"""On-device training (counterpart of ``examples/training.py``):
datareposrc feeds a tensor_trainer that runs torch steps on the card;
the trained parameters are saved and load back for inference
(``custom=params:<file>``).

    python -m nnstreamer_tpu_torch.examples.training [--device cpu]
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

FEAT, CLASSES, N = 8, 4, 32
EPOCHS = 3
CAPS = (
    "other/tensors,format=static,num_tensors=2,"
    f"dimensions={FEAT}.{CLASSES},types=float32.float32,framerate=0/1"
)

#: the linear model, its weights from numpy (the JAX example draws them
#: from jax.random, which this package cannot run)
MODEL = """
import numpy as np
import torch
def make_model(custom):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(%d, %d)) * 0.1).astype(np.float32)
    params = {"w": torch.from_numpy(w), "b": torch.zeros(%d)}
    def apply_fn(p, x):
        return x @ p["w"] + p["b"]
    return apply_fn, params
""" % (FEAT, CLASSES, CLASSES)


def write_repo(data: str, meta: str) -> None:
    """The JAX example's 32 samples: normal features, one-hot labels
    cycling over the 4 classes."""
    rng = np.random.default_rng(0)
    with open(data, "wb") as f:
        for i in range(N):
            x = rng.normal(size=FEAT).astype(np.float32)
            y = np.zeros(CLASSES, np.float32)
            y[i % CLASSES] = 1.0
            f.write(x.tobytes() + y.tobytes())
    with open(meta, "w") as f:
        json.dump({"gst_caps": CAPS, "total_samples": N,
                   "sample_size": (FEAT + CLASSES) * 4}, f)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Returns each epoch's report (``epochs``: loss, accuracy, ...) and
    whether the checkpoint was saved (``saved``)."""
    from nnstreamer_tpu_torch.examples import parse_args
    from nnstreamer_tpu_torch.pipeline import parse_launch

    device, _, _ = parse_args(argv)
    custom = "batch:8,lr:0.1" + (",device:cpu" if device == "cpu" else "")
    with tempfile.TemporaryDirectory() as td:
        data, meta = os.path.join(td, "d.raw"), os.path.join(td, "d.json")
        write_repo(data, meta)
        model = os.path.join(td, "model.py")
        with open(model, "w") as f:
            f.write(MODEL)
        ckpt = os.path.join(td, "ckpt")
        p = parse_launch(
            f"datareposrc location={data} json={meta} epochs={EPOCHS} "
            f"! tensor_trainer framework=jax model-config={model} "
            f"  model-save-path={ckpt} num-inputs=1 num-labels=1 "
            f"  num-training-samples={N} num-validation-samples=0 "
            f"  epochs={EPOCHS} custom={custom} "
            "! tensor_sink name=out")
        p.run(timeout=300)
        # one loss/accuracy report per epoch (1:1:4 float64)
        epochs = [np.asarray(r[0]).reshape(-1)
                  for r in p["out"].collected]
        for epoch, stats in enumerate(epochs):
            print(f"epoch {epoch}: loss={stats[0]:.4f} acc={stats[2]:.4f}")
        saved = os.path.exists(ckpt)
        print("checkpoint saved:", saved)
    return {"epochs": epochs, "saved": saved}


if __name__ == "__main__":
    main()
