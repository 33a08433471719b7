"""Canonical classification pipeline (counterpart of
``examples/classification.py``): video RGB → tensor_converter
(micro-batch of 4) → tensor_filter (MobileNet-v2, normalize and argmax on
the device) → tensor_decoder (image_labeling) → sink.

    python -m nnstreamer_tpu_torch.examples.classification [--device cpu]
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence

import numpy as np

CUSTOM = "seed:0,size:96,width:0.35,postproc:argmax"
N_FRAMES, FPT = 8, 4


def frames() -> List[np.ndarray]:
    """The JAX example's frames: 8 random 96x96 RGB frames."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
            for _ in range(N_FRAMES)]


def main(argv: Optional[Sequence[str]] = None) -> List[List[str]]:
    """Returns the labels of each output buffer (4 frames each)."""
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.examples import (
        accelerator,
        parse_args,
        zoo_custom,
    )
    from nnstreamer_tpu_torch.pipeline import parse_launch

    device, params, _ = parse_args(argv)
    out = []
    with tempfile.TemporaryDirectory() as td:
        labels = os.path.join(td, "labels.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"class{i}" for i in range(1001)))
        p = parse_launch(
            "appsrc name=src caps=video/x-raw,format=RGB,width=96,height=96,"
            "framerate=30/1 "
            f"! tensor_converter frames-per-tensor={FPT} "
            "! tensor_filter framework=jax model=mobilenet_v2 "
            f"  custom={zoo_custom(CUSTOM, params)} {accelerator(device)} "
            f"! tensor_decoder mode=image_labeling option1={labels} "
            "! tensor_sink name=out")
        p.play()
        try:
            for i, frame in enumerate(frames()):
                p["src"].push_buffer(Buffer(tensors=[frame],
                                            pts=i * 33_000_000))
            for _ in range(N_FRAMES // FPT):
                buf = p["out"].pull(timeout=120.0)
                if buf is None:
                    raise RuntimeError(f"no labels: {p.bus.error}")
                print("labels:", buf.meta["label"])
                out.append(list(buf.meta["label"]))
            p["src"].end_of_stream()
            p.bus.wait_eos(10)
        finally:
            p.stop()
    return out


if __name__ == "__main__":
    main()
