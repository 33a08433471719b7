"""Run a .tflite file through the port (counterpart of
``examples/tflite_models.py``): ``tensor_filter framework=jax
model=foo.tflite`` imports the flatbuffer to a torch program on the card
(tools/import_tflite.py) and streams it like any zoo model.

    python -m nnstreamer_tpu_torch.examples.tflite_models <model.tflite>
        [frames] [--device cpu]

Without a path it opens the reference's DeepLab file where a checkout
holds it, and raises naming the path where it does not.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

#: the reference's DeepLab-v3 .tflite, where a checkout holds it
DEFAULT_MODEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "tests", "test_models", "models", "deeplabv3_257_mv_gpu.tflite")


def main(argv: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    """Returns the first output tensor of every frame streamed."""
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.examples import accelerator, parse_args
    from nnstreamer_tpu_torch.pipeline import parse_launch
    from nnstreamer_tpu_torch.tools.import_tflite import load_tflite

    device, _, rest = parse_args(argv)
    model = rest[0] if rest else DEFAULT_MODEL
    n = int(rest[1]) if len(rest) > 1 else 4
    if not os.path.exists(model):
        raise FileNotFoundError(f"no .tflite file at {model}")
    bundle = load_tflite(model, device=device)
    in_t = bundle.input_info[0]
    dims = ":".join(str(d) for d in in_t.dims if d)
    dtype = in_t.dtype.name.lower()
    print(f"{os.path.basename(model)}: input {dims} {dtype}, "
          f"{len(bundle.output_info)} output(s)")
    p = parse_launch(
        "appsrc name=src caps=other/tensors,num-tensors=1,"
        f"dimensions={dims},types={dtype},framerate=0/1 "
        f"! tensor_filter framework=jax model={model} {accelerator(device)} "
        "! tensor_sink name=out")
    p.play()
    try:
        rng = np.random.default_rng(0)
        shape = in_t.np_shape()
        for _ in range(n):
            x = (rng.integers(0, 256, shape).astype(np.uint8)
                 if dtype == "uint8"
                 else rng.normal(0, 1, shape).astype(np.float32))
            p["src"].push_buffer(Buffer(tensors=[x]))
        p["src"].end_of_stream()
        if not p.bus.wait_eos(600) or p.bus.error is not None:
            raise RuntimeError(f"the line failed: {p.bus.error}")
        outs = [np.asarray(b[0]) for b in p["out"].collected]
    finally:
        p.stop()
    print(f"streamed {len(outs)} frames; out[0] shape {outs[0].shape} "
          f"dtype {outs[0].dtype}")
    return outs


if __name__ == "__main__":
    main()
