"""Object detection with the bounding_boxes decoder (counterpart of
``examples/detection.py``): SSD-MobileNet-v2 emits (boxes, scores); the
decoder runs the prior decode and NMS and rasterizes an RGBA overlay.

    python -m nnstreamer_tpu_torch.examples.detection [--device cpu]
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

SIZE = 96
CUSTOM = f"seed:0,size:{SIZE},width:0.35,classes:8"


def frame() -> np.ndarray:
    """The JAX example's frame: one random 96x96 RGB frame."""
    return np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3),
                                             np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Returns the overlay (``overlay``, RGBA) and the decoded
    ``objects``."""
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.examples import (
        accelerator,
        parse_args,
        zoo_custom,
    )
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.pipeline import parse_launch

    device, params, _ = parse_args(argv)
    with tempfile.TemporaryDirectory() as td:
        labels = os.path.join(td, "coco.txt")
        with open(labels, "w") as f:
            f.write("\n".join(f"obj{i}" for i in range(8)))
        priors = os.path.join(td, "box_priors.txt")
        write_box_priors(priors, SIZE)
        p = parse_launch(
            "appsrc name=src caps=video/x-raw,format=RGB,width=96,height=96,"
            "framerate=30/1 "
            "! tensor_converter "
            "! tensor_filter framework=jax model=ssd_mobilenet "
            f"  custom={zoo_custom(CUSTOM, params)} {accelerator(device)} "
            "! tensor_decoder mode=bounding_boxes option1=mobilenet-ssd "
            f"  option2={labels} option3={priors}:0.5 option4=96:96 "
            "option5=96:96 ! tensor_sink name=out")
        p.play()
        try:
            p["src"].push_buffer(Buffer(tensors=[frame()]))
            buf = p["out"].pull(timeout=120.0)
            if buf is None:
                raise RuntimeError(f"no overlay: {p.bus.error}")
            overlay = np.asarray(buf.tensors[0])
            objects = list(buf.meta.get("objects", []))
        finally:
            p.stop()
    print("overlay:", overlay.shape, "objects:", len(objects))
    return {"overlay": overlay, "objects": objects}


if __name__ == "__main__":
    main()
