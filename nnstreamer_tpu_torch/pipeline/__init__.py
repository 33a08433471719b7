"""L3 pipeline runtime.

The reference rides GStreamer's element/pad/caps machinery (L0 in SURVEY.md
§1); we own this layer. The model is the same: elements with sink/src pads,
caps negotiation on link, buffers and in-band events flowing downstream,
per-stage streaming threads created by ``queue`` boundaries, a bus for
out-of-band messages, and 4 pipeline states (NULL/READY/PAUSED/PLAYING).

Device difference: compute elements (tensor_filter etc.) enqueue CUDA work
asynchronously — a pushed buffer may carry CUDA tensors whose values are not
computed yet, so host-side pipeline stages overlap device compute; only
sinks (or host-math elements) synchronize.
"""

from nnstreamer_tpu_torch.pipeline.element import (  # noqa: F401
    Element,
    FlowReturn,
    Pad,
    PadDirection,
    SourceElement,
    State,
    element_register,
    element_factory_make,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Bus, Message, Pipeline  # noqa: F401
from nnstreamer_tpu_torch.pipeline.parse import parse_launch  # noqa: F401
