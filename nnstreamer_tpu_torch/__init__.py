"""nnstreamer_tpu_torch — the PyTorch/CUDA port of nnstreamer_tpu.

A streaming inference dataflow framework (typed multi-tensor stream
pipelines with pluggable filter/decoder subplugins, after NNStreamer) whose
device path runs on an NVIDIA H100 through PyTorch and kernels written by
hand for Hopper (``csrc/``). It mirrors the JAX package ``nnstreamer_tpu``
module for module and accepts its launch lines verbatim
(``framework=jax`` resolves to this package's torch/CUDA backend), so the
same pipeline can run through both; the JAX package is the reference it is
held against. It imports neither JAX nor the JAX package.

This slice carries the flagship image-labeling line:
``appsrc ! tensor_converter ! tensor_filter model=mobilenet_v2 ! queue !
tensor_decoder mode=image_labeling ! tensor_sink``, plus
``tensor_transform acceleration=device``.
"""

__version__ = "0.2.0"

from nnstreamer_tpu_torch.types import (  # noqa: F401
    TensorDType,
    TensorFormat,
    TensorInfo,
    TensorLayout,
    TensorsConfig,
    TensorsInfo,
    dimension_to_string,
    parse_dimension,
)
from nnstreamer_tpu_torch.caps import Caps  # noqa: F401


def __getattr__(name: str):
    # Buffer imports torch: loaded on first use, so a process that drives
    # only the native core (tools/pjrt_native.py) imports no torch
    if name == "Buffer":
        from nnstreamer_tpu_torch.buffer import Buffer

        return Buffer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def parse_launch(description: str):
    """Build a pipeline from a gst-launch-style description string."""
    from nnstreamer_tpu_torch.pipeline.parse import parse_launch as _parse

    return _parse(description)
