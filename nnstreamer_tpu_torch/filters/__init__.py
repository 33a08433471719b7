"""L4/L5: the filter ABI and the torch/CUDA backend behind tensor_filter
(counterpart of the JAX package's ``filters``; the backend is
``filters/cuda_filter.py``, registered as ``jax`` and ``torch_cuda``)."""

from nnstreamer_tpu_torch.filters.base import (  # noqa: F401
    FilterFramework,
    FilterProperties,
    PrefetchedInputs,
    register_custom_easy,
    unregister_custom_easy,
)
