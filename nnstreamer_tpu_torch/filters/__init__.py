"""L4/L5: the filter ABI and the torch/CUDA backend behind tensor_filter
(counterpart of the JAX package's ``filters``; the backend is
``filters/cuda_filter.py``, registered as ``jax`` and ``torch_cuda``)."""

_BASE = ("FilterFramework", "FilterProperties", "PrefetchedInputs",
         "register_custom_easy", "unregister_custom_easy")


def __getattr__(name: str):
    # filters.base imports torch: loaded on first use, so the native
    # harness (tools/pjrt_native.py) reads sig_tokens without torch
    if name in _BASE:
        from nnstreamer_tpu_torch.filters import base

        return getattr(base, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
