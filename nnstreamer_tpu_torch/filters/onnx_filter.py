"""ONNX Runtime filter backend (gated — onnxruntime is optional;
counterpart of the JAX package's ``filters/onnx_filter.py``).

Reference counterpart: ext/nnstreamer/tensor_filter/tensor_filter_onnxruntime.cc
(ORT session per model). The backend registers regardless and raises a
clear error at open() when the runtime is absent (the reference's
conditional-compile gate, done at runtime). The ORT session itself is
not ported yet: no environment of the port has onnxruntime, so open()
raises by name there too. Run ONNX models through
``framework=jax model=foo.onnx`` (tools/import_onnx.py), on the card.
"""

from __future__ import annotations

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.filters.base import FilterFramework, FilterProperties


class OnnxFilter(FilterFramework):
    NAME = "onnxruntime"

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        try:
            import onnxruntime  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "onnxruntime is not installed in this environment; run the "
                "model with framework=jax (the .onnx importer), or install "
                "onnxruntime"
            ) from e
        raise RuntimeError(
            "the torch_cuda port runs no onnxruntime session yet; run the "
            "model with framework=jax (the .onnx importer)")


registry.register(registry.FILTER, "onnxruntime")(OnnxFilter)
registry.register(registry.FILTER, "onnx")(OnnxFilter)
