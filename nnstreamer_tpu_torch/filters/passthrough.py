"""Passthrough filter — hermetic test backend (parity:
tests/nnstreamer_example passthrough custom filter .so; counterpart of the
JAX package's ``filters/passthrough.py``)."""

from __future__ import annotations

from typing import List, Sequence

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.filters.base import FilterFramework


class PassthroughFilter(FilterFramework):
    NAME = "passthrough"
    RESHAPABLE = True

    def get_model_info(self):
        return None, None  # any shape

    def set_input_info(self, in_info):
        return in_info, in_info

    def invoke(self, inputs: Sequence) -> List:
        return list(inputs)


registry.register(registry.FILTER, "passthrough")(PassthroughFilter)
