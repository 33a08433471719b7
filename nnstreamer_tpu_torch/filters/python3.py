"""python3 script filter — user-defined filters in plain Python files
(counterpart of the JAX package's ``filters/python3.py``).

Parity: ext/nnstreamer/tensor_filter/tensor_filter_python3.cc (860 LoC):
embeds CPython and expects a user class with ``getInputDim`` /
``getOutputDim`` / ``invoke`` (+ optional ``setInputDim`` for reshapable
scripts). Here the host *is* Python, so the subplugin reduces to loading the
script and adapting the same user contract onto the FilterFramework vtable.

Script contract (both reference-style and pythonic forms accepted):

    class CustomFilter:            # name is free; first class found is used
        def getInputDim(self):     # -> TensorsInfo | (dims_str, types_str)
        def getOutputDim(self):    # -> same
        def setInputDim(self, in_info):  # optional: reshapable scripts
        def invoke(self, inputs):  # list[np.ndarray] -> list[np.ndarray]

``model=<script.py>`` and ``custom=...`` is passed to the constructor when
it accepts an argument (the reference forwards custom_properties likewise).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Tuple

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.filters.base import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.pyscript import instantiate_script_class, load_script_class
from nnstreamer_tpu_torch.types import TensorsInfo


def _coerce_info(res) -> Optional[TensorsInfo]:
    if res is None or isinstance(res, TensorsInfo):
        return res
    if isinstance(res, (tuple, list)) and len(res) == 2:
        return TensorsInfo.from_strings(str(res[0]), str(res[1]))
    raise TypeError(
        f"script filter info must be TensorsInfo or (dims, types), got {res!r}"
    )


class Python3Filter(FilterFramework):
    NAME = "python3"
    RESHAPABLE = True

    def __init__(self):
        super().__init__()
        self._obj = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        path = props.model_file
        if not path or not path.endswith(".py"):
            raise ValueError("python3 filter needs model=<script.py>")
        cls = load_script_class(path, "invoke")
        self._obj = instantiate_script_class(cls, props.custom_dict())

    def close(self) -> None:
        self._obj = None
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        get_in = getattr(self._obj, "getInputDim", None)
        get_out = getattr(self._obj, "getOutputDim", None)
        return (
            _coerce_info(get_in()) if get_in else None,
            _coerce_info(get_out()) if get_out else None,
        )

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        set_in = getattr(self._obj, "setInputDim", None)
        if set_in is None:
            _, out = self.get_model_info()
            return in_info, out if out is not None else in_info
        res = set_in(in_info)
        out = _coerce_info(res) if res is not None else None
        return in_info, out if out is not None else in_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        t0 = time.perf_counter()
        out = self._obj.invoke(list(inputs))
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return outs


registry.register(registry.FILTER, "python3")(Python3Filter)
