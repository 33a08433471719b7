"""custom filter backend: user C shared objects behind the nnstpu C ABI
(counterpart of the JAX package's ``filters/custom.py``).

Reference counterpart: tensor_filter_custom.c — user .so files exporting a
fn-pointer vtable (tensor_filter_custom.h:40-143). Here the vtable is
``nnstpu_custom_filter`` (native/include/nnstpu/capi.h) exported as the
symbol ``nnstpu_filter_entry`` (the codegen 'c' template emits it); the
same .so plugs into both packages' pipelines and the native core.

The library computes on the host: the backend is not device-capable, so a
CUDA input reaches it through the filter element's one batched host read
a invoke, billed as a ``d2h`` crossing as for every host backend, and its
outputs are host (numpy) arrays, as the ``python3`` backend's are.

Usage: tensor_filter framework=custom model=/path/libmyfilter.so
"""

from __future__ import annotations

import ctypes as C
import os
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.filters.base import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.native_rt import (
    CustomFilterC,
    TensorMemC,
    TensorsInfoC,
    _info_from_c,
    _info_to_c,
)
from nnstreamer_tpu_torch.types import TensorsInfo

ENTRY_SYMBOL = "nnstpu_filter_entry"


class CustomSoFilter(FilterFramework):
    NAME = "custom"

    def __init__(self):
        super().__init__()
        self._lib = None
        self._vt: Optional[CustomFilterC] = None
        self._priv = None
        self._in: Optional[TensorsInfo] = None
        self._out: Optional[TensorsInfo] = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        path = props.model_file
        if not path or not os.path.exists(path):
            raise ValueError(f"custom filter .so not found: {path!r}")
        self._lib = C.CDLL(path)
        try:
            self._vt = CustomFilterC.in_dll(self._lib, ENTRY_SYMBOL)
        except ValueError as e:
            raise ValueError(
                f"{path} does not export {ENTRY_SYMBOL!r} "
                "(see tools/codegen.py 'c' template)"
            ) from e
        if not self._vt.invoke:
            raise ValueError(f"{path}: vtable has no invoke()")
        has_fixed = bool(self._vt.get_input_dim) and bool(self._vt.get_output_dim)
        if not has_fixed and not self._vt.set_input_dim:
            raise ValueError(
                f"{path}: vtable must provide either both get_input_dim/"
                "get_output_dim or set_input_dim (capi.h contract)"
            )
        if self._vt.init:
            self._priv = self._vt.init(props.custom.encode())
        # element negotiation probes set_input_info only on reshapable fws
        self.RESHAPABLE = bool(self._vt.set_input_dim)
        self._load_fixed_info()

    def _load_fixed_info(self) -> None:
        if self._vt.get_input_dim:
            info = TensorsInfoC()
            if self._vt.get_input_dim(self._priv, C.byref(info)) == 0 and info.num:
                self._in = _info_from_c(info)
        if self._vt.get_output_dim:
            info = TensorsInfoC()
            if self._vt.get_output_dim(self._priv, C.byref(info)) == 0 and info.num:
                self._out = _info_from_c(info)

    def close(self) -> None:
        if self._vt is not None and self._vt.exit_ and self._lib is not None:
            self._vt.exit_(self._priv)
        self._lib = None
        self._vt = None
        self._priv = None
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._in, self._out

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        if not self._vt.set_input_dim:
            raise NotImplementedError("custom filter has fixed dimensions")
        cin, cout = TensorsInfoC(), TensorsInfoC()
        _info_to_c(in_info, cin)
        rc = self._vt.set_input_dim(self._priv, C.byref(cin), C.byref(cout))
        if rc != 0:
            raise ValueError(f"custom filter rejected input shape ({rc})")
        self._in, self._out = in_info, _info_from_c(cout)
        return self._in, self._out

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if self._out is None:
            raise RuntimeError("custom filter not negotiated")
        t0 = time.perf_counter()
        arrs = [np.ascontiguousarray(np.asarray(x)) for x in inputs]
        c_in = (TensorMemC * len(arrs))()
        for i, a in enumerate(arrs):
            c_in[i].data = a.ctypes.data
            c_in[i].size = a.nbytes
        outs = [
            np.empty(t.np_shape(), dtype=t.dtype.np_dtype)
            for t in self._out.tensors
        ]
        c_out = (TensorMemC * len(outs))()
        for i, o in enumerate(outs):
            c_out[i].data = o.ctypes.data
            c_out[i].size = o.nbytes
        rc = self._vt.invoke(self._priv, c_in, len(arrs), c_out, len(outs))
        if rc < 0:
            raise RuntimeError(f"custom filter invoke failed ({rc})")
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return [] if rc > 0 else outs  # rc>0 = drop frame


registry.register(registry.FILTER, "custom")(CustomSoFilter)
