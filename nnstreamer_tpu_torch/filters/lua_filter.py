"""Lua scripting filter (counterpart of the JAX package's
``filters/lua_filter.py``; tensor_filter_lua parity,
ext/nnstreamer/tensor_filter/tensor_filter_lua.cc — embedded Lua scripts
as filters).

The script computes on the host: the backend is not device-capable, so a
CUDA input reaches it through the filter element's one batched host read
a invoke, and its outputs are numpy arrays.

The reference embeds liblua; this build embeds its own interpreter for
the Lua subset filter scripts use (``filters/minilua.py``), so
``framework=lua`` WORKS out of the box — no lupa/liblua needed. When the
`lupa` binding happens to be importable it is preferred (full Lua).

Script convention — the REFERENCE's own (tensor_filter_lua.cc:27-66):

    inputTensorsInfo = {
      num = 1,
      dim = {{3, 640, 480, 1}, },   -- innermost-first, rank ≤ 4
      type = {'uint8', }
    }
    outputTensorsInfo = { ... }
    function nnstreamer_invoke()
      oC = outputTensorsInfo['dim'][1][1]
      -- input_tensor(i) / output_tensor(i): 1-based flat element access
      for i = 1, oC do
        output_tensor(1)[i] = input_tensor(1)[i]
      end
    end

Model property: a path to a ``.lua`` file (file mode) or the script text
itself (script mode) — the reference's two modes
(tensor_filter_lua.cc:455-471). The legacy round-1 convention
(``inputConf``/``outputConf`` + ``nnstreamer_invoke(input)`` returning a
table) is still accepted for back-compat.
"""

from __future__ import annotations

import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.filters.base import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.types import TensorsInfo


def _lua_available() -> bool:  # kept for tests / doctor probes
    try:
        import lupa  # noqa: F401

        return True
    except ImportError:
        return False


class _TensorView:
    """1-based flat element access over a numpy array — the userdata
    surface the reference exposes via input_tensor()/output_tensor()
    (tensor_filter_lua.cc:256-296). The flat view is cached: scripts
    index once per element inside interpreted loops."""

    __slots__ = ("flat", "writable")

    def __init__(self, arr: np.ndarray, writable: bool):
        self.flat = arr.reshape(-1)  # contiguous by invoke() construction
        self.writable = writable

    def lua_index(self, key):
        i = int(key)
        if not 1 <= i <= self.flat.size:
            raise IndexError(
                f"tensor index {i} out of range 1..{self.flat.size}")
        return self.flat[i - 1].item()

    def lua_newindex(self, key, value):
        if not self.writable:
            raise TypeError("input tensors are read-only")
        i = int(key)
        if not 1 <= i <= self.flat.size:
            raise IndexError(
                f"tensor index {i} out of range 1..{self.flat.size}")
        self.flat[i - 1] = value

    def lua_length(self):
        return self.flat.size


class LuaFilter(FilterFramework):
    NAME = "lua"
    ASYNC = False
    RESHAPABLE = False

    def __init__(self):
        super().__init__()
        self._rt = None
        self._backend: Optional[str] = None   # 'minilua' | 'lupa'
        self._legacy = False                  # legacy inputConf convention
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._inputs: List[np.ndarray] = []
        self._outputs: List[np.ndarray] = []
        # one Lua state per instance → serialize invokes (the instance may
        # be shared across parallel branches via shared-tensor-filter-key,
        # and the per-invoke tensors are staged on the instance for the
        # input_tensor()/output_tensor() accessors)
        # invoke_ok/blocking_ok: serializing the non-reentrant Lua
        # state across invokes is this lock's entire purpose
        self._invoke_lock = lockwitness.make_lock(
            "lua.invoke", blocking_ok=True, invoke_ok=True)

    # -- script loading ------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        super().open(props)
        # script mode: the model property IS the script, and the element's
        # multi-model comma split must be undone — the reference re-joins
        # model_files with "," the same way (tensor_filter_lua.cc:460)
        script = ",".join(props.model_files) if props.model_files else ""
        if os.path.isfile(script):
            # file mode is selected by EXISTENCE, matching the reference
            # (tensor_filter_lua.cc: script mode only when the model file
            # does not exist) — a real script file without a .lua suffix
            # must still load as a file
            try:
                with open(script, "r", encoding="utf-8") as f:
                    src = f.read()
            except OSError as e:
                raise ValueError(f"lua script file unreadable: {e}") from e
        elif script.endswith(".lua"):
            # looks like a path but isn't there: say so, instead of a
            # baffling script-parse error of the path string
            raise ValueError(f"lua script file not found: {script}")
        else:  # script mode: the property IS the script
            src = script
        if _lua_available():
            self._backend = "lupa"
            self._open_lupa(src)
        else:
            self._backend = "minilua"
            self._open_minilua(src)

    def _open_minilua(self, src: str) -> None:
        from nnstreamer_tpu_torch.filters.minilua import LuaError, MiniLua

        rt = MiniLua()
        rt.set_global("input_tensor",
                      lambda i: self._input_view(int(i)))
        rt.set_global("output_tensor",
                      lambda i: self._output_view(int(i)))
        try:
            rt.execute(src)
        except LuaError as e:
            raise ValueError(f"lua script error: {e}") from e
        self._rt = rt
        fn = rt.get_global("nnstreamer_invoke")
        if fn is None:
            raise ValueError("lua script must define nnstreamer_invoke()")
        info_in = rt.get_global("inputTensorsInfo")
        info_out = rt.get_global("outputTensorsInfo")
        if info_in is not None and info_out is not None:
            self._in_info = _tensors_info_from_table(info_in, "input")
            self._out_info = _tensors_info_from_table(info_out, "output")
        else:
            # legacy convention: inputConf/outputConf + invoke(input)
            conf_in = rt.get_global("inputConf")
            conf_out = rt.get_global("outputConf")
            if conf_in is None or conf_out is None:
                raise ValueError(
                    "lua script must define inputTensorsInfo/"
                    "outputTensorsInfo (reference convention) or "
                    "inputConf/outputConf (legacy)")
            self._in_info = _conf_to_info_tbl(conf_in)
            self._out_info = _conf_to_info_tbl(conf_out)
            self._legacy = True

    def _open_lupa(self, src: str) -> None:
        from lupa import LuaRuntime

        rt = LuaRuntime(unpack_returned_tuples=True)
        g = rt.globals()
        g["input_tensor"] = lambda i: _LupaTensorProxy(
            self, int(i), writable=False)
        g["output_tensor"] = lambda i: _LupaTensorProxy(
            self, int(i), writable=True)
        rt.execute(src)
        self._rt = rt
        if g["nnstreamer_invoke"] is None:
            raise ValueError("lua script must define nnstreamer_invoke()")
        if g["inputTensorsInfo"] is not None:
            if g["outputTensorsInfo"] is None:
                raise ValueError("lua script defines inputTensorsInfo but "
                                 "not outputTensorsInfo")
            self._in_info = _tensors_info_from_lupa(g["inputTensorsInfo"])
            self._out_info = _tensors_info_from_lupa(g["outputTensorsInfo"])
        elif g["inputConf"] is not None:
            if g["outputConf"] is None:
                raise ValueError("lua script defines inputConf but not "
                                 "outputConf")
            self._in_info = _conf_to_info_lupa(g["inputConf"])
            self._out_info = _conf_to_info_lupa(g["outputConf"])
            self._legacy = True
        else:
            raise ValueError("lua script must define tensors info tables")

    # -- tensor access surface -----------------------------------------
    def _input_view(self, i: int) -> _TensorView:
        if not 1 <= i <= len(self._inputs):
            raise IndexError(f"input_tensor({i}): have {len(self._inputs)}")
        return _TensorView(self._inputs[i - 1], writable=False)

    def _output_view(self, i: int) -> _TensorView:
        if not 1 <= i <= len(self._outputs):
            raise IndexError(f"output_tensor({i}): have {len(self._outputs)}")
        return _TensorView(self._outputs[i - 1], writable=True)

    def close(self) -> None:
        self._rt = None
        self._backend = None
        self._legacy = False
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo],
                                      Optional[TensorsInfo]]:
        return self._in_info, self._out_info

    # -- invoke --------------------------------------------------------
    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        assert self._out_info is not None
        # one Lua state; tensors are staged on the instance for the
        # accessor functions → serialize (shared-tensor-filter-key may
        # route parallel branches through this one instance)
        with self._invoke_lock:
            self._inputs = [np.ascontiguousarray(np.asarray(a))
                            for a in inputs]
            if self._legacy:
                return self._invoke_legacy()
            self._outputs = [
                np.zeros(self._out_info[i].np_shape(),
                         self._out_info[i].dtype.np_dtype)
                for i in range(self._out_info.num_tensors)
            ]
            if self._backend == "lupa":
                self._rt.globals()["nnstreamer_invoke"]()
            else:
                from nnstreamer_tpu_torch.filters.minilua import LuaError

                try:
                    self._rt.call(self._rt.get_global("nnstreamer_invoke"))
                except LuaError as e:
                    raise RuntimeError(f"lua invoke error: {e}") from e
            return list(self._outputs)

    def _invoke_legacy(self) -> List[Any]:
        flat = self._inputs[0].reshape(-1).tolist()
        dtype = self._out_info[0].dtype.np_dtype
        if self._backend == "lupa":
            table = self._rt.table_from(flat)
            out = self._rt.globals()["nnstreamer_invoke"](table)
            if out is None or not hasattr(out, "values"):
                raise RuntimeError(
                    "lua invoke error: nnstreamer_invoke(input) must "
                    "return the output table")
            vals = list(out.values())
        else:
            from nnstreamer_tpu_torch.filters.minilua import (
                LuaError,
                LuaTable,
            )

            t = LuaTable({i + 1: v for i, v in enumerate(flat)})
            try:
                out = self._rt.call(
                    self._rt.get_global("nnstreamer_invoke"), t)
            except LuaError as e:
                raise RuntimeError(f"lua invoke error: {e}") from e
            if not isinstance(out, LuaTable):
                raise RuntimeError(
                    "lua invoke error: nnstreamer_invoke(input) must "
                    "return the output table")
            vals = [out.get(i + 1) for i in range(out.length())]
        out_np = np.asarray(vals, dtype=dtype)
        return [out_np.reshape(self._out_info[0].np_shape())]


class _LupaTensorProxy:
    """lupa-side userdata with __index/__newindex via python attrs."""

    def __init__(self, filt: LuaFilter, idx: int, writable: bool):
        self._f = filt
        self._i = idx
        self._w = writable

    def __getitem__(self, k):
        view = (self._f._output_view(self._i) if self._w
                else self._f._input_view(self._i))
        return view.lua_index(k)

    def __setitem__(self, k, v):
        (self._f._output_view(self._i)
         if self._w else self._f._input_view(self._i)).lua_newindex(k, v)


# -- info-table parsing (tensor_filter_lua.cc:361-433 semantics) ---------

def _tensors_info_from_table(t, what: str) -> TensorsInfo:
    num = t.get("num")
    dims_t = t.get("dim")
    types_t = t.get("type")
    if num is None or dims_t is None or types_t is None:
        raise ValueError(
            f"{what}TensorsInfo needs num, dim and type fields")
    dims, types = [], []
    for i in range(1, int(num) + 1):
        d = dims_t.get(i)
        ty = types_t.get(i)
        if d is None or ty is None:
            raise ValueError(f"{what}TensorsInfo missing entry {i}")
        dims.append(":".join(str(int(d.get(j)))
                             for j in range(1, d.length() + 1)))
        types.append(str(ty).lower())
    return TensorsInfo.from_strings(".".join(dims), ".".join(types))


def _tensors_info_from_lupa(t) -> TensorsInfo:
    num = int(t["num"])
    dims, types = [], []
    for i in range(1, num + 1):
        d = t["dim"][i]
        dims.append(":".join(str(int(v)) for v in d.values()))
        types.append(str(t["type"][i]).lower())
    return TensorsInfo.from_strings(".".join(dims), ".".join(types))


def _conf_to_info_tbl(conf) -> TensorsInfo:
    dims = conf.get("dims")
    ds = [int(dims.get(i)) for i in range(1, dims.length() + 1)]
    ttype = str(conf.get("type") or "float32")
    return TensorsInfo.from_strings(":".join(str(d) for d in ds), ttype)


def _conf_to_info_lupa(conf) -> TensorsInfo:
    dims = list(conf["dims"].values()) if conf["dims"] is not None else []
    ttype = str(conf["type"] or "float32")
    return TensorsInfo.from_strings(
        ":".join(str(int(d)) for d in dims), ttype)


registry.register(registry.FILTER, "lua")(LuaFilter)
