"""The native pipeline core and the C ABI of user filter libraries
(counterpart of the JAX package's ``native_rt.py``).

The native core (``native/src``, ``native/include``) is the C++ pipeline
graph: parse_launch, streaming threads, bounded queues, the converter and
transform hot loops, the decoders, and a ``tensor_filter`` whose backends
are C vtables (``nnstpu_custom_filter``, capi.h). Its sources belong to
neither package. This module

  - builds the port's own copy of the core, ``libnnstpu_torch_core.so``
    (SONAME the same), with a bare ``g++``: no cmake, no ninja, and no
    ``pjrt_filter.cc`` (there is no XLA here). The build lives in
    ``_native_build.py``, which needs only the standard library (setup.py
    runs it in an isolated wheel build); its names are re-exported here;
  - wraps the flat C API in :class:`NativePipeline`;
  - bridges Python callables into native graphs
    (:func:`register_callback_filter`: numpy views in, arrays out) and
    loads C++ class subplugins (:func:`compile_and_load_plugin`);
  - builds and loads the native executable filter
    (``csrc/native_exec.cc``, :func:`load_exec`): ``framework=pjrt`` on a
    frozen TorchScript program, run by libtorch with no Python in the
    invoke.

Why a core of its own: one process may load the JAX package's
``native/build/libnnstpu.so`` and this one. Each core keeps its own
registry of elements and filters, and a plugin linked against
``libnnstpu_torch_core.so`` registers into this core whichever loaded
first (a plugin linked against ``libnnstpu.so`` would bind to the other).

Every build runs at first use, never at import; each is serialised across
processes by a lock file in its output directory.

The ctypes mirrors of capi.h's descriptors below are also what the
``custom`` filter backend (filters/custom.py) drives a user library with.
"""

from __future__ import annotations

import ctypes as C
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nnstreamer_tpu_torch._native_build import (  # noqa: F401 (re-exported)
    BUILD_ROOT,
    CORE_CXXFLAGS,
    CORE_NAME,
    CORE_SOURCES,
    NATIVE_DIR,
    PACKAGED_CORE,
    _PKG,
    build,
    build_seconds,
    compile_shared,
    core_build,
    digest,
)
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.types import DTYPE_WIRE_IDS, TensorInfo, TensorsInfo

log = get_logger("native")

#: the native executable filter (framework=pjrt on a TorchScript program)
EXEC_SOURCE = os.path.join(_PKG, "csrc", "native_exec.cc")
EXEC_NAME = "libnnstpu_torch_exec.so"

RANK_LIMIT = 16
TENSORS_MAX = 256


class TensorInfoC(C.Structure):
    _fields_ = [
        ("dims", C.c_uint32 * RANK_LIMIT),
        ("rank", C.c_uint32),
        ("dtype", C.c_uint32),
    ]


class TensorsInfoC(C.Structure):
    _fields_ = [("info", TensorInfoC * TENSORS_MAX), ("num", C.c_uint32)]


class TensorMemC(C.Structure):
    _fields_ = [("data", C.c_void_p), ("size", C.c_size_t)]


INIT_FN = C.CFUNCTYPE(C.c_void_p, C.c_char_p)
EXIT_FN = C.CFUNCTYPE(None, C.c_void_p)
GETDIM_FN = C.CFUNCTYPE(C.c_int, C.c_void_p, C.POINTER(TensorsInfoC))
SETDIM_FN = C.CFUNCTYPE(
    C.c_int, C.c_void_p, C.POINTER(TensorsInfoC), C.POINTER(TensorsInfoC)
)
INVOKE_FN = C.CFUNCTYPE(
    C.c_int,
    C.c_void_p,
    C.POINTER(TensorMemC),
    C.c_uint32,
    C.POINTER(TensorMemC),
    C.c_uint32,
)


class CustomFilterC(C.Structure):
    _fields_ = [
        ("init", INIT_FN),
        ("exit_", EXIT_FN),
        ("get_input_dim", GETDIM_FN),
        ("get_output_dim", GETDIM_FN),
        ("set_input_dim", SETDIM_FN),
        ("invoke", INVOKE_FN),
    ]


def _info_to_c(info: TensorsInfo, out: TensorsInfoC) -> None:
    out.num = len(info.tensors)
    for i, t in enumerate(info.tensors):
        ti = out.info[i]
        ti.rank = len(t.dims)
        for j, d in enumerate(t.dims):
            ti.dims[j] = d
        ti.dtype = DTYPE_WIRE_IDS.index(t.dtype)


def _info_from_c(cinfo: TensorsInfoC) -> TensorsInfo:
    tensors = []
    for i in range(cinfo.num):
        ti = cinfo.info[i]
        dims = tuple(ti.dims[j] for j in range(ti.rank))
        tensors.append(TensorInfo(dims=dims, dtype=DTYPE_WIRE_IDS[ti.dtype]))
    return TensorsInfo(tensors=tensors)


# --------------------------------------------------------------------------
# building
# --------------------------------------------------------------------------

def cuda_include() -> Optional[str]:
    """The CUDA toolkit's include directory where torch was built for
    CUDA and the toolkit's headers exist, else None (a CPU build)."""
    import torch

    if torch.version.cuda is None:
        return None
    from torch.utils import cpp_extension

    home = cpp_extension.CUDA_HOME or "/usr/local/cuda"
    inc = os.path.join(home, "include")
    return inc if os.path.exists(os.path.join(inc, "cuda_runtime_api.h")) \
        else None


def torch_flags(cuda: bool) -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of a C++ library against libtorch:
    torch's headers (its 2.13 headers need C++20), its ABI flag, and an
    rpath to its ``lib/``; with ``cuda``, the CUDA toolkit's headers and
    torch's CUDA libraries. The version define keys a build directory on
    torch's version (the flags are its digest's input); the native filter
    reports it at open."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    cflags = ["-std=c++20", "-O2", "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
              f"-DNNSTPU_TORCH_VERSION=\"{torch.__version__}\""]
    for inc in cpp_extension.include_paths():
        cflags += ["-isystem", inc]
    ldflags = ["-L", lib, f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed",
               "-ltorch", "-ltorch_cpu", "-lc10"]
    if cuda:
        cflags += ["-isystem", cuda_include()]
        ldflags += ["-ltorch_cuda", "-lc10_cuda"]
    return cflags, ldflags


def build_exec() -> str:
    """The native executable filter, ``csrc/native_exec.cc`` linked to the
    port's core and libtorch; where torch has CUDA, with CUDA and linked
    to the TorchScript op library (ops/_script_ops.py), whose kernels a
    program traced on the card calls. The libraries it links build beside
    its compile. Returns its path."""
    cuda = cuda_include() is not None
    cflags, ldflags = torch_flags(cuda)
    inc = os.path.join(NATIVE_DIR, "include")
    cflags += ["-I", inc]
    core_dir = core_build()[0]
    ldflags += ["-L", core_dir, "-lnnstpu_torch_core",
                f"-Wl,-rpath,{core_dir}"]
    with ThreadPoolExecutor(2) as pool:
        linked = [pool.submit(build)]
        if cuda:
            from nnstreamer_tpu_torch.ops import _script_ops

            linked.append(pool.submit(_script_ops.build))
            ops_dir = os.path.dirname(_script_ops.library_path())
            cflags.append("-DNNSTPU_EXEC_CUDA=1")
            ldflags += ["-L", ops_dir, "-lnnstpu_torch_ops",
                        f"-Wl,-rpath,{ops_dir}"]
        files = [EXEC_SOURCE] + [os.path.join(inc, "nnstpu", h) for h in (
            "capi.h", "cppclass.hh")]
        out_dir = os.path.join(BUILD_ROOT, "exec-" + digest(
            files, cflags + ldflags))
        return compile_shared(out_dir, EXEC_NAME, [EXEC_SOURCE], cflags,
                              ldflags, "exec",
                              before_link=lambda: [f.result() for f in linked])


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

_lib = None
# serialises the one-time build and dlopen
_lib_lock = threading.Lock()
_exec = None
_exec_lock = threading.Lock()
_kept_refs: List[object] = []  # registered vtables + callbacks must not be GC'd


def available() -> bool:
    try:
        load()
        return True
    except Exception:  # noqa: BLE001
        return False


def load() -> C.CDLL:
    """The port's core, built and loaded at first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = C.CDLL(build())
        lib.nnstpu_parse_launch.restype = C.c_void_p
        lib.nnstpu_parse_launch.argtypes = [C.c_char_p]
        lib.nnstpu_pipeline_free.argtypes = [C.c_void_p]
        lib.nnstpu_pipeline_play.argtypes = [C.c_void_p]
        lib.nnstpu_pipeline_stop.argtypes = [C.c_void_p]
        lib.nnstpu_last_error.restype = C.c_char_p
        lib.nnstpu_appsrc_push.argtypes = [
            C.c_void_p, C.c_char_p, C.POINTER(TensorMemC), C.c_uint32,
            C.c_int64,
        ]
        lib.nnstpu_appsrc_eos.argtypes = [C.c_void_p, C.c_char_p]
        lib.nnstpu_appsink_pull.argtypes = [
            C.c_void_p, C.c_char_p, C.c_int, C.POINTER(C.c_void_p),
            C.POINTER(TensorMemC), C.POINTER(C.c_uint32),
            C.POINTER(TensorInfoC), C.POINTER(C.c_int64),
        ]
        lib.nnstpu_frame_free.argtypes = [C.c_void_p]
        lib.nnstpu_wait_eos.argtypes = [C.c_void_p, C.c_int]
        lib.nnstpu_bus_pop_error.argtypes = [C.c_void_p, C.c_char_p,
                                             C.c_size_t]
        lib.nnstpu_register_custom_filter.argtypes = [
            C.c_char_p, C.POINTER(CustomFilterC)
        ]
        lib.nnstpu_query_server_port.argtypes = [C.c_void_p, C.c_char_p]
        lib.nnstpu_unregister_custom_filter.argtypes = [C.c_char_p]
        lib.nnstpu_load_subplugin.argtypes = [C.c_char_p]
        lib.nnstpu_version.restype = C.c_char_p
        _lib = lib
        return lib


def _last_error(lib) -> str:
    err = lib.nnstpu_last_error()
    return err.decode() if err else ""


def compile_and_load_plugin(cc_source: str, so_name: str, workdir: str) -> str:
    """Compile a C++ subplugin (nnstpu/cppclass.hh route) against the
    source checkout's headers and the port's core, and dlopen it into the
    core via nnstpu_load_subplugin. Returns the .so path (the file may be
    deleted after load; the handle stays open)."""
    lib = load()
    include = os.path.join(NATIVE_DIR, "include")
    core_dir = os.path.dirname(build())
    if not os.path.isdir(include):
        raise RuntimeError(
            "plugin compile needs the source checkout (native/include)")
    src = os.path.join(workdir, so_name.replace(".so", ".cc"))
    with open(src, "w", encoding="utf-8") as f:
        f.write(cc_source)
    try:
        so = compile_shared(
            workdir, so_name, [src], [*CORE_CXXFLAGS, "-I", include],
            ["-L", core_dir, "-lnnstpu_torch_core", f"-Wl,-rpath,{core_dir}"],
            "plugin", reuse=False)
    except RuntimeError as e:
        raise RuntimeError(f"plugin compile failed: {str(e)[-300:]}") from e
    if lib.nnstpu_load_subplugin(so.encode()) != 0:
        raise RuntimeError(f"plugin load failed: {_last_error(lib)}")
    return so


def load_exec(path: Optional[str] = None) -> C.CDLL:
    """Load the native executable filter into the port's core (built at
    first use unless ``path`` names a built one): ``framework=pjrt`` then
    resolves to it. Returns its handle, which reads the filter's last
    open error (:func:`exec_error`)."""
    global _exec
    lib = load()
    with _exec_lock:
        if _exec is None:
            path = path or build_exec()
            if lib.nnstpu_load_subplugin(path.encode()) != 0:
                raise RuntimeError(
                    f"native exec filter load failed: {_last_error(lib)}")
            handle = C.CDLL(path)  # the same object the core dlopened
            handle.nnstpu_exec_last_error.restype = C.c_char_p
            handle.nnstpu_exec_clear_error.restype = None
            _exec = handle
        return _exec


def clear_exec_error() -> None:
    """Forget the native executable filter's last open error."""
    if _exec is not None:
        _exec.nnstpu_exec_clear_error()


def exec_error() -> str:
    """The native executable filter's last open error, "" without one."""
    if _exec is None:
        return ""
    err = _exec.nnstpu_exec_last_error()
    return err.decode() if err else ""


# --------------------------------------------------------------------------
# Python filters inside native graphs
# --------------------------------------------------------------------------

def register_callback_filter(
    name: str,
    invoke: Callable[[List[np.ndarray]], Sequence[np.ndarray]],
    in_info: TensorsInfo,
    out_info: Optional[TensorsInfo] = None,
    negotiate: Optional[Callable[[TensorsInfo], TensorsInfo]] = None,
) -> None:
    """Register a Python callable as a native filter framework.

    invoke() gets zero-copy numpy views of the input memories (shaped per
    ``in_info``) and must return arrays matching the negotiated output info.
    If ``negotiate`` is given it answers set_input_dim (shape proposals);
    else ``out_info`` is fixed.
    """
    lib = load()
    state: Dict[str, TensorsInfo] = {"in": in_info, "out": out_info or in_info}

    @INIT_FN
    def c_init(_props):
        return None

    @EXIT_FN
    def c_exit(_priv):
        return None

    @GETDIM_FN
    def c_get_in(_priv, cinfo):
        _info_to_c(state["in"], cinfo.contents)
        return 0

    @GETDIM_FN
    def c_get_out(_priv, cinfo):
        _info_to_c(state["out"], cinfo.contents)
        return 0

    @SETDIM_FN
    def c_set_in(_priv, cin, cout):
        proposed = _info_from_c(cin.contents)
        try:
            if negotiate is not None:
                out = negotiate(proposed)
            elif out_info is not None:
                out = out_info
            else:
                out = proposed
        except Exception:  # noqa: BLE001
            return -1
        state["in"], state["out"] = proposed, out
        _info_to_c(out, cout.contents)
        return 0

    @INVOKE_FN
    def c_invoke(_priv, c_in, n_in, c_out, n_out):
        try:
            xs = []
            for i in range(n_in):
                t = state["in"].tensors[i] if i < len(state["in"].tensors) \
                    else None
                raw = C.cast(
                    c_in[i].data, C.POINTER(C.c_uint8 * c_in[i].size)
                ).contents
                a = np.frombuffer(raw, dtype=np.uint8)
                if t is not None and t.is_fixed() and t.size == c_in[i].size:
                    a = a.view(t.dtype.np_dtype).reshape(t.np_shape())
                xs.append(a)
            ys = invoke(xs)
            for i, y in enumerate(ys):
                if i >= n_out:
                    return -2
                y = np.ascontiguousarray(y)
                if y.nbytes != c_out[i].size:
                    return -3
                C.memmove(c_out[i].data, y.ctypes.data, y.nbytes)
            return 0
        except Exception:  # noqa: BLE001 — a raise must not cross into C
            log.exception("callback filter %s invoke failed", name)
            return -1

    vt = CustomFilterC(c_init, c_exit, c_get_in, c_get_out, c_set_in, c_invoke)
    _kept_refs.extend([vt, c_init, c_exit, c_get_in, c_get_out, c_set_in,
                       c_invoke])
    rc = lib.nnstpu_register_custom_filter(name.encode(), C.byref(vt))
    if rc != 0:
        raise RuntimeError(f"native register failed: {_last_error(lib)}")


def unregister_filter(name: str) -> None:
    load().nnstpu_unregister_custom_filter(name.encode())


class NativePipeline:
    """gst-launch-style native pipeline (parse → play → push/pull)."""

    def __init__(self, description: str):
        self._lib = load()
        self._h = self._lib.nnstpu_parse_launch(description.encode())
        if not self._h:
            raise ValueError(f"parse error: {_last_error(self._lib)}")

    def play(self) -> None:
        if self._lib.nnstpu_pipeline_play(self._h) != 0:
            raise RuntimeError(f"play failed: {_last_error(self._lib)}")

    def push(self, elem: str, arrays: Sequence[np.ndarray], pts: int = -1) -> None:
        mems = (TensorMemC * len(arrays))()
        keep = []
        for i, a in enumerate(arrays):
            a = np.ascontiguousarray(a)
            keep.append(a)
            mems[i].data = a.ctypes.data
            mems[i].size = a.nbytes
        rc = self._lib.nnstpu_appsrc_push(
            self._h, elem.encode(), mems, len(arrays), pts
        )
        if rc != 0:
            raise RuntimeError(f"push failed: {_last_error(self._lib)}")

    def pull(
        self, elem: str, timeout: float = 5.0
    ) -> Optional[Tuple[List[np.ndarray], int]]:
        """Returns (tensor bytes as uint8 arrays, pts), or None on timeout/EOS."""
        frame = C.c_void_p()
        mems = (TensorMemC * TENSORS_MAX)()
        infos = (TensorInfoC * TENSORS_MAX)()
        n = C.c_uint32(TENSORS_MAX)
        pts = C.c_int64(-1)
        rc = self._lib.nnstpu_appsink_pull(
            self._h, elem.encode(), int(timeout * 1000), C.byref(frame),
            mems, C.byref(n), infos, C.byref(pts),
        )
        if rc != 1:
            return None
        out = []
        for i in range(n.value):
            raw = C.cast(mems[i].data,
                         C.POINTER(C.c_uint8 * mems[i].size)).contents
            out.append(np.frombuffer(raw, dtype=np.uint8).copy())
        self._lib.nnstpu_frame_free(frame)
        return out, pts.value

    def eos(self, elem: str) -> None:
        self._lib.nnstpu_appsrc_eos(self._h, elem.encode())

    def wait_eos(self, timeout: float = 10.0) -> bool:
        return self._lib.nnstpu_wait_eos(self._h, int(timeout * 1000)) == 1

    def query_server_port(self, elem: str) -> int:
        """Bound port of a tensor_query_serversrc in this pipeline."""
        return self._lib.nnstpu_query_server_port(self._h, elem.encode())

    def pop_error(self) -> Optional[str]:
        buf = C.create_string_buffer(1024)
        if self._lib.nnstpu_bus_pop_error(self._h, buf, 1024):
            return buf.value.decode()
        return None

    def stop(self) -> None:
        if self._h:
            self._lib.nnstpu_pipeline_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.nnstpu_pipeline_stop(self._h)
            self._lib.nnstpu_pipeline_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
