"""Build, load and call the package's hand-written CUDA kernels.

The sources in ``nnstreamer_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, and bound with
``ctypes``. The build runs at first use (never at import): one ``nvcc -c``
per source, all started together, then one link. The library lands in
``build/torch_kernels/<hash>/`` beside the package, keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.

Every entry point launches on PyTorch's current stream and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0. Nothing here
falls back: a failed build or launch raises.

The link takes no driver library: the attention kernels' TMA maps are
encoded by the driver's ``cuTensorMapEncodeTiled``, which
``csrc/attention.cu`` fetches at run time through the CUDA runtime's
``cudaGetDriverEntryPoint`` (``...ByVersion`` from CUDA 12.5), so the
library links only the runtime, as nvcc does by default.

Each kernel wrapper counts its launches with :func:`count_launch`, adding
one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels. The counts go to :data:`LAUNCHES`,
except on a thread that is recording a CUDA graph
(:func:`recording_launches`): there they go to that graph's own count,
which each replay adds to :data:`LAUNCHES`.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

#: ``-fmad=false`` is deliberately absent: the kernels spell every rounding
#: they care about with __fmul_rn/__fadd_rn/__fdiv_rn, and use fmaf where
#: a contracted sum is intended. --use_fast_math is off.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

#: dtype codes shared with csrc/common.cuh
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int8: 4,
    torch.uint16: 5,
    torch.int16: 6,
    torch.int32: 7,
}

#: launches per kernel wrapper (plain integers; reset_launches zeroes them)
LAUNCHES: Dict[str, int] = {
    "fused_inverted_residual": 0,
    "normalize_u8": 0,
    "arith_chain": 0,
    "flash_attention": 0,
    "flash_chunk": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

#: C signatures: every pointer (device or host) and the stream as c_void_p
_SIGNATURES = {
    "nnstpu_normalize_u8": [_P, _P, _LL, _F, _F, _I, _I, _P],
    "nnstpu_arith_chain": [_P, _P, _LL, _I, _I, _P, _P, _I, _I, _F, _F, _I,
                           _P],
    "nnstpu_fused_inverted_residual": [_P, _P, _P, _P, _I, _P, _I, _P],
    "nnstpu_fused_attributes": [_I, _LL, _P],
    "nnstpu_flash_attention": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    "nnstpu_flash_chunk": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "nnstpu_flash_attributes": [_I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
#: seconds the last build took in this process (0.0 when it reused a
#: library built earlier)
build_seconds = 0.0


_recording = threading.local()
#: the replica pool's workers launch from several threads at once
_count_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: into :data:`LAUNCHES`, or into the
    count of the graph this thread is recording."""
    sink = getattr(_recording, "sink", None)
    with _count_lock:
        (LAUNCHES if sink is None else sink)[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches go to the yielded dict
    (one key per kernel) instead of :data:`LAUNCHES`: a CUDA-graph capture
    records launches without running them. Other threads still count
    into :data:`LAUNCHES`."""
    sink = dict.fromkeys(LAUNCHES, 0)
    prev = getattr(_recording, "sink", None)
    _recording.sink = sink
    try:
        yield sink
    finally:
        _recording.sink = prev


#: per thread: where launched kernels bill their plain versions' cost
#: (see :func:`billing`)
_bill = threading.local()


@contextlib.contextmanager
def billing(sink):
    """Within the block, each kernel this thread launches calls
    ``sink(name, plain, args, kwargs)`` with its plain version and the
    launch's arguments: a ``ctypes`` launch is invisible to the
    dispatcher, so the cost model's concrete run (method ``compiled``)
    counts the kernels' work this way."""
    prev = getattr(_bill, "sink", None)
    _bill.sink = sink
    try:
        yield sink
    finally:
        _bill.sink = prev


def bill_launch(name: str, plain, *args, **kwargs) -> None:
    """A launch of kernel ``name``, computing ``plain(*args, **kwargs)``:
    handed to the thread's :func:`billing` sink, if any."""
    sink = getattr(_bill, "sink", None)
    if sink is not None:
        sink(name, plain, args, kwargs)


def on_cpu(x: torch.Tensor) -> bool:
    """The one dispatch rule of every kernel wrapper: the plain PyTorch
    version runs only for a tensor on the CPU; a CUDA tensor goes to the
    kernel. Any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {x.device}")


def plain_route(x: torch.Tensor) -> bool:
    """:func:`on_cpu` for the wrappers of the kernels a filter's
    composition runs (fused block, ``normalize_u8``, ``arith_chain``),
    which also take ``meta`` tensors to their plain versions: the cost
    model's data-free run of the composition (analysis/costmodel.py)
    launches nothing. A CUDA tensor still goes to the kernel."""
    return x.device.type == "meta" or on_cpu(x)


def _sources():
    return sorted(f for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh", ".h")))


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _build(out_dir: str) -> str:
    """Compile each .cu in parallel, then link; returns the library path.
    Serialised across processes by a lock file in ``out_dir``."""
    global build_seconds
    lib_path = os.path.join(out_dir, "libnnstpu_kernels.so")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib_path):
            return lib_path
        t0 = time.perf_counter()
        nvcc = _nvcc()
        cus = [f for f in _sources() if f.endswith(".cu")]
        procs = []
        for f in cus:
            obj = os.path.join(out_dir, f[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c",
                   os.path.join(CSRC, f), "-o", obj]
            procs.append((f, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for f, _, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{f}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = lib_path + f".tmp{os.getpid()}"
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp, lib_path)
        build_seconds = time.perf_counter() - t0
    return lib_path


def library_built() -> bool:
    """Is the kernel library of this tree's sources built already (so the
    first :func:`lib` loads it without ``nvcc``)?"""
    return os.path.exists(os.path.join(BUILD_ROOT, _digest(),
                                       "libnnstpu_kernels.so"))


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path = _build(os.path.join(BUILD_ROOT, _digest()))
            handle = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def refuse_tracing(what: str) -> None:
    """Raise under ``torch.jit.trace``: the tracer cannot see a ``ctypes``
    launch and would record the kernel's output as a constant, so a saved
    program would answer every input with the traced one's result. The
    wrappers on the flagship's path take the TorchScript ops
    (ops/_script_ops.py) under tracing instead."""
    if torch.jit.is_tracing():
        raise RuntimeError(
            f"{what}: a ctypes kernel launch cannot be traced (torch.jit.trace "
            "would record its output as a constant); trace through the "
            "TorchScript op route (ops/_script_ops.py)")


def launcher(what: str) -> ctypes.CDLL:
    """:func:`lib` for a launch of kernel ``what``
    (:func:`refuse_tracing` first)."""
    refuse_tracing(what)
    return lib()


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


#: the named side streams, one per (device, name) a process
_streams: dict = {}
_streams_lock = threading.Lock()


def side_stream(device: torch.device, name: str) -> "torch.cuda.Stream":
    """The CUDA stream ``name`` on ``device``, made once a process and
    reused after: the first GEMM on a stream makes cuBLAS allocate a
    workspace for that stream (32 MiB on the H100) that lives as long as
    the process, so a stream made anew for each window capture or each
    mesh install would hold one more workspace each time."""
    key = (str(device), name)
    with _streams_lock:
        s = _streams.get(key)
        if s is None:
            s = _streams[key] = torch.cuda.Stream(device)
        return s


def stream_handle(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
