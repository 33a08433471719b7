"""Build, load and call the TorchScript op library over the hand-written
kernels (``csrc/torch_ops.cc``).

A ``ctypes`` launch is invisible to ``torch.jit.trace``, which would record
the kernel's output as a constant. So under tracing the kernel wrappers on
the flagship's path (ops/fused_block.py ``fused_inverted_residual``,
ops/preprocess.py ``normalize_u8``) take these ops on a CUDA tensor, and
a frozen program (filters/aot.py ``native_aot_compile``) calls the
kernels through them, from Python or from a C++ process
(``csrc/native_exec.cc``) alike. Each op calls the same C entry point with
the same arguments as the ``ctypes`` wrapper, so the two routes give the
same bits.

The library is built at first use, never at import: ``g++`` against
torch's headers and the CUDA toolkit's, linked to libtorch and the kernel
library (ops/_cuda.py), into ``build/native_torch/ops-<hash>/``. It
counts its launches in C (:func:`launches`): Python's
``_cuda.count_launch`` never sees a launch made from C++.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from nnstreamer_tpu_torch import native_rt
from nnstreamer_tpu_torch.ops import _cuda

SOURCE = os.path.join(_cuda.CSRC, "torch_ops.cc")
NAME = "libnnstpu_torch_ops.so"

#: the C counters' order (csrc/torch_ops.cc Kernel)
KERNELS = ("fused_inverted_residual", "normalize_u8")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _flags():
    if native_rt.cuda_include() is None:
        raise RuntimeError("the TorchScript op library needs torch built for "
                           "CUDA and the CUDA toolkit's headers")
    kdir = os.path.join(_cuda.BUILD_ROOT, _cuda._digest())
    cflags, ldflags = native_rt.torch_flags(cuda=True)
    ldflags += ["-L", kdir, "-lnnstpu_kernels", f"-Wl,-rpath,{kdir}",
                f"-Wl,-soname,{NAME}"]
    return cflags, ldflags


def library_path() -> str:
    """Where :func:`build` puts the library (keyed by the source, the flags
    and the kernel library's digest)."""
    cflags, ldflags = _flags()
    return os.path.join(native_rt.BUILD_ROOT, "ops-" + native_rt.digest(
        [SOURCE], cflags + ldflags), NAME)


def build() -> str:
    """The op library, built at first use (the kernel library it links to
    first). Returns its path."""
    path = library_path()
    cflags, ldflags = _flags()
    # the kernel library (nvcc) builds beside this compile; the link needs it
    with ThreadPoolExecutor(1) as pool:
        kernels = pool.submit(_cuda.lib)
        return native_rt.compile_shared(os.path.dirname(path), NAME, [SOURCE],
                                        cflags, ldflags, "ops",
                                        before_link=kernels.result)


def load() -> ctypes.CDLL:
    """Register the ops with torch (``torch.ops.nnstpu_torch``), building
    the library at first use; returns its handle for the counters."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            torch.ops.load_library(path)
            lib = ctypes.CDLL(path)  # the same object: the counters
            lib.nnstpu_torch_ops_launches.argtypes = [ctypes.c_int]
            lib.nnstpu_torch_ops_launches.restype = ctypes.c_longlong
            lib.nnstpu_torch_ops_reset.argtypes = []
            lib.nnstpu_torch_ops_reset.restype = None
            _lib = lib
        return _lib


def launches() -> Dict[str, int]:
    """Launches made through the ops in this process, per kernel (from
    Python or from C++ alike)."""
    lib = load()
    return {k: int(lib.nnstpu_torch_ops_launches(i))
            for i, k in enumerate(KERNELS)}


def reset_launches() -> None:
    load().nnstpu_torch_ops_reset()


def fused_inverted_residual(x: torch.Tensor, tensors: Dict[str, torch.Tensor],
                            plan: List[int]) -> torch.Tensor:
    """One fused block through the op: ``tensors`` the block's prepared
    weights (w1 and b1 absent for expand=1), ``plan`` the C entry point's
    fields as ops/fused_block.py ``_launch_fields`` gives them (the op
    passes them on unread)."""
    load()
    return torch.ops.nnstpu_torch.fused_inverted_residual(
        x, tensors.get("w1"), tensors.get("b1"), tensors["wd"],
        tensors["bd"], tensors["w2"], tensors["b2"], plan)


def normalize_u8(x: torch.Tensor, scale: float, offset: float,
                 out_dtype: torch.dtype) -> torch.Tensor:
    load()
    return torch.ops.nnstpu_torch.normalize_u8(x, float(scale), float(offset),
                                               out_dtype)
