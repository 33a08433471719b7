"""The C ABI of user filter libraries (counterpart of the C ABI half of the
JAX package's ``native_rt.py``).

``native/include/nnstpu/capi.h`` declares the custom-filter vtable a user
``.so`` exports (``nnstpu_custom_filter``) and the tensor descriptors it
reads and writes. These are its ctypes mirrors, and the conversion
between :class:`types.TensorsInfo` and ``nnstpu_tensors_info``; the
``custom`` filter backend (filters/custom.py) drives a library through
them. Building and loading the native pipeline core (``libnnstpu.so``)
and its ``NativePipeline`` are not part of this package.
"""

from __future__ import annotations

import ctypes as C

from nnstreamer_tpu_torch.types import DTYPE_WIRE_IDS, TensorInfo, TensorsInfo

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
