"""Dtype token table for the native-PJRT signature sidecar.

Single Python-side source of truth shared by the writer
(the JAX package's ``filters/aot_worker.py``) and the reader/harness
(``tools/pjrt_native.py``); a copy, so this package imports nothing of
the JAX package.
The C++ twin is ``kDtypes`` in native/src/pjrt_filter.cc — keep the two
in sync when adding a dtype (the sidecar format couples them).
"""

from __future__ import annotations

import numpy as np

TOKEN_OF_NP = {
    "int32": "i32", "uint32": "u32", "int16": "i16", "uint16": "u16",
    "int8": "i8", "uint8": "u8", "float64": "f64", "float32": "f32",
    "int64": "i64", "uint64": "u64", "float16": "f16", "bfloat16": "bf16",
}

NP_OF_TOKEN = {v: k for k, v in TOKEN_OF_NP.items()}


def token_of(dtype) -> str:
    name = np.dtype(dtype).name
    if name not in TOKEN_OF_NP:
        raise ValueError(f"dtype {dtype} unsupported by the native sidecar")
    return TOKEN_OF_NP[name]


def np_dtype_of(token: str) -> np.dtype:
    name = NP_OF_TOKEN.get(token)
    if name is None:
        raise ValueError(f"unknown sidecar dtype token {token!r}")
    if name == "bfloat16":
        import ml_dtypes  # registers the numpy bfloat16 dtype

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)
