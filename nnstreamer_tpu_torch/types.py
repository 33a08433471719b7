"""L1 tensor type system.

Mirrors the *contracts* of the reference's core data model
(``gst/nnstreamer/include/tensor_typedef.h`` and
``gst/nnstreamer/nnstreamer_plugin_api_util_impl.c``) with a TPU-first
representation: dims are kept innermost-first (the reference's
``d0:d1:d2:d3`` grammar, d0 fastest-varying), dtypes map to numpy/jax
dtypes (bfloat16 added for TPU), and every structure is a plain frozen-ish
dataclass usable inside jit-traced code as static metadata.

Reference contracts implemented here:
  - NNS_TENSOR_RANK_LIMIT = 16          (tensor_typedef.h:34)
  - NNS_TENSOR_SIZE_LIMIT = 256         (tensor_typedef.h:42)
  - tensor_type enum, 11 dtypes + f16   (tensor_typedef.h:138-153)
  - tensor_format static/flexible/sparse (tensor_typedef.h:193-200)
  - tensor_layout ANY/NHWC/NCHW/NONE    (tensor_typedef.h:220-226)
  - GstTensorInfo/GstTensorsInfo/GstTensorsConfig (tensor_typedef.h:261-289)
  - dimension-string parse/format, info compare, size calc
    (nnstreamer_plugin_api_util_impl.c)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# --- limits (tensor_typedef.h:34,42,52) ------------------------------------
NNS_TENSOR_RANK_LIMIT = 16
NNS_TENSOR_SIZE_LIMIT = 256
# The reference splits tensors-per-frame into 16 native memories + "extra"
# spillover (tensor_typedef.h:52). We have no GstMemory, so the only limit
# that survives is the total.


class TensorDType(str, enum.Enum):
    """Element types (tensor_typedef.h:138-153) + bfloat16 for TPU."""

    INT32 = "int32"
    UINT32 = "uint32"
    INT16 = "int16"
    UINT16 = "uint16"
    INT8 = "int8"
    UINT8 = "uint8"
    FLOAT64 = "float64"
    FLOAT32 = "float32"
    INT64 = "int64"
    UINT64 = "uint64"
    FLOAT16 = "float16"
    # TPU-native addition: the MXU's preferred dtype. Not in the reference.
    BFLOAT16 = "bfloat16"

    @property
    def np_dtype(self) -> np.dtype:
        if self is TensorDType.BFLOAT16:
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.value)

    @property
    def size(self) -> int:
        """Bytes per element."""
        return self.np_dtype.itemsize

    @classmethod
    def from_any(cls, v: Union[str, np.dtype, "TensorDType", type]) -> "TensorDType":
        if isinstance(v, TensorDType):
            return v
        if isinstance(v, str):
            return cls(v.lower())
        name = np.dtype(v).name
        return cls(name)


# Stable wire ids for the flexible/sparse binary meta header (meta.py).
# Order follows the reference enum (tensor_typedef.h:138-153); bfloat16
# extends it at the end.
DTYPE_WIRE_IDS: Tuple[TensorDType, ...] = (
    TensorDType.INT32,
    TensorDType.UINT32,
    TensorDType.INT16,
    TensorDType.UINT16,
    TensorDType.INT8,
    TensorDType.UINT8,
    TensorDType.FLOAT64,
    TensorDType.FLOAT32,
    TensorDType.INT64,
    TensorDType.UINT64,
    TensorDType.FLOAT16,
    TensorDType.BFLOAT16,
)


class TensorFormat(str, enum.Enum):
    """Stream data format (tensor_typedef.h:193-200)."""

    STATIC = "static"
    FLEXIBLE = "flexible"
    SPARSE = "sparse"


class TensorLayout(str, enum.Enum):
    """Memory layout hint for backends (tensor_typedef.h:220-226)."""

    ANY = "any"
    NHWC = "nhwc"
    NCHW = "nchw"
    NONE = "none"


Dimension = Tuple[int, ...]


def parse_dimension(dim_str: str) -> Dimension:
    """Parse the reference's dimension grammar ``d0:d1:d2:...`` (up to rank 16).

    d0 is the innermost (fastest-varying) dim — e.g. RGB 224x224 video is
    ``3:224:224:1`` (channel:width:height:batch). Missing trailing dims are
    NOT padded here; rank is the number of stated components with trailing
    1s trimmed down to at least rank 1. ``0`` marks an unfixed (dynamic)
    dim, as in caps negotiation.

    Parity: gst_tensor_parse_dimension (nnstreamer_plugin_api_util_impl.c).
    """
    dim_str = dim_str.strip()
    if not dim_str:
        raise ValueError("empty dimension string")
    parts = dim_str.split(":")
    if len(parts) > NNS_TENSOR_RANK_LIMIT:
        raise ValueError(
            f"rank {len(parts)} exceeds NNS_TENSOR_RANK_LIMIT={NNS_TENSOR_RANK_LIMIT}"
        )
    dims = []
    for p in parts:
        p = p.strip()
        n = int(p)
        if n < 0:
            raise ValueError(f"negative dimension {n!r} in {dim_str!r}")
        dims.append(n)
    return tuple(dims)


def dimension_to_string(dims: Sequence[int], *, pad_rank: int = 0) -> str:
    """Format dims back to the ``d0:d1:...`` grammar.

    Trailing 1s beyond ``pad_rank`` are trimmed, and short dims are 1-padded
    up to ``pad_rank`` (the reference's padded-print variant of
    gst_tensor_get_dimension_string).
    """
    dims = list(dims) if dims else [1]
    while len(dims) > max(1, pad_rank) and dims[-1] == 1:
        dims.pop()
    while len(dims) < pad_rank:
        dims.append(1)
    return ":".join(str(d) for d in dims)


def dimension_is_fixed(dims: Sequence[int]) -> bool:
    """A dimension is fixed (negotiable to a concrete shape) iff all >0."""
    return len(dims) > 0 and all(d > 0 for d in dims)


def dimension_compatible(a: Sequence[int], b: Sequence[int]) -> bool:
    """True if dims match, treating 0 as a wildcard and padding with 1s."""
    la, lb = list(a), list(b)
    n = max(len(la), len(lb))
    la += [1] * (n - len(la))
    lb += [1] * (n - len(lb))
    for x, y in zip(la, lb):
        if x == 0 or y == 0:
            continue
        if x != y:
            return False
    return True


def element_count(dims: Sequence[int]) -> int:
    n = 1
    for d in dims:
        n *= max(d, 1) if d > 0 else 0
    return n


@dataclass
class TensorInfo:
    """Info for one tensor: name, dtype, dims (GstTensorInfo, tensor_typedef.h:261-267)."""

    dims: Dimension = ()
    dtype: TensorDType = TensorDType.FLOAT32
    name: Optional[str] = None

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        self.dtype = TensorDType.from_any(self.dtype)
        if len(self.dims) > NNS_TENSOR_RANK_LIMIT:
            raise ValueError(f"rank {len(self.dims)} > {NNS_TENSOR_RANK_LIMIT}")

    # -- derived -----------------------------------------------------------
    @property
    def size(self) -> int:
        """Byte size of one frame of this tensor (0 if unfixed)."""
        if not self.is_fixed():
            return 0
        return element_count(self.dims) * self.dtype.size

    def is_fixed(self) -> bool:
        return dimension_is_fixed(self.dims)

    def np_shape(self) -> Tuple[int, ...]:
        """Numpy/JAX shape: outermost-first — reverse of the d0-first grammar,
        with trailing 1s trimmed. ``3:224:224:1`` → (224, 224, 3)."""
        dims = list(self.dims)
        while len(dims) > 1 and dims[-1] == 1:
            dims.pop()
        return tuple(reversed(dims))

    @classmethod
    def from_np_shape(
        cls, shape: Sequence[int], dtype="float32", name: Optional[str] = None
    ) -> "TensorInfo":
        return cls(dims=tuple(reversed([int(s) for s in shape])) or (1,),
                   dtype=TensorDType.from_any(dtype), name=name)

    # -- (de)serialization -------------------------------------------------
    def to_string(self) -> str:
        return f"{dimension_to_string(self.dims)}/{self.dtype.value}"

    def __eq__(self, other) -> bool:
        if not isinstance(other, TensorInfo):
            return NotImplemented
        return (
            self.dtype == other.dtype
            and dimension_compatible(self.dims, other.dims)
            and dimension_is_fixed(self.dims) == dimension_is_fixed(other.dims)
        )

    def validate(self) -> bool:
        return self.is_fixed()

    def signature(self) -> Tuple:
        """Strict hashable identity (dims+dtype) — the key for
        compile-per-shape caches, where 0-wildcard equivalence must NOT
        collide distinct concrete shapes."""
        return ("TensorInfo", self.dims, self.dtype)

    # __eq__ is wildcard-aware (0 matches anything), so the hash may only
    # cover fields equal objects always share: the dtype.
    def __hash__(self) -> int:
        return hash(("TensorInfo", self.dtype))


@dataclass
class TensorsInfo:
    """Info for a frame of up to NNS_TENSOR_SIZE_LIMIT tensors
    (GstTensorsInfo, tensor_typedef.h:273-280)."""

    tensors: List[TensorInfo] = field(default_factory=list)
    format: TensorFormat = TensorFormat.STATIC

    def __post_init__(self):
        self.tensors = [
            t if isinstance(t, TensorInfo) else TensorInfo(**t) for t in self.tensors
        ]
        if len(self.tensors) > NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(
                f"{len(self.tensors)} tensors > NNS_TENSOR_SIZE_LIMIT={NNS_TENSOR_SIZE_LIMIT}"
            )
        if isinstance(self.format, str):
            self.format = TensorFormat(self.format)

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def __len__(self) -> int:
        return len(self.tensors)

    def __getitem__(self, i: int) -> TensorInfo:
        return self.tensors[i]

    def __iter__(self):
        return iter(self.tensors)

    def is_fixed(self) -> bool:
        if self.format != TensorFormat.STATIC:
            return True  # flexible/sparse streams are self-describing
        return self.num_tensors > 0 and all(t.is_fixed() for t in self.tensors)

    def frame_size(self) -> int:
        return sum(t.size for t in self.tensors)

    # -- string grammar (caps fields) --------------------------------------
    def dimensions_string(self) -> str:
        """``3:224:224:1.1000:1`` — '.'-joined per-tensor dims
        (GST_TENSORS_CAP_MAKE 'dimensions', tensor_typedef.h:97-100)."""
        return ".".join(dimension_to_string(t.dims) for t in self.tensors)

    def types_string(self) -> str:
        return ".".join(t.dtype.value for t in self.tensors)

    def names_string(self) -> str:
        return ",".join((t.name or "") for t in self.tensors)

    @classmethod
    def from_strings(
        cls,
        dimensions: str,
        types: str,
        names: Optional[str] = None,
        format: TensorFormat = TensorFormat.STATIC,
    ) -> "TensorsInfo":
        """Parse the caps-field grammar (gst_tensors_info_parse_*_string in
        nnstreamer_plugin_api_util_impl.c)."""
        dim_parts = [d for d in dimensions.split(".") if d.strip()] if dimensions else []
        type_parts = [t.strip() for t in types.split(".") if t.strip()] if types else []
        if len(dim_parts) != len(type_parts):
            raise ValueError(
                f"num dimensions ({len(dim_parts)}) != num types ({len(type_parts)})"
            )
        name_parts: List[Optional[str]] = [None] * len(dim_parts)
        if names:
            given = [n.strip() or None for n in names.split(",")]
            for i, n in enumerate(given[: len(name_parts)]):
                name_parts[i] = n
        return cls(
            tensors=[
                TensorInfo(dims=parse_dimension(d), dtype=TensorDType.from_any(t), name=n)
                for d, t, n in zip(dim_parts, type_parts, name_parts)
            ],
            format=format,
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, TensorsInfo):
            return NotImplemented
        if self.format != other.format:
            return False
        if self.format != TensorFormat.STATIC:
            return True
        if self.num_tensors != other.num_tensors:
            return False
        return all(a == b for a, b in zip(self.tensors, other.tensors))

    def copy(self) -> "TensorsInfo":
        return TensorsInfo(
            tensors=[TensorInfo(t.dims, t.dtype, t.name) for t in self.tensors],
            format=self.format,
        )

    def signature(self) -> Tuple:
        """Strict hashable identity for compile caches."""
        return ("TensorsInfo", self.format, tuple(t.signature() for t in self.tensors))

    def __hash__(self) -> int:
        # consistent with __eq__: flexible/sparse compare equal regardless of
        # tensors; static equality implies same count + dtypes
        if self.format != TensorFormat.STATIC:
            return hash(("TensorsInfo", self.format))
        return hash(("TensorsInfo", self.format, tuple(t.dtype for t in self.tensors)))


@dataclass
class TensorsConfig:
    """Stream config: info + framerate (GstTensorsConfig, tensor_typedef.h:283-289)."""

    info: TensorsInfo = field(default_factory=TensorsInfo)
    rate_n: int = -1  # framerate numerator (-1 = unknown)
    rate_d: int = -1

    def is_fixed(self) -> bool:
        return self.info.is_fixed() and self.rate_d > 0 and self.rate_n >= 0

    @property
    def format(self) -> TensorFormat:
        return self.info.format

    def frame_duration_ns(self) -> Optional[int]:
        if self.rate_n > 0 and self.rate_d > 0:
            return int(1e9 * self.rate_d / self.rate_n)
        return None

    def __eq__(self, other) -> bool:
        if not isinstance(other, TensorsConfig):
            return NotImplemented
        if self.info != other.info:
            return False
        # unknown framerates compare equal to anything (util_impl semantics)
        if self.rate_n < 0 or other.rate_n < 0 or self.rate_d < 0 or other.rate_d < 0:
            return True
        return self.rate_n * other.rate_d == other.rate_n * self.rate_d

    def copy(self) -> "TensorsConfig":
        return TensorsConfig(info=self.info.copy(), rate_n=self.rate_n, rate_d=self.rate_d)

    def signature(self) -> Tuple:
        return ("TensorsConfig", self.info.signature(), self.rate_n, self.rate_d)

    def __hash__(self) -> int:
        # rates with unknowns compare equal to anything → hash info only
        return hash(("TensorsConfig", self.info))


def tensors_info_from_arrays(arrays: Iterable[np.ndarray]) -> TensorsInfo:
    """Derive a static TensorsInfo from concrete ndarray frames."""
    return TensorsInfo(
        tensors=[TensorInfo.from_np_shape(a.shape, a.dtype) for a in arrays]
    )
