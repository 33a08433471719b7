"""A reader for the parts of the TFLite flatbuffer schema the importer
reads (tools/import_tflite.py), and a flexbuffer map reader for custom-op
options — no TensorFlow and no ``flatbuffers`` package needed.

The JAX package reads ``.tflite`` files through TensorFlow's generated
object API (``schema_py_generated.ModelT``) and the custom options of
``TFLite_Detection_PostProcess`` through ``flatbuffers.flexbuffers``;
neither is installed where the port runs. :func:`read_model` decodes the
flatbuffer's tables straight from the bytes and returns objects with the
object API's attribute names and defaults (``model.subgraphs[0]
.operators[i].builtinOptions.strideH``), numpy arrays where the object
API gives numpy arrays. The field slots below are the schema's
(tensorflow/lite/schema/schema.fbs, as TensorFlow's
``schema_py_generated`` numbers them).

Flatbuffer layout, as read here: a table at ``pos`` starts with an int32
``soffset`` to its vtable (``vtable = pos - soffset``); the vtable holds
uint16 [vtable bytes, table bytes, field offsets...], field ``slot`` at
``vtable + 4 + 2 * slot``, 0 when absent (the default applies). Strings,
vectors and sub-tables sit behind a uint32 offset relative to the field;
a vector's uint32 length precedes its elements.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: BuiltinOperator names by code (schema.fbs ``enum BuiltinOperator``)
BUILTIN_OPERATORS: Tuple[str, ...] = tuple("""
    ADD AVERAGE_POOL_2D CONCATENATION CONV_2D DEPTHWISE_CONV_2D
    DEPTH_TO_SPACE DEQUANTIZE EMBEDDING_LOOKUP FLOOR FULLY_CONNECTED
    HASHTABLE_LOOKUP L2_NORMALIZATION L2_POOL_2D
    LOCAL_RESPONSE_NORMALIZATION LOGISTIC LSH_PROJECTION LSTM MAX_POOL_2D
    MUL RELU RELU_N1_TO_1 RELU6 RESHAPE RESIZE_BILINEAR RNN SOFTMAX
    SPACE_TO_DEPTH SVDF TANH CONCAT_EMBEDDINGS SKIP_GRAM CALL CUSTOM
    EMBEDDING_LOOKUP_SPARSE PAD UNIDIRECTIONAL_SEQUENCE_RNN GATHER
    BATCH_TO_SPACE_ND SPACE_TO_BATCH_ND TRANSPOSE MEAN SUB DIV SQUEEZE
    UNIDIRECTIONAL_SEQUENCE_LSTM STRIDED_SLICE BIDIRECTIONAL_SEQUENCE_RNN
    EXP TOPK_V2 SPLIT LOG_SOFTMAX DELEGATE BIDIRECTIONAL_SEQUENCE_LSTM CAST
    PRELU MAXIMUM ARG_MAX MINIMUM LESS NEG PADV2 GREATER GREATER_EQUAL
    LESS_EQUAL SELECT SLICE SIN TRANSPOSE_CONV SPARSE_TO_DENSE TILE
    EXPAND_DIMS EQUAL NOT_EQUAL LOG SUM SQRT RSQRT SHAPE POW ARG_MIN
    FAKE_QUANT REDUCE_PROD REDUCE_MAX PACK LOGICAL_OR ONE_HOT LOGICAL_AND
    LOGICAL_NOT UNPACK REDUCE_MIN FLOOR_DIV REDUCE_ANY SQUARE ZEROS_LIKE
    FILL FLOOR_MOD RANGE RESIZE_NEAREST_NEIGHBOR LEAKY_RELU
    SQUARED_DIFFERENCE MIRROR_PAD ABS SPLIT_V UNIQUE CEIL REVERSE_V2 ADD_N
    GATHER_ND COS WHERE RANK ELU REVERSE_SEQUENCE MATRIX_DIAG QUANTIZE
    MATRIX_SET_DIAG ROUND HARD_SWISH IF WHILE NON_MAX_SUPPRESSION_V4
    NON_MAX_SUPPRESSION_V5 SCATTER_ND SELECT_V2 DENSIFY SEGMENT_SUM
    BATCH_MATMUL PLACEHOLDER_FOR_GREATER_OP_CODES CUMSUM CALL_ONCE
    BROADCAST_TO RFFT2D CONV_3D IMAG REAL COMPLEX_ABS HASHTABLE
    HASHTABLE_FIND HASHTABLE_IMPORT HASHTABLE_SIZE REDUCE_ALL
    CONV_3D_TRANSPOSE VAR_HANDLE READ_VARIABLE ASSIGN_VARIABLE
    BROADCAST_ARGS RANDOM_STANDARD_NORMAL BUCKETIZE RANDOM_UNIFORM
    MULTINOMIAL GELU DYNAMIC_UPDATE_SLICE RELU_0_TO_1 UNSORTED_SEGMENT_PROD
    UNSORTED_SEGMENT_MAX UNSORTED_SEGMENT_SUM ATAN2 UNSORTED_SEGMENT_MIN
    SIGN BITCAST BITWISE_XOR RIGHT_SHIFT STABLEHLO_LOGISTIC STABLEHLO_ADD
    STABLEHLO_DIVIDE STABLEHLO_MULTIPLY STABLEHLO_MAXIMUM STABLEHLO_RESHAPE
    STABLEHLO_CLAMP STABLEHLO_CONCATENATE STABLEHLO_BROADCAST_IN_DIM
    STABLEHLO_CONVOLUTION STABLEHLO_SLICE STABLEHLO_CUSTOM_CALL
    STABLEHLO_REDUCE STABLEHLO_ABS STABLEHLO_AND STABLEHLO_COSINE
    STABLEHLO_EXPONENTIAL STABLEHLO_FLOOR STABLEHLO_LOG STABLEHLO_MINIMUM
    STABLEHLO_NEGATE STABLEHLO_OR STABLEHLO_POWER STABLEHLO_REMAINDER
    STABLEHLO_RSQRT STABLEHLO_SELECT STABLEHLO_SUBTRACT STABLEHLO_TANH
    STABLEHLO_SCATTER STABLEHLO_COMPARE STABLEHLO_CONVERT
    STABLEHLO_DYNAMIC_SLICE STABLEHLO_DYNAMIC_UPDATE_SLICE STABLEHLO_PAD
    STABLEHLO_IOTA STABLEHLO_DOT_GENERAL STABLEHLO_REDUCE_WINDOW
    STABLEHLO_SORT STABLEHLO_WHILE STABLEHLO_GATHER STABLEHLO_TRANSPOSE
    DILATE STABLEHLO_RNG_BIT_GENERATOR REDUCE_WINDOW STABLEHLO_COMPOSITE
    STABLEHLO_SHIFT_LEFT STABLEHLO_CBRT STABLEHLO_CASE
""".split())

#: BuiltinOperator codes by name
BuiltinOperator = SimpleNamespace(
    **{name: code for code, name in enumerate(BUILTIN_OPERATORS)})

# builtin-options tables the importer reads: union code → (table name,
# ((slot, attribute, kind, default), ...)); kind: a struct format letter
# for a scalar, "[i" for a vector of int32
_I8, _I32, _F32, _BOOL = "b", "i", "f", "?"
_OPTIONS: Dict[int, Tuple[str, Tuple[Tuple[int, str, str, Any], ...]]] = {
    1: ("Conv2DOptions", (
        (0, "padding", _I8, 0), (1, "strideW", _I32, 0),
        (2, "strideH", _I32, 0), (3, "fusedActivationFunction", _I8, 0),
        (4, "dilationWFactor", _I32, 1), (5, "dilationHFactor", _I32, 1),
        (6, "quantizedBiasType", _I8, 0))),
    2: ("DepthwiseConv2DOptions", (
        (0, "padding", _I8, 0), (1, "strideW", _I32, 0),
        (2, "strideH", _I32, 0), (3, "depthMultiplier", _I32, 0),
        (4, "fusedActivationFunction", _I8, 0),
        (5, "dilationWFactor", _I32, 1), (6, "dilationHFactor", _I32, 1))),
    5: ("Pool2DOptions", (
        (0, "padding", _I8, 0), (1, "strideW", _I32, 0),
        (2, "strideH", _I32, 0), (3, "filterWidth", _I32, 0),
        (4, "filterHeight", _I32, 0),
        (5, "fusedActivationFunction", _I8, 0))),
    8: ("FullyConnectedOptions", (
        (0, "fusedActivationFunction", _I8, 0), (1, "weightsFormat", _I8, 0),
        (2, "keepNumDims", _BOOL, False),
        (3, "asymmetricQuantizeInputs", _BOOL, False),
        (4, "quantizedBiasType", _I8, 0))),
    9: ("SoftmaxOptions", ((0, "beta", _F32, 0.0),)),
    10: ("ConcatenationOptions", (
        (0, "axis", _I32, 0), (1, "fusedActivationFunction", _I8, 0))),
    11: ("AddOptions", (
        (0, "fusedActivationFunction", _I8, 0),
        (1, "potScaleInt16", _BOOL, True))),
    15: ("ResizeBilinearOptions", (
        (2, "alignCorners", _BOOL, False),
        (3, "halfPixelCenters", _BOOL, False))),
    17: ("ReshapeOptions", ((0, "newShape", "[i", None),)),
    21: ("MulOptions", ((0, "fusedActivationFunction", _I8, 0),)),
    22: ("PadOptions", ()),
    27: ("ReducerOptions", ((0, "keepDims", _BOOL, False),)),
    28: ("SubOptions", (
        (0, "fusedActivationFunction", _I8, 0),
        (1, "potScaleInt16", _BOOL, True))),
    29: ("DivOptions", ((0, "fusedActivationFunction", _I8, 0),)),
    30: ("SqueezeOptions", ((0, "squeezeDims", "[i", None),)),
    40: ("ArgMaxOptions", ((0, "outputType", _I8, 0),)),
    49: ("TransposeConvOptions", (
        (0, "padding", _I8, 0), (1, "strideW", _I32, 0),
        (2, "strideH", _I32, 0), (3, "fusedActivationFunction", _I8, 0),
        (4, "quantizedBiasType", _I8, 0))),
    74: ("ResizeNearestNeighborOptions", (
        (0, "alignCorners", _BOOL, False),
        (1, "halfPixelCenters", _BOOL, False))),
}

#: union code → options table name, for the tables listed above
OPTIONS_TABLES: Dict[int, str] = {k: v[0] for k, v in _OPTIONS.items()}


class _Buf:
    """Flatbuffer table access over one ``bytes`` object."""

    def __init__(self, data: bytes):
        self.data = data
        self.mv = memoryview(data)

    def u32(self, pos: int) -> int:
        return struct.unpack_from("<I", self.data, pos)[0]

    def field(self, table: int, slot: int) -> int:
        """Absolute position of ``slot``'s value in ``table``, 0 if absent."""
        vt = table - struct.unpack_from("<i", self.data, table)[0]
        vt_len = struct.unpack_from("<H", self.data, vt)[0]
        at = 4 + 2 * slot
        if at >= vt_len:
            return 0
        off = struct.unpack_from("<H", self.data, vt + at)[0]
        return table + off if off else 0

    def scalar(self, table: int, slot: int, fmt: str, default):
        p = self.field(table, slot)
        if not p:
            return default
        v = struct.unpack_from("<" + fmt, self.data, p)[0]
        return bool(v) if fmt == "?" else v

    def deref(self, table: int, slot: int) -> int:
        """Position a string/vector/table field points at, 0 if absent."""
        p = self.field(table, slot)
        return p + self.u32(p) if p else 0

    def vector(self, table: int, slot: int, dtype) -> Optional[np.ndarray]:
        """A vector of scalars as a numpy view of the bytes (None if
        absent)."""
        p = self.deref(table, slot)
        if not p:
            return None
        n = self.u32(p)
        return np.frombuffer(self.mv, dtype=np.dtype(dtype).newbyteorder("<"),
                             count=n, offset=p + 4)

    def tables(self, table: int, slot: int) -> Optional[List[int]]:
        """A vector of tables as their positions (None if absent)."""
        p = self.deref(table, slot)
        if not p:
            return None
        n = self.u32(p)
        return [p + 4 + 4 * i + self.u32(p + 4 + 4 * i) for i in range(n)]

    def string(self, table: int, slot: int) -> Optional[bytes]:
        p = self.deref(table, slot)
        if not p:
            return None
        return bytes(self.mv[p + 4:p + 4 + self.u32(p)])


def _options(b: _Buf, table: int, code: int):
    """The builtin-options table of union ``code`` at ``table`` as an
    object with the object API's attributes and defaults. A table this
    reader has no layout for comes back with none (the importer does not
    read its fields)."""
    name, fields = _OPTIONS.get(code, (f"BuiltinOptions{code}", ()))
    ns = SimpleNamespace()
    for slot, attr, kind, default in fields:
        if kind == "[i":
            setattr(ns, attr, b.vector(table, slot, np.int32))
        else:
            setattr(ns, attr, b.scalar(table, slot, kind, default))
    ns.table = name
    return ns


def read_model(data: bytes):
    """Decode a ``.tflite`` flatbuffer: the Model with its operator codes,
    subgraphs (tensors, inputs, outputs, operators), buffers and each
    tensor's quantization parameters, under the object API's names.

    A buffer stored outside the flatbuffer (the schema's ``offset`` and
    ``size``, used by models over 2 GB) raises rather than being read
    as empty."""
    data = bytes(data)
    if len(data) < 8:
        raise ValueError("not a TFLite flatbuffer: too short")
    b = _Buf(data)
    root = b.u32(0)
    model = SimpleNamespace(version=b.scalar(root, 0, "I", 0),
                            identifier=data[4:8])
    codes = b.tables(root, 1)
    model.operatorCodes = None if codes is None else [
        SimpleNamespace(
            deprecatedBuiltinCode=b.scalar(t, 0, "b", 0),
            customCode=b.string(t, 1),
            version=b.scalar(t, 2, "i", 1),
            builtinCode=b.scalar(t, 3, "i", 0)) for t in codes]
    bufs = b.tables(root, 4) or []
    model.buffers = []
    for i, t in enumerate(bufs):
        offset = b.scalar(t, 1, "Q", 0)
        if offset > 1:
            raise NotImplementedError(
                f"buffer {i} is stored outside the flatbuffer (offset "
                f"{offset}, size {b.scalar(t, 2, 'Q', 0)}): models over "
                "2 GB are not read by this importer")
        model.buffers.append(SimpleNamespace(
            data=b.vector(t, 0, np.uint8), offset=offset,
            size=b.scalar(t, 2, "Q", 0)))
    model.subgraphs = None
    subs = b.tables(root, 2)
    if subs is not None:
        model.subgraphs = [_subgraph(b, t) for t in subs]
    return model


def _subgraph(b: _Buf, t: int):
    g = SimpleNamespace(inputs=b.vector(t, 1, np.int32),
                        outputs=b.vector(t, 2, np.int32),
                        name=b.string(t, 4))
    g.tensors = [_tensor(b, x) for x in (b.tables(t, 0) or [])]
    ops = b.tables(t, 3)
    g.operators = None if ops is None else [_operator(b, x) for x in ops]
    return g


def _tensor(b: _Buf, t: int):
    q = b.deref(t, 4)
    quant = None
    if q:
        quant = SimpleNamespace(
            min=b.vector(q, 0, np.float32), max=b.vector(q, 1, np.float32),
            scale=b.vector(q, 2, np.float32),
            zeroPoint=b.vector(q, 3, np.int64),
            quantizedDimension=b.scalar(q, 6, "i", 0))
    return SimpleNamespace(
        shape=b.vector(t, 0, np.int32), type=b.scalar(t, 1, "b", 0),
        buffer=b.scalar(t, 2, "I", 0), name=b.string(t, 3),
        quantization=quant, isVariable=b.scalar(t, 5, "?", False))


def _operator(b: _Buf, t: int):
    opt_type = b.scalar(t, 3, "B", 0)
    opt = b.deref(t, 4)
    return SimpleNamespace(
        opcodeIndex=b.scalar(t, 0, "I", 0),
        inputs=b.vector(t, 1, np.int32), outputs=b.vector(t, 2, np.int32),
        builtinOptionsType=opt_type,
        builtinOptions=(_options(b, opt, opt_type)
                        if opt and opt_type else None),
        customOptions=b.vector(t, 5, np.uint8),
        customOptionsFormat=b.scalar(t, 6, "b", 0))


# -- flexbuffers ------------------------------------------------------------
# value types (flexbuffers.h ``Type``)
_FB_NULL, _FB_INT, _FB_UINT, _FB_FLOAT, _FB_KEY, _FB_STRING = range(6)
_FB_INDIRECT_INT, _FB_INDIRECT_UINT, _FB_INDIRECT_FLOAT = 6, 7, 8
_FB_MAP, _FB_VECTOR = 9, 10
_FB_VECTOR_INT, _FB_VECTOR_KEY, _FB_VECTOR_STRING = 11, 14, 15
_FB_BLOB, _FB_BOOL, _FB_VECTOR_BOOL = 25, 26, 36


def _fb_uint(buf: bytes, off: int, width: int) -> int:
    return int.from_bytes(buf[off:off + width], "little")


def _fb_int(buf: bytes, off: int, width: int) -> int:
    return int.from_bytes(buf[off:off + width], "little", signed=True)


def _fb_float(buf: bytes, off: int, width: int) -> float:
    if width == 4:
        return struct.unpack_from("<f", buf, off)[0]
    if width == 8:
        return struct.unpack_from("<d", buf, off)[0]
    raise ValueError(f"flexbuffer float of {width} bytes")


def _fb_cstring(buf: bytes, off: int) -> str:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("utf-8")


def _fb_value(buf: bytes, off: int, parent_width: int, packed: int):
    """The Python value of the flexbuffer reference at ``off``, as
    ``flatbuffers.flexbuffers``' ``Ref.Value`` gives it."""
    typ, width = packed >> 2, 1 << (packed & 3)

    def target() -> int:
        return off - _fb_uint(buf, off, parent_width)

    if typ == _FB_NULL:
        return None
    if typ == _FB_INT:
        return _fb_int(buf, off, parent_width)
    if typ == _FB_UINT:
        return _fb_uint(buf, off, parent_width)
    if typ == _FB_FLOAT:
        return _fb_float(buf, off, parent_width)
    if typ == _FB_BOOL:
        return bool(_fb_uint(buf, off, parent_width))
    if typ == _FB_KEY:
        return _fb_cstring(buf, target())
    if typ == _FB_INDIRECT_INT:
        return _fb_int(buf, target(), width)
    if typ == _FB_INDIRECT_UINT:
        return _fb_uint(buf, target(), width)
    if typ == _FB_INDIRECT_FLOAT:
        return _fb_float(buf, target(), width)
    p = target()
    if typ in (_FB_STRING, _FB_BLOB):
        n = _fb_uint(buf, p - width, width)
        raw = buf[p:p + n]
        return raw.decode("utf-8") if typ == _FB_STRING else raw
    if typ == _FB_MAP:
        n = _fb_uint(buf, p - width, width)
        keys_at = p - 3 * width
        keys = keys_at - _fb_uint(buf, keys_at, width)
        keys_width = _fb_uint(buf, p - 2 * width, width)
        out = {}
        for i in range(n):
            k_at = keys + i * keys_width
            key = _fb_cstring(buf, k_at - _fb_uint(buf, k_at, keys_width))
            out[key] = _fb_value(buf, p + i * width, width,
                                 buf[p + n * width + i])
        return out
    if typ == _FB_VECTOR:
        n = _fb_uint(buf, p - width, width)
        return [_fb_value(buf, p + i * width, width, buf[p + n * width + i])
                for i in range(n)]
    if _FB_VECTOR_INT <= typ <= _FB_VECTOR_STRING or typ == _FB_VECTOR_BOOL:
        elem = (_FB_BOOL if typ == _FB_VECTOR_BOOL
                else typ - _FB_VECTOR_INT + _FB_INT)
        n = _fb_uint(buf, p - width, width)
        return [_fb_value(buf, p + i * width, width, (elem << 2) | (
            packed & 3)) for i in range(n)]
    if 16 <= typ <= 24:  # fixed-length typed vectors of 2, 3 or 4
        elem = (typ - 16) % 3 + _FB_INT
        n = (typ - 16) // 3 + 2
        return [_fb_value(buf, p + i * width, width, (elem << 2) | (
            packed & 3)) for i in range(n)]
    raise ValueError(f"flexbuffer value type {typ} is not read")


def flexbuffer_value(blob: Sequence[int]):
    """The root value of a flexbuffer (a custom op's options): a map as a
    dict, a vector as a list, scalars as Python numbers — what
    ``flexbuffers.GetRoot(blob).Value`` gives."""
    buf = bytes(bytearray(blob))
    if len(buf) < 3:
        raise ValueError("flexbuffer too short")
    width, packed = buf[-1], buf[-2]
    return _fb_value(buf, len(buf) - 2 - width, width, packed)
