"""The model-file importers of the port (nnstreamer_tpu_torch/tools/:
tflite_fb, import_tflite, onnx_lite, import_onnx, _import_common;
testing/model_files) against TensorFlow's generated schema and
interpreter, ``flatbuffers.flexbuffers``, the JAX package's importers
and the port's own zoo module.

Every graph is built here: small Keras models through TF's converter
(one module-scoped fixture each, a conversion costs seconds), torch
modules through ``torch.onnx.export``, a QOperator ``.onnx`` whose
ModelProto bytes the test writes, and MobileNet-v2 at width 0.35, 96 px
from ``model_files``. Float graphs are held at rtol 1e-4, atol 1e-5 (the
reference's own importer tolerance, tests/test_import_tflite.py), a whole
MobileNet-v2 at max abs err 1e-4 with equal argmax (the reference's for
a real model, tests/test_reference_models.py:62);
quantized graphs bit-equal to the JAX importer, except where a float
frame is quantized onto the graph's input grid: the JAX importer's
division by the input scale may be rewritten into a multiply by its
reciprocal, so those outputs are held within one quantization step (the
JAX docstring's own allowance, import_tflite.py:54-59). Pipelines run
with ``accelerator=true:cpu``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
tf = pytest.importorskip("tensorflow")

from nnstreamer_tpu.tools import import_onnx as j_onnx  # noqa: E402
from nnstreamer_tpu.tools import import_tflite as j_tflite  # noqa: E402
from nnstreamer_tpu.tools import onnx_lite as j_onnx_lite  # noqa: E402
from nnstreamer_tpu_torch.testing import model_files  # noqa: E402
from nnstreamer_tpu_torch.tools import import_onnx as p_onnx  # noqa: E402
from nnstreamer_tpu_torch.tools import import_tflite as p_tflite  # noqa: E402
from nnstreamer_tpu_torch.tools import onnx_lite as p_onnx_lite  # noqa: E402
from nnstreamer_tpu_torch.tools import tflite_fb  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
#: a whole model's logits (MobileNet-v2's 52 convolutions): the
#: reference's tolerance for a real model against the interpreter, max
#: abs err 1e-4 with the decisions identical
#: (tests/test_reference_models.py:62)
MODEL_ATOL = 1e-4


def _same_model_logits(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_ATOL)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))


def _convert(model, path, quantize=None):
    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    if quantize is not None:
        conv.optimizations = [tf.lite.Optimize.DEFAULT]
        conv.representative_dataset = quantize
        conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        conv.inference_input_type = tf.int8
        conv.inference_output_type = tf.int8
    with open(path, "wb") as f:
        f.write(conv.convert())
    return str(path)


def _mobilenet_like(inp_hw=32):
    inp = tf.keras.Input((inp_hw, inp_hw, 3), batch_size=1)
    x = tf.keras.layers.Conv2D(8, 3, strides=2, padding="same")(inp)
    x = tf.keras.layers.ReLU(max_value=6.0)(x)
    y = tf.keras.layers.DepthwiseConv2D(3, padding="same")(x)
    y = tf.keras.layers.ReLU(max_value=6.0)(y)
    y = tf.keras.layers.Conv2D(8, 1)(y)
    x = tf.keras.layers.Add()([x, y])
    return inp, x


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every .tflite the tests read, by name (TF's converter, once)."""
    d = tmp_path_factory.mktemp("tflite")
    out = {}
    inp, x = _mobilenet_like()
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    x = tf.keras.layers.Dense(10)(x)
    x = tf.keras.layers.Softmax()(x)
    out["tiny"] = _convert(tf.keras.Model(inp, x), d / "tiny.tflite")

    inp = tf.keras.Input((12, 12, 3), batch_size=1)
    x = tf.keras.layers.MaxPooling2D(3, strides=2, padding="same")(inp)
    y = tf.keras.layers.AveragePooling2D(3, strides=2, padding="same")(inp)
    x = tf.keras.layers.Concatenate()([x, y])
    x = tf.keras.layers.ZeroPadding2D(((1, 0), (0, 2)))(x)
    x = tf.keras.layers.Reshape((-1, 6))(x)
    x = tf.keras.layers.Activation("sigmoid")(x)
    out["pools"] = _convert(tf.keras.Model(inp, x), d / "pools.tflite")

    for k, s, pad in ((3, 2, "same"), (4, 2, "same"), (3, 1, "valid"),
                      (2, 2, "valid")):
        inp = tf.keras.Input((9, 9, 4), batch_size=1)
        x = tf.keras.layers.Conv2DTranspose(6, k, strides=s, padding=pad)(inp)
        out[f"tconv_{k}_{s}_{pad}"] = _convert(
            tf.keras.Model(inp, x), d / f"tconv_{k}_{s}_{pad}.tflite")

    for name, fn in (
            ("bilinear_ac", lambda t: tf.compat.v1.image.resize_bilinear(
                t, (13, 13), align_corners=True)),
            ("bilinear_hp", lambda t: tf.image.resize(t, (11, 5))),
            ("nearest", lambda t: tf.image.resize(t, (13, 9),
                                                  method="nearest"))):
        inp = tf.keras.Input((7, 7, 3), batch_size=1)
        x = tf.keras.layers.Lambda(fn)(inp)
        out[f"resize_{name}"] = _convert(tf.keras.Model(inp, x),
                                         d / f"resize_{name}.tflite")

    inp = tf.keras.Input((8,), batch_size=1)
    x = tf.keras.layers.Lambda(lambda t: tf.math.cumsum(t, axis=-1))(inp)
    out["cumsum"] = _convert(tf.keras.Model(inp, x), d / "cumsum.tflite")

    inp, x = _mobilenet_like(16)
    x = tf.keras.layers.AveragePooling2D(2)(x)
    x = tf.keras.layers.Flatten()(x)
    x = tf.keras.layers.Dense(10)(x)
    rng = np.random.default_rng(0)

    def rep():
        for _ in range(8):
            yield [rng.normal(0, 1, (1, 16, 16, 3)).astype(np.float32)]

    out["int8"] = _convert(tf.keras.Model(inp, x), d / "int8.tflite", rep)
    out["mbv2"] = model_files.write_mobilenet_v2_tflite(
        str(d / "mbv2.tflite"), MBV2)
    return out


#: the written MobileNet-v2: the zoo's seed 0 at width 0.35, 96 px
MBV2 = {"seed": "0", "width": "0.35", "size": "96"}


def _interp(path, xs):
    it = tf.lite.Interpreter(model_path=path)
    it.allocate_tensors()
    outs = []
    for x in xs:
        it.set_tensor(it.get_input_details()[0]["index"], x[None])
        it.invoke()
        outs.append(it.get_tensor(it.get_output_details()[0]["index"])[0])
    return np.stack(outs)


def _jax_run(bundle, x):
    out = jax.jit(bundle.apply_fn)(bundle.params, x)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return [np.asarray(o) for o in outs]


def _port_run(bundle, x):
    out = bundle.apply_fn(torch.from_numpy(np.ascontiguousarray(x)))
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return [o.numpy() for o in outs]


def _both(path, x, custom=None, load=("tflite",)):
    jmod, pmod = (j_tflite, p_tflite) if load[0] == "tflite" else (j_onnx,
                                                                     p_onnx)
    jl = getattr(jmod, f"load_{load[0]}")
    pl = getattr(pmod, f"load_{load[0]}")
    return (_jax_run(jl(path, dict(custom or {})), x),
            _port_run(pl(path, dict(custom or {}), device="cpu"), x))


# -- the readers ------------------------------------------------------------

def _object_api(path):
    from tensorflow.lite.python import schema_py_generated as s

    with open(path, "rb") as f:
        return s.ModelT.InitFromPackedBuf(bytearray(f.read()), 0)


def _np(v):
    return None if v is None else np.asarray(v).tolist()


@pytest.mark.parametrize("name", ["tiny", "pools", "tconv_3_2_same",
                                  "resize_bilinear_ac", "resize_nearest",
                                  "cumsum", "int8", "mbv2"])
def test_tflite_fb_reads_as_the_generated_schema(files, name):
    """Opcodes, tensors, buffers, quantization, operators and every
    builtin-options field of the importer's tables equal the object API
    of TensorFlow's schema_py_generated."""
    want = _object_api(files[name])
    with open(files[name], "rb") as f:
        got = tflite_fb.read_model(f.read())
    assert [(c.builtinCode, c.deprecatedBuiltinCode, c.customCode)
            for c in got.operatorCodes] == [
        (c.builtinCode, c.deprecatedBuiltinCode, c.customCode)
        for c in want.operatorCodes]
    assert len(got.buffers) == len(want.buffers)
    for gb, wb in zip(got.buffers, want.buffers):
        assert _np(gb.data) == _np(wb.data)
    gs, ws = got.subgraphs[0], want.subgraphs[0]
    assert _np(gs.inputs) == _np(ws.inputs)
    assert _np(gs.outputs) == _np(ws.outputs)
    assert len(gs.tensors) == len(ws.tensors)
    for gt, wt in zip(gs.tensors, ws.tensors):
        assert (_np(gt.shape), gt.type, gt.buffer, gt.name) == (
            _np(wt.shape), wt.type, wt.buffer, wt.name)
        assert (gt.quantization is None) == (wt.quantization is None)
        if wt.quantization is not None:
            for f in ("scale", "zeroPoint", "min", "max"):
                assert _np(getattr(gt.quantization, f)) == _np(
                    getattr(wt.quantization, f)), f
            assert (gt.quantization.quantizedDimension
                    == wt.quantization.quantizedDimension)
    assert len(gs.operators) == len(ws.operators)
    for go, wo in zip(gs.operators, ws.operators):
        assert (go.opcodeIndex, _np(go.inputs), _np(go.outputs),
                go.builtinOptionsType, _np(go.customOptions)) == (
            wo.opcodeIndex, _np(wo.inputs), _np(wo.outputs),
            wo.builtinOptionsType, _np(wo.customOptions))
        if wo.builtinOptions is None:
            assert go.builtinOptions is None
            continue
        if wo.builtinOptionsType not in tflite_fb.OPTIONS_TABLES:
            continue  # a table the importer never reads (CUMSUM's)
        assert go.builtinOptions.table == type(
            wo.builtinOptions).__name__.removesuffix("T")
        for attr, v in vars(wo.builtinOptions).items():
            assert _np(getattr(go.builtinOptions, attr)) == _np(v), attr


def test_builtin_operator_names_are_the_schema_enum():
    from tensorflow.lite.python import schema_py_generated as s

    enum = {v: k for k, v in vars(s.BuiltinOperator).items()
            if isinstance(v, int) and not k.startswith("_")}
    assert dict(enumerate(tflite_fb.BUILTIN_OPERATORS)) == enum
    assert tflite_fb.OPTIONS_TABLES == {
        v: k for k, v in vars(s.BuiltinOptions).items()
        if k in tflite_fb.OPTIONS_TABLES.values()}


def _flex_blobs():
    from flatbuffers import flexbuffers

    out = []
    fbb = flexbuffers.Builder()
    with fbb.Map():  # the detection options blob of test_import_tflite.py:156
        fbb.Int("max_detections", 7)
        fbb.Float("nms_iou_threshold", 0.6)
        fbb.Float("nms_score_threshold", 0.25)
        fbb.Float("y_scale", 10.0)
        fbb.Float("x_scale", 10.0)
        fbb.Float("h_scale", 5.0)
        fbb.Float("w_scale", 5.0)
    out.append(bytes(fbb.Finish()))
    out.append(bytes(flexbuffers.Dumps({
        "use_regular_nms": True, "num_classes": 90, "big": 1 << 40,
        "neg": -300, "name": "postprocess", "scale": 0.1,
        "ints": [1, 2, 3], "mixed": [1, 2.5, "x", False],
        "inner": {"f": 0.5, "blob": b"\x00\x01"}})))
    out.append(bytes(flexbuffers.Dumps([1.5, -2, "s", True, None])))
    return out


@pytest.mark.parametrize("i", range(3))
def test_flexbuffer_reader_matches_flatbuffers(i):
    from flatbuffers import flexbuffers

    blob = _flex_blobs()[i]
    assert tflite_fb.flexbuffer_value(blob) == flexbuffers.GetRoot(
        bytearray(blob)).Value


def test_external_buffer_raises_by_name():
    """A buffer stored outside the flatbuffer (offset/size) is refused,
    not read as empty."""
    W, T = model_files.FlatBufferWriter, model_files.Table
    blob = W().finish(T([(0, "I", 3), (4, "tables", [
        T([]), T([(1, "Q", 4096), (2, "Q", 64)])])]), b"TFL3")
    assert _object_api_bytes(blob).buffers[1].offset == 4096
    with pytest.raises(NotImplementedError, match="outside the flatbuffer"):
        tflite_fb.read_model(blob)


def _object_api_bytes(blob):
    from tensorflow.lite.python import schema_py_generated as s

    return s.ModelT.InitFromPackedBuf(bytearray(blob), 0)


# -- onnx ---------------------------------------------------------------

class _SmallNet(torch.nn.Module):
    """Conv/BN/ReLU6/dw-conv/pool/linear (test_import_onnx.py's)."""

    def __init__(self):
        super().__init__()
        self.c1 = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.bn = torch.nn.BatchNorm2d(8)
        self.dw = torch.nn.Conv2d(8, 8, 3, padding=1, groups=8)
        self.pw = torch.nn.Conv2d(8, 16, 1)
        self.fc = torch.nn.Linear(16, 10)

    def forward(self, x):
        x = torch.nn.functional.relu6(self.bn(self.c1(x)))
        x = torch.nn.functional.relu(self.dw(x) + 0.0)
        x = self.pw(x)
        x = torch.nn.functional.adaptive_avg_pool2d(x, 1)
        x = torch.flatten(x, 1)
        return torch.softmax(self.fc(x), dim=-1)


class _PoolPadPermute(torch.nn.Module):
    def forward(self, x):
        x = torch.nn.functional.max_pool2d(x, 2, stride=2)
        x = torch.nn.functional.pad(x, (1, 1, 0, 0))
        return x.permute(0, 2, 3, 1)


class _CumSum(torch.nn.Module):
    def forward(self, x):
        return torch.cumsum(x, dim=-1)


def _export(module, x, path):
    module.eval()
    with model_files._no_onnxscript():
        torch.onnx.export(module, (x,), path, opset_version=13,
                          input_names=["in0"], output_names=["out0"],
                          do_constant_folding=True, dynamo=False)
    return str(path)


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        out += bytes([b | (0x80 if v else 0)])
        if not v:
            return out


def _field(num: int, payload) -> bytes:
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(payload, int):
        return _varint(num << 3) + _varint(payload)
    if isinstance(payload, str):
        payload = payload.encode()
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _tensor_proto(name, arr):
    dt = {np.float32: 1, np.uint8: 2, np.int8: 3, np.int32: 6,
          np.int64: 7}[arr.dtype.type]
    return (b"".join(_field(1, int(d)) for d in arr.shape) + _field(2, dt)
            + _field(8, name) + _field(9, np.ascontiguousarray(arr).tobytes()))


def _value_info(name, elem, dims):
    shape = b"".join(_field(1, _field(1, d)) for d in dims)
    return _field(1, name) + _field(2, _field(1, _field(1, elem)
                                               + _field(2, shape)))


def _node(op, inputs, outputs, ints=None, i=None, domain=""):
    out = b"".join(_field(1, s) for s in inputs)
    out += b"".join(_field(2, s) for s in outputs) + _field(4, op)
    for k, v in (ints or {}).items():
        out += _field(5, _field(1, k) + b"".join(_field(8, x) for x in v)
                      + _field(20, 7))
    for k, v in (i or {}).items():
        out += _field(5, _field(1, k) + _field(3, v) + _field(20, 2))
    if domain:
        out += _field(7, domain)
    return out


def _qoperator_onnx(path, rng):
    """QuantizeLinear → QLinearConv (per-axis weight scales, int32 bias)
    → QLinearAdd (com.microsoft) of that and a 1x1 QLinearConv →
    QLinearGlobalAveragePool → reshape → QLinearMatMul → DequantizeLinear:
    the op set of the reference's mobilenet_v2_quant.onnx."""
    inits = {
        "x_s": np.array(0.02, np.float32), "x_zp": np.array(128, np.uint8),
        "w1": rng.integers(-100, 100, (8, 3, 3, 3)).astype(np.int8),
        "w1_s": rng.uniform(0.002, 0.01, 8).astype(np.float32),
        "w1_zp": np.zeros(8, np.int8),
        "b1": rng.integers(-2000, 2000, 8).astype(np.int32),
        "y1_s": np.array(0.05, np.float32), "y1_zp": np.array(0, np.uint8),
        "w2": rng.integers(-100, 100, (8, 8, 1, 1)).astype(np.int8),
        "w2_s": np.array([0.004], np.float32), "w2_zp": np.array([0], np.int8),
        "y2_s": np.array(0.04, np.float32), "y2_zp": np.array(120, np.uint8),
        "a_s": np.array(0.06, np.float32), "a_zp": np.array(10, np.uint8),
        "g_s": np.array(0.03, np.float32), "g_zp": np.array(5, np.uint8),
        "shape": np.array([1, 8], np.int64),
        "m": rng.integers(0, 255, (8, 5)).astype(np.uint8),
        "m_s": np.array(0.01, np.float32), "m_zp": np.array(128, np.uint8),
        "o_s": np.array(0.1, np.float32), "o_zp": np.array(100, np.uint8),
    }
    nodes = [
        _node("QuantizeLinear", ["x", "x_s", "x_zp"], ["xq"]),
        _node("QLinearConv", ["xq", "x_s", "x_zp", "w1", "w1_s", "w1_zp",
                              "y1_s", "y1_zp", "b1"], ["c1"],
              ints={"pads": [1, 1, 1, 1], "strides": [2, 2]}),
        _node("QLinearConv", ["c1", "y1_s", "y1_zp", "w2", "w2_s", "w2_zp",
                              "y2_s", "y2_zp"], ["c2"]),
        _node("QLinearAdd", ["c1", "y1_s", "y1_zp", "c2", "y2_s", "y2_zp",
                             "a_s", "a_zp"], ["a"], domain="com.microsoft"),
        _node("QLinearGlobalAveragePool", ["a", "a_s", "a_zp", "g_s",
                                           "g_zp"], ["g"],
              domain="com.microsoft"),
        _node("Reshape", ["g", "shape"], ["r"]),
        _node("QLinearMatMul", ["r", "g_s", "g_zp", "m", "m_s", "m_zp",
                                "o_s", "o_zp"], ["o"]),
        _node("DequantizeLinear", ["o", "o_s", "o_zp"], ["y"]),
    ]
    graph = b"".join(_field(1, n) for n in nodes) + _field(2, "q")
    graph += b"".join(_field(5, _tensor_proto(k, v)) for k, v in inits.items())
    graph += _field(11, _value_info("x", 1, [1, 3, 12, 12]))
    graph += _field(12, _value_info("y", 1, [1, 5]))
    model = (_field(1, 7) + _field(8, _field(2, 13))
             + _field(8, _field(1, "com.microsoft") + _field(2, 1))
             + _field(7, graph))
    with open(path, "wb") as f:
        f.write(model)
    return str(path)


@pytest.fixture(scope="module")
def onnx_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    torch.manual_seed(0)
    net = _SmallNet()  # the test rebuilds it from the same seed
    x = torch.randn(1, 3, 32, 32)
    out = {"small": _export(net, x, d / "small.onnx"),
           "mp": _export(_PoolPadPermute(), x, d / "mp.onnx"),
           "cumsum": _export(_CumSum(), torch.randn(1, 8), d / "cs.onnx"),
           "qop": _qoperator_onnx(d / "qop.onnx", np.random.default_rng(3)),
           "mbv2": model_files.write_mobilenet_v2_onnx(str(d / "mbv2.onnx"),
                                                       MBV2)}
    return out


def _tensor_proto_ints(data_type: int, ints32: list) -> bytes:
    """TensorProto with int32_data (test_import_onnx.py's wire cases)."""
    packed = b"".join(_varint(v) for v in ints32)
    return (b"\x08" + _varint(len(ints32)) + b"\x10" + _varint(data_type)
            + b"\x2a" + _varint(len(packed)) + packed)


@pytest.mark.parametrize("name", ["small", "mp", "cumsum", "qop", "mbv2"])
def test_onnx_lite_gives_the_jax_graph(onnx_files, name):
    assert repr(p_onnx_lite.load(onnx_files[name])) == repr(
        j_onnx_lite.load(onnx_files[name]))


@pytest.mark.parametrize("dt,ints", [(3, [-1, -128, 127]),
                                     (6, [-2**31, 5]),
                                     (10, [0x3C00, 0xBC00, 0x0000])])
def test_onnx_lite_sign_and_fp16_cases(dt, ints):
    blob = memoryview(_tensor_proto_ints(dt, ints))
    got = p_onnx_lite._parse_tensor(blob).to_numpy()
    want = j_onnx_lite._parse_tensor(blob).to_numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- the .tflite importer against the JAX one ----------------------------

@pytest.mark.parametrize("name", ["tiny", "pools", "resize_bilinear_ac",
                                  "resize_bilinear_hp", "resize_nearest",
                                  "tconv_3_2_same", "tconv_4_2_same",
                                  "tconv_3_1_valid", "tconv_2_2_valid"])
def test_tflite_float_graphs_match_jax_and_interpreter(files, name, rng):
    path = files[name]
    shape = tuple(int(d) for d in _object_api(path).subgraphs[0].tensors[
        _object_api(path).subgraphs[0].inputs[0]].shape[1:])
    x = rng.normal(0, 1, (1,) + shape).astype(np.float32)
    (j,), (p,) = _both(path, x)
    np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p, _interp(path, x), rtol=RTOL, atol=ATOL)


def test_tflite_batch1_graph_is_vmapped_and_native(files, rng):
    """A batch-1 graph fed 4 frames runs under torch.func.vmap: rows equal
    per-frame invokes and the JAX importer's jax.vmap; ``batch:native``
    gives the same rows; a rank-trimmed frame gets its batch dim back."""
    path = files["tiny"]
    xb = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    (j,), (p,) = _both(path, xb)
    assert p.shape == (4, 10)
    np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
    bundle = p_tflite.load_tflite(path, device="cpu")
    for i in range(4):
        np.testing.assert_allclose(p[i], _port_run(bundle, xb[i:i + 1])[0][0],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p[i], _port_run(bundle, xb[i])[0][0],
                                   rtol=1e-5, atol=1e-6)
    (n,) = _port_run(p_tflite.load_tflite(path, {"batch": "native"},
                                          device="cpu"), xb)
    np.testing.assert_allclose(n, p, rtol=1e-5, atol=1e-6)


def test_tflite_io_info_and_reshape_match_jax(files):
    from nnstreamer_tpu_torch.types import TensorsInfo

    def spec(info):
        return [(tuple(t.dims), t.dtype.value) for t in info.tensors]

    for name, custom in (("tiny", {}), ("int8", {}),
                         ("int8", {"quant": "int8"}),
                         ("tiny", {"preproc": "norm:-127.5:127.5"})):
        j = j_tflite.load_tflite(files[name], custom)
        p = p_tflite.load_tflite(files[name], custom, device="cpu")
        assert spec(p.input_info) == spec(j.input_info)
        assert spec(p.output_info) == spec(j.output_info)
    p = p_tflite.load_tflite(files["tiny"], device="cpu")
    out = p.infer_output(TensorsInfo.from_strings("3:32:32:6", "float32"))
    assert out.dimensions_string() == "10:6"


def test_tflite_weights_are_transposed_once_at_load(files):
    """Each conv weight sits in torch's layout, channels-last, in the
    bundle's module: OIHW for CONV_2D, O1HW for DEPTHWISE_CONV_2D, IOHW
    for TRANSPOSE_CONV."""
    g = p_tflite.TFLiteGraph(files["tiny"])
    b = p_tflite.load_tflite(files["tiny"], device="cpu")
    tree = b.module.tree()
    B = tflite_fb.BuiltinOperator
    kinds = []
    for op in g.operators:
        code = g.opcodes[op.opcodeIndex][0]
        if code in (B.CONV_2D, B.DEPTHWISE_CONV_2D):
            w = tree[str(int(op.inputs[1]))]
            stored = g.tensors[int(op.inputs[1])].shape
            perm = (0, 3, 1, 2) if code == B.CONV_2D else (3, 0, 1, 2)
            assert tuple(w.shape) == tuple(stored[i] for i in perm)
            assert w.is_contiguous(memory_format=torch.channels_last)
            kinds.append(code)
    assert sorted(kinds) == [B.CONV_2D, B.CONV_2D, B.DEPTHWISE_CONV_2D]
    t = p_tflite.TFLiteGraph(files["tconv_3_2_same"])
    (w,) = [v for k, v in t.params().items() if v.ndim == 4]
    assert w.shape == (4, 6, 3, 3)


def test_tflite_unsupported_op_raises_by_name(files):
    b = p_tflite.load_tflite(files["cumsum"], device="cpu")
    with pytest.raises(NotImplementedError,
                       match="CUMSUM.*framework=tflite"):
        b.apply_fn(torch.zeros(1, 8))


def test_cli_checks_against_the_interpreter_on_the_cpu(files, capsys):
    """``--device cpu`` runs the CLI's ``--check`` on a machine without a
    card: the graph's io and its error against TF's interpreter."""
    assert p_tflite.main([files["tiny"], "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("inputs ") and "output 0: max abs err" in out
    err = float(out.split("max abs err ")[1].split()[0])
    assert err < 1e-4


def test_cli_runs_on_the_card_unless_asked(files, monkeypatch, capsys):
    """With no ``--device`` the CLI runs on the card, as the filter does:
    where torch sees none it stops with a usage error naming the CPU
    opt-out, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        p_tflite.main([files["tiny"]])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("custom", [
    {}, {"quant": "int8"}, {"quant": "int8", "carrier": "int"}],
    ids=["fake-quant", "int8-f32", "int8-int"])
def test_tflite_int8_graph_matches_jax(files, custom, rng):
    """TF's full-int8 conversion: int8 frames bit-equal to the JAX
    importer in every mode; float frames (quantized onto the input grid
    first) within one output quantization step. ``carrier:bf16`` is an
    alias of ``carrier:f32`` in the port: with the default carrier, its
    outputs are identical to f32's and bit-equal to the JAX importer's
    bf16 carrier."""
    path = files["int8"]
    xi = rng.integers(-128, 128, (3, 16, 16, 3)).astype(np.int8)
    g = p_tflite.TFLiteGraph(path)
    step = g.tensors[g.outputs[0]].quant[0]

    def same(p, j):
        if custom:
            np.testing.assert_array_equal(p, j)
        else:  # fake-quant is float arithmetic with clamps: float32
            # rounding apart, far inside one step
            np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
            assert np.abs(p - j).max() < step / 100

    (j,), (p,) = _both(path, xi, custom)
    assert p.dtype == np.float32 and p.shape == (3, 10)
    same(p, j)
    if custom == {"quant": "int8"}:
        (jb,), (pb,) = _both(path, xi, {"quant": "int8", "carrier": "bf16"})
        np.testing.assert_array_equal(pb, p)
        same(pb, jb)
    (j1,), (p1,) = _both(path, xi[:1], custom)
    same(p1, j1)
    xf = rng.normal(0, 1, (1, 16, 16, 3)).astype(np.float32)
    (jf,), (pf,) = _both(path, xf, custom)
    assert np.abs(pf - jf).max() <= step * 1.0001
    if custom:  # integer execution lands on the output grid
        assert np.allclose(np.round(pf / step) * step, pf, atol=1e-5)


def test_detection_postprocess_options_match_jax(rng):
    """The flexbuffer options configure the op as in the JAX importer:
    the same boxes, classes, scores and count."""
    from types import SimpleNamespace

    blob = _flex_blobs()[0]
    n = 32
    enc = rng.normal(0, 0.1, (1, n, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (1, n, 4)).astype(np.float32)
    anchors = np.stack([
        rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n),
        np.full(n, 0.1), np.full(n, 0.1)], axis=-1).astype(np.float32)
    op = SimpleNamespace(customOptions=np.frombuffer(blob, np.uint8))
    want = j_tflite.TFLiteGraph._detection_postprocess(
        SimpleNamespace(), SimpleNamespace(customOptions=blob),
        [enc, scores, anchors])
    got = p_tflite.TFLiteGraph._detection_postprocess(
        SimpleNamespace(), op, [torch.from_numpy(v)
                                for v in (enc, scores, anchors)])
    assert got[0].shape == (1, 7, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_detection_postprocess_runs_under_vmap(rng):
    """The batch-1 wrapper vmaps a graph whose last op is the detection
    post-process: per frame under torch.func.vmap it gives the batched
    call's rows (the NMS loop updates nothing in place)."""
    from types import SimpleNamespace

    n, b = 24, 3
    op = SimpleNamespace(customOptions=np.frombuffer(_flex_blobs()[0],
                                                     np.uint8))
    enc = torch.from_numpy(rng.normal(0, 0.1, (b, n, 4)).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (b, n, 4)).astype(
        np.float32))
    anchors = torch.from_numpy(np.stack([
        rng.uniform(0.2, 0.8, n), rng.uniform(0.2, 0.8, n),
        np.full(n, 0.1), np.full(n, 0.1)], axis=-1).astype(np.float32))
    pp = p_tflite.TFLiteGraph._detection_postprocess
    batched = pp(SimpleNamespace(), op, [enc, scores, anchors])
    per_frame = torch.func.vmap(lambda e, s: tuple(
        o[0] for o in pp(SimpleNamespace(), op, [e[None], s[None],
                                                 anchors])))(enc, scores)
    for got, want in zip(per_frame, batched):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_skeleton_and_given_state_rebuild_the_graph(files, rng):
    """The compile cache's two builds of an imported file: the meta
    skeleton answers shapes, and a build around the first build's state
    (models.build_with_state) computes the same logits."""
    from nnstreamer_tpu_torch.models import (
        build_bundle,
        build_with_state,
        skeleton_bundle,
    )

    path = files["mbv2"]
    real = build_bundle(path, {}, "cpu")
    skel = skeleton_bundle(path, {})
    assert all(t.device.type == "meta" for t in skel.module.buffers())
    assert skel.output_info.dimensions_string() == "1001"
    again = build_with_state(path, {}, "cpu", real.module.state_dict())
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 96, 96, 3)).astype(
        np.float32))
    np.testing.assert_array_equal(again.apply_fn(x).numpy(),
                                  real.apply_fn(x).numpy())


# -- the .onnx importer against the JAX one ------------------------------

@pytest.mark.parametrize("name", ["small", "mp"])
def test_onnx_float_graphs_match_jax_and_torch(onnx_files, name, rng):
    module = {"small": _SmallNet, "mp": _PoolPadPermute}[name]
    torch.manual_seed(0)
    net = module().eval()  # the exported weights: same seed, same draw
    for batch in (1, 4):
        x = rng.normal(0, 1, (batch, 3, 32, 32)).astype(np.float32)
        (j,), (p,) = _both(onnx_files[name], x, load=("onnx",))
        np.testing.assert_allclose(p.reshape(j.shape), j, rtol=RTOL,
                                   atol=ATOL)
        with torch.no_grad():
            want = net(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(p.reshape(want.shape), want, rtol=RTOL,
                                   atol=ATOL)


def test_onnx_unsupported_op_raises_by_name(onnx_files):
    b = p_onnx.load_onnx(onnx_files["cumsum"], device="cpu")
    with pytest.raises(NotImplementedError, match="CumSum"):
        b.apply_fn(torch.zeros(1, 8))


@pytest.mark.parametrize("qmode", ["exact", "float"])
def test_onnx_qoperator_graph_matches_jax(onnx_files, qmode, rng):
    """The QOperator graph in both qmodes: within one output quantization
    step of the JAX importer (the input's QuantizeLinear divides by its
    scale, see the module docstring); the exact mode lands on the output
    grid."""
    x = rng.uniform(-2.5, 2.5, (1, 3, 12, 12)).astype(np.float32)
    (j,), (p,) = _both(onnx_files["qop"], x, {"qmode": qmode},
                       load=("onnx",))
    assert p.shape == j.shape == (1, 5)
    assert np.abs(p - j).max() <= 0.1 * 1.0001
    if qmode == "exact":
        np.testing.assert_allclose(np.round(p / 0.1) * 0.1, p, atol=1e-5)


# -- the written MobileNet-v2 ---------------------------------------------

def _mbv2_frames(rng, n=2):
    u8 = rng.integers(0, 256, (n, 96, 96, 3), np.uint8)
    return u8, ((u8.astype(np.float32) - 127.5) / 127.5)


def test_written_tflite_runs_in_the_interpreter(files, rng):
    """model_files' flatbuffer loads in tf.lite.Interpreter; its logits
    match the port's zoo model (its BN-folded float32 forward over the
    same folded weights) and both importers agree on it; the labels are
    the zoo module's own (BatchNorm unfolded)."""
    _, x = _mbv2_frames(rng)
    want = model_files.zoo_folded_forward(MBV2)(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        unfolded = model_files.zoo_module(MBV2)(torch.from_numpy(x)).numpy()
    assert (want.argmax(-1) == unfolded.argmax(-1)).all()
    _same_model_logits(_interp(files["mbv2"], x), want)
    (j,), (p,) = _both(files["mbv2"], x)
    _same_model_logits(p, want)
    _same_model_logits(p, j)


def test_written_onnx_matches_the_zoo_module(onnx_files, rng):
    _, x = _mbv2_frames(rng)
    zoo = model_files.zoo_module(MBV2)
    with torch.no_grad():
        want = zoo(torch.from_numpy(x)).numpy()
    (j,), (p,) = _both(onnx_files["mbv2"], x, load=("onnx",))
    _same_model_logits(p, want)
    _same_model_logits(p, j)


# -- pipelines, through both packages -------------------------------------

def _run_line(pkg, line, frames):
    import importlib

    parse = importlib.import_module(f"{pkg}.pipeline").parse_launch
    Buffer = importlib.import_module(f"{pkg}.buffer").Buffer
    trace = importlib.import_module(f"{pkg}.trace")
    p = parse(line)
    tracer = trace.attach(p)
    p.play()
    for f in frames:
        p["src"].push_buffer(Buffer(tensors=[f]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120), p.bus.error and p.bus.error.data
    assert p.bus.error is None, p.bus.error.data
    logits = np.stack([np.asarray(b.tensors[0]).reshape(-1)
                       for b in p["raw"].collected])
    labels = [bytes(np.asarray(b.tensors[0])) for b in p["out"].collected]
    fusions = tracer.fusions()
    p.stop()
    return logits, labels, fusions


def _labeling_line(model, preamble="fused", custom=""):
    head = ("appsrc name=src caps=video/x-raw,format=RGB,width=96,"
            "height=96,framerate=0/1 ! tensor_converter name=conv ")
    if preamble == "fused":
        head += ("! tensor_transform name=tr mode=arithmetic "
                 "option=typecast:float32,add:-127.5,div:127.5 ")
    else:
        custom = ",".join(c for c in (custom, "preproc:norm:-127.5:127.5")
                          if c)
    cust = f" custom={custom}" if custom else ""
    return (head + f"! tensor_filter name=f framework=jax model={model} "
            f"accelerator=true:cpu{cust} ! tee name=t "
            "t. ! queue name=q1 ! tensor_sink name=raw "
            "t. ! queue name=q2 ! tensor_decoder name=dec "
            "mode=image_labeling ! tensor_sink name=out")


@pytest.mark.parametrize("kind", ["tflite", "onnx"])
def test_image_labeling_line_through_both_packages(files, onnx_files, kind,
                                                   rng):
    """The reference's image-labeling line on the written MobileNet-v2:
    the transform fused into the filter in both packages (the same
    plan), the same labels and logits. On a .tflite file the
    ``preproc:norm:-127.5:127.5`` form gives the same outputs in both
    packages; on a .onnx file both importers ignore ``preproc:`` and
    ``batch:native``, and the two packages agree on what the graph makes
    of the raw frames."""
    path = files["mbv2"] if kind == "tflite" else onnx_files["mbv2"]
    u8, x = _mbv2_frames(rng, 3)
    jl, jlab, jf = _run_line("nnstreamer_tpu", _labeling_line(path), u8)
    pl, plab, pf = _run_line("nnstreamer_tpu_torch", _labeling_line(path),
                             u8)
    assert pf == jf == {"tr": "fused-into:f"}
    assert plab == jlab
    _same_model_logits(pl, jl)
    zoo = model_files.zoo_module(MBV2)
    with torch.no_grad():
        want = zoo(torch.from_numpy(x)).numpy()
    _same_model_logits(pl, want)
    if kind == "tflite":  # both importers read preproc: for .tflite
        line = _labeling_line(path, "preproc")
        ql, qlab, qf = _run_line("nnstreamer_tpu_torch", line, u8)
        # the same arith_chain on the same frames: bit-equal
        assert qf == {} and qlab == plab
        np.testing.assert_array_equal(ql, pl)
    else:
        line = _labeling_line(path, "preproc", custom="batch:native")
        ql, qlab, qf = _run_line("nnstreamer_tpu_torch", line, u8)
        assert qf == {}
    kl, klab, _ = _run_line("nnstreamer_tpu", line, u8)
    assert klab == qlab
    _same_model_logits(ql, kl)


def test_onnx_importer_ignores_the_tflite_options(onnx_files, caplog):
    """``preproc:`` and ``batch:native`` change nothing on a .onnx file
    (the JAX ``load_onnx`` reads neither): the same input info and
    outputs as without them, and one warning naming both."""
    import logging

    from nnstreamer_tpu_torch.tools.import_onnx import load_onnx

    path = onnx_files["small"]
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 3, 32, 32)).astype(np.float32))
    plain = load_onnx(path, {}, device="cpu")
    with caplog.at_level(logging.WARNING, logger="nnstreamer_tpu_torch"):
        opts = load_onnx(path, {"preproc": "norm:-127.5:127.5",
                                "batch": "native"}, device="cpu")
    warned = [r.getMessage() for r in caplog.records
              if "ignores" in r.getMessage()]
    assert len(warned) == 1
    assert "preproc:norm:-127.5:127.5" in warned[0]
    assert "batch:native" in warned[0]
    assert opts.input_info == plain.input_info
    np.testing.assert_array_equal(opts.apply_fn(x).numpy(),
                                  plain.apply_fn(x).numpy())


def test_compile_cache_serves_an_imported_file(files, rng, tmp_path,
                                               monkeypatch):
    """``custom=aot:1`` on the .tflite line: a miss (the worker child
    builds the entry), then a hit in a fresh filter, logits bit-equal to
    ``aot:0``."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    monkeypatch.setenv("NNSTPU_AOT_CACHE", str(tmp_path))
    u8, x = _mbv2_frames(rng, 2)
    outs, events = [], []
    for aot in ("0", "1", "1"):
        fw = TorchCudaFilter()
        fw.open(FilterProperties(model_files=[files["mbv2"]],
                                 custom=f"aot:{aot}",
                                 accelerator="true:cpu"))
        outs.append(fw.invoke([x])[0].numpy())
        events.append([e["outcome"] for e in fw.take_aot_events()])
        fw.close()
    assert events == [[], ["miss-compiled"], ["hit"]]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])
