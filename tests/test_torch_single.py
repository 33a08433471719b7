"""The port's single-shot API (nnstreamer_tpu_torch/single.py) and its
CPU-runtime backends (filters/tflite_filter.py, onnx_filter.py,
python3.py, torch_filter.py), held to the JAX package's.

Every case of tests/test_single.py runs through both packages (the zoo
models with ``accelerator=true:cpu`` on the port, which otherwise runs
on the card); an imported ``.tflite`` (the written MobileNet-v2) runs
through both single-shot APIs; ``framework=auto`` resolves ``.tflite``,
``.onnx``, ``.pt`` and ``.py`` as the JAX package does; the TFLite
interpreter and SavedModel backends give the JAX package's outputs on
the models of tests/test_tflite_backend.py; ``framework=onnxruntime``
raises the same error at open. Float outputs at rtol 1e-4, atol 1e-5;
the MobileNet-v2 logits at max abs err 1e-4 with equal argmax (the
reference's real-model tolerance, tests/test_reference_models.py:62).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
pytest.importorskip("jax")

PKGS = ("nnstreamer_tpu", "nnstreamer_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cpu(pkg):
    """The accelerator property that keeps a package's zoo model on the
    CPU (the port runs on the card unless told)."""
    return "true:cpu" if pkg.endswith("_torch") else ""


@pytest.fixture(params=PKGS, ids=["jax", "port"])
def pkg(request):
    return request.param


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the cases of tests/test_single.py, through both packages -------------

def test_zoo_model(pkg):
    SingleShot = _mod(pkg, "single").SingleShot
    with SingleShot(model="add", custom="k:5", accelerator=_cpu(pkg)) as s:
        out = s.invoke(np.zeros(4, np.float32))
        np.testing.assert_allclose(out[0], np.full(4, 5, np.float32))
        assert isinstance(out[0], np.ndarray)
        assert s.latency_us >= 0


def test_mobilenet_info(pkg):
    s = _mod(pkg, "single").SingleShot(
        model="mobilenet_v2", custom="seed:0,size:32,width:0.35,classes:8",
        accelerator=_cpu(pkg))
    try:
        assert s.input_info.tensors[0].dims[:3] == (3, 32, 32)
        out = s.invoke(np.zeros((32, 32, 3), np.uint8))
        assert out[0].shape[-1] == 8
    finally:
        s.close()


def test_custom_easy_by_name(pkg):
    base = _mod(pkg, "filters.base")
    info = _mod(pkg, "types").TensorsInfo.from_strings("4", "float32")
    base.register_custom_easy("sq", lambda xs: [np.asarray(xs[0]) ** 2],
                              info, info)
    try:
        with _mod(pkg, "single").SingleShot(model="sq",
                                            framework="custom-easy") as s:
            out = s.invoke(np.full(4, 3, np.float32))
            np.testing.assert_allclose(out[0], np.full(4, 9, np.float32))
    finally:
        base.unregister_custom_easy("sq")


def test_py_script_autodetect(pkg, tmp_path):
    script = tmp_path / "s.py"
    script.write_text(
        "import numpy as np\n"
        "class CustomFilter:\n"
        "    def getInputDim(self):\n"
        "        return ('2', 'float32')\n"
        "    def getOutputDim(self):\n"
        "        return ('2', 'float32')\n"
        "    def invoke(self, inputs):\n"
        "        return [np.asarray(inputs[0]) + 10]\n"
    )
    with _mod(pkg, "single").SingleShot(model=str(script)) as s:
        assert s.fw.NAME == "python3"
        out = s.invoke(np.zeros(2, np.float32))
        np.testing.assert_allclose(out[0], np.full(2, 10, np.float32))


def test_shared_key_shares_instance(pkg):
    base = _mod(pkg, "filters.base")
    SingleShot = _mod(pkg, "single").SingleShot
    info = _mod(pkg, "types").TensorsInfo.from_strings("4", "float32")
    calls = []

    def fn(xs):
        calls.append(1)
        return [np.asarray(xs[0])]

    base.register_custom_easy("shared1", fn, info, info)
    try:
        a = SingleShot(model="shared1", framework="custom-easy",
                       shared_key=f"K1-{pkg}")
        b = SingleShot(model="shared1", framework="custom-easy",
                       shared_key=f"K1-{pkg}")
        assert a.fw is b.fw
        a.close()
        # still usable through b after a closes (refcounted release)
        b.invoke(np.zeros(4, np.float32))
        b.close()
        assert calls == [1]
    finally:
        base.unregister_custom_easy("shared1")


def test_closed_invoke_raises(pkg):
    base = _mod(pkg, "filters.base")
    info = _mod(pkg, "types").TensorsInfo.from_strings("4", "float32")
    base.register_custom_easy("c1", lambda xs: list(xs), info, info)
    try:
        s = _mod(pkg, "single").SingleShot(model="c1",
                                           framework="custom-easy")
        s.close()
        with pytest.raises(RuntimeError, match="closed"):
            s.invoke(np.zeros(4, np.float32))
    finally:
        base.unregister_custom_easy("c1")


def test_reshape_rejected_for_fixed_model(pkg):
    base = _mod(pkg, "filters.base")
    TensorsInfo = _mod(pkg, "types").TensorsInfo
    info4 = TensorsInfo.from_strings("4", "float32")
    base.register_custom_easy("fix4", lambda xs: list(xs), info4, info4)
    try:
        with pytest.raises(ValueError, match="expects"):
            _mod(pkg, "single").SingleShot(
                model="fix4", framework="custom-easy",
                input_info=TensorsInfo.from_strings("8", "float32"))
    finally:
        base.unregister_custom_easy("fix4")


# -- an imported model file through the single-shot API ----------------------

MBV2 = {"seed": "0", "width": "0.35", "size": "96"}


@pytest.fixture(scope="module")
def mbv2_tflite(tmp_path_factory):
    from nnstreamer_tpu_torch.testing import model_files

    return model_files.write_mobilenet_v2_tflite(
        str(tmp_path_factory.mktemp("single") / "mbv2.tflite"), MBV2)


def test_imported_tflite_through_both_single_shots(mbv2_tflite, rng):
    """``SingleShot(model=<file>.tflite, framework=jax)``: the same label
    and logits from both packages; the port's ``sync=False`` keeps the
    logits as tensors of the filter's device, ``set_input_info`` answers
    a batch of 4, ``reload`` reopens the file."""
    x = ((rng.integers(0, 256, (96, 96, 3)).astype(np.float32) - 127.5)
         / 127.5).astype(np.float32)
    got = {}
    for pkg in PKGS:
        with _mod(pkg, "single").SingleShot(
                model=mbv2_tflite, framework="jax",
                accelerator=_cpu(pkg) or "cpu") as s:
            assert s.input_info.tensors[0].dims[:3] == (3, 96, 96)
            got[pkg] = s.invoke(x)[0].reshape(-1)
            assert s.latency_us > 0
    j, p = got["nnstreamer_tpu"], got["nnstreamer_tpu_torch"]
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-4)
    assert int(np.argmax(p)) == int(np.argmax(j))

    single = _mod("nnstreamer_tpu_torch", "single")
    TensorsInfo = _mod("nnstreamer_tpu_torch", "types").TensorsInfo
    with single.SingleShot(model=mbv2_tflite, framework="torch_cuda",
                           accelerator="true:cpu", sync=False) as s:
        assert s.fw.NAME == "torch_cuda"
        out = s.invoke(x)[0]
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy().reshape(-1), p)
        info = s.set_input_info(TensorsInfo.from_strings("3:96:96:4",
                                                         "float32"))
        assert info.dimensions_string() == "1001:4"
        s.reload()
        np.testing.assert_array_equal(_host(s.invoke(x)[0]).reshape(-1), p)


# -- the CPU-runtime backends ---------------------------------------------

def test_framework_auto_resolves_as_jax(tmp_path):
    """``.tflite`` → the interpreter backend (the priority list's first),
    ``.onnx`` → jax (the importer), ``.pt`` → torch, ``.py`` → python3,
    a zoo name → jax, a SavedModel directory → tensorflow."""
    (tmp_path / "sm").mkdir()
    (tmp_path / "sm" / "saved_model.pb").write_bytes(b"")
    models = ["m.tflite", "m.onnx", "m.pt", "m.pth", "m.py", "mobilenet_v2",
              str(tmp_path / "sm")]
    for m in models:
        want = _mod("nnstreamer_tpu", "filters.base").detect_framework([m])
        got = _mod("nnstreamer_tpu_torch",
                   "filters.base").detect_framework([m])
        assert got == want, m
    assert _mod("nnstreamer_tpu_torch", "filters.base").detect_framework(
        ["m.tflite"]) == "tensorflow-lite"


def test_onnxruntime_raises_the_same_error_at_open(tmp_path):
    path = tmp_path / "m.onnx"
    path.write_bytes(b"")
    errs = []
    for pkg in PKGS:
        fw = _mod(pkg, "registry").get("filter", "onnxruntime")()
        with pytest.raises(Exception) as e:
            fw.open(_mod(pkg, "filters.base").FilterProperties(
                model_files=[str(path)]))
        errs.append(e)
    assert errs[0].type is errs[1].type is RuntimeError
    for e in errs:
        assert "onnxruntime is not installed" in str(e.value)
    assert "framework=jax" in str(errs[1].value)


tf = None


@pytest.fixture(scope="module")
def add_tflite(tmp_path_factory):
    """x (1,4) float32 -> x + 1 (tests/test_tflite_backend.py's)."""
    global tf
    tf = pytest.importorskip("tensorflow")
    path = str(tmp_path_factory.mktemp("models") / "add.tflite")

    class M(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec((1, 4), tf.float32)])
        def add(self, x):
            return x + 1.0

    m = M()
    conv = tf.lite.TFLiteConverter.from_concrete_functions(
        [m.add.get_concrete_function()], m)
    with open(path, "wb") as f:
        f.write(conv.convert())
    return path


@pytest.fixture(scope="module")
def matmul_savedmodel(tmp_path_factory, add_tflite):
    path = str(tmp_path_factory.mktemp("models") / "mm_saved")

    class M(tf.Module):
        def __init__(self):
            self.w = tf.constant(np.full((4, 2), 0.5, np.float32))

        @tf.function(input_signature=[tf.TensorSpec((1, 4), tf.float32)])
        def serve(self, x):
            return {"y": tf.matmul(x, self.w)}

    m = M()
    tf.saved_model.save(m, path, signatures={"serving_default": m.serve})
    return path


def _tflite_fw(pkg, path, custom=""):
    fw = _mod(pkg, "filters.tflite_filter").TFLiteFilter()
    fw.open(_mod(pkg, "filters.base").FilterProperties(
        model_files=[path], custom=custom))
    return fw


def test_tflite_interpreter_backend_matches_jax(add_tflite):
    """The cases of tests/test_tflite_backend.py:60-109 through both
    packages' interpreter backends: model info, invoke, reshape and the
    reload event give the same outputs."""
    TI = {p: _mod(p, "types") for p in PKGS}
    res = {}
    for pkg in PKGS:
        fw = _tflite_fw(pkg, add_tflite)
        in_info, out_info = fw.get_model_info()
        x = np.arange(4, dtype=np.float32).reshape(1, 4)
        (y,) = fw.invoke([x])
        fw.handle_event("reload_model", {"model": add_tflite})
        (y2,) = fw.invoke([np.zeros((1, 4), np.float32)])
        in2, _ = fw.set_input_info(TI[pkg].TensorsInfo(tensors=[
            TI[pkg].TensorInfo(dims=(4, 1, 1, 2), dtype="float32")]))
        (y3,) = fw.invoke([np.ones((2, 1, 1, 4), np.float32)])
        res[pkg] = (in_info.tensors[0].dims, out_info.tensors[0].dtype.value,
                    y, y2, in2.tensors[0].np_shape(), y3,
                    fw.stats.total_invoke_num)
        fw.close()
    j, p = res["nnstreamer_tpu"], res["nnstreamer_tpu_torch"]
    assert p[0] == j[0] == (4, 1) and p[1] == j[1] == "float32"
    assert p[4] == j[4] == (2, 1, 1, 4) and p[6] == j[6] == 3
    for a, b in zip(p[2:4] + (p[5],), j[2:4] + (j[5],)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(p[2], np.arange(4).reshape(1, 4) + 1.0)


def test_tflite_backend_in_a_port_pipeline(add_tflite):
    Buffer = _mod("nnstreamer_tpu_torch", "buffer").Buffer
    p = _mod("nnstreamer_tpu_torch", "pipeline").parse_launch(
        "appsrc name=src caps=other/tensors,format=static,dimensions=4:1,"
        f"types=float32 ! tensor_filter name=f framework=tensorflow-lite "
        f"model={add_tflite} ! tensor_sink name=out")
    p.play()
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    p["src"].push_buffer(Buffer(tensors=[x]))
    buf = p["out"].pull(timeout=10.0)
    p.stop()
    assert buf is not None
    np.testing.assert_allclose(np.asarray(buf.tensors[0]), x + 1.0)


def test_savedmodel_backend_matches_jax(matmul_savedmodel):
    outs = []
    for pkg in PKGS:
        fw = _mod(pkg, "filters.tflite_filter").TensorFlowFilter()
        fw.open(_mod(pkg, "filters.base").FilterProperties(
            model_files=[matmul_savedmodel]))
        in_info, out_info = fw.get_model_info()
        assert in_info.tensors[0].dims == (4, 1)
        assert out_info.tensors[0].dims == (2, 1)
        (y,) = fw.invoke([np.ones((1, 4), np.float32)])
        outs.append(y)
        fw.close()
        bad = _mod(pkg, "filters.tflite_filter").TensorFlowFilter()
        with pytest.raises(ValueError, match="signature"):
            bad.open(_mod(pkg, "filters.base").FilterProperties(
                model_files=[matmul_savedmodel], custom="signature:nope"))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[1], np.full((1, 2), 2.0))


def test_interpreter_backend_raises_by_name_without_tensorflow(
        add_tflite, monkeypatch):
    """Where TensorFlow is not installed (the card's machine), the
    backend is registered and raises at open naming it."""
    import builtins

    real = builtins.__import__

    def no_tf(name, *a, **k):
        if name == "tensorflow" or name.startswith("tensorflow."):
            raise ImportError("No module named 'tensorflow'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tf)
    fw = _mod("nnstreamer_tpu_torch", "registry").get("filter", "tflite")()
    with pytest.raises(RuntimeError, match="tensorflow is not installed"):
        fw.open(_mod("nnstreamer_tpu_torch", "filters.base").FilterProperties(
            model_files=[add_tflite]))


def test_torch_backend_runs_a_torchscript_file(tmp_path):
    """``framework=torch model=<file>.pt``: the TorchScript module's
    outputs from both packages' backends (the port's on the CPU here)."""
    path = str(tmp_path / "m.pt")
    torch.jit.script(torch.nn.Sequential(torch.nn.Linear(4, 3),
                                         torch.nn.ReLU())).save(path)
    x = np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)
    outs = []
    for pkg in PKGS:
        fw = _mod(pkg, "registry").get("filter", "torch")()
        fw.open(_mod(pkg, "filters.base").FilterProperties(
            model_files=[path], accelerator=_cpu(pkg)))
        info = _mod(pkg, "types").TensorsInfo.from_strings("4:2", "float32")
        _, out_info = fw.set_input_info(info)
        assert out_info.tensors[0].np_shape() == (2, 3)
        outs.append(fw.invoke([x])[0])
        fw.close()
    np.testing.assert_array_equal(outs[1], outs[0])
