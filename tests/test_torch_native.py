"""The port's native pipeline core (nnstreamer_tpu_torch.native_rt) against
the JAX package's (nnstreamer_tpu.native_rt), on the CPU.

The port builds its own core, libnnstpu_torch_core.so, from the same
native/src with a bare g++; the JAX package builds native/build/libnnstpu.so
with cmake+ninja. Both are held to the same cases of tests/test_native.py
and tests/test_native_cppclass.py here: build and version, a parse error,
a numpy callback filter, a C++ class subplugin, and a Python model inside a
native graph (the port's MobileNet-v2 through ``register_callback_filter``
against the JAX model through the JAX package's). Both cores load into this
one process, each with its own registry of filters.
"""

import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnstreamer_tpu import native_rt as jax_rt  # noqa: E402
from nnstreamer_tpu.types import TensorInfo as JaxTensorInfo  # noqa: E402
from nnstreamer_tpu.types import TensorsInfo as JaxTensorsInfo  # noqa: E402
from nnstreamer_tpu_torch import native_rt  # noqa: E402
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo  # noqa: E402

MBV2 = {"size": "96", "width": "0.35", "classes": "16"}
N_FRAMES = 8


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("the port's core needs g++")
    return native_rt.load()


@pytest.fixture(scope="module")
def jax_lib():
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("the JAX package's core needs cmake and ninja")
    return jax_rt.load()


def _infos(pkg_info, pkg_infos, dims, dtype):
    return pkg_infos(tensors=[pkg_info(dims=dims, dtype=dtype)])


def test_build_and_version(lib, jax_lib):
    path = native_rt.build()
    assert path.endswith("/libnnstpu_torch_core.so")
    assert path != jax_rt._LIB_PATH
    assert lib.nnstpu_version().decode() == \
        jax_lib.nnstpu_version().decode()
    assert lib.nnstpu_version().decode().count(".") == 2
    # a build keyed by the same sources and flags is reused
    assert native_rt.build() == path


@pytest.mark.parametrize("rt", [native_rt, jax_rt], ids=["port", "jax"])
def test_parse_error(rt, lib, jax_lib):
    with pytest.raises(ValueError, match="no such element"):
        rt.NativePipeline("appsrc name=s ! nonsense_element ! appsink name=o")


def _run_sum(rt, name):
    p = rt.NativePipeline(
        "appsrc name=src caps=other/tensors,format=static,dimensions=8,"
        f"types=float32 ! tensor_filter framework={name} ! appsink name=out")
    with p:
        p.play()
        p.push("src", [np.arange(8, dtype=np.float32)])
        got = p.pull("out", timeout=5.0)
        assert got is not None
        return got[0][0].view(np.float32).copy()


def test_callback_filter_numpy(lib, jax_lib):
    """tests/test_native.py::test_callback_filter_numpy through both cores:
    the same sum."""
    outs = []
    for rt, info, infos in ((native_rt, TensorInfo, TensorsInfo),
                            (jax_rt, JaxTensorInfo, JaxTensorsInfo)):
        name = f"py_sum_{rt.__name__.split('.')[0]}"
        rt.register_callback_filter(
            name, lambda xs: [np.sum(xs[0], keepdims=True)],
            _infos(info, infos, (8,), "float32"),
            _infos(info, infos, (1,), "float32"))
        try:
            outs.append(_run_sum(rt, name))
        finally:
            rt.unregister_filter(name)
    assert outs[0][0] == pytest.approx(28.0)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_each_core_keeps_its_own_filters(lib, jax_lib):
    """A framework registered into one core is not found by a pipeline of
    the other, in either direction."""
    for rt, info, infos, other in (
            (native_rt, TensorInfo, TensorsInfo, jax_rt),
            (jax_rt, JaxTensorInfo, JaxTensorsInfo, native_rt)):
        name = f"only_in_{rt.__name__.split('.')[0]}"
        rt.register_callback_filter(
            name, lambda xs: [np.sum(xs[0], keepdims=True)],
            _infos(info, infos, (8,), "float32"),
            _infos(info, infos, (1,), "float32"))
        try:
            assert _run_sum(rt, name)[0] == pytest.approx(28.0)
            p = other.NativePipeline(
                "appsrc name=src caps=other/tensors,format=static,"
                f"dimensions=8,types=float32 ! tensor_filter framework={name} "
                "! appsink name=out")
            with p:
                with pytest.raises(RuntimeError, match="start failed"):
                    p.play()
                assert "no such filter framework" in p.pop_error()
        finally:
            rt.unregister_filter(name)


# the C++ class plugin of tests/test_native_cppclass.py, copied
PLUGIN_CC = r"""
#include <cstdio>
#include <cstring>
#include <stdexcept>

#include "nnstpu/cppclass.hh"

// out = in * scale + bias over 4 float32 values; scale and bias each come
// from their OWN model file (caffe2-style two-model open convention).
class scale_bias_filter : public nnstpu::tensor_filter_subplugin {
 public:
  void configure_instance(const char* props) override {
    auto models = parse_models(props);
    if (models.size() != 2)
      throw std::runtime_error("need model=<scale-file>,<bias-file>");
    scale_ = read_scalar(models[0]);
    bias_ = read_scalar(models[1]);
    if (parse_custom(props) == "flag") extra_ = 0.25f;
  }

  int getModelInfo(nnstpu_tensors_info* in,
                   nnstpu_tensors_info* out) override {
    for (nnstpu_tensors_info* t : {in, out}) {
      std::memset(t, 0, sizeof(*t));
      t->num = 1;
      t->info[0].rank = 1;
      t->info[0].dims[0] = 4;
      t->info[0].dtype = 7; /* float32 wire id */
    }
    return 0;
  }

  int invoke(const nnstpu_tensor_mem* in, uint32_t n_in,
             nnstpu_tensor_mem* out, uint32_t n_out) override {
    if (n_in != 1 || n_out != 1 || in[0].size != out[0].size) return -1;
    const float* x = static_cast<const float*>(in[0].data);
    float* y = static_cast<float*>(out[0].data);
    for (size_t i = 0; i < in[0].size / sizeof(float); ++i)
      y[i] = x[i] * scale_ + bias_ + extra_;
    return 0;
  }

 private:
  static float read_scalar(const std::string& path) {
    FILE* f = std::fopen(path.c_str(), "r");
    if (!f) throw std::runtime_error("cannot open model " + path);
    float v = 0.f;
    if (std::fscanf(f, "%f", &v) != 1) {
      std::fclose(f);
      throw std::runtime_error("bad model file " + path);
    }
    std::fclose(f);
    return v;
  }

  float scale_ = 1.f;
  float bias_ = 0.f;
  float extra_ = 0.f;
};

__attribute__((constructor)) static void reg() {
  nnstpu::register_subplugin<scale_bias_filter>("scale_bias_cc_port");
}
"""


def test_compile_and_load_cpp_class_plugin(lib, tmp_path):
    """The port's compile_and_load_plugin builds the plugin against the
    port's core (its DT_NEEDED is libnnstpu_torch_core.so) and the plugin
    registers there: the two-model and colon-in-path cases of
    tests/test_native_cppclass.py."""
    so = native_rt.compile_and_load_plugin(
        PLUGIN_CC, "libnnstpu_filter_scale_bias_port.so", str(tmp_path))
    with open(so, "rb") as f:
        assert b"libnnstpu_torch_core.so" in f.read()
    scale_f, bias_f = tmp_path / "sc:ale.txt", tmp_path / "bias.txt"
    scale_f.write_text("3.0\n")
    bias_f.write_text("0.5\n")
    x = np.arange(4, dtype=np.float32)
    for custom, extra in (("", 0.0), (" custom=flag", 0.25)):
        p = native_rt.NativePipeline(
            "appsrc name=src caps=other/tensors,format=static,dimensions=4,"
            "types=float32 ! tensor_filter framework=scale_bias_cc_port "
            f"model={scale_f},{bias_f}{custom} ! appsink name=out")
        with p:
            p.play()
            for i in range(3):
                p.push("src", [x + i], pts=i)
            for i in range(3):
                got = p.pull("out", timeout=10.0)
                assert got is not None, f"frame {i} missing"
                np.testing.assert_allclose(got[0][0].view(np.float32),
                                           (x + i) * 3.0 + 0.5 + extra)
            p.eos("src")
            assert p.wait_eos(5.0)
    assert lib.nnstpu_load_subplugin(b"/no/such/plugin.so") == -1
    assert "load_subplugin" in native_rt._last_error(lib)


@pytest.fixture(scope="module")
def mbv2(tmp_path_factory):
    """The JAX package's MobileNet-v2 (width 0.35, 96 px, 16 classes) from
    flax's seed:0 init, perturbed as tests/test_torch_pipeline.py does so
    frames get different labels, and the same weights carried across
    (from_jax_variables) into an npz for the port; the frames (4x4 blocks
    of flat colour). The perturbation's seed (8) and the frames' (1) were
    picked for their margins: two classes over the eight frames, the
    smallest top-2 margin 5.3 on logits up to 104 (the JAX forward, bf16),
    where the two packages' logits differ by up to 4.4."""
    from test_torch_pipeline import _perturb

    from nnstreamer_tpu.models import get_model
    from nnstreamer_tpu_torch.models.convert import (
        from_jax_variables,
        save_state_dict,
    )

    b = get_model("mobilenet_v2", dict(MBV2, seed="0"))
    variables = _perturb(jax.device_get(b.params), 8)
    npz = str(tmp_path_factory.mktemp("native_mbv2") / "mbv2.npz")
    save_state_dict(from_jax_variables(variables), npz)
    rng = np.random.default_rng(1)
    frames = np.stack([np.kron(rng.integers(0, 256, (4, 4, 3)),
                               np.ones((24, 24, 1))).astype(np.uint8)
                       for _ in range(N_FRAMES)])
    return b, variables, npz, frames


def _run_frames(rt, name, frames):
    p = rt.NativePipeline(
        "appsrc name=src caps=other/tensors,format=static,"
        f"dimensions=3:96:96:{len(frames)},types=uint8 ! queue "
        f"! tensor_filter framework={name} ! appsink name=out")
    with p:
        p.play()
        p.push("src", [frames])
        got = p.pull("out", timeout=120.0)
        assert got is not None, p.pop_error()
        return got[0][0].view(np.float32).reshape(len(frames), -1).copy()


def test_callback_filter_mobilenet_v2_against_jax(mbv2, lib, jax_lib):
    """The port's filter (single.SingleShot, MobileNet-v2 on the converted
    weights, on the CPU) as a native-graph backend against the JAX model
    through the JAX package's bridge, on the same frames and weights:
    argmax equal on every frame, logits within a tenth of their own
    scale (the bf16 forwards of the two packages differ by up to 4.4 on
    logits up to 104 here, as tests/test_torch_pipeline.py::_perturb
    finds on its weights)."""
    from nnstreamer_tpu_torch.single import SingleShot

    b, variables, npz, frames = mbv2
    n = len(frames)
    fn = jax.jit(lambda x: b.apply_fn(variables, x))
    single = SingleShot(
        model="mobilenet_v2", framework="jax", accelerator="true:cpu",
        custom=",".join([f"params:{npz}"]
                        + [f"{k}:{v}" for k, v in MBV2.items()]))
    outs = {}
    try:
        for rt, info, infos, call in (
                (native_rt, TensorInfo, TensorsInfo,
                 lambda xs: single.invoke(xs[0])),
                (jax_rt, JaxTensorInfo, JaxTensorsInfo,
                 lambda xs: [np.asarray(fn(xs[0]), np.float32)])):
            name = f"mbv2_{rt.__name__.split('.')[0]}"
            rt.register_callback_filter(
                name, call, _infos(info, infos, (3, 96, 96, n), "uint8"),
                _infos(info, infos, (16, n), "float32"))
            try:
                outs[rt] = _run_frames(rt, name, frames)
            finally:
                rt.unregister_filter(name)
    finally:
        single.close()
    port, ref = outs[native_rt], outs[jax_rt]
    assert port.shape == ref.shape == (n, 16)
    labels = ref.argmax(-1)
    np.testing.assert_array_equal(port.argmax(-1), labels)
    assert len(set(labels.tolist())) > 1  # the labels have teeth
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(port, ref, rtol=0, atol=0.1 * scale)
