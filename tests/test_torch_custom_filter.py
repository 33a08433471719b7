"""framework=custom through the port (counterpart of the JAX package's
``TestCustomSoFilter``, tests/test_filter_backends.py, and of
tests/test_tools.py's codegen cases).

User C libraries built here with g++ against ``native/include`` (the
``codegen c`` passthrough, and two written below: a reshapable doubler
that drops frames whose first value is negative, and a fixed-dims pair
sum) run through both packages' pipelines on the same frames, with equal
outputs, bit for bit: both packages hand the same numpy arrays to the
same library. ``tools/codegen.py``: the ``python`` and ``c`` templates
byte-equal to the JAX package's, the ``jax`` template's model file served
by the port.
"""

import importlib
import os
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INCLUDE = os.path.join(REPO, "native", "include")
PKGS = ["nnstreamer_tpu", "nnstreamer_tpu_torch"]
CAPS8 = ("appsrc name=src caps=other/tensors,format=static,num-tensors=1,"
         "dimensions=8,types=float32,framerate=0/1 ")

#: reshapable (set_input_dim): out = 2 * in on float32 tensors; a frame
#: whose first value is negative is dropped (invoke returns 1)
DOUBLE_DROP_C = r"""
#include "nnstpu/capi.h"

static int f_set_input_dim(void *priv, const nnstpu_tensors_info *in,
                           nnstpu_tensors_info *out) {
  (void)priv;
  if (in->num != 1 || in->info[0].dtype != 7) return -1; /* float32 */
  *out = *in;
  return 0;
}

static int f_invoke(void *priv, const nnstpu_tensor_mem *in, uint32_t n_in,
                    nnstpu_tensor_mem *out, uint32_t n_out) {
  (void)priv;
  if (n_in != 1 || n_out != 1 || in[0].size != out[0].size) return -1;
  const float *x = (const float *)in[0].data;
  float *y = (float *)out[0].data;
  if (x[0] < 0.0f) return 1;
  for (size_t i = 0; i < in[0].size / sizeof(float); ++i) y[i] = 2.0f * x[i];
  return 0;
}

extern const nnstpu_custom_filter nnstpu_filter_entry;
const nnstpu_custom_filter nnstpu_filter_entry = {
  0, 0, 0, 0, f_set_input_dim, f_invoke,
};
"""

#: fixed dims (get_input_dim / get_output_dim): 4 float32 in, the sums of
#: the two pairs out
PAIR_SUM_C = r"""
#include "nnstpu/capi.h"

static int one(nnstpu_tensors_info *info, uint32_t n) {
  info->num = 1;
  info->info[0].rank = 1;
  info->info[0].dims[0] = n;
  info->info[0].dtype = 7; /* float32 */
  return 0;
}
static int f_in(void *priv, nnstpu_tensors_info *in) {
  (void)priv; return one(in, 4);
}
static int f_out(void *priv, nnstpu_tensors_info *out) {
  (void)priv; return one(out, 2);
}
static int f_invoke(void *priv, const nnstpu_tensor_mem *in, uint32_t n_in,
                    nnstpu_tensor_mem *out, uint32_t n_out) {
  (void)priv; (void)n_in; (void)n_out;
  const float *x = (const float *)in[0].data;
  float *y = (float *)out[0].data;
  y[0] = x[0] + x[1];
  y[1] = x[2] + x[3];
  return 0;
}

extern const nnstpu_custom_filter nnstpu_filter_entry;
const nnstpu_custom_filter nnstpu_filter_entry = {
  0, 0, f_in, f_out, 0, f_invoke,
};
"""


def _pkg(name, mod):
    return importlib.import_module(f"{name}.{mod}")


def _build(td, name, src):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    c = td / f"{name}.c"
    c.write_text(src)
    so = td / f"lib{name}.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", f"-I{INCLUDE}",
                    str(c), "-o", str(so)], check=True, capture_output=True)
    return str(so)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    from nnstreamer_tpu_torch.tools import codegen

    td = tmp_path_factory.mktemp("customso")
    return {"pass": _build(td, "genfilter", codegen.generate("c",
                                                             "genfilter")),
            "double": _build(td, "doubledrop", DOUBLE_DROP_C),
            "pairs": _build(td, "pairsum", PAIR_SUM_C)}


def _run(pkg, line, frames):
    p = _pkg(pkg, "pipeline").parse_launch(line)
    Buffer = _pkg(pkg, "buffer").Buffer
    p.play()
    for x in frames:
        p["src"].push_buffer(Buffer(tensors=[x]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30), p.bus.error and p.bus.error.data
    out = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    p.stop()
    return out


def _both(line, frames):
    want = _run(PKGS[0], line, frames)
    got = _run(PKGS[1], line, frames)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.reshape(-1), w.reshape(-1))
    return got


def _frames(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=8).astype(np.float32) for _ in range(n)]


# -- the JAX package's TestCustomSoFilter cases, through the port ----------

def test_pipeline_passthrough(libs):
    frames = _frames()
    got = _both(CAPS8 + f"! tensor_filter framework=custom "
                f"model={libs['pass']} ! tensor_sink name=out", frames)
    for g, x in zip(got, frames):
        np.testing.assert_array_equal(g, x)


def test_missing_entry_symbol(tmp_path):
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.custom import CustomSoFilter

    so = _build(tmp_path, "empty", "int nothing_here(void) { return 0; }\n")
    with pytest.raises(ValueError, match="nnstpu_filter_entry"):
        CustomSoFilter().open(FilterProperties(model_files=[so]))


def test_auto_detect_so_extension(libs):
    for pkg in PKGS:
        assert _pkg(pkg, "filters.base").detect_framework(
            [libs["pass"]]) == "custom"


def test_auto_detected_line_runs(libs):
    """No ``framework=``: the ``.so`` extension picks the backend."""
    frames = _frames(2, 1)
    got = _both(CAPS8 + f"! tensor_filter model={libs['pass']} "
                "! tensor_sink name=out", frames)
    np.testing.assert_array_equal(got[1], frames[1])


# -- beyond the reference's cases ------------------------------------------

def test_set_input_dim_negotiation(libs):
    """A reshapable library answers the caps it is offered: 3:5 float32
    negotiates (out = 2 * in, the same in both packages' lines); uint8 is
    refused by name."""
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.custom import CustomSoFilter
    from nnstreamer_tpu_torch.types import TensorsInfo

    fw = CustomSoFilter()
    fw.open(FilterProperties(model_files=[libs["double"]]))
    assert fw.RESHAPABLE and fw.get_model_info() == (None, None)
    info = TensorsInfo.from_strings("3:5", "float32")
    assert fw.set_input_info(info) == (info, info)
    with pytest.raises(ValueError, match="rejected input shape"):
        fw.set_input_info(TensorsInfo.from_strings("8", "uint8"))
    fw.close()
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    got = _both("appsrc name=src caps=other/tensors,format=static,"
                "num-tensors=1,dimensions=3:5,types=float32,framerate=0/1 "
                f"! tensor_filter framework=custom model={libs['double']} "
                "! tensor_sink name=out", [x])
    np.testing.assert_array_equal(got[0].reshape(5, 3), 2 * x)


def test_dropped_frames(libs):
    """invoke returning > 0 drops the frame: the same frames survive in
    both packages, doubled."""
    frames = _frames(6, 2)
    frames[1][0], frames[4][0] = -1.0, -2.0
    frames[0][0] = frames[2][0] = frames[3][0] = frames[5][0] = 1.0
    got = _both(CAPS8 + f"! tensor_filter framework=custom "
                f"model={libs['double']} ! tensor_sink name=out", frames)
    kept = [frames[i] for i in (0, 2, 3, 5)]
    assert len(got) == 4
    for g, x in zip(got, kept):
        np.testing.assert_array_equal(g, 2 * x)


def test_fixed_dims_library(libs):
    """get_input_dim / get_output_dim: the library's own dims negotiate."""
    frames = [np.arange(4, dtype=np.float32) * (i + 1) for i in range(3)]
    got = _both("appsrc name=src caps=other/tensors,format=static,"
                "num-tensors=1,dimensions=4,types=float32,framerate=0/1 "
                f"! tensor_filter framework=custom model={libs['pairs']} "
                "! tensor_sink name=out", frames)
    for g, x in zip(got, frames):
        np.testing.assert_array_equal(g, [x[0] + x[1], x[2] + x[3]])


def test_device_tensors_take_one_host_read(libs):
    """A model filter's tensors (on the CPU the backend's own) into the
    library: the custom backend is not device-capable, so the line reads
    each buffer to the host once, billed as one ``d2h``; the library's
    outputs are numpy, equal to the JAX line's."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    line = (CAPS8 + "! tensor_filter framework=jax model=add custom=k:1 "
            "accelerator=true:cpu ! tensor_filter framework=custom "
            f"model={libs['double']} name=f ! tensor_sink name=out")
    frames = [np.abs(x) for x in _frames(3, 3)]
    p = parse_launch(line)
    tracer = trace.attach(p)
    p.play()
    for x in frames:
        p["src"].push_buffer(Buffer(tensors=[x]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30)
    outs = [b.tensors[0] for b in p["out"].collected]
    c = tracer.crossings()
    p.stop()
    assert (c["d2h"], c["d2h_bytes"]) == (3, 3 * 32)
    assert all(isinstance(o, np.ndarray) for o in outs)
    want = _run(PKGS[0], line.replace(" accelerator=true:cpu", ""), frames)
    for o, w, x in zip(outs, want, frames):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, 2 * (x + 1))


def test_invoke_takes_cpu_torch_tensors(libs):
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.custom import CustomSoFilter
    from nnstreamer_tpu_torch.types import TensorsInfo

    fw = CustomSoFilter()
    fw.open(FilterProperties(model_files=[libs["double"]]))
    fw.set_input_info(TensorsInfo.from_strings("8", "float32"))
    x = torch.arange(8, dtype=torch.float32)
    (y,) = fw.invoke([x])
    assert isinstance(y, np.ndarray)
    np.testing.assert_array_equal(y, 2 * x.numpy())
    fw.close()


# -- tools/codegen.py ------------------------------------------------------

@pytest.mark.parametrize("kind", ["python", "c"])
@pytest.mark.parametrize("name", ["MyFilter", "genfilter"])
def test_codegen_templates_equal_the_jax_package(kind, name):
    from nnstreamer_tpu.tools import codegen as jax_codegen
    from nnstreamer_tpu_torch.tools import codegen

    assert codegen.generate(kind, name) == jax_codegen.generate(kind, name)


def test_codegen_python_skeleton_is_loadable(tmp_path):
    """The ``python`` skeleton loads through the port's script loader
    (filters/python3.py's) and its ``invoke`` passes a frame through."""
    from nnstreamer_tpu_torch.pyscript import load_script_class
    from nnstreamer_tpu_torch.tools import codegen

    f = tmp_path / "my_filter.py"
    f.write_text(codegen.generate("python", "MyFilter"))
    inst = load_script_class(str(f), "invoke")()
    assert inst.getInputDim()[0][1] is np.float32
    x = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(inst.invoke([x])[0], x)


def test_codegen_model_template_is_served_by_the_port(tmp_path):
    """``codegen jax``: the port's template is a torch model file (no JAX
    import) that ``framework=jax model=<file>.py`` serves, giving what the
    JAX package's template file gives in the JAX package."""
    from nnstreamer_tpu.tools import codegen as jax_codegen
    from nnstreamer_tpu_torch.tools import codegen

    src = codegen.generate("jax", "GenModel")
    assert "jax" not in src.replace("framework=jax", "")
    ours, theirs = tmp_path / "gen_model.py", tmp_path / "jax_gen_model.py"
    ours.write_text(src)
    theirs.write_text(jax_codegen.generate("jax", "GenModel"))
    caps = ("appsrc name=src caps=other/tensors,format=static,"
            "num-tensors=1,dimensions=4,types=float32,framerate=0/1 ")
    x = np.arange(4, dtype=np.float32)
    got = _run(PKGS[1], caps + f"! tensor_filter framework=jax model={ours} "
               "custom=scale:2 accelerator=true:cpu ! tensor_sink name=out",
               [x])
    want = _run(PKGS[0], caps + f"! tensor_filter framework=jax "
                f"model={theirs} custom=scale:2 ! tensor_sink name=out", [x])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], 2 * x)


def test_codegen_cli(capsys):
    from nnstreamer_tpu_torch.tools import codegen

    assert codegen.main(["c", "genfilter"]) == 0
    assert capsys.readouterr().out == codegen.generate("c", "genfilter") + "\n"
    assert codegen.main(["c"]) == 2
    with pytest.raises(ValueError, match="python\\|jax\\|c"):
        codegen.generate("rust", "x")
