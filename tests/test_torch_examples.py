"""The port's example runners (``nnstreamer_tpu_torch/examples``) against
the repository's JAX examples (``examples/*.py``), on the CPU.

Each runner runs with ``--device cpu`` at its example's own sizes and
lines. Where the JAX example's model has seed weights, the port's runner
loads the JAX zoo's ``seed:0`` flax variables, carried across with
``from_jax_variables`` (``--params <npz>``), and the JAX package's init is
jitted here (the same values). Tolerances:

  - the stream transformer's window (bf16): the JAX package's bf16
    tolerance, atol 0.15, rtol 0.05 (tests/test_fused_block.py::
    test_model_zoo_fused_custom); ring and Ulysses (float32): atol 3e-5,
    the JAX ring tests' own;
  - classification labels, the detection overlay's object count, the
    query loopback's answers and the native top-1: what the JAX example
    prints, equal;
  - training: each epoch's loss and accuracy at rtol 1e-5, atol 1e-6 (the
    same float32 SGD on the same numpy weights and samples);
  - the imported ``.tflite`` (float32): max abs err 1e-4 with equal argmax,
    the reference's real-model tolerance (tests/test_reference_models.py).
"""

import contextlib
import functools
import importlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import jit_init  # noqa: E402
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
    save_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
RUNNERS = ("long_context", "classification", "detection", "query_offload",
           "training", "native_pipeline", "tflite_models")


@pytest.fixture(scope="module")
def jax_zoo():
    """The JAX zoo's init jitted (the same values as its eager init, made
    once a process): returns ``weights(zoo, custom)`` → an npz of the
    ``seed:0`` variables for the port."""
    import nnstreamer_tpu.models as jm

    mp = pytest.MonkeyPatch()
    mp.setattr(jm, "_init_on_cpu", jit_init)
    d = __import__("tempfile").mkdtemp(prefix="examples-")

    def weights(zoo, custom):
        b = jm.get_model(zoo, {"seed": "0", **custom})
        path = os.path.join(d, f"{zoo}.npz")
        save_state_dict(from_jax_variables(jax.device_get(b.params),
                                           model=zoo), path)
        return path

    yield weights
    mp.undo()


def _jax_example(name):
    """``examples/<name>.py`` as a module (the JAX package's example)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    """(fn's return value, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return ret, buf.getvalue().strip().splitlines()


def _runner(name):
    return importlib.import_module(f"nnstreamer_tpu_torch.examples.{name}")


def test_long_context_runner_matches_jax(jax_zoo):
    """The stream line, ring and Ulysses at the example's sizes and data:
    the window against the JAX line on the same weights, ring and Ulysses
    against the JAX functions over the JAX package's sp=8 CPU mesh; the
    CPU launches no kernel."""
    from nnstreamer_tpu import pipeline as jax_pipeline
    from nnstreamer_tpu.buffer import Buffer
    from nnstreamer_tpu.ops import ring_attention, ulysses_attention
    from nnstreamer_tpu.parallel import make_mesh

    lc = _runner("long_context")
    custom = dict(kv.split(":") for kv in lc.STREAM_CUSTOM.split(","))
    custom.pop("seed")
    npz = jax_zoo("stream_transformer", custom)
    got, printed = _printed(lc.main, CPU + ["--params", npz])
    assert printed == [
        "stream transformer output: (1, 128, 16)",
        "ring attention over sp=8 mesh: seq=1024 -> (2, 1024, 32)",
        "ulysses (all-to-all) over sp=8 mesh: seq=1024 -> (2, 8, 1024, 32)"]
    p = jax_pipeline.parse_launch(
        f"appsrc name=src caps=other/tensors,format=static,"
        f"dimensions={lc.FEAT},types=float32 ! tensor_aggregator frames_in=1 "
        f"frames_out={lc.SEQ} frames_dim=1 ! tensor_filter framework=jax "
        f"model=stream_transformer custom={lc.STREAM_CUSTOM} "
        "! tensor_sink name=out")
    p.play()
    for f in got["frames"]:
        p["src"].push_buffer(Buffer(tensors=[f]))
    want = np.asarray(p["out"].pull(timeout=120.0).tensors[0])
    p.stop()
    assert got["stream"].shape == want.shape == (1, 128, 16)
    np.testing.assert_allclose(got["stream"], want, atol=0.15, rtol=0.05)
    mesh = make_mesh(dp=1, tp=1, sp=8)
    for name, fn, x in (("ring", ring_attention, got["q"]),
                        ("ulysses", ulysses_attention, got["qh"])):
        x = jnp.asarray(x, jnp.float32)
        jitted = jax.jit(functools.partial(fn, mesh=mesh, axis_name="sp",
                                           causal=True))
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(jitted(x, x, x)), atol=3e-5)
    assert all(n == 0 for step in got["launches"].values()
               for n in step.values())


@pytest.mark.parametrize("name,zoo,custom", [
    ("classification", "mobilenet_v2", {"size": "96", "width": "0.35"}),
    ("detection", "ssd_mobilenet", {"size": "96", "width": "0.35",
                                    "classes": "8"})])
def test_vision_runner_prints_the_jax_example(jax_zoo, name, zoo, custom):
    """The JAX example's own main (seed:0) and the runner on the same
    weights print the same lines: the labels of both 4-frame tensors, the
    overlay's shape and the decoded objects' count."""
    _, want = _printed(_jax_example(name).main)
    got, printed = _printed(_runner(name).main,
                            CPU + ["--params", jax_zoo(zoo, custom)])
    assert printed == want
    if name == "classification":
        assert [f"labels: {labels}" for labels in got] == want
        assert len(got) == 2 and all(len(b) == 4 for b in got)
    else:
        assert got["overlay"].shape == (96, 96, 4)
        assert got["overlay"].dtype == np.uint8
        assert want == [f"overlay: (96, 96, 4) objects: "
                        f"{len(got['objects'])}"]


def test_query_offload_runner_prints_the_jax_example():
    """The loopback's three answers, as the JAX example prints them."""
    _, want = _printed(_jax_example("query_offload").main)
    got, printed = _printed(_runner("query_offload").main, CPU)
    assert printed == want
    for i, res in enumerate(got):
        assert res.dtype == np.float32
        np.testing.assert_array_equal(res, np.full(4, (i + 1) * 10.0))


def test_training_runner_matches_jax_on_the_same_weights(tmp_path):
    """The example's line through the JAX trainer with the runner's model
    as a JAX file (the same numpy weights) and the runner's samples: the
    same epoch reports, and both save a checkpoint."""
    from nnstreamer_tpu.pipeline import parse_launch

    tr = _runner("training")
    got, printed = _printed(tr.main, CPU)
    data, meta = str(tmp_path / "d.raw"), str(tmp_path / "d.json")
    tr.write_repo(data, meta)
    model = tmp_path / "model.py"
    model.write_text(
        "import numpy as np\nimport jax.numpy as jnp\n"
        "def make_model(custom):\n"
        "    rng = np.random.default_rng(0)\n"
        f"    w = (rng.normal(size=({tr.FEAT}, {tr.CLASSES})) * 0.1)"
        ".astype(np.float32)\n"
        "    params = {'w': jnp.asarray(w), "
        f"'b': jnp.zeros(({tr.CLASSES},))}}\n"
        "    def apply_fn(p, x):\n"
        "        return x @ p['w'] + p['b']\n"
        "    return apply_fn, params\n")
    ckpt = tmp_path / "ckpt"
    p = parse_launch(
        f"datareposrc location={data} json={meta} epochs={tr.EPOCHS} "
        f"! tensor_trainer framework=jax model-config={model} "
        f"model-save-path={ckpt} num-inputs=1 num-labels=1 "
        f"num-training-samples={tr.N} num-validation-samples=0 "
        f"epochs={tr.EPOCHS} custom=batch:8,lr:0.1 ! tensor_sink name=out")
    p.run(timeout=300)
    want = [np.asarray(r[0]).reshape(-1) for r in p["out"].collected]
    assert len(got["epochs"]) == len(want) == tr.EPOCHS
    for g, w in zip(got["epochs"], want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert got["saved"] and os.path.exists(ckpt)
    assert printed[-1] == "checkpoint saved: True"
    assert len(printed) == tr.EPOCHS + 1


def test_native_pipeline_runner_gives_the_jax_top1():
    """The port's core runs the torch top-1 through the callback ABI: the
    classes the JAX example's jitted top-1 gives on its frames."""
    got, printed = _printed(_runner("native_pipeline").main, CPU)
    top1 = jax.jit(lambda x: jnp.argmax(x, -1).astype(jnp.int32))
    want = []
    for i in range(4):
        x = np.zeros(16, np.float32)
        x[i * 3] = 1.0
        want.append((i, int(top1(x))))
    assert got == want
    assert printed == [f"frame {p}: top-1 class = {c}" for p, c in want]


def test_tflite_runner_matches_jax_import(tmp_path):
    """A MobileNet-v2 .tflite (the zoo's seed weights, written by
    testing/model_files.py) through the runner and through the JAX
    example's line: float32 logits within 1e-4, equal argmax."""
    from nnstreamer_tpu.buffer import Buffer
    from nnstreamer_tpu.pipeline import parse_launch
    from nnstreamer_tpu_torch.testing import model_files

    path = str(tmp_path / "mbv2.tflite")
    model_files.write_mobilenet_v2_tflite(
        path, {"seed": "0", "width": "0.35", "size": "96"})
    got, printed = _printed(_runner("tflite_models").main,
                            [path, "2"] + CPU)
    assert printed[0] == "mbv2.tflite: input 3:96:96:1 float32, 1 output(s)"
    p = parse_launch(
        "appsrc name=src caps=other/tensors,num-tensors=1,"
        "dimensions=3:96:96:1,types=float32,framerate=0/1 "
        f"! tensor_filter framework=jax model={path} ! tensor_sink name=out")
    p.play()
    rng = np.random.default_rng(0)
    for _ in range(2):
        p["src"].push_buffer(Buffer(tensors=[
            rng.normal(0, 1, (1, 96, 96, 3)).astype(np.float32)]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(120)
    want = [np.asarray(b[0]) for b in p["out"].collected]
    p.stop()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 1001)
        assert np.abs(g - w).max() <= 1e-4
        assert np.argmax(g) == np.argmax(w)


def test_tflite_runner_default_path_raises_by_name():
    with pytest.raises(FileNotFoundError, match="deeplabv3_257_mv_gpu"):
        _runner("tflite_models").main(CPU)


def test_runners_import_inert_and_take_the_card_by_default(monkeypatch):
    """Importing a runner sets no environment variable and builds nothing;
    without ``--device cpu`` a runner asks for the card and, with none,
    raises instead of taking the CPU."""
    from nnstreamer_tpu_torch.examples import parse_args

    env = dict(os.environ)
    for name in RUNNERS:
        mod = f"nnstreamer_tpu_torch.examples.{name}"
        sys.modules.pop(mod, None)
        importlib.import_module(mod)
    assert dict(os.environ) == env
    assert parse_args(["m.tflite", "--device", "cpu", "3"]) == (
        "cpu", None, ["m.tflite", "3"])
    with pytest.raises(ValueError, match="--device"):
        parse_args(["--device", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in RUNNERS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _runner(name).main([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert parse_args(["--params", "w.npz"]) == ("cuda", "w.npz", [])
