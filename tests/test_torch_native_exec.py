"""framework=pjrt on the port: native_aot_compile's frozen TorchScript
program run by the native executable filter (csrc/native_exec.cc) inside
the port's core, on the CPU (``custom=device:cpu``).

The CPU build of the filter links libtorch without CUDA; a program traced
on the CPU records the kernels' plain versions. The cases: the reference's
``add`` program through tools/pjrt_native.py's default mode in a child that
imports no torch (tests/test_pjrt_native.py, the TPU test); the signature
sidecar as both packages read it; a traced program that follows its input
(no constant baked in); the frozen program's logits against the JAX
forward on frames of two classes; the ctypes-launch guard; the flagship graph
(videotestsrc ! tensor_converter ! tensor_filter framework=pjrt !
tensor_decoder image_labeling ! appsink) against the JAX package's Python
image-labeling line on the same weights and frames; the compile cache's
bookkeeping of the .pjrt/.sig pair; and the open's refusal without a card.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from nnstreamer_tpu.tools import pjrt_native as jax_pjrt  # noqa: E402
from nnstreamer_tpu_torch import native_rt  # noqa: E402
from nnstreamer_tpu_torch.filters import aot  # noqa: E402
from nnstreamer_tpu_torch.ops import _cuda  # noqa: E402
from nnstreamer_tpu_torch.tools import pjrt_native  # noqa: E402
from test_torch_native import MBV2 as MBV2_96  # noqa: E402
from test_torch_native import mbv2  # noqa: E402,F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "device:cpu"
#: the flagship at a small width: 224 px (the native videotestsrc's size),
#: 16 classes
MBV2 = "width:0.35,classes:16"
BATCH, BATCHES = 4, 2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A private compile cache, the port's core and the CPU build of the
    native filter, loaded once for the module."""
    if shutil.which("g++") is None:
        pytest.skip("the native core and filter need g++")
    d = tmp_path_factory.mktemp("native_exec")
    mp = pytest.MonkeyPatch()
    mp.setenv("NNSTPU_AOT_CACHE", str(d / "cache"))
    runner = native_rt.build_exec()
    native_rt.load_exec(runner)
    yield {"dir": d, "runner": runner}
    mp.undo()


@pytest.fixture(scope="module")
def add_program(env):
    return aot.native_aot_compile("add", "k:1.5", [((4, 4), "float32")],
                                  device="cpu")


def test_add_program_through_the_default_mode(env, add_program):
    """tests/test_pjrt_native.py's case on the CPU: the frozen ``add``
    program through pjrt_native's default mode in a child process, exact
    against x + 1.5, and the child imports no torch in Python."""
    with open(add_program + ".sig") as f:
        assert f.read() == "nnstpu-pjrt-sig v1\nin f32 2 4 4\nout f32 2 4 4\n"
    x = np.random.default_rng(0).normal(0, 1, (4, 4)).astype(np.float32)
    want = env["dir"] / "want.npy"
    np.save(want, x + 1.5)
    spec = env["dir"] / "spec.json"
    spec.write_text(json.dumps({
        "exec": add_program, "frames": 4, "seed": 0,
        "check_path": str(want), "runner": env["runner"], "custom": CPU}))
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.tools.pjrt_native",
         str(spec)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["check_max_err"] == 0.0
    assert result["invokes_per_sec"] > 0
    assert result["python_torch"] is False


def test_open_without_card_names_the_reason(env, add_program):
    """No card and no ``device:cpu``: the open fails and says why."""
    with pytest.raises(RuntimeError, match="say custom=device:cpu"):
        pjrt_native.open_native(add_program, custom="device:cuda:0")
    # the same program opens on the CPU afterwards
    (out,), = pjrt_native.run_native(add_program,
                                     [[np.ones((4, 4), np.float32)]],
                                     custom=CPU)
    np.testing.assert_array_equal(out.view(np.float32), np.full(16, 2.5))


def test_sidecar_reads_the_same_in_both_packages(env):
    path = aot.native_aot_compile(
        "mobilenet_v2", f"seed:0,size:96,{MBV2},postproc:argmax,fused:pallas",
        [((2, 96, 96, 3), "uint8")], device="cpu")
    assert path.endswith(".pjrt")
    sig = pjrt_native._read_sig(path + ".sig")
    assert sig == jax_pjrt._read_sig(path + ".sig")
    assert sig == {"in": [("u8", [2, 96, 96, 3])], "out": [("i32", [2])]}
    assert pjrt_native._caps_from_sig(sig) == jax_pjrt._caps_from_sig(sig)


def test_traced_program_follows_its_input(env):
    """The guard against a baked constant: the program's logits for two
    different batches differ, and each is the eager forward's (the same
    plain ops on the CPU, to float32 rounding of a different order)."""
    from nnstreamer_tpu_torch.models import get_model

    custom = f"seed:0,size:96,{MBV2},fused:pallas"
    path = aot.native_aot_compile("mobilenet_v2", custom,
                                  [((2, 96, 96, 3), "uint8")], device="cpu")
    rng = np.random.default_rng(4)
    xs = [rng.integers(0, 256, (2, 96, 96, 3)).astype(np.uint8)
          for _ in range(2)]
    outs = [o[0].view(np.float32).reshape(2, 16) for o in
            pjrt_native.run_native(path, [[x] for x in xs], custom=CPU)]
    assert np.abs(outs[0] - outs[1]).max() > 1e-2
    bundle = get_model("mobilenet_v2", aot.custom_dict(custom), "cpu")
    for x, got in zip(xs, outs):
        with torch.no_grad():
            want = bundle.apply_fn(torch.from_numpy(x)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_frozen_program_logits_match_the_jax_forward(env, mbv2):
    """The frozen program itself against the JAX package: MobileNet-v2
    (width 0.35, 96 px, 16 classes) on the converted, perturbed flax
    weights of tests/test_torch_native.py's callback case, traced without
    the argmax and run by the native filter (``custom=device:cpu``), against
    the JAX forward on the same eight frames: argmax equal on every frame,
    over two classes, and logits within a tenth of their own scale (the
    callback case's limit: the two packages' bf16 forwards differ by up to
    4.4 on logits up to 104 there)."""
    b, variables, npz, frames = mbv2
    custom = ",".join([f"params:{npz}", "fused:pallas"]
                      + [f"{k}:{v}" for k, v in MBV2_96.items()])
    path = aot.native_aot_compile("mobilenet_v2", custom,
                                  [(frames.shape, "uint8")], device="cpu")
    (out,), = pjrt_native.run_native(path, [[frames]], custom=CPU)
    got = out.view(np.float32).reshape(len(frames), -1)
    ref = np.asarray(jax.jit(lambda x: b.apply_fn(variables, x))(frames),
                     np.float32)
    assert got.shape == ref.shape == (len(frames), 16)
    labels = ref.argmax(-1)
    np.testing.assert_array_equal(got.argmax(-1), labels)
    assert len(set(labels.tolist())) > 1  # the labels have teeth
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.1 * scale)


def test_ctypes_launch_under_tracing_raises():
    """A ctypes launch cannot be traced (its output would be recorded as a
    constant): the guard every launch passes raises under torch.jit.trace
    and is silent outside it. No kernel runs on the CPU; the guard's own
    check is what the launches call (ops/_cuda.launcher)."""
    _cuda.refuse_tracing("k")  # outside a trace: nothing

    def f(x):
        _cuda.refuse_tracing("fused_inverted_residual")
        return x + 1

    with pytest.raises(RuntimeError, match="cannot be traced"), \
            aot.quiet_jit():
        torch.jit.trace(f, (torch.zeros(2),), check_trace=False)


def test_flagship_graph_on_cpu_matches_the_jax_line(env, tmp_path):
    """run_flagship's graph with ``custom=device:cpu``: MobileNet-v2 (width
    0.35, 224 px, 16 classes) on flax's seed:0 weights perturbed as
    tests/test_torch_pipeline.py does and carried across
    (from_jax_variables), argmax folded into the program, against the JAX
    package's Python image-labeling line on the same weights and the same
    videotestsrc frames (testsrc_frame): every label equal. The warm-up
    batch's labels are not returned by run_flagship; its frames are the
    first BATCH. The test source's frames are shifted copies of one
    gradient and take one class here; the perturbation's seed (2) was
    picked for its margin (61 on logits of the JAX forward, against the
    packages' bf16 differences of a few units).
    test_frozen_program_logits_match_the_jax_forward holds a frozen
    program's logits against the JAX forward on frames of two classes, and
    test_traced_program_follows_its_input holds that it follows its
    frames."""
    import flax.serialization
    from test_torch_pipeline import _perturb

    from nnstreamer_tpu import pipeline as jax_pipeline
    from nnstreamer_tpu.buffer import Buffer as JaxBuffer
    from nnstreamer_tpu.models import get_model
    from nnstreamer_tpu_torch.models.convert import (
        from_jax_variables,
        save_state_dict,
    )

    b = get_model("mobilenet_v2", {"seed": "0", "width": "0.35",
                                   "classes": "16"})
    variables = _perturb(jax.device_get(b.params), 2)
    npz, msgpack = str(tmp_path / "w.npz"), str(tmp_path / "w.msgpack")
    save_state_dict(from_jax_variables(variables), npz)
    with open(msgpack, "wb") as f:
        f.write(flax.serialization.to_bytes(variables))
    labels = str(tmp_path / "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"label{i}" for i in range(16)) + "\n")

    path = aot.native_aot_compile(
        "mobilenet_v2", f"params:{npz},{MBV2},postproc:argmax,fused:pallas",
        [((BATCH, 224, 224, 3), "uint8")], device="cpu")
    fps, got = pjrt_native.run_flagship(path, labels, BATCHES, BATCH,
                                        custom=CPU, timeout=120)
    assert fps > 0 and len(got) == BATCHES
    got = [lab for batch in got for lab in batch]

    p = jax_pipeline.parse_launch(
        "appsrc name=src caps=video/x-raw,format=RGB,width=224,height=224,"
        f"framerate=30/1 ! tensor_converter frames-per-tensor={BATCH} "
        "! tensor_filter framework=jax model=mobilenet_v2 "
        f"custom=params:{msgpack},{MBV2},postproc:argmax "
        f"! tensor_decoder mode=image_labeling option1={labels} "
        "! tensor_sink name=out")
    p.play()
    for i in range((BATCHES + 1) * BATCH):
        p["src"].push_buffer(JaxBuffer(tensors=[pjrt_native.testsrc_frame(i)]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(300)
    assert p.bus.error is None, p.bus.error
    want = []
    for buf in p["out"].collected[1:]:
        lab = buf.meta["label"]
        want.extend(lab if isinstance(lab, list) else [lab])
    p.stop()
    assert got == want
    assert len(got) == BATCHES * BATCH


def test_native_program_is_one_cache_entry(env, add_program, monkeypatch):
    """The .pjrt/.sig pair counts once in cache_entries (its size the
    two files'), lists in doctor --aot, and goes together under the cache
    budget."""
    from nnstreamer_tpu_torch.tools import doctor

    sig = add_program + ".sig"
    rows = [r for r in aot.cache_entries()
            if r["path"] == add_program]
    assert len(rows) == 1 and rows[0]["native"]
    assert rows[0]["size"] == (os.path.getsize(add_program)
                               + os.path.getsize(sig))
    assert not any(r["file"].endswith(".sig") for r in aot.cache_entries())
    assert os.path.basename(add_program)[:44] in doctor.render_aot_cache()
    monkeypatch.setenv("NNSTPU_AOT_CACHE_MAX_BYTES", "0")
    assert aot.enforce_cache_budget() >= 1
    assert not os.path.exists(add_program) and not os.path.exists(sig)
    # built again for the tests after this one
    assert aot.native_aot_compile("add", "k:1.5", [((4, 4), "float32")],
                                  device="cpu") == add_program
