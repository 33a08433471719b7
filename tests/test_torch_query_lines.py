"""The serving lines through both packages, on the CPU.

- ``examples/query_offload.py``'s server and client lines (plain query
  offload, ``model=scaler``) and the three lines of
  ``examples/launch_lines_serving.txt`` as written (``model=add``, with
  ``accelerator=true:cpu`` added to the port's filter, whose default
  device is the card): every client of 4 gets its 8 answers, exact, in
  order, from the port as from the JAX package.
- The serving slice: ``tensor_query_serversrc serve=1 ! tensor_filter
  model=mobilenet_v2 ! tensor_query_serversink`` at
  tests/test_torch_pipeline.py's size (64 px, width 0.35, 16 classes) on
  flax's weights, carried into the port with ``from_jax_variables``; the
  same seeded frames from 4 clients through the JAX serving line and the
  port's. The zoo line computes in bf16 in both packages, so its logits
  are held at the JAX package's bf16 line tolerance (atol 0.15, rtol
  0.05; tests/test_torch_pipeline.py) and its labels (perturbed weights,
  with and without ``postproc:argmax``) must be equal. The same serving
  line on a float32 MobileNet-v2 (registered in both zoos by this file:
  flax's float32 module in the JAX package, the port's float32 BN-folded
  fused forward) is held at tests/test_torch_model.py's float32
  tolerance, atol = rtol = 5e-4, with equal argmax.

Every wait and ``join`` is bounded; ports are ``port=0``.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu import pipeline as jpipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JBuffer  # noqa: E402
from nnstreamer_tpu_torch import pipeline as tpipeline  # noqa: E402
from nnstreamer_tpu_torch import trace as ttrace  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as TBuffer  # noqa: E402
from test_torch_pipeline import CUSTOM, weights  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": (jpipeline, JBuffer), "port": (tpipeline, TBuffer)}
CPU = "accelerator=true:cpu"


def _cpu(line):
    """The port's filter runs on the CPU here (its default is the card)."""
    return line.replace("custom=k:1,aot:0", f"custom=k:1,aot:0 {CPU}")


def serve(pkg, server_line, client_caps, frames_of, n_clients,
          client_tail=""):
    """Play ``server_line``, run ``n_clients`` client pipelines of the
    same package in threads (client ``i`` pushes ``frames_of(i)``), and
    return ({client: [reply buffers]}, the server's serving report)."""
    mod, Buffer = PKG[pkg]
    server = mod.parse_launch(server_line)
    tracer = None
    if pkg == "port":
        tracer = ttrace.attach(server)
    server.play()
    results = {}
    try:
        src = next(e for e in server.elements.values()
                   if type(e).__name__ == "TensorQueryServerSrc")
        port = src.port

        def client(idx):
            cl = mod.parse_launch(
                f"appsrc name=src caps={client_caps} ! tensor_query_client "
                f"port={port} timeout=60 on-error=retry:12 "
                f"retry-backoff-ms=10 {client_tail}! tensor_sink name=out")
            cl.play()
            try:
                for i, f in enumerate(frames_of(idx)):
                    cl["src"].push_buffer(Buffer(tensors=[f], pts=i))
                cl["src"].end_of_stream()
                ok = cl.bus.wait_eos(120)
                results[idx] = (ok, cl.bus.error, list(cl["out"].collected))
            finally:
                cl.stop()

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive(), "a client pipeline hung"
    finally:
        server.stop()
    out = {}
    for idx, (ok, err, bufs) in results.items():
        assert ok and err is None, (pkg, idx, err)
        out[idx] = bufs
    rep = tracer.serving() if tracer is not None else None
    return out, rep


def _arrays(bufs):
    return [np.asarray(b.tensors[0]) for b in bufs]


# -- the example lines -------------------------------------------------------

def test_query_offload_example_lines():
    """examples/query_offload.py's server and client lines (scaler
    scale:10, no serving tier) through both packages: the same answers."""
    caps = "other/tensors,format=static,dimensions=4,types=float32"
    got = {}
    for pkg in PKG:
        extra = f" {CPU}" if pkg == "port" else ""
        line = (f"tensor_query_serversrc name=ss id=q1{pkg} port=0 "
                f"caps={caps} ! tensor_filter framework=jax model=scaler "
                f"custom=scale:10{extra} ! tensor_query_serversink "
                f"id=q1{pkg}")
        out, _ = serve(pkg, line, caps,
                       lambda i: [np.full(4, k + 1, np.float32)
                                  for k in range(3)], 1)
        got[pkg] = _arrays(out[0])
    for j, p in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(got["port"][2].reshape(-1),
                                  np.full(4, 30.0, np.float32))


def _serving_lines():
    with open(os.path.join(ROOT, "examples", "launch_lines_serving.txt"),
              encoding="utf-8") as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def test_the_serving_lines_file_has_three_lines():
    lines = _serving_lines()
    assert len(lines) == 3
    assert all("serve=1" in ln and "model=add" in ln for ln in lines)


@pytest.mark.parametrize("index", [0, 1, 2], ids=["flagship", "tenants",
                                                   "linger"])
def test_reference_serving_line(index):
    """4 clients x 8 requests through the line as written: every client
    gets x + 1 for each of its requests, in order, from both packages.
    The clients keep one request in flight each and ride out a shed with
    on-error=retry (the multi-tenant line's rate limit and the small
    lines' queue bounds shed under 4 clients; a retried request answered
    after a later one would reorder a client with more in flight)."""
    line = _serving_lines()[index]
    dims = "8" if "dimensions=8" in line else "4"
    caps = (f"other/tensors,num-tensors=1,dimensions={dims},types=float32,"
            "framerate=0/1")
    n = int(dims)

    def frames_of(i):
        return [np.full(n, 10.0 * i + k, np.float32) for k in range(8)]

    got = {}
    for pkg in PKG:
        out, rep = serve(pkg, _cpu(line) if pkg == "port" else line, caps,
                         frames_of, 4, client_tail="max-in-flight=1 ")
        got[pkg] = {i: _arrays(b) for i, b in out.items()}
        if rep is not None:
            (s,) = rep.values()
            assert s["replies"] == 32 and s["reply_drops"] == 0
    for i in range(4):
        want = [f + 1 for f in frames_of(i)]
        for pkg in PKG:
            assert len(got[pkg][i]) == 8
            for g, w in zip(got[pkg][i], want):
                np.testing.assert_array_equal(g.reshape(-1), w)


# -- the serving slice: MobileNet-v2 -----------------------------------------

SIZE = 64
FRAME_CAPS = (f"other/tensors,num-tensors=1,dimensions=3:{SIZE}:{SIZE},"
              "types=uint8,framerate=0/1")
N_CLIENTS = 4
PER_CLIENT = 4


def _mbv2_line(sid, custom, extra=""):
    return (f"tensor_query_serversrc id={sid} port=0 serve=1 serve-batch=4 "
            f"serve-queue-depth=64 caps={FRAME_CAPS} ! tensor_filter "
            f"framework=jax model=mobilenet_v2 custom={custom} {extra} "
            f"! tensor_query_serversink id={sid} timeout=30")


def _client_frames(frames):
    """Client i's frames: the fixture's frames, rolled by i so clients
    differ."""
    return lambda i: [frames[(i + k) % len(frames)] for k in range(PER_CLIENT)]


def test_mobilenet_serving_logits_match(weights):
    """flax's seed:0 weights as they are; the zoo line in bf16 in both."""
    _, _, npz_seed0, _, frames = weights
    got = {}
    for pkg, custom in (("jax", f"seed:0,{CUSTOM}"),
                        ("port", f"params:{npz_seed0},{CUSTOM}")):
        out, rep = serve(pkg, _mbv2_line(f"m{pkg}", custom,
                                         CPU if pkg == "port" else ""),
                         FRAME_CAPS, _client_frames(frames), N_CLIENTS)
        got[pkg] = out
        if rep is not None:
            (s,) = rep.values()
            assert s["rows"] == N_CLIENTS * PER_CLIENT and s["shed"] == 0
    for i in range(N_CLIENTS):
        g, w = _arrays(got["port"][i]), _arrays(got["jax"][i])
        assert len(g) == len(w) == PER_CLIENT
        for a, b in zip(g, w):
            assert a.shape == b.shape == (16,)
            np.testing.assert_allclose(a, b, atol=0.15, rtol=0.05)


@pytest.mark.parametrize("form", ["decoder", "argmax"])
def test_mobilenet_serving_labels_match(weights, form):
    """The perturbed weights (distinct labels): labels decoded at each
    client by image_labeling, or postproc:argmax on the server (one 0-d
    row per reply), are equal in both packages."""
    msgpack, npz, _, labels, frames = weights
    pp = ",postproc:argmax" if form == "argmax" else ""
    tail = (f"! tensor_decoder mode=image_labeling option1={labels} "
            if form == "decoder" else "")
    got = {}
    for pkg, custom in (("jax", f"params:{msgpack}{pp},{CUSTOM}"),
                        ("port", f"params:{npz}{pp},{CUSTOM}")):
        out, _ = serve(pkg, _mbv2_line(f"l{pkg}{form}", custom,
                                       CPU if pkg == "port" else ""),
                       FRAME_CAPS, _client_frames(frames), N_CLIENTS,
                       client_tail=tail)
        if form == "decoder":
            got[pkg] = {i: [b.meta["label"] for b in bufs]
                        for i, bufs in out.items()}
        else:
            got[pkg] = {i: [int(a.reshape(-1)[0]) for a in _arrays(bufs)]
                        for i, bufs in out.items()}
    assert got["port"] == got["jax"]
    assert all(len(v) == PER_CLIENT for v in got["port"].values())
    assert len({x for v in got["jax"].values() for x in v}) > 1


@pytest.fixture(scope="module")
def f32_models():
    """A float32 MobileNet-v2 (64 px, width 0.35, 16 classes) registered
    as ``mbv2_f32_serving`` in both zoos: flax's init with the BatchNorm
    statistics perturbed (tests/test_torch_model.py's recipe); the JAX
    package runs flax's float32 module, the port the same weights through
    from_jax_variables in its float32 BN-folded fused forward."""
    from nnstreamer_tpu import models as jmodels
    from nnstreamer_tpu.models.mobilenet_v2 import MobileNetV2 as FlaxMBV2
    from nnstreamer_tpu.models.mobilenet_v2 import make_apply
    from nnstreamer_tpu.types import TensorsInfo as JInfo
    from nnstreamer_tpu_torch import models as tmodels
    from nnstreamer_tpu_torch.models.convert import from_jax_variables
    from nnstreamer_tpu_torch.models.mobilenet_v2 import (
        MobileNetV2,
        _make_fused_apply,
        infer_output,
    )
    from nnstreamer_tpu_torch.types import TensorsInfo as TInfo

    rng = np.random.default_rng(2)
    flax_model = FlaxMBV2(num_classes=16, width_mult=0.35, dtype=jnp.float32)
    variables = flax_model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.1, a.shape).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    in_s, out_s = f"3:{SIZE}:{SIZE}:1", "16:1"
    name = "mbv2_f32_serving"

    def jbuild(custom):
        return jmodels.ModelBundle(
            apply_fn=make_apply(flax_model), params=variables,
            input_info=JInfo.from_strings(in_s, "uint8"),
            output_info=JInfo.from_strings(out_s, "float32"))

    state = from_jax_variables(jax.device_get(variables))

    def tbuild(custom, device):
        m = MobileNetV2(num_classes=16, width_mult=0.35, dtype=torch.float32)
        m.load_state_dict(state)
        m = m.to(device).eval()
        fused = _make_fused_apply(m, mode="kernel",
                                  compute_dtype=torch.float32)

        def apply_fn(x):
            return fused(tmodels.preprocess_frames(x, "pm1", torch.float32))

        return tmodels.ModelBundle(
            apply_fn=apply_fn, module=m,
            input_info=TInfo.from_strings(in_s, "uint8"),
            output_info=TInfo.from_strings(out_s, "float32"),
            infer_output=lambda info: infer_output(info, 16))

    jmodels.register_model(name)(jbuild)
    tmodels.register_model(name)(tbuild)
    yield name
    jmodels._zoo.pop(name, None)
    tmodels._zoo.pop(name, None)


def test_mobilenet_serving_float32_matches(f32_models, weights):
    """The float32 serving line: every client's replies at atol = rtol =
    5e-4 of the JAX package's, with equal argmax."""
    frames = weights[-1]
    got = {}
    for pkg in PKG:
        line = _mbv2_line(f"f{pkg}", "a:1", CPU if pkg == "port" else "")
        line = line.replace("model=mobilenet_v2", f"model={f32_models}")
        out, _ = serve(pkg, line, FRAME_CAPS, _client_frames(frames),
                       N_CLIENTS)
        got[pkg] = {i: np.stack(_arrays(b)) for i, b in out.items()}
    for i in range(N_CLIENTS):
        g, w = got["port"][i], got["jax"][i]
        assert g.shape == w.shape == (PER_CLIENT, 16)
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4)
        assert (g.argmax(-1) == w.argmax(-1)).all()
