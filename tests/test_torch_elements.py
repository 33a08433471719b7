"""The port's elements, on the CPU: the transform lines through both
packages (bit-equal; clamp at atol 1e-6 as in
tests/test_ops.py::TestTransformDeviceAccel), tensor_filter's refusal of
properties this package does not implement, the backend's device rule,
the per-package registries, tensor_aggregator, and the rest of
elements/basic.py (tee, identity, filesrc/filesink, videotestsrc), the
test models and the passthrough and custom-easy backends through both
packages: byte-equal, or equal arrays (the models compute the same
float32 or integer expression; matmul, whose weights differ between the
packages, against its own bf16 product at 2e-2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from nnstreamer_tpu import pipeline as jax_pipeline  # noqa: E402
from nnstreamer_tpu.buffer import Buffer as JaxBuffer  # noqa: E402
from nnstreamer_tpu_torch import pipeline as port_pipeline  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer as PortBuffer  # noqa: E402
from nnstreamer_tpu_torch.log import ElementError  # noqa: E402


#: the port's transform runs on the CPU only when asked: the JAX package
#: says acceleration=device, the port acceleration=device:cpu
@pytest.mark.parametrize("line,x,exact", [
    ("appsrc name=src caps=other/tensors,format=static,dimensions=128:8,"
     "types=uint8 ! tensor_transform mode=arithmetic "
     "option=typecast:float32,add:-127.5,div:127.5 acceleration={acc} "
     "! tensor_sink name=out",
     np.random.default_rng(6).integers(0, 256, (8, 128), np.uint8), True),
    ("appsrc name=src caps=other/tensors,format=static,dimensions=1024,"
     "types=float32 ! tensor_transform mode=clamp option=-1:1 "
     "acceleration={acc} ! tensor_sink name=out",
     np.linspace(-2, 2, 1024, dtype=np.float32), False),
])
def test_transform_line_matches(line, x, exact):
    outs = []
    for mod, buf, acc in ((jax_pipeline, JaxBuffer, "device"),
                          (port_pipeline, PortBuffer, "device:cpu")):
        p = mod.parse_launch(line.format(acc=acc))
        p.play()
        p["src"].push_buffer(buf(tensors=[x]))
        got = p["out"].pull(timeout=30.0)
        p.stop()
        assert got is not None
        outs.append(np.asarray(got.tensors[0]))
    assert outs[1].dtype == np.float32
    if exact:
        np.testing.assert_array_equal(outs[1], outs[0])
    else:
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)


def test_transform_without_leading_cast_takes_numpy_path():
    """The device gate: a chain that does not lead with typecast:float32
    stays on the numpy path (same dtype out as numpy gives)."""
    x = np.arange(1024, dtype=np.int32)
    p = port_pipeline.parse_launch(
        "appsrc name=src caps=other/tensors,format=static,dimensions=1024,"
        "types=int32 ! tensor_transform mode=arithmetic option=add:2 "
        "acceleration=device:cpu ! tensor_sink name=out")
    p.play()
    p["src"].push_buffer(PortBuffer(tensors=[x]))
    got = p["out"].pull(timeout=30.0)
    p.stop()
    np.testing.assert_array_equal(np.asarray(got.tensors[0]), x + 2.0)


@pytest.mark.parametrize("acc", ["device", "pallas", "true"])
def test_transform_device_without_a_card_raises(acc, monkeypatch):
    """acceleration=device on a host whose torch sees no card raises at
    start unless the property asks for the CPU: the chain never moves to
    the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    line = ("appsrc name=src caps=other/tensors,format=static,"
            "dimensions=4,types=uint8 ! tensor_transform mode=arithmetic "
            f"option=typecast:float32,add:1 acceleration={acc} "
            "! tensor_sink name=out")
    p = port_pipeline.parse_launch(line)
    with pytest.raises(Exception, match="device:cpu"):
        p.play()
    p.stop()
    p = port_pipeline.parse_launch(line.replace(
        f"acceleration={acc}", f"acceleration={acc}:cpu"))
    p.play()
    p["src"].push_buffer(PortBuffer(tensors=[np.arange(4, dtype=np.uint8)]))
    got = p["out"].pull(timeout=30.0)
    p.stop()
    np.testing.assert_array_equal(np.asarray(got.tensors[0]),
                                  np.arange(4, dtype=np.float32) + 1)


#: properties this package has ported since it first refused them: their
#: cases below now check that the element takes them
PORTED_PROPS = ("batch-size=4", "feed-depth=2", "fetch-window=auto",
                "invoke-dynamic=true", "loop-window=8",
                "invoke-timeout-ms=10", "fallback-framework=auto",
                "shard=dp", "rollout-model=other")


@pytest.mark.parametrize("prop", [
    "batch-size=4", "feed-depth=2", "fetch-window=auto", "shard=dp",
    "invoke-timeout-ms=10", "fallback-framework=auto", "loop-window=8",
    "invoke-dynamic=true", "rollout-model=other",
])
def test_filter_rejects_unported_properties(prop):
    line = ("appsrc ! tensor_filter framework=jax model=mobilenet_v2 "
            f"{prop} ! tensor_sink")
    if prop in PORTED_PROPS:
        p = port_pipeline.parse_launch(line)
        key, value = prop.split("=")
        f = next(e for e in p.elements.values()
                 if e.ELEMENT_NAME == "tensor_filter")
        assert str(f.properties[key.replace("-", "_")]).lower() == value
        return
    with pytest.raises(ElementError, match="not supported"):
        port_pipeline.parse_launch(line)


def test_filter_accepts_off_values_of_unported_properties():
    port_pipeline.parse_launch(
        "appsrc ! tensor_filter framework=jax model=mobilenet_v2 "
        "batch-size=1 feed-depth=1 shard=off ! tensor_sink")


def test_backend_device_rule(monkeypatch):
    """Default device is cuda; accelerator=true:cpu asks for the CPU; a
    card that is asked for and absent makes open raise (no silent CPU)."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.filters.cuda_filter import pick_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pick_device("") == torch.device("cuda")
    assert pick_device("true:gpu") == torch.device("cuda")
    assert pick_device("true:cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pick_device("")
    f = TensorFilter(framework="jax", model="mobilenet_v2",
                     custom="size:32,width:0.35,classes:8")
    with pytest.raises(ElementError, match="CUDA device"):
        f.start()


def test_registry_is_separate_from_the_jax_package():
    """Both packages in one process: each resolves framework=jax and the
    element names to its own classes."""
    from nnstreamer_tpu import registry as jax_registry
    from nnstreamer_tpu.pipeline.element import element_class as jax_cls
    from nnstreamer_tpu_torch import registry
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter
    from nnstreamer_tpu_torch.pipeline.element import element_class

    assert registry.get(registry.FILTER, "jax") is TorchCudaFilter
    assert registry.get(registry.FILTER, "torch_cuda") is TorchCudaFilter
    assert jax_registry.get(jax_registry.FILTER, "jax").__module__ == \
        "nnstreamer_tpu.filters.jax_filter"
    for name in ("tensor_filter", "tensor_converter", "tensor_decoder",
                 "tensor_transform", "appsrc", "tensor_sink", "queue"):
        assert element_class(name).__module__.startswith(
            "nnstreamer_tpu_torch.")
        assert jax_cls(name).__module__.startswith("nnstreamer_tpu.")


# -- tensor_aggregator ------------------------------------------------------

#: (per-buffer numpy shape, aggregator properties, buffers pushed)
AGG_CASES = {
    "windows": ((4, 8), "frames_in=4 frames_out=8 frames_dim=1", 6),
    "overlap": ((4, 8), "frames_in=4 frames_out=6 frames_flush=2 "
                        "frames_dim=1", 6),
    "inner_dim": ((2, 3, 8), "frames_in=1 frames_out=3 frames_dim=0", 5),
    "new_axis": ((3, 8), "frames_in=1 frames_out=2 frames_dim=2", 5),
}


def _agg_line(shape, props, sink=""):
    dims = ":".join(str(d) for d in reversed(shape))
    return (f"appsrc name=src caps=other/tensors,format=static,"
            f"dimensions={dims},types=float32,framerate=30/1 "
            f"! tensor_aggregator {props} ! tensor_sink name=out {sink}")


def _agg_run(mod, buffer_cls, line, chunks):
    """The buffers tensor_aggregator pushes (seen at its src, before the
    sink brings them to the host)."""
    p = mod.parse_launch(line.replace("tensor_aggregator",
                                      "tensor_aggregator name=agg"))
    agg, pushed = p["agg"], []
    real_push = agg.push

    def push(buf, *a, **kw):
        pushed.append(buf)
        return real_push(buf, *a, **kw)

    agg.push = push
    p.play()
    for i, c in enumerate(chunks):
        p["src"].push_buffer(buffer_cls(tensors=[c], pts=i))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(60)
    assert p.bus.error is None, p.bus.error
    assert len(p["out"].collected) == len(pushed)
    p.stop()
    return pushed


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregator_windows_match(case, kind):
    """Windows, flush and frames_dim as the JAX element gives them: the
    same arrays, the same pts. torch tensors go through torch.split and
    torch.cat and come out as torch tensors into a sink that takes them
    as they are (materialize=false: the aggregator is not the residency
    boundary there)."""
    shape, props, n = AGG_CASES[case]
    rng = np.random.default_rng(8)
    chunks = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    line = _agg_line(shape, props,
                     "materialize=false" if kind == "torch" else "")
    want = _agg_run(jax_pipeline, JaxBuffer, line, chunks)
    port_in = chunks if kind == "numpy" else [torch.from_numpy(c)
                                              for c in chunks]
    got = _agg_run(port_pipeline, PortBuffer, line, port_in)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        t = g.tensors[0]
        assert isinstance(t, torch.Tensor) == (kind == "torch")
        np.testing.assert_array_equal(np.asarray(t), np.asarray(w.tensors[0]))
        assert g.pts == w.pts


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregator_is_the_boundary(case):
    """Before a host sink the aggregator is the residency boundary: the
    backend's tensors window on the backend and each window crosses once,
    at the aggregator, as the JAX element fetches it."""
    import jax.numpy as jnp

    from nnstreamer_tpu import trace as jax_trace
    from nnstreamer_tpu_torch import trace as port_trace

    shape, props, n = AGG_CASES[case]
    rng = np.random.default_rng(9)
    chunks = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    line = _agg_line(shape, props).replace("tensor_aggregator",
                                           "tensor_aggregator name=agg")
    got = {}
    for tag, mod, buf, dev, tr in (
            ("jax", jax_pipeline, JaxBuffer, jnp.asarray, jax_trace),
            ("port", port_pipeline, PortBuffer, torch.from_numpy, port_trace)):
        p = mod.parse_launch(line)
        tracer = tr.attach(p)
        p.play()
        for i, c in enumerate(chunks):
            p["src"].push_buffer(buf(tensors=[dev(c.copy())], pts=i))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(60)
        assert p.bus.error is None, p.bus.error
        got[tag] = ([np.asarray(b.tensors[0]) for b in p["out"].collected],
                    tracer.crossings()["per_element"])
        assert p["agg"].src_pad.device_ok is False
        p.stop()
    assert len(got["port"][0]) == len(got["jax"][0]) > 0
    for g, w in zip(got["port"][0], got["jax"][0]):
        np.testing.assert_array_equal(g, w)
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1]["agg"]["d2h"] == len(got["port"][0])


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregator_caps_match(case):
    """Output caps (dims and framerate) from the same input caps."""
    from nnstreamer_tpu.caps import Caps as JaxCaps
    from nnstreamer_tpu_torch.caps import Caps as PortCaps

    shape, props, _ = AGG_CASES[case]
    line = _agg_line(shape, props)
    caps_str = line.split("caps=", 1)[1].split(" ", 1)[0]
    out = []
    for mod, caps_cls in ((jax_pipeline, JaxCaps), (port_pipeline, PortCaps)):
        agg = mod.parse_launch(line.replace(
            "tensor_aggregator", "tensor_aggregator name=agg"))["agg"]
        out.append(str(agg.transform_caps(agg.sink_pads[0],
                                          caps_cls(caps_str))))
    assert out[0] == out[1]
    assert "framerate=" in out[1]


# -- the rest of elements/basic.py, the test models and filters ------------

def _collect(mod, line, push=(), eos_timeout=30, sink="out"):
    """Run a line through one package: push ``push`` into ``src`` (when
    the line has an appsrc), wait for EOS, return the collected buffers."""
    p = mod.parse_launch(line)
    p.play()
    if push:
        buf_cls = JaxBuffer if mod is jax_pipeline else PortBuffer
        for i, x in enumerate(push):
            p["src"].push_buffer(buf_cls(tensors=[x], pts=i))
        p["src"].end_of_stream()
    assert p.bus.wait_eos(eos_timeout)
    assert p.bus.error is None, p.bus.error
    out = list(p[sink].collected)
    p.stop()
    return out


@pytest.mark.parametrize("props", [
    "pattern=counter format=RGB width=8 height=4",
    "pattern=solid format=RGB width=5 height=3",
    "pattern=smpte format=GRAY8 width=7 height=2",
    "pattern=counter format=GRAY8 width=16 height=16 fps=15",
])
def test_videotestsrc_patterns_byte_equal(props):
    """videotestsrc frames, pts and durations are byte-equal to the JAX
    package's, raw and through tensor_converter."""
    for conv in ("", "! tensor_converter "):
        line = (f"videotestsrc num-buffers=5 {props} {conv}"
                "! tensor_sink name=out")
        want = _collect(jax_pipeline, line)
        got = _collect(port_pipeline, line)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.pts == w.pts and g.duration == w.duration
            a, b = np.asarray(g.tensors[0]), np.asarray(w.tensors[0])
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_tee_fans_out_to_every_branch():
    x = [np.arange(8, dtype=np.float32) + i for i in range(3)]
    caps = ("other/tensors,format=static,dimensions=8,types=float32,"
            "framerate=0/1")
    line = (f"appsrc name=src caps={caps} ! tee name=t "
            "t. ! queue ! tensor_sink name=a "
            "t. ! queue ! identity ! tensor_sink name=b")
    for sink in ("a", "b"):
        want = _collect(jax_pipeline, line, x, sink=sink)
        got = _collect(port_pipeline, line, x, sink=sink)
        assert [b.pts for b in got] == [b.pts for b in want] == [0, 1, 2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g.tensors[0]),
                                          np.asarray(w.tensors[0]))


def test_identity_passes_buffers_and_sleeps():
    import time

    x = [np.full(4, float(i), np.float32) for i in range(3)]
    caps = "other/tensors,format=static,dimensions=4,types=float32"
    line = (f"appsrc name=src caps={caps} ! identity sleep-time=20000000 "
            "! tensor_sink name=out")
    t0 = time.perf_counter()
    got = _collect(port_pipeline, line, x)
    assert time.perf_counter() - t0 >= 0.06  # 3 x 20 ms
    want = _collect(jax_pipeline, line, x)
    assert [np.asarray(b.tensors[0]).tolist() for b in got] == \
        [np.asarray(b.tensors[0]).tolist() for b in want]


@pytest.mark.parametrize("blocksize", [-1, 7, 64])
def test_filesink_filesrc_round_trip(tmp_path, blocksize):
    """filesink writes each tensor's raw bytes; filesrc reads them back as
    one buffer or in blocks — the same files and buffers as the JAX
    package's."""
    rng = np.random.default_rng(12)
    x = [rng.integers(0, 256, (3, 5), np.uint8) for _ in range(4)]
    caps = "other/tensors,format=static,dimensions=5:3,types=uint8"
    paths = {}
    for tag, mod in (("jax", jax_pipeline), ("port", port_pipeline)):
        path = tmp_path / f"{tag}.raw"
        p = mod.parse_launch(f"appsrc name=src caps={caps} "
                             f"! filesink location={path}")
        p.play()
        buf_cls = JaxBuffer if mod is jax_pipeline else PortBuffer
        for a in x:
            p["src"].push_buffer(buf_cls(tensors=[a]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(10)
        p.stop()
        paths[tag] = path
    data = b"".join(a.tobytes() for a in x)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes() == data
    reads = {}
    for tag, mod in (("jax", jax_pipeline), ("port", port_pipeline)):
        out = _collect(mod, f"filesrc location={paths[tag]} "
                            f"blocksize={blocksize} ! tensor_sink name=out")
        reads[tag] = [np.asarray(b.tensors[0]).tobytes() for b in out]
    assert reads["port"] == reads["jax"]
    assert b"".join(reads["port"]) == data


def test_filesink_counts_its_fetch():
    """A torch tensor reaching filesink crosses to the host there, once."""
    from nnstreamer_tpu_torch import trace

    caps = "other/tensors,format=static,dimensions=4,types=float32"
    p = port_pipeline.parse_launch(f"appsrc name=src caps={caps} "
                                   "! filesink name=fs location=/dev/null")
    tracer = trace.attach(p)
    p.play()
    p["src"].push_buffer(PortBuffer(tensors=[torch.ones(4)]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(10)
    p.stop()
    assert tracer.crossings()["per_element"]["fs"]["d2h"] == 1
    assert tracer.crossings()["per_element"]["fs"]["d2h_bytes"] == 16


@pytest.mark.parametrize("model,custom,dtype", [
    ("add", "k:3", np.float32),
    ("add", "k:2", np.int32),
    ("passthrough", "", np.float32),
    ("scaler", "scale:0.5", np.float32),
    ("scaler", "", np.uint8),
])
def test_simple_models_match(model, custom, dtype):
    """models/simple.py through framework=jax in both packages (the port's
    backend on the CPU): same values, dtype and shape."""
    x = [(np.arange(12).reshape(3, 4) * (i + 1)).astype(dtype)
         for i in range(3)]
    dname = np.dtype(dtype).name
    caps = (f"other/tensors,format=static,dimensions=4:3,types={dname}")
    cust = f"custom={custom}" if custom else ""
    jax_cust = f"custom={custom},aot:0" if custom else "custom=aot:0"
    base = (f"appsrc name=src caps={caps} ! tensor_filter framework=jax "
            f"model={model} ")
    want = _collect(jax_pipeline, base + f"{jax_cust} ! tensor_sink name=out",
                    x)
    got = _collect(port_pipeline, base + f"{cust} accelerator=true:cpu "
                   "! tensor_sink name=out", x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        g, w = np.asarray(g.tensors[0]), np.asarray(w.tensors[0])
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_matmul_model_shape_and_value():
    from nnstreamer_tpu_torch.models import get_model

    b = get_model("matmul", {"dim": "16", "seed": "3"}, "cpu")
    x = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    out = b.apply_fn(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 16)
    w = b.module.w.float().numpy()
    want = (torch.from_numpy(x).bfloat16().float().numpy() @ w)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-2, atol=2e-2)
    from nnstreamer_tpu_torch.types import TensorsInfo

    info = b.infer_output(TensorsInfo.from_strings("16:2", "float32"))
    assert info.tensors[0].np_shape() == (2, 16)


@pytest.mark.parametrize("fw", ["passthrough", "custom-easy"])
def test_passthrough_and_custom_easy_filters(fw):
    from nnstreamer_tpu.filters.base import (
        register_custom_easy as jax_register,
        unregister_custom_easy as jax_unregister,
    )
    from nnstreamer_tpu.types import TensorsInfo as JaxInfo
    from nnstreamer_tpu_torch.filters.base import (
        register_custom_easy,
        unregister_custom_easy,
    )
    from nnstreamer_tpu_torch.types import TensorsInfo

    x = [np.full((2, 4), float(i), np.float32) for i in range(3)]
    caps = "other/tensors,format=static,dimensions=4:2,types=float32"
    model = "model=m" if fw == "passthrough" else "model=neg_easy"
    jax_register("neg_easy", lambda xs: [-np.asarray(xs[0])],
                 JaxInfo.from_strings("4:2", "float32"),
                 JaxInfo.from_strings("4:2", "float32"))
    register_custom_easy("neg_easy", lambda xs: [-np.asarray(xs[0])],
                         TensorsInfo.from_strings("4:2", "float32"),
                         TensorsInfo.from_strings("4:2", "float32"))
    try:
        line = (f"appsrc name=src caps={caps} ! tensor_filter "
                f"framework={fw} {model} ! tensor_sink name=out")
        want = _collect(jax_pipeline, line, x)
        got = _collect(port_pipeline, line, x)
    finally:
        jax_unregister("neg_easy")
        unregister_custom_easy("neg_easy")
    sign = 1 if fw == "passthrough" else -1
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g.tensors[0]),
                                      np.asarray(w.tensors[0]))
        np.testing.assert_array_equal(np.asarray(g.tensors[0]),
                                      sign * x[i])
