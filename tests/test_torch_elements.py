"""The port's elements on the flagship path, on the CPU: the transform
lines through both packages (bit-equal; clamp at atol 1e-6 as in
tests/test_ops.py::TestTransformDeviceAccel), tensor_filter's refusal of
properties this package does not implement, the backend's device rule and
the per-package registries.
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


@pytest.mark.parametrize("line,x,exact", [
    ("appsrc name=src caps=other/tensors,format=static,dimensions=128:8,"
     "types=uint8 ! tensor_transform mode=arithmetic "
     "option=typecast:float32,add:-127.5,div:127.5 acceleration=device "
     "! tensor_sink name=out",
     np.random.default_rng(6).integers(0, 256, (8, 128), np.uint8), True),
    ("appsrc name=src caps=other/tensors,format=static,dimensions=1024,"
     "types=float32 ! tensor_transform mode=clamp option=-1:1 "
     "acceleration=device ! tensor_sink name=out",
     np.linspace(-2, 2, 1024, dtype=np.float32), False),
])
def test_transform_line_matches(line, x, exact):
    outs = []
    for mod, buf in ((jax_pipeline, JaxBuffer), (port_pipeline, PortBuffer)):
        p = mod.parse_launch(line)
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
        "acceleration=device ! tensor_sink name=out")
    p.play()
    p["src"].push_buffer(PortBuffer(tensors=[x]))
    got = p["out"].pull(timeout=30.0)
    p.stop()
    np.testing.assert_array_equal(np.asarray(got.tensors[0]), x + 2.0)


@pytest.mark.parametrize("prop", [
    "batch-size=4", "feed-depth=2", "fetch-window=auto", "shard=dp",
    "invoke-timeout-ms=10", "fallback-framework=auto", "loop-window=8",
    "invoke-dynamic=true", "rollout-model=other",
])
def test_filter_rejects_unported_properties(prop):
    with pytest.raises(ElementError, match="not supported"):
        port_pipeline.parse_launch(
            "appsrc ! tensor_filter framework=jax model=mobilenet_v2 "
            f"{prop} ! tensor_sink")


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


def _agg_line(shape, props):
    dims = ":".join(str(d) for d in reversed(shape))
    return (f"appsrc name=src caps=other/tensors,format=static,"
            f"dimensions={dims},types=float32,framerate=30/1 "
            f"! tensor_aggregator {props} ! tensor_sink name=out")


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
    torch.cat and come out as torch tensors."""
    shape, props, n = AGG_CASES[case]
    rng = np.random.default_rng(8)
    chunks = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    line = _agg_line(shape, props)
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
