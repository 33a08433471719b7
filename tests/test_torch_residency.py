"""The planner's transform fusion and residency lane through both packages,
on the CPU.

Every case of the reference's tests/test_residency.py that passes there
runs through ``nnstreamer_tpu`` and ``nnstreamer_tpu_torch`` (the port's
filter with ``accelerator=true:cpu``, whose torch tensors count as the
backend's, ``buffer.is_backend_tensor``): the same launch line and frames
go in, and the two runs must give equal outputs, equal
``tracer.fusions()``, equal ``device_ok`` / ``device_resident`` on every
src pad, ``memory:HBM`` on the same caps, equal crossings per element
(counts and bytes) and the same number of device→host transfer calls —
and the port must also meet the reference's own asserts. Each package
uses its own ``HostSumDecoder`` / ``DeviceSumDecoder`` probe.

Held elsewhere: the two ``TestResidencyLint`` cases
(tests/test_torch_analysis.py, with ``tools/validate.py``) and the two
``TestChainFusedCrossingParity`` cases (tests/test_torch_chain.py, on the
port alone: chain fusion engages nowhere in the reference under this jax).

Beyond the reference's cases: fusion parity over every eligible grammar
(fused ``assert_array_equal`` to unfused, port equal to JAX; ``stand`` at
``rtol=1e-6``, as the reference holds it), the fused stage builder against
numpy, ``examples/launch_lines.txt``'s flagship device-resident line and
tee fan-out line, the preamble on input types the CUDA kernel does not
read (held to the kernel's own type check), and a small flagship line with
the reference NNStreamer preamble on the JAX weights: fused logits equal to
unfused logits, every frame's label equal to the JAX pipeline's, and the
logits within a tenth of their scale of the JAX pipeline's.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.caps  # noqa: E402
import nnstreamer_tpu.elements.decoder  # noqa: E402
import nnstreamer_tpu.elements.filter  # noqa: E402
import nnstreamer_tpu.filters.base  # noqa: E402
import nnstreamer_tpu.filters.jax_filter  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu.types  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.caps  # noqa: E402
import nnstreamer_tpu_torch.elements.decoder  # noqa: E402
import nnstreamer_tpu_torch.elements.filter  # noqa: E402
import nnstreamer_tpu_torch.filters.base  # noqa: E402
import nnstreamer_tpu_torch.filters.cuda_filter  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402
import nnstreamer_tpu_torch.types  # noqa: E402
from nnstreamer_tpu_torch.ops.fusion_stages import build_stage_fn  # noqa: E402
from test_torch_pipeline import weights  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPS_U8 = ("other/tensors,num-tensors=1,dimensions=4:2,types=uint8,"
           "framerate=0/1")
CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")


class Pkg:
    """One package's modules and probes under one set of names."""

    def __init__(self, name):
        mod = sys.modules
        self.name = name
        self.port = name == "nnstreamer_tpu_torch"
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.trace = mod[f"{name}.trace"]
        self.buffer = mod[f"{name}.buffer"]
        self.Buffer = self.buffer.Buffer
        self.Caps = mod[f"{name}.caps"].Caps
        self.types = mod[f"{name}.types"]
        self.decoder = mod[f"{name}.elements.decoder"]
        self.filter_mod = mod[f"{name}.elements.filter"]
        self.filters = mod[f"{name}.filters.base"]
        self.backend = (mod[f"{name}.filters.cuda_filter"].TorchCudaFilter
                        if self.port else
                        mod[f"{name}.filters.jax_filter"].JaxFilter)
        #: the filter properties that run the package's backend on the CPU
        self.cpu = "accelerator=true:cpu" if self.port else ""

    def filt(self, name="f", k=1, extra=""):
        return (f"tensor_filter name={name} framework=jax model=add "
                f"custom=k:{k},aot:0 {self.cpu} {extra}")

    def dev(self, a):
        """A tensor on the package's backend: a jax.Array, or a torch
        tensor (the port's backend on the CPU)."""
        a = np.asarray(a)
        return torch.from_numpy(a.copy()) if self.port else jnp.asarray(a)

    def on_backend(self, t) -> bool:
        if self.port:
            return self.buffer.is_backend_tensor(t)
        return self.buffer.is_device_array(t)

    def decoders(self):
        """(HostSumDecoder, DeviceSumDecoder) built on this package."""
        pkg = self

        class HostSumDecoder:
            """Host-only decoder: sums each frame (flexible out caps)."""

            def init(self, opts):
                pass

            def exit(self):
                pass

            def get_out_caps(self, config):
                t = pkg.types
                return pkg.Caps.from_config(t.TensorsConfig(
                    t.TensorsInfo(format=t.TensorFormat.FLEXIBLE),
                    config.rate_n, config.rate_d))

            def decode(self, buf, config):
                return buf.with_tensors(
                    [np.asarray([float(np.asarray(t).sum())], np.float32)
                     for t in buf.tensors])

        class DeviceSumDecoder(HostSumDecoder):
            DEVICE_CAPABLE = True

        return HostSumDecoder, DeviceSumDecoder


JAX, PORT = Pkg("nnstreamer_tpu"), Pkg("nnstreamer_tpu_torch")
PKGS = [JAX, PORT]


def count_transfers(pkg, monkeypatch):
    """Arrays moved per real device→host transfer call. JAX: every
    ``jax.device_get`` (the once-per-process warm-up fetch disarmed, as
    the reference does). Port: every ``materialize_tensors`` call that
    holds a torch tensor, wherever a module imported it."""
    sizes = []
    if not pkg.port:
        monkeypatch.setattr(pkg.filter_mod, "_d2h_warmed", True)
        orig = jax.device_get

        def counting(x):
            sizes.append(len(x) if isinstance(x, (list, tuple)) else 1)
            return orig(x)

        monkeypatch.setattr(jax, "device_get", counting)
        return sizes
    orig = pkg.buffer.materialize_tensors

    def counting_m(tensors):
        n = sum(isinstance(t, torch.Tensor) for t in tensors)
        if n:
            sizes.append(n)
        return orig(tensors)

    for name, m in list(sys.modules.items()):
        if (name.startswith("nnstreamer_tpu_torch")
                and getattr(m, "materialize_tensors", None) is orig):
            monkeypatch.setattr(m, "materialize_tensors", counting_m)
    return sizes


@pytest.fixture
def decoders():
    for pkg in PKGS:
        host, dev = pkg.decoders()
        pkg.decoder.register_custom_decoder("res_sum", host)
        pkg.decoder.register_custom_decoder("res_dev_sum", dev)
    yield
    for pkg in PKGS:
        pkg.decoder.unregister_custom_decoder("res_sum")
        pkg.decoder.unregister_custom_decoder("res_dev_sum")


def plan_of(p) -> dict:
    """Each src pad's residency verdict and whether its caps carry
    memory:HBM: {element.pad: (device_ok, device_resident, hbm)}. An
    element named by its package's counter (``queue7``) is keyed by its
    rank among those of its type in the line (``queue#0``): the counter
    runs over every pipeline a test process built, and the two packages'
    counters differ with the tests that ran before."""
    import re

    auto = {}
    for name, e in p.elements.items():
        m = re.fullmatch(re.escape(e.ELEMENT_NAME) + r"(\d+)", name)
        if m:
            auto.setdefault(e.ELEMENT_NAME, []).append((int(m.group(1)),
                                                         name))
    rename = {name: f"{kind}#{k}" for kind, names in auto.items()
              for k, (_, name) in enumerate(sorted(names))}
    out = {}
    for name, e in p.elements.items():
        for sp in e.src_pads:
            hbm = sp.caps is not None and sp.caps.is_device_resident()
            out[f"{rename.get(name, name)}.{sp.name}"] = (
                sp.device_ok, sp.device_resident, hbm)
    return out


def per_element(tracer) -> dict:
    return tracer.crossings()["per_element"]


def run_line(pkg, line, pushes, sinks=("out",), fusion=None,
             chain_off=False, wait=30):
    """Parse, trace, play, push [(src, array or Buffer)], EOS every pushed
    source; returns {sinks: [[host arrays] per buffer]} and the record
    the two packages are held equal on."""
    p = pkg.parse_launch(line)
    if fusion is not None:
        p.fusion = fusion
    if chain_off:
        p.chain_fusion = "off"
    tracer = pkg.trace.attach(p)
    p.play()
    for src, item in pushes:
        p[src].push_buffer(item if isinstance(item, pkg.Buffer)
                           else pkg.Buffer(tensors=[item]))
    for src in dict.fromkeys(s for s, _ in pushes):
        p[src].end_of_stream()
    assert p.bus.wait_eos(wait)
    assert p.bus.error is None, p.bus.error.data
    outs = {s: [[np.asarray(t) for t in b.tensors] for b in p[s].collected]
            for s in sinks}
    rec = {"fusions": tracer.fusions(), "plan": plan_of(p),
           "crossings": per_element(tracer)}
    p.stop()
    return outs, rec


def assert_same_outputs(got, want, exact=True):
    assert got.keys() == want.keys()
    for s in want:
        assert len(got[s]) == len(want[s]), s
        for gb, wb in zip(got[s], want[s]):
            assert len(gb) == len(wb)
            for g, w in zip(gb, wb):
                assert g.dtype == w.dtype and g.shape == w.shape
                if exact:
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def both(fn):
    """fn(pkg) for the JAX package, then for the port."""
    return fn(JAX), fn(PORT)


X_U8 = np.arange(8, dtype=np.uint8).reshape(2, 4)


# -- TestFlagshipCrossings ----------------------------------------------------

def test_one_h2d_one_d2h_per_batch(decoders, monkeypatch):
    """transform→filter→decoder: one H2D (the uint8 bytes) and one D2H
    (the float32 output), both at the filter, one transfer call, and the
    transform fused into the filter — in both packages alike."""
    def go(pkg):
        gets = count_transfers(pkg, monkeypatch)
        outs, rec = run_line(
            pkg, f"appsrc name=src caps={CAPS_U8} "
            "! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,mul:2 "
            f"! {pkg.filt()} ! queue ! tensor_decoder name=dec mode=res_sum "
            "! tensor_sink name=out", [("src", X_U8)])
        monkeypatch.undo()
        return outs, rec, len(gets)

    (jo, jr, jg), (po, pr, pg) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr and pg == jg
    assert po["out"][0][0].reshape(-1)[0] == float(
        (X_U8.astype(np.float32) * 2 + 1).sum())
    assert pr["crossings"] == {"f": {"h2d": 1, "d2h": 1, "h2d_bytes": 8,
                                     "d2h_bytes": 32}}
    assert pg == 1
    assert pr["fusions"] == {"tr": "fused-into:f"}
    assert pr["plan"]["f.src"][0] is False  # the filter is the boundary


def test_boundary_buffer_is_host_and_tagged():
    """A materialize=false sink accepts device: no boundary before it; the
    buffer arrives on the backend, its edge stamped memory:HBM."""
    def go(pkg):
        p = pkg.parse_launch(f"appsrc name=src caps={CAPS_F32} "
                             f"! {pkg.filt()} "
                             "! tensor_sink name=out materialize=false")
        pkg.trace.attach(p)
        p.play()
        p["src"].push_buffer(pkg.Buffer(tensors=[np.ones((2, 4), np.float32)]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        buf = p["out"].collected[0]
        rec = (all(pkg.on_backend(t) for t in buf.tensors), plan_of(p))
        p.stop()
        return rec

    want, got = both(go)
    assert got == want
    assert got[0] and got[1]["f.src"] == (True, True, True)


def test_filter_chain_single_crossing_each_way():
    """Two device-capable filters hand tensors through a queue untouched:
    one upload at the first, one fetch at the boundary of the second, and
    the device edge's caps carry memory:HBM."""
    def go(pkg):
        return run_line(
            pkg, f"appsrc name=src caps={CAPS_F32} ! {pkg.filt('f1')} "
            f"! queue ! {pkg.filt('f2', k=10)} ! tensor_sink name=out",
            [("src", np.ones((2, 4), np.float32))], chain_off=True)

    (jo, jr), (po, pr) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr
    np.testing.assert_array_equal(po["out"][0][0], np.ones((2, 4)) + 11)
    assert pr["crossings"] == {
        "f1": {"h2d": 1, "d2h": 0, "h2d_bytes": 32, "d2h_bytes": 0},
        "f2": {"h2d": 0, "d2h": 1, "h2d_bytes": 0, "d2h_bytes": 32}}
    assert pr["plan"]["f1.src"] == (True, True, True)
    assert pr["plan"]["f2.src"][0] is False


# -- TestFusionBitParity / TestUnfusedFallback --------------------------------

def grammar(pkg, mid, fusion, x=X_U8, filt=None):
    line = (f"appsrc name=src caps={CAPS_U8} ! "
            + mid.format(F=filt or pkg.filt()) + " ! tensor_sink name=out")
    outs, rec = run_line(pkg, line, [("src", x)], fusion=fusion)
    return outs["out"][0][0], rec


#: (test id, line between appsrc and sink, fusions when fused, exact).
#: exact: fused bit-equal to unfused; False for stand (rtol 1e-6, as the
#: reference holds it) and for the preamble's division by 127.5 in the JAX
#: package only — XLA on the CPU rewrites x / c as x * (1 / c), one float32
#: rounding off numpy; the port's stage divides (arith_chain) and stays
#: bit-equal to numpy in both of its paths
GRAMMARS = [
    ("arith_add_mul", "tensor_transform name=tr mode=arithmetic "
     "option=typecast:float32,add:10,mul:0.5 ! {F}", {"tr": "f"}, True),
    ("arith_div_add", "tensor_transform name=tr mode=arithmetic "
     "option=typecast:float32,div:4,add:-1 ! {F}", {"tr": "f"}, True),
    ("arith_mul_mul_add", "tensor_transform name=tr mode=arithmetic "
     "option=typecast:float32,mul:2,mul:3,add:0.25 ! {F}", {"tr": "f"}, True),
    ("preamble", "tensor_transform name=tr mode=arithmetic "
     "option=typecast:float32,add:-127.5,div:127.5 ! {F}", {"tr": "f"},
     "port"),
    ("typecast_float32", "tensor_transform name=tr mode=typecast "
     "option=float32 ! {F}", {"tr": "f"}, True),
    ("typecast_int32", "tensor_transform name=tr mode=typecast "
     "option=int32 ! {F}", {"tr": "f"}, True),
    ("typecast_float16", "tensor_transform name=tr mode=typecast "
     "option=float16 ! {F}", {"tr": "f"}, True),
    ("clamp_after_cast", "tensor_transform name=t1 mode=arithmetic "
     "option=typecast:float32,mul:0.1 ! tensor_transform name=t2 mode=clamp "
     "option=0.2:0.5 ! {F}", {"t1": "f", "t2": "f"}, True),
    ("cast_then_clamp", "tensor_transform name=t1 mode=typecast "
     "option=float32 ! tensor_transform name=t2 mode=clamp option=2:5 ! {F}",
     {"t1": "f", "t2": "f"}, True),
    ("post_chain", "{F} ! tensor_transform name=tp mode=arithmetic "
     "option=typecast:float32,mul:10", {"tp": "f"}, True),
    ("stand", "tensor_transform name=tr mode=stand ! {F}", {"tr": "f"},
     False),
    ("stand_dc_average", "tensor_transform name=tr mode=stand "
     "option=dc-average ! {F}", {"tr": "f"}, False),
]


def _same(got, ref, exact):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mid,fused_into,exact",
                         [g[1:] for g in GRAMMARS],
                         ids=[g[0] for g in GRAMMARS])
def test_fusion_parity(mid, fused_into, exact):
    """Every eligible grammar: fused equal to unfused, in each package,
    and the port's output equal to the JAX package's (see GRAMMARS for
    the two tolerances)."""
    (jf, jfr), (pf, pfr) = both(lambda pkg: grammar(pkg, mid, "auto"))
    (ju, jur), (pu, pur) = both(lambda pkg: grammar(pkg, mid, "off"))
    want = {k: f"fused-into:{v}" for k, v in fused_into.items()}
    assert pfr["fusions"] == jfr["fusions"] == want
    assert pur["fusions"] == jur["fusions"] == {}
    assert pfr == jfr and pur == jur
    port_exact = bool(exact)
    jax_exact = exact is True
    _same(pf, pu, port_exact)
    _same(pu, ju, port_exact)
    _same(jf, ju, jax_exact)
    _same(pf, jf, jax_exact)


@pytest.mark.parametrize("mid", [
    # per-channel: mutation-hazard grammar
    "tensor_transform name=tr mode=arithmetic "
    "option=typecast:float32,per-channel:true@0,add:1@0 ! {F}",
    # mid-chain cast
    "tensor_transform name=tr mode=arithmetic "
    "option=typecast:float32,add:1,typecast:uint8 ! {F}",
    # no leading cast
    "tensor_transform name=tr mode=arithmetic option=add:1,mul:2 ! {F}",
    # clamp with no statically known float32 input
    "tensor_transform name=tr mode=clamp option=2:5 ! {F}",
], ids=["per_channel", "mid_chain_cast", "no_leading_cast", "clamp_u8"])
def test_ineligible_stays_unfused(mid):
    """Nothing fuses; each package's output is the same fused or not. The
    last two grammars leave numpy's float64 on the host, which the JAX
    package's model (x64 off) returns as float32: there the port is held
    to the JAX values and to the bytes of its own output dtype."""
    (jf, jfr), (pf, pfr) = both(lambda pkg: grammar(pkg, mid, "auto"))
    (ju, _), (pu, _) = both(lambda pkg: grammar(pkg, mid, "off"))
    assert pfr["fusions"] == jfr["fusions"] == {}
    assert pfr["plan"] == jfr["plan"]
    for got, ref in ((pf, pu), (jf, ju)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(pf, jf)
    pc, jc = pfr["crossings"]["f"], jfr["crossings"]["f"]
    assert {k: pc[k] for k in ("h2d", "d2h", "h2d_bytes")} == \
        {k: jc[k] for k in ("h2d", "d2h", "h2d_bytes")}
    assert (pc["d2h_bytes"], jc["d2h_bytes"]) == (pf.nbytes, jf.nbytes)
    if pf.dtype == jf.dtype:
        assert pfr == jfr


def test_ineligible_prefix_eligible_suffix():
    """An ineligible stage cuts only itself and everything upstream: the
    eligible suffix adjacent to the filter still fuses."""
    mid = ("tensor_transform name=t1 mode=arithmetic "
           "option=per-channel:true@0,add:5@0 "
           "! tensor_transform name=t2 mode=arithmetic "
           "option=typecast:float32,mul:2 ! {F}")
    (jf, jfr), (pf, pfr) = both(lambda pkg: grammar(pkg, mid, "auto"))
    (_, _), (pu, _) = both(lambda pkg: grammar(pkg, mid, "off"))
    assert pfr["fusions"] == jfr["fusions"] == {"t2": "fused-into:f"}
    assert pfr == jfr
    np.testing.assert_array_equal(pf, pu)
    np.testing.assert_array_equal(pf, jf)


def test_element_opt_out():
    mid = "tensor_transform name=tr mode=typecast option=float32 fusion=off ! {F}"
    (_, jr), (_, pr) = both(lambda pkg: grammar(pkg, mid, "auto"))
    assert pr["fusions"] == jr["fusions"] == {}
    assert pr == jr


def test_fusion_env_switch(monkeypatch):
    """NNSTPU_FUSION=off, the JAX package's own switch, turns the pass
    off in both packages."""
    monkeypatch.setenv("NNSTPU_FUSION", "off")
    mid = "tensor_transform name=tr mode=typecast option=float32 ! {F}"
    (jo, jr), (po, pr) = both(lambda pkg: grammar(pkg, mid, "auto"))
    assert pr["fusions"] == jr["fusions"] == {}
    np.testing.assert_array_equal(po, jo)


def test_non_jax_backend_declines():
    """The base FilterFramework has no fuse hook: transforms stay live."""
    def go(pkg):
        info = pkg.types.TensorsInfo.from_strings("4:2", "float32")
        pkg.filters.register_custom_easy(
            "res_plus1", lambda xs: [np.asarray(xs[0]) + 1], info, info)
        try:
            return grammar(
                pkg, "tensor_transform name=tr mode=typecast option=float32 "
                "! {F}", "auto", filt="tensor_filter name=f "
                "framework=custom-easy model=res_plus1")
        finally:
            pkg.filters.unregister_custom_easy("res_plus1")

    (jo, jr), (po, pr) = both(go)
    assert pr["fusions"] == jr["fusions"] == {}
    assert pr == jr
    np.testing.assert_array_equal(po, X_U8.astype(np.float32) + 1)
    np.testing.assert_array_equal(po, jo)


# -- TestTransformCopyOnWrite -------------------------------------------------

def test_per_channel_does_not_mutate_teed_branch():
    caps = ("other/tensors,num-tensors=1,dimensions=2:3,types=float32,"
            "framerate=0/1")

    def go(pkg):
        x = np.zeros((3, 2), np.float32)
        outs, rec = run_line(
            pkg, f"appsrc name=src caps={caps} ! tee name=t "
            "t. ! queue ! tensor_transform mode=arithmetic "
            "option=per-channel:true@0,add:100@0 ! tensor_sink name=a "
            "t. ! queue ! tensor_sink name=b", [("src", x)], sinks=("a", "b"))
        np.testing.assert_array_equal(x, np.zeros((3, 2)))  # caller's copy
        return outs, rec

    (jo, jr), (po, pr) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr
    assert po["a"][0][0][0, 0] == 100.0
    np.testing.assert_array_equal(po["b"][0][0], np.zeros((3, 2)))


# -- TestDeviceStacking -------------------------------------------------------

def test_stack_tensors_stays_on_device():
    def go(pkg):
        out = pkg.buffer.stack_tensors(
            [pkg.dev(np.ones(4, np.float32) * i) for i in range(3)])
        return pkg.on_backend(out), np.asarray(out)

    (jd, jo), (pd, po) = both(go)
    assert jd and pd
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(
        po, np.stack([np.ones(4, np.float32) * i for i in range(3)]))


def test_stack_tensors_host_stays_host():
    for pkg in PKGS:
        out = pkg.buffer.stack_tensors(
            [np.ones((4,), np.float32) * i for i in range(3)])
        assert isinstance(out, np.ndarray)


def test_batch_stacking_no_leading_dim_keeps_device(monkeypatch):
    """batch-size with frames lacking a batch dim: the backend's frames
    stack where they are — no upload, one fetch per batch."""
    caps = ("other/tensors,num-tensors=1,dimensions=4,types=float32,"
            "framerate=0/1")

    def go(pkg):
        gets = count_transfers(pkg, monkeypatch)
        outs, rec = run_line(
            pkg, f"appsrc name=src caps={caps} "
            f"! {pkg.filt(extra='batch-size=2')} ! tensor_sink name=out",
            [("src", pkg.dev(np.full((4,), float(i), np.float32)))
             for i in range(4)])
        monkeypatch.undo()
        return outs, rec, len(gets)

    (jo, jr, jg), (po, pr, pg) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr and pg == jg == 2
    for i, b in enumerate(po["out"]):
        np.testing.assert_array_equal(b[0].reshape(-1), np.full(4, i + 1.0))
    assert pr["crossings"]["f"]["h2d"] == 0
    assert pr["crossings"]["f"]["d2h"] == 2


# -- TestDecoderSplitBatch ----------------------------------------------------

@pytest.mark.parametrize("mode,split,gets_want", [
    ("res_sum", 3, 1), ("res_dev_sum", 2, 0)],
    ids=["host_decoder_fetches_once", "device_decoder_slices_on_device"])
def test_decoder_split_batch(decoders, monkeypatch, mode, split, gets_want):
    caps = ("other/tensors,num-tensors=1,dimensions=4:{},types=float32,"
            "framerate=0/1").format(split)
    x = np.arange(4 * split, dtype=np.float32).reshape(split, 4)

    def go(pkg):
        gets = count_transfers(pkg, monkeypatch)
        outs, rec = run_line(
            pkg, f"appsrc name=src caps={caps} ! tensor_decoder name=dec "
            f"mode={mode} split-batch={split} ! tensor_sink name=out",
            [("src", pkg.dev(x))])
        monkeypatch.undo()
        return outs, rec, len(gets)

    (jo, jr, jg), (po, pr, pg) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr and pg == jg == gets_want
    assert [float(b[0].reshape(-1)[0]) for b in po["out"]] == \
        [float(r.sum()) for r in x]
    assert pr["crossings"].get("dec", {"d2h": 0})["d2h"] == gets_want


# -- TestCapsFeatureGrammar ---------------------------------------------------

def test_memory_hbm_roundtrip_and_intersection():
    for pkg in PKGS:
        c = pkg.Caps.from_string(
            "other/tensors(memory:HBM),num_tensors=1,types=float32")
        assert c.is_device_resident()
        assert pkg.Caps.from_string(str(c)) == c
        plain = pkg.Caps.from_string("other/tensors,num_tensors=1")
        inter = c.intersect(plain)
        assert not inter.is_empty()
        assert inter.is_device_resident()
    assert str(PORT.Caps.from_string(
        "other/tensors(memory:HBM),num_tensors=1,types=float32")) == str(
        JAX.Caps.from_string(
            "other/tensors(memory:HBM),num_tensors=1,types=float32"))


def test_disjoint_features_do_not_intersect():
    for pkg in PKGS:
        a = pkg.Caps.from_string("other/tensors(memory:HBM)")
        b = pkg.Caps.from_string("other/tensors(memory:SystemMemory)")
        assert a.intersect(b).is_empty()
        assert pkg.Caps.from_string("other/tensors").with_feature(
            "memory:HBM").has_feature("memory:HBM")


# -- TestSharedBackendFusion / TestTransformBetweenFilters --------------------

def test_shared_key_filters_never_fuse():
    """Stages live on the framework object, which a shared key hands to
    every sharer: shared backends never fuse, and both streams stay
    bit-correct."""
    y = np.ones((2, 4), np.float32)

    def go(pkg):
        p = pkg.parse_launch(
            f"appsrc name=s1 caps={CAPS_U8} "
            "! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,mul:2 "
            f"! {pkg.filt('f1', extra='shared-tensor-filter-key=res_shk')} "
            f"! tensor_sink name=o1 appsrc name=s2 caps={CAPS_F32} "
            f"! {pkg.filt('f2', extra='shared-tensor-filter-key=res_shk')} "
            "! tensor_sink name=o2")
        tracer = pkg.trace.attach(p)
        p.play()
        assert p["f1"].fw is p["f2"].fw  # one backend, two filters
        p["s1"].push_buffer(pkg.Buffer(tensors=[X_U8]))
        p["s2"].push_buffer(pkg.Buffer(tensors=[y]))
        p["s1"].end_of_stream()
        p["s2"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        outs = [np.asarray(p[o].collected[0][0]) for o in ("o1", "o2")]
        rec = (tracer.fusions(), per_element(tracer))
        p.stop()
        return outs, rec

    (jo, jr), (po, pr) = both(go)
    assert pr == jr and pr[0] == {}
    np.testing.assert_array_equal(po[0], X_U8.astype(np.float32) * 2 + 1)
    np.testing.assert_array_equal(po[1], y + 1)
    for g, w in zip(po, jo):
        np.testing.assert_array_equal(g, w)


def test_mid_transform_fuses_into_exactly_one_filter():
    """A transform between two filters is reachable from both walks: its
    math is applied exactly once."""
    x = np.full((2, 4), 8.0, np.float32)

    def go(pkg):
        return run_line(
            pkg, f"appsrc name=src caps={CAPS_F32} ! {pkg.filt('f1')} "
            "! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,mul:0.5 "
            f"! {pkg.filt('f2', k=10)} ! tensor_sink name=out",
            [("src", x)], chain_off=True)

    (jo, jr), (po, pr) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr
    assert set(pr["fusions"]) == {"tr"}
    np.testing.assert_array_equal(po["out"][0][0], (x + 1) * 0.5 + 10)


def test_malformed_arith_operand_falls_back_unfused():
    def go(pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_U8} ! tensor_transform name=tr "
            "mode=arithmetic option=typecast:float32,add:1e "
            f"! {pkg.filt()} ! tensor_sink name=out")
        tracer = pkg.trace.attach(p)
        p.play()  # must not raise
        fus = tracer.fusions()
        p.stop()
        return fus

    assert both(go) == ({}, {})


def test_key_added_after_fused_epoch_tears_stages_down():
    """A shared key added after a fused run: the replan tears the prior
    epoch's stages down and the transform runs live, its math once."""
    def go(pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_U8} "
            "! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,mul:2 "
            f"! {pkg.filt()} ! tensor_sink name=out")
        fus = []
        for epoch in range(2):
            if epoch:
                p["f"].properties["shared_tensor_filter_key"] = \
                    f"stale_epoch_key_{pkg.name}"
            tracer = pkg.trace.attach(p, replace=True)
            p.play()
            p["src"].push_buffer(pkg.Buffer(tensors=[X_U8]))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(30)
            assert p.bus.error is None, p.bus.error.data
            fus.append(tracer.fusions())
            out = np.asarray(p["out"].collected[-1][0])
            p.stop()
        return fus, out

    (jf, jo), (pf, po) = both(go)
    assert pf == jf == [{"tr": "fused-into:f"}, {}]
    np.testing.assert_array_equal(po, X_U8.astype(np.float32) * 2 + 1)
    np.testing.assert_array_equal(po, jo)


# -- TestSyncFilterResidency --------------------------------------------------

def test_sync_filter_does_not_advertise_device_lane():
    def go(pkg):
        outs, rec = run_line(
            pkg, f"appsrc name=src caps={CAPS_F32} "
            f"! {pkg.filt('f1', extra='sync=1')} ! {pkg.filt('f2', k=10)} "
            "! tensor_sink name=out", [("src", np.ones((2, 4), np.float32))])
        return outs, rec

    (jo, jr), (po, pr) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr
    assert pr["plan"]["f1.src"][1:] == (False, False)
    np.testing.assert_array_equal(po["out"][0][0], np.ones((2, 4)) + 11)


# -- TestBoundaryOutputCombination / TestSyncBatchedSingleFetch ---------------

C41 = ("other/tensors,num-tensors=1,dimensions=4:1,types=float32,"
       "framerate=0/1")


@pytest.mark.parametrize("caps,props,frame,sink,d2h", [
    (CAPS_F32, "output-combination=i0,o0 fetch-window=2",
     lambda i: np.full((2, 4), float(i), np.float32), "", 1),
    (C41, "batch-size=2 output-combination=i0,o0",
     lambda i: np.full((1, 4), float(i), np.float32), "", 1),
    (CAPS_F32, "output-combination=i0,o0",
     lambda i: np.arange(8, dtype=np.float32).reshape(2, 4) + i, "", 2),
    (C41, "sync=1 batch-size=2",
     lambda i: np.full((1, 4), float(i), np.float32), "materialize=false", 1),
], ids=["window_prefetches_passthrough_inputs",
        "batch_rows_prefetch_passthrough_inputs",
        "passthrough_input_materializes_at_boundary",
        "sync_batch_materializes_once_on_device_edge"])
def test_boundary_materialization(monkeypatch, caps, props, frame, sink, d2h):
    """Each boundary site fetches outputs and the referenced 'iN' inputs
    in ONE transfer per window / batch / buffer; emitted buffers are
    host-resident."""
    def go(pkg):
        gets = count_transfers(pkg, monkeypatch)
        as_dev = "sync" not in props
        pushes = [("src", pkg.dev(frame(i)) if as_dev else frame(i))
                  for i in range(2)]
        p = pkg.parse_launch(f"appsrc name=src caps={caps} "
                             f"! {pkg.filt(extra=props)} "
                             f"! tensor_sink name=out {sink}")
        tracer = pkg.trace.attach(p)
        p.play()
        for src, x in pushes:
            p[src].push_buffer(pkg.Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        bufs = list(p["out"].collected)
        rec = ([b.meta.get("residency") for b in bufs],
               [[np.asarray(t) for t in b.tensors] for b in bufs],
               per_element(tracer), plan_of(p))
        p.stop()
        monkeypatch.undo()
        return rec, len(gets)

    (jr, jg), (pr, pg) = both(go)
    assert pr[0] == jr[0] == ["host", "host"]
    assert_same_outputs({"out": pr[1]}, {"out": jr[1]})
    assert pr[2:] == jr[2:]
    assert pg == jg == d2h
    assert pr[2]["f"]["d2h"] == pg


def test_merge_fetches_once_pipelined(monkeypatch):
    caps_a = ("other/tensors,num-tensors=1,dimensions=2,types=float32,"
              "framerate=0/1")
    caps_b = ("other/tensors,num-tensors=1,dimensions=3,types=float32,"
              "framerate=0/1")

    def go(pkg):
        gets = count_transfers(pkg, monkeypatch)
        outs, rec = run_line(
            pkg, "tensor_merge name=m option=0 ! tensor_sink name=out "
            f"appsrc name=a caps={caps_a} ! m. "
            f"appsrc name=b caps={caps_b} ! m.",
            [("a", pkg.dev(np.asarray([1, 2], np.float32))),
             ("b", pkg.dev(np.asarray([3, 4, 5], np.float32)))])
        monkeypatch.undo()
        return outs, rec, len(gets)

    (jo, jr, jg), (po, pr, pg) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr and pg == jg == 1
    np.testing.assert_array_equal(np.squeeze(po["out"][0][0]),
                                  np.array([1, 2, 3, 4, 5], np.float32))
    assert pr["crossings"]["m"]["d2h"] == 1


def test_host_backend_pipelines_stranded_prefetched_inputs(monkeypatch):
    """A host-only backend handed the backend's tensors in a prefetch
    handle fetches them in ONE transfer, billed."""
    def go(pkg):
        gets = count_transfers(pkg, monkeypatch)
        info = pkg.types.TensorsInfo.from_strings("4:2.4:2", "float32.float32")
        out_info = pkg.types.TensorsInfo.from_strings("4:2", "float32")
        pkg.filters.register_custom_easy(
            "res_host_add2",
            lambda xs: [np.asarray(xs[0]) + np.asarray(xs[1])],
            info, out_info)
        try:
            caps = ("other/tensors,num-tensors=2,dimensions=4:2.4:2,"
                    "types=float32.float32,framerate=0/1")
            p = pkg.parse_launch(
                f"appsrc name=src caps={caps} "
                "! tensor_filter name=f framework=custom-easy "
                "model=res_host_add2 ! tensor_sink name=out")
            tracer = pkg.trace.attach(p)
            p.play()
            f = p["f"]
            assert not f._fw_device_capable()
            outs = f._invoke(pkg.filters.PrefetchedInputs([
                pkg.dev(np.full((2, 4), 1.0, np.float32)),
                pkg.dev(np.full((2, 4), 2.0, np.float32))]))
            p.stop()
            rec = (np.asarray(outs[0]), per_element(tracer), len(gets))
        finally:
            pkg.filters.unregister_custom_easy("res_host_add2")
            monkeypatch.undo()
        return rec

    (jo, jc, jg), (po, pc, pg) = both(go)
    np.testing.assert_array_equal(po, np.full((2, 4), 3.0, np.float32))
    np.testing.assert_array_equal(po, jo)
    assert pc == jc and pg == jg == 1
    assert pc["f"]["d2h"] == 1


def test_setup_drops_stale_specs_instead_of_installing(monkeypatch):
    """A shared key arriving between epochs: the reopen drops the prior
    epoch's specs, and no non-empty install ever touches the now shared
    backend."""
    def go(pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_U8} "
            "! tensor_transform name=tr mode=typecast option=float32 "
            f"! {pkg.filt()} ! tensor_sink name=out")
        tracer = pkg.trace.attach(p)
        p.play()
        p["src"].push_buffer(pkg.Buffer(tensors=[X_U8]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        first = tracer.fusions()
        p.stop()
        p["f"].properties["shared_tensor_filter_key"] = \
            f"setup_stale_key_{pkg.name}"
        installs = []
        orig = pkg.backend.fuse_stages

        def spy(self, pre, post):
            if pre or post:
                installs.append((list(pre), list(post)))
            return orig(self, pre, post)

        monkeypatch.setattr(pkg.backend, "fuse_stages", spy)
        tracer = pkg.trace.attach(p, replace=True)
        p.play()
        assert installs == []
        p["src"].push_buffer(pkg.Buffer(tensors=[X_U8]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        out = np.asarray(p["out"].collected[-1][0])
        p.stop()
        monkeypatch.undo()
        return first, installs, tracer.fusions(), out

    (jf, ji, js, jo), (pf, pi, ps, po) = both(go)
    assert pf == jf == {"tr": "fused-into:f"}
    assert pi == ji == [] and ps == js == {}
    np.testing.assert_array_equal(po, X_U8.astype(np.float32) + 1)
    np.testing.assert_array_equal(po, jo)


# -- TestOcombFetchesOnlyReferencedInputs / TestInvokeDynamicWindow -----------

@pytest.mark.parametrize("props,sizes", [
    ("fetch-window=2", [6]), ("batch-size=2", [4])],
    ids=["window_skips_unreferenced_inputs",
         "batch_skips_unreferenced_inputs"])
def test_ocomb_fetches_only_referenced_inputs(monkeypatch, props, sizes):
    caps2 = ("other/tensors,num-tensors=2,dimensions=4:2.4:2,"
             "types=float32.float32,framerate=0/1")

    def go(pkg):
        got = count_transfers(pkg, monkeypatch)
        frames = [pkg.Buffer(tensors=[
            pkg.dev(np.full((2, 4), float(10 * i + j), np.float32))
            for j in range(2)]) for i in range(2)]
        outs, rec = run_line(
            pkg, f"appsrc name=src caps={caps2} ! tensor_filter name=f "
            f"framework=jax model=passthrough {pkg.cpu} {props} "
            "output-combination=i0,o0 ! tensor_sink name=out",
            [("src", b) for b in frames])
        monkeypatch.undo()
        return outs, rec, list(got)

    (jo, jr, jg), (po, pr, pg) = both(go)
    assert pr == jr and pg == jg == sizes
    for i, b in enumerate(po["out"]):
        for t in b:
            np.testing.assert_array_equal(
                t.reshape(2, 4), np.full((2, 4), float(10 * i)))
    for gb, wb in zip(po["out"], jo["out"]):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g, w)


def test_window_amortizes_dynamic_fetches(monkeypatch):
    """invoke-dynamic outputs always land on the host: the fetch window
    engages even on a device-accepting edge."""
    def go(pkg):
        gets = count_transfers(pkg, monkeypatch)
        outs, rec = run_line(
            pkg, f"appsrc name=src caps={CAPS_F32} "
            f"! {pkg.filt(extra='invoke-dynamic=1 fetch-window=2')} "
            "! tensor_sink name=out materialize=false",
            [("src", np.full((2, 4), float(i), np.float32)) for i in range(2)])
        monkeypatch.undo()
        return outs, rec, len(gets)

    (jo, jr, jg), (po, pr, pg) = both(go)
    assert_same_outputs(po, jo)
    assert pr == jr and pg == jg == 1
    assert pr["crossings"]["f"]["d2h"] == 1


# -- TestFusedReloadAndWindow -------------------------------------------------

def test_fetch_window_skipped_on_device_edge():
    def go(pkg):
        p = pkg.parse_launch(f"appsrc name=src caps={CAPS_F32} "
                             f"! {pkg.filt(extra='fetch-window=4')} "
                             "! tensor_sink name=out materialize=false")
        p.play()
        p["src"].push_buffer(pkg.Buffer(tensors=[np.ones((2, 4), np.float32)]))
        got = p["out"].pull(timeout=5.0)  # the window would hold 4
        p["src"].end_of_stream()
        p.bus.wait_eos(10)
        p.stop()
        return got is not None and all(pkg.on_backend(t) for t in got.tensors)

    assert both(go) == (True, True)


def test_replay_replans():
    """stop() → play() replans: fusion decisions are recomputed, and
    results stay correct across the restart."""
    def go(pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_U8} "
            "! tensor_transform name=tr mode=typecast option=float32 "
            f"! {pkg.filt()} ! tensor_sink name=out")
        fus = []
        for _ in range(2):
            tracer = pkg.trace.attach(p)
            p.play()
            p["src"].push_buffer(pkg.Buffer(tensors=[X_U8]))
            p["src"].end_of_stream()
            assert p.bus.wait_eos(30)
            assert p.bus.error is None, p.bus.error.data
            np.testing.assert_array_equal(
                np.asarray(p["out"].collected[-1][0]),
                X_U8.astype(np.float32) + 1)
            fus.append(tracer.fusions())
            p.stop()
        return fus

    want, got = both(go)
    assert got == want == [{"tr": "fused-into:f"}] * 2


def test_reload_model_reinstalls_stages():
    """A reload-model event reopens the backend: the stages go back on,
    so the fused-out transform's math still runs once."""
    def go(pkg):
        ev = pkg.buffer.Event("reload-model", {"model": "add"})
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_U8} "
            "! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,mul:3 "
            f"! {pkg.filt()} ! tensor_sink name=out")
        tracer = pkg.trace.attach(p)
        p.play()
        p["src"].push_buffer(pkg.Buffer(tensors=[X_U8]))
        assert p["out"].pull(timeout=10.0) is not None
        p["f"].sink_pad.receive_event(ev)
        p["src"].push_buffer(pkg.Buffer(tensors=[X_U8]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        outs = [np.asarray(b[0]) for b in p["out"].collected]
        fus = tracer.fusions()
        p.stop()
        return outs, fus

    (jo, jf), (po, pf) = both(go)
    assert pf == jf == {"tr": "fused-into:f"}
    assert len(po) == len(jo) == 2
    for g, w in zip(po, jo):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, X_U8.astype(np.float32) * 3 + 1)


# -- the fused stage builder against numpy ------------------------------------

def _kernel_gate(monkeypatch):
    """Hold every arith_chain call of a stage to the input types the CUDA
    kernel reads (on the CPU the plain version takes any type, so the
    gate is the kernel's own check, run here); returns the types seen."""
    import nnstreamer_tpu_torch.ops.transform_ops as tops

    seen = []
    orig = tops.arith_chain

    def gated(x, *a, **kw):
        seen.append(x.dtype)
        assert x.dtype in tops.IN_DTYPES, f"the kernel does not read {x.dtype}"
        return orig(x, *a, **kw)

    monkeypatch.setattr(tops, "arith_chain", gated)
    return seen


@pytest.mark.parametrize("specs,ref", [
    ([("arith", (("add", -127.5), ("div", 127.5)))],
     lambda a: (a.astype(np.float32) + np.float32(-127.5)) / np.float32(127.5)),
    ([("arith", (("mul", 0.1),)), ("clamp", 0.2, 0.5)],
     lambda a: np.clip(a.astype(np.float32) * np.float32(0.1), 0.2, 0.5)),
    ([("typecast", "float32"), ("clamp", 2.0, 5.0)],
     lambda a: np.clip(a.astype(np.float32), 2.0, 5.0)),
    ([("typecast", "int32")], lambda a: a.astype(np.int32)),
    ([("typecast", "float16")], lambda a: a.astype(np.float16)),
    # the float16 tensor reaches the arith stage, which converts it for
    # the kernel
    ([("typecast", "float16"), ("arith", (("mul", 0.1),))],
     lambda a: a.astype(np.float16).astype(np.float32) * np.float32(0.1)),
], ids=["preamble", "arith_then_clamp", "cast_then_clamp", "int32", "float16",
        "float16_then_arith"])
def test_stage_fn_matches_numpy(specs, ref, monkeypatch):
    """Bit-equal to the numpy element on all 256 uint8 values, every
    arith_chain call held to the kernel's input types."""
    _kernel_gate(monkeypatch)
    a = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = build_stage_fn(specs)(torch.from_numpy(a.copy())).numpy()
    want = ref(a)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _wide(dtype):
    """A (2, 4) array of a type the arith kernel does not read, with
    values whose float32 conversion rounds."""
    rng = np.random.default_rng(11)
    if dtype in ("float64", "float16"):
        return (rng.normal(0, 300, (2, 4)) + 1 / 3).astype(dtype)
    if dtype == "bool":
        return rng.integers(0, 2, (2, 4)).astype(bool)
    return rng.integers(2 ** 24, 2 ** 31, (2, 4)).astype(dtype)


WIDE_TYPES = ["float64", "float16", "int64", "uint32", "bool"]


@pytest.mark.parametrize("dtype", WIDE_TYPES)
def test_stage_fn_converts_what_the_kernel_cannot_read(dtype, monkeypatch):
    """The preamble stage on an input type the kernel does not read: the
    kernel gets float32, and the result is bit-equal to numpy's
    astype(float32) then the chain."""
    seen = _kernel_gate(monkeypatch)
    a = _wide(dtype)
    fn = build_stage_fn([("arith", (("add", -127.5), ("div", 127.5)))])
    got = fn(torch.from_numpy(a.copy())).numpy()
    want = (a.astype(np.float32) + np.float32(-127.5)) / np.float32(127.5)
    assert seen == [torch.float32]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", WIDE_TYPES[:-1])
def test_fused_preamble_on_wide_input(dtype, monkeypatch):
    """appsrc frames of a type the kernel does not read, the preamble,
    then a filter: the preamble fuses, the kernel gets float32, and the
    output is bit-equal to the unfused line's and within float32 rounding
    of the JAX package's (whose stage rewrites the division, see
    GRAMMARS). The upload carries the input's own bytes."""
    seen = _kernel_gate(monkeypatch)
    x = _wide(dtype)
    caps = CAPS_F32.replace("float32", dtype)

    def go(pkg, fusion):
        line = (f"appsrc name=src caps={caps} ! tensor_transform name=tr "
                "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5"
                f" ! {pkg.filt()} ! tensor_sink name=out")
        outs, rec = run_line(pkg, line, [("src", x)], fusion=fusion)
        return outs["out"][0][0], rec

    pf, pfr = go(PORT, "auto")
    assert seen == [torch.float32]
    pu, pur = go(PORT, "off")
    jf, jfr = go(JAX, "auto")
    assert pfr["fusions"] == jfr["fusions"] == {"tr": "fused-into:f"}
    assert pur["fusions"] == {}
    want = (x.astype(np.float32) + np.float32(-127.5)) / np.float32(127.5) + 1
    _same(pf, pu, True)
    _same(pf, want, True)
    _same(pf, jf, False)
    assert pfr["crossings"]["f"]["h2d_bytes"] == x.nbytes


def test_stage_fn_clamp_keeps_nan():
    x = np.array([np.nan, -1.0, 0.3, 9.0], np.float32)
    got = build_stage_fn([("clamp", 0.0, 1.0)])(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.clip(x, 0.0, 1.0)))


def test_stage_fn_stand_is_population_std():
    x = np.arange(12, dtype=np.float32).reshape(3, 4) * 1.5
    got = build_stage_fn([("stand", "default")])(torch.from_numpy(x)).numpy()
    y = jnp.asarray(x)
    want = np.asarray((y - y.mean()) / jnp.maximum(y.std(), 1e-10))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_empty_specs_build_nothing():
    assert build_stage_fn([]) is None


# -- examples/launch_lines.txt ------------------------------------------------

def _example_line(comment_prefix):
    with open(os.path.join(ROOT, "examples", "launch_lines.txt"),
              encoding="utf-8") as f:
        text = f.read().splitlines()
    i = next(k for k, ln in enumerate(text) if ln.startswith(comment_prefix))
    return next(ln for ln in text[i + 1:] if not ln.startswith("#"))


def test_flagship_example_line():
    """examples/launch_lines.txt's device-resident flagship line as
    written (the port's filter with accelerator=true:cpu): one upload of
    the uint8 bytes and one fetch, at the filter."""
    line = _example_line("# flagship device-resident chain")

    def go(pkg):
        text = line.replace("tensor_sink", "tensor_sink name=out")
        if pkg.port:
            text = text.replace("aot:0", f"aot:0 {pkg.cpu}")
        p = pkg.parse_launch(text)
        src = next(e for e in p.elements.values() if e.ELEMENT_NAME == "appsrc")
        tracer = pkg.trace.attach(p)
        p.play()
        for i in range(3):
            src.push_buffer(pkg.Buffer(tensors=[X_U8 + i]))
        src.end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data
        outs = [np.asarray(b[0]) for b in p["out"].collected]
        rec = (tracer.fusions(), tracer.crossings())
        p.stop()
        return outs, rec

    (jo, jr), (po, pr) = both(go)
    assert len(po) == 3
    for g, w in zip(po, jo):
        np.testing.assert_array_equal(g, w)
    assert list(pr[0].values()) == list(jr[0].values())
    assert (pr[1]["h2d"], pr[1]["d2h"], pr[1]["h2d_bytes"],
            pr[1]["d2h_bytes"]) == (3, 3, 24, 96)
    assert list(pr[1]["per_element"].values()) == \
        list(jr[1]["per_element"].values())


def test_tee_fan_out_example_line():
    """The tee fan-out line: one boundary at the filter serves both
    branches — 3 d2h and 96 B for 3 buffers, all at the filter."""
    line = _example_line("# branch parallelism: tee fan-out")

    def go(pkg):
        text = line.replace("aot:0", f"aot:0 {pkg.cpu}") if pkg.port \
            else line
        outs, rec = run_line(
            pkg, text, [("src", np.full((2, 4), float(i), np.float32))
                        for i in range(3)], sinks=("a", "b"))
        return outs, rec

    (jo, jr), (po, pr) = both(go)
    for s in ("a", "b"):  # the queues race: compare as sets
        key = lambda o: sorted(float(b[0].sum()) for b in o[s])  # noqa: E731
        assert key(po) == key(jo)
    # the filter's generated name differs between packages: compare the
    # crossing records by value
    assert list(pr["crossings"].values()) == list(jr["crossings"].values())
    assert list(pr["crossings"].values()) == [
        {"h2d": 3, "d2h": 3, "h2d_bytes": 96, "d2h_bytes": 96}]


# -- the flagship preamble on the JAX weights ---------------------------------

PREAMBLE = "typecast:float32,add:-127.5,div:127.5"
MBV2 = "size:64,width:0.35,classes:16,fused:pallas"


def test_preamble_flagship_line(weights):
    """A small MobileNet-v2 line (width 0.35, 64 px, 16 classes) with the
    reference NNStreamer preamble, on the perturbed weights and frames of
    tests/test_torch_pipeline.py (msgpack for the JAX package, npz for
    the port), whose labels have margins: the fused line's logits equal
    the unfused line's (the model input is bit-equal), every frame's
    label equals the JAX pipeline's (two classes over the eight frames),
    and the logits are within a tenth of their own scale of the JAX
    pipeline's: the bf16 fused blocks of the two packages differ by up to
    5.9 on logits up to 106 here, as test_torch_pipeline._perturb finds on
    the uint8 line. The fused line uploads the uint8 frames, the unfused
    one float32."""
    msgpack, npz, _, _, frames = weights
    x = np.stack(frames)

    def go(pkg, fusion):
        custom = (f"params:{npz},{MBV2}" if pkg.port
                  else f"params:{msgpack},{MBV2}")
        line = ("appsrc name=src caps=other/tensors,num-tensors=1,"
                "dimensions=3:64:64:8,types=uint8,framerate=0/1 "
                f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
                "! tensor_filter name=f framework=jax model=mobilenet_v2 "
                f"custom={custom} {pkg.cpu} ! tensor_sink name=out")
        outs, rec = run_line(pkg, line, [("src", x)], fusion=fusion,
                             wait=300)
        return outs["out"][0][0], rec

    pf, pfr = go(PORT, "auto")
    pu, pur = go(PORT, "off")
    jf, jfr = go(JAX, "auto")
    assert pfr["fusions"] == jfr["fusions"] == {"tr": "fused-into:f"}
    assert pur["fusions"] == {}
    assert pf.shape == jf.shape == (8, 16)
    np.testing.assert_array_equal(pf, pu)
    labels = jf.argmax(-1)
    np.testing.assert_array_equal(pf.argmax(-1), labels)
    assert len(set(labels.tolist())) > 1  # the labels have teeth
    scale = float(np.abs(jf).max())
    assert scale > 10.0
    np.testing.assert_allclose(pf, jf, rtol=0, atol=0.1 * scale)
    assert pfr["crossings"]["f"]["h2d_bytes"] == x.nbytes
    assert pur["crossings"]["f"]["h2d_bytes"] == x.nbytes * 4
    assert pfr["crossings"] == jfr["crossings"]
