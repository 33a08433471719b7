"""The port's measurement tools (``nnstreamer_tpu_torch/tools/mfu_table.py``,
``mbv2_breakdown.py``, ``multistream_probe.py``) on the CPU.

What a CPU run can hold: the breakdown's variants against the JAX tool's
``_build_variant`` on the same weights (flax variables filled from numpy
and carried across with ``mbv2_breakdown.from_jax_variables``), at 64 px,
batch 2 and the JAX variant's only width, 1.0, in bf16 at the JAX package's bf16
tolerance (atol 0.15, rtol 0.05; tests/test_fused_block.py::
test_model_zoo_fused_custom); the FLOP counts, exactly against a hand
count of 2·MACs from the layer shapes (SAME padding's zero taps counted,
as FlopCounterMode counts them) and within [0.75, 1.0] of XLA's cost
analysis of the JAX variant (XLA also counts elementwise work: 0.82-0.89
on MobileNet-v2); a row's fields and flags on an injected timer; the
host leg of the multistream probe through the port's pipeline; and that
each tool's timing path raises without a card and writes nothing at the
repository's root. Times come only from the card.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.models.mobilenet_v2 import (  # noqa: E402
    MobileNetV2 as JaxMobileNetV2,
    _make_divisible,
)
from nnstreamer_tpu_torch.tools import mbv2_breakdown as pb  # noqa: E402
from nnstreamer_tpu_torch.tools import mfu_table as pm  # noqa: E402
from nnstreamer_tpu_torch.tools import multistream_probe as ms  # noqa: E402

SIZE, BATCH = 64, 2
ATOL, RTOL = 0.15, 0.05

#: the variants held against JAX: between them every option's values
CASES = {
    "stem+2stages-dense-headless": dict(keep_stages=2, head=False,
                                        depthwise="dense"),
    "full-skip-s2d": dict(depthwise="skip", s2d_stem=True),
    "full": dict(),
}


def _hand_flops(size, batch, keep_stages=None, head=True, depthwise="dw",
                s2d_stem=False, width=1.0, classes=1001):
    """2·MACs of every convolution and the Dense layer, from the layer
    shapes: ``out_h·out_w·(cin/groups)·kh·kw·cout`` a conv (SAME pads
    counted), ``in·out`` the Dense layer, times the batch."""
    cfg = JaxMobileNetV2.CFG
    ch = _make_divisible(32 * width)
    if s2d_stem:
        h = size // 2
        macs = h * h * 12 * 4 * ch
    else:
        h = math.ceil(size / 2)
        macs = h * h * 3 * 9 * ch
    for expand, c, n, s in cfg[:len(cfg) if keep_stages is None
                               else keep_stages]:
        out = _make_divisible(c * width)
        for i in range(n):
            hidden, stride = ch * expand, s if i == 0 else 1
            if expand != 1:
                macs += h * h * ch * hidden
            h = math.ceil(h / stride)
            if depthwise == "dw":
                macs += h * h * hidden * 9
            elif depthwise == "dense":
                macs += h * h * hidden * hidden * 9
            macs += h * h * hidden * out
            ch = out
    if head:
        last = _make_divisible(1280 * max(1.0, width))
        macs += h * h * ch * last + last * classes
    return 2 * macs * batch


def _fill(shapes):
    """flax variables from numpy: LeCun-normal kernels (flax's default
    initializer's scale), zero biases, BatchNorm scale, bias and running
    statistics moved off the identity."""
    rng = np.random.default_rng(1)

    def one(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "scale" in name:
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if "Dense" in name:
            return np.zeros(s.shape, np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                             np.uint8)


@pytest.fixture(scope="module")
def variants(frames):
    """Per case: (JAX module, its variables, the port's variant on them)."""
    from nnstreamer_tpu.tools import mbv2_breakdown as jb

    cache = {}

    def get(case):
        if case not in cache:
            opts = CASES[case]
            jm = jb._build_variant(**opts)
            v = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, SIZE, SIZE, 3))))
            port = pb.Variant(**opts)
            port.load_state_dict(pb.from_jax_variables(v))
            cache[case] = (jm, v, port.eval())
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_variant_matches_jax_and_counts_by_hand(variants, frames, case):
    jm, v, port = variants(case)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(frames)))
    x = torch.from_numpy(frames)
    with torch.no_grad():
        got = port(x).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert pm.cost_flops(port, x) == _hand_flops(SIZE, BATCH, **CASES[case])


def test_variant_options():
    """The stem's SAME padding on even kernels, the skip ablation's
    strided slice, and the options' shapes."""
    s2d = pb.Variant(keep_stages=0, head=False, s2d_stem=True)
    assert tuple(s2d.stem_conv.weight.shape) == (32, 12, 2, 2)
    x = torch.zeros(1, 32, 112, 112)
    # flax pads an even 2x2 kernel at stride 1 by (0, 1): the extra on
    # the high side
    assert pb._same_pad_nchw(x, 2, 1).shape[-2:] == (113, 113)
    assert pb._same_pad_nchw(x, 3, 2).shape[-2:] == (113, 113)
    skip = pb.Variant(keep_stages=2, head=False, depthwise="skip")
    assert not hasattr(skip.blocks[1], "dw_conv")
    dense = pb.Variant(keep_stages=2, head=False, depthwise="dense")
    assert dense.blocks[1].dw_conv.groups == 1
    with torch.no_grad():
        out = skip(torch.zeros(1, SIZE, SIZE, 3, dtype=torch.uint8))
    assert tuple(out.shape) == (1, SIZE // 4, SIZE // 4, 24)
    with pytest.raises(ValueError, match="depthwise"):
        pb.Variant(depthwise="none")
    a = pb.init_seeded(pb.Variant(keep_stages=1, head=False), 3)
    b = pb.init_seeded(pb.Variant(keep_stages=1, head=False), 3)
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k])
               for k in a.state_dict())


def test_flops_within_xla_cost_analysis(variants, frames):
    """FlopCounterMode's 2·MACs against XLA's cost analysis of the same
    variant (the JAX tool's ``_cost_flops``): XLA also counts BatchNorm,
    relu6 and the residual adds."""
    from nnstreamer_tpu.tools.mfu_table import _cost_flops

    jm, v, port = variants("full")
    xla = _cost_flops(lambda p, x: jm.apply(p, x), v, jnp.asarray(frames))
    ratio = pm.cost_flops(port, torch.from_numpy(frames)) / xla
    assert 0.75 <= ratio <= 1.0, ratio


def test_mobilenet_rows_count_the_plain_forward(frames):
    """Every MobileNet-v2 row is counted on a forward whose work the
    counter sees: the fused:pallas row on fused:xla, equal to the unfused
    forward's count and to the hand count. The kernel forward itself hides
    its blocks' depthwise work from the counter (on the CPU its plain
    version's taps are elementwise)."""
    custom = {"size": str(SIZE), "width": "0.35", "classes": "16"}
    fwds = pm.mobilenet_forwards(custom, device="cpu")
    x = torch.from_numpy(frames)
    want = _hand_flops(SIZE, BATCH, width=0.35, classes=16)
    for name, (_, count) in fwds.items():
        assert pm.cost_flops(count, x) == want, name
    pallas, count = fwds["mobilenet_v2 fused:pallas (BN-folded, kernels)"]
    assert count is fwds["mobilenet_v2 fused:xla (BN-folded)"][0]
    assert pm.cost_flops(pallas, x) < want


def _timer(ms, ms_min, ms_max):
    def timer(fn, x):
        return {"ms": ms, "ms_min": ms_min, "ms_max": ms_max, "reps": 5,
                "k_hi": 17, "launches_per_apply": {"normalize_u8": 1},
                "graph_launches": {"normalize_u8": 36}}
    return timer


def test_row_fields_and_flags():
    card = {"name": "NVIDIA H100 80GB HBM3", "power.limit": "700.00 W"}
    row = pm._row("r", None, None, 128, 1e12, _timer(2.0, 1.9, 2.2), card)
    assert row["device_ms_per_batch"] == 2.0
    assert row["device_ms_min"] == 1.9 and row["device_ms_max"] == 2.2
    assert row["reps"] == 5 and row["k_hi"] == 17
    assert row["device_fps"] == pytest.approx(64000.0)
    assert row["gflops_per_batch"] == 1000.0
    assert row["tflops_per_sec"] == pytest.approx(500.0)
    assert row["mfu_pct"] == pytest.approx(500.0 / pm.PEAK_TFLOPS * 100)
    assert row["mfu_pct_best"] == pytest.approx(
        1e12 / 1.9e-3 / 1e12 / pm.PEAK_TFLOPS * 100)
    assert "unreliable" not in row and "noisy_reps" not in row
    assert row["card"] == card and set(row["tf32"]) == {"matmul", "cudnn"}
    assert row["launches_per_apply"] == {"normalize_u8": 1}
    # over the peak: the timing, not the card
    fast = pm._row("r", None, None, 128, 1e12, _timer(0.5, 0.5, 0.6), card)
    assert fast["unreliable"] and fast["mfu_pct"] > 100
    # a collapsed rep: flagged, and no best MFU published
    noisy = pm._row("r", None, None, 128, 1e12, _timer(2.0, 0.5, 2.1), card)
    assert noisy["noisy_reps"] and "mfu_pct_best" not in noisy
    # no count: no rate
    assert "mfu_pct" not in pm._row("r", None, None, 8, None,
                                     _timer(2.0, 1.9, 2.1))

    def broken(fn, x):
        raise RuntimeError("capture failed")

    assert pm._row("r", None, None, 8, 1e9, broken) == {
        "config": "r", "batch": 8, "error": "capture failed"}


def test_failed_table_keeps_the_last_good_one(tmp_path):
    path = str(tmp_path / "probes" / "T.json")
    good = pm.table([{"config": "a", "device_ms_per_batch": 1.0}], {}, {})
    assert pm.save(good, path)
    bad = pm.table([{"config": "a", "error": "x"}], {}, {})
    assert not pm.save(bad, path)
    with open(path) as f:
        assert json.load(f)["rows"] == good["rows"]
    failed = str(tmp_path / "probes" / "T.failed.json")
    assert os.path.exists(failed)
    assert pm.save(good, path) and not os.path.exists(failed)


@pytest.mark.parametrize("streams", [1, 2])
def test_multistream_host_leg(streams):
    """The ms_host leg through the port's round_robin/join line: every
    buffer arrives (run_leg raises otherwise) at a finite rate."""
    ms.register_models(device=None)
    try:
        rate = ms.run_leg("ms_host", streams, 6)
    finally:
        ms.unregister_models()
    assert math.isfinite(rate) and rate > 0
    p = ms.build("ms_host", streams)
    assert sum(type(e).__name__ == "TensorFilter"
               for e in p.elements.values()) == streams


def test_tools_raise_without_card_and_write_nothing_at_root(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    paths = [os.path.join(pm.ROOT, n) for n in (
        "MFU_TABLE.json", "MFU_TABLE.failed.json", "MBV2_BREAKDOWN.json")]
    paths += [pm.DEFAULT_OUT, os.path.splitext(pm.DEFAULT_OUT)[0]
              + ".failed.json", pb.DEFAULT_OUT]

    def state():
        return [os.stat(q).st_mtime_ns if os.path.exists(q) else None
                for q in paths]

    before = state()
    for main in (pm.main, pb.main, ms.main):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            main([])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        pm.chain_ms(lambda x: x, torch.zeros(4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        pm.interleaved_ms({"a": lambda x: x}, torch.zeros(4))
    assert state() == before
