"""The port's fused inverted-residual block against the JAX package.

The same folded weights and inputs (numpy, from a seed) go through the JAX
Pallas kernel in interpret mode and its XLA path, and through the port's
``fused_inverted_residual`` — which on a CPU tensor runs
``inverted_residual_plain`` (stride 1) or ``inverted_residual_conv``
(stride 2); chip_smoke.py holds the CUDA kernel against that plain version
on the card. ``inverted_residual_conv`` is held against the JAX
``inverted_residual_xla``. Tolerances are the JAX package's own
(tests/test_fused_block.py): float32 compute, 1e-4 against the folded
paths, 2e-4 against the flax module; bfloat16 compute at 2^-6 absolute and
relative (a few bf16 ulps: both round at the same points, their float32
sums run in another order).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.ops.fused_block import (  # noqa: E402
    fused_inverted_residual as jax_fused,
    inverted_residual_xla,
)
from nnstreamer_tpu_torch.models.convert import from_jax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: E402
    InvertedResidual,
    MobileNetV2,
)
from nnstreamer_tpu_torch.ops import _cuda  # noqa: E402
from nnstreamer_tpu_torch.ops.fused_block import (  # noqa: E402
    _MAX_OUTPUTS,
    _SMEM_BUDGET,
    _TC_MAX_PIXELS,
    _TC_VARIANTS,
    _TC_WARPS,
    _launch_fields,
    _launch_params,
    _plan_tiles,
    _tc_smem,
    _weights,
    fold_inverted_residual,
    fused_inverted_residual,
    inverted_residual_conv,
    inverted_residual_plain,
)


def _rand_folded(rng, Cin, Ch, Cout, expand):
    fw = {
        "wd": rng.normal(0, 0.3, (9, Ch)).astype(np.float32),
        "bd": rng.normal(0, 0.2, (Ch,)).astype(np.float32),
        "w2": rng.normal(0, 0.3, (Ch, Cout)).astype(np.float32),
        "b2": rng.normal(0, 0.2, (Cout,)).astype(np.float32),
    }
    if expand:
        fw["w1"] = rng.normal(0, 0.3, (Cin, Ch)).astype(np.float32)
        fw["b1"] = rng.normal(0, 0.2, (Ch,)).astype(np.float32)
    return fw


def _torch(fw):
    return {k: torch.from_numpy(v) for k, v in fw.items()}


def _jax(fw):
    return {k: jnp.asarray(v) for k, v in fw.items()}


@pytest.mark.parametrize("stride,expand,size,cin,cout", [
    (1, True, 8, 8, 8),      # residual
    (1, True, 9, 8, 16),     # odd size, no residual
    (1, False, 8, 16, 8),    # expand=1 (hidden == input)
    (2, True, 8, 8, 16),     # stride-2 even
    (2, True, 12, 16, 16),   # stride-2, Cin==Cout but NO residual
    (2, True, 9, 8, 8),      # stride-2 odd (SAME pads differ from torch's)
])
def test_block_matches_jax_kernel_and_xla(stride, expand, size, cin, cout):
    rng = np.random.default_rng(0)
    ch = cin * (6 if expand else 1)
    fw = _rand_folded(rng, cin, ch, cout, expand)
    x = rng.normal(0, 1, (3, size, size, cin)).astype(np.float32)
    want_xla = np.asarray(inverted_residual_xla(
        jnp.asarray(x), _jax(fw), stride=stride, compute_dtype=jnp.float32))
    want_kernel = np.asarray(jax_fused(
        jnp.asarray(x), _jax(fw), stride=stride, interpret=True,
        compute_dtype=jnp.float32))
    got = fused_inverted_residual(torch.from_numpy(x), _torch(fw),
                                  stride=stride,
                                  compute_dtype=torch.float32).numpy()
    assert got.shape == want_xla.shape
    np.testing.assert_allclose(got, want_xla, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want_kernel, atol=1e-4, rtol=1e-4)


def test_prime_size_matches():
    """H = 113 (prime): the JAX package routes it to XLA (no legal tile);
    the port has no tiling gate — on CUDA it runs the kernel — and on the
    CPU its plain version matches."""
    rng = np.random.default_rng(3)
    cin, ch = 4, 24
    fw = _rand_folded(rng, cin, ch, cin, True)
    x = rng.normal(0, 1, (1, 113, 113, cin)).astype(np.float32)
    want = np.asarray(inverted_residual_xla(jnp.asarray(x), _jax(fw),
                                            compute_dtype=jnp.float32))
    got = fused_inverted_residual(torch.from_numpy(x), _torch(fw),
                                  compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    _assert_plan_fits(113, 113, cin, ch, cin, 2)


@pytest.mark.parametrize("stride,expand", [(1, 6), (1, 1), (2, 6)])
def test_flax_block_carried_across(stride, expand):
    """A real flax InvertedResidual (live BatchNorm) carried across by
    from_jax_variables: the port module and the port's folded block both
    match flax apply at 2e-4 (f32). BN statistics are perturbed away from
    flax's identity init so the fold is exercised."""
    from nnstreamer_tpu.models.mobilenet_v2 import (
        InvertedResidual as FlaxInvertedResidual,
    )

    rng = np.random.default_rng(1)
    cin, cout, size = 8, 8 if stride == 1 else 16, 8
    mod = FlaxInvertedResidual(out_ch=cout, stride=stride, expand=expand,
                               dtype=jnp.float32)
    x = rng.normal(0, 1, (2, size, size, cin)).astype(np.float32)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.2, a.shape).astype(np.float32),
        variables)
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))

    blk = InvertedResidual(cin, cout, stride, expand, dtype=torch.float32)
    blk.load_state_dict(from_jax_variables(variables))
    blk.eval()
    with torch.no_grad():
        got_module = blk(torch.from_numpy(x)).numpy()
        got_folded = fused_inverted_residual(
            torch.from_numpy(x), fold_inverted_residual(blk), stride=stride,
            compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got_module, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_folded, want, atol=2e-4, rtol=2e-4)


def test_plain_rounds_like_the_kernel_in_bf16():
    """bf16 compute: each depthwise product is rounded to bf16 before the
    f32 tap sum (the Pallas kernel's rounding point) — the result differs
    from summing unrounded products, and stays within bf16 resolution of
    the f32 block."""
    rng = np.random.default_rng(4)
    fw = _torch(_rand_folded(rng, 8, 48, 8, True))
    x = torch.from_numpy(rng.normal(0, 1, (2, 7, 7, 8)).astype(np.float32))
    got = inverted_residual_plain(x, fw, compute_dtype=torch.bfloat16)
    ref = inverted_residual_plain(x, fw, compute_dtype=torch.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               atol=0.1, rtol=0.05)


def _mbv2_stride1_shapes(size=224, width=1.0):
    """(H, W, Cin, Ch, Cout) of MobileNet-v2's stride-1 blocks."""
    m = MobileNetV2(num_classes=8, width_mult=width)
    out, hw = [], size // 2
    for blk in m.blocks:
        hw = -(-hw // blk.stride)
        if blk.stride == 1:
            cin = blk.dw_conv.in_channels if blk.expand_conv is None \
                else blk.expand_conv.in_channels
            out.append((hw, hw, cin, blk.dw_conv.out_channels,
                        blk.proj_conv.out_channels))
    return out


def _assert_plan_fits(H, W, cin, ch, cout, itemsize, expand=True):
    """The plan's limits, as the kernel checks them before a launch."""
    plan = _plan_tiles(H, W, cin, ch, cout, itemsize, expand)
    assert plan.smem <= _SMEM_BUDGET
    assert 1 <= plan.R <= H and 1 <= plan.Cc
    if itemsize == 4:
        assert plan.kind == "fma" and 1 <= plan.CoT <= cout
        assert plan.R * W * plan.CoT <= _MAX_OUTPUTS
        return plan
    fm, fn = _TC_VARIANTS[plan.variant]
    assert plan.kind == "tc" and plan.CoT == cout
    assert plan.Cc % 16 == 0 and plan.Cc <= 64
    assert plan.R == 1 or plan.R * W <= _TC_MAX_PIXELS
    # the warps' 16x16 project fragments cover R*W pixels x Cout channels
    assert -(-plan.R * W // 16) <= fm * plan.WM
    assert -(-cout // 16) <= fn * (_TC_WARPS // plan.WM)
    assert plan.smem == _tc_smem(H, W, cin, cout, plan.R, plan.Cc, expand)
    return plan


def test_tile_plan_covers_every_main_path_shape():
    shapes = _mbv2_stride1_shapes()
    assert len(shapes) == 13
    assert shapes[0] == (112, 112, 32, 32, 16)
    assert shapes[-1] == (7, 7, 160, 960, 320)
    for itemsize in (2, 4):
        for H, W, cin, ch, cout in shapes:
            plan = _assert_plan_fits(H, W, cin, ch, cout, itemsize,
                                     expand=ch != cin)
            if itemsize == 2 and H <= 14:  # whole images: no halo recompute
                assert plan.R == H
    # the prime size, with Cout above one warp column's fragments
    plan = _assert_plan_fits(113, 113, 8, 48, 80, 2)
    assert plan.R * 113 <= _TC_MAX_PIXELS


def test_kernel_variants_match_the_source():
    """The planner's (FM, FN) table is the kernel's instantiation table."""
    src = open(os.path.join(_cuda.CSRC, "fused_block.cu")).read()
    table = re.search(r"kVariants\[\]\[2\] = \{(.*?)\};", src).group(1)
    pairs = tuple(tuple(int(v) for v in m)
                  for m in re.findall(r"\{(\d+), (\d+)\}", table))
    assert pairs == _TC_VARIANTS
    for v, (fm, fn) in enumerate(_TC_VARIANTS):
        assert f"case {v}: return reinterpret_cast<const void*>(" \
               f"&fused_ir_tc_kernel<{fm}, {fn}>);" in src


#: (stride, expand, dilation, size, cin, cout, residual)
_CONV_CASES = [
    (1, 6, 1, 8, 8, 8, None),     # residual
    (1, 6, 1, 8, 8, 8, False),    # Cin == Cout, residual off
    (1, 6, 1, 9, 8, 16, None),    # odd size, no residual
    (1, 1, 1, 8, 16, 8, None),    # expand=1
    (2, 6, 1, 8, 8, 16, None),    # stride 2, even: SAME pads (0, 1)
    (2, 6, 1, 9, 8, 8, None),     # stride 2, odd
    (2, 1, 1, 10, 16, 16, None),  # stride 2, expand=1, Cin == Cout
    (1, 6, 2, 9, 8, 8, None),     # dilation 2, odd, residual
    (1, 6, 2, 12, 8, 16, None),   # dilation 2
    (2, 6, 2, 11, 8, 8, None),    # stride 2 and dilation 2
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,expand,dilation,size,cin,cout,residual",
                         _CONV_CASES)
def test_conv_matches_jax_xla(stride, expand, dilation, size, cin, cout,
                              residual, dtype):
    """inverted_residual_conv against the JAX inverted_residual_xla on the
    same folded weights: float32 at 1e-4, bfloat16 at 2^-6."""
    rng = np.random.default_rng(10 + stride + 3 * dilation + size)
    ch = cin * expand
    fw = _rand_folded(rng, cin, ch, cout, expand != 1)
    x = rng.normal(0, 1, (2, size, size, cin)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(inverted_residual_xla(
        jnp.asarray(x).astype(jdt), _jax(fw), stride=stride,
        dilation=dilation, residual=residual,
        compute_dtype=jdt).astype(jnp.float32))
    got = inverted_residual_conv(
        torch.from_numpy(x).to(tdt), _torch(fw), stride=stride,
        dilation=dilation, residual=residual, compute_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def _bf16_rne(v):
    """Round float64 values to the nearest bfloat16 (ties to even), once,
    without going through float32: 8 significant bits."""
    m, e = np.frexp(v)  # v = m * 2**e, 0.5 <= |m| < 1
    return np.ldexp(np.rint(m * 256.0) / 256.0, e)


@pytest.mark.parametrize("lo,hi", [(-60, -20), (-8, 8), (20, 60)])
def test_bf16_product_rounds_to_nearest(lo, hi):
    """The fact the kernel's depthwise relies on: a product of two bf16
    values is exact in float32, so rounding the float32 product to bf16
    (the plain version's ``(tap.float() * wd.float()).to(bf16)``) is one
    rounding to nearest of the exact product, as mul.rn.bf16x2 computes it.
    Pairs in the float32 normal range; below it the plain path rounds twice
    and may differ by one bf16 ulp."""
    rng = np.random.default_rng(lo + 100)
    n = 20000
    a = torch.from_numpy(rng.uniform(1, 2, n) * np.exp2(
        rng.integers(lo, hi, n)) * rng.choice([-1, 1], n)).to(torch.bfloat16)
    b = torch.from_numpy(rng.uniform(1, 2, n) * np.exp2(
        rng.integers(lo, hi, n)) * rng.choice([-1, 1], n)).to(torch.bfloat16)
    exact = a.double() * b.double()
    assert torch.equal((a.float() * b.float()).double(), exact)
    plain = (a.float() * b.float()).to(torch.bfloat16)
    np.testing.assert_array_equal(plain.double().numpy(),
                                  _bf16_rne(exact.numpy()))
    # ties occur: the sample exercises round-half-to-even, not only nearest
    scaled = np.frexp(exact.numpy())[0] * 256.0
    assert (np.abs(scaled - np.floor(scaled) - 0.5) == 0).any()


def test_weights_are_cast_once_per_folded_dict():
    """The wrapper's per-call host path: a folded dict already in the
    kernel's form is used as it is, its checks run once, and a dict whose
    tensors were replaced is prepared anew."""
    fw = _torch(_rand_folded(np.random.default_rng(8), 8, 48, 16, True))
    fw = {k: v.to(torch.float32 if k.startswith("b") else torch.bfloat16)
          for k, v in fw.items()}
    dev = torch.device("cpu")
    w = _weights(fw, torch.bfloat16, dev)
    assert w is _weights(fw, torch.bfloat16, dev)
    assert all(w.tensors[k] is v for k, v in fw.items())  # no copy
    assert (w.Cin, w.Ch, w.Cout) == (8, 48, 16)
    assert w.ptrs == tuple(fw[k].data_ptr() for k in
                           ("w1", "b1", "wd", "bd", "w2", "b2"))
    fw["w2"] = fw["w2"].clone()
    w2 = _weights(fw, torch.bfloat16, dev)
    assert w2 is not w and w2.ptrs[4] == fw["w2"].data_ptr()
    # float32 weights for a bfloat16 block are cast (once)
    w32 = _weights(_torch(_rand_folded(np.random.default_rng(9), 8, 48, 8,
                                       False)), torch.bfloat16, dev)
    assert w32.tensors["wd"].dtype == torch.bfloat16 and w32.ptrs[0] == 0
    with pytest.raises(ValueError, match="w2 must be"):
        _weights({**fw, "w2": fw["w2"][:8]}, torch.bfloat16, dev)


def test_launch_params_follow_the_c_layout():
    """The cached argument arrays follow the C entry point's layout
    (csrc/fused_block.cu): the weight pointers, the shape, the dtype code
    and the plan in its F_* order, which the TorchScript op route passes
    on unread (the same fields, _launch_fields)."""
    src = open(os.path.join(_cuda.CSRC, "fused_block.cu")).read()
    names = re.findall(r"F_[A-Z0-9]+", re.search(
        r"enum \{\s*(F_R,.*?F_COUNT)\s*\};", src, re.S).group(1))
    assert names[-1] == "F_COUNT"
    idx = {n: i for i, n in enumerate(names)}
    entry = re.search(r"int nnstpu_fused_inverted_residual\((.*?)\)", src,
                      re.S).group(1)
    assert entry.count(",") + 1 == len(
        _cuda._SIGNATURES["nnstpu_fused_inverted_residual"]) == 8
    w = _weights(_torch(_rand_folded(np.random.default_rng(10), 8, 48, 8,
                                     True)), torch.float32,
                 torch.device("cpu"))
    params = _launch_params(w, 3, 9, 11, True, torch.float32, 0)
    assert params is _launch_params(w, 3, 9, 11, True, torch.float32, 0)
    ptrs, dims, dtype, fields, n = params
    assert [p or 0 for p in ptrs] == list(w.ptrs) and w.ptrs[0] != 0
    assert list(dims) == [3, 9, 11, 8, 48, 8]
    assert dtype == _cuda.DTYPE_CODES[torch.float32]
    assert n == len(fields) == idx["F_COUNT"]
    plan = _plan_tiles(9, 11, 8, 48, 8, 4, True)
    want = {"F_R": plan.R, "F_COT": plan.CoT, "F_CC": plan.Cc,
            "F_VARIANT": -1, "F_GRID": 0, "F_RESIDUAL": 1,
            "F_SMEM": plan.smem}
    assert {k: fields[idx[k]] for k in want} == want
    assert list(fields) == _launch_fields(w, 9, 11, True, torch.float32, 0)


@pytest.mark.parametrize("model,size", [("ssd_mobilenet", 300),
                                        ("deeplab_v3", 257)])
def test_tile_plan_covers_ssd_and_deeplab_shapes(model, size):
    """Every block shape the SSD (300 px) and DeepLab (257 px) lines give
    the kernel — 150², 75², 38², 19², 10² and 129², 65², 33², 17², ragged
    tiles and an expand-1 block among them — has a plan within the
    kernel's limits, in bfloat16 and float32."""
    import importlib

    from nnstreamer_tpu_torch.models.mobilenet_v2 import kernel_block_shapes

    mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{model}")
    m = getattr(mod, {"ssd_mobilenet": "SSDMobileNetV2",
                      "deeplab_v3": "DeepLabV3"}[model])()
    shapes = kernel_block_shapes(m, size)
    assert len(shapes) == (13 if model == "ssd_mobilenet" else 10)
    for itemsize in (2, 4):
        for _, H, W, cin, ch, cout in shapes:
            _assert_plan_fits(H, W, cin, ch, cout, itemsize, expand=ch != cin)


@pytest.mark.parametrize("stride,dilation,size", [
    (1, 1, 19),   # the kernel's route (its plain version here)
    (1, 1, 10),
    (2, 1, 19),   # stride 2: the convolutions
    (1, 2, 17),   # dilated (DeepLab's output-stride trick): the convolutions
])
def test_auto_matches_jax_auto(stride, dilation, size):
    """inverted_residual_auto against the JAX inverted_residual_auto (on
    the CPU its XLA path) at the new models' map sizes, float32."""
    from nnstreamer_tpu.ops.fused_block import (
        inverted_residual_auto as jax_auto,
    )
    from nnstreamer_tpu_torch.ops.fused_block import inverted_residual_auto

    rng = np.random.default_rng(size + stride + dilation)
    fw = _rand_folded(rng, 16, 96, 16, True)
    x = rng.normal(0, 1, (2, size, size, 16)).astype(np.float32)
    want = np.asarray(jax_auto(jnp.asarray(x), _jax(fw), stride=stride,
                               dilation=dilation, compute_dtype=jnp.float32))
    got = inverted_residual_auto(torch.from_numpy(x), _torch(fw),
                                 stride=stride, dilation=dilation,
                                 compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k,stride,groups,dilation,act", [
    (3, 2, 1, 1, "relu6"),   # a stem
    (1, 1, 1, 1, "relu"),    # an ASPP 1x1 branch
    (3, 1, 1, 6, "relu"),    # a dilated ASPP branch
    (3, 2, 8, 1, "relu6"),   # a strided depthwise (PoseNet)
    (3, 1, 1, 1, None),      # no activation
])
def test_fold_conv_bn_apply_matches_jax(k, stride, groups, dilation, act):
    """fold_conv_bn_apply on a conv + BatchNorm against the JAX function
    on the same weights (HWIO, flax's BatchNorm dicts), float32."""
    from nnstreamer_tpu.ops.fused_block import (
        fold_conv_bn_apply as jax_apply,
    )
    from nnstreamer_tpu_torch.ops.fused_block import fold_conv_bn_apply

    rng = np.random.default_rng(k * 100 + stride * 10 + dilation)
    cin, cout = 8, (8 if groups > 1 else 12)
    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, groups=groups,
                           dilation=dilation, bias=False)
    bn = torch.nn.BatchNorm2d(cout).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            rng.normal(0, 0.3, conv.weight.shape).astype(np.float32)))
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.normal(0, 0.5, cout).astype(
                np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, cout).astype(np.float32)))
    params = {"c": {"kernel": jnp.asarray(
        conv.weight.detach().numpy().transpose(2, 3, 1, 0))},
        "b": {"scale": jnp.asarray(bn.weight.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}}
    stats = {"b": {"mean": jnp.asarray(bn.running_mean.numpy()),
                   "var": jnp.asarray(bn.running_var.numpy())}}
    x = rng.normal(0, 1, (2, 21, 21, cin)).astype(np.float32)
    want = np.asarray(jax_apply(
        jnp.asarray(x), params, stats, "c", "b", strides=(stride, stride),
        groups=groups, dilation=(dilation, dilation), act=act,
        compute_dtype=jnp.float32))
    got = fold_conv_bn_apply(conv, bn, act=act,
                             compute_dtype=torch.float32)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
