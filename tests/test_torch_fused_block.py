"""The port's fused inverted-residual block against the JAX package.

The same folded weights and inputs (numpy, from a seed) go through the JAX
Pallas kernel in interpret mode and its XLA path, and through the port's
``fused_inverted_residual`` — which on a CPU tensor runs
``inverted_residual_plain``; chip_smoke.py holds the CUDA kernel against
that plain version on the card. Tolerances are the JAX package's own
(tests/test_fused_block.py): float32 compute, 1e-4 against the folded
paths, 2e-4 against the flax module.
"""

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
from nnstreamer_tpu_torch.ops.fused_block import (  # noqa: E402
    _MAX_OUTPUTS,
    _SMEM_BUDGET,
    _plan_tiles,
    fold_inverted_residual,
    fused_inverted_residual,
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
    r, cot, cc, smem = _plan_tiles(113, 113, cin, ch, cin, 2)
    assert r * 113 * cot <= _MAX_OUTPUTS and smem <= _SMEM_BUDGET


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


def test_tile_plan_covers_every_main_path_shape():
    shapes = _mbv2_stride1_shapes()
    assert len(shapes) == 13
    assert shapes[0] == (112, 112, 32, 32, 16)
    assert shapes[-1] == (7, 7, 160, 960, 320)
    for itemsize in (2, 4):
        for H, W, cin, ch, cout in shapes:
            r, cot, cc, smem = _plan_tiles(H, W, cin, ch, cout, itemsize)
            assert 1 <= r <= H and 1 <= cot <= cout and 1 <= cc <= ch
            assert r * W * cot <= _MAX_OUTPUTS
            assert smem <= _SMEM_BUDGET
