"""The port's single-device attention against the JAX package's.

On the CPU the kernel wrapper runs its plain version (the blockwise
recurrence at the kernel's 128-key blocks); chip_smoke.py holds the CUDA
kernel against that plain version on the card. The same numpy inputs go
through the JAX functions — ``flash_attention_pallas`` in interpret mode,
as the JAX package's own tests run it (tests/test_ops.py) — and through
the port. float32 cases are held at the JAX tests' atol 2e-5; bfloat16 cases
at |port - jax| <= 2^-6 + 2^-6 |jax|, the tolerance the card's check uses
(the two round p and the output at the same points; only float32 sums are
taken in another order, which can flip a bf16 rounding).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.ops import attention as jax_attn  # noqa: E402
from nnstreamer_tpu_torch.ops import _cuda  # noqa: E402
from nnstreamer_tpu_torch.ops import attention as port_attn  # noqa: E402

ATOL = 2e-5
BF16_TOL = 2.0 ** -6


def _qkv(shape, seed, sk=None):
    rng = np.random.default_rng(seed)
    kshape = shape if sk is None else (*shape[:-2], sk, shape[-1])
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=kshape).astype(np.float32),
            rng.normal(size=kshape).astype(np.float32))


def _port(fn, q, k, v, dtype=torch.float32, **kw):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


def _jax(fn, q, k, v, dtype=jnp.float32, **kw):
    return np.asarray(fn(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                         **kw).astype(jnp.float32))


def _naive(q, k, v, causal=False):
    s = np.einsum("...qd,...kd->...qk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        s = np.where(np.arange(sq)[:, None] >= np.arange(sk)[None, :], s,
                     -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("...qk,...kd->...qd", p, v.astype(np.float64))


def _assert_bf16_close(got, want):
    err = np.abs(got - want)
    assert (err <= BF16_TOL + BF16_TOL * np.abs(want)).all(), err.max()


#: the port's two plain routes to the Pallas kernel's result: the
#: recurrence at the Pallas test's blocks, and the kernel wrapper on a CPU
#: tensor (the recurrence at the CUDA kernel's BLOCK_K keys)
PORT_FNS = {
    "plain_b32": lambda q, k, v, **kw: port_attn.flash_attention_plain(
        q, k, v, block_k=32, **kw),
    "wrapper": port_attn.flash_attention_cuda,
}


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_kernel_interpret(fn, causal):
    q, k, v = _qkv((2, 64, 128), 5)
    want = _jax(jax_attn.flash_attention_pallas, q, k, v, causal=causal,
                block_q=32, block_k=32, interpret=True)
    got = _port(PORT_FNS[fn], q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
def test_lead_dims_match_pallas_kernel(fn):
    q, k, v = _qkv((2, 3, 32, 128), 6)
    want = _jax(jax_attn.flash_attention_pallas, q, k, v, block_q=32,
                block_k=32, interpret=True)
    got = _port(PORT_FNS[fn], q, k, v)
    assert got.shape == (2, 3, 32, 128)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_matches_jax_flash_attention(causal):
    q, k, v = _qkv((2, 128, 32), 7)
    want = _jax(jax_attn.flash_attention, q, k, v, causal=causal,
                block_size=32)
    got = _port(port_attn.flash_attention, q, k, v, causal=causal,
                block_size=32)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_bf16_rounds_where_jax_does(causal):
    """bf16 in and out: p rounded to bf16 before p·v, the output rounded
    once — at the same points as the JAX recurrence."""
    q, k, v = _qkv((2, 128, 64), 8)
    want = _jax(jax_attn.flash_attention, q, k, v, jnp.bfloat16,
                causal=causal, block_size=32)
    got = _port(port_attn.flash_attention, q, k, v, torch.bfloat16,
                causal=causal, block_size=32)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_jax(dtype, causal):
    q, k, v = _qkv((2, 40, 16), 9)
    want = _jax(jax_attn.plain_attention, q, k, v, getattr(jnp, dtype),
                causal=causal)
    got = _port(port_attn.plain_attention, q, k, v, getattr(torch, dtype),
                causal=causal)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        _assert_bf16_close(got, want)


def _jax_route(sq, sk, d, dtype):
    """Which plain function the JAX package's flash_attention_auto runs on
    the CPU for these shapes."""
    if (jax_attn._pallas_tiling(sq, sk, d, dtype) is None
            and sq * sk <= jax_attn._PLAIN_SEQ_LIMIT):
        return "plain_attention"
    return "flash_attention"


@pytest.mark.parametrize("shape", [(2, 96, 16), (1, 608, 16), (2, 64, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_auto_cpu_routing_matches_jax(shape, causal, monkeypatch):
    """On a CPU tensor flash_attention_auto picks the plain function the
    JAX package picks, and returns what the JAX package returns."""
    taken = []
    for name in ("plain_attention", "flash_attention"):
        real = getattr(port_attn, name)
        monkeypatch.setattr(
            port_attn, name,
            lambda *a, _real=real, _name=name, **kw: (taken.append(_name),
                                                       _real(*a, **kw))[1])
    q, k, v = _qkv(shape, 10)
    want = _jax(jax_attn.flash_attention_auto, q, k, v, causal=causal)
    got = _port(port_attn.flash_attention_auto, q, k, v, causal=causal)
    assert taken == [_jax_route(shape[-2], shape[-2], shape[-1],
                                jnp.float32)]
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_vit_shape_matches_naive(causal):
    """ViT's 197 tokens at head_dim 64: two 128-key blocks, the last one of
    69 keys — the kernel's ragged tail, on its plain version."""
    q, k, v = _qkv((3, 197, 64), 11)
    want = _naive(q, k, v, causal)
    got = _port(port_attn.flash_attention_cuda, q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("sq,sk", [(100, 300), (300, 100)])
def test_causal_unequal_lengths_match_jax(sq, sk):
    """Causal positions count from 0 in both q and k, as in the JAX mask;
    the last key block is ragged."""
    q, k, v = _qkv((2, sq, 32), 12, sk=sk)
    want = _jax(jax_attn.plain_attention, q, k, v, causal=True)
    got = _port(port_attn.flash_attention_cuda, q, k, v, causal=True)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_block_boundaries_decide_bf16_rounding():
    """The kernel's plain version must run at the kernel's own block: p is
    rounded relative to the running max, so another block size gives other
    bf16 roundings (and this is why chip_smoke compares at BLOCK_K)."""
    q, k, v = _qkv((2, 256, 64), 13)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    a = port_attn.flash_attention_plain(*args, block_k=port_attn.BLOCK_K)
    b = port_attn.flash_attention_plain(*args, block_k=256)
    assert torch.equal(port_attn.flash_attention_cuda(*args), a)
    assert not torch.equal(a, b)
    _assert_bf16_close(a.float().numpy(), b.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_at_kernel_block_matches_pallas_kernel(dtype, causal):
    """The plain version at the CUDA kernel's tile against the Pallas
    kernel in interpret mode at the same 128-row, 128-key blocks."""
    q, k, v = _qkv((2, 256, 128), 14)
    want = _jax(jax_attn.flash_attention_pallas, q, k, v, getattr(jnp, dtype),
                causal=causal, block_q=port_attn.BLOCK_Q,
                block_k=port_attn.BLOCK_K, interpret=True)
    got = _port(port_attn.flash_attention_plain, q, k, v,
                getattr(torch, dtype), causal=causal,
                block_k=port_attn.BLOCK_K)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        _assert_bf16_close(got, want)


def test_kernel_source_declares_the_wrapper_tile():
    """The plain versions run at BLOCK_K because the kernel does: the tile
    csrc/attention.cu declares is the one the wrapper states."""
    with open(os.path.join(_cuda.CSRC, "attention.cu")) as fh:
        src = fh.read()
    tile = dict(re.findall(r"constexpr int (kBlock[QK]) = (\d+);", src))
    assert tile == {"kBlockQ": str(port_attn.BLOCK_Q),
                    "kBlockK": str(port_attn.BLOCK_K)}


def test_kernel_attributes_refuse_a_head_dim_without_a_kernel():
    """The card-side query names only instantiated head dims; another one
    is refused before the library is built or loaded."""
    with pytest.raises(ValueError, match="no kernel for head_dim 48"):
        port_attn.flash_kernel_attributes(48)


def test_wrapper_counts_no_launch_on_cpu_and_refuses_other_devices():
    _cuda.reset_launches()
    q = torch.zeros(1, 8, 32)
    port_attn.flash_attention_cuda(q, q, q)
    port_attn.flash_attention_auto(q, q, q)
    assert _cuda.LAUNCHES["flash_attention"] == 0
    m = torch.zeros(1, 8, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port_attn.flash_attention_cuda(m, m, m)


def test_kernel_is_built_and_bound():
    assert "attention.cu" in _cuda._sources()
    assert "nnstpu_flash_attention" in _cuda._SIGNATURES
    assert port_attn.HEAD_DIMS == (32, 64, 128)
