"""The port's single-device attention against the JAX package's.

On the CPU the kernel wrapper runs its plain version (the blockwise
recurrence at the key block of the kernel instance the same shape would
run: 128 keys, 64 for bf16 from head_dim 256 up on the tensor cores);
chip_smoke.py holds the CUDA kernel against that plain version on the
card. The same numpy inputs go
through the JAX functions — ``flash_attention_pallas`` in interpret mode,
as the JAX package's own tests run it (tests/test_ops.py) — and through
the port. float32 cases are held at the JAX tests' atol 2e-5; bfloat16 cases
at |port - jax| <= 2^-6 + 2^-6 |jax|, the tolerance the card's check uses
(the two round p and the output at the same points; only float32 sums are
taken in another order, which can flip a bf16 rounding).
"""

import contextlib
import ctypes
import functools
import os
import re
import unittest.mock as mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
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
    """The card-side query names only head dims a kernel takes (every one
    from 1 up); another one is refused before the library is built or
    loaded."""
    with pytest.raises(ValueError, match="head_dim of at least 1, got 0"):
        port_attn.flash_kernel_attributes(0)


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
    assert port_attn.SLICE_COLS == 256
    assert port_attn.KERNEL_DTYPES == (torch.bfloat16, torch.float32)


# -- every head dim and both dtypes ----------------------------------------

#: head dims of every kind: the tensor-core body's 16, multiples of 8 and
#: odd widths that the simple body takes, and the largest
WIDE_DIMS = (1, 8, 16, 20, 24, 33, 48, 96, 100, 200, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_every_head_dim_matches_jax_blockwise(dtype, d, causal):
    """The wrapper on a CPU tensor against the JAX package's XLA route
    (its blockwise recurrence) at the key block of the instance that runs
    the shape, so that a bf16 p is rounded at the same running max."""
    q, k, v = _qkv((2, 256, d), 20 + d)
    want = _jax(jax_attn.flash_attention, q, k, v, getattr(jnp, dtype),
                causal=causal,
                block_size=port_attn.key_block(d, getattr(torch, dtype)))
    got = _port(port_attn.flash_attention_cuda, q, k, v,
                getattr(torch, dtype), causal=causal)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        _assert_bf16_close(got, want)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("sq,sk", [(100, 300), (300, 100)])
def test_every_head_dim_ragged_matches_jax(d, sq, sk):
    """Ragged causal sequences at every head dim, float32, against the
    JAX package's plain attention."""
    q, k, v = _qkv((2, sq, d), 30 + d, sk=sk)
    want = _jax(jax_attn.plain_attention, q, k, v, causal=True)
    got = _port(port_attn.flash_attention_cuda, q, k, v, causal=True)
    np.testing.assert_allclose(got, want, atol=ATOL)


#: the stream transformer at head_dim 256 (dim 512 over 2 heads, the
#: stream line's leg at dim 1024 over 4 heads cut to a small size): float32
#: at the example-width test's 1e-4, bf16 at the JAX package's bf16 logit
#: tolerance (tests/test_fused_block.py), as tests/test_torch_vit.py holds
#: the bf16 zoo builders
HD256_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (0.15, 0.05)}


@pytest.mark.parametrize("dtype", sorted(HD256_TOLS))
def test_stream_transformer_at_head_dim_256_matches_flax(dtype):
    """The StreamTransformer at head_dim 256 (dim 512, 2 heads, seq 128,
    depth 1), causal, through the kernel wrapper (on the CPU its plain
    version at the instance's key block: 64 keys in bf16, 128 in float32)
    against flax on the same weights, carried by convert.py."""
    from nnstreamer_tpu.models import vit as jax_vit
    from nnstreamer_tpu_torch.models.convert import from_jax_variables
    from nnstreamer_tpu_torch.models.vit import StreamTransformer

    cfg = dict(seq=128, feat=16, dim=512, depth=1, heads=2)
    assert cfg["dim"] // cfg["heads"] == 256
    rng = np.random.default_rng(41)
    model = jax_vit.StreamTransformer(dtype=getattr(jnp, dtype), causal=True,
                                      **cfg)
    x = rng.normal(size=(2, 128, 16)).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
            np.float32), jax.device_get(variables))
    want = np.asarray(model.apply(variables, jnp.asarray(x)).astype(
        jnp.float32))
    port = StreamTransformer(dtype=getattr(torch, dtype), causal=True, **cfg,
                             attention=port_attn.flash_attention_cuda)
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape == (2, 128, 16)
    atol, rtol = HD256_TOLS[dtype]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_stream_transformer_at_the_example_width_matches_flax():
    """examples/long_context.py's model, dim 32 and 2 heads (head_dim
    16), float32, against flax on the same weights."""
    from nnstreamer_tpu.models import vit as jax_vit
    from nnstreamer_tpu_torch.models.convert import from_jax_variables
    from nnstreamer_tpu_torch.models.vit import StreamTransformer

    cfg = dict(seq=128, feat=16, dim=32, depth=1, heads=2)
    rng = np.random.default_rng(40)
    model = jax_vit.StreamTransformer(dtype=jnp.float32, causal=True, **cfg)
    x = rng.normal(size=(2, 128, 16)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(4), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
            np.float32), jax.device_get(variables))
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = StreamTransformer(dtype=torch.float32, causal=True, **cfg,
                             attention=port_attn.flash_attention_cuda)
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 128, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# -- the CUDA branch of the wrappers, against a recording library ----------

def _read(ptr: int, n: int, code: int) -> np.ndarray:
    """n values of dtype code ``code`` (float32 or bf16) at a host
    pointer, as float32."""
    if code == _cuda.DTYPE_CODES[torch.float32]:
        return np.ctypeslib.as_array((ctypes.c_float * n).from_address(
            ptr)).copy()
    raw = np.ctypeslib.as_array((ctypes.c_uint16 * n).from_address(ptr))
    return (raw.astype(np.uint32) << 16).view(np.float32)


class _RecordingLib:
    """Stands in for the kernel library: records what each entry point is
    given, reading the q/k/v buffers at the pointers it gets."""

    def __init__(self):
        self.calls = []

    def nnstpu_flash_attention(self, q, k, v, o, bh, sq, sk, d, code, scale,
                               causal, stream):
        self.calls.append(dict(
            q=_read(q, bh * sq * d, code), k=_read(k, bh * sk * d, code),
            v=_read(v, bh * sk * d, code), o=o, shape=(bh, sq, sk, d),
            code=code, scale=scale, causal=causal))
        return 0

    def nnstpu_flash_chunk(self, q, k, v, m, l, acc, ml, bh, sq, sk, d,
                           code, q_offset, k_offset, scale, causal, stream):
        self.calls.append(dict(
            q=_read(q, bh * sq * d, code), k=_read(k, bh * sk * d, code),
            v=_read(v, bh * sk * d, code), carries=(m, l, acc), ml=ml,
            shape=(bh, sq, sk, d), code=code, offsets=(q_offset, k_offset),
            scale=scale, causal=causal))
        return 0


@pytest.fixture
def recording_lib(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: every tensor counts as a
    CUDA one, and the library is the recorder."""
    rec = _RecordingLib()
    monkeypatch.setattr(_cuda, "on_cpu", lambda x: False)
    monkeypatch.setattr(_cuda, "lib", lambda: rec)
    monkeypatch.setattr(_cuda, "stream_handle", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    _cuda.reset_launches()
    yield rec
    _cuda.reset_launches()


def _strided(shape, seed, dtype):
    """A non-contiguous tensor of ``shape``: the wrapper must hand the
    kernel a contiguous copy with row stride d."""
    *lead, s, d = shape
    a = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(*lead, d, s)).astype(np.float32)).to(dtype)
    return a.transpose(-1, -2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 256])
def test_cuda_branch_passes_dtype_dim_and_rows(recording_lib, dtype, d):
    tdt = getattr(torch, dtype)
    code = _cuda.DTYPE_CODES[tdt]
    q, k, v = (_strided((2, 3, s, d), i, tdt)
               for i, s in enumerate((40, 70, 70)))
    out = port_attn.flash_attention_cuda(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == tdt
    call, = recording_lib.calls
    assert call["shape"] == (6, 40, 70, d) and call["code"] == code
    assert call["causal"] == 1 and call["o"] == out.data_ptr()
    assert call["scale"] == pytest.approx(1 / d ** 0.5)
    for name, t in (("q", q), ("k", k), ("v", v)):
        np.testing.assert_array_equal(call[name], t.float().reshape(-1).numpy())
    assert _cuda.LAUNCHES["flash_attention"] == 1

    q3, k3 = q.reshape(6, 40, d), k.reshape(6, 70, d)
    carries = [c.clone() for c in port_attn._fresh_carries(6, 40, d, "cpu")]
    port_attn.flash_chunk_cuda(q3, k3, k3, *carries, q_offset=70,
                               k_offset=0, causal=True, scale=0.5)
    call = recording_lib.calls[-1]
    assert call["shape"] == (6, 40, 70, d) and call["code"] == code
    assert call["offsets"] == (70, 0) and call["scale"] == 0.5
    assert call["carries"] == tuple(c.data_ptr() for c in carries)
    assert call["ml"] in (0, None)  # no scratch up to 256 columns
    np.testing.assert_array_equal(call["q"], q3.float().reshape(-1).numpy())
    assert _cuda.LAUNCHES["flash_chunk"] == 1


def _refused_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    return {"d0": ((2, 16, 0), (f32,) * 3, "head_dim of at least 1, got 0"),
            "float16": ((2, 16, 64), (torch.float16,) * 3,
                        "bfloat16 or float32 on CUDA, got torch.float16"),
            "mixed": ((2, 16, 64), (f32, bf16, f32), "of one dtype")}


@pytest.mark.parametrize("case", sorted(_refused_cases()))
@pytest.mark.parametrize("fn", ["flash", "chunk"])
def test_cuda_branch_refuses_what_no_kernel_takes(recording_lib, case, fn):
    shape, dtypes, msg = _refused_cases()[case]
    q, k, v = (torch.zeros(shape, dtype=dt) for dt in dtypes)
    with pytest.raises(ValueError, match=msg):
        if fn == "flash":
            port_attn.flash_attention_cuda(q, k, v)
        else:
            port_attn.flash_chunk_cuda(
                q, k, v, *port_attn._fresh_carries(2, 16, shape[-1], "cpu"),
                q_offset=0, k_offset=0)
    assert not recording_lib.calls


@pytest.mark.parametrize("d,dtype", [(0, torch.float32),
                                     (-1, torch.bfloat16),
                                     (64, torch.float16)])
def test_kernel_attributes_refuse_outside_the_limits(d, dtype):
    with pytest.raises(ValueError):
        port_attn.flash_kernel_attributes(d, dtype=dtype)


def _cu_table(name: str):
    with open(os.path.join(_cuda.CSRC, "attention.cu")) as fh:
        src = fh.read()
    m = re.search(rf"constexpr int {name}\[\] = \{{([^}}]*)\}};", src)
    return tuple(int(x) for x in m.group(1).split(",")), src


def test_instantiation_table_matches_the_wrapper_limits():
    """The kernel source's instantiation tables are the wrapper's (the
    tensor-core body's D and key block at each, the simple body's D, the
    splits' columns, the tensor-core split's panel and key block), every
    entry has a launch case, every head dim up to the widest simple D in
    either dtype reaches one of them at a D not below it, and every wider
    one a split body in ceil(d / 256) slices of 256 columns: the
    tensor-core split for bf16 at multiples of 64, the simple split
    otherwise. Each instance's key block is the one key_block names."""
    tc, src = _cu_table("kTcDims")
    tc_blocks, _ = _cu_table("kTcKeyBlocks")
    simple, _ = _cu_table("kSimpleDims")
    assert tc == port_attn.TC_HEAD_DIMS
    assert tc_blocks == port_attn.TC_KEY_BLOCKS
    assert simple == port_attn.SIMPLE_HEAD_DIMS
    consts = {name: int(v) for name, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    cols = consts["kSliceCols"]
    assert cols == port_attn.SLICE_COLS == simple[-1]
    assert consts["kPanelCols"] == port_attn.PANEL_COLS
    assert consts["kSplitKeyBlock"] == port_attn.SPLIT_KEY_BLOCK
    assert consts["kBlockK"] == port_attn.BLOCK_K
    assert "kMaxHeadDim" not in src
    for D in tc:
        assert f"case {D}: return launch_tc<{D}, kCarry>" in src
    for D in simple:
        assert f"case {D}: return launch_simple<{D // 16}, kCarry>" in src
    assert ("return launch_split<kCarry>(in, inst.body, grid, inst.slices, "
            "bh, s);") in src
    bf16 = torch.bfloat16
    for dtype in port_attn.KERNEL_DTYPES:
        for d in range(1, 3 * cols + 2):
            body, D = port_attn.kernel_instance(d, dtype)
            slices = port_attn.head_dim_slices(d)
            block = port_attn.key_block(d, dtype)
            if d > cols:
                tc_split = dtype == bf16 and d % port_attn.PANEL_COLS == 0
                assert (body, D) == ("tensor_core_split" if tc_split
                                     else "simple_split", cols)
                assert block == (port_attn.SPLIT_KEY_BLOCK if tc_split
                                 else port_attn.BLOCK_K)
                assert (slices - 1) * cols < d <= slices * cols
                continue
            assert slices == 1
            assert D >= d and D in (tc if body == "tensor_core" else simple)
            assert (body == "tensor_core") == (dtype == bf16 and d in tc)
            if body == "tensor_core":
                assert D == d
                assert block == tc_blocks[tc.index(d)]
            else:
                assert block == port_attn.BLOCK_K
    assert port_attn.kernel_instance(64, torch.bfloat16) == ("tensor_core",
                                                             64)
    assert port_attn.kernel_instance(16, torch.bfloat16) == ("tensor_core", 16)
    assert port_attn.kernel_instance(8, torch.bfloat16) == ("simple", 32)
    assert port_attn.kernel_instance(48, torch.bfloat16) == ("simple", 64)
    assert port_attn.kernel_instance(64, torch.float32) == ("simple", 64)
    assert port_attn.kernel_instance(20, torch.bfloat16) == ("simple", 32)
    assert port_attn.kernel_instance(257, torch.bfloat16) == ("simple_split",
                                                              256)
    assert port_attn.kernel_instance(256, bf16) == ("tensor_core", 256)
    assert port_attn.kernel_instance(256, torch.float32) == ("simple", 256)
    assert port_attn.kernel_instance(192, bf16) == ("simple", 256)
    for d in (320, 384, 512):
        assert port_attn.kernel_instance(d, bf16) == ("tensor_core_split", 256)
        assert port_attn.kernel_instance(d, torch.float32) == ("simple_split",
                                                               256)
        assert port_attn.key_block(d, bf16) == 64
    assert port_attn.key_block(256, bf16) == 64
    assert port_attn.key_block(128, bf16) == 128
    assert port_attn.key_block(256, torch.float32) == 128
    assert port_attn.key_block(256, torch.float64) == 128
    assert port_attn.head_dim_slices(512) == 2
    assert port_attn.head_dim_slices(513) == 3


# -- head dims above 256: the split body -----------------------------------

#: head dims past the simple body's widest D: one column over, a ragged
#: last slice, and two multiples of 128 (the Pallas kernel's tiling)
SPLIT_DIMS = (257, 320, 384, 512)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", SPLIT_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_dims_match_jax_blockwise(dtype, d, causal):
    """Above 256 the wrapper on a CPU tensor runs: its plain version
    against the JAX package's blockwise recurrence at the instance's key
    block, at a ragged query length."""
    q, k, v = _qkv((2, 200, d), 50 + d, sk=256)
    want = _jax(jax_attn.flash_attention, q, k, v, getattr(jnp, dtype),
                causal=causal,
                block_size=port_attn.key_block(d, getattr(torch, dtype)))
    got = _port(port_attn.flash_attention_cuda, q, k, v,
                getattr(torch, dtype), causal=causal)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        _assert_bf16_close(got, want)


#: head dims from 256 up where the JAX package runs its Pallas kernel
#: (d % 128 == 0): the tensor-core body at 256 and its split above in bf16
PALLAS_WIDE_DIMS = (256,) + tuple(d for d in SPLIT_DIMS if d % 128 == 0)


@pytest.mark.parametrize("d", PALLAS_WIDE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_dims_match_pallas_kernel_interpret(d, causal):
    """Where the JAX package runs its Pallas kernel (d % 128 == 0), the
    wrapper's plain version against it in interpret mode at the CUDA
    kernel's 128-row, 128-key blocks, float32."""
    q, k, v = _qkv((2, 256, d), 60 + d)
    want = _jax(jax_attn.flash_attention_pallas, q, k, v, causal=causal,
                block_q=port_attn.BLOCK_Q, block_k=port_attn.BLOCK_K,
                interpret=True)
    got = _port(port_attn.flash_attention_cuda, q, k, v, causal=causal)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _pallas_chunk(*args, **kw):
    from jax.experimental import pallas as pl

    with mock.patch.object(pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True)):
        return jax_attn.flash_chunk_pallas(
            *(jnp.asarray(a) for a in args), **kw)


@pytest.mark.parametrize("d", PALLAS_WIDE_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_wide_bf16_head_dims_match_pallas_kernel_interpret(d, causal):
    """bf16 from head_dim 256 up, where the tensor cores take it: the
    wrapper's plain version against the Pallas kernel in interpret mode at
    the instance's blocks (128 q rows, 64 keys), so that p is rounded at
    the same running max."""
    block = port_attn.key_block(d, torch.bfloat16)
    assert block == 64
    q, k, v = _qkv((2, 256, d), 70 + d)
    want = _jax(jax_attn.flash_attention_pallas, q, k, v, jnp.bfloat16,
                causal=causal, block_q=port_attn.BLOCK_Q, block_k=block,
                interpret=True)
    got = _port(port_attn.flash_attention_cuda, q, k, v, torch.bfloat16,
                causal=causal)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("d", PALLAS_WIDE_DIMS)
def test_wide_chunk_matches_pallas_kernel_interpret(d):
    """The chunk wrapper on a CPU tensor at d above 256 against the
    Pallas chunk kernel in interpret mode at 128-row, 128-key blocks:
    a past hop, then the diagonal hop on its carries, float32."""
    bh, sq = 2, 256
    scale = 1.0 / d ** 0.5
    q, k0, v0, k, v = (_qkv((bh, sq, d), 80 + d + i)[0] for i in range(5))
    fresh = (np.full((bh, sq), jax_attn._NEG_INF, np.float32),
             np.zeros((bh, sq), np.float32), np.zeros((bh, sq, d), np.float32))
    blocks = dict(block_q=port_attn.BLOCK_Q, block_k=port_attn.BLOCK_K)
    hops = (dict(q_offset=sq, k_offset=0, causal=True, scale=scale),
            dict(q_offset=sq, k_offset=sq, causal=True, scale=scale))
    want = _pallas_chunk(q, k0, v0, *fresh, **hops[0], **blocks)
    want = _pallas_chunk(q, k, v, *want, **hops[1], **blocks)
    carries = [torch.from_numpy(c.copy()) for c in fresh]
    tq, tk0, tv0, tk, tv = (torch.from_numpy(a) for a in (q, k0, v0, k, v))
    port_attn.flash_chunk_cuda(tq, tk0, tv0, *carries, **hops[0])
    got = port_attn.flash_chunk_cuda(tq, tk, tv, *carries, **hops[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", (256,) + SPLIT_DIMS)
def test_cuda_branch_passes_wide_head_dims(recording_lib, dtype, d):
    """From 256 up the CUDA branch launches both kernels at the given head
    dim; above 256 (a split body) it hands the chunk kernel float32
    scratch for the new m and l (2 x bh x sq) apart from the carries it
    updates, and at 256 (one slice) none."""
    tdt = getattr(torch, dtype)
    q, k = (torch.zeros((3, s, d), dtype=tdt) for s in (40, 70))
    out = port_attn.flash_attention_cuda(q, k, k)
    assert out.shape == q.shape and out.dtype == tdt
    carries = port_attn._fresh_carries(3, 40, d, "cpu")
    port_attn.flash_chunk_cuda(q, k, k, *carries, q_offset=0, k_offset=0)
    flash, chunk = recording_lib.calls
    assert flash["shape"] == chunk["shape"] == (3, 40, 70, d)
    assert chunk["carries"] == tuple(c.data_ptr() for c in carries)
    if port_attn.head_dim_slices(d) == 1:
        assert chunk["ml"] in (0, None)
    else:
        assert chunk["ml"] not in (0, None)
        assert chunk["ml"] not in chunk["carries"]
    assert _cuda.LAUNCHES["flash_attention"] == 1
    assert _cuda.LAUNCHES["flash_chunk"] == 1


def test_attention_probe_raises_without_a_card(monkeypatch):
    """tools/attention_probe.py times the kernels on a card and nowhere
    else: without one it raises before it builds or times anything."""
    from nnstreamer_tpu_torch.tools import attention_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch sees none"):
        attention_probe.main(["--dims", "256"])
