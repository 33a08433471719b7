"""The port's sequence-parallel attention and its mesh against the JAX
package's.

The same numpy inputs go through both packages. JAX runs on the
conftest's 8 virtual host devices (its ring and Ulysses under
``shard_map``, jitted so each call compiles once); the port's mesh is
``make_mesh(sp=8, devices=[cpu] * 8)``, one process driving eight shards.
On the CPU the chunk-kernel wrapper runs its plain version (the chunk
recurrence at the kernel's 128-key blocks); chip_smoke.py holds the CUDA
kernel against that plain version on the card. ``flash_chunk_pallas`` runs
in interpret mode, patched as the JAX package's own tests patch it.

Tolerances: float32 at atol 3e-5, the JAX ring tests' own; bfloat16 at
|port - jax| <= 2^-6 + 2^-6 |jax| (both round p and the output at the same
points; only float32 sums are taken in another order, which can flip a
bf16 rounding); the future-chunk no-op bit for bit; the ring
StreamTransformer against flax at 1e-4, the f32 model tolerance of
tests/test_torch_vit.py.
"""

import functools
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
from nnstreamer_tpu.parallel import mesh as jax_mesh  # noqa: E402
from nnstreamer_tpu_torch.ops import _cuda  # noqa: E402
from nnstreamer_tpu_torch.ops import attention as port_attn  # noqa: E402
from nnstreamer_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

ATOL = 3e-5
BF16_TOL = 2.0 ** -6
CPU = torch.device("cpu")


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_bf16_close(got, want):
    err = np.abs(got - want)
    assert (err <= BF16_TOL + BF16_TOL * np.abs(want)).all(), err.max()


# -- the chunk update against the Pallas kernel in interpret mode ----------

def _pallas_chunk(*args, **kw):
    from jax.experimental import pallas as pl

    with mock.patch.object(pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True)):
        return jax_attn.flash_chunk_pallas(
            *(jnp.asarray(a) for a in args), **kw)


def _fresh(bh, sq, d):
    return (np.full((bh, sq), jax_attn._NEG_INF, np.float32),
            np.zeros((bh, sq), np.float32), np.zeros((bh, sq, d), np.float32))


#: the port's two plain routes to the chunk: the recurrence at the Pallas
#: test's blocks, and the kernel wrapper on a CPU tensor (the instance's
#: key block: BLOCK_K keys at these head dims)
def _plain_at(block_k):
    def fn(*args, **kw):
        return port_attn.flash_chunk_plain(*args, block_k=block_k, **kw)
    return fn


def _wrapper(*args, **kw):
    return port_attn.flash_chunk_cuda(*(t.clone() for t in args[:6]), **kw)


def _port_chunks(fn, q, k, v, carries, offsets, causal, scale, sk):
    m, l, acc = (_t(c) for c in carries)
    for ci, (qo, ko) in enumerate(offsets):
        m, l, acc = fn(_t(q), _t(k[:, ci * sk:(ci + 1) * sk]),
                       _t(v[:, ci * sk:(ci + 1) * sk]), m, l, acc,
                       q_offset=qo, k_offset=ko, causal=causal, scale=scale)
    return m.numpy(), l.numpy(), acc.numpy()


def _jax_chunks(q, k, v, carries, offsets, causal, scale, sk, block):
    m, l, acc = carries
    for ci, (qo, ko) in enumerate(offsets):
        m, l, acc = _pallas_chunk(
            q, k[:, ci * sk:(ci + 1) * sk], v[:, ci * sk:(ci + 1) * sk], m,
            l, acc, q_offset=qo, k_offset=ko, causal=causal, scale=scale,
            block_q=block, block_k=block)
    return tuple(np.asarray(x) for x in (m, l, acc))


def _out(m, l, acc):
    return acc / np.maximum(l, 1e-37)[..., None]


@pytest.fixture(scope="module")
def chunk_refs():
    """The Pallas kernel's carries, one interpret-mode run per case."""
    bh, sq, d = 2, 64, 128
    scale = 1.0 / d ** 0.5
    q, k, v = _np((bh, sq, d), 11), _np((bh, 2 * sq, d), 12), \
        _np((bh, 2 * sq, d), 13)
    refs = {}
    for causal in (False, True):
        # q globally after both K chunks: with causal everything is visible
        args = (q, k, v, _fresh(bh, sq, d), [(2 * sq, 0), (2 * sq, sq)],
                causal, scale, sq)
        refs["mono", causal] = args, _jax_chunks(*args, block=32)
    # the diagonal crosses every q block: offsets 128/128, blocks 16
    args = (q, k, v, _fresh(bh, sq, d), [(128, 128)], True, scale, sq)
    refs["diag", True] = args, _jax_chunks(*args, block=16)
    return refs


CHUNK_FNS = {"plain_b16": _plain_at(16), "plain_b32": _plain_at(32),
             "wrapper": _wrapper}


@pytest.mark.parametrize("fn", sorted(CHUNK_FNS))
@pytest.mark.parametrize("case", [("mono", False), ("mono", True),
                                  ("diag", True)])
def test_chunk_matches_pallas_kernel_interpret(chunk_refs, fn, case):
    (q, k, v, carries, offsets, causal, scale, sk), want = chunk_refs[case]
    got = _port_chunks(CHUNK_FNS[fn], q, k, v, carries, offsets, causal,
                       scale, sk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=ATOL)
    if case[0] == "mono":
        # chunked equals monolithic: the ring-hop algebra
        s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) * scale
        p = np.exp(s - s.max(-1, keepdims=True))
        ref = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v)
        np.testing.assert_allclose(_out(*got), ref, atol=ATOL)


@pytest.mark.parametrize("fn", sorted(CHUNK_FNS))
def test_future_chunk_is_bitwise_noop(fn):
    """Carries from an earlier hop go through a chunk wholly in the causal
    future: the kernel, its plain version and the wrapper leave m, l and
    acc bit for bit as they were."""
    bh, sq, d = 2, 32, 128
    q, k = _np((bh, sq, d), 14), _np((bh, sq, d), 15)
    carries = _port_chunks(_plain_at(32), q, k, k, _fresh(bh, sq, d),
                           [(sq, 0)], True, 0.1, sq)
    assert np.isfinite(carries[2]).all() and (carries[1] > 0).all()
    want = _jax_chunks(q, k, k, carries, [(0, 10 * sq)], True, 0.1, sq, 32)
    got = _port_chunks(CHUNK_FNS[fn], q, k, k, carries, [(0, 10 * sq)],
                       True, 0.1, sq)
    for g, w, c in zip(got, want, carries):
        np.testing.assert_array_equal(w, c)
        np.testing.assert_array_equal(g.view(np.uint32), c.view(np.uint32))


#: (q_offset, the first hop's k_offset, the second's): a past chunk, then
#: one across the diagonal (some rows see none of it) or another past one
@pytest.mark.parametrize("offsets,causal", [((160, 0, 160), True),
                                            ((256, 0, 96), True),
                                            ((0, 96, 0), False)])
def test_chunk_whole_block_bf16_matches_xla_hop(offsets, causal):
    """flash_chunk_plain with one block over the whole chunk (block_k = sk)
    in bf16 against the reference's XLA hop (_ring_chunk_update's CPU
    branch), the second hop on the first one's carries."""
    bh, sq, sk, d = 2, 64, 96, 64
    q, k, v = _np((bh, sq, d), 16), _np((bh, sk, d), 17), _np((bh, sk, d), 18)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    scale = 1.0 / d ** 0.5
    first = dict(q_offset=offsets[0], k_offset=offsets[1], causal=causal,
                 scale=scale)
    hop = dict(q_offset=offsets[0], k_offset=offsets[2], causal=causal,
               scale=scale)
    want = jax_attn._ring_chunk_update(jq, jk, jv, *_fresh(bh, sq, d),
                                       **first)
    want = jax_attn._ring_chunk_update(jq, jk, jv, *want, **hop)
    got = port_attn.flash_chunk_plain(tq, tk, tv, *map(_t, _fresh(bh, sq, d)),
                                      block_k=sk, **first)
    got = port_attn.flash_chunk_plain(tq, tk, tv, *got, block_k=sk, **hop)
    for g, w in zip(got, want):
        _assert_bf16_close(_f32(g), _f32(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", [(256, 0), (256, 256)],
                         ids=["past", "diagonal"])
def test_chunk_plain_at_kernel_block_matches_pallas_kernel(dtype, offsets):
    """flash_chunk_plain at the CUDA kernel's BLOCK_K against the Pallas
    chunk kernel in interpret mode at 128-row, 128-key blocks, on carries
    from an earlier hop: a causal hop over a past chunk, then one on the
    diagonal."""
    bh, sq, d = 2, 256, 128
    scale = 1.0 / d ** 0.5
    q, k, v, k0, v0 = (_np((bh, sq, d), 70 + i) for i in range(5))
    first = dict(q_offset=offsets[0], k_offset=offsets[0] - sq, causal=True,
                 scale=scale)
    hop = dict(q_offset=offsets[0], k_offset=offsets[1], causal=True,
               scale=scale)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jk0, jv0 = (jnp.asarray(a, jdt) for a in (q, k, v, k0, v0))
    blocks = dict(block_q=port_attn.BLOCK_Q, block_k=port_attn.BLOCK_K)
    want = _pallas_chunk(jq, jk0, jv0, *_fresh(bh, sq, d), **first, **blocks)
    want = _pallas_chunk(jq, jk, jv, *want, **hop, **blocks)
    tq, tk, tv, tk0, tv0 = (_t(a, tdt) for a in (q, k, v, k0, v0))
    got = port_attn.flash_chunk_plain(tq, tk0, tv0, *map(_t, _fresh(bh, sq, d)),
                                      **first)
    got = port_attn.flash_chunk_plain(tq, tk, tv, *got, **hop)
    got, want = [_f32(x) for x in got], [_f32(x) for x in want]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=ATOL)
    if dtype == "float32":
        np.testing.assert_allclose(_out(*got), _out(*want), atol=ATOL)
    else:
        _assert_bf16_close(_out(*got), _out(*want))


@pytest.mark.parametrize("d", [256, 384, 512])
def test_wide_bf16_chunk_wrapper_matches_pallas_kernel(d):
    """From head_dim 256 up bf16 runs on the tensor cores in 64-key tiles:
    the chunk wrapper on CPU tensors (its plain version at the instance's
    key block) against the Pallas chunk kernel in interpret mode at 128-row,
    64-key blocks, a past hop and then the diagonal hop on its carries."""
    bh, sq = 2, 256
    block = port_attn.key_block(d, torch.bfloat16)
    assert block == 64
    scale = 1.0 / d ** 0.5
    q, k, v, k0, v0 = (_np((bh, sq, d), 90 + d + i) for i in range(5))
    first = dict(q_offset=sq, k_offset=0, causal=True, scale=scale)
    hop = dict(q_offset=sq, k_offset=sq, causal=True, scale=scale)
    jq, jk, jv, jk0, jv0 = (jnp.asarray(a, jnp.bfloat16)
                            for a in (q, k, v, k0, v0))
    blocks = dict(block_q=port_attn.BLOCK_Q, block_k=block)
    want = _pallas_chunk(jq, jk0, jv0, *_fresh(bh, sq, d), **first, **blocks)
    want = _pallas_chunk(jq, jk, jv, *want, **hop, **blocks)
    tq, tk, tv, tk0, tv0 = (_t(a, torch.bfloat16) for a in (q, k, v, k0, v0))
    carries = list(map(_t, _fresh(bh, sq, d)))
    port_attn.flash_chunk_cuda(tq, tk0, tv0, *carries, **first)
    got = port_attn.flash_chunk_cuda(tq, tk, tv, *carries, **hop)
    got, want = [_f32(x) for x in got], [_f32(x) for x in want]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=ATOL)
    _assert_bf16_close(_out(*got), _out(*want))


def test_chunk_wrapper_updates_in_place_and_counts_no_launch_on_cpu():
    bh, sq, d = 1, 40, 32
    q, k = _t(_np((bh, sq, d), 19)), _t(_np((bh, 70, d), 20))
    m, l, acc = map(_t, _fresh(bh, sq, d))
    kw = dict(q_offset=50, k_offset=0, causal=True, scale=0.2)
    want = port_attn.flash_chunk_plain(q, k, k, m, l, acc, **kw)
    _cuda.reset_launches()
    got = port_attn.flash_chunk_cuda(q, k, k, m, l, acc, **kw)
    assert all(g is c for g, c in zip(got, (m, l, acc)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _cuda.LAUNCHES["flash_chunk"] == 0
    meta = torch.zeros(bh, sq, d, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port_attn.flash_chunk_cuda(meta, meta, meta, *map(_t, _fresh(
            bh, sq, d)), **kw)


def test_chunk_kernel_is_built_and_bound():
    assert "nnstpu_flash_chunk" in _cuda._SIGNATURES
    assert "flash_chunk" in _cuda.LAUNCHES
    with open(f"{_cuda.CSRC}/attention.cu") as fh:
        src = fh.read()
    assert "nnstpu_flash_chunk" in src and "flash_chunk_pallas" in src


# -- ring and Ulysses on an sp=8 mesh --------------------------------------

@pytest.fixture(scope="module")
def meshes():
    return (jax_mesh.make_mesh(dp=1, tp=1, sp=8),
            port_mesh.make_mesh(sp=8, devices=[CPU] * 8))


@pytest.fixture(scope="module")
def jax_ref(meshes):
    """Each JAX sequence-parallel call once per module, jitted."""
    cache = {}

    def get(name, shape, dtype, causal, seed):
        key = (name, shape, dtype, causal, seed)
        if key not in cache:
            fn = jax.jit(functools.partial(
                getattr(jax_attn, name), mesh=meshes[0], axis_name="sp",
                causal=causal))
            args = [jnp.asarray(_np(shape, seed + i), dtype)
                    for i in range(3)]
            cache[key] = _f32(fn(*args))
        return cache[key]

    return get


def _port_sp(fn, mesh, shape, dtype, causal, seed, **kw):
    args = [_t(_np(shape, seed + i), dtype) for i in range(3)]
    out = fn(*args, mesh, "sp", causal=causal, **kw)
    assert out.dtype == dtype and tuple(out.shape) == shape
    return _f32(out)


@pytest.mark.parametrize("shape", [(2, 256, 16), (2, 256, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring(meshes, jax_ref, shape, causal):
    want = jax_ref("ring_attention", shape, jnp.float32, causal, 30)
    got = _port_sp(port_attn.ring_attention, meshes[1], shape, torch.float32,
                   causal, 30)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_bf16_matches_jax_ring(meshes, jax_ref, causal):
    want = jax_ref("ring_attention", (2, 256, 64), jnp.bfloat16, causal, 40)
    got = _port_sp(port_attn.ring_attention, meshes[1], (2, 256, 64),
                   torch.bfloat16, causal, 40)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_plain_is_the_ring_at_the_kernel_block(meshes, causal):
    """ring_attention on CPU shards is its plain version at BLOCK_K; at
    another block only bf16 roundings move."""
    mesh = port_mesh.make_mesh(sp=4, devices=[CPU] * 4)
    args = [_t(_np((3, 512, 32), 50 + i), torch.bfloat16) for i in range(3)]
    ring = port_attn.ring_attention(*args, mesh, causal=causal)
    assert torch.equal(ring, port_attn.ring_attention_plain(
        *args, mesh, causal=causal))
    _assert_bf16_close(_f32(ring), _f32(port_attn.ring_attention_plain(
        *args, mesh, causal=causal, block_k=32)))


def test_ring_takes_the_sp_axis_of_a_wider_mesh():
    """Lead dims pass through, and a (dp=2, sp=4) mesh rings over its sp
    axis as a one-axis mesh does (the reference replicates over dp)."""
    args = [_t(_np((2, 3, 128, 32), 60 + i)) for i in range(3)]
    wide = port_mesh.make_mesh(dp=2, sp=4, devices=[CPU] * 8)
    flat = port_mesh.make_mesh(sp=4, devices=[CPU] * 4)
    got = port_attn.ring_attention(*args, wide, causal=True)
    assert torch.equal(got, port_attn.ring_attention(*args, flat,
                                                     causal=True))
    np.testing.assert_allclose(
        _f32(got), _f32(port_attn.plain_attention(*args, causal=True)),
        atol=ATOL)
    with pytest.raises(ValueError, match="must divide"):
        port_attn.ring_attention(*(a[..., :102, :] for a in args), flat)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_ulysses(meshes, jax_ref, causal):
    shape = (2, 8, 256, 16)
    want = jax_ref("ulysses_attention", shape, jnp.float32, causal, 70)
    got = _port_sp(port_attn.ulysses_attention, meshes[1], shape,
                   torch.float32, causal, 70)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_head_dim_8_long_sequence_matches_jax(meshes, jax_ref, causal):
    """The reference's long-sequence case (tests/test_ops.py), head_dim 8:
    1024 positions in 8 shards of 128."""
    want = jax_ref("ring_attention", (1, 1024, 8), jnp.float32, causal, 74)
    got = _port_sp(port_attn.ring_attention, meshes[1], (1, 1024, 8),
                   torch.float32, causal, 74)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name,shape", [
    ("ring_attention", (2, 1024, 32)),
    ("ulysses_attention", (2, 8, 1024, 32))])
def test_long_context_example_matches_jax(meshes, jax_ref, name, shape):
    """examples/long_context.py's sequence-parallel steps at its own sizes,
    causal float32 over sp=8, against the JAX function and against plain
    attention on the whole sequence."""
    want = jax_ref(name, shape, jnp.float32, True, 76)
    got = _port_sp(getattr(port_attn, name), meshes[1], shape, torch.float32,
                   True, 76)
    np.testing.assert_allclose(got, want, atol=ATOL)
    args = [_t(_np(shape, 76 + i)) for i in range(3)]
    np.testing.assert_allclose(
        got, _f32(port_attn.plain_attention(*args, causal=True)), atol=ATOL)


def test_ulysses_matches_ring(meshes):
    q, k, v = (_t(_np((1, 8, 128, 8), 80 + i)) for i in range(3))
    uly = port_attn.ulysses_attention(q, k, v, meshes[1], "sp")
    ring = port_attn.ring_attention(q.reshape(8, 128, 8), k.reshape(8, 128, 8),
                                    v.reshape(8, 128, 8), meshes[1], "sp")
    np.testing.assert_allclose(_f32(uly).reshape(8, 128, 8), _f32(ring),
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 6, 64, 8), (6, 64, 8)])
def test_ulysses_errors_match_jax(meshes, shape):
    """6 heads on 8 devices, and a rank-3 input: the same ValueError."""
    with pytest.raises(ValueError) as want:
        z = jnp.zeros(shape, jnp.float32)
        jax_attn.ulysses_attention(z, z, z, meshes[0], "sp")
    with pytest.raises(ValueError) as got:
        z = torch.zeros(shape)
        port_attn.ulysses_attention(z, z, z, meshes[1], "sp")
    assert str(got.value) == str(want.value)


# -- the mesh grammar -------------------------------------------------------

def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return f"ValueError: {e}"


def _shape(mesh):
    return dict(mesh.shape)


@pytest.mark.parametrize("kw", [
    {}, {"sp": 8}, {"tp": 2, "sp": 2}, {"dp": 2, "tp": 2, "sp": 2},
    {"n_devices": 4, "tp": 2}, {"tp": 3}, {"dp": 3, "tp": 2},
    {"n_devices": 6, "sp": 4}])
def test_make_mesh_matches_jax(kw):
    want = _outcome(lambda: _shape(jax_mesh.make_mesh(**kw)))
    got = _outcome(lambda: _shape(port_mesh.make_mesh(
        devices=[CPU] * 8, **kw)))
    assert got == want


@pytest.mark.parametrize("spec", [
    {"mode": "dp"}, {"mode": "tp", "shard_devices": 4}, {"mode": "dpxtp"},
    {"mode": "dpxtp", "tp_devices": 4}, {"mode": "dpxtp", "tp_devices": 0},
    {"mode": "dpxtp", "tp_devices": 3}, {"mode": "zz"}])
def test_mesh_from_spec_matches_jax(spec):
    want = _outcome(lambda: _shape(jax_mesh.mesh_from_spec(spec)))
    got = _outcome(lambda: _shape(port_mesh.mesh_from_spec(
        spec, devices=[CPU] * 8)))
    assert got == want


@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2), (3, 3)])
def test_mesh_from_axes_matches_jax(dp, tp):
    want = _outcome(lambda: _shape(jax_mesh.mesh_from_axes(dp, tp)))
    got = _outcome(lambda: _shape(port_mesh.mesh_from_axes(
        dp, tp, devices=[CPU] * 8)))
    assert got == want


@pytest.mark.parametrize("mode,mesh,n", [
    ("dp", "", 8), ("tp", "", 8), ("dpxtp", "", 8), ("dpxtp", "", 7),
    ("dp", "4x2", 8), ("tp", "4", 8), ("dp", "4", 8), ("dpxtp", "2x2", 8),
    ("dpxtp", "1x4", 8), ("x", "", 8), ("dp", "", 1), ("dp", "axb", 8),
    ("tp", "1x16", 8), ("dp", "1x1", 8), ("dp", "0x1", 8),
    (" DP ", " 2X1 ", 2)])
def test_resolve_shard_axes_matches_jax(mode, mesh, n):
    assert _outcome(lambda: port_mesh.resolve_shard_axes(mode, mesh, n)) == \
        _outcome(lambda: jax_mesh.resolve_shard_axes(mode, mesh, n))


def test_mesh_defaults_to_cuda_devices_and_allows_repeats(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_mesh()
    mesh = port_mesh.make_mesh(dp=2, sp=2, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "tp": 1, "sp": 2}
    assert mesh.axis_devices("sp") == [CPU, CPU]
    assert mesh.axis_devices("dp") == [CPU, CPU]


# -- the slice: a StreamTransformer whose attention is the ring -------------

def test_ring_stream_transformer_matches_flax():
    from nnstreamer_tpu.models import vit as jax_vit
    from nnstreamer_tpu_torch.models.convert import from_jax_variables
    from nnstreamer_tpu_torch.models.vit import StreamTransformer

    cfg = dict(seq=256, feat=16, dim=256, depth=2, heads=2)  # head_dim 128
    rng = np.random.default_rng(90)
    model = jax_vit.StreamTransformer(dtype=jnp.float32, causal=True, **cfg)
    x = rng.normal(size=(1, 256, 16)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(2), jnp.asarray(x))
    # perturb every leaf so each converted weight matters
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.02, a.shape).astype(
            np.float32), jax.device_get(variables))
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    mesh = port_mesh.make_mesh(sp=4, devices=[CPU] * 4)
    port = StreamTransformer(dtype=torch.float32, causal=True, **cfg,
                             attention=functools.partial(
                                 port_attn.ring_attention, mesh=mesh,
                                 axis_name="sp"))
    port.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 256, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
