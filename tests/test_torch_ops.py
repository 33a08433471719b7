"""The PyTorch/CUDA port's elementwise ops against the JAX package.

On the CPU the port's wrappers run their plain versions (the CUDA kernels
are held against those plain versions on the card by chip_smoke.py). The
same numpy inputs go through the JAX Pallas kernel in interpret mode, as the
JAX package's own tests run it (tests/test_ops.py), and through the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.ops import arith_chain as jax_arith_chain  # noqa: E402
from nnstreamer_tpu.ops import normalize_u8 as jax_normalize_u8  # noqa: E402
from nnstreamer_tpu_torch.ops import _cuda  # noqa: E402
from nnstreamer_tpu_torch.ops import arith_chain, normalize_u8  # noqa: E402


def _ulp_diff(a, b):
    """Distance in float32 units in the last place."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("shape,scale,offset", [
    ((4, 32, 32, 3), 1 / 127.5, -1.0),   # aligned: the Pallas kernel runs
    ((8, 128), 1 / 255.0, 0.0),          # the 'unit' preamble
    ((3, 7, 5), 1 / 127.5, -1.0),        # ragged: the JAX op's plain path
])
def test_normalize_u8_matches_jax(shape, scale, offset):
    """Against the JAX op at the JAX package's own tolerance (atol 1e-6,
    tests/test_ops.py::TestNormalizeU8): the interpret-mode Pallas kernel
    lands up to 2 float32 ulps from a mul-then-add (XLA contracts it into
    an FMA near the cancellation at x≈127). Against the JAX op's own plain
    expression (float32 mul, then add — what the CUDA kernel computes with
    __fmul_rn/__fadd_rn) the port is bit-equal."""
    x = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    want = np.asarray(jax_normalize_u8(jnp.asarray(x), scale=scale,
                                       offset=offset, out_dtype=jnp.float32,
                                       interpret=True))
    got = normalize_u8(torch.from_numpy(x), scale=scale, offset=offset,
                       out_dtype=torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert _ulp_diff(got, want).max() <= 2
    plain = np.asarray(jnp.asarray(x).astype(jnp.float32) * scale + offset)
    np.testing.assert_array_equal(got, plain)


def test_normalize_u8_bf16_default():
    """Default output is bf16, as in the JAX op; equal to rounding the f32
    result once."""
    x = np.random.default_rng(1).integers(0, 256, (2, 16, 16, 3), np.uint8)
    got = normalize_u8(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    want = normalize_u8(torch.from_numpy(x), out_dtype=torch.float32)
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("n", [1024, 1000])  # aligned / unaligned sizes
@pytest.mark.parametrize("clamp", [None, (-0.5, 0.75)])
@pytest.mark.parametrize("ops", [
    [("add", -127.5), ("mul", 3.0), ("add", 2.0)],
    [("add", -127.5), ("div", 127.5), ("mul", 3.0)],  # the JAX test's chain
])
def test_arith_chain_matches_jax(dtype, n, clamp, ops):
    """Against the JAX op: bit-equal where the JAX op rounds once per op
    (its plain path, taken for sizes that are not a multiple of 1024). In
    interpret mode XLA compiles the Pallas kernel's body with a division by
    a constant turned into a multiply by its reciprocal and a mul→add pair
    contracted into an FMA, so aligned sizes are held at the JAX package's
    own tolerance (rtol 1e-5, tests/test_ops.py::TestArithChain); the port
    rounds once per op in IEEE float32, as numpy does (next test)."""
    rng = np.random.default_rng(2)
    if dtype == np.float32:
        x = rng.normal(0, 100, n).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    want = np.asarray(jax_arith_chain(jnp.asarray(x), ops,
                                      out_dtype=jnp.float32, clamp=clamp,
                                      interpret=True))
    got = arith_chain(torch.from_numpy(x), ops, out_dtype=torch.float32,
                      clamp=clamp).numpy()
    if n % 1024:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ops", [
    [("add", -127.5), ("div", 127.5)],               # the transform preamble
    [("mul", 3.0), ("add", 0.1), ("div", 7.0), ("mul", -2.5), ("add", 1.0)],
])
def test_arith_chain_matches_numpy_per_op(ops):
    """Every op rounds once in float32, as numpy's tensor_transform path
    does — bit for bit, mul→add pairs included."""
    x = np.random.default_rng(3).integers(0, 256, (16, 128), np.uint8)
    got = arith_chain(torch.from_numpy(x), ops,
                      out_dtype=torch.float32).numpy()
    want = x.astype(np.float32)
    for k, v in ops:
        want = want + v if k == "add" else (want * v if k == "mul" else want / v)
    np.testing.assert_array_equal(got, want)


#: the chains of the repo's launch lines (tensor_transform mode=arithmetic:
#: the typecast preamble, mul:2, mul:0.5, mul:0.1, add:1) and a clamp
LAUNCH_LINE_CHAINS = {
    "preamble": ([("add", -127.5), ("div", 127.5)], None),
    "mul2": ([("mul", 2.0)], None),
    "mul0.5": ([("mul", 0.5)], None),
    "mul0.1": ([("mul", 0.1)], None),
    "add1": ([("add", 1.0)], None),
    "preamble_clamp": ([("add", -127.5), ("div", 127.5)], (-0.5, 0.5)),
}


@pytest.mark.parametrize("out", ["float32", "float16"])
@pytest.mark.parametrize("chain", sorted(LAUNCH_LINE_CHAINS))
@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_arith_chain_plain_exhaustive_8bit_matches_numpy(dtype, chain, out):
    """Every one of the 256 values of an 8-bit input, through the plain
    version (the CUDA kernel's table is held bit-equal to it on the card),
    against numpy's per-op float32 arithmetic, then one rounding to the
    output dtype."""
    ops, clamp = LAUNCH_LINE_CHAINS[chain]
    x = np.arange(256, dtype=np.uint8).view(dtype)
    want = x.astype(np.float32)
    for k, v in ops:
        v = np.float32(v)
        want = want + v if k == "add" else (want * v if k == "mul"
                                            else want / v)
    if clamp is not None:
        want = np.clip(want, np.float32(clamp[0]), np.float32(clamp[1]))
    want = want.astype(out)
    got = arith_chain(torch.from_numpy(x), ops, out_dtype=getattr(torch, out),
                      clamp=clamp).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_arith_chain_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown arithmetic op"):
        arith_chain(torch.zeros(8, 128), [("pow", 2.0)])


def test_dispatch_takes_plain_only_on_cpu():
    """The one dispatch rule of every kernel wrapper: plain version for a
    CPU tensor, the kernel for a CUDA tensor, an error for anything else."""
    assert _cuda.on_cpu(torch.zeros(2))
    with pytest.raises(ValueError, match="no kernel"):
        _cuda.on_cpu(torch.zeros(2, device="meta"))


def test_plain_runs_do_not_count_launches():
    _cuda.reset_launches()
    x = torch.zeros(4, 8, 8, 3, dtype=torch.uint8)
    normalize_u8(x)
    arith_chain(x, [("add", 1.0)], out_dtype=torch.float32)
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


def test_kernel_sources_present_and_hashed():
    """The build key covers every source, so an edit rebuilds."""
    srcs = _cuda._sources()
    assert {"fused_block.cu", "preprocess.cu", "transform_ops.cu",
            "common.cuh"} <= set(srcs)
    assert len(_cuda._digest()) == 16
