"""The port's MobileNet-v2 against the JAX package's flax model.

Flax's own init, carried across by ``from_jax_variables``, with the
BatchNorm statistics perturbed away from the identity so the fold matters.
float32 compute at a reduced size/width (all strides and expand configs of
the architecture), at the JAX package's tolerance for the fused forward
(tests/test_fused_block.py::test_full_model_fused_matches_flax): 5e-4 and
equal argmax.
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

from nnstreamer_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
    save_state_dict,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: E402
    MobileNetV2,
    _make_fused_apply,
)


@pytest.fixture(scope="module")
def flax_model():
    from nnstreamer_tpu.models.mobilenet_v2 import MobileNetV2 as FlaxMBV2

    rng = np.random.default_rng(2)
    model = FlaxMBV2(num_classes=16, width_mult=0.35, dtype=jnp.float32)
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(0.0, 0.1, a.shape).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    return variables, x, want


def _port(variables):
    m = MobileNetV2(num_classes=16, width_mult=0.35, dtype=torch.float32)
    m.load_state_dict(from_jax_variables(variables))
    return m.eval()


def test_unfused_module_matches_flax(flax_model):
    variables, x, want = flax_model
    with torch.no_grad():
        got = _port(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("mode", ["kernel", "plain", "xla"])
def test_fused_forward_matches_flax(flax_model, mode):
    """'kernel' is the fused:pallas forward (its stride-1 blocks take the
    plain version on the CPU, its stride-2 blocks the convolutions),
    'plain' every block through the kernel's plain version, 'xla' the
    fused:xla forward (every block through the convolutions)."""
    variables, x, want = flax_model
    fused = _make_fused_apply(_port(variables), mode=mode,
                              compute_dtype=torch.float32)
    got = fused(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_xla_forward_matches_jax_fused_xla(flax_model):
    """The port's fused:xla forward against the JAX package's own fused:xla
    forward on the same (converted) weights: f32, 5e-4 and equal argmax, as
    tests/test_fused_block.py::test_full_model_fused_matches_flax."""
    from nnstreamer_tpu.models.mobilenet_v2 import (
        MobileNetV2 as FlaxMBV2,
        _make_fused_apply as jax_make_fused_apply,
    )

    variables, x, _ = flax_model
    jax_fused = jax_make_fused_apply(
        FlaxMBV2(num_classes=16, width_mult=0.35, dtype=jnp.float32),
        mode="xla", compute_dtype=jnp.float32)
    want = np.asarray(jax_fused(variables, jnp.asarray(x)))
    got = _make_fused_apply(_port(variables), mode="xla",
                            compute_dtype=torch.float32)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("mode,fused,conv,plain", [
    ("kernel", 17, 0, 0),
    ("xla", 0, 17, 0),
    ("plain", 0, 0, 17),
])
def test_fused_forward_routes_blocks(monkeypatch, mode, fused, conv, plain):
    """Which function each of the 17 blocks goes to: in 'kernel' mode all
    17, the 13 stride-1 and the 4 stride-2 blocks, to
    fused_inverted_residual, and inverted_residual_plain only from inside
    the kernel's wrapper (its CPU path), never from the forward; in
    'plain' mode (the kernel-mode forward's oracle) every block to
    inverted_residual_plain itself; in 'xla' mode every block to
    inverted_residual_conv."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import init_weights
    from nnstreamer_tpu_torch.ops import fused_block as fb

    calls = {"fused": [], "conv": [], "plain": [], "plain_outside": 0}
    inside = []

    def spy(name, real):
        def wrapped(x, folded, **kw):
            if name == "plain" and not inside:
                calls["plain_outside"] += 1
            calls[name].append(kw.get("stride", 1))
            inside.append(name)
            try:
                return real(x, folded, **kw)
            finally:
                inside.pop()
        return wrapped

    for name, attr in (("fused", "fused_inverted_residual"),
                       ("conv", "inverted_residual_conv"),
                       ("plain", "inverted_residual_plain")):
        monkeypatch.setattr(fb, attr, spy(name, getattr(fb, attr)))
    model = MobileNetV2(num_classes=8, width_mult=0.35, dtype=torch.float32)
    init_weights(model, 0)
    forward = _make_fused_apply(model.eval(), mode=mode,
                                compute_dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, 32, 32, 3)).astype(np.float32))
    out = forward(x)
    assert tuple(out.shape) == (1, 8) and bool(torch.isfinite(out).all())
    strides = [1] * 13 + [2] * 4  # each block once, whichever route
    assert sorted(calls["fused"]) == (strides if fused else [])
    assert sorted(calls["conv"]) == (strides if conv else [])
    assert len(calls["fused"]) == fused and len(calls["conv"]) == conv
    if mode == "kernel":  # the wrapper's CPU path, once per block
        assert calls["plain"] == calls["fused"]
        assert calls["plain_outside"] == 0
    else:
        assert len(calls["plain"]) == calls["plain_outside"] == plain
        assert sorted(calls["plain"]) == (strides if plain else [])


def test_params_npz_round_trip(flax_model, tmp_path):
    """custom=params:<npz> loads exactly what save_state_dict wrote."""
    from nnstreamer_tpu_torch.models import get_model

    variables, _, _ = flax_model
    path = str(tmp_path / "w.npz")
    save_state_dict(from_jax_variables(variables), path)
    b = get_model("mobilenet_v2", {"params": path, "size": "64",
                                   "width": "0.35", "classes": "16"},
                  device="cpu")
    ref = _port(variables).state_dict()
    for k, v in b.module.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_seed_init_is_deterministic_and_not_identity_bn():
    from nnstreamer_tpu_torch.models import get_model

    cfg = {"seed": "3", "size": "32", "width": "0.35", "classes": "8"}
    a = get_model("mobilenet_v2", cfg, device="cpu").module.state_dict()
    b = get_model("mobilenet_v2", cfg, device="cpu").module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.allclose(a["stem_bn.running_var"],
                              torch.ones_like(a["stem_bn.running_var"]))
    c = get_model("mobilenet_v2", dict(cfg, seed="4"),
                  device="cpu").module.state_dict()
    assert not torch.equal(a["stem_conv.weight"], c["stem_conv.weight"])


def test_zoo_caps_and_output_info():
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.types import TensorsInfo

    b = get_model("mobilenet_v2", {"size": "32", "width": "0.35",
                                   "classes": "8"}, device="cpu")
    assert b.input_info.dimensions_string() == "3:32:32"
    assert b.input_info.types_string() == "uint8"
    assert b.output_info.dimensions_string() == "8"
    out = b.infer_output(TensorsInfo.from_strings("3:32:32:4", "uint8"))
    assert out.tensors[0].np_shape() == (4, 8)
    x = torch.from_numpy(np.zeros((4, 32, 32, 3), np.uint8))
    assert tuple(b.apply_fn(x).shape) == (4, 8)


def test_preprocess_frames_cpu_equals_jax():
    from nnstreamer_tpu.models import preprocess_frames as jax_pre
    from nnstreamer_tpu_torch.models import preprocess_frames

    x = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), np.uint8)
    for scale in ("pm1", "unit"):
        want = np.asarray(jax_pre(jnp.asarray(x), scale))
        got = preprocess_frames(torch.from_numpy(x), scale).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got = preprocess_frames(torch.from_numpy(x[0]))
    assert tuple(got.shape) == (1, 8, 8, 3)
