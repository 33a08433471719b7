"""Training SSD-MobileNet-v2, DeepLab-v3, PoseNet and YOLOv8 in the port
against the JAX package's trainer (the counterparts of the JAX models'
``make_train_apply`` forwards through ``tensor_trainer``). This file runs
DeepLab-v3 and PoseNet; tests/test_torch_train_detect.py runs SSD and
YOLOv8 through the same checks, defined here.

Each model is built small (64 px, narrow) on both sides from the same
variables: flax's tree filled from ``np.random.default_rng(0)``
(:func:`_numpy_init`) in the JAX trainer, carried across by
``models.convert.from_jax_variables`` as the port's ``params:``. Both
trainers then take two ``loss:mse`` steps of batch 4 on the same
numpy-seeded frames and head-shaped labels.

The steps are held in float64 (the flax modules built with
``dtype=float64`` under ``jax.enable_x64`` and their variables cast; the
port's module doubled and its layers set to float64; in both packages
the heads stay float32 as written). These train steps are
ill-conditioned, as MobileNet-v2's is (tests/test_torch_train_mesh.py):
BatchNorm over a nearly constant channel, or over 4 values where SSD's
extra blocks reach 1x1 maps, has a gain in the thousands, and the float32
heads' rounding (the two packages sum in other orders) reaches every
gradient through it. At float32 the two packages' first updates lie up to
6% apart and PoseNet's second losses 3%; at float64, at most 0.7% and
0.08% (SSD), so the holds are:
  - the first step's loss: 1e-6 relative (the loss is a float32 sum);
  - the running statistics after the first step: 1e-5 abs;
  - each parameter after the first step: its distance from the JAX
    trainer's within 1% of the JAX trainer's own update of it, + 1e-6 (a
    parameter whose update is rounding noise, such as the scale of a
    BatchNorm that another BatchNorm follows, is held by the absolute
    term);
  - the second step's loss: 1e-3 relative. The second step's weights are
    not held to the JAX trainer's: SSD's move up to 97% of their update
    apart at float64 (the chaos above, from the first step's rounding).

``softmax_xent`` on a dense head: the trainer's labels become one int a
sample and optax's loss wants labels of the logits' shape less the class
axis, so the JAX trainer raises ``ValueError``; the port raises the same.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.trainers import TrainerProperties as JaxProps  # noqa: E402
from nnstreamer_tpu.trainers.jax_trainer import JaxTrainer  # noqa: E402
from nnstreamer_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
    save_state_dict,
)
from nnstreamer_tpu_torch.trainers import TrainerProperties  # noqa: E402
from nnstreamer_tpu_torch.trainers.cuda_trainer import CudaTrainer  # noqa: E402

SIZE, BATCH = 64, 4

#: zoo name → (the JAX module's file, its flax class, the customs)
MODELS = {
    "ssd_mobilenet": ("ssd_mobilenet", "SSDMobileNetV2",
                      {"width": "0.35", "classes": "4"}),
    "deeplab_v3": ("deeplab_v3", "DeepLabV3",
                   {"width": "0.35", "classes": "4"}),
    "posenet": ("posenet", "PoseNet", {"width": "0.35", "keypoints": "4"}),
    "yolov8": ("yolov8", "YoloV8", {"classes": "4"}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one intra-op thread: these small convolutions gain nothing
    from the pool, and under the test run's parallel workers a pool of 8
    per worker stalls in its barriers (the steps ran 20x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _custom(name, **extra):
    return dict(MODELS[name][2], size=str(SIZE), batch=str(BATCH), seed="0",
                lr="0.01", loss="mse", device="cpu") | extra


def _numpy_init(model, seed, dummy):
    """Variables of flax's tree, made with ``np.random.default_rng(seed)``
    instead of flax's initializers (whose jitted init costs a compile a
    model): He-normal kernels over their fan-in, biases N(0, 0.1),
    BatchNorm scales U(0.8, 1.2), biases and means N(0, 0.1), variances
    U(0.8, 1.2)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros(dummy.shape, dummy.dtype))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        key = jax.tree_util.keystr(path)
        if key.endswith("['kernel']"):
            fan_in = int(np.prod(sd.shape[:-1]))
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), sd.shape)
        elif key.endswith("['scale']") or key.endswith("['var']"):
            a = rng.uniform(0.8, 1.2, sd.shape)
        else:  # biases, means
            a = rng.normal(0.0, 0.1, sd.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax(mp, dtype):
    """The JAX zoo's builders make their flax modules in ``dtype``, their
    variables by :func:`_numpy_init`."""
    import importlib

    import nnstreamer_tpu.models as jm

    mp.setattr(jm, "_init_on_cpu", _numpy_init)
    for file, cls, _ in MODELS.values():
        mod = importlib.import_module(f"nnstreamer_tpu.models.{file}")
        mp.setattr(mod, cls, functools.partial(getattr(mod, cls),
                                               dtype=dtype))


def _label_shape(name):
    """One sample's label: the shape of the head the loss reads."""
    g = -(-SIZE // 16)
    if name == "ssd_mobilenet":
        from nnstreamer_tpu_torch.models.ssd_mobilenet import num_anchors

        return (num_anchors(SIZE), 1, 4)
    if name == "deeplab_v3":
        return (SIZE, SIZE, 4)
    if name == "posenet":
        return (g, g, 4)
    from nnstreamer_tpu_torch.models.yolov8 import num_cells

    return (num_cells(SIZE), 8)


def _samples(name, n=2 * BATCH, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8),
             rng.normal(0.0, 1.0, _label_shape(name)).astype(np.float32)]
            for _ in range(n)]


def _run(tr, props, samples):
    tr.start(lambda e: None)
    losses = []
    for i, s in enumerate(samples):
        tr.push_data(s)
        if i % BATCH == BATCH - 1:
            losses.append(props.training_loss)
    return losses


def _set_dtype(module, dtype):
    """The module's weights and every layer's compute type in ``dtype``."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


def _port_trainer(name, npz=None, dtype=torch.float32, **extra):
    """The port's trainer on ``npz``'s weights (the zoo's ``seed:0`` init
    when None), its module and layers in ``dtype``."""
    if npz is not None:
        extra["params"] = npz
    props = TrainerProperties(model_config=name, num_training_samples=100,
                              custom=_custom(name, **extra))
    tr = CudaTrainer()
    tr.create(props)
    _set_dtype(tr._bundle.module, dtype)
    tr._step = tr._make_step()  # a mesh step places the converted weights
    for row in getattr(tr._step, "_rows", ()):  # a mesh step's templates
        _set_dtype(row, dtype)
    return tr, props


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per model, lazily: the JAX trainer's two float64 steps and the
    variables it started from, as an npz for the port (npz, the two
    losses, the state dict before and after the first step)."""
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            _flax(mp, jnp.float64)
            jt = JaxTrainer()
            jt.create(JaxProps(model_config=name, num_training_samples=100,
                               custom=_custom(name)))
            jt._params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jt._params)
            jt._opt_state = jt._opt.init(jt._params["params"])
            before = from_jax_variables(jax.device_get(jt._params),
                                        model=name)
            npz = str(tmp_path_factory.mktemp(name) / "flax.npz")
            save_state_dict(before, npz)
            samples = _samples(name)
            losses = _run(jt, jt.props, samples[:BATCH])
            after = from_jax_variables(jax.device_get(jt._params),
                                       model=name)
            losses += _run(jt, jt.props, samples[BATCH:])
        cache[name] = (npz, losses, before, after)
        return cache[name]

    return run


def two_mse_steps(jax_runs, name):
    """Two float64 ``loss:mse`` steps from the same variables (see the
    module docstring for the tolerances)."""
    npz, want_losses, before, want = jax_runs(name)
    tr, props = _port_trainer(name, npz, torch.float64)
    samples = _samples(name)
    losses = _run(tr, props, samples[:BATCH])
    got = {k: v.clone() for k, v in tr._bundle.module.state_dict().items()}
    losses += _run(tr, props, samples[BATCH:])
    assert tr.stats["steps"] == 2
    assert losses[0] == pytest.approx(want_losses[0], rel=1e-6)
    assert losses[1] == pytest.approx(want_losses[1], rel=1e-3)
    assert got.keys() == want.keys()
    for k in got:
        if "num_batches" in k:
            continue
        g, w = got[k].double(), want[k].double()
        if "running" in k:
            assert torch.allclose(g, w, atol=1e-5, rtol=0), k
            continue
        moved = float((w - before[k].double()).norm())
        assert float((g - w).norm()) <= 1e-2 * moved + 1e-6, \
            (k, float((g - w).norm()), moved)


def softmax_xent_fails_in_both(name, monkeypatch):
    """Integer labels against a head of more than two dimensions: the JAX
    trainer's optax loss raises ``ValueError``, and so does the port's."""
    samples = [[x, np.eye(4, dtype=np.float32)[i % 4]]
               for i, (x, _) in enumerate(_samples(name, BATCH))]
    _flax(monkeypatch, jnp.float32)
    jt = JaxTrainer()
    jt.create(JaxProps(model_config=name, num_training_samples=100,
                       custom=_custom(name, loss="softmax_xent")))
    jt.start(lambda e: None)
    with pytest.raises(ValueError):
        for s in samples:
            jt.push_data(s)
    tr, _ = _port_trainer(name, loss="softmax_xent")
    tr.start(lambda e: None)
    with pytest.raises(ValueError, match="loss:mse"):
        for s in samples:
            tr.push_data(s)


def mesh_step_takes_the_model(name, monkeypatch):
    """``custom=mesh:1`` over two CPU positions (dp 2), in float64 on the
    zoo's ``seed:0`` weights: the two steps' losses, weights and running
    statistics are the unsharded trainer's at 1e-6 rel (+ 1e-7 abs; the
    heads compute in float32), the BatchNorms taking the whole batch's
    statistics."""
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*2")
    runs = []
    for extra in ({}, {"mesh": "1"}):
        tr, props = _port_trainer(name, dtype=torch.float64, **extra)
        runs.append((_run(tr, props, _samples(name)),
                     tr._bundle.module.state_dict()))
    (plain, s_plain), (mesh, s_mesh) = runs
    assert mesh == pytest.approx(plain, rel=1e-6)  # float32 losses
    for k in s_plain:
        assert torch.allclose(s_mesh[k].double(), s_plain[k].double(),
                              atol=1e-7, rtol=1e-6), k


def pp_bundle_trains_its_raw_model(name):
    """A ``postproc:pp`` bundle trains through the raw model's forward,
    as the JAX package's does: the same losses and weights as the raw
    bundle's trainer."""
    runs = []
    for extra in ({}, {"postproc": "pp"}):
        tr, props = _port_trainer(name, **extra)
        runs.append((_run(tr, props, _samples(name)),
                     tr._bundle.module.state_dict()))
    assert runs[1][0] == runs[0][0]
    for k, v in runs[0][1].items():
        assert torch.equal(runs[1][1][k], v), k


def validation_runs_the_trained_weights(name):
    """With ``fused:xla`` validation runs the BN-folded forward: after the
    steps it folds the trained weights, so its outputs equal a fresh
    fold's of the same module."""
    import importlib

    tr, props = _port_trainer(name, fused="xla")
    x = torch.from_numpy(np.stack([s[0] for s in _samples(name, 2, 5)]))
    first = tr._bundle.apply_fn(x)
    _run(tr, props, _samples(name))
    mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{name}")
    fresh = mod._make_fused_apply(tr._bundle.module, mode="xla")
    from nnstreamer_tpu_torch.models import preprocess_frames

    want = fresh(preprocess_frames(x, "pm1", torch.float32))
    got = tr._bundle.apply_fn(x)
    got, want, first = (o[0] if isinstance(o, tuple) else o
                        for o in (got, want, first))
    assert torch.equal(got, want)
    assert not torch.equal(got, first)


# -- DeepLab-v3 and PoseNet (SSD and YOLOv8: tests/test_torch_train_detect.py)

NAMES = ["deeplab_v3", "posenet"]


@pytest.mark.parametrize("name", NAMES)
def test_two_mse_steps_match_the_jax_trainer(jax_runs, name):
    two_mse_steps(jax_runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_softmax_xent_on_a_dense_head_fails_in_both(name, monkeypatch):
    softmax_xent_fails_in_both(name, monkeypatch)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_step_takes_the_model(name, monkeypatch):
    mesh_step_takes_the_model(name, monkeypatch)


def test_validation_runs_the_trained_weights():
    validation_runs_the_trained_weights("deeplab_v3")
