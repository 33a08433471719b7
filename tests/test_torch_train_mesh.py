"""The sharded train step (``parallel/train.py`` ``mesh=``, ``tensor_trainer
custom=mesh:1[,tp:N]``) on the CPU, against the port's unsharded step and
the JAX package's ``make_train_step``.

MobileNet-v2 (width 0.35, 32 px, 4 classes) from the same flax variables
(flax's init, jitted), on three seeded batches of 8 frames, SGD with
momentum at lr 0.01. Its train step is chaotic: BatchNorm over a few
values, or over a nearly constant channel, has a gain in the hundreds, so
a weight moved by 1e-6 moves the second step's loss by 0.1 at float32. A
sum taken in another order (a dp row's, or XLA's) is such a move. So the
holds run in float64 (the layers, parameters, running statistics, the
classifier and the loss), where rounding is 1e-16, and:

  - dp 4 × tp 1 and dp 2 × tp 2 over ``cpu*4``, and dp 8 over ``cpu*8``:
    three steps against the port's unsharded step, each step's loss at
    1e-7 rel, the parameters at 1e-6 abs and the running statistics at
    1e-7 abs after every step; the replicas equal bit for bit;
  - the first step against the JAX package's unsharded ``make_train_step``
    with batch stats, and dp 8 against its ``make_train_step(mesh=
    make_mesh(tp=1))`` (dp 8 over the conftest's 8 CPU devices), flax
    under ``jax.enable_x64``: the loss at 1e-5 rel, the parameters at 2e-5
    abs, the running statistics at 2e-6 abs (flax's Dense computes in
    float32, the one float32 stage left). The later steps are not held to
    the JAX package's: its own unsharded and mesh steps are 7.6e-5 apart
    in loss at the third step, and the two packages' unsharded steps 0.025
    (the chaos above, from that float32 Dense), while every port step
    here stays within 1e-8 of the port's unsharded one;
  - per-shard statistics (the reduction switched off) miss the unsharded
    first step's loss by more than 1e-3, so the whole-batch sync is what
    the holds see;
  - a batch the dp width does not divide raises, as ``shard_batch`` does
    in the JAX package;
  - ``tensor_trainer custom=mesh:1`` trains through the element:
    ``datareposrc ! tensor_trainer`` on the linear model of
    tests/test_torch_training.py (float32; well-conditioned), its reports
    against the unsharded line's and the JAX line's at 1e-5 abs + 1e-4
    rel, under ``mesh:1`` and ``mesh:1,tp:2``; and MobileNet-v2 (the zoo's
    bfloat16) under ``custom=mesh:1,tp:2``: finite losses, equal
    replicas, the module validation reads holding dp row 0's weights, and
    under ``tp:4`` (no sum across rows) losses equal to the unsharded
    trainer's.

No element-name counter and no lock witness are read here; both packages'
counters are emptied at the module's end.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import jit_init  # noqa: E402
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.pipeline import parse_launch as jax_parse_launch  # noqa: E402
from nnstreamer_tpu_torch.models import preprocess_frames  # noqa: E402
from nnstreamer_tpu_torch.models.convert import from_jax_variables  # noqa: E402
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2  # noqa: E402
from nnstreamer_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from nnstreamer_tpu_torch.parallel.train import make_train_step  # noqa: E402
from nnstreamer_tpu_torch.pipeline import parse_launch  # noqa: E402
from nnstreamer_tpu_torch.trainers import TrainerProperties  # noqa: E402
from nnstreamer_tpu_torch.trainers.cuda_trainer import CudaTrainer  # noqa: E402
from test_torch_training import mlp_models, write_repo  # noqa: E402

SIZE, BATCH, CLASSES, WIDTH, LR, STEPS = 32, 8, 4, 0.35, 0.01, 3
MESHES = {"dp4x1": (4, 1), "dp2x2": (2, 2)}


def _batches():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), dtype=np.uint8),
             rng.integers(0, CLASSES, BATCH).astype(np.int32))
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def flax_run():
    """The flax variables (the shared jitted init) and the JAX package's
    unsharded and dp-8 mesh steps over the batches in float64 compute:
    (variables, losses, state after, mesh losses, mesh state after)."""
    import optax

    from nnstreamer_tpu.models import make_train_apply
    from nnstreamer_tpu.models.mobilenet_v2 import MobileNetV2 as FlaxMBV2
    from nnstreamer_tpu.parallel import make_mesh as jax_make_mesh
    from nnstreamer_tpu.parallel import shard_batch
    from nnstreamer_tpu.parallel.train import make_train_step as jax_step

    init = FlaxMBV2(num_classes=CLASSES, width_mult=WIDTH,
                    dtype=jnp.float32)
    v = jax.device_get(jit_init(init, 0, jnp.zeros((1, SIZE, SIZE, 3))))
    out = [v]
    with jax.enable_x64(True):
        # every variable in float64 but the classifier's (flax's Dense
        # computes in float32, as the port's Linear does)
        v = jax.tree_util.tree_map_with_path(
            lambda path, a: a if "Dense_0" in jax.tree_util.keystr(path)
            else np.asarray(a, np.float64), v)
        model = FlaxMBV2(num_classes=CLASSES, width_mult=WIDTH,
                         dtype=jnp.float64)
        apply = make_train_apply(model)
        for mesh in (None, jax_make_mesh(tp=1)):
            opt = optax.sgd(LR, momentum=0.9)
            step = jax_step(apply, opt, mesh=mesh, has_batch_stats=True)
            state = jax.tree_util.tree_map(jnp.array, v)
            if mesh is not None:
                step = step.jit_with(state)
            opt_state = opt.init(state["params"])
            losses, states = [], []
            for x, y in _batches():
                batch = (x, y) if mesh is None else shard_batch(mesh, (x, y))
                if mesh is None:
                    state, opt_state, m = step(state, opt_state, batch)
                else:
                    with mesh:
                        state, opt_state, m = step(state, opt_state, batch)
                losses.append(float(m["loss"]))
                states.append(from_jax_variables(jax.device_get(state)))
            out.append((losses, states))
    return tuple(out)


def _model(v):
    m = _float64(MobileNetV2(num_classes=CLASSES, width_mult=WIDTH))
    m.load_state_dict(from_jax_variables(v))
    return m


def _float64(m):
    """Layers, parameters and running statistics in float64."""
    m = m.double()
    for sub in m.modules():
        if isinstance(getattr(sub, "dtype", None), torch.dtype):
            sub.dtype = torch.float64
    return m


def _train_apply(m):
    def train_apply(frames):
        new_state = []
        return m(preprocess_frames(frames, "pm1", m.dtype), new_state), \
            new_state
    return train_apply


def _opt(m):
    return torch.optim.SGD(m.parameters(), lr=LR, momentum=0.9)


def _template():
    m = _float64(MobileNetV2(num_classes=CLASSES, width_mult=WIDTH))
    return _train_apply(m), m


def _run(v, mesh=None):
    """((losses, state dicts after each step), the step) of the port's
    step over the batches."""
    m = _model(v)
    step = make_train_step(_train_apply(m), _opt(m), mesh=mesh,
                           has_batch_stats=True, module=m,
                           replicate=_template)
    losses, states = [], []
    for x, y in _batches():
        losses.append(float(step((torch.from_numpy(x),
                                  torch.from_numpy(y)))["loss"]))
        states.append({k: t.clone() for k, t in m.state_dict().items()})
    return (losses, states), step


def _cpu_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=[torch.device("cpu")] * (dp * tp))


def _max_diff(a, b, sel):
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a if sel(k))


def _stats(k):
    return "running" in k


def _params(k):
    return "running" not in k and "num_batches" not in k


def _replicas_equal(step):
    """Every copy of a leaf equals dp row 0's at its tp column (a
    replicated leaf's copies all equal position (0, 0)'s), bit for bit."""
    return all(torch.equal(leaf.shards[i][j],
                           leaf.shards[0][j if leaf.dim is not None else 0])
               for leaf in step.placed.values()
               for i in range(step.dp) for j in range(step.tp))


@pytest.fixture(scope="module")
def unsharded(flax_run):
    return _run(flax_run[0])[0]


def _close(got, want, i, loss_rel, params, stats):
    return (got[0][i] == pytest.approx(want[0][i], rel=loss_rel)
            and _max_diff(got[1][i], want[1][i], _params) <= params
            and _max_diff(got[1][i], want[1][i], _stats) <= stats)


MESH_CASES = dict(MESHES, dp8x1=(8, 1))


@pytest.fixture(scope="module")
def mesh_run(flax_run):
    """name -> the port's run over that mesh, each run once."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _run(flax_run[0], _cpu_mesh(*MESH_CASES[name]))
        return runs[name]

    return get


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_steps_match_the_unsharded_step(name, mesh_run, unsharded):
    got, step = mesh_run(name)
    for i in range(STEPS):
        assert _close(got, unsharded, i, 1e-7, 1e-6, 1e-7), i
    assert _replicas_equal(step)


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_first_mesh_step_matches_jax(name, flax_run, mesh_run, unsharded):
    _, jax_unsharded, jax_mesh = flax_run
    got, _ = mesh_run(name)
    assert _close(got, jax_unsharded, 0, 1e-5, 2e-5, 2e-6)
    assert _close(unsharded, jax_unsharded, 0, 1e-5, 2e-5, 2e-6)
    if MESH_CASES[name][0] == len(jax.devices()):
        assert _close(got, jax_mesh, 0, 1e-5, 2e-5, 2e-6)


def test_batchnorm_statistics_are_the_whole_batch(flax_run, unsharded,
                                                  monkeypatch):
    """Without the cross-row sums (each row normalizing by its own two
    frames) the first step's loss misses the unsharded step's."""
    import contextlib

    import nnstreamer_tpu_torch.models as models

    monkeypatch.setattr(models, "reduced_batch_stats",
                        lambda fn: contextlib.nullcontext())
    (losses, _), _ = _run(flax_run[0], _cpu_mesh(4, 1))
    assert abs(losses[0] - unsharded[0][0]) > 1e-3


def test_uneven_batch_raises(flax_run):
    m = _model(flax_run[0])
    step = make_train_step(None, _opt(m), mesh=_cpu_mesh(4, 1),
                           has_batch_stats=True, module=m,
                           replicate=_template)
    x, y = _batches()[0]
    with pytest.raises(ValueError, match="does not divide"):
        step((torch.from_numpy(x[:6]), torch.from_numpy(y[:6])))


def test_mesh_step_needs_the_module_and_a_template():
    m = MobileNetV2(num_classes=CLASSES, width_mult=WIDTH)
    with pytest.raises(ValueError, match="module= .* replicate="):
        make_train_step(_train_apply(m), _opt(m), mesh=_cpu_mesh(2, 1))


def _trainer_reports(parse, data, meta, model, custom, ckpt):
    p = parse(
        f"datareposrc location={data} json={meta} epochs=2 ! "
        f"tensor_trainer framework=jax model-config={model} "
        f"model-save-path={ckpt} num-training-samples=16 epochs=2 "
        f"custom={custom} ! tensor_sink name=out")
    p.run(timeout=60)
    return np.stack([np.asarray(b.tensors[0]) for b in p["out"].collected])


def test_trainer_element_trains_over_the_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*4")
    data, meta = write_repo(tmp_path, n=16)
    jmodel, tmodel = mlp_models(tmp_path)
    base = "batch:8,lr:0.05,device:cpu"
    want = _trainer_reports(jax_parse_launch, data, meta, jmodel, base,
                            tmp_path / "jax.msgpack")
    off = _trainer_reports(parse_launch, data, meta, tmodel, base,
                           tmp_path / "off.npz")
    for custom in ("mesh:1", "mesh:1,tp:2"):
        got = _trainer_reports(parse_launch, data, meta, tmodel,
                               f"{base},{custom}", tmp_path / "mesh.npz")
        assert got.shape == want.shape == (2, 4, 1, 1)
        np.testing.assert_allclose(got, off, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def _mobilenet_trainer(**extra):
    tr = CudaTrainer()
    props = TrainerProperties(
        model_config="mobilenet_v2", num_training_samples=100,
        custom={"batch": "8", "size": "32", "width": "0.35",
                "classes": "4", "seed": "0", "lr": "0.01", "device": "cpu",
                **extra})
    tr.create(props)
    tr.start(lambda e: None)
    rng = np.random.default_rng(3)
    means = rng.integers(32, 224, (4, 3))
    losses = []
    for i in range(24):
        y = np.zeros(4, np.float32)
        y[i % 4] = 1.0
        x = np.clip(means[i % 4] + rng.normal(0, 16, (32, 32, 3)), 0, 255)
        tr.push_data([x.astype(np.uint8), y])
        if i % 8 == 7:
            losses.append(props.training_loss)
    return tr, losses


def test_mobilenet_trainer_over_dp_and_tp(monkeypatch):
    """The zoo's bfloat16 MobileNet-v2 through the trainer under
    ``custom=mesh:1,tp:2`` over ``cpu*4`` (dp 2 × tp 2): three steps with
    finite losses, equal replicas, and the module the validation reads
    holding dp row 0's weights. (Its losses are not held to the unsharded
    trainer's: at bfloat16 one flipped rounding in a BatchNorm of this
    step moves the first loss by 10%; the float64 holds above are the
    comparison.) Under ``tp:4`` (dp 1) nothing is summed across rows, and
    the losses equal the unsharded trainer's exactly."""
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*4")
    tr, losses = _mobilenet_trainer(mesh="1", tp="2")
    step = tr._step
    assert (step.dp, step.tp) == (2, 2) and tr.stats["steps"] == 3
    assert all(np.isfinite(losses))
    assert _replicas_equal(step)
    tr4, losses4 = _mobilenet_trainer(mesh="1", tp="4")
    assert (tr4._step.dp, tr4._step.tp) == (1, 4)
    assert losses4 == _mobilenet_trainer()[1]
    state = tr._bundle.module.state_dict()
    for key, leaf in step.placed.items():
        assert torch.equal(state[key], leaf.gather(0, state[key].device))
