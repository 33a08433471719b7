"""The port's training path against the JAX package's: datareposrc,
datareposink, tensor_trainer and the trainer backend (counterparts of
tests/test_training.py and the trainer cases of
tests/test_trace_checkpoint.py), run through both packages on the same
numpy-seeded inputs.

Tolerances, case by case:
  - datarepo samples and sink files: byte-equal;
  - the MLP (float32, both packages on the same numpy weights): per-epoch
    losses and accuracies and the final weights at 1e-5 abs + 1e-4 rel;
  - MobileNet-v2 at float32, one train step from the same flax variables:
    the loss and the running statistics against the JAX package's step at
    1e-4 rel and 1e-4 abs, each parameter's update against −lr times
    ``jax.grad`` of the same loss within 5% of its norm + 1e-5 (the
    gradient of a BatchNorm bias that another BatchNorm follows is
    rounding noise). The step is ill-conditioned at float32 (BatchNorm
    over 4 values at 1x1, the variance as E[x²] − E[x]²): both packages'
    gradients lie up to 2% from a float64 gradient, and the JAX step's
    own update lies 17% from ``jax.grad`` at the stem (returning the new
    batch statistics changes how XLA fuses the reductions), so the update
    is held to ``jax.grad``;
  - MobileNet-v2 in the zoo's bfloat16 through both trainers: each
    quantity (each step's loss, the running statistics, the weights) no
    farther from the JAX trainer's than twice the JAX trainer's own
    distance from the same steps at float32 (the bf16 noise floor);
  - the refold: float32 at 2e-3 abs + 1e-3 rel and equal argmax (see the
    case); the trainer's validation forward equal to a fresh fold's,
    exactly;
  - save and serve: the filter's logits equal to the trainer's, exactly.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import jit_init  # noqa: E402
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
    worker_torch_threads,
)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nnstreamer_tpu.pipeline import parse_launch as jax_parse_launch  # noqa: E402
from nnstreamer_tpu.trainers import TrainerProperties as JaxProps  # noqa: E402
from nnstreamer_tpu.trainers.jax_trainer import JaxTrainer  # noqa: E402
from nnstreamer_tpu_torch.buffer import Buffer  # noqa: E402
from nnstreamer_tpu_torch.models import preprocess_frames  # noqa: E402
from nnstreamer_tpu_torch.models.convert import (  # noqa: E402
    from_jax_variables,
    save_state_dict,
)
from nnstreamer_tpu_torch.pipeline import parse_launch  # noqa: E402
from nnstreamer_tpu_torch.trainers import (  # noqa: E402
    TrainerEvent,
    TrainerProperties,
)
from nnstreamer_tpu_torch.trainers.cuda_trainer import CudaTrainer  # noqa: E402

CAPS_MLP = (
    "other/tensors,format=static,num_tensors=2,dimensions=8.4,"
    "types=float32.float32,framerate=0/1"
)
FEAT, CLASSES = 8, 4


def write_repo(tmp_path, n=12, feat=FEAT, classes=CLASSES, seed=1):
    """An n-sample (features, one-hot label) repo pair, as
    tests/test_training.py writes it."""
    rng = np.random.default_rng(seed)
    data = tmp_path / "train.data"
    meta = tmp_path / "train.json"
    with open(data, "wb") as f:
        for i in range(n):
            x = rng.normal(size=feat).astype(np.float32)
            y = np.zeros(classes, np.float32)
            y[i % classes] = 1.0
            f.write(x.tobytes())
            f.write(y.tobytes())
    meta.write_text(json.dumps({"gst_caps": CAPS_MLP, "total_samples": n,
                                "sample_size": (feat + classes) * 4}))
    return data, meta


def mlp_models(tmp_path, feat=FEAT, classes=CLASSES, seed=0):
    """(jax_file, torch_file): one linear model, ``x @ w + b``, in each
    package's array library on the same numpy weights."""
    rng = np.random.default_rng(seed)
    wpath = tmp_path / "mlp_weights.npz"
    np.savez(wpath, w=(rng.normal(size=(feat, classes)) * 0.1)
             .astype(np.float32), b=np.zeros(classes, np.float32))
    files = []
    for lib, asarray in (("jax.numpy as jnp", "jnp.asarray"),
                         ("torch", "torch.from_numpy")):
        name = lib.split()[0].split(".")[0]
        path = tmp_path / f"mlp_{name}.py"
        path.write_text(
            f"import numpy as np\nimport {lib}\n"
            "def make_model(custom):\n"
            f"    z = np.load({str(wpath)!r})\n"
            f"    params = {{'w': {asarray}(z['w']), 'b': {asarray}(z['b'])}}\n"
            "    def apply_fn(p, x):\n"
            "        return x @ p['w'] + p['b']\n"
            "    return apply_fn, params\n")
        files.append(path)
    return files


def mlp_sample(rng):
    """Features and the one-hot argmax of the first four (learnable)."""
    x = rng.normal(size=FEAT).astype(np.float32)
    y = np.zeros(CLASSES, np.float32)
    y[int(np.argmax(x[:4]))] = 1.0
    return [x, y]


def _cpu(custom):
    return dict(custom, device="cpu")


# -- datarepo: the reference's five cases, plus a flexible repo, through
# both packages with byte-equal samples ---------------------------------------

def _samples(parse, line):
    p = parse(line)
    p.run(timeout=30)
    return [[np.asarray(t) for t in b.tensors] for b in p["out"].collected]


def _same_samples(line):
    want = _samples(jax_parse_launch, line)
    got = _samples(parse_launch, line)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [t.dtype for t in g] == [t.dtype for t in w]
        assert [t.shape for t in g] == [t.shape for t in w]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(g, w))
    return got


class TestDataRepo:
    def test_src_reads_samples(self, tmp_path):
        data, meta = write_repo(tmp_path, n=6)
        got = _same_samples(f"datareposrc location={data} json={meta} "
                            "! tensor_sink name=out")
        assert len(got) == 6
        assert got[0][0].shape == (8,) and got[0][1].shape == (4,)

    def test_src_range_and_epochs(self, tmp_path):
        data, meta = write_repo(tmp_path, n=10)
        got = _same_samples(
            f"datareposrc location={data} json={meta} start-sample-index=2 "
            "stop-sample-index=5 epochs=3 ! tensor_sink name=out")
        assert len(got) == 4 * 3

    def test_src_shuffle_deterministic(self, tmp_path):
        data, meta = write_repo(tmp_path, n=8)
        line = (f"datareposrc location={data} json={meta} is-shuffle=true "
                "seed=7 epochs=2 ! tensor_sink name=out")
        a, b = _same_samples(line), _samples(parse_launch, line)
        assert [s[0].tobytes() for s in a] == [s[0].tobytes() for s in b]
        # shuffled: the first epoch is not the file's order
        in_order = _samples(parse_launch, f"datareposrc location={data} "
                            f"json={meta} ! tensor_sink name=out")
        assert [s[0].tobytes() for s in a[:8]] != \
            [s[0].tobytes() for s in in_order]

    def test_sink_src_roundtrip(self, tmp_path):
        data, meta = write_repo(tmp_path, n=5)
        outs = {}
        for name, parse in (("jax", jax_parse_launch), ("torch", parse_launch)):
            out_data = tmp_path / f"copy_{name}.data"
            out_meta = tmp_path / f"copy_{name}.json"
            parse(f"datareposrc location={data} json={meta} ! "
                  f"datareposink location={out_data} json={out_meta}"
                  ).run(timeout=30)
            outs[name] = (out_data.read_bytes(), json.loads(out_meta.read_text()))
        assert outs["torch"] == outs["jax"]
        assert outs["torch"][1]["total_samples"] == 5
        assert outs["torch"][1]["sample_size"] == 48
        assert outs["torch"][0] == data.read_bytes()

    def test_src_bad_range_errors(self, tmp_path):
        data, meta = write_repo(tmp_path, n=4)
        line = (f"datareposrc location={data} json={meta} "
                "start-sample-index=3 stop-sample-index=9 ! tensor_sink name=out")
        for parse in (jax_parse_launch, parse_launch):
            with pytest.raises(Exception, match="range"):
                parse(line).play()

    def test_flexible_repo(self, tmp_path):
        """A flexible repo (sample_offset, tensor_size, tensor_count):
        samples of 1 to 3 tensors of varying sizes, in a sample range."""
        rng = np.random.default_rng(4)
        data, meta = tmp_path / "flex.data", tmp_path / "flex.json"
        offsets, sizes, counts = [], [], []
        with open(data, "wb") as f:
            for i in range(6):
                offsets.append(f.tell())
                counts.append(1 + i % 3)
                for _ in range(counts[-1]):
                    raw = rng.integers(0, 256, int(rng.integers(1, 40)),
                                       dtype=np.uint8).tobytes()
                    f.write(raw)
                    sizes.append(len(raw))
        meta.write_text(json.dumps({
            "gst_caps": "other/tensors,format=flexible,framerate=0/1",
            "total_samples": 6, "sample_offset": offsets,
            "tensor_size": sizes, "tensor_count": counts}))
        got = _same_samples(f"datareposrc location={data} json={meta} "
                            "start-sample-index=1 stop-sample-index=4 "
                            "! tensor_sink name=out")
        assert [len(s) for s in got] == counts[1:5]


# -- the trainer: the reference's cases on the port ----------------------------

def _trainer(model, **props):
    custom = _cpu(props.pop("custom", {}))
    tr = CudaTrainer()
    props = TrainerProperties(model_config=str(model), custom=custom, **props)
    tr.create(props)
    return tr, props


class TestCudaTrainer:
    def test_trainer_learns_and_events(self, tmp_path):
        _, model = mlp_models(tmp_path)
        tr, props = _trainer(model, num_training_samples=16, num_epochs=2,
                             custom={"batch": "8", "lr": "0.1"})
        events = []
        tr.start(events.append)
        rng = np.random.default_rng(3)
        for _ in range(32):
            tr.push_data(mlp_sample(rng))
        assert events.count(TrainerEvent.EPOCH_COMPLETION) == 2
        assert TrainerEvent.TRAINING_COMPLETION in events
        assert props.epoch_count == 2
        assert props.training_loss > 0
        # one upload of each stacked column a step, one host read a step
        assert tr.stats["steps"] == 4 and tr.stats["syncs"] == 4
        assert tr.stats["h2d_bytes"] == 4 * 8 * (FEAT * 4 + 8)

    def test_validation_split(self, tmp_path):
        _, model = mlp_models(tmp_path)
        tr, props = _trainer(model, num_training_samples=16,
                             num_validation_samples=8, num_epochs=2,
                             custom={"batch": "8", "lr": "0.1"})
        events = []
        tr.start(events.append)
        rng = np.random.default_rng(5)
        for _ in range(48):  # 2 epochs × (16 train + 8 val)
            tr.push_data(mlp_sample(rng))
        assert events.count(TrainerEvent.EPOCH_COMPLETION) == 2
        assert TrainerEvent.TRAINING_COMPLETION in events
        assert props.validation_loss > 0
        assert 0 <= props.validation_accuracy <= 1
        assert not tr._val_batch  # drained every epoch
        assert tr.stats["steps"] == 4 and tr.stats["val_batches"] == 2

    def test_save_and_reload(self, tmp_path):
        _, model = mlp_models(tmp_path)
        ckpt = tmp_path / "trained.msgpack"
        tr, _ = _trainer(model, num_training_samples=4,
                         custom={"batch": "4"})
        tr.start(lambda e: None)
        for i in range(4):
            y = np.zeros(4, np.float32)
            y[0] = 1.0
            tr.push_data([np.ones(8, np.float32) * i, y])
        tr.save(str(ckpt))
        # the exact file named (np.savez alone would append .npz)
        assert ckpt.stat().st_size > 0
        assert not (tmp_path / "trained.msgpack.npz").exists()

    def test_push_data_takes_torch_cpu_tensors(self, tmp_path):
        _, model = mlp_models(tmp_path)
        runs = []
        for wrap in (np.asarray, torch.from_numpy):
            tr, props = _trainer(model, num_training_samples=8,
                                 custom={"batch": "4", "lr": "0.1"})
            tr.start(lambda e: None)
            rng = np.random.default_rng(6)
            for _ in range(8):
                tr.push_data([wrap(t) for t in mlp_sample(rng)])
            runs.append(props.training_loss)
        assert runs[0] == runs[1]


class TestTrainerPipeline:
    def test_datarepo_to_trainer(self, tmp_path):
        """The reference line on the port; its reports have the JAX
        line's shapes and dtypes."""
        data, meta = write_repo(tmp_path, n=16)
        jmodel, tmodel = mlp_models(tmp_path)
        reports = {}
        for name, parse, model in (("jax", jax_parse_launch, jmodel),
                                   ("torch", parse_launch, tmodel)):
            ckpt = tmp_path / f"model_{name}.msgpack"
            p = parse(
                f"datareposrc location={data} json={meta} epochs=2 ! "
                f"tensor_trainer framework=jax model-config={model} "
                f"model-save-path={ckpt} num-training-samples=16 epochs=2 "
                "custom=batch:8,lr:0.05,device:cpu ! tensor_sink name=out")
            p.run(timeout=60)
            reports[name] = [b.tensors[0] for b in p["out"].collected]
            assert ckpt.stat().st_size > 0
        got, want = reports["torch"], reports["jax"]
        assert len(got) == len(want) == 2
        assert [(r.shape, r.dtype) for r in got] == \
            [(r.shape, r.dtype) for r in want] == [((4, 1, 1), np.float64)] * 2
        # the same launch line, the same weights: the same reports
        # (float32 steps, 1e-5 abs + 1e-4 rel)
        np.testing.assert_allclose(np.stack(got), np.stack(want),
                                   atol=1e-5, rtol=1e-4)

    def test_zoo_model_batchnorm_training(self):
        """Training a zoo model updates its running statistics by EMA,
        not by gradient descent (train_apply_fn path): they move, and they
        are buffers, outside the optimizer's parameters."""
        tr, _ = _trainer("mobilenet_v2", num_training_samples=4,
                         custom={"batch": "4", "size": "32", "width": "0.35",
                                 "classes": "4", "seed": "0"})
        tr.start(lambda e: None)
        module = tr._bundle.module
        before = module.blocks[0].dw_bn.running_mean.clone()
        rng = np.random.default_rng(0)
        for i in range(4):
            y = np.zeros(4, np.float32)
            y[i % 4] = 1.0
            tr.push_data([rng.integers(0, 255, size=(32, 32, 3),
                                       dtype=np.uint8), y])
        after = module.blocks[0].dw_bn.running_mean
        assert not torch.allclose(before, after)
        trained = {id(p) for g in tr._opt.param_groups for p in g["params"]}
        assert id(after) not in trained
        assert id(module.blocks[0].dw_bn.weight) in trained


class TestTrainerCheckpoint:
    """tests/test_trace_checkpoint.py's two trainer cases on the port: a
    path without an extension is a directory, one with an extension the
    exact file."""

    def _make_trainer(self, tmp_path, load_path=""):
        model = tmp_path / "lin.py"
        if not model.exists():
            rng = np.random.default_rng(0)
            np.save(tmp_path / "lin_w.npy",
                    (rng.normal(size=(4, 2)) * 0.1).astype(np.float32))
            model.write_text(
                "import numpy as np, torch\n"
                "def make_model(custom):\n"
                f"    w = np.load({str(tmp_path / 'lin_w.npy')!r})\n"
                "    params = {'w': torch.from_numpy(w), 'b': torch.zeros(2)}\n"
                "    def apply_fn(p, x):\n"
                "        return x @ p['w'] + p['b']\n"
                "    return apply_fn, params\n")
        tr, _ = _trainer(model, num_training_samples=4,
                         custom={"batch": "2", "loss": "mse"},
                         model_load_path=load_path)
        tr.start(lambda ev: None)
        return tr

    def _leaves(self, tr):
        return [v.detach().clone() for v in
                tr._bundle.module.state_dict().values()]

    def test_dir_save_restore_round_trip(self, tmp_path):
        tr = self._make_trainer(tmp_path)
        rng = np.random.default_rng(0)
        for _ in range(4):
            tr.push_data([rng.normal(size=4).astype(np.float32),
                          rng.normal(size=2).astype(np.float32)])
        ckpt = tmp_path / "ckpt"
        tr.save(str(ckpt))
        assert ckpt.is_dir()
        tr2 = self._make_trainer(tmp_path, load_path=str(ckpt))
        a, b = self._leaves(tr), self._leaves(tr2)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6)
        # and the restored weights differ from the file's initial ones
        assert not all(torch.equal(x, y) for x, y in
                       zip(a, self._leaves(self._make_trainer(tmp_path))))

    def test_file_save_restore(self, tmp_path):
        tr = self._make_trainer(tmp_path)
        path = tmp_path / "params.msgpack"
        tr.save(str(path))
        assert path.is_file()
        before = self._leaves(tr)
        with torch.no_grad():
            for v in tr._bundle.module.parameters():
                v.mul_(0)
        tr.restore(str(path))
        for a, b in zip(before, self._leaves(tr)):
            np.testing.assert_allclose(a.numpy(), b.numpy())


# -- the MLP through both trainers: three optimizers × two losses --------------

def _epochs(tr, props, samples):
    """Push samples; (train loss, train acc, val loss, val acc) per epoch."""
    rows = []

    def on_event(ev):
        if ev.value == "epoch_completion":
            rows.append((props.training_loss, props.training_accuracy,
                         props.validation_loss, props.validation_accuracy))

    tr.start(on_event)
    for s in samples:
        tr.push_data(s)
    return np.array(rows)


@pytest.mark.parametrize("loss", ["softmax_xent", "mse"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
def test_mlp_matches_jax_trainer(tmp_path, optimizer, loss):
    """32 samples, 2 epochs of 12 train + 4 validation at batch 4, on the
    same weights: per-epoch metrics and final weights at float32
    tolerance (1e-5 abs + 1e-4 rel)."""
    jmodel, tmodel = mlp_models(tmp_path)
    rng = np.random.default_rng(7)
    samples = [mlp_sample(rng) for _ in range(32)]
    custom = {"batch": "4", "lr": "0.1", "optimizer": optimizer,
              "loss": loss}
    kw = dict(num_training_samples=12, num_validation_samples=4,
              num_epochs=2)
    jt = JaxTrainer()
    jprops = JaxProps(model_config=str(jmodel), custom=dict(custom), **kw)
    jt.create(jprops)
    want = _epochs(jt, jprops, samples)
    tt, tprops = _trainer(tmodel, custom=custom, **kw)
    got = _epochs(tt, tprops, samples)
    assert got.shape == want.shape == (2, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    params = tt._bundle.module.tree()
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jt._params[k]),
                                   atol=1e-5, rtol=1e-4)


# -- MobileNet-v2 with batch statistics -----------------------------------------

MB_CUSTOM = {"batch": "4", "size": "32", "width": "0.35", "classes": "4",
             "seed": "0", "lr": "0.01"}


def _mb_samples(n, seed=0, size=32, classes=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y = np.zeros(classes, np.float32)
        y[i % classes] = 1.0
        out.append([rng.integers(0, 255, (size, size, 3), dtype=np.uint8), y])
    return out


@pytest.fixture(scope="module")
def jax_mobilenet(tmp_path_factory):
    """The JAX trainer's two bf16 steps on MobileNet-v2 (flax's init,
    jitted) and the variables it started from, as an npz for the port:
    (npz, losses per step, final variables)."""
    import nnstreamer_tpu.models as jm

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "_init_on_cpu", jit_init)
        jt = JaxTrainer()
        jt.create(JaxProps(model_config="mobilenet_v2",
                           num_training_samples=100, custom=dict(MB_CUSTOM)))
    jt.start(lambda e: None)
    npz = str(tmp_path_factory.mktemp("mbv2") / "flax.npz")
    save_state_dict(from_jax_variables(jax.device_get(jt._params)), npz)
    losses = []
    for i, s in enumerate(_mb_samples(8)):
        jt.push_data(s)
        if i % 4 == 3:
            losses.append(jt.props.training_loss)
    return npz, losses, from_jax_variables(jax.device_get(jt._params))


def _set_dtype(module, dtype):
    """Run a zoo module's forwards in ``dtype`` (its layers' compute type)."""
    for m in module.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


def _port_mobilenet(npz, dtype=torch.bfloat16):
    tr, props = _trainer("mobilenet_v2", num_training_samples=100,
                         custom=dict(MB_CUSTOM, params=npz))
    _set_dtype(tr._bundle.module, dtype)
    tr.start(lambda e: None)
    losses = []
    for i, s in enumerate(_mb_samples(8)):
        tr.push_data(s)
        if i % 4 == 3:
            losses.append(props.training_loss)
    return losses, tr._bundle.module.state_dict()


def _group_dist(a, b):
    """Max abs distance over the running statistics and over the
    parameters of two state dicts."""
    def d(sel):
        return max(float((a[k].float() - b[k].float()).abs().max())
                   for k in a if sel(k))
    return {"stats": d(lambda k: "running" in k),
            "params": d(lambda k: "running" not in k
                        and "num_batches" not in k)}


def test_mobilenet_bf16_trainer_matches_jax_within_noise(jax_mobilenet):
    """Two steps of the zoo's bfloat16 MobileNet-v2 through both trainers
    from the same flax variables: each step's loss, the running
    statistics and the weights no farther from the JAX trainer's than
    twice the JAX trainer's distance from the same steps at float32."""
    npz, want_losses, want = jax_mobilenet
    losses, got = _port_mobilenet(npz)
    losses32, got32 = _port_mobilenet(npz, torch.float32)
    noise, dist = _group_dist(want, got32), _group_dist(want, got)
    for k in dist:
        assert dist[k] <= 2 * noise[k], (k, dist[k], noise[k])
    for g, w, f in zip(losses, want_losses, losses32):
        assert abs(g - w) <= 2 * abs(w - f), (g, w, f)
    assert got.keys() == want.keys()


def _flax_step_float32(size=32, batch=4):
    """One JAX float32 train step of flax's MobileNet-v2 (the JAX
    package's make_train_step with batch stats) and the gradient of the
    same loss by ``jax.grad``: (variables before, frames, labels, loss,
    state dict after, gradient as a state dict)."""
    import optax

    from nnstreamer_tpu.models import make_train_apply
    from nnstreamer_tpu.models.mobilenet_v2 import MobileNetV2 as FlaxMBV2
    from nnstreamer_tpu.parallel.train import make_train_step

    model = FlaxMBV2(num_classes=4, width_mult=0.35, dtype=jnp.float32)
    v = jax.device_get(jit_init(model, 0, jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (batch, size, size, 3), dtype=np.uint8)
    y = rng.integers(0, 4, batch).astype(np.int32)
    opt = optax.sgd(0.01, momentum=0.9)
    train_apply = make_train_apply(model)
    step = make_train_step(train_apply, opt, has_batch_stats=True)
    # the step donates its inputs: hand it copies, keep ``v`` as it was
    fresh = jax.tree_util.tree_map(jnp.array, v)
    after, _, m = step(fresh, opt.init(fresh["params"]), (x, y))

    def loss(params):
        logits, _ = train_apply(dict(v, params=params), x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    grad = jax.device_get(jax.jit(jax.grad(loss))(v["params"]))
    return (v, x, y, float(m["loss"]), from_jax_variables(
        jax.device_get(after)), from_jax_variables(
        {"params": grad, "batch_stats": v["batch_stats"]}))


@pytest.fixture(scope="module")
def flax_step_float32():
    return _flax_step_float32()


def _port_step_float32(v, x, y):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2
    from nnstreamer_tpu_torch.parallel.train import make_train_step

    m = MobileNetV2(num_classes=4, width_mult=0.35, dtype=torch.float32)
    m.load_state_dict(from_jax_variables(v))

    def train_apply(frames):
        new_state = []
        return m(preprocess_frames(frames, "pm1", m.dtype), new_state), \
            new_state

    opt = torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(train_apply, opt, has_batch_stats=True)
    loss = float(step((torch.from_numpy(x), torch.from_numpy(y)))["loss"])
    return loss, m.state_dict()


def _running_stats_close(got, want):
    return all(torch.allclose(got[k], want[k], rtol=0, atol=1e-4)
               for k in got if "running" in k)


def _torch_bn_train(y, bn, dtype, new_state, momentum=0.99):
    """torch's own train-mode BatchNorm at flax's momentum: normalizes by
    the biased variance, updates running_var with the unbiased one."""
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    out = torch.nn.functional.batch_norm(
        y.float(), rm, rv, bn.weight, bn.bias, training=True,
        momentum=1.0 - momentum, eps=bn.eps)
    new_state += [(bn.running_mean, rm), (bn.running_var, rv)]
    return out.to(dtype)


def test_mobilenet_float32_step_matches_flax(flax_step_float32):
    """One float32 step from the same variables (see the module docstring
    for the tolerances)."""
    v, x, y, want_loss, want, grad = flax_step_float32
    loss, got = _port_step_float32(v, x, y)
    assert loss == pytest.approx(want_loss, rel=1e-4)
    assert _running_stats_close(got, want)
    before = from_jax_variables(v)
    for k in got:
        if "running" in k or "num_batches" in k:
            continue
        du, dw = got[k] - before[k], -0.01 * grad[k]
        assert float((du - dw).norm()) <= 0.05 * float(dw.norm()) + 1e-5, k


@pytest.mark.usefixtures("worker_torch_threads")
def test_mobilenet_float32_step_fails_with_torch_batchnorm(
        flax_step_float32, monkeypatch):
    """torch.nn.BatchNorm2d's train mode updates running_var with the
    unbiased variance: at 32 px the last maps are 1x1, four values a
    channel, and the same step's running statistics miss flax's."""
    import nnstreamer_tpu_torch.models.mobilenet_v2 as port_mbv2

    v, x, y, want_loss, want, _ = flax_step_float32
    monkeypatch.setattr(port_mbv2, "batch_norm_train", _torch_bn_train)
    loss, got = _port_step_float32(v, x, y)
    assert loss == pytest.approx(want_loss, rel=1e-4)  # same normalization
    assert not _running_stats_close(got, want)


# -- the refold -----------------------------------------------------------------

def _colour_samples(n, seed=3, size=32, classes=4):
    """Frames of a per-class mean colour plus noise: learnable."""
    rng = np.random.default_rng(seed)
    means = rng.integers(40, 216, (classes, 3))
    out = []
    for i in range(n):
        c = i % classes
        x = np.clip(means[c] + rng.normal(0, 20, (size, size, 3)), 0, 255)
        y = np.zeros(classes, np.float32)
        y[c] = 1.0
        out.append([x.astype(np.uint8), y])
    return out


def _train(custom, n_steps, **props):
    tr, props = _trainer("mobilenet_v2", num_training_samples=4 * n_steps,
                         custom=custom, **props)
    tr.start(lambda e: None)
    return tr, props


@pytest.mark.usefixtures("worker_torch_threads")
@pytest.mark.parametrize("stale", [False, True])
def test_refold_after_training(monkeypatch, stale):
    """A float32 folded forward built before training, called after it,
    against the unfused forward of the current weights: 2e-3 abs + 1e-3
    rel and equal argmax (four steps leave the running statistics 96% at
    their initial values, so the eval activations are far from normalized
    and float32 rounding grows through the 17 blocks: 7.4e-4 at logits of
    6.7). Folded once (no refold), it fails: the stale logits lie 5.8
    away."""
    import nnstreamer_tpu_torch.models as port_models
    import nnstreamer_tpu_torch.models.mobilenet_v2 as port_mbv2

    tr, _ = _train(dict(MB_CUSTOM, lr="0.05"), 4)
    module = tr._bundle.module
    _set_dtype(module, torch.float32)
    folded = port_mbv2._make_fused_apply(module, mode="xla")
    if stale:
        # the refold rule reads the version here (models.refolding)
        monkeypatch.setattr(port_models, "weights_version", lambda m: 0)
    for s in _colour_samples(16):
        tr.push_data(s)
    x = preprocess_frames(torch.from_numpy(np.stack(
        [s[0] for s in _colour_samples(8, seed=9)])), "pm1", torch.float32)
    with torch.no_grad():
        got, want = folded(x), module(x)
    close = bool(torch.allclose(got, want, atol=2e-3, rtol=1e-3)
                 and torch.equal(got.argmax(-1), want.argmax(-1)))
    assert close is not stale


@pytest.mark.parametrize("stale", [False, True])
def test_trainer_validation_runs_current_weights(monkeypatch, stale):
    """The trainer's validation forward (fused:xla, bfloat16) after
    training equals a fold of the current weights made then, exactly;
    folded once, it does not."""
    import nnstreamer_tpu_torch.models as port_models
    import nnstreamer_tpu_torch.models.mobilenet_v2 as port_mbv2

    tr, props = _train(dict(MB_CUSTOM, lr="0.05", fused="xla"), 4,
                       num_validation_samples=4)
    if stale:
        # the refold rule reads the version here (models.refolding)
        monkeypatch.setattr(port_models, "weights_version", lambda m: 0)
    samples = _colour_samples(20)
    for s in samples:
        tr.push_data(s)
    assert tr.stats["steps"] == 4 and tr.stats["val_batches"] == 1
    monkeypatch.undo()
    x = torch.from_numpy(np.stack([s[0] for s in samples[16:]]))
    fresh = port_mbv2._make_fused_apply(tr._bundle.module, mode="xla")
    with torch.no_grad():
        want = fresh(preprocess_frames(x, "pm1", torch.bfloat16))
    from nnstreamer_tpu_torch.parallel.train import _loss_and_acc

    y = torch.from_numpy(np.stack([s[1] for s in samples[16:]]).argmax(-1))
    want_loss = float(_loss_and_acc(want, y, "softmax_xent")[0])
    assert (props.validation_loss == want_loss) is not stale


# -- save and serve --------------------------------------------------------------

@pytest.mark.parametrize("name", ["trained.weights", "trained_dir"])
def test_saved_weights_serve_in_the_filter(tmp_path, name):
    """The trainer's save, as a file with an extension of no format
    (written exactly there) or a directory, read by the filter's
    custom=params:: its logits equal the trainer's eval forward's."""
    custom = dict(MB_CUSTOM, lr="0.05", fused="xla")
    tr, _ = _train(custom, 4)
    for s in _colour_samples(16):
        tr.push_data(s)
    path = tmp_path / name
    tr.save(str(path))
    assert path.is_file() if "." in name else path.is_dir()
    frames = np.stack([s[0] for s in _colour_samples(4, seed=9)])
    with torch.no_grad():
        want = tr._bundle.apply_fn(torch.from_numpy(frames)).numpy()
    spec = ",".join(f"{k}:{v}" for k, v in custom.items()
                    if k in ("size", "width", "classes", "fused"))
    p = parse_launch(
        "appsrc name=src caps=other/tensors,num-tensors=1,"
        "dimensions=3:32:32:4,types=uint8,framerate=0/1 ! tensor_filter "
        f"framework=jax model=mobilenet_v2 custom=params:{path},{spec} "
        "accelerator=true:cpu ! tensor_sink name=out")
    p.play()
    p["src"].push_buffer(Buffer(tensors=[frames]))
    p["src"].end_of_stream()
    assert p.bus.wait_eos(30)
    got = np.asarray(p["out"].collected[0].tensors[0])
    p.stop()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_py_model_serves_saved_params(tmp_path):
    """A .py model in the filter (the JAX filter's embedded-Python
    model), with custom=params: reading what the trainer saved."""
    _, tmodel = mlp_models(tmp_path)
    tr, _ = _trainer(tmodel, num_training_samples=8,
                     custom={"batch": "4", "lr": "0.5"})
    tr.start(lambda e: None)
    rng = np.random.default_rng(1)
    for _ in range(8):
        tr.push_data(mlp_sample(rng))
    tr.save(str(tmp_path / "mlp.bin"))
    x = rng.normal(size=(2, FEAT)).astype(np.float32)
    with torch.no_grad():
        want = tr._bundle.apply_fn(torch.from_numpy(x)).numpy()
    outs = []
    for params in ("", f" custom=params:{tmp_path / 'mlp.bin'}"):
        p = parse_launch(
            "appsrc name=src caps=other/tensors,num-tensors=1,"
            f"dimensions={FEAT}:2,types=float32 ! tensor_filter "
            f"framework=jax model={tmodel} accelerator=true:cpu{params} "
            "! tensor_sink name=out")
        p.play()
        p["src"].push_buffer(Buffer(tensors=[x]))
        p["src"].end_of_stream()
        assert p.bus.wait_eos(30)
        outs.append(np.asarray(p["out"].collected[0].tensors[0]))
        p.stop()
    assert outs[1].shape == (2, CLASSES)
    np.testing.assert_array_equal(outs[1], want)
    assert not np.array_equal(outs[0], want)  # untrained weights differ


def test_filter_still_rejects_other_model_files(tmp_path):
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    # .onnx and .tflite files open through the importers; a .jaxexport
    # artifact is a source this backend does not run
    props = FilterProperties(model_files=[str(tmp_path / "m.jaxexport")],
                             accelerator="true:cpu")
    with pytest.raises(ValueError, match=r"\.py model files"):
        TorchCudaFilter().open(props)


# -- the device ------------------------------------------------------------------

def test_trainer_without_cpu_key_needs_a_card(tmp_path, monkeypatch):
    _, model = mlp_models(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device:cpu"):
        CudaTrainer().create(TrainerProperties(model_config=str(model)))


@pytest.mark.parametrize("custom,shape", [
    ({"mesh": "1"}, (4, 1)),
    ({"mesh": "1", "tp": "2"}, (2, 2)),
])
def test_trainer_takes_a_mesh(tmp_path, monkeypatch, custom, shape):
    """``custom=mesh:1[,tp:N]`` builds the sharded step over the visible
    devices (tests/test_torch_train_mesh.py holds what it computes)."""
    _, model = mlp_models(tmp_path)
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*4")
    tr = CudaTrainer()
    tr.create(TrainerProperties(model_config=str(model),
                                custom=_cpu(custom)))
    assert (tr._step.dp, tr._step.tp) == shape


def test_train_step_with_a_mesh_raises():
    """A mesh step raises on a batch its dp width does not divide (the
    JAX package's ``shard_batch``), and trains on one it does."""
    from nnstreamer_tpu_torch.models import ParamTree
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh
    from nnstreamer_tpu_torch.parallel.train import make_train_step

    def model():
        m = ParamTree({"w": np.ones((FEAT, CLASSES), np.float32)})
        return (lambda x: x @ m.w), m

    _, module = model()
    opt = torch.optim.SGD(module.parameters(), lr=0.1)
    step = make_train_step(None, opt, loss="mse", module=module,
                           replicate=model, mesh=make_mesh(
                               dp=4, devices=[torch.device("cpu")] * 4))
    x, y = torch.ones(6, FEAT), torch.zeros(6, CLASSES)
    with pytest.raises(ValueError, match="does not divide"):
        step((x, y))
    assert float(step((x[:4], y[:4]))["loss"]) == pytest.approx(FEAT ** 2)
    assert float(module.w.max()) < 1.0
