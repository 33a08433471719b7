"""The torch/CUDA trainer backend — tensor_trainer's compute on the card
(counterpart of the JAX package's ``trainers/jax_trainer.py``).

Registered as ``jax`` (so the JAX package's launch lines run unchanged)
and as ``torch_cuda``. Per-sample ``push_data`` fills a host batcher; each
full batch is stacked on the host, uploaded once to the trainer's device
and run as one torch train step (:mod:`parallel.train`): bfloat16 forward,
float32 parameters, the optimizer's update in place. Epoch bookkeeping
emits the same EPOCH_COMPLETION / TRAINING_COMPLETION events the element
contract requires.

model_config accepts a zoo name (``mobilenet_v2``, ``ssd_mobilenet``,
``deeplab_v3``, ``posenet``, ``yolov8``, ...) or a ``.py`` file with
``make_model(custom)`` (:func:`models.load_py_model`); custom keys:
``batch:<n>``, ``lr:<f>``, ``optimizer:sgd|adam|adamw``, ``momentum:<f>``
(sgd, default 0.9), ``loss:softmax_xent|mse``, plus model keys, and
``device:cpu`` to train on the CPU (the tests; the JAX trainer hands the
key to its model, which ignores it, so one launch line runs
through both packages). Without it the trainer runs on ``cuda`` and raises
when torch sees no card. ``mesh:1`` trains with the sharded step
(:class:`parallel.train.MeshTrainStep`) over ``make_mesh(tp=N)`` of the
visible devices (``tp:N``, default 1; dp = devices / N;
``NNSTPU_TORCH_DEVICES`` names them, as for the filter's ``shard=``):
each flush places the batch's rows on the mesh, and validation,
``save`` and the refold read the model's own module, which gets the
trained weights after every step.

A zoo model with BatchNorm trains through its ``train_apply_fn``
(BatchNorm by the batch's statistics, running statistics by flax's EMA):
MobileNet-v2, SSD-MobileNet-v2, DeepLab-v3, PoseNet and YOLOv8, a
``postproc:pp`` bundle through its raw model's. The loss reads a model's
first output (SSD's boxes, PoseNet's heatmaps), as the JAX package's
does; under ``softmax_xent`` the labels become one int a sample, so a
dense head (SSD, DeepLab, PoseNet, YOLOv8) trains under ``loss:mse``
against a label tensor of the head's shape, and ``softmax_xent`` on it
raises ``ValueError`` as optax does. A ``.py`` model trains every
parameter through its ``apply_fn``. Validation runs the bundle's
inference ``apply_fn`` (with ``fused:pallas`` the fused-block kernel for
MobileNet-v2, SSD and DeepLab, folded again at the first validation batch
after the weights changed).

``save`` writes the parameters and running statistics as one npz
(:func:`models.save_state`): exactly the file named when the path has an
extension, else a directory holding it, where the JAX trainer writes a
flax msgpack file or an orbax directory. Neither saves optimizer state.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.trainers import TrainerEvent, TrainerFramework, TrainerProperties

log = get_logger("trainer.torch_cuda")

#: optax.adamw's default weight decay (torch.optim.AdamW's is 1e-2)
_ADAMW_WEIGHT_DECAY = 1e-4


def pick_device(custom) -> torch.device:
    """``custom=device:cpu`` → the CPU; otherwise ``cuda``, which must
    exist."""
    if custom.get("device", "").lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the torch_cuda trainer needs a CUDA device and torch sees none; "
            "set custom=device:cpu to train on the CPU")
    return torch.device("cuda")


def make_optimizer(name: str, params, lr: float, momentum: float):
    """The torch twin of the JAX trainer's optax optimizer, with optax's
    defaults: sgd is ``optax.sgd(lr, momentum)`` (no Nesterov, no
    dampening, the first step's trace the gradient itself), adam
    ``optax.adam(lr)`` (eps 1e-8 outside the square root), adamw
    ``optax.adamw(lr)`` (weight decay 1e-4, applied to every parameter)."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=_ADAMW_WEIGHT_DECAY)
    return torch.optim.SGD(params, lr=lr, momentum=momentum)


class CudaTrainer(TrainerFramework):
    NAME = "torch_cuda"

    def __init__(self):
        super().__init__()
        self._bundle = None
        self._device = None
        self._opt = None
        self._step = None
        self._mesh = None
        self._eval_step = None
        self._batch: List[List[np.ndarray]] = []
        self._val_batch: List[List[np.ndarray]] = []
        self._seen_samples = 0
        self._epoch_samples = 0
        # per-epoch accumulators, cleared in _finish_epoch so epoch metrics
        # average exactly this epoch's batches
        self._losses: List[float] = []
        self._accs: List[float] = []
        self._val_losses: List[float] = []
        self._val_accs: List[float] = []
        self._stop = False
        #: train steps and validation batches run, the bytes uploaded for
        #: them, and the host reads of device metrics (one per batch)
        self.stats = {"steps": 0, "val_batches": 0, "h2d_bytes": 0,
                      "syncs": 0}

    # -- lifecycle ----------------------------------------------------------
    def create(self, props: TrainerProperties) -> None:
        from nnstreamer_tpu_torch.models import get_model, load_py_model
        from nnstreamer_tpu_torch.parallel.train import make_eval_step

        super().create(props)
        custom = dict(props.custom)
        cfg = props.model_config
        if not cfg:
            raise ValueError("trainer needs model-config=<zoo-name|.py>")
        self._device = pick_device(custom)
        if cfg.endswith(".py"):
            self._bundle = load_py_model(cfg, custom, self._device)
        else:
            self._bundle = get_model(cfg, custom, self._device)
        if props.model_load_path:
            self.restore(props.model_load_path)

        self.batch_size = int(custom.get("batch", 8))
        self._opt = make_optimizer(
            custom.get("optimizer", "sgd"), self._bundle.module.parameters(),
            float(custom.get("lr", 1e-3)), float(custom.get("momentum", 0.9)))
        self._loss_kind = custom.get("loss", "softmax_xent")
        self._mesh = None
        if custom.get("mesh"):
            from nnstreamer_tpu_torch.parallel.mesh import make_mesh

            self._mesh = make_mesh(tp=int(custom.get("tp", 1)))
        self._custom = custom
        self._step = self._make_step()
        # validation always runs the inference-mode apply (frozen batch stats)
        self._eval_step = make_eval_step(self._bundle.apply_fn,
                                         loss=self._loss_kind)

    def _make_step(self):
        """The train step: over the mesh when ``custom=mesh:1``. Models
        with BatchNorm expose train_apply_fn: grads flow only through the
        parameters, running statistics update by EMA."""
        from nnstreamer_tpu_torch.parallel.train import make_train_step

        b = self._bundle
        has_bn = b.train_apply_fn is not None
        return make_train_step(
            b.train_apply_fn if has_bn else b.apply_fn, self._opt,
            mesh=self._mesh, loss=self._loss_kind, has_batch_stats=has_bn,
            module=b.module, replicate=self._template)

    def _template(self):
        """A fresh (apply, module) pair of the trained model on the
        ``meta`` device, for one dp row of the sharded step (which
        replaces every tensor of it)."""
        from nnstreamer_tpu_torch.models import build_with_state

        custom = {k: v for k, v in self._custom.items() if k != "fused"}
        state = {k: torch.empty_like(v, device="meta")
                 for k, v in self._bundle.module.state_dict().items()}
        b = build_with_state(self.props.model_config, custom, "meta", state)
        return (b.train_apply_fn or b.apply_fn), b.module

    def destroy(self) -> None:
        self._bundle = self._opt = self._step = self._eval_step = None
        super().destroy()

    def start(self, notify) -> None:
        super().start(notify)
        self._stop = False
        self._seen_samples = 0
        self._epoch_samples = 0
        # a re-start is a fresh run: drop half-filled batches and old metrics
        self._batch.clear()
        self._val_batch.clear()
        self._losses.clear()
        self._accs.clear()
        self._val_losses.clear()
        self._val_accs.clear()

    def stop(self) -> None:
        self._stop = True

    # -- data path ----------------------------------------------------------
    def push_data(self, tensors: Sequence[Any]) -> None:
        """One sample per call (numpy arrays or torch CPU tensors). Within
        an epoch the first ``num_training_samples`` train; the next
        ``num_validation_samples`` are held out and only evaluated (the
        reference's train/valid split, GstTensorTrainerProperties
        num_*_samples)."""
        p = self.props
        if self._stop or p is None:
            return
        n_in, n_lab = p.num_inputs, p.num_labels
        if len(tensors) < n_in + n_lab:
            raise ValueError(
                f"trainer sample has {len(tensors)} tensors, needs "
                f"{n_in} inputs + {n_lab} labels"
            )
        sample = [np.asarray(t) for t in tensors[: n_in + n_lab]]
        # first num_training_samples train, the rest are held out — including
        # the num_training_samples=0 case (validation-only runs)
        is_val = (
            p.num_validation_samples > 0
            and self._epoch_samples >= p.num_training_samples
        )
        if is_val:
            self._val_batch.append(sample)
            if len(self._val_batch) >= self.batch_size:
                self._flush_val()
        else:
            self._batch.append(sample)
            if len(self._batch) >= self.batch_size:
                self._flush()
        self._seen_samples += 1
        self._epoch_samples += 1
        epoch_total = p.num_training_samples + p.num_validation_samples
        if epoch_total and self._epoch_samples >= epoch_total:
            self._finish_epoch()

    def _stack_batch(self, samples: List[List[np.ndarray]]):
        """Column-stack a list of samples into (x, y) step inputs on the
        trainer's device: one upload per stacked array."""
        n_in = self.props.num_inputs
        cols = list(zip(*samples))
        xs = [np.stack(c) for c in cols[:n_in]]
        ys = [np.stack(c) for c in cols[n_in:]]
        samples.clear()
        if self._loss_kind == "softmax_xent":
            # labels arrive one-hot (n, C) or integer (n,); the step wants ints
            y = np.asarray(ys[0] if len(ys) == 1 else tuple(ys))
            y = y.reshape(y.shape[0], -1)
            ys = [(y.argmax(-1) if y.shape[-1] > 1 else y.reshape(-1))
                  .astype(np.int64)]
        xs, ys = [self._upload(a) for a in xs], [self._upload(a) for a in ys]
        x = xs[0] if len(xs) == 1 else tuple(xs)
        y = ys[0] if len(ys) == 1 else tuple(ys)
        return x, y

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        self.stats["h2d_bytes"] += a.nbytes
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def _read(self, metrics) -> List[float]:
        """Loss and accuracy to the host: the step's one sync (the JAX
        trainer's ``float(metrics[...])``)."""
        self.stats["syncs"] += 1
        return torch.stack([metrics["loss"].float(),
                            metrics["accuracy"].float()]).tolist()

    def _flush_val(self) -> None:
        if not self._val_batch:
            return
        p = self.props
        x, y = self._stack_batch(self._val_batch)
        p.validation_loss, p.validation_accuracy = self._read(
            self._eval_step((x, y)))
        self.stats["val_batches"] += 1
        self._val_losses.append(p.validation_loss)
        self._val_accs.append(p.validation_accuracy)

    def _flush(self) -> None:
        from nnstreamer_tpu_torch.models import weights_changed

        if not self._batch:
            return
        p = self.props
        x, y = self._stack_batch(self._batch)
        metrics = self._step((x, y))
        weights_changed(self._bundle.module)
        self.stats["steps"] += 1
        loss, acc = self._read(metrics)
        self._losses.append(loss)
        self._accs.append(acc)
        p.training_loss = loss
        p.training_accuracy = acc

    def _finish_epoch(self) -> None:
        self._flush()
        self._flush_val()
        p = self.props
        p.epoch_count += 1
        if self._losses:
            p.training_loss = float(np.mean(self._losses))
            p.training_accuracy = float(np.mean(self._accs))
        if self._val_losses:
            p.validation_loss = float(np.mean(self._val_losses))
            p.validation_accuracy = float(np.mean(self._val_accs))
        self._losses.clear()
        self._accs.clear()
        self._val_losses.clear()
        self._val_accs.clear()
        self._epoch_samples = 0
        log.info("epoch %d complete: loss=%.4f acc=%.4f",
                 p.epoch_count, p.training_loss, p.training_accuracy)
        self.emit(TrainerEvent.EPOCH_COMPLETION)
        if p.num_epochs and p.epoch_count >= p.num_epochs:
            self.emit(TrainerEvent.TRAINING_COMPLETION)

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint the trained parameters and running statistics (see the
        module docstring): ``custom=params:<path>`` of the filter and
        ``model-load-path`` read it back."""
        from nnstreamer_tpu_torch.models import save_state

        self._flush()
        save_state(self._bundle.module.state_dict(), path)
        log.info("saved trained params to %s", path)

    def restore(self, path: str) -> None:
        """Resume from a checkpoint written by save() (a file or a
        directory)."""
        from nnstreamer_tpu_torch.models import read_state, weights_changed

        self._bundle.module.load_state_dict(read_state(path))
        weights_changed(self._bundle.module)
        if self._step is not None and self._mesh is not None:
            self._step = self._make_step()  # re-place the restored weights
        log.info("restored params from %s", path)


registry.register(registry.TRAINER, "jax")(CudaTrainer)
registry.register(registry.TRAINER, "torch_cuda")(CudaTrainer)
