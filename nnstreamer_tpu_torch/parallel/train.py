"""Training step for on-device training (tensor_trainer's compute), the
counterpart of the JAX package's ``parallel/train.py``.

The JAX package jits an optax step; here a step is the torch sequence
forward → loss → ``backward()`` → ``optimizer.step()`` →
``zero_grad(set_to_none=True)`` on the module's own tensors, which the
optimizer updates in place (the JAX step's donated buffers). Gradients
come from autograd through the train forward: the JAX package
differentiates its flax forward outside any Pallas kernel, so no kernel of
this package runs a backward.

With a ``mesh`` (the JAX step's batch over dp, wide channels over tp,
gradients all-reduced by XLA) the step is a :class:`MeshTrainStep` over
the mesh of :mod:`parallel.mesh`, driven by this one process:

- every mesh position holds its own tensors, placed as the filter's
  ``shard=`` places them (:func:`shard_params_for_tp`): a leaf the tp rule
  splits as its slice, every other leaf whole. These tensors are what
  trains; each has its own gradient and optimizer state;
- each dp row runs its row group (:func:`shard_batch`) in a thread of its
  own, on its device and its named stream, through a template of the
  model whose tensors are replaced by the row's (the tp slices gathered
  by a differentiable concatenation, so each slice receives its own
  gradient);
- BatchNorm takes the whole batch's statistics: at each BatchNorm every
  row hands in its Σx, Σx² and count and gets the sums over the rows,
  added in row order (:func:`models.reduced_batch_stats`), so every row
  computes the same bits;
- the loss is the mean over the whole batch; one ``backward()`` runs
  through every row. A position's gradient is then the sum of the rows'
  gradients of its tensor (the all-reduce), added in row order and given
  to every copy, so every copy takes the same optimizer step and the
  replicas stay equal. The running statistics are written once a
  position, and the model's own module gets the gathered weights after
  each step (validation, ``save`` and the refold read it).

A batch that the dp width does not divide raises, as the JAX package's
``shard_batch`` does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


def _wide(logits: torch.Tensor) -> torch.Tensor:
    """The loss's type: float32, or float64 for float64 logits."""
    return logits if logits.dtype == torch.float64 else logits.float()


def _xent(logits: torch.Tensor, y: torch.Tensor,
          reduction: str = "mean") -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels`` reduced: the
    class on the LAST axis, one integer label for every other position.
    Labels of any other shape raise ``ValueError``, as optax does (the
    trainer's labels are one int a sample: a dense head's (N, ..., C)
    output trains under ``loss:mse``)."""
    if tuple(y.shape) != tuple(logits.shape[:-1]):
        raise ValueError(
            f"softmax_xent takes integer labels of shape logits.shape[:-1]: "
            f"logits {tuple(logits.shape)}, labels {tuple(y.shape)} (a "
            f"dense head trains under loss:mse)")
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1).long(), reduction=reduction)


def _first(out):
    """A model's output collapsed to its first tensor (SSD's boxes,
    PoseNet's heatmaps), as the JAX package's loss reads a tuple."""
    return out[0] if isinstance(out, tuple) else out


def _loss_and_acc(logits, y, loss: str):
    """Shared train/eval metric math on a model's output (a tuple is
    collapsed to its first tensor). ``softmax_xent`` takes integer labels
    (:func:`_xent`, the mean of optax's
    ``softmax_cross_entropy_with_integer_labels``); ``mse`` compares the
    float32 (float64) logits with the label tensor as it is, and its
    accuracy is the negative loss, as in the JAX package."""
    logits = _wide(_first(logits))
    if loss == "softmax_xent":
        l = _xent(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
    else:
        l = torch.mean((logits - y) ** 2)
        acc = -l
    return l, acc


def _loss_sums(logits, y, loss: str):
    """One row group's share of :func:`_loss_and_acc`: (the loss summed
    over its elements, the element count, the correct labels), so the
    rows' sums divide once by the whole batch's count."""
    logits = _wide(_first(logits))
    if loss == "softmax_xent":
        return (_xent(logits, y, reduction="sum"), y.numel(),
                (logits.argmax(-1) == y).float().sum())
    d = (logits - y) ** 2
    return d.sum(), d.numel(), None


def make_train_step(apply_fn: Callable, optimizer: torch.optim.Optimizer,
                    mesh=None, loss: str = "softmax_xent",
                    has_batch_stats: bool = False,
                    module: Optional[torch.nn.Module] = None,
                    replicate: Optional[Callable] = None):
    """Build ``step(batch) -> metrics`` over ``optimizer``'s parameters;
    ``metrics`` holds the loss and accuracy as 0-d tensors on the device
    (reading them is the caller's sync).

    ``has_batch_stats``: ``apply_fn`` is a model's ``train_apply_fn``,
    returning (logits, new_state) with new_state the running statistics
    after the batch as (buffer, value) pairs; the step writes them after
    the optimizer's update, as the JAX step returns the new batch_stats
    beside the new params. Otherwise ``apply_fn(x)`` returns the output
    and every parameter trains.

    With ``mesh``: a :class:`MeshTrainStep`. ``module`` holds the weights
    it starts from (and receives the trained ones after every step);
    ``replicate()`` returns a fresh ``(apply_fn, module)`` pair of the
    same model (any device: its tensors are replaced), one per dp row, so
    the rows' threads never share a module; ``optimizer`` names the
    optimizer class and settings the positions' tensors train with."""
    if mesh is not None:
        if module is None or replicate is None:
            raise ValueError("a sharded train step (mesh=) needs module= "
                             "(the weights) and replicate= (a model "
                             "template a dp row)")
        return MeshTrainStep(mesh, module, replicate, optimizer, loss,
                             has_batch_stats)

    def step(batch) -> Dict[str, torch.Tensor]:
        x, y = batch
        out = apply_fn(x)
        l, acc = _loss_and_acc(out[0] if has_batch_stats else out, y, loss)
        l.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if has_batch_stats:
            with torch.no_grad():
                for buf, value in out[1]:
                    buf.copy_(value)
        return {"loss": l.detach(), "accuracy": acc.detach()}

    return step


class _StatsAllReduce:
    """BatchNorm's whole-batch sums across the dp rows of one step: each
    row's thread calls ``reduce(row, Σx, Σx², count)`` at each BatchNorm
    and gets the sums over every row, added in row order on its own
    device (a CUDA row first waits for the event each row recorded after
    its sums). One barrier a BatchNorm: the k-th call's slots alternate
    by k's parity, and a row reaches call k + 2 only after every row has
    passed call k + 1's barrier, so after it has read call k's slots."""

    def __init__(self, devices: List[torch.device]):
        self.devices = devices
        n = len(devices)
        self._barrier = threading.Barrier(n)
        self._slots: List[List] = [[None] * n, [None] * n]
        self._calls = [0] * n

    def abort(self) -> None:
        self._barrier.abort()

    def __call__(self, row: int, s1, s2, count: int):
        event = None
        if s1.is_cuda:
            event = torch.cuda.Event()
            event.record()
        slots = self._slots[self._calls[row] % 2]
        self._calls[row] += 1
        slots[row] = (s1, s2, count, event)
        self._barrier.wait()
        parts = list(slots)
        dev = self.devices[row]
        stream = torch.cuda.current_stream(dev) if s1.is_cuda else None
        t1 = t2 = None
        n = 0
        for a1, a2, c, ev in parts:
            if ev is not None:
                stream.wait_event(ev)
            a1, a2 = a1.to(dev, non_blocking=True), a2.to(dev,
                                                           non_blocking=True)
            if stream is not None:
                a1.record_stream(stream)
                a2.record_stream(stream)
            t1 = a1 if t1 is None else t1 + a1
            t2 = a2 if t2 is None else t2 + a2
            n += c
        return t1, t2, n


class _Row(torch.nn.Module):
    """One dp row's model template: ``net`` is the module its
    ``apply_fn`` closes over, so ``functional_call`` on this wrapper runs
    the apply with the row's tensors in ``net``'s place."""

    def __init__(self, apply_fn: Callable, net: torch.nn.Module):
        super().__init__()
        self.apply_fn = apply_fn
        self.net = net

    def forward(self, x):
        return self.apply_fn(x)


class MeshTrainStep:
    """The sharded train step (see the module docstring). ``placed`` maps
    each state key to its :class:`PlacedLeaf` (``shards[i][j]`` the tensor
    position (i, j) trains); ``optimizer`` steps them all."""

    def __init__(self, mesh, module: torch.nn.Module, replicate: Callable,
                 optimizer: torch.optim.Optimizer, loss: str,
                 has_batch_stats: bool):
        from nnstreamer_tpu_torch.parallel.mesh import (
            row_device,
            shard_params_for_tp,
        )

        self.mesh, self.module, self.loss = mesh, module, loss
        self.has_batch_stats = has_batch_stats
        self.dp, self.tp = mesh.shape["dp"], mesh.shape["tp"]
        self.row_devices = [row_device(mesh, r) for r in range(self.dp)]
        with torch.no_grad():
            self.placed = shard_params_for_tp(mesh, module)
        self._param_keys = [k for k, _ in module.named_parameters()]
        trained = []
        for key in self._param_keys:
            for row in self.placed[key].shards:
                for t in row:
                    t.requires_grad_(True)
                    trained.append(t)
        self.optimizer = type(optimizer)(trained, **optimizer.defaults)
        self._rows = [_Row(*replicate()) for _ in range(self.dp)]
        self._streams = [None] * self.dp
        if self.row_devices[0].type == "cuda":
            from nnstreamer_tpu_torch.ops._cuda import side_stream

            self._streams = [side_stream(d, f"train-row{r}")
                             for r, d in enumerate(self.row_devices)]

    # -- one row -------------------------------------------------------------
    def _row_tensors(self, r: int) -> Dict[str, torch.Tensor]:
        dev = self.row_devices[r]
        out = {}
        for key, leaf in self.placed.items():
            if leaf.dim is None:
                out[key] = leaf.shards[r][0]
            else:
                out[key] = torch.cat([t.to(dev, non_blocking=True)
                                      for t in leaf.shards[r]], dim=leaf.dim)
        return out

    def _row(self, r: int, x, y, reduce: _StatsAllReduce):
        from nnstreamer_tpu_torch.models import reduced_batch_stats

        stream = self._streams[r]
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            tensors = self._row_tensors(r)
            with reduced_batch_stats(
                    lambda s1, s2, n: reduce(r, s1, s2, n)):
                out = torch.func.functional_call(
                    self._rows[r],
                    {f"net.{k}": v for k, v in tensors.items()}, (x,))
            logits = out[0] if self.has_batch_stats else out
            keys = {id(v): k for k, v in tensors.items()}
            # running statistics after the batch, by state key
            stats = ([(keys[id(buf)], value) for buf, value in out[1]]
                     if self.has_batch_stats else [])
            return _loss_sums(logits, y, self.loss), stats

    # -- the step --------------------------------------------------------------
    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        from nnstreamer_tpu_torch.parallel.mesh import shard_batch

        x, y = batch
        xs, ys = shard_batch(self.mesh, (x, y))
        dev0 = self.row_devices[0]
        callers = [torch.cuda.current_stream(d) if s is not None else None
                   for d, s in zip(self.row_devices, self._streams)]
        for r, s in enumerate(self._streams):
            if s is not None:
                s.wait_stream(callers[r])
                xs[r].record_stream(s)
                ys[r].record_stream(s)
        reduce = _StatsAllReduce(self.row_devices)
        results: List = [None] * self.dp
        errors: List[BaseException] = []

        def run(r):
            try:
                results[r] = self._row(r, xs[r], ys[r], reduce)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                reduce.abort()

        threads = [threading.Thread(target=run, args=(r,),
                                    name=f"train-row{r}")
                   for r in range(self.dp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        self._join_rows(callers, results)
        total, count, correct = None, 0, None
        for (l_sum, n, c), _ in results:
            l_sum = l_sum.to(dev0)
            total = l_sum if total is None else total + l_sum
            count += n
            if c is not None:
                c = c.to(dev0)
                correct = c if correct is None else correct + c
        l = total / count
        l.backward()
        self._join_rows(callers, None)
        with torch.no_grad():
            self._all_reduce_grads(callers)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            for r, (_, stats) in enumerate(results):
                for key, value in stats:
                    for t in self.placed[key].shards[r]:
                        t.copy_(value.to(t.device, non_blocking=True))
            self.write_back()
        acc = correct / count if correct is not None else -l
        return {"loss": l.detach(), "accuracy": acc.detach()}

    def _join_rows(self, callers, results) -> None:
        """The caller's streams wait for the rows' streams; what the rows
        made and the caller reads is marked in use on the caller's."""
        for r, s in enumerate(self._streams):
            if s is None:
                continue
            callers[r].wait_stream(s)
            if results is not None:
                for t in results[r][0]:
                    if isinstance(t, torch.Tensor):
                        t.record_stream(callers[0])

    def _all_reduce_grads(self, callers) -> None:
        """Each position's gradient becomes the sum over the dp rows of
        its tensor's gradients (a replicated leaf's from column 0, the
        copy each row's forward read), added in row order; every copy
        gets its own tensor of that sum."""
        for key in self._param_keys:
            leaf = self.placed[key]
            cols = range(self.tp) if leaf.dim is not None else (0,)
            for j in cols:
                grads = [leaf.shards[i][j].grad for i in range(self.dp)]
                home = leaf.shards[0][j]
                total = None
                for g in grads:
                    if g is None:
                        continue
                    if g.is_cuda:
                        g.record_stream(torch.cuda.current_stream(home.device))
                    g = g.to(home.device, non_blocking=True)
                    total = g if total is None else total + g
                if total is None:
                    continue
                targets = ([(i, j) for i in range(self.dp)]
                           if leaf.dim is not None else
                           [(i, c) for i in range(self.dp)
                            for c in range(self.tp)])
                for i, c in targets:
                    t = leaf.shards[i][c]
                    t.grad = total.to(t.device, copy=True)

    def write_back(self) -> None:
        """The model's own module takes the trained weights and running
        statistics: each leaf gathered from dp row 0's positions."""
        with torch.no_grad():
            state = self.module.state_dict()
            for key, leaf in self.placed.items():
                state[key].copy_(leaf.gather(0, state[key].device))


def make_eval_step(apply_fn: Callable, loss: str = "softmax_xent"):
    """Build ``eval_step(batch) -> metrics``: forward only, no gradients,
    no state change (the validation split of tensor_trainer)."""

    def eval_step(batch) -> Dict[str, torch.Tensor]:
        x, y = batch
        with torch.inference_mode():
            l, acc = _loss_and_acc(apply_fn(x), y, loss)
        return {"loss": l, "accuracy": acc}

    return eval_step
