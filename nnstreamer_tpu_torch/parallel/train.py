"""Training step for on-device training (tensor_trainer's compute), the
counterpart of the JAX package's ``parallel/train.py``.

The JAX package jits an optax step; here a step is the torch sequence
forward → loss → ``backward()`` → ``optimizer.step()`` →
``zero_grad(set_to_none=True)`` on the module's own tensors, which the
optimizer updates in place (the JAX step's donated buffers). Gradients
come from autograd through the train forward: the JAX package
differentiates its flax forward outside any Pallas kernel, so no kernel of
this package runs a backward.

The JAX step's ``mesh`` (batch over dp, channels over tp) is not ported:
passing one raises (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _loss_and_acc(logits, y, loss: str):
    """Shared train/eval metric math; a (logits, state) tuple is collapsed
    to its logits. ``softmax_xent`` takes integer labels (the mean of
    optax's ``softmax_cross_entropy_with_integer_labels``); ``mse``
    compares the float32 logits with the label tensor as it is, and its
    accuracy is the negative loss, as in the JAX package."""
    if isinstance(logits, tuple):
        logits = logits[0]
    logits = logits.float()
    if loss == "softmax_xent":
        l = F.cross_entropy(logits, y.long())
        acc = (logits.argmax(-1) == y).float().mean()
    else:
        l = torch.mean((logits - y) ** 2)
        acc = -l
    return l, acc


def make_train_step(apply_fn: Callable, optimizer: torch.optim.Optimizer,
                    mesh=None, loss: str = "softmax_xent",
                    has_batch_stats: bool = False):
    """Build ``step(batch) -> metrics`` over ``optimizer``'s parameters;
    ``metrics`` holds the loss and accuracy as 0-d tensors on the device
    (reading them is the caller's sync).

    ``has_batch_stats``: ``apply_fn`` is a model's ``train_apply_fn``,
    returning (logits, new_state) with new_state the running statistics
    after the batch as (buffer, value) pairs; the step writes them after
    the optimizer's update, as the JAX step returns the new batch_stats
    beside the new params. Otherwise ``apply_fn(x)`` returns the output
    and every parameter trains."""
    if mesh is not None:
        raise NotImplementedError(
            "a sharded train step (mesh=) is not ported to the torch/CUDA "
            "backend (ROADMAP queue 1 item 4)")

    def step(batch) -> Dict[str, torch.Tensor]:
        x, y = batch
        out = apply_fn(x)
        l, acc = _loss_and_acc(out, y, loss)
        l.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        if has_batch_stats:
            with torch.no_grad():
                for buf, value in out[1]:
                    buf.copy_(value)
        return {"loss": l.detach(), "accuracy": acc.detach()}

    return step


def make_eval_step(apply_fn: Callable, loss: str = "softmax_xent"):
    """Build ``eval_step(batch) -> metrics``: forward only, no gradients,
    no state change (the validation split of tensor_trainer)."""

    def eval_step(batch) -> Dict[str, torch.Tensor]:
        x, y = batch
        with torch.inference_mode():
            l, acc = _loss_and_acc(apply_fn(x), y, loss)
        return {"loss": l, "accuracy": acc}

    return eval_step
