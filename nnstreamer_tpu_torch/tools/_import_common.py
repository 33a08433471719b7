"""Shared importer plumbing for the .tflite / .onnx → torch paths
(counterpart of the JAX package's ``tools/_import_common.py``).

An imported graph is a Python program over torch ops (tools/
import_tflite.py, tools/import_onnx.py) and a dict of weights. Here live
the pieces both importers share: the batch-1 wrapper, the device-side
``preproc:norm`` (the ``arith_chain`` kernel on a CUDA tensor), the
precision scope of ``custom=precision:`` and the module that holds an
imported graph's weights on the bundle's device.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.ops.fusion_stages import _torch_dtype
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo


def make_batch1_apply(g_apply: Callable, graph_ranks: List[int],
                      batch1: bool, native: bool = False) -> Callable:
    """Micro-batching wrapper for batch-1 imported graphs.

    ``g_apply(params, *xs)`` runs the graph (padding a trimmed leading
    batch-1 dim itself). When ``batch1`` (every graph input literally has
    a leading dim of 1 — dynamic dims do NOT qualify: a symbolic first
    axis may be a sequence the graph contracts over, where per-element
    vmap would silently change semantics) and every supplied input
    arrives full-rank with a leading dim > 1, the whole graph runs under
    ``torch.func.vmap`` over it, the counterpart of ``jax.vmap``: the
    batching rules fold the vmapped dim into each conv's and matmul's
    batch, so one call still launches one conv per layer.

    ``native`` (importer option ``batch:native``) instead feeds the
    batched input straight through the graph: convs/pools/resizes treat
    the leading dim as batch natively. Only valid for graphs whose ops
    are all batch-elementwise — an op with a hardcoded batch-1 shape
    (RESHAPE to [1, ...]) or a cross-batch reduction would change
    semantics, so this is opt-in per model, not the default.
    """

    def apply_fn(p, *xs):
        if (batch1 and xs and len(xs) == len(graph_ranks)
                and all(hasattr(x, "ndim") and x.ndim == r and x.shape[0] > 1
                        for x, r in zip(xs, graph_ranks))):
            if native:
                return g_apply(p, *xs)

            def one(*row):
                out = g_apply(p, *row)  # row is rank-1-less; g_apply pads
                outs = out if isinstance(out, (list, tuple)) else [out]
                outs = [o[0] if (hasattr(o, "shape") and o.shape
                                 and o.shape[0] == 1) else o
                        for o in outs]
                return tuple(outs) if len(outs) > 1 else outs[0]

            return torch.func.vmap(one)(*xs)
        return g_apply(p, *xs)

    return apply_fn


def make_preproc_norm(spec: Optional[str]):
    """Device-side input normalization from importer option
    ``preproc:norm:<add>:<div>``: x → (float32(x) + add) / div, so
    pipelines feed RAW uint8 frames and the link carries 1 byte/px
    instead of 4. It runs through :func:`ops.transform_ops.arith_chain`
    (typecast float32, add, div): one launch of the hand-written kernel
    per batch on a CUDA tensor, its plain version on the CPU. Returns the
    wrap function, or None when no spec."""
    if not spec:
        return None
    parts = spec.split(":")
    if parts[0] != "norm" or len(parts) != 3:
        raise ValueError(
            f"preproc must be 'norm:<add>:<div>', got {spec!r}")
    ops = [("add", float(parts[1])), ("div", float(parts[2]))]

    def wrap(x):
        from nnstreamer_tpu_torch.ops.transform_ops import arith_chain

        return arith_chain(x, ops, out_dtype=torch.float32)

    return wrap


def with_preproc(apply_fn: Callable, custom: Mapping[str, str],
                 in_info) -> Callable:
    """``apply_fn`` behind ``custom=preproc:`` (:func:`make_preproc_norm`),
    applied to the whole batch BEFORE the batch-1 wrapper's vmap (the
    kernel's call cannot be vmapped); the graph's first input then takes
    raw uint8 frames, which ``in_info`` is changed to say."""
    pre = make_preproc_norm(custom.get("preproc"))
    if pre is None:
        return apply_fn

    def wrapped(p, x0, *rest):
        return apply_fn(p, pre(x0), *rest)

    from nnstreamer_tpu_torch.types import TensorDType

    in_info.tensors[0].dtype = TensorDType.UINT8
    return wrapped


class _Tf32Gate:
    """The process-wide TF32 flags (``torch.backends.cudnn.allow_tf32``,
    ``torch.backends.cuda.matmul.allow_tf32``) shared by invokes that run
    at once: two replicas, two streams, two imported filters in one
    process. Invokes of one precision hold the gate together; an invoke
    of the other precision waits until the last of them has left, so the
    flags change only while no invoke of the other precision is live.
    The first holder saves the flags and sets them, the last one restores
    them. A waiter of the other precision stops new holders from joining,
    and has the next turn once the last holder has left, so neither
    precision starves. A scope nested in a thread that holds
    the gate passes straight through. Code that runs its convs outside
    the gate (a zoo model) sees whatever flags are set at that moment."""

    def __init__(self):
        self._cond = threading.Condition()
        self._mode: Optional[bool] = None  # the TF32 value set while held
        self._holders = 0
        self._waiting = {False: 0, True: 0}
        self._turn: Optional[bool] = None  # who enters an idle gate next
        self._saved: Optional[tuple] = None
        self._local = threading.local()

    @contextlib.contextmanager
    def hold(self, tf32: bool):
        held = getattr(self._local, "mode", None)
        if held is not None:
            if held != tf32:
                raise RuntimeError(
                    "precision scopes of two precisions nested in one thread")
            yield
            return
        with self._cond:
            self._waiting[tf32] += 1
            while not self._may_enter(tf32):
                self._cond.wait()
            self._waiting[tf32] -= 1
            if not self._holders:
                self._turn = None
                self._saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cuda.matmul.allow_tf32 = tf32
                self._mode = tf32
            self._holders += 1
        self._local.mode = tf32
        try:
            yield
        finally:
            self._local.mode = None
            with self._cond:
                self._holders -= 1
                if not self._holders:
                    (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32) = self._saved
                    self._turn = (not tf32) if self._waiting[not tf32] else None
                    self._mode = None
                    self._cond.notify_all()

    def _may_enter(self, tf32: bool) -> bool:
        if not self._holders:
            return self._turn in (None, tf32)
        return self._mode == tf32 and not self._waiting[not tf32]


_TF32_GATE = _Tf32Gate()


@contextlib.contextmanager
def precision_scope(precision: Optional[str], device: torch.device):
    """The float32 accumulation ``custom=precision:`` asks for, for the
    convolutions and matmuls launched inside the block on a card:
    ``highest`` (the importers' default, the interpreter-parity mode)
    turns TF32 off for cuDNN convs and cuBLAS matmuls, ``default`` turns
    it on (the fast path). The flags are process-wide, so the block
    holds :data:`_TF32_GATE` (:class:`_Tf32Gate`): invokes running at
    once each see their own precision, and the flags are restored when
    the last of them leaves, never left changed for the rest of the
    process. Off the card there is no TF32: nothing changes."""
    if device.type != "cuda":
        yield
        return
    with _TF32_GATE.hold(precision in (None, "default")):
        yield


def as_device_tensor(v: Any, device: torch.device) -> torch.Tensor:
    """A numpy constant of a graph as a tensor on ``device``: float64
    becomes float32, as the JAX package's arrays do with x64 off."""
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


class GraphParams(torch.nn.Module):
    """An imported graph's weights as buffers on one device, registered
    under ``p0``, ``p1``, ... (graph names may hold any character):
    :meth:`tree` gives them back under the graph's own names. Four-dim
    tensors listed in ``channels_last`` (the convolution weights, already
    in torch's layouts) are stored channels-last, the memory format of
    the NHWC activations they meet."""

    def __init__(self, arrays: Mapping[str, Any], device,
                 channels_last: Sequence[str] = (),
                 given: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        device = torch.device(device)
        self._names = list(arrays)
        cl = set(channels_last)
        for i, (name, a) in enumerate(arrays.items()):
            key = f"p{i}"
            if given is not None:
                t = given[key]
            elif device.type == "meta":
                a = np.asarray(a)
                t = torch.empty(a.shape, device="meta",
                                dtype=_torch_dtype(a.dtype))
            else:
                t = torch.from_numpy(np.array(a)).to(device)
            # a given state (a compile-cache entry, a mesh copy) arrives
            # in whatever format it was saved in: the same layout gives
            # cuDNN the same algorithm, so the same sums
            if name in cl and t.dim() == 4 and t.device.type != "meta":
                t = t.contiguous(memory_format=torch.channels_last)
            self.register_buffer(key, t)

    def tree(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, f"p{i}")
                for i, name in enumerate(self._names)}


def graph_bundle(g, apply_fn, custom: Dict[str, str], device):
    """The :class:`models.ModelBundle` of an imported graph ``g`` (either
    importer's): its weights as a :class:`GraphParams` on ``device`` (the
    state a compile-cache entry or a mesh copy passes in, when there is
    one), ``apply_fn(params, *xs)`` behind the ``preproc:`` wrapper and
    the precision scope, the graph's declared input and output info, and
    the output info of other input shapes from a ``meta`` run."""
    from nnstreamer_tpu_torch.models import ModelBundle, given_state

    device = torch.device(device)
    in_info, out_info = g.io_info()
    apply_fn = with_preproc(apply_fn, custom, in_info)
    module = GraphParams(g.params(), device, g.channels_last(),
                         given=given_state())
    precision = g.precision

    def run(*xs):
        with torch.no_grad(), precision_scope(precision, device):
            return apply_fn(module.tree(), *xs)

    def infer_output(info: TensorsInfo) -> TensorsInfo:
        if info == in_info:
            return out_info
        from nnstreamer_tpu_torch.buffer import dtype_name

        params = {k: v.detach().to("meta") for k, v in module.tree().items()}
        xs = [torch.empty(t.np_shape(), device="meta",
                          dtype=_torch_dtype(t.dtype.np_dtype))
              for t in info.tensors]
        with torch.no_grad():
            out = apply_fn(params, *xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return TensorsInfo(tensors=[
            TensorInfo.from_np_shape(tuple(o.shape), dtype_name(o))
            for o in outs])

    return ModelBundle(apply_fn=run, module=module, input_info=in_info,
                       output_info=out_info, infer_output=infer_output)
