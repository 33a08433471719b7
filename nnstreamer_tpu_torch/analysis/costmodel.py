"""Program-level static cost model (counterpart of the JAX package's
``analysis/costmodel.py``).

For each ``tensor_filter`` it costs the exact per-invoke composition the
backend runs (fused pre/post stages, the model, the on-device postproc)
at its negotiated (micro-batched) signature and returns

  {flops, bytes_read, bytes_written, hbm_bytes, peak_live_bytes,
   param_bytes, derived_bytes, input_bytes, output_bytes, method,
   weak_type_hazards}

The JAX package walks a jaxpr. Here ONE run of the composition's plain
version on ``meta`` tensors gives everything: a meta tensor has a shape,
a dtype and a storage but no data, so the run is data-free and launches
nothing (the wrappers of the composition's kernels route meta tensors to
their plain versions, ``ops/_cuda.plain_route``; the attention kernels'
wrappers refuse them, so a model with attention is unmodeled here).

  - flops: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products
    and convolutions at 2 per multiply-add, grouped convolutions by their
    own weight shape) plus, as the jaxpr walk counts them, one per output
    element of each pointwise op and dtype conversion and one per input
    element of each reduction;
  - boundary bytes: the inputs read and the outputs written;
  - peak_live_bytes: a ``TorchDispatchMode`` counts the bytes of every
    storage an op creates while a tensor still holds it (a view or an
    in-place result adds nothing); the highest count, plus the params and
    the inputs that are live throughout, is the peak — the counterpart of
    ``make_jaxpr`` plus ``_liveness_peak``. The fused block's wrapper runs
    its plain version inside ``ops._cuda.kernel_resident`` and bills only
    its output, as the reference's walk sees a ``pallas_call`` as one
    equation: the kernel keeps its 6x-wide hidden tensor in shared memory
    (MobileNet-v2's first stride-2 block would otherwise bill 308 MB of
    bf16 at batch 128 that the card never holds). The other plain ops
    materialize what they allocate, an upper-ish bound as the
    reference's is. For a filter on the card (``card=True``) the run
    bills what the card holds: ``normalize_u8`` and ``arith_chain`` bill
    their outputs alone, as the fused block does (the frames reach the
    model as the kernel writes them, in the compute dtype); each storage
    bills the block the CUDA caching allocator carves for it from a fresh
    segment (:func:`card_block_bytes`; a CUDA graph's private pool
    starts empty); a convolution bills cuDNN's workspace
    (:func:`cudnn_workspace_bytes`) and its layout copies
    (:func:`cudnn_layout_bytes`) beside its output. With these the plan
    holds what ``max_memory_allocated`` sees of a forward, whose peak on
    MobileNet-v2 is inside the stem's convolution. The cost then also
    carries ``output_sizes`` (each output's bytes), ``peak_terms`` (the
    peak by those parts), ``gemm`` (whether a product ran on cuBLAS,
    whose workspace a CUDA graph's first capture takes,
    :func:`cublas_workspace_bytes`) and ``weight_blocks`` (the params and
    derived weights as the ordinary pool may count them after earlier
    work, :func:`held_block_bytes`).

``derived_bytes`` (a key the JAX package has no need of) counts the
tensors the forward keeps beyond the module's state — the BN-folded,
cast weights a folded forward holds (``derived_bytes_of``); the JAX
package folds inside its jitted forward, so there they are activations.

``weak_type_hazards`` (NNST801) comes from the same meta run: torch has
no weak types, so :class:`_LiveBytes` follows the tensors that descend
from the stream inputs and flags an op where one of them meets a Python
scalar and comes out in a wider dtype (uint8 ``x * 2.5`` → float32), the
counterpart of the jaxpr walk's weak-typed ``convert_element_type``
(:func:`weak_type_promotions`).

``method="compiled"`` runs the program once, concretely, on the device
its parameters live on (the JAX method asks XLA for the compiled
program's cost and memory analyses): flops by ``FlopCounterMode`` and the
pointwise rule above over the run, bytes accessed as every op's inputs
and outputs, the peak from the CUDA allocator (``max_memory_allocated``
above its value at entry; on the CPU the live-storage count). A kernel
launched through ``ctypes`` is invisible to the dispatcher, so each
kernel wrapper bills its plain version's flops at the launch's shapes,
counted once on meta tensors (:func:`ops._cuda.bill_launch`). Build the
program on a device with :func:`composition`.

:func:`static_report` turns the costs into a roofline table (the
``validate --cost`` table and the NNST702 bottleneck) against
:data:`ROOFLINE`, the H100's published peaks.
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.ops import _cuda

#: roofline constants of the static report: one H100 SXM's published
#: dense bf16 peak and memory rate (NVIDIA's data sheet) and the nominal
#: rate of its PCIe 5.0 x16 host link each way. ``mfu`` is 1.0: no
#: sustained fraction has been measured for this package, so the report's
#: legs are the card's bounds, not a prediction of its times
ROOFLINE = {
    "peak_tflops": 989.0,
    "mfu": 1.0,
    "hbm_gbps": 3350.0,
    "link_h2d_gbps": 64.0,
    "link_d2h_gbps": 64.0,
}

#: the JAX package's HBM capacity default — the budget when no card
#: reports one (CPU lint hosts), kept so CPU verdicts match the JAX
#: package's; override with NNSTPU_HBM_BYTES
DEFAULT_HBM_BYTES = 16 * 2**30

#: reductions, billed one flop per INPUT element (the jaxpr walk's rule)
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "cumsum", "cumprod", "var", "std", "var_mean", "std_mean",
    "logsumexp", "_softmax", "_log_softmax", "norm", "linalg_vector_norm",
}


class ShapeDtype(NamedTuple):
    """A tensor's shape and numpy dtype, without data (the counterpart
    of ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


def meta_tensors(shapes: Sequence[ShapeDtype]) -> List[torch.Tensor]:
    """Data-free ``meta`` tensors of ``shapes``."""
    return [torch.empty(tuple(s.shape), dtype=_torch_dtype(s.dtype),
                        device="meta") for s in shapes]


#: the CUDA caching allocator's rules (c10/cuda/CUDACachingAllocator.cpp,
#: without ``expandable_segments`` or ``roundup_power2_divisions``): a
#: request rounds up to 512 bytes; up to 1 MiB it is carved from a shared
#: 2 MiB small segment, up to 10 MiB from a 20 MiB large one, either way
#: split off as it is; from 10 MiB up it takes a segment of its own,
#: rounded up to 2 MiB, and keeps the whole segment when at most 1 MiB
#: would be left over
_BLOCK_ROUND = 512
_SEGMENT_ROUND = 2 << 20
_LARGE_ALLOC = 10 << 20
_SPLIT_LEFTOVER = 1 << 20

#: cuDNN's own scratch beside the widened copy of a stem's input
#: (``nhwcAddPaddingKernel``): the workspace the flagship's stem requests
#: is the copy and these bytes, at batch 1 and 128 alike (measured on the
#: H100 with torch 2.11 and CUDA 12.8: chip_smoke.py's loop phase,
#: ``graph_pool_blocks``)
_CUDNN_PAD_SCRATCH = 4624

#: aten ops that run on cuBLAS (``linear`` and ``matmul`` reach the
#: dispatch mode as these)
_GEMMS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm",
                    "_addmm_activation", "mv", "addmv", "dot", "vdot"})


def card_block_bytes(n: int) -> int:
    """The bytes the card's caching allocator counts (``memory_allocated``)
    for an ``n``-byte storage taken from a fresh segment: the request
    rounded up to 512 bytes, or from 10 MiB up the 2 MiB-rounded segment
    when the block keeps it whole."""
    if n <= 0:
        return 0
    n = -(-n // _BLOCK_ROUND) * _BLOCK_ROUND
    if n >= _LARGE_ALLOC:
        seg = -(-n // _SEGMENT_ROUND) * _SEGMENT_ROUND
        if seg - n <= _SPLIT_LEFTOVER:
            return seg
    return n


def held_block_bytes(n: int) -> int:
    """The most the card's allocator counts for an ``n``-byte storage that
    the ordinary pool serves after earlier work (a backend's weights): a
    request above 1 MiB may take a cached free block that the allocator
    keeps whole because at most 1 MiB would be left over, so it bills
    its 512-byte-rounded size and that 1 MiB, or its fresh segment where
    that is more (:func:`card_block_bytes`)."""
    n512 = -(-n // _BLOCK_ROUND) * _BLOCK_ROUND
    if n512 > _SPLIT_LEFTOVER:
        return max(card_block_bytes(n), n512 + _SPLIT_LEFTOVER)
    return card_block_bytes(n)


def cudnn_workspace_bytes(func, args) -> int:
    """The workspace cuDNN takes for one convolution on the card, as the
    allocator counts it: for a 16-bit input whose channel count is no
    multiple of 8 (the stems' 3), its tensor-core kernels read 8-channel
    vectors, so it copies the input widened to 8 channels
    (``nhwcAddPaddingKernel``) beside a scratch of its own. 0 for every
    other op."""
    if func is not torch.ops.aten.convolution.default:
        return 0
    x, groups = args[0], args[8]
    if (x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float16)
            or groups != 1 or x.shape[1] % 8 == 0):
        return 0
    n, c, h, w = x.shape
    copy = n * h * w * (-(-c // 8) * 8) * x.element_size()
    return card_block_bytes(copy + _CUDNN_PAD_SCRATCH)


def _channels_last(t: torch.Tensor) -> bool:
    """``t.suggest_memory_format()`` is channels-last: laid out so, and
    not also contiguous (as a one-channel or 1x1 tensor is both)."""
    return (t.is_contiguous(memory_format=torch.channels_last)
            and not t.is_contiguous())


def cudnn_layout_bytes(func, args) -> int:
    """The copies one convolution on the card makes of its input and its
    weight where they are not laid out in the memory format cuDNN runs it
    in: channels-last when either of them is (a stem reads the frames'
    NHWC, so its NCHW weight is copied), else contiguous. 0 for every
    other op."""
    if func is not torch.ops.aten.convolution.default:
        return 0
    x, w = args[0], args[1]
    if x.dim() != 4:
        return 0
    cl = _channels_last(x) or _channels_last(w)
    fmt = torch.channels_last if cl else torch.contiguous_format
    return sum(card_block_bytes(t.numel() * t.element_size())
               for t in (x, w) if not t.is_contiguous(memory_format=fmt))


def cublas_workspace_bytes(capability=None) -> int:
    """The workspace PyTorch gives cuBLAS for each (handle, stream) it runs
    on, made at the first product there and kept for the life of the
    process, as the allocator counts it: ``CUBLAS_WORKSPACE_CONFIG``'s
    ``:KiB:count`` pairs summed, else PyTorch's default, 32 MiB on an
    sm_90 card and 4 MiB x 2 + 16 KiB x 8 on others. ``capability``: the
    card's (major, minor), by default the current card's, else sm_90's."""
    spec = os.environ.get("CUBLAS_WORKSPACE_CONFIG", "")
    pairs = [p for p in spec.split(":") if p]
    if pairs and len(pairs) % 2 == 0 and all(p.isdigit() for p in pairs):
        kib = sum(int(a) * int(b) for a, b in zip(pairs[::2], pairs[1::2]))
        return card_block_bytes(kib << 10)
    if capability is None:
        capability = (torch.cuda.get_device_capability()
                      if torch.cuda.is_available() else (9, 0))
    if tuple(capability) == (9, 0):
        return card_block_bytes(4096 * 8 << 10)
    return card_block_bytes((4096 * 2 + 16 * 8) << 10)


class _LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the bytes of storages created under it while a tensor holds
    them, and the pointwise/reduction flops the FLOP counter leaves out.
    ``card``: bill storages and convolutions as the card holds them
    (:func:`card_block_bytes`, :func:`cudnn_workspace_bytes`,
    :func:`cudnn_layout_bytes`), with the peak's parts in
    ``peak_terms``."""

    def __init__(self, stream_inputs: Sequence[torch.Tensor] = (),
                 card: bool = False):
        super().__init__()
        self.card = card
        self.cur = 0
        self.peak = 0
        #: the storages' requested bytes within ``cur``
        self.cur_requested = 0
        #: the peak as the storages' requests, the allocator's rounding of
        #: them, and the call's cuDNN workspace and layout copies
        self.peak_terms = {"storages": 0, "block_rounding": 0,
                           "cudnn_workspace": 0, "cudnn_layout_copies": 0}
        #: whether an op ran on cuBLAS
        self.gemm = False
        self.extra_flops = 0
        #: every op's input and output bytes (the compiled method's
        #: bytes accessed)
        self.accessed = 0
        #: NNST801 findings, in op order
        self.hazards: List[str] = []
        self._refs: Dict[int, List[int]] = {}  # storage -> [tensors, bytes]
        self._stream: set = set()  # ids of tensors that descend from xs
        self._mark_stream(stream_inputs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_in = torch.utils._pytree.tree_leaves((args, kwargs))
        ins = [t for t in flat_in if isinstance(t, torch.Tensor)]
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self.accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        self._follow_stream(flat_in, ins, outs)
        name = func.overloadpacket.__name__
        if torch.Tag.pointwise in func.tags or (
                name == "_to_copy" and ins and outs
                and outs[0].dtype != ins[0].dtype):
            # a dtype conversion counts as the jaxpr walk counts its
            # convert_element_type: one per element
            self.extra_flops += sum(o.numel() for o in outs)
        elif name in _REDUCTIONS:
            self.extra_flops += sum(t.numel() for t in ins)
        self.gemm = self.gemm or name in _GEMMS
        if _cuda.in_kernel_resident():
            return out  # a kernel's on-chip intermediate, not device memory
        in_keys = {_storage_key(t) for t in ins}
        for o in outs:
            key = _storage_key(o)
            ref = self._refs.get(key)
            if ref is None:
                if key in in_keys:
                    continue  # a view of (or in place on) an outside tensor
                nbytes = o.untyped_storage().nbytes()
                ref = self._refs[key] = [
                    0, card_block_bytes(nbytes) if self.card else nbytes,
                    nbytes]
                self.cur += ref[1]
                self.cur_requested += nbytes
                self._top()
            ref[0] += 1
            weakref.finalize(o, self._release, key)
        if self.card:  # live beside the call's output while it runs
            self._top(cudnn_workspace_bytes(func, args),
                      cudnn_layout_bytes(func, args))
        return out

    def _top(self, workspace: int = 0, layout: int = 0) -> None:
        now = self.cur + workspace + layout
        if now > self.peak:
            self.peak = now
            self.peak_terms = {
                "storages": self.cur_requested,
                "block_rounding": self.cur - self.cur_requested,
                "cudnn_workspace": workspace,
                "cudnn_layout_copies": layout}

    def _mark_stream(self, tensors) -> None:
        for t in tensors:
            if id(t) not in self._stream:
                self._stream.add(id(t))
                weakref.finalize(t, self._stream.discard, id(t))

    def _follow_stream(self, flat_in, ins, outs) -> None:
        """Mark what descends from a stream input, and flag a Python
        scalar that widens it: every tensor input of the op has the
        stream tensor's dtype, and the output's is wider (or as wide and
        another), as the jaxpr walk flags a weak-typed conversion."""
        src = [t for t in ins if id(t) in self._stream]
        if not src:
            return
        self._mark_stream(outs)
        if not outs or not any(isinstance(a, (bool, int, float, complex))
                               for a in flat_in):
            return
        old = src[0].dtype
        if any(t.dtype != old for t in ins):
            return  # a tensor operand promoted it, not the scalar
        new = outs[0].dtype
        if new != old and new.itemsize >= old.itemsize:
            self.hazards.append(
                f"{_dtype_name(old)} stream promoted to {_dtype_name(new)} "
                f"by a python scalar (weak-type)")

    def _release(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.cur -= ref[1]
            self.cur_requested -= ref[2]
            del self._refs[key]


def _dtype_name(dt: torch.dtype) -> str:
    """numpy's name of a torch dtype (``uint8``, ``float32``), the
    spelling of the reference's hazard messages."""
    return str(dt).removeprefix("torch.")


def weak_type_promotions(fn, params, shapes: Sequence[ShapeDtype]
                         ) -> List[str]:
    """NNST801 hazards of ``fn(params, *xs)`` at ``shapes``: a Python
    scalar that widens data descended from the stream inputs (e.g. a
    uint8 stream promoted to float32 by ``x * 2.5``), 4x the bytes and a
    program other than the caps promise. One meta run (``params`` on the
    meta device); :func:`program_cost` reports the same list."""
    xs = meta_tensors(shapes)
    live = _LiveBytes(xs)
    with torch.no_grad(), live:
        fn(params, *xs)
    return list(live.hazards)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors_of(params) -> List[torch.Tensor]:
    """The tensors of a module's state, of every tensor leaf of a tree, or
    of each member of a list or tuple of modules (a composed chain's
    params)."""
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().values())
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _tensors_of(p)]
    return [t for t in torch.utils._pytree.tree_leaves(params)
            if isinstance(t, torch.Tensor)]


def param_bytes_of(params) -> int:
    """Bytes of a module's state (parameters and buffers) or of every
    tensor leaf of a tree."""
    return int(sum(t.numel() * t.element_size() for t in _tensors_of(params)))


def derived_bytes_of(apply_fn, module, size=int) -> int:
    """Bytes of the tensors a model's forward keeps beyond ``module``'s own
    state: the BN-folded, cast weights that a folded forward holds in its
    closure (and folds anew when a trainer moves the weights).
    Walks the closures, ``__wrapped__`` chains, dicts, lists and tuples
    reachable from ``apply_fn``, one count per storage; ``size`` maps a
    storage's bytes to what is billed for it (:func:`held_block_bytes`)."""
    own = {_storage_key(t) for t in _tensors_of(module)}
    seen, total, stack = set(), 0, [apply_fn]
    while stack:
        o = stack.pop()
        if id(o) in seen or isinstance(o, torch.nn.Module):
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            key = _storage_key(o)
            if key not in own:
                own.add(key)
                total += size(o.untyped_storage().nbytes())
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif callable(o):
            for cell in getattr(o, "__closure__", None) or ():
                try:
                    stack.append(cell.cell_contents)
                except ValueError:  # an empty cell
                    pass
            if hasattr(o, "__wrapped__"):
                stack.append(o.__wrapped__)
    return int(total)


def _shapes_nbytes(shapes: Sequence[ShapeDtype]) -> int:
    return int(sum(int(np.prod(s.shape, dtype=np.int64))
                   * np.dtype(s.dtype).itemsize for s in shapes))


def program_cost(fn, params, shapes: Sequence[ShapeDtype],
                 method: str = "auto", card: bool = False) -> Dict[str, Any]:
    """Cost one program at one signature: ``fn(params, *xs)`` runs on
    meta tensors of ``shapes`` (``params`` on the meta device too), or,
    with ``method="compiled"``, once concretely on the device ``params``
    live on (see the module docstring). ``card``: the meta run bills its
    peak as the card holds it (a filter on the card)."""
    from torch.utils.flop_counter import FlopCounterMode

    if method == "compiled":
        return _compiled_cost(fn, params, shapes)
    if method not in ("auto", "meta"):
        raise ValueError(f"unknown cost method {method!r}")
    xs = meta_tensors(shapes)
    counter = FlopCounterMode(display=False)
    live = _LiveBytes(xs, card=card)
    with torch.no_grad(), counter, live, _cuda.billing_card(card):
        out = fn(params, *xs)
    outs = [t for t in torch.utils._pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor)]
    bytes_read = _shapes_nbytes(shapes)
    bytes_written = int(sum(t.numel() * t.element_size() for t in outs))
    p_bytes = param_bytes_of(params)
    card_terms = {}
    if card:
        # the outputs as the allocator counts them, one block each; the
        # peak by its parts; whether cuBLAS ran (its workspace)
        card_terms = {"output_sizes": [int(t.numel() * t.element_size())
                                       for t in outs],
                      "peak_terms": dict(live.peak_terms),
                      "gemm": live.gemm,
                      # the params and the derived weights as the ordinary
                      # pool may count them
                      "weight_blocks": int(sum(
                          held_block_bytes(t.numel() * t.element_size())
                          for t in _tensors_of(params)) + getattr(
                              fn, "derived_blocks",
                              getattr(fn, "derived_bytes", 0)))}
    return {
        "flops": int(counter.get_total_flops() + live.extra_flops),
        "bytes_read": bytes_read,
        "bytes_written": bytes_written,
        "hbm_bytes": bytes_read + bytes_written,
        "peak_live_bytes": int(p_bytes + bytes_read + live.peak),
        "param_bytes": p_bytes,
        "derived_bytes": int(getattr(fn, "derived_bytes", 0)),
        "input_bytes": bytes_read,
        "output_bytes": bytes_written,
        "method": "meta",
        "weak_type_hazards": list(live.hazards),
        **card_terms,
    }


#: (kernel, argument shapes and values) -> the plain version's flops
_plain_flops: Dict[tuple, int] = {}


def _leaf_key(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.dtype)
    return a if isinstance(a, (bool, int, float, str, torch.dtype,
                               type(None))) else type(a).__name__


class _KernelBill:
    """The flops of the kernels launched during a concrete run: each
    launch adds its plain version's count at the launch's shapes, taken
    once per (kernel, shapes) on meta tensors with every dispatch mode of
    the run set aside (the sink of :func:`ops._cuda.billing`)."""

    def __init__(self):
        self.flops = 0
        self.launches = 0

    def __call__(self, name: str, plain, args, kwargs) -> None:
        from torch.utils._python_dispatch import _disable_current_modes
        from torch.utils.flop_counter import FlopCounterMode

        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        key = (name, tuple(_leaf_key(a) for a in leaves))
        n = _plain_flops.get(key)
        if n is None:
            with _disable_current_modes():
                margs, mkw = torch.utils._pytree.tree_map(
                    lambda a: torch.empty_like(a, device="meta")
                    if isinstance(a, torch.Tensor) else a, (args, kwargs))
                counter = FlopCounterMode(display=False)
                live = _LiveBytes()
                with torch.no_grad(), counter, live:
                    plain(*margs, **mkw)
                n = _plain_flops[key] = int(counter.get_total_flops()
                                            + live.extra_flops)
        self.flops += n
        self.launches += 1


def _params_device(params) -> torch.device:
    tensors = _tensors_of(params)
    return tensors[0].device if tensors else torch.device("cpu")


def _compiled_cost(fn, params, shapes: Sequence[ShapeDtype]
                   ) -> Dict[str, Any]:
    """``method="compiled"``: one concrete run of ``fn(params, *xs)`` on
    zeros of ``shapes`` on the device of ``params``."""
    from torch.utils.flop_counter import FlopCounterMode

    from nnstreamer_tpu_torch.ops import _cuda

    dev = _params_device(params)
    if dev.type == "meta":
        raise ValueError("cost method 'compiled' runs the program: build "
                         "it on a device (composition(..., device=))")
    xs = [torch.zeros(tuple(sh.shape), dtype=_torch_dtype(sh.dtype),
                      device=dev) for sh in shapes]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        entry = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    live = _LiveBytes(xs)
    bill = _KernelBill()
    with torch.no_grad(), counter, live, _cuda.billing(bill):
        out = fn(params, *xs)
    if cuda:
        torch.cuda.synchronize(dev)
        above = torch.cuda.max_memory_allocated(dev) - entry
    else:
        above = live.peak
    outs = [t for t in torch.utils._pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor)]
    bytes_read = _shapes_nbytes(shapes)
    bytes_written = int(sum(t.numel() * t.element_size() for t in outs))
    p_bytes = param_bytes_of(params)
    return {
        "flops": int(counter.get_total_flops() + live.extra_flops
                     + bill.flops),
        "bytes_read": bytes_read,
        "bytes_written": bytes_written,
        "hbm_bytes": int(live.accessed),
        "peak_live_bytes": int(p_bytes + bytes_read + above),
        "param_bytes": p_bytes,
        "derived_bytes": int(getattr(fn, "derived_bytes", 0)),
        "input_bytes": bytes_read,
        "output_bytes": bytes_written,
        "method": "compiled",
        "weak_type_hazards": list(live.hazards),
        "kernel_launches": bill.launches,
    }


# --------------------------------------------------------------------------
# per-filter program construction
# --------------------------------------------------------------------------

#: bounded LRU of lint-built meta bundles (a zoo rebuild costs the numpy
#: init of its weights)
_BUNDLE_CACHE_MAX = 4
_bundle_cache: "OrderedDict[Tuple[str, str], Any]" = OrderedDict()


def meta_composition(model: str, custom: Dict[str, str], pre_specs=(),
                     post_specs=()):
    """(fn(params, *xs), module, input_info) of the per-invoke composition
    a backend opened on (model, custom) runs — fused pre-stages, the
    model, the postproc, fused post-stages — built on the ``meta``
    device. Raises when the model cannot be built there."""
    return composition(model, custom, pre_specs, post_specs, "meta")


def composition(model: str, custom: Dict[str, str], pre_specs=(),
                post_specs=(), device="meta"):
    """:func:`meta_composition` built on ``device``: with real weights
    (``custom``'s seed or params) on a CPU or a card, it is what
    ``method="compiled"`` runs. Meta builds are cached (LRU)."""
    from nnstreamer_tpu_torch.filters.cuda_filter import compose, make_postproc
    from nnstreamer_tpu_torch.models import build_bundle
    from nnstreamer_tpu_torch.ops.fusion_stages import build_stage_fn

    device = torch.device(device)
    key = (str(model), str(sorted(custom.items())))
    bundle = _bundle_cache.get(key) if device.type == "meta" else None
    if bundle is not None:
        _bundle_cache.move_to_end(key)
    else:
        bundle = build_bundle(model, custom, device)
        if device.type == "meta":
            _bundle_cache[key] = bundle
            while len(_bundle_cache) > _BUNDLE_CACHE_MAX:
                _bundle_cache.popitem(last=False)
    post = make_postproc(custom)
    stage_pre = build_stage_fn(list(pre_specs)) if pre_specs else None
    stage_post = build_stage_fn(list(post_specs)) if post_specs else None
    apply_fn = bundle.apply_fn

    def run(params, *xs):
        return compose(list(xs), stage_pre, apply_fn, post, stage_post)

    run.derived_bytes = derived_bytes_of(apply_fn, bundle.module)
    run.derived_blocks = derived_bytes_of(apply_fn, bundle.module,
                                          size=held_block_bytes)
    return run, bundle.module, bundle.input_info


def _lint_time_program(e):
    """(fn, params, input_info) for a filter whose backend is NOT open:
    zoo and ``.py`` models rebuild deterministically from (model,
    custom). None when the model cannot be rebuilt here (unmodeled rather
    than guessed)."""
    if str(e.properties.get("framework", "")) not in ("jax", "torch_cuda"):
        return None
    model = e.properties.get("model")
    if not model:
        return None
    from nnstreamer_tpu_torch.filters.base import FilterProperties

    cd = FilterProperties(custom=str(e.properties.get("custom", ""))
                          ).custom_dict()
    try:
        return meta_composition(str(model), cd)
    except Exception:  # noqa: BLE001 — unbuildable here: unmodeled
        return None


def filter_program(e):
    """(fn(params, *xs), params, shapes) for a tensor_filter, or None when
    the program cannot be modeled (non-torch backend, unknown input
    shapes). Prefers the OPEN backend's composition (fused stages and
    postproc — what actually runs); falls back to a rebuild at lint
    time."""
    prog = None
    if e.fw is not None and hasattr(e.fw, "cost_program"):
        prog = e.fw.cost_program()
    if prog is None:
        prog = _lint_time_program(e)
    if prog is None:
        return None
    fn, params, bundle_in = prog
    # the invoke signature is what ARRIVES at the sink pad (narrowed by
    # input-combination): fused pre-stages run inside the program, so the
    # program is fed the raw upstream tensors. A chain-fused SHELL's pads
    # carry the COMPOSED stream (the head emits the end of the chain), so
    # its model signature comes from the chain analyzer's composed
    # annotation instead
    if getattr(e, "_fused_into", None) is not None:
        in_info = e.__dict__.get("_nnchain_in_info")
    else:
        in_info = _caps_input_info(e)
    if in_info is not None:
        sel = e.properties.get("input_combination")
        if sel:
            try:
                from nnstreamer_tpu_torch.types import TensorsInfo

                idx = [int(i) for i in str(sel).split(",")]
                in_info = TensorsInfo(
                    tensors=[in_info.tensors[i] for i in idx],
                    format=in_info.format)
            except Exception:  # noqa: BLE001 — bad spec: not modeled
                return None
    if in_info is None or in_info.num_tensors == 0:
        in_info = (e._in_info if getattr(e, "_in_info", None) is not None
                   and e._in_info.num_tensors > 0 else bundle_in)
    if in_info is None or in_info.num_tensors == 0:
        # last resort: the chain analyzer's composed signature (the dry
        # negotiation cannot resolve caps past a reshapable upstream
        # model, but the stepwise composition knows what reaches an
        # interior member — analysis/chain.py annotates it)
        in_info = e.__dict__.get("_nnchain_in_info")
    if in_info is None or in_info.num_tensors == 0:
        return None
    batch = int(e.properties.get("batch_size", 1) or 1)
    shapes = []
    for t in in_info:
        shape = tuple(int(d) for d in t.np_shape())
        if any(d <= 0 for d in shape):
            return None  # symbolic dims: variable-shape
        shapes.append(_batched_shape(shape, batch, t.dtype.np_dtype))
    return fn, params, shapes


def _batched_shape(shape, batch: int, dtype) -> ShapeDtype:
    """Mirror _flush_batch's assembly: leading dim 1 concatenates along
    it; anything else stacks a fresh batch axis."""
    if batch > 1:
        if shape and shape[0] == 1:
            shape = (batch,) + tuple(shape[1:])
        else:
            shape = (batch,) + tuple(shape)
    return ShapeDtype(tuple(shape), np.dtype(dtype))


def _caps_input_info(e):
    """Negotiated/static sink caps as the input info of last resort:
    live pad caps when the pipeline negotiated, else the dry-run
    negotiation (lint time, nothing opened)."""
    sink0 = e.sink_pads[0] if e.sink_pads else None
    if sink0 is None:
        return None
    caps = getattr(sink0, "caps", None)
    if caps is None and getattr(e, "pipeline", None) is not None:
        from nnstreamer_tpu_torch.analysis import nego

        caps = nego.dry_run_quiet_cached(e.pipeline).get(id(sink0))
    if caps is None:
        return None
    try:
        info = caps.to_config().info
    except Exception:  # noqa: BLE001
        return None
    if info is None or info.num_tensors == 0:
        return None
    return info


def filter_cost(e, method: str = "auto") -> Optional[Dict[str, Any]]:
    """Per-invoke cost of a tensor_filter's composed program at its
    negotiated (micro-batched) signature; None when unmodeled.

    Memoized per element, keyed on everything that changes the program —
    model/custom/batch, the fused stage specs and the resolved input
    signature — so a replan or renegotiation invalidates naturally."""
    from nnstreamer_tpu_torch.analysis.memplan import _runs_on_card

    prog = filter_program(e)
    if prog is None:
        return None
    fn, params, shapes = prog
    card = _runs_on_card(e)
    key = (
        method, card,
        str(e.properties.get("model")), str(e.properties.get("custom")),
        tuple((tuple(s.shape), str(s.dtype)) for s in shapes),
        tuple(getattr(e, "_pre_specs", ()) or ()),
        tuple(getattr(e, "_post_specs", ()) or ()),
    )
    cache = e.__dict__.setdefault("_nncost_cache", {})
    if key in cache:
        hit = cache[key]
        return dict(hit) if hit is not None else None
    try:
        cost = program_cost(fn, params, shapes, method=method, card=card)
    except Exception:  # noqa: BLE001 — the meta run failed: unmodeled
        # negative-cached: one analysis run asks several times
        cache[key] = None
        return None
    cost["batch"] = int(e.properties.get("batch_size", 1) or 1)
    cost["input_shapes"] = [tuple(s.shape) for s in shapes]
    cache[key] = dict(cost)
    return cost


# --------------------------------------------------------------------------
# compile-count prediction
# --------------------------------------------------------------------------

def predict_compiles(pipeline) -> Dict[str, Optional[int]]:
    """Statically predicted builds (the backend's ``compile_stats``
    ``jit_traces``) per device-capable filter for a steady-state run: ONE
    per filter — one input signature (micro-batch padding pins it), or
    one windowed program per (signature, window). ``None`` marks a filter
    the model cannot pin: flexible or variable-shape upstream caps build
    once per distinct shape."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    out: Dict[str, Optional[int]] = {}
    for e in pipeline.elements.values():
        if not isinstance(e, TensorFilter) or not e._fw_device_capable():
            continue
        if e._fused_into is not None:
            out[e.name] = 0  # chain shell: the head's build covers it
            continue
        out[e.name] = None if _variable_shape_upstream(e) else 1
    return out


def _variable_shape_upstream(e) -> bool:
    """True when the caps reaching the filter's sink pad are flexible or
    carry a symbolic dim — every distinct runtime shape rebuilds."""
    from nnstreamer_tpu_torch.types import TensorFormat

    sink0 = e.sink_pads[0] if e.sink_pads else None
    if sink0 is None:
        return False
    caps = getattr(sink0, "caps", None)
    if caps is None:
        return False  # unknown statically: don't cry wolf
    try:
        cfg = caps.to_config()
    except Exception:  # noqa: BLE001
        return False
    if cfg.format == TensorFormat.FLEXIBLE:
        return True
    return any(any(int(d) <= 0 for d in t.np_shape()) for t in cfg.info)


# --------------------------------------------------------------------------
# roofline report
# --------------------------------------------------------------------------

def static_report(pipeline, method: str = "auto",
                  constants: Optional[Dict] = None) -> Dict[str, Any]:
    """Whole-pipeline static cost table + roofline bottleneck prediction.

    Per modeled filter: per-invoke flops/bytes and the roofline leg times
    (compute at the peak times ``mfu``, memory traffic at the memory
    rate, link crossings at the link rate — :data:`ROOFLINE` unless
    ``constants`` overrides them). The bottleneck is the largest per-BUFFER
    time across every element and resource: the static answer to "where
    does the next millisecond go" before anything runs."""
    from nnstreamer_tpu_torch.analysis.residency import predict_crossings
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    c = dict(ROOFLINE, **(constants or {}))
    flops_per_s = c["peak_tflops"] * 1e12 * c["mfu"]
    hbm_bps = c["hbm_gbps"] * 1e9
    rows: List[Dict[str, Any]] = []
    unmodeled: List[str] = []
    try:
        pred = predict_crossings(pipeline, n_buffers=1)
    except Exception:  # noqa: BLE001 — crossing model is advisory;
        # with NO byte prediction at all, every filter must take the
        # signature-based link estimate below (a silent t_link=0 would
        # misreport a link-bound pipeline compute-bound)
        pred = {"per_element_bytes": {}, "bytes_unknown": [],
                "unmodeled": [], "all_bytes_unknown": True}
    link_b = pred.get("per_element_bytes", {})

    for e in pipeline.elements.values():
        if not isinstance(e, TensorFilter):
            continue
        cost = filter_cost(e, method=method)
        if cost is None:
            unmodeled.append(e.name)
            continue
        batch = max(1, cost["batch"])
        eb = link_b.get(e.name, {})
        link_estimated = (pred.get("all_bytes_unknown", False)
                          or e.name in pred.get("bytes_unknown", ()))
        t_compute = cost["flops"] / flops_per_s
        t_hbm = cost["hbm_bytes"] / hbm_bps
        # predict_crossings(n_buffers=1) bills ONE (padded) invoke for a
        # batched filter, so these bytes are per-INVOKE — the same unit
        # as the program cost; the shared `/ batch` below amortizes all
        # three legs to per-buffer
        if link_estimated:
            # crossing bytes unresolved statically (typically the src
            # caps of an unopened model): estimate from the program's
            # own per-invoke signature — both directions billed here,
            # an upper bound for mid-chain device-resident filters but
            # exact for the common upload-invoke-fetch shape. A silent
            # 0 would misreport a link-bound pipeline compute-bound.
            t_link = (cost["input_bytes"] / (c["link_h2d_gbps"] * 1e9)
                      + cost["output_bytes"] / (c["link_d2h_gbps"] * 1e9))
        else:
            t_link = (eb.get("h2d", 0) / (c["link_h2d_gbps"] * 1e9)
                      + eb.get("d2h", 0) / (c["link_d2h_gbps"] * 1e9))
        legs = {
            "compute_ms": t_compute / batch * 1e3,
            "hbm_ms": t_hbm / batch * 1e3,
            "link_ms": t_link / batch * 1e3,
        }
        bound = max(legs, key=lambda k: legs[k])
        rows.append(dict(
            cost, element=e.name,
            **{k: round(v, 6) for k, v in legs.items()},
            link_estimated=link_estimated,
            bound=bound.removesuffix("_ms")))
    bottleneck = None
    if rows:
        worst = max(rows, key=lambda r: max(
            r["compute_ms"], r["hbm_ms"], r["link_ms"]))
        bottleneck = {
            "element": worst["element"],
            "resource": worst["bound"],
            "per_buffer_ms": round(max(
                worst["compute_ms"], worst["hbm_ms"], worst["link_ms"]), 6),
        }
    return {"rows": rows, "bottleneck": bottleneck, "unmodeled": unmodeled,
            "constants": c, "crossings": pred}


def render_cost_report(report: Dict[str, Any]) -> str:
    """Text table for ``validate --cost`` / ``doctor --cost``."""
    lines = []
    hdr = (f"{'element':<16}{'GFLOP':>9}{'HBM MB':>10}{'peak MB':>10}"
           f"{'param MB':>10}{'compute ms':>12}{'hbm ms':>10}"
           f"{'link ms':>10}  bound")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for r in report["rows"]:
        lines.append(
            f"{r['element']:<16}"
            f"{r['flops'] / 1e9:>9.3f}"
            f"{r['hbm_bytes'] / 2**20:>10.2f}"
            f"{r['peak_live_bytes'] / 2**20:>10.2f}"
            f"{r['param_bytes'] / 2**20:>10.2f}"
            f"{r['compute_ms']:>12.3f}"
            f"{r['hbm_ms']:>10.3f}"
            + (f"{'~' + format(r['link_ms'], '.3f'):>10}"
               if r.get("link_estimated")
               else f"{r['link_ms']:>10.3f}")
            + f"  {r['bound']}")
    if report["unmodeled"]:
        lines.append(f"unmodeled: {', '.join(report['unmodeled'])}")
    b = report["bottleneck"]
    if b:
        lines.append(
            f"bottleneck: {b['element']} ({b['resource']}-bound, "
            f"~{b['per_buffer_ms']:.3f} ms/buffer "
            f"→ ~{1e3 / b['per_buffer_ms'] if b['per_buffer_ms'] else 0:.0f}"
            f" buffers/s)")
    return "\n".join(lines)
