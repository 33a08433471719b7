"""The steady-state window program (counterpart of the JAX package's
``ops/steady_loop.py``).

The per-frame hot path pays one Python dispatch of the whole composition
(and, at a boundary, one drain) per invoke. ``tensor_filter
loop-window=N`` amortizes that once per WINDOW of N frames: the filter's
full per-invoke composition (fused pre-stage, the model, the on-device
postproc, the post-stage) runs N times in sequence over a stacked window,
as the JAX package's ``lax.scan`` does, and the N outputs come back
stacked.

  - On a CUDA device the window is ONE replay of a ``torch.cuda.CUDAGraph``
    (:class:`CudaGraphWindow`), captured once per (signature, window): it
    reads a static device input ring of shape (N, *frame) and writes
    static stacked outputs. A window then costs one host stack straight
    into a page-locked slot, one non-blocking copy into the ring on the
    compute stream, one ``replay()`` and one clone of the outputs in stream order
    (so a window banked under ``launch-depth`` survives the next replay) —
    the counterpart of one dispatch of the donated scan. The graph runs N
    per-frame forwards; folding the window into the batch dimension
    instead would be another program (other fused-block shapes, other
    bits).
  - On a CPU tensor (the tests) the same composition runs in a Python
    loop over the window (:func:`build_window_fn`) and the outputs are
    stacked.

Nothing inside the graph may route a CUDA tensor to a plain version: the
kernel wrappers launch their kernels or raise. The kernels' launch counts
(``ops/_cuda.LAUNCHES``) tick in Python, so at capture only: the capturing
thread's counts go to the graph's own (``_cuda.recording_launches``, so
another thread's launches during a capture stay in the global count), and
every replay adds them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.ops import _cuda


class LoopDeclined(RuntimeError):
    """The window program could not be built (its capture failed): the
    element falls back LOUDLY to per-buffer launches, as for a backend
    that declines the window at install."""


def build_window_fn(solo: Callable) -> Callable:
    """Wrap a per-frame ``list -> list`` composition into a window
    function ``list_of_stacked -> list_of_stacked``: the composition runs
    once per row of the leading (window) axis, in order, and each output
    is re-stacked along a new leading axis."""

    def window_fn(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        rows = [solo([x[i] for x in xs]) for i in range(int(xs[0].shape[0]))]
        return [torch.stack([r[j] for r in rows])
                for j in range(len(rows[0]))]

    return window_fn


def validate_window(solo_meta: Optional[Callable], window: int,
                    in_info) -> Optional[str]:
    """Data-free proof that the window program composes at the model's
    signature: one run of the composition on ``meta`` tensors at (window,
    *frame). Returns the failure reason, or None when it composes (or
    when the signature or the meta composition is unknown statically —
    the first window then builds the program)."""
    if in_info is None or solo_meta is None:
        return None
    fn = build_window_fn(solo_meta)
    try:
        xs = [torch.empty((int(window),) + tuple(t.np_shape()),
                          dtype=torch.from_numpy(
                              np.empty(0, t.dtype.np_dtype)).dtype,
                          device="meta") for t in in_info]
        with torch.no_grad():
            fn(xs)
    except Exception as e:  # noqa: BLE001 — incomposable: report why
        return str(e).splitlines()[0][:160] if str(e) else type(e).__name__
    return None


def stack_window(rows: Sequence[Sequence], window: int,
                 out: Optional[Sequence[np.ndarray]] = None):
    """Host-side window assembly: per input index, stack the rows' arrays
    along a NEW leading axis and pad a partial window by repeating the
    last row — every window presents ONE program shape (the micro-batch
    padding discipline), and the padded rows are masked out at emit time
    (never pushed downstream). ``out`` (one array per input, the
    window's shape) receives the stack: the backend's page-locked
    staging slot, so the window is copied once on the host.

    Returns (stacked_arrays, n_valid)."""
    n_valid = len(rows)
    pad = window - n_valid
    stacked = []
    for j in range(len(rows[0])):
        parts = [np.asarray(r[j]) for r in rows]
        if parts and parts[0].ndim == 0:
            raise ValueError("loop-window cannot stack scalar frames")
        parts.extend([parts[-1]] * pad)
        stacked.append(np.stack(parts, out=None if out is None else out[j]))
    return stacked, n_valid


class CudaGraphWindow:
    """The window program at one signature on a CUDA device: a static
    input ring, page-locked staging slots and one captured CUDA graph.

    ``version`` reads the weights' version (``models.weights_version``):
    a trainer refolds the weights in place, after which the graph would
    replay stale weight pointers, so a moved version recaptures before the
    next replay."""

    #: warm-up runs of the window on a side stream before capture: the
    #: first builds the kernel library and the per-shape launch plans and
    #: makes the kernels' one-time attribute calls, cuDNN picks its
    #: algorithms; capture then records launches only
    WARMUP = 2

    def __init__(self, window_fn: Callable, shapes: Sequence[tuple],
                 dtypes: Sequence[torch.dtype], device: torch.device,
                 slots: int, version: Callable[[], int]):
        self.window_fn = window_fn
        self.device = device
        self.version = version
        self.ring = [torch.zeros(tuple(s), dtype=d, device=device)
                     for s, d in zip(shapes, dtypes)]
        # depth + 1 page-locked slots, each with the event of the copy
        # that last read it: a slot is rewritten only after that copy
        self._slots = []
        for _ in range(max(2, int(slots))):
            bufs = [torch.empty(tuple(s), dtype=d, pin_memory=True)
                    for s, d in zip(shapes, dtypes)]
            self._slots.append((bufs, [b.numpy() for b in bufs], None))
        self._next = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outs: List[torch.Tensor] = []
        #: kernel launches one replay makes, by wrapper name
        self.launches: Dict[str, int] = {}
        self.captures = 0
        self.replays = 0
        self.capture_ms = 0.0
        self._version = None
        self.capture()

    def capture(self) -> None:
        """Warm up on a side stream, then capture one window."""
        self.graph = None
        self.outs = []
        stream = torch.cuda.current_stream(self.device)
        side = _cuda.side_stream(self.device, "loop-warmup")
        side.wait_stream(stream)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(self.WARMUP):
                self.window_fn(self.ring)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: a capture mid-stream must not trip over another
        # element's CUDA work on its own thread; capture records this
        # thread's launches and runs none of them
        with _cuda.recording_launches() as launches, \
                torch.inference_mode(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
            outs = self.window_fn(self.ring)
        torch.cuda.synchronize(self.device)
        self.launches = launches
        self.graph, self.outs = graph, outs
        self._version = self.version()
        self.captures += 1
        self.capture_ms += (time.perf_counter() - t0) * 1e3

    def slot(self) -> List[np.ndarray]:
        """The next page-locked slot's arrays, free to write (its previous
        copy has read it): the host stacks the window straight into it."""
        _, arrays, evt = self._slots[self._next]
        if evt is not None:
            evt.synchronize()
        return arrays

    def stage(self, stacked: Sequence[np.ndarray]) -> None:
        """Bring one stacked host window into the next page-locked slot
        (no copy when it was stacked there, :meth:`slot`), then into the
        ring with a non-blocking copy on the compute stream
        (stream-ordered after the previous window's replay)."""
        arrays = self.slot()
        bufs = self._slots[self._next][0]
        for a, x in zip(arrays, stacked):
            if x is not a:
                np.copyto(a, np.asarray(x))
        stream = torch.cuda.current_stream(self.device)
        for r, b in zip(self.ring, bufs):
            r.copy_(b, non_blocking=True)
        evt = torch.cuda.Event()
        evt.record(stream)
        self._slots[self._next] = (bufs, arrays, evt)
        self._next = (self._next + 1) % len(self._slots)

    def replay(self) -> List[torch.Tensor]:
        """Run the staged window: one replay, its launches counted, and
        the stacked outputs cloned in stream order."""
        if self._version != self.version():
            self.capture()
        self.graph.replay()
        for k, n in self.launches.items():
            _cuda.LAUNCHES[k] += n
        self.replays += 1
        with torch.inference_mode():
            return [o.clone() for o in self.outs]
