"""Static residency-plan prediction (counterpart of the JAX package's
``analysis/residency.py``, the CI parity oracle).

``predict_crossings`` walks the graph in topo order and computes, from
the planner's boundary placement plus each element's documented billing
discipline, the EXPECTED per-element ``h2d``/``d2h`` crossing counts —
and, when the edge caps are statically known, the crossing BYTES — for
``n_buffers`` source buffers. The CI conformance step then asserts the
prediction equals the runtime tracer's counters on the example pipelines
— so the single-materialization guarantee ("bytes cross the link once
per direction") can never silently regress: either the planner, the
billing, or this model changed, and the diff names the element.

Byte prediction rides the same walk: every billed crossing multiplies
its count by the per-buffer payload read off the edge's caps (live pad
caps when the pipeline negotiated, else the analyzer's dry-run
negotiation), with micro-batch assembly (including EOS padding — padded
rows really cross) and input-combination narrowing applied exactly as
the runtime pays them. Elements whose edge caps cannot be resolved
statically land in ``bytes_unknown`` and are excluded from the byte
totals — the parity gate only asserts bytes where the model has them.

The model covers the core dataflow elements (sources, transform, filter
with batch/feed-depth/fetch-window, decoder incl. split-batch, the
combiners, sinks, and everything residency-transparent). Data-dependent
elements (tensor_if/rate/crop, aggregator windows) are reported in
``unmodeled`` — the parity gate only runs pipelines the model covers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

#: per-pad flow state: (units flowing per run, residency)
#: residency ∈ 'host' | 'device' | 'mixed' — mirroring the runtime's
#: any()/all() is_device_array gates
State = Tuple[int, str]


def caps_nbytes(caps) -> Optional[int]:
    """Per-buffer payload bytes of fixed static caps; None when the caps
    are flexible/unfixed (byte prediction stops there)."""
    import numpy as np

    if caps is None:
        return None
    try:
        info = caps.to_config().info
    except Exception:  # noqa: BLE001 — unparsable caps: unknown
        return None
    if info is None or info.num_tensors == 0:
        return None
    total = 0
    for t in info:
        shape = t.np_shape()
        if any(int(d) <= 0 for d in shape):
            return None  # symbolic/variable dim
        total += int(np.prod(shape)) * np.dtype(t.dtype.np_dtype).itemsize
    return total


class _Predictor:
    """One prediction walk: counts + bytes, shared caps resolution."""

    def __init__(self, pipeline, n_buffers: int, source_residency: str):
        self.pipeline = pipeline
        self.n_buffers = n_buffers
        self.source_residency = source_residency
        self.state: Dict[int, State] = {}
        self.per: Dict[str, Dict[str, int]] = {}
        self.per_bytes: Dict[str, Dict[str, int]] = {}
        # mesh-sharded filters only: the per-DEVICE slice of each billed
        # crossing (total/dp — divisibility is the NNST470 proof), the
        # static side of the tracer's `<dir>_bytes_per_device` counters
        self.per_dev: Dict[str, Dict[str, int]] = {}
        self.unmodeled: List[str] = []
        self.bytes_unknown: List[str] = []
        self._capmap: Optional[Dict[int, object]] = None

    # -- caps resolution ---------------------------------------------------
    def _dry_run_caps(self) -> Dict[int, object]:
        """Analyzer dry-run negotiation for graphs that never negotiated
        live (lint time). Diagnostics are discarded — the negotiation
        pass owns them; this walk only wants the byte sizes."""
        if self._capmap is None:
            from nnstreamer_tpu_torch.analysis import nego

            self._capmap = nego.dry_run_quiet_cached(self.pipeline)
        return self._capmap

    def pad_bytes(self, pad) -> Optional[int]:
        if pad is None:
            return None
        caps = getattr(pad, "caps", None)
        if caps is None:
            caps = self._dry_run_caps().get(id(pad))
        return caps_nbytes(caps)

    # -- billing -----------------------------------------------------------
    def bill(self, e, direction: str, n: int,
             nbytes: Optional[int] = None) -> None:
        if n > 0:
            self.per.setdefault(
                e.name, {"h2d": 0, "d2h": 0})[direction] += n
            if nbytes is None:
                if e.name not in self.bytes_unknown:
                    self.bytes_unknown.append(e.name)
            else:
                self.per_bytes.setdefault(
                    e.name, {"h2d": 0, "d2h": 0})[direction] += int(nbytes)

    def set_out(self, e, units: int, res: str) -> None:
        for sp in e.src_pads:
            self.state[id(sp)] = (units, res)

    def in_states(self, e) -> Optional[List[State]]:
        ins = []
        for p in e.sink_pads:
            if p.peer is None or id(p.peer) not in self.state:
                continue
            ins.append(self.state[id(p.peer)])
        return ins or None

    # -- the walk ----------------------------------------------------------
    def run(self) -> Dict:
        for e in self.pipeline._topo_order():
            self._predict_element(e)
        totals = {"h2d": sum(c["h2d"] for c in self.per.values()),
                  "d2h": sum(c["d2h"] for c in self.per.values())}
        byte_totals = {
            "h2d": sum(c["h2d"] for c in self.per_bytes.values()),
            "d2h": sum(c["d2h"] for c in self.per_bytes.values())}
        return {
            "per_element": self.per,
            "per_element_bytes": self.per_bytes,
            "per_element_bytes_per_device": self.per_dev,
            "h2d": totals["h2d"], "d2h": totals["d2h"],
            "h2d_bytes": byte_totals["h2d"], "d2h_bytes": byte_totals["d2h"],
            "unmodeled": self.unmodeled,
            "bytes_unknown": self.bytes_unknown,
        }

    def _predict_element(self, e) -> None:
        from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
        from nnstreamer_tpu_torch.elements.filter import TensorFilter
        from nnstreamer_tpu_torch.elements.mux import TensorMerge, TensorSplit
        from nnstreamer_tpu_torch.elements.transform import TensorTransform
        from nnstreamer_tpu_torch.pipeline.element import SourceElement
        from nnstreamer_tpu_torch.pipeline.planner import is_transparent

        if isinstance(e, SourceElement):
            from nnstreamer_tpu_torch.elements.query import TensorQueryServerSrc

            if isinstance(e, TensorQueryServerSrc) \
                    and e.properties.get("serve"):
                # serving source: each emitted buffer is one PADDED
                # serve-batch (the batched caps carry the serve-batch
                # leading dim, so pad rows are modeled as the real
                # bytes they cost — repeated-last-row padding crosses
                # the link like any other row).  n_buffers counts
                # BATCHES here.  With engaged sharded placement the
                # batch crosses H2D at THIS element, straight into the
                # per-shard layout, and flows on as device-resident.
                placement = None
                if getattr(e, "_pool_placement", None) is not None:
                    try:
                        placement = e._resolve_placement()
                    except Exception:  # noqa: BLE001 — advisory model
                        placement = None
                if placement is not None:
                    out_b = self.pad_bytes(
                        e.src_pads[0] if e.src_pads else None)
                    dp = int(placement["dp"])
                    self.bill(e, "h2d", self.n_buffers,
                              _mul(self.n_buffers, out_b))
                    if out_b is not None and dp > 1:
                        self.per_dev.setdefault(
                            e.name, {"h2d": 0, "d2h": 0})["h2d"] += \
                            (self.n_buffers * int(out_b)) // dp
                    self.set_out(e, self.n_buffers, "device")
                    return
            self.set_out(e, self.n_buffers, self.source_residency)
            return
        ins = self.in_states(e)
        if ins is None:
            return  # nothing reaches this element (dangling/unreachable)
        units = min(u for u, _ in ins)
        res = _combine_res(ins)

        if isinstance(e, TensorFilter):
            if e._fused_into is not None:
                # chain-fused shell: its model runs inside the head's
                # composed program — the interior link bills ZERO bytes
                # (buffers pass through untouched); the chain's single
                # boundary bills the COMPOSED output wherever the
                # planner placed it (the head's caps already carry the
                # end-of-chain payload)
                self.set_out(e, units, res)
                return
            self._predict_filter(e, units, res)
            return
        if isinstance(e, TensorTransform):
            self._predict_transform(e, units, res)
            return
        # filter/transform resolve their own byte sizes above
        in_b = self.pad_bytes(e.sink_pads[0] if e.sink_pads else None)
        if isinstance(e, TensorDecoder):
            accepts = e.accepts_device(e.sink_pads[0])
            split = int(e.properties.get("split_batch", 0) or 0)
            if res != "host" and not accepts:
                self.bill(e, "d2h", units,
                          _mul(units, in_b))
                res = "host"
            self.set_out(e, units * split if split > 1 else units, "host")
            return
        if isinstance(e, TensorMerge):
            if res != "host":
                # one pipelined fetch per emission covering every
                # device-resident sink pad's payload
                pad_bs = []
                for p in e.sink_pads:
                    if p.peer is not None and id(p.peer) in self.state \
                            and self.state[id(p.peer)][1] != "host":
                        pad_bs.append(self.pad_bytes(p))
                total_b = (sum(pad_bs) if pad_bs and
                           all(b is not None for b in pad_bs) else None)
                self.bill(e, "d2h", units, _mul(units, total_b))
            self.set_out(e, units, "host")
            return
        if isinstance(e, TensorSplit):
            if res != "host":
                self.bill(e, "d2h", units, _mul(units, in_b))
            self.set_out(e, units, "host")
            return
        if type(e).__name__ in ("TensorSink", "FileSink"):
            if res != "host" and not e.accepts_device(e.sink_pads[0]):
                self.bill(e, "d2h", units, _mul(units, in_b))
            return
        if is_transparent(e) or not e.src_pads:
            self.set_out(e, units, res)
            return
        # anything else: only matters when device data reaches it
        if res != "host":
            self.unmodeled.append(e.name)
        self.set_out(e, units, res)

    def _predict_filter(self, e, units: int, res: str) -> None:
        device_capable = e._fw_device_capable()
        batch = int(e.properties.get("batch_size", 1) or 1)
        invokes = math.ceil(units / batch) if units else 0
        in_b = self._filter_input_bytes(e)
        out_b = self.pad_bytes(e.src_pads[0] if e.src_pads else None)
        # steady-loop window: N frames cross as ONE windowed H2D (the
        # staged ring, padding included — padded rows really upload)
        # and ONE windowed D2H (the stacked drain); outputs land host
        # at the drain, so the filter IS the boundary.  A planned/
        # playing pipeline reads the installed ground truth
        # (_loop_state); at lint time the shared static resolution
        # decides — either way the loop never engages where the runtime
        # would fall back.
        loopw = 0
        if device_capable and units:
            state = getattr(e, "_loop_state", None)
            if state is not None:
                loopw = int(state["window"])
            elif not getattr(self.pipeline, "_loop_planned", False):
                from nnstreamer_tpu_torch.analysis.loop import (
                    runtime_loop_config,
                )

                loopw, _ = runtime_loop_config(self.pipeline, e)
        if loopw > 1:
            windows = math.ceil(units / loopw)
            self.bill(e, "h2d", windows, _mul(windows * loopw, in_b))
            self.bill(e, "d2h", windows, _mul(windows * loopw, out_b))
            self.set_out(e, units, "host")
            return
        # mesh partition (analysis/shard.py): the dp axis an engaged
        # shard splits each transfer across — runtime_shard_config IS
        # the single shared resolution (installed ground truth once the
        # planner decided, the static resolution at lint time), so this
        # byte model can never diverge from the memplan/tuner billing
        shard_dp = 1
        if device_capable and units:
            from nnstreamer_tpu_torch.analysis.shard import runtime_shard_config

            scfg = runtime_shard_config(self.pipeline, e)
            if scfg is not None:
                shard_dp = int(scfg["dp"])

        def bill_sharded(direction: str, n: int, nbytes) -> None:
            self.bill(e, direction, n, nbytes)
            if shard_dp > 1 and nbytes is not None:
                self.per_dev.setdefault(
                    e.name, {"h2d": 0, "d2h": 0})[direction] += \
                    int(nbytes) // shard_dp

        # one invoke moves the whole assembled micro-batch, EOS padding
        # included (the padded rows are uploaded/fetched too)
        per_invoke_in = _mul(batch, in_b)
        per_invoke_out = _mul(batch, out_b)
        if device_capable:
            if res != "device":
                # inline upload / prefetch / mixed batch assembly: one
                # pipelined put per invoke entry, billed at exactly one site
                bill_sharded("h2d", invokes, _mul(invokes, per_invoke_in))
        elif res != "host":
            # host-only backend fed device arrays: one pipelined fetch per
            # invoke (_invoke's billed materialize path)
            self.bill(e, "d2h", invokes, _mul(invokes, per_invoke_in))
            self.set_out(e, units, "host")
            return
        cross_here = bool(
            e.properties.get("sync") or e.properties.get("invoke_dynamic")
            or (e.src_pads and e.src_pads[0].device_ok is False))
        if device_capable and cross_here and invokes:
            window = e._fetch_window_size()
            flushes = math.ceil(invokes / window) if window > 1 else invokes
            bill_sharded("d2h", flushes, _mul(invokes, per_invoke_out))
        out_res = ("device" if device_capable and e.produces_device(
            e.src_pads[0] if e.src_pads else None) and not cross_here
            and (e.src_pads and e.src_pads[0].device_ok is True) else "host")
        self.set_out(e, units, out_res)

    def _filter_input_bytes(self, e) -> Optional[int]:
        """Per-buffer bytes the filter actually uploads: the sink caps,
        narrowed by input-combination (unselected tensors never reach the
        backend, so their bytes never cross)."""
        import numpy as np

        sink0 = e.sink_pads[0] if e.sink_pads else None
        if sink0 is None:
            return None
        caps = getattr(sink0, "caps", None)
        if caps is None:
            caps = self._dry_run_caps().get(id(sink0))
        sel = e.properties.get("input_combination")
        if not sel:
            return caps_nbytes(caps)
        if caps is None:
            return None
        try:
            info = caps.to_config().info
            idx = [int(i) for i in str(sel).split(",")]
            total = 0
            for i in idx:
                t = info.tensors[i]
                shape = t.np_shape()
                if any(int(d) <= 0 for d in shape):
                    return None
                total += int(np.prod(shape)) * \
                    np.dtype(t.dtype.np_dtype).itemsize
            return total
        except Exception:  # noqa: BLE001 — malformed selection: unknown
            return None

    def _predict_transform(self, e, units: int, res: str) -> None:
        in_b = self.pad_bytes(e.sink_pads[0] if e.sink_pads else None)
        out_b = self.pad_bytes(e.src_pads[0] if e.src_pads else None)
        if e._fused_into is not None:
            self.set_out(e, units, res)
            return
        device_path = e._device_accel() and e._statically_device_eligible()
        if device_path:
            if res != "device":
                self.bill(e, "h2d", units, _mul(units, in_b))
            boundary = e.src_pads and e.src_pads[0].device_ok is False
            if boundary:
                self.bill(e, "d2h", units, _mul(units, out_b))
                self.set_out(e, units, "host")
            else:
                self.set_out(e, units, "device")
            return
        if res != "host":
            # host math on device buffers: one billed pipelined fetch per
            # chain
            self.bill(e, "d2h", units, _mul(units, in_b))
        self.set_out(e, units, "host")


def _mul(n: int, b: Optional[int]) -> Optional[int]:
    return None if b is None else int(n) * int(b)


def predict_crossings(pipeline, n_buffers: int = 1,
                      source_residency: str = "host") -> Dict:
    """Expected crossings (counts and, where caps resolve, bytes) for
    ``n_buffers`` per source. Plans residency on an unplanned graph (same
    pass set_state runs at PLAYING); a pipeline already planned/playing
    is read as-is."""
    from nnstreamer_tpu_torch.pipeline.planner import _plan_residency

    all_src = [sp for e in pipeline.elements.values() for sp in e.src_pads]
    if all_src and all(sp.device_ok is None for sp in all_src):
        _plan_residency(pipeline)
    return _Predictor(pipeline, n_buffers, source_residency).run()


def _combine_res(states: List[State]) -> str:
    rs = {r for _, r in states}
    if rs == {"device"}:
        return "device"
    if rs == {"host"}:
        return "host"
    return "mixed"


def parity_mismatches(predicted: Dict, tracer_crossings: Dict,
                      check_bytes: bool = True) -> List[str]:
    """Compare a prediction against Tracer.crossings(); returns human-
    readable mismatch lines (empty = parity holds). Byte parity is
    asserted wherever the static model resolved the edge caps
    (``check_bytes=False`` restores the counts-only comparison)."""
    out: List[str] = []
    pred = predicted["per_element"]
    pred_b = predicted.get("per_element_bytes", {})
    unknown = set(predicted.get("bytes_unknown", ()))
    seen = tracer_crossings.get("per_element", {})
    for name in sorted(set(pred) | set(seen)):
        p = pred.get(name, {"h2d": 0, "d2h": 0})
        s = seen.get(name, {})
        for d in ("h2d", "d2h"):
            if p.get(d, 0) != s.get(d, 0):
                out.append(f"{name}.{d}: predicted {p.get(d, 0)}, "
                           f"traced {s.get(d, 0)}")
        if not check_bytes or name in unknown:
            continue
        pb = pred_b.get(name, {"h2d": 0, "d2h": 0})
        for d in ("h2d", "d2h"):
            if pb.get(d, 0) != s.get(d + "_bytes", 0):
                out.append(
                    f"{name}.{d}_bytes: predicted {pb.get(d, 0)}, "
                    f"traced {s.get(d + '_bytes', 0)}")
        # mesh-sharded filters: the per-DEVICE slice of each crossing
        # must match the tracer's sharded-transfer counters too (the
        # static per-shard model vs the runtime's devices= billing)
        pd = predicted.get("per_element_bytes_per_device", {}).get(name)
        if pd is not None:
            for d in ("h2d", "d2h"):
                if pd.get(d, 0) != s.get(d + "_bytes_per_device", 0):
                    out.append(
                        f"{name}.{d}_bytes_per_device: predicted "
                        f"{pd.get(d, 0)}, traced "
                        f"{s.get(d + '_bytes_per_device', 0)}")
    return out
