"""Static caps/shape/dtype dry-run negotiation (pass NNST2xx; counterpart
of the JAX package's ``analysis/nego.py``).

Propagates fixed caps from sources through the graph WITHOUT opening
models, entering PLAYING or pushing real caps events (which would run the
live negotiation machinery and mutate pad state): per element it calls
the same ``transform_caps`` logic the runtime uses, in a try/except that
converts failures into attributed diagnostics instead of a bus error at
play time.

Elements whose output depends on an unopened model (a tensor_filter
before NULL→READY with no declared output) stop propagation with an
*info* diagnostic (NNST202) — the dry run is best-effort by design, never
a false error. :func:`dry_run_quiet` is the same run with the
diagnostics discarded: the cost model's input-signature resolution and
the residency byte model read it where live pad caps are not there yet
(lint time, the PLAYING planner before the sources start).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import ElementError


def dry_run_quiet(pipeline) -> Dict[int, object]:
    """``dry_run`` with diagnostics discarded — for callers that only
    want the statically negotiated caps (the residency byte model and
    the cost model's input-signature resolution). Never raises: an
    unresolvable graph yields an empty map."""

    class _NullCtx:
        def emit(self, *a, **k):
            return None

    ctx = _NullCtx()
    ctx.pipeline = pipeline
    try:
        return dry_run(ctx)
    except Exception:  # noqa: BLE001 — advisory callers degrade to {}
        return {}


def dry_run_quiet_cached(pipeline) -> Dict[int, object]:
    """``dry_run_quiet`` memoized on the pipeline object (keyed by a
    cheap graph fingerprint: element count + linked-pad count) so one
    analysis run pays ONE dry negotiation instead of one per pass per
    filter. Call sites always prefer LIVE pad caps over this map, so a
    stale entry only ever serves a graph re-analyzed without
    relinking."""
    fp = (len(pipeline.elements),
          sum(1 for e in pipeline.elements.values()
              for p in list(e.sink_pads) + list(e.src_pads)
              if p.peer is not None))
    cached = pipeline.__dict__.get("_nncost_capmap")
    if cached is not None and cached[0] == fp:
        return cached[1]
    caps = dry_run_quiet(pipeline)
    pipeline.__dict__["_nncost_capmap"] = (fp, caps)
    return caps


def dry_run(ctx) -> Dict[int, object]:
    """Run the dry negotiation, emitting NNST2xx via ``ctx.emit``.
    Returns {id(pad): Caps} for every pad a verdict reached."""
    from nnstreamer_tpu_torch.caps import Caps
    from nnstreamer_tpu_torch.pipeline.element import SourceElement

    pipeline = ctx.pipeline
    pad_caps: Dict[int, object] = {}
    combiner_cfgs: Dict[int, dict] = {}
    deliveries: Dict[int, int] = {}
    work: List[Tuple[object, object]] = []  # (sink_pad, caps)

    for e in pipeline.elements.values():
        if not isinstance(e, SourceElement):
            continue
        try:
            caps = e.negotiate()
        except Exception:  # noqa: BLE001 — source needs resources: unknown
            caps = None
        if caps is None:
            continue
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        for sp in e.src_pads:
            pad_caps[id(sp)] = caps
            if sp.peer is not None:
                work.append((sp.peer, caps))

    while work:
        pad, caps = work.pop(0)
        # cycle guard: the graph pass flags pad-linked cycles; here just
        # refuse to spin on them
        deliveries[id(pad)] = deliveries.get(id(pad), 0) + 1
        if deliveries[id(pad)] > 2:
            continue
        e = pad.element
        inter = caps.intersect(pad.template)
        if inter.is_empty():
            ctx.emit(
                "NNST200", e,
                f"caps {caps} do not intersect sink pad {pad.name!r} "
                f"template {pad.template}")
            continue
        fixed = inter.fixate() if not inter.is_fixed() else inter
        pad_caps[id(pad)] = fixed
        for sp, out in _react(ctx, e, pad, fixed, combiner_cfgs):
            pad_caps[id(sp)] = out
            if sp.peer is not None:
                work.append((sp.peer, out))
    return pad_caps


def _react(ctx, e, pad, fixed, combiner_cfgs) -> List[tuple]:
    """One element's static reaction to fixed caps on a sink pad:
    [(src_pad, out_caps)] to keep propagating (possibly empty)."""
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.flow import TensorCrop
    from nnstreamer_tpu_torch.elements.mux import TensorDemux, TensorSplit, _SyncCombiner

    try:
        if isinstance(e, TensorFilter):
            out = _filter_out_caps(ctx, e, fixed)
        elif isinstance(e, _SyncCombiner):
            return _combiner_react(ctx, e, pad, fixed, combiner_cfgs)
        elif isinstance(e, TensorDemux):
            return _demux_react(e, fixed)
        elif isinstance(e, TensorSplit):
            return _split_react(e, fixed)
        elif isinstance(e, TensorCrop):
            out = _flexible_like(fixed) if pad.name == "raw" else None
        elif isinstance(e, TensorDecoder):
            out = _decoder_out_caps(ctx, e, fixed)
        else:
            out = e.transform_caps(pad, fixed)
    except ElementError as err:
        ctx.emit("NNST201", e, f"static negotiation failed: {err}")
        return []
    except Exception as err:  # noqa: BLE001 — bad option grammar etc.
        ctx.emit("NNST201", e,
                 f"static negotiation failed: {type(err).__name__}: {err}")
        return []
    if out is None:
        return []
    return [(sp, out) for sp in e.src_pads]


def _flexible_like(fixed):
    from nnstreamer_tpu_torch.caps import Caps
    from nnstreamer_tpu_torch.types import TensorFormat, TensorsConfig, TensorsInfo

    cfg = fixed.to_config()
    return Caps.from_config(TensorsConfig(
        TensorsInfo(format=TensorFormat.FLEXIBLE), cfg.rate_n, cfg.rate_d))


def _filter_out_caps(ctx, e, fixed):
    """tensor_filter statically: check declared input overrides against
    the incoming stream (NNST203), then derive output caps from declared
    output overrides / the open model — or stop with NNST202 when the
    model info is simply not known yet."""
    from nnstreamer_tpu_torch.caps import Caps
    from nnstreamer_tpu_torch.types import TensorFormat, TensorsConfig, TensorsInfo

    cfg = fixed.to_config()
    in_info = cfg.info
    sel = e.properties.get("input_combination")
    if sel and in_info.num_tensors > 0:
        try:
            idx = [int(i) for i in str(sel).split(",")]
            in_info = TensorsInfo(tensors=[in_info.tensors[i] for i in idx],
                                  format=in_info.format)
        except Exception:  # noqa: BLE001 — bad combination spec
            ctx.emit("NNST201", e,
                     f"input-combination {sel!r} does not select from "
                     f"{in_info.num_tensors} incoming tensor(s)")
            return None
    if (e.properties.get("input") and e.properties.get("inputtype")
            and cfg.format == TensorFormat.STATIC
            and in_info.num_tensors > 0 and not e._fused_pre):
        declared = TensorsInfo.from_strings(
            str(e.properties["input"]), str(e.properties["inputtype"]),
            e.properties.get("inputname"))
        if declared.num_tensors > 0 and not (declared == in_info):
            ctx.emit(
                "NNST203", e,
                f"incoming tensors {in_info.dimensions_string()}/"
                f"{in_info.types_string()} do not match the declared input "
                f"{declared.dimensions_string()}/{declared.types_string()}",
                hint="fix the input/input-type properties or the upstream "
                     "caps; a reshapable backend may still adapt at "
                     "runtime")
            return None
    if e.properties.get("invoke_dynamic"):
        return Caps.from_config(TensorsConfig(
            TensorsInfo(format=TensorFormat.FLEXIBLE),
            cfg.rate_n, cfg.rate_d))
    out_info = None
    if e.properties.get("output") and e.properties.get("outputtype"):
        out_info = TensorsInfo.from_strings(
            str(e.properties["output"]), str(e.properties["outputtype"]),
            e.properties.get("outputname"))
    elif e.fw is not None and e._out_info is not None:
        return e.transform_caps(e.sink_pads[0], fixed)
    if out_info is None:
        ctx.emit(
            "NNST202", e,
            "output caps unknown before the model opens; static "
            "negotiation stops here (declare output/output-type to lint "
            "the downstream chain)")
        return None
    if e.properties.get("output_combination"):
        # combination mixes inputs back in; model outputs unknown → stop
        ctx.emit("NNST202", e,
                 "output-combination references model outputs that are "
                 "unknown before the model opens")
        return None
    return Caps.from_config(TensorsConfig(out_info, cfg.rate_n, cfg.rate_d))


def _decoder_out_caps(ctx, e, fixed):
    """Instantiate the decoder subplugin statically (no element state
    change) and ask it for out caps; unknown modes were already flagged
    by the properties pass."""
    from nnstreamer_tpu_torch import registry as reg

    if e._dec is not None:
        return e.transform_caps(e.sink_pads[0], fixed)
    mode = e.properties.get("mode")
    cls = (reg.get(reg.CUSTOM_DECODER, str(mode))
           or reg.get(reg.DECODER, str(mode))) if mode else None
    if cls is None:
        return None  # NNST104/NNST105 cover it
    dec = cls() if callable(cls) else cls
    opts = [
        str(e.properties[f"option{i}"]) if f"option{i}" in e.properties
        else None
        for i in range(1, 10)
    ]
    try:
        dec.init(opts)
        return dec.get_out_caps(fixed.to_config())
    finally:
        try:
            dec.exit()
        except Exception:  # noqa: BLE001 — static probe teardown only
            pass


def _combiner_react(ctx, e, pad, fixed, combiner_cfgs) -> List[tuple]:
    """mux/merge: collect per-pad configs; once complete, compute the
    combined caps with the element's own logic (state swapped in and out
    so nothing sticks)."""
    cfgs = combiner_cfgs.setdefault(id(e), {})
    cfgs[pad.name] = fixed.to_config()
    if len(cfgs) < len(e.sink_pads):
        return []
    saved = e._pad_configs
    e._pad_configs = dict(cfgs)
    try:
        out = e._combined_caps()
    except ElementError as err:
        ctx.emit("NNST204", e, f"combiner pads disagree: {err}")
        return []
    finally:
        e._pad_configs = saved
    if out is None:
        return []
    return [(sp, out) for sp in e.src_pads]


def _demux_react(e, fixed) -> List[tuple]:
    saved = e._config
    e._config = fixed.to_config()
    try:
        out = []
        for i, sp in enumerate(e.src_pads):
            c = e._pad_caps(i)
            if c is not None:
                out.append((sp, c.fixate() if not c.is_fixed() else c))
        return out
    finally:
        e._config = saved


def _split_react(e, fixed) -> List[tuple]:
    cfg = fixed.to_config()
    caps_list = e.split_out_caps(cfg)
    if caps_list is None:
        return []
    return [(sp, c) for sp, c in zip(e.src_pads, caps_list) if c is not None]
