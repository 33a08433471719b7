"""Static caps dry-run negotiation (counterpart of the JAX package's
``analysis/nego.py``, its quiet form).

Propagates each source's advertised caps through the graph WITHOUT
entering PLAYING and without pushing real caps events: per element it
calls the same ``transform_caps`` logic the runtime uses. Elements whose
output depends on an unopened model (a tensor_filter before NULL→READY
with no declared output) stop propagation. The cost model's
input-signature resolution and the residency byte model read the result
where live pad caps are not there yet (lint time, the PLAYING planner
before the sources start).

The JAX package's NNST2xx diagnostics wait with its analyzer registry;
this module emits none.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def dry_run_quiet(pipeline) -> Dict[int, object]:
    """{id(pad): Caps} for every pad the dry negotiation reached. Never
    raises: an unresolvable graph yields an empty map."""
    try:
        return _dry_run(pipeline)
    except Exception:  # noqa: BLE001 — advisory callers degrade to {}
        return {}


def dry_run_quiet_cached(pipeline) -> Dict[int, object]:
    """:func:`dry_run_quiet` memoized on the pipeline object (keyed by a
    cheap graph fingerprint: element count + linked-pad count), so one
    analysis run pays ONE dry negotiation. Call sites prefer LIVE pad
    caps over this map, so a stale entry only ever serves a graph
    re-analyzed without relinking."""
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


def _dry_run(pipeline) -> Dict[int, object]:
    from nnstreamer_tpu_torch.caps import Caps
    from nnstreamer_tpu_torch.pipeline.element import SourceElement

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
        # refuse to spin on pad-linked cycles
        deliveries[id(pad)] = deliveries.get(id(pad), 0) + 1
        if deliveries[id(pad)] > 2:
            continue
        inter = caps.intersect(pad.template)
        if inter.is_empty():
            continue
        fixed = inter.fixate() if not inter.is_fixed() else inter
        pad_caps[id(pad)] = fixed
        for sp, out in _react(pad.element, pad, fixed, combiner_cfgs):
            pad_caps[id(sp)] = out
            if sp.peer is not None:
                work.append((sp.peer, out))
    return pad_caps


def _react(e, pad, fixed, combiner_cfgs) -> List[tuple]:
    """One element's static reaction to fixed caps on a sink pad:
    [(src_pad, out_caps)] to keep propagating (possibly empty)."""
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.elements.flow import TensorCrop
    from nnstreamer_tpu_torch.elements.mux import (
        TensorDemux,
        TensorSplit,
        _SyncCombiner,
    )

    try:
        if isinstance(e, TensorFilter):
            out = _filter_out_caps(e, fixed)
        elif isinstance(e, _SyncCombiner):
            return _combiner_react(e, pad, fixed, combiner_cfgs)
        elif isinstance(e, TensorDemux):
            return _demux_react(e, fixed)
        elif isinstance(e, TensorSplit):
            caps_list = e.split_out_caps(fixed.to_config()) or []
            return [(sp, c) for sp, c in zip(e.src_pads, caps_list)
                    if c is not None]
        elif isinstance(e, TensorCrop):
            out = _flexible_like(fixed) if pad.name == "raw" else None
        elif isinstance(e, TensorDecoder):
            out = _decoder_out_caps(e, fixed)
        else:
            out = e.transform_caps(pad, fixed)
    except Exception:  # noqa: BLE001 — a failed negotiation stops here
        return []
    if out is None:
        return []
    return [(sp, out) for sp in e.src_pads]


def _flexible_like(fixed):
    from nnstreamer_tpu_torch.caps import Caps
    from nnstreamer_tpu_torch.types import (
        TensorFormat,
        TensorsConfig,
        TensorsInfo,
    )

    cfg = fixed.to_config()
    return Caps.from_config(TensorsConfig(
        TensorsInfo(format=TensorFormat.FLEXIBLE), cfg.rate_n, cfg.rate_d))


def _filter_out_caps(e, fixed):
    """tensor_filter statically: output caps from declared output
    overrides or the open model; None when the model info is simply not
    known yet."""
    from nnstreamer_tpu_torch.caps import Caps
    from nnstreamer_tpu_torch.types import (
        TensorFormat,
        TensorsConfig,
        TensorsInfo,
    )

    cfg = fixed.to_config()
    if e.properties.get("invoke_dynamic"):
        return Caps.from_config(TensorsConfig(
            TensorsInfo(format=TensorFormat.FLEXIBLE),
            cfg.rate_n, cfg.rate_d))
    if e.properties.get("output") and e.properties.get("outputtype"):
        if e.properties.get("output_combination"):
            return None
        out_info = TensorsInfo.from_strings(
            str(e.properties["output"]), str(e.properties["outputtype"]),
            e.properties.get("outputname"))
        return Caps.from_config(TensorsConfig(out_info, cfg.rate_n,
                                              cfg.rate_d))
    if e.fw is not None and e._out_info is not None:
        return e.transform_caps(e.sink_pads[0], fixed)
    return None


def _decoder_out_caps(e, fixed):
    """Instantiate the decoder subplugin statically (no element state
    change) and ask it for out caps."""
    from nnstreamer_tpu_torch import registry as reg

    if e._dec is not None:
        return e.transform_caps(e.sink_pads[0], fixed)
    mode = e.properties.get("mode")
    cls = (reg.get(reg.CUSTOM_DECODER, str(mode))
           or reg.get(reg.DECODER, str(mode))) if mode else None
    if cls is None:
        return None
    dec = cls() if callable(cls) else cls
    opts = [str(e.properties[f"option{i}"]) if f"option{i}" in e.properties
            else None for i in range(1, 10)]
    try:
        dec.init(opts)
        return dec.get_out_caps(fixed.to_config())
    finally:
        try:
            dec.exit()
        except Exception:  # noqa: BLE001 — static probe teardown only
            pass


def _combiner_react(e, pad, fixed, combiner_cfgs) -> List[tuple]:
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
