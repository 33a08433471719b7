"""nndeploy — fleet-level static deployment analyzer (NNST99x;
counterpart of the JAX package's ``analysis/deploy.py``).

Every other NNST pass validates ONE pipeline in ONE process. A real
edge-AI deployment is N processes — camera clients, query servers,
MQTT bridges — wired over endpoints, sharing chips, fronting several
models. This pass cross-links the members' existing per-pipeline
analyses into fleet verdicts over a *deployment spec*:

    # comment
    device <name> [hbm=<bytes, K/M/G/T suffixes>]
    offered-rps <float>
    slo-ms <float>
    member <name> [role=client|server] [device=<device>]
    <launch line>                      # the next non-directive line

Verdicts (all zero-compile: property reads, caps intersection,
meta-device costs, cache stats — byte-identical across runs):

  NNST990  info     deployment summary: members, wiring graph,
                    per-device co-resident sets
  NNST991  error    broken wiring: client endpoint with no matching
                    server, port collision, MQTT topic mismatch,
                    dangling HYBRID discovery topic, spec errors
  NNST992  error    client↔server signature mismatch across the wire
                    (static dry-run nego: the client's negotiated
                    request caps cannot intersect the server's declared
                    caps — NNST2xx/900 generalized across processes)
  NNST993  error    fleet SLO infeasible: declared offered load exceeds
                    the summed plant-model capacity of the serving
                    members at their nnpool replica counts (NNST950
                    lifted to the fleet)
  NNST994  error    per-device HBM overcommit: co-resident members'
                    memplan totals jointly exceed the device budget
                    (with an evict/repack hint)
  NNST995  error    rollout hazard: a rollout-model candidate fails the
                    static shape/dtype link against live traffic, or
                    hedging targets an endpoint without _rid dedup
  NNST996  warning  cold-start exposure: which members compile at
                    PLAYING, with the estimated fleet warm-up cost

Wired as an EXPLICIT pass ("deploy"): it never runs unless named, so
single-pipeline ``validate`` output is byte-identical when unused.
Entry point: :func:`analyze_deploy` (``validate --deploy <spec>``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.analysis.diagnostics import Diagnostic, sort_diagnostics


# ---------------------------------------------------------------------------
# deployment spec


@dataclass
class DeviceDecl:
    name: str
    hbm_bytes: Optional[int]  # None: device_memory_budget() default
    line: int
    text: str  # the raw spec line (span source)


@dataclass
class DeployMember:
    name: str
    role: str  # "client" | "server" | "auto"
    device: Optional[str]
    header_line: int
    header_text: str
    launch: str = ""
    line: int = 0  # 1-based spec line of the launch line
    pipeline: object = None
    endpoints: list = field(default_factory=list)  # WireEndpoint list


@dataclass
class DeploySpec:
    path: str
    devices: Dict[str, DeviceDecl] = field(default_factory=dict)
    members: List[DeployMember] = field(default_factory=list)
    offered_rps: Optional[float] = None
    offered_line: int = 0
    offered_text: str = ""
    slo_ms: Optional[float] = None


class Fleet:
    """The deploy pass's analysis subject: the spec plus every member's
    constructed pipeline. Duck-types the little the registry touches
    (``_source``/``elements``) so :func:`run_passes` can host it."""

    is_fleet = True

    def __init__(self, spec: DeploySpec):
        self.spec = spec
        self.elements: Dict[str, object] = {}
        self._source = None
        # filled by the pass, kept for tests (NNST994 parity) and for
        # downstream consumers (balancer/autoscaler per ROADMAP 1/3/5)
        self.memplans: Dict[str, dict] = {}
        self.capacities: Dict[str, float] = {}


def _spec_error(diags: List[Diagnostic], path: str, line: int, text: str,
                message: str, hint: Optional[str] = None) -> None:
    diags.append(Diagnostic(
        code="NNST991", element="spec", message=f"spec error: {message}",
        hint=hint, span=(0, len(text)), source=text, path=path, line=line))


def parse_deploy_text(text: str, path: str
                      ) -> Tuple[DeploySpec, List[Diagnostic]]:
    """Parse a deployment spec. Malformed directives become NNST991
    diagnostics (the spec IS fleet wiring configuration), never
    exceptions — a broken spec still lints."""
    from nnstreamer_tpu_torch.analysis.memplan import _parse_bytes

    spec = DeploySpec(path=path)
    diags: List[Diagnostic] = []
    pending: Optional[DeployMember] = None
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        head = line.split()[0]
        if head == "device":
            toks = line.split()
            if len(toks) < 2:
                _spec_error(diags, path, i, line,
                            "device directive needs a name",
                            hint="device <name> [hbm=<bytes>]")
                continue
            name, hbm = toks[1], None
            for t in toks[2:]:
                k, _, v = t.partition("=")
                if k == "hbm":
                    try:
                        hbm = _parse_bytes(v)
                    except ValueError:
                        _spec_error(diags, path, i, line,
                                    f"unparseable hbm= value {v!r}",
                                    hint="bytes with optional K/M/G/T "
                                         "suffix, e.g. hbm=16G")
                else:
                    _spec_error(diags, path, i, line,
                                f"unknown device attribute {k!r}")
            if name in spec.devices:
                _spec_error(diags, path, i, line,
                            f"duplicate device {name!r}")
                continue
            spec.devices[name] = DeviceDecl(name, hbm, i, line)
        elif head in ("offered-rps", "slo-ms"):
            toks = line.split()
            try:
                val = float(toks[1])
            except (IndexError, ValueError):
                _spec_error(diags, path, i, line,
                            f"{head} needs a numeric value")
                continue
            if head == "offered-rps":
                spec.offered_rps = val
                spec.offered_line, spec.offered_text = i, line
            else:
                spec.slo_ms = val
        elif head == "member":
            if pending is not None:
                _spec_error(diags, path, pending.header_line,
                            pending.header_text,
                            f"member {pending.name!r} has no launch line")
            toks = line.split()
            if len(toks) < 2:
                _spec_error(diags, path, i, line,
                            "member directive needs a name",
                            hint="member <name> [role=client|server] "
                                 "[device=<device>]")
                pending = None
                continue
            m = DeployMember(name=toks[1], role="auto", device=None,
                             header_line=i, header_text=line)
            for t in toks[2:]:
                k, _, v = t.partition("=")
                if k == "role" and v in ("client", "server"):
                    m.role = v
                elif k == "device":
                    m.device = v
                else:
                    _spec_error(diags, path, i, line,
                                f"unknown member attribute {t!r}")
            if any(x.name == m.name for x in spec.members):
                _spec_error(diags, path, i, line,
                            f"duplicate member {m.name!r}")
                pending = None
                continue
            pending = m
        else:
            if pending is None:
                _spec_error(diags, path, i, line,
                            "launch line outside a member block",
                            hint="precede it with: member <name> "
                                 "[role=...] [device=...]")
                continue
            pending.launch = raw.rstrip("\n")
            pending.line = i
            spec.members.append(pending)
            pending = None
    if pending is not None:
        _spec_error(diags, path, pending.header_line, pending.header_text,
                    f"member {pending.name!r} has no launch line")
    for m in spec.members:
        if m.device is not None and m.device not in spec.devices:
            _spec_error(diags, path, m.header_line, m.header_text,
                        f"member {m.name!r} placed on undeclared device "
                        f"{m.device!r}",
                        hint="declare it first: device "
                             f"{m.device} [hbm=<bytes>]")
    return spec, diags


# ---------------------------------------------------------------------------
# entry point


def analyze_deploy(path: str, text: Optional[str] = None
                   ) -> Tuple[List[Diagnostic], Fleet]:
    """Lint a deployment spec: per-member pipeline analyses (with
    ``<spec>:<line>`` attribution) plus the fleet-level NNST99x pass.
    ``text`` overrides reading ``path`` (tests)."""
    from nnstreamer_tpu_torch.analysis import analyze_launch_with_pipeline
    from nnstreamer_tpu_torch.analysis.registry import run_passes

    if text is None:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    spec, diags = parse_deploy_text(text, path)
    fleet = Fleet(spec)
    for m in spec.members:
        mdiags, pipe = analyze_launch_with_pipeline(
            m.launch, cost=True, origin=(spec.path, m.line), member=m.name)
        diags.extend(mdiags)
        m.pipeline = pipe
    diags.extend(run_passes(fleet, passes=["deploy"]))
    return sort_diagnostics(diags), fleet


# ---------------------------------------------------------------------------
# the pass body (registered as "deploy" in analysis/passes.py)


def deploy_pass_body(ctx) -> None:
    fleet = getattr(ctx.pipeline, "is_fleet", False) and ctx.pipeline
    if not fleet:
        return  # a regular pipeline: fleet verdicts do not apply
    from nnstreamer_tpu_torch.edge.wiring import endpoints_of

    spec = fleet.spec
    for m in spec.members:
        m.endpoints = endpoints_of(m.pipeline) if m.pipeline is not None \
            else []
    _check_wiring(ctx, spec)
    _check_signatures(ctx, spec)
    _check_capacity(ctx, spec, fleet)
    _check_packing(ctx, spec, fleet)
    _check_rollout_hazards(ctx, spec)
    _check_cold_start(ctx, spec)
    _emit_summary(ctx, spec)


def _m_origin(spec: DeploySpec, m: DeployMember):
    return (spec.path, m.line)


def _emit_member(ctx, code: str, spec: DeploySpec, m: DeployMember, ep,
                 message: str, hint: Optional[str] = None,
                 span=None, prop: Optional[str] = None) -> None:
    """Emit one member-attributed verdict: element = the wiring element,
    span = its (property) token inside the member's launch line, cited
    at ``<spec>:<line>``."""
    if span is None and prop is not None and ep is not None:
        span = ep.prop_span(prop)
    if span is None and ep is not None:
        span = getattr(ep.element, "_span", None)
    ctx.emit(code, ep.name if ep is not None else "member", message,
             hint=hint, span=span, member=m.name,
             origin=_m_origin(spec, m), source=m.launch)


def _servers(spec: DeploySpec):
    for m in spec.members:
        for ep in m.endpoints:
            if ep.kind == "server":
                yield m, ep


def _clients(spec: DeploySpec):
    for m in spec.members:
        for ep in m.endpoints:
            if ep.kind == "client":
                yield m, ep


# -- NNST991 ---------------------------------------------------------------


def _check_wiring(ctx, spec: DeploySpec) -> None:
    listeners: Dict[int, Tuple[DeployMember, object]] = {}
    for m, ep in _servers(spec):
        if ep.transport == "mqtt" or not ep.port:
            continue  # mqtt matches on topic; port 0 = auto-assign
        if ep.port in listeners:
            om, oep = listeners[ep.port]
            _emit_member(
                ctx, "NNST991", spec, m, ep,
                f"port collision: {ep.name} listens on :{ep.port}, "
                f"already claimed by {om.name}/{oep.name} — the second "
                f"bind fails at start",
                hint="give each server member a distinct port",
                prop="port")
        else:
            listeners[ep.port] = (m, ep)
    hybrid_topics = {ep.topic for _, ep in _servers(spec)
                     if ep.transport in ("query", "edge")
                     and ep.connect_type == "HYBRID" and ep.topic}
    mqtt_topics = {ep.topic for _, ep in _servers(spec)
                   if ep.transport == "mqtt" and ep.topic}
    for m, ep in _clients(spec):
        if ep.transport == "mqtt":
            if ep.topic and ep.topic not in mqtt_topics:
                _emit_member(
                    ctx, "NNST991", spec, m, ep,
                    f"MQTT topic mismatch: {ep.name} subscribes "
                    f"{ep.topic!r} but no member publishes it"
                    + (f" (published: "
                       f"{', '.join(sorted(mqtt_topics))})"
                       if mqtt_topics else " (no mqttsink in the fleet)"),
                    hint="point an mqttsink at the same topic= or fix "
                         "the subscription",
                    prop="topic")
            continue
        if ep.connect_type == "HYBRID":
            if ep.topic and ep.topic not in hybrid_topics:
                _emit_member(
                    ctx, "NNST991", spec, m, ep,
                    f"dangling discovery scope: {ep.name} discovers "
                    f"topic {ep.topic!r} but no HYBRID server member "
                    f"announces it",
                    hint="announce the topic from a serversrc/edgesink "
                         "with connect-type=HYBRID topic="
                         f"{ep.topic}",
                    prop="topic")
            continue
        for host, port in ep.targets:
            if port not in listeners:
                _emit_member(
                    ctx, "NNST991", spec, m, ep,
                    f"client endpoint {host}:{port} has no member "
                    f"listening on it"
                    + (f" (fleet listens on: "
                       f"{', '.join(':%d' % p for p in sorted(listeners))})"
                       if listeners else " (no server member in the "
                                         "fleet)"),
                    hint="add a server member on that port or fix the "
                         "client's port=/endpoints=",
                    prop="endpoints" if ep.prop_span("endpoints")
                    else "port")


# -- NNST992 ---------------------------------------------------------------


def _client_request_caps(m: DeployMember, ep):
    """The client's statically negotiated REQUEST caps: what the member
    pipeline delivers into the query client's sink pad (dry-run nego,
    no PLAYING)."""
    from nnstreamer_tpu_torch.analysis.nego import dry_run_quiet_cached

    sinks = getattr(ep.element, "sink_pads", None)
    if not sinks:
        return None
    try:
        pad_caps = dry_run_quiet_cached(m.pipeline)
    except Exception:  # noqa: BLE001 — unresolved nego: NNST2xx's job
        return None
    caps = pad_caps.get(id(sinks[0]))
    if caps is None or caps.is_any() or caps.is_empty():
        return None
    return caps


def _check_signatures(ctx, spec: DeploySpec) -> None:
    from nnstreamer_tpu_torch.caps import Caps

    servers = {}
    for m, ep in _servers(spec):
        if ep.transport == "query" and ep.port:
            servers.setdefault(ep.port, (m, ep))
    for m, ep in _clients(spec):
        if ep.transport != "query":
            continue
        for host, port in ep.targets:
            hit = servers.get(port)
            if hit is None:
                continue  # NNST991 already covers the dangling endpoint
            sm, sep = hit
            declared = sep.element.properties.get("caps")
            if not declared:
                continue  # server accepts whatever arrives: nothing to pin
            try:
                scaps = declared if isinstance(declared, Caps) \
                    else Caps.from_string(str(declared))
            except Exception:  # noqa: BLE001 — NNST1xx's job
                continue
            ccaps = _client_request_caps(m, ep)
            if ccaps is None:
                continue  # unresolved client side: do not guess
            if not ccaps.can_intersect(scaps):
                _emit_member(
                    ctx, "NNST992", spec, m, ep,
                    f"request caps mismatch across the wire: "
                    f"{m.name}/{ep.name} sends {ccaps} but "
                    f"{sm.name}/{sep.name} (:{port}) declares "
                    f"caps={scaps} — every request is rejected at "
                    f"negotiation",
                    hint=f"align the client pipeline's tensor layout "
                         f"with {sm.name}'s caps= (or fix the server "
                         f"declaration)")


# -- NNST993 ---------------------------------------------------------------


def _member_capacity(m: DeployMember) -> Optional[Tuple[float, object, int]]:
    """(capacity_rps, serversrc endpoint, replicas) of a serving member,
    None when it has no modelable serving source."""
    from nnstreamer_tpu_torch.analysis.plant import (
        predict_latency,
        serving_launch_model,
    )
    from nnstreamer_tpu_torch.analysis.pool import resolve_pool

    for ep in m.endpoints:
        if ep.transport != "query" or ep.kind != "server":
            continue
        src = ep.element
        if not src.properties.get("serve"):
            continue
        model = serving_launch_model(m.pipeline, src)
        if model is None:
            return None  # unmodelable: skip the verdict, never guess
        try:
            pool = resolve_pool(m.pipeline)
        except Exception:  # noqa: BLE001
            pool = {}
        replicas = max(1, int(pool.get(src.name, (1,))[0] or 1))
        config = {
            "serve_batch": src.properties.get("serve_batch", 1),
            "linger_ms": src.properties.get("serve_linger_ms", 0.0),
            "queue_depth": src.properties.get("serve_queue_depth", 0),
            "row_device_ms": model["row_device_ms"],
            "replicas": replicas,
        }
        return predict_latency(config)["capacity_rps"], ep, replicas
    return None


def _check_capacity(ctx, spec: DeploySpec, fleet: Fleet) -> None:
    if spec.offered_rps is None:
        return
    legs = []
    for m in spec.members:
        if m.pipeline is None:
            continue
        cap = _member_capacity(m)
        if cap is not None:
            legs.append((m, cap))
            fleet.capacities[m.name] = cap[0]
    if not legs:
        return  # no modelable serving member: nothing to price
    total = sum(c[0] for _, c in legs)
    if spec.offered_rps <= total:
        return
    detail = ", ".join(
        f"{m.name}={c[0]:g} rps (x{c[2]} replica"
        f"{'s' if c[2] != 1 else ''})" for m, c in legs)
    ctx.emit(
        "NNST993", "fleet",
        f"fleet SLO infeasible: offered-rps {spec.offered_rps:g} exceeds "
        f"the summed plant-model capacity {total:g} rps ({detail})"
        + (f" under slo-ms {spec.slo_ms:g}" if spec.slo_ms else ""),
        hint="raise replicas= / serve-batch on the serving members, add "
             "a server member, or lower the declared offered-rps",
        span=(0, len(spec.offered_text)), origin=(spec.path,
                                                  spec.offered_line),
        source=spec.offered_text)


# -- NNST994 ---------------------------------------------------------------


def _check_packing(ctx, spec: DeploySpec, fleet: Fleet) -> None:
    from nnstreamer_tpu_torch.analysis.memplan import device_memory_budget

    by_device: Dict[str, List[Tuple[DeployMember, int]]] = {}
    for m in spec.members:
        if m.pipeline is None or m.device is None:
            continue
        try:
            from nnstreamer_tpu_torch.analysis.memplan import plan_memory

            plan = plan_memory(m.pipeline)
        except Exception:  # noqa: BLE001 — unmodelable member: skip
            continue
        fleet.memplans[m.name] = plan
        by_device.setdefault(m.device, []).append(
            (m, int(plan["total_bytes"])))
    mb = 1024 * 1024
    free: Dict[str, int] = {}
    for name, dev in spec.devices.items():
        budget = dev.hbm_bytes if dev.hbm_bytes is not None \
            else device_memory_budget()[0]
        used = sum(b for _, b in by_device.get(name, []))
        free[name] = budget - used
    for name, dev in spec.devices.items():
        residents = by_device.get(name, [])
        total = sum(b for _, b in residents)
        budget = dev.hbm_bytes if dev.hbm_bytes is not None \
            else device_memory_budget()[0]
        if total <= budget or not residents:
            continue
        biggest = max(residents, key=lambda t: (t[1], t[0].name))
        room = sorted(((n, f) for n, f in free.items()
                       if n != name and f >= biggest[1]),
                      key=lambda t: (-t[1], t[0]))
        if room:
            hint = (f"move {biggest[0].name} ({biggest[1] // mb} MB) to "
                    f"device {room[0][0]} ({room[0][1] // mb} MB free), "
                    f"or evict it")
        else:
            hint = (f"evict {biggest[0].name} ({biggest[1] // mb} MB) or "
                    f"shrink its footprint (serve-batch, feed/fetch "
                    f"depth, replicas) — no other declared device has "
                    f"room")
        detail = " + ".join(f"{m.name}={b // mb} MB" for m, b in residents)
        ctx.emit(
            "NNST994", name,
            f"per-device HBM overcommit on {name}: co-resident members "
            f"need {total // mb} MB ({detail}) against a "
            f"{budget // mb} MB budget — the last member to reach "
            f"PLAYING OOMs even though each fits alone",
            hint=hint, member=biggest[0].name,
            span=(0, len(dev.text)), origin=(spec.path, dev.line),
            source=dev.text)


# -- NNST995 ---------------------------------------------------------------


def _rollout_link_error(filt, candidate: str) -> Optional[str]:
    """Why the rollout candidate cannot serve the live traffic: a
    human-readable reason, or None when the static link succeeds (or
    cannot be modeled — never guess). The candidate runs on the ``meta``
    device at the live signature (no weights, no launch)."""
    from nnstreamer_tpu_torch.analysis.costmodel import (
        filter_program,
        meta_composition,
        meta_tensors,
    )

    live = filter_program(filt)
    if live is None:
        return None  # live side unmodelable: nothing to check against
    _, _, shapes = live
    from nnstreamer_tpu_torch.filters.base import FilterProperties

    cd = FilterProperties(
        custom=str(filt.properties.get("custom", ""))).custom_dict()
    try:
        run, params, _ = meta_composition(candidate, cd)
    except Exception as e:  # noqa: BLE001 — candidate cannot be opened
        return f"candidate cannot be opened: {e}"
    import torch

    try:
        with torch.no_grad():
            run(params, *meta_tensors(shapes))
    except Exception as e:  # noqa: BLE001 — abstract link failure
        reason = str(e).split("\n")[0]
        shp = ", ".join(f"{tuple(s.shape)}:{s.dtype}" for s in shapes)
        return (f"live traffic signature [{shp}] does not link: {reason}")
    return None


def _check_rollout_hazards(ctx, spec: DeploySpec) -> None:
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    for m in spec.members:
        if m.pipeline is None:
            continue
        for e in m.pipeline.elements.values():
            if not isinstance(e, TensorFilter):
                continue
            candidate = e.properties.get("rollout_model")
            if not candidate:
                continue
            why = _rollout_link_error(e, str(candidate))
            if why is None:
                continue
            ctx.emit(
                "NNST995", e,
                f"rollout hazard: rollout-model={candidate} on "
                f"{m.name}/{e.name} fails the static shape/dtype link "
                f"against live traffic — the hot-swap canary would "
                f"crash on its first frame ({why})",
                hint="pick a candidate with a signature compatible "
                     "with the live stream, or restage the traffic "
                     "first",
                span=getattr(e, "_prop_spans", {}).get("rollout_model"),
                member=m.name, origin=_m_origin(spec, m), source=m.launch)
    rid_less = {}
    for sm, sep in _servers(spec):
        if sep.port and not sep.rid_dedup:
            rid_less[sep.port] = (sm, sep)
    for m, ep in _clients(spec):
        if ep.transport != "query":
            continue
        hedge = float(ep.element.properties.get("hedge_after_ms", 0) or 0)
        if hedge <= 0 or len(ep.targets) < 2:
            continue  # NNST980/982 own the degenerate configs
        for host, port in ep.targets:
            hit = rid_less.get(port)
            if hit is None:
                continue
            sm, sep = hit
            _emit_member(
                ctx, "NNST995", spec, m, ep,
                f"rollout hazard: hedging client {m.name}/{ep.name} "
                f"targets {host}:{port} served by {sm.name}/{sep.name} "
                f"({type(sep.element).__name__}) which has no _rid dedup "
                f"— "
                f"a hedged resend is double-invoked there",
                hint="hedge only across tensor_query_serversrc members "
                     "(their RidFilter acks duplicates), or drop "
                     "hedge-after-ms",
                prop="hedge_after_ms")


# -- NNST996 ---------------------------------------------------------------


def _check_cold_start(ctx, spec: DeploySpec) -> None:
    from nnstreamer_tpu_torch.analysis.aot import aot_points

    cold_by_member = []
    for m in spec.members:
        if m.pipeline is None:
            continue
        try:
            points = aot_points(m.pipeline)
        except Exception:  # noqa: BLE001 — unmodelable member: skip
            continue
        cold = [p for p in points if p.cached is not True]
        if cold:
            cost = sum(p.est_compile_s * max(1, p.count) for p in cold)
            cold_by_member.append((m, cold, cost))
    if not cold_by_member:
        return
    fleet_cost = sum(c for _, _, c in cold_by_member)
    for m, cold, cost in cold_by_member:
        what = ", ".join(f"{p.element} ({p.kind})" for p in cold)
        ctx.emit(
            "NNST996", cold[0].element,
            f"cold-start exposure: member {m.name} compiles "
            f"{len(cold)} executable(s) in-line at PLAYING ({what}), "
            f"~{cost:.1f}s — fleet warm-up total "
            f"~{fleet_cost:.1f}s across "
            f"{len(cold_by_member)} member(s)",
            hint="pre-warm the compile cache on the deployment image "
                 "(play each member once, or ship the NNSTPU_AOT_CACHE "
                 "dir) before rollout",
            member=m.name, origin=_m_origin(spec, m), source=m.launch,
            span=None)


# -- NNST990 ---------------------------------------------------------------


def _emit_summary(ctx, spec: DeploySpec) -> None:
    roles = []
    for m in spec.members:
        role = m.role
        if role == "auto":
            kinds = {ep.kind for ep in m.endpoints}
            role = "server" if "server" in kinds else (
                "client" if "client" in kinds else "standalone")
        at = f"@{m.device}" if m.device else ""
        roles.append(f"{m.name}[{role}]{at}")
    listeners = {}
    for sm, sep in _servers(spec):
        if sep.port:
            listeners[sep.port] = sm
    edges = []
    for m, ep in _clients(spec):
        for host, port in ep.targets:
            sm = listeners.get(port)
            if sm is not None:
                edges.append(f"{m.name}->{sm.name} (:{port})")
        if ep.transport == "mqtt" and ep.topic:
            for sm, sep in _servers(spec):
                if sep.transport == "mqtt" and sep.topic == ep.topic:
                    edges.append(f"{m.name}->{sm.name} "
                                 f"(mqtt {ep.topic})")
    co = []
    for name in spec.devices:
        members = [m.name for m in spec.members if m.device == name]
        if members:
            co.append(f"{name}={{{','.join(members)}}}")
    ctx.emit(
        "NNST990", "fleet",
        f"deployment: {len(spec.members)} member(s): {', '.join(roles)}"
        + (f"; wiring: {', '.join(edges)}" if edges else "; wiring: none")
        + (f"; devices: {', '.join(co)}" if co else "")
        + (f"; offered-rps {spec.offered_rps:g}"
           if spec.offered_rps is not None else "")
        + (f"; slo-ms {spec.slo_ms:g}" if spec.slo_ms is not None else ""),
        origin=(spec.path, 1))
