"""nnlint diagnostics: stable codes, severity, element attribution, spans.

Every finding the analyzer (or the runtime sanitizer) produces is a
:class:`Diagnostic` carrying a STABLE ``NNSTxxx`` code — tests, CI gates
and editors key on the code, never on message wording. The code space is
partitioned by bug class:

  NNST0xx  graph structure (dangling pads, unreachable, cycles)
  NNST1xx  property schema (unknown / mistyped / invalid-enum / bad value)
  NNST2xx  static caps/shape/dtype negotiation (pre-PLAYING dry run)
  NNST3xx  residency planning (avoidable crossings, boundary prediction)
  NNST4xx  fusion safety (shared backends, sync lanes, double claims);
           NNST45x is the chain-composition (nnchain) sub-range:
           whole-chain filter→filter fusion verdicts; NNST46x is the
           steady-loop (nnloop) sub-range: donated-buffer lax.scan
           window eligibility verdicts; NNST47x is the mesh-partition
           (nnshard) sub-range: static shard=dp|tp|dpxtp mesh=AxB
           placement verdicts + resharding-hazard detection
  NNST5xx  queue/mux deadlock and starvation
  NNST6xx  runtime sanitizer (NNSTPU_SANITIZE=1) violations; NNST61x is
           the lock-witness (nnsan-c) sub-range: lock-order inversion,
           blocking call under a framework lock, cross-thread handoff
           mutation, lock held across a backend invoke; NNST62x is the
           static thread-topology (nnsan-c) sub-range: topology summary,
           bounded-capacity wait cycle, blocking-reply hazard
  NNST7xx  static cost & memory (HBM footprint, OOM prediction, roofline)
  NNST8xx  compile churn & donation (retrace hazards, donate safety);
           NNST85x is the autotuner (nntune) sub-range: dominated config
           in use, search summary, fully-pruned space, unmodelable point
  NNST9xx  serving tier (batch-signature mismatch, unbounded admission,
           per-request launches under concurrent load); NNST95x is the
           serving-controller (nnctl) sub-range: static SLO feasibility
           against the plant model, controller-bound sanity, and
           conflicting knob pins; NNST96x is the replica-serving
           (nnpool) sub-range: per-device replica eligibility for
           ``tensor_query_serversrc serve=1 replicas=N|auto``;
           NNST97x is the AOT executable-cache (nnaot) sub-range:
           per-pipeline compile-point summary with predicted cache
           hit/miss, cold-start warnings, stale-entry detection;
           NNST99x is the deployment-lint (nndeploy) sub-range:
           fleet-level verdicts over a multi-pipeline deploy spec
           (wiring, cross-process signatures, capacity, HBM packing,
           rollout hazards, cold-start exposure)

Source spans come from ``pipeline/parse.py``: when the pipeline was built
from a launch line, a diagnostic can point at the exact ``key=value``
token that caused it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

#: code → (default severity, short title). The table is the contract:
#: codes are append-only; a code's meaning never changes once shipped.
CODES = {
    # -- graph structure ---------------------------------------------------
    "NNST000": ("error", "empty pipeline"),
    "NNST001": ("error", "dangling sink pad"),
    "NNST002": ("warning", "no src pad linked (output dropped)"),
    "NNST003": ("error", "no source elements"),
    "NNST004": ("warning", "unreachable from any source"),
    "NNST005": ("error", "pad-linked cycle"),
    # -- property schema ---------------------------------------------------
    "NNST100": ("warning", "unknown property"),
    "NNST101": ("warning", "mistyped property value"),
    "NNST102": ("warning", "invalid enum value"),
    "NNST103": ("error", "invalid property value"),
    "NNST104": ("error", "missing required property"),
    "NNST105": ("warning", "unknown subplugin/mode"),
    "NNST106": ("error", "element construction failed"),
    "NNST107": ("error", "unknown element type"),
    # -- static negotiation ------------------------------------------------
    "NNST200": ("error", "caps rejected by pad template"),
    "NNST201": ("error", "negotiation failure"),
    "NNST202": ("info", "negotiation unresolved (model not opened)"),
    "NNST203": ("error", "filter io override mismatches incoming caps"),
    "NNST204": ("error", "combiner pads disagree"),
    # -- residency ---------------------------------------------------------
    "NNST300": ("warning", "avoidable host crossing"),
    "NNST301": ("info", "residency plan / predicted crossings"),
    # -- fusion safety -----------------------------------------------------
    "NNST400": ("warning", "shared backend refuses fusion"),
    "NNST401": ("warning", "sync=1 wastes a device lane"),
    "NNST402": ("warning", "transform between two filters"),
    "NNST403": ("info", "fusion inhibited by filter properties"),
    # -- chain composition (nnchain) — NNST45x sub-range -------------------
    "NNST450": ("info", "filter chain is fusable into one XLA program"),
    "NNST451": ("warning", "filter chain blocked from whole-chain fusion"),
    "NNST452": ("warning", "composed chain program exceeds the HBM "
                           "budget (fusion pruned before any compile)"),
    "NNST453": ("warning", "shape/dtype mismatch at a chain link"),
    # -- steady-state loop (nnloop) — NNST46x sub-range --------------------
    "NNST460": ("info", "steady-loop eligible: the filter's (chain-)fused "
                        "program wraps in a donated-buffer lax.scan window"),
    "NNST461": ("warning", "steady-loop ineligible — loop-window falls "
                           "back to per-buffer launches (names the "
                           "blocking reason)"),
    "NNST462": ("warning", "loop window ring + in-flight windows exceed "
                           "the HBM budget (loop pruned before any "
                           "compile; per-buffer launches)"),
    # -- mesh partitioning (nnshard) — NNST47x sub-range --------------------
    "NNST470": ("info", "shard-eligible: the requested mesh partition is "
                        "statically sound (carries the resolved "
                        "PartitionSpec layout and modeled per-shard "
                        "bytes) — the planner installs it at PLAYING"),
    "NNST471": ("warning", "shard-ineligible — the filter falls back "
                           "LOUDLY to unsharded execution (names the "
                           "blocking dim/reason: indivisible batch, no "
                           "shardable channel dim, invoke-dynamic, "
                           "sync=1, shared key, chain/loop interaction, "
                           "insufficient devices, non-composable "
                           "backend)"),
    "NNST472": ("warning", "resharding hazard: adjacent filters on a "
                           "memory:HBM edge carry incompatible shard "
                           "specs — the mismatch forces an implicit "
                           "gather/reshard at the link"),
    # -- deadlock / starvation ---------------------------------------------
    "NNST500": ("warning", "unbalanced drop into slowest-sync combiner"),
    "NNST501": ("warning", "slowest-sync sources of unequal length"),
    "NNST502": ("warning", "basepad driver branch drops frames"),
    "NNST503": ("warning", "unbounded queue"),
    # -- runtime sanitizer -------------------------------------------------
    "NNST600": ("error", "in-place mutation of a tee-shared tensor"),
    "NNST601": ("error", "concurrent invoke on one framework instance"),
    "NNST602": ("error", "un-billed host materialization"),
    # -- lock witness (nnsan-c) — NNST61x sub-range --------------------------
    "NNST610": ("error", "lock-order inversion: two framework locks are "
                         "acquired in opposite orders from two threads — "
                         "a potential deadlock, reported with BOTH "
                         "acquisition stacks and thread names even when "
                         "this schedule did not deadlock"),
    "NNST611": ("error", "blocking call under a framework lock: a socket "
                         "send/recv, device block/compile, subprocess or "
                         "sleep runs while a lock that was not declared "
                         "blocking-safe is held (names the lock, the "
                         "call site, and the held-duration)"),
    "NNST612": ("error", "cross-thread handoff mutation: a tensor handed "
                         "off through a queue/ack-channel/serving-route/"
                         "replica-inbox was mutated between the sending "
                         "and receiving thread (names the channel and "
                         "both threads)"),
    "NNST613": ("warning", "framework lock held across a backend invoke "
                           "(contention hazard: every other user of the "
                           "lock stalls for the full device latency)"),
    # -- static thread topology (nnsan-c) — NNST62x sub-range ----------------
    "NNST620": ("info", "thread-topology summary: the launch line's "
                        "streaming threads, edge accept/recv threads, "
                        "serving scheduler, replica dispatch workers, "
                        "nnctl tick and health advertiser, modeled "
                        "without PLAYING"),
    "NNST621": ("warning", "bounded-capacity wait cycle: replica "
                           "dispatch in-flight windows drain only on the "
                           "serversink's reply ack, the reply send can "
                           "block forever (no timeout), and the bounded "
                           "admission pool backs up behind the stalled "
                           "ack drain — one stuck client stalls the "
                           "batch pipeline"),
    "NNST622": ("warning", "blocking-reply hazard: the serving "
                           "serversink sends replies synchronously on "
                           "the streaming thread with no timeout= bound "
                           "— a client that stopped reading (full TCP "
                           "window) wedges the reply path"),
    # -- static cost & memory ----------------------------------------------
    "NNST700": ("error", "predicted HBM footprint exceeds device memory"),
    "NNST701": ("info", "per-filter static cost/memory summary"),
    "NNST702": ("info", "static roofline bottleneck prediction"),
    "NNST703": ("warning", "predicted HBM footprint near device memory"),
    # -- compile churn & donation ------------------------------------------
    "NNST800": ("warning", "retrace hazard: variable-shape caps reach a "
                           "jitted filter"),
    "NNST801": ("warning", "python-scalar weak-type promotion in the "
                           "jitted program"),
    "NNST802": ("error", "unsafe donate:1 (upstream fan-out holds the "
                         "input buffer)"),
    "NNST803": ("info", "missed donation opportunity on dead inputs"),
    # -- autotuner (nntune) ------------------------------------------------
    "NNST850": ("warning", "dominated configuration in use (static model "
                           "predicts headroom over the current knobs)"),
    "NNST851": ("info", "tuner search summary (enumerated/pruned/"
                        "evaluated counts + best modeled config)"),
    "NNST852": ("error", "tuning space fully pruned (no statically "
                         "feasible configuration)"),
    "NNST853": ("info", "tuning point unmodelable at this configuration "
                        "(pruned before any compile)"),
    # -- serving tier (nnserve) --------------------------------------------
    "NNST900": ("warning", "serving batch mismatches the filter's "
                           "compiled batch signature (retrace hazard)"),
    "NNST901": ("warning", "serving admission queue is unbounded"),
    "NNST902": ("warning", "query server feeds a jitted filter without "
                           "batching (per-request launches under "
                           "concurrent load)"),
    # -- serving controller (nnctl) — NNST95x sub-range ---------------------
    "NNST950": ("error", "declared SLO statically infeasible: the plant "
                         "model prices the zero-load latency floor past "
                         "slo-ms at EVERY serve-batch the controller "
                         "bounds allow"),
    "NNST951": ("warning", "ctl-bounds exclude the modeled optimum: the "
                           "plant model's SLO-optimal serve-batch lies "
                           "outside the controller's reachable range"),
    "NNST952": ("warning", "conflicting controller pins: ctl actuation "
                           "collides with a pinned compiled signature, "
                           "an out-of-bounds serve-batch pin, or a "
                           "non-serving server"),
    # -- replica serving (nnpool) — NNST96x sub-range ------------------------
    "NNST960": ("info", "replica-eligible: the serving source clones the "
                        "served filter's compiled program onto N devices "
                        "(one traced program per serve-batch shape, "
                        "compiled once per device; least-loaded "
                        "dispatch) — the planner installs the pool at "
                        "PLAYING"),
    "NNST961": ("warning", "replica-ineligible — the server falls back "
                           "LOUDLY to single-replica serving (names the "
                           "blocking reason: serving off, shard/chain/"
                           "loop interaction, shared key, batch/feed/"
                           "fetch amortizers, invoke-dynamic, stateful "
                           "backend, insufficient devices)"),
    "NNST962": ("warning", "replicas exceed the per-device budget: each "
                           "replica REPLICATES params + serving batch "
                           "per device — pruned before any compile; "
                           "single-replica serving"),
    # -- AOT executable cache (nnaot) — NNST97x sub-range --------------------
    "NNST970": ("info", "AOT compile-point summary: every planner-"
                        "resolved executable this pipeline will build at "
                        "PLAYING (filter/chain/loop/shard/replica), with "
                        "the predicted cache outcome (warm hit vs cold "
                        "compile) per key"),
    "NNST971": ("warning", "AOT cold start: a compile-point has no cache "
                           "entry — the first PLAYING pays an estimated "
                           "in-line compile (names the element and the "
                           "missing key dimension)"),
    "NNST972": ("warning", "stale/incompatible AOT cache entry: an entry "
                           "matches this program's model+signature but a "
                           "key dimension moved (runtime upgrade, spec "
                           "change, model content change) or the entry "
                           "was quarantined as unreadable — it will "
                           "never be loaded again"),
    # -- fleet resilience (nnfleet-r) — NNST98x sub-range ---------------------
    "NNST980": ("error", "hedging without idempotent pairing: "
                         "hedge-after-ms is set but the client has no "
                         "endpoints= fleet — single-connection frames "
                         "carry no _rid, so a hedged resend would be "
                         "double-invoked server-side"),
    "NNST981": ("error", "rollout-rollback=auto with no canary window: "
                         "rollout-canary-frames=0 means no frame is ever "
                         "watched after the flip — the auto-rollback "
                         "decision is unreachable and a bad model B "
                         "serves forever"),
    "NNST982": ("warning", "single-endpoint hedge is a no-op: endpoints= "
                           "lists one server, so a hedged resend has "
                           "nowhere else to go (the client takes the "
                           "legacy single-connection path)"),
    # -- deployment lint (nndeploy) — NNST99x sub-range -----------------------
    "NNST990": ("info", "deployment summary: the spec's members with "
                        "roles, the resolved cross-process wiring graph "
                        "(client→server edges over ports/topics), and "
                        "the per-device co-resident member sets"),
    "NNST991": ("error", "broken fleet wiring: a client endpoint with no "
                         "member listening on it, two servers claiming "
                         "one port, an MQTT subscription no member "
                         "publishes, a dangling HYBRID discovery topic, "
                         "or a malformed deploy-spec directive"),
    "NNST992": ("error", "client↔server signature mismatch across the "
                         "wire: the client's statically negotiated "
                         "request caps disagree with the server's "
                         "declared caps (num-tensors/dimensions/types) "
                         "— NNST2xx/900 generalized across processes"),
    "NNST993": ("error", "fleet SLO infeasible: the declared offered "
                         "load exceeds the summed plant-model capacity "
                         "of every serving member at its nnpool replica "
                         "count — NNST950 lifted to the fleet"),
    "NNST994": ("error", "per-device HBM overcommit: the co-resident "
                         "members' memplan footprints jointly exceed "
                         "the device's budget even though each member "
                         "fits alone (with an evict/repack fix hint)"),
    "NNST995": ("error", "rollout hazard: a rollout-model candidate "
                         "fails the static shape/dtype link against the "
                         "live traffic signature, or hedging targets a "
                         "server endpoint without _rid dedup support"),
    "NNST996": ("warning", "fleet cold-start exposure: this member's "
                           "compile-points have no warm AOT cache entry "
                           "— it compiles in-line at PLAYING (with the "
                           "member's and the fleet's estimated warm-up "
                           "cost)"),
}

_SEV_RANK = {"info": 0, "warning": 1, "error": 2}


@dataclass
class Diagnostic:
    """One analyzer finding. ``span`` indexes into ``source`` (the launch
    description) when the pipeline came from ``parse_launch``.

    ``member``/``path``/``line`` attribute a finding inside a MULTI-FILE
    source (a deploy spec): ``member`` is the deploy-spec member name the
    pipeline belongs to, ``path``/``line`` the spec file and 1-based line
    the member's launch line sits on — so a span cites
    ``<spec>:<line>, col a..b`` instead of an anonymous ``col a..b``.
    All three default to None; single-pipeline output is byte-identical
    to before they existed."""

    code: str
    element: str
    message: str
    severity: str = ""  # filled from CODES when empty
    hint: Optional[str] = None
    span: Optional[Tuple[int, int]] = None
    source: Optional[str] = field(default=None, repr=False)
    member: Optional[str] = None
    path: Optional[str] = None
    line: Optional[int] = None

    def __post_init__(self):
        if not self.severity:
            self.severity = CODES.get(self.code, ("warning", ""))[0]

    @property
    def rank(self) -> int:
        return _SEV_RANK.get(self.severity, 1)

    def format(self, show_span: bool = True) -> str:
        label = (f"{self.member}/{self.element}" if self.member
                 else self.element)
        out = f"{self.code} {self.severity}: {label}: {self.message}"
        loc = f"{self.path}:{self.line}, " if self.path and self.line else ""
        if show_span and self.span and self.source:
            a, b = self.span
            out += f"\n    --> {loc}col {a}..{b}: {self.source[a:b]!r}"
        elif show_span and loc:
            out += f"\n    --> {loc.rstrip(', ')}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> dict:
        """Stable structured form for ``validate --json``: every field a
        CI gate may key on, deterministically ordered by the JSON
        serializer (sort_keys)."""
        return {
            "code": self.code,
            "severity": self.severity,
            "member": self.member,
            "element": self.element,
            "message": self.message,
            "span": list(self.span) if self.span else None,
            "path": self.path,
            "line": self.line,
            "fix_hint": self.hint,
        }


def format_diagnostic(d: Diagnostic) -> str:
    return d.format()


def sort_key(d: Diagnostic):
    """The stable diagnostic order: (code, member, element, span, line).
    ``sorted``/``list.sort`` are stable, so diagnostics that tie keep
    their emission order — but nothing about the output can depend on
    dict/registration ordering anymore (the ci.sh byte-diff gates key on
    this)."""
    return (d.code, d.member or "", d.element,
            d.span if d.span is not None else (-1, -1),
            d.line if d.line is not None else -1)


def sort_diagnostics(diags):
    """Stably sort a diagnostic list in place and return it."""
    diags.sort(key=sort_key)
    return diags


def worst_severity(diags) -> str:
    """'error' | 'warning' | 'info' | 'clean' over a diagnostic list."""
    worst = -1
    for d in diags:
        worst = max(worst, d.rank)
    return {2: "error", 1: "warning", 0: "info", -1: "clean"}[worst]


def exit_code(diags, strict: bool = False) -> int:
    """CLI/CI exit-code semantics: 0 clean, 1 warnings, 2 errors.
    ``strict`` promotes warnings to errors (CI gating mode)."""
    sev = worst_severity(diags)
    if sev == "error":
        return 2
    if sev == "warning":
        return 2 if strict else 1
    return 0
