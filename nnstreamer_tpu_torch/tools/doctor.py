"""Environment checker — ``python -m nnstreamer_tpu_torch.tools.doctor``
(counterpart of the JAX package's ``tools/doctor.py``).

Reference counterpart: tools/development/confchk (nnstreamer-check) which
dumps the resolved nnsconf configuration and available subplugins. Here it
also probes torch, CUDA and the card (``torch.cuda``), ``nvcc`` and
whether the kernel library of this checkout is built (ops/_cuda.py), where
the JAX package probes ``jax.devices`` and its native core, and the
optional transports. ``--aot`` renders the compile cache (its entries,
quarantine and a saved report's outcome events), ``--tune``, ``--lint``,
``--cost`` and ``--deploy`` hand over to ``tools/validate.py``.
"""

from __future__ import annotations

import json
import sys


def collect(probe_device: bool = True) -> dict:
    from nnstreamer_tpu_torch import __version__, registry
    from nnstreamer_tpu_torch.config import conf

    # one source of truth (nnstreamer_tpu_torch.__version__, which
    # pyproject.toml reads via setuptools dynamic metadata)
    report: dict = {"version": __version__}

    c = conf()
    report["config"] = {
        "ini_path": getattr(c, "ini_path", None),
        "envvar_enabled": c.get("common", "enable_envvar"),
    }

    subplugins = {}
    for sp_type in (registry.FILTER, registry.DECODER, registry.CONVERTER,
                    registry.TRAINER):
        entries = {}
        for name in registry.available(sp_type):
            try:
                entries[name] = registry.get(sp_type, name) is not None
            except Exception:  # noqa: BLE001
                entries[name] = False
        subplugins[sp_type] = entries
    report["subplugins"] = subplugins

    from nnstreamer_tpu_torch.pipeline.element import element_types

    report["elements"] = element_types()

    import torch

    report["torch"] = {"version": torch.__version__,
                       "cuda": torch.version.cuda}
    if probe_device:
        try:
            if torch.cuda.is_available():
                report["devices"] = [
                    f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                    for i in range(torch.cuda.device_count())]
                report["default_backend"] = "cuda"
            else:
                report["devices"] = ["cpu"]
                report["default_backend"] = "cpu"
        except Exception as e:  # noqa: BLE001
            report["devices"] = []
            report["device_error"] = str(e)

    from nnstreamer_tpu_torch.platform import hw_capabilities

    report["hw"] = hw_capabilities(probe_device=probe_device)
    report["kernels"] = kernel_library()

    optional = {}
    for mod in ("grpc", "google.protobuf", "flatbuffers", "triton",
                "scipy"):
        try:
            __import__(mod)
            optional[mod] = True
        except ImportError:
            optional[mod] = False
    report["optional_deps"] = optional
    return report


def kernel_library() -> dict:
    """``nvcc`` and the kernel library of this checkout: the compiler's
    path (None when absent), the sources' digest, the library's path and
    whether it is built (``ops/_cuda.py``; nothing is built here)."""
    import os

    from nnstreamer_tpu_torch.ops import _cuda

    out: dict = {"csrc": _cuda.CSRC}
    try:
        out["nvcc"] = _cuda._nvcc()
    except RuntimeError:
        out["nvcc"] = None
    try:
        digest = _cuda._digest()
    except OSError as e:
        return dict(out, built=False, error=str(e))
    lib = os.path.join(_cuda.BUILD_ROOT, digest, "libnnstpu_kernels.so")
    out.update(digest=digest, library=lib, built=os.path.exists(lib))
    return out


def render_serving(serving: dict) -> str:
    """Human rendering of the tracer's ``serving`` section (queue depth,
    time-in-queue, batch fill, sheds, per-tenant goodput) — the nnserve
    observability surface. Accepts either a full tracer report (uses its
    ``serving`` key) or the serving dict itself."""
    for key in ("detail", "serving", "serving_stats"):
        # accept a tracer report, a bench metric record, or the serving
        # dict itself
        if key in serving and isinstance(serving[key], dict):
            serving = serving[key]
            if key == "detail" and "serving_stats" in serving:
                serving = serving["serving_stats"]
            break
    lines = []
    for server, s in sorted(serving.items()):
        if not isinstance(s, dict) or "batches" not in s:
            continue
        depth = s.get("queue_depth", {}) or {}
        wait = s.get("time_in_queue", {}) or {}
        lines.append(f"query server id={server}:")
        lines.append(
            f"  batches={s.get('batches', 0)} "
            f"fill={s.get('batch_fill', 0.0):.2f} rows/launch "
            f"(rows={s.get('rows', 0)}, padded={s.get('padded_rows', 0)})")
        lines.append(
            f"  admitted={s.get('enqueued', 0)} shed={s.get('shed', 0)} "
            f"{s.get('shed_reasons', {})} replies={s.get('replies', 0)} "
            f"reply-drops={s.get('reply_drops', 0)}")
        if depth.get("count"):
            lines.append(
                f"  queue depth p50={depth.get('p50', 0):.0f} "
                f"max={depth.get('max', 0):.0f}")
        if wait.get("count"):
            lines.append(
                f"  time-in-queue p50={wait.get('p50_us', 0) / 1e3:.2f}ms "
                f"p95={wait.get('p95_us', 0) / 1e3:.2f}ms")
        for tenant, t in sorted((s.get("per_tenant") or {}).items()):
            lines.append(
                f"  tenant {tenant!r}: admitted={t.get('enqueued', 0)} "
                f"shed={t.get('shed', 0)} replies={t.get('replies', 0)} "
                f"goodput={t.get('goodput_rps', 0.0)} req/s")
        per_replica = s.get("per_replica") or {}
        if per_replica:
            split = " ".join(
                f"r{r}={v.get('batches', 0)}"
                for r, v in sorted(per_replica.items(),
                                   key=lambda kv: int(kv[0])))
            lines.append(
                f"  replicas (nnpool): {len(per_replica)} engaged, "
                f"batch split {split}")
    return "\n".join(lines) if lines else "(no serving stats recorded)"


def render_ctl(report: dict) -> str:
    """Human rendering of the tracer's ``ctl`` section (``doctor --ctl
    <report.json>``): per-server knob state plus the controller's
    decision log — every actuation with its rule, before→after values
    and the observed metrics that licensed it.  Accepts a full tracer
    report (uses its ``ctl`` key), a bench ctl record (``detail``), or
    the ctl dict itself."""
    for key in ("detail", "ctl"):
        if key in report and isinstance(report[key], dict):
            report = report[key]
            if key == "detail" and "ctl" in report:
                report = report["ctl"]
            break
    if "knob_trajectory" in report or "final_knobs" in report:
        # a bench --ctl record's controller arm: trajectory entries are
        # compacted decisions (tick/t_ms/rule/knob/before/after) with
        # the final knob state alongside
        lines = ["nnctl bench record:"]
        fk = report.get("final_knobs") or {}
        if fk:
            lines.append("  knobs now: " + "  ".join(
                f"{k}={v}" for k, v in sorted(fk.items())))
        traj = report.get("knob_trajectory") or []
        lines.append(f"  decisions: {len(traj)} recorded")
        for d in traj:
            lines.append(
                f"  t+{d.get('t_ms', 0):8.1f}ms  {d.get('rule', '?'):<12}"
                f" {d.get('knob', '?')}: {d.get('before')} -> "
                f"{d.get('after')}")
        return "\n".join(lines)
    lines = []
    for server, s in sorted(report.items()):
        if not isinstance(s, dict) or "decisions" not in s:
            continue
        lines.append(f"nnctl server id={server}:")
        knobs = s.get("knobs") or {}
        if knobs:
            lines.append("  knobs now: " + "  ".join(
                f"{k}={v}" for k, v in sorted(knobs.items())))
        dropped = s.get("dropped_decisions", 0)
        decisions = s.get("decisions") or []
        lines.append(f"  decisions: {len(decisions)} recorded"
                     + (f" (+{dropped} evicted)" if dropped else ""))
        for d in decisions:
            obs = d.get("observed") or {}
            obs_s = " ".join(
                f"{k.replace('_ms', '').replace('_rps', '')}="
                f"{obs[k]:g}" for k in (
                    "admitted_p99_ms", "queue_p99_ms", "device_p99_ms",
                    "batch_fill", "arrival_rps")
                if isinstance(obs.get(k), (int, float)))
            lines.append(
                f"  t+{d.get('t_ms', 0):8.1f}ms  {d.get('rule', '?'):<12}"
                f" {d.get('knob', '?')}: {d.get('before')} -> "
                f"{d.get('after')}  [{obs_s}]")
            if d.get("reason"):
                lines.append(f"      {d['reason']}")
    return "\n".join(lines) if lines else "(no ctl decisions recorded)"


def render_timeline(rec: dict) -> str:
    """ASCII waterfall of a host-stack attribution (``doctor --timeline
    <report.json>``): accepts a bench ``--spans`` metric record (uses its
    ``detail``), a run_spans detail dict, or a raw
    ``Tracer.host_stack_report()`` result. Bars are offset cumulatively —
    reading top to bottom walks one batch through the host stack."""
    if isinstance(rec.get("detail"), dict):
        rec = rec["detail"]
    comp = rec.get("components_ms_per_batch") or {}
    if not comp:
        return "(no host-stack attribution in report — run bench.py " \
               "--spans or Tracer.host_stack_report())"
    attributed = sum(comp.values())
    measured = rec.get("host_stack_ms_per_batch")
    dev = rec.get("device_compute_ms_per_batch")
    width = 44
    total = max(attributed, 1e-9)
    head = f"host-stack waterfall: {attributed:.3f} ms/batch attributed"
    if isinstance(measured, (int, float)) and \
            abs(measured - attributed) > 1e-9:
        head += f" (measured {measured:.3f} ms)"
    if isinstance(dev, (int, float)) and dev:
        head += f"; device compute {dev:.3f} ms rides below the line"
    lines = [head]
    cum = 0.0
    for name, v in sorted(comp.items(), key=lambda kv: -kv[1]):
        off = int(cum / total * width)
        bar = max(1, int(round(v / total * width))) if v > 0 else 0
        lines.append(f"  {name:<18} {' ' * off}{'#' * bar}"
                     f"{' ' * max(0, width - off - bar)} "
                     f"{v:8.3f} ms ({v / total * 100:4.1f}%)")
        cum += v
    if isinstance(dev, (int, float)) and dev:
        lines.append(f"  {'device_compute':<18} {' ' * width} "
                     f"{dev:8.3f} ms (device track)")
    batches = rec.get("batches")
    if batches:
        lines.append(f"  ({batches} batches attributed; spans dropped: "
                     f"{rec.get('dropped_spans', 0)})")
    return "\n".join(lines)


def render_trace_request(doc: dict, trace_id: str) -> str:
    """ASCII waterfall of ONE request across processes (``doctor
    --trace-request <trace_id> <trace.json>``): every span in a (merged)
    Chrome trace tagged with that trace_id — the client gap, the network
    legs, the server's admission/batch/device/reply stages — ordered on
    one timeline. A shed request renders its terminated span with the
    shed reason. ``trace_id`` may be a unique prefix of the hex id."""
    events = doc.get("traceEvents") or []
    names = {}  # (pid, tid) -> track name
    spans = []  # (t0_us, t1_us, name, track, args)
    open_b: dict = {}
    for ev in events:
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "M":
            if ev.get("name") == "thread_name":
                names[key] = (ev.get("args") or {}).get("name", "")
            continue
        args = ev.get("args") or {}
        tid = str(args.get("trace_id", ""))
        if ph in ("B", "b"):
            open_b[(key, ev.get("name"), ev.get("id"))] = (ev.get("ts"),
                                                           args)
        elif ph in ("E", "e"):
            got = open_b.pop((key, ev.get("name"), ev.get("id")), None)
            if got is None:
                continue
            t0, bargs = got
            btid = str(bargs.get("trace_id", ""))
            if btid and btid.startswith(trace_id):
                spans.append((t0, ev.get("ts"), ev.get("name"), key, bargs))
        elif ph == "X" and tid and tid.startswith(trace_id):
            t0 = ev.get("ts")
            spans.append((t0, t0 + (ev.get("dur") or 0), ev.get("name"),
                          key, args))
    if not spans:
        return (f"(no spans tagged trace_id={trace_id!r} — was the "
                f"request sampled, and is this a span-mode trace?)")
    spans.sort(key=lambda s: (s[0], -(s[1] or 0)))
    base = spans[0][0]
    end = max(s[1] for s in spans)
    total = max(end - base, 1e-9)
    width = 44
    ids = sorted({str(s[4].get("trace_id")) for s in spans})
    lines = [f"request {ids[0]}: {total / 1e3:.3f} ms across "
             f"{len({s[3][0] for s in spans})} process(es)"]
    if len(ids) > 1:
        return (f"trace_id prefix {trace_id!r} is ambiguous: "
                + ", ".join(ids))
    for t0, t1, name, key, args in spans:
        off = int((t0 - base) / total * width)
        bar = max(1, int(round((t1 - t0) / total * width)))
        track = names.get(key, f"tid{key[1]}")
        note = ""
        if args.get("terminated"):
            note = f"  ! terminated ({args.get('shed_reason', '?')})"
        lines.append(
            f"  {name:<18.18} {' ' * off}{'#' * min(bar, width - off)}"
            f"{' ' * max(0, width - off - bar)} "
            f"{(t1 - t0) / 1e3:8.3f} ms  [{track}]{note}")
    return "\n".join(lines)


def render_aot(report: dict) -> str:
    """Human rendering of the tracer's ``aot`` section (``doctor --aot
    <report.json>``): per-element cache outcomes — hits vs misses,
    cumulative load vs compile milliseconds (the warm-start win), and
    the recent event ring.  Accepts a full tracer report (uses its
    ``aot`` key) or the aot dict itself."""
    if "aot" in report and isinstance(report["aot"], dict):
        report = report["aot"]
    lines = []
    for el, s in sorted(report.items()):
        if not isinstance(s, dict) or "hits" not in s:
            continue
        lines.append(
            f"nnaot {el}: {s['hits']} hits, {s['misses']} misses, "
            f"{s.get('refused', 0)} refused-budget, "
            f"{s.get('prefetch', 0)} prefetch — "
            f"load {s.get('load_ms', 0.0):.1f} ms vs compile "
            f"{s.get('compile_ms', 0.0):.1f} ms")
        dropped = s.get("dropped_events", 0)
        events = s.get("events") or []
        for ev in events:
            ms = (f"load {ev.get('load_ms', 0.0):.1f} ms"
                  if ev.get("outcome") == "hit"
                  else f"compile {ev.get('compile_ms', 0.0):.1f} ms")
            lines.append(
                f"  {ev.get('outcome', '?'):<18} key={str(ev.get('key', ''))[:12]}"
                f" sig={ev.get('sig')} {ms}")
        if dropped:
            lines.append(f"  (+{dropped} events evicted)")
    return "\n".join(lines) if lines else "(no aot events recorded)"


def render_rollout(report: dict) -> str:
    """Human rendering of the tracer's ``rollout`` section (``doctor
    --rollout <report.json>``): per-element nnfleet-r canary decisions —
    started/promoted/rolled-back counters plus every recorded verdict
    with the observed fault delta / admitted-p99 and the flip/rollback
    milliseconds. Accepts a full tracer report (uses its ``rollout``
    key) or the rollout dict itself."""
    if "rollout" in report and isinstance(report["rollout"], dict):
        report = report["rollout"]
    lines = []
    for el, s in sorted(report.items()):
        if not isinstance(s, dict) or "events" not in s:
            continue
        lines.append(
            f"nnfleet-r {el}: {s.get('started', 0)} started, "
            f"{s.get('promoted', 0)} promoted, "
            f"{s.get('rolled_back', 0)} rolled back")
        for ev in s.get("events") or []:
            decision = ev.get("decision", "?")
            extra = []
            if ev.get("flip_ms") is not None:
                extra.append(f"flip {ev['flip_ms']:.1f} ms")
            if ev.get("rollback_ms") is not None:
                extra.append(f"rollback {ev['rollback_ms']:.1f} ms")
            if ev.get("frames_used") is not None:
                extra.append(f"{ev['frames_used']} canary frames")
            if isinstance(ev.get("p99_ms"), (int, float)):
                extra.append(f"p99 {ev['p99_ms']:.1f} ms")
            lines.append(
                f"  {decision:<12} {ev.get('old_model', '?')} -> "
                f"{ev.get('model', '?')}"
                + (f"  [{', '.join(extra)}]" if extra else ""))
            if ev.get("reason"):
                lines.append(f"      {ev['reason']}")
        dropped = s.get("dropped_events", 0)
        if dropped:
            lines.append(f"  (+{dropped} events evicted)")
    return "\n".join(lines) if lines else "(no rollout decisions recorded)"


def render_aot_cache() -> str:
    """The on-disk compile cache: every entry's key dimensions, size,
    age and last-load time (LRU order — the eviction order the cache
    budget enforces), plus the quarantine."""
    import time as _time

    from nnstreamer_tpu_torch.filters import aot

    try:
        rows = aot.cache_entries()
        q = aot.quarantined_entries()
    except Exception as e:  # noqa: BLE001 — refused/unreadable cache dir
        return f"AOT cache unavailable: {e}"
    now = _time.time()
    lines = [f"AOT cache {aot.cache_dir()}: {len(rows)} entries, "
             f"{sum(r['size'] for r in rows) / 2**20:.1f} MiB "
             f"(budget {aot.cache_max_bytes() / 2**20:.0f} MiB)"]
    for r in rows:
        spec = r.get("spec") or {}
        dims = ("native" if r.get("native")
                else ",".join(sorted(spec)) if spec else "solo")
        age = ((now - r["created"]) / 3600.0
               if r.get("created") else float("nan"))
        last = (now - r["last_load"]) / 60.0
        lines.append(
            f"  {r['file']:<44.44} {r['size'] / 2**20:7.2f} MiB  "
            f"model={str(r.get('model', '?')):<12.12} dims={dims:<20.20} "
            f"age={age:6.1f}h  last-load {last:6.1f}m ago")
    if q:
        lines.append(f"  quarantine: {len(q)} unreadable entr"
                     f"{'y' if len(q) == 1 else 'ies'} "
                     f"(--aot-purge clears)")
    if aot.EVENTS:
        # this process's outcome log (a library caller's, after plays)
        lines.append(f"  events: {len(aot.EVENTS)} in this process")
        for ev in list(aot.EVENTS)[-8:]:
            lines.append(
                f"  {ev.get('outcome', '?'):<18} "
                f"key={str(ev.get('key', ''))[:12]} sig={ev.get('sig')} "
                f"load {ev.get('load_ms', 0.0):.1f} ms compile "
                f"{ev.get('compile_ms', 0.0):.1f} ms")
    return "\n".join(lines)


def render_locks(report: dict) -> str:
    """Human rendering of the tracer's ``locks`` section (``doctor
    --locks <report.json>``): the nnsan-c lock witness's per-lock
    held-time/wait-time percentiles and contention counters, sorted by
    p95 held time so the lock most worth shrinking reads first. Accepts
    a full tracer report (uses its ``locks`` key) or the locks dict
    itself."""
    if "locks" in report and isinstance(report["locks"], dict):
        report = report["locks"]
    rows = [(name, s) for name, s in report.items()
            if isinstance(s, dict) and "acquisitions" in s]
    if not rows:
        return ("(no lock stats recorded — run with NNSTPU_SANITIZE=1; "
                "the witness only observes when the sanitizer is on)")
    rows.sort(key=lambda kv: (-float(kv[1].get("held_p95_us", 0) or 0),
                              kv[0]))
    w = max(len(name) for name, _ in rows)
    lines = ["nnsan-c lock witness (sorted by p95 held time):",
             f"  {'lock':<{w}}  {'acq':>8}  {'contended':>9}  "
             f"{'held p50':>10}  {'held p95':>10}  {'wait p95':>10}"]
    for name, s in rows:
        acq = int(s.get("acquisitions", 0))
        con = int(s.get("contended", 0))
        pct = f" ({100.0 * con / acq:.0f}%)" if acq and con else ""
        lines.append(
            f"  {name:<{w}}  {acq:>8}  {f'{con}{pct}':>9}  "
            f"{s.get('held_p50_us', 0):>8.1f}us  "
            f"{s.get('held_p95_us', 0):>8.1f}us  "
            f"{s.get('wait_p95_us', 0):>8.1f}us")
    return "\n".join(lines)


def _arg_file(args, flag):
    idx = args.index(flag)
    if idx + 1 >= len(args):
        print(f"usage: doctor {flag} <report.json>", file=sys.stderr)
        return None
    return args[idx + 1]


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if "--timeline" in args:
        # ``doctor --timeline <report.json>`` — ASCII waterfall of the
        # host-stack attribution a bench --spans leg (or
        # Tracer.host_stack_report) saved
        path = _arg_file(args, "--timeline")
        if path is None:
            return 2
        with open(path, "r", encoding="utf-8") as f:
            print(render_timeline(json.load(f)))
        return 0
    if "--trace-request" in args:
        # ``doctor --trace-request <trace_id> <trace.json>`` — render one
        # request's cross-process waterfall from a (merged) Chrome trace
        # (trace ids come from exemplars, shed records, or bench output)
        idx = args.index("--trace-request")
        if idx + 2 >= len(args):
            print("usage: doctor --trace-request <trace_id> <trace.json>",
                  file=sys.stderr)
            return 2
        trace_id, path = args[idx + 1], args[idx + 2]
        with open(path, "r", encoding="utf-8") as f:
            print(render_trace_request(json.load(f), trace_id))
        return 0
    if "--metrics" in args:
        # ``doctor --metrics <report.json> [--openmetrics]`` —
        # Prometheus-style text of a saved tracer report (per-element
        # latency histograms, per-tenant serving wait, per-peer request
        # RTT, crossing/shed/reply counters). --openmetrics switches to
        # OpenMetrics and attaches the nntrace-x trace_id exemplars to
        # the latency buckets (exemplar syntax is OpenMetrics-only)
        from nnstreamer_tpu_torch.trace import metrics_text

        path = _arg_file(args, "--metrics")
        if path is None:
            return 2
        with open(path, "r", encoding="utf-8") as f:
            sys.stdout.write(metrics_text(
                json.load(f), openmetrics="--openmetrics" in args))
        return 0
    if "--rollout" in args:
        # ``doctor --rollout <report.json>`` — render the nnfleet-r
        # rollout decision log of a saved tracer report: every canary
        # verdict (promoted / rolled-back, with the fault delta or p99
        # regression that licensed it) per element
        path = _arg_file(args, "--rollout")
        if path is None:
            return 2
        with open(path, "r", encoding="utf-8") as f:
            print(render_rollout(json.load(f)))
        return 0
    if "--locks" in args:
        # ``doctor --locks <report.json>`` — render the nnsan-c lock
        # witness section of a saved tracer report: per-lock held-time /
        # wait-time percentiles and contention counters (present only
        # when the run had NNSTPU_SANITIZE=1)
        path = _arg_file(args, "--locks")
        if path is None:
            return 2
        with open(path, "r", encoding="utf-8") as f:
            print(render_locks(json.load(f)))
        return 0
    if "--ctl" in args:
        # ``doctor --ctl <report.json>`` — render the nnctl decision log
        # of a saved tracer report / bench ctl artifact: every knob
        # actuation (rule, before→after, the observed metrics that
        # licensed it) plus the current knob state per server
        path = _arg_file(args, "--ctl")
        if path is None:
            return 2
        with open(path, "r", encoding="utf-8") as f:
            print(render_ctl(json.load(f)))
        return 0
    if "--serving" in args:
        # ``doctor --serving <report.json>`` — render the serving section
        # of a saved tracer report / BENCH serving artifact (the nnserve
        # SLO table: batch fill, sheds, queue time, per-tenant goodput)
        idx = args.index("--serving")
        if idx + 1 >= len(args):
            print("usage: doctor --serving <tracer-report.json>",
                  file=sys.stderr)
            return 2
        with open(args[idx + 1], "r", encoding="utf-8") as f:
            text = f.read()
        try:
            print(render_serving(json.loads(text)))
        except json.JSONDecodeError:
            # BENCH_SERVING.json is JSONL (one metric record per line):
            # render every record that carries a serving section; a
            # malformed line (truncated mid-append) reports, not
            # tracebacks
            for i, line in enumerate(text.splitlines(), 1):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    print(f"bad JSON on line {i} of {args[idx + 1]}: {e}",
                          file=sys.stderr)
                    return 2
                print(render_serving(rec))
        return 0
    if "--aot-purge" in args:
        # ``doctor --aot-purge`` — remove every compile-cache entry of
        # this package (quarantine included); the next PLAYING builds
        # cold
        from nnstreamer_tpu_torch.filters import aot

        try:
            n = aot.purge_cache()
        except Exception as e:  # noqa: BLE001 — refused/unreadable dir
            print(f"AOT cache unavailable: {e}", file=sys.stderr)
            return 2
        print(f"purged {n} AOT cache entr{'y' if n == 1 else 'ies'}")
        return 0
    if "--aot" in args and not any(
            f in args for f in ("--lint", "--cost", "--tune", "--deploy")):
        # ``doctor --aot [report.json]`` — the compile-cache view:
        # with a saved tracer report, render its per-element hit/miss +
        # load-vs-compile section first; always list the on-disk cache
        # (key dims, size, age, last load — LRU eviction order).
        # (``doctor --lint --aot '<line>'`` stays the validate path: the
        # NNST97x static pass.)
        import os as _os

        idx = args.index("--aot")
        path = args[idx + 1] if idx + 1 < len(args) else None
        if path and _os.path.isfile(path):
            with open(path, "r", encoding="utf-8") as f:
                print(render_aot(json.load(f)))
        print(render_aot_cache())
        return 0
    if ("--lint" in args or "--cost" in args or "--tune" in args
            or "--deploy" in args):
        # ``doctor --lint [--strict] '<launch line>' …`` — run the nnlint
        # analyzer over launch descriptions (the validate CLI, wired here
        # so the environment checker is the one-stop triage tool); exit
        # codes 0 clean / 1 warnings / 2 errors. ``doctor --cost`` is the
        # capacity-planning variant: the opt-in NNST7xx/8xx cost & memory
        # passes plus the per-element cost table and static roofline
        # bottleneck report (validate --cost). ``doctor --tune`` is the
        # nntune autotuner: enumerate the config space, prune infeasible
        # points with the static model (NNST700/800/802/900, no compile),
        # rank the survivors, validate the top-K with short measured runs
        # (NNSTPU_TUNE_MEASURE=0 skips) and print the signed report.
        # ``doctor --deploy <spec>`` is the nndeploy fleet lint
        # (validate --deploy): the NNST99x cross-process verdicts.
        from nnstreamer_tpu_torch.tools.validate import main as validate_main

        rest = [a for a in args if a != "--lint"]
        return validate_main(rest)
    probe = "--no-device" not in args
    report = collect(probe_device=probe)
    if "--json" in args:
        print(json.dumps(report, indent=2, default=str))
        return 0
    print(f"nnstreamer_tpu_torch doctor (v{report['version']})")
    print(f"  torch: {report['torch']['version']} "
          f"cuda={report['torch']['cuda']}")
    print(f"  devices: {report.get('devices', 'skipped')}")
    hw = report["hw"]
    print(f"  hw: platform={hw['platform']} gpu={hw['has_gpu']} "
          f"kind={hw['gpu_kind']} sm={hw['sm_capability']} "
          f"cores={hw['cpu_count']}")
    k = report["kernels"]
    print(f"  nvcc: {k.get('nvcc') or 'NOT FOUND'}")
    print(f"  kernel library: "
          f"{'BUILT ' + k['library'] if k.get('built') else 'NOT BUILT'}"
          f" (digest {k.get('digest', '?')})")
    for sp_type, entries in report["subplugins"].items():
        ok = sorted(n for n, v in entries.items() if v)
        bad = sorted(n for n, v in entries.items() if not v)
        line = f"  {sp_type}: {', '.join(ok)}"
        if bad:
            line += f"  (unavailable: {', '.join(bad)})"
        print(line)
    print(f"  elements: {len(report['elements'])} registered")
    deps = ", ".join(f"{k}={'y' if v else 'n'}" for k, v in report["optional_deps"].items())
    print(f"  optional: {deps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
