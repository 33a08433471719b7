"""Pipeline graph validator — the CLI/CI shell over the nnlint analyzer
(counterpart of the JAX package's ``tools/validate.py``).

A pipeline is checked before PLAYING by ``nnstreamer_tpu_torch.analysis``'s
pass pipeline: graph structure, property schemas, static caps dry-run
negotiation, residency/crossing prediction, fusion safety, whole-chain
composition, steady-loop eligibility, mesh and replica-pool eligibility,
serving thread topology and queue/mux deadlock detection —
every finding a stable ``NNSTxxx`` code with element attribution and (for
launch-line pipelines) a source span.

Library use: ``issues = validate(parse_launch("..."))`` — each issue is
(severity, element, message); 'error' predicts a runtime failure,
'warning' is a smell. ``analyze``/``analyze_launch`` return the full
:class:`Diagnostic` objects.

CLI exit codes (CI gating): 0 clean / 1 warnings / 2 errors; ``--strict``
promotes warnings to errors. ``--tune`` hands the invocation to the
autotuner's CLI (:func:`analysis.tuner.tune_main`). The JAX package's
``--aot`` and ``--deploy`` wait with their analyses (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import List, Tuple

from nnstreamer_tpu_torch.analysis import (
    analyze,
    analyze_launch,
    analyze_launch_with_pipeline,
    exit_code,
)

Issue = Tuple[str, str, str]  # severity, element, message


def validate(pipeline) -> List[Issue]:
    """Static lint of a constructed pipeline. Info-level diagnostics
    (residency plans, unresolved negotiation) are analyzer-only detail
    and not reported here."""
    return [
        (d.severity, d.element, f"{d.code}: {d.message}")
        for d in analyze(pipeline)
        if d.severity != "info"
    ]


def validate_launch(description: str) -> List[Issue]:
    return [
        (d.severity, d.element, f"{d.code}: {d.message}")
        for d in analyze_launch(description)
        if d.severity != "info"
    ]


def main(argv=None) -> int:
    """``python -m nnstreamer_tpu_torch.tools.validate [--strict]
    [--verbose] [--cost] [--json] [--file <path>] '<launch line>' …``

    ``--file`` reads launch lines (one per line, '#' comments) from a
    file. ``--cost`` additionally runs the opt-in static cost and memory
    passes (NNST70x) and prints the per-element cost table and roofline
    bottleneck. ``--json`` emits one deterministic JSON document (code /
    severity / member / element / span / path / line / fix-hint per
    diagnostic) instead of text — exit codes unchanged. ``--tune`` hands
    the whole invocation to the autotuner's CLI (static config-space
    search and measured top-K validation; its own flags --objective,
    --top-k, --json, --no-measure apply, and ``NNSTPU_TUNE_MEASURE=0``
    skips the measured phase; exit 0, or 2 on a broken line or a fully
    pruned space). Exit 0 clean / 1 warnings / 2 errors (``--strict``:
    warnings exit 2)."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if "--tune" in args:
        from nnstreamer_tpu_torch.analysis.tuner import tune_main

        return tune_main([a for a in args if a != "--tune"])
    strict = "--strict" in args
    verbose = "--verbose" in args
    cost = "--cost" in args
    as_json = "--json" in args
    args = [a for a in args
            if a not in ("--strict", "--verbose", "--cost", "--json")]
    descs: List[str] = []
    while args:
        a = args.pop(0)
        if a == "--file":
            if not args:
                print("--file needs a path", file=sys.stderr)
                return 2
            with open(args.pop(0), "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        descs.append(line)
        elif a.startswith("--"):
            print(f"unknown option {a!r}", file=sys.stderr)
            return 2
        else:
            descs.append(a)
    if not descs:
        print("usage: python -m nnstreamer_tpu_torch.tools.validate "
              "[--strict] [--verbose] [--cost] [--json] [--file <path>] "
              "'<launch description>' [...]", file=sys.stderr)
        return 2
    rc = 0
    results = []
    for desc in descs:
        diags, pipe = analyze_launch_with_pipeline(desc, cost=cost)
        rc = max(rc, _report(desc, diags, strict, verbose, as_json,
                             results))
        if cost and not as_json and pipe is not None:
            _print_cost_report(pipe)
    if as_json:
        import json

        print(json.dumps({"results": results, "exit": rc},
                         sort_keys=True, separators=(",", ":")))
    return rc


def _report(source: str, diags, strict: bool, verbose: bool,
            as_json: bool, results: list) -> int:
    """Render one launch line's diagnostics and return its exit code. In
    ``--json`` mode the line is appended to ``results`` instead."""
    rc = exit_code(diags, strict=strict)
    if as_json:
        results.append({
            "source": source,
            "diagnostics": [d.to_dict() for d in diags],
            "exit": rc,
        })
        return rc
    shown = [d for d in diags if verbose or d.severity != "info"]
    for d in shown:
        print(d.format())
    if not shown:
        print(f"ok: {source}")
    return rc


def _print_cost_report(pipe) -> None:
    """The ``--cost`` table: per-filter flops/bytes + the static roofline
    bottleneck (analysis/costmodel.static_report), on the ALREADY analyzed
    pipeline so the per-filter meta runs (memoized on the elements) are
    reused."""
    from nnstreamer_tpu_torch.analysis.costmodel import (
        render_cost_report,
        static_report,
    )

    try:
        report = static_report(pipe)
    except Exception:  # noqa: BLE001 — broken lines already diagnosed
        return
    if report["rows"] or report["unmodeled"]:
        print(render_cost_report(report))


if __name__ == "__main__":
    raise SystemExit(main())
