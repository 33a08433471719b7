"""nnlint — the multi-pass pipeline analyzer (counterpart of the JAX
package's ``analysis`` package).

Every finding is a stable ``NNSTxxx`` code with severity, element
attribution and, for launch-line pipelines, a source span:

- **Diagnostics** (:mod:`analysis.diagnostics`): the code table.
- **Passes** (:mod:`analysis.passes` via :mod:`analysis.registry`):
  graph structure, property schemas, static caps dry-run negotiation,
  residency/crossing prediction, fusion safety, whole-chain composition,
  steady-loop eligibility, deadlock detection, serving lints, compile
  churn, the opt-in cost and memory passes, and the explicit-only tuner
  pass (:mod:`analysis.tuner`, NNST850–853; ``validate --tune``).

- **Sanitizer** (:mod:`analysis.sanitizer`, ``NNSTPU_SANITIZE=1``):
  runtime checks for tee aliasing (NNST600), concurrent invokes (NNST601)
  and un-billed materialization (NNST602), with the lock witness
  (:mod:`analysis.lockwitness`, NNST610–613).

Entry points: :func:`analyze` (constructed pipeline) and
:func:`analyze_launch` (launch string — parse diagnostics included).
``tools/validate.py`` wraps these for the CLI/CI.

The JAX package's AOT and deploy passes are not in this package
(ROADMAP.md queue 1).

This ``__init__`` stays import-light (element modules import the schema
from here); the heavier pass machinery loads on first use.
"""

from __future__ import annotations

from typing import List, Optional

from nnstreamer_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CODES,
    Diagnostic,
    exit_code,
    format_diagnostic,
    worst_severity,
)
from nnstreamer_tpu_torch.analysis.schema import Prop, schema_for  # noqa: F401
from nnstreamer_tpu_torch.analysis import sanitizer  # noqa: F401


def analyze(pipeline, passes=None, cost: bool = False,
            extra=None) -> List[Diagnostic]:
    """Run the static passes over a constructed pipeline. ``cost=True``
    additionally runs the opt-in cost/memory passes (NNST7xx/8xx program
    analysis — may build model bundles, so it is not part of the default
    lint). ``extra`` names explicit passes to run alongside the default
    selection (e.g. ``["aot"]`` for the NNST97x cache verdicts)."""
    from nnstreamer_tpu_torch.analysis.registry import run_passes

    return run_passes(pipeline, passes=passes, include_opt_in=cost,
                      extra=extra)


def analyze_launch(description: str, passes=None,
                   cost: bool = False, extra=None) -> List[Diagnostic]:
    """Parse a launch line and analyze it. Construction failures become
    diagnostics (NNST106/NNST107) instead of exceptions, so a broken
    pipeline still lints."""
    return analyze_launch_with_pipeline(description, passes=passes,
                                        cost=cost, extra=extra)[0]


def analyze_launch_with_pipeline(description: str, passes=None,
                                 cost: bool = False, extra=None,
                                 origin=None, member: Optional[str] = None):
    """``analyze_launch`` returning ``(diagnostics, pipeline_or_None)`` —
    the pipeline (None when construction failed) lets callers reuse the
    analyzed graph (and its memoized per-filter costs) instead of
    re-parsing and re-abstract-evaling, e.g. the ``validate --cost``
    table renderer. ``origin``/``member`` thread multi-file attribution
    (a deploy spec's ``(path, line)`` + member name) onto every
    diagnostic; the defaults leave output byte-identical."""
    from nnstreamer_tpu_torch.log import ElementError
    from nnstreamer_tpu_torch.pipeline.parse import parse_launch

    path, line = origin if origin else (None, None)
    diags: List[Diagnostic] = []
    try:
        pipe = parse_launch(description, diagnostics=diags,
                            origin=origin, member=member)
    except ElementError as e:
        diags.append(Diagnostic(
            code="NNST106", element=getattr(e, "element", "pipeline"),
            message=f"element construction failed: {e}",
            source=description, member=member, path=path, line=line))
        return diags, None
    except (ValueError, PermissionError) as e:
        msg = str(e)
        code = "NNST107" if "no such element type" in msg else "NNST106"
        hint = None
        if code == "NNST107":
            hint = _element_hint(msg)
        diags.append(Diagnostic(code=code, element="pipeline", message=msg,
                                hint=hint, source=description,
                                member=member, path=path, line=line))
        return diags, None
    # the properties pass re-checks everything parse already diagnosed;
    # dedup on (code, source span) — the span pins the exact offending
    # token, while element label and message wording differ between the
    # parse-time and pass-time emissions
    def key(d):
        return (d.code, d.span) if d.span else (d.code, d.element, d.message)

    seen = {key(d) for d in diags}
    for d in analyze(pipe, passes=passes, cost=cost, extra=extra):
        if key(d) not in seen:
            diags.append(d)
    from nnstreamer_tpu_torch.analysis.diagnostics import sort_diagnostics

    return sort_diagnostics(diags), pipe


def _element_hint(msg: str) -> Optional[str]:
    """did-you-mean for an unknown element type name."""
    import difflib
    import re

    m = re.search(r"no such element type '([^']+)'", msg)
    if not m:
        return None
    from nnstreamer_tpu_torch.pipeline.element import element_types

    hits = difflib.get_close_matches(m.group(1), element_types(), n=1,
                                     cutoff=0.6)
    return f"did you mean {hits[0]!r}?" if hits else None
