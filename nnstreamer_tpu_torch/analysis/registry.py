"""Analysis pass registry + runner.

Passes register with :func:`analysis_pass` and receive an
:class:`AnalysisContext`; ``run_passes`` executes them in registration
order over a constructed pipeline and returns the collected diagnostics.
``tools/validate.py`` and ``doctor --lint`` are thin shells over this.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from nnstreamer_tpu_torch.analysis.diagnostics import (CODES, Diagnostic,
                                                 sort_diagnostics)

_passes: Dict[str, Callable] = {}
_opt_in: set = set()
_explicit: set = set()


def analysis_pass(name: str, opt_in: bool = False, explicit: bool = False):
    """Register a pass: ``fn(ctx: AnalysisContext) -> None``.

    ``opt_in=True`` marks a pass that is skipped by the default
    ``analyze()`` run and executes only when selected by name or via
    ``include_opt_in`` (``validate --cost``): the cost/memory passes may
    build model bundles to abstract-eval their programs, which is too
    heavy to pay on every lint of every pipeline.

    ``explicit=True`` marks a pass that runs ONLY when named in
    ``passes`` — even ``include_opt_in`` skips it. The tuner pass uses
    this: it evaluates the whole configuration space, which would turn
    every ``validate --cost`` into a full search."""

    def deco(fn):
        _passes[name] = fn
        if opt_in:
            _opt_in.add(name)
        if explicit:
            _explicit.add(name)
        return fn

    return deco


def pass_names() -> List[str]:
    return list(_passes)


class AnalysisContext:
    def __init__(self, pipeline, source: Optional[str] = None):
        self.pipeline = pipeline
        # launch-line source text + parse spans, when the pipeline came
        # from parse_launch (API-built graphs simply have no spans)
        self.source = source if source is not None else getattr(
            pipeline, "_source", None)
        # multi-file attribution: a deploy-spec member pipeline carries
        # the spec member name + (path, line) of its launch line, so
        # every pass emission cites ``<spec>:<line>`` for free
        self.member = getattr(pipeline, "_member", None)
        self.origin = getattr(pipeline, "_origin", None)
        self.diagnostics: List[Diagnostic] = []

    def emit(self, code: str, element, message: str, hint: Optional[str] = None,
             span=None, severity: str = "", member: Optional[str] = None,
             origin=None, source: Optional[str] = None) -> Diagnostic:
        if code not in CODES:
            raise ValueError(f"unknown diagnostic code {code!r}")
        name = element if isinstance(element, str) else element.name
        if span is None and not isinstance(element, str):
            span = getattr(element, "_span", None)
        if member is None:
            member = self.member
        if origin is None:
            origin = self.origin
        path, line = origin if origin else (None, None)
        d = Diagnostic(code=code, element=name, message=message,
                       severity=severity, hint=hint, span=span,
                       source=source if source is not None else self.source,
                       member=member, path=path, line=line)
        self.diagnostics.append(d)
        return d


def run_passes(pipeline, source: Optional[str] = None,
               passes=None, include_opt_in: bool = False,
               extra=None) -> List[Diagnostic]:
    """Run the (selected) registered passes; returns all diagnostics in
    pass order. Pass bodies must never raise for malformed graphs — a
    broken pipeline is their INPUT, not an error condition. Opt-in
    passes (cost/memory) run only when named in ``passes`` or when
    ``include_opt_in`` is set. ``extra`` names passes to run IN ADDITION
    to the default selection (``validate --aot`` composes the explicit
    aot pass with the normal lint this way).

    Determinism contract: passes ALWAYS execute in registration order —
    ``extra`` is membership, never ordering — and the returned list is
    stably sorted by (code, member, element, span), so the bytes a CI
    gate diffs can never depend on dict/set iteration order."""
    import nnstreamer_tpu_torch.analysis.passes  # noqa: F401 — registers built-ins

    wanted = set(extra or ())
    ctx = AnalysisContext(pipeline, source)
    for name, fn in _passes.items():
        if passes is not None:
            if name not in passes:
                continue
        elif name in wanted:
            pass  # requested alongside the defaults
        elif name in _explicit:
            continue  # explicit-only passes never run unselected
        elif name in _opt_in and not include_opt_in:
            continue
        fn(ctx)
    return sort_diagnostics(ctx.diagnostics)
