"""gst-launch-style pipeline description parser.

The reference's primary user surface is pipeline strings
(Documentation/component-description.md:20-151):

    appsrc name=src ! other/tensors,... ! tensor_filter framework=jax \
        model=m.msgpack ! tensor_decoder mode=image_labeling ! tensor_sink

Supported grammar (the subset the reference's docs/tests actually use):
  - ``a ! b ! c`` chains
  - ``type key=value`` properties (quoted values with ' or ")
  - ``name=foo`` element naming, ``foo.`` / ``foo.sink_1`` pad references
    for fan-in/fan-out (mux/demux/tee)
  - bare caps (``other/tensors,num_tensors=1,...``) become capsfilter
    elements, as in gst-launch

nnlint integration: the tokenizer records each token's source span, every
``key=value`` property is checked against the target element's declared
schema (NNST1xx — unknown/mistyped/invalid-enum properties warn instead
of becoming silent runtime no-ops; ``strict=True`` raises), and the
constructed pipeline carries ``_source``/per-element ``_span`` +
``_prop_spans`` so analyzer diagnostics can point at the offending token.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

from nnstreamer_tpu_torch.analysis.diagnostics import Diagnostic
from nnstreamer_tpu_torch.analysis.schema import check_value, closest_key, schema_for
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    element_class,
    element_factory_make,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

log = get_logger("parse")


class _Tok(NamedTuple):
    text: str
    start: int
    end: int


class _ParseCtx:
    """Carries the source text + diagnostic sink through one parse."""

    def __init__(self, source: str, diagnostics: Optional[list],
                 strict: bool, origin=None, member: Optional[str] = None):
        self.source = source
        self.diagnostics = diagnostics
        self.strict = strict
        self.origin = origin  # (path, 1-based line) for multi-file sources
        self.member = member  # deploy-spec member name, when applicable

    def emit(self, code: str, element: str, message: str,
             span: Optional[Tuple[int, int]] = None,
             hint: Optional[str] = None) -> None:
        path, line = self.origin if self.origin else (None, None)
        d = Diagnostic(code=code, element=element, message=message,
                       hint=hint, span=span, source=self.source,
                       member=self.member, path=path, line=line)
        if self.strict and d.severity in ("warning", "error"):
            raise ValueError(d.format())
        if self.diagnostics is not None:
            self.diagnostics.append(d)
        else:
            log.warning("%s", d.format(show_span=False))


def parse_launch(description: str, name: str = "pipeline",
                 diagnostics: Optional[list] = None,
                 strict: bool = False, origin=None,
                 member: Optional[str] = None) -> Pipeline:
    """Build a pipeline from a launch description.

    ``diagnostics``: optional list that collects NNST1xx property
    diagnostics (unknown/mistyped properties). Without it they are
    logged as warnings — never silently dropped. ``strict=True`` turns
    the first such diagnostic into a ValueError (CI mode).

    ``origin``: optional ``(path, line)`` of the description inside a
    multi-file source (a deploy spec); ``member`` names the spec member.
    Both are stamped on every diagnostic this parse (and later analysis
    of the returned pipeline) produces, so findings cite
    ``<spec>:<line>`` instead of an anonymous string. With the defaults
    the output is byte-identical to before these existed.
    """
    ctx = _ParseCtx(description, diagnostics, strict,
                    origin=origin, member=member)
    pipe = Pipeline(name)
    pipe._source = description
    if origin is not None:
        pipe._origin = origin
    if member is not None:
        pipe._member = member
    tokens = _tokenize_spans(description)
    chains = _split_chains(tokens)
    deferred: List[tuple] = []  # forward pad references, resolved after all
    for chain in chains:
        _build_chain(pipe, chain, deferred, ctx)
    for src_pad, ref in deferred:
        elem, sink_pad, _ = _resolve_ref(pipe, ref)
        tp = sink_pad if sink_pad is not None else Pipeline._free_sink_pad(elem)
        src_pad.link(tp)
    return pipe


def _tokenize_spans(s: str) -> List[_Tok]:
    """Whitespace-split tokenizer with posix-style quote/escape handling
    (shlex.whitespace_split semantics) that keeps each token's source
    span for diagnostics."""
    toks: List[_Tok] = []
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i].isspace():
            i += 1
        if i >= n:
            break
        start = i
        parts: List[str] = []
        while i < n and not s[i].isspace():
            c = s[i]
            if c in ("'", '"'):
                quote = c
                i += 1
                while i < n and s[i] != quote:
                    if quote == '"' and s[i] == "\\" and i + 1 < n:
                        i += 1
                    parts.append(s[i])
                    i += 1
                if i >= n:
                    raise ValueError("No closing quotation")
                i += 1
            elif c == "\\" and i + 1 < n:
                parts.append(s[i + 1])
                i += 2
            else:
                parts.append(c)
                i += 1
        toks.append(_Tok("".join(parts), start, i))
    return toks


def _tokenize(s: str) -> List[str]:
    """Token texts only (kept for callers that predate spans)."""
    return [t.text for t in _tokenize_spans(s)]


def _split_chains(tokens: List[_Tok]) -> List[List[List[_Tok]]]:
    """tokens → chains; each chain is a list of node token-groups.

    A node group is [head, prop...]; '!' separates nodes; a new chain starts
    at a token group following a node that wasn't followed by '!'."""
    chains: List[List[List[_Tok]]] = []
    cur_chain: List[List[_Tok]] = []
    cur_node: List[_Tok] = []
    expecting_link = False  # saw '!' → next node continues chain
    for tok in tokens:
        if tok.text == "!":
            if not cur_node:
                raise ValueError("dangling '!' in pipeline description")
            cur_chain.append(cur_node)
            cur_node = []
            expecting_link = True
            continue
        if "=" in tok.text and cur_node and not _is_node_head(tok.text):
            cur_node.append(tok)  # property
            continue
        # new node head
        if cur_node:
            cur_chain.append(cur_node)
            cur_node = []
            if not expecting_link:
                chains.append(cur_chain)
                cur_chain = []
        elif cur_chain and not expecting_link:
            chains.append(cur_chain)
            cur_chain = []
        cur_node = [tok]
        expecting_link = False
    if cur_node:
        cur_chain.append(cur_node)
    if cur_chain:
        chains.append(cur_chain)
    return chains


def _is_node_head(tok: str) -> bool:
    """True if tok starts a new node (element type, caps, or pad ref) rather
    than being a key=value property."""
    if "/" in tok.split("=")[0]:
        return True  # caps like other/tensors,format=...
    return False


def _build_chain(pipe: Pipeline, chain: List[List[_Tok]],
                 deferred: List[tuple], ctx: _ParseCtx) -> None:
    prev_elem: Optional[Element] = None
    prev_pad = None
    for group in chain:
        head, props = group[0], group[1:]
        if _is_pad_ref(pipe, head.text) and \
                head.text.split(".")[0] not in pipe.elements:
            # forward reference (gst-launch allows "…! mx." before mx exists):
            # record the source side now, resolve once all chains are built
            if prev_elem is None:
                raise ValueError(
                    f"forward reference {head.text!r} cannot start a chain"
                )
            sp = prev_pad if prev_pad is not None else Pipeline._free_src_pad(prev_elem)
            sp.reserved = True  # keep later chains from claiming it
            deferred.append((sp, head.text))
            prev_elem, prev_pad = None, None
            continue
        elem, sink_pad, src_pad = _make_node(pipe, head, props, ctx)
        if prev_elem is not None:
            sp = prev_pad if prev_pad is not None else Pipeline._free_src_pad(prev_elem)
            tp = sink_pad if sink_pad is not None else Pipeline._free_sink_pad(elem)
            sp.link(tp)
        prev_elem, prev_pad = elem, src_pad


def _is_pad_ref(pipe: Pipeline, head: str) -> bool:
    if "/" in head:
        return False
    if head.endswith("."):
        return True
    return "." in head and "=" not in head.split(".")[0]


def _resolve_ref(pipe: Pipeline, head: str):
    ename, _, pname = head.partition(".")
    if ename not in pipe.elements:
        raise ValueError(f"reference to unknown element {ename!r}")
    elem = pipe.elements[ename]
    if pname:
        pad = elem.get_pad(pname)
        if pad is None:
            pad = elem.request_pad(pname)
        from nnstreamer_tpu_torch.pipeline.element import PadDirection

        if pad.direction == PadDirection.SINK:
            return elem, pad, None
        return elem, None, pad
    return elem, None, None


def _make_node(
    pipe: Pipeline, head: _Tok, props: List[_Tok], ctx: _ParseCtx
) -> Tuple[Element, Optional[object], Optional[object]]:
    """Returns (element, explicit_sink_pad, explicit_src_pad)."""
    # pad reference: "name." or "name.padname"
    if head.text.endswith(".") or (
        "." in head.text and head.text.split(".")[0] in pipe.elements
        and "/" not in head.text
    ):
        return _resolve_ref(pipe, head.text)
    # bare caps → capsfilter
    if "/" in head.text.split(",")[0].split("=")[0]:
        caps = Caps.from_string(head.text)
        elem = element_factory_make("capsfilter", caps=caps)
        elem._span = (head.start, head.end)
        elem._prop_spans = {}
        pipe.add(elem)
        return elem, None, None
    # ordinary element
    kv = {}
    ename = None
    prop_spans = {}
    cls = element_class(head.text)
    schema = schema_for(cls) if cls is not None else None
    for p in props:
        k, _, v = p.text.partition("=")
        if k == "name":
            ename = v
            continue
        key = k.replace("-", "_")
        value = _coerce(v)
        span = (p.start, p.end)
        prop_spans[key] = span
        label = ename or head.text
        if schema is not None:
            spec = schema.get(key)
            if spec is None:
                guess = closest_key(key, schema)
                ctx.emit(
                    "NNST100", label,
                    f"unknown property {k!r} on {head.text!r} "
                    f"(silently ignored at runtime)",
                    span=span,
                    hint=(f"did you mean {guess.replace('_', '-')!r}?"
                          if guess else None))
            else:
                err = check_value(spec, value)
                if err is not None:
                    code, msg = err
                    ctx.emit(code, label, f"property {k!r}: {msg}",
                             span=span)
        kv[key] = value
    elem = element_factory_make(head.text, name=ename, **kv)
    elem._span = (head.start, head.end)
    elem._prop_spans = prop_spans
    pipe.add(elem)
    return elem, None, None


def _coerce(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    low = v.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    return v
