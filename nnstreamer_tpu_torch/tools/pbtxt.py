"""pbtxt ↔ launch-string pipeline descriptions (counterpart of the JAX
package's ``tools/pbtxt.py``; the launch side goes through this
package's ``parse_launch``).

Reference counterpart: tools/development/gstPrototxt.py + parser/ (the
gst2pbtxt bison parser) — pipelines exchanged as protobuf-text graphs.
Our dialect is a flat node list; edges are declared by ``input:`` fields
naming the upstream node (matching the element ``name=`` property):

    node {
      element: "tensor_converter"
      name: "conv"
      property { key: "frames-per-tensor" value: "4" }
      input: "src"
    }

Round trip: ``pbtxt_to_launch`` emits a gst-launch string for
pipeline.parse_launch (named-ref branches for fan-out); ``launch_to_pbtxt``
parses a launch string into pbtxt via the pipeline parser itself, so both
directions share one grammar implementation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["pbtxt_to_launch", "launch_to_pbtxt", "parse_pbtxt", "Node"]


@dataclass
class Node:
    element: str
    name: Optional[str] = None
    properties: List[Tuple[str, str]] = field(default_factory=list)
    inputs: List[str] = field(default_factory=list)


_TOKEN_RE = re.compile(
    r"""
    (?P<open>\{)
  | (?P<close>\})
  | (?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*:?\s*
  | (?P<string>"(?:[^"\\]|\\.)*")
  """,
    re.VERBOSE,
)


def _tokens(text: str):
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        for m in _TOKEN_RE.finditer(line):
            kind = m.lastgroup
            val = m.group()
            if kind == "key":
                val = m.group("key")
            elif kind == "string":
                val = val[1:-1].encode().decode("unicode_escape")
            yield kind, val


def parse_pbtxt(text: str) -> List[Node]:
    nodes: List[Node] = []
    it = _tokens(text)
    for kind, val in it:
        if kind == "key" and val == "node":
            k, _ = next(it, (None, None))
            if k != "open":
                raise ValueError("expected '{' after node")
            nodes.append(_parse_node(it))
        elif kind in ("key",):
            raise ValueError(f"unexpected top-level field {val!r}")
    return nodes


def _parse_node(it) -> Node:
    node = Node(element="")
    for kind, val in it:
        if kind == "close":
            if not node.element:
                raise ValueError("node missing element:")
            return node
        if kind != "key":
            raise ValueError(f"unexpected token {val!r} in node")
        if val == "property":
            k, _ = next(it, (None, None))
            if k != "open":
                raise ValueError("expected '{' after property")
            node.properties.append(_parse_property(it))
            continue
        vk, vv = next(it, (None, None))
        if vk != "string":
            raise ValueError(f"field {val!r} needs a quoted value")
        if val == "element":
            node.element = vv
        elif val == "name":
            node.name = vv
        elif val == "input":
            node.inputs.append(vv)
        else:
            raise ValueError(f"unknown node field {val!r}")
    raise ValueError("unterminated node block")


def _parse_property(it) -> Tuple[str, str]:
    key = value = None
    for kind, val in it:
        if kind == "close":
            if key is None or value is None:
                raise ValueError("property needs key and value")
            return key, value
        if kind == "key" and val in ("key", "value"):
            vk, vv = next(it, (None, None))
            if vk != "string":
                raise ValueError("property key/value must be quoted")
            if val == "key":
                key = vv
            else:
                value = vv
        else:
            raise ValueError(f"unexpected token {val!r} in property")
    raise ValueError("unterminated property block")


def pbtxt_to_launch(text: str) -> str:
    """Emit a launch string: chains follow edges; fan-out uses named refs."""
    nodes = parse_pbtxt(text)
    # assign names so edges can reference every node
    used = {n.name for n in nodes if n.name}
    counter = 0
    for n in nodes:
        if not n.name:
            while f"_n{counter}" in used:
                counter += 1
            n.name = f"_n{counter}"
            used.add(n.name)
    by_name: Dict[str, Node] = {n.name: n for n in nodes}
    for n in nodes:
        for i in n.inputs:
            if i not in by_name:
                raise ValueError(f"node {n.name!r} references unknown input {i!r}")

    def node_str(n: Node) -> str:
        parts = [n.element, f"name={n.name}"]
        for k, v in n.properties:
            parts.append(f"{k}={v}" if not re.search(r"\s", v) else f'{k}="{v}"')
        return " ".join(parts)

    # topological emission: start chains at source nodes (no inputs), walk
    # single-consumer edges; extra consumers branch via "name. !"
    consumers: Dict[str, List[Node]] = {}
    for n in nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)

    emitted = set()
    chains: List[str] = []

    def emit_chain(start: Node, prefix: str) -> None:
        chain = [prefix] if prefix else []
        cur = start
        while True:
            chain.append(node_str(cur))
            emitted.add(cur.name)
            outs = [c for c in consumers.get(cur.name, []) if c.name not in emitted]
            if not outs:
                break
            nxt, rest = outs[0], outs[1:]
            for r in rest:
                pending.append((r, f"{cur.name}. !"))
            # only follow if all of nxt's inputs are emitted (mux fan-in)
            if all(i in emitted for i in nxt.inputs):
                cur = nxt
            else:
                pending.append((nxt, f"{cur.name}. !"))
                break
        chains.append(" ! ".join(chain) if not prefix else chain[0] + " " + " ! ".join(chain[1:]))

    pending: List[Tuple[Node, str]] = [(n, "") for n in nodes if not n.inputs]
    stall = 0
    while pending:
        if stall > len(pending):
            break  # a full lap made no progress: cycle → error below
        node, prefix = pending.pop(0)
        if node.name in emitted:
            if prefix:  # link an extra input edge into an emitted node
                chains.append(f"{prefix} {node.name}.")
            stall = 0
            continue
        if prefix and not all(i in emitted for i in node.inputs):
            pending.append((node, prefix))
            stall += 1
            continue
        emit_chain(node, prefix)
        stall = 0
    if len(emitted) != len(nodes):
        missing = [n.name for n in nodes if n.name not in emitted]
        raise ValueError(f"disconnected or cyclic nodes: {missing}")
    return "  ".join(chains)


def launch_to_pbtxt(launch: str) -> str:
    """Parse a launch string (via the pipeline parser) and emit pbtxt."""
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(launch)
    lines: List[str] = []
    for e in p.elements.values():
        lines.append("node {")
        lines.append(f'  element: "{e.ELEMENT_NAME}"')
        lines.append(f'  name: "{e.name}"')
        for k, v in e.properties.items():
            if k == "name":
                continue
            lines.append("  property {")
            lines.append(f'    key: "{k}"')
            lines.append(f'    value: "{v}"')
            lines.append("  }")
        for sp in e.sink_pads:
            if sp.peer is not None:
                lines.append(f'  input: "{sp.peer.element.name}"')
        lines.append("}")
    return "\n".join(lines) + "\n"
