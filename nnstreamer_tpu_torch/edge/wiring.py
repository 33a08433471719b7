"""Static wiring metadata extraction for the nndeploy fleet analyzer
(counterpart of the JAX package's ``edge/wiring.py``).

The edge layer has three cross-process transports — tensor_query
(client/serversrc TCP + HYBRID discovery), nnstreamer-edge pub/sub
(edgesink/edgesrc) and MQTT (mqttsink/mqttsrc). Each element already
declares everything a fleet-level linter needs (ports, topics,
connect-type, hedging endpoints) as properties; this module walks a
parsed pipeline and returns a flat, typed endpoint list so
``analysis/deploy.py`` can match clients to servers across member
pipelines without knowing per-element property spellings.

Pure property reads — no sockets, no broker, no PLAYING.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class WireEndpoint:
    """One cross-process attachment point of a pipeline.

    ``kind``: ``"server"`` (listens / publishes) or ``"client"``
    (connects / subscribes). ``transport``: ``"query"`` | ``"edge"`` |
    ``"mqtt"``. ``targets`` is the client's connect list (one entry per
    ``host:port``; a query client's ``endpoints=`` fleet expands here).
    ``rid_dedup`` is True only for transports whose server side
    deduplicates hedged resends via the ``_rid`` idempotency token
    (the tensor_query RidFilter) — the NNST995 hedging check keys on it.
    """

    kind: str
    transport: str
    element: object
    port: Optional[int] = None
    host: Optional[str] = None
    topic: Optional[str] = None
    connect_type: str = "TCP"
    targets: List[Tuple[str, int]] = field(default_factory=list)
    rid_dedup: bool = False

    @property
    def name(self) -> str:
        return self.element.name

    def prop_span(self, key: str):
        return getattr(self.element, "_prop_spans", {}).get(key)


def _int_prop(e, key) -> Optional[int]:
    v = e.properties.get(key)
    if v in (None, ""):
        return None
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


def _str_prop(e, key) -> Optional[str]:
    v = e.properties.get(key)
    if v in (None, ""):
        return None
    return str(v)


def endpoints_of(pipeline) -> List[WireEndpoint]:
    """Every cross-process endpoint a parsed pipeline declares, in
    element insertion order (deterministic for one launch line)."""
    from nnstreamer_tpu_torch.elements.edge_elems import EdgeSink, EdgeSrc
    from nnstreamer_tpu_torch.elements.mqtt_elems import MqttSink, MqttSrc
    from nnstreamer_tpu_torch.elements.query import (
        TensorQueryClient,
        TensorQueryServerSrc,
    )

    out: List[WireEndpoint] = []
    for e in pipeline.elements.values():
        ct = str(e.properties.get("connect_type", "TCP") or "TCP")
        if isinstance(e, TensorQueryServerSrc):
            out.append(WireEndpoint(
                kind="server", transport="query", element=e,
                port=_int_prop(e, "port"), host=_str_prop(e, "host"),
                topic=_str_prop(e, "topic"), connect_type=ct,
                rid_dedup=True))
        elif isinstance(e, TensorQueryClient):
            ep = WireEndpoint(
                kind="client", transport="query", element=e,
                port=_int_prop(e, "port"), host=_str_prop(e, "host"),
                topic=_str_prop(e, "topic"), connect_type=ct)
            spec = _str_prop(e, "endpoints")
            if spec:
                from nnstreamer_tpu_torch.edge.fleet import parse_endpoints

                try:
                    ep.targets = list(parse_endpoints(spec))
                except ValueError:
                    ep.targets = []  # malformed: start() rejects it
            elif ep.port is not None and ct == "TCP":
                ep.targets = [(ep.host or "localhost", ep.port)]
            out.append(ep)
        elif isinstance(e, EdgeSink):
            out.append(WireEndpoint(
                kind="server", transport="edge", element=e,
                port=_int_prop(e, "port"), host=_str_prop(e, "host"),
                topic=_str_prop(e, "topic"), connect_type=ct))
        elif isinstance(e, EdgeSrc):
            ep = WireEndpoint(
                kind="client", transport="edge", element=e,
                port=_int_prop(e, "port"), host=_str_prop(e, "host"),
                topic=_str_prop(e, "topic"), connect_type=ct)
            if ep.port is not None and ct == "TCP":
                ep.targets = [(ep.host or "localhost", ep.port)]
            out.append(ep)
        elif isinstance(e, MqttSink):
            out.append(WireEndpoint(
                kind="server", transport="mqtt", element=e,
                port=_int_prop(e, "port"), host=_str_prop(e, "host"),
                topic=_str_prop(e, "topic")))
        elif isinstance(e, MqttSrc):
            out.append(WireEndpoint(
                kind="client", transport="mqtt", element=e,
                port=_int_prop(e, "port"), host=_str_prop(e, "host"),
                topic=_str_prop(e, "topic")))
    return out
