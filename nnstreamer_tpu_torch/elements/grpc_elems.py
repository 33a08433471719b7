"""gRPC tensor stream elements: tensor_src_grpc / tensor_sink_grpc.

Reference counterpart: ext/nnstreamer/tensor_source/tensor_src_grpc.c +
tensor_sink_grpc.c over extra/nnstreamer_grpc_common.cc (NNStreamerRPC:
server OR client at either end, sync/async, blocking queues,
protobuf/flatbuf IDLs). Redesign: one streaming RPC service built with
grpc's generic method handlers (no codegen), payloads are
nnstpu.TensorFrame protobuf messages (idl=protobuf, default) or
flexbuffers frames (idl=flatbuf).

Topology matrix (same as the reference's `server` property):
  tensor_sink_grpc server=true  — serves RecvFrames: remote clients pull
                                  this pipeline's output stream
  tensor_sink_grpc server=false — client of SendFrames: pushes frames to a
                                  remote serving tensor_src_grpc
  tensor_src_grpc  server=true  — serves SendFrames: remote clients push
                                  frames into this pipeline
  tensor_src_grpc  server=false — client of RecvFrames: pulls a remote
                                  pipeline's output stream

A copy of the JAX package's elements; each package's elements talk to the
other's. ``grpc`` and the IDL's package (``google.protobuf`` or
``flatbuffers``) are imported when an element starts, never when this
module is: without one of them ``start`` raises ``ElementError`` naming
the package (``rpc.require``), and nothing falls back to another
transport. The sink brings tensors on the card to the host once a buffer,
in the encoder.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Optional

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.rpc import codec, require
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    FlowReturn,
    Pad,
    SourceElement,
    element_register,
)

log = get_logger("grpc")

SERVICE = "nnstpu.TensorService"
SEND_METHOD = f"/{SERVICE}/SendFrames"  # client-streaming: edge → pipeline
RECV_METHOD = f"/{SERVICE}/RecvFrames"  # server-streaming: pipeline → edge


class _FrameService:
    """Generic-handler gRPC service bridging byte frames to queues."""

    def __init__(self, in_q: Optional[_queue.Queue], out_q: Optional[_queue.Queue]):
        self.in_q = in_q
        self.out_q = out_q
        self.stop = threading.Event()

    def handler(self):
        import grpc

        svc = self

        def send_frames(request_iterator, context):
            for payload in request_iterator:
                if svc.stop.is_set():
                    break
                if svc.in_q is not None:
                    svc.in_q.put(payload)
            return b""

        def recv_frames(_request, context):
            while not svc.stop.is_set():
                try:
                    payload = svc.out_q.get(timeout=0.2)
                except _queue.Empty:
                    continue
                if payload is None:
                    return
                yield payload

        ident = lambda b: b  # payloads are already serialized frames
        handlers = {
            "SendFrames": grpc.stream_unary_rpc_method_handler(
                send_frames, request_deserializer=ident, response_serializer=ident
            ),
            "RecvFrames": grpc.unary_stream_rpc_method_handler(
                recv_frames, request_deserializer=ident, response_serializer=ident
            ),
        }
        return grpc.method_handlers_generic_handler(SERVICE, handlers)


def _start_server(service: _FrameService, host: str, port: int):
    import grpc
    from concurrent import futures

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((service.handler(),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"grpc: cannot bind {host}:{port}")
    server.start()
    return server, bound


@element_register
class TensorSrcGrpc(SourceElement):
    """Ingest tensor frames from gRPC (server: remote pushes; client:
    pull a remote stream). Props: host, port, server, idl, out-caps."""

    ELEMENT_NAME = "tensor_src_grpc"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "server": Prop("bool"),
        "idl": Prop("enum", enum=("protobuf", "flatbuf")),
        "out_caps": Prop("caps"),
    }

    def start(self) -> None:
        self._idl = str(self.properties.get("idl", "protobuf"))
        self._host = str(self.properties.get("host", "127.0.0.1"))
        self._port = int(self.properties.get("port", 55115))
        self._is_server = str(self.properties.get("server", "true")).lower() in (
            "1", "true", "yes",
        )
        require("grpc", self.name)
        self._q: _queue.Queue = _queue.Queue(maxsize=64)
        _, self._decode = codec(self._idl, self.name)
        self._service = _FrameService(self._q, None)
        self._server = None
        self._chan = None
        self._client_thread = None
        if self._is_server:
            self._server, port = _start_server(self._service, self._host, self._port)
            if self._port == 0:
                self._port = port  # ephemeral bind
        else:
            import grpc

            self._chan = grpc.insecure_channel(f"{self._host}:{self._port}")
            recv = self._chan.unary_stream(
                RECV_METHOD,
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )

            def pull_loop():
                try:
                    for payload in recv(b""):
                        if self._service.stop.is_set():
                            break
                        self._q.put(payload)
                except Exception as e:  # noqa: BLE001 — remote closed
                    log.info("grpc src client stream ended: %s", e)
                self._q.put(None)  # EOS

            self._client_thread = threading.Thread(target=pull_loop, daemon=True)
            self._client_thread.start()

    @property
    def bound_port(self) -> int:
        return self._port

    def negotiate(self) -> Optional[Caps]:
        want = self.properties.get("out_caps") or self.properties.get("out-caps")
        if want:
            self._caps_sent = True
            return Caps(str(want))
        # frames are self-describing: hold negotiation until the first frame
        # arrives, then emit its concrete static caps (so a downstream
        # tensor_filter can negotiate fixed shapes)
        self._caps_sent = False
        return None

    def create(self) -> Optional[Buffer]:
        while not self._service.stop.is_set():
            try:
                payload = self._q.get(timeout=0.2)
            except _queue.Empty:
                # a stopping pipeline joins this thread before it stops the
                # element: leave at the next poll, as mqttsrc does
                if self.pipeline is not None and \
                        not self.pipeline._running.is_set():
                    return None
                continue
            if payload is None:
                return None  # EOS
            buf, cfg = self._decode(bytes(payload))
            if not self._caps_sent:
                from nnstreamer_tpu_torch.buffer import Event

                caps = (
                    Caps.from_config(cfg)
                    if cfg.info.is_fixed()
                    else Caps("other/tensors,format=flexible")
                )
                for sp in self.src_pads:
                    sp.push_event(Event("caps", {"caps": caps}))
                self._caps_sent = True
            return buf
        return None

    def stop(self) -> None:
        if getattr(self, "_service", None) is None:
            return  # start raised before the service existed
        self._service.stop.set()
        if self._server is not None:
            self._server.stop(grace=0.2)
            self._server = None
        if self._chan is not None:
            self._chan.close()
            self._chan = None


@element_register
class TensorSinkGrpc(Element):
    """Emit tensor frames over gRPC (server: remote pulls; client: push to
    a remote src). Props: host, port, server, idl."""

    ELEMENT_NAME = "tensor_sink_grpc"
    SINK_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "host": Prop("str"),
        "port": Prop("int"),
        "server": Prop("bool"),
        "idl": Prop("enum", enum=("protobuf", "flatbuf")),
    }

    def _setup_pads(self) -> None:
        self.add_sink_pad("sink")

    def start(self) -> None:
        self._idl = str(self.properties.get("idl", "protobuf"))
        self._host = str(self.properties.get("host", "127.0.0.1"))
        self._port = int(self.properties.get("port", 55116))
        self._is_server = str(self.properties.get("server", "true")).lower() in (
            "1", "true", "yes",
        )
        require("grpc", self.name)
        self._encode, _ = codec(self._idl, self.name)
        self._q: _queue.Queue = _queue.Queue(maxsize=64)
        self._service = _FrameService(None, self._q)
        self._server = None
        self._chan = None
        self._send_thread = None
        self._config = None
        if self._is_server:
            self._server, port = _start_server(self._service, self._host, self._port)
            if self._port == 0:
                self._port = port
        else:
            import grpc

            self._chan = grpc.insecure_channel(f"{self._host}:{self._port}")
            send = self._chan.stream_unary(
                SEND_METHOD,
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )

            def frame_iter():
                while True:
                    payload = self._q.get()
                    if payload is None:
                        return
                    yield payload

            def push_loop():
                try:
                    send(frame_iter())
                except Exception as e:  # noqa: BLE001
                    if self._service.stop.is_set():
                        log.info("grpc sink client stream closed at stop")
                    else:
                        log.warning("grpc sink client send failed: %s", e)

            self._send_thread = threading.Thread(target=push_loop, daemon=True)
            self._send_thread.start()

    @property
    def bound_port(self) -> int:
        return self._port

    def _on_sink_caps(self, pad: Pad, caps: Caps) -> None:
        try:
            self._config = caps.to_config()
        except Exception:  # noqa: BLE001 — non-tensor caps: self-describing
            self._config = None

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        payload = self._encode(buf, self._config)
        try:
            self._q.put(payload, timeout=5.0)
        except _queue.Full:
            return FlowReturn.DROPPED  # shed load, reference drop semantics
        return FlowReturn.OK

    def _on_sink_event(self, pad: Pad, event) -> None:
        if event.type == "eos":
            self._q.put(None)
        super()._on_sink_event(pad, event)

    def stop(self) -> None:
        if getattr(self, "_service", None) is None:
            return  # start raised before the service existed
        self._service.stop.set()
        self._q.put(None)
        if self._server is not None:
            self._server.stop(grace=0.2)
            self._server = None
        if self._chan is not None:
            self._chan.close()
            self._chan = None
