"""Wire protocol for edge/query transport.

Our own length-framed binary format (the reference delegates framing to the
external nnstreamer-edge lib):

    MAGIC 'NTEQ' | u8 msg_type | u32 meta_len | u16 n_payloads
    | u64 payload_len x n_payloads | meta (JSON, UTF-8) | payloads...

Tensors travel as the framework's flexible wire format (meta.py header +
raw data, tensor_typedef.h:310-326 contract) so the receiving end
reconstructs dtype/dims without negotiated caps. Metadata carries
client_id routing (GstMetaQuery parity, tensor_meta.h:30-40), timestamps,
and the caps handshake strings.

nntrace-x trace context (edge/tracex.py) rides as an OPTIONAL header:
when a frame carries one, the msg-type byte has :data:`TRACE_FLAG` set
and ``u16 hdr_len | header bytes`` follows the fixed header, before the
payload-length array. The header only ever appears after MSG_CAPABILITY
negotiation (the server advertises ``trace`` support; the client opts in
per request), so a peer that never negotiated it sees byte-identical
frames, and a NEWER peer's longer header is length-delimited — trailing
bytes are skipped, never fatal.
"""

from __future__ import annotations

import json
import socket
import struct
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer, materialize_tensors
from nnstreamer_tpu_torch.meta import unwrap_flexible, wrap_flexible
from nnstreamer_tpu_torch.types import TensorInfo

MAGIC = b"NTEQ"
_HEADER = struct.Struct("<4sBIH")  # magic, type, meta_len, n_payloads
_PLEN = struct.Struct("<Q")
_TLEN = struct.Struct("<H")  # trace-header length (TRACE_FLAG frames)

#: msg-type high bit: this frame carries a trace-context header
#: (edge/tracex.py) between the fixed header and the payload lengths.
#: Only set toward peers that negotiated the ``trace`` capability.
TRACE_FLAG = 0x80

MSG_HELLO = 0
MSG_CAPABILITY = 1
MSG_DATA = 2
MSG_RESULT = 3
MSG_BYE = 4
#: serving-tier admission reject (SERVER_BUSY): the server shed this
#: request instead of queueing it — meta carries ``reason`` plus the
#: request's ``_seq`` echo so the client pairs it with the right frame
#: and applies its own on-error policy (retry / drop / abort)
MSG_BUSY = 5


@dataclass
class Message:
    type: int
    meta: Dict[str, Any] = field(default_factory=dict)
    payloads: List[bytes] = field(default_factory=list)
    #: optional nntrace-x context (edge/tracex.TraceContext). None means
    #: the frame encodes exactly as it always has — zero added bytes.
    trace: Any = None


class ProtocolError(RuntimeError):
    pass


def encode_message(msg: Message) -> bytes:
    meta_b = json.dumps(msg.meta, separators=(",", ":")).encode("utf-8")
    mtype = msg.type
    trace_b = b""
    if msg.trace is not None:
        from nnstreamer_tpu_torch.edge import tracex

        trace_b = tracex.pack(msg.trace)
        mtype |= TRACE_FLAG
    parts = [_HEADER.pack(MAGIC, mtype, len(meta_b), len(msg.payloads))]
    if trace_b:
        parts.append(_TLEN.pack(len(trace_b)))
        parts.append(trace_b)
    for p in msg.payloads:
        parts.append(_PLEN.pack(len(p)))
    parts.append(meta_b)
    parts.extend(msg.payloads)
    return b"".join(parts)


def send_message(sock: socket.socket, msg: Message, tag: str = "") -> None:
    """Send one framed message. ``tag`` scopes the wire fault points
    (testing/faults.py): ``slow-link`` delays the send, ``partial-write``
    ships half the frame then kills the socket, ``socket-drop`` kills it
    before any byte — each raising the same ConnectionError a real link
    failure would. ``byzantine-reply`` corrupts the first payload's
    flexible-tensor header (the frame stays wire-valid; the PEER must
    detect and drop it), ``link-flap`` is socket-drop on a cadence.

    nnsan-c chokepoint: a sendall can block for the peer's full TCP
    window — doing that under a framework lock is NNST611."""
    from nnstreamer_tpu_torch.analysis import lockwitness
    from nnstreamer_tpu_torch.testing import faults

    lockwitness.blocking_call("socket.send", tag or "untagged")

    f = faults.check("byzantine-reply", tag)
    if f is not None and msg.payloads:
        # corrupt a COPY: the caller's Message (and any retry of it)
        # stays intact — only these wire bytes lie
        msg = Message(type=msg.type, meta=msg.meta,
                      payloads=[faults.corrupt_flexible_payload(
                          msg.payloads[0])] + list(msg.payloads[1:]),
                      trace=msg.trace)
    data = encode_message(msg)
    f = faults.check("slow-link", tag)
    if f is not None:
        time.sleep(f.delay_s)
    f = faults.check("partial-write", tag)
    if f is not None:
        try:
            sock.sendall(data[: max(1, len(data) // 2)])
        finally:
            hard_close(sock)
        raise ConnectionError(f"injected partial-write ({tag or 'untagged'})")
    f = faults.check("socket-drop", tag)
    if f is not None:
        hard_close(sock)
        raise ConnectionError(f"injected socket-drop ({tag or 'untagged'})")
    f = faults.check("link-flap", tag)
    if f is not None:
        hard_close(sock)
        raise ConnectionError(f"injected link-flap ({tag or 'untagged'})")
    sock.sendall(data)


def hard_close(sock: socket.socket) -> None:
    """shutdown() before close(): a plain close() while another thread is
    blocked in recv() on the same fd does NOT send FIN (the in-flight
    syscall pins the open file description), so peers would never learn
    the connection died. shutdown(SHUT_RDWR) sends FIN immediately and
    wakes any blocked recv with EOF. The one copy handle.py and the
    injected drops above share."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def decode_message(data: bytes) -> Message:
    """Parse one complete encoded message from a bytes blob (the MQTT
    payload path, where framing is already done by the outer protocol).
    Any malformed/truncated input raises ProtocolError — never struct or
    json errors — so callers can treat it as 'not ours' and skip."""
    if len(data) < _HEADER.size:
        raise ProtocolError("short message")
    magic, mtype, meta_len, n_payloads = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    off = _HEADER.size
    trace = None
    if mtype & TRACE_FLAG:
        mtype &= ~TRACE_FLAG
        if off + _TLEN.size > len(data):
            raise ProtocolError("truncated trace header length")
        (tlen,) = _TLEN.unpack_from(data, off)
        off += _TLEN.size
        if off + tlen > len(data):
            raise ProtocolError("truncated trace header")
        from nnstreamer_tpu_torch.edge import tracex

        # a malformed header never kills the frame — the payload framing
        # is independent; parse() returns None on garbage
        trace = tracex.parse(data[off : off + tlen])
        off += tlen
    if off + n_payloads * _PLEN.size + meta_len > len(data):
        raise ProtocolError("truncated header region")
    lens = []
    for _ in range(n_payloads):
        lens.append(_PLEN.unpack_from(data, off)[0])
        off += _PLEN.size
    try:
        meta = json.loads(data[off : off + meta_len]) if meta_len else {}
    except ValueError as e:
        raise ProtocolError(f"bad meta json: {e}")
    off += meta_len
    payloads = []
    for ln in lens:
        if off + ln > len(data):
            raise ProtocolError("truncated payload")
        payloads.append(data[off : off + ln])
        off += ln
    return Message(type=mtype, meta=meta, payloads=payloads, trace=trace)


def recv_message(sock: socket.socket) -> Message:
    from nnstreamer_tpu_torch.analysis import lockwitness

    lockwitness.blocking_call("socket.recv")
    head = _recv_exact(sock, _HEADER.size)
    magic, mtype, meta_len, n_payloads = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    trace = None
    if mtype & TRACE_FLAG:
        mtype &= ~TRACE_FLAG
        (tlen,) = _TLEN.unpack(_recv_exact(sock, _TLEN.size))
        raw = _recv_exact(sock, tlen) if tlen else b""
        from nnstreamer_tpu_torch.edge import tracex

        trace = tracex.parse(raw)  # None on garbage, frame survives
    lens = [
        _PLEN.unpack(_recv_exact(sock, _PLEN.size))[0] for _ in range(n_payloads)
    ]
    meta = json.loads(_recv_exact(sock, meta_len)) if meta_len else {}
    payloads = [_recv_exact(sock, ln) for ln in lens]
    return Message(type=mtype, meta=meta, payloads=payloads, trace=trace)


def corrupt_payloads(msg: Message) -> int:
    """Byzantine-frame detector: payloads that CLAIM the flexible-tensor
    wrap (TPUS magic, meta.py header) but fail to unwrap. A corrupted
    reply is wire-valid — lengths and framing intact — so only the
    payload's own self-describing header can convict it. Receivers drop
    the FRAME (recorded on the fault ledger), never the connection: one
    bad frame is data corruption, a dead socket is a different failure."""
    import struct as _struct

    from nnstreamer_tpu_torch.meta import META_MAGIC

    magic = _struct.pack("<I", META_MAGIC)
    n = 0
    for p in msg.payloads:
        if len(p) >= 4 and bytes(p[:4]) == magic:
            try:
                unwrap_flexible(p)
            except Exception:  # noqa: BLE001 — any parse failure convicts
                n += 1
    return n


# -- Buffer <-> Message ----------------------------------------------------
def buffer_to_message(buf: Buffer, mtype: int, **extra_meta) -> Message:
    """Pack a frame for the wire; tensors become flexible-wrapped blobs
    (nns_edge_data_create/add parity, tensor_query_client.c:694-709).
    Torch tensors (on the card or the host) come to the host through
    :func:`materialize_tensors`, one batched copy for the frame, so a
    tensor encodes to the bytes of its numpy twin."""
    payloads = []
    for t in materialize_tensors(buf.tensors):
        if isinstance(t, (bytes, bytearray, memoryview)):
            payloads.append(bytes(t))  # already self-describing or raw media
        else:
            a = np.ascontiguousarray(np.asarray(t))
            payloads.append(wrap_flexible(a, TensorInfo.from_np_shape(a.shape, a.dtype)))
    meta = {
        "pts": buf.pts,
        "duration": buf.duration,
        **{k: v for k, v in buf.meta.items() if _json_safe(v)},
        **extra_meta,
    }
    return Message(type=mtype, meta=meta, payloads=payloads)


def message_to_buffer(msg: Message, unwrap: bool = True) -> Buffer:
    tensors: List[Any] = []
    for p in msg.payloads:
        if unwrap:
            try:
                arr, _info = unwrap_flexible(p)
                tensors.append(arr)
                continue
            except Exception:
                pass
        tensors.append(p)
    meta = {
        k: v
        for k, v in msg.meta.items()
        if k not in ("pts", "duration")
    }
    return Buffer(
        tensors=tensors,
        pts=int(msg.meta.get("pts", -1)),
        duration=int(msg.meta.get("duration", -1)),
        meta=meta,
    )


def _json_safe(v) -> bool:
    return isinstance(v, (str, int, float, bool, type(None), list, dict))
