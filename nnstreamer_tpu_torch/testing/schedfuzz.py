"""Schedule fuzzer: seeded, deterministic jitter at lock-witness points
(counterpart of the JAX package's ``testing/schedfuzz.py``).

Race windows in the serving stack are nanoseconds wide on an idle box:
the scheduler ingests, assembles and acks faster than the OS ever
preempts, so a latent lock-order inversion or handoff mutation can ride
green for months. This module widens those windows *deterministically*:
every lock-witness point (acquire/release, handoff) calls :func:`jitter`,
and when a seed is armed — ``NNSTPU_SCHEDFUZZ=<N>`` or :func:`configure` —
a pure function of (seed, thread name, point, tag, per-thread sequence
number) decides whether and how long to stall. Two runs with one seed
produce the SAME stall sequence per thread, so a soak that fails replays;
runs with different seeds explore different interleavings. Unarmed cost is
one module-attribute read.

The stall primitive is ``time.sleep`` as it was when this module was
imported: the lock witness patches ``time.sleep`` to detect sleeping under
a framework lock (NNST611), and the fuzzer's own stalls must neither trip
that check nor recurse through it.

``python -m nnstreamer_tpu_torch.testing.schedfuzz --soak`` runs the
deterministic in-process serving soak: a scheduler fed from concurrent
producer threads, an edge server/client exchange and a tracer, all under
this package's sanitizer, printing the sorted NNST61x violation counts and
the lock-order edge list (no timings — two seeded runs print identical
bytes). The JAX package's soak also accounts replica dispatches; this
package has no replica pool yet (ROADMAP.md queue 1), so its soak leaves
that part out.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Optional

#: seed env var — any int arms the fuzzer for the whole process
SEED_ENV = "NNSTPU_SCHEDFUZZ"
#: max stall per jitter point, microseconds (env override)
AMP_ENV = "NNSTPU_SCHEDFUZZ_US"

#: captured before this package's lock witness patches time.sleep
_sleep = time.sleep

_seed: Optional[int] = None
_amp_us: int = 200
_tls = threading.local()


def _env_seed() -> Optional[int]:
    raw = os.environ.get(SEED_ENV, "").strip()
    if not raw:
        return None
    try:
        return int(raw, 0)
    except ValueError:
        return zlib.crc32(raw.encode())  # named seeds are fine too


_seed = _env_seed()
try:
    _amp_us = max(1, int(os.environ.get(AMP_ENV, "200")))
except ValueError:
    _amp_us = 200


def configure(seed: Optional[int], amp_us: Optional[int] = None) -> None:
    """Arm (or disarm with ``None``) the fuzzer from a test."""
    global _seed, _amp_us
    _seed = seed
    if amp_us is not None:
        _amp_us = max(1, int(amp_us))


def enabled() -> bool:
    return _seed is not None


def jitter(point: str, tag: str = "") -> None:
    """Witness-point hook: deterministically stall this thread.

    The decision and duration are a pure function of (seed, thread name,
    point, tag, per-thread call count): roughly one call in four stalls,
    for up to ``_amp_us`` microseconds. Unarmed cost is one module-
    attribute read.
    """
    if _seed is None:
        return
    n = getattr(_tls, "n", 0)
    _tls.n = n + 1
    h = zlib.crc32(
        f"{_seed}:{threading.current_thread().name}:{point}:{tag}:{n}"
        .encode())
    if h & 3:
        return  # 3 of 4 points pass untouched (stalls stay affordable)
    _sleep(((h >> 8) % _amp_us) / 1e6)


def _soak(seed: int) -> str:
    """The in-process serving soak (``--soak``): concurrent ingest /
    assemble / ack against one scheduler, an edge server↔client frame
    exchange, and tracer recording — the lock-heavy core of the serving
    stack, no model needed. Returns the deterministic summary text."""
    import queue as _q

    import numpy as np

    from nnstreamer_tpu_torch.analysis import lockwitness, sanitizer
    from nnstreamer_tpu_torch.edge import protocol as proto
    from nnstreamer_tpu_torch.edge.handle import EdgeClient, EdgeServer
    from nnstreamer_tpu_torch.meta import wrap_flexible
    from nnstreamer_tpu_torch.serving.scheduler import ServingScheduler
    from nnstreamer_tpu_torch.trace import Tracer
    from nnstreamer_tpu_torch.types import TensorInfo

    sanitizer.enable(True)
    sanitizer.clear()
    configure(seed)

    class _FakeServer:
        def __init__(self):
            self.recv_queue: "_q.Queue" = _q.Queue()
            self.sent = 0

        def pop(self, timeout=0.2):
            try:
                return self.recv_queue.get(timeout=timeout)
            except _q.Empty:
                return None

        def send_to(self, cid, msg, timeout=None):
            self.sent += 1
            return True

    srv = _FakeServer()
    sched = ServingScheduler(srv, batch=4, stats_key="soak",
                             queue_depth=64)
    tracer = Tracer()
    stop = threading.Event()

    def produce(k: int) -> None:
        for i in range(200):
            arr = np.full((1, 4), float(i), np.float32)
            msg = proto.Message(
                proto.MSG_DATA, {"client_id": k, "seq": i},
                payloads=[wrap_flexible(
                    arr, TensorInfo.from_np_shape(arr.shape, arr.dtype))])
            srv.recv_queue.put((k, msg))
            jitter("soak.produce", str(k))

    def consume() -> None:
        while not stop.is_set():
            buf = sched.next_batch(timeout=0.05)
            if buf is None:
                continue
            tracer.record_chain("soak", time.perf_counter() - 1e-4,
                                time.perf_counter())
            sched.note_reply_batch()
            jitter("soak.consume")

    producers = [threading.Thread(target=produce, args=(k,),
                                  name=f"soak-prod-{k}", daemon=True)
                 for k in range(3)]
    consumer = threading.Thread(target=consume, name="soak-consume",
                                daemon=True)
    for t in producers:
        t.start()
    consumer.start()
    for t in producers:
        t.join(timeout=60)
    deadline = time.monotonic() + 30
    while sched.health_snapshot()["depth"] and time.monotonic() < deadline:
        _sleep(0.01)
    stop.set()
    consumer.join(timeout=10)
    sched.shutdown()

    # one real edge round trip so the send-lock / registry-lock pairs
    # appear in the witness graph
    es = EdgeServer(port=0, caps="other/tensors")
    es.start()
    ec = EdgeClient("localhost", es.port, timeout=10.0)
    ec.connect()
    ec.send(proto.Message(proto.MSG_DATA, {"seq": 0},
                          payloads=[b"\x00" * 16]))
    got = es.pop(timeout=10.0)
    if got is not None:
        es.send_to(got[0], proto.Message(proto.MSG_RESULT, {"seq": 0}))
        ec.recv(timeout=10.0)
    ec.close()
    es.close()

    counts = {c: 0 for c in ("NNST610", "NNST611", "NNST612", "NNST613")}
    for v in sanitizer.violations():
        if v.code in counts:
            counts[v.code] += 1
    lines = [f"{code}={n}" for code, n in sorted(counts.items())]
    edges = sorted({f"{a}->{b}" for a, bs in lockwitness.order_edges().items()
                    for b in bs})
    lines.append("order-edges: " + (", ".join(edges) if edges else "(none)"))
    lines.append(f"locks-witnessed={len(lockwitness.locks_report())}")
    configure(None)
    sanitizer.reset()
    return "\n".join(lines)


def main(argv=None) -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if "--soak" in args:
        seed = _seed if _seed is not None else 1
        print(_soak(seed))
        return 0
    print("usage: python -m nnstreamer_tpu_torch.testing.schedfuzz --soak",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
