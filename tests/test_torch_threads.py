"""The thread-topology lint (``analysis/threads.py``, NNST620/621/622)
and the replica pool under the lock witness, through both packages, on
the CPU.

Every ``TestThreadTopologyPass`` case of the reference's
tests/test_threads.py runs through both packages' analyzers on the lines
of ``examples/launch_lines_threads.txt``; each must give the case's codes
and message fragments. Then a pooled serving route (``replicas=4``) plays
in each package with its sanitizer on, the other package's off: the
replica inboxes' handoff (``filter.replica_inbox``) is witnessed, the
NNST601 busy gate keys on each replica (four workers invoking one
framework instance concurrently are legal), and no NNST60x/61x violation
accrues. The port runs on ``NNSTPU_TORCH_DEVICES=cpu*8``, the JAX package
on the conftest's 8 virtual devices. The lock-witness cases of
tests/test_threads.py are tests/test_torch_sanitizer.py's.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import nnstreamer_tpu.analysis  # noqa: E402
import nnstreamer_tpu.analysis.lockwitness  # noqa: E402
import nnstreamer_tpu.analysis.sanitizer  # noqa: E402
import nnstreamer_tpu.analysis.threads  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.pipeline.element  # noqa: E402
import nnstreamer_tpu_torch.analysis  # noqa: E402
import nnstreamer_tpu_torch.analysis.lockwitness  # noqa: E402
import nnstreamer_tpu_torch.analysis.sanitizer  # noqa: E402
import nnstreamer_tpu_torch.analysis.threads  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.pipeline.element  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS4 = "other/tensors,num-tensors=1,dimensions=4,types=float32,framerate=0/1"


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*8")


class Pkg:
    def __init__(self, name):
        mod = sys.modules
        self.port = name == "nnstreamer_tpu_torch"
        self.analyze_launch = mod[f"{name}.analysis"].analyze_launch
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.threads = mod[f"{name}.analysis.threads"]
        self.sanitizer = mod[f"{name}.analysis.sanitizer"]
        self.lockwitness = mod[f"{name}.analysis.lockwitness"]
        self.cpu = " accelerator=true:cpu" if self.port else ""

    def codes_for(self, line):
        return {d.code: d for d in self.analyze_launch(line)
                if d.code.startswith("NNST62")}


JAX = Pkg("nnstreamer_tpu")
PORT = Pkg("nnstreamer_tpu_torch")


@pytest.fixture(params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    return request.param


def _fixture_line(marker: str) -> str:
    with open(os.path.join(ROOT, "examples", "launch_lines_threads.txt"),
              encoding="utf-8") as f:
        seen = False
        for line in f:
            if line.startswith(marker):
                seen = True
            elif seen and line.startswith("tensor_query"):
                return line.strip()
    raise AssertionError(f"no fixture line after marker {marker!r}")


class TestThreadTopologyPass:
    def test_nnst620_topology_summary(self, pkg):
        d = pkg.codes_for(_fixture_line("# CLEAN"))
        assert set(d) == {"NNST620"}
        msg = d["NNST620"].message
        assert "streaming thread" in msg
        assert "ONE scheduler lock" in msg
        assert "bounded (serve-queue-depth=64)" in msg
        assert "UNBOUNDED" not in msg

    def test_nnst622_unbounded_reply_send(self, pkg):
        d = pkg.codes_for(_fixture_line("# HAZARD (NNST622)"))
        assert "NNST622" in d and "NNST621" not in d
        assert "timeout=" in d["NNST622"].message
        assert d["NNST622"].hint and "timeout=" in d["NNST622"].hint

    def test_nnst621_bounded_capacity_wait_cycle(self, pkg):
        d = pkg.codes_for(_fixture_line("# HAZARD (NNST621"))
        assert "NNST621" in d and "NNST622" in d
        msg = d["NNST621"].message
        assert "replicas -> ack-drain -> pending-drain cycle" in msg
        assert "NNST620" in d
        assert "UNBOUNDED" in d["NNST620"].message

    def test_timeout_bound_clears_both_warnings(self, pkg):
        parts = _fixture_line("# HAZARD (NNST621").rsplit("id=thr2", 1)
        line = parts[0] + "id=thr2 timeout=5" + parts[1]
        codes = {d.code for d in pkg.analyze_launch(line)}
        assert "NNST621" not in codes and "NNST622" not in codes

    def test_non_serving_pipelines_emit_nothing(self, pkg):
        line = (f"appsrc caps={CAPS4} ! tensor_filter framework=jax "
                f"model=add custom=k:1,aot:0{pkg.cpu} ! tensor_sink")
        assert not [d for d in pkg.analyze_launch(line)
                    if d.code.startswith("NNST62")]

    def test_describe_topology_replicas_and_ctl(self, pkg):
        p = pkg.parse_launch(
            "tensor_query_serversrc name=ssrc id=dt port=0 serve=1 "
            "serve-batch=4 serve-queue-depth=8 replicas=2 ctl=1 "
            f"ctl-interval-ms=50 caps={CAPS4} ! tensor_filter framework=jax "
            f"model=add custom=k:1,aot:0{pkg.cpu} "
            "! tensor_query_serversink id=dt timeout=3")
        topo = pkg.threads.describe_topology(p, p["ssrc"])
        assert "2 replica dispatch workers" in topo
        assert "nnctl tick thread (50" in topo
        assert "bounded (serve-queue-depth=8)" in topo
        assert "UNBOUNDED" not in topo

    def test_analyze_threads_matches_the_pass(self, pkg):
        """The standalone entry gives the pass's codes on each fixture
        line, in both packages alike."""
        for marker in ("# CLEAN", "# HAZARD (NNST622)", "# HAZARD (NNST621"):
            line = _fixture_line(marker)
            got = sorted(c for c, _, _ in pkg.threads.analyze_threads(
                pkg.parse_launch(line)))
            assert got == sorted(pkg.codes_for(line)), marker


@pytest.fixture
def witnessed(pkg):
    """``pkg``'s sanitizer on with a clean witness; both packages' off
    and cleared afterwards."""
    for p in (JAX, PORT):
        p.sanitizer.enable(False)
        p.sanitizer.clear()
        p.lockwitness.reset()
    pkg.sanitizer.enable(True)
    yield pkg
    for p in (JAX, PORT):
        p.sanitizer.enable(False)
        p.sanitizer.clear()
        p.lockwitness.reset()
        p.sanitizer.reset()


def test_pooled_route_under_the_witness(witnessed):
    """Four replica workers invoke one framework instance at once: the
    busy gate keys on each replica, so no NNST601; the inbox handoff is
    witnessed and clean; every reply is right."""
    pkg = witnessed
    handle = sys.modules[("nnstreamer_tpu_torch" if pkg.port
                          else "nnstreamer_tpu") + ".edge.handle"]
    proto = sys.modules[("nnstreamer_tpu_torch" if pkg.port
                         else "nnstreamer_tpu") + ".edge.protocol"]
    p = pkg.parse_launch(
        "tensor_query_serversrc name=ssrc id=wp port=0 serve=1 "
        f"serve-batch=1 serve-queue-depth=64 replicas=4 caps={CAPS4} "
        f"! tensor_filter name=f framework=jax model=add "
        f"custom=k:1,aot:0{pkg.cpu} ! tensor_query_serversink id=wp "
        "timeout=5")
    p.play()
    try:
        assert p["f"]._replica_state == {"replicas": 4}
        cli = handle.EdgeClient("localhost", p["ssrc"].port, timeout=10.0)
        cli.connect()
        got = []
        try:
            for i in range(16):
                cli.send(proto.buffer_to_message(
                    pkg.Buffer(tensors=[np.full(4, float(i), np.float32)]),
                    proto.MSG_DATA, _seq=i + 1))
            for _ in range(16):
                msg = cli.recv(timeout=10.0)
                assert msg is not None
                got.append(float(np.asarray(
                    proto.message_to_buffer(msg).tensors[0]).reshape(-1)[0]))
        finally:
            cli.close()
        assert sorted(got) == [float(i) + 1 for i in range(16)]
    finally:
        p.stop()
    codes = [v.code for v in pkg.sanitizer.violations()]
    assert not [c for c in codes if c.startswith(("NNST60", "NNST61"))], \
        codes
