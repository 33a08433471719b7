"""The replica pool (``tensor_query_serversrc serve=1 replicas=N|auto``)
and sharded serve-batch placement through both packages, on the CPU.

The JAX package runs on the 8 virtual CPU devices of tests/conftest.py;
the port on ``NNSTPU_TORCH_DEVICES=cpu*8`` (set for every test here),
its served filters with ``accelerator=true:cpu``. Every case of the
reference's tests/test_pool.py that passes there runs through both
packages — the NNST96x verdicts, the scheduler's least-loaded dispatch,
the plant's replica division, the loopback replica parity, faults and
drain, sharded placement and the pad-row byte parity — each package held
to the reference's asserts with its own elements, scheduler, fault
harness and client. The four cases the reference fails only through its
cost model (NNST962, ``replicas=auto`` and the two memory-plan cases)
are held on the port alone to what they assert, with distinct device
names (``cuda:0,...``, never run) where the reference's per-device
semantics apply. The ``doctor`` case renders each package's pooled
report with its own ``tools/doctor.py``.
Every client thread and pipeline wait is bounded; ports are ``port=0``.
"""

import queue
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_shared import (  # noqa: E402,F401 (fixtures)
    equal_name_counters,
    one_torch_thread,
)
jax = pytest.importorskip("jax")

import nnstreamer_tpu.analysis  # noqa: E402
import nnstreamer_tpu.analysis.plant  # noqa: E402
import nnstreamer_tpu.analysis.residency  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.edge.protocol  # noqa: E402
import nnstreamer_tpu.filters.base  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.pipeline.element  # noqa: E402
import nnstreamer_tpu.serving.controller  # noqa: E402
import nnstreamer_tpu.serving.scheduler  # noqa: E402
import nnstreamer_tpu.testing.faults  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu.types  # noqa: E402
import nnstreamer_tpu_torch.analysis  # noqa: E402
import nnstreamer_tpu_torch.analysis.plant  # noqa: E402
import nnstreamer_tpu_torch.analysis.residency  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.edge.protocol  # noqa: E402
import nnstreamer_tpu_torch.filters.base  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.pipeline.element  # noqa: E402
import nnstreamer_tpu_torch.serving.controller  # noqa: E402
import nnstreamer_tpu_torch.serving.scheduler  # noqa: E402
import nnstreamer_tpu_torch.testing.faults  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402
import nnstreamer_tpu_torch.types  # noqa: E402
from nnstreamer_tpu_torch.analysis import memplan  # noqa: E402

PKGS = ("nnstreamer_tpu", "nnstreamer_tpu_torch")
CAPS4 = "other/tensors,num-tensors=1,dimensions=4,types=float32,framerate=30/1"
DISTINCT = ",".join(f"cuda:{i}" for i in range(8))


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    """The port's counterpart of the conftest's 8 virtual devices."""
    monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cpu*8")


class Pkg:
    def __init__(self, name):
        mod = sys.modules
        self.port = name == "nnstreamer_tpu_torch"
        self.analyze_launch = mod[f"{name}.analysis"].analyze_launch
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.trace = mod[f"{name}.trace"]
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.Event = mod[f"{name}.pipeline.element"].Event
        self.proto = mod[f"{name}.edge.protocol"]
        self.faults = mod[f"{name}.testing.faults"]
        self.plant = mod[f"{name}.analysis.plant"]
        self.residency = mod[f"{name}.analysis.residency"]
        self.Scheduler = mod[f"{name}.serving.scheduler"].ServingScheduler
        self.Feed = mod[f"{name}.serving.controller"].SchedulerFeed
        self.filt = ("tensor_filter framework=jax model=add custom=k:1,aot:0"
                     + (" accelerator=true:cpu" if self.port else ""))

    def pool_line(self, sid, extra="replicas=4 ", fextra="", b=8,
                  caps=CAPS4):
        return (f"tensor_query_serversrc name=ssrc id={sid} port=0 serve=1 "
                f"serve-batch={b} serve-queue-depth=64 {extra}caps={caps} "
                f"! {self.filt} name=f {fextra}"
                f"! tensor_query_serversink id={sid} timeout=5")

    def codes(self, diags):
        return [d.code for d in diags]

    def by_code(self, diags, code):
        hits = [d for d in diags if d.code == code]
        assert hits, f"{code} not emitted; got {self.codes(diags)}"
        return hits[0]

    def pool_diags(self, extra="replicas=4 ", fextra="", sid="pl", b=8):
        return self.analyze_launch(self.pool_line(sid, extra, fextra, b))

    def server(self, sid, extra="replicas=4 ", fextra="", b=4):
        p = self.parse_launch(self.pool_line(sid, extra, fextra, b))
        tracer = self.trace.attach(p)
        p.play()
        return p, tracer

    def drive(self, port, values, timeout=30):
        cl = self.parse_launch(
            f"appsrc name=src caps={CAPS4} "
            f"! tensor_query_client name=cli port={port} on-error=drop "
            f"! tensor_sink name=out")
        cl.play()
        for i, v in enumerate(values):
            cl["src"].push_buffer(self.Buffer(
                tensors=[np.full(4, float(v), np.float32)], pts=i))
        cl["src"].end_of_stream()
        ok = cl.bus.wait_eos(timeout)
        outs = [np.asarray(b[0]) for b in cl["out"].collected]
        err = cl.bus.error
        stats = dict(cl["cli"].error_stats)
        cl.stop()
        return ok, err, outs, stats


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


PORT = Pkg("nnstreamer_tpu_torch")


# --- NNST96x verdicts -------------------------------------------------------

class TestPoolVerdicts:
    def test_nnst960_eligible_carries_count_and_filter(self, pkg):
        d = pkg.by_code(pkg.pool_diags(), "NNST960")
        assert "replicas=4" in d.message and "4 per-device" in d.message
        assert "'f'" in d.message
        assert d.severity == "info"

    @pytest.mark.parametrize("fextra,frag", [
        ("shard=dp mesh=4x1 ", "shard interaction"),
        ("loop-window=8 ", "loop interaction"),
        ("shared-tensor-filter-key=pk ", "shared backend key"),
        ("batch-size=2 ", "batch-size"),
    ])
    def test_nnst961_gates(self, pkg, fextra, frag):
        d = pkg.by_code(pkg.pool_diags(fextra=fextra), "NNST961")
        assert frag in d.message

    def test_nnst961_insufficient_devices(self, pkg):
        d = pkg.by_code(pkg.pool_diags(extra="replicas=9 "), "NNST961")
        assert "device" in d.message

    def test_nnst961_requires_serving(self, pkg):
        diags = pkg.analyze_launch(
            f"tensor_query_serversrc id=ns port=0 replicas=4 caps={CAPS4} "
            f"! {pkg.filt} ! tensor_query_serversink id=ns")
        assert "serve=1" in pkg.by_code(diags, "NNST961").message

    def test_replicas_off_zero_nnst96x(self, pkg):
        diags = pkg.pool_diags(extra="")
        assert not [c for c in pkg.codes(diags) if c.startswith("NNST96")]

    def test_nnst962_overbudget_names_replicas(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "4M")
        line = PORT.pool_line("ob", caps=CAPS4.replace(
            "dimensions=4,", "dimensions=1024:256,"))
        d = PORT.by_code(PORT.analyze_launch(line), "NNST962")
        assert "per-device budget" in d.message
        assert "replicas=" in (d.hint or "")

    def test_auto_resolves_largest_feasible(self, monkeypatch):
        """replicas=auto takes the largest count every device of the pool
        can hold: devices 4..7 are tiny, so auto resolves 4, not 8."""
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        monkeypatch.delenv("NNSTPU_HBM_BYTES", raising=False)
        limits = [16 * 2**30] * 4 + [2**20] * 4
        monkeypatch.setattr(memplan, "device_memory_budget",
                            lambda i=0: (limits[i] if i < 8 else 16 * 2**30,
                                         "cuda"))
        line = PORT.pool_line("auto", extra="replicas=auto ",
                              caps=CAPS4.replace("dimensions=4,",
                                                 "dimensions=1024:64,"))
        d = PORT.by_code(PORT.analyze_launch(line), "NNST960")
        assert "4 per-device replicas" in d.message


# --- memory plan: replicas --------------------------------------------------

class TestReplicaMemplan:
    def test_plan_rows_carry_replicas_and_aggregate(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        plan = memplan.plan_memory(PORT.parse_launch(PORT.pool_line("mp")))
        row = next(r for r in plan["rows"] if r["element"] == "f")
        assert row["replicas"] == 4 and row["devices"] == 4
        assert plan["mesh_devices"] == 4
        assert plan["aggregate_bytes"] > plan["total_bytes"]

    def test_per_device_budget_is_min_over_pool(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        monkeypatch.delenv("NNSTPU_HBM_BYTES", raising=False)
        limits = [16 * 2**30] * 3 + [2**20] + [16 * 2**30] * 4
        monkeypatch.setattr(memplan, "device_memory_budget",
                            lambda i=0: (limits[i] if i < 8 else 16 * 2**30,
                                         "cuda"))
        big = CAPS4.replace("dimensions=4,", "dimensions=1024:64,")
        d = PORT.by_code(PORT.analyze_launch(
            PORT.pool_line("hb", caps=big)), "NNST962")
        assert "replicas=" in (d.hint or "")
        limits[3] = 16 * 2**30  # a homogeneous pool holds the same ask
        assert "NNST962" not in PORT.codes(PORT.analyze_launch(
            PORT.pool_line("hb2", caps=big)))

    def test_replicas_off_plan_has_no_replica_keys(self, pkg):
        if not pkg.port:
            from nnstreamer_tpu.analysis.memplan import plan_memory
        else:
            plan_memory = memplan.plan_memory
        plan = plan_memory(pkg.parse_launch(pkg.pool_line("off", extra="")))
        assert all("replicas" not in r for r in plan["rows"])
        assert "mesh_devices" not in plan

    def test_repeated_device_holds_every_replica(self, monkeypatch):
        """replicas=4 over one repeated device: that device's row holds
        the params and the serving batch four times, where four distinct
        devices hold one copy each."""
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", DISTINCT)
        line = PORT.pool_line("rep").replace(
            "model=add custom=k:1,aot:0",
            "model=matmul custom=dim:64,aot:0").replace(
            "dimensions=4,", "dimensions=64,")
        distinct = memplan.plan_memory(PORT.parse_launch(line))
        monkeypatch.setenv("NNSTPU_TORCH_DEVICES", "cuda:0*4")
        one = memplan.plan_memory(PORT.parse_launch(line))
        row = next(r for r in one["rows"] if r["element"] == "f")
        per = row["total_bytes"] + 64 * 64 * 2
        assert set(distinct["per_device_bytes"]) == {
            f"cuda:{i}" for i in range(4)}
        assert one["per_device_bytes"] == {"cuda:0": one["total_bytes"]}
        assert one["total_bytes"] == distinct["total_bytes"] + 3 * per


# --- the plant model: replica division --------------------------------------

class TestPlantReplicas:
    def test_device_leg_divides_by_replicas(self, pkg):
        obs = {"arrival_rps": 0.0, "device_ms_per_launch": 40.0}
        p1 = pkg.plant.predict_latency({"serve_batch": 8,
                                        "queue_depth": 32}, obs)
        p4 = pkg.plant.predict_latency({"serve_batch": 8, "queue_depth": 32,
                                        "replicas": 4}, obs)
        assert p1["cycle_ms"] == pytest.approx(53.6)
        assert p4["cycle_ms"] == pytest.approx(23.6)
        assert p4["capacity_rps"] > 2 * p1["capacity_rps"]

    def test_feed_carries_replicas_into_predictions(self, pkg):
        class _Srv:
            def __init__(self):
                self.recv_queue = queue.Queue()

            def pop(self, timeout=0.0):
                return None

            def send_to(self, cid, msg, timeout=None):
                return True

        sched = pkg.Scheduler(_Srv(), batch=8)
        sched.configure_pool(replicas=3)
        assert pkg.Feed(sched, clock=lambda: 1.0).sample()["replicas"] == 3
        assert pkg.Feed(pkg.Scheduler(_Srv(), batch=8),
                        clock=lambda: 1.0).sample()["replicas"] == 1


# --- the scheduler: least-loaded dispatch and acks --------------------------

class FakeServer:
    def __init__(self, proto, buffer_cls):
        self.recv_queue = queue.Queue()
        self.sent = []
        self.proto, self.Buffer = proto, buffer_cls

    def push(self, cid, value=1.0, seq=None):
        meta = {"client_id": cid}
        if seq is not None:
            meta["_seq"] = seq
        msg = self.proto.buffer_to_message(
            self.Buffer(tensors=[np.full(4, value, np.float32)], pts=0),
            self.proto.MSG_DATA, **meta)
        self.recv_queue.put((cid, msg))

    def pop(self, timeout=0.0):
        try:
            return self.recv_queue.get(timeout=timeout or 0.001)
        except queue.Empty:
            return None

    def send_to(self, cid, msg, timeout=None):
        self.sent.append((cid, msg))
        return True


class TestSchedulerPool:
    def test_least_loaded_round_robin_then_acked_replica(self, pkg):
        srv = FakeServer(pkg.proto, pkg.Buffer)
        s = pkg.Scheduler(srv, batch=1)
        s.configure_pool(replicas=4)
        picks = []
        for i in range(4):
            srv.push(cid=1, value=float(i))
            picks.append(s.next_batch(timeout=0.5).meta["serve_replica"])
        assert sorted(picks) == [0, 1, 2, 3]
        s.note_reply_batch(None, replica=2)
        srv.push(cid=1, value=9.0)
        buf = s.next_batch(timeout=0.5)
        assert buf.meta["serve_replica"] == 2
        assert buf.meta["serve_server"] == s.stats_key

    def test_shed_batch_sends_busy_with_reason(self, pkg):
        srv = FakeServer(pkg.proto, pkg.Buffer)
        s = pkg.Scheduler(srv, batch=2)
        s.configure_pool(replicas=2)
        srv.push(cid=7, seq=41)
        srv.push(cid=8, seq=42)
        buf = s.next_batch(timeout=0.5)
        s.shed_batch(buf.meta["serve_routes"], "replica-error")
        assert len(srv.sent) == 2
        for cid, msg in srv.sent:
            assert msg.type == pkg.proto.MSG_BUSY
            assert msg.meta["detail"] == "replica-error"
            assert msg.meta["_seq"] in (41, 42)
        assert s.shed_reasons.get("replica-error") == 2

    def test_hung_replica_expires_and_pool_routes_around(self, pkg):
        srv = FakeServer(pkg.proto, pkg.Buffer)
        s = pkg.Scheduler(srv, batch=1)
        s.configure_pool(replicas=2)
        s.inflight_expire_s = 0.05
        srv.push(cid=1)
        assert s.next_batch(timeout=0.5).meta["serve_replica"] == 0
        srv.push(cid=1)
        assert s.next_batch(timeout=0.5).meta["serve_replica"] == 1
        s.note_reply_batch(None, replica=1)
        srv.push(cid=1)
        assert s.next_batch(timeout=0.5).meta["serve_replica"] == 1
        time.sleep(0.06)  # replica 0's phantom window expires
        s.note_reply_batch(None, replica=1)
        srv.push(cid=1)
        assert s.next_batch(timeout=0.5).meta["serve_replica"] == 0


# --- loopback: parity, traces, faults, drain --------------------------------

class TestPoolLoopback:
    def test_replica_parity_traces_and_split(self, pkg):
        server, tracer = pkg.server("par")
        try:
            assert server["ssrc"]._pool_state == {"replicas": 4}
            assert server["f"]._replica_state == {"replicas": 4}
            ok, err, outs, _ = pkg.drive(server["ssrc"].port,
                                         list(range(12)))
            assert ok and err is None
            got = sorted(float(o.reshape(-1)[0]) for o in outs)
            assert got == [float(i) + 1 for i in range(12)]
            assert server["f"].fw.compile_stats()["jit_traces"] == 1
            s = tracer.serving()["par"]
            assert s["replies"] == 12
            split = s.get("per_replica") or {}
            assert split and sum(v["batches"] for v in split.values()) \
                == s["batches"]
        finally:
            server.stop()
        single, _ = pkg.server("par1", extra="")
        try:
            ok, err, outs1, _ = pkg.drive(single["ssrc"].port,
                                          list(range(12)))
            assert ok and err is None
            a = sorted(map(bytes, (np.ascontiguousarray(o) for o in outs)))
            b = sorted(map(bytes, (np.ascontiguousarray(o) for o in outs1)))
            assert a == b  # replica-vs-single parity, exact bytes
        finally:
            single.stop()

    def test_slow_replica_degrades_to_healthy_pool(self, pkg):
        server, tracer = pkg.server("slow", b=1)
        try:
            pkg.faults.install("invoke-hang", times=1, delay_s=1.0,
                               match="f@r0")
            t0 = time.perf_counter()
            ok, err, outs, _ = pkg.drive(server["ssrc"].port,
                                         list(range(10)))
            wall = time.perf_counter() - t0
            assert ok and err is None and len(outs) == 10
            assert wall < 8.0
            split = tracer.serving()["slow"].get("per_replica") or {}
            assert sum(v["batches"] for r, v in split.items()
                       if r != "0") >= 6
        finally:
            pkg.faults.clear()
            server.stop()

    def test_replica_error_sheds_batch_with_reason(self, pkg):
        server, tracer = pkg.server("rerr", fextra="on-error=drop ", b=1)
        try:
            pkg.faults.install("invoke-raise", times=1, match="f@r")
            ok, err, outs, stats = pkg.drive(server["ssrc"].port,
                                             list(range(8)))
            assert ok and err is None
            assert len(outs) == 7  # exactly the faulted batch was shed
            assert stats.get("dropped") == 1  # the client saw the BUSY
            sheds = tracer.serving()["rerr"]["shed_reasons"]
            assert sheds.get("replica-error") == 1
        finally:
            pkg.faults.clear()
            server.stop()

    def test_drain_on_stop_sheds_all_replicas_draining(self, pkg):
        handle = sys.modules[("nnstreamer_tpu_torch" if pkg.port
                              else "nnstreamer_tpu") + ".edge.handle"]
        server, tracer = pkg.server("drain", b=1)
        cli = handle.EdgeClient("localhost", server["ssrc"].port,
                                timeout=5.0)
        cli.connect()
        try:
            pkg.faults.install("invoke-hang", times=None, delay_s=0.4,
                               match="f@")
            for i in range(24):
                cli.send(pkg.proto.buffer_to_message(
                    pkg.Buffer(tensors=[np.full(4, float(i), np.float32)]),
                    pkg.proto.MSG_DATA, _seq=i + 1))
            time.sleep(0.3)
        finally:
            server.stop()
            pkg.faults.clear()
        sheds = tracer.serving()["drain"]["shed_reasons"]
        assert sheds.get("draining", 0) >= 1
        cli.close()

    def test_midstream_fallback_resets_scheduler_and_plant(self, pkg):
        server, _ = pkg.server("fall")
        try:
            f = server["f"]
            sched = server["ssrc"]._sched
            assert sched._replicas == 4
            f.fw.build_replicas = lambda n: n <= 1  # the reload declines
            f.sink_pads[0].receive_event(
                pkg.Event("reload-model", {"model": "add"}))
            assert f._replica_state is None
            assert server["ssrc"]._pool_state is None
            assert sched._replicas == 1
            assert sched.ctl_window().get("replicas") is None
            ok, err, outs, _ = pkg.drive(server["ssrc"].port,
                                         list(range(4)))
            assert ok and err is None
            got = sorted(float(o.reshape(-1)[0]) for o in outs)
            assert got == [1.0, 2.0, 3.0, 4.0]
        finally:
            server.stop()

    def test_doctor_serving_renders_per_replica(self, pkg, tmp_path):
        """doctor --serving round-trips a pooled report and prints the
        per-replica batch split."""
        import json

        import importlib

        doctor = importlib.import_module(
            ("nnstreamer_tpu_torch" if pkg.port else "nnstreamer_tpu")
            + ".tools.doctor")
        server, tracer = pkg.server("doc")
        try:
            ok, err, outs, _ = pkg.drive(server["ssrc"].port, list(range(8)))
            assert ok and err is None
            rep = {"serving": tracer.serving()}
        finally:
            server.stop()
        path = tmp_path / "report.json"
        path.write_text(json.dumps(rep, default=str))
        assert doctor.main(["--serving", str(path)]) == 0
        text = doctor.render_serving(rep)
        assert "replicas (nnpool)" in text and "r0=" in text

    def test_replicas_off_report_byte_identical(self, pkg):
        server, tracer = pkg.server("norep", extra="")
        try:
            ok, err, outs, _ = pkg.drive(server["ssrc"].port, list(range(4)))
            assert ok and err is None
            assert "per_replica" not in tracer.serving()["norep"]
            assert server["ssrc"]._pool_state is None
        finally:
            server.stop()


# --- sharded serve-batch placement and serving byte parity ------------------

class TestShardedPlacement:
    def test_batches_land_sharded_with_parity(self, pkg):
        p = pkg.parse_launch(pkg.pool_line("place", extra="",
                                           fextra="shard=dp mesh=4x1 "))
        tracer = pkg.trace.attach(p)
        p.play()
        try:
            assert p["f"]._shard_state == {"mode": "dp", "dp": 4, "tp": 1}
            assert p["ssrc"]._pool_placement is p["f"]
            ok, err, outs, _ = pkg.drive(p["ssrc"].port, list(range(16)))
            assert ok and err is None
            got = sorted(float(o.reshape(-1)[0]) for o in outs)
            assert got == [float(i) + 1 for i in range(16)]
            cr = tracer.crossings()
            assert cr["per_element"]["ssrc"]["h2d"] >= 1
            assert "f" not in cr["per_element"] \
                or cr["per_element"]["f"]["h2d"] == 0
            batches = tracer.serving()["place"]["batches"]
            pred = pkg.residency.predict_crossings(p, n_buffers=batches)
            assert pkg.residency.parity_mismatches(pred, cr) == []
            pd = pred["per_element_bytes_per_device"]["ssrc"]
            assert pd["h2d"] * 4 == pred["per_element_bytes"]["ssrc"]["h2d"]
        finally:
            p.stop()


class TestServingPadByteParity:
    def test_pad_rows_cross_as_real_bytes(self, pkg):
        p = pkg.parse_launch(pkg.pool_line("pads", extra=""))
        tracer = pkg.trace.attach(p)
        p.play()
        try:
            ok, err, outs, _ = pkg.drive(p["ssrc"].port, [0, 1, 2])
            assert ok and err is None and len(outs) == 3
            s = tracer.serving()["pads"]
            assert s["padded_rows"] > 0
            cr = tracer.crossings()
            assert cr["per_element"]["f"]["h2d_bytes"] == \
                s["batches"] * 8 * 16  # pad rows included
            pred = pkg.residency.predict_crossings(p, n_buffers=s["batches"])
            assert pkg.residency.parity_mismatches(pred, cr) == []
        finally:
            p.stop()


def test_replicas_serve_the_mobilenet_line_like_one():
    """A narrow MobileNet-v2 served behind ``replicas=4`` on the port:
    the replies' logits are the single-replica server's bit for bit (each
    replica runs the same forward on its own copy of the weights; the
    pool may reply in another order), and every replica serves a
    batch."""
    caps = ("other/tensors,num-tensors=1,dimensions=3:32:32,types=uint8,"
            "framerate=0/1")
    filt = ("tensor_filter framework=jax model=mobilenet_v2 "
            "custom=seed:0,size:32,width:0.35,classes:16,fused:pallas "
            "accelerator=true:cpu")

    def serve(sid, extra):
        p = PORT.parse_launch(
            f"tensor_query_serversrc name=ssrc id={sid} port=0 serve=1 "
            f"serve-batch=2 {extra}caps={caps} ! {filt} name=f "
            f"! tensor_query_serversink id={sid} timeout=5")
        tracer = PORT.trace.attach(p)
        p.play()
        cl = PORT.parse_launch(
            f"appsrc name=src caps={caps} ! tensor_query_client name=cli "
            f"port={p['ssrc'].port} ! tensor_sink name=out")
        cl.play()
        rng = np.random.default_rng(3)
        for i in range(16):
            cl["src"].push_buffer(PORT.Buffer(tensors=[rng.integers(
                0, 256, (32, 32, 3), dtype=np.uint8)], pts=i))
        cl["src"].end_of_stream()
        assert cl.bus.wait_eos(120) and cl.bus.error is None
        outs = [np.asarray(b[0]) for b in cl["out"].collected]
        split = tracer.serving()[sid].get("per_replica", {})
        cl.stop()
        p.stop()
        return outs, split

    pooled, split = serve("mbr", "replicas=4 ")
    single, _ = serve("mb1", "")
    assert len(pooled) == len(single) == 16
    assert sorted(o.tobytes() for o in pooled) == \
        sorted(o.tobytes() for o in single)
    assert sorted(split) == ["0", "1", "2", "3"]


@pytest.mark.parametrize("safe,code", [(True, "NNST960"), (False, "NNST961")])
def test_custom_easy_declares_replica_safety(pkg, safe, code):
    """A custom-easy model registered ``replica_safe=True`` replicates
    (its workers share the pure function); one that does not declare it
    is refused as a stateful backend — the same in both packages."""
    base = sys.modules[("nnstreamer_tpu_torch" if pkg.port
                        else "nnstreamer_tpu") + ".filters.base"]
    types = sys.modules[("nnstreamer_tpu_torch" if pkg.port
                         else "nnstreamer_tpu") + ".types"]
    info = types.TensorsInfo.from_strings("4:8", "float32")
    name = f"pool_easy_{safe}"
    base.register_custom_easy(name, lambda xs: [xs[0] * 2], info, info,
                              replica_safe=safe)
    try:
        p = pkg.parse_launch(
            "tensor_query_serversrc name=ssrc id=ce port=0 serve=1 "
            f"serve-batch=8 replicas=4 caps={CAPS4} ! tensor_filter name=f "
            f"framework=custom-easy model={name} "
            "! tensor_query_serversink id=ce timeout=5")
        p.play()
        try:
            if safe:
                assert p["f"]._replica_state == {"replicas": 4}
                assert p["f"].fw.replica_count() == 4
            else:
                assert p["ssrc"]._pool_refused[0] == code
                assert "cannot replicate" in p["ssrc"]._pool_refused[1]
        finally:
            p.stop()
    finally:
        base.unregister_custom_easy(name)
