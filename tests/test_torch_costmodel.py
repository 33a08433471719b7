"""The port's cost model, memory plan and crossing predictor, on the CPU.

The cost model (``analysis/costmodel.py``) runs the filter's plain
composition once on ``meta`` tensors: flops from
``torch.utils.flop_counter.FlopCounterMode`` plus the jaxpr walk's
pointwise and reduction counts, the live-storage peak from a dispatch
mode. It is held to what the reference's tests/test_costmodel.py asserts
(MobileNet-v2 within 25% of MFU_TABLE.json's recorded count, a fused
stage's flops, the plan's feed/fetch holdings and param sharing — cases
the JAX package fails only because its jaxpr walk raises under this jax).
The reference's passing byte-parity, compile-count, NNST800, budget and
serving-plan cases run through both packages with equal results.

The cost method ``compiled`` (one concrete run of the composition) is
held to the reference's ``compiled`` method, which does not walk a jaxpr
and so runs here (tests/test_costmodel.py:266-283): ``model=add``'s flops
equal 8 in both, MobileNet-v2's within 25% of each other; its keys are
the reference's. NNST801 (a Python scalar widening stream data) fires
on the reference's uint8 ``x * 2.5`` model and stays silent on
``model=add`` (tests/test_costmodel.py:150-170); the reference's jaxpr
walk raises there, so the port alone is held to those asserts.

Left out: ``static_report``/the roofline bottleneck and the jaxpr-only
cases.
"""

import json
import os
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

import nnstreamer_tpu.analysis.costmodel  # noqa: E402
import nnstreamer_tpu.analysis.memplan  # noqa: E402
import nnstreamer_tpu.analysis.residency  # noqa: E402
import nnstreamer_tpu.buffer  # noqa: E402
import nnstreamer_tpu.elements.filter  # noqa: E402
import nnstreamer_tpu.pipeline  # noqa: E402
import nnstreamer_tpu.trace  # noqa: E402
import nnstreamer_tpu_torch.analysis.costmodel  # noqa: E402
import nnstreamer_tpu_torch.analysis.memplan  # noqa: E402
import nnstreamer_tpu_torch.analysis.residency  # noqa: E402
import nnstreamer_tpu_torch.buffer  # noqa: E402
import nnstreamer_tpu_torch.elements.filter  # noqa: E402
import nnstreamer_tpu_torch.pipeline  # noqa: E402
import nnstreamer_tpu_torch.trace  # noqa: E402
from nnstreamer_tpu_torch.analysis.costmodel import (  # noqa: E402
    ShapeDtype,
    card_block_bytes as card_block,
    composition,
    filter_cost,
    meta_composition,
    program_cost,
)
from nnstreamer_tpu_torch.analysis.memplan import plan_memory  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPS_F32 = ("other/tensors,num-tensors=1,dimensions=4:2,types=float32,"
            "framerate=0/1")
CAPS_U8 = ("other/tensors,num-tensors=1,dimensions=4:2,types=uint8,"
           "framerate=0/1")
PKGS = ("nnstreamer_tpu", "nnstreamer_tpu_torch")


class Pkg:
    def __init__(self, name):
        mod = sys.modules
        self.port = name == "nnstreamer_tpu_torch"
        self.parse_launch = mod[f"{name}.pipeline"].parse_launch
        self.trace = mod[f"{name}.trace"]
        self.Buffer = mod[f"{name}.buffer"].Buffer
        self.cost = mod[f"{name}.analysis.costmodel"]
        self.memplan = mod[f"{name}.analysis.memplan"]
        self.residency = mod[f"{name}.analysis.residency"]
        self.TensorFilter = mod[f"{name}.elements.filter"].TensorFilter
        self.cpu = "accelerator=true:cpu " if self.port else ""

    def filt(self, extra="", name=None, k=1):
        nm = f"name={name} " if name else ""
        return (f"tensor_filter {nm}framework=jax model=add "
                f"custom=k:{k},aot:0 {self.cpu}{extra}")

    def run(self, p, bufs, src="src"):
        for b in bufs:
            p[src].push_buffer(b)
        p[src].end_of_stream()
        assert p.bus.wait_eos(30)
        assert p.bus.error is None, p.bus.error.data


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture
def port():
    return Pkg("nnstreamer_tpu_torch")


def _add_program():
    fn, module, _ = meta_composition("add", {"k": "1"})
    return fn, module


class TestProgramCost:
    def test_add_flops_and_bytes(self):
        fn, module = _add_program()
        c = program_cost(fn, module, [ShapeDtype((2, 4), np.float32)])
        assert c["flops"] == 8  # one add per element
        assert c["bytes_read"] == c["bytes_written"] == 32
        assert c["hbm_bytes"] == 64
        assert c["param_bytes"] == 0
        # the input, the 0-d k, the output
        assert c["peak_live_bytes"] == 32 + 4 + 32
        assert c["method"] == "meta" and c["weak_type_hazards"] == []

    def test_compiled_method_runs_the_program(self):
        """``method="compiled"`` runs the composition once on the device
        of its params, with the reference's keys; a meta build cannot
        run."""
        fn, module, _ = composition("add", {"k": "1"}, device="cpu")
        c = program_cost(fn, module, [ShapeDtype((2, 4), np.float32)],
                         method="compiled")
        assert c["method"] == "compiled" and c["flops"] == 8
        assert c["bytes_read"] == c["bytes_written"] == 32
        assert c["weak_type_hazards"] == []
        fn, module, _ = meta_composition("matmul", {"dim": "64"})
        with pytest.raises(ValueError, match="compiled"):
            program_cost(fn, module, [ShapeDtype((8, 64), np.float32)],
                         method="compiled")

    def test_matmul_flops_and_params(self):
        fn, module, _ = meta_composition("matmul", {"dim": "64"})
        c = program_cost(fn, module, [ShapeDtype((8, 64), np.float32)])
        # 2*8*64*64 for the product, 8*64 per cast (in and out)
        assert c["flops"] == 2 * 8 * 64 * 64 + 2 * 8 * 64
        assert c["param_bytes"] == 64 * 64 * 2  # bf16 W
        assert c["output_bytes"] == 8 * 64 * 4

    def test_peak_frees_dead_intermediates(self):
        """A chain of elementwise ops holds two intermediates at a time,
        not all of them: the peak counts storages while a tensor lives."""
        def fn(params, x):
            for _ in range(6):
                x = x * 2.0
            return x

        c = program_cost(fn, {}, [ShapeDtype((256,), np.float32)])
        assert c["flops"] == 6 * 256
        assert c["peak_live_bytes"] <= 1024 + 2 * 1024

    def test_meta_run_launches_nothing(self):
        """The kernels' wrappers route meta tensors to their plain
        versions: a MobileNet-v2 cost run adds no launch."""
        from nnstreamer_tpu_torch.ops import _cuda

        before = dict(_cuda.LAUNCHES)
        fn, module, _ = meta_composition(
            "mobilenet_v2", {"seed": "0", "size": "64", "width": "0.35",
                             "classes": "16", "fused": "pallas"})
        c = program_cost(fn, module, [ShapeDtype((2, 64, 64, 3), np.uint8)])
        assert c["flops"] > 0 and c["output_bytes"] == 2 * 16 * 4
        assert _cuda.LAUNCHES == before

    def test_meta_route_only_for_the_composition_kernels(self):
        """Meta tensors take the plain route of the composition's kernels
        (fused block, normalize_u8, arith_chain); the one dispatch rule
        still refuses them elsewhere, and a CPU tensor takes both."""
        from nnstreamer_tpu_torch.ops import _cuda

        meta = torch.zeros(2, device="meta")
        assert _cuda.plain_route(meta)
        assert _cuda.plain_route(torch.zeros(2))
        with pytest.raises(ValueError, match="no kernel"):
            _cuda.on_cpu(meta)

    @pytest.mark.parametrize("stride,size", [(1, 16), (2, 16), (2, 15)])
    def test_fused_block_bills_its_output_not_its_hidden_tensor(
            self, stride, size):
        """The meta run bills the fused block as the card holds it: its
        output in device memory, its hidden tensor and depthwise output on
        chip (the reference's walk sees a pallas_call as one equation).
        The flops stay the plain version's; the plain version called
        directly still bills what it materializes."""
        from torch.utils.flop_counter import FlopCounterMode

        from nnstreamer_tpu_torch.ops import _cuda
        from nnstreamer_tpu_torch.ops.fused_block import (
            fused_inverted_residual,
            inverted_residual_plain,
        )

        cin, ch, cout, B = 16, 96, 24, 2
        rng = np.random.default_rng(5)
        fw = {k: torch.from_numpy(rng.normal(0, 0.3, s).astype(np.float32))
              .to("meta") for k, s in (("w1", (cin, ch)), ("b1", (ch,)),
                                       ("wd", (9, ch)), ("bd", (ch,)),
                                       ("w2", (ch, cout)), ("b2", (cout,)))}
        shape = [ShapeDtype((B, size, size, cin), np.float32)]
        out_bytes = B * (-(-size // stride)) ** 2 * cout * 2

        def kernel(params, x):
            return fused_inverted_residual(x, params, stride=stride)

        def plain(params, x):
            return inverted_residual_plain(x, params, stride=stride)

        k = program_cost(kernel, fw, shape)
        p = program_cost(plain, fw, shape)
        base = k["param_bytes"] + k["bytes_read"]
        assert k["output_bytes"] == p["output_bytes"] == out_bytes
        assert k["peak_live_bytes"] == base + out_bytes
        # the plain version materializes the hidden tensor (B*H*W*Ch)
        assert p["peak_live_bytes"] > base + B * size * size * ch * 2
        assert k["flops"] == p["flops"] > 0
        assert not _cuda.in_kernel_resident()
        # outside the cost model the scope changes nothing
        with FlopCounterMode(display=False):
            got = fused_inverted_residual(
                torch.zeros((B, size, size, cin), device="meta"), fw,
                stride=stride, compute_dtype=torch.float32)
        assert got.device.type == "meta" and got.dtype == torch.float32

    def test_card_blocks_follow_the_caching_allocator(self):
        """For a filter on the card each storage bills the block the CUDA
        caching allocator keeps from a fresh segment: every request
        rounded up to 512 bytes (up to 1 MiB carved from a shared small
        segment, up to 10 MiB from a large one); from 10 MiB up the
        2 MiB-rounded segment when at most 1 MiB would be left over (the
        sizes of the flagship's batch-128 stem: the preamble's float32
        output, the padded input, the stem's output, cuDNN's widened copy
        and its scratch), else the request."""
        from nnstreamer_tpu_torch.analysis.costmodel import card_block_bytes

        mib = 1 << 20
        assert card_block_bytes(0) == 0
        assert card_block_bytes(4) == card_block_bytes(32) == 512
        assert card_block_bytes(1728) == 2048  # the stem's weight copy
        assert card_block_bytes(303_750) == 304_128  # the padded frame
        assert card_block_bytes(mib) == mib
        assert card_block_bytes(9 * mib + 1) == 9 * mib + 512
        assert card_block_bytes(77_070_336) == 77_594_624
        assert card_block_bytes(38_880_000) == 39_845_888
        assert card_block_bytes(38_535_168) == 38_535_168  # 1.25 MiB over
        assert card_block_bytes(102_760_448) == 102_760_448  # 49 x 2 MiB
        assert card_block_bytes(103_684_624) == 103_685_120  # 1.12 MiB over

    def test_held_weights_bill_a_cached_block_kept_whole(self):
        """A weight the ordinary pool serves after earlier work may take a
        cached block the allocator keeps whole (at most 1 MiB left over):
        above 1 MiB it bills that 1 MiB more than its 512-byte-rounded
        size (the flagship's head weight took a whole 2 MiB block on the
        card), or its fresh segment where that is more; up to 1 MiB it
        bills the small pool's block."""
        from nnstreamer_tpu_torch.analysis.costmodel import held_block_bytes

        mib = 1 << 20
        assert held_block_bytes(1000) == 1024
        assert held_block_bytes(mib) == mib
        assert held_block_bytes(1_638_400) == 1_638_400 + mib
        assert held_block_bytes(38_880_000) == 38_880_256 + mib
        assert held_block_bytes(77_070_336) == 77_070_336 + mib

    def test_card_run_rounds_small_and_large_storages(self):
        """The meta run for the card bills a small storage as the small
        pool's 512-byte block and a large one as its whole 2 MiB-rounded
        segment, and splits its peak into the requests and the rounding;
        for the CPU it bills the requests."""
        mib = 1 << 20

        def two(params, x):
            small = x * 2  # 1000 bytes
            big = torch.zeros(11 * mib + 100, dtype=torch.uint8,
                              device=x.device)
            return small, big

        shape = [ShapeDtype((250,), np.float32)]
        host, card = (program_cost(two, {}, shape, card=c)
                      for c in (False, True))
        base = host["param_bytes"] + host["bytes_read"]
        assert host["peak_live_bytes"] == base + 1000 + 11 * mib + 100
        assert card["peak_live_bytes"] == base + 1024 + 12 * mib
        assert card["peak_terms"] == {
            "storages": 1000 + 11 * mib + 100,
            "block_rounding": 24 + mib - 100,
            "cudnn_workspace": 0, "cudnn_layout_copies": 0}
        assert card["output_sizes"] == [1000, 11 * mib + 100]
        assert card["gemm"] is False
        assert "peak_terms" not in host and "gemm" not in host

    @pytest.mark.parametrize("dtype,cin,groups,want", [
        ("bfloat16", 3, 1, 1), ("float16", 3, 1, 1), ("float32", 3, 1, 0),
        ("bfloat16", 8, 1, 0), ("bfloat16", 6, 3, 0)])
    def test_card_bills_cudnns_widened_stem_input(self, dtype, cin, groups,
                                                  want):
        """A 16-bit convolution whose input channels are no multiple of 8
        (the stems' 3) bills cuDNN's copy of its input widened to 8
        channels and cuDNN's scratch beside its output, as the allocator
        counts them, for a filter on the card only; every convolution of
        a channels-last input there bills the copy of its NCHW weight."""
        from nnstreamer_tpu_torch.analysis.costmodel import (
            card_block_bytes,
            cudnn_layout_bytes,
            cudnn_workspace_bytes,
        )

        dt = getattr(torch, dtype)
        w = torch.empty((8, cin // groups, 3, 3), dtype=dt, device="meta")

        def conv(params, x):
            return torch.nn.functional.conv2d(
                x.to(dt).permute(0, 3, 1, 2), w, stride=2, groups=groups)

        shape = [ShapeDtype((4, 33, 33, cin), np.float32)]
        host, card = (program_cost(conv, {}, shape, card=c)
                      for c in (False, True))
        ws = card_block_bytes(4 * 33 * 33 * 8 * 2 + 4624)
        weight = card_block_bytes(w.numel() * w.element_size())
        assert card["peak_terms"]["cudnn_workspace"] == want * ws
        assert card["peak_terms"]["cudnn_layout_copies"] == weight
        assert card["peak_live_bytes"] - host["peak_live_bytes"] == (
            want * ws + weight + card["peak_terms"]["block_rounding"])
        x = torch.empty((4, 33, 33, cin), dtype=dt,
                        device="meta").permute(0, 3, 1, 2)
        args = (x, w, None, [2, 2], [0, 0], [1, 1], False, [0, 0], groups)
        aten = torch.ops.aten
        assert cudnn_workspace_bytes(aten.convolution.default,
                                     args) == want * ws
        assert cudnn_workspace_bytes(aten.add.Tensor, args) == 0
        assert cudnn_layout_bytes(aten.convolution.default, args) == weight
        # an NCHW input and weight: nothing copied
        nchw = (x.contiguous(),) + args[1:]
        assert cudnn_layout_bytes(aten.convolution.default, nchw) == 0

    def test_card_run_bills_the_kernels_outputs_alone(self):
        """For the card, ``normalize_u8`` and ``arith_chain`` bill their
        outputs alone (the frames reach the model in the compute dtype, as
        the kernel writes them); for the CPU the frames are the JAX
        package's float32 expression and the chain's plain steps, as
        before."""
        from nnstreamer_tpu_torch.models import preprocess_frames
        from nnstreamer_tpu_torch.ops.transform_ops import arith_chain

        shape = [ShapeDtype((2, 16, 16, 3), np.uint8)]
        px = 2 * 16 * 16 * 3

        def frames(params, x):
            return preprocess_frames(x, "pm1", torch.bfloat16)

        def chain(params, x):
            return arith_chain(x, [("add", -127.5), ("div", 127.5)],
                               out_dtype=torch.float32)

        host, card = (program_cost(frames, {}, shape, card=c)
                      for c in (False, True))
        base = host["param_bytes"] + host["bytes_read"]
        assert card["output_sizes"] == [px * 2]  # bfloat16
        assert card["peak_live_bytes"] == base + card_block(px * 2)
        assert host["output_bytes"] == px * 4  # the float32 expression
        assert host["peak_live_bytes"] >= base + 2 * px * 4
        host, card = (program_cost(chain, {}, shape, card=c)
                      for c in (False, True))
        assert card["peak_live_bytes"] == base + card_block(px * 4)
        assert host["peak_live_bytes"] >= base + 2 * px * 4

    @pytest.mark.parametrize("model,window,where,billed", [
        ("matmul", 4, "card", True), ("matmul", 1, "card", False),
        ("matmul", 4, "cpu", False), ("add", 4, "card", False)])
    def test_cublas_workspace_billed_for_a_product_in_a_capture(
            self, port, model, window, where, billed):
        """A windowed filter on the card whose composition runs a product
        bills cuBLAS's workspace beside its graph pool: the first
        capture's products take it in that capture's pool, and cuBLAS
        keeps it. Per buffer, on the CPU, or without a product, no
        workspace is billed."""
        from nnstreamer_tpu_torch.analysis.costmodel import (
            cublas_workspace_bytes,
        )

        cpu = port.cpu if where == "cpu" else ""
        loop = f"loop-window={window} " if window > 1 else ""
        p = port.parse_launch(
            f"appsrc caps={CAPS_F32} ! tensor_filter name=f framework=jax "
            f"model={model} custom=dim:4,aot:0 {cpu}{loop}! tensor_sink")
        row = next(r for r in plan_memory(p)["rows"] if r["element"] == "f")
        assert row["loop_window"] == window
        want = cublas_workspace_bytes() if billed else 0
        assert row["cublas_bytes"] == want
        assert row["total_bytes"] == (
            row["activation_bytes"] + row["feed_bytes"] + row["window_bytes"]
            + row["loop_bytes"] + row["graph_bytes"] + want)
        if where == "card" and window > 1:
            terms = row["graph_terms"]
            assert terms["cublas_first_capture"] == want
            assert sum(v for k, v in terms.items()
                       if k != "cublas_first_capture") == row["graph_bytes"]

    @pytest.mark.parametrize("spec,capability,want", [
        (None, (9, 0), 32 << 20), (None, (8, 0), (4096 * 2 + 16 * 8) << 10),
        (":4096:8", (8, 0), 32 << 20), (":16:8", (9, 0), 128 << 10)])
    def test_cublas_workspace_follows_pytorchs_rule(self, monkeypatch, spec,
                                                    capability, want):
        """cuBLAS's workspace for a (handle, stream): CUBLAS_WORKSPACE_CONFIG's
        ``:KiB:count`` pairs summed, else PyTorch's default for the card
        (32 MiB on sm_90, measured in a capture's pool on the H100)."""
        from nnstreamer_tpu_torch.analysis.costmodel import (
            cublas_workspace_bytes,
        )

        if spec is None:
            monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
        else:
            monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", spec)
        assert cublas_workspace_bytes(capability) == want


class TestMfuTable:
    def test_analyzer_flops_match_recorded_count(self):
        """MobileNet-v2's modelled flops at the recorded row's batch lie
        within 25% of MFU_TABLE.json's recorded count (81.9 GFLOPs at
        batch 128) — the reference's own test, on the port's model."""
        with open(os.path.join(REPO, "MFU_TABLE.json")) as f:
            table = json.load(f)
        row = next(r for r in table["rows"]
                   if r["config"].startswith("mobilenet_v2 f32-params"))
        fn, module, _ = meta_composition(
            "mobilenet_v2", {"seed": "0", "fused": "pallas"})
        c = program_cost(fn, module, [
            ShapeDtype((row["batch"], 224, 224, 3), np.uint8)])
        rec = row["gflops_per_batch"] * 1e9
        assert abs(c["flops"] - rec) / rec < 0.25, (c["flops"], rec)
        # float32 weights and BN statistics of MobileNet-v2 1.0
        assert 13e6 < c["param_bytes"] < 15e6


class TestFilterCost:
    def test_fused_stages_included(self, port):
        """A fused pre-stage's math shows up in the OPEN backend's cost:
        cast (8) + mul (8) + the model's add (8)."""
        p = port.parse_launch(
            f"appsrc name=src caps={CAPS_U8} "
            "! tensor_transform name=tr mode=arithmetic "
            "option=typecast:float32,mul:2 "
            f"! {port.filt(name='f')} ! tensor_sink name=out")
        p.play()
        try:
            assert p["tr"]._fused_into == "f"
            cost = filter_cost(p["f"])
            assert cost is not None and cost["flops"] == 24
            assert cost["input_bytes"] == 8  # uint8 frames cross
        finally:
            p.stop()

    def test_lint_time_signature_from_dry_negotiation(self, port):
        p = port.parse_launch(
            f"appsrc caps={CAPS_F32} ! {port.filt('batch-size=4 ', 'f')} "
            "! tensor_sink")
        cost = filter_cost(p["f"])
        assert cost["input_shapes"] == [(4, 2, 4)]
        assert cost["flops"] == 32 and cost["batch"] == 4

    def test_unbuildable_model_is_unmodeled(self, port):
        p = port.parse_launch(
            f"appsrc caps={CAPS_F32} ! tensor_filter name=f framework=jax "
            "model=no_such_model_xyz ! tensor_sink")
        assert filter_cost(p["f"]) is None


class TestMemplan:
    def test_shared_backend_params_counted_once(self, port):
        def line(shared):
            key = "shared-tensor-filter-key=K " if shared else ""
            return (f"appsrc caps={CAPS_F32.replace('4:2', '512:4')} "
                    "! tee name=t  "
                    "t. ! queue ! tensor_filter name=fa framework=jax "
                    f"model=matmul custom=dim:512 {key}! tensor_sink name=a  "
                    "t. ! queue ! tensor_filter name=fb framework=jax "
                    f"model=matmul custom=dim:512 {key}! tensor_sink name=b")

        ps = plan_memory(port.parse_launch(line(True)))
        pp = plan_memory(port.parse_launch(line(False)))
        one = ps["rows"][0]["param_bytes"]
        assert one == 512 * 512 * 2
        assert ps["param_bytes_total"] == one
        assert pp["param_bytes_total"] == 2 * one
        assert ps["param_sharing_groups"] == 1
        assert pp["param_sharing_groups"] == 2

    def test_params_not_double_billed(self, port):
        p = port.parse_launch(
            f"appsrc caps={CAPS_F32.replace('4:2', '1024:4')} "
            "! tensor_filter framework=jax model=matmul custom=dim:1024 "
            "! tensor_sink")
        plan = plan_memory(p)
        params = plan["param_bytes_total"]
        assert params > 1_000_000  # 1024^2 bf16
        # on the card the 2 MiB weight may come from a cached block kept
        # whole, up to 1 MiB larger: billed beside the params, once
        assert plan["weight_rounding_bytes_total"] == 1 << 20
        assert (plan["total_bytes"] - plan["weight_rounding_bytes_total"]
                < 1.5 * params)

    def test_feed_and_window_holdings(self, port):
        p = port.parse_launch(
            f"appsrc caps={CAPS_F32} ! "
            f"{port.filt('batch-size=2 feed-depth=4 fetch-window=8 ')} "
            "! tensor_sink")
        row = plan_memory(p)["rows"][0]
        # 32 B/frame x batch 2 = 64 B/invoke
        assert row["feed_bytes"] == 4 * 64
        assert row["window_bytes"] == 8 * 64

    def test_unconfigured_hbm_queue_billed_at_runtime_default(self, pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} "
            f"! {pkg.filt(name='f1')} ! queue name=q "
            f"! {pkg.filt(name='f2', k=10)} ! tensor_sink")
        p.play()
        try:
            deadline = time.time() + 10
            while getattr(p["q"].src_pads[0], "caps", None) is None \
                    and time.time() < deadline:
                time.sleep(0.01)
            plan = pkg.memplan.plan_memory(p)
        finally:
            p.stop()
        q = [r for r in plan["queues"] if r["element"] == "q"]
        assert q and q[0]["capacity"] == 16
        assert q[0]["bytes"] == 16 * 32

    def test_budget_env_override(self, pkg, monkeypatch):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "2G")
        assert pkg.memplan.device_memory_budget() == (2 * 2**30,
                                                      "NNSTPU_HBM_BYTES")

    def test_budget_env_malformed_never_raises(self, pkg, monkeypatch):
        monkeypatch.setenv("NNSTPU_HBM_BYTES", "lots")
        b, src = pkg.memplan.device_memory_budget()
        assert b > 0 and src != "NNSTPU_HBM_BYTES"

    def test_cpu_budget_matches_the_reference_default(self, monkeypatch):
        monkeypatch.delenv("NNSTPU_HBM_BYTES", raising=False)
        got = Pkg("nnstreamer_tpu_torch").memplan.device_memory_budget()
        assert got == Pkg("nnstreamer_tpu").memplan.device_memory_budget()


class TestMemplanHostParity:
    """The card's terms (the allocator's blocks, cuDNN's workspace and
    layout copies, the kernels' outputs alone, the graph pool, cuBLAS's
    workspace) apply only where the plan bills for the card: with the
    port's filter on the CPU its rows stand to the JAX package's as they
    did before those terms (the port's activation a few bytes above, as
    its meta run and the jaxpr walk part ways on 0-d constants and on
    when the fused stage's cast dies)."""

    LINES = {
        "add": (f"appsrc caps={CAPS_F32} ! {{filt}} ! tensor_sink", 4),
        "add_windowed": (f"appsrc caps={CAPS_F32} ! {{filt}} ! tensor_sink",
                         4),
        "fused_uint8": (f"appsrc caps={CAPS_U8} ! tensor_transform "
                        "mode=arithmetic option=typecast:float32,mul:2 "
                        "! {filt} ! queue ! tensor_sink", 12),
    }
    SAME = ("param_bytes", "feed_bytes", "window_bytes", "loop_bytes")
    APART = ("peak_live_bytes", "activation_bytes", "total_bytes")

    @pytest.mark.parametrize("case", sorted(LINES))
    def test_rows_stand_to_the_reference_as_before(self, case,
                                                   monkeypatch):
        # jax 0.9 moved Literal to jax.extend.core; the reference's cost
        # model reads it from jax.core (ROADMAP queue 3 item 2)
        import jax.extend.core

        monkeypatch.setattr(jax.core, "Literal", jax.extend.core.Literal,
                            raising=False)
        line, apart = self.LINES[case]
        rows = []
        for name in PKGS:
            pkg = Pkg(name)
            extra = "loop-window=4 " if case == "add_windowed" else ""
            p = pkg.parse_launch(line.format(filt=pkg.filt(extra, name="f")))
            if case == "fused_uint8":
                p.play()  # the planner fuses the stage into the filter
            try:
                plan = pkg.memplan.plan_memory(p)
            finally:
                if case == "fused_uint8":
                    p.stop()
            assert plan["unmodeled"] == []
            row = next(r for r in plan["rows"] if r["element"] == "f")
            rows.append(row)
            if pkg.port:
                assert row["graph_bytes"] == row["cublas_bytes"] == 0
                assert "graph_terms" not in row
        ref, got = rows
        assert {k: got[k] for k in self.SAME} == {k: ref[k] for k in self.SAME}
        assert [got[k] - ref[k] for k in self.APART] == [apart] * 3


class TestMemplanServing:
    SERVING = (
        "tensor_query_serversrc id=mp port=0 serve=1 serve-batch=4 "
        "serve-queue-depth=2048 caps=other/tensors,num-tensors=1,"
        "dimensions=1024:1024,types=float32,framerate=0/1 "
        "! {filt} ! tensor_query_serversink id=mp")

    def _serving(self, pkg, line):
        return pkg.memplan.plan_memory(pkg.parse_launch(
            line.format(filt=pkg.filt())))["serving"]

    def test_serving_holdings_billed(self, pkg):
        srv = self._serving(pkg, self.SERVING)
        assert len(srv) == 1 and srv[0]["element"].startswith(
            "tensor_query_serversrc")
        unit = 1024 * 1024 * 4
        assert srv[0]["unit_bytes"] == unit
        assert srv[0]["batch_bytes"] == 4 * unit
        assert srv[0]["queue_bytes"] == 2048 * unit

    def test_unbounded_queue_not_billed_as_finite(self, pkg):
        srv = self._serving(pkg, self.SERVING.replace(
            "serve-queue-depth=2048", "serve-queue-depth=0"))
        assert srv[0]["queue_bytes"] == 0

    def test_unset_depth_billed_at_scheduler_default(self, pkg):
        srv = self._serving(pkg, self.SERVING.replace(
            " serve-queue-depth=2048", ""))
        assert srv[0]["queue_depth"] == 64

    def test_packages_agree(self):
        """Equal holdings (the auto-named element aside: each package
        numbers its elements with its own counter)."""
        got = [[{k: v for k, v in row.items() if k != "element"}
                for row in self._serving(Pkg(n), self.SERVING)]
               for n in PKGS]
        assert got[0] == got[1]


class TestCompileCountParity:
    def _assert_parity(self, pkg, p):
        pred = pkg.cost.predict_compiles(p)
        checked = 0
        for e in p.elements.values():
            if not isinstance(e, pkg.TensorFilter) or e.fw is None:
                continue
            want = pred.get(e.name)
            if want is None:
                continue
            assert e.fw.compile_stats()["jit_traces"] == want, e.name
            checked += 1
        assert checked

    def test_flagship_fused_line(self, pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_U8} "
            "! tensor_transform mode=arithmetic "
            "option=typecast:float32,mul:2 "
            f"! {pkg.filt()} ! queue ! tensor_sink name=out")
        p.play()
        pkg.run(p, [pkg.Buffer(tensors=[np.ones((2, 4), np.uint8)])
                    for _ in range(3)])
        self._assert_parity(pkg, p)
        p.stop()

    def test_filter_chain(self, pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} ! {pkg.filt(name='f1')} "
            f"! queue ! {pkg.filt(name='f2', k=10)} ! tensor_sink name=out")
        p.play()
        pkg.run(p, [pkg.Buffer(tensors=[np.ones((2, 4), np.float32)])
                    for _ in range(4)])
        self._assert_parity(pkg, p)
        p.stop()

    def test_batch_padding_keeps_one_signature(self, pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} "
            f"! {pkg.filt('batch-size=2 feed-depth=2 fetch-window=2 ')} "
            "! tensor_sink name=out")
        p.play()
        pkg.run(p, [pkg.Buffer(tensors=[np.ones((2, 4), np.float32)])
                    for _ in range(3)])
        self._assert_parity(pkg, p)
        fname = next(n for n in p.elements if n.startswith("tensor_filter"))
        assert pkg.cost.predict_compiles(p) == {fname: 1}
        p.stop()

    def test_windowed_filter_one_build(self, pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} "
            f"! {pkg.filt('loop-window=4 ')} ! tensor_sink name=out")
        p.play()
        pkg.run(p, [pkg.Buffer(tensors=[np.ones((2, 4), np.float32)])
                    for _ in range(6)])
        self._assert_parity(pkg, p)
        p.stop()


class TestByteParity:
    CASES = {
        "single": (CAPS_F32, "", np.float32, 3, (96, 96)),
        "fused_uint8_up_f32_down": (
            CAPS_U8, "! tensor_transform mode=arithmetic "
            "option=typecast:float32,mul:2 ", np.uint8, 2, (16, 64)),
        "batched_padding": (CAPS_F32, None, np.float32, 3, (128, 128)),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_bytes(self, pkg, case):
        caps, pre, dtype, n, (h2d, d2h) = self.CASES[case]
        if pre is None:
            filt = pkg.filt("batch-size=2 feed-depth=2 fetch-window=2 ")
            pre = ""
        else:
            filt = pkg.filt()
        tail = "! queue " if case.startswith("fused") else ""
        p = pkg.parse_launch(f"appsrc name=src caps={caps} {pre}! {filt} "
                             f"{tail}! tensor_sink name=out")
        tracer = pkg.trace.attach(p)
        p.play()
        pkg.run(p, [pkg.Buffer(tensors=[np.ones((2, 4), dtype)])
                    for _ in range(n)])
        pred = pkg.residency.predict_crossings(p, n_buffers=n)
        mismatches = pkg.residency.parity_mismatches(pred,
                                                     tracer.crossings())
        p.stop()
        assert mismatches == []
        assert (pred["h2d_bytes"], pred["d2h_bytes"]) == (h2d, d2h)


class TestChurn:
    def test_nnst800_variable_shape_upstream(self, pkg):
        """f2's sink caps are the dynamic filter's FLEXIBLE output: every
        distinct runtime shape rebuilds f2's program."""
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} "
            f"! {pkg.filt('invoke-dynamic=true ')} "
            f"! tensor_filter name=f2 framework=jax model=passthrough "
            f"custom=aot:0 {pkg.cpu}! tensor_sink name=out")
        p.play()
        try:
            for _ in range(500):
                if p["f2"].sink_pads[0].caps is not None:
                    break
                time.sleep(0.01)
            assert pkg.cost._variable_shape_upstream(p["f2"])
            assert pkg.cost.predict_compiles(p)["f2"] is None
        finally:
            p.stop()

    def test_static_caps_are_not_variable(self, pkg):
        p = pkg.parse_launch(
            f"appsrc name=src caps={CAPS_F32} ! {pkg.filt(name='f')} "
            "! tensor_sink name=out")
        p.play()
        try:
            for _ in range(500):
                if p["f"].sink_pads[0].caps is not None:
                    break
                time.sleep(0.01)
            assert not pkg.cost._variable_shape_upstream(p["f"])
        finally:
            p.stop()


# -- the compiled method against the reference's ------------------------------

#: the reference's compiled cost dict's keys (costmodel.py:457-468)
COMPILED_KEYS = {"flops", "bytes_read", "bytes_written", "hbm_bytes",
                 "peak_live_bytes", "param_bytes", "input_bytes",
                 "output_bytes", "method", "weak_type_hazards"}


def _jax_compiled(model, custom, shape, dtype):
    from nnstreamer_tpu.filters.jax_filter import build_bundle

    bundle = build_bundle(model, custom)
    return nnstreamer_tpu.analysis.costmodel.program_cost(
        lambda p, *xs: bundle.apply_fn(p, *xs), bundle.params,
        [jax.ShapeDtypeStruct(shape, dtype)], method="compiled")


class TestCompiledAgainstReference:
    def test_add_exact_agreement(self):
        want = _jax_compiled("add", {"k": "1"}, (2, 4), np.float32)
        fn, module, _ = composition("add", {"k": "1"}, device="cpu")
        got = program_cost(fn, module, [ShapeDtype((2, 4), np.float32)],
                           method="compiled")
        meta = program_cost(*_add_program(),
                            [ShapeDtype((2, 4), np.float32)])
        assert got["flops"] == want["flops"] == meta["flops"] == 8
        assert COMPILED_KEYS <= set(got) and COMPILED_KEYS <= set(want)
        assert got["method"] == want["method"] == "compiled"
        assert (got["bytes_read"], got["bytes_written"]) == \
            (want["bytes_read"], want["bytes_written"]) == (32, 32)

    def test_mobilenet_v2_agreement(self):
        want = _jax_compiled("mobilenet_v2", {"seed": "0"},
                             (1, 224, 224, 3), np.uint8)
        fn, module, _ = composition("mobilenet_v2", {"seed": "0"},
                                    device="cpu")
        shapes = [ShapeDtype((1, 224, 224, 3), np.uint8)]
        got = program_cost(fn, module, shapes, method="compiled")
        meta = program_cost(*meta_composition("mobilenet_v2",
                                              {"seed": "0"})[:2], shapes)
        assert got["flops"] > 0 and want["flops"] > 0
        assert abs(got["flops"] - want["flops"]) / want["flops"] < 0.25
        assert abs(got["flops"] - meta["flops"]) / meta["flops"] < 0.25
        assert got["param_bytes"] == meta["param_bytes"] > 0
        assert got["peak_live_bytes"] > got["param_bytes"]


# -- NNST801: a python scalar widening stream data ----------------------------

WEAK_MODEL = (
    "from nnstreamer_tpu_torch.types import TensorsInfo\n"
    "def make_model(custom):\n"
    "    def apply_fn(params, x):\n"
    "        return x * 2.5  # python scalar: uint8 widened to float32\n"
    "    return (apply_fn, {}, TensorsInfo.from_strings('4:2', 'uint8'))\n")


class TestWeakType:
    def test_nnst801_python_scalar_promotion(self, tmp_path):
        from nnstreamer_tpu_torch.analysis import analyze_launch

        model = tmp_path / "weak.py"
        model.write_text(WEAK_MODEL)
        diags = analyze_launch(
            f"appsrc caps={CAPS_U8} ! tensor_filter framework=jax "
            f"model={model} custom=aot:0 ! tensor_sink", cost=True)
        d = [x for x in diags if x.code == "NNST801"]
        assert d and "promoted" in d[0].message
        assert "uint8 stream promoted to float32" in d[0].message

    def test_nnst801_clean_for_pinned_dtypes(self):
        from nnstreamer_tpu_torch.analysis import analyze_launch

        # model=add pins its scalar as a tensor of the stream's dtype
        diags = analyze_launch(
            f"appsrc caps={CAPS_U8} ! tensor_filter framework=jax "
            "model=add custom=k:1,aot:0 ! tensor_sink", cost=True)
        assert "NNST801" not in {x.code for x in diags}

    def test_explicit_casts_are_not_hazards(self):
        from nnstreamer_tpu_torch.analysis.costmodel import (
            weak_type_promotions,
        )

        def fn(params, x):
            return x.to(torch.float32) * 2.5 + (x * 2)  # cast, then float

        assert weak_type_promotions(
            fn, {}, [ShapeDtype((2, 4), np.uint8)]) == []
        assert weak_type_promotions(
            lambda p, x: x / 2, {}, [ShapeDtype((2, 4), np.int32)]) == [
            "int32 stream promoted to float32 by a python scalar "
            "(weak-type)"]
