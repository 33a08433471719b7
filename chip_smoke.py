"""Drive the PyTorch/CUDA port (nnstreamer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only slice,serve

Phases, each printing one JSON line:

  device     the card (nvidia-smi name and power limit), torch and CUDA
             versions, and the time it took to build the kernel library
             from csrc/ with nvcc;
  kernel     every hand-written kernel against its plain PyTorch version on
             the card, at the flagship path's shapes: max abs error against
             the stated tolerance, kernel and plain times (CUDA events
             around back-to-back calls, after warm-up), the kernel's own
             device time per launch from torch.profiler (device_ms: a
             kernel faster than its wrapper's host time is not timed by
             the wrapper) and the least time the card could take for the
             same work (bytes at 3.35 TB/s or operations at the peak rate
             for their type, whichever is larger). The fused block has one
             row per stride-1 block of MobileNet-v2 at batch 128, with its
             plan, registers, shared memory and CTAs per SM and the time of
             the same block as three cuDNN convolutions
             (inverted_residual_conv, timed only: cudnn_chain_ms), then a
             float32 row, a prime 113x113 row and a row summing the 13
             blocks (its bound is the sum of the per-block bounds); then
             the same rows at every stride-1 block shape of SSD-MobileNet
             -v2 at 300 px (13, batch 32) and DeepLab-v3 at 257 px (10,
             batch 16) with a sum per model, and normalize_u8 at the four
             vision lines' frames, bit-equal to its plain version;
  stride2    the 4 stride-2 blocks as the main path runs them
             (inverted_residual_conv) against the plain version they ran
             before, both timed;
  slice      the flagship image-labeling line through the port's
             parse_launch at full width (MobileNet-v2 1.0, 224x224 RGB,
             1001 classes, 128 frames per tensor): one label per frame,
             the fused-block kernel launched 13 times and normalize_u8 once
             per forward, the filter's logits against the same forward with
             the kernel's plain version in its place (mode 'plain'), the
             fused:xla forward's distance from it (reported), frames per
             second and p50 batch latency;
  profile    one more run of the line under torch.profiler: device time
             by kernel, the PyTorch elementwise kernels' sum and the
             device's idle share;
  transform  tensor_transform acceleration=device bit-equal to numpy;
             (the kernel phase also holds arith_chain bit-equal to its
             plain version for every input and output dtype, on all 256
             values of 8-bit inputs and all 65,536 of 16-bit ones, for the
             launch lines' chains, at a ragged size and an unaligned base);
  attention  the flash-attention kernel against its plain version (the
             blockwise recurrence at the kernel's 128-key blocks) at causal
             8x8192x128 (the stream line), 768x197x64 (ViT-S/16 at batch
             128), a ragged causal 3x1000x32 and 4x777x64 and a ragged
             non-causal 2x333x128 (each head dim on both mask paths), in
             float32 at the reference's test shapes, in bf16 and float32 at
             head dims 8, 16, 24, 48, 96 and 256 with ragged and unequal
             sequences, and in float32 at causal 8x4096x128: max error
             against the stated tolerance (float32 at 2e-5 abs + 2e-5
             rel, TF32 off); for the timed shapes kernel, device, plain and
             bound ms, and the time of torch's scaled_dot_product_attention
             at the same shape (library_ms, timed only); every line also
             gives the body and instantiation the kernel ran, its registers
             per thread, dynamic shared memory and resident CTAs per SM;
  stream     the long-context line (appsrc ! tensor_aggregator !
             tensor_filter model=stream_transformer ! tensor_sink) at seq
             8192, dim 1024, 8 heads, depth 4: 8 windows after 2 warm-up
             windows, windows and frames per second, p50 window latency,
             4 flash_attention launches per forward, the output against a
             twin of the model whose attention is the plain version; then
             a profile line of 2 more windows;
  chunk      the ring's chunk kernel against its plain version (the chunk
             recurrence at the kernel's 128-key blocks) at the stream line's
             sp=4 shard, 8x2048x128, on carries from an earlier hop: the
             diagonal, past, future and non-causal hops, and two ragged
             causal cases (3x1000x32 with offsets); then the diagonal, past,
             partly masked and future hops at 3x300x300 for head dims 8, 16,
             24, 48, 96 and 256 in bf16 and float32; a future hop leaves
             the carries bit-identical, the others hold acc/l, m and l
             within stated tolerances; kernel, device, plain and bound ms
             per timed hop;
  ring       ring_attention over make_mesh(sp=4, devices=[cuda:0] * 4) at
             causal 8x8192x128 against the same ring over the plain chunk
             update, cross-checked (with their own tolerance) against
             flash_attention_cuda, as is ulysses_attention at 1x8x8192x128;
             16 flash_chunk launches per ring call and 4 flash_attention
             per Ulysses call; ring, Ulysses, flash and SDPA ms; then the
             stream line's StreamTransformer on the filter's own weights
             with the ring as its attention (64 flash_chunk launches)
             against the filter's flash forward, and both forwards' ms;
             and a profile line of 5 ring calls;
  longctx    examples/long_context.py's three steps at its own sizes:
             its stream line (128 one-frame buffers to one window, dim 32,
             2 heads: bf16 at head_dim 16) against the plain-attention twin,
             with its flash_attention launch; ring attention on float32
             (2, 1024, 32) and Ulysses on float32 (2, 8, 1024, 32), causal,
             over make_mesh(sp=8, devices=[cuda:0] * 8), each against
             plain_attention at the reference's atol 3e-5 with its kernel's
             launches; then the reference tests' float32 ring (d 16 and 8)
             and Ulysses (d 16) shapes the same way;
  vit        the ViT-S/16 labeling line (224x224, depth 6, 1000 classes,
             128 frames per tensor): 6 flash_attention launches and 1
             normalize_u8 launch per forward, logits against the plain
             twin, frames per second and p50 batch latency;
  detect     the SSD line at full width (300x300 RGB, width 1.0, 91
             classes, 1917 anchors, fused:pallas, 32 frames per tensor)
             into bounding_boxes mobilenet-ssd with split-batch=32: one
             RGBA overlay per frame, the fused block launched 13 times and
             normalize_u8 once per forward, boxes and scores against the
             plain forward (the kernel's plain version in its place) held
             to the bf16 noise floor (the fused:xla forward's distance
             from the same plain forward: the kernel's mean distance at
             most half of it, its max distance and per-anchor class
             agreement no worse), the float32 forward's distance
             reported, frames/s and p50 batch latency; then the
             postproc:pp line into mobilenet-ssd-postprocess: its quads
             bit-equal to the post-process of the kernel forward's raw
             outputs, and their near agreement with the plain forward's
             quads no worse than the fused:xla forward's;
  segment    the DeepLab line (257x257, width 1.0, 21 classes, 16 frames
             per tensor) into image_segment tflite-deeplab: 10 fused-block
             launches and 1 normalize_u8 per forward, logits and per-pixel
             classes held to the noise floor as in detect, frames/s; the
             SSD and DeepLab lines each get a profile line of 4 more
             batches (device time by kernel, idle share);
  vision     PoseNet (257 px, 17 keypoints) into pose_estimation
             heatmap-offset and YOLOv8 (320 px, width 0.25, depth 0.34, 80
             classes) into bounding_boxes yolov8, 16 frames per tensor:
             output shapes, finiteness, one overlay per frame, one
             normalize_u8 per forward, frames/s;

  upload     the flagship line (fetch-window=4) at feed-depth 1, 2 and 4,
             each run twice (1, 2, 4, 4, 2, 1): frames per second per run
             with the median and spread per depth, p50 batch latency,
             labels equal to feed-depth=1's, and from the tracer one h2d
             crossing per batch and one d2h per fetch window at the filter
             (with their bytes), the upload-window and fetch-window
             residencies; then one run each at feed-depth 1 and 2 under
             trace.torch_profile: device busy ms and idle share, the
             kernels' streams, and every host-to-device copy by name
             (Pinned or Pageable), stream, count and ms — at feed-depth 2
             the input's upload must be pinned and off the kernels' stream;
             and one span-traced run each at feed-depth 1 and 2: the
             filter's own host ms per batch, its mean dispatch ms and at
             depth 2 the prefetch's staging copy (the h2d span);
  batch      the live-camera form of the line: tensor_converter
             frames-per-tensor=1 ! tensor_filter batch-size=32
             fetch-timeout-ms=50 fetch-window=auto, frames pushed one by
             one: labels equal to the frames-per-tensor=32 line's, the
             window auto settled on, frames per second; then 40 frames and
             no EOS, brought out only by the timer thread's quiescence
             flush, labels again equal;
  hostspans  the flagship and stream lines with a span tracer attached
             after warm-up: each element's host ms per batch (window), its
             chain's inclusive time from Tracer.report() and its own time
             from the span ring (Tracer.element_self_ms), the host-stack
             roll-up and the filter's crossings; both span traces and a
             trace.torch_profile trace of the flagship line checked by
             validate_chrome_trace;
  serve      the serving tier at full width: tensor_query_serversrc
             serve=1 serve-batch=32 serve-queue-depth=256 ! tensor_filter
             model=mobilenet_v2 (1.0, 224x224, 1001 classes) !
             tensor_query_serversink, 8 client pipelines (appsrc !
             tensor_query_client ! tensor_decoder image_labeling !
             tensor_sink) pushing 32 seeded frames each at once: every
             client gets exactly its own 32 replies in order, each label
             equal to the direct forward's at batch 32 on the same
             frames, and (a second run with no decoder) each reply's
             logits within 0.15 abs + 0.05 rel of it, while the same
             replies shifted by one row fall outside that band and each
             client's frames carry at least two labels (so a mis-sliced
             row would show; logits_bit_equal reported); 13 fused-block and
             1 normalize_u8 launches per served batch; the serving report
             (rows, sheds, replies, batch fill); requests/s and p50/p99
             request latency from client push to client sink; then a
             profile line of one more run (line=serve), a serve_overload
             line (open-loop Poisson arrivals over the 8 clients at twice
             the measured rate for 3 s, serve-queue-depth=32: queue-full
             sheds, every admitted request answered once by its own
             client, the first reply before the last push, admitted
             p50/p99 and goodput), and a serve_lines
             line (the three lines of examples/launch_lines_serving.txt
             as written, model=add, 4 clients x 8 requests: exact);

then one ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that last line. It needs a CUDA card: without one it exits 1 at once.

``--only`` runs the named phases alone (``serve`` needs ``slice`` for
its frames; ``stride2`` runs inside ``kernel``, the flagship's profile
inside ``slice``, the overload and reference lines inside ``serve``) and
ends after them, without the ``kernels`` and result lines.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (dense): bytes/s, bf16 and f32 ops/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

BATCH = 128
SIZE = 224
N_BATCHES = 8
FETCH_WINDOW = 4


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of fn(), after warm-up: the median over up to
    5 groups of back-to-back calls (``reps`` in all), each group timed by
    two CUDA events. Back to back, a kernel that takes longer than its
    host-side launch keeps the card busy, so this is its device time; a
    call whose host side is the slower (a launch that does no work) is
    timed by its host side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    groups = max(1, min(5, reps))
    per = max(1, reps // groups)
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, calls: int = 10):
    """Device time per launch of the kernels whose name contains
    ``kernel``, over ``calls`` calls of fn() under torch.profiler (after a
    warm-up call): the kernel's own time, which back-to-back ``cuda_ms``
    cannot separate from its wrapper's host time when the wrapper is the
    slower. The profiler now and then records no device activity for a
    window, so an empty window is traced again, up to 3 times; None when
    it never sees the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel in e.key):
                us += getattr(e, "self_device_time_total", 0) or 0
                count += e.count
        if count:
            return us / 1e3 / count
    return None


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(got, want, atol: float, rtol: float) -> bool:
    import torch

    return bool(torch.all((got.float() - want.float()).abs()
                          <= atol + rtol * want.float().abs()))


# -- phase: kernels against their plain versions ---------------------------

def check_elementwise(torch, results):
    from nnstreamer_tpu_torch.ops import (
        arith_chain,
        arith_chain_plain,
        normalize_u8,
        normalize_u8_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    ragged = torch.randint(0, 256, (1000003,), generator=gen, device="cuda",
                           dtype=torch.uint8)
    n = frames.numel()
    # normalize_u8: bit-equal to the plain version (same two roundings)
    for x, out in ((frames, torch.bfloat16), (frames, torch.float32),
                   (ragged, torch.float32)):
        k = normalize_u8(x, out_dtype=out)
        p = normalize_u8_plain(x, out_dtype=out)
        err = max_err(k, p)
        row = {"kernel": "normalize_u8", "shape": list(x.shape),
               "out": str(out).replace("torch.", ""), "max_abs_err": err,
               "tol": 0.0}
        if x is frames and out is torch.bfloat16:
            row["ms"] = cuda_ms(lambda: normalize_u8(x, out_dtype=out))
            row["device_ms"] = device_ms(
                torch, lambda: normalize_u8(x, out_dtype=out),
                "normalize_u8_kernel")
            row["plain_ms"] = cuda_ms(lambda: normalize_u8_plain(x, out_dtype=out))
            row["bound_ms"], row["bound_by"] = bound_ms(3 * n, 2 * n, "float32")
            results["normalize_u8"] = row
        emit("kernel", **row)
        if err != 0.0:
            raise AssertionError(f"normalize_u8 {row}")
    # arith_chain: the tensor_transform preamble and a clamp, bit-equal
    pre = [("add", -127.5), ("div", 127.5)]
    xf = torch.randn(BATCH * SIZE * SIZE * 3, generator=gen, device="cuda")
    cases = [(frames, pre, None, "preamble"),
             (xf, [], (-1.0, 1.0), "clamp"),
             (ragged, pre + [("mul", 3.0), ("add", 0.5)], (-2.0, 2.0),
              "ragged")]
    for x, ops, clamp, what in cases:
        k = arith_chain(x, ops, out_dtype=torch.float32, clamp=clamp)
        p = arith_chain_plain(x, ops, out_dtype=torch.float32, clamp=clamp)
        err = max_err(k, p)
        row = {"kernel": "arith_chain", "case": what, "shape": list(x.shape),
               "in": str(x.dtype).replace("torch.", ""), "max_abs_err": err,
               "tol": 0.0}
        if what == "preamble":
            row["ms"] = cuda_ms(lambda: arith_chain(x, ops, torch.float32))
            row["device_ms"] = device_ms(
                torch, lambda: arith_chain(x, ops, torch.float32),
                "arith_chain")
            row["plain_ms"] = cuda_ms(
                lambda: arith_chain_plain(x, ops, torch.float32))
            row["bound_ms"], row["bound_by"] = bound_ms(5 * n, 3 * n, "float32")
            results["arith_chain"] = row
        emit("kernel", **row)
        if err != 0.0:
            raise AssertionError(f"arith_chain {row}")
    check_arith_exhaustive(torch, gen)


#: the chains of the repo's launch lines (the tensor_transform preamble,
#: mul:2, mul:0.5, mul:0.1, add:1) and a clamp
ARITH_CHAINS = {
    "preamble": ([("add", -127.5), ("div", 127.5)], None),
    "mul2": ([("mul", 2.0)], None),
    "mul0.5": ([("mul", 0.5)], None),
    "mul0.1": ([("mul", 0.1)], None),
    "add1": ([("add", 1.0)], None),
    "preamble_clamp": ([("add", -127.5), ("div", 127.5)], (-0.5, 0.5)),
}


def _bits_equal(torch, a, b) -> bool:
    """Bit for bit where neither is NaN, and NaN at the same places (the
    NaN payload a conversion leaves is not the function's)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(ints)[~na], b.view(ints)[~nb]))


def check_arith_exhaustive(torch, gen):
    """arith_chain bit-equal to its plain version for every input and
    output dtype and every chain of ARITH_CHAINS: all 256 values of an
    8-bit input and all 65,536 of a 16-bit one (repeated to a ragged
    length), int32 and float32 samples with their extremes, each at an
    aligned base and at an unaligned one (x[1:], the element-by-element
    path)."""
    from nnstreamer_tpu_torch.ops import arith_chain, arith_chain_plain

    def tiled(values, reps):
        return torch.cat([values.repeat(reps), values[:37]])

    u8 = torch.arange(256, device="cuda", dtype=torch.int32)
    u16 = torch.arange(65536, device="cuda", dtype=torch.int32)
    i32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (300001,), generator=gen,
                        device="cuda", dtype=torch.int32)
    i32[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, 0, -1], device="cuda")
    f32 = torch.randn(300001, generator=gen, device="cuda") * 300.0
    f32[:8] = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0,
                            -0.0, 1e-40, 3.4e38, -3.4e38], device="cuda")
    inputs = {"uint8": tiled(u8.to(torch.uint8), 1000),
              "int8": tiled(u8.to(torch.uint8).view(torch.int8), 1000),
              "uint16": tiled(u16.to(torch.int16), 3).view(torch.uint16),
              "int16": tiled(u16.to(torch.int16), 3),
              "int32": i32, "float32": f32}
    checked, bad = 0, []
    for name, x in inputs.items():
        for out in (torch.float32, torch.bfloat16, torch.float16):
            for chain, (ops, clamp) in ARITH_CHAINS.items():
                for base in (x, x[1:]):
                    k = arith_chain(base, ops, out_dtype=out, clamp=clamp)
                    p = arith_chain_plain(base, ops, out_dtype=out,
                                          clamp=clamp)
                    checked += 1
                    if not _bits_equal(torch, k, p):
                        bad.append([name, str(out), chain,
                                    base.data_ptr() % 16,
                                    max_err(k[~torch.isnan(p.float())],
                                            p[~torch.isnan(p.float())])])
    emit("kernel", kernel="arith_chain", case="exhaustive",
         inputs={n: list(x.shape) for n, x in inputs.items()},
         outputs=["float32", "bfloat16", "float16"],
         chains=sorted(ARITH_CHAINS), calls=checked, bit_equal=not bad,
         mismatches=bad[:10])
    if bad:
        raise AssertionError(f"arith_chain not bit-equal: {bad[:10]}")


def _blocks(model, stride: int):
    """(index, H, W, folded) of the blocks with ``stride`` at SIZE (H, W:
    the block's input map)."""
    from nnstreamer_tpu_torch.ops.fused_block import fold_inverted_residual

    out, hw = [], SIZE // 2
    for i, blk in enumerate(model.blocks):
        if blk.stride == stride:
            out.append((i, hw, hw, fold_inverted_residual(blk)))
        hw = -(-hw // blk.stride)
    return out


def _block_work(B, H, W, fwc, stride: int = 1):
    """(bytes, operations) of one block: the input read once and the
    output written once in bf16, the weights once; 2 operations per
    multiply-add of the expand, depthwise and project."""
    Cin = fwc["w1"].shape[0] if "w1" in fwc else fwc["wd"].shape[1]
    Ch, Cout = fwc["wd"].shape[1], fwc["w2"].shape[1]
    Ho, Wo = -(-H // stride), -(-W // stride)
    nbytes = 2 * B * (H * W * Cin + Ho * Wo * Cout) + sum(
        v.numel() * v.element_size() for v in fwc.values())
    ops = 2.0 * B * ((H * W * Cin * Ch if "w1" in fwc else 0)
                     + Ho * Wo * (9 * Ch + Ch * Cout))
    return nbytes, ops


#: fused block, kernel against plain: both round at the same points, only
#: the order of the float32 sums differs, which flips an occasional bf16
#: rounding (1 ulp = 2^-8 relative) — allow 4
FUSED_TOL = 2.0 ** -6
#: stride-2 blocks, inverted_residual_conv against the plain version: the
#: convolutions round each conv's output to bf16 before its bias add and
#: cuDNN sums the depthwise products unrounded, two more roundings per
#: stage than the plain version's: a few bf16 ulps of values up to 8
STRIDE2_TOL = 2.0 ** -4


def _fused_row(torch, B, H, W, fw, gen, **label):
    """One block shape: the kernel against its plain version at batch B
    on random bf16 input, with its plan, registers, shared memory, CTAs
    per SM, times (kernel, profiler device, plain, the three-cuDNN-call
    chain) and bound. Emits the row; raises if the kernel disagrees."""
    from nnstreamer_tpu_torch.ops.fused_block import (
        _plan_tiles,
        cast_folded,
        fused_inverted_residual,
        fused_kernel_attributes,
        inverted_residual_conv,
        inverted_residual_plain,
    )

    fwc = cast_folded(fw, torch.bfloat16, "cuda")
    fwx = cast_folded(fw, torch.bfloat16, "cuda", torch.bfloat16)
    Cin = fwc["w1"].shape[0] if "w1" in fwc else fwc["wd"].shape[1]
    Ch, Cout = fwc["wd"].shape[1], fwc["w2"].shape[1]
    x = torch.randn((B, H, W, Cin), generator=gen, device="cuda")
    x = x.clamp(-3, 3).to(torch.bfloat16)
    k = fused_inverted_residual(x, fwc)
    p = inverted_residual_plain(x, fwc)
    err = max_err(k, p)
    ok = within(k, p, FUSED_TOL, FUSED_TOL)
    plan = _plan_tiles(H, W, Cin, Ch, Cout, 2, "w1" in fwc)
    row = {"kernel": "fused_inverted_residual", **label,
           "shape": [B, H, W, Cin, Ch, Cout], "dtype": "bfloat16",
           "max_abs_err": err, "atol": FUSED_TOL, "rtol": FUSED_TOL,
           "ok": ok, "plan": plan._asdict(),
           **fused_kernel_attributes(plan)}
    row["ms"] = cuda_ms(lambda: fused_inverted_residual(x, fwc))
    row["device_ms"] = device_ms(
        torch, lambda: fused_inverted_residual(x, fwc), "fused_ir_")
    row["plain_ms"] = cuda_ms(lambda: inverted_residual_plain(x, fwc),
                              reps=10, warmup=2)
    row["cudnn_chain_ms"] = cuda_ms(lambda: inverted_residual_conv(x, fwx))
    nbytes, ops = _block_work(B, H, W, fwc)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, "bfloat16")
    row["tflops"] = ops / row["ms"] / 1e9
    emit("kernel", **row)
    if not ok:
        raise AssertionError(f"fused block {label} at {row['shape']} "
                             f"disagrees: {err}")
    return row


def check_fused_block(torch, results):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import (
        MobileNetV2,
        init_weights,
    )
    from nnstreamer_tpu_torch.ops.fused_block import (
        _plan_tiles,
        cast_folded,
        fused_inverted_residual,
        fused_kernel_attributes,
        inverted_residual_plain,
    )

    model = MobileNetV2()
    init_weights(model, 0)
    blocks = _blocks(model, 1)
    if len(blocks) != 13:
        raise AssertionError(f"expected 13 stride-1 blocks, got {len(blocks)}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = ("ms", "device_ms", "plain_ms", "cudnn_chain_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    by = {"bytes": 0.0, "operations": 0.0}  # bound ms of each kind
    errs = []
    for i, H, W, fw in blocks:
        row = _fused_row(torch, BATCH, H, W, fw, gen, block=i)
        for key in keys:  # a sum with a missing term is None
            tot[key] = None if tot[key] is None or row[key] is None \
                else tot[key] + row[key]
        by[row["bound_by"]] += row["bound_ms"]
        errs.append(row["max_abs_err"])
    # one shape in float32 against a float32 plain version (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    i, H, W, fw = blocks[5]
    fwc = cast_folded(fw, torch.float32, "cuda")
    Cin = fwc["w1"].shape[0]
    x = torch.randn((BATCH, H, W, Cin), generator=gen, device="cuda")
    k = fused_inverted_residual(x, fwc, compute_dtype=torch.float32)
    p = inverted_residual_plain(x, fwc, compute_dtype=torch.float32)
    err = max_err(k, p)
    ok = within(k, p, 1e-4, 1e-4)
    plan = _plan_tiles(H, W, Cin, fwc["wd"].shape[1], fwc["w2"].shape[1], 4)
    emit("kernel", kernel="fused_inverted_residual", block=i,
         shape=list(x.shape), dtype="float32", max_abs_err=err, atol=1e-4,
         rtol=1e-4, ok=ok, plan=plan._asdict(),
         **fused_kernel_attributes(plan))
    if not ok:
        raise AssertionError(f"fused block f32 disagrees: {err}")
    errs.append(err)
    # a prime size: ragged row tiles, and Cout (80) across 5 fragment
    # columns; the JAX package's tiling gate would send it to XLA
    Cin, Ch, Cout = 8, 48, 80
    fw = {"w1": torch.randn((Cin, Ch), generator=gen, device="cuda") * 0.3,
          "b1": torch.randn((Ch,), generator=gen, device="cuda") * 0.2,
          "wd": torch.randn((9, Ch), generator=gen, device="cuda") * 0.3,
          "bd": torch.randn((Ch,), generator=gen, device="cuda") * 0.2,
          "w2": torch.randn((Ch, Cout), generator=gen, device="cuda") * 0.3,
          "b2": torch.randn((Cout,), generator=gen, device="cuda") * 0.2}
    fwc = cast_folded(fw, torch.bfloat16, "cuda")
    x = torch.randn((4, 113, 113, Cin), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = fused_inverted_residual(x, fwc)
    p = inverted_residual_plain(x, fwc)
    err = max_err(k, p)
    ok = within(k, p, FUSED_TOL, FUSED_TOL)
    plan = _plan_tiles(113, 113, Cin, Ch, Cout, 2)
    emit("kernel", kernel="fused_inverted_residual", block="prime",
         shape=[4, 113, 113, Cin, Ch, Cout], dtype="bfloat16",
         max_abs_err=err, atol=FUSED_TOL, rtol=FUSED_TOL, ok=ok,
         plan=plan._asdict(), **fused_kernel_attributes(plan))
    if not ok:
        raise AssertionError(f"fused block at 113x113 disagrees: {err}")
    errs.append(err)
    # the bound is the sum of per-block bounds (each block is bound by
    # bytes or by operations on its own); bound_by names the kind that
    # holds the larger part of it
    results["fused_inverted_residual"] = {
        "ms": tot["ms"], "device_ms": tot["device_ms"],
        "plain_ms": tot["plain_ms"], "cudnn_chain_ms": tot["cudnn_chain_ms"],
        "max_abs_err": max(errs), "bound_ms": tot["bound_ms"],
        "bound_by": max(by, key=by.get), "bound_ms_by_kind": by,
        "library_ms": None}
    emit("kernel", kernel="fused_inverted_residual", block="sum of 13",
         **results["fused_inverted_residual"])
    check_stride2(torch, model, gen)
    check_vision_blocks(torch, results, gen)


def check_stride2(torch, model, gen):
    """The 4 stride-2 blocks: the convolutions the main path runs
    (inverted_residual_conv) against the plain version they ran before,
    with both timed."""
    from nnstreamer_tpu_torch.ops.fused_block import (
        cast_folded,
        inverted_residual_conv,
        inverted_residual_plain,
    )

    blocks = _blocks(model, 2)
    if len(blocks) != 4:
        raise AssertionError(f"expected 4 stride-2 blocks, got {len(blocks)}")
    tot = {"conv_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for i, H, W, fw in blocks:
        fwc = cast_folded(fw, torch.bfloat16, "cuda")
        fwx = cast_folded(fw, torch.bfloat16, "cuda", torch.bfloat16)
        Cin = fwc["w1"].shape[0]
        x = torch.randn((BATCH, H, W, Cin), generator=gen, device="cuda")
        x = x.clamp(-3, 3).to(torch.bfloat16)
        got = inverted_residual_conv(x, fwx, stride=2)
        want = inverted_residual_plain(x, fwc, stride=2)
        ok = (tuple(got.shape) == tuple(want.shape)
              and within(got, want, STRIDE2_TOL, STRIDE2_TOL))
        nbytes, ops = _block_work(BATCH, H, W, fwc, stride=2)
        row = {"block": i, "shape": [BATCH, H, W, Cin, fwc["wd"].shape[1],
                                     fwc["w2"].shape[1]],
               "max_abs_err": max_err(got, want), "atol": STRIDE2_TOL,
               "rtol": STRIDE2_TOL, "ok": ok,
               "conv_ms": cuda_ms(lambda: inverted_residual_conv(
                   x, fwx, stride=2)),
               "plain_ms": cuda_ms(lambda: inverted_residual_plain(
                   x, fwc, stride=2), reps=10, warmup=2),
               "bound_ms": bound_ms(nbytes, ops, "bfloat16")[0]}
        emit("stride2", **row)
        if not ok:
            raise AssertionError(f"stride-2 block {i} disagrees: {row}")
        for key in tot:
            tot[key] += row[key]
    emit("stride2", block="sum of 4", **tot)


# -- phase: the flagship slice ---------------------------------------------

def _labeling_line(labels: str, model: str, custom: str) -> str:
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        f"! tensor_filter name=f framework=jax model={model} "
        f"custom={custom} fetch-window={FETCH_WINDOW} "
        f"! queue ! tensor_decoder mode=image_labeling option1={labels} "
        f"! tensor_sink name=out")


def _flagship(labels: str, fused: str = "pallas") -> str:
    return _labeling_line(labels, "mobilenet_v2",
                          f"seed:0,postproc:argmax,fused:{fused}")


def _drive(line, frames, n_batches, traced=False, spans=False):
    """Push n_batches of frames through a labeling line; returns
    (labels per batch, seconds, p50 batch latency ms, pipeline).
    ``traced`` attaches a tracer (aggregate counters; with ``spans``, the
    span ring too)."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(line)
    if traced:
        trace.attach(p, spans=spans)
    pushed, arrived = {}, {}
    p["out"].connect_new_data(
        lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
    p.play()
    t0 = time.perf_counter()
    for i in range(n_batches * BATCH):
        p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]], pts=i))
        pushed[i] = time.perf_counter()
    p["src"].end_of_stream()
    if not p.bus.wait_eos(600):
        raise TimeoutError("labeling line did not reach EOS")
    secs = time.perf_counter() - t0
    if p.bus.error is not None:
        raise RuntimeError(f"labeling line failed: {p.bus.error.data}")
    lat = [(arrived[k] - pushed[k]) * 1e3 for k in arrived]
    out = [b.meta["label"] for b in p["out"].collected]
    return out, secs, statistics.median(lat), p


def check_slice(torch, results, workdir):
    import numpy as np

    from nnstreamer_tpu_torch.models import get_model, preprocess_frames
    from nnstreamer_tpu_torch.models.mobilenet_v2 import _make_fused_apply
    from nnstreamer_tpu_torch.ops import _cuda

    labels = os.path.join(workdir, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    # frames of 4x4 blocks of flat colour, so they differ in content
    rng = np.random.default_rng(0)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    results["flag_labels"], results["flag_frames"] = labels, frames
    # warm-up run (cuDNN/cuBLAS plans, allocator) — not the measured one
    _, _, _, p = _drive(_flagship(labels), frames, 2)
    p.stop()
    _cuda.reset_launches()
    out, secs, p50, p = _drive(_flagship(labels), frames, N_BATCHES)
    launches = dict(_cuda.LAUNCHES)
    forward = p["f"].fw._bundle.apply_fn  # the filter's own forward
    module = p["f"].fw._bundle.module
    p.stop()
    n_frames = sum(len(b) for b in out)
    if len(out) != N_BATCHES or n_frames != N_BATCHES * BATCH:
        raise AssertionError(f"expected {N_BATCHES * BATCH} labels, got "
                             f"{n_frames} in {len(out)} buffers")
    names = {f"class{i}" for i in range(1001)}
    if not all(lab in names for b in out for lab in b):
        raise AssertionError("a label is not from the labels file")
    if launches["fused_inverted_residual"] != 13 * N_BATCHES or \
            launches["normalize_u8"] != N_BATCHES:
        raise AssertionError(f"launch counts per {N_BATCHES} forwards: "
                             f"{launches}")
    results["launches"] = launches
    # the filter's logits for one batch against the same folded forward
    # with the kernel's plain version in its place (mode 'plain'), on the
    # filter's own weights; the fused:xla forward (every block through the
    # convolutions, the JAX package's fused:xla) is compared with it too,
    # reported and not held to the kernel's tolerance: it rounds
    # differently in all 17 blocks, which random weights amplify
    x = torch.from_numpy(np.stack(frames)).cuda()
    with torch.inference_mode():
        got = forward(x).float()
        pre = preprocess_frames(x, "pm1", module.dtype)
        plain = _make_fused_apply(module, mode="plain")(pre).float()
        xla = get_model("mobilenet_v2", {"seed": "0", "fused": "xla"},
                        "cuda").apply_fn(x).float()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    ok = finite and within(got, plain, 0.15, 0.05)
    xla_agree = float((xla.argmax(-1) == plain.argmax(-1)).float().mean())
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    emit("slice", frames=n_frames, batches=len(out), seconds=secs,
         fps=n_frames / secs, p50_batch_latency_ms=p50,
         fetch_window=FETCH_WINDOW, launches=launches,
         logits_max_abs_err=max_err(got, plain), logits_atol=0.15,
         logits_rtol=0.05, logits_ok=ok, argmax_agreement=agree,
         xla_logits_max_abs_err=max_err(xla, plain),
         xla_argmax_agreement=xla_agree,
         distinct_labels=len({lab for b in out for lab in b}),
         card=results["card"])
    if not ok:
        raise AssertionError("filter logits disagree with the plain forward")
    profile_slice(torch, labels, frames)


def profile_slice(torch, labels, frames, n_batches: int = 4) -> None:
    """One more run of the line under torch.profiler."""
    def run():
        _, secs, _, p = _drive(_flagship(labels), frames, n_batches)
        p.stop()
        return secs

    emit("profile", line="flagship", batches=n_batches,
         **device_profile(torch, run))


def device_profile(torch, run) -> dict:
    """Device time by kernel name and the device's idle share over the wall
    time ``run()`` returns (first push to the last output). Device times
    are null when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs = run()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        by_name[e.key] = by_name.get(e.key, 0) + us
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = secs * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    elementwise = sum(v for k, v in by_name.items() if "elementwise" in k)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "elementwise_ms": elementwise / 1e3 if busy_ms else None,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "top_device": [{"name": k[:90], "ms": v / 1e3} for k, v in top]}


def check_transform(torch, results):
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    line = (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=1000/1 "
            f"! tensor_converter frames-per-tensor={BATCH} "
            "! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 "
            "acceleration=device ! tensor_sink name=out")
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2 * BATCH, SIZE, SIZE, 3), np.uint8)
    p = parse_launch(line)
    _cuda.reset_launches()
    p.play()
    for f in frames:
        p["src"].push_buffer(Buffer(tensors=[f]))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(300) or p.bus.error is not None:
        raise RuntimeError(f"transform line failed: {p.bus.error}")
    launches = _cuda.LAUNCHES["arith_chain"]
    got = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    p.stop()
    want = [(frames[i:i + BATCH].astype(np.float32) + -127.5) / 127.5
            for i in range(0, len(frames), BATCH)]
    equal = len(got) == len(want) and all(
        np.array_equal(g, w) for g, w in zip(got, want))
    emit("transform", buffers=len(got), bit_equal_numpy=equal,
         arith_chain_launches=launches)
    if not equal or launches < 1:
        raise AssertionError("transform line: not bit-equal or no launch")
    results["arith_launches"] = launches


# -- phase: the attention kernel against its plain version -----------------

#: |kernel - plain| <= ATTN_TOL + ATTN_TOL * |plain|: both round p to bf16
#: at the same running max (the same 128-key blocks, BLOCK_K) and the
#: output once; only the order of the float32 sums and exp's last bits
#: differ, which can flip a bf16 rounding of p or of the output (1 ulp =
#: 2^-8 relative) — allow 4
ATTN_TOL = 2.0 ** -6

#: the long-context line (examples/long_context.py) at the repo's causal
#: 8x8192x128 attention shape: head_dim 1024 / 8 = 128
STREAM = {"seq": 8192, "feat": 64, "dim": 1024, "depth": 4, "heads": 8}
STREAM_CHUNK = 512
#: ViT-S/16 (bench_suite.py, tools/mfu_table.py), depth 6
VIT = {"size": SIZE, "patch": 16, "depth": 6, "dim": 384, "heads": 6,
       "classes": 1000}
N_WARMUP = 2
#: model outputs against the plain-attention instance on the same weights:
#: the JAX package's bf16 tolerance for logits
#: (tests/test_fused_block.py::test_model_zoo_fused_custom)
MODEL_ATOL, MODEL_RTOL = 0.15, 0.05
#: least share of ViT frames whose argmax must agree with the plain twin:
#: random weights leave near-ties that a reordered float32 sum can flip
VIT_ARGMAX_FLOOR = 0.95


def _custom(cfg: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in cfg.items())


#: float32 attention, kernel against plain at the same 128-key blocks:
#: both products in float32 (the plain version's matmul with TF32 off),
#: only the order of the sums and exp's last bits differ
F32_ATOL = F32_RTOL = 2e-5
#: head dims of every kind: 8 and 16 the reference's ring and Ulysses
#: tests (16 also the tensor-core body's D 16), multiples of 8 and odd
#: widths that only the simple body takes in bf16 (its odd q row stride,
#: a partial 32-column K stage, V rows at stride d), and the largest the
#: kernels take
WIDE_DIMS = (1, 8, 16, 20, 24, 33, 48, 96, 100, 200, 256)
#: one timed shape for each instantiation the bf16 main-path shapes do
#: not reach (causal 8 heads x 4096, half the stream line's length): the
#: tensor-core body at D 16 (bf16, d 16), the simple body at D 32, 64, 128
#: and 256 (float32)
TIMED_WIDE = ((16, "bfloat16"), (32, "float32"), (64, "float32"),
              (128, "float32"), (256, "float32"))


def attention_work(bh: int, sq: int, sk: int, d: int, causal: bool,
                   q_offset: int = 0, k_offset: int = 0,
                   carries: bool = False, itemsize: int = 2):
    """(bytes, operations) one attention call needs: 4*d operations (two
    products) per (q, k) pair the mask keeps, at the global positions
    q_offset + i >= k_offset + j; q, k, v read once in their dtype
    (``itemsize`` bytes) and either o written once in it (a flash call)
    or, for a chunk update (``carries``), the float32 carries m, l, acc
    read and written once. A chunk no row sees needs nothing: its carries
    pass through."""
    import numpy as np

    if causal:
        pairs = int(np.clip(q_offset - k_offset + 1 + np.arange(sq), 0,
                            sk).sum())
    else:
        pairs = sq * sk
    if not carries:
        return itemsize * bh * d * (2 * sq + 2 * sk), 4.0 * bh * d * pairs
    if pairs == 0:
        return 0.0, 0.0
    return (bh * (itemsize * d * (sq + 2 * sk) + 8.0 * sq * (2 + d)),
            4.0 * bh * d * pairs)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tols(torch, dtype):
    return (ATTN_TOL, ATTN_TOL) if dtype == torch.bfloat16 else (F32_ATOL,
                                                                 F32_RTOL)


def check_attention(torch, results):
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.attention import (
        BLOCK_K,
        flash_attention_cuda,
        flash_attention_plain,
        flash_kernel_attributes,
    )

    # float32 products in float32 on both sides: the plain version's
    # matmul (and SDPA's, timed only) with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    hd = STREAM["dim"] // STREAM["heads"]
    vit_hd = VIT["dim"] // VIT["heads"]
    vit_tokens = (SIZE // VIT["patch"]) ** 2 + 1
    bf16, f32 = torch.bfloat16, torch.float32
    # (case, q shape, key length, causal, dtype, timed, on a main path)
    cases = [("stream", (STREAM["heads"], STREAM["seq"], hd), None, True,
              bf16, True, True),
             ("vit", (BATCH * VIT["heads"], vit_tokens, vit_hd), None, False,
              bf16, True, True),
             ("ragged", (3, 1000, 32), None, True, bf16, False, False),
             ("ragged64", (4, 777, 64), None, True, bf16, False, False),
             ("noncausal128", (2, 333, 128), None, False, bf16, False,
              False),
             # float32 at the reference's kernel tests (tests/test_ops.py)
             ("ref_f32", (2, 64, 128), None, False, f32, False, False),
             ("ref_f32_causal", (2, 64, 128), None, True, f32, False, False),
             ("ref_f32_lead", (2, 3, 32, 128), None, False, f32, False,
              False)]
    cases += [(f"timed_{dt}_d{d}", (8, 4096, d), None, True,
               getattr(torch, dt), True, False) for d, dt in TIMED_WIDE]
    for d in WIDE_DIMS:
        for dtype in (bf16, f32):
            cases += [(f"d{d}_causal", (3, 300, d), None, True, dtype, False,
                       False),
                      (f"d{d}_unequal", (2, 257, d), 130, False, dtype,
                       False, False)]
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0.0, "ops": 0.0, "err": 0.0}
    for case, shape, sk, causal, dtype, timed, main in cases:
        *lead, s, d = shape
        kshape = (*lead, sk or s, d)
        q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(kshape, generator=gen, device="cuda").to(dtype)
                for _ in range(2))

        def kern():
            return flash_attention_cuda(q, k, v, causal=causal)

        def plain():
            return flash_attention_plain(q, k, v, causal=causal,
                                         block_k=BLOCK_K)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_err(got, want)
        atol, rtol = _tols(torch, dtype)
        ok = (got.dtype == dtype and bool(torch.isfinite(got.float()).all())
              and within(got, want, atol, rtol))
        row = {"kernel": "flash_attention", "case": case,
               "shape": list(shape), "sk": kshape[-2], "causal": causal,
               "dtype": _dtype_name(dtype), "block_k": BLOCK_K,
               "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
               **flash_kernel_attributes(d, dtype=dtype)}
        if timed:
            def library():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal)

            bh = shape[0]
            nbytes, ops = attention_work(bh, s, kshape[-2], d, causal,
                                         itemsize=q.element_size())
            row["ms"] = cuda_ms(kern)
            row["device_ms"] = device_ms(torch, kern, "flash_fwd")
            row["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
            row["library_ms"] = cuda_ms(library)
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, ops, _dtype_name(dtype))
            row["tflops"] = ops / row["ms"] / 1e9
            if main:
                for key in ("ms", "device_ms", "plain_ms", "library_ms"):
                    tot[key] = None if tot[key] is None or row[key] is None \
                        else tot[key] + row[key]
                tot["bytes"] += nbytes
                tot["ops"] += ops
        emit("attention", **row)
        if not ok:
            raise AssertionError(f"flash_attention disagrees: {row}")
        tot["err"] = max(tot["err"], err)
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], "bfloat16")
    results["flash_attention"] = {
        "ms": tot["ms"], "device_ms": tot["device_ms"],
        "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
        "max_abs_err": tot["err"], "bound_ms": b_ms, "bound_by": b_by}


def _plain_twin(module, cls, cfg):
    """A second instance of the filter's model with the kernel's plain
    version as its attention, on the same weights: the oracle."""
    import functools

    from nnstreamer_tpu_torch.ops.attention import (
        BLOCK_K,
        flash_attention_plain,
    )

    twin = cls(**cfg, attention=functools.partial(flash_attention_plain,
                                                  block_k=BLOCK_K))
    twin.load_state_dict(module.state_dict())
    return twin.to("cuda").eval()


# -- phase: the long-context stream line -----------------------------------

def _stream_line() -> str:
    feat, seq = STREAM["feat"], STREAM["seq"]
    return (f"appsrc name=src caps=other/tensors,format=static,"
            f"dimensions={feat}:{STREAM_CHUNK},types=float32 "
            f"! tensor_aggregator name=agg frames_in={STREAM_CHUNK} "
            f"frames_out={seq} "
            f"frames_dim=1 ! tensor_filter name=f framework=jax "
            f"model=stream_transformer custom=seed:0,{_custom(STREAM)} "
            f"! tensor_sink name=out")


class _LineDriver:
    """A launch line, open across its runs: each unit is a list of
    buffers (a window's chunks, a batch's frames) whose push yields
    ``outputs_per_unit`` buffers at the sink; :meth:`run` pushes whole
    units and waits for their outputs. ``spans`` attaches a span tracer
    now; :meth:`attach` does it between runs (after a warm-up)."""

    def __init__(self, line, chunks, outputs_per_unit=1, spans=False):
        from nnstreamer_tpu_torch import trace
        from nnstreamer_tpu_torch.pipeline import parse_launch

        self.chunks = chunks
        self.per_unit = outputs_per_unit
        self.p = parse_launch(line)
        self.arrived = []
        self.p["out"].connect_new_data(
            lambda b: self.arrived.append(time.perf_counter()))
        if spans:
            trace.attach(self.p, spans=True)
        self.p.play()
        self.pts = 0

    def attach(self):
        from nnstreamer_tpu_torch import trace

        return trace.attach(self.p, spans=True)

    def run(self, n_units: int):
        """Push n_units units; returns (seconds from the first push to
        the last output, p50 ms from a unit's last push to its output)."""
        from nnstreamer_tpu_torch.buffer import Buffer

        start = len(self.arrived)
        last_push = []
        t0 = time.perf_counter()
        for _ in range(n_units):
            for c in self.chunks:
                self.p["src"].push_buffer(Buffer(tensors=[c], pts=self.pts))
                self.pts += 1
            last_push.append(time.perf_counter())
        want = start + n_units * self.per_unit
        deadline = time.monotonic() + 600
        while len(self.arrived) < want:
            if self.p.bus.error is not None:
                raise RuntimeError(f"line failed: {self.p.bus.error.data}")
            if time.monotonic() > deadline:
                raise TimeoutError("line: outputs did not arrive")
            time.sleep(0.001)
        secs = self.arrived[-1] - t0
        ends = self.arrived[start + self.per_unit - 1::self.per_unit]
        lat = [(a - b) * 1e3 for a, b in zip(ends, last_push)]
        return secs, statistics.median(lat)

    def close(self):
        self.p["src"].end_of_stream()
        if not self.p.bus.wait_eos(120) or self.p.bus.error is not None:
            raise RuntimeError(f"line failed at EOS: {self.p.bus.error}")
        outs = [b.tensors[0] for b in self.p["out"].collected]
        self.p.stop()
        return outs


class _StreamDriver(_LineDriver):
    """The stream line: one unit is one window's 512-frame chunks."""

    def __init__(self, window, spans=False):
        super().__init__(_stream_line(),
                         [window[i:i + STREAM_CHUNK]
                          for i in range(0, len(window), STREAM_CHUNK)],
                         spans=spans)


def check_stream(torch, results):
    import numpy as np

    from nnstreamer_tpu_torch.models.vit import StreamTransformer
    from nnstreamer_tpu_torch.ops import _cuda

    seq, feat = STREAM["seq"], STREAM["feat"]
    window = np.random.default_rng(3).normal(
        size=(seq, feat)).astype(np.float32)
    drv = _StreamDriver(window)
    drv.run(N_WARMUP)
    _cuda.reset_launches()
    secs, p50 = drv.run(N_BATCHES)
    launches = dict(_cuda.LAUNCHES)
    if launches["flash_attention"] != STREAM["depth"] * N_BATCHES:
        raise AssertionError(f"stream: launch counts per {N_BATCHES} "
                             f"forwards: {launches}")
    results["stream_launches"] = launches
    prof = device_profile(torch, lambda: drv.run(N_WARMUP)[0])
    bundle = drv.p["f"].fw._bundle  # the filter's own model
    results["stream_module"], results["stream_window"] = bundle.module, window
    outs = drv.close()
    # the filter's forward on one window against the plain-attention twin
    twin = _plain_twin(bundle.module, StreamTransformer, STREAM)
    x = torch.from_numpy(window).cuda()
    with torch.inference_mode():
        got = bundle.apply_fn(x).float()
        want = twin(x[None]).float()
    torch.cuda.synchronize()
    last = np.asarray(outs[-1])
    finite = bool(torch.isfinite(got).all()) and bool(np.isfinite(last).all())
    ok = (finite and tuple(got.shape) == (1, seq, feat)
          and last.shape == (1, seq, feat)
          and within(got, want, MODEL_ATOL, MODEL_RTOL))
    emit("stream", windows=N_BATCHES, frames=N_BATCHES * seq, seconds=secs,
         windows_per_s=N_BATCHES / secs, frames_per_s=N_BATCHES * seq / secs,
         p50_window_latency_ms=p50, launches=launches,
         out_max_abs_err=max_err(got, want), out_atol=MODEL_ATOL,
         out_rtol=MODEL_RTOL, out_ok=ok, finite=finite,
         outputs=len(outs), card=results["card"])
    emit("profile", line="stream", windows=N_WARMUP, **prof)
    if not ok:
        raise AssertionError("stream output disagrees with the plain "
                             "forward or is not finite")


# -- phase: the ring's chunk kernel against its plain version --------------

#: the stream line's attention (causal 8x8192x128) over an sp=4 mesh on the
#: one card: 4 shards of 2048, 16 chunk launches per ring call, 4 on the
#: diagonal, 6 in the past and 6 in the masked future
SP = 4
#: chunk carries, kernel against plain from the same carries: m is a max of
#: float32 dot products of 128 bf16 pairs summed in another order, so it
#: moves by a few float32 ulps of those sums; l sums the same float32 exps
#: in another order, at an m that moved by that much: both far inside
#: 1e-4. acc / l, the hop's output, is held at ATTN_TOL, as the flash kernel
CHUNK_M_ATOL = 1e-4
CHUNK_L_RTOL = 1e-4
#: ring (or Ulysses) against flash_attention_cuda on the same q/k/v: the ring
#: folds a row's keys in another order (its diagonal chunk first, then the
#: earlier ones), so every p is rounded to bf16 at another running max, not
#: only a few: |Δ| <= 2^-9 max|v| (p's rounding) + 2 bf16 ulps of the output;
#: 2^-5 absolute and relative holds that with room for max|v| up to 8
XCHECK_TOL = 2.0 ** -5


def _carries(torch, bh, sq, d):
    return (torch.full((bh, sq), -1e30, device="cuda"),
            torch.zeros((bh, sq), device="cuda"),
            torch.zeros((bh, sq, d), device="cuda"))


def check_chunk(torch, results):
    from nnstreamer_tpu_torch.ops.attention import (
        BLOCK_K,
        flash_chunk_cuda,
        flash_chunk_plain,
        flash_kernel_attributes,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    bh, n = STREAM["heads"], STREAM["seq"] // SP
    d = STREAM["dim"] // STREAM["heads"]
    bf16, f32 = torch.bfloat16, torch.float32

    # (case, q/k/v/earlier-chunk shapes, q_offset, k_offset, causal, dtype,
    # timed): the ring's shard 2 at its hops, on carries from an earlier hop
    # over a past chunk, so they are non-zero; then two ragged causal cases,
    # the second with its first q tiles wholly before the chunk; then every
    # hop at every head dim of WIDE_DIMS in both dtypes, ragged: the
    # diagonal, a past chunk, one whose first rows see none of it, and one
    # wholly in the future
    cases = [("diagonal", (bh, n, n, d), 2 * n, 2 * n, True, bf16, True),
             ("past", (bh, n, n, d), 2 * n, n, True, bf16, True),
             ("future", (bh, n, n, d), 2 * n, 3 * n, True, bf16, True),
             ("noncausal", (bh, n, n, d), 2 * n, n, False, bf16, True),
             ("ragged", (3, 1000, 1000, 32), 1000, 700, True, bf16, False),
             ("ragged_head", (3, 1000, 1000, 32), 0, 300, True, bf16, False)]
    for hd in WIDE_DIMS:
        for dtype in (bf16, f32):
            name = f"{_dtype_name(dtype)}_d{hd}"
            cases += [(f"{name}_diagonal", (3, 300, 300, hd), 300, 300, True,
                       dtype, False),
                      (f"{name}_past", (3, 300, 300, hd), 600, 0, True, dtype,
                       False),
                      (f"{name}_masked", (3, 300, 300, hd), 0, 150, True,
                       dtype, False),
                      (f"{name}_future", (3, 300, 300, hd), 0, 300, True,
                       dtype, False)]
    rows = {}
    for case, (b, sq, sk, hd), q_off, k_off, causal, dtype, timed in cases:
        q, k, v, k0, v0 = (torch.randn((b, s, hd), generator=gen,
                                       device="cuda").to(dtype)
                           for s in (sq, sk, sk, sk, sk))
        scale = 1.0 / hd ** 0.5
        kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, scale=scale)
        carries = flash_chunk_plain(
            q, k0, v0, *_carries(torch, b, sq, hd), q_offset=q_off,
            k_offset=q_off - sk if causal else 0, causal=causal, scale=scale)
        before = [c.clone() for c in carries]
        got = flash_chunk_cuda(q, k, v, *[c.clone() for c in carries], **kw)
        want = flash_chunk_plain(q, k, v, *carries, block_k=BLOCK_K, **kw)
        torch.cuda.synchronize()
        out_got, out_want = (c[2] / c[1].clamp(min=1e-37)[..., None]
                             for c in (got, want))
        err = max_err(out_got, out_want)
        m_err = max_err(got[0], want[0])
        l_rel = float(((got[1] - want[1]).abs()
                       / want[1].abs().clamp(min=1e-30)).max())
        finite = all(bool(torch.isfinite(c).all()) for c in got)
        atol, rtol = _tols(torch, dtype)
        m_atol, l_rtol = ((CHUNK_M_ATOL, CHUNK_L_RTOL) if dtype == bf16
                          else (F32_ATOL, F32_RTOL))
        future = case.endswith("future")
        if future:
            same = all(torch.equal(g.view(torch.int32), c.view(torch.int32))
                       for g, c in zip(got, before))
            ok = same and all(torch.equal(w, c) for w, c in zip(want, before))
        else:
            ok = (finite and within(out_got, out_want, atol, rtol)
                  and m_err <= m_atol and l_rel <= l_rtol)
        row = {"kernel": "flash_chunk", "case": case, "shape": [b, sq, sk, hd],
               "q_offset": q_off, "k_offset": k_off, "causal": causal,
               "dtype": _dtype_name(dtype), "block_k": BLOCK_K,
               "max_abs_err": err, "atol": atol, "rtol": rtol,
               "m_max_abs_err": m_err, "m_atol": m_atol,
               "l_max_rel_err": l_rel, "l_rtol": l_rtol, "ok": ok,
               **flash_kernel_attributes(hd, carry=True, dtype=dtype)}
        if future:
            row["bit_identical"] = ok
        if timed:
            work = [c.clone() for c in carries]

            def kern():
                return flash_chunk_cuda(q, k, v, *work, **kw)

            row["ms"] = cuda_ms(kern)
            row["device_ms"] = device_ms(torch, kern, "flash_chunk")
            row["plain_ms"] = cuda_ms(lambda: flash_chunk_plain(
                q, k, v, *carries, block_k=BLOCK_K, **kw), reps=5, warmup=1)
            nbytes, ops = attention_work(b, sq, sk, hd, causal, q_off, k_off,
                                         carries=True,
                                         itemsize=q.element_size())
            row["bytes"], row["ops"] = nbytes, ops
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, ops, _dtype_name(dtype))
            row["tflops"] = ops / row["ms"] / 1e9
            row["library_ms"] = None
        emit("chunk", **row)
        if not ok:
            raise AssertionError(f"flash_chunk disagrees: {row}")
        rows[case] = row
    # the kernels line: one ring call's 16 hops at the stream shape (a
    # future hop's device time is its CTAs' early return; the profiler may
    # see none of it, and the sum is then null)
    hops = {"diagonal": SP, "past": SP * (SP - 1) // 2,
            "future": SP * (SP - 1) // 2}
    tot = {key: sum(rows[c][key] * k for c, k in hops.items())
           for key in ("ms", "plain_ms", "bytes", "ops")}
    dev = [rows[c]["device_ms"] for c in hops]
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], "bfloat16")
    results["flash_chunk"] = {
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "library_ms": None,
        "device_ms": None if None in dev else sum(
            x * k for x, k in zip(dev, hops.values())),
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "bound_ms": b_ms, "bound_by": b_by, "hops": hops}


# -- phase: sequence-parallel attention over an sp mesh on the card --------

def check_ring(torch, results):
    import functools

    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models.vit import StreamTransformer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention_cuda,
        ring_attention,
        ring_attention_plain,
        ulysses_attention,
    )
    from nnstreamer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(sp=SP, devices=[torch.device("cuda", 0)] * SP)
    gen = torch.Generator(device="cuda").manual_seed(6)
    bh, s = STREAM["heads"], STREAM["seq"]
    d = STREAM["dim"] // STREAM["heads"]
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))

    def ring():
        return ring_attention(q, k, v, mesh, "sp", causal=True)

    def plain():
        return ring_attention_plain(q, k, v, mesh, "sp", causal=True)

    def flash():
        return flash_attention_cuda(q, k, v, causal=True)

    def ulysses():
        return ulysses_attention(q[None], k[None], v[None], mesh, "sp",
                                 causal=True)

    def library():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True)

    _cuda.reset_launches()
    got = ring()
    torch.cuda.synchronize()
    ring_launches = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    uly = ulysses()[0]
    torch.cuda.synchronize()
    uly_launches = dict(_cuda.LAUNCHES)
    want, ref = plain(), flash()
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and within(
        got, want, ATTN_TOL, ATTN_TOL)
    x_ok = within(got, ref, XCHECK_TOL, XCHECK_TOL)
    u_ok = within(uly, ref, XCHECK_TOL, XCHECK_TOL)
    counts_ok = (ring_launches["flash_chunk"] == SP * SP
                 and ring_launches["flash_attention"] == 0
                 and uly_launches["flash_attention"] == SP
                 and uly_launches["flash_chunk"] == 0)
    row = {"shape": [bh, s, d], "causal": True, "dtype": "bfloat16",
           "sp": SP, "devices": [str(dv) for dv in mesh.axis_devices("sp")],
           "max_abs_err_vs_plain_ring": err, "atol": ATTN_TOL,
           "rtol": ATTN_TOL, "ok": ok,
           "max_abs_err_vs_flash": max_err(got, ref),
           "ulysses_max_abs_err_vs_flash": max_err(uly, ref),
           "ulysses_bit_equal_flash": bool(torch.equal(uly, ref)),
           "xcheck_tol": XCHECK_TOL, "xcheck_ok": x_ok and u_ok,
           "ring_launches": ring_launches, "ulysses_launches": uly_launches,
           "ring_ms": cuda_ms(ring, reps=10),
           "plain_ring_ms": cuda_ms(plain, reps=1, warmup=1),
           "ulysses_ms": cuda_ms(ulysses, reps=10),
           "flash_ms": cuda_ms(flash, reps=10),
           "sdpa_ms": cuda_ms(library, reps=10), "card": results["card"]}
    emit("ring", **row)
    if not (ok and x_ok and u_ok and counts_ok):
        raise AssertionError(f"ring/ulysses: {row}")

    def five_rings():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            ring()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    emit("profile", line="ring", calls=5, **device_profile(torch, five_rings))

    # the stream transformer at full width with the ring as its attention,
    # on the filter's own weights, against the filter's (flash) forward
    flash_model = results["stream_module"]
    ring_model = StreamTransformer(**STREAM, attention=functools.partial(
        ring_attention, mesh=mesh, axis_name="sp"))
    ring_model.load_state_dict(flash_model.state_dict())
    ring_model = ring_model.to("cuda").eval()
    x = torch.from_numpy(results["stream_window"]).cuda()[None]
    with torch.inference_mode():
        want = flash_model(x).float()
        _cuda.reset_launches()
        got = ring_model(x).float()
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        ring_fwd_ms = cuda_ms(lambda: ring_model(x), reps=5, warmup=1)
        flash_fwd_ms = cuda_ms(lambda: flash_model(x), reps=5, warmup=1)
    ok = (bool(torch.isfinite(got).all())
          and tuple(got.shape) == (1, STREAM["seq"], STREAM["feat"])
          and within(got, want, MODEL_ATOL, MODEL_RTOL))
    emit("ring", model="stream_transformer", sp=SP, launches=launches,
         out_max_abs_err=max_err(got, want), out_atol=MODEL_ATOL,
         out_rtol=MODEL_RTOL, out_ok=ok, ring_forward_ms=ring_fwd_ms,
         flash_forward_ms=flash_fwd_ms, card=results["card"])
    if not ok or launches["flash_chunk"] != SP * SP * STREAM["depth"] \
            or launches["flash_attention"] != 0:
        raise AssertionError(f"ring stream transformer: {launches}, ok={ok}")
    results["ring_launches"] = launches


# -- phase: examples/long_context.py on the card ----------------------------

#: the example's stream line (bf16, dim 32 over 2 heads: head_dim 16)
LONGCTX = {"seq": 128, "feat": 16, "dim": 32, "depth": 1, "heads": 2}
#: the example's sequence-parallel steps: sp=8 on one card, float32
LONGCTX_SP = 8
#: float32 ring and Ulysses against plain attention: the reference's
#: tolerance (tests/test_ops.py TestRingAttention, TestUlyssesAttention)
SP_F32_ATOL = 3e-5


def check_longctx(torch, results):
    """The three steps of examples/long_context.py at its own sizes through
    the port: the stream line (128 one-frame buffers aggregated to one
    window, the stream transformer at dim 32, 2 heads, bf16) against its
    plain-attention twin; ring_attention on float32 (2, 1024, 32) and
    ulysses_attention on float32 (2, 8, 1024, 32), causal, over
    make_mesh(sp=8, devices=[cuda:0] * 8), against plain_attention. The
    data are the example's own (numpy default_rng(0), q = k = v). Then
    the reference's float32 ring and Ulysses test shapes the same way, and
    ring and Ulysses at every head dim of WIDE_DIMS in both dtypes: float32
    against plain_attention, bf16 against the plain ring and the plain
    flash forward at BLOCK_K (p rounded at the same blocks) at ATTN_TOL."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.models.vit import StreamTransformer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.ops.attention import (
        BLOCK_K,
        flash_attention_plain,
        flash_kernel_attributes,
        plain_attention,
        ring_attention,
        ring_attention_plain,
        ulysses_attention,
    )
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.pipeline import parse_launch

    torch.backends.cuda.matmul.allow_tf32 = False
    seq, feat = LONGCTX["seq"], LONGCTX["feat"]
    rng = np.random.default_rng(0)
    frames = [rng.normal(size=feat).astype(np.float32) for _ in range(seq)]
    p = parse_launch(
        f"appsrc name=src caps=other/tensors,format=static,dimensions={feat},"
        f"types=float32 ! tensor_aggregator frames_in=1 frames_out={seq} "
        f"frames_dim=1 ! tensor_filter name=f framework=jax "
        f"model=stream_transformer custom=seed:0,{_custom(LONGCTX)} "
        f"! tensor_sink name=out")
    p.play()
    _cuda.reset_launches()
    for f in frames:
        p["src"].push_buffer(Buffer(tensors=[f]))
    buf = p["out"].pull(timeout=300.0)
    launches = dict(_cuda.LAUNCHES)
    bundle = p["f"].fw._bundle
    p.stop()
    if buf is None:
        raise AssertionError("longctx: the stream line gave no output")
    got = torch.as_tensor(np.asarray(buf.tensors[0])).float()
    twin = _plain_twin(bundle.module, StreamTransformer, LONGCTX)
    with torch.inference_mode():
        want = twin(torch.from_numpy(np.stack(frames)).cuda()[None])
    want = want.float().cpu()
    ok = (tuple(got.shape) == (1, seq, feat)
          and bool(torch.isfinite(got).all())
          and within(got, want, MODEL_ATOL, MODEL_RTOL)
          and launches["flash_attention"] == LONGCTX["depth"])
    hd = LONGCTX["dim"] // LONGCTX["heads"]
    emit("longctx", step="stream_line", shape=list(got.shape), head_dim=hd,
         dtype="bfloat16", launches=launches,
         out_max_abs_err=max_err(got, want), out_atol=MODEL_ATOL,
         out_rtol=MODEL_RTOL, ok=ok,
         kernel=flash_kernel_attributes(hd, dtype=torch.bfloat16))
    if not ok:
        raise AssertionError(f"longctx stream line: {launches}")
    total = launches

    mesh = make_mesh(sp=LONGCTX_SP,
                     devices=[torch.device("cuda", 0)] * LONGCTX_SP)
    q = torch.from_numpy(rng.normal(size=(2, 1024, 32))).float().cuda()
    qh = torch.from_numpy(rng.normal(size=(2, 8, 1024, 32))).float().cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def plain_ring(a, b, c, causal):
        return ring_attention_plain(a, b, c, mesh, "sp", causal=causal)

    def plain_flash(a, b, c, causal):
        return flash_attention_plain(a, b, c, causal=causal, block_k=BLOCK_K)

    # (step, function, q = k = v or three tensors, causal, launch counted,
    # plain version); float32 against plain_attention at SP_F32_ATOL
    steps = [("ring", ring_attention, (q, q, q), True, "flash_chunk",
              plain_attention),
             ("ulysses", ulysses_attention, (qh, qh, qh), True,
              "flash_attention", plain_attention)]
    for causal in (False, True):
        steps += [(f"ref_ring_d16_{'causal' if causal else 'full'}",
                   ring_attention, [randn((2, 256, 16)) for _ in range(3)],
                   causal, "flash_chunk", plain_attention),
                  (f"ref_ulysses_d16_{'causal' if causal else 'full'}",
                   ulysses_attention,
                   [randn((2, 8, 256, 16)) for _ in range(3)], causal,
                   "flash_attention", plain_attention)]
    steps.append(("ref_ring_d8_long", ring_attention,
                  [randn((1, 1024, 8)) for _ in range(3)], False,
                  "flash_chunk", plain_attention))
    for hd in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{_dtype_name(dtype)}_d{hd}"
            f32 = dtype == torch.float32
            steps += [(f"ring_{name}", ring_attention,
                       [randn((2, 256, hd), dtype) for _ in range(3)], True,
                       "flash_chunk", plain_attention if f32 else plain_ring),
                      (f"ulysses_{name}", ulysses_attention,
                       [randn((2, 8, 256, hd), dtype) for _ in range(3)],
                       True, "flash_attention",
                       plain_attention if f32 else plain_flash)]
    for step, fn, (a, b, c), causal, kernel, plain in steps:
        _cuda.reset_launches()
        out = fn(a, b, c, mesh, "sp", causal=causal)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        ref = plain(a, b, c, causal=causal)
        if a.dtype == torch.float32:
            atol, rtol = SP_F32_ATOL, 0.0
        else:
            atol = rtol = ATTN_TOL
        ok = (out.shape == a.shape and out.dtype == a.dtype
              and bool(torch.isfinite(out.float()).all())
              and within(out, ref, atol, rtol) and launches[kernel] > 0)
        row = {"step": step, "shape": list(a.shape), "causal": causal,
               "dtype": _dtype_name(a.dtype), "sp": LONGCTX_SP,
               "launches": launches, "plain": plain.__name__,
               "max_abs_err_vs_plain": max_err(out, ref),
               "atol": atol, "rtol": rtol, "ok": ok}
        if step in ("ring", "ulysses"):
            def call():
                return fn(a, b, c, mesh, "sp", causal=causal)

            row["ms"] = cuda_ms(call, reps=5, warmup=1)
            # the kernel's own time per launch, and its instantiation
            row["kernel_device_ms"] = device_ms(
                torch, call, "flash_chunk" if step == "ring" else "flash_fwd",
                calls=2)
            row["kernel"] = flash_kernel_attributes(
                a.shape[-1], carry=step == "ring", dtype=a.dtype)
        emit("longctx", **row)
        if not ok:
            raise AssertionError(f"longctx {step}: {launches}")
        if step in ("ring", "ulysses"):
            total = {kk: total[kk] + launches[kk] for kk in total}
    results["longctx_launches"] = total


# -- phase: the ViT-S/16 labeling line -------------------------------------

def check_vit(torch, results, workdir):
    import numpy as np

    from nnstreamer_tpu_torch.models import preprocess_frames
    from nnstreamer_tpu_torch.models.vit import ViT
    from nnstreamer_tpu_torch.ops import _cuda

    classes = VIT["classes"]
    labels = os.path.join(workdir, "vit_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(classes)) + "\n")
    rng = np.random.default_rng(4)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    line = _labeling_line(labels, "vit",
                          f"seed:0,postproc:argmax,{_custom(VIT)}")
    _, _, _, p = _drive(line, frames, N_WARMUP)
    p.stop()
    _cuda.reset_launches()
    out, secs, p50, p = _drive(line, frames, N_BATCHES)
    launches = dict(_cuda.LAUNCHES)
    bundle = p["f"].fw._bundle
    p.stop()
    n_frames = sum(len(b) for b in out)
    if len(out) != N_BATCHES or n_frames != N_BATCHES * BATCH:
        raise AssertionError(f"vit: expected {N_BATCHES * BATCH} labels, got "
                             f"{n_frames} in {len(out)} buffers")
    names = {f"class{i}" for i in range(classes)}
    if not all(lab in names for b in out for lab in b):
        raise AssertionError("vit: a label is not from the labels file")
    if launches["flash_attention"] != VIT["depth"] * N_BATCHES or \
            launches["normalize_u8"] != N_BATCHES:
        raise AssertionError(f"vit: launch counts per {N_BATCHES} forwards: "
                             f"{launches}")
    results["vit_launches"] = launches
    twin = _plain_twin(bundle.module, ViT, VIT)
    x = torch.from_numpy(np.stack(frames)).cuda()
    with torch.inference_mode():
        got = bundle.apply_fn(x).float()
        want = twin(preprocess_frames(x, "pm1", torch.bfloat16)).float()
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(got).all()) and within(got, want, MODEL_ATOL,
                                                    MODEL_RTOL)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    ok = ok and agree >= VIT_ARGMAX_FLOOR
    emit("vit", frames=n_frames, batches=len(out), seconds=secs,
         fps=n_frames / secs, p50_batch_latency_ms=p50,
         fetch_window=FETCH_WINDOW, launches=launches,
         logits_max_abs_err=max_err(got, want), logits_atol=MODEL_ATOL,
         logits_rtol=MODEL_RTOL, logits_ok=ok, argmax_agreement=agree,
         argmax_floor=VIT_ARGMAX_FLOOR,
         distinct_labels=len({lab for b in out for lab in b}),
         card=results["card"])
    if not ok:
        raise AssertionError("vit logits or labels disagree with the plain "
                             "forward")


# -- the detection, segmentation and pose lines ----------------------------

#: the four lines at full width (seed:0 weights from the port's numpy init):
#: frame size, frames per tensor, and the model's own customs
VISION = {
    "ssd_mobilenet": {"size": 300, "fpt": 32, "custom": "classes:91"},
    "deeplab_v3": {"size": 257, "fpt": 16, "custom": "classes:21"},
    "posenet": {"size": 257, "fpt": 16, "custom": "keypoints:17"},
    "yolov8": {"size": 320, "fpt": 16, "custom": "classes:80"},
}
#: batches per measured run of a line (after 2 warm-up batches)
VISION_BATCHES = 8


def _vision_model(name):
    """The line's model at full width with the seed:0 weights its line
    builds (the kernel rows' blocks)."""
    import importlib

    mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{name}")
    model = getattr(mod, {"ssd_mobilenet": "SSDMobileNetV2",
                          "deeplab_v3": "DeepLabV3"}[name])()
    mod.init_weights(model, 0)
    return model


def check_vision_blocks(torch, results, gen):
    """The fused block at every stride-1 block shape of SSD (300 px,
    batch 32) and DeepLab (257 px, batch 16), against its plain version,
    each row with its plan, registers, shared memory, CTAs per SM, times,
    bound and cuDNN chain; then normalize_u8 at the four lines' frames,
    bit-equal to its plain version."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import kernel_block_shapes
    from nnstreamer_tpu_torch.ops import normalize_u8, normalize_u8_plain
    from nnstreamer_tpu_torch.ops.fused_block import fold_inverted_residual

    keys = ("ms", "device_ms", "plain_ms", "cudnn_chain_ms", "bound_ms")
    for name, want in (("ssd_mobilenet", 13), ("deeplab_v3", 10)):
        cfg = VISION[name]
        model = _vision_model(name)
        shapes = kernel_block_shapes(model, cfg["size"])
        if len(shapes) != want:
            raise AssertionError(f"{name}: {len(shapes)} kernel blocks, "
                                 f"expected {want}")
        tot, errs = dict.fromkeys(keys, 0.0), []
        for i, H, W, *_ in shapes:
            row = _fused_row(torch, cfg["fpt"], H, W,
                             fold_inverted_residual(model.blocks[i]), gen,
                             model=name, block=i)
            for key in keys:
                tot[key] = None if tot[key] is None or row[key] is None \
                    else tot[key] + row[key]
            errs.append(row["max_abs_err"])
        results[f"fused_{name}"] = dict(tot, max_abs_err=max(errs))
        emit("kernel", kernel="fused_inverted_residual", model=name,
             block=f"sum of {want}", batch=cfg["fpt"], **tot,
             max_abs_err=max(errs))
    for name, cfg in VISION.items():
        s, fpt = cfg["size"], cfg["fpt"]
        x = torch.randint(0, 256, (fpt, s, s, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
        scale = (1.0 / 255.0, 0.0) if name == "yolov8" else (1.0 / 127.5,
                                                             -1.0)
        k = normalize_u8(x, *scale, out_dtype=torch.bfloat16)
        p = normalize_u8_plain(x, *scale, out_dtype=torch.bfloat16)
        n = x.numel()
        row = {"kernel": "normalize_u8", "model": name,
               "shape": list(x.shape), "max_abs_err": max_err(k, p),
               "tol": 0.0,
               "ms": cuda_ms(lambda: normalize_u8(
                   x, *scale, out_dtype=torch.bfloat16)),
               "plain_ms": cuda_ms(lambda: normalize_u8_plain(
                   x, *scale, out_dtype=torch.bfloat16)),
               "bound_ms": bound_ms(3 * n, 2 * n, "float32")[0]}
        emit("kernel", **row)
        if row["max_abs_err"] != 0.0:
            raise AssertionError(f"normalize_u8 at {name}'s frames: {row}")


def _vision_frames(seed, n, size):
    """n frames of 4x4 blocks of flat colour (different content each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cell = -(-size // 4)
    return [np.kron(rng.integers(0, 256, (4, 4, 3)),
                    np.ones((cell, cell, 1)))[:size, :size].astype(np.uint8)
            for _ in range(n)]


def _vision_line(name, decoder, extra=""):
    cfg = VISION[name]
    s = cfg["size"]
    return (f"appsrc name=src caps=video/x-raw,format=RGB,width={s},"
            f"height={s},framerate=1000/1 "
            f"! tensor_converter frames-per-tensor={cfg['fpt']} "
            f"! tensor_filter name=f framework=jax model={name} "
            f"custom=seed:0,{cfg['custom']}{extra} "
            f"! queue ! tensor_decoder {decoder} split-batch={cfg['fpt']} "
            f"! tensor_sink name=out")


def _run_vision(torch, name, decoder, frames, extra="",
                n_batches=VISION_BATCHES, warmup=N_WARMUP):
    """Drive one line: ``warmup`` batches, then n_batches measured with
    the launch counts zeroed just before. Returns (seconds, p50 batch ms,
    launches, bundle, the measured run's overlays, objects per overlay)."""
    from nnstreamer_tpu_torch.ops import _cuda

    fpt, size = VISION[name]["fpt"], VISION[name]["size"]
    d = _LineDriver(_vision_line(name, decoder, extra), frames,
                    outputs_per_unit=fpt)
    if warmup:
        d.run(warmup)
    _cuda.reset_launches()
    secs, p50 = d.run(n_batches)
    launches = dict(_cuda.LAUNCHES)
    bundle = d.p["f"].fw._bundle
    measured = d.p["out"].collected[warmup * fpt:]
    objects = [len(b.meta.get("objects") or b.meta.get("keypoints") or ())
               for b in measured]
    outs = d.close()[warmup * fpt:]
    if len(outs) != n_batches * fpt or any(
            tuple(o.shape) != (size, size, 4) for o in outs):
        raise AssertionError(f"{name}: expected {n_batches * fpt} "
                             f"{size}x{size} RGBA overlays, got "
                             f"{[tuple(o.shape) for o in outs[:3]]}... "
                             f"({len(outs)})")
    return secs, p50, launches, bundle, outs, objects


def _profile_vision(torch, name, decoder, frames, extra=""):
    """One more run of a line (4 batches, no warm-up: the model's weights
    upload inside the window, the wall clock starts at the first push)
    under torch.profiler."""
    emit("profile", line=name + extra, batches=4, **device_profile(
        torch, lambda: _run_vision(torch, name, decoder, frames, extra,
                                   n_batches=4, warmup=0)[0]))


def _check_launches(name, launches, fused, n_batches=VISION_BATCHES):
    """The fused block ``fused`` times and normalize_u8 once per forward,
    no other kernel."""
    want = {"fused_inverted_residual": fused * n_batches,
            "normalize_u8": n_batches}
    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{name}: launches per {n_batches} forwards "
                             f"{launches}, expected {want}")


def _near_agreement(got, want, tol=5e-3):
    """The pp quads' near agreement (tests/test_fused_block.py::
    test_ssd_zoo_fused_pp_custom) per frame: survivor counts within
    max(3, n/10), the leading (up to 10) scores within ``tol`` and each
    leading detection matched by one of the oracle's first lead + 3 with
    its class, score and box (near-tied scores may swap order). Returns
    (whether every frame holds it, frames whose leading classes are in
    the same order, the largest count difference)."""
    locs, cls, scr, num = (t.float().cpu() for t in got)
    wl, wc, ws, wn = (t.float().cpu() for t in want)
    ok, same_order, worst = True, 0, 0
    for b in range(num.shape[0]):
        n_got, n_want = int(num[b, 0]), int(wn[b, 0])
        worst = max(worst, abs(n_got - n_want))
        ok &= abs(n_got - n_want) <= max(3, n_want // 10)
        lead = min(n_got, n_want, 10)
        ok &= bool(((scr[b, :lead] - ws[b, :lead]).abs()
                    <= tol + tol * ws[b, :lead].abs()).all())
        same_order += bool((cls[b, :lead] == wc[b, :lead]).all())
        for i in range(lead):
            ok &= any(wc[b, j] == cls[b, i]
                      and abs(float(ws[b, j] - scr[b, i])) <= tol
                      and float((wl[b, j] - locs[b, i]).abs().max()) <= tol
                      for j in range(min(lead + 3, wc.shape[1])))
    return bool(ok), same_order, worst


def _forwards(torch, name, bundle, x):
    """The filter's own forward on ``x`` and, on the same weights, the
    same folded forward with the kernel's plain version in its place
    ('plain'), with every block as three convolutions ('xla', the JAX
    package's fused:xla form) and in float32 ('f32', TF32 off)."""
    import importlib

    from nnstreamer_tpu_torch.models import preprocess_frames

    mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{name}")
    m = bundle.module
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        pre = preprocess_frames(x, "pm1", m.dtype)
        out = {"kernel": bundle.apply_fn(x)}
        for mode in ("plain", "xla"):
            out[mode] = mod._make_fused_apply(m, mode=mode)(pre)
        out["f32"] = mod._make_fused_apply(
            m, mode="plain", compute_dtype=torch.float32)(pre.float())
    torch.cuda.synchronize()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return {k: v if isinstance(v, tuple) else (v,) for k, v in out.items()}


#: the kernel forward against the plain forward, relative to the bf16
#: noise floor: the xla forward's distance from the same plain forward
#: (it rounds at other points in every block, as any second correct bf16
#: implementation does). The kernel rounds where the plain version rounds,
#: so its mean distance must stay below this share of the floor's
NOISE_SHARE = 0.5


def _agreement(torch, outs):
    """Per output tensor: max and mean |a - plain| for a in kernel, xla
    and f32, and the argmax agreement over the last axis. ``ok``: every
    kernel output finite, its mean distance at most NOISE_SHARE of the
    xla forward's, its max distance and argmax agreement no worse than
    the xla forward's."""
    rows, ok = [], True
    for i, plain in enumerate(outs["plain"]):
        row = {}
        for a in ("kernel", "xla", "f32"):
            d = (outs[a][i].float() - plain.float()).abs()
            row[a] = {"max": float(d.max()), "mean": float(d.mean()),
                      "argmax_agreement": float(
                          (outs[a][i].argmax(-1) == plain.argmax(-1))
                          .float().mean())}
        k, x = row["kernel"], row["xla"]
        row["finite"] = bool(torch.isfinite(outs["kernel"][i]).all())
        row["ok"] = (row["finite"] and k["mean"] <= NOISE_SHARE * x["mean"]
                     and k["max"] <= x["max"]
                     and k["argmax_agreement"] >= x["argmax_agreement"])
        ok = ok and row["ok"]
        rows.append(row)
    return ok, rows


def check_detect(torch, results, workdir):
    """SSD-MobileNet-v2 at 300 px into bounding_boxes mobilenet-ssd, then
    its postproc:pp line into mobilenet-ssd-postprocess."""
    import numpy as np

    from nnstreamer_tpu_torch.models.ssd_mobilenet import (
        generate_anchors,
        pp_options,
        ssd_postprocess,
        write_box_priors,
    )

    name, cfg = "ssd_mobilenet", VISION["ssd_mobilenet"]
    labels = os.path.join(workdir, "ssd_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(91)) + "\n")
    priors = os.path.join(workdir, "box_priors.txt")
    n_anchors = write_box_priors(priors, cfg["size"])
    frames = _vision_frames(5, cfg["fpt"], cfg["size"])
    wh = f"{cfg['size']}:{cfg['size']}"
    secs, p50, launches, bundle, outs, objects = _run_vision(
        torch, name,
        f"mode=bounding_boxes option1=mobilenet-ssd option2={labels} "
        f"option3={priors}:0.5 option4={wh} option5={wh}", frames,
        extra=",fused:pallas")
    _check_launches(name, launches, 13)
    results["detect_launches"] = launches
    x = torch.from_numpy(np.stack(frames)).cuda()
    fw = _forwards(torch, name, bundle, x)
    got = fw["kernel"]
    ok, rows = _agreement(torch, fw)
    ok = ok and (tuple(got[0].shape) == (cfg["fpt"], n_anchors, 1, 4)
                 and tuple(got[1].shape) == (cfg["fpt"], n_anchors, 91))
    emit("detect", line="ssd_mobilenet", frames=len(outs),
         batches=VISION_BATCHES, frames_per_tensor=cfg["fpt"], seconds=secs,
         fps=len(outs) / secs, p50_batch_latency_ms=p50, launches=launches,
         anchors=n_anchors, boxes=rows[0], scores=rows[1],
         noise_share=NOISE_SHARE, ok=ok,
         within_flagship_tol=[within(g, w, MODEL_ATOL, MODEL_RTOL)
                              for g, w in zip(got, fw["plain"])],
         objects_per_frame=statistics.mean(objects), card=results["card"])
    if not ok:
        raise AssertionError("detect: SSD outputs stray from the plain "
                             "forward beyond the bf16 noise floor")
    _profile_vision(
        torch, name,
        f"mode=bounding_boxes option1=mobilenet-ssd option2={labels} "
        f"option3={priors}:0.5 option4={wh} option5={wh}", frames,
        extra=",fused:pallas")
    # the pp line: the post-process on the device, four small tensors out
    k, iou, thr = pp_options({})
    secs, p50, launches, bundle, outs, objects = _run_vision(
        torch, name,
        f"mode=bounding_boxes option1=mobilenet-ssd-postprocess "
        f"option2={labels} option3=0:1:2:3,50 option4={wh} option5={wh}",
        frames, extra=",fused:pallas,postproc:pp", n_batches=4)
    _check_launches(name, launches, 13, n_batches=4)
    results["detect_pp_launches"] = launches
    pri = torch.from_numpy(generate_anchors(cfg["size"])).cuda()
    with torch.inference_mode():
        got = bundle.apply_fn(x)
        post = {a: ssd_postprocess(*fw[a], pri, k, iou, thr)
                for a in ("kernel", "plain", "xla")}
    torch.cuda.synchronize()
    # the device post-process is exact: the pp line's quads are the
    # post-process of the same kernel forward's raw outputs, bit for bit
    exact = all(bool(torch.equal(g, w)) for g, w in zip(got, post["kernel"]))
    # against the plain forward's quads: the near-agreement rule,
    # reported, and held to the noise floor of the xla forward's quads
    near, same_order, worst = _near_agreement(got, post["plain"])
    x_near, x_same, x_worst = _near_agreement(post["xla"], post["plain"])
    ok = exact and worst <= x_worst and same_order >= x_same
    emit("detect", line="ssd_mobilenet postproc:pp", frames=len(outs),
         batches=4, seconds=secs, fps=len(outs) / secs,
         p50_batch_latency_ms=p50, launches=launches,
         survivors=[int(v) for v in got[3][:, 0].tolist()],
         survivors_plain=[int(v) for v in post["plain"][3][:, 0].tolist()],
         exact=exact, near_agreement=near, largest_count_difference=worst,
         leading_order_equal=same_order,
         xla={"near_agreement": x_near, "largest_count_difference": x_worst,
              "leading_order_equal": x_same},
         ok=ok, objects_per_frame=statistics.mean(objects),
         card=results["card"])
    if not ok:
        raise AssertionError("detect: the pp quads are not the post-process "
                             "of the kernel forward, or stray from the "
                             "plain forward's beyond the noise floor")


def check_segment(torch, results):
    """DeepLab-v3 at 257 px into image_segment tflite-deeplab."""
    import numpy as np

    name, cfg = "deeplab_v3", VISION["deeplab_v3"]
    frames = _vision_frames(6, cfg["fpt"], cfg["size"])
    secs, p50, launches, bundle, outs, _ = _run_vision(
        torch, name, "mode=image_segment option1=tflite-deeplab", frames,
        extra=",fused:pallas")
    _check_launches(name, launches, 10)
    results["segment_launches"] = launches
    fw = _forwards(torch, name, bundle,
                   torch.from_numpy(np.stack(frames)).cuda())
    got = fw["kernel"][0]
    s = cfg["size"]
    ok, rows = _agreement(torch, fw)
    ok = ok and tuple(got.shape) == (cfg["fpt"], s, s, 21)
    emit("segment", line="deeplab_v3", frames=len(outs),
         batches=VISION_BATCHES, frames_per_tensor=cfg["fpt"], seconds=secs,
         fps=len(outs) / secs, p50_batch_latency_ms=p50, launches=launches,
         logits=rows[0], noise_share=NOISE_SHARE, ok=ok,
         within_flagship_tol=within(got, fw["plain"][0], MODEL_ATOL,
                                    MODEL_RTOL),
         distinct_classes=int(got.argmax(-1).unique().numel()),
         card=results["card"])
    if not ok:
        raise AssertionError("segment: DeepLab logits stray from the plain "
                             "forward beyond the bf16 noise floor")
    _profile_vision(torch, name, "mode=image_segment option1=tflite-deeplab",
                    frames, extra=",fused:pallas")


#: COCO's 17 keypoints and their skeleton, as the pose decoder's
#: metadata file (PoseNet emits 17 heatmaps; the decoder's default has 14)
COCO_KEYPOINTS = (
    ("nose", (1, 2)), ("l_eye", (0, 3)), ("r_eye", (0, 4)), ("l_ear", (1,)),
    ("r_ear", (2,)), ("l_shoulder", (6, 7, 11)), ("r_shoulder", (5, 8, 12)),
    ("l_elbow", (5, 9)), ("r_elbow", (6, 10)), ("l_wrist", (7,)),
    ("r_wrist", (8,)), ("l_hip", (5, 12, 13)), ("r_hip", (6, 11, 14)),
    ("l_knee", (11, 15)), ("r_knee", (12, 16)), ("l_ankle", (13,)),
    ("r_ankle", (14,)))


def check_vision(torch, results, workdir):
    """PoseNet at 257 px into pose_estimation heatmap-offset, YOLOv8 at
    320 px into bounding_boxes yolov8: outputs' shapes and finiteness, one
    overlay per frame, frames per second."""
    import numpy as np

    labels = os.path.join(workdir, "coco_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(80)) + "\n")
    pose = os.path.join(workdir, "coco_pose.txt")
    with open(pose, "w") as f:  # label, then the keypoints it joins
        f.write("\n".join(f"{n} {' '.join(map(str, c))}" for n, c in (
            COCO_KEYPOINTS)) + "\n")
    results["vision_launches"] = {}
    for name, decoder, shapes in (
            ("posenet", "mode=pose_estimation option1=257:257 "
             f"option2=257:257 option3={pose} option4=heatmap-offset",
             [(16, 17, 17, 17), (16, 17, 17, 34)]),
            ("yolov8", f"mode=bounding_boxes option1=yolov8 "
             f"option2={labels} option3=1:0.25:0.45 option4=320:320 "
             "option5=320:320", [(16, 2100, 84)])):
        cfg = VISION[name]
        frames = _vision_frames(7, cfg["fpt"], cfg["size"])
        secs, p50, launches, bundle, outs, objects = _run_vision(
            torch, name, decoder, frames)
        _check_launches(name, launches, 0)
        for k, v in launches.items():
            results["vision_launches"][k] = \
                results["vision_launches"].get(k, 0) + v
        with torch.inference_mode():
            out = bundle.apply_fn(torch.from_numpy(np.stack(frames)).cuda())
        out = out if isinstance(out, tuple) else (out,)
        got = [tuple(t.shape) for t in out]
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        ok = finite and got == shapes
        emit("vision", line=name, frames=len(outs), batches=VISION_BATCHES,
             frames_per_tensor=cfg["fpt"], seconds=secs,
             fps=len(outs) / secs, p50_batch_latency_ms=p50,
             launches=launches, shapes=got, finite=finite, ok=ok,
             objects_per_frame=statistics.mean(objects),
             card=results["card"])
        if not ok:
            raise AssertionError(f"vision: {name} outputs {got}, finite "
                                 f"{finite}; expected {shapes}")


# -- phase: the upload window on the flagship line --------------------------

#: feed-depth values the upload phase drives, each run twice, in the order
#: 1, 2, 4, 4, 2, 1
FEED_DEPTHS = (1, 2, 4)


def _flag_line(labels: str, extra: str = "", fpt: int = BATCH) -> str:
    """The flagship labeling line with tensor_filter properties added
    (fetch-window=4 unless ``extra`` sets one)."""
    if "fetch-window" not in extra:
        extra += f" fetch-window={FETCH_WINDOW}"
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter name=conv frames-per-tensor={fpt} "
        f"! tensor_filter name=f framework=jax model=mobilenet_v2 "
        f"custom=seed:0,postproc:argmax,fused:pallas {extra} "
        f"! queue name=q ! tensor_decoder name=dec mode=image_labeling "
        f"option1={labels} ! tensor_sink name=out")


def _labels_of(p) -> list:
    """Every label the sink collected, one per frame, in order."""
    out = []
    for b in p["out"].collected:
        lab = b.meta["label"]
        out.extend(lab if isinstance(lab, list) else [lab])
    return out


def trace_device_stats(path: str, wall_s: float) -> dict:
    """From a torch.profiler Chrome trace (``trace.torch_profile``): the
    device's busy time (union of its kernel, memcpy and memset intervals)
    and idle share over ``wall_s``, the streams the kernels ran on, and
    every host-to-device copy by name (Kineto says Pinned or Pageable) and
    stream, with its count and milliseconds."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    spans, kernel_streams, h2d = [], set(), {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or "dur" not in e:
            continue
        t0 = float(e["ts"])
        spans.append((t0, t0 + float(e["dur"])))
        stream = (e.get("args") or {}).get("stream")
        if cat == "kernel":
            kernel_streams.add(stream)
        elif "HtoD" in e.get("name", ""):
            n, ms = h2d.get((e["name"], stream), (0, 0.0))
            h2d[(e["name"], stream)] = (n + 1, ms + float(e["dur"]) / 1e3)
    busy_us, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy_us += t1 - t0
            end = t1
        elif t1 > end:
            busy_us += t1 - end
            end = t1
    return {"device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
            "kernel_streams": sorted(kernel_streams, key=str),
            "h2d": [{"name": name, "stream": stream, "count": n, "ms": ms}
                    for (name, stream), (n, ms) in sorted(h2d.items(),
                                                          key=str)],
            "h2d_pinned_off_kernel_stream": any(
                "Pinned" in name and stream not in kernel_streams
                for name, stream in h2d)}


def check_upload(torch, results, workdir):
    """The flagship line at feed-depth 1, 2 and 4 (fetch-window=4), each
    run twice: frames/s, labels against feed-depth=1, the tracer's
    crossings and upload-window residency, then one torch.profiler run at
    depth 1 and one at depth 2 (idle share; which stream the uploads ran
    on, pinned or pageable)."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    _, _, _, p = _drive(_flag_line(labels, "feed-depth=2"), frames, 2)
    p.stop()  # warm-up: the staging ring's first pinned allocations
    runs = {d: [] for d in FEED_DEPTHS}
    launches = {}
    ref_labels, report = None, {}
    for d in FEED_DEPTHS + FEED_DEPTHS[::-1]:
        _cuda.reset_launches()
        out, secs, p50, p = _drive(
            _flag_line(labels, f"feed-depth={d}"), frames, N_BATCHES,
            traced=True)
        for k, v in _cuda.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        got = _labels_of(p)
        cr = p.tracer.crossings()["per_element"]
        res = p.tracer.report().get("residency", {})
        p.stop()
        if ref_labels is None:
            ref_labels = got
        runs[d].append({"fps": N_BATCHES * BATCH / secs, "p50_ms": p50,
                        "labels_equal_depth1": got == ref_labels})
        report[d] = {"crossings_f": cr.get("f"),
                     "crossings_other": {k: v for k, v in cr.items()
                                         if k != "f"},
                     "upload_window": res.get("upload-window:f"),
                     "fetch_window": res.get("fetch-window:f")}
        want_h2d = (N_BATCHES, N_BATCHES * BATCH * SIZE * SIZE * 3)
        want_d2h = (N_BATCHES // FETCH_WINDOW, N_BATCHES * BATCH * 4)
        f = cr.get("f") or {}
        if (len(got) != N_BATCHES * BATCH or got != ref_labels
                or (f.get("h2d"), f.get("h2d_bytes")) != want_h2d
                or (f.get("d2h"), f.get("d2h_bytes")) != want_d2h
                or (d > 1 and (res.get("upload-window:f") or {})
                    .get("count") != N_BATCHES)):
            emit("upload", feed_depth=d, failed=report[d],
                 labels=len(got), labels_equal=got == ref_labels)
            raise AssertionError(f"upload: feed-depth={d} run is wrong")
    runs_n = 2 * len(FEED_DEPTHS)
    if launches.get("fused_inverted_residual") != 13 * N_BATCHES * runs_n \
            or launches.get("normalize_u8") != N_BATCHES * runs_n:
        raise AssertionError(f"upload: launch counts {launches}")
    results["upload_launches"] = launches
    profiles = {}
    for d in (1, 2):
        logdir = os.path.join(workdir, f"upload_prof_d{d}")
        with trace.torch_profile(logdir) as path:
            _, secs, _, p = _drive(_flag_line(labels, f"feed-depth={d}"),
                                   frames, FETCH_WINDOW)
            p.stop()
        profiles[d] = trace_device_stats(path, secs)
        profiles[d]["wall_ms"] = secs * 1e3
        profiles[d]["trace_valid"] = trace.validate_chrome_trace(path) == []
    # the host side: one span-traced run per depth — the filter's own ms
    # per batch, its invoke dispatch (at depth 1 it includes the pageable
    # upload) and, at depth 2, the prefetch's staging copy (the h2d span)
    host = {}
    for d in (1, 2):
        _, secs, _, p = _drive(_flag_line(labels, f"feed-depth={d}"),
                               frames, N_BATCHES, traced=True, spans=True)
        recs = p.tracer.spans.records()
        p.stop()
        ms = {cat: [(r[4] - r[3]) * 1e3 for r in recs if r[2] == cat]
              for cat in ("h2d", "dispatch")}
        host[d] = {"wall_ms_per_batch": secs * 1e3 / N_BATCHES,
                   "filter_own_ms_per_batch":
                       p.tracer.element_self_ms(N_BATCHES).get("f"),
                   "dispatch_ms_mean": statistics.fmean(ms["dispatch"]),
                   "h2d_staging_ms_mean": (statistics.fmean(ms["h2d"])
                                           if ms["h2d"] else None)}
    emit("upload", batches=N_BATCHES, batch=BATCH,
         fetch_window=FETCH_WINDOW,
         fps={d: [r["fps"] for r in runs[d]] for d in FEED_DEPTHS},
         fps_median={d: statistics.median(r["fps"] for r in runs[d])
                     for d in FEED_DEPTHS},
         fps_spread={d: max(r["fps"] for r in runs[d])
                     - min(r["fps"] for r in runs[d]) for d in FEED_DEPTHS},
         p50_batch_latency_ms={d: [r["p50_ms"] for r in runs[d]]
                               for d in FEED_DEPTHS},
         labels_equal_depth1=all(r["labels_equal_depth1"]
                                 for d in FEED_DEPTHS for r in runs[d]),
         tracer=report, launches=launches, profile=profiles,
         host_spans=host, card=results["card"])
    if not profiles[2]["h2d_pinned_off_kernel_stream"]:
        raise AssertionError("upload: feed-depth=2 shows no pinned upload "
                             "off the kernels' stream")


# -- phase: the live-camera form of the flagship line ------------------------

#: frames per micro-batch on the live line, and the quiescence flush
LIVE_BATCH = 32
LIVE_TIMEOUT_MS = 50


def check_batch(torch, results):
    """tensor_converter frames-per-tensor=1 ! tensor_filter batch-size=32
    fetch-timeout-ms=50 fetch-window=auto, frames pushed one by one: its
    labels against the frames-per-tensor=32 line on the same frames, the
    window auto settles on, frames/s; then 40 frames with no EOS, which
    only the timer thread's flush can bring out."""
    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    n_units = 16
    live = (f"batch-size={LIVE_BATCH} fetch-timeout-ms={LIVE_TIMEOUT_MS} "
            "fetch-window=auto")
    ref = _LineDriver(_flag_line(labels, "fetch-window=1", fpt=LIVE_BATCH),
                      frames[:LIVE_BATCH])
    ref.run(2)
    ref.run(n_units)
    ref.close()
    want = _labels_of(ref.p)[2 * LIVE_BATCH:]
    drv = _LineDriver(_flag_line(labels, live, fpt=1), frames[:LIVE_BATCH],
                      outputs_per_unit=LIVE_BATCH)
    drv.run(2)  # warm-up
    _cuda.reset_launches()
    secs, p50 = drv.run(n_units)
    launches = dict(_cuda.LAUNCHES)
    window = drv.p["f"]._auto_window
    # the quiescence flush: 40 frames, no EOS — the last 8 sit in a
    # partial batch until fetch-timeout-ms expires on the timer thread
    n0 = len(drv.arrived)
    t0 = time.perf_counter()
    for i in range(40):
        drv.p["src"].push_buffer(_frame_buf(frames[i % LIVE_BATCH]))
    deadline = time.monotonic() + 30
    while len(drv.arrived) < n0 + 40 and time.monotonic() < deadline:
        time.sleep(0.001)
    flush_s = time.perf_counter() - t0
    drv.close()
    got = _labels_of(drv.p)
    live_labels = got[2 * LIVE_BATCH:2 * LIVE_BATCH + n_units * LIVE_BATCH]
    timer_labels = got[(2 + n_units) * LIVE_BATCH:]
    ok = (live_labels == want and len(timer_labels) == 40
          and timer_labels == want[:40]
          and launches.get("fused_inverted_residual") == 13 * n_units
          and launches.get("normalize_u8") == n_units)
    results["batch_launches"] = launches
    emit("batch", frames=n_units * LIVE_BATCH, batch=LIVE_BATCH,
         seconds=secs, fps=n_units * LIVE_BATCH / secs,
         p50_batch_latency_ms=p50, auto_window=window,
         labels_equal_fpt32=live_labels == want,
         timeout_flush_frames=len(timer_labels),
         timeout_flush_labels_equal=timer_labels == want[:40],
         timeout_flush_s=flush_s, launches=launches, card=results["card"])
    if not ok:
        raise AssertionError("batch: labels, the timer flush or the launch "
                             "counts are wrong")


def _frame_buf(frame):
    from nnstreamer_tpu_torch.buffer import Buffer

    return Buffer(tensors=[frame])


# -- phase: host time per element ---------------------------------------------

def _element_host_ms(tracer, units: int) -> dict:
    """Per element: its chain's inclusive host ms per unit (report()'s
    proctime; an element's chain includes the downstream chains it calls
    on its thread) and its own ms per unit (the span ring's self time)."""
    rep = tracer.report()
    own = tracer.element_self_ms(units)
    out = {}
    for el, e in rep.items():
        pt = e.get("proctime") if isinstance(e, dict) else None
        if not pt or not pt.get("count"):
            continue
        out[el] = {"chains": pt["count"],
                   "inclusive_ms": pt["mean_us"] * pt["count"] / 1e3 / units,
                   "own_ms": own.get(el, 0.0)}
    return out


def check_hostspans(torch, results, workdir):
    """The flagship and stream lines with a span tracer attached after
    their warm-up: each element's host ms per batch (window), the
    host-stack roll-up, and a torch_profile trace of the flagship line
    checked by validate_chrome_trace."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    launches = {}
    drv = _LineDriver(_flag_line(labels), frames)
    drv.run(FETCH_WINDOW)
    tracer = drv.attach()
    _cuda.reset_launches()
    secs, _ = drv.run(N_BATCHES)
    for k, v in _cuda.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    flag = {"batches": N_BATCHES, "wall_ms_per_batch": secs * 1e3 / N_BATCHES,
            "elements": _element_host_ms(tracer, N_BATCHES),
            "host_stack": tracer.host_stack_report(N_BATCHES),
            "crossings": tracer.crossings()["per_element"]}
    spans_valid = trace.validate_chrome_trace(
        tracer.export_chrome_trace()) == []
    drv.close()
    window = results["stream_window"]
    sdrv = _StreamDriver(window)
    sdrv.run(N_WARMUP)
    stracer = sdrv.attach()
    _cuda.reset_launches()
    ssecs, _ = sdrv.run(N_BATCHES)
    for k, v in _cuda.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    stream = {"windows": N_BATCHES,
              "wall_ms_per_window": ssecs * 1e3 / N_BATCHES,
              "elements": _element_host_ms(stracer, N_BATCHES),
              "host_stack": stracer.host_stack_report(N_BATCHES)}
    spans_valid = spans_valid and trace.validate_chrome_trace(
        stracer.export_chrome_trace()) == []
    sdrv.close()
    logdir = os.path.join(workdir, "hostspans_prof")
    with trace.torch_profile(logdir) as path:
        _, psecs, _, p = _drive(_flag_line(labels), frames, FETCH_WINDOW)
        p.stop()
    problems = trace.validate_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        n_events = len(json.load(f)["traceEvents"])
    prof = trace_device_stats(path, psecs)
    results["hostspans_launches"] = launches
    emit("hostspans", flagship=flag, stream=stream,
         span_traces_valid=spans_valid,
         torch_profile={"path": os.path.relpath(path, ROOT),
                        "events": n_events, "problems": problems[:5],
                        "valid": not problems, "wall_ms": psecs * 1e3,
                        "idle_share": prof["idle_share"],
                        "device_busy_ms": prof["device_busy_ms"]},
         launches=launches, card=results["card"])
    if problems or not spans_valid or not flag["elements"] \
            or not stream["elements"] \
            or launches.get("fused_inverted_residual") != 13 * N_BATCHES \
            or launches.get("flash_attention") != \
            STREAM["depth"] * N_BATCHES:
        raise AssertionError("hostspans: a trace is invalid, an element "
                             "is missing or a kernel did not launch")


# -- phase: the serving tier --------------------------------------------------

#: rows per served batch, client pipelines, requests per client, and the
#: admission bound of the measured run and of the 2x-overload run
SERVE_BATCH = 32
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 32
SERVE_DEPTH = 256
OVERLOAD_DEPTH = 32
OVERLOAD_S = 3.0
SERVE_FRAME_CAPS = (f"other/tensors,num-tensors=1,dimensions=3:{SIZE}:{SIZE},"
                    "types=uint8,framerate=0/1")


def _serve_line(depth: int = SERVE_DEPTH) -> str:
    """The serving line at full width: MobileNet-v2 1.0, 224x224, 1001
    classes, 32 rows per batch assembled from every waiting client."""
    return (f"tensor_query_serversrc id=srv port=0 serve=1 "
            f"serve-batch={SERVE_BATCH} serve-queue-depth={depth} "
            f"caps={SERVE_FRAME_CAPS} ! tensor_filter framework=jax "
            "model=mobilenet_v2 custom=seed:0,fused:pallas "
            "! tensor_query_serversink id=srv timeout=5")


def _element(p, type_name: str):
    return next(e for e in p.elements.values()
                if e.ELEMENT_NAME == type_name)


def _serve_frames(frames, client: int, n: int = SERVE_PER_CLIENT):
    """Client ``client``'s frames: the flagship's seeded frames, from an
    offset of its own."""
    return [frames[(client * 17 + k) % len(frames)] for k in range(n)]


def _run_serving(server_line, clients, client_caps, client_tail="",
                 decoder="", traced=True):
    """Play ``server_line`` and one client pipeline per entry of
    ``clients`` (each ``(frames, offsets)``: the frames it pushes and, for
    an open-loop run, the second after the start at which it pushes each;
    None pushes them back to back), all started together in threads.
    Returns (per-client results, the server's serving report, seconds from
    the first push to the last reply, the served filter's forward and
    device). Each frame's pts names its client and index, so a reply
    names the request it answers."""
    import threading

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    server = parse_launch(server_line)
    tracer = trace.attach(server) if traced else None
    server.play()
    res = {}
    t0 = [0.0]
    # every client connected and playing before the first push; the
    # barrier's action stamps the start all offsets count from
    ready = threading.Barrier(
        len(clients) + 1, timeout=60,
        action=lambda: t0.__setitem__(0, time.perf_counter()))
    try:
        port = _element(server, "tensor_query_serversrc").port

        def client(i, frames, offsets):
            cl = parse_launch(
                f"appsrc name=src caps={client_caps} ! tensor_query_client "
                f"name=qc port={port} timeout=60 {client_tail} "
                f"! {decoder}tensor_sink name=out")
            arrived = {}
            cl["out"].connect_new_data(
                lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
            cl.play()
            pushed = {}
            try:
                ready.wait()
                for k, f in enumerate(frames):
                    if offsets is not None:
                        delay = t0[0] + offsets[k] - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    pts = i * 1_000_000 + k
                    pushed[pts] = time.perf_counter()
                    cl["src"].push_buffer(Buffer(tensors=[f], pts=pts))
                cl["src"].end_of_stream()
                ok = cl.bus.wait_eos(180)
                res[i] = {"ok": ok, "error": cl.bus.error, "pushed": pushed,
                          "arrived": arrived,
                          "out": list(cl["out"].collected),
                          "dropped": cl["qc"].error_stats["dropped"]}
            finally:
                cl.stop()

        threads = [threading.Thread(target=client, args=(i, fr, off),
                                    daemon=True)
                   for i, (fr, off) in enumerate(clients)]
        for t in threads:
            t.start()
        ready.wait()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("serve: a client pipeline hung")
        last = max((max(r["arrived"].values()) for r in res.values()
                    if r["arrived"]), default=t0[0])
        fw = _element(server, "tensor_filter").fw
        forward = (fw._bundle.apply_fn, fw._device)  # the backend closes
    finally:
        server.stop()
    if len(res) != len(clients):
        raise AssertionError(f"serve: {len(clients) - len(res)} client "
                             "pipeline(s) failed to run")
    for i, r in res.items():
        if not r["ok"] or r["error"] is not None:
            raise AssertionError(f"serve: client {i} failed: {r['error']}")
    serving = next(iter(tracer.serving().values())) if traced else None
    return res, serving, last - t0[0], forward


def _latencies_ms(res) -> list:
    return sorted((r["arrived"][k] - r["pushed"][k]) * 1e3
                  for r in res.values() for k in r["arrived"])


def _pct(sorted_vals, q: float):
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def _serve_launches(name, launches, batches):
    if launches.get("fused_inverted_residual") != 13 * batches or \
            launches.get("normalize_u8") != batches:
        raise AssertionError(f"serve {name}: launches {launches} over "
                             f"{batches} served batches")


def _check_replies(name, res, n_per_client):
    """Every client got exactly its own requests' replies, once each, in
    the order it sent them."""
    for i, r in res.items():
        got = [b.pts for b in r["out"]]
        want = sorted(r["pushed"])
        if got != want or len(got) != n_per_client:
            raise AssertionError(f"serve {name}: client {i} got pts "
                                 f"{got[:5]}... for {want[:5]}...")


def check_serve(torch, results, workdir):
    """The serving tier at full width: 8 clients x 32 frames through the
    continuous-batching server (labels and logits against the direct
    forward at batch 32, launch counts per served batch, the serving
    report, requests/s and request latency), one torch.profiler run, a
    run at twice the measured capacity (open-loop Poisson arrivals,
    serve-queue-depth=32: queue-full sheds, every admitted request
    answered once by the right client), then the three reference serving
    lines of examples/launch_lines_serving.txt as written."""
    import numpy as np

    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    names = [f"class{i}" for i in range(1001)]
    decoder = f"tensor_decoder mode=image_labeling option1={labels} ! "
    clients = [(_serve_frames(frames, i), None) for i in range(SERVE_CLIENTS)]
    total = SERVE_CLIENTS * SERVE_PER_CLIENT
    # warm-up: one client (cuDNN plans, the allocator), not measured
    _run_serving(_serve_line(), clients[:1], SERVE_FRAME_CAPS,
                 traced=False)
    launches_all = {}

    def add_launches(launches):
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v

    _cuda.reset_launches()
    res, srv, secs, (forward, device) = _run_serving(
        _serve_line(), clients, SERVE_FRAME_CAPS, decoder=decoder)
    launches = dict(_cuda.LAUNCHES)
    add_launches(launches)
    _serve_launches("labels", launches, srv["batches"])
    if srv["rows"] != total or srv["shed"] != 0 or srv["replies"] != total \
            or not srv["batch_fill"] > 1:
        raise AssertionError(f"serve: serving report {srv}")
    _check_replies("labels", res, SERVE_PER_CLIENT)
    # the direct forward of the same filter on each client's frames at
    # batch 32: its labels, and its logits for the second run
    want_logits = {}
    with torch.inference_mode():
        for i, (fr, _) in enumerate(clients):
            x = torch.from_numpy(np.stack(fr)).to(device)
            want_logits[i] = forward(x).float()
    torch.cuda.synchronize()
    label_ok, distinct = True, []
    for i, r in res.items():
        got = []
        for b in r["out"]:
            lab = b.meta["label"]
            got.extend(lab if isinstance(lab, list) else [lab])
        want = [names[j] for j in want_logits[i].argmax(-1).tolist()]
        label_ok = label_ok and got == want
        distinct.append(len(set(want)))
    lat = _latencies_ms(res)
    rps = total / secs
    # the logits: the same run with no decoder at the clients
    _cuda.reset_launches()
    res2, srv2, secs2, _ = _run_serving(_serve_line(), clients,
                                        SERVE_FRAME_CAPS)
    launches2 = dict(_cuda.LAUNCHES)
    add_launches(launches2)
    _serve_launches("logits", launches2, srv2["batches"])
    _check_replies("logits", res2, SERVE_PER_CLIENT)
    logits_err, logits_ok, bit_equal = 0.0, True, True
    shift_caught, rows_caught = True, 0
    for i, r in res2.items():
        want = want_logits[i]
        got = torch.from_numpy(np.stack(
            [np.asarray(b.tensors[0]).reshape(-1) for b in r["out"]])
        ).to(want.device)
        logits_err = max(logits_err, max_err(got, want))
        logits_ok = logits_ok and got.shape == want.shape and \
            within(got, want, 0.15, 0.05)
        bit_equal = bit_equal and torch.equal(got, want)
        # a demux off by one row must fail the same check: the replies
        # shifted by one row, against the direct forward
        shifted = got.roll(1, 0)
        shift_caught = shift_caught and not within(shifted, want, 0.15, 0.05)
        rows_caught += int((~((shifted - want).abs()
                              <= 0.15 + 0.05 * want.abs()).all(-1)).sum())
    lat2 = _latencies_ms(res2)
    emit("serve", clients=SERVE_CLIENTS, requests=total,
         serve_batch=SERVE_BATCH, seconds=secs, requests_per_s=rps,
         p50_request_ms=_pct(lat, 0.5), p99_request_ms=_pct(lat, 0.99),
         batches=srv["batches"], batch_fill=srv["batch_fill"],
         padded_rows=srv["padded_rows"],
         time_in_queue=srv["time_in_queue"], launches=launches,
         labels_equal_direct_forward=label_ok,
         distinct_labels_per_client=distinct,
         logits_run={"seconds": secs2, "requests_per_s": total / secs2,
                     "p50_request_ms": _pct(lat2, 0.5),
                     "p99_request_ms": _pct(lat2, 0.99),
                     "batches": srv2["batches"],
                     "batch_fill": srv2["batch_fill"],
                     "launches": launches2},
         logits_max_abs_err=logits_err, logits_atol=0.15, logits_rtol=0.05,
         logits_ok=logits_ok, logits_bit_equal=bit_equal,
         shifted_by_one_fails=shift_caught,
         shifted_rows_caught=rows_caught, card=results["card"])
    if not label_ok or not logits_ok:
        raise AssertionError("serve: a reply's label or logits disagree "
                             "with the direct forward")
    # the checks above could not see a mis-sliced row if every frame got
    # the same class, or if neighbouring rows' logits lay within the band
    if min(distinct) < 2 or not shift_caught:
        raise AssertionError(
            f"serve: the label and logits checks cannot tell rows apart "
            f"(distinct labels per client {distinct}, replies shifted by "
            f"one row pass: {not shift_caught})")

    # one run under torch.profiler: device busy, idle share, device time
    # by kernel
    def run():
        _cuda.reset_launches()
        _, sp, s, _ = _run_serving(_serve_line(), clients, SERVE_FRAME_CAPS)
        prof_launches = dict(_cuda.LAUNCHES)
        add_launches(prof_launches)
        _serve_launches("profile", prof_launches, sp["batches"])
        return s

    emit("profile", line="serve", requests=total,
         **device_profile(torch, run))

    # 2x the measured capacity, open loop: Poisson arrivals per client at
    # 2 * rps / 8, for OVERLOAD_S seconds, queue bound 32
    rate = 2.0 * rps / SERVE_CLIENTS
    rng = np.random.default_rng(7)
    over = []
    for i in range(SERVE_CLIENTS):
        offs = np.cumsum(rng.exponential(1.0 / rate, int(rate * OVERLOAD_S
                                                        * 1.5) + 8))
        offs = offs[offs < OVERLOAD_S]
        over.append((_serve_frames(frames, i, len(offs)), list(offs)))
    _cuda.reset_launches()
    res3, srv3, secs3, _ = _run_serving(
        _serve_line(depth=OVERLOAD_DEPTH), over, SERVE_FRAME_CAPS,
        client_tail="on-error=drop max-in-flight=100000")
    launches3 = dict(_cuda.LAUNCHES)
    add_launches(launches3)
    _serve_launches("overload", launches3, srv3["batches"])
    offered = sum(len(r["pushed"]) for r in res3.values())
    delivered = sum(len(r["out"]) for r in res3.values())
    dropped = sum(r["dropped"] for r in res3.values())
    own_once = all(
        len({b.pts for b in r["out"]}) == len(r["out"])
        and all(b.pts // 1_000_000 == i and b.pts in r["pushed"]
                for b in r["out"])
        for i, r in res3.items())
    lat3 = _latencies_ms(res3)
    first = min(min(r["pushed"].values()) for r in res3.values())
    last_push = max(max(r["pushed"].values()) for r in res3.values())
    # a batch must leave while the clients still send: a scheduler that
    # ingests until its queue is empty answers nothing until they stop
    first_reply = min((min(r["arrived"].values()) for r in res3.values()
                       if r["arrived"]), default=float("inf"))
    served_while_sending = first_reply < last_push
    emit("serve_overload", target_rps=2.0 * rps,
         offered_rps=offered / max(1e-9, last_push - first),
         offered=offered, admitted=srv3["enqueued"], shed=srv3["shed"],
         shed_reasons=srv3["shed_reasons"], replies=srv3["replies"],
         delivered=delivered, client_drops=dropped,
         admitted_p50_ms=_pct(lat3, 0.5), admitted_p99_ms=_pct(lat3, 0.99),
         goodput_rps=delivered / secs3, seconds=secs3,
         batches=srv3["batches"], batch_fill=srv3["batch_fill"],
         replies_own_client_once=own_once,
         served_while_sending=served_while_sending, launches=launches3,
         card=results["card"])
    if not (srv3["shed"] > 0 and srv3["shed_reasons"].get("queue-full", 0) > 0
            and own_once and delivered == srv3["replies"] == srv3["enqueued"]
            and delivered + dropped == offered and served_while_sending):
        raise AssertionError("serve: the 2x run did not shed on queue-full, "
                             "lost or misrouted an admitted request, or "
                             "answered nothing while the clients sent")
    results["serve_launches"] = launches_all
    check_serve_lines(results)


def check_serve_lines(results):
    """The three lines of examples/launch_lines_serving.txt as written
    (model=add on the card): 4 clients x 8 requests each, every answer
    exactly x + 1, in order. The clients keep one request in flight and
    retry a shed (the multi-tenant line's rate limit)."""
    import numpy as np

    with open(os.path.join(ROOT, "examples", "launch_lines_serving.txt"),
              encoding="utf-8") as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    rows = []
    for line in lines:
        n = 8 if "dimensions=8" in line else 4
        caps = (f"other/tensors,num-tensors=1,dimensions={n},"
                "types=float32,framerate=0/1")
        sid = line.split(" id=", 1)[1].split()[0]
        clients = [([np.full(n, 10.0 * i + k, np.float32) for k in range(8)],
                    None) for i in range(4)]
        res, srv, secs, _ = _run_serving(
            line, clients, caps,
            client_tail="max-in-flight=1 on-error=retry:12 "
                        "retry-backoff-ms=10")
        ok = True
        for i, r in res.items():
            got = [np.asarray(b.tensors[0]).reshape(-1) for b in r["out"]]
            want = [fr + 1 for fr in clients[i][0]]
            ok = ok and len(got) == 8 and all(
                np.array_equal(g, w) for g, w in zip(got, want))
        rows.append({"id": sid, "exact": ok, "replies": srv["replies"],
                     "shed": srv["shed"], "batches": srv["batches"],
                     "batch_fill": srv["batch_fill"], "seconds": secs})
    emit("serve_lines", lines=rows, card=results["card"])
    if not all(r["exact"] and r["replies"] == 32 for r in rows):
        raise AssertionError("serve_lines: a reference serving line did not "
                             "answer exactly")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nnstreamer_tpu_torch.ops import _cuda

    card = nvidia_smi()
    t0 = time.perf_counter()
    _cuda.lib()
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         kernel_build_s=time.perf_counter() - t0,
         nvcc_s=_cuda.build_seconds)
    results = {"card": card}
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(dir=workdir)
    phases = {
        "elementwise": lambda: check_elementwise(torch, results),
        "kernel": lambda: check_fused_block(torch, results),
        "slice": lambda: check_slice(torch, results, workdir),
        "transform": lambda: check_transform(torch, results),
        "attention": lambda: check_attention(torch, results),
        "stream": lambda: check_stream(torch, results),
        "chunk": lambda: check_chunk(torch, results),
        "ring": lambda: check_ring(torch, results),
        "longctx": lambda: check_longctx(torch, results),
        "vit": lambda: check_vit(torch, results, workdir),
        "detect": lambda: check_detect(torch, results, workdir),
        "segment": lambda: check_segment(torch, results),
        "vision": lambda: check_vision(torch, results, workdir),
        "upload": lambda: check_upload(torch, results, workdir),
        "batch": lambda: check_batch(torch, results),
        "hostspans": lambda: check_hostspans(torch, results, workdir),
        "serve": lambda: check_serve(torch, results, workdir),
    }
    only = None
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        unknown = sorted(set(only) - set(phases))
        if unknown:
            print(f"chip_smoke: unknown phases {unknown}; phases are "
                  f"{sorted(phases)}", file=sys.stderr)
            return 2
    for name, run in phases.items():
        if only is None or name in only:
            run()
    if only is not None:
        return 0

    src = {"fused_inverted_residual": "nnstreamer_tpu_torch/csrc/fused_block.cu",
           "normalize_u8": "nnstreamer_tpu_torch/csrc/preprocess.cu",
           "arith_chain": "nnstreamer_tpu_torch/csrc/transform_ops.cu",
           "flash_attention": "nnstreamer_tpu_torch/csrc/attention.cu",
           "flash_chunk": "nnstreamer_tpu_torch/csrc/attention.cu"}
    rep = {"fused_inverted_residual": "nnstreamer_tpu/ops/fused_block.py:430",
           "normalize_u8": "nnstreamer_tpu/ops/preprocess.py:63",
           "arith_chain": "nnstreamer_tpu/ops/transform_ops.py:75",
           "flash_attention": "nnstreamer_tpu/ops/attention.py:180",
           "flash_chunk": "nnstreamer_tpu/ops/attention.py:347"}
    # launches summed over the main-path runs of every line
    launches = {name: sum(results[run].get(name, 0) for run in (
        "launches", "stream_launches", "vit_launches", "ring_launches",
        "longctx_launches", "upload_launches", "batch_launches",
        "hostspans_launches", "detect_launches", "detect_pp_launches",
        "segment_launches", "vision_launches", "serve_launches"))
        for name in src}
    launches["arith_chain"] += results["arith_launches"]
    kernels = []
    for name in src:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": rep[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            "device_ms": r.get("device_ms")})
    # the fused block's rows at the SSD and DeepLab lines' shapes
    kernels[0]["models"] = {name: results[f"fused_{name}"]
                            for name in ("ssd_mobilenet", "deeplab_v3")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
