"""Drive the PyTorch/CUDA port (nnstreamer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device     the card (nvidia-smi name and power limit), torch and CUDA
             versions, and the time it took to build the kernel library
             from csrc/ with nvcc;
  kernel     every hand-written kernel against its plain PyTorch version on
             the card, at the flagship path's shapes: max abs error against
             the stated tolerance, kernel and plain times (CUDA events,
             median of 20 after warm-up) and the least time the card could
             take for the same work (bytes at 3.35 TB/s or operations at
             the peak rate for their type, whichever is larger);
  slice      the flagship image-labeling line through the port's
             parse_launch at full width (MobileNet-v2 1.0, 224x224 RGB,
             1001 classes, 128 frames per tensor): one label per frame,
             the fused-block kernel launched 13 times and normalize_u8 once
             per forward, the filter's logits against the plain (fused:xla)
             forward, frames per second and p50 batch latency;
  profile    one more run of the line under torch.profiler: device time
             by kernel and the device's idle share;
  transform  tensor_transform acceleration=device bit-equal to numpy;

then one ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that last line. It needs a CUDA card: without one it exits 1 at once.
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
    """Median of ``reps`` CUDA-event timings of fn(), after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
            row["plain_ms"] = cuda_ms(
                lambda: arith_chain_plain(x, ops, torch.float32))
            row["bound_ms"], row["bound_by"] = bound_ms(5 * n, 3 * n, "float32")
            results["arith_chain"] = row
        emit("kernel", **row)
        if err != 0.0:
            raise AssertionError(f"arith_chain {row}")


def _stride1_blocks(model):
    """(index, H, W, folded) of the stride-1 blocks at SIZE."""
    from nnstreamer_tpu_torch.ops.fused_block import fold_inverted_residual

    out, hw = [], SIZE // 2
    for i, blk in enumerate(model.blocks):
        hw = -(-hw // blk.stride)
        if blk.stride == 1:
            out.append((i, hw, hw, fold_inverted_residual(blk)))
    return out


def check_fused_block(torch, results):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import (
        MobileNetV2,
        init_weights,
    )
    from nnstreamer_tpu_torch.ops.fused_block import (
        cast_folded,
        fused_inverted_residual,
        inverted_residual_plain,
    )

    model = MobileNetV2()
    init_weights(model, 0)
    blocks = _stride1_blocks(model)
    if len(blocks) != 13:
        raise AssertionError(f"expected 13 stride-1 blocks, got {len(blocks)}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "bytes": 0.0, "ops": 0.0}
    # bf16 at every main-path shape; tolerance: kernel and plain round at
    # the same points, only the order of the float32 sums differs, which
    # flips an occasional bf16 rounding (1 ulp = 2^-8 relative) — allow 4
    bf_atol, bf_rtol = 2.0 ** -6, 2.0 ** -6
    for i, H, W, fw in blocks:
        fwc = cast_folded(fw, torch.bfloat16, "cuda")
        Cin = fwc["w1"].shape[0] if "w1" in fwc else fwc["wd"].shape[1]
        Ch, Cout = fwc["wd"].shape[1], fwc["w2"].shape[1]
        x = torch.randn((BATCH, H, W, Cin), generator=gen, device="cuda")
        x = x.clamp(-3, 3).to(torch.bfloat16)
        k = fused_inverted_residual(x, fwc)
        p = inverted_residual_plain(x, fwc)
        err = max_err(k, p)
        ok = within(k, p, bf_atol, bf_rtol)
        ms = cuda_ms(lambda: fused_inverted_residual(x, fwc))
        plain_ms = cuda_ms(lambda: inverted_residual_plain(x, fwc), reps=20,
                           warmup=2)
        nbytes = 2 * BATCH * H * W * (Cin + Cout) + 2 * sum(
            v.numel() for kk, v in fwc.items() if kk.startswith("w")) + 4 * sum(
            v.numel() for kk, v in fwc.items() if kk.startswith("b"))
        ops = 2.0 * BATCH * H * W * (
            (Cin * Ch if "w1" in fwc else 0) + 9 * Ch + Ch * Cout)
        b_ms, b_by = bound_ms(nbytes, ops, "bfloat16")
        emit("kernel", kernel="fused_inverted_residual", block=i,
             shape=[BATCH, H, W, Cin, Ch, Cout], dtype="bfloat16",
             max_abs_err=err, atol=bf_atol, rtol=bf_rtol, ok=ok, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if not ok:
            raise AssertionError(f"fused block {i} disagrees: {err}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["err"] = max(tot["err"], err)
        tot["bytes"] += nbytes
        tot["ops"] += ops
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
    emit("kernel", kernel="fused_inverted_residual", block=i,
         shape=list(x.shape), dtype="float32", max_abs_err=err, atol=1e-4,
         rtol=1e-4, ok=ok)
    if not ok:
        raise AssertionError(f"fused block f32 disagrees: {err}")
    # a prime size with a ragged output-channel tile (Cout > the tile the
    # accumulators hold at W=113), which the JAX package's tiling gate
    # would send to XLA: here it runs the kernel
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
    err_r = max_err(k, p)
    ok = within(k, p, bf_atol, bf_rtol)
    emit("kernel", kernel="fused_inverted_residual", block="prime",
         shape=[4, 113, 113, Cin, Ch, Cout], dtype="bfloat16",
         max_abs_err=err_r, atol=bf_atol, rtol=bf_rtol, ok=ok)
    if not ok:
        raise AssertionError(f"fused block at 113x113 disagrees: {err_r}")
    err = max(err, err_r)
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], "bfloat16")
    results["fused_inverted_residual"] = {
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "max_abs_err": max(tot["err"], err), "bound_ms": b_ms,
        "bound_by": b_by}


# -- phase: the flagship slice ---------------------------------------------

def _flagship(labels: str, fused: str = "pallas") -> str:
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        f"! tensor_filter name=f framework=jax model=mobilenet_v2 "
        f"custom=seed:0,postproc:argmax,fused:{fused} "
        f"fetch-window={FETCH_WINDOW} "
        f"! queue ! tensor_decoder mode=image_labeling option1={labels} "
        f"! tensor_sink name=out")


def _drive(torch, labels, frames, n_batches):
    """Push n_batches of frames through the flagship line; returns
    (labels per batch, seconds, p50 batch latency ms, pipeline)."""
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(_flagship(labels))
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
        raise TimeoutError("flagship line did not reach EOS")
    secs = time.perf_counter() - t0
    if p.bus.error is not None:
        raise RuntimeError(f"flagship line failed: {p.bus.error.data}")
    lat = [(arrived[k] - pushed[k]) * 1e3 for k in arrived]
    out = [b.meta["label"] for b in p["out"].collected]
    return out, secs, statistics.median(lat), p


def check_slice(torch, results, workdir):
    import numpy as np

    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.ops import _cuda

    labels = os.path.join(workdir, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    # frames of 4x4 blocks of flat colour, so they differ in content
    rng = np.random.default_rng(0)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    # warm-up run (cuDNN/cuBLAS plans, allocator) — not the measured one
    _, _, _, p = _drive(torch, labels, frames, 2)
    p.stop()
    _cuda.reset_launches()
    out, secs, p50, p = _drive(torch, labels, frames, N_BATCHES)
    launches = dict(_cuda.LAUNCHES)
    forward = p["f"].fw._bundle.apply_fn  # the filter's own forward
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
    # the filter's logits for one batch against the plain (fused:xla)
    # forward on the same weights
    x = torch.from_numpy(np.stack(frames)).cuda()
    with torch.inference_mode():
        got = forward(x).float()
        plain = get_model("mobilenet_v2", {"seed": "0", "fused": "xla"},
                          "cuda").apply_fn(x).float()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    ok = finite and within(got, plain, 0.15, 0.05)
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    emit("slice", frames=n_frames, batches=len(out), seconds=secs,
         fps=n_frames / secs, p50_batch_latency_ms=p50,
         fetch_window=FETCH_WINDOW, launches=launches,
         logits_max_abs_err=max_err(got, plain), logits_atol=0.15,
         logits_rtol=0.05, logits_ok=ok, argmax_agreement=agree,
         distinct_labels=len({lab for b in out for lab in b}),
         card=results["card"])
    if not ok:
        raise AssertionError("filter logits disagree with the plain forward")
    profile_slice(torch, labels, frames)


def profile_slice(torch, labels, frames, n_batches: int = 4) -> None:
    """One more run of the line under torch.profiler: device time by
    kernel name and the device's idle share over the run's wall time
    (first push to EOS). Device times are null when the profiler sees no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, secs, _, p = _drive(torch, labels, frames, n_batches)
        p.stop()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        by_name[e.key] = by_name.get(e.key, 0) + us
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = secs * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", batches=n_batches, wall_ms=wall_ms,
         device_busy_ms=busy_ms or None,
         idle_share=(1.0 - busy_ms / wall_ms) if busy_ms else None,
         top_device=[{"name": k[:90], "ms": v / 1e3} for k, v in top])


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
    check_elementwise(torch, results)
    check_fused_block(torch, results)
    check_slice(torch, results, workdir)
    check_transform(torch, results)

    src = {"fused_inverted_residual": "nnstreamer_tpu_torch/csrc/fused_block.cu",
           "normalize_u8": "nnstreamer_tpu_torch/csrc/preprocess.cu",
           "arith_chain": "nnstreamer_tpu_torch/csrc/transform_ops.cu"}
    rep = {"fused_inverted_residual": "nnstreamer_tpu/ops/fused_block.py:430",
           "normalize_u8": "nnstreamer_tpu/ops/preprocess.py:63",
           "arith_chain": "nnstreamer_tpu/ops/transform_ops.py:75"}
    launches = dict(results["launches"], arith_chain=results["arith_launches"])
    kernels = []
    for name in ("fused_inverted_residual", "normalize_u8", "arith_chain"):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": rep[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
