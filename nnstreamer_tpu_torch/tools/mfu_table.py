"""A per-model MFU table on the card (counterpart of the JAX package's
``tools/mfu_table.py``).

Each row is one measurement of device compute per forward:

  - time: chained differencing on CUDA graphs. ``k_lo`` (1) and ``k_hi``
    (17) back-to-back applies are each captured in one CUDA graph; the
    two graphs are replayed in turns, each replay between two CUDA
    events, and ``(t_hi - t_lo) / (k_hi - k_lo)`` is one rep's device ms
    per apply. The row is the median of at least 5 reps, with min and
    max. A replay launches no Python, so the host time of the wrappers
    (ctypes launches, dispatch) stays out of the number, and the
    difference cancels the graph launch itself;
  - FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` on the row's
    forward with every hand-written kernel replaced by convolutions or
    matmuls that compute the same function (the counter cannot see a
    ctypes launch): MobileNet-v2's ``fused:pallas`` row is counted on its
    ``fused:xla`` forward, whose blocks are three convolutions each, and
    ViT on its twin with ``plain_attention``. It counts 2·MACs of
    convolutions and matmuls; elementwise work (BatchNorm, relu6,
    biases) is not counted, where XLA's cost analysis counts it;
  - MFU against the H100 SXM's dense bf16 peak, :data:`PEAK_TFLOPS`.

Sections, as in the JAX tool: MobileNet-v2 at batch 128/256/512 with
float32 and bf16 weights and ``fused:xla`` on uint8 frames, the
``fused:pallas`` forward the flagship runs (kernels 1 and 2), NCHW frames
permuted on the card; ViT-S/16 at depth 6 at batch 32/128; the causal
8x8192x128 bf16 flash rows (the CUDA kernel against the blockwise plain
version, interleaved) with the analytic count ``0.5·4·B·S²·D``; and the
quantized MobileNet-v2 rows when :data:`QUANT_TFLITE` exists in the
checkout. Every row carries the card's name and power limit and whether
TF32 was on.

Run on the card: ``python -m nnstreamer_tpu_torch.tools.mfu_table
[--quick] [--out PATH]``. It prints one JSON line per row and writes the
table to ``--out`` (``build/probes/MFU_TABLE.cuda.json`` in the checkout
by default, a directory git ignores). A table with an errored row does
not replace the last good one: it goes beside it as
``<out>.failed.json`` and the exit code is 1. Without a card it raises.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

#: NVIDIA H100 SXM, dense bf16 (the data sheet's rate at 700 W)
PEAK_TFLOPS = 989.0

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the reference's quantized MobileNet-v2, where a checkout holds it
QUANT_TFLITE = os.path.join(ROOT, "tests", "test_models", "models",
                            "mobilenet_v2_1.0_224_quant.tflite")

DEFAULT_OUT = os.path.join(ROOT, "build", "probes",
                           "MFU_TABLE.cuda.json")

#: the differenced signal (k_hi - k_lo applies) must dwarf the events'
#: resolution and the clock's settling: the chain doubles until it holds
#: this many seconds of device work or k_hi reaches K_CAP
MIN_SIGNAL_S = 0.05
K_CAP = 129

METHOD = ("chained differencing on CUDA graphs: k_lo=1 and k_hi=17 "
          "back-to-back applies, each captured in one graph, replayed in "
          "turns between CUDA events; per-rep paired diffs over "
          "k_hi-k_lo, row = median of >=5 reps with min/max; k_hi doubles "
          f"until the diff holds {MIN_SIGNAL_S} s of device work; flops = "
          "torch.utils.flop_counter.FlopCounterMode (2*MACs of "
          "convolutions and matmuls) on the row's forward with every "
          "hand-written kernel replaced by convolutions/matmuls computing "
          "the same function (fused:pallas counted on fused:xla, ViT on "
          "its plain_attention twin); elementwise work not counted")


def require_card() -> None:
    """A timing path runs on the card or not at all."""
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times device work and needs a CUDA "
                           "device; torch sees none")


def card_stamp(clocks: bool = True) -> Dict[str, str]:
    """The card's name and power limit (and its SM clock and temperature
    now), as ``nvidia-smi`` reads them."""
    keys = ["name", "power.limit"] + (
        ["clocks.sm", "temperature.gpu"] if clocks else [])
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)[:160]}
    vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(keys, vals))


def tf32_state() -> Dict[str, bool]:
    return {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}


def _graph(fn: Callable, x: torch.Tensor, k: int):
    """k back-to-back ``fn(x)`` captured in one CUDA graph; returns the
    graph and the kernel launches its capture recorded."""
    from nnstreamer_tpu_torch.ops import _cuda

    graph = torch.cuda.CUDAGraph()
    with _cuda.recording_launches() as launches, torch.inference_mode(), \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(k):
            fn(x)
    return graph, dict(launches)


def _replay_ms(graph) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


class _Chain:
    """One forward's two graphs (k_lo and k_hi applies) and the applies
    their replays ran."""

    def __init__(self, fn: Callable, x: torch.Tensor, k_lo: int, k_hi: int):
        self.k_lo, self.applies, self.diffs = k_lo, 0, []
        self.g_lo, per = _graph(fn, x, k_lo)
        self.per_apply = {k: v // k_lo for k, v in per.items() if v}
        while True:
            self.k_hi = k_hi
            self.g_hi, _ = _graph(fn, x, k_hi)
            self.replay(self.g_lo), self.replay(self.g_hi)  # first: upload
            diff = self.replay(self.g_hi) - self.replay(self.g_lo)
            if diff / 1e3 >= MIN_SIGNAL_S or k_hi >= K_CAP:
                break
            del self.g_hi
            k_hi = k_hi * 2 - 1

    def replay(self, g) -> float:
        self.applies += self.k_lo if g is self.g_lo else self.k_hi
        return _replay_ms(g)

    def rep(self) -> None:
        t_lo = self.replay(self.g_lo)
        t_hi = self.replay(self.g_hi)
        self.diffs.append(max((t_hi - t_lo) / (self.k_hi - self.k_lo),
                              1e-7))

    def result(self) -> Dict[str, object]:
        diffs = sorted(self.diffs)
        return {"ms": statistics.median(diffs), "ms_min": diffs[0],
                "ms_max": diffs[-1], "reps": len(diffs), "k_hi": self.k_hi,
                "launches_per_apply": dict(self.per_apply),
                "graph_launches": {k: v * self.applies
                                   for k, v in self.per_apply.items()}}


def interleaved_ms(fns: Mapping[str, Callable], x: torch.Tensor,
                   k_lo: int = 1, k_hi: int = 17, reps: int = 5
                   ) -> Dict[str, Dict[str, object]]:
    """Device ms per apply of each ``fns[tag](x)`` by chained differencing
    on CUDA graphs, the variants' replays interleaved rep by rep (one
    clock and thermal state decides between them). Per tag: ``ms`` (the
    median of the reps' paired differences), ``ms_min``, ``ms_max``,
    ``reps``, ``k_hi``, ``launches_per_apply`` (the hand-written kernels
    one apply launches, from the capture) and ``graph_launches`` (the
    launches all its replays made)."""
    require_card()
    if not x.is_cuda:
        raise RuntimeError("chained differencing times CUDA tensors; got "
                           f"one on {x.device}")
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side), torch.inference_mode():
        for fn in fns.values():  # builds, folds, plans, picks algorithms
            fn(x)
            fn(x)
    stream.wait_stream(side)
    torch.cuda.synchronize()
    chains = {tag: _Chain(fn, x, k_lo, k_hi) for tag, fn in fns.items()}
    for _ in range(reps):
        for c in chains.values():
            c.rep()
    res = {tag: c.result() for tag, c in chains.items()}
    del chains
    torch.cuda.synchronize()
    return res


def chain_ms(apply_fn: Callable, x: torch.Tensor, k_lo: int = 1,
             k_hi: int = 17, reps: int = 5) -> Dict[str, object]:
    """:func:`interleaved_ms` of one forward."""
    return interleaved_ms({"_": apply_fn}, x, k_lo, k_hi, reps)["_"]


def cost_flops(count_fn: Callable, x: torch.Tensor) -> Optional[float]:
    """FLOPs of one ``count_fn(x)`` as FlopCounterMode counts them (2·MACs
    of convolutions and matmuls); None when it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        count_fn(x)
    return float(counter.get_total_flops()) or None


def _row(name: str, apply_fn: Callable, x, batch: int,
         flops: Optional[float], timer: Callable = chain_ms,
         card: Optional[Mapping[str, str]] = None) -> Dict[str, object]:
    """One table row: ``timer(apply_fn, x)``'s device ms (a fault costs
    the row, not the table) and ``flops`` a forward."""
    try:
        m = timer(apply_fn, x)
    except Exception as e:  # noqa: BLE001 — a row's fault is its own
        return {"config": name, "batch": batch, "error": str(e)[:200]}
    return measured_row(name, batch, m, flops, card)


def measured_row(name: str, batch: int, m: Mapping[str, object],
                 flops: Optional[float],
                 card: Optional[Mapping[str, str]] = None
                 ) -> Dict[str, object]:
    """A row from a timing ``m`` (:func:`interleaved_ms`'s per-tag
    result) and ``flops`` a forward (None: no rate)."""
    ms = m["ms"]
    row: Dict[str, object] = {
        "config": name,
        "batch": batch,
        "device_ms_per_batch": ms,
        "device_ms_min": m["ms_min"],
        "device_ms_max": m["ms_max"],
        "reps": m["reps"],
        "k_hi": m["k_hi"],
        "device_fps": batch / ms * 1e3,
        "launches_per_apply": m.get("launches_per_apply", {}),
        "graph_launches": m.get("graph_launches", {}),
        "tf32": tf32_state(),
        "card": dict(card or {}),
    }
    # a rep whose paired diff collapsed poisons min-derived statistics:
    # flag the row instead of publishing a best MFU
    noisy = m["ms_min"] < 0.5 * ms
    if noisy:
        row["noisy_reps"] = True
    if flops:
        tflops = flops / (ms / 1e3) / 1e12
        row["gflops_per_batch"] = flops / 1e9
        row["tflops_per_sec"] = tflops
        row["mfu_pct"] = tflops / PEAK_TFLOPS * 100
        if row["mfu_pct"] > 100.0:
            row["unreliable"] = True  # physically impossible: the timing
        if not noisy:
            best = flops / (m["ms_min"] / 1e3) / 1e12 / PEAK_TFLOPS * 100
            if best > 100.0:
                row["unreliable"] = True
            else:
                row["mfu_pct_best"] = best
    return row


def _bf16_weights(model):
    """The module with its conv and Dense weights in bf16; BatchNorm
    stays float32 (the port's BatchNorm normalizes in float32)."""
    import copy

    m = copy.deepcopy(model)
    for mod in m.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.to(torch.bfloat16)
    return m


def mobilenet_forwards(custom: Optional[Mapping[str, str]] = None,
                       device="cuda") -> Dict[str, tuple]:
    """The MobileNet-v2 section's forwards of uint8 NHWC frames, by row
    name: (the forward timed, the forward its FLOPs are counted on). The
    ``fused:pallas`` forward (kernels 1 and 2) is counted on
    ``fused:xla``, the same function with its blocks as convolutions."""
    from nnstreamer_tpu_torch.models import get_model, preprocess_frames

    custom = {"seed": "0", **dict(custom or {})}
    model = get_model("mobilenet_v2", custom, device).module
    model16 = _bf16_weights(model)
    xla = get_model("mobilenet_v2", {**custom, "fused": "xla"},
                    device).apply_fn
    pallas = get_model("mobilenet_v2", {**custom, "fused": "pallas"},
                       device).apply_fn

    def unfused(m):
        return lambda x: m(preprocess_frames(x, "pm1", m.dtype))

    f32, bf16 = unfused(model), unfused(model16)
    return {"mobilenet_v2 f32-params uint8-in": (f32, f32),
            "mobilenet_v2 bf16-params uint8-in": (bf16, bf16),
            "mobilenet_v2 fused:xla (BN-folded)": (xla, xla),
            "mobilenet_v2 fused:pallas (BN-folded, kernels)": (pallas, xla)}


def _mobilenet_rows(rows, rng, quick, card):
    forwards = mobilenet_forwards()
    batches = [128] if quick else [128, 256, 512]
    for b in batches:
        x = torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3),
                                          np.uint8)).cuda()
        for name, (fwd, count) in forwards.items():
            rows.append(_row(name, fwd, x, b, cost_flops(count, x),
                             card=card))
        del x
    # NCHW frames, permuted to NHWC on the card
    b = batches[0]
    x_nchw = torch.from_numpy(np.ascontiguousarray(
        rng.integers(0, 256, (b, 224, 224, 3), np.uint8)
        .transpose(0, 3, 1, 2))).cuda()
    f32 = forwards["mobilenet_v2 f32-params uint8-in"][0]

    def apply_nchw(x):
        return f32(x.permute(0, 2, 3, 1))

    rows.append(_row("mobilenet_v2 f32-params NCHW-in(+device permute)",
                     apply_nchw, x_nchw, b, cost_flops(apply_nchw, x_nchw),
                     card=card))


def _vit_rows(rows, rng, quick, card):
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.models.vit import ViT
    from nnstreamer_tpu_torch.ops.attention import plain_attention

    cfg = {"size": 224, "patch": 16, "depth": 6, "dim": 384, "heads": 6,
           "classes": 1000}
    vit = get_model("vit", {"seed": "0", **{k: str(v) for k, v in
                                            cfg.items()}})
    twin = ViT(**cfg, attention=plain_attention)
    twin.load_state_dict(vit.module.state_dict())
    twin = twin.cuda().eval()
    for b in ([32] if quick else [32, 128]):
        x = torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3), np.uint8)
                             .astype(np.float32) / 255.0).cuda()
        rows.append(_row("vit_s16 bf16", vit.apply_fn, x, b,
                         cost_flops(twin, x), card=card))


#: the causal flash rows' shape: (batch·heads, seq, head_dim)
FLASH_SHAPE = (8, 8192, 128)


def flash_flops(bh: int, s: int, d: int) -> float:
    """Causal attention's matmul work: half of 4·B·S²·D (the JAX
    tool's analytic count)."""
    return 0.5 * 4 * bh * s ** 2 * d


def _flash_rows(rows, rng, card):
    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_cuda,
    )

    bh, s, d = FLASH_SHAPE
    q = torch.from_numpy(rng.normal(size=FLASH_SHAPE)).to(
        torch.bfloat16).cuda()
    fns = {
        "flash-attn cuda": lambda a: flash_attention_cuda(a, a, a,
                                                          causal=True),
        "flash-attn blockwise b256": lambda a: flash_attention(
            a, a, a, causal=True, block_size=256),
    }
    flops = flash_flops(bh, s, d)
    for tag, m in interleaved_ms(fns, q).items():
        rows.append(measured_row(
            f"{tag} causal {bh}x{s}x{d} bf16 (interleaved)", bh, m, flops,
            card))


def _quant_rows(rows, rng, card):
    from nnstreamer_tpu_torch.tools.import_tflite import load_tflite

    b = 128
    xq = torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3),
                                       np.uint8)).cuda()
    for custom, tag in (
            ({"quant": "int8"}, "quant-int8 carrier=f32 highest"),
            ({"quant": "int8", "precision": "default"},
             "quant-int8 carrier=f32 default"),
            ({"quant": "int8", "carrier": "bf16"}, "quant-int8 carrier=bf16"),
            ({"precision": "default"}, "fake-quant bf16-convs")):
        qb = load_tflite(QUANT_TFLITE, custom)
        rows.append(_row(f"mobilenet_quant {tag}", qb.apply_fn, xq, b,
                         cost_flops(qb.apply_fn, xq), card=card))
    variants = {
        "carrier=f32 default": {"quant": "int8", "precision": "default"},
        "carrier=bf16": {"quant": "int8", "carrier": "bf16"},
        "fake-quant bf16": {"precision": "default"},
    }
    fns = {tag: load_tflite(QUANT_TFLITE, custom).apply_fn
           for tag, custom in variants.items()}
    for tag, m in interleaved_ms(fns, xq).items():
        rows.append(measured_row(f"mobilenet_quant {tag} (interleaved)", b,
                                 m, None, card))


def build_rows(quick: bool = False) -> List[Dict[str, object]]:
    """Every section's rows on the card (a section's setup fault costs the
    section, not the table)."""
    require_card()
    rng = np.random.default_rng(0)
    card = card_stamp(clocks=False)
    rows: List[Dict[str, object]] = []
    sections = [("mobilenet section",
                 lambda: _mobilenet_rows(rows, rng, quick, card)),
                ("vit section",
                 lambda: _vit_rows(rows, rng, quick, card))]
    if not quick:
        sections.append(("flash-attn interleaved section",
                         lambda: _flash_rows(rows, rng, card)))
        if os.path.exists(QUANT_TFLITE):
            sections.append(("quant section",
                             lambda: _quant_rows(rows, rng, card)))
    for name, run in sections:
        try:
            run()
        except Exception as e:  # noqa: BLE001 — one section, not the table
            rows.append({"config": name, "error": str(e)[:200]})
        torch.cuda.empty_cache()
    return rows


def table(rows, before, after) -> Dict[str, object]:
    return {"peak_tflops_bf16": PEAK_TFLOPS, "method": METHOD,
            "quant_tflite": (QUANT_TFLITE if os.path.exists(QUANT_TFLITE)
                             else f"skipped: {QUANT_TFLITE} is not in the "
                                  "checkout"),
            "card_before": before, "card_after": after, "rows": rows}


def save(out: Dict[str, object], path: str) -> bool:
    """Write ``out`` to ``path``; a table with an errored row goes beside
    it as ``<path>.failed.json`` instead (the last good table stays).
    Returns whether the table was clean."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    failed = os.path.splitext(path)[0] + ".failed.json"
    clean = not any("error" in r for r in out["rows"])
    with open(path if clean else failed, "w") as f:
        json.dump(out, f, indent=1)
    if clean and os.path.exists(failed):
        os.remove(failed)  # a clean run supersedes a degraded record
    return clean


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    quick = "--quick" in argv
    out_path = (argv[argv.index("--out") + 1] if "--out" in argv
                else DEFAULT_OUT)
    require_card()
    before = card_stamp()
    rows = build_rows(quick=quick)
    for r in rows:
        print(json.dumps(r), flush=True)
    out = table(rows, before, card_stamp())
    if not save(out, out_path):
        errors = sum("error" in r for r in rows)
        print(f"{errors}/{len(rows)} rows errored: kept {out_path}, wrote "
              "the table beside it as .failed.json")
        return 1
    print(f"wrote {out_path} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
