"""Probe the fused-block kernel's plans and the flagship's device memory on
the card.

``plans``: for each stride-2 block of MobileNet-v2 1.0 (224 px, seed-0
weights) at ``--batch``, every (R, Cc) tile plan of the bfloat16 body
that fits the card's shared memory and the warps' fragments, launched in
the planner's place: its device ms (CUDA events around back-to-back
launches) and max error against the plain version, beside the plan
``ops.fused_block._plan_tiles`` picks.

``memory``: the flagship's composition (the filter's program: the
``typecast:float32,add:-127.5,div:127.5`` preamble fused, or not, then
the folded forward and the argmax) at ``--batch``, once on the card under
a dispatch mode that reads the CUDA allocator around every op, and once
on meta tensors as the cost model bills it for a filter on the card
(``analysis.costmodel.program_cost(..., card=True)``): each run's peak
above its entry, the op it peaks in, and the card's largest transient
inside one op (a workspace the op frees before it returns).

    python3 -m nnstreamer_tpu_torch.tools.fused_block_probe plans
    python3 -m nnstreamer_tpu_torch.tools.fused_block_probe memory

One JSON line per block or line on stdout, each with the card's name and
power limit. Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

#: the preamble the memory probe fuses into the filter (the reference
#: pipelines' tensor_transform)
PREAMBLE = [("arith", [("add", -127.5), ("div", 127.5)])]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def probe_plans(batch: int, card: str) -> None:
    from nnstreamer_tpu_torch.models.mobilenet_v2 import (
        MobileNetV2,
        init_weights,
    )
    from nnstreamer_tpu_torch.ops import fused_block as fb

    model = MobileNetV2()
    init_weights(model, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    planner = fb._plan_tiles
    hw = 112
    for i, blk in enumerate(model.blocks):
        if blk.stride != 2:
            hw = -(-hw // blk.stride)
            continue
        fw = fb.fold_inverted_residual(blk)
        cin, ch = blk.expand_conv.in_channels, blk.dw_conv.out_channels
        cout, ho = blk.proj_conv.out_channels, -(-hw // 2)
        x = torch.randn((batch, hw, hw, cin), generator=gen, device="cuda")
        x = x.clamp(-3, 3).to(torch.bfloat16)
        chosen = planner(hw, hw, cin, ch, cout, 2, True, 2)
        rows = []
        for r in sorted({-(-ho // n) for n in range(1, ho + 1)}):
            fit = fb._tc_fit(r, ho, cout)
            if fit is None or (r > 1 and r * ho > fb._TC_MAX_PIXELS):
                continue
            for cc in fb._TC_CHUNKS:
                smem = fb._tc_smem(hw, hw, cin, cout, r, cc, True, 2)
                if smem > fb._SMEM_BUDGET:
                    continue
                plan = fb.FusedPlan("tc", r, cc, cout, fit[0], fit[1],
                                    smem, 2)
                # a fresh folded dict: its launch arguments are built anew
                fwc = fb.cast_folded(fw, torch.bfloat16, "cuda")
                fb._plan_tiles = lambda *a, plan=plan: plan
                try:
                    k = fb.fused_inverted_residual(x, fwc, stride=2)
                    p = fb.inverted_residual_plain(x, fwc, stride=2)
                    err = float((k.float() - p.float()).abs().max())
                    ms = _device_ms(
                        lambda: fb.fused_inverted_residual(x, fwc, stride=2))
                finally:
                    fb._plan_tiles = planner
                rows.append({"R": r, "Cc": cc, "smem": smem, "ms": ms,
                             "max_abs_err": err,
                             "chosen": (r, cc) == (chosen.R, chosen.Cc)})
        rows.sort(key=lambda row: row["ms"])
        print(json.dumps({"probe": "plans", "block": i,
                          "shape": [batch, hw, hw, cin, ch, cout],
                          "chosen": {"R": chosen.R, "Cc": chosen.Cc},
                          "chosen_rank": next(n for n, row in enumerate(rows)
                                              if row["chosen"]),
                          "plans": rows, "card": card}), flush=True)
        hw = ho


def probe_memory(batch: int, card: str) -> None:
    from torch.utils._python_dispatch import TorchDispatchMode

    from nnstreamer_tpu_torch.analysis import costmodel

    custom = {"seed": "0", "postproc": "argmax", "fused": "pallas"}
    shape = [costmodel.ShapeDtype((batch, 224, 224, 3), "uint8")]
    for line, pre in (("preamble", PREAMBLE), ("normalize_u8", [])):
        fn, module, _ = costmodel.composition("mobilenet_v2", custom, pre,
                                              (), device="cuda")
        x = torch.randint(0, 256, shape[0].shape, dtype=torch.uint8,
                          device="cuda")
        with torch.no_grad():
            fn(module, x)  # warm-up: cuDNN plans, the kernels' arguments
        torch.cuda.synchronize()
        ops = []

        class Allocator(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated() - base
                out = func(*args, **(kwargs or {}))
                after = torch.cuda.memory_allocated() - base
                peak = torch.cuda.max_memory_allocated() - base
                ops.append((str(func), before, peak, after))
                return out

        base = torch.cuda.memory_allocated()
        with torch.no_grad(), Allocator():
            fn(module, x)
        torch.cuda.synchronize()
        top = max(range(len(ops)), key=lambda n: ops[n][2])
        transient = max(ops, key=lambda o: o[2] - max(o[1], o[3]))
        meta_fn, meta_module, _ = costmodel.meta_composition(
            "mobilenet_v2", custom, pre)
        bill = costmodel.program_cost(meta_fn, meta_module, shape, card=True)
        print(json.dumps({
            "probe": "memory", "line": line, "batch": batch,
            "card_peak_bytes": ops[top][2], "card_peak_op": ops[top][0],
            "card_peak_op_before_bytes": ops[top][1],
            "largest_transient": {"op": transient[0], "bytes": transient[2]
                                  - max(transient[1], transient[3])},
            "billed_activation_bytes": (bill["peak_live_bytes"]
                                        - bill["param_bytes"]
                                        - bill["input_bytes"]),
            "card": card}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("plans", "memory"))
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fused_block_probe runs on a CUDA card")
    card = _card()
    (probe_plans if args.probe == "plans" else probe_memory)(args.batch, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
