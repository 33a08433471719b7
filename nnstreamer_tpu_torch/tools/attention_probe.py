"""Time the attention kernels at the given head dims on the card.

For each head dim: the flash kernel (``flash_attention_cuda``) causal and
not, and the chunk kernel's diagonal hop (``flash_chunk_cuda`` on carries
from a past hop), at ``bh`` heads of ``seq`` rows in one dtype. Each row
gives the kernel's ms (CUDA events around back-to-back calls, the median
of 5 groups), its device ms (torch.profiler, the kernel alone), the
instance it ran (``flash_kernel_attributes``), its max error against
``plain_attention`` (flash) or the plain chunk update at 128-key blocks
(chunk), and, for the flash rows, the time of torch's
``scaled_dot_product_attention`` on the same inputs (timed only). Every
row carries the card's name and power limit and the package it timed.

It uses only functions that every version of the port's attention module
has, so that two trees can be timed in turns on one card, each from its
own checkout::

    PYTHONPATH=<checkout> python3 nnstreamer_tpu_torch/tools/attention_probe.py \\
        --dims 256,384,512 --label parent

One JSON line per row on stdout. Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    groups, times = 5, []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(max(1, reps // groups)):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / max(1, reps // groups))
    return statistics.median(times)


def _device_ms(fn, name: str, calls: int = 5):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = [e.device_time_total for e in prof.key_averages()
             if name in e.key]
    return sum(total) / calls / 1e3 if total else None


def rows(dims, dtype, bh: int, seq: int, seed: int = 0):
    import torch.nn.functional as F

    import nnstreamer_tpu_torch
    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention_cuda,
        flash_chunk_cuda,
        flash_chunk_plain,
        flash_kernel_attributes,
        plain_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    card, pkg = _card(), nnstreamer_tpu_torch.__file__
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for d in dims:
        q, k, v, k0, v0 = (torch.randn((bh, seq, d), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(5))
        for causal in (False, True):
            def kern():
                return flash_attention_cuda(q, k, v, causal=causal)

            def library():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal)

            err = float((kern().float() - plain_attention(
                q, k, v, causal=causal).float()).abs().max())
            yield {"kernel": "flash_attention", "d": d, "causal": causal,
                   "shape": [bh, seq, d], "dtype": str(dtype),
                   "max_abs_err_vs_plain_attention": err,
                   "ms": _ms(kern), "device_ms": _device_ms(kern, "flash_fwd"),
                   "library_ms": _ms(library),
                   "instance": flash_kernel_attributes(d, dtype=dtype),
                   "card": card, "package": pkg}
        scale = 1.0 / d ** 0.5
        carries = flash_chunk_plain(
            q, k0, v0, torch.full((bh, seq), -1e30, device="cuda"),
            torch.zeros((bh, seq), device="cuda"),
            torch.zeros((bh, seq, d), device="cuda"), q_offset=seq,
            k_offset=0, causal=True, scale=scale, block_k=128)
        kw = dict(q_offset=seq, k_offset=seq, causal=True, scale=scale)
        work = [c.clone() for c in carries]

        def hop():
            return flash_chunk_cuda(q, k, v, *work, **kw)

        got = flash_chunk_cuda(q, k, v, *[c.clone() for c in carries], **kw)
        want = flash_chunk_plain(q, k, v, *carries, block_k=128, **kw)
        err = float((got[2] / got[1][..., None] - want[2] / want[1][..., None])
                    .abs().max())
        yield {"kernel": "flash_chunk", "d": d, "case": "diagonal",
               "shape": [bh, seq, seq, d], "dtype": str(dtype),
               "max_abs_err_vs_plain_128": err, "ms": _ms(hop),
               "device_ms": _device_ms(hop, "flash_chunk"),
               "instance": flash_kernel_attributes(d, carry=True,
                                                   dtype=dtype),
               "card": card, "package": pkg}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dims", default="256,384,512")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--bh", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("attention_probe times the kernels on a card; "
                           "torch sees none")
    dims = [int(x) for x in args.dims.split(",")]
    for row in rows(dims, getattr(torch, args.dtype), args.bh, args.seq):
        print(json.dumps({"label": args.label, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
