"""Where do MobileNet-v2's device milliseconds go on the card?
(counterpart of the JAX package's ``tools/mbv2_breakdown.py``)

Every timing is :func:`tools.mfu_table.chain_ms` (chained differencing on
CUDA graphs), every FLOP count :func:`tools.mfu_table.cost_flops`
(FlopCounterMode, 2·MACs of convolutions and matmuls), on variants of the
network built here as bf16, channels-last modules:

  - cumulative truncated models (the stem, then after each of the 7
    ``MobileNetV2.CFG`` stages, headless) → per-stage device ms by
    differencing;
  - the full model with its head;
  - ablations at full scale: ``depthwise='skip'`` (the 3x3s removed, a
    strided slice where the stride is 2: the depthwise share of the
    time), ``'dense'`` (``groups=1``: the same network with every 3x3 a
    full convolution) and ``s2d_stem`` (the stride-2 3x3 stem on
    224x224x3 rewritten as a stride-1 2x2 conv on 112x112x12).

The variants take raw uint8 frames cast to bf16, as the JAX tool's do, and
their convolutions pad as flax's 'SAME' does (the extra row and column on
the high side; the s2d stem's even 2x2 kernel pads (0, 1)). Weights come
from :func:`init_seeded` (an explicit ``torch.Generator``), or from the
JAX tool's flax variables through :func:`from_jax_variables`.

Run on the card: ``python -m nnstreamer_tpu_torch.tools.mbv2_breakdown
[--quick] [--out PATH]``; writes ``build/probes/MBV2_BREAKDOWN.cuda.json``
in the checkout by default. Without a card it raises.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models.convert import _conv_bn_pair, _dense
from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    MobileNetV2,
    _make_divisible,
    _same_pad_nchw,
)
from nnstreamer_tpu_torch.tools import mfu_table

DEFAULT_OUT = os.path.join(mfu_table.ROOT, "build", "probes",
                           "MBV2_BREAKDOWN.cuda.json")

#: below ~50 µs a differenced row is noise: no rate is published for it
NOISE_FLOOR_MS = 0.05

DEPTHWISE = ("dw", "skip", "dense")


def _conv(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """NCHW 'SAME' conv in bf16 (flax pads the extra on the high side)."""
    k = conv.kernel_size[0]
    return F.conv2d(_same_pad_nchw(x, k, stride),
                    conv.weight.to(torch.bfloat16), stride=stride,
                    groups=conv.groups)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm in float32, rounded to bf16 (flax's
    ``BatchNorm(dtype=bfloat16)`` on float32 statistics)."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, training=False,
                        eps=bn.eps).to(torch.bfloat16)


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


class Block(nn.Module):
    """An inverted residual block with its depthwise conv as ``depthwise``
    says: ``dw`` (groups = hidden), ``dense`` (groups = 1) or ``skip``
    (none; a strided slice where the stride is not 1)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int,
                 depthwise: str):
        super().__init__()
        hidden = in_ch * expand
        self.stride, self.depthwise = stride, depthwise
        self.expand_conv = (nn.Conv2d(in_ch, hidden, 1, bias=False)
                            if expand != 1 else None)
        self.expand_bn = nn.BatchNorm2d(hidden) if expand != 1 else None
        if depthwise != "skip":
            self.dw_conv = nn.Conv2d(hidden, hidden, 3, stride=stride,
                                     groups=hidden if depthwise == "dw"
                                     else 1, bias=False)
            self.dw_bn = nn.BatchNorm2d(hidden)
        self.proj_conv = nn.Conv2d(hidden, out_ch, 1, bias=False)
        self.proj_bn = nn.BatchNorm2d(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand_conv is not None:
            h = _relu6(_bn(_conv(h, self.expand_conv), self.expand_bn))
        if self.depthwise != "skip":
            h = _relu6(_bn(_conv(h, self.dw_conv, self.stride), self.dw_bn))
        elif self.stride != 1:
            h = h[:, :, ::self.stride, ::self.stride]
        h = _bn(_conv(h, self.proj_conv), self.proj_bn)
        return h + x if self.residual else h


class Variant(nn.Module):
    """A MobileNet-v2 variant for the ablation probes, with the JAX tool's
    ``_build_variant`` options: NHWC frames (any dtype, cast to bf16 as
    they are) in; float32 logits out with the head, the NHWC float32
    features without it."""

    def __init__(self, keep_stages: Optional[int] = None, head: bool = True,
                 depthwise: str = "dw", s2d_stem: bool = False):
        super().__init__()
        if depthwise not in DEPTHWISE:
            raise ValueError(f"depthwise must be one of {DEPTHWISE}, got "
                             f"{depthwise!r}")
        cfg = MobileNetV2.CFG
        n_stages = len(cfg) if keep_stages is None else keep_stages
        self.s2d_stem, self.head = s2d_stem, head
        ch = _make_divisible(32)
        self.stem_conv = (nn.Conv2d(12, ch, 2, bias=False) if s2d_stem
                          else nn.Conv2d(3, ch, 3, stride=2, bias=False))
        self.stem_bn = nn.BatchNorm2d(ch)
        blocks = []
        for expand, c, n, s in cfg[:n_stages]:
            out_ch = _make_divisible(c)
            for i in range(n):
                blocks.append(Block(ch, out_ch, s if i == 0 else 1, expand,
                                    depthwise))
                ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        if head:
            last = _make_divisible(1280)
            self.head_conv = nn.Conv2d(ch, last, 1, bias=False)
            self.head_bn = nn.BatchNorm2d(last)
            self.classifier = nn.Linear(last, 1001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        if self.s2d_stem:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            stride = 1
        else:
            stride = 2
        # NHWC memory read as NCHW: the channels-last layout, no copy
        y = _relu6(_bn(_conv(x.permute(0, 3, 1, 2), self.stem_conv, stride),
                       self.stem_bn))
        for blk in self.blocks:
            y = blk(y)
        if not self.head:
            return y.permute(0, 2, 3, 1).float()
        y = _relu6(_bn(_conv(y, self.head_conv), self.head_bn))
        y = y.float().mean(dim=(2, 3)).to(torch.bfloat16)
        return F.linear(y.float(), self.classifier.weight.float(),
                        self.classifier.bias.float())


def init_seeded(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights from an explicit ``torch.Generator``: He-normal
    convs, BatchNorm scale and statistics near (not at) the identity,
    small biases, a LeCun-normal classifier."""
    g = torch.Generator().manual_seed(seed)
    new = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            new[name] = t
            continue
        shape = tuple(t.shape)
        if name.endswith("_conv.weight"):
            std = (2.0 / float(np.prod(shape[1:]))) ** 0.5
            v = torch.randn(shape, generator=g) * std
        elif name.endswith("running_var") or (
                "_bn." in name and name.endswith("weight")):
            v = 0.8 + 0.4 * torch.rand(shape, generator=g)
        elif name.endswith("running_mean") or name.endswith("bias"):
            v = 0.1 * torch.randn(shape, generator=g)
        else:  # classifier weight (out, in)
            v = torch.randn(shape, generator=g) / shape[1] ** 0.5
        new[name] = v
    model.load_state_dict(new)
    return model


def _block_state(out: Dict[str, torch.Tensor], prefix: str, params,
                 stats) -> None:
    """One flax ``Block_{i}``: its 3x3 conv (depthwise or dense, where the
    variant keeps one) is ``dw``, the last 1x1 conv ``proj`` and a 1x1
    conv before it ``expand``; each conv's BatchNorm has its number."""
    convs = sorted(n for n in params if n.startswith("Conv"))
    for cname in convs:
        if np.asarray(params[cname]["kernel"]).shape[0] == 3:
            role = "dw"
        else:
            role = "proj" if cname == convs[-1] else "expand"
        bname = "BatchNorm_" + cname.split("_", 1)[1]
        _conv_bn_pair(out, prefix, params, stats, cname, bname,
                      f"{role}_conv", f"{role}_bn")


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """The JAX tool's flax variables of one variant → a :class:`Variant`
    state dict: the stem ``Conv_0`` (3x3, or the space-to-depth 2x2),
    ``Block_{i}`` (a block may lack its depthwise conv or hold a dense
    one, so its layers are told apart by kernel shape) and, with its
    head, ``Conv_1`` and ``Dense_0``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    _conv_bn_pair(out, "", params, stats, "Conv_0", "BatchNorm_0",
                  "stem_conv", "stem_bn")
    i = 0
    while f"Block_{i}" in params:
        _block_state(out, f"blocks.{i}.", params[f"Block_{i}"],
                     stats[f"Block_{i}"])
        i += 1
    if "Dense_0" in params:
        _conv_bn_pair(out, "", params, stats, "Conv_1", "BatchNorm_1",
                      "head_conv", "head_bn")
        _dense(out, "classifier", params["Dense_0"])
    return out


def to_card(model: Variant, device="cuda") -> Variant:
    """The variant on ``device`` for timing: its conv weights stored bf16
    and channels-last once (BatchNorm and the classifier stay float32),
    eval mode."""
    model = model.to(device).eval()
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.weight.data = mod.weight.data.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
    return model


def _probe(name: str, model: Variant, x: torch.Tensor, batch: int,
           rows: List[Dict[str, Any]], reps: int = 5,
           card: Optional[Dict[str, str]] = None) -> float:
    """Time and count one variant; append its row."""
    m = mfu_table.chain_ms(model, x, reps=reps)
    ms = m["ms"]
    flops = mfu_table.cost_flops(model, x)
    row: Dict[str, Any] = {
        "config": name,
        "batch": batch,
        "device_ms_per_batch": ms,
        "device_ms_min": m["ms_min"],
        "device_ms_max": m["ms_max"],
        "reps": m["reps"],
        "k_hi": m["k_hi"],
        "card": dict(card or {}),
    }
    if flops is not None:
        row["gflops_per_batch"] = flops / 1e9
        if ms >= NOISE_FLOOR_MS:
            row["tflops_per_sec"] = flops / (ms / 1e3) / 1e12
            row["mfu_pct"] = row["tflops_per_sec"] / mfu_table.PEAK_TFLOPS \
                * 100
        else:
            row["below_noise_floor"] = True
    rows.append(row)
    return ms


def run(quick: bool = False) -> Dict[str, Any]:
    """Every row of the breakdown on the card; returns the output object."""
    mfu_table.require_card()
    batch = 32 if quick else 128
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3),
                                      np.uint8)).cuda()
    card = mfu_table.card_stamp(clocks=False)
    rows: List[Dict[str, Any]] = []

    def probe(name, reps=5, **opts):
        model = to_card(init_seeded(Variant(**opts)))
        ms = _probe(name, model, x, batch, rows, reps=reps, card=card)
        del model
        torch.cuda.empty_cache()
        return ms

    # cumulative truncation, headless, so a stage's cost is not confounded
    # with the 1280-channel head
    cum: List[Tuple[str, float]] = []
    for n in ([0, 3, 7] if quick else range(8)):
        cum.append((f"stage{n}", probe(
            f"cumulative stem+{n}stages (headless)", reps=3 if quick else 5,
            keep_stages=n, head=False)))
    full_ms = probe("full model (head incl.)")
    nodw_ms = probe("full, depthwise REMOVED", depthwise="skip")
    probe("full, 3x3s DENSE (groups=1)", depthwise="dense")
    probe("full, space-to-depth stem", s2d_stem=True)
    return {
        "batch": batch,
        "method": "chained differencing on CUDA graphs and FlopCounterMode "
                  "(see tools/mfu_table.py)",
        "card": mfu_table.card_stamp(),
        "rows": rows,
        "per_stage_delta_ms": [
            {"stage": cum[i][0], "delta_ms": cum[i][1] - cum[i - 1][1]}
            for i in range(1, len(cum))],
        "depthwise_share_pct": (full_ms - nodw_ms) / full_ms * 100,
        "full_ms": full_ms,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    out_path = (argv[argv.index("--out") + 1] if "--out" in argv
                else DEFAULT_OUT)
    out = run(quick="--quick" in argv)
    for row in out["rows"]:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"depthwise_share_pct": out["depthwise_share_pct"],
                      "full_ms": out["full_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
