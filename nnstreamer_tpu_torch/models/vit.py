"""ViT image classifier and streaming transformer — the attention model
family (counterpart of the JAX package's ``models/vit.py``).

  - ``vit``: patchify → transformer encoder → classifier, NHWC uint8
    frames in (``3:{size}:{size}:1``), ``{classes}:1`` float32 logits out;
  - ``stream_transformer``: causal encoder over a ``(seq, feat)`` float32
    stream window (the tensor_aggregator use-case), ``(1, seq, feat)``
    float32 out.

Both run in bfloat16 with the JAX package's rounding points: LayerNorm
statistics and normalization in float32 with eps 1e-6 (flax's default),
rounded to bf16; each Dense a bf16 product rounded once, then its bias
added in bf16; GELU the tanh approximation (flax ``nn.gelu``); the
classifier in float32 on the bf16 features. Attention goes through the
function the module is built with, :func:`ops.attention.flash_attention_auto`
by default (the CUDA kernel on the card); a second instance built with a
plain version is the kernel's oracle.

custom keys (both): depth, dim, heads, seed, params:<npz>; vit adds size,
patch, classes; stream_transformer adds seq, feat, causal.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nnstreamer_tpu_torch.models import (
    ModelBundle,
    load_or_init,
    preprocess_frames,
    register_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import _same_pad_nchw
from nnstreamer_tpu_torch.models.mobilenet_v2 import infer_output as \
    _logits_info
from nnstreamer_tpu_torch.ops.attention import flash_attention_auto
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

#: flax LayerNorm's default epsilon (torch's is 1e-5)
LN_EPS = 1e-6


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm,
                dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        eps=LN_EPS).to(dtype)


def _dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense with ``dtype``: the product rounded to ``dtype``, then the
    bias added in ``dtype``."""
    return torch.matmul(x.to(dtype), lin.weight.to(dtype).t()) + \
        lin.bias.to(dtype)


class Block(nn.Module):
    """Pre-norm transformer block: attention, then a 4x GELU MLP."""

    def __init__(self, dim: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 attention: Callable = flash_attention_auto):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} does not split into {heads} heads")
        self.dim, self.heads, self.causal, self.dtype = dim, heads, causal, dtype
        self.attention = attention
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b, s, _ = x.shape
        hd = self.dim // self.heads
        h = _layer_norm(x, self.ln1, dt)
        # contiguous thirds, then heads: (B, S, D) -> (B*H, S, hd)
        q, k, v = (t.reshape(b, s, self.heads, hd).transpose(1, 2)
                   .reshape(b * self.heads, s, hd)
                   for t in _dense(h, self.qkv, dt).split(self.dim, dim=-1))
        o = self.attention(q, k, v, causal=self.causal)
        o = o.reshape(b, self.heads, s, hd).transpose(1, 2).reshape(b, s, -1)
        x = x + _dense(o, self.proj, dt)
        h = _layer_norm(x, self.ln2, dt)
        h = F.gelu(_dense(h, self.fc1, dt), approximate="tanh")
        return x + _dense(h, self.fc2, dt)


class ViT(nn.Module):
    def __init__(self, size: int = 224, patch: int = 16, dim: int = 192,
                 depth: int = 6, heads: int = 3, classes: int = 1001,
                 dtype: torch.dtype = torch.bfloat16,
                 attention: Callable = flash_attention_auto):
        super().__init__()
        self.patch, self.dim, self.dtype = patch, dim, dtype
        tokens = (-(-size // patch)) ** 2 + 1  # 'SAME' patches + CLS
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, False, dtype, attention) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC float frames → float32 logits."""
        dt, p = self.dtype, self.patch
        y = _same_pad_nchw(x.to(dt).permute(0, 3, 1, 2), p, p)
        y = F.conv2d(y, self.patch_embed.weight.to(dt), stride=p) + \
            self.patch_embed.bias.to(dt).reshape(1, -1, 1, 1)
        b = y.shape[0]
        y = y.permute(0, 2, 3, 1).reshape(b, -1, self.dim)  # NHWC tokens
        y = torch.cat([self.cls.to(dt).expand(b, 1, self.dim), y], 1)
        y = y + self.pos.to(dt)
        for blk in self.blocks:
            y = blk(y)
        y = _layer_norm(y, self.norm, dt)
        return F.linear(y[:, 0].float(), self.head.weight.float(),
                        self.head.bias.float())


class StreamTransformer(nn.Module):
    def __init__(self, seq: int = 1024, feat: int = 64, dim: int = 128,
                 depth: int = 4, heads: int = 4, causal: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 attention: Callable = flash_attention_auto):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Linear(feat, dim)
        self.pos = nn.Parameter(torch.zeros(1, seq, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, causal, dtype, attention) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, feat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, seq, feat) → (B, seq, feat) float32."""
        dt = self.dtype
        y = _dense(x.to(dt), self.embed, dt) + self.pos.to(dt)
        for blk in self.blocks:
            y = blk(y)
        y = _layer_norm(y, self.norm, dt)
        return F.linear(y.float(), self.head.weight.float(),
                        self.head.bias.float())


def init_weights(model: nn.Module, seed: int) -> None:
    """Deterministic weights from ``np.random.default_rng(seed)``:
    LeCun-normal Dense and patch kernels, LayerNorm scales near 1, small
    biases, ``cls`` and ``pos`` at 0.02. This does NOT reproduce the JAX
    package's ``seed:`` weights (flax initializers and ``jax.random``);
    carry those across with :func:`models.convert.from_jax_variables`."""
    rng = np.random.default_rng(seed)
    new = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        is_ln = name.startswith("norm.") or ".ln" in name
        if name in ("cls", "pos"):
            a = rng.normal(0.0, 0.02, shape)
        elif is_ln and leaf == "weight":
            a = rng.uniform(0.8, 1.2, shape)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.02, shape)
        else:  # Dense (out, in) or patch conv (O, I, H, W)
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        new[name] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(new)


def build_vit(custom: Dict[str, str], device: torch.device) -> ModelBundle:
    size = int(custom.get("size", 224))
    classes = int(custom.get("classes", 1001))
    model = ViT(size=size, patch=int(custom.get("patch", 16)),
                dim=int(custom.get("dim", 192)),
                depth=int(custom.get("depth", 6)),
                heads=int(custom.get("heads", 3)), classes=classes)
    load_or_init(model, custom, init_weights)
    model = model.to(device).eval()

    def apply_fn(x):
        with torch.no_grad():
            return model(preprocess_frames(x, "pm1", model.dtype))

    return ModelBundle(
        apply_fn=apply_fn, module=model,
        input_info=TensorsInfo.from_strings(f"3:{size}:{size}:1", "uint8"),
        output_info=TensorsInfo.from_strings(f"{classes}:1", "float32"),
        infer_output=lambda info: _logits_info(info, classes))


def stream_output_info(in_info: TensorsInfo) -> TensorsInfo:
    """(seq, feat) or (B, seq, feat) float → (B, seq, feat) float32, B = 1
    for a 2-D window."""
    shape = in_info.tensors[0].np_shape()
    if len(shape) == 2:
        shape = (1, *shape)
    return TensorsInfo(tensors=[TensorInfo.from_np_shape(shape, "float32")])


def build_stream_transformer(custom: Dict[str, str],
                             device: torch.device) -> ModelBundle:
    seq = int(custom.get("seq", 1024))
    feat = int(custom.get("feat", 64))
    model = StreamTransformer(
        seq=seq, feat=feat, dim=int(custom.get("dim", 128)),
        depth=int(custom.get("depth", 4)), heads=int(custom.get("heads", 4)),
        causal=custom.get("causal", "true").lower() != "false")
    load_or_init(model, custom, init_weights)
    model = model.to(device).eval()

    def apply_fn(x):
        with torch.no_grad():
            return model(x[None] if x.dim() == 2 else x)

    info = TensorsInfo.from_strings(f"{feat}:{seq}:1", "float32")
    return ModelBundle(apply_fn=apply_fn, module=model, input_info=info,
                       output_info=info, infer_output=stream_output_info)


register_model("vit")(build_vit)
register_model("stream_transformer")(build_stream_transformer)
