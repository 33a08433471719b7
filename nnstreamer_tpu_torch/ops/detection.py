"""Detection post-processing on the device: top-k prefilter + greedy NMS —
the counterpart of the JAX package's ``ops/detection.py``.

The reference's "pp" detection models embed TFLite_Detection_PostProcess in
the graph and the decoder consumes four compact tensors
(box_properties/mobilenetssdpp.cc: locations/classes/scores/num). Here the
same post-process runs on the device after the model, so only the k
survivors per frame cross to the host instead of the raw logits.

Everything has a static shape: ``k`` survivors at most, invalid rows
zero-padded, the survivor count in ``num``. The greedy scan mirrors the
host decoder's class-agnostic highest-score-first NMS
(decoders/detections.nms ↔ tensordec-boundingbox.cc:336) as k steps over
the k×k IoU matrix, batched over frames, with no host synchronisation.

Ties: ``lax.top_k`` puts the lower index first among equal scores, and
sigmoid scores saturate to exactly 1.0 under random weights; ``torch.topk``
on CUDA makes no such promise, so the top k come from a stable descending
sort. The survivors are compacted by a stable argsort, as the JAX function
does with ``argsort(~valid, stable=True)``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """IoU matrix for (..., k, 4) [ymin, xmin, ymax, xmax] boxes →
    (..., k, k)."""
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    area = (ymax - ymin).clamp_min(0.0) * (xmax - xmin).clamp_min(0.0)
    iy1 = torch.maximum(ymin[..., :, None], ymin[..., None, :])
    ix1 = torch.maximum(xmin[..., :, None], xmin[..., None, :])
    iy2 = torch.minimum(ymax[..., :, None], ymax[..., None, :])
    ix2 = torch.minimum(xmax[..., :, None], xmax[..., None, :])
    inter = (iy2 - iy1).clamp_min(0.0) * (ix2 - ix1).clamp_min(0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _nms_valid(boxes: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """Greedy suppression over score-sorted (B, k, 4) boxes → bool (B, k).
    Step i kills every later box that overlaps box i while box i is still
    valid; the loop runs on the device (no ``.item()``) and updates no
    tensor in place, so it also runs under ``torch.func.vmap`` (an
    imported graph's TFLite_Detection_PostProcess, tools/import_tflite)."""
    k = boxes.shape[-2]
    later = torch.ones((k, k), dtype=torch.bool,
                       device=boxes.device).triu(1)
    kill = (_pairwise_iou(boxes) > iou_thr) & later
    valid = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                       device=boxes.device)
    for i in range(k - 1):
        # kill[..., i, j] is False for j <= i: only later boxes change
        valid = valid & ~(kill[..., i, :] & valid[..., i, None])
    return valid


def detection_postprocess(boxes: torch.Tensor, scores: torch.Tensor,
                          classes: torch.Tensor, k: int = 100,
                          iou_thr: float = 0.5, score_thr: float = 0.5
                          ) -> Tuple[torch.Tensor, ...]:
    """(B, N, 4) normalised [ymin, xmin, ymax, xmax] boxes + (B, N)
    scores and classes → the pp quad: locations (B, k, 4), classes (B, k),
    scores (B, k), num (B, 1), all float32 — survivors first in score
    order, zero-padded."""
    B, N = scores.shape
    k_eff = min(k, N)
    order = torch.sort(scores, dim=1, descending=True,
                       stable=True).indices[:, :k_eff]
    top_s = torch.gather(scores, 1, order)
    top_b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    top_c = torch.gather(classes, 1, order)
    valid = _nms_valid(top_b, iou_thr) & (top_s >= score_thr)
    # compact the survivors to the front, keeping score order
    perm = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    keep = torch.gather(valid, 1, perm)
    top_b = torch.where(keep[..., None], torch.gather(
        top_b, 1, perm[..., None].expand(-1, -1, 4)), 0.0)
    top_s = torch.where(keep, torch.gather(top_s, 1, perm), 0.0)
    top_c = torch.where(keep, torch.gather(top_c, 1, perm), 0)
    num = valid.sum(dim=1, keepdim=True).to(torch.float32)
    pad = k - k_eff
    if pad:
        top_b = torch.nn.functional.pad(top_b, (0, 0, 0, pad))
        top_s = torch.nn.functional.pad(top_s, (0, pad))
        top_c = torch.nn.functional.pad(top_c, (0, pad))
    return (top_b.to(torch.float32), top_c.to(torch.float32),
            top_s.to(torch.float32), num)


def ssd_decode_boxes(encodings: torch.Tensor, priors: torch.Tensor,
                     y_scale: float = 10.0, x_scale: float = 10.0,
                     h_scale: float = 5.0, w_scale: float = 5.0
                     ) -> torch.Tensor:
    """tflite-SSD box decode on the device — the host decoder's math
    (decoders/bounding_boxes.MobilenetSSD.decode_boxes ↔
    box_properties/mobilenetssd.cc). encodings (B, N, 4) [ty, tx, th, tw];
    priors (4, N) [ycenter, xcenter, h, w] → (B, N, 4) [ymin, xmin, ymax,
    xmax]."""
    pri_cy, pri_cx, pri_h, pri_w = (priors[i][None, :] for i in range(4))
    enc = encodings.to(torch.float32)
    ycenter = enc[..., 0] / y_scale * pri_h + pri_cy
    xcenter = enc[..., 1] / x_scale * pri_w + pri_cx
    h = torch.exp(enc[..., 2] / h_scale) * pri_h
    w = torch.exp(enc[..., 3] / w_scale) * pri_w
    ymin = ycenter - h / 2.0
    xmin = xcenter - w / 2.0
    return torch.stack([ymin, xmin, ymin + h, xmin + w], dim=-1)
