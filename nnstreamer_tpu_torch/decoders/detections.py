"""Shared detection utilities for box-producing decoders.

The reference keeps detections in GArray<detectedObject> and loops per box
(tensordec-boundingbox.cc: iou/nms/draw/updateCentroids). Here detections
are struct-of-arrays (numpy) so decode stages are vectorized: thresholding,
argmax over classes, and the IoU matrix are single array ops instead of
per-box scalar loops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch.decoders import rasterfont

PIXEL_VALUE = np.uint32(0xFF0000FF)  # RED 100% in RGBA (tensordec-boundingbox.h:114)


@dataclass
class Detections:
    """Struct-of-arrays detections (detectedObject parity)."""

    x: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    y: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    width: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    height: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    class_id: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    prob: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    tracking_id: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    def __post_init__(self):
        if self.tracking_id.shape != self.x.shape:
            self.tracking_id = np.zeros(self.x.shape, np.int32)

    def __len__(self) -> int:
        return int(self.x.shape[0])

    def take(self, idx) -> "Detections":
        return Detections(
            x=self.x[idx],
            y=self.y[idx],
            width=self.width[idx],
            height=self.height[idx],
            class_id=self.class_id[idx],
            prob=self.prob[idx],
            tracking_id=self.tracking_id[idx],
        )

    def to_list(self) -> List[dict]:
        """App-facing structured results (meta['objects'])."""
        return [
            {
                "x": int(self.x[i]),
                "y": int(self.y[i]),
                "width": int(self.width[i]),
                "height": int(self.height[i]),
                "class_id": int(self.class_id[i]),
                "prob": float(self.prob[i]),
                "tracking_id": int(self.tracking_id[i]),
            }
            for i in range(len(self))
        ]


def make_detections(x, y, width, height, class_id, prob) -> Detections:
    to32 = lambda a: np.asarray(a).astype(np.int32).reshape(-1)  # noqa: E731
    return Detections(
        x=to32(x),
        y=to32(y),
        width=to32(width),
        height=to32(height),
        class_id=to32(class_id),
        prob=np.asarray(prob, np.float32).reshape(-1),
    )


def iou_matrix(d: Detections) -> np.ndarray:
    """Pairwise IoU with the reference's inclusive-pixel convention
    (tensordec-boundingbox.cc:317: w = max(0, x2-x1+1))."""
    x1 = np.maximum(d.x[:, None], d.x[None, :])
    y1 = np.maximum(d.y[:, None], d.y[None, :])
    x2 = np.minimum((d.x + d.width)[:, None], (d.x + d.width)[None, :])
    y2 = np.minimum((d.y + d.height)[:, None], (d.y + d.height)[None, :])
    w = np.maximum(0, x2 - x1 + 1).astype(np.float32)
    h = np.maximum(0, y2 - y1 + 1).astype(np.float32)
    inter = w * h
    area = (d.width * d.height).astype(np.float32)
    union = area[:, None] + area[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        o = np.where(union > 0, inter / union, 0.0)
    return np.maximum(o, 0.0)


def nms(d: Detections, threshold: float) -> Detections:
    """Greedy NMS, highest-prob first (nms(), tensordec-boundingbox.cc:336).

    The pairwise IoU matrix is computed once (vectorized); the greedy
    suppression scan itself is O(n) over the sorted survivors.
    """
    n = len(d)
    if n == 0:
        return d
    order = np.argsort(-d.prob, kind="stable")
    d = d.take(order)
    ious = iou_matrix(d)
    valid = np.ones(n, dtype=bool)
    for i in range(n):
        if not valid[i]:
            continue
        kill = ious[i, i + 1 :] > threshold
        valid[i + 1 :] &= ~kill
    return d.take(valid)


def load_labels(path: str) -> List[str]:
    """Label file: one label per line (loadImageLabels, tensordecutil.c)."""
    with open(path, "r", encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]


def draw_boxes(
    canvas: np.ndarray,
    d: Detections,
    i_width: int,
    i_height: int,
    labels: Optional[List[str]] = None,
    track: bool = False,
) -> None:
    """Draw 1-px box borders + label sprites on a (h, w) uint32 RGBA canvas.

    Geometry parity with BoundingBox::draw (tensordec-boundingbox.cc:594):
    model-space coords scaled into output space, horizontal edges at y1/y2,
    vertical edges from y1+1, label text 14 px above the box.
    """
    height, width = canvas.shape
    use_label = labels is not None and len(labels) > 0
    for i in range(len(d)):
        cid = int(d.class_id[i])
        if use_label and (cid < 0 or cid >= len(labels)):
            continue
        x1 = (width * int(d.x[i])) // i_width
        x2 = min(width - 1, (width * (int(d.x[i]) + int(d.width[i]))) // i_width)
        y1 = (height * int(d.y[i])) // i_height
        y2 = min(height - 1, (height * (int(d.y[i]) + int(d.height[i]))) // i_height)
        x1c, x2c = max(0, x1), max(0, x2)
        # a box whose top lies below the canvas has no top edge to draw
        # (the JAX package's copy indexes past the canvas there and raises)
        if 0 <= y1 < height and x2c >= x1c:
            canvas[y1, x1c : x2c + 1] = PIXEL_VALUE
        if y2 >= 0 and x2c >= x1c:
            canvas[y2, x1c : x2c + 1] = PIXEL_VALUE
        ys, ye = max(0, y1 + 1), max(0, y2)
        if ye > ys:
            if 0 <= x1 < width:
                canvas[ys:ye, x1] = PIXEL_VALUE
            if 0 <= x2 < width:
                canvas[ys:ye, x2] = PIXEL_VALUE
        if use_label:
            text = labels[cid]
            if track and int(d.tracking_id[i]) != 0:
                text = f"{text}-{int(d.tracking_id[i])}"
            # label sprites share PIXEL_VALUE red (tensordecutil.c:115
            # initSingleLineSprite(singleLineSprite, rasters, PIXEL_VALUE))
            rasterfont.draw_text(canvas, max(0, x1), max(0, y1 - 14), text,
                                 color=int(PIXEL_VALUE))


class CentroidTracker:
    """Naive centroid tracking (option6; BoundingBox::updateCentroids).

    Greedy nearest-centroid matching over squared distances; unmatched
    centroids age out after ``consecutive_disappear_threshold`` frames;
    unmatched boxes register new ids (ids start at 1).
    """

    def __init__(self, max_centroids: int = 100, disappear_threshold: int = 100):
        self.max_centroids = max_centroids
        self.disappear_threshold = disappear_threshold
        self.last_id = 0
        # each: [id, cx, cy, disappeared]
        self.centroids: List[list] = []

    def update(self, d: Detections) -> None:
        if len(d) > self.max_centroids:
            return
        self.centroids = [
            c for c in self.centroids if c[3] < self.disappear_threshold
        ]
        if len(d) == 0:
            for c in self.centroids:
                c[3] += 1
            return
        cx = (d.x + d.width // 2).astype(np.int64)
        cy = (d.y + d.height // 2).astype(np.int64)
        if not self.centroids:
            for b in range(len(d)):
                self.last_id += 1
                self.centroids.append([self.last_id, int(cx[b]), int(cy[b]), 0])
                d.tracking_id[b] = self.last_id
            return
        ccx = np.array([c[1] for c in self.centroids], np.int64)
        ccy = np.array([c[2] for c in self.centroids], np.int64)
        dist = (ccx[:, None] - cx[None, :]) ** 2 + (ccy[:, None] - cy[None, :]) ** 2
        order = np.argsort(dist, axis=None, kind="stable")
        matched_c, matched_b = set(), set()
        for flat in order:
            ci, bi = divmod(int(flat), len(d))
            if ci in matched_c or bi in matched_b:
                continue
            matched_c.add(ci)
            matched_b.add(bi)
            c = self.centroids[ci]
            c[1], c[2], c[3] = int(cx[bi]), int(cy[bi]), 0
            d.tracking_id[bi] = c[0]
        for ci, c in enumerate(self.centroids):
            if ci not in matched_c:
                c[3] += 1
        for bi in range(len(d)):
            if bi not in matched_b:
                self.last_id += 1
                self.centroids.append([self.last_id, int(cx[bi]), int(cy[bi]), 0])
                d.tracking_id[bi] = self.last_id
