"""pose_estimation decoder: heatmaps (+offsets) → skeleton overlay video.

Parity: tensordec-pose.c. Options: option1 = output WIDTH:HEIGHT,
option2 = model input WIDTH:HEIGHT, option3 = key-point metadata file
(one line per keypoint: "label conn conn ..."), option4 = mode
("heatmap-only" default | "heatmap-offset" w/ sigmoid + offset tensor).

Input: tensor[0] = heatmap, np shape (grid_y, grid_x, #keypoints);
heatmap-offset mode adds tensor[1] = offsets (grid_y, grid_x, 2*#keypoints)
with y-offsets first (tensordec-pose.c:790-795).

Vectorised: the per-keypoint grid scan becomes one argmax over the flattened
grid for all keypoints at once. Keypoints are also attached as
``meta['keypoints']`` for app consumption.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders import rasterfont
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder, typed_tensors
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.types import TensorsConfig, parse_dimension

PIXEL_VALUE = np.uint32(0xFFFFFFFF)  # white (tensordec-pose.c:118)
PROB_THRESHOLD = 0.5

# default key-body metadata (pose_metadata_default, tensordec-pose.c:156-185)
DEFAULT_METADATA: List[Tuple[str, List[int]]] = [
    ("top", [1]),
    ("neck", [0, 2, 5, 8, 11]),
    ("r_shoulder", [1, 3]),
    ("r_elbow", [2, 4]),
    ("r_wrist", [3]),
    ("l_shoulder", [1, 6]),
    ("l_elbow", [5, 7]),
    ("l_wrist", [6]),
    ("r_hip", [1, 9]),
    ("r_knee", [8, 10]),
    ("r_ankle", [9]),
    ("l_hip", [1, 12]),
    ("l_knee", [11, 13]),
    ("l_ankle", [12]),
]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float32)))


def load_pose_metadata(path: str) -> List[Tuple[str, List[int]]]:
    """One keypoint per line: label then space-separated connection ids
    (pose_load_metadata_from_file, tensordec-pose.c:251)."""
    md = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            md.append((parts[0], [int(p) for p in parts[1:]]))
    if not md:
        raise ElementError("tensor_decoder", f"empty pose metadata file {path}")
    return md


def _draw_line_with_dot(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """Straight connection line (draw_line_with_dot, tensordec-pose.c)."""
    h, w = canvas.shape
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.linspace(x0, x1, n + 1).round().astype(np.int64)
    ys = np.linspace(y0, y1, n + 1).round().astype(np.int64)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = PIXEL_VALUE
    # end-point dots (3x3)
    for cx, cy in ((x0, y0), (x1, y1)):
        xlo, xhi = max(0, cx - 1), min(w, cx + 2)
        ylo, yhi = max(0, cy - 1), min(h, cy + 2)
        if xhi > xlo and yhi > ylo:
            canvas[ylo:yhi, xlo:xhi] = PIXEL_VALUE


@register_decoder
class PoseEstimation(Decoder):
    MODE = "pose_estimation"

    def init(self, options):
        super().init(options)
        opts = list(options) + [None] * 9
        self.width = self.height = 0
        self.i_width = self.i_height = 0
        if opts[0]:
            dims = parse_dimension(opts[0])
            if len(dims) >= 2:
                self.width, self.height = dims[0], dims[1]
        if opts[1]:
            dims = parse_dimension(opts[1])
            if len(dims) >= 2:
                self.i_width, self.i_height = dims[0], dims[1]
        self.metadata = load_pose_metadata(opts[2]) if opts[2] else list(DEFAULT_METADATA)
        mode = opts[3] or "heatmap-only"
        if mode not in ("heatmap-only", "heatmap-offset"):
            raise ElementError("tensor_decoder", f"pose: unknown option4 mode {mode!r}")
        self.offset_mode = mode == "heatmap-offset"
        if not (self.width and self.height and self.i_width and self.i_height):
            raise ElementError(
                "tensor_decoder", "pose needs option1=outW:outH and option2=inW:inH"
            )

    @property
    def total_labels(self) -> int:
        return len(self.metadata)

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        dims = config.info[0].dims
        if dims[0] != self.total_labels:
            raise ElementError(
                "tensor_decoder",
                f"pose: heatmap dim0 {dims[0]} != {self.total_labels} keypoints",
            )
        rate = (
            f",framerate={config.rate_n}/{config.rate_d}"
            if config.rate_n >= 0 and config.rate_d > 0
            else ""
        )
        return Caps.from_string(
            f"video/x-raw,format=RGBA,width={self.width},height={self.height}{rate}"
        )

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        tensors = typed_tensors(buf, config)
        n = self.total_labels
        dims = config.info[0].dims
        grid_x = dims[1] if len(dims) > 1 else 1
        grid_y = dims[2] if len(dims) > 2 else 1
        heat = tensors[0].astype(np.float32).reshape(grid_y, grid_x, n)
        if self.offset_mode:
            heat = _sigmoid(heat)
        flat = heat.reshape(-1, n)
        best = np.argmax(flat, axis=0)
        prob = flat[best, np.arange(n)]
        max_y, max_x = np.divmod(best, grid_x)

        if self.offset_mode:
            offsets = tensors[1].astype(np.float32).reshape(grid_y, grid_x, 2 * n)
            off_y = offsets[max_y, max_x, np.arange(n)]
            off_x = offsets[max_y, max_x, np.arange(n) + n]
            pos_x = max_x / max(grid_x - 1, 1) * self.i_width + off_x
            pos_y = max_y / max(grid_y - 1, 1) * self.i_height + off_y
            xs = pos_x * self.width / self.i_width
            ys = pos_y * self.height / self.i_height
        else:
            xs = max_x * self.width / self.i_width
            ys = max_y * self.height / self.i_height
        xs = np.clip(np.maximum(0, xs).astype(np.int64), 0, self.width)
        ys = np.clip(np.maximum(0, ys).astype(np.int64), 0, self.height)

        canvas = np.zeros((self.height, self.width), np.uint32)
        valid = prob >= PROB_THRESHOLD
        for i in range(n):
            if not valid[i]:
                continue
            for k in self.metadata[i][1]:
                # draw each connection once (k >= i) toward valid keypoints
                if k > n or k < i or k >= n or not valid[k]:
                    continue
                _draw_line_with_dot(canvas, int(xs[i]), int(ys[i]), int(xs[k]), int(ys[k]))
        for i in range(n):
            if valid[i]:
                rasterfont.draw_text(
                    canvas,
                    max(0, int(xs[i])),
                    max(0, int(ys[i]) - 14),
                    self.metadata[i][0],
                )

        out = buf.with_tensors([canvas.view(np.uint8).reshape(self.height, self.width, 4)])
        out.meta["keypoints"] = [
            {
                "label": self.metadata[i][0],
                "x": int(xs[i]),
                "y": int(ys[i]),
                "prob": float(prob[i]),
                "valid": bool(valid[i]),
            }
            for i in range(n)
        ]
        return out
