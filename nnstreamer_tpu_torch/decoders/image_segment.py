"""image_segment decoder: segmentation tensors → RGBA label-color video.

Parity: tensordec-imagesegment.c. Modes (option1):
  tflite-deeplab — [#labels, w, h] float32 per-pixel class probabilities
                   (argmax over labels → label map)
  snpe-deeplab   — [w, h] float32 already-argmaxed label indices
  snpe-depth     — [1, w, h] float32 depth map → normalized grayscale
option2 = max number of labels (default 20, Pascal VOC).

Colors follow the reference's deterministic (NEON-path) map:
rgb_modifier = 0xFFFFFF // (max_labels + 1); color[i] = modifier * i with
alpha forced 0xFF; label 0 (background) stays fully transparent.

Vectorised: the per-pixel loops become whole-image numpy ops (argmax +
color-table gather).
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder, typed_tensors
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.types import TensorsConfig

DEFAULT_LABELS = 20
_MODES = ("tflite-deeplab", "snpe-deeplab", "snpe-depth")


@register_decoder
class ImageSegment(Decoder):
    MODE = "image_segment"

    def init(self, options):
        super().init(options)
        opts = list(options) + [None] * 9
        self.seg_mode = opts[0]
        if self.seg_mode not in _MODES:
            raise ElementError(
                "tensor_decoder",
                f"image_segment: set option1 to one of {_MODES}, got {self.seg_mode!r}",
            )
        self.max_labels = int(opts[1]) if opts[1] else DEFAULT_LABELS
        modifier = 0xFFFFFF // (self.max_labels + 1)
        colors = modifier * np.arange(self.max_labels + 1, dtype=np.uint32)
        colors |= np.uint32(0xFF000000)  # alpha
        colors[0] = 0  # transparent background
        self.color_map = colors
        self.width = self.height = 0

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        dims = config.info[0].dims
        if self.seg_mode == "snpe-deeplab":
            self.width = dims[0]
            self.height = dims[1] if len(dims) > 1 else 1
        else:
            self.width = dims[1] if len(dims) > 1 else 1
            self.height = dims[2] if len(dims) > 2 else 1
        rate = (
            f",framerate={config.rate_n}/{config.rate_d}"
            if config.rate_n >= 0 and config.rate_d > 0
            else ""
        )
        return Caps.from_string(
            f"video/x-raw,format=RGBA,width={self.width},height={self.height}{rate}"
        )

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        t = typed_tensors(buf, config)[0].astype(np.float32)
        h, w = self.height, self.width
        if self.seg_mode == "tflite-deeplab":
            # np shape (h, w, labels): argmax over the label axis
            probs = t.reshape(h, w, -1)
            labels = np.argmax(probs, axis=-1)
            labels = np.minimum(labels, self.max_labels).astype(np.int64)
            canvas = self.color_map[labels]
        elif self.seg_mode == "snpe-deeplab":
            labels = np.minimum(t.reshape(h, w).astype(np.int64), self.max_labels)
            canvas = self.color_map[labels]
        else:  # snpe-depth: normalize to grayscale
            depth = t.reshape(h, w)
            lo, hi = float(depth.min()), float(depth.max())
            scale = 255.0 / (hi - lo) if hi > lo else 0.0
            gray = ((depth - lo) * scale).astype(np.uint32)
            canvas = gray * np.uint32(0x00010101) | np.uint32(0xFF000000)
        out = buf.with_tensors([canvas.astype(np.uint32).view(np.uint8).reshape(h, w, 4)])
        out.meta["segment_labels"] = None if self.seg_mode == "snpe-depth" else labels
        return out
