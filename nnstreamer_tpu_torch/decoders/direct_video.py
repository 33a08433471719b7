"""direct_video decoder: raw tensor → video/x-raw (tensordec-directvideo.c).

Interprets a uint8 tensor with dims C:W:H[:1], C∈{1,3,4} as
GRAY8/RGB/RGBA video."""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.types import TensorsConfig

_FMT = {1: "GRAY8", 3: "RGB", 4: "RGBA"}


@register_decoder
class DirectVideo(Decoder):
    MODE = "direct_video"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        info = config.info[0]
        ch, w, h = (list(info.dims) + [1, 1, 1])[:3]
        if ch not in _FMT:
            raise ElementError("tensor_decoder", f"direct_video: bad channels {ch}")
        rate = f",framerate={config.rate_n}/{config.rate_d}" if config.rate_n >= 0 and config.rate_d > 0 else ""
        return Caps.from_string(
            f"video/x-raw,format={_FMT[ch]},width={w},height={h}{rate}"
        )

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        info = config.info[0]
        ch, w, h = (list(info.dims) + [1, 1, 1])[:3]
        frame = np.asarray(buf.tensors[0]).reshape(h, w, ch).astype(np.uint8)
        return buf.with_tensors([frame])
