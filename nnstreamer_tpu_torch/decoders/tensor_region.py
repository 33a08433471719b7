"""tensor_region decoder: detections → crop-info tensor for tensor_crop.

Parity: tensordec-tensor_region.c — runs the mobilenet-ssd box decode
(priors via option3, model size via option4), keeps the top-N regions
(option1, default 1), and emits a flexible uint32 tensor of shape
[4, N] (x, y, w, h per region) that tensor_crop's info pad consumes.
option2 = label file (for total_labels validation only).
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders import detections as det
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder, typed_tensors
from nnstreamer_tpu_torch.decoders.bounding_boxes import MobilenetSSD, _parse_wh
from nnstreamer_tpu_torch.meta import wrap_flexible
from nnstreamer_tpu_torch.types import TensorInfo, TensorsConfig


@register_decoder
class TensorRegion(Decoder):
    MODE = "tensor_region"

    def init(self, options):
        super().init(options)
        opts = list(options) + [None] * 9
        self.num = int(opts[0]) if opts[0] else 1
        self.props = MobilenetSSD()
        if opts[1]:
            self.props.total_labels = len(det.load_labels(opts[1]))
        self.props.i_width, self.props.i_height = 300, 300
        if opts[3]:
            self.props.i_width, self.props.i_height = _parse_wh(
                opts[3], "option4 (input size)"
            )
        if opts[2]:
            self.props.set_option_internal(opts[2])

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        self.props.check_compatible(config)
        rate = (
            f",framerate={config.rate_n}/{config.rate_d}"
            if config.rate_n >= 0 and config.rate_d > 0
            else ""
        )
        return Caps.from_string(f"other/tensors,format=flexible{rate}")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        results = self.props.decode_boxes(config, typed_tensors(buf, config))
        # top-N by probability (gst_tensor_top_detectedObjects_cropInfo)
        order = np.argsort(-results.prob, kind="stable")[: self.num]
        top = results.take(order)
        regions = np.zeros((self.num, 4), np.uint32)
        n = len(top)
        if n:
            regions[:n, 0] = np.maximum(0, top.x)
            regions[:n, 1] = np.maximum(0, top.y)
            regions[:n, 2] = np.maximum(0, top.width)
            regions[:n, 3] = np.maximum(0, top.height)
        info = TensorInfo(dims=(4, self.num), dtype="uint32")
        out = buf.with_tensors([wrap_flexible(regions, info)])
        out.meta["crop_regions"] = top.to_list()
        return out
