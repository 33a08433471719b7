"""image_labeling decoder: classification scores → text/x-raw label.

Parity: tensordec-imagelabel.c — option1 = label file (one label per line),
output is the argmax label as a text stream. The reference's golden tests
(tests/nnstreamer_decoder_image_labeling) byte-compare the emitted label.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder
from nnstreamer_tpu_torch.types import TensorsConfig


@register_decoder
class ImageLabeling(Decoder):
    MODE = "image_labeling"

    def init(self, options):
        super().init(options)
        self.labels = []
        if options and options[0]:
            with open(options[0], "r", encoding="utf-8") as f:
                self.labels = [line.rstrip("\n") for line in f]

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps.from_string("text/x-raw,format=utf8")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        scores = np.asarray(buf.tensors[0])
        if scores.dtype in (np.int32, np.int64) and (
            scores.ndim <= 1 or scores.shape[-1] == 1
        ):
            # upstream ran the argmax on the device
            # (filter custom=postproc:argmax): already class indices.
            # Narrow dtype/shape check: quantized uint8/int8 SCORE tensors
            # (tflite backend) must still take the argmax branch below.
            idxs = scores.reshape(-1)
        else:
            # batched frames (micro-batching upstream): one label per row
            rows = (
                scores.reshape(-1, scores.shape[-1]) if scores.ndim > 1 else scores[None]
            )
            idxs = np.argmax(rows, axis=-1)
        labels = [
            self.labels[i] if i < len(self.labels) else str(i) for i in map(int, idxs)
        ]
        out = buf.with_tensors(["\n".join(labels).encode("utf-8")])
        out.meta["label_index"] = int(idxs[0]) if len(idxs) == 1 else [int(i) for i in idxs]
        out.meta["label"] = labels[0] if len(labels) == 1 else labels
        return out
