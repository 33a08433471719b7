"""flexbuf converter: self-describing binary stream → static tensors.

Parity: ext/nnstreamer/tensor_converter/tensor_converter_flexbuf.cc — the
inverse of the flexbuf decoder. The wire format is the framework's
flexible-tensor header (meta.py pack_header, tensor_typedef.h:310-326
GstTensorMetaInfo); each incoming payload may carry several concatenated
header+payload records.
"""

from __future__ import annotations

from typing import List

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.converters import register_converter
from nnstreamer_tpu_torch.meta import HEADER_SIZE, parse_header, unwrap_flexible
from nnstreamer_tpu_torch.types import TensorFormat, TensorsConfig, TensorsInfo


@register_converter("flexbuf")
class FlexBufConverter:
    MEDIA_TYPES = ("other/flexbuf", "application/octet-stream+flex")

    @classmethod
    def accepts(cls, media_type: str) -> bool:
        return media_type in cls.MEDIA_TYPES

    def get_out_config(self, caps: Caps) -> TensorsConfig:
        s = caps.structures[0]
        rate = s.fields.get("framerate")
        rate_n, rate_d = (
            (rate.numerator, rate.denominator)
            if hasattr(rate, "numerator")
            else (-1, -1)
        )
        # payload is self-describing; stream stays flexible until first frame
        return TensorsConfig(
            TensorsInfo(format=TensorFormat.FLEXIBLE), rate_n, rate_d
        )

    def convert(self, buf: Buffer) -> Buffer:
        tensors: List[np.ndarray] = []
        for t in buf.tensors:
            data = bytes(t)
            off = 0
            while off < len(data):
                info, _, _nnz = parse_header(data[off : off + HEADER_SIZE])
                nbytes = info.size
                end = off + HEADER_SIZE + nbytes
                if end > len(data):
                    raise ValueError(
                        f"truncated flexible record: need {end}, have {len(data)}"
                    )
                arr, _ = unwrap_flexible(data[off:end])
                tensors.append(arr)
                off = end
        return buf.with_tensors(tensors)
