"""tensor_converter — media streams → other/tensors.

Mirrors gsttensor_converter.c for video/x-raw (RGB/BGRx/GRAY8) with
`frames-per-tensor` batching. Dim convention (reference video parse,
gsttensor_converter.c:1440): video HxW RGB → dims channel:width:height:frames
= 3:W:H:1, uint8.

The JAX package's audio, text, octet-stream, flexible and converter-subplugin
paths are not ported yet; other media types are refused at negotiation.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import TensorInfo, TensorsConfig, TensorsInfo

_VIDEO_CH = {"RGB": 3, "BGR": 3, "BGRx": 4, "RGBx": 4, "xRGB": 4, "GRAY8": 1}


@element_register
class TensorConverter(Element):
    ELEMENT_NAME = "tensor_converter"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "frames_per_tensor": Prop("int"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._out_config: Optional[TensorsConfig] = None
        self._frames_per_tensor = int(self.properties.get("frames_per_tensor", 1))
        self._accum: List[np.ndarray] = []

    # -- negotiation -------------------------------------------------------
    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        s = caps.structures[0]
        mt = s.media_type
        if mt != "video/x-raw":
            raise ElementError(
                self.name, f"media type {mt!r} is not supported by this "
                "package's tensor_converter (video/x-raw only)")
        fpt = self._frames_per_tensor
        rate = s.fields.get("framerate")
        rate_n, rate_d = (rate.numerator, rate.denominator) if hasattr(rate, "numerator") else (-1, -1)
        if rate_n > 0 and fpt > 1:
            rate_n, rate_d = rate_n, rate_d * fpt  # batching divides frame rate
        fmt = s.fields.get("format", "RGB")
        if fmt not in _VIDEO_CH:
            raise ElementError(self.name, f"unsupported video format {fmt}")
        w, h = int(s.fields["width"]), int(s.fields["height"])
        info = TensorsInfo(tensors=[TensorInfo((_VIDEO_CH[fmt], w, h, fpt), "uint8")])
        self._out_config = TensorsConfig(info, rate_n, rate_d)
        return Caps.from_config(self._out_config)

    # -- chain -------------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._out_config is None:
            return FlowReturn.NOT_NEGOTIATED
        arrs = buf.as_numpy()
        if len(arrs) != 1:
            raise ElementError(self.name, f"expected 1 media payload, got {len(arrs)}")
        a = arrs[0]
        ch, w, h = self._out_config.info[0].dims[:3]
        # numpy frames are packed: the reference's stride-padding removal
        # (gsttensor_converter.c "remove padding") is a reshape here
        out = a.reshape(h, w, ch) if a.ndim != 3 else a
        if self._frames_per_tensor > 1:
            self._accum.append(out)
            if len(self._accum) < self._frames_per_tensor:
                return FlowReturn.OK
            out = np.stack(self._accum, axis=0)
            self._accum = []
        return self.push(buf.with_tensors([out]))
