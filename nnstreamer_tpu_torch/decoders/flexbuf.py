"""flexbuf decoder: tensors → self-describing flexible binary stream.

Parity: tensordec-flexbuf.cc serializes tensors with FlexBuffers so any
consumer can reconstruct them without negotiated caps. Our wire format is
the framework's own flexible-tensor header (meta.py pack_header — magic/
version/dtype/dims, tensor_typedef.h:310-326), which round-trips through
the flex_to_tensor converter (converters/flexbuf.py).
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder, typed_tensors
from nnstreamer_tpu_torch.meta import wrap_flexible
from nnstreamer_tpu_torch.types import TensorInfo, TensorsConfig


@register_decoder
class FlexBuf(Decoder):
    MODE = "flexbuf"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        rate = (
            f",framerate={config.rate_n}/{config.rate_d}"
            if config.rate_n >= 0 and config.rate_d > 0
            else ""
        )
        return Caps.from_string(f"other/tensors,format=flexible{rate}")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        out = []
        arrays = typed_tensors(buf, config)
        for i, arr in enumerate(arrays):
            info = (
                config.info[i]
                if i < config.info.num_tensors
                else TensorInfo.from_np_shape(arr.shape, np.dtype(arr.dtype))
            )
            out.append(wrap_flexible(np.ascontiguousarray(arr), info))
        return buf.with_tensors(out)
