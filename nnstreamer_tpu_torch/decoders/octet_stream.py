"""octet_stream decoder: tensors → application/octet-stream raw bytes.

Parity: tensordec-octetstream.c — concatenates every tensor's raw payload
into one octet stream buffer.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder
from nnstreamer_tpu_torch.types import TensorsConfig


@register_decoder
class OctetStream(Decoder):
    MODE = "octet_stream"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps.from_string("application/octet-stream")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        chunks = []
        for t in buf.tensors:
            if isinstance(t, (bytes, bytearray, memoryview)):
                chunks.append(bytes(t))
            else:
                chunks.append(np.ascontiguousarray(np.asarray(t)).tobytes())
        return buf.with_tensors([b"".join(chunks)])
