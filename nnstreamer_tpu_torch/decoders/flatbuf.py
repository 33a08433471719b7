"""flatbuf decoder: tensors → flexbuffers-encoded frame stream.

Parity: ext/nnstreamer/tensor_decoder/tensordec-flatbuf.cc. Round-trips
through converters/flatbuf.py.

A copy of the JAX package's subplugin; the decoder element hands it host
arrays. It registers without the ``flatbuffers`` package; a decoder that starts
without it raises ``ElementError`` naming it.
"""

from __future__ import annotations

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder, typed_tensors
from nnstreamer_tpu_torch.rpc import codec
from nnstreamer_tpu_torch.types import TensorsConfig


@register_decoder
class Flatbuf(Decoder):
    MODE = "flatbuf"

    def init(self, options) -> None:
        super().init(options)
        self._encode, _ = codec("flatbuf", "tensor_decoder mode=flatbuf")

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps.from_string("other/flatbuf-tensor")

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        arrays = typed_tensors(buf, config)
        payload = self._encode(buf.with_tensors(arrays), config)
        return buf.with_tensors([payload])
