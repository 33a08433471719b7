"""protobuf converter: serialized TensorFrame stream → tensors.

Parity: ext/nnstreamer/tensor_converter/tensor_converter_protobuf.cc
(inverse of the protobuf decoder). Each payload is one nnstpu.TensorFrame
message (rpc/proto.py).

A copy of the JAX package's subplugin. It registers without the
``google.protobuf`` package; a stream that reaches it without that package raises
``ElementError`` naming it (:func:`nnstreamer_tpu_torch.rpc.codec`).
"""

from __future__ import annotations

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.converters import register_converter
from nnstreamer_tpu_torch.rpc import codec
from nnstreamer_tpu_torch.types import TensorFormat, TensorsConfig, TensorsInfo


@register_converter("protobuf")
class ProtobufConverter:
    MEDIA_TYPES = ("other/protobuf-tensor", "application/protobuf")

    @classmethod
    def accepts(cls, media_type: str) -> bool:
        return media_type in cls.MEDIA_TYPES

    def __init__(self):
        _, self._decode = codec("protobuf", "tensor_converter (protobuf)")

    def get_out_config(self, caps: Caps) -> TensorsConfig:
        # frames are self-describing; config firms up per-buffer
        return TensorsConfig(TensorsInfo(format=TensorFormat.FLEXIBLE), -1, -1)

    def convert(self, buf: Buffer) -> Buffer:
        tensors = []
        pts = buf.pts
        for t in buf.tensors:
            frame, _cfg = self._decode(bytes(t))
            tensors.extend(frame.tensors)
            if pts < 0:
                pts = frame.pts
        out = buf.with_tensors(tensors)
        out.pts = pts
        return out
