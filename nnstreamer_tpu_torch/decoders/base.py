"""Decoder ABI (GstTensorDecoderDef parity, nnstreamer_plugin_api_decoder.h:38-97)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.types import TensorsConfig


def typed_tensors(buf: Buffer, config: TensorsConfig) -> List[np.ndarray]:
    """Materialize the buffer's tensors as numpy arrays typed per the
    negotiated config (raw bytes payloads are reinterpreted with the
    negotiated dtype/shape, matching how the reference's decoders cast
    GstTensorMemory.data).

    Flexible/sparse payloads are self-describing — their per-tensor meta
    header wins over (the typically empty) negotiated info, same as
    tensor_filter's header strip (tensor_filter.c:706-708). Arrays built
    from bytes are writable copies (as_numpy/unwrap_flexible convention).
    """
    from nnstreamer_tpu_torch import meta as meta_mod
    from nnstreamer_tpu_torch.types import TensorFormat

    out = []
    n_info = config.info.num_tensors
    for i, t in enumerate(buf.tensors):
        if isinstance(t, (bytes, bytearray, memoryview)):
            raw = bytes(t)
            if config.info.format == TensorFormat.FLEXIBLE:
                out.append(meta_mod.unwrap_flexible(raw)[0])
            elif config.info.format == TensorFormat.SPARSE:
                out.append(meta_mod.sparse_decode(raw)[0])
            elif i < n_info and config.info[i].is_fixed():
                info = config.info[i]
                arr = np.frombuffer(raw, dtype=info.dtype.np_dtype).copy()
                out.append(arr.reshape(info.np_shape()))
            else:
                out.append(np.frombuffer(raw, dtype=np.uint8).copy())
        else:
            out.append(np.asarray(t))
    return out


class Decoder:
    """Subclass + register under a mode name. One instance per element."""

    MODE: str = "base"

    def init(self, options: List[Optional[str]]) -> None:
        """option1..optionN strings (setOption parity). Called before caps."""
        self.options = options

    def exit(self) -> None:
        pass

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        """Output caps for negotiated input tensors (getOutCaps)."""
        raise NotImplementedError

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        """Decode one frame of tensors into the output media (decode)."""
        raise NotImplementedError


def register_decoder(cls):
    """Class decorator: register under cls.MODE (self-registration parity,
    tensordec-boundingbox.cc:194)."""
    registry.register(registry.DECODER, cls.MODE)(cls)
    return cls
