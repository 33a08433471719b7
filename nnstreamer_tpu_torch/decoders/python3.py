"""python3 decoder: user script class as a decoder subplugin.

Parity: tensordec-python3.cc — option1 is a path to a python script whose
``CustomDecoder`` class provides ``getOutCaps()`` (caps string) and
``decode(raw_data, in_info, rate_n, rate_d)``. Since this framework is
Python-native we load the script directly (no embedded interpreter), and
additionally accept the framework-style ``get_out_caps(config)`` /
``decode(buf, config)`` method pair for richer custom decoders.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.decoders.base import Decoder, register_decoder, typed_tensors
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.types import TensorsConfig

_counter = [0]


def _load_script(path: str):
    if not os.path.exists(path):
        raise ElementError("tensor_decoder", f"python3 decoder script not found: {path}")
    _counter[0] += 1
    name = f"nns_tpu_pydecoder_{_counter[0]}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@register_decoder
class Python3Decoder(Decoder):
    MODE = "python3"

    def init(self, options):
        super().init(options)
        if not options or not options[0]:
            raise ElementError("tensor_decoder", "python3 decoder needs option1=script.py")
        mod = _load_script(options[0])
        cls = getattr(mod, "CustomDecoder", None)
        if cls is None:
            raise ElementError(
                "tensor_decoder", f"{options[0]} does not define class CustomDecoder"
            )
        self.obj = cls()

    def exit(self) -> None:
        self.obj = None

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        if hasattr(self.obj, "get_out_caps"):
            caps = self.obj.get_out_caps(config)
        elif hasattr(self.obj, "getOutCaps"):
            caps = self.obj.getOutCaps()
        else:
            raise ElementError(
                "tensor_decoder", "CustomDecoder needs get_out_caps/getOutCaps"
            )
        return caps if isinstance(caps, Caps) else Caps.from_string(str(caps))

    def decode(self, buf: Buffer, config: TensorsConfig) -> Buffer:
        if hasattr(self.obj, "decode_buffer"):
            out = self.obj.decode_buffer(buf, config)
            if not isinstance(out, Buffer):
                raise ElementError("tensor_decoder", "decode_buffer must return Buffer")
            return out
        raw = typed_tensors(buf, config)
        in_info = [config.info[i] for i in range(config.info.num_tensors)]
        result = self.obj.decode(raw, in_info, config.rate_n, config.rate_d)
        if isinstance(result, Buffer):
            return result
        if isinstance(result, (bytes, bytearray)):
            return buf.with_tensors([bytes(result)])
        return buf.with_tensors(list(result) if isinstance(result, (list, tuple)) else [result])
