"""python3 script converter — user-defined media→tensor conversion.

Parity: ext/nnstreamer/tensor_converter/tensor_converter_python3.cc: a user
script class converts arbitrary payloads to tensors. Script contract
(mirrors the reference's custom converter scripts,
tests custom_converter.py):

    class CustomConverter:
        def get_out_info(self, caps_str):   # -> TensorsInfo | (dims, types)
        def convert(self, raw_list):        # list[bytes|ndarray] -> list[ndarray]

Select with ``tensor_converter subplugin=python3 script=<file.py>`` (any
media type) — scripts decide what they accept.
"""

from __future__ import annotations

from typing import Optional

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.converters import register_converter
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pyscript import instantiate_script_class, load_script_class
from nnstreamer_tpu_torch.types import TensorsConfig, TensorsInfo


@register_converter("python3")
class Python3Converter:
    """Instantiated per element; the script path arrives via the element's
    ``script`` property (read from caps option in get_out_config otherwise)."""

    def __init__(self, script: Optional[str] = None):
        self._obj = None
        self._script = script

    @classmethod
    def accepts(cls, media_type: str) -> bool:
        return False  # explicit selection only (subplugin=python3)

    def _load(self, path: str) -> None:
        try:
            cls = load_script_class(path, "convert")
        except ValueError as e:
            raise ElementError("tensor_converter", str(e)) from e
        self._obj = instantiate_script_class(cls)

    def set_script(self, path: str) -> None:
        self._script = path

    def get_out_config(self, caps: Caps) -> TensorsConfig:
        if self._obj is None:
            if not self._script:
                raise ElementError(
                    "tensor_converter", "python3 converter needs script=<file.py>"
                )
            self._load(self._script)
        res = self._obj.get_out_info(str(caps)) if hasattr(self._obj, "get_out_info") else None
        s = caps.structures[0]
        rate = s.fields.get("framerate")
        rate_n, rate_d = (
            (rate.numerator, rate.denominator)
            if hasattr(rate, "numerator")
            else (-1, -1)
        )
        if res is None:
            from nnstreamer_tpu_torch.types import TensorFormat

            return TensorsConfig(
                TensorsInfo(format=TensorFormat.FLEXIBLE), rate_n, rate_d
            )
        if isinstance(res, TensorsInfo):
            info = res
        else:
            info = TensorsInfo.from_strings(str(res[0]), str(res[1]))
        return TensorsConfig(info, rate_n, rate_d)

    def convert(self, buf: Buffer) -> Buffer:
        outs = self._obj.convert(list(buf.tensors))
        return buf.with_tensors(
            list(outs) if isinstance(outs, (list, tuple)) else [outs]
        )
