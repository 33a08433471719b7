"""tensor_converter — media streams → other/tensors (counterpart of the JAX
package's ``elements/converter.py``).

Mirrors gsttensor_converter.c (2451 LoC): video/x-raw (RGB/BGRx/GRAY8),
audio/x-raw (S16LE/F32LE), text, application/octet-stream, and flexible
tensors in; `frames-per-tensor` batching; unknown media types delegate to
converter subplugins (findExternalConverter gsttensor_converter.c:171).

Dim conventions (reference video parse, gsttensor_converter.c:1440):
video HxW RGB → dims channel:width:height:frames = 3:W:H:1, uint8.
audio S16 C channels, F frames → C:F:1, int16. text → fixed-size uint8 via
``input-dim``. octet → dims from ``input-dim``+``input-type`` props.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch import meta as meta_mod
from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import (
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
    parse_dimension,
)

_VIDEO_CH = {"RGB": 3, "BGR": 3, "BGRx": 4, "RGBx": 4, "xRGB": 4, "GRAY8": 1}
_AUDIO_DT = {"S16LE": "int16", "U8": "uint8", "F32LE": "float32", "S32LE": "int32"}


@element_register
class TensorConverter(Element):
    ELEMENT_NAME = "tensor_converter"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "frames_per_tensor": Prop("int"),
        "input_dim": Prop("str", doc="dims for text/octet input"),
        "input_type": Prop("str"),
        "subplugin": Prop("str", doc="external converter subplugin"),
        "script": Prop("str", doc="python3 converter script path"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._mode: Optional[str] = None
        self._out_config: Optional[TensorsConfig] = None
        self._frames_per_tensor = int(self.properties.get("frames_per_tensor", 1))
        self._accum: List[np.ndarray] = []
        self._sub = None  # external converter subplugin

    # -- negotiation -------------------------------------------------------
    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        s = caps.structures[0]
        mt = s.media_type
        # an explicitly requested subplugin overrides built-in media-type
        # dispatch (the reference's mode=custom-script/custom-code path,
        # gsttensor_converter.c:486)
        if self.properties.get("subplugin"):
            return self._use_subplugin(caps, mt)
        fpt = self._frames_per_tensor
        rate = s.fields.get("framerate")
        rate_n, rate_d = (rate.numerator, rate.denominator) if hasattr(rate, "numerator") else (-1, -1)
        if rate_n > 0 and fpt > 1:
            rate_n, rate_d = rate_n, rate_d * fpt  # batching divides frame rate
        if mt == "video/x-raw":
            fmt = s.fields.get("format", "RGB")
            if fmt not in _VIDEO_CH:
                raise ElementError(self.name, f"unsupported video format {fmt}")
            w, h = int(s.fields["width"]), int(s.fields["height"])
            ch = _VIDEO_CH[fmt]
            self._mode = f"video:{fmt}"
            info = TensorsInfo(tensors=[TensorInfo((ch, w, h, fpt), "uint8")])
        elif mt == "audio/x-raw":
            afmt = s.fields.get("format", "S16LE")
            if afmt not in _AUDIO_DT:
                raise ElementError(self.name, f"unsupported audio format {afmt}")
            ch = int(s.fields.get("channels", 1))
            self._mode = f"audio:{afmt}:{ch}"
            # per-buffer frame count varies; dims fixed only with frames-per-tensor
            info = TensorsInfo(tensors=[TensorInfo((ch, fpt if fpt > 1 else 1), _AUDIO_DT[afmt])])
            if fpt <= 1:
                self._mode += ":dynamic"
        elif mt == "text/x-raw":
            dim = self.properties.get("input_dim")
            if not dim:
                raise ElementError(self.name, "text input needs input-dim=<max-bytes>")
            self._mode = "text"
            info = TensorsInfo(tensors=[TensorInfo(parse_dimension(str(dim)), "uint8")])
        elif mt == "application/octet-stream":
            dim, typ = self.properties.get("input_dim"), self.properties.get("input_type")
            if not dim or not typ:
                raise ElementError(self.name, "octet input needs input-dim and input-type")
            self._mode = "octet"
            info = TensorsInfo.from_strings(str(dim), str(typ))
        elif mt in ("other/tensors", "other/tensor"):
            # flexible → static passthrough conversion (self-describing in)
            self._mode = "flexible"
            info = TensorsInfo(format=TensorFormat.FLEXIBLE)
        else:
            # delegate to converter subplugins (flexbuf/protobuf/python3...)
            return self._use_subplugin(caps, mt)
        self._out_config = TensorsConfig(info, rate_n, rate_d)
        return Caps.from_config(self._out_config)

    def _use_subplugin(self, caps: Caps, mt: str) -> Caps:
        """Resolve a converter subplugin (findExternalConverter
        gsttensor_converter.c:171): explicit ``subplugin=`` first, then
        accepts() probing by media type."""
        sub = None
        sub_name = self.properties.get("subplugin")
        if sub_name:
            sub = registry.get(registry.CONVERTER, str(sub_name))
            if sub is None:
                raise ElementError(self.name, f"no converter subplugin {sub_name!r}")
        if sub is None:
            # available() includes not-yet-imported builtins; get() lazy-loads
            for name in registry.available(registry.CONVERTER) or []:
                cand = registry.get(registry.CONVERTER, name)
                if cand is not None and getattr(cand, "accepts", lambda m: False)(mt):
                    sub = cand
                    break
        if sub is None:
            raise ElementError(self.name, f"no converter for media type {mt!r}")
        self._sub = sub() if callable(sub) else sub
        script = self.properties.get("script")
        if script and hasattr(self._sub, "set_script"):
            self._sub.set_script(str(script))
        self._mode = "subplugin"
        out_cfg = self._sub.get_out_config(caps)
        self._out_config = out_cfg
        return Caps.from_config(out_cfg)

    # -- chain -------------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._mode is None:
            return FlowReturn.NOT_NEGOTIATED
        if self._mode == "subplugin":
            return self.push(self._sub.convert(buf))
        if self._mode == "flexible":
            tensors = [
                meta_mod.unwrap_flexible(t)[0]
                if isinstance(t, (bytes, bytearray, memoryview)) else t
                for t in buf.tensors
            ]
            return self.push(buf.with_tensors(tensors))

        arrs = buf.as_numpy()
        if len(arrs) != 1:
            raise ElementError(self.name, f"expected 1 media payload, got {len(arrs)}")
        a = arrs[0]
        if self._mode.startswith("video"):
            fmt = self._mode.split(":")[1]
            info = self._out_config.info[0]
            ch, w, h = info.dims[0], info.dims[1], info.dims[2]
            frame = a.reshape(h, w, ch) if a.ndim != 3 else a
            # stride-padding removal is a no-op here: numpy frames are packed
            # (the reference memcpy-strips GStreamer's 4-byte row alignment,
            # gsttensor_converter.c "remove padding")
            out = frame
        elif self._mode.startswith("audio"):
            parts = self._mode.split(":")
            ch = int(parts[2])
            dt = _AUDIO_DT[parts[1]]
            out = a.view(np.dtype(dt)).reshape(-1, ch) if a.dtype == np.uint8 else a.reshape(-1, ch)
        elif self._mode == "text":
            info = self._out_config.info[0]
            size = info.dims[0]
            raw = a.tobytes()[:size]
            out = np.frombuffer(raw.ljust(size, b"\0"), dtype=np.uint8)
        elif self._mode == "octet":
            info = self._out_config.info[0]
            out = np.frombuffer(a.tobytes(), dtype=info.dtype.np_dtype).reshape(info.np_shape())
        else:
            raise ElementError(self.name, f"bad mode {self._mode}")

        if self._frames_per_tensor > 1:
            self._accum.append(out)
            if len(self._accum) < self._frames_per_tensor:
                return FlowReturn.OK
            spans = self._spans()
            t_asm = time.perf_counter() if spans is not None else 0.0
            out = np.stack(self._accum, axis=0)
            if spans is not None:
                # the frames-per-tensor stack IS the bench's host-stack
                # baseline (run_profile host_stack_ms_per_batch): span it
                # so the attribution names it `batching_padding`
                spans.emit("batch-assemble", "batch", t_asm,
                           time.perf_counter(),
                           args={"element": self.name,
                                 "rows": self._frames_per_tensor})
            self._accum = []
        return self.push(buf.with_tensors([out]))
