"""Platform-gated sources: tensor_src_tizensensor and amcsrc parity
(counterpart of the JAX package's ``elements/platform_sources.py``).

The reference gates these elements on vendor SDKs at build time:
  - tensor_src_tizensensor (ext/nnstreamer/tensor_source/
    tensor_src_tizensensor.c) needs the Tizen sensor framework;
  - amcsrc (ext/nnstreamer/android_source/gstamcsrc.c) needs the Android
    MediaCodec JNI looper.

This package registers the elements unconditionally (launch strings stay
portable) and gates at START time instead: without the platform API a
clear error explains the gap, and a process-local **provider hook** lets
applications (and tests) supply readings/frames from any sensor/decoder
stack — the extension seam the reference implements in C per vendor.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import SourceElement, element_register

log = get_logger("platform_sources")

#: name -> callable() -> Optional[np.ndarray]; None ends the stream
_sensor_providers: Dict[str, Callable[[], Optional[np.ndarray]]] = {}
#: name -> callable() -> Optional[tuple(np.ndarray frame, pts_ns)]
_media_providers: Dict[str, Callable[[], Optional[tuple]]] = {}


def register_sensor_provider(name: str, fn: Callable[[], Optional[np.ndarray]]) -> None:
    """Plug a sensor backend (the Tizen sensor-fw seam)."""
    _sensor_providers[name] = fn


def unregister_sensor_provider(name: str) -> bool:
    return _sensor_providers.pop(name, None) is not None


def register_media_provider(name: str, fn: Callable[[], Optional[tuple]]) -> None:
    """Plug a media-decoder backend (the MediaCodec seam)."""
    _media_providers[name] = fn


def unregister_media_provider(name: str) -> bool:
    return _media_providers.pop(name, None) is not None


@element_register
class TensorSrcTizenSensor(SourceElement):
    """tensor_src_tizensensor parity (tensor_src_tizensensor.c).

    Props: type (sensor name, e.g. 'accelerometer'), freq (Hz, default 10),
    num_buffers (-1 = until provider returns None). Emits float32 tensors.
    """

    ELEMENT_NAME = "tensor_src_tizensensor"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "type": Prop("str", required=True, doc="sensor name"),
        "freq": Prop("int"),
        "num_buffers": Prop("int"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._provider = None
        self._i = 0

    def start(self) -> None:
        sensor = str(self.properties.get("type", ""))
        self._provider = _sensor_providers.get(sensor)
        if self._provider is None:
            raise ElementError(
                self.name,
                f"no provider for sensor type {sensor!r}: the Tizen sensor "
                "framework is not available on this platform — register one "
                "with nnstreamer_tpu_torch.elements.platform_sources."
                "register_sensor_provider(type, fn)",
            )
        self._i = 0

    def negotiate(self) -> Optional[Caps]:
        probe = self._provider()
        if probe is None:
            raise ElementError(self.name, "sensor provider yielded no probe reading")
        self._probe = np.asarray(probe, dtype=np.float32).reshape(-1)
        freq = int(self.properties.get("freq", 10) or 10)
        return Caps.from_string(
            "other/tensors,num-tensors=1,"
            f"dimensions={self._probe.shape[0]},types=float32,framerate={freq}/1"
        )

    def create(self) -> Optional[Buffer]:
        n = int(self.properties.get("num_buffers", -1))
        if 0 <= n <= self._i:
            return None
        if self._i == 0 and getattr(self, "_probe", None) is not None:
            reading, self._probe = self._probe, None
        else:
            r = self._provider()
            if r is None:
                return None
            reading = np.asarray(r, dtype=np.float32).reshape(-1)
        freq = int(self.properties.get("freq", 10) or 10)
        if self._i > 0:
            time.sleep(1.0 / freq)  # paced capture (reference polls at freq)
        buf = Buffer(tensors=[reading], pts=int(self._i * 1e9 / freq))
        self._i += 1
        return buf


@element_register
class AmcSrc(SourceElement):
    """amcsrc parity (gstamcsrc.c) — hardware-decoded media frames as a
    source. Props: provider (name of a provider registered with
    register_media_provider; default "default"), num_buffers. The provider
    is called per frame and returns (RGB ndarray, pts_ns) or None at EOS;
    emits video/x-raw RGB."""

    ELEMENT_NAME = "amcsrc"
    SRC_TEMPLATE = "video/x-raw"
    PROPERTY_SCHEMA = {
        "provider": Prop("str"),
        "freq": Prop("int"),
        "num_buffers": Prop("int"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._provider = None
        self._i = 0
        self._first = None

    def start(self) -> None:
        key = str(self.properties.get("provider", "default"))
        factory = _media_providers.get(key)
        if factory is None:
            raise ElementError(
                self.name,
                f"no media provider {key!r}: Android MediaCodec is not "
                "available on this platform — register a decoder with "
                "nnstreamer_tpu_torch.elements.platform_sources."
                "register_media_provider(name, fn)",
            )
        self._provider = factory
        self._i = 0

    def negotiate(self) -> Optional[Caps]:
        item = self._provider()
        if item is None:
            raise ElementError(self.name, "media provider yielded no frame")
        frame, _pts = item
        self._first = item
        h, w = np.asarray(frame).shape[:2]
        return Caps.from_string(
            f"video/x-raw,format=RGB,width={w},height={h},framerate=30/1"
        )

    def create(self) -> Optional[Buffer]:
        n = int(self.properties.get("num_buffers", -1))
        if 0 <= n <= self._i:
            return None
        if self._first is not None:
            item, self._first = self._first, None
        else:
            item = self._provider()
        if item is None:
            return None
        frame, pts = item
        buf = Buffer(tensors=[np.asarray(frame, dtype=np.uint8)], pts=int(pts))
        self._i += 1
        return buf
