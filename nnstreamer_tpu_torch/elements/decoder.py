"""tensor_decoder element — dispatches to decoder subplugins.

Parity: gsttensor_decoder.c (1010 LoC): ``mode`` property selects the
subplugin, option1..option9 pass through, runtime-registerable custom
decoders (gsttensor_decoder.c:972-1006)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import TensorsConfig


@element_register
class TensorDecoder(Element):
    ELEMENT_NAME = "tensor_decoder"
    SINK_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "mode": Prop("str", required=True, doc="decoder subplugin"),
        "split_batch": Prop("int", doc="emit N per-frame buffers from a "
                                       "batched tensor"),
        **{f"option{i}": Prop("str") for i in range(1, 10)},
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._dec = None
        self._config: Optional[TensorsConfig] = None

    def start(self) -> None:
        mode = self.properties.get("mode")
        if not mode:
            raise ElementError(self.name, "tensor_decoder needs mode=<subplugin>")
        # custom decoders registered at runtime take priority
        cls = registry.get(registry.CUSTOM_DECODER, str(mode)) or registry.get(
            registry.DECODER, str(mode)
        )
        if cls is None:
            raise ElementError(
                self.name,
                f"no decoder mode {mode!r}; available: {registry.available(registry.DECODER)}",
            )
        self._dec = cls() if callable(cls) else cls
        opts = [
            str(self.properties[f"option{i}"]) if f"option{i}" in self.properties else None
            for i in range(1, 10)
        ]
        self._dec.init(opts)

    def stop(self) -> None:
        if self._dec is not None:
            self._dec.exit()
            self._dec = None

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        self._config = caps.to_config()
        return self._dec.get_out_caps(self._config)

    # -- residency negotiation (memory:HBM lane) ---------------------------
    def accepts_device(self, pad: Pad) -> bool:
        """Decoder subplugins are host math unless they declare
        ``DEVICE_CAPABLE = True`` (then the backend's tensors flow in
        untouched and split-batch slices them where they are)."""
        return bool(getattr(self._dec, "DEVICE_CAPABLE", False))

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._dec is None or self._config is None:
            return FlowReturn.NOT_NEGOTIATED
        if not getattr(self._dec, "DEVICE_CAPABLE", False):
            # a host decoder: the backend's tensors cross once, billed as
            # the JAX element bills its fetch
            buf = self._fetch_to_host(buf)
        split = int(self.properties.get("split_batch", 0) or 0)
        if split > 1:
            # split-batch=N: upstream micro-batching hands this element
            # tensors with a leading batch dim; emit one decoded buffer per
            # frame, preserving order
            arrs = [t if isinstance(t, torch.Tensor) else np.asarray(t)
                    for t in buf.tensors]
            for a in arrs:
                if a.ndim == 0 or a.shape[0] != split:
                    raise ElementError(
                        self.name,
                        f"split-batch={split} but tensor leading dim is "
                        f"{tuple(a.shape)[:1]} (shape {tuple(a.shape)})",
                    )
            ret = FlowReturn.OK
            for b in range(split):
                sub = buf.with_tensors([a[b] for a in arrs])
                ret = self.push(self._dec.decode(sub, self._config))
                if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                    return ret
            return ret
        return self.push(self._dec.decode(buf, self._config))


def register_custom_decoder(mode: str, decoder_cls) -> None:
    """Runtime custom decoder registration
    (nnstreamer_decoder_custom_register parity, gsttensor_decoder.c:972)."""
    registry.register(registry.CUSTOM_DECODER, mode)(decoder_cls)


def unregister_custom_decoder(mode: str) -> bool:
    return registry.unregister(registry.CUSTOM_DECODER, mode)
