"""tensor_sparse_enc / tensor_sparse_dec — static ↔ sparse stream format
(counterpart of the JAX package's ``elements/sparse.py``).

Reference parity: gsttensor_sparseenc.c:419 / gsttensor_sparsedec.c:412 /
gsttensor_sparseutil.c:255 — sparse payload = meta header (with nnz) +
values + uint indices (tensor_typedef.h:294-297). The encoder works on
the host: fed the backend's tensors it brings them over in one batched
transfer and records one ``d2h`` crossing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nnstreamer_tpu_torch import meta as meta_mod
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import (
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
)


@element_register
class TensorSparseEnc(Element):
    ELEMENT_NAME = "tensor_sparse_enc"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        cfg = caps.to_config()
        out = TensorsConfig(
            TensorsInfo(format=TensorFormat.SPARSE), cfg.rate_n, cfg.rate_d
        )
        return Caps.from_config(out)

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        blobs = []
        for t in self._fetch_to_host(buf).as_numpy():
            info = TensorInfo.from_np_shape(t.shape, t.dtype)
            blobs.append(meta_mod.sparse_encode(t, info))
        return self.push(buf.with_tensors(blobs))


@element_register
class TensorSparseDec(Element):
    ELEMENT_NAME = "tensor_sparse_dec"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        cfg = caps.to_config()
        # dense shape is per-buffer self-described; advertise flexible out
        out = TensorsConfig(
            TensorsInfo(format=TensorFormat.FLEXIBLE), cfg.rate_n, cfg.rate_d
        )
        return Caps.from_config(out)

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        dense = [meta_mod.sparse_decode(bytes(t))[0] for t in buf.tensors]
        return self.push(buf.with_tensors(dense))
