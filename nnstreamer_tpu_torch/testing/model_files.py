"""Model files made at run time from the zoo's seed weights, for the
importer tests and ``chip_smoke.py`` (no model file is committed, and the
card's machine has neither TensorFlow nor the ``flatbuffers`` package).

  - :func:`write_mobilenet_v2_tflite` writes the zoo model
    ``mobilenet_v2 custom=seed:<n>`` (any ``width``/``size``/``classes``)
    as a float32 ``.tflite`` flatbuffer, BatchNorm folded into each conv:
    CONV_2D / DEPTHWISE_CONV_2D with fused RELU6, ADD for the residuals,
    MEAN over H and W, FULLY_CONNECTED for the logits. NHWC float32
    [1, size, size, 3] in (frames normalized to [-1, 1]), [1, classes]
    logits out. The flatbuffer comes from :class:`FlatBufferWriter`, a
    minimal writer with the ``TFL3`` identifier.
  - :func:`write_mobilenet_v2_onnx` writes the same weights as an
    ``.onnx`` file by ``torch.onnx.export`` (the TorchScript exporter,
    which needs no ``onnx`` package once its one hook that imports it is
    stubbed) of the float32 :class:`models.mobilenet_v2.MobileNetV2`,
    whose unfused forward is plain torch ops (BatchNorm unfolded).

The zoo module itself (:func:`zoo_module`) takes the same NHWC float
frames, and :func:`zoo_folded_forward` is its BN-folded float32 forward
(the ``fused:xla`` route) over the very weights the ``.tflite`` holds, so
a test holds an imported file's logits against either.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: TFLite tensor types and builtin codes the writer emits
_FLOAT32, _INT32 = 0, 2
_ADD, _CONV_2D, _DEPTHWISE_CONV_2D, _FULLY_CONNECTED, _MEAN = 0, 3, 4, 9, 40
#: builtin-options union codes
_OPT_CONV, _OPT_DW, _OPT_FC, _OPT_ADD, _OPT_REDUCER = 1, 2, 8, 11, 27
_RELU6, _SAME = 3, 0


class Table:
    """A flatbuffer table to write: ``fields`` is a list of (slot, kind,
    value); kind is a struct letter for a scalar, ``"str"``, ``"vec:<letter>"``
    for a vector of scalars, ``"bytes"`` (a uint8 vector aligned to 16),
    ``"table"`` or ``"tables"``."""

    def __init__(self, fields: Sequence[Tuple[int, str, object]]):
        self.fields = [f for f in fields if f[2] is not None]


class FlatBufferWriter:
    """Lays out a table tree front to back: each table's vtable, then the
    table, then its children (strings, vectors, sub-tables), so every
    uoffset points forward as the format requires; scalars, vectors and
    tables are aligned to their sizes (tables to 8)."""

    def __init__(self):
        self.buf = bytearray()

    def _align(self, n: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % n:
            self.buf.append(0)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def finish(self, root: Table, identifier: bytes) -> bytes:
        self.buf = bytearray(8)
        self.buf[4:8] = identifier
        self._patch(0, self.table(root))
        return bytes(self.buf)

    def table(self, t: Table) -> int:
        inline = []  # (slot, size, fmt or None for an offset, value, kind)
        for slot, kind, value in t.fields:
            if len(kind) == 1:
                inline.append((slot, struct.calcsize(kind), kind, value, kind))
            else:
                inline.append((slot, 4, None, value, kind))
        inline.sort(key=lambda f: -f[1])
        offsets, at = {}, 4
        for slot, size, _fmt, _v, _k in inline:
            at += (-at) % size
            offsets[slot] = at
            at += size
        tsize = at + (-at) % 4
        nslots = max(offsets, default=-1) + 1
        self._align(2)
        vt = len(self.buf)
        self.buf += struct.pack(f"<{2 + nslots}H", 4 + 2 * nslots, tsize,
                                *[offsets.get(i, 0) for i in range(nslots)])
        self._align(8)
        pos = len(self.buf)
        self.buf += bytes(tsize)
        struct.pack_into("<i", self.buf, pos, pos - vt)
        children = []
        for slot, _size, fmt, value, kind in inline:
            if fmt is not None:
                struct.pack_into("<" + fmt, self.buf, pos + offsets[slot],
                                 value)
            else:
                children.append((pos + offsets[slot], kind, value))
        for at, kind, value in children:
            self._patch(at, self._child(kind, value))
        return pos

    def _child(self, kind: str, value) -> int:
        if kind == "table":
            return self.table(value)
        if kind == "str":
            raw = value.encode() if isinstance(value, str) else bytes(value)
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(raw)) + raw + b"\0"
            return pos
        if kind == "tables":
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(value)) + bytes(4 * len(value))
            for i, t in enumerate(value):
                self._patch(pos + 4 + 4 * i, self.table(t))
            return pos
        if kind == "bytes":
            raw = np.ascontiguousarray(value, np.uint8).tobytes()
            self._align(16, 4)
        else:  # vec:<letter>
            fmt = kind.split(":", 1)[1]
            raw = struct.pack(f"<{len(value)}{fmt}", *value)
            self._align(max(4, struct.calcsize(fmt)), 4)
        pos = len(self.buf)
        n = len(raw) if kind == "bytes" else len(value)
        self.buf += struct.pack("<I", n) + raw
        return pos


class _Graph:
    """The subgraph being written: tensors, buffers, operators."""

    def __init__(self):
        self.tensors: List[Table] = []
        self.buffers: List[Table] = [Table([])]  # buffer 0: empty
        self.ops: List[Table] = []
        self.codes: List[int] = []

    def tensor(self, shape, name: str, data: Optional[np.ndarray] = None,
               ttype: int = _FLOAT32) -> int:
        buf = 0
        if data is not None:
            buf = len(self.buffers)
            self.buffers.append(Table([(0, "bytes", np.frombuffer(
                np.ascontiguousarray(data).tobytes(), np.uint8))]))
        self.tensors.append(Table([
            (0, "vec:i", [int(d) for d in shape]), (1, "b", ttype),
            (2, "I", buf), (3, "str", name)]))
        return len(self.tensors) - 1

    def op(self, code: int, inputs, outputs, opt_type: int,
           options: Table) -> None:
        if code not in self.codes:
            self.codes.append(code)
        self.ops.append(Table([
            (0, "I", self.codes.index(code)), (1, "vec:i", list(inputs)),
            (2, "vec:i", list(outputs)), (3, "B", opt_type),
            (4, "table", options)]))

    def model(self, inputs, outputs) -> Table:
        sub = Table([(0, "tables", self.tensors), (1, "vec:i", list(inputs)),
                     (2, "vec:i", list(outputs)), (3, "tables", self.ops),
                     (4, "str", "main")])
        codes = [Table([(0, "b", min(c, 127)), (2, "i", 1), (3, "i", c)])
                 for c in self.codes]
        return Table([(0, "I", 3), (1, "tables", codes), (2, "tables", [sub]),
                      (3, "str", "nnstreamer_tpu_torch.testing.model_files"),
                      (4, "tables", self.buffers)])


def zoo_module(custom: Optional[Dict[str, str]] = None):
    """The zoo's MobileNet-v2 (``custom``: ``seed``, ``width``,
    ``classes``, or ``params``) in float32 on the CPU, in eval mode: the
    weights both files are written from. Its forward takes NHWC float
    frames (already normalized) and gives the logits."""
    from nnstreamer_tpu_torch.models import load_or_init
    from nnstreamer_tpu_torch.models.mobilenet_v2 import (
        MobileNetV2,
        init_weights,
    )

    custom = dict(custom or {})
    model = MobileNetV2(num_classes=int(custom.get("classes", 1001)),
                        width_mult=float(custom.get("width", 1.0)),
                        dtype=torch.float32)
    load_or_init(model, custom, init_weights)
    return model.eval()


def zoo_folded_forward(custom: Optional[Dict[str, str]] = None):
    """The zoo MobileNet-v2's BN-folded float32 forward (every block
    through three convolutions, as ``fused:xla``) on the CPU: NHWC float
    frames → logits, over the weights :func:`write_mobilenet_v2_tflite`
    writes."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import _make_fused_apply

    return _make_fused_apply(zoo_module(custom), mode="xla",
                             compute_dtype=torch.float32)


def _fold(conv, bn) -> Tuple[np.ndarray, np.ndarray]:
    """A conv's OIHW kernel and bias with its BatchNorm folded in, as the
    zoo's own folded forward folds them (ops/fused_block.fold_conv_bn):
    the file's weights are bit-equal to those of ``fused:xla``."""
    from nnstreamer_tpu_torch.ops.fused_block import fold_conv_bn

    with torch.no_grad():
        k, b = fold_conv_bn(conv, bn)
    return k.numpy(), b.numpy()


def mobilenet_v2_tflite_bytes(custom: Optional[Dict[str, str]] = None
                              ) -> bytes:
    """The ``.tflite`` flatbuffer of the zoo's MobileNet-v2 (see the
    module docstring) as bytes."""
    custom = dict(custom or {})
    size = int(custom.get("size", 224))
    model = zoo_module(custom)
    g = _Graph()
    hw = size
    x = g.tensor([1, hw, hw, 3], "input")
    inp = x
    n = [0]

    def conv(x_idx, cin_hw, conv_m, bn_m, relu6: bool):
        w, b = _fold(conv_m, bn_m)
        stride = conv_m.stride[0]
        out_hw = -(-cin_hw // stride)
        cout = w.shape[0]
        n[0] += 1
        tag = f"l{n[0]}"
        depthwise = conv_m.groups > 1
        if depthwise:  # OIHW (C,1,kh,kw) → 1HWO
            wt = np.ascontiguousarray(w.transpose(1, 2, 3, 0))
        else:  # OIHW → OHWI
            wt = np.ascontiguousarray(w.transpose(0, 2, 3, 1))
        wi = g.tensor(wt.shape, f"{tag}/w", wt)
        bi = g.tensor(b.shape, f"{tag}/b", b)
        y = g.tensor([1, out_hw, out_hw, cout], f"{tag}/out")
        act = _RELU6 if relu6 else 0
        if depthwise:
            g.op(_DEPTHWISE_CONV_2D, [x_idx, wi, bi], [y], _OPT_DW, Table([
                (0, "b", _SAME), (1, "i", stride), (2, "i", stride),
                (3, "i", 1), (4, "b", act), (5, "i", 1), (6, "i", 1)]))
        else:
            g.op(_CONV_2D, [x_idx, wi, bi], [y], _OPT_CONV, Table([
                (0, "b", _SAME), (1, "i", stride), (2, "i", stride),
                (3, "b", act), (4, "i", 1), (5, "i", 1)]))
        return y, out_hw, cout

    x, hw, ch = conv(x, hw, model.stem_conv, model.stem_bn, True)
    for blk in model.blocks:
        h, hhw = x, hw
        if blk.expand_conv is not None:
            h, hhw, _ = conv(h, hhw, blk.expand_conv, blk.expand_bn, True)
        h, hhw, _ = conv(h, hhw, blk.dw_conv, blk.dw_bn, True)
        h, hhw, cout = conv(h, hhw, blk.proj_conv, blk.proj_bn, False)
        if blk.use_residual:
            n[0] += 1
            y = g.tensor([1, hhw, hhw, cout], f"add{n[0]}")
            g.op(_ADD, [x, h], [y], _OPT_ADD, Table([(0, "b", 0)]))
            h = y
        x, hw, ch = h, hhw, cout
    x, hw, ch = conv(x, hw, model.head_conv, model.head_bn, True)
    axes = g.tensor([2], "pool/axes", np.array([1, 2], np.int32), _INT32)
    pooled = g.tensor([1, ch], "pool")
    g.op(_MEAN, [x, axes], [pooled], _OPT_REDUCER, Table([(0, "?", False)]))
    fc_w = model.classifier.weight.detach().float().numpy()
    fc_b = model.classifier.bias.detach().float().numpy()
    wi = g.tensor(fc_w.shape, "logits/w", np.ascontiguousarray(fc_w))
    bi = g.tensor(fc_b.shape, "logits/b", fc_b)
    out = g.tensor([1, fc_w.shape[0]], "logits")
    g.op(_FULLY_CONNECTED, [pooled, wi, bi], [out], _OPT_FC,
         Table([(0, "b", 0)]))
    return FlatBufferWriter().finish(g.model([inp], [out]), b"TFL3")


def write_mobilenet_v2_tflite(path: str,
                              custom: Optional[Dict[str, str]] = None) -> str:
    """Write :func:`mobilenet_v2_tflite_bytes` to ``path``; returns it."""
    with open(path, "wb") as f:
        f.write(mobilenet_v2_tflite_bytes(custom))
    return path


@contextlib.contextmanager
def _no_onnxscript():
    """The TorchScript exporter imports the ``onnx`` package only inside
    ``_add_onnxscript_fn``, a no-op for graphs without onnxscript
    functions (like these): stub it, as neither package is installed."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, _ops: model_bytes
    try:
        yield
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


@contextlib.contextmanager
def _static_same_pads():
    """The zoo's 'SAME' padding reads each activation's size; under the
    exporter's trace a size is a graph value, and the pads would export
    as Shape/Gather/Neg/Div arithmetic. Within the block the sizes are
    read as Python ints, so each pad exports as one constant ``Pad``."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models import mobilenet_v2

    orig = mobilenet_v2._same_pad_nchw

    def static_pad(x, k, stride, dilation=1):
        k_eff = (k - 1) * dilation + 1
        pads = []
        for size in (int(x.shape[3]), int(x.shape[2])):
            out = -(-size // stride)
            total = max((out - 1) * stride + k_eff - size, 0)
            pads += [total // 2, total - total // 2]
        return F.pad(x, pads) if any(pads) else x

    mobilenet_v2._same_pad_nchw = static_pad
    try:
        yield
    finally:
        mobilenet_v2._same_pad_nchw = orig


def write_mobilenet_v2_onnx(path: str,
                            custom: Optional[Dict[str, str]] = None) -> str:
    """Write the zoo's MobileNet-v2 (float32, NHWC [1, size, size, 3]
    float in, logits out) as ``.onnx`` to ``path``; returns it."""
    import warnings

    custom = dict(custom or {})
    size = int(custom.get("size", 224))
    model = zoo_module(custom)
    x = torch.zeros(1, size, size, 3)
    with torch.no_grad(), _no_onnxscript(), _static_same_pads(), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        torch.onnx.export(model, (x,), path, opset_version=13,
                          input_names=["input"], output_names=["logits"],
                          do_constant_folding=True, dynamo=False)
    return path
