""".tflite → torch importer: run existing TFLite models on the card
(counterpart of the JAX package's ``tools/import_tflite.py``).

The reference's model universe is .tflite files executed by the TFLite
interpreter (tensor_filter_tensorflow_lite.cc:59-122). Here the
flatbuffer is read once (tools/tflite_fb.py: no TensorFlow, no
``flatbuffers`` package) and lowered to a torch program: weights become
tensors on the bundle's device, each op a torch call, and the graph runs
like any zoo model — ``tensor_filter framework=jax model=foo.tflite``.
The plain ``framework=tflite`` backend (filters/tflite_filter.py) remains
the CPU-interpreter route where TensorFlow is installed.

The op set is the JAX importer's (MobileNet-v1/v2 classification, SSD
detection incl. the TFLite_Detection_PostProcess custom op — mapped to
ops/detection.py —, DeepLab segmentation, PoseNet heatmaps); an
unsupported op raises ``NotImplementedError`` naming it and
``framework=tflite``. Op semantics follow the TFLite reference kernels
(lite/kernels/internal/reference/): resize honors align_corners /
half_pixel_centers, transpose-conv is the exact scatter
(``conv_transpose2d`` over the kernel as stored, cropped at the
output_shape operand's window).

Layout: activations stay NHWC, as the graph's shapes, axes and
reshapes say. A convolution reads its NHWC input through an NCHW view
(``permute``, no copy: the channels-last memory format) and hands its
output back the same way. The weights are transposed ONCE, at load:
CONV_2D's OHWI → OIHW, DEPTHWISE_CONV_2D's 1HWO → O1HW, TRANSPOSE_CONV's
OHWI → IOHW, each stored channels-last; a weight computed at run time
(a DEQUANTIZE of fp16 weights) is permuted where the conv reads it.

Precision: ``custom=precision:highest`` (the default) is float32
interpreter parity — TF32 is off for the convs and matmuls of each
invoke on a card (``_import_common.precision_scope``);
``precision:default`` turns TF32 on there.

Quantization, as the JAX importer:
- float32 graphs execute natively; uint8/int8 *weight* tensors with
  per-tensor or per-channel quantization are dequantized at load
  (scale·(q-zero_point)).
- fully integer-quantized graphs execute in **fake-quant float** mode
  by default: weights and int32 biases are dequantized, arithmetic runs
  in float32, and every op output is clamped to the representable range
  of its quantized tensor.
- ``custom=quant:int8`` selects **quantized integer execution**:
  activations stay quantized between ops, convs accumulate the exact
  integer sums, biases add in int32 units, requantization multiplies in
  float32 and rounds half away from zero, fused-activation ranges clamp
  in quantized units. ``carrier:`` names the integer accumulation:
    - ``carrier:f32`` (default): zero-point-shifted integer VALUES in
      float32 convs with TF32 off — exact while partial sums stay below
      2^24, as in the JAX importer;
    - ``carrier:bf16``: accepted for parity with the JAX importer, and
      an alias of ``carrier:f32`` in the port: the same float32 convs,
      identical outputs. The JAX importer feeds bf16 operands (lossless
      for int8-range values) to an f32-accumulating conv; torch's bf16
      conv rounds its OUTPUT to bf16, so the port keeps the operands'
      exact values in float32, which gives the JAX importer's sums;
    - ``carrier:int``: exact integer sums carried in float64 convs
      (exact below 2^53; torch has no integer conv on a card), bit-equal
      to the JAX importer's int32 accumulation.
  The one deliberate divergence from the interpreter is the JAX
  importer's: the requant multiply runs in float32 instead of the
  fixed-point doubling-high multiply, so an output can differ by ~1 LSB
  near rounding boundaries. Ops without an integer implementation fall
  back per op: dequantize inputs → float kernel → requantize outputs.

Outputs of both quantized modes are emitted dequantized (float32).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.tools import tflite_fb
from nnstreamer_tpu_torch.tools._import_common import as_device_tensor
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

log = get_logger("tools.import_tflite")

B = tflite_fb.BuiltinOperator

_TFLITE_DTYPES = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64, 17: np.uint32,
}

_QRANGE = {
    np.dtype(np.uint8): (0, 255),
    np.dtype(np.int8): (-128, 127),
    np.dtype(np.int16): (-32768, 32767),
}

_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
}

#: weight layouts fixed at load, per op: the permutation of the stored
#: weight (input 1) that gives torch's layout
_CONV_PERM = {B.CONV_2D: (0, 3, 1, 2),           # OHWI → OIHW
              B.DEPTHWISE_CONV_2D: (3, 0, 1, 2),  # 1HWO → O1HW
              B.TRANSPOSE_CONV: (3, 0, 1, 2)}     # OHWI → IOHW


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device: tensor-tensor float32
    arithmetic (a Python scalar may take a reciprocal fast path)."""
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _is_int(x) -> bool:
    dt = x.dtype
    if isinstance(dt, torch.dtype):
        return not dt.is_floating_point and dt != torch.bool
    return np.issubdtype(dt, np.integer)


class _Tensor:
    __slots__ = ("index", "shape", "dtype", "data", "quant",
                 "qscale", "qzero", "qdim")

    def __init__(self, index, shape, dtype, data, qscale, qzero, qdim):
        self.index = index
        self.shape = shape
        self.dtype = dtype
        self.data = data  # np array for weight tensors, None for activations
        # per-tensor (scale, zero_point) or None; per-channel keeps arrays
        self.quant = ((float(qscale[0]), int(qzero[0]))
                      if qscale is not None and len(qscale) == 1 else None)
        self.qscale = qscale  # np float32 array or None
        self.qzero = qzero  # np int64 array (same length) or None
        self.qdim = qdim  # quantized dimension for per-channel

    def dequantize(self, d):
        """scale·(q - zero_point), per-tensor or per-channel (qdim), on a
        numpy array or a tensor."""
        scale, zp = self.qscale, self.qzero
        if len(scale) > 1:
            bshape = [1] * d.ndim
            bshape[self.qdim] = len(scale)
            scale = scale.reshape(bshape)
            zp = zp.reshape(bshape)
        if isinstance(d, torch.Tensor):
            return ((d.to(torch.float32) - as_device_tensor(
                zp.astype(np.float32), d.device))
                * as_device_tensor(scale, d.device))
        return (d.astype(np.float32) - zp.astype(np.float32)) * scale

    def qrange(self):
        """Representable float range of this quantized tensor, or None."""
        if self.quant is None or np.dtype(self.dtype) not in _QRANGE:
            return None
        scale, zp = self.quant
        qmin, qmax = _QRANGE[np.dtype(self.dtype)]
        return (scale * (qmin - zp), scale * (qmax - zp))


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    """TFLite integer-kernel rounding (half away from zero);
    torch.round would round half to even."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def _quantize_arr(x: torch.Tensor, scale: float, zp: int, dtype):
    """float → quantized integer tensor per (scale, zero_point)."""
    qmin, qmax = _QRANGE[np.dtype(dtype)]
    q = _round_half_away(x.to(torch.float32) / _f32(scale, x)) + zp
    return torch.clamp(q, qmin, qmax).to(_TORCH_DTYPES[np.dtype(dtype)])


def _act(code: int) -> Callable:
    """Fused activation from ActivationFunctionType."""
    if code == 0:
        return lambda x: x
    if code == 1:
        return lambda x: torch.clamp(x, min=0)
    if code == 2:
        return lambda x: torch.clamp(x, -1, 1)  # RELU_N1_TO_1
    if code == 3:
        return lambda x: torch.clamp(x, 0, 6)
    if code == 4:
        return torch.tanh
    raise NotImplementedError(f"fused activation {code}")


def _same_pads(in_sz: int, k: int, stride: int, dilation: int = 1):
    """TF 'SAME' (before, after) padding of one spatial axis (the extra
    one after, as XLA pads)."""
    k_eff = (k - 1) * dilation + 1
    out = -(-in_sz // stride)
    total = max((out - 1) * stride + k_eff - in_sz, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, padding: int, kh: int, kw: int, sh: int,
              sw: int, dh: int = 1, dw: int = 1, value: float = 0.0):
    """An NCHW view padded for TFLite ``padding`` (0 SAME, else VALID)."""
    if padding != 0:
        return x
    ph = _same_pads(x.shape[2], kh, sh, dh)
    pw = _same_pads(x.shape[3], kw, sw, dw)
    if not any(ph + pw):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _resize(img: torch.Tensor, out_h: int, out_w: int, bilinear: bool,
            align_corners: bool, half_pixel: bool) -> torch.Tensor:
    """TFLite-exact resize (reference/resize_bilinear.h,
    resize_nearest_neighbor.h) of an NHWC tensor: the coordinate mapping
    is explicit, as the JAX importer's."""
    _, in_h, in_w, _ = img.shape
    dev = img.device

    def scale(in_sz, out_sz):
        if align_corners and out_sz > 1:
            return (in_sz - 1) / float(out_sz - 1)
        return in_sz / float(out_sz)

    if bilinear:
        def lerp_axis(arr, in_sz, out_sz, axis):
            o = torch.arange(out_sz, dtype=torch.float32, device=dev)
            sc = _f32(scale(in_sz, out_sz), o)
            src = ((o + 0.5) * sc - 0.5 if half_pixel else o * sc)
            lo = torch.clamp(torch.floor(src).to(torch.int64), min=0)
            hi = torch.clamp(torch.ceil(src).to(torch.int64), max=in_sz - 1)
            w = (src - lo).reshape([-1 if d == axis else 1
                                    for d in range(arr.ndim)])
            a = torch.index_select(arr, axis, lo)
            b = torch.index_select(arr, axis, hi)
            return a * (1 - w) + b * w

        y = lerp_axis(img.to(torch.float32), in_h, out_h, axis=1)
        return lerp_axis(y, in_w, out_w, axis=2)

    def nearest_idx(in_sz, out_sz):
        o = torch.arange(out_sz, dtype=torch.float32, device=dev)
        off = 0.5 if half_pixel else 0.0
        v = (o + off) * _f32(scale(in_sz, out_sz), o)
        # TfLiteRound = half away from zero; inputs are >= -0.5 here so
        # floor(v + 0.5) matches
        idx = torch.floor(v + 0.5) if align_corners else torch.floor(v)
        return torch.clamp(idx.to(torch.int64), 0, in_sz - 1)

    y = torch.index_select(img, 1, nearest_idx(in_h, out_h))
    return torch.index_select(y, 2, nearest_idx(in_w, out_w))


def _window_sum(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int,
                padding: int) -> torch.Tensor:
    """Sum over each pooling window of an NCHW tensor, zero-padded for
    SAME (lax.reduce_window's add)."""
    x = _pad_nchw(x, padding, kh, kw, sh, sw)
    return F.avg_pool2d(x, (kh, kw), (sh, sw), divisor_override=1)


class TFLiteGraph:
    """Parsed subgraph 0 of a .tflite flatbuffer, executable as torch.

    ``precision`` controls the conv/matmul accumulation on a card: the
    default ``"highest"`` matches the TFLite reference kernels' float32
    math (TF32 off); ``precision="default"`` (pipeline:
    ``custom=precision:default``) lets cuDNN and cuBLAS use TF32."""

    def __init__(self, path: str, precision: Optional[str] = "highest",
                 qmode: str = "float", qcarrier: str = "f32"):
        if qmode not in ("float", "int8"):
            raise ValueError(f"qmode must be 'float' or 'int8', got {qmode!r}")
        if qcarrier not in ("f32", "bf16", "int"):
            raise ValueError(
                f"carrier must be 'f32', 'bf16' or 'int', got {qcarrier!r}")
        self.qcarrier = qcarrier
        self.precision = None if precision in (None, "default") else precision
        with open(path, "rb") as f:
            model = tflite_fb.read_model(f.read())
        if not model.subgraphs:
            raise ValueError(f"{path}: no subgraphs")
        self.opcodes = []
        for oc in model.operatorCodes or []:
            code = max(oc.builtinCode, oc.deprecatedBuiltinCode)
            name = oc.customCode.decode() if oc.customCode else None
            self.opcodes.append((code, name))
        g = model.subgraphs[0]
        self.inputs = [int(i) for i in g.inputs]
        self.outputs = [int(i) for i in g.outputs]
        self.operators = g.operators or []
        self.tensors: List[_Tensor] = []
        for i, t in enumerate(g.tensors):
            dtype = _TFLITE_DTYPES.get(t.type)
            if dtype is None:
                raise NotImplementedError(f"tflite dtype code {t.type}")
            shape = [int(d) for d in (t.shape if t.shape is not None else [])]
            data = None
            raw = model.buffers[t.buffer].data
            if raw is not None and len(raw):
                data = np.frombuffer(raw.tobytes(), dtype=dtype).reshape(shape)
            qscale = qzero = None
            qdim = 0
            q = t.quantization
            if q is not None and q.scale is not None and len(q.scale):
                qscale = np.asarray(q.scale, np.float32)
                qzero = (np.asarray(q.zeroPoint, np.int64)
                         if q.zeroPoint is not None and len(q.zeroPoint)
                         else np.zeros(len(qscale), np.int64))
                if len(qzero) != len(qscale):
                    qzero = np.full(len(qscale), qzero[0] if len(qzero) else 0,
                                    np.int64)
                qdim = int(q.quantizedDimension or 0)
            self.tensors.append(_Tensor(i, shape, dtype, data,
                                        qscale, qzero, qdim))
        # a fully integer-quantized graph has quantized integer
        # activations (not just weights): it runs in fake-quant float mode
        # (see the module docstring)
        self.fake_quant = any(
            t.data is None
            and t.quant is not None
            and np.dtype(t.dtype) in _QRANGE
            and t.index not in self.inputs
            for t in self.tensors
        )
        # int8 mode only applies to fully integer-quantized graphs; float
        # graphs execute natively either way
        self.qmode = qmode if self.fake_quant else "float"
        if self.fake_quant:
            log.info("%s: fully integer-quantized graph — %s", path,
                     "integer execution (custom=quant:int8)"
                     if self.qmode == "int8" else "fake-quant float mode")
        self.has_postprocess = any(
            self.opcodes[op.opcodeIndex] == (B.CUSTOM,
                                             "TFLite_Detection_PostProcess")
            for op in self.operators)
        self.prepared = self._weight_layouts()

    def _weight_layouts(self) -> Dict[int, tuple]:
        """Weight tensors transposed at load: {tensor index: permutation}
        for each stored weight every reader of which is the weight slot
        of ops wanting the same layout."""
        uses: Dict[int, set] = {}
        for op in self.operators:
            code = self.opcodes[op.opcodeIndex][0]
            for pos, i in enumerate(op.inputs):
                i = int(i)
                if i < 0 or self.tensors[i].data is None:
                    continue
                perm = _CONV_PERM.get(code) if pos == 1 else None
                uses.setdefault(i, set()).add(perm)
        return {i: next(iter(p)) for i, p in uses.items()
                if len(p) == 1 and None not in p}

    # -- weights ------------------------------------------------------------
    def params(self) -> Dict[str, np.ndarray]:
        """The graph's stored tensors by index, as the JAX importer's
        ``params()`` gives them (dequantized per mode), with each
        convolution weight already in torch's layout."""
        out = {}
        for t in self.tensors:
            if t.data is None:
                continue
            d = t.data
            if self.qmode == "int8":
                pass  # integer execution consumes raw quantized values
            elif t.qscale is not None and t.dtype in (np.uint8, np.int8):
                d = t.dequantize(d)
            elif (self.fake_quant and t.qscale is not None
                  and t.dtype == np.int32):
                # quantized biases: scale = in_scale·w_scale, zp = 0
                d = t.dequantize(d)
            perm = self.prepared.get(t.index)
            if perm is not None:
                d = np.ascontiguousarray(np.transpose(d, perm))
            out[str(t.index)] = d
        return out

    def channels_last(self) -> List[str]:
        """The params keys stored channels-last (the conv weights)."""
        return [str(i) for i in self.prepared]

    def _weight(self, op, pos: int, x, code: int) -> torch.Tensor:
        """Op input ``pos`` as a weight in torch's layout: transposed at
        load, or permuted here when it was computed at run time."""
        if int(op.inputs[pos]) in self.prepared:
            return x[pos]
        return x[pos].permute(*_CONV_PERM[code])

    # -- execution ----------------------------------------------------------
    def apply(self, params: Dict[str, Any], *inputs):
        vals: Dict[int, Any] = {}
        for t in self.tensors:
            if t.data is not None:
                vals[t.index] = params[str(t.index)]
        if len(inputs) != len(self.inputs):
            raise ValueError(
                f"model wants {len(self.inputs)} inputs, got {len(inputs)}"
            )
        for idx, x in zip(self.inputs, inputs):
            t = self.tensors[idx]
            if hasattr(x, "ndim") and x.ndim == len(t.shape) - 1:
                # the caps grammar trims the outermost batch-1 dim
                # (types.np_shape); restore the graph's exact rank
                x = x[None]
            if t.quant is not None and np.dtype(t.dtype) in _QRANGE:
                if self.qmode == "int8":
                    if not _is_int(x):
                        # float input: quantize onto the graph's input grid
                        x = _quantize_arr(x, t.quant[0], t.quant[1], t.dtype)
                elif _is_int(x):
                    x = t.dequantize(x)
            vals[idx] = x
        for op in self.operators:
            code, custom = self.opcodes[op.opcodeIndex]
            if self.qmode == "int8":
                outs = self._run_op_int8(code, custom, op, vals)
                if outs is NotImplemented:
                    outs = self._run_op_int8_fallback(code, custom, op, vals)
            else:
                outs = self._run_op(code, custom, op, vals)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for i, o in zip(op.outputs, outs):
                i = int(i)
                if self.fake_quant and self.qmode != "int8":
                    rng = self.tensors[i].qrange()
                    if rng is not None:
                        o = torch.clamp(o, rng[0], rng[1])
                vals[i] = o
        res = []
        for i in self.outputs:
            o = vals[i]
            t = self.tensors[i]
            if (self.qmode == "int8" and t.quant is not None
                    and np.dtype(t.dtype) in _QRANGE and _is_int(o)):
                o = t.dequantize(o)  # same float surface as fake-quant mode
            res.append(o)
        return res[0] if len(res) == 1 else tuple(res)

    # -- integer execution (custom=quant:int8) ------------------------------
    def _act_qrange(self, act_code: int, t_out):
        """Fused-activation clamp range in QUANTIZED units
        (CalculateActivationRangeQuantized, lite/kernels/kernel_util.cc);
        None when the activation has no quantized clamp form."""
        scale, zp = t_out.quant
        qmin, qmax = _QRANGE[np.dtype(t_out.dtype)]

        def qz(v):
            return zp + int(round(v / scale))

        if act_code == 0:
            return qmin, qmax
        if act_code == 1:  # RELU
            return max(qmin, qz(0.0)), qmax
        if act_code == 2:  # RELU_N1_TO_1
            return max(qmin, qz(-1.0)), min(qmax, qz(1.0))
        if act_code == 3:  # RELU6
            return max(qmin, qz(0.0)), min(qmax, qz(6.0))
        return None

    def _carrier(self) -> torch.dtype:
        """The float type the integer sums are carried in (see the module
        docstring): float64 for ``carrier:int``, else float32."""
        return torch.float64 if self.qcarrier == "int" else torch.float32

    def _run_op_int8(self, code, custom, op, vals):
        """Integer implementation of one op, or NotImplemented to route
        through the dequantize→float→requantize fallback. Values in
        ``vals`` are quantized tensors in their tensors' storage dtypes."""
        opts = op.builtinOptions
        t_out = self.tensors[int(op.outputs[0])]
        out_dt = _TORCH_DTYPES.get(np.dtype(t_out.dtype))

        if code in (B.RESHAPE, B.SQUEEZE):
            # layout-only: dtype-preserving, quant params unchanged
            return self._run_op(code, custom, op, vals)

        if code in (B.CONV_2D, B.DEPTHWISE_CONV_2D):
            t_x = self.tensors[int(op.inputs[0])]
            t_w = self.tensors[int(op.inputs[1])]
            if (t_x.quant is None or t_w.qscale is None or t_out.quant is None
                    or np.dtype(t_x.dtype) not in _QRANGE
                    or np.dtype(t_w.dtype) not in _QRANGE):
                return NotImplemented
            arange = self._act_qrange(opts.fusedActivationFunction, t_out)
            if arange is None:
                return NotImplemented
            x_s, x_zp = t_x.quant
            o_s, o_zp = t_out.quant
            ctype = self._carrier()
            a = vals[int(op.inputs[0])]
            xs = a.to(ctype) - torch.tensor(float(x_zp), dtype=ctype,
                                            device=a.device)
            w = self._weight(op, 1, [None, vals[int(op.inputs[1])]], code)
            wz = t_w.qzero
            if len(wz) > 1:  # per-channel: the output channel, axis 0 here
                wzb = torch.as_tensor(wz.reshape(-1, 1, 1, 1), dtype=ctype,
                                      device=a.device)
            else:
                wzb = torch.tensor(float(wz[0]), dtype=ctype,
                                   device=a.device)
            ws = w.to(ctype) - wzb
            kh, kw = int(ws.shape[2]), int(ws.shape[3])
            dh, dw = opts.dilationHFactor or 1, opts.dilationWFactor or 1
            xin = _pad_nchw(_nchw(xs), opts.padding, kh, kw, opts.strideH,
                            opts.strideW, dh, dw)
            acc = F.conv2d(xin, ws, stride=(opts.strideH, opts.strideW),
                           dilation=(dh, dw),
                           groups=(xs.shape[-1] if code ==
                                   B.DEPTHWISE_CONV_2D else 1))
            acc = _nhwc(acc)
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                acc = acc + vals[int(op.inputs[2])].to(ctype)
            # output multiplier in f64, applied in f32 (the documented
            # 1-LSB divergence from the fixed-point doubling-high multiply)
            mult = np.asarray(t_w.qscale, np.float64) * x_s / o_s
            multb = torch.as_tensor(mult.astype(np.float32), device=a.device)
            amin, amax = arange
            q = _round_half_away(acc.to(torch.float32) * multb) + o_zp
            return torch.clamp(q, amin, amax).to(out_dt)

        if code == B.FULLY_CONNECTED:
            t_x = self.tensors[int(op.inputs[0])]
            t_w = self.tensors[int(op.inputs[1])]
            if (t_x.quant is None or t_w.quant is None or t_out.quant is None
                    or np.dtype(t_x.dtype) not in _QRANGE
                    or np.dtype(t_w.dtype) not in _QRANGE):
                return NotImplemented
            arange = self._act_qrange(opts.fusedActivationFunction, t_out)
            if arange is None:
                return NotImplemented
            x_s, x_zp = t_x.quant
            w_s, w_zp = t_w.quant
            o_s, o_zp = t_out.quant
            a = vals[int(op.inputs[0])]
            a = a.reshape(a.shape[0] if a.ndim > 1 else 1, -1)
            ctype = self._carrier()
            xs = a.to(ctype) - float(x_zp)
            ws = vals[int(op.inputs[1])].to(ctype) - float(w_zp)
            acc = xs @ ws.t()
            if len(op.inputs) > 2 and op.inputs[2] >= 0:
                acc = acc + vals[int(op.inputs[2])].to(ctype)
            amin, amax = arange
            q = _round_half_away(acc.to(torch.float32) * _f32(
                np.float32(x_s * w_s / o_s), a)) + o_zp
            return torch.clamp(q, amin, amax).to(out_dt)

        if code == B.ADD:
            t1 = self.tensors[int(op.inputs[0])]
            t2 = self.tensors[int(op.inputs[1])]
            if (t1.quant is None or t2.quant is None or t_out.quant is None
                    or np.dtype(t1.dtype) not in _QRANGE
                    or np.dtype(t2.dtype) not in _QRANGE):
                return NotImplemented
            arange = self._act_qrange(
                opts.fusedActivationFunction if opts else 0, t_out)
            if arange is None:
                return NotImplemented
            s1, z1 = t1.quant
            s2, z2 = t2.quant
            so, zo = t_out.quant
            a = vals[int(op.inputs[0])]
            x1 = a.to(torch.float32) - _f32(z1, a)
            x2 = vals[int(op.inputs[1])].to(torch.float32) - _f32(z2, a)
            f = x1 * _f32(s1, a) + x2 * _f32(s2, a)
            amin, amax = arange
            q = _round_half_away(f * _f32(np.float32(1.0 / so), a)) + zo
            return torch.clamp(q, amin, amax).to(out_dt)

        if code == B.AVERAGE_POOL_2D:
            t_x = self.tensors[int(op.inputs[0])]
            if (t_x.quant is None or t_out.quant is None
                    or np.dtype(t_x.dtype) not in _QRANGE):
                return NotImplemented
            if opts.padding == 0:
                # SAME needs per-position divisor counts; the float
                # fallback already computes those
                return NotImplemented
            arange = self._act_qrange(opts.fusedActivationFunction, t_out)
            if arange is None:
                return NotImplemented
            x = vals[int(op.inputs[0])]
            acc = _nhwc(_window_sum(
                _nchw(x.to(torch.float64)), opts.filterHeight,
                opts.filterWidth, opts.strideH, opts.strideW, 1)
            ).to(torch.int64)
            count = int(opts.filterHeight) * int(opts.filterWidth)
            # reference_integer_ops::AveragePool divisor rounding: add
            # half the count away from zero, then truncate toward zero
            q = torch.where(acc >= 0,
                            torch.div(acc + count // 2, count,
                                      rounding_mode="floor"),
                            -torch.div(-acc + count // 2, count,
                                       rounding_mode="floor"))
            amin, amax = arange
            return torch.clamp(q, amin, amax).to(out_dt)

        return NotImplemented

    def _run_op_int8_fallback(self, code, custom, op, vals):
        """Per-op float fallback for int8 mode: dequantize quantized
        integer inputs, run the float kernel, requantize quantized
        outputs. Keeps unsupported-op coverage identical to float mode
        while the hot convs stay integer."""
        shim = dict(vals)
        for i in op.inputs:
            i = int(i)
            if i < 0 or i not in shim:
                continue
            t = self.tensors[i]
            v = shim[i]
            # dequantize quantized activations/weights AND int32 biases —
            # int8-mode params() keeps biases in raw accumulator units
            if (t.qscale is not None
                    and (np.dtype(t.dtype) in _QRANGE
                         or np.dtype(t.dtype) == np.int32)
                    and _is_int(v)):
                if i in self.prepared:  # back to the stored layout
                    v = v.permute(*np.argsort(self.prepared[i]).tolist())
                    shim[i] = t.dequantize(v).permute(*self.prepared[i])
                else:
                    shim[i] = t.dequantize(v)
        outs = self._run_op(code, custom, op, shim)
        outs_l = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        res = []
        for i, o in zip(op.outputs, outs_l):
            t = self.tensors[int(i)]
            if t.quant is not None and np.dtype(t.dtype) in _QRANGE:
                o = _quantize_arr(o, t.quant[0], t.quant[1], t.dtype)
            res.append(o)
        return res if isinstance(outs, (list, tuple)) else res[0]

    def _run_op(self, code: int, custom: Optional[str], op, vals):
        x = [vals[int(i)] if i >= 0 else None for i in op.inputs]
        opts = op.builtinOptions

        def static(pos: int) -> np.ndarray:
            """Shape/axis operands must be constants of the graph: read
            the flatbuffer data, never the runtime value."""
            t = self.tensors[int(op.inputs[pos])]
            if t.data is None:
                raise NotImplementedError(
                    "dynamic shape/axis operand (tensor %d) — the "
                    "importer needs static shapes" % t.index
                )
            return t.data

        if code in (B.CONV_2D, B.DEPTHWISE_CONV_2D):
            act = _act(opts.fusedActivationFunction)
            a = x[0].to(torch.float32)
            w = self._weight(op, 1, x, code).to(torch.float32)
            kh, kw = int(w.shape[2]), int(w.shape[3])
            dh, dw = opts.dilationHFactor or 1, opts.dilationWFactor or 1
            xin = _pad_nchw(_nchw(a), opts.padding, kh, kw, opts.strideH,
                            opts.strideW, dh, dw)
            y = _nhwc(F.conv2d(
                xin, w, stride=(opts.strideH, opts.strideW),
                dilation=(dh, dw),
                groups=a.shape[-1] if code == B.DEPTHWISE_CONV_2D else 1))
            if x[2] is not None:
                y = y + x[2]
            return act(y)
        if code == B.TRANSPOSE_CONV:
            # TFLite semantics (reference_ops TransposeConv): each input
            # pixel i scatters the kernel at out = i·s + f − pad_before,
            # pad_before = max(0, (I−1)·s + k − O) // 2 for SAME, 0 for
            # VALID, with O from the output_shape operand: the full
            # scatter (conv_transpose2d, no padding) cropped to
            # [pad_before, pad_before + O), zero beyond its extent
            out_shape = [int(v) for v in static(0).reshape(-1)]
            w = self._weight(op, 1, x, code).to(torch.float32)  # IOHW
            a = x[2].to(torch.float32)
            kh, kw = int(w.shape[2]), int(w.shape[3])
            sh, sw = int(opts.strideH), int(opts.strideW)
            same = opts.padding == 0
            full = F.conv_transpose2d(_nchw(a), w, stride=(sh, sw))

            def window(in_sz, out_sz, k, stride, axis):
                nonlocal full
                before = (max(0, (in_sz - 1) * stride + k - out_sz) // 2
                          if same else 0)
                extra = before + out_sz - full.shape[axis]
                if extra > 0:
                    pad = [0, 0, 0, 0]
                    pad[(3 - axis) * 2 + 1] = extra
                    full = F.pad(full, pad)
                full = full.narrow(axis, before, out_sz)

            window(a.shape[1], out_shape[1], kh, sh, 2)
            window(a.shape[2], out_shape[2], kw, sw, 3)
            y = _nhwc(full)
            if len(x) > 3 and x[3] is not None:
                y = y + x[3]
            return y
        if code == B.FULLY_CONNECTED:
            act = _act(opts.fusedActivationFunction)
            a = x[0].reshape(x[0].shape[0] if x[0].ndim > 1 else 1, -1)
            y = a.to(torch.float32) @ x[1].to(torch.float32).t()
            if x[2] is not None:
                y = y + x[2]
            return act(y)
        if code == B.AVERAGE_POOL_2D:
            act = _act(opts.fusedActivationFunction)
            a = _nchw(x[0].to(torch.float32))
            k = (opts.filterHeight, opts.filterWidth, opts.strideH,
                 opts.strideW, opts.padding)
            y = _window_sum(a, *k)
            ones = _window_sum(torch.ones((1, 1) + tuple(a.shape[2:]),
                                          dtype=torch.float32,
                                          device=a.device), *k)
            return act(_nhwc(y / ones))
        if code == B.MAX_POOL_2D:
            act = _act(opts.fusedActivationFunction)
            kh, kw = opts.filterHeight, opts.filterWidth
            a = _pad_nchw(_nchw(x[0]), opts.padding, kh, kw, opts.strideH,
                          opts.strideW, value=-float("inf"))
            return act(_nhwc(F.max_pool2d(a, (kh, kw),
                                          (opts.strideH, opts.strideW))))
        if code in (B.ADD, B.SUB, B.MUL, B.DIV):
            act = _act(opts.fusedActivationFunction if opts else 0)
            f = {B.ADD: torch.add, B.SUB: torch.sub,
                 B.MUL: torch.mul, B.DIV: torch.div}[code]
            return act(f(*_operands(x[0], x[1])))
        if code == B.RELU:
            return torch.clamp(x[0], min=0)
        if code == B.RELU6:
            return torch.clamp(x[0], 0, 6)
        if code == B.LOGISTIC:
            return torch.sigmoid(x[0])
        if code == B.TANH:
            return torch.tanh(x[0])
        if code == B.HARD_SWISH:
            return x[0] * torch.clamp(x[0] + 3, 0, 6) / 6
        if code == B.SOFTMAX:
            beta = float(opts.beta) if opts is not None and opts.beta else 1.0
            return torch.softmax(x[0] * beta, dim=-1)
        if code == B.RESHAPE:
            shape = (list(opts.newShape) if opts is not None
                     and opts.newShape is not None
                     else list(static(1).reshape(-1)))
            return x[0].reshape([int(s) for s in shape])
        if code == B.SQUEEZE:
            dims = sorted((int(d) for d in opts.squeezeDims), reverse=True)
            y = x[0]
            for d in dims:
                y = torch.squeeze(y, dim=d)
            return y
        if code == B.CONCATENATION:
            act = _act(opts.fusedActivationFunction)
            return act(torch.cat([v for v in x if v is not None],
                                 dim=opts.axis))
        if code == B.PAD:
            padding = static(1).tolist()
            flat = [int(v) for pair in reversed(padding) for v in pair]
            return F.pad(x[0], flat)
        if code == B.MEAN:
            axes = tuple(int(a) for a in static(1).reshape(-1))
            return torch.mean(x[0], dim=axes,
                              keepdim=bool(opts.keepDims) if opts else False)
        if code == B.ARG_MAX:
            # the output tensor's declared type (int64 or int32)
            axis = int(static(1).reshape(-1)[0])
            t_out = self.tensors[int(op.outputs[0])]
            return torch.argmax(x[0], dim=axis).to(
                _TORCH_DTYPES.get(np.dtype(t_out.dtype), torch.int64))
        if code in (B.RESIZE_BILINEAR, B.RESIZE_NEAREST_NEIGHBOR):
            h, w = (int(v) for v in static(1).reshape(-1))
            align = bool(opts.alignCorners) if opts is not None else False
            half = bool(opts.halfPixelCenters) if opts is not None else False
            return _resize(x[0], h, w,
                           bilinear=code == B.RESIZE_BILINEAR,
                           align_corners=align, half_pixel=half)
        if code == B.DEQUANTIZE:
            t = self.tensors[int(op.inputs[0])]
            if t.qscale is not None and _is_int(x[0]):
                return t.dequantize(x[0])
            # fp16-weights models / fake-quant mode: value is already float
            return x[0].to(torch.float32)
        if code == B.QUANTIZE:
            return x[0]  # float path: keep values, drop the cast
        if code == B.CUSTOM and custom == "TFLite_Detection_PostProcess":
            return self._detection_postprocess(op, x)
        name = custom
        if code != B.CUSTOM:
            name = (tflite_fb.BUILTIN_OPERATORS[code]
                    if 0 <= code < len(tflite_fb.BUILTIN_OPERATORS) else code)
        raise NotImplementedError(
            f"tflite op {name} is not supported by the importer; "
            "run this model with framework=tflite instead"
        )

    def _detection_postprocess(self, op, x):
        """TFLite_Detection_PostProcess custom op → ops/detection.py (the
        on-device top-k + NMS the pp models use). Anchors ride in input
        2. Class indices are emitted background-excluded, the TFLite op
        convention the reference's mobilenetssdpp.cc decoder consumes."""
        from nnstreamer_tpu_torch.ops.detection import (
            detection_postprocess,
            ssd_decode_boxes,
        )

        cfg = {}
        if op.customOptions is not None and len(op.customOptions):
            try:
                cfg = tflite_fb.flexbuffer_value(op.customOptions)
            except Exception as e:  # noqa: BLE001
                log.warning("TFLite_Detection_PostProcess: unparsable "
                            "customOptions (%s) — using op defaults", e)
        if cfg.get("use_regular_nms"):
            log.warning(
                "TFLite_Detection_PostProcess: use_regular_nms=true is "
                "approximated with class-agnostic fast NMS — overlapping "
                "boxes of different classes may suppress each other"
            )
        k = int(cfg.get("max_detections", 10))
        iou = float(cfg.get("nms_iou_threshold", 0.5))
        thr = float(cfg.get("nms_score_threshold", 0.5))
        scales = (float(cfg.get("y_scale", 10.0)),
                  float(cfg.get("x_scale", 10.0)),
                  float(cfg.get("h_scale", 5.0)),
                  float(cfg.get("w_scale", 5.0)))
        enc, scores_all, anchors = (torch.as_tensor(v) for v in x[:3])
        # anchors (N,4) ycenter,xcenter,h,w → (4,N) for ssd_decode_boxes
        xyxy = ssd_decode_boxes(enc, anchors.to(enc.device).t(), *scales)
        cls_scores = scores_all[..., 1:]  # class 0 = background
        score, best = torch.max(cls_scores, dim=-1)
        locs, cls, scr, num = detection_postprocess(
            xyxy, score, best, k=k, iou_thr=iou, score_thr=thr
        )
        # tflite op output order: boxes, classes, scores, num
        return [locs, cls, scr, num]

    # -- metadata -----------------------------------------------------------
    def io_info(self):
        def info(idxs, dequantized=False):
            tensors = []
            for i in idxs:
                t = self.tensors[i]
                dtype = t.dtype
                if (dequantized and t.quant is not None
                        and np.dtype(t.dtype) in _QRANGE):
                    # fake-quant mode emits this output dequantized;
                    # genuinely-integer outputs (e.g. an ARG_MAX head,
                    # no quant params) keep their dtype
                    dtype = np.float32
                tensors.append(TensorInfo.from_np_shape(t.shape, dtype))
            return TensorsInfo(tensors=tensors)

        return (info(self.inputs),
                info(self.outputs, dequantized=self.fake_quant))


def _operands(a, b):
    """Two operands of an elementwise op as tensors on one device (a
    stored constant arrives as a tensor already; a numpy value is made
    one)."""
    dev = a.device if isinstance(a, torch.Tensor) else b.device
    if not isinstance(a, torch.Tensor):
        a = as_device_tensor(a, dev)
    if not isinstance(b, torch.Tensor):
        b = as_device_tensor(b, dev)
    return a, b


def load_tflite(path: str, custom: Optional[Dict[str, str]] = None,
                device="cuda"):
    """Parse a .tflite file into a :class:`models.ModelBundle` on
    ``device`` (``framework=jax model=foo.tflite``).

    ``custom=precision:default`` lets the card use TF32; the default is
    "highest" = float32 interpreter parity. ``custom=quant:int8`` runs
    fully integer-quantized graphs with integer arithmetic (see the
    module docstring); ``preproc:norm:<add>:<div>`` normalizes raw uint8
    frames on the device (the ``arith_chain`` kernel).

    Micro-batching: .tflite graphs are typically frozen at batch 1; when
    every graph input has a leading dim of 1 and the caller supplies a
    bigger leading dim, the whole graph runs under ``torch.func.vmap``,
    so ``tensor_converter frames-per-tensor=N`` works on imported models
    exactly like on zoo models (``batch:native`` feeds the batch straight
    through instead)."""
    from nnstreamer_tpu_torch.tools._import_common import (
        graph_bundle,
        make_batch1_apply,
    )

    custom = custom or {}
    g = TFLiteGraph(path, precision=custom.get("precision", "highest"),
                    qmode=custom.get("quant", "float"),
                    qcarrier=custom.get("carrier", "f32"))
    graph_ranks = [len(g.tensors[i].shape) for i in g.inputs]
    batch1 = bool(g.inputs) and all(
        g.tensors[i].shape and g.tensors[i].shape[0] == 1 for i in g.inputs
    )
    native = custom.get("batch") == "native"
    apply_fn = make_batch1_apply(g.apply, graph_ranks, batch1, native=native)
    log.info("imported %s: %d ops, %d weight tensors", path,
             len(g.operators), sum(t.data is not None for t in g.tensors))
    return graph_bundle(g, apply_fn, custom, device)


def main(argv=None) -> int:
    """CLI: load a .tflite and validate it against the TFLite interpreter
    (where TensorFlow is installed; it is imported for ``--check`` only).
    The graph runs on the card, as the filter's does; ``--device cpu``
    asks for the CPU (a ``--check`` on a machine without a card).

    usage: python -m nnstreamer_tpu_torch.tools.import_tflite model.tflite
               [--check] [--device cpu|cuda]
    """
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("--check", action="store_true",
                    help="compare against the TFLite interpreter")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        ap.error("torch sees no CUDA device; pass --device cpu to run on "
                 "the CPU")
    device = torch.device(args.device or "cuda")
    bundle = load_tflite(args.model, device=device)
    print(f"inputs {bundle.input_info.dimensions_string()} "
          f"outputs {bundle.output_info.dimensions_string()}")
    if args.check:
        import tensorflow as tf

        interp = tf.lite.Interpreter(model_path=args.model)
        interp.allocate_tensors()
        rng = np.random.default_rng(0)
        feeds = []
        for d in interp.get_input_details():
            a = (rng.integers(0, 256, d["shape"], np.uint8)
                 if d["dtype"] == np.uint8
                 else rng.normal(0, 1, d["shape"]).astype(d["dtype"]))
            interp.set_tensor(d["index"], a)
            feeds.append(a)
        interp.invoke()
        outs = interp.get_output_details()
        want = [interp.get_tensor(d["index"]) for d in outs]
        got = bundle.apply_fn(*[torch.from_numpy(f).to(device)
                                for f in feeds])
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        for i, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b)
            if np.issubdtype(b.dtype, np.integer) and "quantization" in outs[i]:
                scale, zp = outs[i]["quantization"]
                if scale:  # compare in dequantized units
                    b = (b.astype(np.float32) - zp) * scale
            a = a.detach().cpu().numpy().astype(np.float32)
            b = np.asarray(b, np.float32)
            err = float(np.max(np.abs(a - b)))
            line = f"output {i}: max abs err {err:.3e}"
            if a.ndim >= 1 and a.shape[-1] > 1:
                line += (f"  argmax torch={int(np.argmax(a.reshape(-1)))}"
                         f" interp={int(np.argmax(b.reshape(-1)))}")
            print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
