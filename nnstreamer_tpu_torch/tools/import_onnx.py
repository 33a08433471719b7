""".onnx → torch importer: run ONNX models on the card (counterpart of
the JAX package's ``tools/import_onnx.py``).

The reference executes .onnx via onnxruntime
(tensor_filter_onnxruntime.cc); that runtime is not installed where the
port runs, so ONNX gets the same treatment as .tflite
(tools/import_tflite.py): parse the model (tools/onnx_lite.py — protobuf
wire format, no onnx package needed), lower the graph to torch ops, and
stream it like any zoo model — ``tensor_filter framework=jax
model=foo.onnx``.

Two op families, as the JAX importer's:
- float ops (Conv/Gemm/MatMul/elementwise/pools/shape ops);
- QOperator quantized ops (QuantizeLinear/DequantizeLinear, QLinearConv
  with per-axis weight scales, QLinearAdd, QLinearMatMul,
  QLinearGlobalAveragePool): explicit quantize-round-clip at every op
  boundary (integer semantics emulated in float; ``custom=qmode:float``
  skips the rounding).

Shape operands are constants of the graph, computed in numpy (Shape →
Gather → Concat → Reshape chains stay numpy); weights live on the
bundle's device. QLinearConv's dequantized weights and float bias, and
QLinearMatMul's dequantized right operand, are computed once at load.
Unsupported ops raise with the op name. Layout is ONNX-native NCHW;
convs and matmuls run with TF32 off on a card by default
(``custom=precision:default`` turns it on).

``custom=preproc:`` and ``batch:native``, which the .tflite importer
reads, change nothing here, as in the JAX ``load_onnx``: the importer
logs one warning naming them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.ops.fusion_stages import _torch_dtype
from nnstreamer_tpu_torch.tools import onnx_lite
from nnstreamer_tpu_torch.tools._import_common import as_device_tensor
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

log = get_logger("tools.import_onnx")


def _attr_i(node, name, default=0):
    a = node.attrs.get(name)
    return a.i if a is not None else default


def _attr_f(node, name, default=0.0):
    a = node.attrs.get(name)
    return float(a.f) if a is not None else default


def _attr_ints(node, name, default=()):
    a = node.attrs.get(name)
    return list(a.ints) if a is not None else list(default)


def _conv_pads(node, spatial: int):
    """ONNX pads = [d1_b, d2_b, ..., d1_e, d2_e, ...] → (before, after)
    pairs; SAME_UPPER / SAME_LOWER give None (padded as XLA's "SAME")."""
    auto = node.attrs.get("auto_pad")
    mode = auto.s.decode() if auto is not None and auto.s else "NOTSET"
    if mode in ("NOTSET", ""):
        pads = _attr_ints(node, "pads", [0] * (2 * spatial))
        return [(pads[i], pads[i + spatial]) for i in range(spatial)], None
    if mode == "VALID":
        return [(0, 0)] * spatial, None
    return None, mode


def _same_pairs(shape, kernel, strides, dilations):
    """XLA 'SAME' (before, after) pairs over the spatial dims."""
    out = []
    for n, k, s, d in zip(shape, kernel, strides, dilations):
        k_eff = (k - 1) * d + 1
        o = -(-n // s)
        total = max((o - 1) * s + k_eff - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _pad_spatial(a: torch.Tensor, pairs, value: float = 0.0):
    """Pad an N,C,spatial... tensor by (before, after) pairs."""
    if not any(b or e for b, e in pairs):
        return a
    flat = [v for pair in reversed(pairs) for v in pair]
    return F.pad(a, flat, value=value)


def _as_2d(a: torch.Tensor) -> torch.Tensor:
    """A 1-D spatial tensor (N, C, W) as (N, C, 1, W)."""
    return a.unsqueeze(2) if a.ndim == 3 else a


class OnnxGraph:
    """Parsed ONNX graph, executable as torch (see module docstring)."""

    def __init__(self, path: str, precision: Optional[str] = "highest",
                 qmode: str = "exact"):
        #: "exact" rounds+clips at every quantized-op boundary (integer
        #: semantics emulated in float); "float" skips rounding entirely —
        #: used to cross-validate the quant emulation
        self.qmode = qmode
        self.precision = None if precision in (None, "default") else precision
        self.g = onnx_lite.load(path)
        self.path = path
        self._consts: Dict[str, np.ndarray] = {
            name: t.to_numpy() for name, t in self.g.initializers.items()
        }
        for n in self.g.nodes:  # Constant nodes are compile-time values
            if n.op_type == "Constant":
                a = n.attrs.get("value")
                if a is not None and a.t is not None:
                    self._consts[n.outputs[0]] = a.t.to_numpy()
        self._derived = self._derive_weights()

    def _derive_weights(self) -> Dict[str, np.ndarray]:
        """Float weights the QOperator ops compute from their integer
        initializers, once: QLinearConv's dequantized kernel and float
        bias, QLinearMatMul's dequantized right operand (the JAX importer
        computes the same values per trace, from the same constants)."""
        out: Dict[str, np.ndarray] = {}
        for node in self.g.nodes:
            key = node.outputs[0] if node.outputs else node.name
            c = self._consts.get
            if node.op_type == "QLinearConv":
                if any(c(node.inputs[i]) is None for i in (1, 3, 4, 5)):
                    continue  # the op raises: its operands must be static
                xs = np.asarray(c(node.inputs[1]), np.float32)
                w = c(node.inputs[3])
                ws = np.asarray(c(node.inputs[4]), np.float32)
                wzp = np.asarray(c(node.inputs[5])).astype(np.int64)
                shp = ((-1,) + (1,) * (w.ndim - 1))
                out[f"{key}:w"] = (
                    (w.astype(np.float32)
                     - np.asarray(wzp, np.float32).reshape(
                         shp if np.size(wzp) > 1 else ()))
                    * np.asarray(ws, np.float32).reshape(
                        shp if np.size(ws) > 1 else ()))
                if len(node.inputs) > 8 and node.inputs[8]:
                    b32 = c(node.inputs[8]).astype(np.float64)
                    out[f"{key}:b"] = (b32 * (
                        np.asarray(ws, np.float64).reshape(-1)
                        * float(np.asarray(xs).reshape(-1)[0]))
                    ).astype(np.float32)
            elif node.op_type == "QLinearMatMul":
                b = c(node.inputs[3])
                bs = c(node.inputs[4])
                bzp = c(node.inputs[5])
                if b is None or bs is None or bzp is None:
                    continue
                out[f"{key}:b"] = (
                    (b.astype(np.float32)
                     - np.asarray(bzp).astype(np.float32))
                    * np.asarray(bs, np.float32))
        return out

    # -- weights ------------------------------------------------------------
    def params(self) -> Dict[str, np.ndarray]:
        """The graph's constants a device op reads (float64 as float32,
        as the JAX package's arrays with x64 off), and the derived
        QOperator weights."""
        out = {}
        for name, v in list(self._consts.items()) + list(
                self._derived.items()):
            a = np.asarray(v)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            if a.dtype.kind not in "fiub" or a.dtype.itemsize > 8 or (
                    a.dtype.kind == "u" and a.dtype.itemsize > 1):
                continue  # no torch op reads it: it stays a numpy constant
            out[name] = a
        return out

    def channels_last(self):
        return []

    def io_info(self):
        def info(vis):
            tensors = []
            for vi in vis:
                dt = onnx_lite.DTYPES.get(vi.elem_type, np.float32)
                dims = [d if d > 0 else 1 for d in vi.dims]
                tensors.append(TensorInfo.from_np_shape(dims, dt))
            return TensorsInfo(tensors=tensors)

        return info(self.g.inputs), info(self.g.outputs)

    # -- execution ----------------------------------------------------------
    def apply(self, params: Dict[str, Any], *inputs):
        vals: Dict[str, Any] = dict(params)
        if len(inputs) != len(self.g.inputs):
            raise ValueError(
                f"model wants {len(self.g.inputs)} inputs, got {len(inputs)}"
            )
        for vi, x in zip(self.g.inputs, inputs):
            want_rank = len(vi.dims)
            if hasattr(x, "ndim") and want_rank and x.ndim == want_rank - 1:
                x = x[None]  # caps grammar trims the leading batch-1 dim
            vals[vi.name] = x
        dev = next((v.device for v in list(inputs) + list(params.values())
                    if isinstance(v, torch.Tensor)), torch.device("cpu"))
        for node in self.g.nodes:
            if node.op_type == "Constant":
                continue
            outs = self._run_op(node, vals, params, dev)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, o in zip(node.outputs, outs):
                vals[name] = o
        res = [vals[o.name] for o in self.g.outputs]
        return res[0] if len(res) == 1 else tuple(res)

    # -- op lowering --------------------------------------------------------
    def _run_op(self, node, vals, params, dev):
        op = node.op_type

        def val(name):
            if not name:
                return None
            c = self._consts.get(name)
            # integer constants (shape/pads/axes math) and tiny scalars
            # stay numpy so downstream `static()` chains keep working —
            # real weights (float, big) are the device params
            if c is not None and (c.dtype.kind in "iu" or c.size <= 16):
                return c
            return vals[name]

        x = [val(i) for i in node.inputs]

        def tensor(idx: int) -> Optional[torch.Tensor]:
            """Input ``idx`` as a device tensor: a numpy constant as its
            device copy (the params), a computed numpy value made one."""
            v = x[idx]
            if v is None or isinstance(v, torch.Tensor):
                return v
            name = node.inputs[idx]
            if name in params:
                return params[name]
            return as_device_tensor(v, dev)

        def static(idx: int) -> np.ndarray:
            """Shape/scale operands must be constants: the parsed
            initializer, or a statically computed numpy value
            (Shape/ConstantOfShape chains) — never a runtime value."""
            name = node.inputs[idx]
            v = self._consts.get(name)
            if v is None:
                rv = vals.get(name)
                if isinstance(rv, np.ndarray):
                    v = rv
            if v is not None:
                return v
            raise NotImplementedError(
                f"{op}: operand {name!r} must be a compile-time constant"
            )

        def conv(a, w, b, group):
            spatial = w.ndim - 2
            strides = _attr_ints(node, "strides", [1] * spatial)
            dil = _attr_ints(node, "dilations", [1] * spatial)
            pads, _same = _conv_pads(node, spatial)
            a = a.to(torch.float32)
            w = w.to(torch.float32)
            if pads is None:
                pads = _same_pairs(a.shape[2:], w.shape[2:], strides, dil)
            a = _pad_spatial(a, pads)
            if spatial == 1:
                y = F.conv1d(a, w, stride=strides, dilation=dil,
                             groups=group)
            else:
                y = F.conv2d(a, w, stride=strides, dilation=dil,
                             groups=group)
            if b is not None:
                y = y + b.to(torch.float32).reshape((1, -1) + (1,) * spatial)
            return y

        def pool(a, kind, mean=False, global_=False):
            spatial = a.ndim - 2
            if global_:
                dims = tuple(range(2, a.ndim))
                return (a.mean(dim=dims, keepdim=True) if mean
                        else a.amax(dim=dims, keepdim=True))
            k = _attr_ints(node, "kernel_shape")
            strides = _attr_ints(node, "strides", [1] * spatial)
            pads, _same = _conv_pads(node, spatial)
            a = a.to(torch.float32)
            if pads is None:
                pads = _same_pairs(a.shape[2:], k, strides, [1] * spatial)
            one_d = spatial == 1
            k2 = ([1] + k) if one_d else k
            s2 = ([1] + strides) if one_d else strides
            p2 = ([(0, 0)] + pads) if one_d else pads
            a2 = _as_2d(a)
            if kind == "max":
                y = F.max_pool2d(_pad_spatial(a2, p2, -float("inf")), k2, s2)
            else:
                y = F.avg_pool2d(_pad_spatial(a2, p2), k2, s2,
                                 divisor_override=1)
                ones = torch.ones((1, 1) + tuple(a2.shape[2:]),
                                  dtype=torch.float32, device=a.device)
                y = y / F.avg_pool2d(_pad_spatial(ones, p2), k2, s2,
                                     divisor_override=1)
            return y.squeeze(2) if one_d else y

        # ---- quantization helpers (QOperator family) ----
        def qparams(scale_idx, zp_idx):
            s = np.asarray(static(scale_idx), np.float32)
            zp = np.asarray(static(zp_idx))
            return s, zp.astype(np.int64), zp.dtype

        def dequant(v, s, zp, axis=None):
            sv = as_device_tensor(np.asarray(s, np.float32), dev)
            zv = as_device_tensor(np.asarray(zp, np.float32), dev)
            if axis is not None and np.ndim(s) == 1 and np.size(s) > 1:
                shape = [1] * v.ndim
                shape[axis] = -1
                sv = sv.reshape(shape)
                zv = zv.reshape(shape)
            return (v.to(torch.float32) - zv) * sv

        def quant(v, s, zp, qdtype):
            if np.size(s) > 1 or np.size(zp) > 1:
                raise NotImplementedError(
                    "per-axis quantize (y_scale/y_zero_point per channel) "
                    "is not supported; only per-tensor output quantization")
            sc = float(np.asarray(s).reshape(-1)[0])
            z = int(np.asarray(zp).reshape(-1)[0])
            info = np.iinfo(qdtype)
            q = v / torch.tensor(sc, dtype=torch.float32, device=v.device) + z
            if self.qmode != "float":
                q = torch.round(q)
            # the clip is SEMANTIC, not just quantization: QOperator graphs
            # fold activations into the representable range (zero_point=0 +
            # uint8 clamp at 0 IS the ReLU), so even the no-rounding float
            # reference mode must clamp; the value stays "quantized value
            # as float" (downstream dequant subtracts the zero point)
            return torch.clamp(q, float(info.min), float(info.max))

        def derived(suffix):
            return params[f"{node.outputs[0]}:{suffix}"]

        if op == "Conv":
            return conv(tensor(0), tensor(1),
                        tensor(2) if len(x) > 2 else None,
                        _attr_i(node, "group", 1))
        if op == "Gemm":
            a = tensor(0).to(torch.float32)
            b = tensor(1).to(torch.float32)
            if _attr_i(node, "transA"):
                a = a.t()
            if _attr_i(node, "transB", 0) != 0:
                b = b.t()
            y = (a @ b) * _attr_f(node, "alpha", 1.0)
            if len(x) > 2 and x[2] is not None:
                y = y + tensor(2).to(torch.float32) * _attr_f(
                    node, "beta", 1.0)
            return y
        if op == "MatMul":
            return tensor(0).to(torch.float32) @ tensor(1).to(torch.float32)
        if op in ("Add", "Sub", "Mul", "Div"):
            f = {"Add": torch.add, "Sub": torch.sub,
                 "Mul": torch.mul, "Div": torch.div}[op]
            return f(tensor(0), tensor(1))
        if op == "Relu":
            return torch.clamp(tensor(0), min=0)
        if op == "Clip":
            lo = (float(np.asarray(static(1)).reshape(())) if len(x) > 1
                  and x[1] is not None else _attr_f(node, "min", -np.inf))
            hi = (float(np.asarray(static(2)).reshape(())) if len(x) > 2
                  and x[2] is not None else _attr_f(node, "max", np.inf))
            return torch.clamp(tensor(0), lo, hi)
        if op == "Sigmoid":
            return torch.sigmoid(tensor(0))
        if op == "Tanh":
            return torch.tanh(tensor(0))
        if op == "Softmax":
            return torch.softmax(tensor(0), dim=_attr_i(node, "axis", -1))
        if op == "GlobalAveragePool":
            return pool(tensor(0), "avg", mean=True, global_=True)
        if op == "GlobalMaxPool":
            return pool(tensor(0), "max", global_=True)
        if op == "AveragePool":
            # divide by the count of in-bounds elements (count_include_pad
            # =0, the ONNX default), floor output shape (ceil_mode=0);
            # other combinations are refused explicitly
            if _attr_i(node, "count_include_pad", 0):
                raise NotImplementedError("AveragePool count_include_pad=1")
            if _attr_i(node, "ceil_mode", 0):
                raise NotImplementedError("AveragePool ceil_mode=1")
            return pool(tensor(0), "avg", mean=True)
        if op == "MaxPool":
            if _attr_i(node, "ceil_mode", 0):
                raise NotImplementedError("MaxPool ceil_mode=1")
            return pool(tensor(0), "max")
        if op == "Reshape":
            shape = [int(v) for v in static(1).reshape(-1)]
            # ONNX: 0 = copy input dim, -1 = infer
            shape = [x[0].shape[i] if s == 0 else s
                     for i, s in enumerate(shape)]
            if isinstance(x[0], np.ndarray):
                return np.reshape(x[0], shape)
            return tensor(0).reshape(shape)
        if op == "Flatten":
            ax = _attr_i(node, "axis", 1)
            lead = int(np.prod(x[0].shape[:ax])) if ax else 1
            return tensor(0).reshape(lead, -1)
        if op == "Transpose":
            perm = _attr_ints(node, "perm") or list(
                range(x[0].ndim))[::-1]
            if isinstance(x[0], np.ndarray):
                return np.transpose(x[0], perm)
            return tensor(0).permute(*perm)
        if op == "Concat":
            ax = _attr_i(node, "axis", 0)
            idx = [i for i, v in enumerate(x) if v is not None]
            if all(isinstance(x[i], np.ndarray) for i in idx):
                return np.concatenate([x[i] for i in idx], axis=ax)
            return torch.cat([tensor(i) for i in idx], dim=ax)
        if op == "Unsqueeze":
            axes = (_attr_ints(node, "axes")
                    or [int(v) for v in static(1).reshape(-1)])
            y = x[0]
            if not isinstance(y, np.ndarray):
                y = tensor(0)
            for a in sorted(axes):
                y = (np.expand_dims(y, a) if isinstance(y, np.ndarray)
                     else y.unsqueeze(a))
            return y
        if op == "Squeeze":
            axes = _attr_ints(node, "axes") or (
                [int(v) for v in static(1).reshape(-1)]
                if len(node.inputs) > 1 else None)
            y = tensor(0)
            return y.squeeze(tuple(axes)) if axes else y.squeeze()
        if op == "BatchNormalization":
            s, b, mean, var = (tensor(i).to(torch.float32)
                               for i in (1, 2, 3, 4))
            eps = _attr_f(node, "epsilon", 1e-5)
            a = tensor(0)
            shape = (1, -1) + (1,) * (a.ndim - 2)
            return ((a - mean.reshape(shape))
                    / torch.sqrt(var.reshape(shape) + eps)
                    * s.reshape(shape) + b.reshape(shape))
        if op == "Pad":
            mode = node.attrs.get("mode")
            if mode is not None and mode.s not in (b"", b"constant"):
                raise NotImplementedError(f"Pad mode {mode.s!r}")
            pads = (_attr_ints(node, "pads")
                    or [int(v) for v in static(1).reshape(-1)])
            a = tensor(0)
            n = a.ndim
            return F.pad(a, [v for i in reversed(range(n))
                             for v in (pads[i], pads[i + n])])
        if op == "ReduceMean":
            axes = _attr_ints(node, "axes") or None
            keep = bool(_attr_i(node, "keepdims", 1))
            a = tensor(0)
            return a.mean(dim=tuple(axes) if axes else tuple(range(a.ndim)),
                          keepdim=keep)
        if op == "Identity":
            return x[0]
        if op == "Shape":
            return np.asarray(tuple(x[0].shape), np.int64)
        if op == "ConstantOfShape":
            shape = [int(v) for v in static(0).reshape(-1)]
            a = node.attrs.get("value")
            fill = a.t.to_numpy() if a is not None and a.t is not None \
                else np.zeros(1, np.float32)
            return np.full(shape, fill.reshape(-1)[0], fill.dtype)
        if op == "Cast":
            to = onnx_lite.DTYPES.get(_attr_i(node, "to", 1), np.float32)
            if isinstance(x[0], np.ndarray):
                return x[0].astype(to)
            return tensor(0).to(_torch_dtype(to))
        if op == "Gather":
            ax = _attr_i(node, "axis", 0)
            idx_v = x[1]
            if isinstance(x[0], np.ndarray) and isinstance(idx_v,
                                                           np.ndarray):
                return np.take(x[0], idx_v, axis=ax)
            a = tensor(0)
            idx = tensor(1).to(torch.int64)
            ax = ax % a.ndim
            idx = torch.where(idx < 0, idx + a.shape[ax], idx)
            out = torch.index_select(a, ax, idx.reshape(-1))
            return out.reshape(tuple(a.shape[:ax]) + tuple(idx.shape)
                               + tuple(a.shape[ax + 1:]))
        if op == "Expand":
            shape = [int(v) for v in static(1).reshape(-1)]
            a = tensor(0)
            return a.expand(np.broadcast_shapes(tuple(a.shape),
                                                tuple(shape)))
        if op == "Slice":
            if "starts" in node.attrs:  # opset < 10: attributes
                starts = _attr_ints(node, "starts")
                ends = _attr_ints(node, "ends")
                axes = _attr_ints(node, "axes",
                                  list(range(len(starts))))
                steps = [1] * len(starts)
            else:
                starts = [int(v) for v in static(1).reshape(-1)]
                ends = [int(v) for v in static(2).reshape(-1)]
                axes = ([int(v) for v in static(3).reshape(-1)]
                        if len(node.inputs) > 3 and node.inputs[3]
                        else list(range(len(starts))))
                steps = ([int(v) for v in static(4).reshape(-1)]
                         if len(node.inputs) > 4 and node.inputs[4]
                         else [1] * len(starts))
            if isinstance(x[0], np.ndarray):
                sl = [slice(None)] * x[0].ndim
                for s, e, a2, st in zip(starts, ends, axes, steps):
                    sl[a2] = slice(s, e, st)
                return x[0][tuple(sl)]
            y = tensor(0)
            for s, e, a2, st in zip(starts, ends, axes, steps):
                if st > 0:
                    y = y[(slice(None),) * (a2 % y.ndim) + (slice(s, e, st),)]
                else:  # torch slices take no negative step: gather
                    keep = list(range(y.shape[a2]))[slice(s, e, st)]
                    y = torch.index_select(y, a2, torch.as_tensor(
                        keep, dtype=torch.int64, device=y.device))
            return y

        # ---- QOperator quantized family ----
        if op == "QuantizeLinear":
            s, zp, qdt = qparams(1, 2)
            return quant(tensor(0).to(torch.float32), s, zp, qdt)
        if op == "DequantizeLinear":
            s, zp, _ = qparams(1, 2)
            axis = _attr_i(node, "axis", 1)
            return dequant(tensor(0), s, zp,
                           axis=axis if np.size(s) > 1 else None)
        if op == "QLinearConv":
            # x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp[, B(int32)]
            xs, xzp, _ = qparams(1, 2)
            ys, yzp, ydt = qparams(6, 7)
            a = dequant(tensor(0), xs, xzp)
            bias = (derived("b") if len(node.inputs) > 8 and node.inputs[8]
                    else None)
            y = conv(a, derived("w"), bias, _attr_i(node, "group", 1))
            return quant(y, ys, yzp, ydt)
        if op == "QLinearAdd":  # com.microsoft contrib
            as_, azp, _ = qparams(1, 2)
            bs, bzp, _ = qparams(4, 5)
            cs, czp, cdt = qparams(6, 7)
            return quant(dequant(tensor(0), as_, azp)
                         + dequant(tensor(3), bs, bzp), cs, czp, cdt)
        if op == "QLinearMatMul":
            as_, azp, _ = qparams(1, 2)
            cs, czp, cdt = qparams(6, 7)
            y = dequant(tensor(0), as_, azp) @ derived("b")
            return quant(y, cs, czp, cdt)
        if op == "QLinearGlobalAveragePool":  # com.microsoft contrib
            xs, xzp, _ = qparams(1, 2)
            ys, yzp, ydt = qparams(3, 4)
            a = dequant(tensor(0), xs, xzp)
            if _attr_i(node, "channels_last", 0):
                y = a.mean(dim=tuple(range(1, a.ndim - 1)), keepdim=True)
            else:
                y = a.mean(dim=tuple(range(2, a.ndim)), keepdim=True)
            return quant(y, ys, yzp, ydt)

        raise NotImplementedError(
            f"onnx op {op} is not supported by the importer"
        )


def load_onnx(path: str, custom: Optional[Dict[str, str]] = None,
              device="cuda"):
    """Parse an .onnx file into a :class:`models.ModelBundle` on
    ``device`` (``framework=jax model=foo.onnx``).

    ``custom=precision:default`` lets the card use TF32;
    ``custom=qmode:float`` is the no-rounding reference mode for
    QOperator graphs (see OnnxGraph.qmode). The .tflite importer's
    ``preproc:`` and ``batch:native`` are ignored, as the JAX importer
    ignores them."""
    from nnstreamer_tpu_torch.tools._import_common import (
        graph_bundle,
        make_batch1_apply,
    )

    custom = dict(custom or {})
    ignored = [f"{k}:{custom.pop(k)}" for k in ("preproc", "batch")
               if k in custom and (k != "batch" or custom[k] == "native")]
    if ignored:
        log.warning("%s: the .onnx importer ignores %s (the .tflite "
                    "importer's options)", path, ", ".join(ignored))
    g = OnnxGraph(path, precision=custom.get("precision", "highest"),
                  qmode=str(custom.get("qmode", "exact")))
    graph_ranks = [len(vi.dims) for vi in g.g.inputs]
    # literal batch-1 only: a dynamic first axis (parsed as 0) may be a
    # sequence dim the graph contracts over — see make_batch1_apply
    batch1 = bool(g.g.inputs) and all(
        vi.dims and vi.dims[0] == 1 for vi in g.g.inputs)
    apply_fn = make_batch1_apply(g.apply, graph_ranks, batch1)
    log.info("imported %s: %d nodes, %d initializers", path,
             len(g.g.nodes), len(g.g.initializers))
    return graph_bundle(g, apply_fn, custom, device)
