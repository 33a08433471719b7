"""tensor_transform — elementwise/shape op element, 7 modes.

Parity: gsttensor_transform.c (2345 LoC), modes enum gsttensor_transform.h:57-68:
dimchg / typecast / arithmetic / transpose / stand / clamp / padding, with the
arithmetic option grammar ``[typecast:T,][per-channel:true@D,]add|mul|div:V[@C],...``
(gsttensor_transform.c:753). The reference accelerates with ORC SIMD; here the
host path is vectorized numpy, and ``acceleration=device`` routes eligible
chains to the ``arith_chain`` CUDA kernel (ops/transform_ops.py). Host
inputs go to ``cuda``, which must exist; ``acceleration=device:cpu`` (the
grammar of the filter's ``accelerator=true:cpu``) asks for the CPU, where
the kernel's plain version runs. A torch tensor input stays on its device,
and the outputs stay there too unless this element is the pipeline's
materialization boundary (the residency planner's verdict), where they
cross to the host once.

Next to a ``tensor_filter`` the fusion planner (pipeline/planner.py) may
move an eligible chain into the filter's backend, where it runs on the
device after the upload; the element is then a passthrough shell for caps
and buffers (``fused-into:<filter>`` on the tracer).

Option grammars use the reference's innermost-first dim indices: dim k maps
to numpy axis (ndim-1-k).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import (
    Buffer,
    is_backend_tensor,
    materialize_tensors,
    nbytes_of,
    residency_of,
)
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import TensorDType, TensorInfo, TensorsConfig, TensorsInfo


MODES = ("dimchg", "typecast", "arithmetic", "transpose", "stand", "clamp", "padding")


@element_register
class TensorTransform(Element):
    ELEMENT_NAME = "tensor_transform"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "mode": Prop("enum", enum=MODES),
        "option": Prop("str", doc="mode-specific grammar"),
        "acceleration": Prop("str", doc="device|pallas[:cpu] routes "
                                        "eligible chains through the CUDA "
                                        "kernel (:cpu: its plain version "
                                        "on the CPU)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._mode = str(self.properties.get("mode", ""))
        self._option = str(self.properties.get("option", ""))
        self._accel_device: Optional[torch.device] = None  # set by start()
        # set by the fusion planner: this element's math runs inside the
        # named filter's backend; chain() is a passthrough shell until the
        # next (re)plan (tracer shows `fused-into:<filter>`)
        self._fused_into: Optional[str] = None
        if self._mode and self._mode not in MODES:
            raise ElementError(self.name, f"unknown transform mode {self._mode!r}")

    # -- residency negotiation (memory:HBM lane) ---------------------------
    def _statically_device_eligible(self) -> bool:
        """The device-path gates evaluable without data: True when this
        mode/option is GUARANTEED to run device-side with bit parity.
        Only arithmetic qualifies — clamp's float32-input gate resolves at
        runtime, so advertising residency for it could strip the upstream
        boundary and then bail to per-buffer host math; clamp stays
        conservative."""
        if self._mode != "arithmetic":
            return False
        from nnstreamer_tpu_torch.pipeline.planner import transform_fusion_spec

        return transform_fusion_spec(self, None, 1) is not None

    def accepts_device(self, pad: Pad) -> bool:
        if self._fused_into is not None:
            return True  # passthrough shell
        return self._device_accel() and self._statically_device_eligible()

    def produces_device(self, pad: Pad) -> bool:
        return (self._fused_into is None and self._device_accel()
                and self._statically_device_eligible())

    # -- negotiation -------------------------------------------------------
    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        if self._fused_into is not None:
            # fused: the math happens inside the downstream filter's
            # backend; caps (like buffers) pass through untouched
            return caps
        config = caps.to_config()
        info = config.info
        if info.num_tensors == 0:  # flexible: per-buffer transform
            return caps
        out_tensors = [self._transform_info(t) for t in info]
        out = TensorsConfig(
            TensorsInfo(tensors=out_tensors, format=info.format),
            config.rate_n, config.rate_d,
        )
        return Caps.from_config(out)

    def _transform_info(self, t: TensorInfo) -> TensorInfo:
        dims, dtype = list(t.dims), t.dtype
        mode, opt = self._mode, self._option
        if mode == "typecast":
            dtype = TensorDType.from_any(opt)
        elif mode == "arithmetic":
            for tok in opt.split(","):
                if tok.strip().startswith("typecast:"):
                    dtype = TensorDType.from_any(tok.split(":")[1])
        elif mode == "transpose":
            perm = [int(x) for x in opt.split(":")]
            src = list(dims) + [1] * (len(perm) - len(dims))
            dims = [src[p] for p in perm]
        elif mode == "dimchg":
            frm, to = (int(x) for x in opt.split(":"))
            d = list(dims) + [1] * (max(frm, to) + 1 - len(dims))
            v = d.pop(frm)
            d.insert(to, v)
            dims = d
        elif mode == "padding":
            d = list(dims)
            for spec in opt.split(","):
                spec = spec.strip()
                if not spec:
                    continue
                ab, _, dim_s = spec.partition("@")
                a, b = (int(x) for x in ab.split(":"))
                k = int(dim_s) if dim_s else 0
                while len(d) <= k:
                    d.append(1)
                d[k] += a + b
            dims = d
        return TensorInfo(tuple(dims), dtype, t.name)

    def start(self) -> None:
        self._accel_device = (self._pick_accel_device()
                              if self._device_accel() else None)

    # -- chain -------------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._fused_into is not None:
            return self.push(buf)  # fused: passthrough shell
        if self._device_accel():
            out = self._apply_device(buf)
            if out is not None:
                return self.push(out)
        # host math on the backend's tensors: one batched fetch, billed
        buf = self._fetch_to_host(buf)
        outs = [self._apply(np.asarray(t)) for t in buf.as_numpy()]
        return self.push(buf.with_tensors(outs))

    def _device_accel(self) -> bool:
        """acceleration=device|pallas routes eligible chains through the
        CUDA kernel (ops.arith_chain) — the reference's ORC SIMD
        ``acceleration`` property (gsttensor_transform.c), GPU edition.
        Outputs stay device-resident (async downstream)."""
        acc = str(self.properties.get("acceleration", "")).lower()
        return acc.split(":")[0] in ("device", "pallas", "true", "1")

    def _pick_accel_device(self) -> torch.device:
        """The device host inputs go to: the CPU only when the property
        asks for it (``device:cpu``), otherwise ``cuda``, which must
        exist."""
        target = str(self.properties.get("acceleration", "")).lower()
        if target.partition(":")[2] == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise ElementError(
                self.name, "acceleration=device needs a CUDA device and "
                "torch sees none; set acceleration=device:cpu to run the "
                "chain's plain version on the CPU")
        return torch.device("cuda")

    def _apply_device(self, buf: Buffer):
        """Device path ONLY where it bit-matches the numpy path:
        - arithmetic chains that LEAD with a float32 typecast (ops then run
          in float32 like numpy does after the cast); no per-channel;
        - clamp on float32 tensors.
        Anything else returns None → numpy path (no silent value drift).
        A kernel fault raises: there is no fallback to numpy once a chain
        qualified."""
        from nnstreamer_tpu_torch.ops import arith_chain
        from nnstreamer_tpu_torch.ops.fusion_stages import kernel_input

        mode, opt = self._mode, self._option
        if mode == "arithmetic" and "@" not in opt and "per-channel" not in opt:
            toks = [t.strip() for t in opt.split(",") if t.strip()]
            if not toks or not toks[0].startswith("typecast:"):
                return None
            cast = TensorDType.from_any(toks[0].split(":")[1])
            if cast != TensorDType.FLOAT32:
                # f64 is not what the kernel computes in; f16 accumulates
                # differently than numpy's per-op half math
                return None
            ops = []
            for tok in toks[1:]:
                k, _, v = tok.partition(":")
                if k == "typecast":
                    return None  # mid-chain casts: numpy path
                ops.append((k, float(v)))
            xs = self._device_chain_inputs(buf)
            outs = [arith_chain(kernel_input(x), ops, out_dtype=torch.float32)
                    for x in xs]
            return self._finish_device(buf, outs)
        if mode == "clamp":
            xs = self._device_chain_inputs(buf)
            if any(x.dtype != torch.float32 for x in xs):
                return None  # see cast gate above
            lo, hi = (float(x) for x in opt.split(":"))
            outs = [arith_chain(x, [], clamp=(lo, hi)) for x in xs]
            return self._finish_device(buf, outs)
        return None

    def _finish_device(self, buf: Buffer, outs: List) -> Buffer:
        """Device-path emit: bill the upload of host inputs, and honor the
        residency plan — fetch here (one batched transfer) when this
        element is the boundary, else hand the tensors downstream
        untouched."""
        host = [t for t in buf.tensors if not is_backend_tensor(t)]
        if host:
            self._record_crossing("h2d", nbytes=nbytes_of(host))
        if self.src_pads and self.src_pads[0].device_ok is False:
            self._record_crossing("d2h", nbytes=nbytes_of(outs))
            outs = materialize_tensors(outs)
        nb = buf.with_tensors(outs)
        nb.meta["residency"] = residency_of(outs)
        return nb

    def _device_chain_inputs(self, buf: Buffer) -> List[torch.Tensor]:
        """Per-tensor inputs for the device path: torch tensors stay on
        their device; host arrays go to the device :meth:`start` picked
        (on the CPU ops.arith_chain runs its plain version)."""
        dev = self._accel_device
        xs: List[torch.Tensor] = []
        for t in buf.tensors:
            if isinstance(t, torch.Tensor):
                xs.append(t)
                continue
            if isinstance(t, (bytes, bytearray, memoryview)):
                a = np.frombuffer(bytes(t), dtype=np.uint8).copy()
            else:
                a = np.ascontiguousarray(np.asarray(t))
            xs.append(torch.from_numpy(a).to(dev))
        return xs

    def _apply(self, a: np.ndarray) -> np.ndarray:
        mode, opt = self._mode, self._option
        if mode == "typecast":
            return a.astype(TensorDType.from_any(opt).np_dtype)
        if mode == "arithmetic":
            return self._arith(a, opt)
        if mode == "transpose":
            perm = [int(x) for x in opt.split(":")]
            r = len(perm)
            # nns trailing-1 dims are *outer* numpy axes → prepend
            x = a.reshape((1,) * (r - a.ndim) + a.shape) if a.ndim < r else a
            # nns dim k ↔ np axis (r-1-k); new dim i takes old dim perm[i]
            np_perm = [r - 1 - perm[r - 1 - i] for i in range(r)]
            return np.transpose(x, np_perm)
        if mode == "dimchg":
            frm, to = (int(x) for x in opt.split(":"))
            r = max(a.ndim, frm + 1, to + 1)
            x = a.reshape((1,) * (r - a.ndim) + a.shape) if a.ndim < r else a
            return np.moveaxis(x, r - 1 - frm, r - 1 - to)
        if mode == "stand":
            parts = opt.split(":") if opt else ["default"]
            per_ch = "per-channel" in parts
            axes = tuple(range(a.ndim - 1)) if per_ch else None
            # double two-pass mean/std, f32 result: matches the native
            # runtime (and the reference's double accumulators) so the
            # cross-runtime conformance suite byte-compares clean.
            # Caveat: numpy sums pairwise, the native loop sequentially —
            # both in double, so the f32-cast results agree except when a
            # value lands within ~1e-16 relative of an f32 rounding
            # boundary (possible on very large tensors, not observed)
            x = a.astype(np.float64)
            mean = x.mean(axis=axes, keepdims=per_ch)
            if parts[0] == "dc-average":
                return (x - mean).astype(np.float32)
            std = x.std(axis=axes, keepdims=per_ch)
            return ((x - mean) / np.maximum(std, 1e-10)).astype(np.float32)
        if mode == "clamp":
            lo, hi = (float(x) for x in opt.split(":"))
            return np.clip(a, lo, hi)
        if mode == "padding":
            pads = [(0, 0)] * a.ndim
            for spec in opt.split(","):
                spec = spec.strip()
                if not spec:
                    continue
                ab, _, dim_s = spec.partition("@")
                p, q = (int(x) for x in ab.split(":"))
                k = int(dim_s) if dim_s else 0
                pads[a.ndim - 1 - k] = (p, q)
            return np.pad(a, pads)
        if not mode:
            return a
        raise ElementError(self.name, f"mode {mode!r} not handled")

    def _arith(self, a: np.ndarray, opt: str) -> np.ndarray:
        """``[typecast:T,][per-channel:true@D,]add|mul|div:V[@C],...``

        ``owned`` tracks whether ``x`` is a private copy: without a
        leading typecast (whose astype() copies), ``x`` aliases the
        caller's tensor and the per-channel in-place writes below would
        mutate the shared buffer — corrupting tee'd/queued branches that
        hold the same array. Copy-on-write before the first mutating op."""
        x = a
        owned = False
        per_ch_dim: Optional[int] = None
        for tok in opt.split(","):
            tok = tok.strip()
            if not tok:
                continue
            op, _, val = tok.partition(":")
            if op == "typecast":
                x = x.astype(TensorDType.from_any(val).np_dtype)
                owned = True
            elif op == "per-channel":
                flag, _, d = val.partition("@")
                per_ch_dim = int(d) if flag.lower() == "true" and d else (0 if flag.lower() == "true" else None)
            elif op in ("add", "mul", "div"):
                val, _, ch = val.partition("@")
                v = float(val)
                if ch and per_ch_dim is not None:
                    if not owned:
                        x = x.copy()
                        owned = True
                    axis = x.ndim - 1 - per_ch_dim
                    sl = [slice(None)] * x.ndim
                    sl[axis] = int(ch)
                    sl = tuple(sl)
                    if op == "add":
                        x[sl] = x[sl] + v
                    elif op == "mul":
                        x[sl] = x[sl] * v
                    else:
                        x[sl] = x[sl] / v
                else:
                    x = x + v if op == "add" else (x * v if op == "mul" else x / v)
                    owned = True
            else:
                raise ElementError(self.name, f"bad arithmetic op {tok!r}")
        return x
