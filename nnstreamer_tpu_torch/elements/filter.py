"""tensor_filter — THE inference element (counterpart of the JAX package's
``elements/filter.py``, solo path).

Mirrors the reference's GstBaseTransform hot loop (tensor_filter.c:643-944)
and shared property engine (tensor_filter_common.c): framework
auto-detection from the model extension (tensor_filter_common.c:1224-1270),
input/output info overrides, input/output-combination selection
(:716-758, :850-869), invoke statistics (`latency`/`throughput` props,
tensor_filter.c:366-478), QoS throttling (:512), shared-tensor-filter-key
and hot model reload events.

Invoke enqueues CUDA work and returns without synchronising: outputs flow
downstream as CUDA tensors. ``fetch-window=K|eos`` holds device outputs and
brings a whole window to the host in ONE batched device→host transfer
(:func:`buffer.materialize_tensors`).

Not ported yet (see ROADMAP.md): micro-batching (``batch-size``), the
upload window (``feed-depth``), ``fetch-window=auto``, chain/stage fusion,
the steady loop, mesh sharding, replicas, the AOT cache, rollout, the
invoke watchdog and ``fallback-framework``. Setting any of them to other
than its default raises at construction instead of being ignored.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import numpy as np

from nnstreamer_tpu_torch import meta as meta_mod
from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import (
    Buffer,
    Event,
    is_device_array,
    materialize_tensors,
    residency_of,
)
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.config import conf
from nnstreamer_tpu_torch.filters.base import (
    FilterProperties,
    acquire_framework,
    release_framework,
)
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.types import TensorFormat, TensorsConfig, TensorsInfo

log = get_logger("tensor_filter")

#: JAX-package properties this element does not implement yet, with the
#: value that means "off" (that value is accepted; any other raises)
NOT_PORTED = {
    "invoke_dynamic": False,
    "batch_size": 1,
    "feed_depth": 1,
    "fetch_timeout_ms": 0,
    "loop_window": 0,
    "launch_depth": 1,
    "shard": "off",
    "mesh": "",
    "invoke_timeout_ms": 0,
    "fallback_framework": "",
    "fallback_after": 0,
    "chain_fusion": "off",
    "rollout_model": "",
    "rollout_canary_frames": 0,
    "rollout_rollback": "off",
}


def _is_off(key: str, value) -> bool:
    off = NOT_PORTED[key]
    if isinstance(off, bool):
        return not value or str(value).lower() in ("0", "false", "no")
    return str(value).strip().lower() == str(off)


@element_register
class TensorFilter(Element):
    ELEMENT_NAME = "tensor_filter"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "framework": Prop("str", doc="backend name or 'auto'"),
        "model": Prop("str", doc="model file(s), comma separated"),
        "custom": Prop("str", doc="backend-specific options"),
        "accelerator": Prop("str"),
        "shared_tensor_filter_key": Prop("str"),
        "input": Prop("str", doc="input dims override (with input-type)"),
        "inputtype": Prop("str"),
        "inputname": Prop("str"),
        "output": Prop("str"),
        "outputtype": Prop("str"),
        "outputname": Prop("str"),
        "input_combination": Prop("str", doc="comma-separated indices"),
        "output_combination": Prop("str", doc="iN/oN tokens"),
        "fetch_window": Prop(
            "str",
            validate=lambda v: (
                None if str(v).strip().lower() == "eos"
                or str(v).strip().lstrip("-").isdigit()
                else f"expected an integer or 'eos', got {v!r}"),
            doc="device→host transfer amortizer"),
        "latency": Prop("bool"),
        "latency_report": Prop("bool"),
        "latency_e2e": Prop("bool"),
        "throughput": Prop("bool"),
        "sync": Prop("bool", doc="materialize outputs on the streaming "
                                 "thread"),
        **{k: Prop("any", doc="not supported in this package")
           for k in NOT_PORTED},
    }

    #: fetch-window=eos memory backstop: flush after this many held buffers
    _EOS_WINDOW_CAP = 4096

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        on = [k for k in NOT_PORTED
              if k in self.properties and not _is_off(k, self.properties[k])]
        if on:
            raise ElementError(
                self.name, "not supported by this package's tensor_filter: "
                + ", ".join(f"{k.replace('_', '-')}={self.properties[k]}"
                            for k in on))
        if str(self.properties.get("fetch_window", "")).lower() == "auto":
            raise ElementError(self.name, "fetch-window=auto is not supported "
                               "by this package's tensor_filter")
        self.fw = None
        self._fw_props: Optional[FilterProperties] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self._in_config: Optional[TensorsConfig] = None
        self._latencies_us: deque = deque(maxlen=10)  # last-10 window (:981-987)
        self._e2e_us: deque = deque(maxlen=10)
        self._out_times: deque = deque(maxlen=50)
        self._qos_earliest: int = -1
        self._invoke_count = 0
        # fetch-window: (buf, tensors, outputs) entries awaiting one
        # batched device→host transfer
        self._fetch_pending: List[tuple] = []
        # serializes the hot loop with reload events (the invoke runs
        # under it, by design)
        self._window_lock = lockwitness.make_rlock(
            "filter.window", blocking_ok=True, invoke_ok=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """NULL→READY opens the framework (gst_tensor_filter_start
        tensor_filter.c:1548 → common_open_fw tensor_filter_common.c:2465)."""
        fw_name = str(self.properties.get("framework", "auto"))
        model = self.properties.get("model")
        models = str(model).split(",") if model else []
        fw_name = conf().resolve_alias(fw_name) or "auto"
        if fw_name in ("auto", ""):
            fw_name = self._detect_framework(models)
        fprops = FilterProperties(
            framework=fw_name,
            model_files=models,
            custom=str(self.properties.get("custom", "")),
            accelerator=str(self.properties.get("accelerator", "")),
            shared_key=self.properties.get("shared_tensor_filter_key"),
        )
        # user input/output overrides (input=dims input-type=...; :894-1030)
        if self.properties.get("input") and self.properties.get("inputtype"):
            fprops.input_info = TensorsInfo.from_strings(
                str(self.properties["input"]), str(self.properties["inputtype"]),
                self.properties.get("inputname"),
            )
        if self.properties.get("output") and self.properties.get("outputtype"):
            fprops.output_info = TensorsInfo.from_strings(
                str(self.properties["output"]), str(self.properties["outputtype"]),
                self.properties.get("outputname"),
            )
        try:
            self.fw = acquire_framework(fw_name, fprops)
        except Exception as e:
            raise ElementError(self.name, f"cannot open framework {fw_name!r}: {e}")
        self._fw_props = fprops
        in_info, out_info = self.fw.get_model_info()
        self._in_info = fprops.input_info or in_info
        self._out_info = fprops.output_info or out_info
        self._invoke_count = 0
        self._latencies_us.clear()
        self._e2e_us.clear()

    def stop(self) -> None:
        with self._window_lock:
            if self.fw is not None:
                release_framework(self.fw, self._fw_props.shared_key)
                self.fw = None
            self._fetch_pending = []

    def _detect_framework(self, models: List[str]) -> str:
        from nnstreamer_tpu_torch.filters.base import detect_framework

        try:
            return detect_framework(models)
        except ValueError as e:
            raise ElementError(self.name, str(e)) from e

    # -- negotiation -------------------------------------------------------
    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        """Fixed sink caps → src caps from the model's output info
        (gst_tensor_filter_configure_tensor tensor_filter.c:953)."""
        with self._window_lock:
            return self._transform_caps_locked(pad, caps)

    def _transform_caps_locked(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        config = caps.to_config()
        self._in_config = config
        in_info = config.info
        # input-combination narrows what the model sees (:716-758)
        sel = self.properties.get("input_combination")
        if sel and in_info.num_tensors > 0:
            idx = [int(i) for i in str(sel).split(",")]
            in_info = TensorsInfo(tensors=[in_info.tensors[i] for i in idx],
                                  format=in_info.format)
        if config.format == TensorFormat.STATIC and in_info.num_tensors > 0:
            if self._in_info is not None and self._in_info.num_tensors > 0:
                if not (self._in_info == in_info):
                    # model disagrees: try reshape (SET_INPUT_INFO :418-441)
                    if self.fw is not None and self.fw.RESHAPABLE:
                        self._in_info, self._out_info = self.fw.set_input_info(in_info)
                    else:
                        raise ElementError(
                            self.name,
                            f"incoming tensors {in_info.dimensions_string()}/"
                            f"{in_info.types_string()} do not match model input "
                            f"{self._in_info.dimensions_string()}/{self._in_info.types_string()}",
                        )
            elif self.fw is not None and self.fw.RESHAPABLE:
                self._in_info, self._out_info = self.fw.set_input_info(in_info)
        if self._out_info is None:
            raise ElementError(self.name, "cannot determine output info")
        out_info = self._out_info
        # output-combination mixes inputs back into the output caps (:850-869)
        ocomb = self.properties.get("output_combination")
        if ocomb:
            tensors = []
            for tok in str(ocomb).split(","):
                tok = tok.strip()
                if tok.startswith("i"):
                    tensors.append(config.info.tensors[int(tok[1:])])
                else:
                    tensors.append(out_info.tensors[int(tok[1:]) if tok.startswith("o") else int(tok)])
            out_info = TensorsInfo(tensors=tensors)
        return Caps.from_config(TensorsConfig(out_info, config.rate_n, config.rate_d))

    # -- events ------------------------------------------------------------
    def _on_sink_event(self, pad: Pad, event: Event) -> None:
        if event.type == "reload-model":
            new_model = event.data.get("model")
            # serialized with the hot loop: held window entries are
            # emitted against the OLD model before the swap
            with self._window_lock:
                if self._fetch_pending:
                    self._flush_fetch_window()
                if new_model:
                    self.properties["model"] = new_model
                    self._fw_props.model_files = str(new_model).split(",")
                    if (self.fw.props is not None
                            and self.fw.props is not self._fw_props):
                        self.fw.props.model_files = list(
                            self._fw_props.model_files)
                self.fw.handle_event("reload_model")
            self.post_message("model-reloaded", {"model": new_model})
            return
        super()._on_sink_event(pad, event)

    def on_upstream_event(self, pad: Pad, event: Event) -> None:
        if event.type == "qos":
            # QoS throttling (gst_tensor_filter_check_throttling_delay :512)
            self._qos_earliest = max(self._qos_earliest, int(event.data.get("earliest", -1)))
        self.send_upstream_event(event)

    # -- hot loop ----------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self.fw is None:
            return FlowReturn.NOT_NEGOTIATED
        # QoS drop (tensor_filter.c:512 → FLOW_DROPPED)
        if self._qos_earliest > 0 and 0 <= buf.pts < self._qos_earliest:
            return FlowReturn.DROPPED
        if self._measuring():
            # arrival stamp for the e2e latency window (rides the buffer
            # through fetch-window holds to _emit_now)
            buf._nns_t_in = time.monotonic()
        tensors = list(buf.tensors)
        fmt = self._in_config.format if self._in_config else TensorFormat.STATIC
        if fmt == TensorFormat.FLEXIBLE:
            # strip per-tensor headers (:706-708)
            tensors = [meta_mod.unwrap_flexible(t)[0] if isinstance(t, (bytes, bytearray, memoryview)) else t
                       for t in tensors]
        elif self._in_config is not None and self._in_config.info.num_tensors == len(tensors):
            # bytes payloads on static streams: view as typed arrays
            tensors = [
                np.frombuffer(bytes(t), dtype=i.dtype.np_dtype).reshape(i.np_shape())
                if isinstance(t, (bytes, bytearray, memoryview)) else t
                for t, i in zip(tensors, self._in_config.info)
            ]
        # input-combination selection (:716-758)
        sel = self.properties.get("input_combination")
        inputs = [tensors[int(i)] for i in str(sel).split(",")] if sel else tensors
        with self._window_lock:
            outputs = self._invoke(inputs)
            return self._emit(buf, tensors, outputs)

    def _measuring(self) -> bool:
        return any(self.properties.get(k) for k in
                   ("latency", "throughput", "latency_report", "latency_e2e"))

    def _invoke(self, inputs: List) -> List:
        """One backend invoke. With latency measurement on, the outputs are
        synchronised so the window holds compute time, not enqueue time."""
        t0 = time.perf_counter()
        try:
            outputs = self.fw.invoke(inputs)
        except ElementError:
            raise
        except Exception as e:
            raise ElementError(self.name, f"invoke failed: {e}") from e
        self._invoke_count += 1
        if self._measuring():
            dev = [o for o in outputs if is_device_array(o)]
            if dev:
                import torch

                torch.cuda.synchronize(dev[0].device)
            if self._invoke_count > 1:  # the first invoke builds; keep it out
                self._latencies_us.append((time.perf_counter() - t0) * 1e6)
            self._out_times.append(time.monotonic())
        return outputs

    def _emit(self, buf: Buffer, tensors: List, outputs: List) -> FlowReturn:
        if not outputs:
            # backend signalled per-frame drop (tensor_filter.c:843-845)
            return FlowReturn.DROPPED
        # this package has no residency planner yet, so every downstream
        # element is a host consumer and the window always engages
        window = self._fetch_window_size()
        if window > 1 and (
            any(is_device_array(o) for o in outputs) or self._fetch_pending
        ):
            if not self.properties.get("output_combination"):
                # held entries must not pin the stream's input frames
                nb = buf.with_tensors([])
                t_in = getattr(buf, "_nns_t_in", None)
                if t_in is not None:
                    nb._nns_t_in = t_in
                buf, tensors = nb, []
            self._fetch_pending.append((buf, tensors, outputs))
            if len(self._fetch_pending) < window:
                return FlowReturn.OK
            return self._flush_fetch_window()
        return self._emit_now(buf, tensors, outputs)

    def _fetch_window_size(self) -> int:
        prop = str(self.properties.get("fetch_window", 1)).strip().lower()
        if prop == "eos":
            return self._EOS_WINDOW_CAP
        return int(prop or 1)

    def _flush_fetch_window(self) -> FlowReturn:
        """Bring every held window entry to the host in ONE batched
        device→host transfer, then emit them in order."""
        pending, self._fetch_pending = self._fetch_pending, []
        if not pending:
            return FlowReturn.OK
        flat = materialize_tensors([o for _, _, outs in pending for o in outs])
        k = 0
        ret = FlowReturn.OK
        for buf, tensors, outs in pending:
            host = flat[k:k + len(outs)]
            k += len(outs)
            ret = self._emit_now(buf, tensors, host)
            if ret not in (FlowReturn.OK, FlowReturn.DROPPED):
                return ret
        return ret

    def _emit_now(self, buf: Buffer, tensors: List, outputs: List) -> FlowReturn:
        # output-combination (:850-869): 'iN' passthrough input N, 'oN' output N
        ocomb = self.properties.get("output_combination")
        if ocomb:
            outs = []
            for tok in str(ocomb).split(","):
                tok = tok.strip()
                if tok.startswith("i"):
                    outs.append(tensors[int(tok[1:])])
                else:
                    outs.append(outputs[int(tok[1:]) if tok.startswith("o") else int(tok)])
            outputs = outs
        if self.properties.get("sync"):
            # sync=1: materialize on THIS streaming thread
            outputs = materialize_tensors(outputs)
        t_in = getattr(buf, "_nns_t_in", None)
        if t_in is not None:
            self._e2e_us.append((time.monotonic() - t_in) * 1e6)
        out_buf = buf.with_tensors(outputs)
        out_buf.meta["residency"] = residency_of(outputs)
        return self.push(out_buf)

    def on_eos(self) -> None:
        with self._window_lock:
            if self._fetch_pending:
                self._flush_fetch_window()

    def query_latency(self) -> int:
        """Estimated per-buffer latency in ns with 15% headroom
        (tensor_filter.c:1381-1421) when latency-report is enabled."""
        if not self.properties.get("latency_report") or not self._latencies_us:
            return 0
        avg_us = sum(self._latencies_us) / len(self._latencies_us)
        return int(avg_us * 1.15 * 1000)

    # -- stats (read-only runtime props, tensor_filter_common.c:981-995) ---
    def get_property(self, key: str):
        key = key.replace("-", "_")
        if key == "latency":
            return int(sum(self._latencies_us) / len(self._latencies_us)) if self._latencies_us else 0
        if key == "latency_e2e":
            return int(sum(self._e2e_us) / len(self._e2e_us)) if self._e2e_us else 0
        if key == "throughput":
            # outputs/sec × 10
            if len(self._out_times) >= 2:
                dt = self._out_times[-1] - self._out_times[0]
                if dt > 0:
                    return int((len(self._out_times) - 1) / dt * 10)
            return 0
        if key == "invoke_stats":
            s = self.fw.stats if self.fw else None
            return (s.total_invoke_num, s.total_invoke_latency_us) if s else (0, 0)
        return super().get_property(key)
