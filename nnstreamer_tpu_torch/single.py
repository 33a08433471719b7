"""Single-shot (pipeline-less) inference — the ML single-shot API basis
(counterpart of the JAX package's ``single.py``).

Parity: tensor_filter_single.c (435 LoC) + §3.3 of SURVEY.md: a wrapper
over the same framework ABI, no pipeline/caps machinery, direct invoke.
The Tizen/Android ``ml_single_*`` C API is built on it.

The same FilterFramework backends the pipeline element uses (the
torch/CUDA backend, registered as ``jax``, first), so a single-shot
invoke of a zoo model or an imported ``.tflite``/``.onnx`` file runs on
the card unless ``accelerator=true:cpu`` asks for the CPU;
``invoke()`` keeps outputs on the card for chained calls with
``sync=False``.

    from nnstreamer_tpu_torch.single import SingleShot
    s = SingleShot(model="mobilenet_v2", custom="seed:0")
    logits = s.invoke(frame)[0]
    s.close()
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

from nnstreamer_tpu_torch.buffer import materialize_tensors
from nnstreamer_tpu_torch.config import conf
from nnstreamer_tpu_torch.filters.base import (
    FilterProperties,
    acquire_framework,
    detect_framework,
    release_framework,
)
from nnstreamer_tpu_torch.types import TensorsInfo


class SingleShot:
    """Open-once, invoke-many, close. Thread-compatible (one instance per
    thread, or share via shared_key like the element's
    shared-tensor-filter-key)."""

    def __init__(
        self,
        model: Union[str, Sequence[str]],
        framework: str = "auto",
        custom: str = "",
        accelerator: str = "",
        input_info: Optional[TensorsInfo] = None,
        output_info: Optional[TensorsInfo] = None,
        shared_key: Optional[str] = None,
        sync: bool = True,
    ):
        models = [model] if isinstance(model, str) else list(model)
        framework = conf().resolve_alias(framework) or "auto"
        if framework in ("auto", ""):
            framework = detect_framework(models)
        self._props = FilterProperties(
            framework=framework,
            model_files=models,
            custom=custom,
            accelerator=accelerator,
            shared_key=shared_key,
        )
        self._sync = sync
        self.fw = acquire_framework(framework, self._props)
        try:
            in_info, out_info = self.fw.get_model_info()
            if input_info is not None and (
                in_info is None or not (in_info == input_info)
            ):
                if self.fw.RESHAPABLE:
                    in_info, out_info = self.fw.set_input_info(input_info)
                else:
                    raise ValueError(
                        f"model expects {in_info and in_info.dimensions_string()}, "
                        f"caller requested {input_info.dimensions_string()}"
                    )
        except Exception:
            # don't leak the opened (possibly shared/refcounted) framework
            release_framework(self.fw, shared_key)
            self.fw = None
            raise
        self.input_info = in_info
        self.output_info = output_info or out_info

    # -- invoke (tensor_filter_single.c:321) -------------------------------
    def invoke(self, inputs: Union[Any, Sequence[Any]]) -> List[Any]:
        """One sample in → list of output tensors. Accepts a single array or
        a list matching input_info. ``sync=True`` (default) materializes
        host ndarrays; otherwise device arrays may flow out."""
        if self.fw is None:
            raise RuntimeError("SingleShot is closed")
        if isinstance(inputs, (list, tuple)):
            xs = list(inputs)
        else:
            xs = [inputs]
        outs = self.fw.invoke(xs)
        if self._sync:
            outs = materialize_tensors(outs)
        return outs

    __call__ = invoke

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        """Reshape the model (SET_INPUT_INFO); returns the new output info."""
        self.input_info, self.output_info = self.fw.set_input_info(in_info)
        return self.output_info

    def reload(self) -> None:
        """Hot model reload (RELOAD_MODEL event parity)."""
        self.fw.handle_event("reload_model")

    @property
    def latency_us(self) -> float:
        """Average invoke latency (μs) over recorded invokes — the `latency`
        property parity (tensor_filter_common.c:981-987)."""
        s = self.fw.stats
        return s.total_invoke_latency_us / max(1, s.total_invoke_num)

    def close(self) -> None:
        if self.fw is not None:
            release_framework(self.fw, self._props.shared_key)
            self.fw = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
