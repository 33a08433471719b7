"""tensor_trainer element — on-device training stage in a stream pipeline.

Parity: gsttensor_trainer.c (1400 LoC): chain feeds samples to the trainer
subplugin (push_data :711), counts samples/epochs (:590,730), pushes a
1:1:4 float64 loss/accuracy tensor downstream per epoch (:25-30), reacts to
EPOCH/TRAINING_COMPLETION events, saves the model at EOS
(model_save_path write). Framework lookup via the trainer registry (:1148).
Counterpart of the JAX package's ``elements/trainer_element.py``, copied
with its imports pointed at this package. It declares no residency hooks,
as the JAX element does: a host consumer, so a device producer upstream
fetches at its boundary.

Properties (gsttensor_trainer.c property ids):
  framework, model-config, model-save-path, model-load-path,
  num-inputs, num-labels, num-training-samples, num-validation-samples,
  epochs, custom (free-form ``k:v,k:v`` passed to the backend)
"""

from __future__ import annotations

import queue
from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.analysis.schema import Prop
from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.caps import Caps
from nnstreamer_tpu_torch.log import ElementError, get_logger
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn, Pad, element_register
from nnstreamer_tpu_torch.trainers import TrainerEvent, TrainerProperties, find_trainer

log = get_logger("element.trainer")


@element_register
class TensorTrainer(Element):
    ELEMENT_NAME = "tensor_trainer"
    SINK_TEMPLATE = "other/tensors"
    SRC_TEMPLATE = "other/tensors"
    PROPERTY_SCHEMA = {
        "framework": Prop("str"),
        "model_config": Prop("str"),
        "model_save_path": Prop("str"),
        "model_load_path": Prop("str"),
        "epochs": Prop("int"),
        "num_inputs": Prop("int"),
        "num_labels": Prop("int"),
        "num_training_samples": Prop("int"),
        "num_validation_samples": Prop("int"),
        "custom": Prop("str"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fw = None
        self._events: "queue.Queue[TrainerEvent]" = queue.Queue()
        self._complete = False

    def start(self) -> None:
        fw_name = str(self.properties.get("framework", "jax"))
        cls = find_trainer(fw_name)
        if cls is None:
            raise ElementError(
                self.name, f"no trainer framework {fw_name!r} registered"
            )
        custom = {}
        for kv in str(self.properties.get("custom", "")).split(","):
            if ":" in kv:
                k, _, v = kv.partition(":")
                custom[k.strip()] = v.strip()
        self._tprops = TrainerProperties(
            model_config=str(self.properties.get("model_config", "")),
            model_save_path=str(self.properties.get("model_save_path", "")),
            model_load_path=str(self.properties.get("model_load_path", "")),
            num_inputs=int(self.properties.get("num_inputs", 1)),
            num_labels=int(self.properties.get("num_labels", 1)),
            num_training_samples=int(self.properties.get("num_training_samples", 0)),
            num_validation_samples=int(self.properties.get("num_validation_samples", 0)),
            num_epochs=int(self.properties.get("epochs", 1)),
            custom=custom,
        )
        self._fw = cls()
        self._fw.create(self._tprops)
        self._fw.start(self._events.put)
        self._complete = False

    def stop(self) -> None:
        if self._fw is not None:
            self._fw.stop()
            self._fw.destroy()
            self._fw = None

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        # downstream stream is the per-epoch loss/acc report:
        # 1:1:4 float64 (gsttensor_trainer.c:25-30)
        rate = ""
        cfg = caps.to_config()
        if cfg.rate_n >= 0 and cfg.rate_d > 0:
            rate = f",framerate={cfg.rate_n}/{cfg.rate_d}"
        return Caps.from_string(
            "other/tensors,format=static,num_tensors=1,"
            f"dimensions=1:1:4,types=float64{rate}"
        )

    def chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._fw is None:
            return FlowReturn.NOT_NEGOTIATED
        if self._complete:
            return FlowReturn.OK  # training done: drop further samples
        try:
            self._fw.push_data(buf.tensors)
        except Exception as e:  # noqa: BLE001 — surface as element error
            raise ElementError(self.name, f"push_data failed: {e}") from e
        ret = FlowReturn.OK
        while not self._events.empty():
            ev = self._events.get_nowait()
            if ev == TrainerEvent.EPOCH_COMPLETION:
                ret = self._push_status(buf)
            elif ev == TrainerEvent.TRAINING_COMPLETION:
                self._complete = True
                self._save()
        return ret

    def _push_status(self, like: Buffer) -> FlowReturn:
        s = self._fw.get_status()
        # dims 1:1:4 → numpy (4, 1, 1): the 4 values live on the fastest axis
        report = np.array(
            [
                s["training_loss"],
                s["training_accuracy"],
                s["validation_loss"],
                s["validation_accuracy"],
            ],
            np.float64,
        ).reshape(4, 1, 1)
        return self.push(Buffer(tensors=[report], pts=like.pts,
                                duration=like.duration))

    def _save(self) -> None:
        path = self._tprops.model_save_path
        if path and self._fw is not None:
            self._fw.save(path)

    def on_eos(self) -> None:
        if self._fw is not None and not self._complete:
            # partial training: still persist what we have (reference saves
            # at state change to READY)
            self._save()

    def get_property(self, key: str):
        if key in ("loss", "accuracy", "epoch") and self._fw is not None:
            s = self._fw.get_status()
            return {
                "loss": s["training_loss"],
                "accuracy": s["training_accuracy"],
                "epoch": s["epoch_count"],
            }[key]
        return super().get_property(key)
