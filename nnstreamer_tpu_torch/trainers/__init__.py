"""Trainer subplugin ABI — on-device training backends for tensor_trainer.

Parity: GstTensorTrainerFramework (nnstreamer_plugin_api_trainer.h:95-160:
create/destroy/start/stop/push_data/getStatus vtable), the trainer event
notifier (TRAINER_EVENT_EPOCH_COMPLETION / TRAINING_COMPLETION,
nnstreamer_plugin_api_trainer.h:66-73), and GstTensorTrainerProperties
(:31-48: model paths, sample/epoch counts, live loss/accuracy fields).

Counterpart of the JAX package's ``trainers/__init__.py``, copied with its
imports pointed at this package. A trainer is a Python class per backend;
``framework=jax`` (the JAX package's launch lines) and ``torch_cuda``
resolve to :mod:`trainers.cuda_trainer`, whose per-sample ``push_data``
feeds a host-side batcher whose flush is one torch train step
(:mod:`parallel.train`) on the card.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.analysis import lockwitness
from nnstreamer_tpu_torch.types import TensorsInfo


class TrainerEvent(enum.Enum):
    """TRAINER_EVENT_* (nnstreamer_plugin_api_trainer.h:66-73)."""

    EPOCH_COMPLETION = "epoch_completion"
    TRAINING_COMPLETION = "training_completion"


@dataclass
class TrainerProperties:
    """GstTensorTrainerProperties analogue (nnstreamer_plugin_api_trainer.h:31-48)."""

    input_meta: Optional[TensorsInfo] = None
    model_config: str = ""  # zoo name / .py file / backend config
    model_save_path: str = ""
    model_load_path: str = ""
    num_inputs: int = 1
    num_labels: int = 1
    num_training_samples: int = 0
    num_validation_samples: int = 0
    num_epochs: int = 1
    custom: Dict[str, str] = field(default_factory=dict)

    # live status written by the subplugin (getStatus parity)
    epoch_count: int = 0
    training_loss: float = 0.0
    training_accuracy: float = 0.0
    validation_loss: float = 0.0
    validation_accuracy: float = 0.0


class TrainerFramework:
    """Base class every trainer backend implements (the v1 vtable)."""

    NAME = ""

    def __init__(self):
        self.props: Optional[TrainerProperties] = None
        self._notify: Optional[Callable[[TrainerEvent], None]] = None
        self._lock = lockwitness.make_lock("trainer.state")

    # -- vtable -------------------------------------------------------------
    def create(self, props: TrainerProperties) -> None:
        """Build the model/optimizer (create, plugin_api_trainer.h:102)."""
        self.props = props

    def destroy(self) -> None:
        self.props = None
        self._notify = None

    def start(self, notify: Callable[[TrainerEvent], None]) -> None:
        """Begin training; ``notify`` delivers epoch/completion events back
        to the element (the event-notifier handle)."""
        self._notify = notify

    def stop(self) -> None:
        pass

    def push_data(self, tensors: Sequence[Any]) -> None:
        """One sample: ``num_inputs`` feature tensors then ``num_labels``
        label tensors, in buffer order (push_data parity)."""
        raise NotImplementedError

    def get_status(self) -> Dict[str, float]:
        """getStatus parity: live loss/accuracy/epoch counters."""
        p = self.props
        return {
            "epoch_count": p.epoch_count,
            "training_loss": p.training_loss,
            "training_accuracy": p.training_accuracy,
            "validation_loss": p.validation_loss,
            "validation_accuracy": p.validation_accuracy,
        }

    def save(self, path: str) -> None:
        """Persist the trained model (model_save_path write at EOS)."""
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    def emit(self, event: TrainerEvent) -> None:
        if self._notify is not None:
            self._notify(event)


def find_trainer(name: str) -> Optional[type]:
    return registry.get(registry.TRAINER, name)
