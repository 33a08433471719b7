"""Runnable examples of the port, one per script of the repository's
``examples/`` (counterparts of ``examples/*.py``, which run the JAX
package), at each example's own sizes and lines:

    python -m nnstreamer_tpu_torch.examples.<name> [--device cpu]

``long_context``, ``classification``, ``detection``, ``query_offload``,
``training``, ``native_pipeline`` and ``tflite_models`` (which takes the
``.tflite`` path as its first argument). Every runner runs on the card;
``--device cpu`` asks for the CPU (``accelerator=true:cpu`` on the
filters, ``custom=device:cpu`` on the trainer, CPU tensors elsewhere).
``--params <npz>`` loads a state dict into the runners' zoo models in
place of their ``seed:0`` weights (``custom=params:<npz>``). Each
``main(argv)`` prints what its JAX counterpart prints and returns its
outputs. Importing a runner sets nothing and builds nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

DEVICES = ("cuda", "cpu")


def parse_args(argv: Optional[Sequence[str]]
               ) -> Tuple[str, Optional[str], List[str]]:
    """(device, params file or None, the other arguments in order) from
    ``argv`` (``sys.argv[1:]`` when None). The card is the default and
    must exist: without one a runner raises, it does not take the CPU."""
    import sys

    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    device, params, rest = "cuda", None, []
    while args:
        a = args.pop(0)
        if a in ("--device", "--params"):
            if not args:
                raise ValueError(f"{a} needs a value")
            v = args.pop(0)
            if a == "--params":
                params = v
            elif v not in DEVICES:
                raise ValueError(f"--device takes one of {DEVICES}, got {v!r}")
            else:
                device = v
        else:
            rest.append(a)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the runner runs on the card and torch sees no "
                           "CUDA device; say --device cpu for the CPU")
    return device, params, rest


def accelerator(device: str) -> str:
    """The tensor_filter property that puts its model on ``device``."""
    return "accelerator=true:cpu" if device == "cpu" else ""


def zoo_custom(custom: str, params: Optional[str]) -> str:
    """A zoo model's ``custom=``, its ``seed:`` replaced by ``params:``
    when a state file is given."""
    if params is None:
        return custom
    keep = [kv for kv in custom.split(",") if not kv.startswith("seed:")]
    return ",".join([f"params:{params}", *keep])
