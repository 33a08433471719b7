"""Device meshes (counterpart of the JAX package's ``parallel/mesh.py``).

Axes convention, as the reference's:
  dp — data (batch) parallel
  tp — tensor (channel) parallel
  sp — sequence parallel (long-context: ``ops.attention.ring_attention``
       and ``ulysses_attention`` shard the sequence over it)

A :class:`Mesh` is a grid of ``torch.device``s that one process drives:
the sequence-parallel functions split their tensors onto the devices of an
axis and move shards between them with device-to-device copies. A device
may appear more than once. That is this package's counterpart of the
reference's virtual host devices (``--xla_force_host_platform_device_count``):
``make_mesh(sp=8, devices=[torch.device("cpu")] * 8)`` is the CPU tests'
mesh, and ``make_mesh(sp=4, devices=[torch.device("cuda", 0)] * 4)`` runs a
real four-shard ring on one card, where moving a shard between two places
on the same device is passing the tensor along.

The default devices are every visible CUDA device; with no card the caller
must pass ``devices=``. The grammar functions (:func:`resolve_shard_axes`,
:func:`mesh_from_spec`, :func:`mesh_from_axes`) resolve exactly as the
reference's do; the placement functions of its dp/tp filter path
(``shard_batch``, ``shard_params_for_tp``, ``param_shardings``,
``tp_leaf_sharded``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("dp", "tp", "sp")


class Mesh:
    """A numpy object array of ``torch.device``s with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis_name: str) -> List[torch.device]:
        """The devices along ``axis_name``, every other axis at index 0.
        In the reference a shard_map over one axis replicates the work over
        the others; one replica gives the same result."""
        i = self.axis_names.index(axis_name)
        return list(np.moveaxis(self.devices, i, -1).reshape(
            -1, self.devices.shape[i])[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def _device_array(devs: Sequence[torch.device], shape: Tuple[int, ...]):
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return arr.reshape(shape)


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none (pass
    ``devices=`` to build a mesh on the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device visible: pass devices= (e.g. "
                           "[torch.device('cpu')] * n) for a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    return list(devices) if devices is not None else visible_devices()


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: int = 1,
    sp: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (dp, tp, sp) mesh. dp defaults to filling remaining devices."""
    devs = _devices(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if dp is None:
        if n % (tp * sp) != 0:
            raise ValueError(f"{n} devices not divisible by tp*sp={tp * sp}")
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"dp*tp*sp={dp * tp * sp} != {n} devices")
    return Mesh(_device_array(devs, (dp, tp, sp)))


def mesh_from_spec(spec: dict, devices: Optional[Sequence] = None) -> Mesh:
    """Inference-shard recipe → mesh.

    spec: {"mode": "dp|tp|dpxtp", "shard_devices": N (0 = all),
    "tp_devices": T (dpxtp only, default 2)}."""
    devs = _devices(devices)
    n = int(spec.get("shard_devices") or 0)
    if n:
        devs = devs[:n]
    mode = spec["mode"]
    if mode == "dp":
        dp_n, tp_n = len(devs), 1
    elif mode == "tp":
        dp_n, tp_n = 1, len(devs)
    elif mode == "dpxtp":
        raw = spec.get("tp_devices")
        # explicit-but-invalid values (0, negatives) must raise, not
        # silently coerce to the default
        tp_n = 2 if raw is None else int(raw)
        if tp_n < 1:
            raise ValueError(f"shard:dpxtp needs tp_devices >= 1, got {tp_n}")
        if len(devs) % tp_n:
            raise ValueError(
                f"shard:dpxtp with tp_devices:{tp_n} needs a device count "
                f"divisible by {tp_n}, got {len(devs)}"
            )
        dp_n = len(devs) // tp_n
    else:
        raise ValueError(f"unknown shard mode {mode!r} (supported: dp, tp, dpxtp)")
    return make_mesh(devices=devs, dp=dp_n, tp=tp_n, sp=1)


def resolve_shard_axes(mode: str, mesh: str, n_devices: int) -> Tuple[int, int]:
    """``tensor_filter shard=<mode> mesh=AxB`` → the (dp, tp) axis sizes,
    resolved against ``n_devices`` visible devices.

    ``mesh`` spellings: ``AxB`` (dp x tp), a bare ``N`` (the mode's own
    axis), or empty (all visible devices: dp→Nx1, tp→1xN, dpxtp→(N/2)x2).
    Raises ``ValueError`` with the human reason when unsatisfiable."""
    mode = str(mode or "").strip().lower()
    if mode not in ("dp", "tp", "dpxtp"):
        raise ValueError(f"unknown shard mode {mode!r} (dp, tp, dpxtp)")
    s = str(mesh or "").strip().lower()
    if s:
        parts = s.split("x")
        try:
            axes = [int(p) for p in parts]
        except ValueError:
            raise ValueError(
                f"mesh={mesh!r} is not AxB (two positive ints, e.g. 4x2)")
        if len(axes) == 1:
            # bare N sizes the mode's own axis
            axes = [axes[0], 1] if mode == "dp" else [1, axes[0]]
        if len(axes) != 2 or any(a < 1 for a in axes):
            raise ValueError(
                f"mesh={mesh!r} is not AxB (two positive ints, e.g. 4x2)")
        dp, tp = axes
    else:
        if n_devices < 2:
            raise ValueError(
                f"only {n_devices} device(s) visible — a mesh needs >= 2")
        if mode == "dp":
            dp, tp = n_devices, 1
        elif mode == "tp":
            dp, tp = 1, n_devices
        else:
            if n_devices % 2:
                raise ValueError(
                    f"shard=dpxtp with no mesh= needs an even device "
                    f"count, got {n_devices} (say mesh=AxB)")
            dp, tp = n_devices // 2, 2
    # the axes must agree with the mode (a dp mesh with tp>1 would
    # silently shard params the user never asked to split)
    if mode == "dp" and tp != 1:
        raise ValueError(f"shard=dp wants mesh=Ax1, got {dp}x{tp}")
    if mode == "tp" and dp != 1:
        raise ValueError(f"shard=tp wants mesh=1xB, got {dp}x{tp}")
    if mode == "dpxtp" and (dp < 2 or tp < 2):
        raise ValueError(
            f"shard=dpxtp wants both axes >= 2, got {dp}x{tp} "
            f"(use shard=dp or shard=tp for a 1-axis mesh)")
    if dp * tp < 2:
        raise ValueError(f"mesh {dp}x{tp} is a single device — nothing "
                         f"to shard")
    if dp * tp > n_devices:
        raise ValueError(
            f"mesh {dp}x{tp} needs {dp * tp} devices but only "
            f"{n_devices} visible")
    return dp, tp


def mesh_from_axes(dp: int, tp: int, devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, tp, sp=1) Mesh over the first dp*tp devices, in order (the
    reference's topology-blind reshape; no placement probe)."""
    devs = _devices(devices)[: dp * tp]
    if len(devs) < dp * tp:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have "
                         f"{len(devs)}")
    return Mesh(_device_array(devs, (dp, tp, 1)))
