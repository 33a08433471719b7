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

The device list is :func:`visible_devices`, the one place that decides
it: ``NNSTPU_TORCH_DEVICES`` when set (``cuda:0*8``, ``cpu*8``,
``cuda:0,cuda:1``: comma-separated devices, each optionally repeated
``*N`` times; the counterpart of ``--xla_force_host_platform_device_count``),
else every CUDA device, else the single-device view ``[cpu]``. It is read
on every call, never cached. A mesh built with no ``devices=`` takes that
list, but refuses the single-device CPU view: with no card and nothing
set, pass ``devices=``. The grammar functions (:func:`resolve_shard_axes`,
:func:`mesh_from_spec`, :func:`mesh_from_axes`) resolve exactly as the
reference's do.

Placement (the dp/tp filter path, ``filters/cuda_filter.py``): a batch
splits its leading rows over the dp axis (:func:`shard_batch`); a param
leaf splits its output-channel dim over the tp axis where
:func:`tp_leaf_sharded` says so and is replicated otherwise
(:func:`shard_params_for_tp`). A placed leaf is a :class:`PlacedLeaf`:
one torch tensor per mesh position, not a ``DTensor`` (that needs process
groups, which one process over repeated devices does not have). The
output-channel dim of a torch leaf is the first of a convolution's or a
linear layer's weight (the second of a transposed convolution's) and the
last of any other tensor, which is where the reference's flax layouts
(HWIO kernels, (in, out) dense weights, ``x @ w``) keep it; so the same
leaves split in both packages and the per-shard byte bills agree.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.buffer import as_torch

AXES = ("dp", "tp", "sp")

#: the device list every mesh, analyzer and memory plan of this package
#: reads (see the module docstring)
DEVICES_ENV = "NNSTPU_TORCH_DEVICES"


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


def parse_devices(spec: str) -> List[torch.device]:
    """``cuda:0*8`` / ``cpu*8`` / ``cuda:0,cuda:1`` → the device list."""
    out: List[torch.device] = []
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        name, _, count = item.partition("*")
        try:
            n = int(count) if count.strip() else 1
            dev = torch.device(name.strip())
        except (ValueError, RuntimeError) as e:
            raise ValueError(f"{DEVICES_ENV}={spec!r}: bad item {item!r} "
                             f"(want e.g. cuda:0*8, cpu*8 or cuda:0,cuda:1)"
                             ) from e
        if n < 1:
            raise ValueError(f"{DEVICES_ENV}={spec!r}: count {n} < 1")
        out.extend([dev] * n)
    if not out:
        raise ValueError(f"{DEVICES_ENV}={spec!r} names no device")
    return out


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def visible_devices() -> List[torch.device]:
    """The device list (see the module docstring): ``NNSTPU_TORCH_DEVICES``
    when set, else every CUDA device, else ``[cpu]``. Read anew on every
    call."""
    spec = os.environ.get(DEVICES_ENV, "").strip()
    if spec:
        return parse_devices(spec)
    n = _cuda_count()
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def visible_device_count() -> int:
    """``len(visible_devices())``: the count the shard and pool analyzers
    resolve a mesh or a replica count against."""
    return len(visible_devices())


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is not None:
        return list(devices)
    if not os.environ.get(DEVICES_ENV, "").strip() and _cuda_count() == 0:
        raise RuntimeError("no CUDA device visible: pass devices= (e.g. "
                           "[torch.device('cpu')] * n) or set "
                           f"{DEVICES_ENV} for a mesh on the CPU")
    return visible_devices()


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


# --------------------------------------------------------------------------
# placement (the dp/tp filter path)
# --------------------------------------------------------------------------

def mesh_positions(mesh: Mesh) -> List[Tuple[int, int]]:
    """The (dp, tp) positions of a (dp, tp, sp=1) mesh, row-major."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    return [(i, j) for i in range(dp) for j in range(tp)]


def position_device(mesh: Mesh, pos: Tuple[int, int]) -> torch.device:
    return mesh.devices[pos[0], pos[1], 0]


def row_device(mesh: Mesh, row: int) -> torch.device:
    """The device a dp row computes on: its first tp position (the
    activations replicate over tp, so one position computes them)."""
    return mesh.devices[row, 0, 0]


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """Place a batch onto the mesh, sharded over dp (leading axis): each
    tensor (or array) of ``batch`` — one, or a list or tuple of them —
    becomes a list of ``dp`` tensors, row group ``i`` on dp row ``i``'s
    device, copied non-blocking. The leading dim must divide by dp."""
    dp = mesh.shape["dp"]

    def place(x):
        t = as_torch(x)
        n = int(t.shape[0]) if t.dim() else 0
        if n % dp:
            raise ValueError(f"batch leading dim {n} does not divide the dp "
                             f"axis ({dp})")
        g = n // dp
        return [t[i * g:(i + 1) * g].to(row_device(mesh, i),
                                        non_blocking=True)
                for i in range(dp)]

    if isinstance(batch, (list, tuple)):
        return type(batch)(place(x) for x in batch)
    return place(batch)


def channel_dims(params: Any) -> Dict[str, int]:
    """State-dict key → output-channel dim of each leaf of ``params`` (a
    module, or a dict of tensors, whose channel dim is the last): 0 for a
    convolution's or a linear layer's weight, 1 for a transposed
    convolution's, -1 for every other leaf."""
    if not isinstance(params, torch.nn.Module):
        return {k: -1 for k in param_leaves(params)}
    out = {k: -1 for k in params.state_dict()}
    for name, m in params.named_modules():
        w = f"{name}.weight" if name else "weight"
        if w not in out:
            continue
        if isinstance(m, torch.nn.modules.conv._ConvTransposeNd):
            out[w] = 1
        elif isinstance(m, (torch.nn.modules.conv._ConvNd, torch.nn.Linear)):
            out[w] = 0
    return out


def param_leaves(params: Any) -> Dict[str, torch.Tensor]:
    """State-dict key → tensor of a module, or of a flat dict of tensors."""
    if isinstance(params, torch.nn.Module):
        return dict(params.state_dict())
    return {str(k): v for k, v in dict(params).items()}


def tp_leaf_sharded(leaf, tp: int, dim: int = -1) -> bool:
    """THE tp placement rule, as a predicate: does a tp axis of width
    ``tp`` SPLIT this param leaf along its output-channel dim ``dim`` (vs
    replicate it)? The single source the runtime placement
    (:func:`shard_params_for_tp`, :func:`param_shardings`) and the static
    per-shard byte bill (``analysis/shard.py``) both read."""
    return (tp > 1 and hasattr(leaf, "ndim") and leaf.ndim >= 2
            and leaf.shape[dim] >= 2 and leaf.shape[dim] % tp == 0)


def _param_spec(path: str, leaf, dim: int = -1) -> Tuple[Optional[str], ...]:
    """TP sharding spec of one leaf, as a PartitionSpec-like tuple: the
    output-channel dim ``dim`` of a weight matrix or kernel wide enough
    to split says ``'tp'``, every other dim None; a leaf that stays whole
    is ``()``. Callers gate it with :func:`tp_leaf_sharded`."""
    if hasattr(leaf, "ndim") and leaf.ndim >= 2 and leaf.shape[dim] >= 2:
        spec: List[Optional[str]] = [None] * leaf.ndim
        spec[dim % leaf.ndim] = "tp"
        return tuple(spec)
    return ()


@dataclass
class PlacedLeaf:
    """One param leaf over a (dp, tp) mesh: ``shards[i][j]`` is the
    tensor mesh position (i, j) holds — the whole leaf when ``dim`` is
    None (replicated), else its j-th slice along ``dim``."""

    shards: List[List[torch.Tensor]]
    dim: Optional[int]

    def gather(self, row: int, device: torch.device) -> torch.Tensor:
        """The whole leaf on ``device``, from dp row ``row``'s positions:
        their slices concatenated along ``dim`` (a fresh tensor the
        caller owns), or the replicated tensor itself."""
        parts = self.shards[row]
        if self.dim is None:
            return parts[0].to(device, non_blocking=True)
        return torch.cat([p.to(device, non_blocking=True) for p in parts],
                         dim=self.dim)

    def nbytes_at(self, pos: Tuple[int, int]) -> int:
        t = self.shards[pos[0]][pos[1]]
        return t.numel() * t.element_size()


def shard_params_for_tp(mesh: Mesh, params: Any) -> Dict[str, PlacedLeaf]:
    """Place a params tree (a module's state, or a dict of tensors) over
    the mesh with channel-dim tp sharding: a leaf the rule splits is cut
    into tp slices, slice j on every position (i, j); any other leaf is
    copied whole to every position. Replicated over dp either way."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    dims = channel_dims(params)
    out: Dict[str, PlacedLeaf] = {}
    for key, leaf in param_leaves(params).items():
        leaf = leaf.detach()
        dim = dims.get(key, -1)
        split = tp_leaf_sharded(leaf, tp, dim)
        d = dim % leaf.ndim if split else None
        parts = (list(torch.chunk(leaf, tp, dim=d)) if split
                 else [leaf] * tp)
        out[key] = PlacedLeaf(
            shards=[[parts[j].to(position_device(mesh, (i, j)),
                                 copy=True).contiguous()
                     for j in range(tp)] for i in range(dp)],
            dim=d)
    return out


def param_shardings(mesh: Mesh, params: Any) -> Dict[str, Tuple]:
    """The spec tree matching :func:`shard_params_for_tp`'s placement:
    state-dict key → the leaf's spec tuple (``()`` when replicated)."""
    tp = mesh.shape["tp"]
    dims = channel_dims(params)
    return {key: (_param_spec(key, leaf, dims.get(key, -1))
                  if tp_leaf_sharded(leaf, tp, dims.get(key, -1)) else ())
            for key, leaf in param_leaves(params).items()}
