"""Model zoo for the torch/CUDA filter backend (counterpart of the JAX
package's ``models/__init__.py``).

A model is an ``nn.Module`` whose weights are placed on the device once,
when the bundle is built, plus an ``apply_fn(*inputs) -> output`` the
filter calls per buffer. The zoo registers builders by name so pipelines
can say ``tensor_filter framework=jax model=mobilenet_v2`` (the JAX
package's launch lines run unchanged). Weights come from
``custom=params:<path>`` (a saved state dict: an ``.npz`` carried across
from the JAX package by :mod:`models.convert`, or what the trainer saved,
a file or a directory holding one) or are made from ``custom=seed:<n>``
with numpy. :func:`load_py_model` loads an embedded-Python model file.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.types import TensorsInfo

_zoo: Dict[str, Callable[..., "ModelBundle"]] = {}


@dataclass
class ModelBundle:
    """Everything the filter backend needs to run a model."""

    apply_fn: Callable  # apply_fn(*inputs) -> output tensor or tuple
    module: torch.nn.Module  # weights, already on the bundle's device
    input_info: Optional[TensorsInfo] = None
    output_info: Optional[TensorsInfo] = None
    #: output info for a proposed input info (the counterpart of the JAX
    #: backend's jax.eval_shape probe) — computed from shapes, no launch
    infer_output: Optional[Callable[[TensorsInfo], TensorsInfo]] = None
    #: training-mode forward ``train_apply_fn(x) -> (logits, new_state)``
    #: for models with BatchNorm: the batch's statistics normalize, and
    #: ``new_state`` holds the running statistics after flax's EMA as
    #: (buffer, value) pairs that the train step writes after the
    #: optimizer's update, as the JAX package's train apply returns new
    #: ``batch_stats`` beside its output (so gradients reach parameters
    #: only). None where the trainer differentiates ``apply_fn``.
    train_apply_fn: Optional[Callable] = None
    #: ``folded() -> (state, recipe)``: the state the forward computes
    #: with as flat tensors (BatchNorm folded and cast where the forward
    #: folds) and the JSON recipe :func:`restore_folded` rebuilds the
    #: forward from. None where the forward reads the module as built
    #: (the compile cache, filters/aot.py, then keeps the state dict)
    folded: Optional[Callable[[], tuple]] = None
    #: the recipe of a bundle rebuilt by :func:`restore_folded` (its module
    #: is a :class:`FoldedState`), else None
    recipe: Optional[dict] = None


def register_model(name: str):
    """Decorator: register ``builder(custom: dict, device) -> ModelBundle``."""

    def deco(builder):
        _zoo[name.lower()] = builder
        return builder

    return deco


def _load_builtins() -> None:
    import importlib

    for mod in ("mobilenet_v2", "ssd_mobilenet", "deeplab_v3", "posenet",
                "yolov8", "vit", "simple"):
        importlib.import_module(f"nnstreamer_tpu_torch.models.{mod}")


#: the file a saved state dict takes inside a checkpoint directory
STATE_FILE = "state.npz"


def save_state(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a state dict (parameters and running statistics) as an npz,
    one array per key: to exactly ``path`` when it has an extension, else
    into a directory ``path`` holding :data:`STATE_FILE` (the JAX
    trainer's msgpack file and orbax directory, in one format)."""
    if not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, STATE_FILE)
    arrays = {k: v.detach().cpu().numpy() for k, v in state.items()}
    # through a file object: np.savez appends .npz to a name without it
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def read_state(path: str) -> Dict[str, torch.Tensor]:
    """A state dict written by :func:`save_state` (a file, or a directory
    holding :data:`STATE_FILE`)."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k])) for k in z.files}


#: the state a zoo build function takes instead of its own
#: (see :func:`build_with_state`)
_given = threading.local()

#: :data:`_given`'s state that means "no weights at all": the skeleton
#: build (:func:`skeleton_bundle`) leaves the meta module uninitialised
_SKELETON = object()


def load_or_init(module: torch.nn.Module, custom: Dict[str, str],
                 init_fn: Callable[[torch.nn.Module, int], None]) -> None:
    """Shared builder plumbing: weights from a saved state dict
    (``custom=params:<path>``, see :func:`read_state`) or deterministic
    numpy init from ``custom=seed:<n>`` — or, inside
    :func:`build_with_state`, that call's state, assigned as it is."""
    given = getattr(_given, "state", None)
    if given is _SKELETON:
        return
    if given is not None:
        module.load_state_dict(given, assign=True)
        return
    params_path = custom.get("params")
    if params_path:
        module.load_state_dict(read_state(params_path))
    else:
        init_fn(module, int(custom.get("seed", 0)))


def weights_version(module: torch.nn.Module) -> int:
    """How many times a trainer changed ``module``'s weights or running
    statistics (see :func:`weights_changed`); 0 for a module as built."""
    return getattr(module, "_weights_version", 0)


def weights_changed(module: torch.nn.Module) -> None:
    """Record that ``module``'s weights changed in place (a train step, a
    restore): a forward that folded them refolds before its next call."""
    module._weights_version = weights_version(module) + 1


#: momentum of flax's ``nn.BatchNorm``, which the JAX zoo trains with
BN_MOMENTUM = 0.99

#: the calling thread's BatchNorm reduction (see :func:`reduced_batch_stats`)
_bn_reduce = threading.local()


@contextlib.contextmanager
def reduced_batch_stats(fn):
    """Within the block, :func:`batch_norm_train` on this thread takes its
    statistics through ``fn(Σx, Σx², count) -> (Σx, Σx², count)``, the
    sums over every row group of a dp mesh (``parallel/train.py``)."""
    prev = getattr(_bn_reduce, "fn", None)
    _bn_reduce.fn = fn
    try:
        yield
    finally:
        _bn_reduce.fn = prev


def batch_norm_train(y: torch.Tensor, bn: torch.nn.BatchNorm2d,
                     dtype: torch.dtype, new_state: list,
                     momentum: float = BN_MOMENTUM) -> torch.Tensor:
    """Train-mode BatchNorm of an NCHW tensor as flax computes it
    (``nn.BatchNorm(use_running_average=False)``, ``use_fast_variance``):
    the batch's mean and variance in float32 (float64 for a float64
    tensor) over (N, H, W), the variance as E[x²] − E[x]² clipped at 0
    (biased), ``(x − mean) · rsqrt(var + eps) · scale + bias`` in that
    type, rounded once to ``dtype``. The
    running statistics' update, ``ra = momentum · ra + (1 − momentum) ·
    batch`` with that same biased variance, is appended to ``new_state``
    as (buffer, value) pairs, computed without gradient.

    Not ``F.batch_norm(training=True)``: its momentum is the batch's
    weight, and it updates ``running_var`` with the unbiased variance.

    Inside :func:`reduced_batch_stats` (a dp mesh's row, ``parallel/
    train.py``) the statistics are the whole batch's, as GSPMD takes them:
    this row group's Σx, Σx² and count, summed over every row group
    before the division, with autograd through the sums."""
    x = y if y.dtype == torch.float64 else y.float()
    reduce_stats = getattr(_bn_reduce, "fn", None)
    if reduce_stats is None:
        mean = x.mean(dim=(0, 2, 3))
        sq = (x * x).mean(dim=(0, 2, 3))
    else:
        s1, s2, n = reduce_stats(x.sum(dim=(0, 2, 3)),
                                 (x * x).sum(dim=(0, 2, 3)),
                                 x.numel() // x.shape[1])
        mean, sq = s1 / n, s2 / n
    var = torch.clamp(sq - mean * mean, min=0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    out = ((x - mean.reshape(1, -1, 1, 1)) * mul.reshape(1, -1, 1, 1)
           + bn.bias.reshape(1, -1, 1, 1))
    with torch.no_grad():
        new_state.append((bn.running_mean, momentum * bn.running_mean
                          + (1.0 - momentum) * mean))
        new_state.append((bn.running_var, momentum * bn.running_var
                          + (1.0 - momentum) * var))
    return out.to(dtype)


def init_conv_bn(module: torch.nn.Module, seed: int) -> None:
    """Deterministic weights from ``np.random.default_rng(seed)`` for a
    model of convolutions and BatchNorms, module by module in registration
    order: He-normal conv kernels (fan-in over the conv's group), conv
    biases N(0, 0.1), BatchNorm scale, bias and running statistics that
    are not the identity (as MobileNet-v2's ``init_weights``). A model
    sets its heads' biases afterwards where it wants a prior.

    Like every ``seed:`` init of this package it does NOT reproduce the
    JAX package's flax init: carry flax variables across with
    :mod:`models.convert` to run both packages on the same weights."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                shape = tuple(m.weight.shape)
                fan_in = int(np.prod(shape[1:]))
                m.weight.copy_(torch.from_numpy(rng.normal(
                    0.0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)))
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(rng.normal(
                        0.0, 0.1, m.bias.shape).astype(np.float32)))
            elif isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, a in ((m.weight, rng.uniform(0.8, 1.2, n)),
                             (m.bias, rng.normal(0.0, 0.1, n)),
                             (m.running_mean, rng.normal(0.0, 0.1, n)),
                             (m.running_var, rng.uniform(0.8, 1.2, n))):
                    t.copy_(torch.from_numpy(a.astype(np.float32)))


def batch_of(info: TensorsInfo) -> int:
    """The batch of frames a model's input info carries: the leading dim
    of an [B, H, W, C] tensor, 1 for one [H, W, C] frame."""
    shape = info.tensors[0].np_shape()
    return shape[0] if len(shape) == 4 else 1


def preprocess_frames(x: torch.Tensor, scale: str = "pm1",
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Shared frame preprocessing: uint8 normalization (``scale``: 'pm1' →
    [-1, 1); 'unit' → [0, 1)) and batch-dim fixup.

    A uint8 CUDA tensor goes through the ``normalize_u8`` kernel, which
    writes the compute dtype directly; a CPU tensor computes the JAX
    package's expression as written, in float32."""
    if x.dtype == torch.uint8:
        if x.is_cuda:
            from nnstreamer_tpu_torch.ops.preprocess import normalize_u8

            scale_v, offset = ((1.0 / 127.5, -1.0) if scale == "pm1"
                               else (1.0 / 255.0, 0.0))
            x = normalize_u8(x, scale=scale_v, offset=offset,
                             out_dtype=compute_dtype)
        else:
            x = (x.to(torch.float32) / 127.5 - 1.0 if scale == "pm1"
                 else x.to(torch.float32) / 255.0)
    if x.dim() == 3:
        x = x[None]
    return x


def resolve_fused_apply(custom: Dict[str, str], model, make_fused,
                        scale: str = "pm1"):
    """Shared ``custom=fused:pallas|xla`` wiring: ``pallas`` runs the
    BN-folded forward through the package's CUDA kernels (``make_fused``
    mode 'kernel'), ``xla`` the same folded forward as the JAX package's
    ``fused:xla`` computes it, outside any kernel (mode 'xla'). BN folds
    here (at open); MobileNet-v2's, the zoo model the trainer takes,
    folds again after a trainer changed the weights
    (:func:`weights_changed`). Returns None when the custom key is
    absent."""
    fused = custom.get("fused")
    if fused is None:
        return None
    if fused not in ("pallas", "xla"):
        raise ValueError(f"unknown fused mode {fused!r} (use fused:pallas "
                         "or fused:xla)")
    if getattr(_given, "state", None) is _SKELETON:
        return _skeleton_forward  # nothing to fold: no weights
    raw = make_fused(model, mode="kernel" if fused == "pallas" else "xla")

    def apply_fn(x):
        return raw(preprocess_frames(x, scale, model.dtype))

    if hasattr(raw, "folded"):
        apply_fn.folded = raw.folded
    return apply_fn


class ParamTree(torch.nn.Module):
    """An embedded-Python model's (nested) dict of tensors as a module:
    each floating leaf a parameter under its key, any other leaf a buffer,
    each nested dict a child. :meth:`tree` gives the dict back, holding
    the module's own tensors, so ``.to(device)``, ``state_dict`` and an
    optimizer over ``parameters()`` all see the model's weights."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if not isinstance(k, str) or not k or "." in k:
                raise ValueError(f"model params key {k!r}: keys are "
                                 "non-empty strings without '.'")
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
                continue
            t = torch.as_tensor(v).detach().clone()
            if t.is_floating_point():
                self.register_parameter(k, torch.nn.Parameter(t))
            else:
                self.register_buffer(k, t)

    def tree(self) -> Dict[str, Any]:
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            out[k] = v.tree() if isinstance(v, ParamTree) else v
        return out


def _meta_infer(fn: Callable, module: ParamTree):
    """Output info for a proposed input info, by running ``fn`` on meta
    tensors (shapes and dtypes only, no data, no launch)."""
    from nnstreamer_tpu_torch.buffer import dtype_name
    from nnstreamer_tpu_torch.ops.fusion_stages import _torch_dtype
    from nnstreamer_tpu_torch.types import TensorInfo

    def infer(info: TensorsInfo) -> TensorsInfo:
        params = _to_meta(module.tree())
        xs = [torch.empty(t.np_shape(), device="meta",
                          dtype=_torch_dtype(t.dtype.np_dtype))
              for t in info.tensors]
        with torch.no_grad():
            out = fn(params, *xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return TensorsInfo(tensors=[
            TensorInfo.from_np_shape(tuple(o.shape), dtype_name(o))
            for o in outs])

    return infer


def _to_meta(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _to_meta(v) if isinstance(v, dict) else v.detach().to("meta")
            for k, v in tree.items()}


def load_py_model(path: str, custom: Dict[str, str],
                  device="cuda") -> ModelBundle:
    """Embedded-Python model file (the JAX filter's ``_load_py_model``,
    tensor_filter_python3 parity): the file defines ``make_model(custom)``
    returning a :class:`ModelBundle`, or ``(apply_fn, params[, in_info[,
    out_info]])`` with ``apply_fn(params, *inputs)`` a torch function and
    ``params`` a (nested) dict of tensors or arrays. The params become a
    :class:`ParamTree` on ``device``; ``custom=params:<path>`` replaces
    them with a saved state (:func:`read_state`)."""
    import importlib.util

    name = os.path.basename(path).removesuffix(".py")
    spec = importlib.util.spec_from_file_location(f"nns_torch_model_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "make_model"):
        raise ValueError(f"{path} must define make_model(custom)")
    res = mod.make_model(custom)
    if isinstance(res, ModelBundle):
        return res
    fn, params = res[0], res[1]
    module = ParamTree(params or {})
    given = getattr(_given, "state", None)
    if given is _SKELETON:
        pass
    elif given is not None:
        module.load_state_dict(given, assign=True)
    elif custom.get("params"):
        module.load_state_dict(read_state(custom["params"]))
    module = module.to(torch.device(device))

    def apply_fn(*xs):
        return fn(module.tree(), *xs)

    return ModelBundle(apply_fn=apply_fn, module=module,
                       input_info=res[2] if len(res) > 2 else None,
                       output_info=res[3] if len(res) > 3 else None,
                       infer_output=_meta_infer(fn, module))


def build_bundle(model: str, custom: Dict[str, str],
                 device="cuda") -> ModelBundle:
    """The bundle of a model source on ``device``: an embedded-Python
    ``.py`` file, a checkpoint file (what :func:`save_state` wrote) of the
    zoo model ``custom=arch:<zoo-name>`` names (the JAX backend's
    ``.msgpack`` + ``arch:``), or a zoo name."""
    if str(model).endswith(".py"):
        return load_py_model(model, custom, device)
    arch = custom.get("arch")
    if arch:
        return get_model(arch, dict(custom, params=model), device)
    if "." in os.path.basename(str(model)):
        raise ValueError(f"model {model!r}: the torch_cuda backend runs "
                         "zoo models (weights via custom=params:<path>), "
                         "checkpoint files with custom=arch:<zoo-name> and "
                         ".py model files")
    return get_model(model, custom, device)


def build_with_state(model: str, custom: Dict[str, str], device,
                     state: Mapping[str, torch.Tensor]) -> ModelBundle:
    """The bundle of ``model`` (see :func:`build_bundle`) built on
    ``device`` with ``state`` as its weights: the tensors are assigned to
    the module, not copied, so a state already on ``device`` is used in
    place (the mesh path's per-position copies and its per-invoke gathered
    weights, filters/cuda_filter.py). No seed init runs and no checkpoint
    is read."""
    _given.state = state
    try:
        return build_bundle(model, custom, device)
    finally:
        _given.state = None


def skeleton_bundle(model: str, custom: Dict[str, str]) -> ModelBundle:
    """The bundle of ``model`` on the ``meta`` device with no weights: no
    seed draw, no checkpoint read, no fold of real data. Its input and
    output info and ``infer_output`` answer negotiation; its forward
    computes nothing (the filter's stand-in until a compile-cache entry
    or an in-process build supplies the real program)."""
    _given.state = _SKELETON
    try:
        with torch.device("meta"):
            return build_bundle(model, custom, torch.device("meta"))
    finally:
        _given.state = None


def _skeleton_forward(*xs):
    raise RuntimeError("a skeleton bundle (models.skeleton_bundle) has no "
                       "weights to run")


class FoldedState(torch.nn.Module):
    """The module of a bundle rebuilt from a folded state: each tensor a
    buffer (``.`` in a name becomes ``__``). :meth:`tensors` gives the
    state back under its own names."""

    def __init__(self, state: Mapping[str, torch.Tensor]):
        super().__init__()
        self._names = list(state)
        for k, v in state.items():
            self.register_buffer(k.replace(".", "__"), v)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k.replace(".", "__")) for k in self._names}

    @staticmethod
    def unflatten(state: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """A state dict of this module under the folded state's own names
        (they hold no ``__``)."""
        return {k.replace("__", "."): v for k, v in state.items()}


def restore_folded(recipe: dict, state: Mapping[str, torch.Tensor],
                   custom: Dict[str, str], device) -> ModelBundle:
    """The bundle a :attr:`ModelBundle.folded` state and recipe describe,
    on ``device`` (the state's tensors are used as given: move them
    first). Its ``recipe`` is set, its module is a :class:`FoldedState`,
    and it folds nothing."""
    if recipe.get("kind") != "mobilenet_v2":
        raise ValueError(f"no restore for folded state kind "
                         f"{recipe.get('kind')!r}")
    from nnstreamer_tpu_torch.models.mobilenet_v2 import restore

    bundle = restore(dict(state), recipe, custom, torch.device(device))
    bundle.recipe = dict(recipe)
    return bundle


def get_model(name: str, custom: Optional[Dict[str, str]] = None,
              device="cuda") -> ModelBundle:
    name = name.lower()
    if name not in _zoo:
        _load_builtins()
    if name not in _zoo:
        raise ValueError(f"unknown model {name!r}; zoo: {sorted(_zoo)}")
    return _zoo[name](custom or {}, torch.device(device))
