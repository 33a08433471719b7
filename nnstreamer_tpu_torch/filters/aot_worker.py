"""The compile cache's worker — ``python -m
nnstreamer_tpu_torch.filters.aot_worker`` (counterpart of the JAX
package's ``filters/aot_worker.py``).

Reads a JSON spec on stdin::

    {"model": "...", "custom": "...", "shapes": [[[128,224,224,3],"uint8"]],
     "device": "cuda:0", "out": "/path/<key>.nnstpu-torch",
     "spec": {"stages_pre": [...], "stages_post": [...],
              "chain": [["stages", [...]], ["model", {...}]],
              "loop_window": 8, "launch_depth": 2,
              "placement": "replica", "serve_batch": [...],
              "device_index": 0, "donate": true},
     "shard": {"mode": "dp", "shard_devices": 4, "tp_devices": 1}}

and builds the state of the program the filter would run: the same
model source (zoo name, checkpoint + ``arch:``, ``.py`` file), built on
the device the parent named, with its BatchNorms folded and cast there;
each model of the spec's chain the same way. It restores those models
from the entry it is about to write, as the parent will; the spec's
fused stages, window and placement are key dimensions and meta only, as
the filter composes around the loaded models with its own code. A mesh
(``shard``) is checked over ``NNSTPU_TORCH_DEVICES``. On the card it
first builds the kernel library when ``build/torch_kernels/<hash>/``
lacks it. Then it writes the entry atomically (filters/aot.py
``write_entry``) and prints one JSON line: the milliseconds of its
kernel build, fold, check and write (:func:`build` is the same work in
the calling process).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _state_of(bundle):
    """(form, recipe, tensors) of a bundle: the folded state where the
    forward folds (``bundle.folded``), else the module's state dict, else
    nothing (a model without weights)."""
    if bundle.folded is not None:
        flat, recipe = bundle.folded()
        return "folded", recipe, dict(flat)
    state = dict(bundle.module.state_dict()) if bundle.module is not None \
        else {}
    if state:
        return "state", None, state
    return "none", None, {}


def _sig_line(kind: str, dtype, shape) -> str:
    from nnstreamer_tpu_torch.filters.sig_tokens import token_of

    try:
        tok = token_of(dtype)
    except (TypeError, ValueError):  # a dtype numpy has no name for
        tok = str(dtype)
    return f"{kind} {tok} {len(shape)} " + " ".join(str(d) for d in shape)


def _outputs(head, custom, shapes, cspec) -> list:
    """(shape, dtype) of each output of a solo or pre-staged program, from
    the model's own shape rule and the postproc's; empty where a chain or
    a post-stage follows (the estimate then leaves the outputs out, as
    the JAX worker's does when its eval_shape fails). Nothing runs: a
    run on ``meta`` tensors would import torch's compiler stack, seconds
    of the child's life."""
    from nnstreamer_tpu_torch.filters.cuda_filter import _postproc_info
    from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

    if cspec.get("chain") or cspec.get("stages_post") \
            or head.infer_output is None:
        return []
    info = TensorsInfo(tensors=[TensorInfo.from_np_shape(tuple(s.shape),
                                                         s.dtype.name)
                                for s in shapes])
    if cspec.get("stages_pre"):  # the preamble's arith stages: float32
        info = TensorsInfo(tensors=[TensorInfo.from_np_shape(
            t.np_shape(), "float32") for t in info.tensors])
    try:
        out = _postproc_info(custom.get("postproc"),
                             head.infer_output(info))
    except Exception:  # noqa: BLE001 — no shape rule for this input
        return []
    return [(tuple(t.np_shape()), np.dtype(t.dtype.np_dtype).name)
            for t in out.tensors]


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors.values()))


def build(spec: dict) -> dict:
    """Build, check and write the entry ``spec`` describes; returns the
    worker's report (milliseconds of its phases, the entry's bytes).
    :func:`main` runs it in the child process."""
    import torch

    from nnstreamer_tpu_torch.analysis.costmodel import ShapeDtype
    from nnstreamer_tpu_torch.filters import aot
    from nnstreamer_tpu_torch.models import build_bundle

    t0 = time.perf_counter()
    device = torch.device(spec["device"])
    built_kernels = False
    if device.type == "cuda":
        from nnstreamer_tpu_torch.ops import _cuda

        if device.index is None:  # the parent's "cuda": its current card
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        built_kernels = _cuda._lib is None and not _cuda.library_built()
        _cuda.lib()  # the parent then finds the library built
    t_kernels = time.perf_counter()
    custom_str = spec["custom"]
    # the SAME parser the filter uses — a divergent parse would cache a
    # program that silently differs from the in-process one
    custom = aot.custom_dict(custom_str)
    cspec = spec.get("spec") or {}
    shapes = [ShapeDtype(tuple(s), np.dtype(d)) for s, d in spec["shapes"]]

    arrays, programs = {}, {}
    head = build_bundle(spec["model"], custom, device)
    form, recipe, state = _state_of(head)
    programs["head"] = {"form": form, "recipe": recipe}
    arrays.update({f"head/{k}": v for k, v in state.items()})
    for i, (kind, payload) in enumerate(cspec.get("chain") or []):
        if kind != "model":
            continue
        tail = build_bundle(payload["model"],
                            aot.custom_dict(payload.get("custom", "")),
                            device)
        form, recipe, state = _state_of(tail)
        programs[f"chain.{i}"] = {"form": form, "recipe": recipe}
        arrays.update({f"chain.{i}/{k}": v for k, v in state.items()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_fold = time.perf_counter()

    # the entry restores into the models the parent will load, before
    # it is written
    meta = {"model": spec["model"], "custom": custom_str,
            "shapes": spec["shapes"], "spec": cspec,
            "shard": spec.get("shard"), "programs": programs,
            "device": str(device)}
    aot.Program(meta, arrays, device)
    outs = _outputs(head, custom, shapes, cspec)
    t_check = time.perf_counter()
    shard = spec.get("shard")
    if shard:
        from nnstreamer_tpu_torch.parallel.mesh import (
            mesh_from_spec,
            visible_devices,
        )

        devs = visible_devices()[:int(shard["shard_devices"])]
        mesh = mesh_from_spec(shard, devs)
        dp = mesh.shape["dp"]
        lead = int(shapes[0].shape[0]) if shapes and shapes[0].shape else 0
        if dp > 1 and lead % dp:
            raise ValueError(f"batch {lead} does not divide the dp axis {dp}")

    # footprint estimate for the parent's memplan hit gate: the state,
    # the inputs and the outputs (where the shapes say them)
    hbm = _nbytes(arrays) + sum(
        int(np.prod(s, dtype=np.int64)) * np.dtype(d).itemsize
        for s, d in [(x.shape, x.dtype) for x in shapes] + outs)
    # the signature as the native sidecar spells it (sig_tokens)
    sig = [_sig_line("in", x.dtype, x.shape) for x in shapes]
    sig += [_sig_line("out", d, s) for s, d in outs]
    meta.update(hbm_bytes=int(hbm), created=time.time(), sig=sig,
                parent_hbm_bytes=spec.get("hbm_bytes"))
    aot.write_entry(spec["out"], arrays, meta)
    t_end = time.perf_counter()
    return {"kernels_ms": (t_kernels - t0) * 1e3,
            "built_kernels": built_kernels,
            "fold_ms": (t_fold - t_kernels) * 1e3,
            "check_ms": (t_check - t_fold) * 1e3,
            "write_ms": (t_end - t_check) * 1e3,
            "worker_ms": (t_end - t0) * 1e3,
            "bytes": _nbytes(arrays)}


def build_frozen(spec: dict) -> dict:
    """The native program ``spec`` describes (``"freeze": true``): the
    forward traced on the spec's device (through the kernels' TorchScript
    ops on a card, their plain versions on the CPU), frozen, saved to
    ``spec["out"]`` with its signature sidecar beside it, both atomically.
    Returns the worker's report."""
    import torch

    from nnstreamer_tpu_torch.filters import aot
    from nnstreamer_tpu_torch.filters.cuda_filter import make_postproc
    from nnstreamer_tpu_torch.filters.sig_tokens import TOKEN_OF_NP
    from nnstreamer_tpu_torch.models import build_bundle

    t0 = time.perf_counter()
    device = torch.device(spec["device"])
    if device.type == "cuda":
        from nnstreamer_tpu_torch.ops import _script_ops

        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        _script_ops.load()  # the kernel library and the op library
    t_kernels = time.perf_counter()
    custom = aot.custom_dict(spec["custom"])
    bundle = build_bundle(spec["model"], custom, device)
    apply_fn, post = bundle.apply_fn, make_postproc(custom)

    class Program(torch.nn.Module):
        """The forward as the filter runs it: the model, then its
        postproc. Its tensors are the forward's, which the trace records
        as constants."""

        def forward(self, *xs):
            out = apply_fn(*xs)
            return post(out) if post is not None else out

    rng = np.random.default_rng(0)
    xs = []
    for shape, dt in spec["shapes"]:
        a = (rng.integers(0, 256, shape) if np.dtype(dt).kind in "ui"
             else rng.normal(size=shape)).astype(dt)
        xs.append(torch.from_numpy(a).to(device))
    with torch.no_grad(), aot.quiet_jit():
        traced = torch.jit.trace(Program(), tuple(xs), check_trace=False)
        frozen = torch.jit.freeze(traced.eval(), optimize_numerics=False)
        outs = frozen(*xs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_trace = time.perf_counter()
    out = spec["out"]
    tmp = f"{out}.tmp.{os.getpid()}"
    with aot.quiet_jit():
        torch.jit.save(frozen, tmp)
    sig = ["nnstpu-pjrt-sig v1"]
    sig += [_sig_line("in", np.dtype(dt), shape)
            for shape, dt in spec["shapes"]]
    sig += ["out %s %d %s" % (TOKEN_OF_NP[str(o.dtype).split(".")[-1]],
                              o.dim(), " ".join(str(d) for d in o.shape))
            for o in outs]
    with open(f"{out}.sig.tmp.{os.getpid()}", "w") as f:
        f.write("\n".join(sig) + "\n")
    os.replace(tmp, out)
    os.replace(f"{out}.sig.tmp.{os.getpid()}", f"{out}.sig")
    t_end = time.perf_counter()
    return {"kernels_ms": (t_kernels - t0) * 1e3,
            "trace_ms": (t_trace - t_kernels) * 1e3,
            "write_ms": (t_end - t_trace) * 1e3,
            "worker_ms": (t_end - t0) * 1e3,
            "bytes": os.path.getsize(out)}


def main() -> int:
    t0 = time.perf_counter()
    spec = json.loads(sys.stdin.read())
    report = build_frozen(spec) if spec.get("freeze") else build(spec)
    # the child's whole life but the interpreter's own start: imports,
    # the kernel build, the fold, the check and the write
    report["process_ms"] = (time.perf_counter() - t0) * 1e3
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
