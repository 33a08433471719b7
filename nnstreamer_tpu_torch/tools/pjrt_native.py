"""Native pipeline harness: run ``framework=pjrt`` end to end from C++ on a
frozen TorchScript program (counterpart of the JAX package's
``tools/pjrt_native.py``).

Pairs with csrc/native_exec.cc (the native executable filter, libtorch
behind the core's C vtable) and filters/aot.native_aot_compile (the traced,
frozen program and its signature sidecar):

1. ``native_aot_compile(model, custom, shapes)`` (the parent process)
   writes ``<key>.pjrt`` + ``.sig``.
2. ``custom_string()`` builds the filter's custom= string: the device the
   program runs on (``device:cuda:0`` unless told otherwise; the JAX
   package passes its PJRT plugin and client options here instead).
3. ``run_native(exec_path, frames)`` drives a native pipeline (appsrc →
   tensor_filter framework=pjrt → appsink) through the port's core.

The module main (``python -m nnstreamer_tpu_torch.tools.pjrt_native
<spec.json>``) is a subprocess entry. Its default and ``pipeline`` modes
import no torch on the Python side when the spec names a built runner
(``"runner"``): the native filter loads libtorch itself and the frames
never touch Python between the core's elements. The ``ab`` mode is the
deliberate exception: it runs the native filter AND the port's Python
``framework=jax`` filter (single.SingleShot) in one process, alternating,
so the per-invoke comparison shares one process lifetime.

Reference counterpart: tensor_filter_tensorrt.cc:215 — native engine
deserialize + native invoke loop, no interpreter in the hot path.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_DEVICE = "cuda:0"


def custom_string(device: Optional[str] = None) -> str:
    """The filter's custom= string: where the program runs."""
    return f"device:{device or DEFAULT_DEVICE}"


def open_native(exec_path: str, custom: Optional[str] = None,
                runner: Optional[str] = None):
    """Build+play a native pjrt pipeline; returns (pipeline, signature).
    Raises, naming the filter's reason, when the program cannot be opened
    (no card and no ``device:cpu``, a missing sidecar, ...)."""
    from nnstreamer_tpu_torch import native_rt

    native_rt.load_exec(runner)
    sig = _read_sig(exec_path + ".sig")
    caps = _caps_from_sig(sig)
    custom = custom or custom_string()
    p = native_rt.NativePipeline(
        f"appsrc name=src caps={caps} "
        f"! tensor_filter framework=pjrt model={exec_path} custom={custom} "
        "! appsink name=out"
    )
    _play(p, "native pjrt pipeline")
    return p, sig


def _play(p, what: str) -> None:
    """Play ``p``; raise with the bus error and the native filter's open
    error where there is one (the filter opens inside play)."""
    from nnstreamer_tpu_torch import native_rt

    native_rt.clear_exec_error()
    try:
        p.play()
    except RuntimeError:
        p.close()
        raise
    err = native_rt.exec_error() or p.pop_error()
    if err:
        p.close()
        raise RuntimeError(f"{what} failed: {err}")


def _push_pull(p, frame, timeout: float) -> List[np.ndarray]:
    p.push("src", [np.ascontiguousarray(a) for a in frame])
    res = p.pull("out", timeout=timeout)
    if res is None:
        raise RuntimeError(
            f"native pjrt pipeline produced no output ({p.pop_error()})"
        )
    return res[0]  # (tensors, pts)


def run_native(
    exec_path: str,
    frames: Sequence[Sequence[np.ndarray]],
    custom: Optional[str] = None,
    timeout: float = 300.0,
    runner: Optional[str] = None,
) -> List[List[np.ndarray]]:
    """Push ``frames`` through a native pjrt pipeline; return outputs."""
    p, _sig = open_native(exec_path, custom, runner)
    try:
        outs = [_push_pull(p, f, timeout) for f in frames]
        p.eos("src")
        p.wait_eos(10.0)
    finally:
        p.stop()
        p.close()
    return outs


def testsrc_frame(i: int, w: int = 224, h: int = 224) -> np.ndarray:
    """The native videotestsrc counter pattern (elements_stream2.cc:
    frame i byte j = (j + i) & 0xff) replicated so a host process can
    compute expected model outputs for the pure-native pipeline."""
    return ((np.arange(h * w * 3, dtype=np.int64) + i) % 256).astype(
        np.uint8).reshape(h, w, 3)


def run_flagship(exec_path: str, labels_path: str, batches: int, batch: int,
                 custom: Optional[str] = None, warmup: int = 1,
                 timeout: float = 300.0, framework: str = "pjrt",
                 runner: Optional[str] = None,
                 intervals: Optional[List[float]] = None):
    """The flagship pipeline with NO Python in the frame path:
    videotestsrc → tensor_converter(frames-per-tensor) → tensor_filter
    framework=pjrt → tensor_decoder(image_labeling) → appsink. Every
    element is C++ (the core's elements_stream2/tensor/decoder.cc and
    csrc/native_exec.cc); this function only builds the graph and pulls
    the label text. ``framework`` names another filter in the same graph
    (a :func:`native_rt.register_callback_filter` name runs a Python
    callable there); ``intervals`` receives the seconds between
    consecutive batches after warm-up.

    Returns (fps_post_warmup, labels_per_batch: List[List[str]]).
    """
    from nnstreamer_tpu_torch import native_rt

    if framework == "pjrt":
        native_rt.load_exec(runner)
    custom = custom or custom_string()
    n_frames = (batches + warmup) * batch
    p = native_rt.NativePipeline(
        f"videotestsrc name=src width=224 height=224 num-buffers={n_frames} "
        f"fps=0 ! tensor_converter frames-per-tensor={batch} "
        f"! tensor_filter framework={framework} model={exec_path} "
        f"custom={custom} "
        f"! tensor_decoder mode=image_labeling option1={labels_path} "
        "! appsink name=out"
    )
    labels = []
    try:
        _play(p, "native flagship pipeline")
        for _ in range(warmup):
            res = p.pull("out", timeout=timeout)
            if res is None:
                raise RuntimeError(
                    f"flagship warmup produced no output ({p.pop_error()})")
        t0 = last = time.perf_counter()
        for _ in range(batches):
            res = p.pull("out", timeout=timeout)
            if res is None:
                raise RuntimeError(
                    f"flagship produced no output ({p.pop_error()})")
            labels.append(res[0][0].tobytes().decode("utf-8").split("\n"))
            now = time.perf_counter()
            if intervals is not None:
                intervals.append(now - last)
            last = now
        dt = time.perf_counter() - t0
        p.wait_eos(10.0)
    finally:
        p.stop()
        p.close()
    return batches * batch / dt, labels


def _read_sig(path: str):
    ins, outs = [], []
    with open(path) as f:
        head = f.readline()
        if not head.startswith("nnstpu-pjrt-sig"):
            raise ValueError(f"{path}: not a nnstpu-pjrt-sig file")
        for line in f:
            parts = line.split()
            if not parts:
                continue
            kind, dt, nd = parts[0], parts[1], int(parts[2])
            dims = [int(d) for d in parts[3:3 + nd]]
            (ins if kind == "in" else outs).append((dt, dims))
    return {"in": ins, "out": outs}


def _caps_from_sig(sig) -> str:
    from nnstreamer_tpu_torch.filters.sig_tokens import NP_OF_TOKEN

    dims, types = [], []
    for dt, np_dims in sig["in"]:
        dims.append(":".join(str(d) for d in reversed(np_dims)))
        types.append(NP_OF_TOKEN[dt])
    return ("other/tensors,num-tensors=%d,dimensions=%s,types=%s,"
            "framerate=0/1" % (len(dims), ".".join(dims), ".".join(types)))


def _synth_frame(sig, seed: int):
    from nnstreamer_tpu_torch.filters.sig_tokens import np_dtype_of

    rng = np.random.default_rng(seed)
    frame = []
    for dt, np_dims in sig["in"]:
        npdt = np_dtype_of(dt)
        if npdt.kind in "ui":
            frame.append(rng.integers(0, 200, np_dims).astype(npdt))
        else:
            frame.append(rng.normal(0, 1, np_dims).astype(npdt))
    return frame


def run_ab(spec) -> Dict[str, object]:
    """Paired native-vs-Python comparison in ONE process: the native pjrt
    pipeline and the port's Python ``framework=jax`` filter
    (single.SingleShot on ``spec["model"]`` with ``spec["custom_model"]``)
    alternate, never concurrent, on the same frame, so per-rep medians
    compare the two routes' per-invoke cost under one process lifetime.
    Each rep is one frame in and its outputs on the host. spec:
    {"mode": "ab", "exec", "model", "custom_model", "reps": 5,
    "device": "cuda:0", "runner": optional}.
    """
    from nnstreamer_tpu_torch.single import SingleShot

    sig = _read_sig(spec["exec"] + ".sig")
    frame = _synth_frame(sig, int(spec.get("seed", 0)))
    device = spec.get("device", DEFAULT_DEVICE)
    p, _ = open_native(spec["exec"], custom_string(device),
                       spec.get("runner"))
    reps = int(spec.get("reps", 5))
    nat, py = [], []
    single = SingleShot(
        model=spec["model"], framework="jax", custom=spec["custom_model"],
        accelerator="true:cpu" if device == "cpu" else "")
    try:
        _push_pull(p, frame, 300.0)  # native warmup (load + first invoke)
        single.invoke(frame)  # python warmup
        for _ in range(reps):
            t0 = time.perf_counter()
            _push_pull(p, frame, 300.0)
            nat.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            single.invoke(frame)
            py.append(time.perf_counter() - t0)
        p.eos("src")
        p.wait_eos(10.0)
    finally:
        single.close()
        p.stop()
        p.close()

    def stats(xs):
        xs = sorted(xs)
        return {"median_ms": 1e3 * xs[len(xs) // 2],
                "min_ms": 1e3 * xs[0], "max_ms": 1e3 * xs[-1]}

    out = {"reps": reps, "native": stats(nat), "python": stats(py)}
    out["native_overhead_pct"] = (
        out["native"]["median_ms"] / out["python"]["median_ms"] - 1.0) * 100
    return out


def main(argv=None) -> int:
    """Subprocess entry: read a JSON spec, run, report one JSON line.

    spec modes (each may name a built runner, ``"runner"``, and a
    ``"custom"`` string for the filter, default :func:`custom_string`):
      default:  {"exec": path, "frames": N, "seed": 0, "check_path":
                 optional .npy with expected output of frame 0, "warmup": 1}
      pipeline: {"mode": "pipeline", "exec", "labels", "batches", "batch",
                 "warmup": 1, "expect_path": optional .npy int32 indices
                 covering ALL ((warmup+batches)*batch,) frames from stream
                 start (warmup entries are skipped) for golden-correct
                 label verification}
      ab:       see run_ab
    The default and pipeline modes report whether this process imported
    torch (``python_torch``).
    """
    with open(argv[0]) if argv else sys.stdin as f:
        spec = json.loads(f.read())
    runner, custom = spec.get("runner"), spec.get("custom")
    if spec.get("mode") == "ab":
        print(json.dumps(run_ab(spec)))
        return 0
    if spec.get("mode") == "pipeline":
        batches = int(spec.get("batches", 8))
        batch = int(spec.get("batch", 8))
        fps, labels = run_flagship(
            spec["exec"], spec["labels"], batches, batch, custom=custom,
            warmup=int(spec.get("warmup", 1)), runner=runner)
        result = {"fps": fps, "batches": batches, "batch": batch,
                  "first_labels": labels[0][:4]}
        if spec.get("expect_path"):
            with open(spec["labels"]) as f:
                lab_list = [ln.rstrip("\n") for ln in f]
            # expect_path covers frames from stream start; warmup batches
            # are pulled but not collected, so skip their entries
            skip = int(spec.get("warmup", 1)) * batch
            want = np.load(spec["expect_path"]).reshape(-1)[skip:]
            got_flat = [lab for chunk in labels for lab in chunk]
            want_lab = [lab_list[i] if 0 <= i < len(lab_list) else str(i)
                        for i in want[:len(got_flat)]]
            result["label_matches"] = sum(
                g == w for g, w in zip(got_flat, want_lab))
            result["label_total"] = len(got_flat)
        result["python_torch"] = "torch" in sys.modules
        print(json.dumps(result))
        return 0
    sig = _read_sig(spec["exec"] + ".sig")
    frame = _synth_frame(sig, int(spec.get("seed", 0)))
    n = int(spec.get("frames", 16))
    # ONE pipeline: warmup amortizes load + first transfers, the timed
    # window then measures steady-state invoke cost only
    p, _ = open_native(spec["exec"], custom, runner)
    try:
        for _i in range(max(1, int(spec.get("warmup", 1)))):
            _push_pull(p, frame, 300.0)
        t0 = time.perf_counter()
        outs = None
        for _i in range(n):
            outs = _push_pull(p, frame, 300.0)
        dt_s = time.perf_counter() - t0
        p.eos("src")
        p.wait_eos(10.0)
    finally:
        p.stop()
        p.close()
    result = {
        "frames": n,
        "sec": dt_s,
        "invokes_per_sec": n / dt_s,
        "out0_sum": float(np.asarray(
            outs[0].view(np.uint8)).astype(np.int64).sum()),
    }
    if spec.get("check_path"):
        want = np.load(spec["check_path"])
        got = outs[0].view(want.dtype).reshape(want.shape)
        result["check_max_err"] = float(np.max(np.abs(
            got.astype(np.float64) - want.astype(np.float64))))
    result["python_torch"] = "torch" in sys.modules
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
