"""Multi-stream scaling probe: what serializes N-stream aggregate
throughput? (counterpart of the JAX package's
``tools/multistream_probe.py``)

Three workloads over the same round_robin/join branch topology (queue 8
before each branch's filter), each at 1, 2, 4 and 8 streams:

- ``ms_host``: each invoke is host BLAS (numpy matmuls of 256², which
  release the GIL): if the aggregate scales with streams, no framework
  lock serializes the element graph;
- ``ms_dev``: each invoke is 96 chained ``tanh(m @ w)`` on a 1024² bf16
  weight on the card, seeded from the input's sum, with a payload of a
  few bytes: every stream shares one card, so the aggregate is expected
  near the card's rate, streams hiding only host time;
- ``native_spin``: the same topology in the port's native core (no GIL),
  a compiled filter burning ~3 ms of CPU an invoke: it tracks the host's
  cores.

Run on the card: ``python -m nnstreamer_tpu_torch.tools.multistream_probe
[--streams=1,2,4,8]``. Prints one JSON object: per leg the aggregate
buffers/s at each stream count and ``scaling_at_max``, and the card's
stamp. ``ms_dev`` needs a card, so the probe raises without one.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.buffer import Buffer
from nnstreamer_tpu_torch.filters.base import (
    register_custom_easy,
    unregister_custom_easy,
)
from nnstreamer_tpu_torch.pipeline import parse_launch
from nnstreamer_tpu_torch.types import TensorsInfo

CAPS = ("other/tensors,num-tensors=1,dimensions=256:256,"
        "types=float32,framerate=0/1")

MODELS = ("ms_host", "ms_dev")

#: buffers timed per leg and stream count
N_BUFS = {"ms_host": 64, "ms_dev": 48, "native_spin": 48}


def register_models(device="cuda") -> None:
    """Register ``ms_host`` and, with a ``device``, ``ms_dev`` on it."""
    rng = np.random.default_rng(7)
    w_host = rng.normal(0, 0.05, (256, 256)).astype(np.float32)

    def host_blas(ins):
        # ~0.4 GFLOP of BLAS per invoke; numpy releases the GIL inside
        x = np.asarray(ins[0])
        for _ in range(12):
            x = np.tanh(x @ w_host)
        return [x]

    info = TensorsInfo.from_strings("256:256", "float32")
    register_custom_easy("ms_host", host_blas, info, info)
    if device is None:
        return
    w_dev = torch.from_numpy(rng.normal(0, 0.05, (1024, 1024))).to(
        device=device, dtype=torch.bfloat16)

    @torch.inference_mode()
    def dev_model(ins):
        # ~0.2 TFLOP chained on the card, data-dependent through the seed
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(ins[0])[:2, :2])).to(device)
        m = w_dev + x.sum().to(torch.bfloat16) * 1e-6
        for _ in range(96):
            m = torch.tanh(m @ w_dev)
        return [m.float().sum().reshape(1, 1)]

    register_custom_easy("ms_dev", dev_model, info,
                         TensorsInfo.from_strings("1:1", "float32"))


def unregister_models() -> None:
    for m in MODELS:
        unregister_custom_easy(m)


def build(model: str, n_streams: int, queue: int = 8):
    def filt(name):
        return (f"tensor_filter name={name} framework=custom-easy "
                f"model={model}")

    if n_streams == 1:
        mid = f"! {filt('f0')} "
    else:
        first = (f"rr. ! queue max-size-buffers={queue} ! {filt('f0')} "
                 "! join name=j")
        rest = " ".join(
            f"rr. ! queue max-size-buffers={queue} ! {filt(f'f{i}')} ! j."
            for i in range(1, n_streams))
        mid = f"! round_robin name=rr {first} {rest} j. "
    return parse_launch(
        f"appsrc name=src caps={CAPS} " + mid + "! tensor_sink name=out "
        "materialize=false")


def run_leg(model: str, streams: int, n_bufs: int) -> float:
    """Aggregate buffers/s of ``n_bufs`` through ``streams`` branches,
    after one warm-up buffer per stream."""
    p = build(model, streams)
    p.play()
    try:
        src, out = p["src"], p["out"]
        x = np.zeros((256, 256), np.float32)
        for _ in range(streams):
            src.push_buffer(Buffer(tensors=[x]))
        got = 0
        deadline = time.time() + 120
        while got < streams and time.time() < deadline:
            if out.pull(timeout=5.0) is not None:
                got += 1
        if got < streams:
            # timing now would fold the first invokes into the rate
            raise RuntimeError(
                f"{model}/{streams}: warmup incomplete ({got}/{streams})")
        t0 = time.perf_counter()
        for _ in range(n_bufs):
            src.push_buffer(Buffer(tensors=[x]))
            while out.pull(timeout=0) is not None:
                got += 1
        while got < streams + n_bufs:
            if out.pull(timeout=60.0) is None:
                raise RuntimeError(f"{model}/{streams}: stalled at {got}")
            got += 1
        return n_bufs / (time.perf_counter() - t0)
    finally:
        p.stop()


#: native spin filter: ~3 ms of pure C++ CPU work per invoke, no GIL;
#: whether this leg scales is decided by the host's cores alone
NATIVE_SPIN_CC = r"""
#include <chrono>
#include <cstring>

#include "nnstpu/cppclass.hh"

class spin_filter : public nnstpu::tensor_filter_subplugin {
 public:
  void configure_instance(const char*) override {}
  int getModelInfo(nnstpu_tensors_info* in,
                   nnstpu_tensors_info* out) override {
    for (nnstpu_tensors_info* t : {in, out}) {
      std::memset(t, 0, sizeof(*t));
      t->num = 1;
      t->info[0].rank = 1;
      t->info[0].dims[0] = 4;
      t->info[0].dtype = 7; /* float32 */
    }
    return 0;
  }
  int invoke(const nnstpu_tensor_mem* in, uint32_t, nnstpu_tensor_mem* out,
             uint32_t) override {
    auto end = std::chrono::steady_clock::now() +
               std::chrono::milliseconds(3);
    volatile double acc = 0;
    while (std::chrono::steady_clock::now() < end) acc += 1.0;
    std::memcpy(out[0].data, in[0].data, out[0].size);
    return 0;
  }
};

__attribute__((constructor)) static void reg() {
  nnstpu::register_subplugin<spin_filter>("ms_spin_native");
}
"""


def scaling(leg: Dict[str, float], streams_list: Sequence[int]) -> float:
    base = leg[str(streams_list[0])] or 1.0
    return leg[str(streams_list[-1])] / base


def run_native_legs(streams_list: Sequence[int]) -> Dict[str, float]:
    """The same topology in the port's native core: the spin filter,
    compiled against the checkout's ``native/include`` and the core."""
    from nnstreamer_tpu_torch import native_rt

    with tempfile.TemporaryDirectory() as td:
        # the .so stays dlopen'd; deleting the file after the load is safe
        native_rt.compile_and_load_plugin(
            NATIVE_SPIN_CC, "libnnstpu_torch_filter_spin.so", td)
    caps = "other/tensors,format=static,dimensions=4,types=float32"
    leg: Dict[str, float] = {}
    n_bufs = N_BUFS["native_spin"]
    for s in streams_list:
        if s == 1:
            desc = (f"appsrc name=src caps={caps} ! tensor_filter "
                    "framework=ms_spin_native ! appsink name=out")
        else:
            branches = " ".join(
                "r. ! queue ! tensor_filter framework=ms_spin_native ! j."
                for _ in range(s))
            desc = (f"appsrc name=src caps={caps} ! round_robin name=r "
                    f"join name=j ! appsink name=out {branches}")
        x = np.zeros(4, np.float32)
        with native_rt.NativePipeline(desc) as p:
            p.play()
            for _ in range(s):  # warm-up
                p.push("src", [x])
            for _ in range(s):
                if p.pull("out", timeout=30.0) is None:
                    raise RuntimeError(f"native/{s}: warmup stalled")
            t0 = time.perf_counter()
            got = 0
            for _ in range(n_bufs):
                p.push("src", [x])
                while p.pull("out", timeout=0.0) is not None:
                    got += 1
            while got < n_bufs:
                if p.pull("out", timeout=30.0) is None:
                    raise RuntimeError(f"native/{s}: stalled at {got}")
                got += 1
            leg[str(s)] = n_bufs / (time.perf_counter() - t0)
            p.eos("src")
            p.wait_eos(5.0)
    leg["scaling_at_max"] = scaling(leg, streams_list)
    return leg


def run(streams: Sequence[int] = (1, 2, 4, 8)) -> Dict[str, object]:
    """Every leg at each stream count on the card."""
    from nnstreamer_tpu_torch.tools.mfu_table import card_stamp, require_card

    require_card()
    streams: List[int] = list(streams)
    register_models("cuda")
    try:
        res: Dict[str, object] = {}
        for model in MODELS:
            leg = {str(s): run_leg(model, s, N_BUFS[model]) for s in streams}
            leg["scaling_at_max"] = scaling(leg, streams)
            res[model] = leg
        res["native_spin"] = run_native_legs(streams)
        res["card"] = card_stamp()
        return res
    finally:
        unregister_models()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    streams = [1, 2, 4, 8]
    for a in argv:
        if a.startswith("--streams"):
            streams = [int(t) for t in a.split("=", 1)[1].split(",")]
    print(json.dumps(run(streams)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
