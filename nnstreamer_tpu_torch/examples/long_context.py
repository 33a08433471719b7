"""Long-context streaming (counterpart of ``examples/long_context.py``):
tensor_aggregator windows a feature stream into one sequence, a causal
stream transformer (flash attention) processes it, and, for sequences
beyond one device, ring and Ulysses attention shard the sequence over an
``sp=8`` mesh, here eight positions on one device.

    python -m nnstreamer_tpu_torch.examples.long_context [--device cpu]

The data are the JAX example's (``numpy.random.default_rng(0)``: 128
frames of 16 features, then q = k = v of float32 (2, 1024, 32) for the
ring and (2, 8, 1024, 32) for Ulysses).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

SEQ, FEAT = 128, 16
#: the stream transformer's custom= (the JAX example's)
STREAM_CUSTOM = f"seed:0,seq:{SEQ},feat:{FEAT},dim:32,depth:1,heads:2"
SP = 8


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    from nnstreamer_tpu_torch.ops import _cuda

    return {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Returns the inputs (``frames``, ``q``, ``qh``), each step's output
    (``stream`` as numpy, ``ring`` and ``ulysses`` as tensors on the
    device) and each step's kernel launches (``launches``)."""
    import torch

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.examples import (
        accelerator,
        parse_args,
        zoo_custom,
    )
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.ops.attention import (
        ring_attention,
        ulysses_attention,
    )
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.pipeline import parse_launch

    device, params, _ = parse_args(argv)
    launches = {}
    # 1) in the pipeline: 128 one-frame buffers aggregated to one window
    p = parse_launch(
        f"appsrc name=src caps=other/tensors,format=static,dimensions={FEAT},"
        f"types=float32 ! tensor_aggregator frames_in=1 frames_out={SEQ} "
        "frames_dim=1 ! tensor_filter name=f framework=jax "
        f"model=stream_transformer custom={zoo_custom(STREAM_CUSTOM, params)} "
        f"{accelerator(device)} ! tensor_sink name=out")
    p.play()
    rng = np.random.default_rng(0)
    frames = [rng.normal(size=FEAT).astype(np.float32) for _ in range(SEQ)]
    before = dict(_cuda.LAUNCHES)
    try:
        for f in frames:
            p["src"].push_buffer(Buffer(tensors=[f]))
        buf = p["out"].pull(timeout=300.0)
        if buf is None:
            raise RuntimeError(f"the stream line gave no output: "
                               f"{p.bus.error}")
        if device == "cuda":
            torch.cuda.synchronize()
        launches["stream"] = _launches_since(before)
        stream = np.asarray(buf.tensors[0])
    finally:
        p.stop()
    print("stream transformer output:", stream.shape)

    # 2) beyond one device: ring attention over an sp=8 mesh
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = make_mesh(sp=SP, devices=[dev] * SP)
    q_np = rng.normal(size=(2, 1024, 32))
    q = torch.from_numpy(q_np).float().to(dev)
    before = dict(_cuda.LAUNCHES)
    ring = ring_attention(q, q, q, mesh, "sp", causal=True)
    if device == "cuda":
        torch.cuda.synchronize()
    launches["ring"] = _launches_since(before)
    print(f"ring attention over sp={SP} mesh: seq=1024 -> "
          f"{tuple(ring.shape)}")

    # the all-to-all formulation: heads re-shard across sp, each position
    # attends its head slice over the full sequence
    qh_np = rng.normal(size=(2, 8, 1024, 32))
    qh = torch.from_numpy(qh_np).float().to(dev)
    before = dict(_cuda.LAUNCHES)
    uly = ulysses_attention(qh, qh, qh, mesh, "sp", causal=True)
    if device == "cuda":
        torch.cuda.synchronize()
    launches["ulysses"] = _launches_since(before)
    print(f"ulysses (all-to-all) over sp={SP} mesh: seq=1024 -> "
          f"{tuple(uly.shape)}")
    return {"frames": frames, "q": q_np, "qh": qh_np, "stream": stream,
            "ring": ring, "ulysses": uly, "launches": launches}


if __name__ == "__main__":
    main()
