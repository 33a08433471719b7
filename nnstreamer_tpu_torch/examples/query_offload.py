"""Query offload (counterpart of ``examples/query_offload.py``): a client
pipeline sends frames to a server pipeline that runs the inference and
routes the answers back by client id, over loopback TCP on one host.

    python -m nnstreamer_tpu_torch.examples.query_offload [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

CAPS = "other/tensors,format=static,dimensions=4,types=float32"


def main(argv: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    """Returns the offloaded result of each of the 3 frames."""
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.examples import accelerator, parse_args
    from nnstreamer_tpu_torch.pipeline import parse_launch

    device, _, _ = parse_args(argv)
    server = parse_launch(
        f"tensor_query_serversrc name=ss id=q1 port=0 caps={CAPS} "
        "! tensor_filter framework=jax model=scaler custom=scale:10 "
        f"{accelerator(device)} ! tensor_query_serversink id=q1")
    server.play()
    out = []
    try:
        client = parse_launch(
            f"appsrc name=src caps={CAPS} "
            f"! tensor_query_client port={server['ss'].port} "
            "! tensor_sink name=out")
        client.play()
        try:
            for i in range(3):
                client["src"].push_buffer(
                    Buffer(tensors=[np.full(4, i + 1, np.float32)]))
                buf = client["out"].pull(timeout=30.0)
                if buf is None:
                    raise RuntimeError(f"frame {i}: no answer: "
                                       f"{client.bus.error}")
                res = np.asarray(buf.tensors[0])
                print(f"frame {i}: offloaded result = {res}")
                out.append(res)
        finally:
            client.stop()
    finally:
        server.stop()
    return out


if __name__ == "__main__":
    main()
