"""The port's native C++ core running a torch model through the custom
filter C ABI (counterpart of ``examples/native_pipeline.py``): a Python
top-1 on the device, registered with
``native_rt.register_callback_filter``, inside a
``native_rt.NativePipeline``.

    python -m nnstreamer_tpu_torch.examples.native_pipeline [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

NAME = "torch_top1"


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple[int, int]]:
    """Returns (pts, top-1 class) of each of the 4 frames."""
    import torch

    from nnstreamer_tpu_torch import native_rt
    from nnstreamer_tpu_torch.examples import parse_args
    from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

    device, _, _ = parse_args(argv)

    @torch.inference_mode()
    def top1(xs):
        x = torch.from_numpy(np.array(xs[0])).to(device)
        return [torch.argmax(x, -1).to(torch.int32).reshape(1).cpu().numpy()]

    native_rt.register_callback_filter(
        NAME, top1,
        TensorsInfo(tensors=[TensorInfo(dims=(16,), dtype="float32")]),
        TensorsInfo(tensors=[TensorInfo(dims=(1,), dtype="int32")]))
    out = []
    try:
        with native_rt.NativePipeline(
                "appsrc name=src caps=other/tensors,format=static,"
                "dimensions=16,types=float32 "
                f"! queue ! tensor_filter framework={NAME} "
                "! appsink name=out") as p:
            p.play()
            for i in range(4):
                x = np.zeros(16, np.float32)
                x[i * 3] = 1.0
                p.push("src", [x], pts=i)
            for _ in range(4):
                got = p.pull("out", timeout=30.0)
                if got is None:
                    raise RuntimeError(f"no top-1: {p.pop_error()}")
                arrs, pts = got
                cls = int(arrs[0].view(np.int32)[0])
                print(f"frame {pts}: top-1 class = {cls}")
                out.append((pts, cls))
            p.eos("src")
            p.wait_eos(5.0)
    finally:
        native_rt.unregister_filter(NAME)
    return out


if __name__ == "__main__":
    main()
