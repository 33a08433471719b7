"""PyTorch filter backend — TorchScript ``.pt`` files (counterpart of the
JAX package's ``filters/torch_filter.py``).

Parity: ext/nnstreamer/tensor_filter/tensor_filter_pytorch.cc (TorchScript
module per model). ``model=<script.pt>`` is loaded with ``torch.jit.load``;
``model=<module.py>`` defines ``make_model(custom)`` returning an
``nn.Module``. The module runs on the card unless ``accelerator=true:cpu``
asks for the CPU (filters/cuda_filter.pick_device); outputs come back as
host arrays, as the JAX package's backend returns them. Torch modules
carry no static shape metadata: negotiation supplies shapes through
``set_input_info``.
"""

from __future__ import annotations

import os
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch import registry
from nnstreamer_tpu_torch.buffer import as_torch, dtype_name
from nnstreamer_tpu_torch.filters.base import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo


class TorchFilter(FilterFramework):
    NAME = "torch"  # also registered as "pytorch" below
    RESHAPABLE = True

    def __init__(self):
        super().__init__()
        self._mod = None
        self._device = None

    def open(self, props: FilterProperties) -> None:
        from nnstreamer_tpu_torch.filters.cuda_filter import pick_device

        super().open(props)
        path = props.model_file
        if not path:
            raise ValueError("torch filter needs model=<script.pt|module.py>")
        self._device = pick_device(props.accelerator)
        if path.endswith(".py"):
            import importlib.util

            spec = importlib.util.spec_from_file_location(
                f"nns_torch_module_{os.path.basename(path).removesuffix('.py')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if not hasattr(mod, "make_model"):
                raise ValueError(f"{path} must define make_model(custom)")
            self._mod = mod.make_model(props.custom_dict()).to(self._device)
        else:
            self._mod = torch.jit.load(path, map_location=self._device)
        self._mod.eval()

    def close(self) -> None:
        self._mod = None
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return None, None

    def _run(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        with torch.no_grad():
            out = self._mod(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def set_input_info(self, in_info: TensorsInfo) -> Tuple[TensorsInfo, TensorsInfo]:
        outs = self._run([
            torch.from_numpy(np.zeros(t.np_shape(), dtype=t.dtype.np_dtype))
            .to(self._device) for t in in_info])
        out_info = TensorsInfo(tensors=[
            TensorInfo.from_np_shape(tuple(o.shape), dtype_name(o))
            for o in outs])
        return in_info, out_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        t0 = time.perf_counter()
        outs = self._run([as_torch(x).to(self._device) for x in inputs])
        res = [o.detach().cpu().numpy() for o in outs]
        self.stats.record((time.perf_counter() - t0) * 1e6)
        return res


registry.register(registry.FILTER, "torch")(TorchFilter)
registry.register(registry.FILTER, "pytorch")(TorchFilter)
