"""Device ops with hand-written CUDA kernels for the H100 (sm_90a), each
with its plain PyTorch version beside it — the counterparts of the JAX
package's Pallas kernels.

  fused_inverted_residual   ops/fused_block.py   csrc/fused_block.cu
  normalize_u8              ops/preprocess.py    csrc/preprocess.cu
  arith_chain               ops/transform_ops.py csrc/transform_ops.cu
  flash_attention           ops/attention.py     csrc/attention.cu
  flash_chunk               ops/attention.py     csrc/attention.cu

``ops/detection.py`` holds the detection models' device post-process
(top-k and greedy NMS), plain PyTorch as the JAX package's is plain XLA.

``flash_chunk`` is the per-hop update of :func:`ring_attention`; the
sequence-parallel functions (ring and Ulysses) run over a
``parallel.Mesh`` axis.

A wrapper runs its plain version only for a tensor on the CPU; a CUDA
tensor launches the kernel or raises (ops/_cuda.py builds and loads them).
"""

from nnstreamer_tpu_torch.ops.attention import (  # noqa: F401
    flash_attention,
    flash_attention_auto,
    flash_attention_cuda,
    flash_attention_plain,
    flash_chunk_cuda,
    flash_chunk_plain,
    plain_attention,
    ring_attention,
    ring_attention_plain,
    ulysses_attention,
)
from nnstreamer_tpu_torch.ops.detection import (  # noqa: F401
    detection_postprocess,
    ssd_decode_boxes,
)
from nnstreamer_tpu_torch.ops.fused_block import (  # noqa: F401
    fold_conv_bn,
    fold_conv_bn_apply,
    fold_inverted_residual,
    fused_inverted_residual,
    inverted_residual_auto,
    inverted_residual_conv,
    inverted_residual_plain,
)
from nnstreamer_tpu_torch.ops.preprocess import (  # noqa: F401
    normalize_u8,
    normalize_u8_plain,
)
from nnstreamer_tpu_torch.ops.transform_ops import (  # noqa: F401
    arith_chain,
    arith_chain_plain,
)
