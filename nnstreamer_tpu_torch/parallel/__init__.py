"""Multi-device parallelism (counterpart of the JAX package's
``parallel/``): device meshes with dp/tp/sp axes, driven by one process,
the placement of batches and weights over them (the filter's ``shard=``)
and the train step, sharded over a mesh (``parallel/train.py``). The
sequence-parallel attention that runs over an sp axis is in
``ops/attention.py``.
"""

from nnstreamer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    PlacedLeaf,
    make_mesh,
    mesh_from_axes,
    mesh_from_spec,
    param_shardings,
    resolve_shard_axes,
    shard_batch,
    shard_params_for_tp,
    tp_leaf_sharded,
    visible_device_count,
    visible_devices,
)
from nnstreamer_tpu_torch.parallel.train import make_train_step  # noqa: F401,E402
