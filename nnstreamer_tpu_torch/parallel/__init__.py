"""Multi-device parallelism (counterpart of the JAX package's
``parallel/``): device meshes with dp/tp/sp axes, driven by one process,
and the placement of batches and weights over them (the filter's
``shard=``). The sequence-parallel attention that runs over an sp axis is
in ``ops/attention.py``.
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
