"""Multi-device parallelism (counterpart of the JAX package's
``parallel/``): device meshes with dp/tp/sp axes, driven by one process.
The sequence-parallel attention that runs over an sp axis is in
``ops/attention.py``.
"""

from nnstreamer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_from_axes,
    mesh_from_spec,
    resolve_shard_axes,
    visible_devices,
)
