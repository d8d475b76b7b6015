"""Device-mesh parallelism (port of photon_ml_tpu/parallel/__init__.py):
the 1-D and 2-D meshes of slots, row, entity and feature sharding
(distributed.py) and multi-host initialization (multihost.py)."""

from photon_ml_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_primary_host,
)
from photon_ml_tpu_torch.parallel.distributed import (
    DATA_AXIS,
    MODEL_AXIS,
    FeatureShardedFeatures,
    Mesh,
    RowShardedFeatures,
    axis_slots,
    make_mesh,
    make_mesh_2d,
    mesh_device_list,
    mesh_fold_devices,
    mesh_grid_2d,
    replicate,
    shard_batch,
    shard_batch_csr_feature_dim,
    shard_batch_feature_dim,
    shard_block,
    shard_coef,
    split_csr_columns,
    unpad_coef,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "FeatureShardedFeatures",
    "Mesh",
    "RowShardedFeatures",
    "axis_slots",
    "make_mesh",
    "make_mesh_2d",
    "mesh_device_list",
    "mesh_fold_devices",
    "mesh_grid_2d",
    "replicate",
    "shard_batch",
    "shard_batch_csr_feature_dim",
    "shard_batch_feature_dim",
    "shard_block",
    "shard_coef",
    "split_csr_columns",
    "unpad_coef",
    "initialize_multihost",
    "is_primary_host",
]
