"""Device-mesh parallelism (port of photon_ml_tpu/parallel/__init__.py):
the 1-D mesh of slots, row and entity sharding (distributed.py). The
2-D mesh and multi-host (``parallel/multihost.py``) are ROADMAP A6b."""

from photon_ml_tpu_torch.parallel.distributed import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    RowShardedFeatures,
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
    "Mesh",
    "RowShardedFeatures",
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
]
