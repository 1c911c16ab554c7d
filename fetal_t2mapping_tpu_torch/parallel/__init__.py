from .mesh import (
    VOXEL_AXIS,
    VoxelMesh,
    fit_batch_multistart_sharded,
    fit_batch_sharded,
    fit_fused_sharded,
    mesh_from_flag,
    pad_to_devices,
    shard_voxels,
    voxel_mesh,
)

__all__ = ["VOXEL_AXIS", "VoxelMesh", "voxel_mesh", "mesh_from_flag", "shard_voxels",
           "fit_batch_sharded", "fit_batch_multistart_sharded", "fit_fused_sharded",
           "pad_to_devices"]
