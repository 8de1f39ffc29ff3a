"""Data parallelism over ranks, one process each: the mesh and its
launcher, data-parallel training with synchronised BatchNorm, data-parallel
evaluation and the spatial (row-band) front end. Port of
``tpu_pillars/parallel``."""

from tpu_pillars_torch.parallel.mesh import (
    Mesh, launch, make_mesh, make_mesh_n, mesh_devices,
)
from tpu_pillars_torch.parallel.train_dp import (
    make_dp_train_step, make_shardmap_train_step, shard_train_batch,
)
from tpu_pillars_torch.parallel.eval_dp import (
    make_dp_detector_fn, make_dp_packed_detector,
)
from tpu_pillars_torch.parallel.spatial import (
    make_spatial_detector_fn, make_spatial_frontend, split_points_by_slab,
)

__all__ = [
    "Mesh", "launch", "make_mesh", "make_mesh_n", "mesh_devices",
    "make_dp_train_step", "make_shardmap_train_step", "shard_train_batch",
    "make_dp_detector_fn", "make_dp_packed_detector",
    "make_spatial_detector_fn", "make_spatial_frontend",
    "split_points_by_slab",
]
