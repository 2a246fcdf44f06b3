"""Data-parallel training over processes, one card each
(pathtracker_tpu/parallel/): ``distributed`` joins the process group,
``mesh`` holds the data axis, the batch split and the active data group the
global reductions go through."""

from pathtracker_torch.parallel.mesh import (DataMesh, active_mesh, data_group,
                                             make_mesh, replicate_tree, shard_batch)

__all__ = ["DataMesh", "active_mesh", "data_group", "make_mesh", "replicate_tree",
           "shard_batch"]
