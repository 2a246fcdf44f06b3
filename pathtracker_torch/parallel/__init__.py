"""Parallel training over processes, one card each
(pathtracker_tpu/parallel/): ``distributed`` joins the process group;
``mesh`` holds the meshes, the sharding rules, the sharded parameters and
the active groups the global reductions go through; ``collectives`` the
collectives with their gradients; ``pipeline`` the GPipe stage pipeline;
``moe`` the expert-parallel mixture of experts; ``dryrun`` the multi-rank
dry run of every mode."""

from pathtracker_torch.parallel.mesh import (DataMesh, Mesh2D, Sharded, active_mesh,
                                             data_group, make_mesh, make_mesh_2d,
                                             replicate_tree, shard_batch)

__all__ = ["DataMesh", "Mesh2D", "Sharded", "active_mesh", "data_group", "make_mesh",
           "make_mesh_2d", "replicate_tree", "shard_batch"]
