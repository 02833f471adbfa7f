"""The multi-device solve: the lattice block-sharded over ``torch.distributed``
ranks, one a device (port of ``gqmap_tpu/parallel``)."""

from .halo import make_halo_sweep, halo_roll
from .launch import global_mesh, host_to_global, initialize
from .mesh import Mesh, factor_2d, make_mesh, make_mesh_for_shape, replicated, state_sharding
from .sharded import (gather_state, make_batched_sharded_sweep, make_sharded_sweep,
                      shard_problem, shard_state, stack_states)
