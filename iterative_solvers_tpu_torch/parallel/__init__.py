"""The mesh layer (counterpart of iterative_solvers_tpu/parallel): solver
meshes over ``torch.distributed`` ranks, the block partition of fields, the
halo-exchanging stencils, the shard-fused V-cycle (``parallel.mg_sharded``)
and the sharded fused CG engine (``parallel.cg_fused_sharded``)."""

from iterative_solvers_tpu_torch.parallel.halo import ShardedStencilOperator
from iterative_solvers_tpu_torch.parallel.halo_pallas import (
    ShardedPallas3DStencilOperator,
    ShardedPallasStencilOperator,
)
from iterative_solvers_tpu_torch.parallel.mesh import (
    SolverMesh,
    crop_field,
    gather_field,
    make_sharded_problem,
    make_solver_mesh,
    pad_field,
    padded_grid_shape,
    shard_field,
)
from iterative_solvers_tpu_torch.parallel.multihost import (
    initialize_distributed,
    make_hybrid_mesh,
    run_world,
)

__all__ = [
    "make_solver_mesh",
    "make_hybrid_mesh",
    "initialize_distributed",
    "run_world",
    "pad_field",
    "crop_field",
    "padded_grid_shape",
    "shard_field",
    "gather_field",
    "make_sharded_problem",
    "SolverMesh",
    "ShardedStencilOperator",
    "ShardedPallasStencilOperator",
    "ShardedPallas3DStencilOperator",
]
