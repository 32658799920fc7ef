"""Mode and factor sharding of the solve: counterpart of ``tensorkrylov_tpu/parallel``.

A mesh of shard slots (``make_mesh``) is driven by one process, or spans
processes (``multihost.py``: ``init_distributed``, ``make_pod_mesh``,
``distribute_problem``), each rank then holding the shards of its own slots.
Every solver takes a ``ShardedOperator`` (``shard_operator``) with b whole or
split (``shard_rhs``), as the JAX package's solvers take sharded arrays;
``solve_sharded`` and ``solve_deflated(mesh=)`` split the problem themselves,
and ``solve_multi_rhs(mesh=)`` runs the rhs groups of a ('rhs', 'factor',
'mode') mesh. The bases are split over the mesh and every Krylov step is
written once over the shard pieces (``krylov.py``).
"""
from .multihost import distribute_problem, global_array, init_distributed, make_pod_mesh
from .sharding import Mesh, ShardedOperator, gather, make_mesh, shard_operator, shard_rhs, solve_sharded

__all__ = ["Mesh", "ShardedOperator", "make_mesh", "shard_operator", "shard_rhs", "gather", "solve_sharded",
           "init_distributed", "make_pod_mesh", "global_array", "distribute_problem"]
