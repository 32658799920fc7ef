"""Mode and factor sharding of the solve: counterpart of ``tensorkrylov_tpu/parallel``.

One process drives a mesh of shard slots (``make_mesh``); ``solve_sharded``
and ``solve_deflated(mesh=)`` run their solves with the bases split over it,
every Krylov step written once over the shard pieces (``krylov.py``). The
multi-process layer (``multihost.py``) is not ported yet.
"""
from .sharding import Mesh, gather, make_mesh, shard_operator, shard_rhs, solve_sharded

__all__ = ["Mesh", "make_mesh", "shard_operator", "shard_rhs", "gather", "solve_sharded"]
