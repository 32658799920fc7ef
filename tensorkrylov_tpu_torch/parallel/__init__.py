"""Mode and factor sharding of the solve: counterpart of ``tensorkrylov_tpu/parallel``.

One process drives a mesh of shard slots (``make_mesh``); ``solve_sharded``
runs the solve with the bases split over it. The multi-process layer
(``multihost.py``) is not ported yet.
"""
from .sharding import Mesh, gather, make_mesh, shard_operator, shard_rhs, solve_sharded

__all__ = ["Mesh", "make_mesh", "shard_operator", "shard_rhs", "gather", "solve_sharded"]
