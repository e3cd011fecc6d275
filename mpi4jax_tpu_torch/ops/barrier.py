"""barrier — synchronize all ranks.

The counterpart of ``mpi4jax_tpu/ops/barrier.py``.  One program on one
stream needs no barrier for correctness; the mesh tier runs a SUM allreduce
of one zero per rank, as the JAX package's cross-rank psum dependency does
(``_mesh_impl.barrier``).  On the world tier the transport's barrier: every
rank blocks until all have reached it (host order; work queued on a card
before it is not waited for).
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl


def barrier(*, comm=None, token=None):
    """Returns ``None``, or with ``token=`` that token."""
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        from . import _world_impl

        _world_impl.barrier(comm)
        return _world_impl.chain_token(comm, token)
    _tracing.trace_mesh_op(comm, "Barrier")
    _mesh_impl.barrier(comm)
    return token
