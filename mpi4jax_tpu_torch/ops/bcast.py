"""bcast — broadcast the root's block to every rank.

The counterpart of ``mpi4jax_tpu/ops/bcast.py``.  On the mesh tier a
masked SUM allreduce, only the root's block contributing, so it rides the
hop and fused-ring kernels (``_mesh_impl.bcast``); on the world tier the
transport's broadcast (``_world_impl.bcast``).
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl


def bcast(x, root=0, *, comm=None, token=None):
    """Every rank receives the root's block of ``x`` (on the world tier
    every rank passes the same shape); a root outside the communicator
    raises."""
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        from . import _world_impl

        _validation.check_world_tensor("bcast", x, comm)
        root = _validation.check_root("bcast", root, comm)
        _validation.check_wire_dtype("bcast", x, comm)
        return _dispatch.attach_world(_world_impl.bcast(x, root, comm),
                                      token, comm)
    _validation.check_tensor("bcast", x, comm)
    root = _validation.check_root("bcast", root, comm)
    _tracing.trace_mesh_op(comm, "Bcast", f"root {root}")
    return _dispatch.attach(_mesh_impl.bcast(x, root, comm), token)
