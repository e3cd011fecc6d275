"""allgather — every rank's block, stacked along a new dimension.

The counterpart of ``mpi4jax_tpu/ops/allgather.py``.  On the mesh tier a
ring of hops (``_collectives.all_gather``); on the world tier the
transport's allgather (``_world_impl.allgather``).
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl


def allgather(x, *, comm=None, token=None):
    """Gather ``x`` from all ranks: each rank receives ``(size, *local)``,
    so on the mesh tier the result is ``(*lead, size, *local)``, and on the
    world tier ``(size, *x.shape)``."""
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        from . import _world_impl

        _validation.check_world_tensor("allgather", x, comm)
        _validation.check_wire_dtype("allgather", x, comm)
        return _dispatch.attach_world(_world_impl.allgather(x, comm),
                                      token, comm)
    _validation.check_tensor("allgather", x, comm)
    _tracing.trace_mesh_op(comm, "Allgather")
    return _dispatch.attach(_mesh_impl.allgather(x, comm), token)
