"""scan — inclusive prefix reduction across ranks (MPI_Scan).

The counterpart of ``mpi4jax_tpu/ops/scan.py``.  On the mesh tier a
log2(size) Hillis–Steele ladder whose shifts are hops
(``_mesh_impl.scan``); on the world tier the transport's scan, a custom op
as an allgather and a local prefix fold (``_world_impl.scan``).
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl
from .reduce_ops import SUM, as_reduce_op


def scan(x, op=SUM, *, comm=None, token=None):
    """Rank r receives ``op(x_0, ..., x_r)`` (inclusive prefix)."""
    op = as_reduce_op(op)
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        from . import _world_impl

        _validation.check_world_tensor("scan", x, comm)
        _validation.check_reduce_dtype("scan", op, x, comm)
        _validation.check_wire_dtype("scan", x, comm)
        return _dispatch.attach_world(_world_impl.scan(x, op, comm),
                                      token, comm)
    _validation.check_tensor("scan", x, comm)
    _validation.check_reduce_dtype("scan", op, x, comm)
    _tracing.trace_mesh_op(comm, "Scan", f"op {op.name}")
    return _dispatch.attach(_mesh_impl.scan(x, op, comm), token)
