"""reduce — reduce across ranks, the result delivered to the root.

The counterpart of ``mpi4jax_tpu/ops/reduce.py``.  On the mesh tier the
allreduce, then a per-rank select (``_mesh_impl.reduce``); on the world
tier the transport's reduce, a custom op as a gather and a fold at the
root (``_world_impl.reduce``).  Either way the root receives the reduction
and the other ranks their input back.
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl
from .reduce_ops import SUM, as_reduce_op


def reduce(x, op=SUM, root=0, *, comm=None, token=None):
    """Reduce ``x`` with ``op``; the root receives the result, the others
    keep ``x``."""
    op = as_reduce_op(op)
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        from . import _world_impl

        _validation.check_world_tensor("reduce", x, comm)
        root = _validation.check_root("reduce", root, comm)
        _validation.check_reduce_dtype("reduce", op, x, comm)
        _validation.check_wire_dtype("reduce", x, comm)
        return _dispatch.attach_world(
            _world_impl.reduce(x, op, root, comm), token, comm)
    _validation.check_tensor("reduce", x, comm)
    root = _validation.check_root("reduce", root, comm)
    _validation.check_reduce_dtype("reduce", op, x, comm)
    _tracing.trace_mesh_op(comm, "Reduce", f"op {op.name} root {root}")
    return _dispatch.attach(_mesh_impl.reduce(x, op, root, comm), token)
