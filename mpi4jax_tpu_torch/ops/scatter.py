"""scatter — distribute the rows of the root's buffer, one per rank.

The counterpart of ``mpi4jax_tpu/ops/scatter.py``.  On the mesh tier every
rank passes a ``(size, ...)`` buffer (only the root's values are read) and
receives its row, from one alltoall and the root's row of its result, so it
rides the alltoall kernel (``_mesh_impl.scatter``).  On the world tier the
transport's scatter; every rank passes a ``(size, ...)`` buffer there too.
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl


def scatter(x, root=0, *, comm=None, token=None):
    """Rank ``j`` receives row ``j`` of the root's ``(size, ...)`` buffer."""
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        from . import _world_impl

        _validation.check_world_tensor("scatter", x, comm)
        root = _validation.check_root("scatter", root, comm)
        _validation.check_wire_dtype("scatter", x, comm)
        if x.dim() < 1 or x.shape[0] != comm.size():
            _validation.fail(
                f"scatter requires input shape (size, ...) = "
                f"({comm.size()}, ...)", op="scatter", comm=comm, x=x,
                exc=ValueError)
        return _dispatch.attach_world(_world_impl.scatter(x, root, comm),
                                      token, comm)
    _validation.check_tensor("scatter", x, comm)
    root = _validation.check_root("scatter", root, comm)
    _tracing.trace_mesh_op(comm, "Scatter", f"root {root}")
    return _dispatch.attach(_mesh_impl.scatter(x, root, comm), token)
