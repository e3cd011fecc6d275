"""gather — collect every rank's block.

The counterpart of ``mpi4jax_tpu/ops/gather.py``.  On the mesh tier the
all-gather over hops, its result on every rank (the SPMD divergence of
DESIGN.md: the root's view is the reference's root result).  On the world
tier the transport's gather: the root receives ``(size, *x.shape)``, every
other rank its input back (the reference's contract).
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl


def gather(x, root=0, *, comm=None, token=None):
    """Gather ``x`` from all ranks: on the mesh tier ``(*lead, size,
    *local)``, replicated on every rank; on the world tier ``(size,
    *x.shape)`` on the root and ``x`` elsewhere."""
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        from . import _world_impl

        _validation.check_world_tensor("gather", x, comm)
        root = _validation.check_root("gather", root, comm)
        _validation.check_wire_dtype("gather", x, comm)
        return _dispatch.attach_world(_world_impl.gather(x, root, comm),
                                      token, comm)
    _validation.check_tensor("gather", x, comm)
    root = _validation.check_root("gather", root, comm)
    _tracing.trace_mesh_op(comm, "Gather", f"root {root}")
    return _dispatch.attach(_mesh_impl.gather(x, root, comm), token)
