"""allgather — every rank's block, stacked along a new dimension.

The counterpart of ``mpi4jax_tpu/ops/allgather.py`` on the mesh tier: a
ring of hops (``_collectives.all_gather``).
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _mesh_impl


def allgather(x, *, comm=None, token=None):
    """Gather ``x`` from all ranks: each rank receives ``(size, *local)``,
    so the result is ``(*lead, size, *local)``."""
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("allgather", x, comm)
    _validation.check_no_token("allgather", token, comm, x)
    return _mesh_impl.allgather(x, comm)
