"""gather — collect every rank's block.

The counterpart of ``mpi4jax_tpu/ops/gather.py`` on the mesh tier: the
all-gather over hops, its result on every rank (the SPMD divergence of
DESIGN.md: the root's view is the reference's root result).
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _mesh_impl


def gather(x, root=0, *, comm=None, token=None):
    """Gather ``x`` from all ranks: ``(*lead, size, *local)``, replicated on
    every rank."""
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("gather", x, comm)
    _validation.check_no_token("gather", token, comm, x)
    root = _validation.check_root("gather", root, comm)
    return _mesh_impl.gather(x, root, comm)
