"""barrier — synchronize all ranks.

The counterpart of ``mpi4jax_tpu/ops/barrier.py`` on the mesh tier.  One
program on one stream needs no barrier for correctness; the mesh tier runs
a SUM allreduce of one zero per rank, as the JAX package's cross-rank psum
dependency does (``_mesh_impl.barrier``).
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _mesh_impl


def barrier(*, comm=None, token=None):
    """Returns ``None``; ``token=`` raises ``NotImplementedError``."""
    comm = _validation.resolve_comm(comm)
    _validation.check_no_token("barrier", token, comm)
    _mesh_impl.barrier(comm)
