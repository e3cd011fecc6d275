"""scatter — distribute the rows of the root's buffer, one per rank.

The counterpart of ``mpi4jax_tpu/ops/scatter.py`` on the mesh tier: every
rank passes a ``(size, ...)`` buffer (only the root's values are read) and
receives its row, from one alltoall and the root's row of its result, so it
rides the alltoall kernel (``_mesh_impl.scatter``).
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _mesh_impl


def scatter(x, root=0, *, comm=None, token=None):
    """Rank ``j`` receives row ``j`` of the root's ``(size, ...)`` buffer."""
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("scatter", x, comm)
    _validation.check_no_token("scatter", token, comm, x)
    root = _validation.check_root("scatter", root, comm)
    return _mesh_impl.scatter(x, root, comm)
