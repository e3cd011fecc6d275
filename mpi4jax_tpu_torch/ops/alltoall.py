"""alltoall — transpose chunks across ranks (the FFT-slab move).

The counterpart of ``mpi4jax_tpu/ops/alltoall.py`` on the mesh tier: one
launch of the alltoall kernel (``_collectives.alltoall``), differentiable
(the op is its own transpose).
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _mesh_impl


def alltoall(x, *, comm=None, token=None, compression=None, algo=None):
    """Exchange chunks: rank r's output row ``j`` is rank ``j``'s input row
    ``r``.

    ``x`` is ``(*lead, size, ...)``: the mesh's rank dimensions, then each
    rank's ``(size, ...)`` buffer.  ``compression=`` (the quantized wire
    format) and ``algo=`` (world-tier schedules) are not ported and raise
    ``NotImplementedError``; so does ``token=``.
    """
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("alltoall", x, comm)
    _validation.check_no_token("alltoall", token, comm, x)
    if compression is not None:
        _validation.fail(
            "compression= is not ported yet (the quantized alltoall is "
            "queued in ROADMAP.md)", op="alltoall", comm=comm, x=x,
            exc=NotImplementedError)
    if algo is not None:
        _validation.fail(
            "algo= forces a world-tier transport schedule; the mesh tier "
            "has one alltoall kernel", op="alltoall", comm=comm, x=x,
            exc=NotImplementedError)
    return _mesh_impl.alltoall(x, comm)
