"""alltoall — transpose chunks across ranks (the FFT-slab move).

The counterpart of ``mpi4jax_tpu/ops/alltoall.py`` on the mesh tier: one
launch of the alltoall kernel (``_collectives.alltoall``), differentiable
(the op is its own transpose).
"""

from __future__ import annotations

from ..utils import algos as _algos
from ..utils import validation as _validation
from . import _mesh_impl


def alltoall(x, *, comm=None, token=None, compression=None, algo=None):
    """Exchange chunks: rank r's output row ``j`` is rank ``j``'s input row
    ``r``.

    ``x`` is ``(*lead, size, ...)``: the mesh's rank dimensions, then each
    rank's ``(size, ...)`` buffer.  ``algo=`` and ``compression=`` are
    checked as in the JAX package: an unknown value raises ``ValueError``,
    and a valid one raises ``NotImplementedError`` on the mesh tier, as
    there (both belong to the world-tier transport).  So does ``token=``.
    """
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("alltoall", x, comm)
    if algo is not None:
        _algos.check_algo(algo, "alltoall")
        # every comm of the port is a mesh comm
        _validation.fail(
            "algo= forces a WORLD-tier transport schedule; the mesh tier "
            "has one alltoall kernel", op="alltoall", comm=comm, x=x,
            exc=NotImplementedError)
    if compression is not None:
        if compression != "int8":
            _validation.fail(
                f"unknown compression {compression!r}; supported: 'int8'",
                op="alltoall", comm=comm, x=x, exc=ValueError)
        _validation.fail(
            "compression='int8' rides the world-tier transport wire "
            "format; the mesh tier has one alltoall kernel",
            op="alltoall", comm=comm, x=x, exc=NotImplementedError)
    _validation.check_no_token("alltoall", token, comm, x)
    return _mesh_impl.alltoall(x, comm)
