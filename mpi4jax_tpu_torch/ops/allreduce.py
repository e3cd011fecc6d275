"""allreduce — reduce across all ranks, the result on every rank.

The counterpart of ``mpi4jax_tpu/ops/allreduce.py`` on the mesh tier: SUM
runs on the hop and fused-ring kernels (``_collectives.allreduce_sum``) and
is differentiable; the other ops follow ``_mesh_impl.allreduce``.
"""

from __future__ import annotations

from ..utils import algos as _algos
from ..utils import validation as _validation
from . import _mesh_impl
from .reduce_ops import SUM, as_reduce_op


def allreduce(x, op=SUM, *, comm=None, token=None, compression=None,
              algo=None):
    """Reduce ``x`` with ``op`` across the ranks of ``comm``.

    ``x`` has the mesh's rank dimensions leading; every rank's block is
    replaced by the reduction over its group.  ``algo=`` and
    ``compression=`` are checked as in the JAX package: an unknown value
    raises ``ValueError``.  A valid ``algo=`` forces a world-tier schedule
    and raises ``NotImplementedError`` on the mesh tier, as there;
    ``compression="int8"`` raises ``NotImplementedError`` until the
    quantized mesh allreduce is ported (ROADMAP.md).  So does ``token=``.
    """
    op = as_reduce_op(op)
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("allreduce", x, comm)
    if algo is not None:
        _algos.check_algo(algo, "allreduce")
        # every comm of the port is a mesh comm
        _validation.fail(
            "algo= forces a WORLD-tier transport schedule; the mesh tier "
            "has its own dispatch", op="allreduce", comm=comm, x=x,
            exc=NotImplementedError)
    if compression is not None:
        if compression != "int8":
            _validation.fail(
                f"unknown compression {compression!r}; supported: 'int8'",
                op="allreduce", comm=comm, x=x, exc=ValueError)
        if op.name != "SUM":
            _validation.fail(
                f"compression='int8' is supported with op=SUM, got "
                f"{op.name}", op="allreduce", comm=comm, x=x,
                exc=NotImplementedError)
        _validation.fail(
            "compression='int8' on a mesh comm is not ported yet (the "
            "quantized mesh allreduce is queued in ROADMAP.md)",
            op="allreduce", comm=comm, x=x, exc=NotImplementedError)
    _validation.check_no_token("allreduce", token, comm, x)
    _validation.check_reduce_dtype("allreduce", op, x, comm)
    return _mesh_impl.allreduce(x, op, comm)
