"""allreduce — reduce across all ranks, the result on every rank.

The counterpart of ``mpi4jax_tpu/ops/allreduce.py`` on the mesh tier: SUM
runs on the hop and fused-ring kernels (``_collectives.allreduce_sum``) and
is differentiable; the other ops follow ``_mesh_impl.allreduce``.
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _mesh_impl
from .reduce_ops import SUM, as_reduce_op


def allreduce(x, op=SUM, *, comm=None, token=None, compression=None,
              algo=None):
    """Reduce ``x`` with ``op`` across the ranks of ``comm``.

    ``x`` has the mesh's rank dimensions leading; every rank's block is
    replaced by the reduction over its group.  ``compression=`` (the
    quantized path) and ``algo=`` (world-tier schedules) are not ported and
    raise ``NotImplementedError``; so does ``token=``.
    """
    op = as_reduce_op(op)
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("allreduce", x, comm)
    _validation.check_no_token("allreduce", token, comm, x)
    if compression is not None:
        _validation.fail(
            "compression= is not ported yet (the quantized allreduce is "
            "queued in ROADMAP.md)", op="allreduce", comm=comm, x=x,
            exc=NotImplementedError)
    if algo is not None:
        _validation.fail(
            "algo= forces a world-tier transport schedule; the mesh tier "
            "has its own dispatch", op="allreduce", comm=comm, x=x,
            exc=NotImplementedError)
    _validation.check_reduce_dtype("allreduce", op, x, comm)
    return _mesh_impl.allreduce(x, op, comm)
