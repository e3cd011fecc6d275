"""allreduce — reduce across all ranks, the result on every rank.

The counterpart of ``mpi4jax_tpu/ops/allreduce.py``.  On the mesh tier SUM
runs on the hop and fused-ring kernels (``_collectives.allreduce_sum``) and
is differentiable; the other ops follow ``_mesh_impl.allreduce``;
``compression="int8"`` takes the quantized schedule of ``quantized.py``.  On the
world tier (a ``WorldComm``, one process per rank) every op and dtype runs
through the transport (``_world_impl.allreduce``): ``algo=None`` is the
engine's pick from the installed decision table (``tune``), a forced
``algo=`` one schedule, and the hierarchical schedules run their
intra-island leg on the card.  ``compression="int8"`` takes the
transport's qring or qrd (``tune.quantized_algorithm``), or the Python
schedule under ``MPI4JAX_TPU_COLL_QUANT=deny``.
"""

from __future__ import annotations

from ..utils import algos as _algos
from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl
from .reduce_ops import SUM, as_reduce_op

def allreduce(x, op=SUM, *, comm=None, token=None, compression=None,
              algo=None):
    """Reduce ``x`` with ``op`` across the ranks of ``comm``.

    On a mesh comm ``x`` has the mesh's rank dimensions leading; every
    rank's block is replaced by the reduction over its group.  ``algo=``
    and ``compression=`` are checked as in the JAX package: an unknown
    value raises ``ValueError``.  A valid ``algo=`` forces a world-tier
    schedule and raises ``NotImplementedError`` on the mesh tier, as
    there; ``compression="int8"`` with ``op=SUM`` runs the quantized
    schedule (``quantized.quantized_allreduce_sum``: one alltoall and one
    all-gather of int8 rows), and with another op raises
    ``NotImplementedError``.

    On a world comm ``x`` is this rank's tensor, on the comm's device; any
    op and supported dtype; ``algo=`` one of auto, ring, rd, tree, qring,
    qrd, hring and htree (every rank must force the same one; an
    ineligible pick degrades in the transport as a table row does), or
    None for the engine's pick.  ``compression="int8"`` with SUM on a real
    floating dtype runs the transport's quantized schedule, rank-consistent
    and about 1e-2 off the exact sum.  Only SUM is differentiable: its
    gradient passes the cotangent unchanged.

    With ``token=`` (``ops/_dispatch.py``) both tiers return ``(result,
    token)``; the result is the tokenless call's.
    """
    op = as_reduce_op(op)
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        return _dispatch.attach_world(
            _world_allreduce(x, op, comm, compression, algo), token, comm)
    _validation.check_tensor("allreduce", x, comm)
    if algo is not None:
        _algos.check_algo(algo, "allreduce")
        # a mesh comm has no transport schedules
        _validation.fail(
            "algo= forces a WORLD-tier transport schedule; the mesh tier "
            "has its own dispatch", op="allreduce", comm=comm, x=x,
            exc=NotImplementedError)
    if compression is not None:
        _check_compression(compression, op, comm, x)
        from .quantized import quantized_allreduce_sum

        return _dispatch.attach(quantized_allreduce_sum(x, comm), token)
    _validation.check_reduce_dtype("allreduce", op, x, comm)
    _tracing.trace_mesh_op(comm, "Allreduce", f"op {op.name}")
    return _dispatch.attach(_mesh_impl.allreduce(x, op, comm), token)


def _check_compression(compression, op, comm, x):
    if compression != "int8":
        _validation.fail(
            f"unknown compression {compression!r}; supported: 'int8'",
            op="allreduce", comm=comm, x=x, exc=ValueError)
    if op.name != "SUM":
        _validation.fail(
            f"compression='int8' is supported with op=SUM, got {op.name}",
            op="allreduce", comm=comm, x=x, exc=NotImplementedError)


def _world_allreduce(x, op, comm, compression, algo):
    from . import _world_impl

    _validation.check_world_tensor("allreduce", x, comm)
    if algo is not None:
        algo = _algos.check_algo(algo, "allreduce")
        if compression is not None:
            _validation.fail(
                "compression='int8' selects its own wire format; do not "
                "combine it with algo=", op="allreduce", comm=comm, x=x,
                exc=ValueError)
        if op.custom:
            _validation.fail(
                f"custom reduce op {op.name} runs as allgather + local "
                "fold; there is no allreduce schedule to force",
                op="allreduce", comm=comm, x=x, exc=ValueError)
    if compression is not None:
        from .quantized import (check_quantizable, native_quant_algo,
                                quantized_allreduce_sum_world)

        _check_compression(compression, op, comm, x)
        check_quantizable(x, comm)
        _validation.check_wire_dtype("allreduce", x, comm)
        algo = native_quant_algo(comm, x)
        if algo is None:  # MPI4JAX_TPU_COLL_QUANT=deny
            return quantized_allreduce_sum_world(x, comm)
        return _world_impl.allreduce(x, op, comm, algo=algo)
    _validation.check_reduce_dtype("allreduce", op, x, comm)
    _validation.check_wire_dtype("allreduce", x, comm)
    return _world_impl.allreduce(x, op, comm, algo=algo)
