"""allreduce — reduce across all ranks, the result on every rank.

The counterpart of ``mpi4jax_tpu/ops/allreduce.py``.  On the mesh tier SUM
runs on the hop and fused-ring kernels (``_collectives.allreduce_sum``) and
is differentiable; the other ops follow ``_mesh_impl.allreduce``;
``compression="int8"`` takes the quantized schedule of ``quantized.py``.  On the
world tier (a ``WorldComm``, one process per rank) the port carries the
f32 SUM with a forced ``algo=`` (``_world_impl.allreduce_sum``), whose
hierarchical schedules run their intra-island leg on the card.
"""

from __future__ import annotations

import torch

from ..utils import algos as _algos
from ..utils import validation as _validation
from . import _mesh_impl
from .reduce_ops import SUM, as_reduce_op

# the forced schedules the world tier carries; qring/qrd (the native
# route of compression="int8") and the engine's own pick wait for their port
_WORLD_ALGOS = ("ring", "rd", "tree", "hring", "htree")


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
    ``NotImplementedError``.  So does ``token=``.

    On a world comm ``x`` is this rank's tensor, on the comm's device, and
    ``algo=`` is one of ring, rd, tree, hring and htree.  Every other op,
    dtype or algorithm, and ``algo=None`` (the tuner's table is not
    ported), raises ``NotImplementedError`` naming ROADMAP.md.
    """
    op = as_reduce_op(op)
    comm = _validation.resolve_comm(comm, world=True)
    if not hasattr(comm, "axes"):
        return _world_allreduce(x, op, comm, token, compression, algo)
    _validation.check_tensor("allreduce", x, comm)
    if algo is not None:
        _algos.check_algo(algo, "allreduce")
        # a mesh comm has no transport schedules
        _validation.fail(
            "algo= forces a WORLD-tier transport schedule; the mesh tier "
            "has its own dispatch", op="allreduce", comm=comm, x=x,
            exc=NotImplementedError)
    _validation.check_no_token("allreduce", token, comm, x)
    if compression is not None:
        _check_compression(compression, op, comm, x)
        from .quantized import quantized_allreduce_sum

        return quantized_allreduce_sum(x, comm)
    _validation.check_reduce_dtype("allreduce", op, x, comm)
    return _mesh_impl.allreduce(x, op, comm)


def _check_compression(compression, op, comm, x):
    if compression != "int8":
        _validation.fail(
            f"unknown compression {compression!r}; supported: 'int8'",
            op="allreduce", comm=comm, x=x, exc=ValueError)
    if op.name != "SUM":
        _validation.fail(
            f"compression='int8' is supported with op=SUM, got {op.name}",
            op="allreduce", comm=comm, x=x, exc=NotImplementedError)


def _not_ported(what, comm, x):
    _validation.fail(
        f"{what} on a world comm is not ported yet (ROADMAP.md §1 item 6)",
        op="allreduce", comm=comm, x=x, exc=NotImplementedError)


def _world_allreduce(x, op, comm, token, compression, algo):
    from . import _world_impl

    if not isinstance(x, torch.Tensor):
        _validation.fail(f"x must be a torch.Tensor, got "
                         f"{type(x).__qualname__}", op="allreduce",
                         comm=comm)
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
        _check_compression(compression, op, comm, x)
        _not_ported("compression='int8' (the native qring/qrd route)",
                    comm, x)
    _validation.check_no_token("allreduce", token, comm, x)
    if op.name != "SUM":
        _not_ported(f"op={op.name}", comm, x)
    if x.dtype != torch.float32:
        _not_ported(f"dtype {x.dtype}", comm, x)
    if algo is None or algo == "auto":
        _not_ported("the engine's own algorithm pick (algo=None or "
                    "'auto': the tuner's decision table)", comm, x)
    if algo not in _WORLD_ALGOS:
        _not_ported(f"algo={algo!r}", comm, x)
    if x.device != comm.device:
        _validation.fail(f"x is on {x.device}, the comm on {comm.device}",
                         op="allreduce", comm=comm, x=x, exc=ValueError)
    return _world_impl.allreduce_sum(x, comm, algo)
