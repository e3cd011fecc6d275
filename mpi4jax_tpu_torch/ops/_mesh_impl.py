"""Mesh-tier implementations of the ops.

The counterpart of ``mpi4jax_tpu/ops/_mesh_impl.py``.  Tensors follow the
mesh layout of ``parallel/mesh.py``: the leading dimensions are the mesh's
rank axes, and an op over ``comm`` acts along the comm's axes, batched over
the others.

==============  =====================================================
allreduce       SUM: ``_collectives.allreduce_sum`` (hop and fused-ring
                kernels); MAX/MIN: ``amax``/``amin`` over the rank
                dimension, as the JAX package takes ``lax.pmax``/``pmin``
                outside any Pallas kernel, with no gradient as they have
                none; logical ops on a 0/1 view;
                PROD, bitwise and custom ops: all-gather then a local fold
allgather       ``_collectives.all_gather`` (hops)
alltoall        ``_collectives.alltoall`` (the alltoall kernel)
bcast           masked SUM allreduce (only the root contributes)
reduce          allreduce + select (non-root ranks keep their input)
scan            Hillis–Steele ladder of ``sendrecv`` (log2 steps)
scatter         alltoall + the root's row
gather          allgather (result replicated: the SPMD divergence of
                DESIGN.md)
sendrecv        a ring permutation rides ``ring_shift``, any other one a
                hop; ranks that no rank sends to receive zeros
barrier         SUM allreduce of one zero per rank
==============  =====================================================

send, recv and neighbor_exchange have no mesh route: their fronts raise,
as the JAX package's do on the mesh tier.
"""

from __future__ import annotations

import torch

from . import _collectives
from .reduce_ops import ReduceOp


def _rank_mask(comm, x, keep):
    """``keep(rank)`` per mesh rank, shaped to broadcast against ``x``."""
    r = comm.rank(x.device)
    lead = len(comm.layout)
    return keep(r).reshape(r.shape + (1,) * (x.dim() - lead))


def _over_ranks(x, comm, reduce):
    """``reduce(stack)`` over the comm's rank dimension, broadcast back to
    every rank of the group."""
    front = _collectives._to_front(x, comm)
    out = reduce(front).unsqueeze(0).expand(front.shape)
    return _collectives._from_front(out, comm, x.shape).contiguous()


class _Extremum(torch.autograd.Function):
    """MAX or MIN over the ranks.  Its backward raises, as ``jax.grad``
    does through ``lax.pmax`` and ``lax.pmin``: only SUM is
    differentiable."""

    @staticmethod
    def forward(ctx, x, comm, op):
        ctx.name = op.name
        return _over_ranks(x, comm, op.reduce)  # amax / amin over dim 0

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            f"allreduce with op={ctx.name} has no gradient: only SUM is "
            f"differentiable")


def _gathered(x, comm):
    """Every group's blocks, stacked first: ``(n, *lead, *local)``."""
    lead = len(comm.layout)
    return _collectives.all_gather(x, comm).movedim(lead, 0)


def allreduce(x, op: ReduceOp, comm):
    op.check_dtype(x.dtype)
    if op.kind == "sum":
        return _collectives.allreduce_sum(x, comm)
    if op.kind in ("max", "min"):
        return _Extremum.apply(x, comm, op)
    if op.custom:
        # user-defined: always the generic gather+reduce path
        return op.reduce(_gathered(x, comm)).to(x.dtype)
    if op.domain == "bool":
        # logical ops on a 0/1 view (truthiness, so integer inputs behave
        # like MPI's logical ops)
        bits = (x != 0).to(torch.uint8)
        if op.name == "LAND":
            out = _over_ranks(bits, comm, lambda s: torch.amin(s, dim=0))
        elif op.name == "LOR":
            out = _over_ranks(bits, comm, lambda s: torch.amax(s, dim=0))
        else:  # LXOR: parity of the count of true values
            out = _over_ranks(
                bits.to(torch.int32), comm,
                lambda s: torch.sum(s, dim=0) % 2)
        return out.to(x.dtype)
    # PROD / bitwise: gather then reduce locally
    return op.reduce(_gathered(x, comm)).to(x.dtype)


def allgather(x, comm):
    return _collectives.all_gather(x, comm)


def sendrecv(x, perm, comm):
    """Send along a static permutation of comm ranks ``[(src, dst), ...]``;
    ranks that are no destination receive zeros."""
    n = comm.size()
    k = _collectives.ring_shift_of(perm, n)
    if k is not None:
        return _collectives.ring_shift(x, comm, k)
    key = ("sendrecv", tuple(tuple(p) for p in perm))
    table = comm.tables.get(key)
    if table is None:
        to = {}
        for s, d in perm:
            if not (0 <= s < n and 0 <= d < n):
                raise ValueError(
                    f"pair ({s}, {d}) out of range for {n} ranks")
            if s in to:
                raise ValueError(f"rank {s} sends twice in {perm}")
            to[s] = d
        if len(set(to.values())) != len(to):
            raise ValueError(f"a rank receives twice in {perm}")
        # checked once per permutation and cached on the comm, with the
        # hop's launch plan
        table = _collectives._check_table(
            [(comm.peer(f, to[c]) if c in to else None,)
             for f, c in enumerate(comm.ranks())], 1)
        comm.tables[key] = table
    return _collectives._hop_apply(table, (x,))[0]


def alltoall(x, comm):
    return _collectives.alltoall(x, comm)


def bcast(x, root: int, comm):
    # only the root's block is non-zero, so the sum is its block exactly;
    # bool goes via uint8, the wide unsigned types via their signed twins
    keep = _rank_mask(comm, x, lambda r: r == root)
    if x.dtype == torch.bool:
        bits = torch.where(keep, x, False).to(torch.uint8)
        return _collectives.allreduce_sum(bits, comm) != 0
    signed = _collectives._SIGNED.get(x.dtype)
    v = x.view(signed) if signed is not None else x
    out = _collectives.allreduce_sum(torch.where(keep, v, 0), comm)
    return out.view(x.dtype) if signed is not None else out


def reduce(x, op: ReduceOp, root: int, comm):
    # the root receives the reduction, other ranks their input back
    full = allreduce(x, op, comm)
    return torch.where(_rank_mask(comm, x, lambda r: r == root), full, x)


def gather(x, root: int, comm):
    # the result (size, *local) on every rank; the root's equals MPI's
    del root
    return _collectives.all_gather(x, comm)


def scatter(x, root: int, comm):
    n = comm.size()
    lead = len(comm.layout)
    local = x.shape[lead:]
    if not local or local[0] != n:
        raise ValueError(
            f"scatter requires input shape (size, ...) = ({n}, ...) on every "
            f"rank (only root's values are read), got local shape "
            f"{tuple(local)}")
    # row j of the alltoall holds rank j's row addressed to us; row `root`
    # is MPI_Scatter's result
    return _collectives.alltoall(x, comm).select(lead, root)


def barrier(comm):
    # no rank waits on another in one program on one stream; a SUM
    # allreduce of one zero per rank still runs the collective path
    z = torch.zeros(comm.layout_shape, dtype=torch.int32, device=comm.device)
    _collectives.allreduce_sum(z, comm)


def scan(x, op: ReduceOp, comm):
    """Inclusive prefix reduction across ranks (MPI_Scan): log2(n)
    shift-and-combine steps; ranks below the shift distance keep their
    partial."""
    op.check_dtype(x.dtype)
    n = comm.size()
    acc = x
    shift = 1
    while shift < n:
        shifted = sendrecv(acc, [(i, i + shift) for i in range(n - shift)],
                           comm)
        mask = _rank_mask(comm, acc, lambda r, s=shift: r >= s)
        acc = torch.where(mask, op.combine(acc, shifted), acc)
        shift *= 2
    return acc.to(x.dtype)


def ring_perm(size: int, shift: int = 1, wrap: bool = True):
    """(source, dest) pairs sending each rank's data to ``rank + shift``."""
    pairs = []
    for i in range(size):
        j = i + shift
        if wrap:
            pairs.append((i, j % size))
        elif 0 <= j < size:
            pairs.append((i, j))
    return pairs
