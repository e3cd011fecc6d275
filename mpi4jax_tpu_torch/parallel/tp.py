"""Tensor parallelism: column- and row-sharded linear layers.

The counterpart of ``mpi4jax_tpu/parallel/tp.py``: the Megatron pairing of
a column-parallel layer (no communication in, features sharded out) and a
row-parallel layer (features sharded in, one SUM allreduce out).  Tensors
have the mesh's rank dimensions leading, so each rank's block is its own
slice of ``x`` and of the weight shard: ``x (*lead, ..., d_in)`` and
``w_shard (*lead, d_in, d_out / size)``.
"""

from __future__ import annotations

import torch

from ..ops import SUM, allreduce


def column_parallel(x, w_shard, b_shard=None):
    """``y_shard = x @ w_shard (+ b_shard)``: output features sharded, no
    communication.  ``w_shard``: each rank's column block."""
    y = torch.matmul(x, w_shard)
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(x_shard, w_shard, b=None, *, comm=None):
    """``y = allreduce(x_shard @ w_shard) (+ b)``: input features sharded,
    one SUM allreduce gives every rank the whole output.  ``w_shard``: each
    rank's row block; ``b`` is added once, after the reduction."""
    y = allreduce(torch.matmul(x_shard, w_shard), op=SUM, comm=comm)
    if b is not None:
        y = y + b
    return y


def shard_columns(w, rank, size):
    """Rank ``rank``'s block of the columns of a whole weight."""
    d = w.shape[-1]
    if d % size:
        raise ValueError(f"cannot split {d} columns over {size} ranks")
    step = d // size
    return w[..., rank * step:(rank + 1) * step]


def shard_rows(w, rank, size):
    """Rank ``rank``'s block of the rows of a whole weight."""
    d = w.shape[0]
    if d % size:
        raise ValueError(f"cannot split {d} rows over {size} ranks")
    step = d // size
    return w[rank * step:(rank + 1) * step]
