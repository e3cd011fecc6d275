"""The ported ops of the mesh tier: allreduce, allgather, sendrecv, scan.

bcast, reduce, gather, scatter, alltoall, barrier and send/recv are queued
in ROADMAP.md.
"""

from .allgather import allgather
from .allreduce import allreduce
from .reduce_ops import (
    ALL_OPS,
    BAND,
    BOR,
    BXOR,
    LAND,
    LOR,
    LXOR,
    MAX,
    MIN,
    PROD,
    SUM,
    ReduceOp,
    as_reduce_op,
    custom_op,
)
from .scan import scan
from .sendrecv import sendrecv

__all__ = [
    "allgather",
    "allreduce",
    "scan",
    "sendrecv",
    "ReduceOp",
    "as_reduce_op",
    "custom_op",
    "ALL_OPS",
    "SUM",
    "PROD",
    "MAX",
    "MIN",
    "LAND",
    "LOR",
    "LXOR",
    "BAND",
    "BOR",
    "BXOR",
]
