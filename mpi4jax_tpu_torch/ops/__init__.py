"""The twelve MPI-style ops on the mesh tier, and ``neighbor_exchange``.

Every op runs on the mesh tier (``_mesh_impl.py``) and on the world tier
(``_world_impl.py``, one process per rank over the native transport).
send, recv and neighbor_exchange belong to the world tier: on a mesh comm
they raise, as the JAX package's do.  Every front takes ``token=``
(``_dispatch.py``, ``compat/token_api.py``).
"""

from ._dispatch import create_token
from ._world_impl import explicit_token_ordering
from .allgather import allgather
from .allreduce import allreduce
from .alltoall import alltoall
from .barrier import barrier
from .bcast import bcast
from .gather import gather
from .neighbor import neighbor_exchange
from .recv import recv
from .reduce import reduce
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
from .scatter import scatter
from .send import send
from .sendrecv import sendrecv

__all__ = [
    "allgather",
    "allreduce",
    "alltoall",
    "barrier",
    "bcast",
    "create_token",
    "explicit_token_ordering",
    "gather",
    "neighbor_exchange",
    "recv",
    "reduce",
    "scan",
    "scatter",
    "send",
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
