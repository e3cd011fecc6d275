"""send — point-to-point send.

The counterpart of ``mpi4jax_tpu/ops/send.py``.  A lone send needs ranks
that run different programs (the world tier, not ported yet).  In one SPMD
program every rank runs every line, so an unpaired send has no receiver
call; the mesh tier rejects it and points to ``sendrecv``.
"""

from __future__ import annotations

from ..utils import validation as _validation

MESH_P2P = (
    "{op}() has no meaning inside a single SPMD program: every rank executes "
    "the same code, so there is no separate {peer}. Use sendrecv(x, "
    "perm=...) / sendrecv(x, shift=...) on the mesh tier (the world tier, "
    "one process per rank, is not ported yet)"
)


def send(x, dest, tag=0, *, comm=None, token=None):
    """Send ``x`` to rank ``dest`` (world tier only; raises
    ``NotImplementedError`` on a mesh comm)."""
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("send", x, comm)
    _validation.check_static_int("dest", dest)
    _validation.check_static_int("tag", tag)
    raise NotImplementedError(MESH_P2P.format(op="send", peer="receiver"))
