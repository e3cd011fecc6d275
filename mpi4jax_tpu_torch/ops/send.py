"""send — point-to-point send.

The counterpart of ``mpi4jax_tpu/ops/send.py``.  A lone send needs ranks
that run different programs: the world tier, where it is the transport's
send (``_world_impl.send``).  In one SPMD program every rank runs every
line, so an unpaired send has no receiver call; the mesh tier rejects it
and points to ``sendrecv``.
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _dispatch

MESH_P2P = (
    "{op}() has no meaning inside a single SPMD program: every rank executes "
    "the same code, so there is no separate {peer}. Use sendrecv(x, "
    "perm=...) / sendrecv(x, shift=...) on the mesh tier, or run one "
    "process per rank (python -m mpi4jax_tpu_torch.runtime.launch) for "
    "MPMD send/recv"
)


def send(x, dest, tag=0, *, comm=None, token=None):
    """Send ``x`` to rank ``dest`` (world tier only; raises
    ``NotImplementedError`` on a mesh comm).  Returns ``None``, or with
    ``token=`` that token."""
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if not _validation.is_world(comm):
        _validation.check_tensor("send", x, comm)
        _validation.check_static_int("dest", dest)
        _validation.check_static_int("tag", tag)
        raise NotImplementedError(MESH_P2P.format(op="send",
                                                  peer="receiver"))
    from . import _world_impl

    _validation.check_world_tensor("send", x, comm)
    dest = _validation.check_static_int("dest", dest)
    tag = _validation.check_static_int("tag", tag)
    _validation.check_in_range("dest", dest, comm.size(), op="send",
                               comm=comm)
    _validation.check_wire_dtype("send", x, comm)
    _world_impl.send(x, dest, tag, comm)
    return _world_impl.chain_token(comm, token)
