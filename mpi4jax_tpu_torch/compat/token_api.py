"""The explicit-token API: the reference's ``res, token = op(...)``.

The counterpart of ``mpi4jax_tpu/compat/token_api.py``.  Every function
returns ``(result, token)`` (the token alone for ``send`` and
``barrier``) and accepts ``token=None`` to start a chain, as in

    res, token = allreduce(x, op=SUM, comm=comm, token=token)

The tokens are the port's (``ops/_dispatch.py``): 0-d ``uint32`` zeros on
the comm's device.  The port runs eagerly, so program order already
orders the ops; a chain adds no launch and changes no result.
"""

from __future__ import annotations

from .. import ops as _ops
from ..ops import _dispatch
from ..ops.reduce_ops import SUM

create_token = _dispatch.create_token


def _start(token, x=None, comm=None):
    return _dispatch.create_token(x, comm=comm) if token is None else token


def allreduce(x, op=SUM, *, comm=None, token=None):
    return _ops.allreduce(x, op, comm=comm, token=_start(token, x))


def allgather(x, *, comm=None, token=None):
    return _ops.allgather(x, comm=comm, token=_start(token, x))


def alltoall(x, *, comm=None, token=None):
    return _ops.alltoall(x, comm=comm, token=_start(token, x))


def barrier(*, comm=None, token=None):
    return _ops.barrier(comm=comm, token=_start(token, comm=comm))


def bcast(x, root=0, *, comm=None, token=None):
    return _ops.bcast(x, root, comm=comm, token=_start(token, x))


def gather(x, root=0, *, comm=None, token=None):
    return _ops.gather(x, root, comm=comm, token=_start(token, x))


def recv(x, source, tag=None, *, comm=None, token=None, status=None):
    return _ops.recv(x, source, tag, comm=comm, token=_start(token, x),
                     status=status)


def reduce(x, op=SUM, root=0, *, comm=None, token=None):
    return _ops.reduce(x, op, root, comm=comm, token=_start(token, x))


def scan(x, op=SUM, *, comm=None, token=None):
    return _ops.scan(x, op, comm=comm, token=_start(token, x))


def scatter(x, root=0, *, comm=None, token=None):
    return _ops.scatter(x, root, comm=comm, token=_start(token, x))


def send(x, dest, tag=0, *, comm=None, token=None):
    return _ops.send(x, dest, tag, comm=comm, token=_start(token, x))


def sendrecv(x, *, perm=None, shift=None, wrap=True, source=None, dest=None,
             tag=None, sendtag=0, recvtag=None, status=None, comm=None,
             token=None):
    return _ops.sendrecv(
        x, perm=perm, shift=shift, wrap=wrap, source=source, dest=dest,
        tag=tag, sendtag=sendtag, recvtag=recvtag, status=status,
        comm=comm, token=_start(token, x))


__all__ = [
    "allgather", "allreduce", "alltoall", "barrier", "bcast", "create_token",
    "gather", "recv", "reduce", "scan", "scatter", "send", "sendrecv",
]
