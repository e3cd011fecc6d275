"""recv — point-to-point receive.

The counterpart of ``mpi4jax_tpu/ops/recv.py``.  Like ``send``, a lone
receive needs per-rank programs: on the world tier it is the transport's
receive (``_world_impl.recv``); the mesh tier rejects it and points to
``sendrecv``.
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _dispatch
from ..utils.status import ANY_SOURCE, ANY_TAG, Status
from .send import MESH_P2P


def recv(x, source, tag=None, *, comm=None, token=None, status=None):
    """Receive into the shape and dtype of ``x`` from rank ``source``
    (world tier only; raises ``NotImplementedError`` on a mesh comm).

    ``tag=None`` accepts any tag (``ANY_TAG``); ``source`` may be
    ``ANY_SOURCE`` (the first complete frame from any peer wins).
    ``status``, a :class:`~mpi4jax_tpu_torch.Status`, is filled with the
    source, tag and byte count that arrived; with it a shorter message is
    accepted into the zeroed buffer, without it the arrived size must equal
    ``x``'s (the transport exits the job otherwise).
    """
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if not _validation.is_world(comm):
        _validation.check_tensor("recv", x, comm)
        _validation.check_static_int("source", source)
        if tag is not None:
            _validation.check_static_int("tag", tag)
        raise NotImplementedError(MESH_P2P.format(op="recv", peer="sender"))
    from . import _world_impl

    _validation.check_world_tensor("recv", x, comm)
    source = _validation.check_static_int("source", source)
    tag = _validation.check_static_int("tag", ANY_TAG if tag is None
                                       else tag)
    if status is not None and not isinstance(status, Status):
        raise TypeError(f"status must be an mpi4jax_tpu_torch.Status, got "
                        f"{type(status)}")
    if source != ANY_SOURCE:
        _validation.check_in_range("source", source, comm.size(), op="recv",
                                   comm=comm)
    _validation.check_wire_dtype("recv", x, comm)
    return _dispatch.attach_world(
        _world_impl.recv(x, source, tag, comm, status), token, comm)
