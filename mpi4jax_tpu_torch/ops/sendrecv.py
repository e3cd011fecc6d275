"""sendrecv — paired exchange along a static permutation.

The counterpart of ``mpi4jax_tpu/ops/sendrecv.py``.  On the mesh tier:
``perm=[(src, dst), ...]`` or ``shift=k`` (data moves to ``rank + k``, a
ring with ``wrap=True``).  A ring rides ``ring_shift``, any other
permutation a hop; ranks that are no destination receive zeros.  On the
world tier: this rank's ``source``/``dest``, or ``perm=``/``shift=``
resolved against its rank, through the transport's sendrecv
(``_world_impl.sendrecv``), with split tags and a ``Status``.  On both the
gradient sends the cotangent back along each edge.
"""

from __future__ import annotations

from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl


def _resolve_perm(comm, perm, shift, wrap):
    if (perm is None) == (shift is None):
        raise ValueError("pass exactly one of perm= or shift=")
    if perm is not None:
        return [
            (
                _validation.check_static_int("source", s),
                _validation.check_static_int("dest", d),
            )
            for s, d in perm
        ]
    shift = _validation.check_static_int("shift", shift)
    return _mesh_impl.ring_perm(comm.size(), shift, wrap)


def sendrecv(x, *, perm=None, shift=None, wrap=True, source=None, dest=None,
             tag=None, sendtag=0, recvtag=None, status=None, comm=None,
             token=None):
    """Exchange ``x`` along a static rank permutation.

    Each pair ``(s, d)`` delivers rank ``s``'s block to rank ``d``.  The
    per-rank ``source=``/``dest=`` ints, tags and ``status`` belong to the
    world tier and raise on the mesh tier, as on the JAX package's.

    On the world tier ``x`` is this rank's tensor, sent to ``dest`` while
    the result arrives from ``source`` (or both from ``perm=``/``shift=``:
    a rank outside the permutation, or a shift past the edge without
    ``wrap``, raises ``ValueError``).  ``tag=k`` is ``sendtag=k,
    recvtag=k``; ``recvtag=None`` matches the send tag, or any tag
    (``ANY_TAG``) when ``status`` is given, which is then filled with what
    arrived.  Without a status a message of another size exits the job.
    """
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if _validation.is_world(comm):
        _validation.check_world_tensor("sendrecv", x, comm)
    else:
        _validation.check_tensor("sendrecv", x, comm)
    if tag is not None:
        sendtag = recvtag = _validation.check_static_int("tag", tag)
    sendtag = _validation.check_static_int("sendtag", sendtag)
    if recvtag is not None:
        recvtag = _validation.check_static_int("recvtag", recvtag)
    if _validation.is_world(comm):
        return _dispatch.attach_world(
            _world_sendrecv(x, comm, perm, shift, wrap, source, dest,
                            sendtag, recvtag, status), token, comm)
    if source is not None or dest is not None:
        raise ValueError(
            "mesh-tier sendrecv takes the global pattern (perm=[(src, dst), "
            "...] or shift=k), not per-rank source/dest ints")
    if status is not None:
        raise ValueError("status introspection is world-tier only")
    if sendtag != 0 or (recvtag is not None and recvtag != sendtag):
        raise ValueError("message tags are world-tier only")
    pairs = _resolve_perm(comm, perm, shift, wrap)
    _tracing.trace_mesh_op(comm, "Sendrecv", f"perm {pairs}")
    return _dispatch.attach(_mesh_impl.sendrecv(x, pairs, comm), token)


def _world_sendrecv(x, comm, perm, shift, wrap, source, dest, sendtag,
                    recvtag, status):
    from ..utils.status import ANY_TAG, Status
    from . import _world_impl

    _validation.check_wire_dtype("sendrecv", x, comm)
    if status is not None and not isinstance(status, Status):
        raise TypeError(f"status must be an mpi4jax_tpu_torch.Status, got "
                        f"{type(status)}")
    if recvtag is None:
        recvtag = ANY_TAG if status is not None else sendtag
    if source is None or dest is None:
        source, dest = _world_impl.resolve_edge(comm, perm, shift, wrap)
    return _world_impl.sendrecv(x, comm=comm, source=int(source),
                                dest=int(dest), sendtag=sendtag,
                                recvtag=recvtag, status=status)
