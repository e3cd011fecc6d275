"""sendrecv — paired exchange along a static permutation.

The counterpart of ``mpi4jax_tpu/ops/sendrecv.py`` on the mesh tier:
``perm=[(src, dst), ...]`` or ``shift=k`` (data moves to ``rank + k``, a
ring with ``wrap=True``).  A ring rides ``ring_shift``, any other
permutation a hop; ranks that are no destination receive zeros.  The
gradient sends the cotangent back along each edge.
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _mesh_impl


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
    world tier and raise here, as on the JAX package's mesh tier.
    """
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("sendrecv", x, comm)
    _validation.check_no_token("sendrecv", token, comm, x)
    if tag is not None:
        sendtag = recvtag = _validation.check_static_int("tag", tag)
    sendtag = _validation.check_static_int("sendtag", sendtag)
    if recvtag is not None:
        recvtag = _validation.check_static_int("recvtag", recvtag)
    if source is not None or dest is not None:
        raise ValueError(
            "mesh-tier sendrecv takes the global pattern (perm=[(src, dst), "
            "...] or shift=k), not per-rank source/dest ints")
    if status is not None:
        raise ValueError("status introspection is world-tier only")
    if sendtag != 0 or (recvtag is not None and recvtag != sendtag):
        raise ValueError("message tags are world-tier only")
    pairs = _resolve_perm(comm, perm, shift, wrap)
    return _mesh_impl.sendrecv(x, pairs, comm)
