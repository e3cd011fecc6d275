"""neighbor_exchange — bidirectional 1-D ring exchange in one op.

The counterpart of ``mpi4jax_tpu/ops/neighbor.py``: a world-tier op (the
halo path of one process per rank), the transport's ``shift2``
(``_world_impl.neighbor_exchange``).  On the mesh tier the halo path is
``parallel.halo.halo_exchange`` (``ring_shift2`` on the hop kernel), so a
mesh comm raises, as in the JAX package.
"""

from __future__ import annotations

from ..utils import validation as _validation
from . import _dispatch


def neighbor_exchange(to_lo, to_hi, *, lo, hi, comm=None, tag=60,
                      token=None):
    """Exchange strips with the two 1-D ring neighbours, in one op.

    ``to_lo`` / ``to_hi``: strips of one shape sent to the low / high
    neighbour.  ``lo`` / ``hi``: neighbour ranks, or ``None`` for a wall
    (nothing is sent or received on that side; the strip returned there is
    the opposite input, to be ignored).  ``tag``: the base message tag (the
    high direction's frames use ``tag + 1``).

    Returns ``(from_lo, from_hi)``, the strips received from the low / high
    neighbour.  A self-wrap (both neighbours the own rank, a periodic ring
    of one) is a local rotation.  Free of deadlock on any chain or ring
    when every member calls it at the same point of its program.  World
    tier only: a mesh comm raises ``NotImplementedError``.
    """
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    if not _validation.is_world(comm):
        _validation.check_tensor("neighbor_exchange", to_lo, comm)
        _validation.check_tensor("neighbor_exchange", to_hi, comm)
        raise NotImplementedError(
            "neighbor_exchange is a world-tier op; on the mesh tier use "
            "mpi4jax_tpu_torch.halo_exchange (ring_shift2 on the hop "
            "kernel) or sendrecv(shift=±1)")
    from . import _world_impl

    _validation.check_world_tensor("neighbor_exchange", to_lo, comm,
                                   name="to_lo")
    _validation.check_world_tensor("neighbor_exchange", to_hi, comm,
                                   name="to_hi")
    if to_lo.shape != to_hi.shape or to_lo.dtype != to_hi.dtype:
        _validation.fail(
            f"to_lo and to_hi must match: {tuple(to_lo.shape)} "
            f"{to_lo.dtype} against {tuple(to_hi.shape)} {to_hi.dtype}",
            op="neighbor_exchange", comm=comm, x=to_lo, exc=ValueError)
    for name, r in (("lo", lo), ("hi", hi)):
        if r is not None:
            _validation.check_in_range(name, int(r), comm.size(),
                                       op="neighbor_exchange", comm=comm)
    _validation.check_wire_dtype("neighbor_exchange", to_lo, comm)
    out = _world_impl.neighbor_exchange(to_lo, to_hi, lo=lo, hi=hi,
                                        comm=comm, tag=tag)
    return _dispatch.attach_world(out, token, comm)
