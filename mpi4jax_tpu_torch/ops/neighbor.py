"""neighbor_exchange — bidirectional 1-D ring exchange in one op.

The counterpart of ``mpi4jax_tpu/ops/neighbor.py``: a world-tier op (the
halo path of one process per rank, not ported yet).  On the mesh tier the
halo path is ``parallel.halo.halo_exchange`` (``ring_shift2`` on the hop
kernel), so a mesh comm raises, as in the JAX package.
"""

from __future__ import annotations

from ..utils import validation as _validation


def neighbor_exchange(to_lo, to_hi, *, lo, hi, comm=None, tag=60,
                      token=None):
    """Exchange strips with the two 1-D ring neighbours (world tier only;
    raises ``NotImplementedError`` on a mesh comm)."""
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("neighbor_exchange", to_lo, comm)
    _validation.check_tensor("neighbor_exchange", to_hi, comm)
    raise NotImplementedError(
        "neighbor_exchange is a world-tier op; on the mesh tier use "
        "mpi4jax_tpu_torch.halo_exchange (ring_shift2 on the hop kernel) or "
        "sendrecv(shift=±1)")
