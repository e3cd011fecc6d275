"""recv — point-to-point receive.

The counterpart of ``mpi4jax_tpu/ops/recv.py``.  Like ``send``, a lone
receive needs per-rank programs (the world tier, not ported yet); the mesh
tier rejects it and points to ``sendrecv``.
"""

from __future__ import annotations

from ..utils import validation as _validation
from .send import MESH_P2P


def recv(x, source, tag=None, *, comm=None, token=None, status=None):
    """Receive into the shape and dtype of ``x`` from rank ``source``
    (world tier only; raises ``NotImplementedError`` on a mesh comm)."""
    comm = _validation.resolve_comm(comm)
    _validation.check_tensor("recv", x, comm)
    _validation.check_static_int("source", source)
    if tag is not None:
        _validation.check_static_int("tag", tag)
    raise NotImplementedError(MESH_P2P.format(op="recv", peer="sender"))
