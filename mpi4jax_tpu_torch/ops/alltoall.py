"""alltoall — transpose chunks across ranks (the FFT-slab and MoE move).

The counterpart of ``mpi4jax_tpu/ops/alltoall.py``.  On the mesh tier one
launch of the alltoall kernel (``_collectives.alltoall``), differentiable
(the op is its own transpose); on the world tier the transport's exchange
(``_world_impl.alltoall``): the exact pairwise one, or a schedule of the
alltoall family forced with ``algo=`` (``qalltoall``, ``halltoall``,
``hqalltoall``) or picked by ``compression="int8"``
(``quantized.native_quant_alltoall``).
"""

from __future__ import annotations

from ..utils import algos as _algos
from ..utils import tracing as _tracing
from ..utils import validation as _validation
from . import _dispatch, _mesh_impl


def alltoall(x, *, comm=None, token=None, compression=None, algo=None):
    """Exchange chunks: rank r's output row ``j`` is rank ``j``'s input row
    ``r``.

    On the mesh tier ``x`` is ``(*lead, size, ...)``: the mesh's rank
    dimensions, then each rank's ``(size, ...)`` buffer; on the world tier
    this rank's ``(size, ...)`` buffer (another leading size raises
    ``ValueError``).  ``algo=`` and ``compression=`` are checked as in the
    JAX package: an unknown value raises ``ValueError``, and a valid one
    raises ``NotImplementedError`` on the mesh tier, as there (both belong
    to the world-tier transport).  On the world tier ``algo=`` forces the
    schedule of this call (every rank forces the same one): ``"ring"`` the
    exact exchange, ``"qalltoall"`` every off-rank chunk through the int8
    codec, ``"halltoall"`` the hierarchical exchange (a permutation, bit
    for bit the flat one), ``"hqalltoall"`` its leader leg quantized.
    ``compression="int8"`` (real floating dtypes, about 1e-2 relative error
    on off-rank chunks, the own chunk exact) picks ``qalltoall``, or the
    exact exchange under ``MPI4JAX_TPU_COLL_QUANT=deny``.  The transport
    applies the gates (``COLL_QUANT=deny|force``, ``MPI4JAX_TPU_HIER=
    deny``) and degrades integer payloads to the exact exchange; bf16 rides
    its f32 staging.  The result has no gradient on the world tier, as in
    the JAX package.  With ``token=`` both tiers return ``(result,
    token)``.
    """
    comm = _validation.resolve_comm(comm)
    _dispatch.check_token(token)
    world = _validation.is_world(comm)
    if world:
        _validation.check_world_tensor("alltoall", x, comm)
    else:
        _validation.check_tensor("alltoall", x, comm)
    if algo is not None:
        algo = _algos.check_algo(algo, "alltoall")
        if not world:
            _validation.fail(
                "algo= forces a WORLD-tier transport schedule; the mesh "
                "tier has one alltoall kernel", op="alltoall", comm=comm,
                x=x, exc=NotImplementedError)
        if compression is not None:
            _validation.fail(
                "compression='int8' selects its own wire format; do not "
                "combine it with algo=", op="alltoall", comm=comm, x=x,
                exc=ValueError)
    if compression is not None:
        if compression != "int8":
            _validation.fail(
                f"unknown compression {compression!r}; supported: 'int8'",
                op="alltoall", comm=comm, x=x, exc=ValueError)
        if not world:
            _validation.fail(
                "compression='int8' rides the world-tier transport wire "
                "format; the mesh tier has one alltoall kernel",
                op="alltoall", comm=comm, x=x, exc=NotImplementedError)
        from .quantized import check_quantizable, native_quant_alltoall

        check_quantizable(x, comm)
        # None: the exact exchange (COLL_QUANT=deny), the same process-wide
        # signal on every rank
        algo = native_quant_alltoall()
    if not world:
        _tracing.trace_mesh_op(comm, "Alltoall")
        return _dispatch.attach(_mesh_impl.alltoall(x, comm), token)
    from . import _world_impl

    _validation.check_wire_dtype("alltoall", x, comm)
    if x.dim() < 1 or x.shape[0] != comm.size():
        _validation.fail(
            f"alltoall requires leading axis == communicator size "
            f"({comm.size()})", op="alltoall", comm=comm, x=x,
            exc=ValueError)
    return _dispatch.attach_world(
        _world_impl.alltoall(x, comm, algo=algo), token, comm)
