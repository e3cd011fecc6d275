"""The world tier's allreduce on eager torch tensors.

The counterpart of the allreduce of ``mpi4jax_tpu/ops/_world_impl.py``:
one process per rank, the native transport between them.  A CUDA tensor
is synchronized (the copy to the host waits for the work queued before
it), copied into pinned host memory, reduced by ``bridge.allreduce_raw``
with its forced algorithm code, and copied back to the card; program
order on the one stream is the ordering contract.  The transport's
hierarchical schedules run the intra-island leg on the card
(``topo/_ici_leg.py``).

The gradient of an allreduce-SUM is the identity on the cotangent, as the
reference's transposed pass (``allreduce.py:87-89`` there).
"""

from __future__ import annotations

import torch

from ..runtime import bridge
from ..utils import algos


def _staged(x: torch.Tensor, comm, code: int) -> torch.Tensor:
    flat = x.detach().reshape(-1)
    pin = flat.device.type == "cuda"
    send = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=pin)
    send.copy_(flat)  # from the card: waits for the stream
    recv = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=pin)
    bridge.allreduce_raw(comm.handle, send.numpy(), recv.numpy(),
                         bridge.F32, bridge.SUM, algo=code)
    return recv.to(x.device).reshape(x.shape)


class _AllreduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, code):
        return _staged(x, comm, code)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def allreduce_sum(x: torch.Tensor, comm, algo: str) -> torch.Tensor:
    """The f32 SUM of ``x`` over the world ``comm``'s ranks, with the
    schedule ``algo`` forced."""
    return _AllreduceSum.apply(x, comm, algos.ALGO_CODES[algo])
