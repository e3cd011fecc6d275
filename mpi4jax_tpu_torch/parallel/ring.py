"""Ring attention: exact attention over sequence shards with a k/v ring.

The counterpart of ``mpi4jax_tpu/parallel/ring.py`` on the mesh tier.  q,
k and v are ``(*lead, B, T_local, H, D)``: the comm's mesh rank dimensions
leading (``parallel/mesh.py``), then each rank's shard of the sequence, in
rank order along the comm.  Causality is resolved at global positions.
Each ring step rotates k and v one hop together (``ring_shift_n``, one
launch of the hop kernel on the card).  Both routes are differentiable: the
flash route's backward runs kernels 6 and 7 and carries dk and dv home
around the ring (``ops/flash.py``), the recurrence's goes through torch
autograd and the hop's backward.
"""

from __future__ import annotations

import torch

from ..ops import _collectives
from ..ops.flash import check_qkv, ring_flash_attention


def ring_attention(q, k, v, *, comm=None, causal: bool = False, scale=None,
                   impl: str = "auto", block_q: int = None,
                   block_k: int = None):
    """Exact (flash-accumulated) attention across a sequence-sharded ring.

    Args:
        q, k, v: ``(*lead, B, T_local, H, D)`` on the mesh layout of
            ``comm``, the sequence sharded over its ranks.
        comm: the ring's communicator (default: ambient).
        causal: apply a causal mask over global positions.
        scale: score scale (default ``1/sqrt(D)``).
        impl: ``"pallas"``: the flash route, kernel 5 for the local blocks
            and kernels 6 and 7 for their backward (``ops/flash.py``; the
            name is the JAX package's); ``"xla"``:
            the einsum recurrence below in plain torch, differentiable
            through torch autograd and the hop's backward; ``"auto"``:
            the flash route on a CUDA tensor, the recurrence on a CPU
            tensor.  A tensor ``scale`` on a CUDA tensor needs
            ``impl="xla"`` by name: ``"auto"`` raises rather than put the
            recurrence, which holds every step's full score matrix, in
            kernel 5's place.
        block_q, block_k: the JAX package's tile sizes, accepted for its
            API and ignored (the CUDA kernel uses its own tile).

    Returns:
        ``(*lead, B, T_local, H, D)`` attention output, sharded like q.
    """
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    comm = check_qkv(q, k, v, comm)
    scale_tensor = isinstance(scale, torch.Tensor)
    on_card = q.device.type == "cuda"
    if impl == "auto":
        if on_card and scale_tensor:
            raise ValueError(
                "ring_attention on a CUDA tensor with a tensor scale: pass "
                "impl='xla' to run the plain recurrence (no kernel; it "
                "holds each step's full score matrix), or a float scale for "
                "the flash route")
        impl = "pallas" if on_card else "xla"
    if impl == "pallas":
        if scale_tensor:
            raise ValueError(
                "impl='pallas' needs a Python float scale; got a tensor "
                "(use impl='xla' for a learnable scale)")
        return ring_flash_attention(q, k, v, comm=comm, causal=causal,
                                    scale=scale)
    return _ring_recurrence(q, k, v, comm, causal, scale)


def _ring_recurrence(q, k, v, comm, causal, scale):
    n = comm.size()
    lead = comm.layout_shape
    t_loc, _, d = q.shape[-3:]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=q.dtype,
                                              device=q.device))

    # work in (*lead, B, H, T, D) for clean einsums
    qt = q.transpose(-3, -2).float()
    kt = k.transpose(-3, -2)
    vt = v.transpose(-3, -2)
    # (*lead, 1, ..., 1): broadcast a per-rank value over B and H
    per_rank = (*lead,) + (1,) * (qt.dim() - len(lead) - 2)
    me = comm.rank(q.device)
    pos = torch.arange(t_loc, device=q.device)
    q_pos = (me[..., None] * t_loc + pos).reshape(*per_rank, t_loc, 1)

    neg_inf = torch.finfo(torch.float32).min
    shape = qt.shape[:-1]
    o = torch.zeros(qt.shape, dtype=torch.float32, device=q.device)
    m = torch.full(shape, neg_inf, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = kt, vt
    for i in range(n):
        # after i hops, each rank holds the block of comm rank me - i
        scores = torch.einsum("...qd,...kd->...qk", qt, k_cur.float()) * scale
        if causal:
            src = (me - i) % n
            k_pos = (src[..., None] * t_loc + pos).reshape(*per_rank, 1,
                                                          t_loc)
            scores = torch.where(q_pos >= k_pos, scores, neg_inf)
        m_blk = scores.amax(-1)
        m_new = torch.maximum(m, m_blk)
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("...qk,...kd->...qd", p,
                                               v_cur.float())
        m = m_new
        if i < n - 1:  # the n-th hop would return blocks nobody reads
            k_cur, v_cur = _collectives.ring_shift_n((k_cur, v_cur), comm, 1)
    out = o / l[..., None]
    return out.transpose(-3, -2).to(q.dtype)
