"""Ulysses-style sequence parallelism: alltoall head/sequence re-sharding.

The counterpart of ``mpi4jax_tpu/parallel/ulysses.py``, with ``comm=`` in
place of ``axis=``.  Sequence-sharded activations are re-sharded to
head-sharded with one alltoall, attention runs per rank over the whole
sequence of its head group, and a second alltoall restores the sequence
sharding.  Tensors have the mesh's rank dimensions leading:
``(*lead, B, T_local, H, D)``.  Both transposes are the mesh ``alltoall``
(one launch of the alltoall kernel on the card); the JAX package calls
``lax.all_to_all`` there directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.alltoall import alltoall


def seq_to_heads(x, *, comm):
    """``(*lead, B, T_local, H, D)`` sequence-sharded to ``(*lead, B,
    T_global, H_local, D)`` head-sharded."""
    size = comm.size()
    lead = comm.layout_shape
    L = len(lead)
    b, t_loc, h, d = x.shape[L:]
    if h % size:
        raise ValueError(f"heads ({h}) must divide the axis size ({size})")
    h_loc = h // size
    # split heads into `size` groups, one per destination rank
    x = x.reshape(*lead, b, t_loc, size, h_loc, d).movedim(L + 2, L)
    # (*lead, size, B, T_local, H_local, D): row j -> rank j
    x = alltoall(x.contiguous(), comm=comm)
    # rows now hold every rank's sequence chunk of our head group
    x = x.movedim(L, L + 1)
    return x.reshape(*lead, b, size * t_loc, h_loc, d)


def heads_to_seq(x, *, comm):
    """The inverse of :func:`seq_to_heads`."""
    size = comm.size()
    lead = comm.layout_shape
    L = len(lead)
    b, t_glob, h_loc, d = x.shape[L:]
    if t_glob % size:
        raise ValueError(
            f"global sequence ({t_glob}) must divide the axis size ({size})")
    t_loc = t_glob // size
    x = x.reshape(*lead, b, size, t_loc, h_loc, d).movedim(L + 1, L)
    x = alltoall(x.contiguous(), comm=comm)
    # (*lead, size, B, T_local, H_local, D) -> (*lead, B, T_local, size, ...)
    x = x.movedim(L, L + 2)
    return x.reshape(*lead, b, t_loc, size * h_loc, d)


def ulysses_attention(q, k, v, *, comm, causal: bool = False, scale=None):
    """Exact attention over the whole sequence by head sharding
    (DeepSpeed-Ulysses).

    ``q``, ``k``, ``v``: ``(*lead, B, T_local, H, D)`` sequence-sharded over
    ``comm``, whose size must divide H.  The attention is the JAX
    package's: scores in f32 scaled by ``1/sqrt(D)`` (an f32 value), the
    causal mask filled with the least f32, a max-subtracted softmax, the
    product with v in f32, then the cast to q's dtype.
    """
    if scale is None:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    qh = seq_to_heads(q, comm=comm)
    kh = seq_to_heads(k, comm=comm)
    vh = seq_to_heads(v, comm=comm)

    scores = torch.einsum("...qhd,...khd->...hqk", qh.float(),
                          kh.float()) * scale
    if causal:
        t = qh.shape[-3]
        mask = torch.ones(t, t, dtype=torch.bool,
                          device=scores.device).tril()
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("...hqk,...khd->...qhd", probs, vh.float())
    return heads_to_seq(out.to(q.dtype), comm=comm)
