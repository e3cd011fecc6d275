"""Mixture-of-Experts expert parallelism: the alltoall dispatch and combine.

The counterpart of ``mpi4jax_tpu/parallel/moe.py``.  Experts are
rank-sharded (one expert per rank of ``comm``); every token is routed
top-1 and shipped to its expert's rank with one ``alltoall``, the expert
FFN runs per rank, and a second ``alltoall`` brings the outputs home.
Each rank reserves ``capacity`` slots per expert; tokens past it are
dropped and come back as zeros (the Switch capacity rule).

On a mesh comm the tensors have the mesh's rank dimensions leading:
tokens ``(*lead, t, d)``; the parameters hold one entry per rank
(``w_gate`` a replica each, ``w_in``/``b_in``/``w_out``/``b_out`` that
rank's expert), and both exchanges are the mesh ``alltoall`` front (one
launch of the alltoall kernel on the card).  On a world comm (one process
per rank) ``x`` is this rank's ``(t, d)`` tokens and ``params`` this
rank's gate replica and expert, as in the JAX package
(``mpi4jax_tpu/parallel/moe.py:34-124``): the exchanges are the world
``alltoall`` through the transport, and ``compression=`` and ``algo=``
pass straight to it (``"int8"`` for the quantized dispatch wire,
``"qalltoall"``/``"halltoall"``/``"hqalltoall"`` to force a schedule); on
a mesh comm they raise, as in the JAX package.  The binning is
``index_put(..., accumulate=True)``: a slot holds at most one kept token,
and dropped tokens add zeros, so the sums are exact in any order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.alltoall import alltoall
from ..utils.device import resolve_device
from ..utils.validation import is_world
from .mesh import get_default_comm


def _resolve(comm):
    return comm if comm is not None else get_default_comm()


def _lead(comm) -> tuple:
    """The rank dimensions in front of each rank's tensors: the mesh
    layout's, none on a world comm."""
    return () if is_world(comm) else tuple(comm.layout_shape)


def expert_capacity(tokens: int, n_experts: int,
                    capacity_factor: float = 1.25) -> int:
    """Token slots each rank reserves per expert."""
    return max(1, int(math.ceil(tokens / n_experts * capacity_factor)))


def router_top1(x, w_gate):
    """Top-1 routing per token: ``(expert_idx int32, gate_prob,
    full_probs)``.  The softmax runs in f32 whatever the activation
    dtype."""
    logits = torch.matmul(x, w_gate)
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(probs, dim=-1).to(torch.int32)
    prob = torch.gather(probs, -1, idx[..., None].long())[..., 0]
    return idx, prob, probs


def _rank_index(lead, t, device):
    """Per token of each rank, the rank's flat index: ``(R, t)``."""
    r = math.prod(lead)
    return torch.arange(r, device=device)[:, None].expand(r, t)


def dispatch(x, expert_idx, capacity: int, *, comm=None, compression=None,
             algo=None):
    """Bin each rank's tokens per destination expert and exchange them.

    Returns ``(expert_inputs, route)``: ``expert_inputs`` is ``(*lead,
    size, capacity, d)``, row j the tokens rank j routed to this rank's
    expert; ``route`` is what :func:`combine` needs.
    """
    comm = _resolve(comm)
    size = comm.size()
    lead = _lead(comm)
    t, d = x.shape[len(lead):]
    idx = expert_idx.reshape(-1, t).long()
    oh = torch.nn.functional.one_hot(idx, size)
    # position of each token in its expert's queue (0-based)
    pos = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1
    keep = (pos >= 0) & (pos < capacity)
    pos_c = pos.clamp(0, capacity - 1)
    flat = x.reshape(-1, t, d)
    buf = flat.new_zeros(flat.shape[0], size, capacity, d)
    # accumulate, not set: a dropped token adds zeros to a clipped slot
    # that may also hold a kept token
    ranks = _rank_index(lead, t, x.device)
    buf = buf.index_put(
        (ranks, idx, pos_c),
        torch.where(keep[..., None], flat, torch.zeros_like(flat)),
        accumulate=True)
    recv = alltoall(buf.reshape(*lead, size, capacity, d), comm=comm,
                    compression=compression, algo=algo)
    return recv, (idx, pos_c, keep)


def combine(expert_out, route, *, comm=None, compression=None, algo=None):
    """The return trip of :func:`dispatch`: each expert's outputs back to
    the ranks that sent the tokens, in token order; dropped tokens are
    zeros."""
    comm = _resolve(comm)
    lead = _lead(comm)
    idx, pos_c, keep = route
    back = alltoall(expert_out, comm=comm, compression=compression,
                    algo=algo)
    size, cap, d = back.shape[len(lead):]
    ranks = _rank_index(lead, idx.shape[-1], back.device)
    y = back.reshape(-1, size, cap, d)[ranks, idx, pos_c]
    y = torch.where(keep[..., None], y, torch.zeros_like(y))
    return y.reshape(*lead, idx.shape[-1], d)


def moe_ffn(x, params, *, comm=None, capacity_factor: float = 1.25,
            compression=None, algo=None):
    """One expert-parallel MoE FFN block: route, dispatch, this rank's
    expert (a two-layer relu FFN), combine, weight by the gate.

    ``x``: ``(*lead, tokens, d_model)``, each rank's tokens.  ``params``:
    ``w_gate (*lead, d_model, size)`` (a replica per rank) and each rank's
    expert ``w_in (*lead, d_model, d_ff)``, ``b_in``, ``w_out (*lead,
    d_ff, d_model)``, ``b_out`` (see :func:`init_moe_params`); ``lead`` is
    empty on a world comm.
    """
    comm = _resolve(comm)
    size = comm.size()
    lead = _lead(comm)
    t, d = x.shape[len(lead):]
    idx, prob, _ = router_top1(x, params["w_gate"])
    cap = expert_capacity(t, size, capacity_factor)
    recv, route = dispatch(x, idx, cap, comm=comm, compression=compression,
                           algo=algo)
    flat = recv.reshape(*lead, size * cap, d)
    b_in = params["b_in"].unsqueeze(-2)
    b_out = params["b_out"].unsqueeze(-2)
    h = torch.relu(torch.matmul(flat, params["w_in"]) + b_in)
    out = (torch.matmul(h, params["w_out"]) + b_out).to(x.dtype)
    y = combine(out.reshape(*lead, size, cap, d), route, comm=comm,
                compression=compression, algo=algo)
    return y * prob[..., None].to(y.dtype)


def init_moe_params(d_model: int, d_ff: int, n_experts: int, seed: int = 0,
                    dtype=np.float32) -> dict:
    """The gate and every rank's expert, as numpy arrays stacked over the
    ``n_experts`` ranks, drawn from ``np.random.RandomState(seed)`` with the
    JAX package's scales (``1/sqrt(d_model)`` in, ``1/sqrt(d_ff)`` out):
    the port's own initialisation (the JAX package draws from
    ``jax.random``; :func:`params_from_numpy` carries its draws over)."""
    rng = np.random.RandomState(seed)
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_ff)
    w_gate = (rng.randn(d_model, n_experts) * scale_in).astype(dtype)
    w_in = (rng.randn(n_experts, d_model, d_ff) * scale_in).astype(dtype)
    w_out = (rng.randn(n_experts, d_ff, d_model) * scale_out).astype(dtype)
    return {
        "w_gate": np.broadcast_to(w_gate, (n_experts, *w_gate.shape)).copy(),
        "w_in": w_in,
        "b_in": np.zeros((n_experts, d_ff), dtype),
        "w_out": w_out,
        "b_out": np.zeros((n_experts, d_model), dtype),
    }


def params_from_numpy(per_rank, device=None, rank=None) -> dict:
    """MoE parameters as tensors on ``device`` (default ``cuda:0``), one
    entry per rank of a 1-D mesh: ``per_rank`` is either a list of the JAX
    package's per-rank dicts (``init_moe_params(key, ..., expert_rank=r)``
    for each rank r, through ``np.asarray``), stacked here over the ranks,
    or a dict already stacked (the port's ``init_moe_params``).  With
    ``rank`` (a world comm's rank), only that rank's slice: its gate
    replica and its expert, the JAX world tier's per-rank dict."""
    dev = resolve_device(device)
    if isinstance(per_rank, dict):
        stacked = {k: np.asarray(v) for k, v in per_rank.items()}
    else:
        stacked = {k: np.stack([np.asarray(p[k]) for p in per_rank])
                   for k in per_rank[0]}
    if rank is not None:
        stacked = {k: v[int(rank)] for k, v in stacked.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in stacked.items()}
