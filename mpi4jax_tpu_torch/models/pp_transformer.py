"""Pipeline-parallel GPT: the layers split into stages over a pp comm.

The counterpart of ``mpi4jax_tpu/models/pp_transformer.py`` (BASELINE.md's
"Pipeline-parallel GPT-2 124M via point-to-point").  The schedule is the
SPMD GPipe of ``parallel/pipeline.py``: one hop launch per tick,
microbatches filling the bubble, autograd replaying the schedule
backward.

Every rank lives on one card and the pp axis leads every tensor: the
stage fields (``ln1`` ... ``b2``) are ``(pp, Ls, ...)``, rank r holding
stage r's ``Ls = n_layers / pp`` blocks, exactly the JAX package's global
layout; the replicated fields (``wte``, ``wpe``, ``lnf``) are held as one
replica per rank, ``(pp, ...)``, so that autograd gives each rank its own
gradient, which the step then SUM-allreduces over pp as the JAX step does.
Stage 0 embeds through the pipeline's ``prepare_fn``; the final norm, the
tied unembedding and the loss run on every stage, and the loss is kept on
the last one and SUM-allreduced over pp.  The model is f32 throughout, as
in the JAX package (``cfg.dtype`` is not read), and attention is the JAX
package's dense causal softmax.  The optimizer is SGD.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import SUM, allreduce
from ..parallel.mesh import MeshComm
from ..parallel.pipeline import pipeline_apply
from ..utils.device import resolve_device
from .transformer import GPTConfig, _layernorm

__all__ = ["GPTConfig", "PPGPT", "PPGPTParams", "REPLICATED", "init_params",
           "params_from_numpy"]


class PPGPTParams(NamedTuple):
    wte: object   # (vocab, d)      replicated
    wpe: object   # (max_seq, d)    replicated
    lnf: object   # (2, d)          replicated
    # stage-sharded stacks: leading pp axis, then layers per stage
    ln1: object   # (pp, Ls, 2, d)
    ln2: object   # (pp, Ls, 2, d)
    w_qkv: object  # (pp, Ls, d, 3d)
    w_o: object    # (pp, Ls, d, d)
    w1: object     # (pp, Ls, d, ff)
    b1: object     # (pp, Ls, ff)
    w2: object     # (pp, Ls, ff, d)
    b2: object     # (pp, Ls, d)


REPLICATED = ("wte", "wpe", "lnf")
STAGE = ("ln1", "ln2", "w_qkv", "w_o", "w1", "b1", "w2", "b2")


def init_params(cfg: GPTConfig, pp: int, seed: int = 0) -> PPGPTParams:
    """The JAX package's initial parameters as float32 numpy arrays: the
    same draws from ``np.random.RandomState(seed)`` in the same order
    (wte, wpe, w_qkv, w_o, w1, w2)."""
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide pp ({pp})")
    ls = cfg.n_layers // pp
    d, ff = cfg.d_model, cfg.d_ff
    rng = np.random.RandomState(seed)
    s = 0.02

    def norm(*shape):
        return rng.randn(*shape).astype(np.float32) * np.float32(s)

    ln = np.stack([np.ones((pp, ls, d), np.float32),
                   np.zeros((pp, ls, d), np.float32)], axis=2)
    return PPGPTParams(
        wte=norm(cfg.vocab, d),
        wpe=norm(cfg.max_seq, d),
        lnf=np.stack([np.ones((d,), np.float32), np.zeros((d,), np.float32)]),
        ln1=ln, ln2=ln.copy(),
        w_qkv=norm(pp, ls, d, 3 * d),
        w_o=norm(pp, ls, d, d),
        w1=norm(pp, ls, d, ff),
        b1=np.zeros((pp, ls, ff), np.float32),
        w2=norm(pp, ls, ff, d),
        b2=np.zeros((pp, ls, d), np.float32),
    )


def params_from_numpy(params, device=None) -> PPGPTParams:
    """A ``PPGPTParams`` of array-likes (the JAX package's parameters
    through ``np.asarray``, or ``init_params``'s) as new float32 tensors on
    ``device`` (default ``cuda:0``), in the global layout."""
    dev = resolve_device(device)

    def host(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    return PPGPTParams(*(torch.tensor(np.asarray(host(x), np.float32),
                                      device=dev) for x in params))


def _causal_attention(x, w_qkv, w_o, n_heads):
    """The JAX package's dense causal attention, batched over the ranks:
    ``x`` ``(R, B, T, d)``, ``w_qkv`` ``(R, d, 3d)``, ``w_o`` ``(R, d,
    d)``."""
    r, b, t, d = x.shape
    hd = d // n_heads
    qkv = torch.matmul(x.reshape(r, b * t, d), w_qkv).reshape(
        r, b, t, 3, n_heads, hd)
    q, k, v = qkv.unbind(3)
    scores = torch.einsum("rbqhd,rbkhd->rbhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("rbhqk,rbkhd->rbqhd", p, v).reshape(r, b * t, d)
    return torch.matmul(out, w_o).reshape(r, b, t, d)


class PPGPT:
    """The model on ``pp`` stages on one device.

    ``params``: a ``PPGPTParams`` in the global layout (numpy arrays or
    tensors; default ``init_params(cfg, pp, seed)``).  ``device`` defaults
    to ``cuda:0``.  ``self.params`` holds the per-rank tensors (leaves
    requiring grad), ``self.comm`` the pp comm.
    """

    def __init__(self, cfg: GPTConfig, pp: int, params=None, *, device=None,
                 seed: int = 0):
        self.cfg, self.pp = cfg, int(pp)
        self.device = resolve_device(device)
        self.comm = MeshComm("pp", self.pp, self.device)
        if params is None:
            params = init_params(cfg, self.pp, seed)
        params = params_from_numpy(params, self.device)
        if params.w_qkv.shape[0] != self.pp:
            raise ValueError(f"the parameters have {params.w_qkv.shape[0]} "
                             f"stages, the model {self.pp}")
        self.params = PPGPTParams(*(
            (x[None].expand(self.pp, *x.shape).contiguous()
             if f in REPLICATED else x).requires_grad_()
            for f, x in zip(PPGPTParams._fields, params)))

    def global_params(self) -> PPGPTParams:
        """The parameters in the JAX package's global layout (the
        replicated fields from rank 0)."""
        return PPGPTParams(*(x.detach()[0] if f in REPLICATED else x.detach()
                             for f, x in zip(PPGPTParams._fields,
                                             self.params)))

    def _stage(self, stage_params, x):
        """Every stage's block stack on its activations ``(pp, B, T, d)``."""
        cfg = self.cfg
        r, b, t, d = x.shape
        ln1, ln2, w_qkv, w_o, w1, b1, w2, b2 = stage_params
        for layer in range(ln1.shape[1]):
            y = _layernorm(x.reshape(r, b * t, d), ln1[:, layer])
            x = x + _causal_attention(y.reshape(r, b, t, d),
                                      w_qkv[:, layer], w_o[:, layer],
                                      cfg.n_heads)
            y = _layernorm(x.reshape(r, b * t, d), ln2[:, layer])
            h = F.gelu(torch.matmul(y, w1[:, layer]) + b1[:, layer, None],
                       approximate="tanh")
            x = x + (torch.matmul(h, w2[:, layer])
                     + b2[:, layer, None]).reshape(r, b, t, d)
        return x

    def loss(self, tokens, targets, mask):
        """Each rank's pipelined loss ``(pp,)``: tokens, targets and mask
        ``(M, B_mb, T)``, the same on every rank; the last stage's mean NLL
        over the masked tokens, SUM-allreduced over pp."""
        cfg, pp = self.cfg, self.pp
        p = self.params
        stage = tuple(getattr(p, f) for f in STAGE)
        v = cfg.vocab
        offs = torch.arange(pp, device=self.device)

        def prepare(mb):  # (pp, B_mb, T) tokens -> (pp, B_mb, T, d)
            t = mb.shape[-1]
            ids = mb.long() + offs[:, None, None] * v
            x = F.embedding(ids, p.wte.reshape(pp * v, -1))
            return x + p.wpe[:, None, :t]

        rep = (pp, *tokens.shape)
        acts = pipeline_apply(self._stage, stage, tokens.expand(rep),
                              comm=self.comm, prepare_fn=prepare)
        # (pp, M, B_mb, T, d): zeros except on the last stage
        x = _layernorm(acts.reshape(pp, -1, cfg.d_model), p.lnf)
        logits = torch.matmul(x, p.wte.transpose(1, 2))
        logp = torch.log_softmax(logits.float(), dim=-1)
        tgt = targets.reshape(1, -1, 1).expand(pp, -1, 1).long()
        nll = -torch.gather(logp, -1, tgt)[..., 0]
        w = mask.reshape(1, -1)
        local = (nll * w).sum(-1) / w.sum(-1).clamp_min(1.0)
        # only the last stage's numbers are real; share them
        contrib = torch.where(offs == pp - 1, local, torch.zeros_like(local))
        return allreduce(contrib, op=SUM, comm=self.comm)

    def train_step(self, tokens, lr: float = 3e-4):
        """One SGD step on ``(M, B_mb, T)`` int tokens, the JAX step's:
        the shifted targets and mask, every rank's loss seeded with 1, the
        replicated fields' gradients SUM-allreduced over pp, ``p - lr g``.
        Returns rank 0's loss, a 0-d f32 tensor."""
        tokens = tokens.to(self.device)
        targets = torch.cat([tokens[..., 1:],
                             torch.zeros_like(tokens[..., :1])], dim=-1)
        mask = torch.cat([torch.ones_like(tokens[..., 1:],
                                          dtype=torch.float32),
                          torch.zeros_like(tokens[..., :1],
                                           dtype=torch.float32)], dim=-1)
        loss = self.loss(tokens, targets, mask)
        grads = torch.autograd.grad(loss.sum(), self.params)
        with torch.no_grad():
            for f, x, g in zip(PPGPTParams._fields, self.params, grads):
                if f in REPLICATED:
                    g = allreduce(g, op=SUM, comm=self.comm)
                x.sub_(lr * g)
        return loss[0].detach()
