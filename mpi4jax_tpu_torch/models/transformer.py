"""GPT-style transformer with dp x tp x sp parallelism on one mesh layout.

The counterpart of ``mpi4jax_tpu/models/transformer.py``.  There one
``shard_map`` over a ``("dp", "tp", "sp")`` mesh runs the per-rank step;
here every rank lives on one card and the rank axes lead every tensor
(``parallel/mesh.py``): a parameter is ``(dp, tp, sp, *local)``, one
replica or tp block per rank, and the tokens are ``(dp, tp, sp, B/dp,
T/sp)``.

- **dp**: batch-sharded; gradients synced with a SUM over (dp, sp) divided
  by their number.
- **tp**: Megatron-style; the qkv and MLP up-projections are
  column-parallel, the output and down-projections row-parallel with one
  SUM allreduce each in the compute dtype (the hop and fused-ring kernels).
- **sp**: sequence-sharded activations with ring attention
  (``parallel/ring.py``): on the card the flash route, kernels 5, 6 and 7,
  in every layer.

The ops of a block are the JAX package's: layernorm in f32 with the
population variance and eps 1e-5, casts to ``cfg.dtype`` before every
projection, ``gelu`` in its tanh form (``jax.nn.gelu``'s default), tied
embeddings with the head in the residual dtype (f32), and the loss the
log-softmax NLL over the global tokens with the target shift and mask of
the JAX step.  Each rank keeps its own replica of every replicated
parameter, so that autograd gives each rank's gradient as the JAX step
sees it per shard (a collective's cotangent is the same collective); the
sync then adds the ranks as the JAX step does, and every replica takes the
same AdamW update.  Large products outside the kernels are
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import SUM, allreduce
from ..parallel.mesh import MeshComm
from ..parallel.ring import ring_attention
from ..utils.device import resolve_device


class GPTConfig(NamedTuple):
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 256
    max_seq: int = 128
    dtype: str = "float32"  # compute dtype; "bfloat16" on the card


class GPTParams(NamedTuple):
    # replicated
    wte: object  # (vocab, d)
    wpe: object  # (max_seq, d)
    ln1: object  # (L, 2, d) scale/bias
    ln2: object  # (L, 2, d)
    lnf: object  # (2, d)
    b2: object   # (L, d)  down-proj bias (added post-reduction)
    bo: object   # (L, d)  attn out bias (added post-reduction)
    # tp-sharded (leading tp axis after L)
    w_qkv: object  # (L, tp, d, 3*d/tp)
    w_o: object    # (L, tp, d/tp, d)
    w1: object     # (L, tp, d, ff/tp)
    b1: object     # (L, tp, ff/tp)
    w2: object     # (L, tp, ff/tp, d)


REPLICATED_FIELDS = ("wte", "wpe", "ln1", "ln2", "lnf", "b2", "bo")
TP_FIELDS = ("w_qkv", "w_o", "w1", "b1", "w2")

# optax.adamw(3e-4)'s defaults, which the JAX step uses
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def init_params(cfg: GPTConfig, tp: int, seed: int = 0) -> GPTParams:
    """The JAX package's initial parameters, as float32 numpy arrays: the
    same draws from ``np.random.RandomState(seed)`` in the same order (wte,
    wpe, w_qkv, w_o, w1, w2), so both packages start from the same
    weights."""
    if cfg.d_model % cfg.n_heads or cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError("d_model/n_heads/d_ff must divide heads and tp")
    rng = np.random.RandomState(seed)
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    s = 0.02

    def norm(*shape):
        return rng.randn(*shape).astype(np.float32) * np.float32(s)

    ln_init = np.stack([np.ones((L, d), np.float32),
                        np.zeros((L, d), np.float32)], axis=1)
    return GPTParams(
        wte=norm(cfg.vocab, d),
        wpe=norm(cfg.max_seq, d),
        ln1=ln_init,
        ln2=ln_init.copy(),
        lnf=np.stack([np.ones((d,), np.float32), np.zeros((d,), np.float32)]),
        b2=np.zeros((L, d), np.float32),
        bo=np.zeros((L, d), np.float32),
        w_qkv=norm(L, tp, d, 3 * d // tp),
        w_o=norm(L, tp, d // tp, d),
        w1=norm(L, tp, d, ff // tp),
        b1=np.zeros((L, tp, ff // tp), np.float32),
        w2=norm(L, tp, ff // tp, d),
    )


def params_from_numpy(params, device=None) -> GPTParams:
    """A ``GPTParams`` (or any mapping or named tuple with its fields) of
    array-likes, such as the JAX package's parameters through
    ``np.asarray``, as new float32 tensors on ``device`` (default
    ``cuda:0``), in the global layout."""
    dev = resolve_device(device)
    get = params.get if isinstance(params, dict) else (
        lambda f: getattr(params, f))

    def host(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    return GPTParams(**{f: torch.tensor(np.asarray(host(get(f)), np.float32),
                                        device=dev)
                        for f in GPTParams._fields})


def _layernorm(x, scale_bias):
    """``x`` ``(R, N, d)`` f32, ``scale_bias`` ``(R, 2, d)``: population
    variance, eps 1e-5, as the JAX package's ``_layernorm``."""
    scale, bias = scale_bias[:, None, 0], scale_bias[:, None, 1]
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


class GPT(torch.nn.Module):
    """The model on a ``(dp, tp, sp)`` mesh layout on one device.

    ``mesh``: the sizes ``(dp, tp, sp)``.  ``params``: a ``GPTParams`` in
    the global layout (numpy arrays or tensors; default
    ``init_params(cfg, tp, seed)``).  Every parameter is stored per rank,
    ``(dp, tp, sp, *local)``: the replicated fields as one replica per
    rank, the tp fields as rank (i, t, j)'s block t.  ``device`` defaults
    to ``cuda:0``.
    """

    def __init__(self, cfg: GPTConfig, mesh=(1, 1, 1), params=None, *,
                 device=None, seed: int = 0):
        super().__init__()
        dp, tp, sp = (int(x) for x in mesh)
        if cfg.n_heads % tp or cfg.d_ff % tp or cfg.d_model % cfg.n_heads:
            raise ValueError("d_model/n_heads/d_ff must divide heads and tp")
        self.cfg, self.mesh = cfg, (dp, tp, sp)
        self.device = resolve_device(device)
        layout = (("dp", dp), ("tp", tp), ("sp", sp))
        self.sp_comm = MeshComm("sp", device=self.device, layout=layout)
        self.tp_comm = MeshComm("tp", device=self.device, layout=layout)
        self.dpsp_comm = MeshComm(("dp", "sp"), device=self.device,
                                  layout=layout)
        self.dtype = getattr(torch, cfg.dtype)
        if params is None:
            params = init_params(cfg, tp, seed)
        params = params_from_numpy(params, self.device)
        for f in GPTParams._fields:
            self.register_parameter(f, torch.nn.Parameter(
                self._per_rank(f, getattr(params, f))))
        self.opt = torch.optim.AdamW(
            [getattr(self, f) for f in GPTParams._fields], **ADAMW)

    # -- layouts ------------------------------------------------------------
    def _per_rank(self, field, x):
        """A global parameter as ``(dp, tp, sp, *local)``, a copy per rank."""
        dp, tp, sp = self.mesh
        if field in TP_FIELDS:
            if x.shape[1] != tp:
                raise ValueError(f"{field} has {x.shape[1]} tp blocks, the "
                                 f"mesh {tp}")
            x = x.movedim(1, 0)[None, :, None]  # (1, tp, 1, L, *rest)
        else:
            x = x[None, None, None]
        return x.expand(dp, tp, sp, *x.shape[3:]).contiguous()

    def global_params(self) -> GPTParams:
        """The parameters in the JAX package's global layout, from ranks
        (0, t, 0)."""
        out = {}
        for f in GPTParams._fields:
            x = getattr(self, f).detach()
            out[f] = x[0, :, 0].movedim(0, 1) if f in TP_FIELDS else x[0, 0, 0]
        return GPTParams(**out)

    def shard_tokens(self, tokens):
        """Global ``(B, T)`` tokens as ``(dp, tp, sp, B/dp, T/sp)``."""
        dp, tp, sp = self.mesh
        b, t = tokens.shape
        if b % dp or t % sp:
            raise ValueError(f"tokens {tuple(tokens.shape)} do not split "
                             f"over dp={dp} and sp={sp}")
        x = tokens.reshape(dp, b // dp, sp, t // sp).transpose(1, 2)
        return x[:, None].expand(dp, tp, sp, b // dp, t // sp)

    # -- the per-rank forward ------------------------------------------------
    def _rank_view(self, field):
        x = getattr(self, field)
        return x.reshape(-1, *x.shape[3:])  # (R, *local)

    def _tp_sum(self, x):
        """SUM over tp of ``(R, N, d)``, in its dtype."""
        return allreduce(x.reshape(*self.mesh, *x.shape[1:]), op=SUM,
                         comm=self.tp_comm).reshape(x.shape)

    def _block(self, x, layer, bl, tl):
        """One transformer block on the ranks' local activations
        ``(R, N, d)`` f32, N = B_loc T_loc."""
        cfg, dt = self.cfg, self.dtype
        dp, tp, sp = self.mesh
        h_loc = cfg.n_heads // tp
        hd = cfg.d_model // cfg.n_heads
        p = {f: self._rank_view(f)[:, layer] for f in
             ("ln1", "ln2", "w_qkv", "w_o", "w1", "b1", "w2", "b2", "bo")}

        # attention: column-parallel qkv (no comm)
        y = _layernorm(x, p["ln1"]).to(dt)
        qkv = torch.matmul(y, p["w_qkv"].to(dt))  # (R, N, 3 d/tp)
        qkv = qkv.reshape(dp, tp, sp, bl, tl, 3, h_loc, hd)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        # exact causal attention over the sequence ring
        attn = ring_attention(q, k, v, comm=self.sp_comm, causal=True)
        attn = attn.reshape(x.shape[0], bl * tl, h_loc * hd)
        # row-parallel output projection: one SUM collective over tp
        out = (self._tp_sum(torch.matmul(attn, p["w_o"].to(dt)))
               + p["bo"][:, None].to(dt))
        x = x + out.to(x.dtype)

        # MLP: column-parallel up, row-parallel down
        y = _layernorm(x, p["ln2"]).to(dt)
        h = F.gelu(torch.matmul(y, p["w1"].to(dt)) + p["b1"][:, None].to(dt),
                   approximate="tanh")
        down = (self._tp_sum(torch.matmul(h, p["w2"].to(dt)))
                + p["b2"][:, None].to(dt))
        return x + down.to(x.dtype)

    def forward(self, tokens):
        """Per-rank logits ``(dp, tp, sp, B/dp, T/sp, vocab)`` in f32 of
        global ``(B, T)`` tokens."""
        cfg = self.cfg
        dp, tp, sp = self.mesh
        tok = self.shard_tokens(tokens)
        bl, tl = tok.shape[-2:]
        r = dp * tp * sp
        wte, wpe = self._rank_view("wte"), self._rank_view("wpe")
        # each rank's embedding rows, and its positions sp_idx * T_loc + t
        ids = (tok.reshape(r, bl * tl)
               + torch.arange(r, device=tok.device)[:, None] * cfg.vocab)
        x = F.embedding(ids, wte.reshape(r * cfg.vocab, -1))
        sp_idx = torch.arange(sp, device=tok.device).repeat(dp * tp)
        pos = (sp_idx[:, None] * tl + torch.arange(tl, device=tok.device)
               + torch.arange(r, device=tok.device)[:, None] * cfg.max_seq)
        x = (x.reshape(r, bl, tl, -1)
             + F.embedding(pos, wpe.reshape(r * cfg.max_seq, -1))[:, None])
        x = x.reshape(r, bl * tl, -1)
        for layer in range(cfg.n_layers):
            x = self._block(x, layer, bl, tl)
        x = _layernorm(x, self._rank_view("lnf"))
        # tied embeddings, in the residual dtype as in the JAX package
        logits = torch.matmul(x, wte.transpose(1, 2))
        return logits.reshape(dp, tp, sp, bl, tl, cfg.vocab)

    def loss(self, tokens):
        """Each rank's loss ``(dp, tp, sp)``: the mean NLL over the global
        tokens of next-token prediction (the last position masked)."""
        tokens = tokens.to(self.device)
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1)
        mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                          torch.zeros_like(tokens[:, :1],
                                           dtype=torch.float32)], dim=1)
        logp = torch.log_softmax(self(tokens).float(), dim=-1)
        tgt = self.shard_tokens(targets).long()
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        nll = nll * self.shard_tokens(mask)
        total = allreduce(nll.sum((-2, -1)), op=SUM, comm=self.dpsp_comm)
        count = allreduce(self.shard_tokens(mask).sum((-2, -1)), op=SUM,
                          comm=self.dpsp_comm)
        return total / count.clamp_min(1.0)

    # -- the training step ---------------------------------------------------
    def train_step(self, tokens):
        """One step on global ``(B, T)`` int tokens: loss, gradients, the
        JAX step's gradient sync (every field: SUM over (dp, sp) divided by
        their number; the replicated fields also SUM over tp), then AdamW.
        Returns the loss of rank (0, 0, 0), a 0-d f32 tensor."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(tokens)
        # every rank's loss seeded with 1, as each shard's value_and_grad
        loss.sum().backward()
        n = self.dpsp_comm.size()
        with torch.no_grad():
            for f in GPTParams._fields:
                p = getattr(self, f)
                g = allreduce(p.grad, op=SUM, comm=self.dpsp_comm) / n
                if f in REPLICATED_FIELDS:
                    g = allreduce(g, op=SUM, comm=self.tp_comm)
                p.grad = g
        self.opt.step()
        return loss[0, 0, 0].detach()
