"""Flash attention for ring attention: the forward, on kernel 5.

The counterpart of ``mpi4jax_tpu/ops/flash.py``, forward half.  One ring
step computes the partial attention of the local q against the k/v block
it holds, as the unnormalized ``(o, m, l)`` triple in float32
(``flash_fwd_block``); the ring combines the steps' triples in plain
torch and rotates k and v one hop between steps (``_ring_forward``).

- ``flash_fwd_block_plain`` is the plain PyTorch version of one step: the
  scores in f32, causal masking at global positions, the probabilities
  rounded to v's dtype before the PV product, as the JAX kernel does.
- ``csrc/flash_fwd.cu`` (kernel 5, ``_flash_fwd_kernel``) computes the
  same triple by an online softmax over k tiles, on the tensor cores for
  bf16 and fp16 and in f32 FMAs for f32.  One launch covers every batch
  row of every rank: each row reads its own ``(q_off, k_off)`` pair from a
  small int32 tensor, which takes the place of the TPU's scalar prefetch.
- ``flash_fwd_block`` takes the kernel on a CUDA tensor and the plain
  version on a CPU tensor (``_collectives.use_plain()`` forces the plain
  version on the card: the oracle).

Semantics of a row that sees no key of the block (causal): m = NEG_INF,
l = 0 and o = 0, in both versions; this is what the JAX kernel gives for a
row whose tiles are all skipped.

The backward (kernels 6 and 7) is not ported yet: ``ring_flash_attention``
raises ``NotImplementedError`` when differentiated (ROADMAP.md §1 item 2).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import _collectives
from ..utils import validation as _validation

NEG_INF = -1e30

LAUNCHES = {"flash_fwd": 0}  # read by chip_smoke

HEAD_DIMS = (16, 32, 64, 128)  # the head sizes kernel 5 is built for
# flash_fwd_launch's type codes
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the plain version works on chunks of q rows of at most this many scores
_PLAIN_CHUNK = 1 << 26


def _to_bhtd(x):
    """``(*lead, T, H, D)`` as ``(prod(lead) * H, T, D)``: each (leading
    index, head) pair is one batch row, rank-major on the mesh layout."""
    t, h, d = x.shape[-3:]
    return x.transpose(-3, -2).reshape(-1, t, d)


def _from_bhtd(x, lead, h):
    """The inverse of ``_to_bhtd``: ``(prod(lead) * H, T, D)`` as
    ``(*lead, T, H, D)``."""
    _, t, d = x.shape
    return x.reshape(*lead, h, t, d).transpose(-3, -2)


def _offsets(off, bh, device):
    """A start per batch row: ``off`` is an int, or an int tensor of one
    element or of ``bh``."""
    off = torch.as_tensor(off, device=device)
    if off.dtype.is_floating_point or off.dtype.is_complex:
        raise TypeError(f"offsets must be integers, got {off.dtype}")
    off = off.reshape(-1)
    return off.expand(bh) if off.numel() == 1 else off.reshape(bh)


def _plain_chunks(q, k, q_off, k_off, *, scale, causal):
    """The plain version's probabilities by chunks of q rows (non-empty
    inputs): yields ``(lo, hi, p, m)``, p the f32 ``exp(s - m)`` of rows
    ``lo:hi`` ``(BH, hi - lo, Tk)``, 0 where masked, and m their maxima
    ``(BH, hi - lo, 1)``."""
    bh, tq, _ = q.shape
    tk = k.shape[1]
    dev = q.device
    qo = _offsets(q_off, bh, dev).long()
    ko = _offsets(k_off, bh, dev).long()
    kt = k.float().transpose(1, 2)
    cols = ko[:, None] + torch.arange(tk, device=dev)  # (BH, Tk)
    step = max(1, _PLAIN_CHUNK // (bh * tk))
    for lo in range(0, tq, step):
        hi = min(tq, lo + step)
        # products of the inputs, summed in f32 (on the card: no TF32,
        # torch's default for matmul)
        s = torch.matmul(q[:, lo:hi].float(), kt)
        if scale != 1.0:
            s = s * scale
        if causal:
            rows = qo[:, None] + torch.arange(lo, hi, device=dev)
            seen = cols[:, None, :] <= rows[:, :, None]  # (BH, rows, Tk)
            s = torch.where(seen, s, NEG_INF)
        mc = s.amax(-1, keepdim=True)
        p = torch.exp(s - mc)
        if causal:
            # a row that sees no key contributes nothing (m stays NEG_INF)
            p = torch.where(seen, p, 0.0)
        yield lo, hi, p, mc


def flash_fwd_block_plain(q, k, v, q_off, k_off, *, scale, causal):
    """The plain version of one ring step's partial attention.

    q: ``(BH, Tq, D)``; k, v: ``(BH, Tk, D)``; ``q_off`` and ``k_off``: the
    global positions of q's and k's first rows, one per batch row (int
    tensors; one element broadcasts).  Returns float32
    ``(o (BH, Tq, D), m (BH, Tq, 1), l (BH, Tq, 1))``: o the unnormalized
    output, m the row maximum of the scores, l the sum of exp(s - m).
    """
    bh, tq, d = q.shape
    dev = q.device
    o = torch.zeros((bh, tq, d), dtype=torch.float32, device=dev)
    m = torch.full((bh, tq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, tq, 1), dtype=torch.float32, device=dev)
    if bh == 0 or tq == 0 or k.shape[1] == 0:
        return o, m, l
    vf = v.float()
    for lo, hi, p, mc in _plain_chunks(q, k, q_off, k_off, scale=scale,
                                       causal=causal):
        m[:, lo:hi] = mc
        l[:, lo:hi] = p.sum(-1, keepdim=True)
        # p rounded to v's dtype, then products summed in f32
        o[:, lo:hi] = torch.matmul(p.to(v.dtype).float(), vf)
    return o, m, l


def _aligned(x):
    """``x`` contiguous, its data 16-byte aligned (the kernel's vector
    loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _flash_fwd_kernel(q, k, v, offs, *, scale, causal):
    """One launch of ``csrc/flash_fwd.cu`` (kernel 5) on CUDA tensors:
    ``offs`` is ``(BH, 2)`` int32, row r's ``(q_off, k_off)``.  The same
    function as ``flash_fwd_block_plain``."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    kind = _KINDS.get(q.dtype)
    if kind is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"kernel 5 takes q, k and v of one type among float32, bfloat16 "
            f"and float16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel 5 is built for head sizes {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (bh, tk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({bh}, Tk, {d}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if offs.shape != (bh, 2):
        raise ValueError(f"offsets must be ({bh}, 2), got {tuple(offs.shape)}")
    for x in (q, k, v, offs):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"kernel 5 needs every tensor on one card; got "
                             f"{x.device} beside {q.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    offs = offs.to(torch.int32).contiguous()
    o = torch.empty((bh, tq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    if bh == 0 or tq == 0:
        return o, m, l
    lib = _build.library("flash_fwd")
    fn = lib.flash_fwd_launch
    if fn.argtypes is None:  # declared once per loaded library
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
                 o.data_ptr(), m.data_ptr(), l.data_ptr(), bh, tq, tk, d,
                 kind, int(bool(causal)), float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_fwd_launch failed: {_build.error_string(lib, err)}")
    LAUNCHES["flash_fwd"] += 1
    return o, m, l


def _fwd_block(q, k, v, offs, *, scale, causal):
    if _collectives.on_kernel(q):
        return _flash_fwd_kernel(q, k, v, offs, scale=scale, causal=causal)
    return flash_fwd_block_plain(q, k, v, offs[:, 0], offs[:, 1],
                                 scale=scale, causal=causal)


def flash_fwd_block(q, k, v, q_off, k_off, *, scale, causal):
    """One ring step's partial attention (see ``flash_fwd_block_plain``):
    kernel 5 on a CUDA tensor, the plain version on a CPU tensor."""
    bh = q.shape[0]
    offs = torch.stack([_offsets(q_off, bh, q.device),
                        _offsets(k_off, bh, q.device)], dim=1)
    return _fwd_block(q, k, v, offs.to(torch.int32), scale=scale,
                      causal=causal)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def _ring_offsets(comm, bh, t, device):
    """``(n, nranks * bh, 2)`` int32: at ring step i, batch row r of mesh
    rank f (comm rank c) holds q at ``c * t`` and the k/v block of comm
    rank ``(c - i) mod n``, at ``((c - i) mod n) * t``.  Cached on the
    comm."""
    key = ("flash_offsets", str(device), bh, t)
    offs = comm.tables.get(key)
    if offs is None:
        n = comm.size()
        rows = [(c * t, ((c - i) % n) * t)
                for i in range(n) for c in comm.ranks() for _ in range(bh)]
        offs = torch.tensor(rows, dtype=torch.int32,
                            device=device).reshape(n, -1, 2)
        comm.tables[key] = offs
    return offs


def _ring_forward(q, k, v, comm, causal, scale):
    """The ring's forward on the mesh layout, q, k and v
    ``(*lead, B, T, H, D)``: n steps of one block launch each (covering
    every rank), the ``(o, m, l)`` combine in plain torch, and n - 1 hops of
    k and v between them (the JAX scan's n-th hop returns blocks nobody
    reads).  Returns the normalized output in float32, before its cast to
    q's dtype, and the f32 logsumexp ``(R, T, 1)``."""
    lead = comm.layout_shape
    t, h, d = q.shape[-3:]
    n = comm.size()
    qf, kf, vf = _to_bhtd(q), _to_bhtd(k), _to_bhtd(v)
    rows = qf.shape[0]
    bh = rows // comm.nranks
    offs = _ring_offsets(comm, bh, t, q.device)
    k_cur = kf.reshape(*lead, bh, t, d)
    v_cur = vf.reshape(*lead, bh, t, d)
    o = m = l = None
    for i in range(n):
        o_b, m_b, l_b = _fwd_block(qf, k_cur.reshape(rows, t, d),
                                   v_cur.reshape(rows, t, d), offs[i],
                                   scale=scale, causal=causal)
        if i == 0:
            # the combine with the empty start (o 0, m NEG_INF, l 0) is
            # the identity
            o, m, l = o_b, m_b, l_b
        else:
            m_new = torch.maximum(m, m_b)
            a, a_b = torch.exp(m - m_new), torch.exp(m_b - m_new)
            o = o.mul_(a).add_(o_b.mul_(a_b))
            l = l.mul_(a).add_(l_b.mul_(a_b))
            m = m_new
        if i < n - 1:
            k_cur, v_cur = _collectives.ring_shift_n((k_cur, v_cur), comm, 1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = m + torch.log(l_safe)
    return _from_bhtd(o.div_(l_safe), q.shape[:-3], h), lse


def prescale(q, scale=None):
    """q times the scale (default ``1/sqrt(D)``), the scale rounded to q's
    dtype and the product rounded once, as the JAX package's
    ``q * jnp.asarray(scale, q.dtype)``; the kernels then take scale 1.
    The rounding changes bf16 results."""
    scale = 1.0 / q.shape[-1] ** 0.5 if scale is None else float(scale)
    return q if scale == 1.0 else q * torch.tensor(scale,
                                                   dtype=q.dtype).item()


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm, causal):
        out, _ = _ring_forward(q, k, v, comm, causal, 1.0)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the backward of ring_flash_attention needs the flash backward "
            "kernels 6 and 7 (dq and dk/dv), which are not ported yet "
            "(ROADMAP.md §1 item 2); differentiate ring_attention with "
            "impl='xla'")


def check_qkv(q, k, v, comm):
    """The comm (``comm`` or the ambient one), after checking that q, k and
    v are ``(*lead, B, T_local, H, D)`` on its mesh layout, alike, with
    ``T_local >= 1``."""
    comm = _validation.resolve_comm(comm)
    lead = comm.layout_shape
    for x in (q, k, v):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"q, k and v must be tensors, got {type(x)}")
    if q.dim() != len(lead) + 4 or tuple(q.shape[:len(lead)]) != lead:
        raise ValueError(
            f"q must be (*{lead}, B, T_local, H, D), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k and v must have q's shape {tuple(q.shape)}; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.shape[-3] < 1:
        raise ValueError("T_local must be at least 1")
    return comm


def ring_flash_attention(q, k, v, *, comm=None, causal=False, scale=None,
                         block_q=1024, block_k=1024):
    """Ring attention with kernel 5 for the local blocks.

    q, k and v are ``(*lead, B, T_local, H, D)`` on the mesh layout of
    ``comm`` (its rank dimensions leading), the sequence split over the
    comm's ranks in rank order.  Returns the exact attention output, in q's
    dtype.  Not differentiable yet: its backward raises
    ``NotImplementedError``.  q is multiplied by the scale in q's dtype
    before the kernels, as the JAX package does (``prescale``).

    ``block_q`` and ``block_k`` are the JAX package's tile sizes, accepted
    for its API and ignored: the CUDA kernel uses its own tile of 64 x 64,
    because a block's shared memory holds 227 KB, not the TPU's 100 MB of
    VMEM.
    """
    comm = check_qkv(q, k, v, comm)
    return _RingFlash.apply(prescale(q, scale), k, v, comm, bool(causal))
