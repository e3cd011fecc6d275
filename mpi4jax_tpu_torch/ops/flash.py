"""Flash attention for ring attention: kernel 5 forward, kernels 6 and 7
backward.

The counterpart of ``mpi4jax_tpu/ops/flash.py``.  One ring step computes
the partial attention of the local q against the k/v block it holds, as the
unnormalized ``(o, m, l)`` triple in float32 (``flash_fwd_block``); the ring
combines the steps' triples in plain torch and rotates k and v one hop
between steps (``_ring_forward``).  The backward re-runs the ring from the
saved logsumexp: one step gives ``(dq, dk, dv)`` in float32
(``flash_bwd_block``); dq accumulates at home while dk and dv ride the ring
with their k/v blocks and are home after n hops (``_ring_backward``).

- ``flash_fwd_block_plain`` and ``flash_bwd_block_plain`` are the plain
  PyTorch versions of one step, with the JAX kernels' rounding points: the
  scores in f32 from input-dtype operands, causal masking at global
  positions, p rounded to v's (forward) or dO's (backward) dtype before its
  product, ds rounded to k's and q's dtype before its products.
- ``csrc/flash_fwd.cu`` (kernel 5, ``_flash_fwd_kernel``) computes the
  forward triple by an online softmax over k tiles;
  ``csrc/flash_bwd.cu`` computes dq (kernel 6, ``_flash_bwd_dq_kernel``,
  a loop over k tiles per block of q rows) and dk, dv (kernel 7,
  ``_flash_bwd_dkv_kernel``, a loop over q tiles per block of keys), both
  from p = exp(s - lse) and delta = rowsum(dO * out).  All run on the tensor
  cores for bf16 and fp16 (on wgmma, fed by TMA and a producer warp) and in
  f32 FMAs for f32.  They read their 16-bit inputs through TMA tensor maps
  that the C side makes at each launch from the tensors' addresses.  One
  launch covers every batch row of every rank: each row reads its own
  ``(q_off, k_off)`` pair from a small int32 tensor, which takes the place
  of the TPU's scalar prefetch.
- ``flash_fwd_block`` and ``flash_bwd_block`` take the kernels on a CUDA
  tensor and the plain versions on a CPU tensor
  (``_collectives.use_plain()`` forces the plain versions on the card: the
  oracle).

Semantics of a row that sees no key of the block (causal): m = NEG_INF,
l = 0 and o = 0, in both versions; this is what the JAX kernel gives for a
row whose tiles are all skipped.  In the backward its p is 0 exactly, so
its dq row is 0 and it adds nothing to dk or dv.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import _collectives
from ..utils import validation as _validation

NEG_INF = -1e30

# read by chip_smoke: kernel 5, kernel 6, kernel 7
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

HEAD_DIMS = (16, 32, 64, 128)  # the head sizes kernels 5-7 are built for
# the launch functions' type codes
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


def _pairs(q_off, k_off, bh, device):
    """The ``(BH, 2)`` int32 ``(q_off, k_off)`` of every batch row."""
    offs = torch.stack([_offsets(q_off, bh, device),
                        _offsets(k_off, bh, device)], dim=1)
    return offs.to(torch.int32)


def _plain_chunks(q, k, q_off, k_off, *, scale, causal, lse=None):
    """The plain version's probabilities by chunks of q rows (non-empty
    inputs): yields ``(lo, hi, p, m)``, p the f32 ``exp(s - m)`` of rows
    ``lo:hi`` ``(BH, hi - lo, Tk)``, 0 where masked, and m their maxima
    ``(BH, hi - lo, 1)``.  With ``lse`` ``(BH, Tq, 1)``, p is
    ``exp(s - lse)`` instead (the backward's), still 0 where masked."""
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
        p = torch.exp(s - (mc if lse is None else lse[:, lo:hi]))
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
    """``x`` contiguous, its data 16-byte aligned (the kernels' vector
    loads and TMA tensor maps): a copy where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_card(label, q, k, v, offs, *q_like):
    """The type code of q, after checking that q, k, v (and ``q_like``,
    shaped as q: dO) are of one type the kernels take, of a head size they
    are built for, shaped alike, with ``offs`` ``(BH, 2)``, all on one
    card."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    kind = _KINDS.get(q.dtype)
    if kind is None or any(x.dtype != q.dtype for x in (k, v, *q_like)):
        raise TypeError(
            f"{label} takes q, k, v{', dO' if q_like else ''} of one type "
            f"among float32, bfloat16 and float16; got "
            f"{', '.join(str(x.dtype) for x in (q, k, v, *q_like))}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{label} is built for head sizes {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (bh, tk, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({bh}, Tk, {d}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if any(x.shape != q.shape for x in q_like):
        raise ValueError(f"dO must have q's shape {tuple(q.shape)}")
    if offs.shape != (bh, 2):
        raise ValueError(f"offsets must be ({bh}, 2), got {tuple(offs.shape)}")
    for x in (q, k, v, offs, *q_like):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"{label} needs every tensor on one card; got "
                             f"{x.device} beside {q.device}")
    return kind


def _launch(name, fn_name, n_ptrs, ptrs, ints, scale, dev):
    """One launch of ``fn_name`` of ``csrc/<name>.cu``: ``n_ptrs`` device
    pointers, the ints, the scale and the current stream; raises on the
    error code it returns."""
    lib = _build.library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:  # declared once per loaded library
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * len(ints)
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*ptrs, *ints, float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} failed: {_build.error_string(lib, err)}")


def _flash_fwd_kernel(q, k, v, offs, *, scale, causal):
    """One launch of ``csrc/flash_fwd.cu`` (kernel 5) on CUDA tensors:
    ``offs`` is ``(BH, 2)`` int32, row r's ``(q_off, k_off)``.  The same
    function as ``flash_fwd_block_plain``."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    kind = _check_card("kernel 5", q, k, v, offs)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    offs = offs.to(torch.int32).contiguous()
    o = torch.empty((bh, tq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    if bh == 0 or tq == 0:
        return o, m, l
    _launch("flash_fwd", "flash_fwd_launch", 7,
            [x.data_ptr() for x in (q, k, v, offs, o, m, l)],
            (bh, tq, tk, d, kind, int(bool(causal))), scale, q.device)
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
    return _fwd_block(q, k, v, _pairs(q_off, k_off, q.shape[0], q.device),
                      scale=scale, causal=causal)


# ---------------------------------------------------------------------------
# the backward of one ring step: kernels 6 and 7
# ---------------------------------------------------------------------------


def flash_bwd_block_plain(q, k, v, do, lse, delta, q_off, k_off, *, scale,
                          causal):
    """The plain version of one ring step's backward.

    q and do: ``(BH, Tq, D)``; k, v: ``(BH, Tk, D)``; lse and delta: f32
    ``(BH, Tq, 1)``, the rows' global logsumexp and ``rowsum(dO * out)``;
    the offsets as in ``flash_fwd_block_plain``.  Returns float32
    ``(dq (BH, Tq, D), dk (BH, Tk, D), dv (BH, Tk, D))``, the JAX kernels'
    rounding points kept: p = exp(s - lse) in f32 (0 where masked),
    dp = dO v^T, ds = p (dp - delta) (times scale when scale != 1),
    dq = ds k with ds rounded to k's dtype, dv = p^T dO with p rounded to
    dO's, dk = ds^T q with ds rounded to q's; products summed in f32.
    """
    bh, tq, d = q.shape
    tk = k.shape[1]
    dev = q.device
    dq = torch.zeros((bh, tq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((bh, tk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((bh, tk, d), dtype=torch.float32, device=dev)
    if bh == 0 or tq == 0 or tk == 0:
        return dq, dk, dv
    kf = k.float()
    vt = v.float().transpose(1, 2)
    for lo, hi, p, _ in _plain_chunks(q, k, q_off, k_off, scale=scale,
                                      causal=causal, lse=lse):
        dof = do[:, lo:hi].float()
        ds = p * (torch.matmul(dof, vt) - delta[:, lo:hi])
        if scale != 1.0:
            ds = ds * scale
        dq[:, lo:hi] = torch.matmul(ds.to(k.dtype).float(), kf)
        dv += torch.matmul(p.to(do.dtype).float().transpose(1, 2), dof)
        dk += torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                           q[:, lo:hi].float())
    return dq, dk, dv


def _bwd_inputs(label, q, k, v, do, lse, delta, offs):
    """The type code and the inputs of kernel 6 or 7 as they launch
    (aligned, contiguous, int32 offsets), after the checks of
    ``_check_card`` and of lse and delta (f32 ``(BH, Tq, 1)``)."""
    kind = _check_card(label, q, k, v, offs, do)
    bh, tq, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (bh, tq, 1) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({bh}, {tq}, 1); got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    return kind, [*(_aligned(x) for x in (q, k, v, do)), lse.contiguous(),
                  delta.contiguous(), offs.to(torch.int32).contiguous()]


def _flash_bwd_dq_kernel(q, k, v, do, lse, delta, offs, *, scale, causal):
    """One launch of kernel 6 (``flash_bwd_dq_launch`` of
    ``csrc/flash_bwd.cu``) on CUDA tensors: dq of one ring step, f32
    ``(BH, Tq, D)``, as ``flash_bwd_block_plain`` computes it."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    kind, ins = _bwd_inputs("kernel 6", q, k, v, do, lse, delta, offs)
    if bh == 0 or tq == 0 or tk == 0:
        return torch.zeros((bh, tq, d), dtype=torch.float32, device=q.device)
    dq = torch.empty((bh, tq, d), dtype=torch.float32, device=q.device)
    _launch("flash_bwd", "flash_bwd_dq_launch", 8,
            [x.data_ptr() for x in (*ins, dq)],
            (bh, tq, tk, d, kind, int(bool(causal))), scale, q.device)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_kernel(q, k, v, do, lse, delta, offs, *, scale, causal):
    """One launch of kernel 7 (``flash_bwd_dkv_launch`` of
    ``csrc/flash_bwd.cu``) on CUDA tensors: dk and dv of one ring step, f32
    ``(BH, Tk, D)`` each, as ``flash_bwd_block_plain`` computes them."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    kind, ins = _bwd_inputs("kernel 7", q, k, v, do, lse, delta, offs)
    empty = bh == 0 or tq == 0 or tk == 0
    dk = (torch.zeros if empty else torch.empty)(
        (bh, tk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk) if empty else torch.empty_like(dk)
    if empty:
        return dk, dv
    _launch("flash_bwd", "flash_bwd_dkv_launch", 9,
            [x.data_ptr() for x in (*ins, dk, dv)],
            (bh, tq, tk, d, kind, int(bool(causal))), scale, q.device)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _bwd_block(q, k, v, do, lse, delta, offs, *, scale, causal):
    if _collectives.on_kernel(q):
        dq = _flash_bwd_dq_kernel(q, k, v, do, lse, delta, offs, scale=scale,
                                  causal=causal)
        dk, dv = _flash_bwd_dkv_kernel(q, k, v, do, lse, delta, offs,
                                       scale=scale, causal=causal)
        return dq, dk, dv
    return flash_bwd_block_plain(q, k, v, do, lse, delta, offs[:, 0],
                                 offs[:, 1], scale=scale, causal=causal)


def flash_bwd_block(q, k, v, do, lse, delta, q_off, k_off, *, scale, causal):
    """One ring step's backward (see ``flash_bwd_block_plain``): kernels 6
    and 7 on a CUDA tensor, the plain version on a CPU tensor."""
    return _bwd_block(q, k, v, do, lse, delta,
                      _pairs(q_off, k_off, q.shape[0], q.device),
                      scale=scale, causal=causal)


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


def _ring_backward(q, k, v, out, lse, g, comm, causal):
    """The ring's backward on the mesh layout, from the forward's inputs,
    its output ``out`` (in q's dtype), its f32 logsumexp ``lse`` and the
    cotangent ``g``: n steps of one launch each of kernels 6 and 7
    (covering every rank), dq accumulated at home, dk and dv carried with
    their k/v blocks by one ``ring_shift_n`` launch per step (the last one
    carries dk and dv only; they are home after n hops, none at n = 1).
    Returns the f32 ``(dq, dk, dv)``, each ``(*lead, B, T, H, D)``, before
    their casts."""
    lead = comm.layout_shape
    t, h, d = q.shape[-3:]
    n = comm.size()
    qf, dof = _to_bhtd(q), _to_bhtd(g)
    rows = qf.shape[0]
    bh = rows // comm.nranks
    # delta in plain torch, as the JAX package computes it outside Pallas
    delta = (dof.float() * _to_bhtd(out).float()).sum(-1, keepdim=True)
    offs = _ring_offsets(comm, bh, t, q.device)
    k_cur = _to_bhtd(k).reshape(*lead, bh, t, d)
    v_cur = _to_bhtd(v).reshape(*lead, bh, t, d)
    dq = dk = dv = None
    for i in range(n):
        dq_b, dk_b, dv_b = _bwd_block(qf, k_cur.reshape(rows, t, d),
                                      v_cur.reshape(rows, t, d), dof, lse,
                                      delta, offs[i], scale=1.0,
                                      causal=causal)
        dk_b, dv_b = (x.reshape(*lead, bh, t, d) for x in (dk_b, dv_b))
        if i == 0:
            dq, dk, dv = dq_b, dk_b, dv_b
        else:
            dq, dk, dv = dq.add_(dq_b), dk.add_(dk_b), dv.add_(dv_b)
        if n > 1 and i < n - 1:
            k_cur, v_cur, dk, dv = _collectives.ring_shift_n(
                (k_cur, v_cur, dk, dv), comm, 1)
        elif n > 1:
            # k and v are read no more: the last hop takes dk and dv home
            dk, dv = _collectives.ring_shift_n((dk, dv), comm, 1)
    shape = q.shape[:-3]
    return tuple(_from_bhtd(x.reshape(rows, t, d), shape, h)
                 for x in (dq, dk, dv))


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm, causal):
        out, lse = _ring_forward(q, k, v, comm, causal, 1.0)
        out = out.to(q.dtype)
        # what the JAX package saves: the (prescaled) q, k, v, the output in
        # q's dtype and the f32 logsumexp
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.comm, ctx.causal = comm, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, g, ctx.comm,
                                    ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def check_qkv(q, k, v, comm):
    """The comm (``comm`` or the ambient one), after checking that q, k and
    v are ``(*lead, B, T_local, H, D)`` on its mesh layout, alike, with
    ``T_local >= 1``."""
    comm = _validation.resolve_comm(comm, mesh_only="ring attention")
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
    """Ring attention with kernel 5 for the local blocks, and kernels 6
    and 7 for their backward.

    q, k and v are ``(*lead, B, T_local, H, D)`` on the mesh layout of
    ``comm`` (its rank dimensions leading), the sequence split over the
    comm's ranks in rank order.  Returns the exact attention output, in q's
    dtype.  Differentiable: the backward re-runs the ring on kernels 6 and
    7 from the saved logsumexp (``_ring_backward``).  q is multiplied by the
    scale in q's dtype before the kernels, as the JAX package does
    (``prescale``); that product stays outside the ``autograd.Function``,
    so torch autograd applies its chain rule, as JAX's autodiff does.

    ``block_q`` and ``block_k`` are the JAX package's tile sizes, accepted
    for its API and ignored: the CUDA kernels use their own tiles of 64 or
    128 rows, because a block's shared memory holds 227 KB, not the TPU's
    100 MB of VMEM.
    """
    comm = check_qkv(q, k, v, comm)
    return _RingFlash.apply(prescale(q, scale), k, v, comm, bool(causal))
