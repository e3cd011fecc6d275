"""The checks that hold kernels 5, 6 and 7 against their plain versions on
the card.

Shared by ``chip_smoke.py``, ``tests/test_torch_flash_gpu.py`` and
``benchmarks/flash_tolerance.py``.  The forward (kernel 5): ``cases`` makes
the edge inputs from a seed, ``noise`` and ``ring_noise`` give each output
component's scale of rounding noise, ``errors`` measures a kernel triple
against the plain one, ``ring_outputs`` runs the ring on both routes, and
``TOL`` bounds each error by type:

- ``o``: the error of the normalized output ``o / l`` in f32 (the ring's
  before its cast to the input type), in each component over that
  component's noise scale ``sqrt(sum_j p_j^2 v_jd^2) / l``, the sum over
  the keys the row sees, p from the plain version.  Rounding each p_j to
  the input type with relative error e_j (|e_j| <= u: 2^-9 in bf16, 2^-12
  in fp16) moves the component by ``sum_j e_j p_j v_jd / l``; the kernel
  rounds against a running maximum and the plain version against the
  row's, so their difference spreads by about ``u sqrt(2/3)`` of the scale,
  1.6e-3 in bf16.  The scale shrinks as a row sees more keys, as the
  output itself does, so a fault that drops a few keys of a long row stands
  out where a limit in units of the tensor's largest |v| would not.  In f32
  no p is rounded: only the order of summation and ``expf`` differ.
- ``l``: relative.  Both sum the unrounded f32 p; the scores differ only
  by the order of their f32 sums (and the tensor cores' accumulation for
  half types).
- ``m``: ``|m - m_plain| / (1 + |m_plain|)``, the scores' own error.
- A row that sees no key must be the empty triple exactly (m = NEG_INF,
  l = 0, o = 0) in both.

Each limit of ``TOL`` lies between two readings of
``benchmarks/flash_tolerance.py`` on the card: the sound kernel's worst, at
these edge cases and at path (d)'s B4 T4096 H16 D128 shapes, and the least
of kernels with a planted fault (a k tile, its P V, one key or the
diagonal dropped), each of which the limit must catch.  The ring's output
is held to ``TOL[dtype]["o"]`` as one block: each p is rounded once in
both routes.

The backward (kernels 6 and 7): ``bwd_cases`` adds dO, lse and delta to the
edge inputs, ``bwd_noise`` and ``ring_bwd_noise`` give each gradient
component's noise scale, ``bwd_errors`` measures a kernel's ``(dq, dk, dv)``
against the plain one, ``ring_grads`` runs the ring's forward and backward
on both routes, ``ring_grad_check`` holds the entry point's gradients to
them, ``ring_bwd_steps`` gives each ring step's inputs to the kernels, and
``TOL_BWD`` bounds each error by type.  Each component
is measured over the scale of the rounding its sum goes through: dv's
component (j, d) over ``sqrt(sum_i p_ij^2 dO_id^2)`` (p rounded to dO's
type), dk's over ``sqrt(sum_i ds_ij^2 q_id^2)`` and dq's over
``sqrt(sum_j e_ij k_jd^2)`` (ds rounded to q's and k's type), the sums
over the pairs the row or key sees, p and ds from the plain version, and
``e_ij = ds_ij^2 + p_ij^2 w_ij`` adding the noise of dp - delta (the input
type's rounding of dO v and dO out), which a row where they cancel keeps.  Both
versions compute p = exp(s - lse) from the same f32 formula, so they round
alike except where the scores' f32 sums, taken in other orders, straddle a
rounding boundary; a component that has no term (a row that sees no key, a
key no row sees) must be 0 exactly in both.  Each limit of ``TOL_BWD`` lies
between the sound kernels' worst reading and the least reading of kernels
with a planted fault (``benchmarks/flash_tolerance.py``: kernel 6 skips a
k tile, kernel 7 a q tile, delta dropped, one row's lse off by log 2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _collectives, flash
from .flash import NEG_INF

TOL = {
    torch.float32: {"o": 1e-3, "l": 1e-5, "m": 1e-5},
    torch.bfloat16: {"o": 4e-2, "l": 1e-4, "m": 1e-4},
    torch.float16: {"o": 1e-2, "l": 1e-4, "m": 1e-4},
}
# kernels 6 and 7: the error of each gradient over its noise scale
TOL_BWD = {
    torch.float32: {"dq": 1e-3, "dk": 1e-3, "dv": 1e-3},
    torch.bfloat16: {"dq": 4e-2, "dk": 4e-2, "dv": 4e-2},
    torch.float16: {"dq": 1e-2, "dk": 1e-2, "dv": 1e-2},
}
HEAD_DIMS = (16, 32, 64, 128)
# (BH, Tq, Tk): the JAX test's shape, ragged edges, several tiles each way
SHAPES = ((3, 32, 48), (2, 100, 77), (2, 200, 300))
# (q_off, k_off) per batch row, causal: the diagonal, k in the past, a
# partial overlap with rows that see nothing, a fully skipped block, and
# rows with different offsets (as one ring step gives every rank)
OFFSETS = (((0,), (0,)), ((64,), (0,)), ((16,), (32,)), ((0,), (1000,)),
           ((0, 64, 16), (0, 0, 32)))
_TINY = 1e-30


def _offsets(offs, bh, device):
    vals = [offs[i % len(offs)] for i in range(bh)]
    return torch.tensor(vals, dtype=torch.int32, device=device)


def cases(device, dtypes=(torch.float32, torch.bfloat16, torch.float16),
          head_dims=HEAD_DIMS, seed: int = 0):
    """The edge inputs: per dtype, head size and shape, a non-causal case at
    scale 0.25 and the causal offsets of ``OFFSETS`` at scale 1.0 (the ring
    pre-scales q) and 0.25.  fp16 takes the first shape only.  Yields
    ``(tag, q, k, v, q_off, k_off, scale, causal)``."""
    g = torch.Generator().manual_seed(seed)
    for dtype in dtypes:
        for d in head_dims:
            shapes = SHAPES[:1] if dtype == torch.float16 else SHAPES
            for bh, tq, tk in shapes:
                q, k, v = (
                    (torch.randn((bh, t, d), generator=g) * 0.4).to(dtype)
                    .to(device) for t in (tq, tk, tk))
                tag = f"{str(dtype)[6:]} D={d} BH={bh} Tq={tq} Tk={tk}"
                zero = _offsets((0,), bh, device)
                yield (f"{tag} full", q, k, v, zero, zero, 0.25, False)
                for qo, ko in OFFSETS:
                    for scale in (1.0, 0.25):
                        yield (f"{tag} causal offsets {qo}/{ko} scale {scale}",
                               q, k, v, _offsets(qo, bh, device),
                               _offsets(ko, bh, device), scale, True)


def _parts(q, k, v, q_off, k_off, *, scale, causal):
    """One block's ``(m, l, w)`` on the plain version: the row maxima, the
    sums of p and ``w = sum_j p_j^2 v_jd^2`` ``(BH, Tq, D)``, p against m."""
    bh, tq, d = q.shape
    m = torch.full((bh, tq, 1), NEG_INF, device=q.device)
    l = torch.zeros((bh, tq, 1), device=q.device)
    w = torch.zeros((bh, tq, d), device=q.device)
    if k.shape[1]:
        v2 = v.float().square()
        for lo, hi, p, mc in flash._plain_chunks(q, k, q_off, k_off,
                                                 scale=scale, causal=causal):
            m[:, lo:hi] = mc
            l[:, lo:hi] = p.sum(-1, keepdim=True)
            w[:, lo:hi] = torch.matmul(p.square(), v2)
    return m, l, w


def noise(q, k, v, q_off, k_off, *, scale, causal):
    """The noise scale ``sqrt(sum_j p_j^2 v_jd^2) / l`` of each component of
    one block's normalized output ``(BH, Tq, D)``; 0 in a row that sees no
    key."""
    _, l, w = _parts(q, k, v, q_off, k_off, scale=scale, causal=causal)
    return w.sqrt() / l.clamp_min(_TINY)


def ring_outputs(q, k, v, comm, causal):
    """The ring's normalized f32 output, before its cast, on the route the
    tensors take and on the plain route: ``(got, ref)``, each
    ``(*lead, B, T_local, H, D)``."""
    qs = flash.prescale(q)
    got, _ = flash._ring_forward(qs, k, v, comm, causal, 1.0)
    with _collectives.use_plain():
        ref, _ = flash._ring_forward(qs, k, v, comm, causal, 1.0)
    return got, ref


def ring_noise(q, k, v, comm, causal):
    """The noise scale of each component of the ring's output, over every
    key of the global sequence that the row sees, ``(*lead, B, T_local, H,
    D)``: the blocks' ``_parts`` combined along the ring on the plain
    route."""
    lead = comm.layout_shape
    t, h, d = q.shape[-3:]
    qf, kf, vf = (flash._to_bhtd(x) for x in (flash.prescale(q), k, v))
    rows = qf.shape[0]
    bh = rows // comm.nranks
    offs = flash._ring_offsets(comm, bh, t, q.device)
    m = l = w = None
    with _collectives.use_plain():
        for i in range(comm.size()):
            mb, lb, wb = _parts(qf, kf, vf, offs[i][:, 0], offs[i][:, 1],
                                scale=1.0, causal=causal)
            if i == 0:
                m, l, w = mb, lb, wb
            else:
                m_new = torch.maximum(m, mb)
                a, ab = torch.exp(m - m_new), torch.exp(mb - m_new)
                l = l * a + lb * ab
                w = w * a.square() + wb * ab.square()
                m = m_new
            if i < comm.size() - 1:
                kf, vf = (x.reshape(rows, t, d) for x in
                          _collectives.ring_shift_n(
                              (kf.reshape(*lead, bh, t, d),
                               vf.reshape(*lead, bh, t, d)), comm, 1))
    return flash._from_bhtd(w.sqrt() / l.clamp_min(_TINY), q.shape[:-3], h)


def scaled_error(got, ref, scale) -> float:
    """The largest ``|got - ref|`` over ``scale``, component by component."""
    if not got.numel():
        return 0.0
    return ((got.float() - ref.float()).abs()
            / scale.clamp_min(_TINY)).max().item()


def errors(got, ref, scale):
    """``got`` against ``ref``, two ``(o, m, l)`` triples of one block, with
    ``scale`` the block's ``noise``: the errors of o (normalized, over the
    noise), l and m over the rows that see a key, whether the rows that see
    none are the empty triple in both, and the largest absolute difference
    of the normalized output."""
    o, m, l = (x.float() for x in got)
    o_r, m_r, l_r = (x.float() for x in ref)
    live = l_r[..., 0] > 0
    dead_ok = True
    if bool((~live).any()):
        for x, r, empty in ((o, o_r, 0.0), (m, m_r, NEG_INF), (l, l_r, 0.0)):
            dead_ok &= bool((x[~live] == empty).all()) and bool(
                (r[~live] == empty).all())
    out = {"o": 0.0, "l": 0.0, "m": 0.0, "empty_rows_exact": dead_ok,
           "max_abs_err": 0.0}
    if bool(live.any()):
        on = o[live] / torch.where(l[live] == 0, 1.0, l[live])
        on_r = o_r[live] / l_r[live]
        out["o"] = scaled_error(on, on_r, scale[live])
        out["max_abs_err"] = (on - on_r).abs().max().item()
        lr = l_r[live]
        out["l"] = ((l[live] - lr).abs() / lr).max().item()
        out["m"] = ((m[live] - m_r[live]).abs()
                    / (1 + m_r[live].abs())).max().item()
    return out


def within(errs, dtype) -> bool:
    """Whether ``errors``' result is inside ``TOL[dtype]``."""
    tol = TOL[dtype]
    return errs["empty_rows_exact"] and all(
        errs[key] <= tol[key] for key in ("o", "l", "m"))


# -- the backward: kernels 6 and 7 -------------------------------------------


def bwd_cases(device, dtypes=(torch.float32, torch.bfloat16, torch.float16),
              head_dims=HEAD_DIMS, seed: int = 0):
    """The edge inputs of the backward: each case of ``cases`` with a
    cotangent dO in the input type and the rows' lse and delta as a ring
    step sees them, the block's own share of a global softmax: lse is the
    block's logsumexp plus ``log(1 + u)`` (u uniform in [0, 2), the mass of
    other blocks; a finite draw where the row sees no key of the block) and
    delta is ``rowsum(dO * o / l)`` over ``1 + u`` plus a normal draw of
    0.1.  Yields ``(tag, q, k, v, do, lse, delta, q_off, k_off, scale,
    causal)``."""
    g = torch.Generator().manual_seed(seed + 1)
    for tag, q, k, v, qo, ko, scale, causal in cases(device, dtypes,
                                                      head_dims, seed):
        bh, tq, d = q.shape
        do = (torch.randn((bh, tq, d), generator=g) * 0.4).to(q.dtype).to(
            device)
        u = (torch.rand((bh, tq, 1), generator=g) * 2).to(device)
        extra = (torch.randn((bh, tq, 1), generator=g) * 0.1).to(device)
        o, m, l = flash.flash_fwd_block_plain(q, k, v, qo, ko, scale=scale,
                                              causal=causal)
        live = l > 0
        lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0))
                          + torch.log1p(u), u)
        out = o / torch.where(live, l, 1.0)
        delta = ((do.float() * out).sum(-1, keepdim=True) / (1 + u)
                 + extra)
        yield (tag, q, k, v, do, lse, delta, qo, ko, scale, causal)


def _bwd_squares(q, k, v, do, lse, delta, offs, *, scale, causal, a=None):
    """One step's squared noise scales on the plain version: ``(sum_j e_ij k_jd^2, sum_i e_ij q_id^2,
    sum_i p_ij^2 dO_id^2)`` in f32, shaped as dq, dk and dv, where
    ``e_ij = ds_ij^2 + (scale p_ij)^2 w_ij`` is the scale of ds's rounding
    and of the noise in dp - delta: ``w_ij = sum_d dO_id^2 v_jd^2 + a_i``,
    the input type's rounding of dp's factors, and with ``a`` ``(BH, Tq,
    1)`` that of delta's (``sum_d dO_id^2 out_id^2``).  A row whose dp and
    delta cancel has ds near 0 but keeps that noise."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    wq = torch.zeros((bh, tq, d), device=q.device)
    wk = torch.zeros((bh, tk, d), device=q.device)
    wv = torch.zeros((bh, tk, d), device=q.device)
    if bh == 0 or tq == 0 or tk == 0:
        return wq, wk, wv
    k2, vt = k.float().square(), v.float().transpose(1, 2)
    v2t = vt.square()
    for lo, hi, p, _ in flash._plain_chunks(q, k, offs[:, 0], offs[:, 1],
                                            scale=scale, causal=causal,
                                            lse=lse):
        dof = do[:, lo:hi].float()
        ds = p * (torch.matmul(dof, vt) - delta[:, lo:hi])
        w = torch.matmul(dof.square(), v2t)
        if a is not None:
            w = w + a[:, lo:hi]
        if scale != 1.0:
            ds, w = ds * scale, w * scale ** 2
        e = ds.square() + p.square() * w
        wq[:, lo:hi] = torch.matmul(e, k2)
        wk += torch.matmul(e.transpose(1, 2), q[:, lo:hi].float().square())
        wv += torch.matmul(p.square().transpose(1, 2), dof.square())
    return wq, wk, wv


def bwd_noise(q, k, v, do, lse, delta, q_off, k_off, *, scale, causal):
    """The noise scale of each component of one step's ``(dq, dk, dv)``
    (``_bwd_squares`` with delta taken as exact); 0 where a component has
    no term."""
    offs = flash._pairs(q_off, k_off, q.shape[0], q.device)
    return tuple(w.sqrt() for w in _bwd_squares(
        q, k, v, do, lse, delta, offs, scale=scale, causal=causal))


def bwd_errors(got, ref, scale):
    """``got`` against ``ref``, two ``(dq, dk, dv)`` triples, with
    ``scale`` their ``bwd_noise``: the largest error of each over its noise
    scale (a component whose scale is 0 must be equal), and the largest
    absolute difference."""
    out = {"max_abs_err": 0.0}
    for name, x, r, sc in zip(("dq", "dk", "dv"), got, ref, scale):
        out[name] = scaled_error(x, r, sc)
        if x.numel():
            out["max_abs_err"] = max(out["max_abs_err"], (
                x.float() - r.float()).abs().max().item())
    return out


def within_bwd(errs, dtype) -> bool:
    """Whether ``bwd_errors``' result is inside ``TOL_BWD[dtype]``."""
    return all(errs[key] <= lim for key, lim in TOL_BWD[dtype].items())


def ring_grads(q, k, v, do, comm, causal):
    """The ring's f32 ``(dq, dk, dv)`` before their casts, for the
    cotangent ``do`` of its output, on the route the tensors take and on
    the plain route (forward and backward): ``(got, ref)``.  dq is the
    gradient of the prescaled q."""
    qs = flash.prescale(q)

    def run():
        out, lse = flash._ring_forward(qs, k, v, comm, causal, 1.0)
        return flash._ring_backward(qs, k, v, out.to(q.dtype), lse, do, comm,
                                    causal)

    got = run()
    with _collectives.use_plain():
        ref = run()
    return got, ref


class RingStep(NamedTuple):
    """One ring step's inputs to kernels 6 and 7, each ``(R, T, D)`` or
    ``(R, T, 1)`` over every rank's batch rows, and the output ``out`` (in
    q's type) that delta reads."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    offs: torch.Tensor
    out: torch.Tensor

    @property
    def args(self):
        """The kernels' positional arguments ``(q, k, v, do, lse, delta,
        offs)``."""
        return self[:7]


def ring_bwd_steps(q, k, v, do, comm, causal):
    """The inputs of each of the ring's n backward steps, as
    ``flash._ring_backward`` gives them to kernels 6 and 7: the prescaled
    q, the lse of the ring's forward (on the route the tensors take),
    delta = rowsum(dO * out), and at step i every rank's k/v block of comm
    rank ``me - i`` with the offsets of ``flash._ring_offsets``.  Yields
    ``RingStep``s; the hops between them take the plain route."""
    lead = comm.layout_shape
    t, _, d = q.shape[-3:]
    qs = flash.prescale(q)
    out, lse = flash._ring_forward(qs, k, v, comm, causal, 1.0)
    qf, dof = flash._to_bhtd(qs), flash._to_bhtd(do)
    outf = flash._to_bhtd(out.to(q.dtype))
    del out
    delta = (dof.float() * outf.float()).sum(-1, keepdim=True)
    rows = qf.shape[0]
    bh = rows // comm.nranks
    offs = flash._ring_offsets(comm, bh, t, q.device)
    k_cur, v_cur = (flash._to_bhtd(x).reshape(*lead, bh, t, d)
                    for x in (k, v))
    for i in range(comm.size()):
        if i:
            with _collectives.use_plain():
                k_cur, v_cur = _collectives.ring_shift_n((k_cur, v_cur),
                                                         comm, 1)
        yield RingStep(qf, k_cur.reshape(rows, t, d),
                       v_cur.reshape(rows, t, d), dof, lse, delta, offs[i],
                       outf)


def ring_bwd_noise(q, k, v, do, comm, causal):
    """The noise scale of each component of the ring's ``(dq, dk, dv)``
    over every pair of the global sequence: ``_bwd_squares`` of each step
    of ``ring_bwd_steps`` on the plain route, summed as the gradients are
    (dk's and dv's riding the ring home), with the rounding of the output
    that delta reads."""
    lead = comm.layout_shape
    t, h, d = q.shape[-3:]
    n = comm.size()
    wq = wk = wv = None
    with _collectives.use_plain():
        for i, st in enumerate(ring_bwd_steps(q, k, v, do, comm, causal)):
            a = (st.do.float().square() * st.out.float().square()).sum(
                -1, keepdim=True)
            sq = _bwd_squares(*st.args, scale=1.0, causal=causal, a=a)
            rows = sq[0].shape[0]
            sk, sv = (x.reshape(*lead, rows // comm.nranks, t, d)
                      for x in sq[1:])
            if i == 0:
                wq, wk, wv = sq[0], sk, sv
            else:
                wq, wk, wv = wq + sq[0], wk + sk, wv + sv
            if n > 1:  # as dk and dv: one hop after every step
                wk, wv = _collectives.ring_shift_n((wk, wv), comm, 1)
    return tuple(flash._from_bhtd(w.reshape(-1, t, d).sqrt(), q.shape[:-3],
                                  h) for w in (wq, wk, wv))


def ring_grad_check(q, k, v, do, comm, causal, grads):
    """The ring's gradients held to the plain route's: ``bwd_errors`` of
    the f32 ``(dq, dk, dv)`` (``ring_grads``) over ``ring_bwd_noise``,
    whether they are within ``TOL_BWD``, and whether ``grads``, the entry
    point's ``(q.grad, k.grad, v.grad)`` for the same inputs and
    cotangent, are those f32 gradients cast bit for bit (q.grad through
    the prescale's chain rule: dq cast, times the scale in q's type)."""
    got, ref = ring_grads(q, k, v, do, comm, causal)
    errs = bwd_errors(got, ref, ring_bwd_noise(q, k, v, do, comm, causal))
    c = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype).item()
    want = (got[0].to(q.dtype) * c, got[1].to(k.dtype), got[2].to(v.dtype))
    return {**errs, "within": within_bwd(errs, q.dtype),
            "grads_are_f32_cast": all(torch.equal(g, w)
                                      for g, w in zip(grads, want))}
