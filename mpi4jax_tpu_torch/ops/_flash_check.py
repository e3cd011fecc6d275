"""The check that holds kernel 5 against its plain version on the card.

Shared by ``chip_smoke.py``, ``tests/test_torch_flash_gpu.py`` and
``benchmarks/flash_tolerance.py``: ``cases`` makes the edge inputs from a
seed, ``noise`` and ``ring_noise`` give each output component's scale of
rounding noise, ``errors`` measures a kernel triple against the plain one,
``ring_outputs`` runs the ring on both routes, and ``TOL`` bounds each error
by type:

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
"""

from __future__ import annotations

import torch

from . import _collectives, flash
from .flash import NEG_INF

TOL = {
    torch.float32: {"o": 1e-3, "l": 1e-5, "m": 1e-5},
    torch.bfloat16: {"o": 4e-2, "l": 1e-4, "m": 1e-4},
    torch.float16: {"o": 1e-2, "l": 1e-4, "m": 1e-4},
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
