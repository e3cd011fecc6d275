"""The tile walks of kernels 5, 6 and 7 held to their plain versions, on
the CPU.

``csrc/flash_fwd.cu`` (kernel 5) gives a block 128 query rows, two
warpgroups of 64, and walks 128-key tiles; in ``csrc/flash_bwd.cu``, kernel
6 gives a block 128 query rows, two warpgroups of 64, and walks 64-key
tiles, and kernel 7 gives a block 128 keys, two warpgroups of 64, and walks
64-query tiles.  Which tiles a block visits is ``tiles_to_visit`` and
``first_q_tile`` of ``csrc/flash_tiles.cuh``; a warpgroup computes only the
visited tiles that hold a pair it sees: the walks count only rows within Tq
and keys within Tk.  ``_fwd_walk``, ``_dq_walk`` and ``_dkv_walk`` below
are that walk and the kernels' rounding points in torch, a model of the
kernels for these tests and not a second plain version: kernel 5 takes
p = exp(s - m) against the running maximum, rounds it to the input type
before P V and rescales its sums tile by tile; kernel 6 rounds dS to the
input type before dQ += dS K and sums the tiles in order; kernel 7 rounds
P^T and dS^T to the input type before dV += P^T dO and dK += dS^T Q and
sums the tiles in order.  Each model is held to ``flash_fwd_block_plain``
or ``flash_bwd_block_plain`` within ``_flash_check.TOL`` or ``TOL_BWD``
(errors over each component's rounding-noise scale; see
``mpi4jax_tpu_torch/ops/_flash_check.py``), at a ring's offsets (the
diagonal step, the step below it, whose keys every row sees, and the one
above, which no row sees), at partial overlaps and per-row offsets, at
ragged Tq and Tk, causal and not.  The walks must
compute every pair a row sees and no tile that holds none.  The header's
two functions are built with g++ and held to the Python ones, and the
source substitutions of ``benchmarks/flash_tolerance.py`` (planted faults)
and ``benchmarks/kernel_variants.py`` (designs tried) must each find their
text.

Three files of at most 45 cases: kernel 5's walk, the header and the
substitutions here; kernel 6's walk in
``tests/test_torch_flash_tiles_dq.py`` and kernel 7's in
``tests/test_torch_flash_tiles_dkv.py``, which import the models from
here.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch import _build
from mpi4jax_tpu_torch.benchmarks import flash_tolerance, kernel_variants
from mpi4jax_tpu_torch.ops import _flash_check as chk
from mpi4jax_tpu_torch.ops import flash

BQ5, BK5 = 128, 128  # kernel 5: rows of a block, keys of a tile
BQ6, BK6 = 128, 64   # kernel 6: rows of a block, keys of a tile
BK7, BQ7 = 128, 64   # kernel 7: keys of a block, queries of a tile
WG = 64              # rows (5, 6) or keys (7) of a consumer warpgroup
T = 200              # a ring's local length: ragged against both tiles
# (name, BH, Tq, Tk, q_off per row, k_off per row)
CASES = (
    ("ring diagonal", 2, T, T, (T,), (T,)),
    ("ring below", 2, T, T, (2 * T,), (T,)),
    ("ring above", 2, T, T, (T,), (2 * T,)),
    ("partial overlap", 1, 130, 300, (64,), (0,)),
    ("rows that see nothing", 1, 77, 300, (16,), (160,)),
    ("per-row offsets", 3, 150, 257, (0, 64, 16), (0, 0, 32)),
)
DTYPES = (torch.bfloat16, torch.float16)
D = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are many small
    products, which threads only slow down when the suite runs several
    workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiles_to_visit(tk, bk, bq, q_off, q0, k_off, causal):
    """``tiles_to_visit`` of ``csrc/flash_tiles.cuh``."""
    nk = (tk + bk - 1) // bk
    if causal:
        last = q_off + q0 + bq - 1 - k_off
        if last < 0:
            return 0
        nk = min(nk, last // bk + 1)
    return nk


def first_q_tile(tq, bq, q_off, k0, k_off, causal):
    """``first_q_tile`` of ``csrc/flash_tiles.cuh``."""
    nq = (tq + bq - 1) // bq
    if not causal:
        return 0
    first = k_off + k0 - q_off
    if first <= 0:
        return 0
    return nq if first >= tq else first // bq


def _seen(q_off, k_off, rows, cols, causal):
    """Which (row, col) pairs of the local ranges a causal row sees."""
    if not causal:
        return torch.ones(len(rows), len(cols), dtype=torch.bool)
    return (k_off + torch.tensor(cols))[None, :] <= (
        q_off + torch.tensor(rows))[:, None]


def _fwd_walk(q, k, v, q_off, k_off, *, scale, causal):
    """Kernel 5's walk: ``(o, m, l)`` as ``flash_fwd_block_plain`` returns
    them, the pairs computed ``(BH, Tq, Tk)`` and the number of
    (warpgroup, tile) steps that held no pair their rows see."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    o = torch.zeros(bh, tq, d)
    m = torch.full((bh, tq, 1), flash.NEG_INF)
    l = torch.zeros(bh, tq, 1)
    done = torch.zeros(bh, tq, tk, dtype=torch.bool)
    idle = 0
    for b in range(bh):
        qo, ko = int(q_off[b]), int(k_off[b])
        for blk_q0 in range(0, tq, BQ5):
            nk = tiles_to_visit(tk, BK5, min(BQ5, tq - blk_q0), qo, blk_q0,
                                ko, causal)
            for q0 in (blk_q0, blk_q0 + WG):
                nkw = tiles_to_visit(tk, BK5, min(WG, tq - q0), qo, q0, ko,
                                     causal) if q0 < tq else 0
                rows = list(range(q0, min(q0 + WG, tq)))
                if not rows:
                    continue
                acc = torch.zeros(len(rows), d)
                m_r = torch.full((len(rows), 1), flash.NEG_INF)
                l_r = torch.zeros(len(rows), 1)
                for kt in range(min(nk, nkw)):
                    cols = list(range(kt * BK5, min((kt + 1) * BK5, tk)))
                    ok = _seen(qo, ko, rows, cols, causal)
                    idle += not bool(ok.any())
                    done[b, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = True
                    s = q[b, rows].float() @ k[b, cols].float().T
                    if scale != 1.0:
                        s = s * scale
                    x = torch.where(ok, s, flash.NEG_INF)
                    mx = torch.maximum(m_r, x.amax(-1, keepdim=True))
                    alpha = torch.exp(m_r - mx)
                    p = torch.where(ok, torch.exp(x - mx), 0.0)
                    l_r = l_r * alpha + p.sum(-1, keepdim=True)
                    pv = p.to(v.dtype).float() @ v[b, cols].float()
                    acc = acc * alpha + pv
                    m_r = mx
                o[b, rows], m[b, rows], l[b, rows] = acc, m_r, l_r
    return (o, m, l), done, idle


def _dq_walk(q, k, v, do, lse, delta, q_off, k_off, *, scale, causal):
    """Kernel 6's walk: dq as ``flash_bwd_block_plain`` returns it, the
    pairs computed ``(BH, Tq, Tk)`` and the number of (warpgroup, tile)
    steps that held no pair their rows see."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dq = torch.zeros(bh, tq, d)
    done = torch.zeros(bh, tq, tk, dtype=torch.bool)
    idle = 0
    for b in range(bh):
        qo, ko = int(q_off[b]), int(k_off[b])
        for blk_q0 in range(0, tq, BQ6):
            nk = tiles_to_visit(tk, BK6, min(BQ6, tq - blk_q0), qo, blk_q0,
                                ko, causal)
            for q0 in (blk_q0, blk_q0 + WG):
                nkw = tiles_to_visit(tk, BK6, min(WG, tq - q0), qo, q0, ko,
                                     causal) if q0 < tq else 0
                rows = list(range(q0, min(q0 + WG, tq)))
                for kt in range(min(nk, nkw)):
                    cols = list(range(kt * BK6, min((kt + 1) * BK6, tk)))
                    ok = _seen(qo, ko, rows, cols, causal)
                    idle += not bool(ok.any())
                    done[b, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = True
                    s = q[b, rows].float() @ k[b, cols].float().T
                    if scale != 1.0:
                        s = s * scale
                    p = torch.where(ok, torch.exp(s - lse[b, rows]), 0.0)
                    dp = do[b, rows].float() @ v[b, cols].float().T
                    ds = p * (dp - delta[b, rows])
                    if scale != 1.0:
                        ds = ds * scale
                    dq[b, rows] += ds.to(k.dtype).float() @ k[b, cols].float()
    return dq, done, idle


def _dkv_walk(q, k, v, do, lse, delta, q_off, k_off, *, scale, causal):
    """Kernel 7's walk: ``(dk, dv)`` as ``flash_bwd_block_plain`` returns
    them, the pairs computed ``(BH, Tq, Tk)`` and the number of
    (warpgroup, tile) steps that held no pair their keys see."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dk = torch.zeros(bh, tk, d)
    dv = torch.zeros(bh, tk, d)
    done = torch.zeros(bh, tq, tk, dtype=torch.bool)
    idle = 0
    nq = (tq + BQ7 - 1) // BQ7
    for b in range(bh):
        qo, ko = int(q_off[b]), int(k_off[b])
        for blk_k0 in range(0, tk, BK7):
            t0 = first_q_tile(tq, BQ7, qo, blk_k0, ko, causal)
            for k0 in (blk_k0, blk_k0 + WG):
                t0w = first_q_tile(tq, BQ7, qo, k0, ko, causal) \
                    if k0 < tk else nq
                keys = list(range(k0, min(k0 + WG, tk)))
                if not keys:
                    continue
                for qt in range(max(t0, t0w), nq):
                    rows = list(range(qt * BQ7, min((qt + 1) * BQ7, tq)))
                    ok = _seen(qo, ko, rows, keys, causal).T  # keys x rows
                    idle += not bool(ok.any())
                    done[b, rows[0]:rows[-1] + 1, keys[0]:keys[-1] + 1] = True
                    st = k[b, keys].float() @ q[b, rows].float().T
                    if scale != 1.0:
                        st = st * scale
                    p = torch.where(ok, torch.exp(st - lse[b, rows].T), 0.0)
                    dpt = v[b, keys].float() @ do[b, rows].float().T
                    ds = p * (dpt - delta[b, rows].T)
                    if scale != 1.0:
                        ds = ds * scale
                    dv[b, keys] += p.to(do.dtype).float() @ do[b, rows].float()
                    dk[b, keys] += ds.to(q.dtype).float() @ q[b, rows].float()
    return (dk, dv), done, idle


def _inputs(bh, tq, tk, q_off, k_off, dtype, seed):
    rng = np.random.default_rng(seed)

    def draw(t):
        return torch.from_numpy(
            rng.standard_normal((bh, t, D)).astype(np.float32) * 0.4).to(dtype)

    q, k, v, do = draw(tq), draw(tk), draw(tk), draw(tq)
    rows = lambda offs: torch.tensor([offs[i % len(offs)] for i in range(bh)],
                                     dtype=torch.int32)
    return q, k, v, do, rows(q_off), rows(k_off)


def _visible(q_off, k_off, tq, tk, causal):
    bh = len(q_off)
    if not causal:
        return torch.ones(bh, tq, tk, dtype=torch.bool)
    return torch.stack([_seen(int(q_off[b]), int(k_off[b]), range(tq),
                              range(tk), True) for b in range(bh)])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_walk_matches_plain(case, causal, dtype):
    _, bh, tq, tk, qo, ko = case
    q, k, v, _, q_off, k_off = _inputs(bh, tq, tk, qo, ko, dtype, seed=tq)
    scale = 1.0 if causal else 0.25
    got, done, idle = _fwd_walk(q, k, v, q_off, k_off, scale=scale,
                                causal=causal)
    ref = flash.flash_fwd_block_plain(q, k, v, q_off, k_off, scale=scale,
                                      causal=causal)
    noise = chk.noise(q, k, v, q_off, k_off, scale=scale, causal=causal)
    errs = chk.errors(got, ref, noise)
    assert chk.within(errs, dtype), errs
    assert bool(done[_visible(q_off, k_off, tq, tk, causal)].all())
    assert idle == 0


def _bwd_case(case, causal, dtype):
    """The inputs of a backward case, with the lse and delta of the plain
    forward, and its scale."""
    _, bh, tq, tk, qo, ko = case
    q, k, v, do, q_off, k_off = _inputs(bh, tq, tk, qo, ko, dtype, seed=tk)
    scale = 1.0 if causal else 0.25
    o, m, l = flash.flash_fwd_block_plain(q, k, v, q_off, k_off, scale=scale,
                                          causal=causal)
    live = l > 0
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)), 0.0)
    delta = (do.float() * o / torch.where(live, l, 1.0)).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta, q_off, k_off), scale


def _check_bwd_walk(args, scale, causal, dtype, got, done, idle):
    q, k, _, _, _, _, q_off, k_off = args
    ref = flash.flash_bwd_block_plain(*args, scale=scale, causal=causal)
    noise = chk.bwd_noise(*args, scale=scale, causal=causal)
    errs = chk.bwd_errors(tuple(r if g is None else g
                                for g, r in zip(got, ref)), ref, noise)
    assert chk.within_bwd(errs, dtype), errs
    assert bool(done[_visible(q_off, k_off, q.shape[1], k.shape[1],
                              causal)].all())
    assert idle == 0


def test_heaviest_blocks_start_first():
    """Kernels 5 and 6's block x takes rows from the end
    (``gridDim.x - 1 - x``), so at the diagonal its first blocks visit the
    most tiles; kernel 7's block x takes keys from the start, so its first
    blocks see the most query tiles."""
    tq = tk = 1000
    nx = (tq + BQ5 - 1) // BQ5
    fwd = [tiles_to_visit(tk, BK5, BQ5, 0, (nx - 1 - x) * BQ5, 0, 1)
           for x in range(nx)]
    nx6 = (tq + BQ6 - 1) // BQ6
    dq = [tiles_to_visit(tk, BK6, BQ6, 0, (nx6 - 1 - x) * BQ6, 0, 1)
          for x in range(nx6)]
    bwd = [(tq + BQ7 - 1) // BQ7 - first_q_tile(tq, BQ7, 0, x * BK7, 0, 1)
           for x in range((tk + BK7 - 1) // BK7)]
    for tiles in (fwd, dq, bwd):
        assert tiles == sorted(tiles, reverse=True) and tiles[0] > tiles[-1]


@pytest.fixture(scope="module")
def tiles_lib(tmp_path_factory):
    """``csrc/flash_tiles.cuh`` built with g++ behind two C functions."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("tiles")
    src = out / "tiles.cpp"
    src.write_text(
        '#include "flash_tiles.cuh"\n'
        'extern "C" int c_tiles_to_visit(int tk, int bk, int bq, long long '
        "qo, int q0, long long ko, int causal) { return tiles_to_visit(tk, "
        "bk, bq, qo, q0, ko, causal); }\n"
        'extern "C" int c_first_q_tile(int tq, int bq, long long qo, int k0, '
        "long long ko, int causal) { return first_q_tile(tq, bq, qo, k0, ko, "
        "causal); }\n")
    lib_path = out / "tiles.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-I", str(_build.CSRC),
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    i, ll = ctypes.c_int, ctypes.c_longlong
    lib.c_tiles_to_visit.argtypes = [i, i, i, ll, i, ll, i]
    lib.c_first_q_tile.argtypes = [i, i, ll, i, ll, i]
    return lib


def test_header_matches_its_model(tiles_lib):
    lens = (0, 1, 63, 64, 77, 128, 129, 300, 4096)
    offs = (0, 1, 64, 127, 128, 1000, 4096)
    starts = (0, 64, 128, 256, 3968)
    count = 0
    for causal in (0, 1):
        for t in lens:
            for width in (32, 64, 128):
                for q_off in offs:
                    for k_off in offs:
                        for start in starts:
                            for rows in (16, 64, 128):
                                assert tiles_lib.c_tiles_to_visit(
                                    t, width, rows, q_off, start, k_off,
                                    causal) == tiles_to_visit(
                                    t, width, rows, q_off, start, k_off,
                                    causal)
                            assert tiles_lib.c_first_q_tile(
                                t, width, q_off, start, k_off,
                                causal) == first_q_tile(
                                t, width, q_off, start, k_off, causal)
                            count += 1
    assert count == 2 * len(lens) * 3 * len(offs) ** 2 * len(starts)


@pytest.mark.parametrize("name", sorted(flash_tolerance.SOURCES))
def test_planted_faults_find_their_lines(name):
    """Every fault of ``benchmarks/flash_tolerance.py`` finds its text
    exactly once in the kernels' sources, so each planted copy builds the
    fault it names."""
    for fault in flash_tolerance.SOURCES[name]:
        src = flash_tolerance.planted_source(fault, name)
        assert src != (_build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_find_their_lines(name):
    """Every variant of ``benchmarks/kernel_variants.py`` finds its text
    exactly once in the source it changes."""
    for variant in kernel_variants.VARIANTS[name]:
        src = kernel_variants.variant_source(name, variant)
        assert src != (_build.CSRC / f"{name}.cu").read_text()
