"""The readings that set the tolerances of kernel 5
(``ops/_flash_check.TOL``) and of kernels 6 and 7 (``TOL_BWD``).

Builds kernel 5 from ``csrc/flash_fwd.cu`` and kernels 6 and 7 from
``csrc/flash_bwd.cu`` and, beside them, copies of those sources with one
fault planted each, by a text substitution made at run time into the build
directory (the checkout's sources stay as they are).  Kernel 5's faults:

- ``tile``: the probabilities of the middle k tile (``kt == nk / 2``, nk
  the tiles of Tk) dropped from both l and P V;
- ``pv``: that tile's P V dropped, its p still summed into l;
- ``key``: the middle key (``Tk / 2``) dropped;
- ``diag``: the causal mask off by one (key c seen by row r only when
  c < r).

Every kernel, sound or not, is held to the plain version, with the errors
of ``_flash_check.errors``, on (1) the edge cases of ``_flash_check.cases``,
by dtype; (2) path (d)'s launches at B4 T4096 H16 D128 bf16 causal on the
path's prescaled q: the whole forward at n = 1 and the four ring steps at
n = 4; (3) path (f)'s launches (one layer's attention of the GPT-2 step:
96 rows of T1024 D64 at (1, 1, 1), both ring steps of 192 rows of T512
at (1, 2, 2)); (4) the ring's f32 output at n = 1 and n = 4 against the
plain route's, over ``_flash_check.ring_noise``.  A limit is sound when it lies
above the sound kernel's worst reading and below every fault's reading.

Kernels 6 and 7's faults (``BWD_FAULTS``), each in the bf16/fp16 and the
f32 kernels:

- ``dq_tile``: kernel 6 skips the middle k tile (its p taken as 0);
- ``dkv_tile``: kernel 7 skips the middle q tile;
- ``delta``: delta dropped from ds in both kernels;
- ``lse``: the lse of row Tq / 2 off by log 2 in both kernels.

Each is held to ``flash_bwd_block_plain`` with ``_flash_check.bwd_errors``
on (1) the edge cases of ``bwd_cases``, by dtype; (2) path (e)'s launches:
the whole backward at n = 1 and the four ring steps at n = 4, with the lse
and delta of the path's forward; (3) path (f)'s launches, as for kernel 5;
(4) the ring's f32 gradients at n = 1 and 4 against the plain route's,
over ``ring_bwd_noise``.

``--part gpt`` reads the whole-step check of path (f)
(``gpt_step.route_check``, one GPT-2 124M B8 T1024 bf16 step on the
kernel route against one on the plain route, ``ROUTE_TOL``): the sound
kernels at seeds 0-3 on the (1, 1, 1) and (1, 2, 2) meshes, and each of
the eight planted faults above at (1, 1, 1).

    python -m mpi4jax_tpu_torch.benchmarks.flash_tolerance [--part bwd]

Prints the card's name and power limit, one JSON line per kernel and
input set (``kernel``, ``set``, the worst errors, ``caught``: how many
cases ``within`` or ``within_bwd`` fails), and a last JSON line that sums
up the readings per set.  Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import _build
from ..ops import _flash_check as chk
from ..ops import _collectives, flash
from ..parallel.mesh import make_mesh
from . import gpt_step as gpt_bench
from . import ring_attention as ring_bench

_MID_TILE = "kt == ((tk + {bk} - 1) / {bk}) / 2"
# the same test on kp, the tile whose P V kernel 5 issues
_MID_PV = _MID_TILE.format(bk="kBK").replace("kt", "kp", 1)
# fault -> [(text in csrc/flash_fwd.cu, its replacement)], each text found
# exactly once: the bf16/fp16 kernel's lines first, then the f32 kernel's
FAULTS = {
    "tile": [
        ("const float p = expf(sc[nt * 4 + e] - mx[hr]);",
         "const float p = " + _MID_TILE.format(bk="kBK")
         + " ? 0.f : expf(sc[nt * 4 + e] - mx[hr]);"),
        ("const float p = ok ? expf(x - mx) : 0.f;",
         "const float p = ok && !(" + _MID_TILE.format(bk="kBKF")
         + ") ? expf(x - mx) : 0.f;"),
    ],
    "pv": [
        ("issue_pv<T, D>(acc, pa, v_prev);",
         "if (" + _MID_PV + ") wg_commit(); "
         "else issue_pv<T, D>(acc, pa, v_prev);"),
        ("issue_pv<T, D>(acc, pa, v_last);",
         "if (" + _MID_PV + ") wg_commit(); "
         "else issue_pv<T, D>(acc, pa, v_last);"),
        ("const float pj = __shfl_sync(0xffffffffu, p, j);",
         "const float pj = " + _MID_TILE.format(bk="kBKF")
         + " ? 0.f : __shfl_sync(0xffffffffu, p, j);"),
    ],
    "key": [
        ("const float p = expf(sc[nt * 4 + e] - mx[hr]);",
         "const float p = k0 + nt * 8 + t4 * 2 + (e & 1) == tk / 2 ? 0.f : "
         "expf(sc[nt * 4 + e] - mx[hr]);"),
        ("const float p = ok ? expf(x - mx) : 0.f;",
         "const float p = ok && col != tk / 2 ? expf(x - mx) : 0.f;"),
    ],
    "diag": [
        ("(!causal || k_off + col <= row_pos[hr]);",
         "(!causal || k_off + col < row_pos[hr]);"),
        ("(!causal || k_off + k0 + kBK - 1 <= q_off + q0);",
         "(!causal || k_off + k0 + kBK - 1 < q_off + q0);"),
        ("(!causal || k_off + col <= q_off + q0 + rl);",
         "(!causal || k_off + col < q_off + q0 + rl);"),
    ],
}
def _mid(var, width, n):
    return f"{var} == (({n} + {width} - 1) / {width}) / 2"


_LOG2 = " + ({} == tq / 2 ? 0.6931472f : 0.f)"
# kernels 6 and 7's faults in csrc/flash_bwd.cu: the wgmma kernels' lines
# first, then the f32 kernels'
BWD_FAULTS = {
    "dq_tile": [
        ("const float p = expf(ok ? x - lse_r[hr] : -INFINITY);",
         "const float p = expf(ok && !(" + _mid("kt", "kT6", "tk")
         + ") ? x - lse_r[hr] : -INFINITY);"),
        ("const float p = ok ? expf(x - lse_r[i]) : 0.f;",
         "const float p = ok && !(" + _mid("kt", "kTF", "tk")
         + ") ? expf(x - lse_r[i]) : 0.f;"),
    ],
    "dkv_tile": [
        ("const float p = expf(ok ? x - lc[qi] : -INFINITY);",
         "const float p = expf(ok && !(" + _mid("qt", "kT7", "tq")
         + ") ? x - lc[qi] : -INFINITY);"),
        ("const float p = ok ? expf(x - Ls[lane]) : 0.f;",
         "const float p = ok && !(" + _mid("qt", "kTF", "tq")
         + ") ? expf(x - Ls[lane]) : 0.f;"),
    ],
    "delta": [
        ("float ds = p * (dp[nt * 4 + e] - dlt_r[hr]);",
         "float ds = p * dp[nt * 4 + e];"),
        ("float ds = p * (dpT[nt * 4 + e] - ec[qi]);",
         "float ds = p * dpT[nt * 4 + e];"),
        ("float ds = p * (dpv - dlt_r[i]);", "float ds = p * dpv;"),
        ("float ds = p * (dpv - Es[lane]);", "float ds = p * dpv;"),
    ],
    "lse": [
        ("lse_r[hr] = r < tq ? lse[qrow + r] : 0.f;",
         "lse_r[hr] = r < tq ? lse[qrow + r]" + _LOG2.format("r") + " : 0.f;"),
        ("Ls[st * kT7 + i] = r < tq ? lse[qrow + r] : 0.f;",
         "Ls[st * kT7 + i] = r < tq ? lse[qrow + r]" + _LOG2.format("r")
         + " : 0.f;"),
        ("lse_r[i] = r < tq ? lse[qrow + r] : 0.f;",
         "lse_r[i] = r < tq ? lse[qrow + r]" + _LOG2.format("r") + " : 0.f;"),
        ("Ls[i] = in ? lse[qrow + q0t + i] : 0.f;",
         "Ls[i] = in ? lse[qrow + q0t + i]" + _LOG2.format("q0t + i")
         + " : 0.f;"),
    ],
}
SOURCES = {"flash_fwd": FAULTS, "flash_bwd": BWD_FAULTS}
PATH_SHAPE = (4, 4096, 16, 128)
PATH_RANKS = (1, 4)
GPT_SEEDS = (0, 1, 2, 3)


def planted_source(fault: str, name: str = "flash_fwd") -> str:
    """``csrc/<name>.cu`` with ``fault`` planted."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in SOURCES[name][fault]:
        if src.count(old) != 1:
            raise RuntimeError(f"fault {fault}: {old!r} is not in the "
                               "source exactly once")
        src = src.replace(old, new)
    return src


def build_planted(fault: str, name: str = "flash_fwd") -> ctypes.CDLL:
    """Build and load the library of ``planted_source(fault, name)``."""
    out = _build.BUILD_DIR / "planted"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}_{fault}.cu"
    src.write_text(planted_source(fault, name))
    lib_path = out / f"{name}_{fault}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib_path), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on fault {fault}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


class _Using:
    """Within the block, the kernels of ``csrc/<name>.cu`` launch ``lib``."""

    def __init__(self, lib, name="flash_fwd"):
        self.lib, self.name = lib, name

    def __enter__(self):
        self.saved = _build._LIBS.get(self.name)
        _build._LIBS[self.name] = self.lib

    def __exit__(self, *exc):
        _build._LIBS[self.name] = self.saved


def _edge_sets(dev):
    """The edge cases with their plain triples and noise, by dtype."""
    sets = {}
    for tag, q, k, v, qo, ko, scale, causal in chk.cases(dev):
        ref = flash.flash_fwd_block_plain(q, k, v, qo, ko, scale=scale,
                                          causal=causal)
        nz = chk.noise(q, k, v, qo, ko, scale=scale, causal=causal)
        sets.setdefault(f"edge {str(q.dtype)[6:]}", []).append(
            (tag, (q, k, v, qo, ko, scale, causal), ref, nz))
    return sets


def _path_launches(dev, qkv):
    """Path (d)'s launches: the whole forward at n = 1 and the four steps at
    n = 4, on the prescaled q, with their plain triples and noise."""
    b, t, h, d = PATH_SHAPE
    cases = []
    for n in PATH_RANKS:
        comm = make_mesh(n, device=dev)
        q, k, v = (flash._to_bhtd(ring_bench.shard(x, n)) for x in qkv)
        q = flash.prescale(q)
        offs = flash._ring_offsets(comm, b * h, t // n, dev)
        for i in range(n):
            qo, ko = offs[i][:, 0], offs[i][:, 1]
            ref = flash.flash_fwd_block_plain(q, k, v, qo, ko, scale=1.0,
                                              causal=True)
            nz = chk.noise(q, k, v, qo, ko, scale=1.0, causal=True)
            cases.append((f"n={n} step {i}", (q, k, v, qo, ko, 1.0, True),
                          ref, nz))
    return cases


def _gpt_steps(dev):
    """Path (f)'s launches: one layer's attention of the GPT-2 124M B8
    T1024 step at (1, 1, 1) and both ring steps at (1, 2, 2)
    (``gpt_step.attention_inputs``, seed 2), with the lse and delta of the
    ring's forward on the plain route."""
    out = []
    for mesh in gpt_bench.MESHES:
        *qkvdo, comm = gpt_bench.attention_inputs(
            gpt_bench.CFG, mesh, gpt_bench.BATCH, gpt_bench.SEQ, 2, dev)
        with _collectives.use_plain():
            out += [(f"{mesh} step {i}", st) for i, st in enumerate(
                chk.ring_bwd_steps(*qkvdo, comm, True))]
    return out


def _gpt_launches(steps):
    """Kernel 5's cases at path (f)'s launches, with their plain triples
    and noise."""
    cases = []
    for tag, st in steps:
        args = (st.q, st.k, st.v, st.offs[:, 0], st.offs[:, 1])
        cases.append((tag, (*args, 1.0, True),
                      flash.flash_fwd_block_plain(*args, scale=1.0,
                                                  causal=True),
                      chk.noise(*args, scale=1.0, causal=True)))
    return cases


def _bwd_gpt_launches(steps):
    """Kernels 6 and 7's cases at path (f)'s launches, with their plain
    gradients and noise."""
    kw = dict(scale=1.0, causal=True)
    cases = []
    for tag, st in steps:
        args = (*st.args[:6], st.offs[:, 0], st.offs[:, 1])
        cases.append((tag, args, kw, flash.flash_bwd_block_plain(*args, **kw),
                      chk.bwd_noise(*args, **kw)))
    return cases


def _block_reading(cases):
    """The worst errors over ``cases`` of the kernel now loaded, and
    whether ``within`` fails any."""
    worst = {"o": 0.0, "l": 0.0, "m": 0.0}
    caught = []
    for tag, (q, k, v, qo, ko, scale, causal), ref, nz in cases:
        got = flash.flash_fwd_block(q, k, v, qo, ko, scale=scale,
                                    causal=causal)
        errs = chk.errors(got, ref, nz)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
        if not chk.within(errs, q.dtype):
            caught.append(tag)
    return worst, caught


def _bwd_edge_sets(dev):
    """The backward's edge cases with their plain gradients and noise, by
    dtype."""
    sets = {}
    for case in chk.bwd_cases(dev):
        tag, q, k, v, do, lse, delta, qo, ko, scale, causal = case
        args = (q, k, v, do, lse, delta, qo, ko)
        kw = dict(scale=scale, causal=causal)
        sets.setdefault(f"bwd edge {str(q.dtype)[6:]}", []).append(
            (tag, args, kw, flash.flash_bwd_block_plain(*args, **kw),
             chk.bwd_noise(*args, **kw)))
    return sets


def _bwd_path_launches(dev, qkv):
    """Path (e)'s backward launches: the whole backward at n = 1 and the
    four steps at n = 4 (``ring_bwd_steps``: the prescaled q, dO from seed
    1, and the lse and delta of the path's forward on the plain route),
    with their plain gradients and noise."""
    do_g = ring_bench.make_qkv(PATH_SHAPE, torch.bfloat16, dev, seed=1)[0]
    kw = dict(scale=1.0, causal=True)
    cases = []
    for n in PATH_RANKS:
        comm = make_mesh(n, device=dev)
        with _collectives.use_plain():
            steps = list(chk.ring_bwd_steps(
                *(ring_bench.shard(x, n) for x in (*qkv, do_g)), comm, True))
        for i, st in enumerate(steps):
            args = (*st.args[:6], st.offs[:, 0], st.offs[:, 1])
            cases.append((f"n={n} step {i}", args, kw,
                          flash.flash_bwd_block_plain(*args, **kw),
                          chk.bwd_noise(*args, **kw)))
    return cases


def _bwd_reading(cases):
    """The worst errors over ``cases`` of the backward kernels now loaded,
    and the cases ``within_bwd`` fails."""
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    caught = []
    for tag, args, kw, ref, nz in cases:
        errs = chk.bwd_errors(flash.flash_bwd_block(*args, **kw), ref, nz)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
        if not chk.within_bwd(errs, args[0].dtype):
            caught.append(tag)
    return worst, caught


def _build_libs(name, faults):
    with ThreadPoolExecutor(max_workers=len(faults) + 1) as pool:
        sound = pool.submit(_build.library, name)
        planted = {f: pool.submit(build_planted, f, name) for f in faults}
        libs = {"sound": sound.result()}
        libs.update((f, fut.result()) for f, fut in planted.items())
    return libs


def forward_readings(dev, faults):
    """Kernel 5's readings; returns the summary of o errors by set."""
    libs = _build_libs("flash_fwd", faults)
    sets = _edge_sets(dev)
    qkv = ring_bench.make_qkv(PATH_SHAPE, torch.bfloat16, dev, seed=0)
    sets["path bf16"] = _path_launches(dev, qkv)
    sets["gpt bf16"] = _gpt_launches(_gpt_steps(dev))
    rings = {}
    for n in PATH_RANKS:
        comm = make_mesh(n, device=dev)
        q, k, v = (ring_bench.shard(x, n) for x in qkv)
        with _Using(libs["sound"]):
            _, ref = chk.ring_outputs(q, k, v, comm, True)
        rings[n] = (comm, (q, k, v), ref,
                    chk.ring_noise(q, k, v, comm, True))

    summary = {}
    for name, lib in libs.items():
        with _Using(lib):
            for set_name, cases in sets.items():
                worst, caught = _block_reading(cases)
                rec = {"kernel": name, "set": set_name, **worst,
                       "cases": len(cases), "caught": len(caught)}
                print(json.dumps(rec), flush=True)
                summary.setdefault(set_name, {})[name] = worst["o"]
            for n, (comm, (q, k, v), ref, nz) in rings.items():
                got, _ = chk.ring_outputs(q, k, v, comm, True)
                err = chk.scaled_error(got, ref, nz)
                rec = {"kernel": name, "set": f"ring n={n} bf16", "o": err,
                       "caught": int(err > chk.TOL[torch.bfloat16]["o"])}
                print(json.dumps(rec), flush=True)
                summary.setdefault(f"ring n={n} bf16", {})[name] = err
            torch.cuda.synchronize(dev)
    return summary


def backward_readings(dev, faults):
    """Kernels 6 and 7's readings; returns the summary of the largest of
    the dq, dk and dv errors by set."""
    libs = _build_libs("flash_bwd", faults)
    sets = _bwd_edge_sets(dev)
    qkv = ring_bench.make_qkv(PATH_SHAPE, torch.bfloat16, dev, seed=0)
    sets["bwd path bf16"] = _bwd_path_launches(dev, qkv)
    sets["bwd gpt bf16"] = _bwd_gpt_launches(_gpt_steps(dev))
    do_g = ring_bench.make_qkv(PATH_SHAPE, torch.bfloat16, dev, seed=1)[0]
    rings = {}
    for n in PATH_RANKS:
        comm = make_mesh(n, device=dev)
        args = tuple(ring_bench.shard(x, n) for x in (*qkv, do_g)) + (
            comm, True)
        with _Using(libs["sound"], "flash_bwd"):
            _, ref = chk.ring_grads(*args)
        rings[n] = (args, ref, chk.ring_bwd_noise(*args))

    summary = {}
    for name, lib in libs.items():
        with _Using(lib, "flash_bwd"):
            for set_name, cases in sets.items():
                worst, caught = _bwd_reading(cases)
                print(json.dumps({"kernel": name, "set": set_name, **worst,
                                  "cases": len(cases),
                                  "caught": len(caught)}), flush=True)
                summary.setdefault(set_name, {})[name] = max(worst.values())
            for n, (args, ref, nz) in rings.items():
                got, _ = chk.ring_grads(*args)
                errs = chk.bwd_errors(got, ref, nz)
                errs.pop("max_abs_err")
                print(json.dumps({"kernel": name,
                                  "set": f"bwd ring n={n} bf16", **errs,
                                  "caught": int(not chk.within_bwd(
                                      errs, torch.bfloat16))}), flush=True)
                summary.setdefault(f"bwd ring n={n} bf16", {})[name] = max(
                    errs.values())
            torch.cuda.synchronize(dev)
    return summary


def gpt_readings(dev, seeds=GPT_SEEDS):
    """``gpt_step.route_check`` at path (f)'s GPT-2 124M B8 T1024 bf16
    step: the sound kernels at ``seeds`` on both meshes, then each planted
    fault of kernel 5 and of kernels 6 and 7 at (1, 1, 1), seed 0.
    Returns the readings (``loss_rel``, ``worst_grad``, ``worst_update``,
    ``within``) by kernel."""
    fwd = _build_libs("flash_fwd", sorted(FAULTS))
    bwd = _build_libs("flash_bwd", sorted(BWD_FAULTS))
    keys = ("loss_rel", "worst_grad", "worst_update", "within")
    out = {}

    def read(kernel, mesh, seed):
        toks = gpt_bench.make_tokens(gpt_bench.BATCH, gpt_bench.SEQ,
                                     gpt_bench.CFG.vocab, seed, dev)
        res = gpt_bench.route_check(gpt_bench.CFG, mesh, toks, device=dev,
                                    seed=seed)
        rec = {"kernel": kernel, "set": f"gpt {mesh} seed {seed}",
               **{k: res[k] for k in keys}}
        print(json.dumps(rec), flush=True)
        out.setdefault(kernel, []).append(rec)
        torch.cuda.empty_cache()

    for mesh in gpt_bench.MESHES:
        for seed in seeds:
            read("sound", mesh, seed)
    for name, libs in (("flash_fwd", fwd), ("flash_bwd", bwd)):
        for fault, lib in libs.items():
            if fault != "sound":
                with _Using(lib, name):
                    read(f"{name} {fault}", (1, 1, 1), 0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("fwd", "bwd", "both", "gpt"),
                    default="both",
                    help="kernel 5's readings, kernels 6 and 7's, both, or "
                         "path (f)'s route check under every fault")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_tolerance needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    out = {}
    if args.part in ("fwd", "both"):
        out["o_readings"] = forward_readings(dev, sorted(FAULTS))
        out["tol_o"] = {str(k)[6:]: v["o"] for k, v in chk.TOL.items()}
    if args.part in ("bwd", "both"):
        out["grad_readings"] = backward_readings(dev, sorted(BWD_FAULTS))
        out["tol_bwd"] = {str(k)[6:]: v for k, v in chk.TOL_BWD.items()}
    if args.part == "gpt":
        out["gpt_readings"] = gpt_readings(dev)
        out["route_tol"] = gpt_bench.ROUTE_TOL[gpt_bench.CFG.dtype]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
