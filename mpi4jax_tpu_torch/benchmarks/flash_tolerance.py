"""The readings that set kernel 5's tolerances (``ops/_flash_check.TOL``).

Builds kernel 5 from ``csrc/flash_fwd.cu`` and, beside it, copies of that
source with one fault planted each, by a text substitution made at run time
into the build directory (the checkout's sources stay as they are):

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
n = 4; (3) the ring's f32 output at n = 1 and n = 4 against the plain
route's, over ``_flash_check.ring_noise``.  A limit is sound when it lies
above the sound kernel's worst reading and below every fault's reading.

    python -m mpi4jax_tpu_torch.benchmarks.flash_tolerance

Prints the card's name and power limit, one JSON line per kernel and
input set (``kernel``, ``set``, the worst ``o``, ``l`` and ``m`` errors,
``caught``: whether ``_flash_check.within`` fails it), and a last JSON line
that sums up the readings per dtype.  Card only.
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
from ..ops import flash
from ..parallel.mesh import make_mesh
from . import ring_attention as ring_bench

_MID_TILE = "kt == ((tk + {bk} - 1) / {bk}) / 2"
# fault -> [(text in csrc/flash_fwd.cu, its replacement)], each text found
# exactly once: the bf16/fp16 kernel's line first, then the f32 kernel's
FAULTS = {
    "tile": [
        ("const float p = (seen >> (nt * 4 + e)) & 1u",
         "const float p = !(" + _MID_TILE.format(bk="kBK")
         + ") && ((seen >> (nt * 4 + e)) & 1u)"),
        ("const float p = ok ? expf(x - mx) : 0.f;",
         "const float p = ok && !(" + _MID_TILE.format(bk="kBKF")
         + ") ? expf(x - mx) : 0.f;"),
    ],
    "pv": [
        ("for (int kk = 0; kk < kBK / 16; ++kk) {",
         "for (int kk = 0; kk < (" + _MID_TILE.format(bk="kBK")
         + " ? 0 : kBK / 16); ++kk) {"),
        ("const float pj = __shfl_sync(0xffffffffu, p, j);",
         "const float pj = " + _MID_TILE.format(bk="kBKF")
         + " ? 0.f : __shfl_sync(0xffffffffu, p, j);"),
    ],
    "key": [
        ("const float p = (seen >> (nt * 4 + e)) & 1u",
         "const float p = k0 + nt * 8 + t4 * 2 + (e & 1) != tk / 2 && "
         "((seen >> (nt * 4 + e)) & 1u)"),
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
PATH_SHAPE = (4, 4096, 16, 128)
PATH_RANKS = (1, 4)


def planted_source(fault: str) -> str:
    """``csrc/flash_fwd.cu`` with ``fault`` planted."""
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    for old, new in FAULTS[fault]:
        if src.count(old) != 1:
            raise RuntimeError(f"fault {fault}: {old!r} is not in the "
                               "source exactly once")
        src = src.replace(old, new)
    return src


def build_planted(fault: str) -> ctypes.CDLL:
    """Build and load the library of ``planted_source(fault)``."""
    out = _build.BUILD_DIR / "planted"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"flash_fwd_{fault}.cu"
    src.write_text(planted_source(fault))
    lib_path = out / f"flash_fwd_{fault}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on fault {fault}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


class _Using:
    """Within the block, ``flash._flash_fwd_kernel`` launches ``lib``."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved = _build._LIBS.get("flash_fwd")
        _build._LIBS["flash_fwd"] = self.lib

    def __exit__(self, *exc):
        _build._LIBS["flash_fwd"] = self.saved


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", nargs="*", default=sorted(FAULTS),
                    choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_tolerance needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    with ThreadPoolExecutor(max_workers=len(args.faults) + 1) as pool:
        sound = pool.submit(_build.library, "flash_fwd")
        planted = {f: pool.submit(build_planted, f) for f in args.faults}
        libs = {"sound": sound.result()}
        libs.update((f, fut.result()) for f, fut in planted.items())

    sets = _edge_sets(dev)
    qkv = ring_bench.make_qkv(PATH_SHAPE, torch.bfloat16, dev, seed=0)
    sets["path bf16"] = _path_launches(dev, qkv)
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
    print(json.dumps({"o_readings": summary,
                      "tol_o": {str(k)[6:]: v["o"]
                                for k, v in chk.TOL.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
