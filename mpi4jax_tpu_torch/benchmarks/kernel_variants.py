"""Source variants of kernel 8 (``csrc/sw_step.cu``), kernel 6
(``csrc/flash_bwd.cu``) and the alltoall (``csrc/alltoall.cu``), timed
beside the kernels as committed.

A variant is a copy of the source with text substitutions made at run time
into the build directory (as ``flash_tolerance`` plants its faults), built
with nvcc beside the checkout's kernel; the checkout's sources stay as they
are.  The variants are the designs a redesign tried and did not keep:

- kernel 8: ``halo4``, the parent's window of 4 cells per side per step in
  place of 2; ``arrays11``, the shared-memory footprint of the parent's 11
  window arrays (11 floats a cell; the accesses stay the design's);
  ``ieee_div``, IEEE division by dx, dy and in q in place of reciprocals
  and the inline division; ``hoist``, the compiler free to keep every
  cell's addresses across passes (``forget_positions`` emptied);
  ``cells16``, 16 cells a thread in blocks of at most 512 threads;
  ``persistent``, candidate (ii): a persistent grid that brings the next
  tile's window in with ``cp.async`` while it advances the current one.
  The committed kernel is candidate (i), two or more blocks an SM, at each
  tile of ``SW_TILES``;
- kernel 6: ``kt128``, 128-key tiles in place of 64 (in two stages);
  ``stages2``, two stages of K and V in place of three; ``serial``, tile
  kt's dS computed only after tile kt - 1's dQ product is in (no overlap
  of the two);
- the alltoall: ``chunk64k`` (the PR 5 kernel), ``chunk16k`` and
  ``chunk4k``, rows copied in chunks of 64, 16 or 4 KiB a block (four,
  four or one 16-byte loads a thread in flight) in place of 8 KiB (two);
  ``threads128``, 8 KiB chunks by 128 threads of four loads; ``streaming``,
  loads and stores with the evict-first hints (``__ldcs``, ``__stcs``);
  ``bulk_4x32k`` and
  ``bulk_8x16k``, aligned rows of at least one piece copied by
  ``cp.async.bulk`` through shared memory, 4 stages of 32 KiB or 8 of 16
  KiB per SM, one thread of one block per SM issuing them.

Each variant, and the committed kernel, is held to the plain version (kernel
8 within ``_sw_check.CHECK_TOL`` at fuse 1, 2 and 3 on the check states at
1800x3600, both viscosities, before it is timed; kernel 6 within
``TOL_BWD`` at the shapes it is timed at; the alltoall bit for bit at edge
rows: odd sizes, sizes no multiple of 16, inputs 4 bytes off 16, 64 ranks)
and timed by CUDA events in rounds that take the kernels in turn: kernel 8
at path (a)'s 1x1 shape, 1800x3600, per tile and fuse, with the blocks an SM
holds; kernel 6 at path (e)'s n = 1 launch (B4 T4096 H16 D128 bf16 causal)
and path (f)'s (B8 T1024 H12 D64), the alltoall at path (c)'s 256^3
complex64 transposes at n = 4 and 8, beside
``x.transpose(0, 1).contiguous()``.

    python -m mpi4jax_tpu_torch.benchmarks.kernel_variants
        [--part sw|dq|alltoall] [--rounds 3]

Prints the card's name and power limit, each build's ptxas lines
(registers, spills, C7520), and one JSON line per kernel and shape: the ms
per launch of every round.  Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import _build
from ..ops import _collectives as coll
from ..ops import _flash_check as chk
from ..ops import flash
from ..parallel.mesh import make_mesh
from .flash_tolerance import _Using

# The alltoall's bulk path: rows of at least one piece, 16-byte aligned
# with both bases, copied by one thread per block (one block per SM) that
# walks the (pair, piece) items blockIdx.x, blockIdx.x + gridDim.x, ...: a
# piece comes into a stage of shared memory by one cp.async.bulk completing
# on the stage's mbarrier and leaves by another, stages - 1 loads in flight
# behind the stores.
_BULK = """constexpr int kStages = {stages};
constexpr int kBulk = {kib} * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {{
  return (uint32_t)__cvta_generic_to_shared(p);
}}

__global__ void __launch_bounds__(32, 1)
    alltoall_bulk(const unsigned char* __restrict__ x,
                  unsigned char* __restrict__ out,
                  const int* __restrict__ src_rows, long long row_bytes,
                  long long pieces, long long items) {{
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n"
                 :: "r"(smem_u32(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  const long long mine =
      items > blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto piece = [&](long long j, long long& from, long long& to) {{
    const long long it = blockIdx.x + j * gridDim.x;
    const long long p = it / pieces, lo = (it - p * pieces) * kBulk;
    from = (long long)src_rows[p] * row_bytes + lo;
    to = p * row_bytes + lo;
    return (uint32_t)(row_bytes - lo < kBulk ? row_bytes - lo : kBulk);
  }};
  auto load = [&](long long j) {{
    long long from, to;
    const uint32_t n = piece(j, from, to);
    const uint32_t bar = smem_u32(&full[j % kStages]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
                 :: "r"(bar), "r"(n) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\\n"
        :: "r"(smem_u32(buf + (j % kStages) * kBulk)),
           "l"(reinterpret_cast<uint64_t>(x + from)), "r"(n), "r"(bar)
        : "memory");
  }};
  for (long long j = 0; j < mine && j < kStages; ++j) load(j);
  for (long long j = 0; j < mine; ++j) {{
    const int st = (int)(j % kStages);
    const uint32_t bar = smem_u32(&full[st]);
    const uint32_t parity = (uint32_t)((j / kStages) & 1);
    uint32_t done = 0;
    while (!done) {{
      asm volatile(
          "{{\\n.reg .pred p;\\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
          "selp.u32 %0, 1, 0, p;\\n}}\\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }}
    long long from, to;
    const uint32_t n = piece(j, from, to);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
        :: "l"(reinterpret_cast<uint64_t>(out + to)),
           "r"(smem_u32(buf + st * kBulk)), "r"(n)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
    // the store before this one has read its stage: refill it
    if (j >= 1 && j - 1 + kStages < mine) {{
      asm volatile("cp.async.bulk.wait_group.read 1;\\n" ::: "memory");
      load(j - 1 + kStages);
    }}
  }}
  asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
}}

}}  // namespace"""
_BULK_LAUNCH = (
    "  if (npairs < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;\n",
    """  if (npairs < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)out | (uintptr_t)row_bytes) & 15) == 0 &&
      row_bytes >= kBulk) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(alltoall_bulk,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStages * kBulk);
    if (err != cudaSuccess) return (int)err;
    const long long pieces = (row_bytes + kBulk - 1) / kBulk;
    const long long items = pieces * npairs;
    alltoall_bulk<<<items < sms ? (int)items : sms, 32, kStages * kBulk,
                    (cudaStream_t)stream>>>(
        static_cast<const unsigned char*>(x),
        static_cast<unsigned char*>(out), src_rows, row_bytes, pieces, items);
    return (int)cudaGetLastError();
  }
""")
# Kernel 8's candidate (ii): a persistent grid of as many blocks as the SMs
# hold, each walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...; while it
# advances one tile, cp.async brings the next tile's window (six fields,
# four bytes a copy: the rows are no multiple of 16 bytes) into a staging
# area beside the seven window arrays, and the tile starts by moving its
# staged cells into place.  Every thread copies and moves only its own
# cells.
_SW_PERSISTENT = """__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

template <int NX, int NY>
__device__ __forceinline__ void prefetch(const Cells<NX, NY>& cl,
                                         const Fields& f, float* st,
                                         const Params& p, int gr0, int gc0) {
  int gcol[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    int m = (gc0 + cl.col[j] - 1) % p.nx;
    gcol[j] = 1 + (m < 0 ? m + p.nx : m);
  }
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    const int r = cl.row[i];
    if (r >= p.wy) continue;
    const size_t base = (size_t)min(max(gr0 + r, 0), p.nyp - 1) * p.X;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int c = cl.col[j];
      if (c >= p.wx) continue;
      float* at = st + (r * p.wx + c) * 6;
      const size_t off = base + gcol[j];
      cp_async4(at, f.h + off);
      cp_async4(at + 1, f.u + off);
      cp_async4(at + 2, f.v + off);
      cp_async4(at + 3, f.dh + off);
      cp_async4(at + 4, f.du + off);
      cp_async4(at + 5, f.dv + off);
    }
  }
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

template <int NX, int NY>
__device__ __forceinline__ void unstage(Cells<NX, NY>& cl, const float* st,
                                        float* win, const Params& p,
                                        int gr0) {
#pragma unroll
  for (int i = 0; i < NY; ++i) {
    const int r = cl.row[i], gr = gr0 + r;
    if (r >= p.wy) continue;
    const bool ghost = gr < 1 || gr > p.nyp - 2;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int c = cl.col[j];
      if (c >= p.wx) continue;
      float* at = win + (r * p.wx + c) * kArrays;
      const float* in = st + (r * p.wx + c) * 6;
      at[H] = in[0];
      at[U] = in[1];
      at[V] = in[2];
      cl.dh[i][j] = in[3];
      cl.du[i][j] = in[4];
      cl.dv[i][j] = in[5];
      if (ghost) at[FE] = at[FN] = at[Q] = at[KE] = 0.0f;
    }
  }
}

template <int NX, int NY>
__global__ void __launch_bounds__(kLanes * kMaxRows)
    sw_step_persistent(Fields f, Params p, int tiles_x, int tiles) {
  extern __shared__ float win[];
  float* st = win + kArrays * p.wy * p.wx;
  Cells<NX, NY> cl;
#pragma unroll
  for (int j = 0; j < NX; ++j) cl.col[j] = threadIdx.x + kLanes * j;
#pragma unroll
  for (int i = 0; i < NY; ++i) cl.row[i] = threadIdx.y + blockDim.y * i;
  int t = blockIdx.x;
  if (t < tiles)
    prefetch(cl, f, st, p, (t / tiles_x) * p.ty - p.halo,
             (t % tiles_x) * p.tx - p.halo);
  for (; t < tiles; t += gridDim.x) {
    const int gr0 = (t / tiles_x) * p.ty - p.halo;
    const int gc0 = (t % tiles_x) * p.tx - p.halo;
    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
    __syncthreads();  // the last tile's passes are done with the window
    unstage(cl, st, win, p, gr0);
    __syncthreads();
    const int next = t + gridDim.x;
    if (next < tiles)
      prefetch(cl, f, st, p, (next / tiles_x) * p.ty - p.halo,
               (next % tiles_x) * p.tx - p.halo);
    advance(cl, win, p, gr0);
    store(cl, f, win, p, gr0, gc0);
  }
}

// Raises the kernel's dynamic shared-memory limit"""
_SW_PERSISTENT_LAUNCH = (
    """  sw_step_kernel<NX, NY><<<job.grid, job.block, job.smem, job.stream>>>(
      job.f, job.p);
  return cudaGetLastError();""",
    """  const size_t smem = job.smem / kArrays * (kArrays + 6);
  err = cudaFuncSetAttribute(sw_step_persistent<NX, NY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sw_step_persistent<NX, NY>,
        (int)(job.block.x * job.block.y), smem);
  if (err != cudaSuccess) return err;
  const int tiles = (int)(job.grid.x * job.grid.y);
  const int blocks = min(tiles, sms * max(per_sm, 1));
  sw_step_persistent<NX, NY><<<blocks, job.block, smem, job.stream>>>(
      job.f, job.p, (int)job.grid.x, tiles);
  return cudaGetLastError();""")
VARIANTS = {
    "sw_step": {
        # the parent's window depth, 4 cells per side per step
        "halo4": [("constexpr int kHaloPerStep = 2;",
                   "constexpr int kHaloPerStep = 4;")],
        # the footprint of the parent's 11 window arrays, 11 floats a cell
        # (what it costs in blocks per SM; the accesses stay the design's)
        "arrays11": [("constexpr int kArrays = 7;",
                      "constexpr int kArrays = 11;")],
        # IEEE division by dx, dy and of q, as the parent divides
        "ieee_div": [("  return d * p.rdx;", "  return d / p.dx;"),
                     ("  return d * p.rdy;", "  return d / p.dy;"),
                     ("      x.c[Q] = divide(fc + zeta, thick);",
                      "      x.c[Q] = (fc + zeta) / thick;")],
        # the compiler free to keep every cell's addresses across passes
        "hoist": [("#pragma unroll\n"
                   "  for (int j = 0; j < NX; ++j) asm volatile(\"\" : \"+r\"(cl.col[j]));\n"
                   "#pragma unroll\n"
                   "  for (int i = 0; i < NY; ++i) asm volatile(\"\" : \"+r\"(cl.row[i]));",
                   "")],
        # 16 cells a thread (4 x 4 or 2 x 8) in blocks of at most 512
        # threads, 128 registers each
        "cells16": [("sh->ny = sh->nx <= 2 ? 4 : 2;",
                     "sh->ny = sh->nx <= 2 ? 8 : 4;"),
                    ("__global__ void __launch_bounds__(kLanes * kMaxRows)\n"
                     "    sw_step_kernel(",
                     "__global__ void __launch_bounds__(kLanes * kMaxRows / 2)\n"
                     "    sw_step_kernel("),
                    ("    case 4 * 8 + 1: return run<1, 4>(job);\n"
                     "    case 4 * 8 + 2: return run<2, 4>(job);\n"
                     "    case 2 * 8 + 3: return run<3, 2>(job);\n"
                     "    case 2 * 8 + 4: return run<4, 2>(job);",
                     "    case 8 * 8 + 1: return run<1, 8>(job);\n"
                     "    case 8 * 8 + 2: return run<2, 8>(job);\n"
                     "    case 4 * 8 + 3: return run<3, 4>(job);\n"
                     "    case 4 * 8 + 4: return run<4, 4>(job);")],
        # candidate (ii): a persistent grid prefetching with cp.async
        "persistent": [("// Raises the kernel's dynamic shared-memory limit",
                        _SW_PERSISTENT), _SW_PERSISTENT_LAUNCH],
    },
    "flash_bwd": {
        # two stages: three of 128-key tiles pass 227 KB at D = 128
        "kt128": [("constexpr int kT6 = 64;", "constexpr int kT6 = 128;"),
                  ("constexpr int kStages6 = 3;",
                   "constexpr int kStages6 = 2;")],
        "stages2": [("constexpr int kStages6 = 3;",
                     "constexpr int kStages6 = 2;")],
        "serial": [("wg_wait<1>();  // S and dP are in; dQ may still run",
                    "wg_wait<0>();  // S and dP are in")],
    },
    "alltoall": {
        "chunk64k": [("kChunk = 8 * 1024;", "kChunk = 64 * 1024;"),
                     ("kUnroll = 2;", "kUnroll = 4;")],
        "chunk16k": [("kChunk = 8 * 1024;", "kChunk = 16 * 1024;"),
                     ("kUnroll = 2;", "kUnroll = 4;")],
        "chunk4k": [("kChunk = 8 * 1024;", "kChunk = 4 * 1024;"),
                    ("kUnroll = 2;", "kUnroll = 1;")],
        "threads128": [("kThreads = 256;", "kThreads = 128;"),
                       ("kUnroll = 2;", "kUnroll = 4;")],
        "streaming": [
            ("v[u] = s4[i + u * kThreads];",
             "v[u] = __ldcs(s4 + i + u * kThreads);"),
            ("d4[i + u * kThreads] = v[u];",
             "__stcs(d4 + i + u * kThreads, v[u]);")],
        "bulk_4x32k": [("}  // namespace", _BULK.format(stages=4, kib=32)),
                       _BULK_LAUNCH],
        "bulk_8x16k": [("}  // namespace", _BULK.format(stages=8, kib=16)),
                       _BULK_LAUNCH],
    },
}
# kernel 6's shapes: (label, BH, T, D)
DQ_SHAPES = (("path (e) n=1, B4 T4096 H16 D128", 64, 4096, 128),
             ("path (f) (1,1,1), B8 T1024 H12 D64", 96, 1024, 64))
SPECTRAL_N = 256
# kernel 8: path (a)'s 1x1 shape and the candidate tiles (rows, cols)
SW_SHAPE = (1800, 3600)
SW_TILES = ((32, 52), (40, 52), (48, 52), (56, 52), (32, 64), (24, 84),
            (16, 52))


def variant_source(name: str, variant: str) -> str:
    """``csrc/<name>.cu`` with ``variant``'s substitutions made."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in VARIANTS[name][variant]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {variant}: {old!r} is not in "
                               f"csrc/{name}.cu exactly once")
        src = src.replace(old, new)
    return src


def build_variant(name: str, variant: str):
    """Build and load ``variant_source(name, variant)``; returns the
    library and nvcc's messages."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}_{variant}.cu"
    src.write_text(variant_source(name, variant))
    lib_path = out / f"{name}_{variant}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib_path), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {variant}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, proc.stdout


def ptxas_lines(log: str):
    """nvcc's messages in short: one line per wgmma or bulk kernel
    instantiation (its name, registers and spills), and every line that
    names C7520, a warning or an error."""
    out, fn, spills = [], None, ""
    for ln in log.splitlines():
        if any(k in ln for k in ("C7520", "warning", "error")):
            out.append(ln.strip())
        elif "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            fn = next((k for k in ("dq_wgmma", "dkv_wgmma", "alltoall_bulk",
                                   "alltoall_kernel", "sw_step_kernel",
                                   "sw_step_persistent") if k in mangled),
                      None)
            if fn and "sw_step" in fn:
                nx, ny = mangled.split("ILi")[1].split("EE")[0].split("ELi")
                fn += f" {nx}x{ny} cells"
            if fn and "wgmma" in fn:
                fn += " bf16" if "bfloat16" in mangled else " fp16"
                fn += " D=" + mangled.split("Li")[-1].split("E")[0]
        elif "spill" in ln:
            spills = ln.strip()
        elif "Used" in ln and fn:
            out.append(f"{fn}: {ln.split(':', 1)[1].strip()}; {spills}")
            fn = None
    return out


def time_ms(fn, reps):
    """Mean ms on the card of ``fn()`` over ``reps`` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _dq_inputs(bh, t, d, dev, seed):
    """bf16 q, k, v, dO of one causal block at offset 0, with the lse and
    delta of its plain forward."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = [(torch.randn((bh, t, d), generator=g) * 0.4).to(
        torch.bfloat16).to(dev) for _ in range(4)]
    offs = torch.zeros(bh, 2, dtype=torch.int32, device=dev)
    o, m, l = flash.flash_fwd_block_plain(q, k, v, offs[:, 0], offs[:, 1],
                                          scale=1.0, causal=True)
    live = l > 0
    lse = m + torch.log(torch.where(live, l, 1.0))
    delta = (do.float() * o / torch.where(live, l, 1.0)).sum(-1, keepdim=True)
    return (q, k, v, do, lse, delta, offs)


def run_dq(libs, dev, rounds):
    """Kernel 6's variants: the errors at each shape and the ms per launch
    of every round."""
    recs = []
    for label, bh, t, d in DQ_SHAPES:
        args = _dq_inputs(bh, t, d, dev, seed=t)
        plain = (*args[:6], args[6][:, 0], args[6][:, 1])
        kw = dict(scale=1.0, causal=True)
        ref = flash.flash_bwd_block_plain(*plain, **kw)
        noise = chk.bwd_noise(*plain, **kw)
        rec = {"kernel": "flash_bwd_dq", "at": label, "ms": {}, "errors": {}}
        for name, lib in libs.items():
            with _Using(lib, "flash_bwd"):
                dq = flash._flash_bwd_dq_kernel(*args, **kw)
            torch.cuda.synchronize()
            errs = chk.bwd_errors((dq, ref[1], ref[2]), ref, noise)
            rec["errors"][name] = errs["dq"]
            rec["ms"][name] = []
        for _ in range(rounds):
            for name, lib in libs.items():
                with _Using(lib, "flash_bwd"):
                    rec["ms"][name].append(time_ms(
                        lambda: flash._flash_bwd_dq_kernel(*args, **kw), 20))
        rec["within"] = {n: e <= chk.TOL_BWD[torch.bfloat16]["dq"]
                         for n, e in rec["errors"].items()}
        recs.append(rec)
    return recs


def _a2a_cases(dev):
    """Edge inputs of the alltoall: (comm, x) with odd and unaligned rows,
    an input 4 bytes off 16, rows of several pieces, and 64 ranks."""
    g = torch.Generator().manual_seed(0)
    cases = []
    for n, rest, dtype in ((2, (5,), torch.float32), (3, (3, 7), torch.int8),
                           (4, (1030,), torch.bfloat16),
                           (4, (9000, 3), torch.float32),
                           (8, (8195, 4), torch.float32),
                           (4, (40001,), torch.int8),
                           (4, (40000,), torch.float32),
                           (4, (16, 16, 256), torch.complex64),
                           (64, (3,), torch.float32)):
        comm = make_mesh(n, device=dev)
        shape = (n, n) + rest
        x = torch.randn(shape, generator=g).to(dtype).to(dev)
        cases.append((comm, x))
        if rest == (40000,):
            # the same rows 4 bytes off 16
            buf = torch.empty(x.numel() + 4, dtype=dtype, device=dev)
            y = buf[1:1 + x.numel()].view(shape)
            y.copy_(x)
            cases.append((comm, y))
    return cases


def run_alltoall(libs, dev, rounds):
    """The alltoall's variants: bit for bit at the edge inputs, and the ms
    per launch of every round at path (c)'s transposes."""
    checked = {}
    for name, lib in libs.items():
        ok = True
        with _Using(lib, "alltoall"):
            for comm, x in _a2a_cases(dev):
                got = coll._alltoall_kernel(x, comm)
                ok &= torch.equal(got.view(torch.uint8).reshape(-1),
                                  coll.alltoall_plain(x, comm).view(
                                      torch.uint8).reshape(-1))
        torch.cuda.synchronize()
        checked[name] = bool(ok)
    recs = []
    size = SPECTRAL_N
    for n in (4, 8):
        comm = make_mesh(n, device=dev)
        x = torch.randn((n, n, size // n, size // n, size),
                        dtype=torch.complex64, device=dev)
        rec = {"kernel": "alltoall",
               "at": f"{size}^3 complex64, n={n}", "bit_exact": checked,
               "ms": {name: [] for name in libs}, "library_ms": []}
        for _ in range(rounds):
            for name, lib in libs.items():
                with _Using(lib, "alltoall"):
                    rec["ms"][name].append(time_ms(
                        lambda: coll._alltoall_kernel(x, comm), 50))
            rec["library_ms"].append(time_ms(
                lambda: x.transpose(0, 1).contiguous(), 50))
        recs.append(rec)
    return recs


def _sw_inputs(dev):
    """Path (a)'s 1x1 state for kernel 8: the check state at 1800x3600 after
    two plain steps, and per (params, fuse) the plain version's result."""
    from ..models import _sw_check as sw_chk
    from ..models import _sw_kernel as swk
    from ..models.shallow_water import ShallowWater, SWParams

    refs = {}
    for params in (SWParams(dx=5e3, dy=5e3),
                   sw_chk.StiffParams(dx=5e3, dy=5e3)):
        model = ShallowWater(SW_SHAPE, params, device=dev)
        s0 = sw_chk.check_state(model, 0)
        s2 = model._step_local(model._step_local(s0, True), False)
        for fuse in (1, 2, 3):
            refs[(type(params).__name__, fuse)] = (
                params, s2, swk.fused_step_plain(s2, params, first=False,
                                                 fuse=fuse))
    return refs


def run_sw(libs, dev, rounds):
    """Kernel 8's variants at each candidate tile and fuse: the worst
    error over scale against the plain version (both check parameter
    sets), the blocks an SM holds, and the ms per launch of every round at
    1800x3600."""
    from ..models import _sw_check as sw_chk
    from ..models import _sw_kernel as swk
    from ..models.shallow_water import SWState

    refs = _sw_inputs(dev)
    recs = []
    for tile in SW_TILES:
        for fuse in (3, 2, 1):
            rec = {"kernel": "sw_step", "at": f"{SW_SHAPE[0]}x{SW_SHAPE[1]} "
                   f"fuse={fuse} tile={tile}", "errors": {}, "blocks_per_sm": {},
                   "ms": {}, "bound_ms": 12 * 1802 * 3602 * 4 / 3.35e12 * 1e3}
            runs = {}
            for name, lib in libs.items():
                worst = 0.0
                try:
                    with _Using(lib, "sw_step"):
                        for (_, f), (params, s, ref) in refs.items():
                            if f != fuse:
                                continue
                            got = swk.fused_step(s, params, first=False,
                                                 fuse=fuse, tile=tile)
                            torch.cuda.synchronize()
                            worst = max(worst, max(
                                r for _, r in sw_chk.errors(got, ref, s)))
                        rec["blocks_per_sm"][name] = swk.blocks_per_sm(
                            s.h.shape, fuse, tile)
                except (RuntimeError, ValueError) as err:
                    rec["errors"][name] = str(err).splitlines()[0]
                    continue
                rec["errors"][name] = worst
                rec["ms"][name] = []
                params, s, _ = refs[("SWParams", fuse)]
                bufs = [SWState(*(torch.empty_like(x) for x in s))
                        for _ in range(2)]
                runs[name] = (lib, params, s, bufs)
            rec["within"] = {n: isinstance(e, float) and e <= sw_chk.CHECK_TOL
                             for n, e in rec["errors"].items()}
            for _ in range(rounds):
                for name, (lib, params, s, bufs) in runs.items():
                    if not rec["within"][name]:
                        continue
                    flip = [0]

                    def one():
                        flip[0] += 1
                        swk.fused_step(s, params, first=False, fuse=fuse,
                                       tile=tile, out=bufs[flip[0] % 2])
                    with _Using(lib, "sw_step"):
                        rec["ms"][name].append(time_ms(one, 20))
            recs.append(rec)
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "sw", "dq", "alltoall"),
                    default="all")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    parts = {"sw": "sw_step", "dq": "flash_bwd", "alltoall": "alltoall"}
    names = [v for k, v in parts.items() if args.part in ("all", k)]
    jobs = [(name, var) for name in names for var in VARIANTS[name]]
    with ThreadPoolExecutor(max_workers=len(jobs) + len(names)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build_variant(*j), jobs)))
        _build.build_all(names)
    for name in names:
        for line in ptxas_lines(_build.LOGS.get(name, "")):
            print(f"{name} committed: {line}", flush=True)
    for (name, var), (_, log) in built.items():
        for line in ptxas_lines(log):
            print(f"{name} {var}: {line}", flush=True)
    for name, run in (("sw_step", run_sw), ("flash_bwd", run_dq),
                      ("alltoall", run_alltoall)):
        if name not in names:
            continue
        libs = {"committed": _build.library(name)}
        libs.update({var: built[(name, var)][0] for var in VARIANTS[name]})
        for rec in run(libs, dev, args.rounds):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
