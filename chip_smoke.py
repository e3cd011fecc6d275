#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py             # on a machine with an NVIDIA card
    python3 chip_smoke.py --rehearse  # on the CPU, plain path, small size

Phases, each of which fails the run (non-zero exit) if its check fails:

1. the card's name and power limit; build the seven sources of
   ``mpi4jax_tpu_torch/csrc/`` (eight kernels) with nvcc, one process each,
   and the native transport (``native/tpucomm.cc``, g++), all started
   together, and print the fused step's build time and ptxas lines, and
   for each instantiation of it its registers, spills and the dynamic
   shared memory of the default tile;
2. the kernel against its plain PyTorch version on the card at 1800x3600:
   the Euler step from a check state (the initial jet with seeded
   grid-scale noise), and fuse=1, 2 and 3 from that state after two plain
   steps, at the solver's parameters and at 1000x its viscosity; each
   field within ``_sw_check.CHECK_TOL`` of its scale (see
   ``mpi4jax_tpu_torch/models/_sw_check.py``);
3. the same at the edge shapes (16, 32), (22, 32) and (70, 50), with
   fuse=2 too;
4. the main path: ``ShallowWater.step_fn`` runs 0.1 model day at
   1800x3600 (the Euler step, then 431 timed steps) through the kernel at
   fuse=3 and at fuse=1.  The launch counter is reset just before and read
   just after; h must stay finite, mass must hold to 1e-5, and the result
   must stay near the plain path's, which is timed too (as the cost of the
   test oracle, not as a yardstick);
5. the kernel's time per launch and per step (CUDA events) at fuse=3, 2
   and 1, beside its memory bound, with the blocks an SM holds
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the plain
   version's time;
6. the build of the hop and fused-ring kernels (``csrc/hop.cu``,
   ``csrc/fused_ring.cu``): build time and ptxas lines;
7. the hop kernel against ``hop_plain`` on the card, bit for bit:
   ``ring_shift`` at +1 and -1, ``ring_shift2``, the XOR exchange and a
   permutation that leaves ranks without a source (zero fill), at n = 2, 4
   and 8 and on the axes of a 2x4 grid, in f32, f64, int32, bf16,
   complex64 and uint8, at byte counts that are odd and not multiples of
   16; its time per call on the halo's y and x strips of path (a) (CUDA
   events over back-to-back calls) and the profiler's device time of one
   launch, beside its bound, its plain version and a ``torch.roll`` pair;
8. the fused ring against ``fused_ring_allreduce_plain`` on the card, bit
   for bit, at n = 3, 4 and 8 and 1, 513, 16Ki, 16Ki+37 and 4Mi+3 elements
   per rank (f32), at n = 65 and 1, 513 and 16Ki+37, at n = 3 and 16Ki+16
   (a chunk boundary inside a 16-byte vector, in every dtype it takes), at
   path (g)'s island fold, n = 2 and 3, 513, 70000, 4Mi and 16Mi elements,
   and in the other dtypes at 16Ki+37; every output row identical; its
   time at n = 4 and 16 MiB per rank, and at n = 2 and 16 and 64 MiB per
   rank (path (g)'s), beside its bound, its plain version, ``x.sum(0)``
   (one row) and ``x.sum(0, keepdim=True).expand_as(x).contiguous()`` (the
   n rows the kernel writes);
9. path (b): the allreduce sweep (``mpi4jax_tpu_torch.benchmarks.
   allreduce_sweep``) through ``ops.allreduce`` at n = 4 and 8 from 1 KiB
   to 64 MiB per rank, the launch counters reset just before and read just
   after; each size bit for bit against the same call on the plain route,
   the fused ring taken from 16Ki elements per rank up;
10. path (a): the shallow-water solver on a 2x2 grid at 1800x3600 for 0.1
   model day (init, the Euler step and 431 timed steps) through the hop
   kernel, the counters reset just before and read just after; h finite,
   mass to 1e-5, bit for bit the same run on the plain hop, and within
   ``GRID_TOL`` of the 1x1 run of phase 4; the share of a step that the
   halo exchanges take (CUDA events);
11. the build of the alltoall kernel (``csrc/alltoall.cu``): build time
   and ptxas lines;
12. the alltoall kernel against ``alltoall_plain`` on the card, bit for
   bit: n = 2, 3, 4 and 8 and both axes of a 2x4 grid; f32, f64, bf16,
   complex64, int8, uint8 and bool; rows of one element, odd byte counts,
   counts that are no multiple of 16, several 64 KiB chunks and empty rows;
   the backward pass, and scatter, bcast, reduce, gather and barrier through
   their fronts, each against the same call on the plain route; its time
   per launch at the 256^3 n = 4 transpose (128 MiB of complex64), beside
   its bound, its plain version and ``x.transpose(0, 1).contiguous()``;
13. path (c): the spectral Poisson solve (``mpi4jax_tpu_torch.benchmarks.
   spectral``) of the manufactured 256^3 problem at n = 1, 4 and 8 (one
   warm-up solve, then 5 timed), the counters reset just before each run
   and read just after: 2 alltoall launches per solve at n > 1; the
   solution to 1e-3, bit for bit the same solve on the plain route, and the
   share of a solve that the alltoalls take (CUDA events);
14. the build of kernel 5, the flash forward (``csrc/flash_fwd.cu``): build
   time and ptxas lines, and each instantiation's registers, spills and
   shared memory;
15. kernel 5 against ``flash_fwd_block_plain`` on the card at the edge
   shapes of ``mpi4jax_tpu_torch/ops/_flash_check.py``: f32, bf16 and fp16,
   D = 16, 32, 64 and 128, causal and not, offsets (0, 0), (64, 0),
   (16, 32), a fully skipped block and per-row offsets, ragged T, each
   within ``_flash_check.TOL``: the normalized output's error in each
   component over that component's noise scale (``_flash_check.noise``),
   between the readings of the sound kernel and of planted faults
   (``mpi4jax_tpu_torch.benchmarks.flash_tolerance``);
16. the hop past 64 (rank, payload) pairs, bit for bit against the plain
   route: ``ring_shift``, ``ring_shift_n`` and the allreduce on 64 and 65
   ranks, and ``halo_exchange`` on 6x6 and 8x8 grids; every hop is one
   launch (``ring_shift`` and ``ring_shift_n`` one each, ``halo_exchange``
   one per grid dimension);
17. path (d): ring attention's forward (``mpi4jax_tpu_torch.benchmarks.
   ring_attention``) at B4 T4096 H16 D128 bf16 causal over n = 1 and 4
   ranks on the card (one warm-up, then 5 timed forwards), the counters
   reset just before each run and read just after: n flash launches and
   n - 1 hops per forward; the output finite and the cast of the f32
   output, which is held to the plain route's f32 output over each
   component's noise scale (``_flash_check.ring_noise``) within
   ``_flash_check.TOL``, as is the n = 4 output to the n = 1 output; the
   card's time per forward by kernel group
   (``torch.profiler``); kernel 5's time per launch at n = 1 and at each
   of the four ring steps of n = 4, each beside its bound and each held to
   the plain version at that shape; the plain version's time and
   ``scaled_dot_product_attention(is_causal=True)``'s on the same tensors;
18. the build of kernels 6 and 7, the flash backward (``csrc/flash_bwd.cu``):
   ptxas lines (registers, spills and shared memory of each
   instantiation);
19. kernels 6 and 7 against ``flash_bwd_block_plain`` at the edge cases of
   ``_flash_check.bwd_cases`` (the forward's, with dO, lse and delta): f32,
   bf16 and fp16, D = 16, 32, 64 and 128, each gradient within
   ``_flash_check.TOL_BWD`` of its noise scale (``bwd_noise``);
20. path (e): ring attention's forward and backward
   (``benchmarks.ring_attention.run_backward``) at B4 T4096 H16 D128 bf16
   causal over n = 1 and 4 (one warm-up, then 3 timed steps), the counters
   reset just before each run and read just after: n launches each of
   kernels 5, 6 and 7 per step, n - 1 hops in the forward and n in the
   backward (none at n = 1); the gradients finite, the f32 gradients held
   to the plain route's over ``ring_bwd_noise`` within ``TOL_BWD``, and the
   entry point's dq, dk and dv their cast (``run_backward``'s check); the profiler's breakdown; kernels 6
   and 7 per launch at n = 1 and each step of n = 4, beside their bounds
   and the plain version's time, held to it; SDPA's forward and
   forward+backward time on the same tensors;
21. path (f): the GPT-2 124M train step (``benchmarks.gpt_step``, bf16,
   B8 T1024) on the (1, 1, 1) and (1, 2, 2) meshes (one warm-up step, then
   3 timed), the counters reset just before each run and read just after:
   12 (24 at (1, 2, 2)) launches each of kernels 5, 6 and 7 per step, finite
   losses; the profiler's top groups; one step on the kernel route against
   one on the plain route from the same weights
   (``benchmarks.gpt_step.route_check``: the loss, each field's gradient
   and its AdamW update within ``ROUTE_TOL``, relative L2); kernels 5, 6
   and 7 per launch at each mesh's attention shapes (B8 x 12 heads of T1024
   at (1, 1, 1); both ring steps of 192 rows of T512 at (1, 2, 2)), each
   held to its plain version within ``TOL`` or ``TOL_BWD``;
22. the build of kernel 4, the int8 wire codec (``csrc/quant_pack.cu``):
   ptxas lines; and the transport's build seconds;
23. kernel 4 against ``quant_pack_plain`` on the card, bit for bit, at
   n = 0, 1, 255, 256, 257, 70000, 4Mi and 16Mi elements (path (g)'s 16 and
   64 MiB), each with the edge cases of ``quantized.check_inputs`` (zero
   blocks, +-amax, exact ties, a subnormal scale with subnormal elements,
   magnitudes near 1e30 and 3e38), and an input off a 16-byte boundary;
   the same frames against the transport's codec (``tpucomm_quant_pack``);
   its time per launch at 16 and 64 MiB (the profiler's kernel time over
   the launches it recorded, with the L2 flushed between launches, and
   with the input in L2; CUDA events per call) beside its bytes bound and the plain version's time;
24. path (g): the world tier's hierarchical f32 allreduce
   (``mpi4jax_tpu_torch.benchmarks.ici_leg``), 4 ranks on the card through
   ``mpi4jax_tpu_torch.runtime.launch -n 4 --fake-hosts 'r0,r1|r2,r3'``,
   ``MPI4JAX_TPU_ICI_LEG=force``, one job exact and one with
   ``MPI4JAX_TPU_COLL_QUANT=force``: ``algo`` hring and htree at 3, 513,
   70000 and 4Mi f32 per rank, every rank bit for bit against the port's
   ``simulate_h{ring,tree}_sum(..., intra="ring")`` or
   ``simulate_ici_q_sum``, the ranks agreeing, the quantized result within
   5e-2 of the exact sum; one launch of kernel 3 per rank and call, and of
   kernel 4 per rank and quantized call (each job's counts start at 0 in
   its rank processes); ms per call at 16 and 64 MiB per rank with its
   phase split, beside the native ``hring`` with the leg off.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a card the run fails and prints
no result.  ``--rehearse`` runs phases 2-4, 7-10, 12, 13, 15-17, 19-21,
23 and 24 on the CPU through the plain versions at a small size and prints
no result line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mpi4jax_tpu_torch import _build, ops
from mpi4jax_tpu_torch.benchmarks import allreduce_sweep
from mpi4jax_tpu_torch.benchmarks._profile import RERUNS, kernel_ms_by_group
from mpi4jax_tpu_torch.benchmarks import gpt_step as gpt_bench
from mpi4jax_tpu_torch.benchmarks import ici_leg
from mpi4jax_tpu_torch.benchmarks import ring_attention as ring_bench
from mpi4jax_tpu_torch.benchmarks import spectral as spectral_bench
from mpi4jax_tpu_torch.models import _sw_check as chk
from mpi4jax_tpu_torch.models import _sw_kernel as kernel
from mpi4jax_tpu_torch.models import shallow_water as sw
from mpi4jax_tpu_torch.models import spectral
from mpi4jax_tpu_torch.models import transformer as gpt
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.ops import _flash_check as flash_chk
from mpi4jax_tpu_torch.ops import _mesh_impl, flash, quantized
from mpi4jax_tpu_torch.parallel.grid import ProcessGrid
from mpi4jax_tpu_torch.parallel.halo import halo_exchange
from mpi4jax_tpu_torch.parallel.mesh import make_mesh
from mpi4jax_tpu_torch.runtime import bridge

SHAPE = (1800, 3600)
EDGE_SHAPES = [(16, 32), (22, 32), (70, 50)]
DAYS = 0.1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published
# flops of one cell-step of the fused kernel, counted in csrc/sw_step.cu:
# fluxes/q/ke 30, tendencies and Adams-Bashforth 48, viscous fluxes 12,
# viscous update 14
FLOPS_PER_CELL_STEP = 104
KERNELS = ("sw_step", "hop", "fused_ring", "alltoall", "flash_fwd",
           "flash_bwd", "quant_pack")
HOP_DTYPES = (torch.float32, torch.float64, torch.int32, torch.bfloat16,
              torch.complex64, torch.uint8)
HOP_LOCALS = ((5,), (37,), (3, 7), (4, 1802))  # odd and 4/8/16-byte blocks
RING_COUNTS = (1, 513, 16 * 1024, 16 * 1024 + 37, 4 * 1024 * 1024 + 3)
RING_DTYPES = (torch.float64, torch.float16, torch.bfloat16, torch.int32,
               torch.int64, torch.uint8, torch.complex64)
# at n = 3 a chunk of this many elements is no multiple of a 16-byte vector
# in any dtype, while the rows stay 16-byte aligned: two vectors of a row
# hold a chunk boundary
RING_SPLIT_COUNT = 16 * 1024 + 16
SWEEP_MAX_BYTES = 64 * 1024 * 1024
GRID = (2, 2)
# tolerance of the 2x2 run's h against the 1x1 run's after 0.1 day (see
# phase 10): the two inits associate the prefix integral and the mean
# differently, and the 1x1 run goes through the fused-step kernel
GRID_TOL = 1e-2
A2A_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.complex64,
              torch.int8, torch.uint8, torch.bool)
# rows of 1 element, odd byte counts, no multiple of 16, 16-byte multiples,
# several 64 KiB chunks, empty rows
A2A_RESTS = ((), (5,), (3, 7), (1030,), (9000, 3), (0,))
SPECTRAL_N = 256
SPECTRAL_RANKS = (1, 4, 8)
SOLVES = 5
# the manufactured Poisson solution's tolerance (tests/models/test_spectral.py)
POISSON_TOL = 1e-3
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores, published
# path (d): bench.py's _flash_setup and benchmarks/flash_sweep.py
FLASH_SHAPE = (4, 4096, 16, 128)
FLASH_RANKS = (1, 4)
FLASH_ITERS = 5
# path (e): path (d)'s shape, forward and backward (bench_flash_mfu's second
# half); path (f): bench.py's bench_gpt2_step (GPT-2 124M, B8 T1024 bf16)
BWD_ITERS = 3
GPT_STEPS = 3
# kernel 4 (phase 23): the codec's lengths, and the per-rank payloads of
# path (g) at which it is timed
QUANT_LENGTHS = (0, 1, 255, 256, 257, 70000, 4 * 1024 * 1024,
                 16 * 1024 * 1024)
QUANT_TIMED = (16 * 1024 * 1024, 64 * 1024 * 1024)
# path (g) (phase 24): the check counts and the timed payloads per rank
G_COUNTS = (3, 513, 70000, 4 * 1024 * 1024)
G_SIZES = (16 * 1024 * 1024, 64 * 1024 * 1024)
G_CALLS = 5


def log(msg=""):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


def compare(got, ref, before, what):
    """Per-field max abs error and error over scale; fails past
    CHECK_TOL.  Returns the largest of each."""
    worst_abs = worst_rel = 0.0
    parts = []
    for name, (diff, rel) in zip(("h", "u", "v", "dh", "du", "dv"),
                                 chk.errors(got, ref, before)):
        parts.append(f"{name} {diff:.3e} ({rel:.2e})")
        worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel, rel)
        if not rel <= chk.CHECK_TOL:
            fail(f"{what}: field {name} differs by {diff:.3e}, {rel:.3e} of "
                 f"its scale (tolerance {chk.CHECK_TOL})")
    log(f"  {what}: " + "; ".join(parts))
    return worst_abs, worst_rel


def log_build(name, build_secs):
    log(f"  csrc/{name}.cu: {build_secs[name]:.2f} s")
    for line in _build.LOGS.get(name, "").splitlines():
        if any(w in line for w in ("ptxas", "spill", "error", "warning")):
            log(f"  {name}: {line.strip()}")


# the kernels of csrc/flash_fwd.cu and csrc/flash_bwd.cu, as ptxas names them
FLASH_KERNEL_NAMES = ("flash_fwd_wgmma", "flash_fwd_f32",
                      "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
                      "flash_bwd_dq_f32", "flash_bwd_dkv_f32")


def log_registers(name):
    """Each kernel's registers, spills and static shared memory from
    ptxas's lines, one line per instantiation; for the wgmma kernels also
    the dynamic shared memory a launch asks for (``flash_smem_bytes`` of
    the library, ``flash_dq_smem_bytes`` for kernel 6)."""
    lib = _build.library(name)
    fn = None
    for line in _build.LOGS.get(name, "").splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            # the kernel's name and its template arguments, unmangled enough
            fn = next(p for p in (*FLASH_KERNEL_NAMES, mangled)
                      if p in mangled)
            d = int(mangled.split("Li")[-1].split("E")[0])
            if "wgmma" in fn:
                smem = getattr(lib, "flash_dq_smem_bytes"
                               if fn == "flash_bwd_dq_wgmma"
                               else "flash_smem_bytes")
                smem.argtypes = [ctypes.c_int]
                fn += f" (dynamic smem {smem(d)} bytes)"
            fn += " " + ("bf16" if "bfloat16" in mangled else "fp16"
                         if "half" in mangled else "f32")
            fn += f" D={d}"
            spills = ""
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and fn:
            log(f"  {name}: {fn}: {line.split(':', 1)[1].strip()}; {spills}")
            fn = None


def log_sw_registers():
    """Per instantiation of the fused step (NX x NY cells a thread): its
    registers, spills and static shared memory from ptxas's lines, and the
    dynamic shared memory of the default tile at fuse 1, 2 and 3."""
    cells = None
    for line in _build.LOGS.get("sw_step", "").splitlines():
        if "Compiling entry function" in line and "sw_step_kernel" in line:
            nx, ny = line.split("ILi")[1].split("EE")[0].split("ELi")
            cells = f"{nx} x {ny} cells a thread"
            spills = ""
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and cells:
            log(f"  sw_step: {cells}: {line.split(':', 1)[1].strip()}; "
                f"{spills}")
            cells = None
    tile = kernel.DEFAULT_TILE
    log(f"  sw_step: dynamic shared memory of tile {tile}: " + ", ".join(
        f"fuse={f} {kernel.smem_bytes(tile, f)} B" for f in (1, 2, 3)))


def reset_counts():
    kernel.LAUNCHES = 0
    for counts in (coll.LAUNCHES, flash.LAUNCHES, quantized.LAUNCHES):
        for k in counts:
            counts[k] = 0


def timed_build():
    """The transport's build (g++), in seconds."""
    t0 = time.perf_counter()
    bridge.build()
    return time.perf_counter() - t0


def bits_equal(a, b):
    a = a.detach().contiguous().reshape(-1)
    b = b.detach().contiguous().reshape(-1)
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def abs_diff(a, b):
    if a.dtype == torch.bool:
        return float((a != b).any())
    a, b = torch.view_as_real(a) if a.is_complex() else a, \
        torch.view_as_real(b) if b.is_complex() else b
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def random_tensor(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        x = torch.randint(0, 2, shape, generator=g).bool()
    elif dtype == torch.int8:
        x = torch.randint(-128, 128, shape, generator=g, dtype=dtype)
    elif dtype.is_complex:
        x = torch.randn(shape, generator=g, dtype=dtype)
    elif dtype.is_floating_point:
        x = torch.randn(shape, generator=g).to(dtype)
    elif dtype == torch.uint8:
        x = torch.randint(0, 256, shape, generator=g, dtype=dtype)
    else:
        x = torch.randint(-2**20, 2**20, shape, generator=g, dtype=dtype)
    return x.to(dev)


# the largest |kernel - plain| that same_as_plain has seen since its reset
WORST = {"diff": 0.0}


def same_as_plain(what, fn, *args):
    """``fn(*args)`` against the same call on the plain route, bit for
    bit; returns the result.  The largest difference goes to WORST."""
    got = fn(*args)
    with coll.use_plain():
        ref = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        diff = abs_diff(g, r)
        WORST["diff"] = max(WORST["diff"], diff)
        if not bits_equal(g, r):
            fail(f"{what}: differs from the plain version by {diff:.3e}")
    return got


def check_hop(dev):
    """Phase 7: the hop kernel against hop_plain, bit for bit; returns
    the largest difference."""
    WORST["diff"] = 0.0
    cases = 0
    seed = 0
    for n in (2, 4, 8):
        comm = make_mesh(n, device=dev)
        grid_comms = []
        if n == 8:
            grid = ProcessGrid((2, 4), device=dev)
            grid_comms = [grid.axis_comm(0), grid.axis_comm(1)]
        for dtype in HOP_DTYPES:
            for local in HOP_LOCALS:
                seed += 1
                x = random_tensor((n,) + local, dtype, dev, seed)
                y = random_tensor((n,) + local, dtype, dev, seed + 1000)
                tag = f"n={n} {dtype} local {local}"
                same_as_plain(f"ring_shift +1 {tag}", coll.ring_shift, x,
                              comm, 1)
                same_as_plain(f"ring_shift -1 {tag}", coll.ring_shift, x,
                              comm, -1)
                same_as_plain(f"ring_shift2 {tag}", coll.ring_shift2, x, y,
                              comm)
                k = 1
                while k < n:
                    same_as_plain(f"xor {k} {tag}", coll.exchange, x, comm,
                                  [c ^ k for c in range(n)])
                    k *= 2
                perm = [(i, i + 1) for i in range(n - 1)]
                (got,) = same_as_plain(f"open chain {tag}",
                                       _mesh_impl.sendrecv, x, perm, comm)
                if not bits_equal(got[0], torch.zeros_like(got[0])):
                    fail(f"open chain {tag}: rank 0 has no source but is "
                         "not zero")
                cases += 5 + (n.bit_length() - 1)
                for sub in grid_comms:
                    g2 = x.reshape((2, 4) + local)
                    h2 = y.reshape((2, 4) + local)
                    same_as_plain(f"ring_shift2 on {sub} {tag}",
                                  coll.ring_shift2, g2, h2, sub)
                    cases += 1
    sync(dev)
    log(f"  {cases} hop calls equal their plain versions bit for bit")
    return WORST["diff"]


def check_ring(dev, on_card):
    """Phase 8: the fused ring against its plain version, bit for bit, at
    the mesh's n = 3, 4, 8 and at path (g)'s island fold (n = 2, its check
    counts and timed payloads); returns the largest difference."""
    WORST["diff"] = 0.0
    cases = 0
    seed = 100
    g_counts = G_COUNTS + tuple(b // 4 for b in G_SIZES[1:]) if on_card \
        else G_COUNTS[:3]
    for n, counts in ((2, g_counts), (3, RING_COUNTS + (RING_SPLIT_COUNT,)),
                      (4, RING_COUNTS), (8, RING_COUNTS),
                      (65, (1, 513, 16 * 1024 + 37))):
        for count in counts:
            seed += 1
            rows = random_tensor((n, count), torch.float32, dev, seed)
            got = coll.fused_ring_kernel(rows) if dev.type == "cuda" \
                else coll.fused_ring_allreduce_plain(rows)
            ref = coll.fused_ring_allreduce_plain(rows)
            diff = abs_diff(got, ref)
            WORST["diff"] = max(WORST["diff"], diff)
            if not bits_equal(got, ref):
                fail(f"fused ring n={n} count={count}: differs from the "
                     f"plain version by {diff:.3e}")
            if not bits_equal(got, got[:1].expand_as(got)):
                fail(f"fused ring n={n} count={count}: rows differ")
            cases += 1
    for n, count in ((4, 16 * 1024 + 37), (3, RING_SPLIT_COUNT)):
        comm = make_mesh(n, device=dev)
        for dtype in RING_DTYPES:
            seed += 1
            x = random_tensor((n, count), dtype, dev, seed)
            same_as_plain(f"fused ring n={n} count={count} {dtype}",
                          coll.fused_ring_allreduce_sum, x, comm)
            cases += 1
    sync(dev)
    log(f"  {cases} fused-ring calls equal their plain versions bit for "
        "bit, every row identical")
    return WORST["diff"]


def time_hop(dev, model):
    """The hop's time per call on path (a)'s halo strips: the y strips (4
    fields of nxl+2) and the x strips (4 fields of nyl+2), each moved by
    one ring_shift2 on its grid axis; then the profiler's device time of
    one launch (after every CUDA-event reading: a CUPTI session may slow
    the launches that follow it)."""
    grid = model.grid
    gy, gx = grid.shape
    nyp, nxp = model.block_shape
    rows, calls = {}, {}
    for name, gdim, strip in (("y", 0, (4, 1, nxp)), ("x", 1, (4, nyp, 1))):
        a = random_tensor((gy, gx) + strip, torch.float32, dev, 7)
        b = random_tensor((gy, gx) + strip, torch.float32, dev, 8)
        comm = grid.axis_comm(gdim)
        calls[name] = lambda a=a, b=b, comm=comm: coll.ring_shift2(a, b, comm)
        ms = time_ms(calls[name], 200)
        with coll.use_plain():
            plain_ms = time_ms(calls[name], 200)
        lib_ms = time_ms(lambda a=a, b=b, d=gdim: (
            torch.roll(a, 1, dims=d), torch.roll(b, -1, dims=d)), 200)
        nbytes = 2 * (a.numel() + b.numel()) * 4
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                          payload_bytes=nbytes // 2)
    for name, row in rows.items():
        # the kernel's own time on the card, from the profiler
        _, groups, launches = kernel_ms_by_group(
            calls[name], 200, lambda k: "hop" if "hop_kernel" in k else k,
            dev, expect=("hop",))
        if set(groups) != {"hop"} or launches["hop"] > 1:
            fail(f"200 ring_shift2 of the {name} strips ran {sorted(groups)},"
                 f" {launches['hop'] * 200:.0f} hop launches")
        # the profiler may miss launches: a launch's time is read over
        # those it recorded
        row["device_ms"] = groups["hop"] / launches["hop"]
        row["profiled_launches"] = round(launches["hop"] * 200)
        log(f"  hop, {name} strips ({row['payload_bytes']} B per launch): "
            f"{row['ms'] * 1e3:.2f} us per call, the launch "
            f"{row['device_ms'] * 1e3:.2f} us on the card (the profiler "
            f"recorded {row['profiled_launches']} of 200), bound "
            f"{row['bound_ms'] * 1e3:.4f} us (bytes), plain "
            f"{row['plain_ms'] * 1e3:.2f} us, torch.roll pair "
            f"{row['library_ms'] * 1e3:.2f} us")
    return rows


def time_ring(dev, n=4, count=4 * 1024 * 1024):
    """The fused ring's time at n ranks and count f32 per rank."""
    x = random_tensor((n, count), torch.float32, dev, 11)
    ms = time_ms(lambda: coll.fused_ring_kernel(x), 20)
    plain_ms = time_ms(lambda: coll.fused_ring_allreduce_plain(x), 5)
    lib_ms = time_ms(lambda: x.sum(0), 20)
    rows_ms = time_ms(
        lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(), 20)
    bound = 2 * n * count * 4 / HBM_BYTES_PER_S * 1e3
    log(f"  fused ring, n={n}, {count * 4} B per rank: {ms:.4f} ms, bound "
        f"{bound:.4f} ms (bytes), {bound / ms:.3f} of it; plain "
        f"{plain_ms:.4f} ms; x.sum(0) {lib_ms:.4f} ms (one row); the n rows"
        f" by x.sum(0, keepdim=True).expand_as(x).contiguous() "
        f"{rows_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_n_rows_ms=rows_ms, bound_ms=bound)


def path_b(dev, max_bytes, on_card, card):
    """Phase 9: the sweep at n = 4 and 8, then each size against the plain
    route."""
    reset_counts()
    recs = []
    for n in (4, 8):
        recs += allreduce_sweep.sweep(n, 1024, max_bytes, device=dev,
                                      reps=10 if on_card else 1,
                                      warmup=3 if on_card else 1)
    launches = dict(coll.LAUNCHES)
    if on_card and launches["fused_ring"] == 0:
        fail("path (b) launched no fused ring")
    for r in recs:
        n, nbytes = r["ranks"], r["bytes"]
        comm = make_mesh(n, device=dev)
        x = allreduce_sweep.make_input(n, nbytes, 0, dev)
        same_as_plain(f"allreduce n={n} {nbytes} B", lambda v: ops.allreduce(
            v, op=ops.SUM, comm=comm), x)
        if nbytes // 4 >= coll.BIDIR_MIN_ELEMS and r["arm"] != "fused_ring":
            fail(f"allreduce n={n} {nbytes} B took {r['arm']}")
        r["bound_us"] = 2 * n * nbytes / HBM_BYTES_PER_S * 1e6
        r["sum0_us"] = allreduce_sweep.time_call(
            lambda: x.sum(0), dev, 3 if on_card else 1,
            10 if on_card else 1) * 1e6
        log(f"  n={n} {nbytes:>9} B: {r['us']:10.2f} us {r['arm']:<10} "
            f"{r['eff_GBps_per_chip']:9.3f} GB/s eff, bound "
            f"{r['bound_us']:9.3f} us, x.sum(0) {r['sum0_us']:9.2f} us; "
            "equals plain")
        del x
    log(f"  launches in the sweep: {launches} [{card}]")
    return recs, launches


def halo_share(model, state, steps=5):
    """CUDA-event time of the halo exchanges within ``steps`` steps, over
    the steps' time."""
    orig = model._exchange
    spans = []

    def timed(fields, kinds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(fields, kinds)
        b.record()
        spans.append((a, b))
        return out

    model._exchange = timed
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s = state
        start.record()
        for _ in range(steps):
            s = model._step_local(s, False)
        end.record()
        end.synchronize()
    finally:
        del model._exchange
    halo = sum(a.elapsed_time(b) for a, b in spans)
    return halo / steps, start.elapsed_time(end) / steps, len(spans) // steps


def path_a(shape, dev, ref_1x1, on_card, reps):
    """Phase 10: the 2x2 solver for 0.1 day through the hop kernel."""
    model = sw.ShallowWater(shape, grid=GRID, device=dev)
    n_steps = int(DAYS * model.params.day_seconds / model.params.dt)
    first = model.step_fn(1, first=True)
    run = model.step_fn(n_steps - 1)
    model.step_fn(2, first=True)(model.init())  # warm-up
    sync(dev)

    reset_counts()
    s0 = model.init()
    state1 = first(s0)
    sync(dev)
    before = coll.LAUNCHES["hop"]
    t0 = time.perf_counter()
    state = run(state1)
    sync(dev)
    times = [time.perf_counter() - t0]
    launches = dict(coll.LAUNCHES)
    timed_hops = launches["hop"] - before
    if on_card and launches["hop"] == 0:
        fail("path (a) launched no hop kernel")
    for _ in range(reps - 1):
        t0 = time.perf_counter()
        state = run(state1)
        sync(dev)
        times.append(time.perf_counter() - t0)

    if not bool(torch.isfinite(state.h).all()):
        fail("path (a): h is not finite")
    h = model.interior(state.h)
    if h.shape != tuple(shape):
        fail(f"path (a): h has shape {h.shape}")
    m0, m1 = model.total_mass(s0), model.total_mass(state)
    drift = abs(m1 - m0) / abs(m0)
    if not drift < 1e-5:
        fail(f"path (a): mass drifted by {drift:.3e}")

    t0 = time.perf_counter()
    twin = model.step_fn(n_steps - 1, impl="plain")(
        model.step_fn(1, first=True, impl="plain")(s0))
    sync(dev)
    twin_secs = time.perf_counter() - t0
    for name, a, b in zip(sw.SWState._fields, state, twin):
        if not bits_equal(a, b):
            fail(f"path (a): field {name} differs from the plain-hop run "
                 f"by {abs_diff(a, b):.3e}")
    d1 = float(abs(h - ref_1x1).max())
    if not d1 < GRID_TOL:
        fail(f"path (a): h differs from the 1x1 run by {d1:.3e}")
    secs = statistics.median(times)
    timed = n_steps - 1
    log(f"  {GRID[0]}x{GRID[1]} grid at {tuple(shape)}: {timed} timed steps "
        f"in {secs:.4f} s median of {len(times)} "
        f"({[round(t, 4) for t in times]}), {secs / timed * 1e3:.4f} ms/step; "
        f"launches {launches} ({timed_hops / timed:.2f} hops per timed "
        f"step); mass drift {drift:.2e}; h in [{h.min():.3f}, {h.max():.3f}]")
    log(f"  equals the plain-hop run bit for bit (that run: {twin_secs:.4f} s);"
        f" max |h - h_1x1| = {d1:.3e} (tolerance {GRID_TOL})")
    share = None
    if on_card:
        halo_ms, step_ms, calls = halo_share(model, state)
        share = halo_ms / step_ms
        log(f"  halo: {halo_ms:.4f} ms of {step_ms:.4f} ms per step "
            f"({share:.3f}), {calls} exchanges per step")
    return dict(model=model, secs=secs, launches=launches,
                hops_per_step=timed_hops / timed, d1x1=d1, drift=drift,
                halo_share=share, twin_secs=twin_secs, times=times)


def check_alltoall(dev, on_card):
    """Phase 12: the alltoall kernel against alltoall_plain, bit for bit,
    and the fronts built on it against the plain route; returns the
    largest difference."""
    WORST["diff"] = 0.0
    grid = ProcessGrid((2, 4), device=dev)
    comms = ([make_mesh(n, device=dev) for n in (2, 3, 4, 8)]
             + [grid.axis_comm(0), grid.axis_comm(1)])
    cases = 0
    seed = 300
    for comm in comms:
        for dtype in A2A_DTYPES:
            for rest in A2A_RESTS:
                seed += 1
                x = random_tensor(comm.layout_shape + (comm.size(),) + rest,
                                  dtype, dev, seed)
                before = coll.LAUNCHES["alltoall"]
                tag = f"alltoall on {comm} {dtype} rest {rest}"
                same_as_plain(tag, coll.alltoall, x, comm)
                launched = coll.LAUNCHES["alltoall"] - before
                if on_card and launched != (1 if x.numel() else 0):
                    fail(f"{tag}: {launched} launches")
                cases += 1
    for comm in (comms[2], comms[5]):
        seed += 1
        x = random_tensor(comm.layout_shape + (comm.size(), 7),
                          torch.float32, dev, seed)
        w = random_tensor(x.shape, torch.float32, dev, seed + 1000)

        def grad(v, comm=comm, w=w):
            v = v.detach().requires_grad_()
            (coll.alltoall(v, comm) * w).sum().backward()
            return v.grad

        same_as_plain(f"alltoall backward on {comm}", grad, x)
        cases += 1
    for n in (3, 4, 8):
        comm = make_mesh(n, device=dev)
        x = random_tensor((n, n, 5), torch.float32, dev, n)
        flags = random_tensor((n, 3), torch.bool, dev, n + 1)
        for what, fn, arg in (
                ("scatter", lambda v: ops.scatter(v, n - 1, comm=comm), x),
                ("bcast", lambda v: ops.bcast(v, 1, comm=comm), x),
                ("bcast bool", lambda v: ops.bcast(v, 0, comm=comm), flags),
                ("reduce SUM", lambda v: ops.reduce(v, ops.SUM, 2, comm=comm),
                 x),
                ("reduce MAX", lambda v: ops.reduce(v, ops.MAX, 0, comm=comm),
                 x),
                ("gather", lambda v: ops.gather(v, 0, comm=comm), x)):
            same_as_plain(f"{what} n={n}", fn, arg)
            cases += 1
        if ops.barrier(comm=comm) is not None:
            fail("barrier returned a value")
    sync(dev)
    log(f"  {cases} alltoall calls (kernel, backward, fronts) equal their "
        "plain versions bit for bit")
    return WORST["diff"]


def time_alltoall(dev, size=SPECTRAL_N, n=4):
    """The alltoall's time per launch on path (c)'s x-to-y transpose at
    size^3 complex64 over n ranks."""
    comm = make_mesh(n, device=dev)
    x = random_tensor((n, n, size // n, size // n, size), torch.complex64,
                      dev, 13)
    ms = time_ms(lambda: coll.alltoall(x, comm), 50)
    with coll.use_plain():
        plain_ms = time_ms(lambda: coll.alltoall(x, comm), 10)
    lib_ms = time_ms(lambda: x.transpose(0, 1).contiguous(), 50)
    nbytes = x.numel() * x.element_size()
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    # at 64 bytes per rank the call is all host work: validation, the
    # table lookup, one allocation, ctypes
    tiny = random_tensor((n, n, 4), torch.float32, dev, 14)
    host_us = time_ms(lambda: ops.alltoall(tiny, comm=comm), 200) * 1e3
    log(f"  alltoall, {size}^3 complex64 over n={n} ({nbytes} B): "
        f"{ms:.4f} ms/launch, bound {bound:.4f} ms (bytes), "
        f"{bound / ms:.3f} of it; plain {plain_ms:.4f} ms; "
        f"x.transpose(0, 1).contiguous() {lib_ms:.4f} ms; a call of "
        f"{tiny[0].numel() * 4} B per rank through ops.alltoall "
        f"{host_us:.2f} us")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                payload_bytes=nbytes, tiny_call_us=host_us)


def alltoall_share(comm, f, size):
    """CUDA-event time of the alltoalls within SOLVES back-to-back solves,
    over the solves' time; a span also counts any time the card waits for
    the call's host work."""
    orig = spectral.alltoall
    spans = []

    def timed(x, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(x, **kw)
        b.record()
        spans.append((a, b))
        return out

    spectral.alltoall = timed
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SOLVES):
            spectral.poisson_solve(f, comm=comm, shape=(size,) * 3)
        end.record()
        end.synchronize()
    finally:
        spectral.alltoall = orig
    part = sum(a.elapsed_time(b) for a, b in spans)
    whole = start.elapsed_time(end)
    return part / SOLVES, whole / SOLVES, len(spans) // SOLVES


def path_c(dev, size, on_card, card):
    """Phase 13: the spectral Poisson solve at n = 1, 4 and 8."""
    rows = []
    total = 0
    for ranks in SPECTRAL_RANKS:
        reset_counts()
        rec, u = spectral_bench.run(size, ranks, SOLVES, device=dev)
        launches = dict(coll.LAUNCHES)
        expect = 2 * (SOLVES + 1) if ranks > 1 else 0
        if on_card and launches["alltoall"] != expect:
            fail(f"path (c) n={ranks}: {launches['alltoall']} alltoall "
                 f"launches, expected {expect}")
        total += launches["alltoall"]
        if u.shape != (ranks, size // ranks, size, size) or not bool(
                torch.isfinite(u).all()):
            fail(f"path (c) n={ranks}: u has shape {tuple(u.shape)} or is "
                 "not finite")
        if not rec["max_abs_err"] <= POISSON_TOL:
            fail(f"path (c) n={ranks}: |u - u_true| = "
                 f"{rec['max_abs_err']:.3e}")
        comm = make_mesh(ranks, device=dev)
        f, _ = spectral_bench.manufactured(size, comm)
        t0 = time.perf_counter()
        with coll.use_plain():
            twin = spectral.poisson_solve(f, comm=comm, shape=(size,) * 3)
        sync(dev)
        twin_secs = time.perf_counter() - t0
        if not bits_equal(u, twin):
            fail(f"path (c) n={ranks}: differs from the plain-route solve by "
                 f"{abs_diff(u, twin):.3e}")
        row = dict(ranks=ranks, ms_per_solve=rec["ms_per_solve"],
                   launches=launches["alltoall"],
                   launches_per_solve=rec["alltoall_launches_per_solve"],
                   max_abs_err=rec["max_abs_err"], plain_twin_s=twin_secs)
        msg = ""
        if on_card:
            part, whole, calls = alltoall_share(comm, f, size)
            prof = spectral_bench.device_profile(size, ranks, SOLVES,
                                                 device=dev)
            row.update(alltoall_ms=part, solve_ms=whole,
                       alltoall_share=part / whole, profile=prof)
            msg = (f"; alltoall spans {part:.4f} of {whole:.4f} ms per "
                   f"solve ({part / whole:.3f}, {calls} calls); profiler: "
                   f"card busy {prof['busy_ms_per_solve']:.4f} of "
                   f"{prof['wall_ms_per_solve']:.4f} ms per solve ("
                   f"{prof['busy_share']:.3f}), by group "
                   + ", ".join(f"{k} {v:.4f}" for k, v in
                               prof["ms_per_solve_by_group"].items()))
        log(f"  n={ranks}: {rec['ms_per_solve']:.4f} ms per solve (mean of "
            f"{SOLVES} after one warm-up), launches {launches} "
            f"({rec['alltoall_launches_per_solve']:.2f} alltoall per timed "
            f"solve); max |u - u_true| {rec['max_abs_err']:.3e}; bit for bit "
            f"the plain route ({twin_secs:.4f} s){msg} [{card}]")
        rows.append(row)
        del u, twin, f
    return rows, total


def check_flash(dev, on_card):
    """Phase 15: kernel 5 against flash_fwd_block_plain at the edge
    shapes; returns the worst errors by dtype and the case count."""
    head_dims = flash_chk.HEAD_DIMS if on_card else (16,)
    worst = {}
    cases = 0
    for tag, q, k, v, qo, ko, scale, causal in flash_chk.cases(
            dev, head_dims=head_dims):
        got = flash.flash_fwd_block(q, k, v, qo, ko, scale=scale,
                                    causal=causal)
        sync(dev)
        ref = flash.flash_fwd_block_plain(q, k, v, qo, ko, scale=scale,
                                          causal=causal)
        noise = flash_chk.noise(q, k, v, qo, ko, scale=scale, causal=causal)
        errs = flash_chk.errors(got, ref, noise)
        if not flash_chk.within(errs, q.dtype):
            fail(f"kernel 5 {tag}: {errs} (tolerance "
                 f"{flash_chk.TOL[q.dtype]})")
        w = worst.setdefault(str(q.dtype)[6:], {"o": 0.0, "l": 0.0, "m": 0.0,
                                                "max_abs_err": 0.0})
        for key in w:
            w[key] = max(w[key], errs[key])
        cases += 1
    for name, w in worst.items():
        log(f"  {name}: worst o {w['o']:.3e} (of the noise scale), l "
            f"{w['l']:.3e}, m {w['m']:.3e}; |o/l - plain| "
            f"{w['max_abs_err']:.3e}")
    log(f"  {cases} cases within _flash_check.TOL, rows that see no key "
        "exactly empty")
    return worst, cases


def check_big_hops(dev, on_card):
    """Phase 16: the hop past 64 (rank, payload) pairs, bit for bit
    against the plain route, and its launch counts."""
    cases = 0
    for n in (64, 65):
        comm = make_mesh(n, device=dev)
        x = random_tensor((n, 37), torch.float32, dev, n)
        y = random_tensor((n, 5), torch.bfloat16, dev, n + 1)
        for what, fn, args in (("ring_shift", coll.ring_shift, (x, comm, 1)),
                                ("ring_shift_n", coll.ring_shift_n,
                                 ((x, y), comm, 1)),
                                ("ring_shift2", coll.ring_shift2,
                                 (x, y, comm))):
            before = coll.LAUNCHES["hop"]
            same_as_plain(f"{what} n={n}", fn, *args)
            launched = coll.LAUNCHES["hop"] - before
            if on_card and launched != 1:
                fail(f"{what} over {n} ranks took {launched} hop launches")
        same_as_plain(f"allreduce n={n}", lambda t: ops.allreduce(t,
                                                                 comm=comm), x)
        cases += 4
    for shape in ((6, 6), (8, 8)):
        grid = ProcessGrid(shape, device=dev)
        f = random_tensor(shape + (3, 10, 12), torch.float32, dev, 9)
        for periodic in (True, False):
            before = coll.LAUNCHES["hop"]
            same_as_plain(f"halo_exchange {shape} periodic={periodic}",
                          lambda g: halo_exchange(g, grid, periodic=periodic),
                          f)
            launched = coll.LAUNCHES["hop"] - before
            if on_card and launched != 2:
                fail(f"halo_exchange on {shape} took {launched} hop launches,"
                     " not one per grid dimension")
            cases += 1
    sync(dev)
    log(f"  {cases} calls past 64 pairs equal their plain versions bit for "
        "bit; every hop one launch")
    return cases


def visible_pairs(offs, t):
    """(query, key) pairs a causal block sees, over the batch rows of one
    launch with ``offs`` (rows, 2) and T = t on both sides, and the number
    of batch rows that see any key."""
    q_off = offs[:, 0].long().cpu()[:, None]
    k_off = offs[:, 1].long().cpu()[:, None]
    rows = torch.arange(t)[None, :]
    seen = (q_off + rows - k_off + 1).clamp(0, t)
    return int(seen.sum()), int((seen.sum(1) > 0).sum())


def flash_launch(dev, qf, kf, vf, offs, t, reps, plain_reps):
    """Kernel 5's time per launch on one ring step's inputs, beside its
    bound, the plain version's time, and the kernel held to the plain
    version at that shape."""
    rows, _, d = qf.shape
    args = (qf, kf, vf, offs)
    ms = time_ms(lambda: flash._flash_fwd_kernel(*args, scale=1.0,
                                                 causal=True), reps)
    got = flash._flash_fwd_kernel(*args, scale=1.0, causal=True)
    t0 = time.perf_counter()
    ref = flash.flash_fwd_block_plain(qf, kf, vf, offs[:, 0], offs[:, 1],
                                      scale=1.0, causal=True)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if plain_reps > 1:
        plain_ms = time_ms(lambda: flash.flash_fwd_block_plain(
            qf, kf, vf, offs[:, 0], offs[:, 1], scale=1.0, causal=True),
            plain_reps)
    noise = flash_chk.noise(qf, kf, vf, offs[:, 0], offs[:, 1], scale=1.0,
                            causal=True)
    errs = flash_chk.errors(got, ref, noise)
    if not flash_chk.within(errs, qf.dtype):
        fail(f"kernel 5 at the path's shape {tuple(qf.shape)}: {errs} "
             f"(tolerance {flash_chk.TOL[qf.dtype]})")
    pairs, live_rows = visible_pairs(offs, t)
    op_ms = 4 * d * pairs / BF16_FLOPS_PER_S * 1e3
    in_bytes = 3 * live_rows * t * d * qf.element_size()
    out_bytes = rows * t * (d + 2) * 4
    mem_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    bound = max(op_ms, mem_ms)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, op_ms=op_ms,
                mem_ms=mem_ms,
                bound_by="operations" if op_ms >= mem_ms else "bytes",
                flop=4 * d * pairs, errors=errs)


def path_d(dev, on_card, card):
    """Phase 17: ring attention's forward at n = 1 and 4."""
    shape = FLASH_SHAPE if on_card else (1, 64, 2, 16)
    b, t, h, d = shape
    qkv = ring_bench.make_qkv(shape, torch.bfloat16, dev, seed=0)
    tol = flash_chk.TOL[torch.bfloat16]["o"]
    runs, outs = [], {}
    total = 0
    for n in FLASH_RANKS:
        reset_counts()
        rec, out = ring_bench.run(shape, n, FLASH_ITERS, torch.bfloat16,
                                  device=dev, qkv=qkv)
        launches = flash.LAUNCHES["flash_fwd"]
        hops = coll.LAUNCHES["hop"]
        total += launches
        forwards = FLASH_ITERS + 1  # the warm-up and the timed forwards
        if on_card and (launches != n * forwards
                        or hops != (n - 1) * forwards):
            fail(f"path (d) n={n}: {launches} flash and {hops} hop launches "
                 f"in {forwards} forwards, expected {n} and {n - 1} each")
        if out.shape != (n, b, t // n, h, d) or not bool(
                torch.isfinite(out).all()):
            fail(f"path (d) n={n}: the output has shape {tuple(out.shape)} "
                 "or is not finite")
        # the f32 output before its cast, against the plain route's, over
        # each component's noise scale (launches after the counts are read)
        comm = make_mesh(n, device=dev)
        q, k, v = (ring_bench.shard(x, n) for x in qkv)
        got, ref = flash_chk.ring_outputs(q, k, v, comm, True)
        noise = flash_chk.ring_noise(q, k, v, comm, True)
        err = flash_chk.scaled_error(got, ref, noise)
        if not err <= tol:
            fail(f"path (d) n={n}: the f32 output {err:.3e} of its noise "
                 f"scale from the plain route's, past {tol}")
        if not torch.equal(got.to(torch.bfloat16), out):
            fail(f"path (d) n={n}: the entry point's output is not the f32 "
                 "output cast")
        outs[n] = ring_bench.unshard(got)
        if n == FLASH_RANKS[0]:
            noise_1 = ring_bench.unshard(noise)
        del q, k, v, got, ref, noise
        rec.update(flash_launches=launches, hop_launches=hops, o_error=err)
        runs.append(rec)
        tflops = (f"{rec['tflops']:.1f} TFLOP/s" if rec["tflops"] is not None
                  else "no rate (CPU)")
        log(f"  n={n}: {rec['ms_per_forward']:.4f} ms per forward (mean of "
            f"{FLASH_ITERS} after a warm-up), {tflops}; {launches} flash and "
            f"{hops} hop launches in {forwards} forwards; plain route "
            f"{rec['plain_ms']:.4f} ms; |out - plain route| "
            f"{rec['max_abs_diff']:.3e}; f32 output {err:.3e} of its noise "
            f"scale from the plain route's (tolerance {tol}) [{card}]")
        if on_card:
            prof = ring_bench.device_profile(shape, n, device=dev, qkv=qkv)
            rec["profile"] = prof
            log(f"  n={n} profiler: card busy "
                f"{prof['busy_ms_per_forward']:.4f} of "
                f"{prof['wall_ms_per_forward']:.4f} ms per forward "
                f"({prof['busy_share']:.3f}), by group "
                + ", ".join(f"{k} {v:.4f}" for k, v in
                            prof["ms_per_forward_by_group"].items()))
    gap = flash_chk.scaled_error(outs[FLASH_RANKS[-1]], outs[FLASH_RANKS[0]],
                                 noise_1)
    if not gap <= tol:
        fail(f"path (d): n={FLASH_RANKS[-1]} and n={FLASH_RANKS[0]} differ "
             f"by {gap:.3e} of the noise scale, past {tol}")
    log(f"  f32 out(n={FLASH_RANKS[-1]}) against out(n={FLASH_RANKS[0]}): "
        f"{gap:.3e} of the noise scale")
    if not on_card:
        return runs, total, None

    # kernel 5 per launch: the whole forward at n = 1, each step at n = 4,
    # on the path's own prescaled q
    steps = {}
    for n in FLASH_RANKS:
        comm = make_mesh(n, device=dev)
        qf, kf, vf = (flash._to_bhtd(ring_bench.shard(x, n)) for x in qkv)
        qf = flash.prescale(qf)
        offs = flash._ring_offsets(comm, b * h, t // n, dev)
        steps[n] = []
        for i in range(n):
            row = flash_launch(dev, qf, kf, vf, offs[i], t // n, 20,
                               1 if n > 1 else 2)
            steps[n].append(row)
            log(f"  kernel 5, n={n} step {i}: {row['ms']:.4f} ms per launch "
                f"({row['flop'] / row['ms'] / 1e9:.1f} TFLOP/s), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}: ops "
                f"{row['op_ms']:.4f}, bytes {row['mem_ms']:.4f}), "
                f"{row['bound_ms'] / row['ms']:.3f} of it; plain "
                f"{row['plain_ms']:.4f} ms; o error {row['errors']['o']:.2e} "
                f"of the noise scale")
        del qf, kf, vf
    q, k, v = (x.transpose(1, 2).contiguous() for x in qkv)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True), 20)
    lib_out = sdpa(q, k, v, is_causal=True).transpose(1, 2).float()
    lib_gap = (outs[1] - lib_out).abs().max().item()
    log(f"  scaled_dot_product_attention(is_causal=True) on the same "
        f"tensors: {lib_ms:.4f} ms; |out(n=1) - SDPA| {lib_gap:.3e} (the "
        "port rounds q x scale to bf16 first, as the JAX package does)")
    return runs, total, dict(steps=steps, library_ms=lib_ms,
                             library_gap=lib_gap, n_gap=gap)


def check_flash_bwd(dev, on_card):
    """Phase 19: kernels 6 and 7 against flash_bwd_block_plain at the edge
    cases; returns the worst errors by dtype and the case count."""
    head_dims = flash_chk.HEAD_DIMS if on_card else (16,)
    worst = {}
    cases = 0
    for (tag, q, k, v, do, lse, delta, qo, ko, scale,
         causal) in flash_chk.bwd_cases(dev, head_dims=head_dims):
        args = (q, k, v, do, lse, delta, qo, ko)
        got = flash.flash_bwd_block(*args, scale=scale, causal=causal)
        sync(dev)
        ref = flash.flash_bwd_block_plain(*args, scale=scale, causal=causal)
        noise = flash_chk.bwd_noise(*args, scale=scale, causal=causal)
        errs = flash_chk.bwd_errors(got, ref, noise)
        if not flash_chk.within_bwd(errs, q.dtype):
            fail(f"kernels 6 and 7 {tag}: {errs} (tolerance "
                 f"{flash_chk.TOL_BWD[q.dtype]})")
        w = worst.setdefault(str(q.dtype)[6:], dict.fromkeys(
            ("dq", "dk", "dv", "max_abs_err"), 0.0))
        for key in w:
            w[key] = max(w[key], errs[key])
        cases += 1
    for name, w in worst.items():
        log(f"  {name}: worst dq {w['dq']:.3e}, dk {w['dk']:.3e}, dv "
            f"{w['dv']:.3e} (of the noise scale); max |diff| "
            f"{w['max_abs_err']:.3e}")
    log(f"  {cases} cases within _flash_check.TOL_BWD, components without a "
        "term exactly 0")
    return worst, cases


def bwd_launches(dev, qf, kf, vf, dof, lse, delta, offs, t, reps,
                 plain_reps):
    """Kernels 6 and 7's times per launch on one ring step's inputs, each
    beside its bound, the plain version's time (both kernels' work), and
    the pair held to the plain version at that shape."""
    rows, _, d = qf.shape
    args = (qf, kf, vf, dof, lse, delta, offs)
    kw = dict(scale=1.0, causal=True)
    ms6 = time_ms(lambda: flash._flash_bwd_dq_kernel(*args, **kw), reps)
    ms7 = time_ms(lambda: flash._flash_bwd_dkv_kernel(*args, **kw), reps)
    got = flash.flash_bwd_block(*args[:6], offs[:, 0], offs[:, 1], **kw)
    plain = (*args[:6], offs[:, 0], offs[:, 1])
    t0 = time.perf_counter()
    ref = flash.flash_bwd_block_plain(*plain, **kw)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if plain_reps > 1:
        plain_ms = time_ms(lambda: flash.flash_bwd_block_plain(*plain, **kw),
                           plain_reps)
    noise = flash_chk.bwd_noise(*plain, **kw)
    errs = flash_chk.bwd_errors(got, ref, noise)
    if not flash_chk.within_bwd(errs, qf.dtype):
        fail(f"kernels 6 and 7 at the path's shape {tuple(qf.shape)}: "
             f"{errs} (tolerance {flash_chk.TOL_BWD[qf.dtype]})")
    pairs, live_rows = visible_pairs(offs, t)
    el = qf.element_size()
    # each input read once, each output written once: q, dO, lse, delta
    # of every row; k and v of the rows that see a key; f32 outputs
    rows_in = rows * t * (2 * d * el + 8)
    kv_in = 2 * live_rows * t * d * el
    rows_out = {6: rows * t * d * 4, 7: 2 * rows * t * d * 4}
    out = {}
    for kern, ms, units in ((6, ms6, 3), (7, ms7, 4)):
        flop = 2 * units * d * pairs
        op_ms = flop / BF16_FLOPS_PER_S * 1e3
        mem_ms = (rows_in + kv_in + rows_out[kern]) / HBM_BYTES_PER_S * 1e3
        out[kern] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(op_ms, mem_ms),
                         op_ms=op_ms, mem_ms=mem_ms, flop=flop,
                         bound_by="operations" if op_ms >= mem_ms else "bytes")
    out["errors"] = errs
    return out


def sdpa_ms(qkv, do):
    """scaled_dot_product_attention(is_causal=True) on the global tensors:
    the forward's time and the forward and backward's (CUDA events)."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in qkv)
    fwd = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), 20)
    return fwd, ring_bench.sdpa_fwd_bwd_ms(qkv, do, 10)


def path_e(dev, on_card, card):
    """Phase 20: ring attention's forward and backward at n = 1 and 4."""
    shape = FLASH_SHAPE if on_card else (1, 64, 2, 16)
    b, t, h, d = shape
    qkv = ring_bench.make_qkv(shape, torch.bfloat16, dev, seed=0)
    do_g = ring_bench.make_qkv(shape, torch.bfloat16, dev, seed=1)[0]
    tol = flash_chk.TOL_BWD[torch.bfloat16]
    runs, totals = [], {}
    for n in FLASH_RANKS:
        reset_counts()
        rec, grads = ring_bench.run_backward(shape, n, BWD_ITERS,
                                             torch.bfloat16, device=dev,
                                             qkv=qkv)
        # the path's launches, read before run_backward's check ran the
        # kernel route again
        launches = {k: rec["launches"][k] for k in flash.LAUNCHES}
        hops = rec["launches"]["hop"]
        steps = BWD_ITERS + 1  # the warm-up and the timed steps
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        want_hops = steps * (n - 1 + (n if n > 1 else 0))
        if on_card and (any(v != n * steps for v in launches.values())
                        or hops != want_hops):
            fail(f"path (e) n={n}: {launches} and {hops} hop launches in "
                 f"{steps} steps, expected {n} of each kernel and "
                 f"{want_hops // steps} hops per step")
        if any(g.shape != (n, b, t // n, h, d)
               or not bool(torch.isfinite(g).all()) for g in grads):
            fail(f"path (e) n={n}: a gradient is not finite or has another "
                 "shape")
        errs = rec["grad_errors"]
        if not rec["within"]:
            fail(f"path (e) n={n}: the f32 gradients against the plain "
                 f"route's {errs}, tolerance {tol}")
        if not rec["grads_are_f32_cast"]:
            fail(f"path (e) n={n}: the entry point's dq, dk, dv are not the "
                 "f32 gradients cast")
        del grads
        rec.update(hop_launches=hops)
        runs.append(rec)
        tflops = (f"{rec['tflops']:.1f} TFLOP/s" if rec["tflops"] is not None
                  else "no rate (CPU)")
        log(f"  n={n}: {rec['ms_per_step']:.4f} ms per forward+backward "
            f"(mean of {BWD_ITERS} after a warm-up), {tflops} (3.5 x the "
            f"causal forward's flop); launches in {steps} steps: {launches}, "
            f"{hops} hops; plain route {rec['plain_ms']:.4f} ms; f32 "
            f"gradients over their noise dq {errs['dq']:.3e}, dk "
            f"{errs['dk']:.3e}, dv {errs['dv']:.3e} (tolerance {tol}), the "
            f"entry point's their cast [{card}]")
        if on_card:
            prof = ring_bench.device_profile(shape, n, device=dev, qkv=qkv,
                                             backward=True)
            rec["profile"] = prof
            log(f"  n={n} profiler: card busy "
                f"{prof['busy_ms_per_forward']:.4f} of "
                f"{prof['wall_ms_per_forward']:.4f} ms per step "
                f"({prof['busy_share']:.3f}), by group "
                + ", ".join(f"{k} {v:.4f}" for k, v in
                            prof["ms_per_forward_by_group"].items()))
    if not on_card:
        return runs, totals, None

    # kernels 6 and 7 per launch: the whole backward at n = 1, each step at
    # n = 4, with the lse and delta of the path's forward
    steps = {}
    for n in FLASH_RANKS:
        comm = make_mesh(n, device=dev)
        q, k, v, do = (ring_bench.shard(x, n) for x in (*qkv, do_g))
        steps[n] = []
        for i, st in enumerate(flash_chk.ring_bwd_steps(q, k, v, do, comm,
                                                        True)):
            row = bwd_launches(dev, *st.args, t // n, 10, 1)
            steps[n].append(row)
            log_bwd_launch(f"n={n} step {i}", row)
        del q, k, v, do, st
    fwd_ms, fwd_bwd_ms = sdpa_ms(qkv, do_g)
    log(f"  scaled_dot_product_attention(is_causal=True) on the same "
        f"tensors: forward {fwd_ms:.4f} ms, forward+backward "
        f"{fwd_bwd_ms:.4f} ms, so its backward {fwd_bwd_ms - fwd_ms:.4f} ms")
    return runs, totals, dict(steps=steps, sdpa_fwd_ms=fwd_ms,
                              sdpa_fwd_bwd_ms=fwd_bwd_ms,
                              library_ms=fwd_bwd_ms - fwd_ms)


def log_bwd_launch(at, row):
    for kern in (6, 7):
        r = row[kern]
        log(f"  kernel {kern}, {at}: {r['ms']:.4f} ms per launch "
            f"({r['flop'] / r['ms'] / 1e9:.1f} TFLOP/s), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: ops {r['op_ms']:.4f}, "
            f"bytes {r['mem_ms']:.4f}), {r['bound_ms'] / r['ms']:.3f} of it")
    log(f"  plain version (both) {row[6]['plain_ms']:.4f} ms; errors dq "
        f"{row['errors']['dq']:.2e}, dk {row['errors']['dk']:.2e}, dv "
        f"{row['errors']['dv']:.2e} of the noise scale")


def log_fwd_launch(at, row):
    log(f"  kernel 5, {at}: {row['ms']:.4f} ms per launch "
        f"({row['flop'] / row['ms'] / 1e9:.1f} TFLOP/s), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}: ops "
        f"{row['op_ms']:.4f}, bytes {row['mem_ms']:.4f}), "
        f"{row['bound_ms'] / row['ms']:.3f} of it; plain "
        f"{row['plain_ms']:.4f} ms; o error {row['errors']['o']:.2e} of the "
        "noise scale")


def path_f_launches(dev, cfg, batch, seq, mesh, seed, reps, plain_reps):
    """Kernels 5, 6 and 7 at the shapes a mesh's GPT step gives them
    (``gpt_step.attention_inputs``: every rank's batch rows and heads in
    one launch), with the lse and delta of the ring's forward.  Per ring
    step: kernel 5 and kernels 6 and 7 each held to the plain version at
    that shape, with their times and bounds."""
    *qkvdo, comm = gpt_bench.attention_inputs(cfg, mesh, batch, seq, seed,
                                              dev)
    t = seq // mesh[2]
    rows = []
    for i, st in enumerate(flash_chk.ring_bwd_steps(*qkvdo, comm, True)):
        at = f"{mesh} step {i}, {st.q.shape[0]} rows of T{t} D{st.q.shape[2]}"
        fwd = flash_launch(dev, st.q, st.k, st.v, st.offs, t, reps,
                           plain_reps)
        log_fwd_launch(at, fwd)
        bwd = bwd_launches(dev, *st.args, t, reps, plain_reps)
        log_bwd_launch(at, bwd)
        rows.append(dict(at=at, fwd=fwd, bwd=bwd))
    return rows


def path_f_rows(f_times, part, kern=None):
    """The kernels line's record of path (f)'s launches of kernel 5
    (``part`` "fwd") or of kernel ``kern`` ("bwd"): per mesh and ring
    step, the time, the plain version's, the bound and the errors."""
    out = []
    for rows in f_times["launches"].values():
        for row in rows:
            r = row[part] if kern is None else row[part][kern]
            errs = row[part]["errors"]
            out.append({"at": row["at"], **{k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")}, "errors": errs})
    return out


def path_f(dev, on_card, card):
    """Phase 21: the GPT-2 124M train step at (1, 1, 1) and (1, 2, 2)."""
    cfg = gpt_bench.CFG if on_card else gpt.GPTConfig(
        vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32,
        dtype="bfloat16")
    batch, seq = (gpt_bench.BATCH, gpt_bench.SEQ) if on_card else (2, 32)
    tol = gpt_bench.ROUTE_TOL[cfg.dtype]
    runs, totals = [], {}
    for mesh in gpt_bench.MESHES:
        sp = mesh[2]
        reset_counts()
        rec, model = gpt_bench.run(mesh, GPT_STEPS, cfg=cfg, batch=batch,
                                   seq=seq, device=dev)
        launches = {k: flash.LAUNCHES[k] for k in flash.LAUNCHES}
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        steps = GPT_STEPS + 1
        per_step = cfg.n_layers * sp
        if on_card and any(v != per_step * steps for v in launches.values()):
            fail(f"path (f) {mesh}: {launches} in {steps} steps, expected "
                 f"{per_step} launches of each kernel per step")
        if not all(np.isfinite(rec["losses"])):
            fail(f"path (f) {mesh}: losses {rec['losses']}")
        rec["launches"] = launches
        rate = (f"{rec['model_tflops']:.1f} model TFLOP/s"
                if rec["model_tflops"] is not None else "no rate (CPU)")
        log(f"  mesh {mesh}: {rec['ms_per_step']:.2f} ms per step (mean of "
            f"{GPT_STEPS} after a warm-up), {rec['tokens_per_s']:.0f} "
            f"tokens/s, {rate}, {rec['params_M']:.2f} M params; losses "
            f"{[round(x, 4) for x in rec['losses']]}; launches in {steps} "
            f"steps {launches}, per step {rec['launches_per_step']} [{card}]")
        if on_card:
            toks = gpt_bench.make_tokens(batch, seq, cfg.vocab, 0, dev)
            prof = gpt_bench.profile(model, toks)
            rec["profile"] = prof
            log(f"  mesh {mesh} profiler: card busy "
                f"{prof['busy_ms_per_step']:.2f} of "
                f"{prof['wall_ms_per_step']:.2f} ms per step "
                f"({prof['busy_share']:.3f}), by group "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            prof["ms_per_step_by_group"].items()))
        del model
        toks = gpt_bench.make_tokens(batch, seq, cfg.vocab, 0, dev)
        routes = gpt_bench.route_check(cfg, mesh, toks, device=dev)
        rec["route_check"] = routes
        log(f"  mesh {mesh} kernel route vs plain route, one step: loss "
            f"{routes['loss_kernel']:.6f} vs {routes['loss_plain']:.6f} "
            f"({routes['loss_rel']:.2e}); worst field gradient "
            f"{routes['worst_grad']:.3e}, update {routes['worst_update']:.3e}"
            f" in relative L2 (gpt_step.ROUTE_TOL {tol})")
        if not routes["within"]:
            fail(f"path (f) {mesh}: kernel route against plain route "
                 f"{routes}")
        runs.append(rec)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if not on_card:
        return runs, totals, None

    # kernels 5, 6 and 7 per launch at each mesh's attention shapes: B8 x
    # 12 heads of T1024 at (1, 1, 1); the two ring steps of 192 rows
    # (2 x 2 ranks, B8 x 6 heads) of T512 at (1, 2, 2)
    launches = {mesh: path_f_launches(dev, cfg, batch, seq, mesh, 2 + i,
                                      20 if mesh == (1, 1, 1) else 5,
                                      2 if mesh == (1, 1, 1) else 1)
                for i, mesh in enumerate(gpt_bench.MESHES)}
    shape = (batch, seq, cfg.n_heads, cfg.d_model // cfg.n_heads)
    fwd_ms, fwd_bwd_ms = sdpa_ms(
        ring_bench.make_qkv(shape, torch.bfloat16, dev, seed=2),
        ring_bench.make_qkv(shape, torch.bfloat16, dev, seed=3)[0])
    log(f"  scaled_dot_product_attention(is_causal=True) at the (1, 1, 1) "
        f"step's attention {shape}: forward {fwd_ms:.4f} ms, its backward "
        f"{fwd_bwd_ms - fwd_ms:.4f} ms")
    return runs, totals, dict(launches=launches, sdpa_fwd_ms=fwd_ms,
                              sdpa_bwd_ms=fwd_bwd_ms - fwd_ms)


def quant_frame_bytes(n):
    """Bytes kernel 4 must move for n elements: each f32 read once, the
    frame (codes and block scales) written once."""
    return 4 * n + quantized.quant_packed_bytes(n)


def check_quant_pack(dev, on_card):
    """Phase 23: kernel 4 against quant_pack_plain, bit for bit, at the
    codec's edge cases, and the same frames against the transport's codec;
    its time per launch at path (g)'s payloads.  Returns the number of
    inputs, the largest difference of a frame's bytes (as integers) from
    either reference, and the times."""
    cases = 0
    worst = 0.0
    lengths = QUANT_LENGTHS if on_card else QUANT_LENGTHS[:6]
    for n in lengths:
        if n == 0:
            before = dict(quantized.LAUNCHES)
            if quantized.quant_pack(torch.zeros(0, device=dev)).numel() != 0 \
                    or quantized.LAUNCHES != before:
                fail("kernel 4: an empty input must give an empty frame "
                     "and launch nothing")
            cases += 1
            continue
        for name, x in quantized.check_inputs(n).items():
            t = torch.from_numpy(x).to(dev)
            got = quantized.quant_pack(t)
            ref = quantized.quant_pack_plain(t)
            native = torch.from_numpy(bridge.quant_pack(x)).to(dev)
            worst = max(worst, abs_diff(got, ref), abs_diff(got, native))
            if not bits_equal(got, ref):
                fail(f"kernel 4, {name} n={n}: differs from quant_pack_plain "
                     f"in {int((got != ref).sum())} bytes")
            if not bits_equal(got, native):
                fail(f"kernel 4, {name} n={n}: differs from the transport's "
                     "codec (tpucomm_quant_pack)")
            cases += 1
    x = torch.from_numpy(quantized.check_inputs(70001)["normal"]).to(dev)
    got, ref = quantized.quant_pack(x[1:]), quantized.quant_pack_plain(x[1:])
    worst = max(worst, abs_diff(got, ref))
    if not bits_equal(got, ref):
        fail("kernel 4 on an input 4 bytes past a 16-byte boundary differs "
             "from quant_pack_plain")
    sync(dev)
    log(f"  {cases + 1} inputs: kernel 4 equals quant_pack_plain and the "
        "transport's codec bit for bit")
    times = {}
    # 64 MiB written between launches evicts the 50 MB L2, so each launch
    # reads its input from device memory, as the bound assumes
    flush = torch.empty(16 * 1024 * 1024, device=dev) if on_card else None

    def group(name):
        return "kernel 4" if "quant_pack_kernel" in name else "other"

    for nbytes in QUANT_TIMED if on_card else ():
        n = nbytes // 4
        x = random_tensor((n,), torch.float32, dev, 23)
        # a call's time from CUDA events: the wrapper's host work sets it
        # while the kernel is shorter
        call_ms = time_ms(lambda: quantized.quant_pack(x), 50)
        # the kernel's own time on the card, from the profiler, over the
        # launches it recorded (it may miss some)
        _, warm, warm_n = kernel_ms_by_group(
            lambda: quantized.quant_pack(x), 20, group, dev,
            expect=("kernel 4",))
        _, cold, cold_n = kernel_ms_by_group(
            lambda: (flush.zero_(), quantized.quant_pack(x)), 20, group, dev,
            expect=("kernel 4",))
        ms = cold["kernel 4"] / cold_n["kernel 4"]
        warm_ms = warm["kernel 4"] / warm_n["kernel 4"]
        recorded = [round(k["kernel 4"] * 20) for k in (cold_n, warm_n)]
        plain_ms = time_ms(lambda: quantized.quant_pack_plain(x), 10)
        bound = quant_frame_bytes(n) / HBM_BYTES_PER_S * 1e3
        times[nbytes] = dict(ms=ms, warm_l2_ms=warm_ms, call_ms=call_ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bytes=quant_frame_bytes(n),
                             profiled_launches=recorded)
        log(f"  kernel 4, {nbytes} B per rank: {ms:.4f} ms on the card "
            f"from device memory ({warm_ms:.4f} ms with its input in L2; "
            f"the profiler recorded {recorded[0]} and {recorded[1]} of 20 "
            f"launches; {call_ms:.4f} ms per call by CUDA events), bound "
            f"{bound:.4f} ms (bytes: {quant_frame_bytes(n)} B), "
            f"{bound / ms:.3f} of it; plain {plain_ms:.4f} ms")
    return cases + 1, worst, times


def path_g(dev, on_card):
    """Phase 24: path (g), 4 ranks on 'r0,r1|r2,r3' through the port's
    launcher, the leg forced, exact and quantized.  Every rank holds its
    result to the simulators bit for bit and the ranks agree (the ranks'
    program, ``benchmarks/ici_leg.py``, fails the job otherwise); here the
    launches of kernels 3 and 4 per call are checked, and the timed
    payloads beside the native hierarchical ring with the leg off."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    counts = G_COUNTS if on_card else G_COUNTS[:3]
    sizes = G_SIZES if on_card else (64 * 1024,)
    jobs = {}
    for label in ("hring+ici", "hring+q+ici"):
        quant = "+q" in label
        t0 = time.perf_counter()
        rec = ici_leg.run_job(label, device=str(dev), algos=("hring", "htree"),
                              check_counts=counts, sizes=sizes,
                              calls=G_CALLS, beside=True, timeout=300)
        secs = time.perf_counter() - t0
        want = {"fused_ring": int(on_card), "quant_pack": int(on_card and quant)}
        if not rec["leg"] or rec["quant"] is not quant:
            fail(f"path (g) {label}: the leg was not active as asked")
        for c in rec["checks"]:
            if c["launches"] != want:
                fail(f"path (g) {label} {c['algo']} count={c['count']}: "
                     f"launched {c['launches']} per call, expected {want}")
            if c["check"] != "bits":
                fail(f"path (g) {label}: not held bit for bit")
        for r in rec["records"]:
            if r["launches_per_call"] != want:
                fail(f"path (g) {label} {r['bytes']} B: launched "
                     f"{r['launches_per_call']} per call, expected {want}")
            log(f"  {label}, {r['bytes']} B per rank: {r['ms']:.3f} ms per "
                f"call ({r['eff_GBps']:.3f} GB/s), leg off "
                f"{r['leg_off_ms']:.3f} ms; phases (ms): " + ", ".join(
                    f"{k} {v:.3f}" for k, v in r["phases_ms"].items()))
        worst = max(c["rel_err"] for c in rec["checks"])
        log(f"  {label}: {len(rec['checks'])} checks bit for bit on every "
            f"rank (worst {worst:.3e} of the exact sum), job {secs:.1f} s, "
            f"kernel launches {rec['launches']}, contexts "
            f"{max(rec['ctx_seconds']):.2f} s, comm "
            f"{max(rec['comm_seconds']):.2f} s, tiers {rec['tiers']}")
        rec["job_seconds"] = secs
        jobs[label] = rec
    return jobs


def check_kernel(shape, dev, fuses):
    """The kernel against its plain version at one shape, at the solver's
    parameters and at the stiff viscosity."""
    worst_abs = worst_rel = 0.0
    for params in (sw.SWParams(dx=5e3, dy=5e3),
                   chk.StiffParams(dx=5e3, dy=5e3)):
        for s, first, fuse in chk.cases(shape, params, dev, fuses):
            got = kernel.fused_step(s, params, first=first, fuse=fuse)
            sync(dev)
            ref = kernel.fused_step_plain(s, params, first=first, fuse=fuse)
            tag = (f"{type(params).__name__} "
                   + ("first" if first else f"fuse={fuse}"))
            a, r = compare(got, ref, s, f"{shape} {tag}")
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    return worst_abs, worst_rel


def main_path(shape, dev, fuse, reps, on_card):
    """0.1 model day through step_fn at one fuse; returns the launches,
    the median seconds of the timed region, the final state, the state
    after the Euler step and the model."""
    model = sw.ShallowWater(shape, device=dev)
    n_steps = int(DAYS * model.params.day_seconds / model.params.dt)
    first = model.step_fn(1, first=True, fuse=fuse)
    run = model.step_fn(n_steps - 1, fuse=fuse)
    s0 = model.init()
    run(first(s0))  # warm-up
    sync(dev)

    reset_counts()
    state1 = first(s0)
    t0 = time.perf_counter()
    state = run(state1)
    sync(dev)
    times = [time.perf_counter() - t0]
    launches = kernel.LAUNCHES
    if on_card:
        expect = 1 + (n_steps - 1) // fuse + (n_steps - 1) % fuse
        if launches != expect:
            fail(f"fuse={fuse}: {launches} kernel launches, expected {expect}")
    for _ in range(reps - 1):
        t0 = time.perf_counter()
        state = run(state1)
        sync(dev)
        times.append(time.perf_counter() - t0)

    h = model.interior(state.h)
    if h.shape != shape or not bool(torch.isfinite(state.h).all()):
        fail(f"fuse={fuse}: h is not finite with shape {shape}")
    m0, m1 = model.total_mass(s0), model.total_mass(state)
    drift = abs(m1 - m0) / abs(m0)
    if not drift < 1e-5:
        fail(f"fuse={fuse}: mass drifted by {drift:.3e}")
    secs = statistics.median(times)
    timed = n_steps - 1
    log(f"  fuse={fuse}: {launches} launches; {timed} timed steps in "
        f"{secs:.4f} s median of {len(times)} "
        f"({[round(t, 4) for t in times]}), {secs / timed * 1e3:.4f} ms/step, "
        f"{timed / secs:.1f} steps/s; mass drift {drift:.2e}; "
        f"h in [{h.min():.3f}, {h.max():.3f}]")
    return launches, secs, state, state1, model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="phases 2-4, 7-10, 12, 13, 15-17, 19-21, 23 and 24 "
                         "on the "
                         "CPU, plain versions, small size; prints no result "
                         "line")
    args = ap.parse_args(argv)

    on_card = not args.rehearse
    if on_card and not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    if on_card:
        dev = torch.device("cuda", 0)
        shape, reps = SHAPE, 5
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        log(f"card: {card}")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as pool:
            transport = pool.submit(timed_build)
            build_secs = _build.build_all(KERNELS)
            build_secs["transport"] = transport.result()
        log(f"build: {len(KERNELS)} sources and the transport in parallel in "
            f"{time.perf_counter() - t0:.2f} s")
        log_build("sw_step", build_secs)
        log_sw_registers()
    else:
        dev = torch.device("cpu")
        shape, reps = (64, 128), 1
        card = kind = "cpu (rehearsal)"
        build_secs = {}

    log(f"phase 2: kernel vs plain at {shape}")
    max_abs, max_rel = check_kernel(shape, dev, (1, 2, 3))
    log("phase 3: kernel vs plain at the edge shapes")
    for es in EDGE_SHAPES:
        a, r = check_kernel(es, dev, (1, 2, 3))
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
    log(f"  worst: {max_abs:.3e} abs, {max_rel:.3e} of the scale "
        f"(tolerance {chk.CHECK_TOL})")

    log(f"phase 4: main path, {DAYS} day at {shape} [{card}]")
    launches, secs3, state3, state1, model = main_path(
        shape, dev, 3, reps, on_card)
    _, secs1, _, _, _ = main_path(shape, dev, 1, reps, on_card)
    n_timed = int(DAYS * model.params.day_seconds / model.params.dt) - 1
    plain = model.step_fn(n_timed, impl="plain")
    t0 = time.perf_counter()
    ref = plain(state1)
    sync(dev)
    plain_secs = time.perf_counter() - t0
    dh = (state3.h - ref.h).abs().max().item()
    log(f"  plain path (test oracle): {plain_secs:.4f} s, "
        f"{plain_secs / n_timed * 1e3:.4f} ms/step; "
        f"max |h_kernel - h_plain| after {DAYS} day: {dh:.3e}")
    if not dh < 1e-2:
        fail(f"kernel and plain paths differ by {dh:.3e} in h after {DAYS} day")

    h_1x1 = model.interior(state3.h)

    if on_card:
        sw_row = phase5(shape, state1, model, card, launches, max_abs,
                        max_rel, secs3, secs1, plain_secs)
        log("phase 6: build of the hop and fused-ring kernels")
        for name in ("hop", "fused_ring"):
            log_build(name, build_secs)

    log(f"phase 7: hop kernel vs hop_plain [{card}]")
    hop_worst = check_hop(dev)
    log(f"phase 8: fused ring vs fused_ring_allreduce_plain [{card}]")
    ring_worst = check_ring(dev, on_card)
    ring_t = time_ring(dev) if on_card else None
    # path (g)'s island fold: m = 2 rows of its timed payloads
    ring_g = {b: time_ring(dev, n=2, count=b // 4) for b in G_SIZES} \
        if on_card else None

    max_bytes = SWEEP_MAX_BYTES if on_card else 1024 * 1024
    log(f"phase 9: path (b), the allreduce sweep to {max_bytes} B per rank "
        f"[{card}]")
    recs, b_launches = path_b(dev, max_bytes, on_card, card)

    log(f"phase 10: path (a), the {GRID[0]}x{GRID[1]} solver, {DAYS} day at "
        f"{shape} [{card}]")
    a = path_a(shape, dev, h_1x1, on_card, reps)
    hop_t = time_hop(dev, a["model"]) if on_card else None

    if on_card:
        log("phase 11: build of the alltoall kernel")
        log_build("alltoall", build_secs)
    log(f"phase 12: alltoall kernel vs alltoall_plain [{card}]")
    a2a_worst = check_alltoall(dev, on_card)
    size = SPECTRAL_N if on_card else 32
    a2a_t = time_alltoall(dev) if on_card else None
    log(f"phase 13: path (c), the {size}^3 spectral Poisson solve at n = "
        f"{', '.join(map(str, SPECTRAL_RANKS))} [{card}]")
    c_rows, c_launches = path_c(dev, size, on_card, card)

    if on_card:
        log("phase 14: build of kernel 5, the flash forward")
        log_build("flash_fwd", build_secs)
        log_registers("flash_fwd")
    log(f"phase 15: kernel 5 vs flash_fwd_block_plain at the edge shapes "
        f"[{card}]")
    flash_worst, flash_cases = check_flash(dev, on_card)
    log(f"phase 16: the hop past 64 (rank, payload) pairs [{card}]")
    check_big_hops(dev, on_card)
    log(f"phase 17: path (d), ring attention's forward at "
        f"{FLASH_SHAPE if on_card else (1, 64, 2, 16)} bf16 causal, n = "
        f"{', '.join(map(str, FLASH_RANKS))} [{card}]")
    d_runs, d_launches, d_times = path_d(dev, on_card, card)
    if on_card:
        log("phase 18: build of kernels 6 and 7, the flash backward")
        log(f"  csrc/flash_bwd.cu: {build_secs['flash_bwd']:.2f} s")
        log_registers("flash_bwd")
    log(f"phase 19: kernels 6 and 7 vs flash_bwd_block_plain at the edge "
        f"cases [{card}]")
    bwd_worst, bwd_cases = check_flash_bwd(dev, on_card)
    log(f"phase 20: path (e), ring attention's forward and backward at "
        f"{FLASH_SHAPE if on_card else (1, 64, 2, 16)} bf16 causal, n = "
        f"{', '.join(map(str, FLASH_RANKS))} [{card}]")
    e_runs, e_launches, e_times = path_e(dev, on_card, card)
    log(f"phase 21: path (f), the GPT-2 124M train step at "
        f"{', '.join(map(str, gpt_bench.MESHES))} [{card}]")
    f_runs, f_launches, f_times = path_f(dev, on_card, card)
    if on_card:
        log("phase 22: build of kernel 4 and of the transport")
        log_build("quant_pack", build_secs)
        log(f"  native/tpucomm.cc (g++, transport only): "
            f"{build_secs['transport']:.2f} s")
    else:
        log(f"phase 22: build of the transport: {timed_build():.2f} s")
    log(f"phase 23: kernel 4 vs quant_pack_plain and the transport's codec "
        f"[{card}]")
    q_cases, q_worst, q_times = check_quant_pack(dev, on_card)
    log(f"phase 24: path (g), the hierarchical allreduce of 4 ranks on "
        f"{ici_leg.FAKE_HOSTS} with the leg on the card [{card}]")
    g_jobs = path_g(dev, on_card)
    log(f"profiler sessions run again (no kernel to time): {len(RERUNS)} "
        f"{RERUNS}")
    if not on_card:
        log("rehearsal done (no result line: not a chip run)")
        return 0

    hop_row = {
        "name": "hop", "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/hop.cu",
        "replaces": "mpi4jax_tpu/ops/pallas_collectives.py:74",
        "launches": a["launches"]["hop"], "max_abs_err": hop_worst,
        "ok": True, "ms": hop_t["y"]["ms"],
        "device_ms": hop_t["y"]["device_ms"],
        "plain_ms": hop_t["y"]["plain_ms"],
        "bound_ms": hop_t["y"]["bound_ms"], "bound_by": "bytes",
        "library_ms": hop_t["y"]["library_ms"],
        "library": "torch.roll pair (no single call shifts two ways)",
        "at": "ring_shift2 of the y strips of path (a)",
        "payload_bytes": hop_t["y"]["payload_bytes"],
        "x_strips": hop_t["x"], "hops_per_step": a["hops_per_step"],
        "launches_path_b": b_launches["hop"],
        "day_seconds_2x2": a["secs"], "halo_share": a["halo_share"],
        "h_vs_1x1": a["d1x1"], "card": card,
    }
    ring_row = {
        "name": "fused_ring", "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/fused_ring.cu",
        "replaces": "mpi4jax_tpu/ops/pallas_collectives.py:660",
        "launches": b_launches["fused_ring"], "max_abs_err": ring_worst,
        "ok": True, "ms": ring_t["ms"], "plain_ms": ring_t["plain_ms"],
        "bound_ms": ring_t["bound_ms"], "bound_by": "bytes",
        "library_ms": ring_t["library_ms"], "library": "x.sum(0) (one row)",
        "library_n_rows_ms": ring_t["library_n_rows_ms"],
        "library_n_rows": "x.sum(0, keepdim=True).expand_as(x).contiguous()",
        "at": "n=4, 16 MiB per rank",
        "path_g_island_fold": {f"n=2, {b} B per rank": t
                               for b, t in ring_g.items()},
        "sweep": [{k: r[k] for k in ("ranks", "bytes", "us", "arm",
                                     "eff_GBps_per_chip", "bound_us",
                                     "sum0_us")} for r in recs],
        "card": card,
    }
    a2a_row = {
        "name": "alltoall", "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/alltoall.cu",
        "replaces": "mpi4jax_tpu/ops/pallas_collectives.py:499",
        "launches": c_launches, "max_abs_err": a2a_worst, "ok": True,
        "ms": a2a_t["ms"], "plain_ms": a2a_t["plain_ms"],
        "bound_ms": a2a_t["bound_ms"], "bound_by": "bytes",
        "library_ms": a2a_t["library_ms"],
        "library": "x.transpose(0, 1).contiguous()",
        "variant": "8 KiB chunks a block, two 16-byte loads a thread in "
                   "flight (benchmarks/kernel_variants.py)",
        "at": f"{SPECTRAL_N}^3 complex64 x-to-y transpose, n=4",
        "payload_bytes": a2a_t["payload_bytes"],
        "tiny_call_us": a2a_t["tiny_call_us"], "path_c": c_rows,
        "card": card,
    }
    whole = d_times["steps"][1][0]
    flash_row = {
        "name": "flash_fwd", "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mpi4jax_tpu/ops/flash.py:112",
        "launches": d_launches,
        "max_abs_err": max(r["errors"]["max_abs_err"]
                           for rows in d_times["steps"].values()
                           for r in rows),
        "o_error_of_noise": max(r["errors"]["o"]
                                for rows in d_times["steps"].values()
                                for r in rows),
        "ok": True, "ms": whole["ms"], "plain_ms": whole["plain_ms"],
        "bound_ms": whole["bound_ms"], "bound_by": whole["bound_by"],
        "library_ms": d_times["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention"
                   "(is_causal=True)",
        "at": f"B{FLASH_SHAPE[0]} T{FLASH_SHAPE[1]} H{FLASH_SHAPE[2]} "
              f"D{FLASH_SHAPE[3]} bf16 causal, n=1 (one launch per forward)",
        "steps_n4": [{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "op_ms", "mem_ms")}
                     for r in d_times["steps"][4]],
        "edge_cases": flash_cases, "edge_worst": flash_worst,
        "path_d": d_runs, "launches_path_e": e_launches["flash_fwd"],
        "launches_path_f": f_launches["flash_fwd"],
        "path_f_launches": path_f_rows(f_times, "fwd"), "card": card,
    }
    bwd_rows = []
    for kern, name, line in ((6, "flash_bwd_dq", 245),
                             (7, "flash_bwd_dkv", 276)):
        whole = e_times["steps"][1][0][kern]
        bwd_rows.append({
            "name": name, "route": "cuda",
            "source": "mpi4jax_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"mpi4jax_tpu/ops/flash.py:{line}",
            "launches": f_launches[name],
            "max_abs_err": max(r["errors"]["max_abs_err"]
                               for rows in e_times["steps"].values()
                               for r in rows),
            "grad_error_of_noise": max(
                max(r["errors"][g] for g in ("dq", "dk", "dv"))
                for rows in e_times["steps"].values() for r in rows),
            "ok": True, "ms": whole["ms"], "plain_ms": whole["plain_ms"],
            "bound_ms": whole["bound_ms"], "bound_by": whole["bound_by"],
            "library_ms": e_times["library_ms"],
            "library": "the backward of torch.nn.functional."
                       "scaled_dot_product_attention(is_causal=True) (dq, dk "
                       "and dv together: forward+backward minus forward)",
            "at": f"B{FLASH_SHAPE[0]} T{FLASH_SHAPE[1]} H{FLASH_SHAPE[2]} "
                  f"D{FLASH_SHAPE[3]} bf16 causal, n=1 (one launch per "
                  "backward)",
            "launches_path_e": e_launches[name],
            "steps_n4": [{k: r[kern][k] for k in ("ms", "bound_ms",
                                                   "bound_by")}
                         for r in e_times["steps"][4]],
            "path_f_launches": path_f_rows(f_times, "bwd", kern),
            "path_f_sdpa_bwd_ms": f_times["sdpa_bwd_ms"],
            "edge_cases": bwd_cases, "edge_worst": bwd_worst,
            "card": card,
        })
    bwd_rows[0]["path_e"] = e_runs
    bwd_rows[0]["path_f"] = f_runs
    ring_row["launches_path_g"] = sum(
        rec["launches"]["fused_ring"] for rec in g_jobs.values())
    t16, t64 = q_times[QUANT_TIMED[0]], q_times[QUANT_TIMED[1]]
    quant_row = {
        "name": "quant_pack", "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/quant_pack.cu",
        "replaces": "mpi4jax_tpu/ops/pallas_collectives.py:862",
        "launches": g_jobs["hring+q+ici"]["launches"]["quant_pack"],
        "max_abs_err": q_worst, "ok": True, "ms": t16["ms"],
        "warm_l2_ms": t16["warm_l2_ms"], "call_ms": t16["call_ms"],
        "plain_ms": t16["plain_ms"], "bound_ms": t16["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "library": "none: no single PyTorch call produces the "
                   "per-256-block frame",
        "at": "16 MiB per rank (4Mi f32), path (g)'s island sum",
        "bytes": t16["bytes"], "at_64MiB": t64, "edge_cases": q_cases,
        "path_g": {label: {k: rec[k] for k in (
            "leg", "quant", "tiers", "launches", "ctx_seconds",
            "comm_seconds", "job_seconds", "records")}
            for label, rec in g_jobs.items()},
        "card": card,
    }
    log(f"card: {card}")
    print(json.dumps({"kernels": [sw_row, hop_row, ring_row, a2a_row,
                                  flash_row, *bwd_rows, quant_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase5(shape, state1, model, card, launches, max_abs, max_rel, secs3,
           secs1, plain_secs):
    """Phase 5: the fused step's time per launch; returns its kernels row."""
    log(f"phase 5: kernel time per launch at {shape} [{card}]")
    s = state1
    bufs = [sw.SWState(*(torch.empty_like(f) for f in s)) for _ in range(2)]
    p = model.params

    def launch_ms(fuse):
        flip = [0]

        def one():
            src = s if flip[0] == 0 else bufs[flip[0] % 2]
            flip[0] += 1
            kernel.fused_step(src, p, first=False, fuse=fuse,
                              out=bufs[flip[0] % 2])
        return time_ms(one, 50)

    nyp, nxp = s.h.shape
    cells = nyp * nxp
    bytes_moved = 12 * cells * 4
    rows = {}
    for fuse in (3, 2, 1):
        ms = launch_ms(fuse)
        plain_ms = time_ms(
            lambda: kernel.fused_step_plain(s, p, first=False, fuse=fuse), 5)
        mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        op_ms = FLOPS_PER_CELL_STEP * fuse * cells / F32_FLOPS_PER_S * 1e3
        bound_ms = max(mem_ms, op_ms)
        blocks = kernel.blocks_per_sm((nyp, nxp), fuse)
        smem = kernel.smem_bytes(kernel.DEFAULT_TILE, fuse)
        rows[fuse] = dict(ms=ms, ms_per_step=ms / fuse, plain_ms=plain_ms,
                          bound_ms=bound_ms, blocks_per_sm=blocks,
                          bound_by="bytes" if mem_ms >= op_ms else "operations")
        log(f"  fuse={fuse}: {ms:.4f} ms/launch ({ms / fuse:.4f} ms/step), "
            f"bound {bound_ms:.4f} ms ({rows[fuse]['bound_by']}: "
            f"{mem_ms:.4f} ms bytes, {op_ms:.4f} ms flops), "
            f"{bound_ms / ms:.3f} of the bound; {blocks} blocks per SM "
            f"(tile {kernel.DEFAULT_TILE}, {smem} B); plain {plain_ms:.4f} ms")
    best = min(rows, key=lambda f: rows[f]["ms_per_step"])
    log(f"  fastest per step: fuse={best} (ms per step: " + ", ".join(
        f"fuse={f} {r['ms_per_step']:.4f}" for f, r in rows.items()) + ")")

    row = {
        "name": "sw_fused_step", "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/sw_step.cu",
        "replaces": "mpi4jax_tpu/models/_sw_pallas.py:82",
        "launches": launches, "max_abs_err": max_abs,
        "err_over_scale": max_rel, "tolerance": chk.CHECK_TOL, "ok": True,
        "ms": rows[3]["ms"], "plain_ms": rows[3]["plain_ms"],
        "bound_ms": rows[3]["bound_ms"], "bound_by": rows[3]["bound_by"],
        "library_ms": None, "fuse": 3, "tile": list(kernel.DEFAULT_TILE),
        "blocks_per_sm": rows[3]["blocks_per_sm"],
        "ms_fuse2": rows[2]["ms"], "plain_ms_fuse2": rows[2]["plain_ms"],
        "ms_fuse1": rows[1]["ms"], "plain_ms_fuse1": rows[1]["plain_ms"],
        "bound_ms_fuse1": rows[1]["bound_ms"], "shape": list(shape),
        "day_seconds_fuse3": secs3, "day_seconds_fuse1": secs1,
        "plain_day_seconds": plain_secs, "card": card,
    }
    return row


if __name__ == "__main__":
    sys.exit(main())
