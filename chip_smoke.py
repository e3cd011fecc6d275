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
   phase split, beside the native ``hring`` with the leg off;
25. path (h): the data-parallel ResNet-50 step
   (``mpi4jax_tpu_torch.benchmarks.resnet_step``: bf16, 224x224, a global
   batch of 32, SGD) at n = 1 and 4 ranks, one warm-up step then 20
   timed one by one (the median and the spread: the step is bound by the
   host), the counters reset just before each run and read just after:
   one allreduce per leaf and the loss's ``pmean``, each on the launches
   its arm gives, and at n = 4 the 208 hops and 52 fused-ring launches a
   step counted from ResNet-50's leaves; finite losses; the profiler's
   groups; one step on the kernel route bit for bit against one on the
   plain route (``cudnn.deterministic``);
26. path (i): the pipeline-parallel GPT-2 124M step
   (``benchmarks.pp_step``: f32, 4 microbatches of B2 T1024, SGD) at pp =
   1 and 4, with 3 timed steps: at pp = 4 seven hops in the forward and
   six in the backward (autograd runs no reverse hop for the last tick),
   and the loss's and the replicated fields' allreduces, 19 hops and 2
   fused-ring launches a step; the peak memory; the kernel route bit for
   bit against the plain route;
27. path (j): the alltoall family at n = 4 (``benchmarks.alltoall_family``):
   Ulysses attention at B4 T4096 H16 D128 bf16 causal (4 alltoall launches
   forward, 8 forward and backward), ``moe_ffn`` at d_model 768, d_ff
   3072, 4 experts, 8192 f32 tokens a rank (4 launches forward and
   backward), and ``allreduce(compression="int8")`` at 16 and 64 MiB per
   rank (one alltoall and 3 hops a call) beside the exact allreduce, with
   its errors within the JAX package's test criteria; each bit for bit
   against the plain route and timed;
28. the world tier's ops (``mpi4jax_tpu_torch.benchmarks.world_ops``), 4
   ranks on the card through ``runtime.launch -n 4 --fake-hosts
   'r0,r1|r2,r3'`` (one process each; CUDA tensors staged through pinned
   host memory): every op of the dtype sweep (f32, f64, f16, bf16,
   complex64, int32, int64, uint8, bool) with every reduce op it admits,
   the reductions and an allgather in the other six wire dtypes,
   the f32 SUM under the default table's pick and forced ring, rd, tree,
   hring and htree bit for bit against ``topo/_simulate.py`` (with
   ``MPI4JAX_TPU_ICI_LEG=off``: the transport's own hierarchical
   schedules; phase 24's path (g) holds the intra-island leg), int8 on
   qring and qrd bit for bit against their simulators and on the Python
   schedule against its oracle, status, wildcards, walls and self-wrap,
   the gradients and the refusals, split and dup, and an allreduce and a
   ``neighbor_exchange`` queued right behind a long matrix product on the
   same stream, each rank against its oracles;
29. path (k): the world-tier solver (``benchmarks.sw_world``,
   ``WorldShallowWater``) on a 2x2 grid of world ranks, one process each
   on the one card, at 1800x3600 for 0.1 model day (the Euler step, a
   warm-up, then 431 timed steps, each rank's stream synchronized): s per
   0.1 day, the share of a step inside ``neighbor_exchange`` (staging and
   transport; the median over 20 instrumented steps), and rank 0's
   gathered h, u and v within
   ``_sw_check.CHECK_TOL`` of each field's scale from path (a)'s plain
   route (phase 10), and whether bit for bit;
30. path (l): the tuner (``python -m mpi4jax_tpu_torch.tune --np 4``,
   allreduce and alltoall at 1 KiB to 16 MiB) writes a cache, and the world
   MoE job runs under it (``runtime.launch -n 4 --fake-hosts 'r0,r1|r2,r3'
   --trace``, ``benchmarks.moe_world``, ``MPI4JAX_TPU_DISABLE_SHM=1``):
   ``moe_ffn`` forward at d_model 768, d_ff 3072, 4 experts, 8192 f32
   tokens a rank on the routes auto, int8, halltoall and hqalltoall against
   the exact route, the alltoall alone on the (4, 2560, 768) dispatch
   buffer under ring, qalltoall, halltoall and hqalltoall bit for bit
   against ``topo/_simulate.py``, two 16 MiB f32 ``hring`` allreduces on
   the intra-island leg (kernel 3, and kernel 4 under
   ``MPI4JAX_TPU_COLL_QUANT=force``), the recorder's cost, each timed;
   then the merged trace validates, ``profile report --json`` holds the
   four alltoall schedules and the ``ici`` allreduce with nothing dropped,
   and ``tune --from-trace`` gives a cache that loads.  The job's launch
   carries ``--verify`` (path (n2)): the static verifier runs the program
   in its virtual world first, with the ranks' environment, and the
   launcher must say it is clean at np=4;
31. path (m): (m1) the joint tuner (``python -m mpi4jax_tpu_torch.tune
   --joint --np 4 --topk 3`` on ``r0,r1|r2,r3``, allreduce, allgather and
   alltoall from 1 KiB to 16 MiB) writes a v2 cache and a cost-model file,
   with kernels 3 and 4 launched in its ``+ici`` sub-jobs (their counts
   summed over the sub-jobs' ranks); the winners per op and band, each
   (op, combo)'s fitted alpha and beta and each sub-job's seconds; then
   path (g)'s f32 SUM allreduce with ``algo=None`` under that cache (the
   picked combo's gates set) at 16 and 64 MiB a rank: the schedule that
   runs is the cache's pick for its band, an exact pick bit for bit its
   simulator on every rank, a quantized one within 5e-2 of the exact sum;
   (m2) the 1x1 solver of phase 4 at fuse=3, saved with
   ``checkpoint.save_sharded`` at the midpoint of its timed steps, restored
   into a freshly built model and finished, bit for bit the uninterrupted
   run with the same launches of kernel 8; path (f)'s GPT-2 124M train
   state after one step (f32 master parameters, their bf16 compute copies,
   the AdamW state) through ``checkpoint.save``/``restore`` on the card,
   byte for byte, with the MB written and the seconds to write and read;
   (m3) ``compat.token_api``'s allreduce, sendrecv(shift=1), barrier and
   allgather chained on a 4-rank mesh comm at 16 MiB f32 a rank, each
   result bit for bit the tokenless call's, with the tokenless chain's
   launches of kernels 1 and 3; the phase's seconds;
32. path (n), the static communication verifier on the card (every rank
   thread's tensors on ``cuda``; every world op served on the host): (n1)
   ``python -m mpi4jax_tpu_torch.analyze -m
   mpi4jax_tpu_torch.benchmarks.moe_world --np 4 --json --schedules`` with
   phase 30's arguments, tune cache and islands must report clean, and
   each rank's world ops (kind and bytes) must equal what phase 30's
   transport ran: the ops before the recorder's last restart, which the
   trace cannot hold (``unrecorded_ops``), then that rank's top-level ops
   in the merged trace; (n3) the analyzer on path (k)'s program
   (``benchmarks.sw_world --grid 2 2``) at 1800x3600 and ``N_DAYS`` model
   days (0.05, half of path (k)'s, for the script's time limit) must
   report clean with halo exchanges on every rank; (n4)
   ``launch -n 2 --verify tests/torch_world_programs/tag_mismatch.py``
   must exit 3, name the ``tag_mismatch`` finding and start no rank; (n3)
   and (n4) run beside (n1); the seconds and events per rank of each;
33. path (o), plan execution (``runtime/planrt.py``): (o1) ``runtime.launch
   -n 3 -m mpi4jax_tpu_torch.benchmarks.schedule_overlap`` at the JAX
   benchmark's defaults (15 rounds of 4096 KB f32 blocks on ``cuda:0``
   down a chain of ranks, a 3 ms idle window, then 64 gradients of 8 KB
   per leaf and in 512 KB buckets), the plan off and then on, the shm arena
   off: every received block equal to its numpy oracle, each rank's digest
   equal on and off, the runner's hoisted receives and deferred sends above
   0 and no mismatch; us per round on and off, the bucketed and per-leaf
   seconds; (o2) ``launch -n 3 --plan false_serialization.py``: the
   launcher's ``--plan: verified plan``, digests equal to a
   ``MPI4JAX_TPU_PLAN=0`` run's; (o3) ``bucketed_dp_grad.py`` at np 2 under
   the plan ``analyze --emit-plan`` gives for it: ``bucketed_dp_grad OK`` on
   both ranks;
34. path (p), live re-tuning (``live/``): (p1) ``runtime.launch -n 4
   --fake-hosts 'r0,r1|r2,r3' --live -m
   mpi4jax_tpu_torch.benchmarks.live_world``: 30 f32 SUM allreduces of
   16 MiB a rank on ``cuda:0`` under a tune cache pinned to ``ring``; after
   call 10 rank 0 proposes ``hring``; every rank reports epoch 1 and one
   swap committed at the same boundary, each call before the commit bit for
   bit ``simulate_ring_sum`` and each after it bit for bit the leg's
   ``simulate_hring_sum`` on every rank, kernel 3 launched 0 times before
   the commit and once per rank per call after it; (p2) the same job
   without ``--live``: epoch 0, no swap, no boundary hook, every call
   ``ring``; ms per call before the proposal, in (p2) and after the swap;
35. path (q), elastic worlds (``elastic/``, ``bridge.rebuild``, ``launch
   --elastic``), every job's ranks on ``cuda:0``, the shm arena off: (q1)
   ``tests/torch_world_programs/elastic_train.py`` at np 3, 12 steps, a
   commit every 2, uninterrupted and with slot 1 killed by the native fault
   injector under ``shrink`` and under ``respawn``: every finishing rank's
   digest the clean run's, bit for bit, each survivor resumed from a step
   strictly inside the job; (q3) ``launch --plan --elastic`` of
   ``elastic_plan_bundle.py`` at np 3, clean and with slot 1 killed: the
   bundle covers np 3 and 2, the recovery re-proves the np=2 plan on both
   survivors, which end with ``plan_active=1 mismatches=0`` and the clean
   digest; (q2) ``gpt_dp_elastic.py`` at GPT-2's widths cut to 2 of its 12
   layers (vocab 50304, d_model 768, 12 heads of 64, d_ff 3072, T 1024, bf16
   compute, about 54 M parameters), SGD through ``dp.elastic_step_fn``, a
   global batch of 12 made from a seed per step, 8 steps, a commit every 2,
   at np 4 on ``r0,r1|r2,r3`` with every gradient allreduce on ``hring``
   and the leg forced; clean (beside (q1) and (q3)), then alone with slot 1
   killed at the start of step 5 and the job finished on np 3 on the
   islands ``{0,1}|{2}``, step 4 replayed: the final full-batch loss within
   1e-2 relative of the clean run's and the final parameters within 2e-2
   of the clean run's (relative to how far training moved them, at most a
   third of the least step's update), each generation's first step held to the
   plain route (the synced gradient within ``gpt_step.ROUTE_TOL``, kernel
   3's island sums bit for bit its plain version), kernels 5, 6 and 7
   launched by every rank in every step before and after the recovery,
   kernel 3 by the rebuilt island's ranks; the step times and the time
   from the death to the first step of the new generation.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a card the run fails and prints
no result.  ``--rehearse`` runs phases 2-4, 7-10, 12, 13, 15-17, 19-21,
23-35 on the CPU through the plain versions at a small size and prints
no result line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mpi4jax_tpu_torch import _build, obs, ops, tune
from mpi4jax_tpu_torch.benchmarks import allreduce_sweep
from mpi4jax_tpu_torch.benchmarks import alltoall_family as a2a_bench
from mpi4jax_tpu_torch.benchmarks._profile import RERUNS, kernel_ms_by_group
from mpi4jax_tpu_torch.benchmarks import gpt_step as gpt_bench
from mpi4jax_tpu_torch.benchmarks import ici_leg
from mpi4jax_tpu_torch.benchmarks import moe_world
from mpi4jax_tpu_torch.benchmarks import pp_step as pp_bench
from mpi4jax_tpu_torch.benchmarks import resnet_step as resnet_bench
from mpi4jax_tpu_torch.benchmarks import ring_attention as ring_bench
from mpi4jax_tpu_torch.benchmarks import spectral as spectral_bench
from mpi4jax_tpu_torch.benchmarks import sw_world
from mpi4jax_tpu_torch.benchmarks import world_ops
from mpi4jax_tpu_torch.models import _sw_check as chk
from mpi4jax_tpu_torch.models import _sw_kernel as kernel
from mpi4jax_tpu_torch.models import resnet
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
PATH_STEPS = 3  # timed steps of paths (i) and (j), after a warm-up
# launches per step of the full-width paths, counted from the models'
# leaves and schedules by hand (not from the arms that route them)
H_LAUNCHES = {1: {"hop": 0, "fused_ring": 0},
              4: {"hop": 208, "fused_ring": 52}}
I_LAUNCHES = {1: {"hop": 0, "fused_ring": 0},
              4: {"hop": 19, "fused_ring": 2}}
WORLD_RANKS = 4  # phase 28
# phase 30, path (l): the tuner's sweep, then the world MoE job
L_TUNE_SIZES = "1024,65536,1048576,16777216"
L_SMALL = ["--device", "cpu", "--tokens", "64", "--d-model", "16",
           "--d-ff", "32", "--leg-bytes", "65536", "--reps", "3",
           "--small-reps", "10"]
# phase 31, path (m): the payloads a rank of the algo=None allreduce and of
# the token chain (16 MiB), and the rehearsal's sizes
M_SIZES = (16 * 1024 * 1024, 64 * 1024 * 1024)
M_SMALL_SIZES = "1024,65536"
M_SMALL_COUNTS = (256, 16384)
# phase 32, path (n): the verifier's deadline, and path (k)'s model days in
# the virtual world
N_TIMEOUT_S = 900
N_DAYS = DAYS / 2  # (n3)'s depth, cut for the script's time limit
M_SMALL_GPT = gpt.GPTConfig(vocab=256, d_model=32, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=32, dtype="bfloat16")
# phase 33, path (o): the chain at the JAX benchmark's defaults on the card
O_SMALL = ["--device", "cpu", "--rounds", "4", "--block-kb", "512"]
# phase 34, path (p): path (g)'s 16 MiB a rank on the card
P_SMALL_MIB = 1
# phase 35, path (q): the native fault points (sends of slot 1, the shm
# arena off) that land after the first commit and before the last step of
# (q1)'s 12 steps and (q3)'s 10; (q1)'s lands late enough (resumed from
# step 8) that the respawned slot finishes without dying again
Q1_FAULT = "rank=1,point=send,after=30,action=exit"
Q3_FAULT = "rank=1,point=send,after=30,action=exit"
# at step 5, after the commit of step 4: step 4 is replayed on np 3
Q2_KILL = "1:5"
Q2_LOSS_BOUND = 1e-2  # tests/world/test_elastic.py's LOSS_REL_BOUND
# the recovered run's final parameters against the clean run's, the L2 of
# the difference over the L2 of the clean run's movement from the initial
# parameters: about ten times the reassociation noise of bf16 compute
# (2.4e-3 at the small width on the CPU, np 4 shrinking to 3); the least
# step's update over that movement (what a lost or repeated step adds)
# must exceed it 3 times
Q2_PARAM_BOUND = 2e-2
REPO = os.path.dirname(os.path.abspath(__file__))


_T_START = time.perf_counter()


def log(msg=""):
    if msg.startswith("phase "):  # each phase's start, on the script's clock
        msg = f"{msg} (t = {time.perf_counter() - _T_START:.1f} s)"
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
                halo_share=share, twin_secs=twin_secs, times=times,
                plain={k: model.interior(getattr(twin, k)) for k in "huv"},
                initial={k: model.interior(getattr(s0, k)) for k in "huv"})


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


def _profile_line(what, prof):
    log(f"  {what} profiler: card busy {prof['busy_ms_per_step']:.2f} of "
        f"{prof['wall_ms_per_step']:.2f} ms per step "
        f"({prof['busy_share']:.3f}), by group " + ", ".join(
            f"{k} {v:.3f}" for k, v in prof["ms_per_step_by_group"].items()))


def _path_launches(what, launches, want, steps, on_card):
    """The counters after a run of ``steps`` steps against ``want`` per
    step (on the card; the CPU runs the plain versions, which count
    nothing)."""
    want = {k: want[k] * steps for k in launches}
    if on_card and launches != want:
        fail(f"{what}: launched {launches} in {steps} steps, expected "
             f"{want}")


def path_h(dev, on_card, card):
    """Phase 25: path (h), the DP ResNet-50 step at n = 1 and 4, the
    counters reset just before each run and read just after; the
    profiler's groups; the kernel route bit for bit against the plain
    route at n = 4."""
    cfg = resnet_bench.CFG if on_card else resnet.ResNetConfig(
        stages=(1, 1), widths=(8, 16), n_classes=10, groups=4,
        block="bottleneck", stem="imagenet", dtype="bfloat16")
    batch, image = ((resnet_bench.BATCH, resnet_bench.IMAGE) if on_card
                    else (8, 32))
    steps = resnet_bench.STEPS if on_card else PATH_STEPS
    runs = {}
    for n in resnet_bench.RANKS:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        reset_counts()
        rec, step_args = resnet_bench.run(
            n, steps, cfg=cfg, batch=batch, image=image, device=dev)
        launches = {k: coll.LAUNCHES[k] for k in resnet_bench.COLLECTIVES}
        rec["launches"] = launches
        _path_launches(f"path (h) n={n}", launches, rec["expected_launches"],
                       steps + 1, on_card)
        _path_launches(f"path (h) n={n}, counted by hand", launches,
                       H_LAUNCHES[n], steps + 1, on_card)
        if not all(np.isfinite(rec["losses"])):
            fail(f"path (h) n={n}: losses {rec['losses']}")
        log(f"  n={n}: {rec['ms_per_step']:.2f} ms per step (median of "
            f"{steps} after a warm-up; {rec['ms_min']:.2f}-"
            f"{rec['ms_max']:.2f}), {rec['images_per_s']:.1f} images/s, "
            f"bound {rec['bound_ms']:.3f} ms ({rec['step_tflop']:.3f} TFLOP "
            f"a step); losses {[round(x, 4) for x in rec['losses'][:3]]}"
            f"...{round(rec['losses'][-1], 4)}; launches in {steps + 1} "
            f"steps {launches}, per step {rec['launches_per_step']}, "
            f"{rec['expected_launches']}; {rec['leaves']} leaves, "
            f"{rec['params_M']:.2f} M params [{card}]")
        if on_card:
            rec["profile"] = resnet_bench.profile(step_args)
            _profile_line(f"n={n}", rec["profile"])
        del step_args
        runs[f"n={n}"] = rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    routes = resnet_bench.route_check(cfg, 4, batch=batch, image=image,
                                      device=dev)
    log(f"  n=4 kernel route vs plain route, one step (cudnn "
        f"deterministic): loss {routes['loss_kernel']:.6f} vs "
        f"{routes['loss_plain']:.6f}, bit for bit {routes['bit_equal']}, "
        f"largest difference {routes['max_abs_diff']:.3e}")
    if not routes["bit_equal"]:
        fail(f"path (h): kernel route against plain route {routes}")
    runs["route_check"] = routes
    return runs


def path_i(dev, on_card, card):
    """Phase 26: path (i), the pipeline-parallel GPT-2 124M step at pp = 1
    and 4, the counters reset just before each run and read just after;
    the profiler's groups; the kernel route bit for bit against the plain
    route at pp = 4."""
    cfg = pp_bench.CFG if on_card else gpt.GPTConfig(
        vocab=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq=32)
    micro, batch, seq = ((pp_bench.MICRO, pp_bench.BATCH, pp_bench.SEQ)
                         if on_card else (4, 2, 32))
    runs = {}
    for pp in pp_bench.PPS:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        reset_counts()
        rec, (model, toks) = pp_bench.run(pp, PATH_STEPS, cfg=cfg,
                                          micro=micro, batch=batch, seq=seq,
                                          device=dev)
        launches = {k: coll.LAUNCHES[k] for k in pp_bench.COLLECTIVES}
        rec["launches"] = launches
        _path_launches(f"path (i) pp={pp}", launches,
                       rec["expected_launches"], PATH_STEPS + 1, on_card)
        _path_launches(f"path (i) pp={pp}, counted by hand", launches,
                       I_LAUNCHES[pp], PATH_STEPS + 1, on_card)
        if not all(np.isfinite(rec["losses"])):
            fail(f"path (i) pp={pp}: losses {rec['losses']}")
        mem = (f"{rec['peak_memory_GB']:.2f} GB peak"
               if rec["peak_memory_GB"] is not None else "memory not measured")
        log(f"  pp={pp}: {rec['ms_per_step']:.2f} ms per step (mean of "
            f"{PATH_STEPS} after a warm-up), {rec['tokens_per_s']:.0f} "
            f"tokens/s, bound {rec['bound_ms']:.2f} ms (masked share "
            f"{rec['masked_share']:.3f}), {mem}; losses "
            f"{[round(x, 4) for x in rec['losses']]}; launches in "
            f"{PATH_STEPS + 1} steps {launches}, per step "
            f"{rec['launches_per_step']} [{card}]")
        if on_card:
            rec["profile"] = pp_bench.profile(model, toks)
            _profile_line(f"pp={pp}", rec["profile"])
        del model, toks
        runs[f"pp={pp}"] = rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    routes = pp_bench.route_check(cfg, 4, micro=micro, batch=batch, seq=seq,
                                  device=dev)
    log(f"  pp=4 kernel route vs plain route, one step: loss "
        f"{routes['loss_kernel']:.6f} vs {routes['loss_plain']:.6f}, bit for "
        f"bit {routes['bit_equal']}, largest difference "
        f"{routes['max_abs_diff']:.3e}")
    if not routes["bit_equal"]:
        fail(f"path (i): kernel route against plain route {routes}")
    runs["route_check"] = routes
    return runs


def path_j(dev, on_card, card):
    """Phase 27: path (j), the alltoall family at n = 4: Ulysses attention,
    ``moe_ffn`` and the int8 allreduce, each with its launches counted
    over one call, held bit for bit to the plain route, and timed."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shape = a2a_bench.ULYSSES if on_card else (2, 64, 8, 16)
    moe_cfg = a2a_bench.MOE if on_card else dict(
        d_model=32, d_ff=64, tokens=64, capacity_factor=1.25)
    sizes = a2a_bench.INT8_BYTES if on_card else (4096, 65536)
    want = int(on_card)
    reset_counts()
    u = a2a_bench.run_ulysses(shape, reps=PATH_STEPS, device=dev)
    if u["launches_forward"]["alltoall"] != 4 * want or \
            u["launches_forward_backward"]["alltoall"] != 8 * want:
        fail(f"path (j) Ulysses: alltoall launches {u}")
    if not (u["bit_equal_forward"] and u["bit_equal_forward_backward"]
            and u["finite"]):
        fail(f"path (j) Ulysses: against the plain route {u}")
    log(f"  Ulysses B{shape[0]} T{shape[1]} H{shape[2]} D{shape[3]} bf16 "
        f"causal, n=4: forward {u['ms_forward']:.3f} ms (bound "
        f"{u['bound_ms_forward']:.3f}), forward+backward "
        f"{u['ms_forward_backward']:.3f} ms (bound "
        f"{u['bound_ms_forward_backward']:.3f}); launches "
        f"{u['launches_forward']} / {u['launches_forward_backward']}; bit "
        f"for bit the plain route [{card}]")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    m = a2a_bench.run_moe(moe_cfg, reps=PATH_STEPS, device=dev)
    if m["launches_forward_backward"]["alltoall"] != 4 * want:
        fail(f"path (j) MoE: alltoall launches {m}")
    if not (m["bit_equal_forward_backward"] and m["finite"]):
        fail(f"path (j) MoE: against the plain route {m}")
    log(f"  moe_ffn d_model {m['d_model']} d_ff {m['d_ff']}, "
        f"{m['tokens_total']} tokens over 4 experts, capacity {m['capacity']} ({m['tokens_kept']}"
        f" kept): forward+backward {m['ms_forward_backward']:.3f} ms (bound "
        f"{m['bound_ms_forward_backward']:.3f}); launches "
        f"{m['launches_forward_backward']}; bit for bit the plain route "
        f"[{card}]")
    q = a2a_bench.run_int8(sizes, reps=G_CALLS, device=dev)
    for size in sizes:
        r = q[f"{size}"]
        if r["launches"] != {"hop": 3 * want, "fused_ring": 0,
                             "alltoall": want}:
            fail(f"path (j) int8 {size} B: launches {r['launches']}")
        if not r["bit_equal"]:
            fail(f"path (j) int8 {size} B: not bit for bit the plain route")
        # the JAX package's own criteria for the mesh schedule
        if not (r["median_rel_err"] < 2e-2
                and r["max_abs_err_over_max"] < 0.2):
            fail(f"path (j) int8 {size} B: errors {r}")
        log(f"  allreduce(compression='int8'), {size} B f32 per rank, n=4: "
            f"{r['ms']:.4f} ms per call (bound {r['bound_ms']:.4f}), the "
            f"exact allreduce {r['exact_ms']:.4f} ms; median relative error "
            f"{r['median_rel_err']:.3e}, largest {r['max_abs_err_over_max']:.3e}"
            f" of the largest sum; launches {r['launches']}, the exact "
            f"{r['exact_launches']}; bit for bit the plain route [{card}]")
    return {"ulysses": u, "moe": m, "int8": q}


def path_world_ops(dev):
    """Phase 28: ``benchmarks/world_ops.py`` on 4 ranks on 'r0,r1|r2,r3'
    (a TCP world: the forced schedules and qring/qrd really run), each rank
    holding every op on its tensors to its oracle, an allreduce and a
    neighbor_exchange queued right behind a long matrix product among
    them (the job fails otherwise).  The job runs with
    ``MPI4JAX_TPU_ICI_LEG=off``, so its forced hring/htree are the
    transport's own schedules; phase 24 holds the intra-island leg."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="world_ops_") as tmp:
        t0 = time.perf_counter()
        rec = world_ops.run_job(WORLD_RANKS, tmp, device=str(dev),
                                fake_hosts=ici_leg.FAKE_HOSTS, timeout=300)
        secs = time.perf_counter() - t0
        results = world_ops.load_results(tmp, WORLD_RANKS)
    if rec["device"] != str(dev) or not rec["multi"] or rec["arena"]:
        fail(f"phase 28: the job ran as {rec}")
    for r, res in enumerate(results):
        if set(res) != set(rec["ops"]):
            fail(f"phase 28: rank {r} wrote {len(res)} results, expected "
                 f"{len(rec['ops'])}")
    log(f"  {WORLD_RANKS} ranks on {rec['device']}, islands "
        f"{rec['islands']}: {rec['checks_per_rank']} checks per rank held "
        f"({len(rec['ops'])} ops over "
        f"{len(world_ops.DTYPES) + len(world_ops.OTHER_DTYPES)} dtypes, "
        f"forced ring/rd/tree/hring/htree, int8 qring/qrd and the Python "
        f"schedule, status, wildcards, neighbours, gradients, split/dup, "
        f"ops behind a kernel); rank 0 {rec['seconds']:.2f} s, job "
        f"{secs:.1f} s; worst float error over its tolerance scale "
        f"{max(rec['worst_rel'].values()):.3e}")
    return dict(rec, job_seconds=secs)


def path_k(dev, a, shape, card):
    """Phase 29: path (k), the world-tier solver on a 2x2 grid of world
    ranks (one process each, all on the one card) for 0.1 model day,
    timed, its gathered h, u and v held to path (a)'s plain route within
    ``CHECK_TOL`` of each field's scale (the largest change path (a) made
    to it)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="path_k_") as tmp:
        t0 = time.perf_counter()
        rec, fields = sw_world.run_job([(GRID, shape)], tmp, days=DAYS,
                                       device=str(dev), timeout=600)[GRID]
        secs = time.perf_counter() - t0
    worst, bits = 0.0, True
    for k in "huv":
        got, want = fields[k], a["plain"][k]
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"path (k): {k} has shape {got.shape} or is not finite")
        scale = float(np.abs(want - a["initial"][k]).max())
        err = float(np.abs(got - want).max())
        bits &= bool(np.array_equal(got, want))
        worst = max(worst, err / scale)
        log(f"  {k}: max |k - a| {err:.3e}, {err / scale:.3e} of its scale "
            f"{scale:.3e}")
    if not worst <= chk.CHECK_TOL:
        fail(f"path (k): {worst:.3e} of a field's scale from path (a)'s "
             f"plain route (tolerance {chk.CHECK_TOL})")
    if not rec["mass_drift"] < 1e-5:
        fail(f"path (k): mass drifted by {rec['mass_drift']:.3e}")
    log(f"  {GRID[0]}x{GRID[1]} world ranks at {tuple(shape)}: "
        f"{rec['steps']} timed steps in {rec['seconds']:.4f} s "
        f"({rec['ms_per_step']:.4f} ms/step; path (a) {a['secs']:.4f} s), "
        f"halo share {rec['halo_share']:.3f} (largest rank "
        f"{rec['halo_share_max']:.3f}; medians of {rec['halo_steps']} "
        f"instrumented steps: {rec['halo_ms_per_step']:.4f} of "
        f"{rec['instrumented_ms_per_step']:.4f} ms), "
        f"{rec['neighbor_exchanges_per_step']:.0f} neighbor_exchange calls "
        f"a step; mass drift {rec['mass_drift']:.2e}; within "
        f"{worst:.3e} of path (a)'s plain route (tolerance "
        f"{chk.CHECK_TOL}), bit for bit: {bits}; job {secs:.1f} s [{card}]")
    return dict(rec, worst_over_scale=worst, bit_for_bit=bits,
                job_seconds=secs)


def _timed(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its wall seconds)``."""
    t0 = time.perf_counter()
    return fn(*args, **kwargs), time.perf_counter() - t0


def _run(what, cmd, env, timeout):
    """A subprocess from the repo's root; its failure fails the phase with
    the tail of its output."""
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    return proc


def path_l(on_card, card):
    """Phase 30: path (l).  The tuner (``python -m mpi4jax_tpu_torch.tune
    --np 4``) writes a cache; the world MoE job runs under it with the
    recorder (``runtime.launch -n 4 --fake-hosts 'r0,r1|r2,r3' --trace``,
    ``benchmarks.moe_world``, the shm arena off), each rank holding its
    outputs to the simulators and the exact route; then the merged trace
    must validate, ``profile report --json`` must hold a row for each of
    the four alltoall schedules and for the leg's ``ici`` allreduce with
    nothing dropped, and ``tune --from-trace`` must give a cache that
    loads.  The job's launch carries ``--verify`` (path (n2)): the static
    verifier runs the program in its virtual world first, with the ranks'
    environment, and must say it is clean at np=4.  Returns the record,
    each rank's top-level world ops in the merged trace and the tune
    cache, which path (n1) reads."""
    if on_card:
        torch.cuda.empty_cache()
    py = sys.executable
    with tempfile.TemporaryDirectory(prefix="path_l_") as tmp:
        cache = os.path.join(tmp, "tune_4.json")
        env = dict(os.environ, MPI4JAX_TPU_DISABLE_SHM="1",
                   MPI4JAX_TPU_TUNE_CACHE=cache,
                   MPI4JAX_TPU_ANALYZE_TIMEOUT_S=str(N_TIMEOUT_S))
        t0 = time.perf_counter()
        proc = _run("the tuner", [
            py, "-m", "mpi4jax_tpu_torch.tune", "--np", "4", "--sizes",
            L_TUNE_SIZES if on_card else "1024,65536", "--repeats", "3",
            "--ops", "allreduce,alltoall", "--cache", cache]
            + ([] if on_card else ["--device", "cpu"]), env, 600)
        tune_secs = time.perf_counter() - t0
        winners = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith("{")]
        for w in winners:
            log(f"  tuner: {w['op']} {w['bytes']} B -> {w['winner']}; ms "
                + ", ".join(f"{a} {t * 1e3:.4f}"
                            for a, t in w["seconds"].items()))
        trace = os.path.join(tmp, "l.json")
        t0 = time.perf_counter()
        job = _run("the path (l) job", [
            py, "-m", "mpi4jax_tpu_torch.runtime.launch", "-n", "4",
            "--fake-hosts", ici_leg.FAKE_HOSTS, "--trace", trace,
            "--timeout", "600", "--verify",
            "-m", "mpi4jax_tpu_torch.benchmarks.moe_world",
            "--out", tmp] + ([] if on_card else L_SMALL), env,
            900 + N_TIMEOUT_S)
        job_secs = time.perf_counter() - t0
        if "clean at np=4" not in job.stderr:
            fail("path (n2): launch --verify did not say the program is "
                 f"clean at np=4:\n{job.stderr[-3000:]}")
        with open(os.path.join(tmp, "record.json")) as f:
            rec = json.load(f)
        with open(trace) as f:
            merged = json.load(f)
        errors = obs.validate_chrome_trace(merged)
        trace_ops = trace_world_ops(merged)
        with open(cache) as f:
            cache_text = f.read()
        if errors:
            fail(f"path (l): the merged trace is invalid: {errors[:3]}")
        parts = obs.part_paths(trace)
        # a rank whose dump failed at exit still exits 0: hold every part
        # to the events its rank counted before the dump
        if len(parts) != 4:
            fail(f"path (l): {len(parts)} recording parts, expected 4")
        for path in parts:
            part = obs.load_part(path)
            r = int(part["rank"])
            if len(part["events"]) < rec["events_per_rank"][r]:
                fail(f"path (l): rank {r}'s part holds "
                     f"{len(part['events'])} events, the rank counted "
                     f"{rec['events_per_rank'][r]}")
        stats = json.loads(_run("profile report", [
            py, "-m", "mpi4jax_tpu_torch.profile", "report", "--json",
            *parts], env, 300).stdout)
        rows = stats["per_op"]
        for algo in moe_world.FAMILY:
            if not any(r["op"] == "Alltoall" and r["src"] == "native"
                       and r["algo"] == algo and "tier" not in r
                       for r in rows):
                fail(f"path (l): no alltoall row for {algo} in the report")
        ici = [r for r in rows if r["op"] == "Allreduce"
               and r.get("tier") == "ici"]
        if not ici:
            fail("path (l): no ici allreduce row in the report")
        for k, v in rec["leg"].items():
            want = {"fused_ring": 4 * v["calls"] if on_card else 0,
                    "quant_pack": 4 * v["calls"] if on_card and "q" in k
                    else 0}
            if v["launches_all_ranks"] != want:
                fail(f"path (l): the leg {k} launched "
                     f"{v['launches_all_ranks']}, expected {want}")
        dropped = sum(stats["dropped"].values())
        if dropped:
            fail(f"path (l): {dropped} events dropped")
        ft = os.path.join(tmp, "from_trace.json")
        _run("tune --from-trace", [
            py, "-m", "mpi4jax_tpu_torch.tune", "--from-trace",
            ",".join(parts), "--cache", ft], env, 300)
        saved = (tune._cache_table, tune._cache_origin, tune._cache_combos)
        try:
            ft_table = tune.load_cache(4, path=ft)
        finally:
            tune._cache_table, tune._cache_origin, tune._cache_combos = saved
    log(f"  4 ranks on {rec['device']}, islands {rec['islands']}, tiers "
        f"{rec['tiers']}; tune sources {rec['sources']}; moe_ffn at d_model "
        f"{rec['d_model']}, d_ff {rec['d_ff']}, {rec['tokens']} tokens a "
        f"rank, capacity {rec['capacity']} (dispatch buffer "
        f"{rec['dispatch_bytes']} B a rank); auto picks {rec['auto_pick']}")
    log("  moe_ffn forward, ms (slowest rank's median of "
        f"{rec['reps']}): " + ", ".join(
            f"{k} {v:.4f} (max |y - exact| {rec['moe_max_abs_err'][k]:.3e})"
            for k, v in rec["moe_ms"].items())
        + f"; bit for bit the exact route: {rec['moe_bit_for_bit']}")
    log("  alltoall alone on the dispatch buffer, ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["alltoall_ms"].items())
        + " (each bit for bit its simulator)")
    for k, v in rec["leg"].items():
        log(f"  leg allreduce {k}, {moe_world.LEG_BYTES if on_card else 65536}"
            f" B a rank: {v['ms']:.4f} ms, {v['check']} its simulator "
            f"(rel err {v['rel_err']:.3e}); launches over {v['calls']} calls "
            f"on all ranks {v['launches_all_ranks']}")
    r, c = rec["recorder_ms"], rec["call_trace_us"]
    log(f"  recorder (medians of {moe_world.REC_ROUNDS} rounds): exact "
        f"alltoall {r['alltoall_on']:.4f} ms on, {r['alltoall_off']:.4f} off;"
        f" 4 KiB allreduce {r['allreduce_4KiB_on']:.4f} on, "
        f"{r['allreduce_4KiB_off']:.4f} off; rank 0's rounds "
        f"{rec['recorder_rounds_rank0']}; CallTrace alone {c['on']:.3f} us "
        f"on, {c['off']:.3f} off; events per rank {rec['events_per_rank']},"
        f" dropped {rec['dropped_per_rank']}")
    log(f"  report: {stats['total_events']} events, {len(rows)} rows, 0 "
        f"dropped; ici rows {len(ici)}; trace valid; from-trace cache "
        f"{ft_table}; tuner {tune_secs:.1f} s, job {job_secs:.1f} s [{card}]")
    return dict(rec, winners=winners, from_trace=ft_table,
                tune_seconds=tune_secs, job_seconds=job_secs,
                trace_ops=trace_ops, tune_cache=cache_text)

_ITEMSIZE = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
             "float16": 2, "bfloat16": 2, "int32": 4, "uint32": 4,
             "float32": 4, "int64": 8, "uint64": 8, "float64": 8,
             "complex64": 8, "complex128": 16}


def schedule_op(line):
    """``(kind, bytes)`` of one event of an analyzer schedule (``"alltoall
    float32[4x2560x768] @ site"``), in the bytes the ops layer's span
    records for it (a sendrecv's span counts both directions)."""
    head = line.split(" @ ", 1)[0].split()
    nbytes = 0
    for word in head[1:]:
        dtype, _, dims = word.partition("[")
        if dims.endswith("]") and dtype in _ITEMSIZE:
            nbytes = _ITEMSIZE[dtype]
            for d in filter(None, dims[:-1].split("x")):
                nbytes *= int(d)
    return head[0], 2 * nbytes if head[0] == "sendrecv" else nbytes


def trace_world_ops(merged):
    """Each rank's top-level world ops in a merged trace, in time order:
    the ops layer's spans (``CallTrace``), the nested leg spans (with a
    ``tier``) left out, as ``(kind, bytes)``."""
    per = {}
    for e in merged["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != "ops" \
                or "tier" in e.get("args", {}):
            continue
        per.setdefault(int(e["pid"]), []).append(
            (e["ts"], e["name"].lower(), int(e["args"]["bytes"])))
    return {r: [(k, b) for _, k, b in sorted(v, key=lambda t: t[0])]
            for r, v in per.items()}


def unrecorded_ops(args_small, n=4):
    """The world ops path (l)'s program issues before its recording
    starts (``moe_world``: the two warm-up calls, then the recorder's
    rounds, each call behind a barrier), which the trace cannot hold."""
    ap = {"tokens": moe_world.TOKENS, "d_model": moe_world.D_MODEL,
          "reps": 10, "small_reps": 100}
    for flag, key in (("--tokens", "tokens"), ("--d-model", "d_model"),
                      ("--reps", "reps"), ("--small-reps", "small_reps")):
        if flag in args_small:
            ap[key] = int(args_small[args_small.index(flag) + 1])
    from mpi4jax_tpu_torch.parallel import moe

    cap = moe.expert_capacity(ap["tokens"], n, moe_world.CAPACITY_FACTOR)
    a2a = ("alltoall", 4 * n * cap * ap["d_model"])
    small = ("allreduce", moe_world.REC_BYTES)
    one_round = ([("barrier", 0), a2a] * ap["reps"]
                 + [("barrier", 0), small] * ap["small_reps"])
    return [a2a, small] + one_round * (2 * moe_world.REC_ROUNDS)


def path_n(on_card, card, l_run, shape):
    """Phase 32: path (n), the static communication verifier on the card.
    (n1) the analyzer CLI on path (l)'s program with phase 30's arguments
    (``-m mpi4jax_tpu_torch.benchmarks.moe_world`` at np 4, ``--json
    --schedules``), under phase 30's tune cache and islands: clean, and
    each rank's world ops (kind, bytes) equal to what the transport ran:
    the ops before the recorder's last restart (``unrecorded_ops``), then
    that rank's top-level ops in phase 30's merged trace.  (n2) is phase
    30's ``--verify``.  (n3) the analyzer on path (k)'s program
    (``benchmarks.sw_world --grid 2 2``) at ``shape`` and ``N_DAYS``:
    clean, with halo exchanges on every rank.  (n4) ``launch -n 2
    --verify`` of ``tests/torch_world_programs/tag_mismatch.py``: exit 3,
    the finding named, no rank started.  (n3) and (n4) run beside (n1).
    Every rank thread's tensors live on the card."""
    if on_card:
        torch.cuda.empty_cache()
    py = sys.executable
    dev_args = [] if on_card else ["--device", "cpu"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="path_n_") as tmp:
        cache = os.path.join(tmp, "tune_4.json")
        with open(cache, "w") as f:
            f.write(l_run["tune_cache"])
        env = dict(os.environ, MPI4JAX_TPU_DISABLE_SHM="1",
                   MPI4JAX_TPU_TUNE_CACHE=cache,
                   MPI4JAX_TPU_FAKE_HOSTS=ici_leg.FAKE_HOSTS)
        analyze = [py, "-m", "mpi4jax_tpu_torch.analyze", "--np", "4",
                   "--json", "--schedules", "--timeout", str(N_TIMEOUT_S)]
        # (n3) and (n4) run beside (n1): each analyzer is one process whose
        # rank threads share its interpreter lock, so the three fit the
        # machine's cores side by side
        days = N_DAYS if on_card else 0.02
        pool = ThreadPoolExecutor(max_workers=2)
        n3 = pool.submit(_timed, _run, "(n3) the analyzer on path (k)'s "
                         "program", analyze + [
                             "-m", "mpi4jax_tpu_torch.benchmarks.sw_world",
                             "--", "--grid", str(GRID[0]), str(GRID[1]),
                             "--size", str(shape[0]), str(shape[1]),
                             "--days", str(days)] + dev_args,
                         env, N_TIMEOUT_S + 120)
        n4 = pool.submit(_timed, subprocess.run, [
            py, "-m", "mpi4jax_tpu_torch.runtime.launch", "-n", "2",
            "--verify", os.path.join("tests", "torch_world_programs",
                                     "tag_mismatch.py")] + dev_args,
            env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
        pool.shutdown(wait=False)
        # (n1)
        l_out = os.path.join(tmp, "n1")
        os.makedirs(l_out)
        t0 = time.perf_counter()
        proc = _run("(n1) the analyzer on path (l)'s program", analyze + [
            "-m", "mpi4jax_tpu_torch.benchmarks.moe_world", "--",
            "--out", l_out] + ([] if on_card else L_SMALL), env,
            N_TIMEOUT_S + 120)
        secs = time.perf_counter() - t0
        rep = json.loads(proc.stdout)
        if not rep["ok"] or rep["findings"]:
            fail(f"path (n1): findings on path (l)'s program: "
                 f"{rep['findings'][:3]}")
        if os.listdir(l_out):
            fail(f"path (n1): the analyzed program wrote {os.listdir(l_out)}")
        prefix = unrecorded_ops([] if on_card else L_SMALL)
        counts = {}
        for r, lines in sorted(rep["schedules"].items(), key=lambda t:
                               int(t[0])):
            got = [schedule_op(line) for line in lines]
            want = prefix + l_run["trace_ops"].get(int(r), [])
            if got != want:
                first = next((i for i, (a, b) in enumerate(zip(got, want))
                              if a != b), min(len(got), len(want)))
                fail(f"path (n1): rank {r}'s analyzed ops differ from what "
                     f"the transport ran at op {first} of {len(got)} / "
                     f"{len(want)}: {got[first:first + 3]} against "
                     f"{want[first:first + 3]}")
            counts[int(r)] = len(got)
        log(f"  (n1) path (l)'s program analyzed clean at np=4 in "
            f"{secs:.1f} s ({rep['cache_key']}); events per rank {counts}, "
            f"each rank's equal to phase 30's: {len(prefix)} before the "
            f"recording, then the trace's {len(l_run['trace_ops'][0])} "
            f"[{card}]")
        out["n1"] = {"seconds": secs, "events_per_rank": counts,
                     "unrecorded": len(prefix),
                     "cache_key": rep["cache_key"]}
        # (n3)
        if days != DAYS:
            log(f"  (n3) --days cut from {DAYS} to {days}")
        proc, secs = n3.result()
        rep = json.loads(proc.stdout)
        if not rep["ok"] or rep["findings"]:
            fail(f"path (n3): findings on path (k)'s program: "
                 f"{rep['findings'][:3]}")
        halos = {int(r): sum(line.startswith("shift2 ") for line in lines)
                 for r, lines in rep["schedules"].items()}
        if sorted(halos) != list(range(4)) or min(halos.values()) == 0:
            fail(f"path (n3): halo exchanges per rank {halos}")
        log(f"  (n3) path (k)'s program at {tuple(shape)}, {days} day, "
            f"analyzed clean at np=4 in {secs:.1f} s beside (n1); events "
            f"per rank "
            f"{ {int(r): len(v) for r, v in rep['schedules'].items()} }, "
            f"of them halo exchanges {halos} [{card}]")
        out["n3"] = {"seconds": secs, "days": days, "halos": halos}
        # (n4)
        bad, secs = n4.result()
        if bad.returncode != 3 or "tag_mismatch" not in bad.stderr \
                or "no rank was spawned" not in bad.stderr \
                or "UNREACHABLE" in bad.stdout + bad.stderr:
            fail(f"path (n4): launch --verify of tag_mismatch.py exited "
                 f"{bad.returncode}:\n{bad.stdout[-2000:]}\n"
                 f"{bad.stderr[-2000:]}")
        log(f"  (n4) launch -n 2 --verify tag_mismatch.py: exit 3, "
            f"tag_mismatch named, no rank started, {secs:.1f} s beside "
            "(n1)")
        out["n4"] = {"seconds": secs}
    return out


def _joint_pick(combos, nbytes):
    """The combo of ``combos`` (a v2 cache's entries for one op, ``[(min
    bytes, combo), ...]`` ascending) whose band holds ``nbytes``."""
    pick = combos[0][1]
    for mb, combo in combos:
        if nbytes >= mb:
            pick = combo
    return pick


def path_m1(dev, on_card, card):
    """Phase 31, part (m1): ``python -m mpi4jax_tpu_torch.tune --joint
    --np 4`` on ``r0,r1|r2,r3`` writes a v2 cache and a cost-model file;
    kernels 3 and 4 must launch in the ``+ici`` sub-jobs.  Then path (g)'s
    f32 SUM allreduce runs with ``algo=None`` under that cache (the picked
    combo's gates set) on every rank at 16 and 64 MiB: the schedule that
    runs must be the cache's pick for the band, an exact pick bit for bit
    its simulator, a quantized one within 5e-2 of the exact sum."""
    from mpi4jax_tpu_torch.tune import _joint, _model

    py = sys.executable
    with tempfile.TemporaryDirectory(prefix="path_m1_") as tmp:
        cache = os.path.join(tmp, "tune_joint.json")
        model_file = os.path.join(tmp, "model_joint.json")
        env = dict(os.environ, MPI4JAX_TPU_FAKE_HOSTS=ici_leg.FAKE_HOSTS)
        t0 = time.perf_counter()
        proc = _run("the joint tuner", [
            py, "-m", "mpi4jax_tpu_torch.tune", "--joint", "--np", "4",
            "--ops", "allreduce,allgather,alltoall", "--topk", "3",
            "--repeats", "3", "--cache", cache, "--model-out", model_file]
            + ([] if on_card else ["--device", "cpu", "--sizes",
                                   M_SMALL_SIZES]), env, 900)
        tune_secs = time.perf_counter() - t0
        lines = [json.loads(line) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
        subs = [x for x in lines if "sub_job" in x]
        with open(cache) as f:
            payload = json.load(f)
        model = _model.load_model(model_file)
    combos = {op: [tuple(e) for e in entries]
              for op, entries in payload["combos"].items()}
    for op, entries in sorted(combos.items()):
        log(f"  joint winners, {op}: " + ", ".join(
            f">= {mb} B {combo}" for mb, combo in entries))
    fits = {}
    for (op, combo), pts in sorted(model.samples.items()):
        alpha, beta = model._fit((op, combo))
        fits[f"{op}/{combo}"] = {"alpha_us": alpha * 1e6,
                                 "beta_ns_per_byte": beta * 1e9,
                                 "sizes": len(pts)}
    log("  fitted alpha (us) and beta (ns/B): " + "; ".join(
        f"{k} {v['alpha_us']:.2f} {v['beta_ns_per_byte']:.5f}"
        for k, v in fits.items()))
    ran = {}
    for sub in subs:
        if "skipped" in sub:
            log(f"  sub-job {sub['sub_job']} {sub['gates']} skipped: "
                f"{sub['skipped']} ({sub['combos']})")
            continue
        ran[sub["sub_job"]] = sub
        log(f"  sub-job {sub['sub_job']} {sub['gates']}: {sub['rows']} rows "
            f"of {sub['combos']} in {sub['seconds']:.2f} s; launches "
            f"{sub['launches']}")
    # the driver writes the cache without a gated sub-job that failed:
    # every sub-job must be there, and only +q may be skipped (with the
    # leg on, the leg takes all of its schedules)
    labels = sorted(sub["sub_job"] for sub in subs)
    if labels != sorted(("base", "+q", "+ici", "+q+ici")) \
            or not {"base", "+ici", "+q+ici"} <= set(ran):
        fail(f"path (m1): sub-jobs {labels}, of which ran {sorted(ran)}; "
             "base, +ici and +q+ici must run, and +q run or be skipped")
    if on_card and not (ran["+ici"]["launches"]["fused_ring"] > 0
                        and ran["+q+ici"]["launches"]["fused_ring"] > 0
                        and ran["+q+ici"]["launches"]["quant_pack"] > 0):
        fail(f"path (m1): +ici launched {ran['+ici']['launches']}, +q+ici "
             f"{ran['+q+ici']['launches']}; kernel 3 must launch in both "
             "and kernel 4 in +q+ici")
    ici = {k: ran["+ici"]["launches"][k] + ran["+q+ici"]["launches"][k]
           for k in ("fused_ring", "quant_pack")}
    pick = _joint_pick(combos["allreduce"], M_SIZES[0] if on_card
                       else M_SMALL_COUNTS[-1] * 4)
    gates = _joint.combo_gates(pick)
    env = {"MPI4JAX_TPU_TUNE_CACHE": None,  # set per job below
           "MPI4JAX_TPU_ICI_LEG": gates.get("MPI4JAX_TPU_ICI_LEG", "off"),
           "MPI4JAX_TPU_COLL_QUANT": gates.get("MPI4JAX_TPU_COLL_QUANT",
                                               "allow")}
    counts = ([b // 4 for b in M_SIZES] if on_card else M_SMALL_COUNTS)
    with tempfile.TemporaryDirectory(prefix="path_m1_") as tmp:
        env["MPI4JAX_TPU_TUNE_CACHE"] = os.path.join(tmp, "tune_joint.json")
        with open(env["MPI4JAX_TPU_TUNE_CACHE"], "w") as f:
            json.dump(payload, f)
        t0 = time.perf_counter()
        rec = ici_leg.run_job("joint", device=str(dev), algos=(None,),
                              check_counts=counts, env=env)
        check_secs = time.perf_counter() - t0
    for c in rec["checks"]:
        want = _joint.combo_algo(_joint_pick(combos["allreduce"],
                                             c["count"] * 4))
        if c["algo"] != want:
            fail(f"path (m1): algo=None ran {c['algo']} at {c['count']} f32 "
                 f"a rank, the cache picks {want}")
        log(f"  algo=None at {c['count'] * 4} B a rank: {c['algo']} (cache: "
            f"{_joint_pick(combos['allreduce'], c['count'] * 4)}, gates "
            f"{gates}), held to its simulator ({c['check']}), rel err "
            f"{c['rel_err']:.3e}; launches on rank 0 {c['launches']}")
    log(f"  tuner {tune_secs:.1f} s, the algo=None job {check_secs:.1f} s; "
        f"launches in the +ici sub-jobs {ici}, in the algo=None job "
        f"{rec['launches']} [{card}]")
    return {"winners": combos, "fits": fits, "sub_jobs": subs,
            "ici_launches": ici, "check": rec["checks"],
            "check_launches": rec["launches"], "pick": pick,
            "tune_seconds": tune_secs, "check_seconds": check_secs}


def _bytes_equal(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def _dir_mb(path) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e6


def path_m2(dev, shape, on_card, card):
    """Phase 31, part (m2): the 1x1 solver at fuse=3 for 0.1 model day,
    uninterrupted and then saved (``checkpoint.save_sharded``) at the
    midpoint of the timed steps, restored into a freshly built model and
    finished: the final fields bit for bit and kernel 8's launches the
    same.  Then path (f)'s GPT-2 124M train state after one step (the f32
    master parameters, their bf16 compute copies and the AdamW state)
    through ``checkpoint.save``/``restore`` on the card, byte for byte."""
    from mpi4jax_tpu_torch.utils import checkpoint

    fuse = 3
    model = sw.ShallowWater(shape, device=dev)
    timed = int(DAYS * model.params.day_seconds / model.params.dt) - 1
    mid = (timed // 2) // fuse * fuse  # the same launches either way
    s0 = model.init()
    first = model.step_fn(1, first=True, fuse=fuse)
    reset_counts()
    ref = model.step_fn(timed, fuse=fuse)(first(s0))
    ref = sw.SWState(*(f.clone() for f in ref))
    sync(dev)
    ref_launches = kernel.LAUNCHES
    reset_counts()
    state = model.step_fn(mid, fuse=fuse)(first(s0))
    with tempfile.TemporaryDirectory(prefix="path_m2_") as tmp:
        sync(dev)
        t0 = time.perf_counter()
        checkpoint.save_sharded(state._asdict(), step=mid, directory=tmp)
        sw_write = time.perf_counter() - t0
        sw_mb = _dir_mb(tmp)
        fresh = sw.ShallowWater(shape, device=dev)
        t0 = time.perf_counter()
        tree, step, manifest = checkpoint.restore_sharded(
            fresh.init()._asdict(), directory=tmp)
        sync(dev)
        sw_read = time.perf_counter() - t0
    out = fresh.step_fn(timed - mid, fuse=fuse)(sw.SWState(**tree))
    sync(dev)
    launches = kernel.LAUNCHES
    bits = {k: _bytes_equal(getattr(out, k), getattr(ref, k))
            for k in sw.SWState._fields}
    if not all(bits.values()) or launches != ref_launches:
        fail(f"path (m2): the resumed run differs: bit for bit {bits}, "
             f"kernel 8 launched {launches} against {ref_launches}")
    if step != mid or manifest["nshards"] != 1:
        fail(f"path (m2): restored step {step}, manifest {manifest}")
    log(f"  solver {shape} fuse={fuse}: saved at step {mid} of {timed} "
        f"timed steps, {sw_mb:.1f} MB written in {sw_write:.3f} s, read in "
        f"{sw_read:.3f} s; resumed fields bit for bit {bits}; kernel 8 "
        f"launches {launches} (uninterrupted {ref_launches})")

    cfg = gpt_bench.CFG if on_card else M_SMALL_GPT
    batch, seq = (gpt_bench.BATCH, gpt_bench.SEQ) if on_card else (2, 32)
    net = gpt.GPT(cfg, (1, 1, 1), device=dev, seed=0)
    net.train_step(gpt_bench.make_tokens(batch, seq, cfg.vocab, 0, dev))
    params = {f: getattr(net, f).detach() for f in gpt.GPTParams._fields}
    state = {"params": params,
             "params_bf16": {f: p.to(torch.bfloat16)
                             for f, p in params.items()},
             "adamw": {f: dict(net.opt.state[getattr(net, f)])
                       for f in gpt.GPTParams._fields}}
    del net
    like = {"params": {f: torch.empty_like(p) for f, p in params.items()},
            "params_bf16": {f: torch.empty_like(p)
                            for f, p in state["params_bf16"].items()},
            "adamw": {f: {k: torch.empty_like(v) for k, v in st.items()}
                      for f, st in state["adamw"].items()}}
    with tempfile.TemporaryDirectory(prefix="path_m2_") as tmp:
        path = os.path.join(tmp, "gpt_state.npz")
        sync(dev)
        t0 = time.perf_counter()
        checkpoint.save(path, state)
        gpt_write = time.perf_counter() - t0
        gpt_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        back = checkpoint.restore(path, like)
        sync(dev)
        gpt_read = time.perf_counter() - t0
    from mpi4jax_tpu_torch.utils.tree import leaves

    pairs = list(zip(leaves(state), leaves(back)))
    bad = [i for i, (a, b) in enumerate(pairs)
           if not (_bytes_equal(a, b) and a.device == b.device)]
    n_bf16 = sum(a.dtype == torch.bfloat16 for a, _ in pairs)
    if bad:
        fail(f"path (m2): {len(bad)} of {len(pairs)} GPT state leaves did "
             f"not round-trip byte for byte (first {bad[:3]})")
    log(f"  GPT {'124M' if on_card else '(small)'} train state after one "
        f"step: {len(pairs)} leaves ({n_bf16} bf16), {gpt_mb:.1f} MB "
        f"written in {gpt_write:.3f} s, read in {gpt_read:.3f} s, byte for "
        f"byte [{card}]")
    return {"sw": {"mb": sw_mb, "write_s": sw_write, "read_s": sw_read,
                   "step": mid, "timed_steps": timed,
                   "kernel8_launches": launches,
                   "uninterrupted_launches": ref_launches,
                   "bit_for_bit": bits},
            "gpt": {"mb": gpt_mb, "write_s": gpt_write, "read_s": gpt_read,
                    "leaves": len(pairs), "bf16_leaves": n_bf16}}


def path_m3(dev, on_card, card):
    """Phase 31, part (m3): on a 4-rank mesh comm with 16 MiB f32 a rank,
    ``token_api`` allreduce -> sendrecv(shift=1) -> barrier -> allgather,
    each result bit for bit the tokenless call's, with the launches of
    kernels 1 and 3 of the tokenless chain."""
    from mpi4jax_tpu_torch.compat import token_api

    n, count = 4, (M_SIZES[0] // 4 if on_card else 4096)
    comm = make_mesh(n, device=dev)
    x = random_tensor((n, count), torch.float32, dev, 31)

    def plain():
        a = ops.allreduce(x, comm=comm)
        b = ops.sendrecv(a, shift=1, comm=comm)
        ops.barrier(comm=comm)
        return a, b, ops.allgather(b, comm=comm)

    def chained():
        tok = token_api.create_token(x)
        a, tok = token_api.allreduce(x, comm=comm, token=tok)
        b, tok = token_api.sendrecv(a, shift=1, comm=comm, token=tok)
        tok = token_api.barrier(comm=comm, token=tok)
        c, tok = token_api.allgather(b, comm=comm, token=tok)
        if tok.dtype != torch.uint32 or tok.device != x.device:
            fail(f"path (m3): token {tok.dtype} on {tok.device}")
        return a, b, c

    runs = {}
    for name, fn in (("tokenless", plain), ("token", chained)):
        reset_counts()
        out = fn()
        sync(dev)
        runs[name] = (out, {k: coll.LAUNCHES[k]
                            for k in ("hop", "fused_ring")})
    bits = [_bytes_equal(a, b) for a, b in zip(runs["token"][0],
                                               runs["tokenless"][0])]
    if not all(bits) or runs["token"][1] != runs["tokenless"][1]:
        fail(f"path (m3): the token chain differs: bit for bit {bits}, "
             f"launches {runs['token'][1]} against {runs['tokenless'][1]}")
    log(f"  n={n}, {count * 4} B a rank: allreduce, sendrecv, barrier, "
        f"allgather bit for bit {bits}; launches {runs['token'][1]} "
        f"(tokenless {runs['tokenless'][1]}) [{card}]")
    return {"launches": runs["token"][1], "bit_for_bit": bits}


def _digests(text, marker):
    import re

    return sorted(re.findall(marker + r" (r\d+ [0-9a-f]{64})", text))


def path_o(on_card, card):
    """Phase 33: path (o), plan execution on the card.  (o1) the chain
    pipeline of ``benchmarks.schedule_overlap`` at np 3, plan off then on
    (the shm arena off, as the JAX bridge-level plan tests run): every
    received block equal to its numpy oracle and each rank's digest equal
    on and off (the ranks check both), the runner's counts summed over the
    ranks with hoisted receives and deferred sends and no mismatch; the
    us per round on and off (the slowest rank, through the runner's flush)
    with every rank's split into sends, receives and the flush, the
    bucketed and per-leaf seconds.  (o2)
    ``launch -n 3 --plan`` of ``false_serialization.py``: the launcher
    verifies the plan, no rank disables it, and the digests equal a
    ``MPI4JAX_TPU_PLAN=0`` run's.  (o3) ``bucketed_dp_grad.py`` at np 2
    under the plan that ``analyze --emit-plan`` gives for it: both ranks
    print ``bucketed_dp_grad OK``."""
    if on_card:
        torch.cuda.empty_cache()
    py = sys.executable
    launch = [py, "-m", "mpi4jax_tpu_torch.runtime.launch"]
    dev_args = ["--device", "cuda" if on_card else "cpu"]
    progs = os.path.join("tests", "torch_world_programs")
    out = {}
    t_phase = time.perf_counter()
    # (o1)
    env = dict(os.environ, MPI4JAX_TPU_DISABLE_SHM="1")
    env.pop("MPI4JAX_TPU_PLAN", None)
    t0 = time.perf_counter()
    proc = _run("(o1) schedule_overlap", launch + [
        "-n", "3", "--timeout", "300", "-m",
        "mpi4jax_tpu_torch.benchmarks.schedule_overlap", "--"]
        + ([] if on_card else O_SMALL), env, 400)
    secs = time.perf_counter() - t0
    rec = next(json.loads(line) for line in reversed(
        proc.stdout.splitlines()) if line.startswith('{"schedule_overlap"'))
    run = rec["runner"]
    if run["hoisted_recvs"] <= 0 or run["deferred_sends"] <= 0 \
            or run["mismatches"] != 0 or not rec["digests_equal"]:
        fail(f"path (o1): the runner's counts {run}")
    by_rank = rec["us_per_round_by_rank"]
    log(f"  (o1) chain of 3 ranks, {rec['rounds']} rounds of "
        f"{rec['block_bytes']} B on {rec['device']}, {rec['compute_ms']} ms "
        f"window, the slowest rank through the flush: plan off "
        f"{rec['us_per_round_off']:.1f} us per round, on "
        f"{rec['us_per_round_on']:.1f} us; the runner {run} (by rank "
        f"{rec['runner_by_rank']}); every block its oracle, digests equal "
        f"on and off; {rec['n_allreduce_per_leaf']} gradient allreduces "
        f"{rec['per_leaf_s']:.6f} s, in {rec['n_buckets']} bucket(s) "
        f"{rec['bucketed_s']:.6f} s; job {secs:.1f} s [{card}]")
    for label in ("off", "on"):
        log(f"    plan {label}, us per round by rank 0, 1, 2: " + "; ".join(
            f"{k} " + ", ".join(f"{v:.1f}" for v in by_rank[label][k])
            for k in ("total", "send", "recv", "flush")))
    out["o1"] = dict(rec, seconds=secs)
    # (o2) and (o3)'s pre-flight side by side: the plan-off run and the
    # analyzer of bucketed_dp_grad.py start beside the timed --plan launch
    fs = os.path.join(progs, "false_serialization.py")
    bucketed = os.path.join(progs, "bucketed_dp_grad.py")
    env = dict(os.environ)
    env.pop("MPI4JAX_TPU_PLAN", None)
    with tempfile.TemporaryDirectory(prefix="path_o_") as tmp:
        plan = os.path.join(tmp, "plan.json")
        side = {
            "(o2) false_serialization.py, MPI4JAX_TPU_PLAN=0": subprocess.Popen(
                launch + ["-n", "3", "--timeout", "300", fs] + dev_args,
                env=dict(env, MPI4JAX_TPU_PLAN="0"), cwd=REPO, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE),
            "(o3) analyze --emit-plan bucketed_dp_grad.py": subprocess.Popen(
                [py, "-m", "mpi4jax_tpu_torch.analyze", bucketed, "--np", "2",
                 "--emit-plan", plan, "--"] + dev_args,
                env=env, cwd=REPO, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)}
        t0 = time.perf_counter()
        on = _run("(o2) launch --plan false_serialization.py", launch + [
            "-n", "3", "--timeout", "300", "--plan", fs] + dev_args, env,
            400)
        secs = time.perf_counter() - t0
        done = {}
        for what, proc in side.items():
            stdout, stderr = proc.communicate(timeout=400)
            if proc.returncode != 0:
                fail(f"{what} exited {proc.returncode}:\n{stdout[-3000:]}\n"
                     f"{stderr[-3000:]}")
            done[what] = stdout
        if "--plan: verified plan" not in on.stderr \
                or "plan execution disabled" in on.stderr:
            fail(f"path (o2): launch --plan did not run a verified plan:\n"
                 f"{on.stderr[-2000:]}")
        d_on = _digests(on.stdout, "false_serialization digest")
        d_off = _digests(done["(o2) false_serialization.py, "
                              "MPI4JAX_TPU_PLAN=0"],
                         "false_serialization digest")
        if d_on != d_off or len(d_on) != 3:
            fail(f"path (o2): digests with the plan {d_on}, without {d_off}")
        log(f"  (o2) launch -n 3 --plan false_serialization.py: verified "
            f"plan, 3 digests equal to the MPI4JAX_TPU_PLAN=0 run's; "
            f"{secs:.1f} s with the pre-flight, beside the plan-off run and "
            "(o3)'s analyzer")
        out["o2"] = {"seconds": secs}
        t0 = time.perf_counter()
        proc = _run("(o3) bucketed_dp_grad.py under its plan", launch + [
            "-n", "2", "--timeout", "300", bucketed] + dev_args,
            dict(env, MPI4JAX_TPU_PLAN=plan), 400)
        secs = time.perf_counter() - t0
    if proc.stdout.count("bucketed_dp_grad OK") != 2 \
            or "plan execution disabled" in proc.stderr:
        fail(f"path (o3): {proc.stdout[-1000:]}\n{proc.stderr[-1000:]}")
    log(f"  (o3) bucketed_dp_grad.py at np 2 under its emitted plan: OK on "
        f"both ranks, {secs:.1f} s")
    out["o3"] = {"seconds": secs}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 33: {out['seconds']:.1f} s [{card}]")
    return out


def path_p(dev, on_card, card):
    """Phase 34: path (p), live re-tuning onto the leg.  (p1) ``launch -n 4
    --fake-hosts 'r0,r1|r2,r3' --live`` of ``benchmarks.live_world``: path
    (g)'s f32 SUM allreduce (16 MiB a rank on the card) 30 times under a
    tune cache pinned to ``ring``; rank 0 proposes ``hring`` after call 10.
    Every rank reports epoch 1 and one swap at the same boundary; the calls
    before the commit ran ``ring`` and those after it ``hring``, each bit
    for bit its simulator on every rank, with kernel 3 launched 0 times per
    rank per call before the commit and once after it (each rank checks
    its own calls).  (p2) the same job without ``--live``: epoch 0, no
    swap, no boundary hook, every call ``ring``.  The ms per call, the
    slowest rank's median: (p1) before the proposal, (p2), (p1) after the
    swap."""
    from mpi4jax_tpu_torch.benchmarks import live_world

    if on_card:
        torch.cuda.empty_cache()
    mib = live_world.MIB if on_card else P_SMALL_MIB
    t_phase = time.perf_counter()
    runs = {}
    for name, is_live in (("p1", True), ("p2", False)):
        t0 = time.perf_counter()
        runs[name] = live_world.run_job(live=is_live, device=str(dev),
                                        mib=mib, timeout=300)
        runs[name]["job_seconds"] = time.perf_counter() - t0
    p1, p2 = runs["p1"], runs["p2"]
    n = p1["ranks"]
    commit = p1["commit_call"]
    if p1["epochs"] != [1] * n or p1["swaps"] != [1] * n \
            or len(set(p1["commit_boundaries"])) != 1 or commit is None:
        fail(f"path (p1): epochs {p1['epochs']}, swaps {p1['swaps']}, "
             f"commit boundaries {p1['commit_boundaries']}")
    if commit < p1["propose_after"] or p1["schedules"] != \
            ["ring"] * commit + ["hring"] * (p1["calls"] - commit):
        fail(f"path (p1): schedules {p1['schedules']}")
    want = [0] * commit + [int(on_card)] * (p1["calls"] - commit)
    if p1["launches"] != want:
        fail(f"path (p1): kernel 3 per call on rank 0 {p1['launches']}")
    if p2["epochs"] != [0] * n or p2["swaps"] != [0] * n \
            or p2["hooks_installed"] != [0] * n \
            or p2["schedules"] != ["ring"] * p2["calls"] \
            or any(p2["launches"]):
        fail(f"path (p2): epochs {p2['epochs']}, swaps {p2['swaps']}, "
             f"hooks {p2['hooks_installed']}, schedules {p2['schedules']}")
    p2_ms = statistics.median(p2["ms_slowest_rank"][1:p1["propose_after"]])
    log(f"  (p1) {n} ranks on {live_world.FAKE_HOSTS}, {p1['calls']} f32 SUM "
        f"allreduces of {p1['bytes']} B a rank on {p1['device']}: epoch 1 "
        f"on every rank, one swap at boundary {p1['commit_boundaries'][0]} "
        f"(a rendezvous every {p1['period']}), committed in call "
        f"{commit + 1}; calls 1-{commit} ring, {commit + 1}-{p1['calls']} "
        f"hring on the leg, each bit for bit its simulator on every rank; "
        f"kernel 3 launches by rank {p1['launches_by_rank']} (1 per call "
        f"after the commit, 0 before); job {p1['job_seconds']:.1f} s "
        f"[{card}]")
    log(f"  (p2) live off: epoch 0, no swap, no boundary hook, every call "
        f"ring; job {p2['job_seconds']:.1f} s")
    before = p1["ms_slowest_rank"][1:p1["propose_after"]]
    off = p2["ms_slowest_rank"][1:p1["propose_after"]]
    after = p1["ms_slowest_rank"][commit + 1:]
    log(f"  ms per call (the slowest rank's median, [min, max]): (p1) "
        f"before the proposal {p1['ms_before']:.3f} [{min(before):.3f}, "
        f"{max(before):.3f}] (calls 2-{p1['propose_after']}), (p2) "
        f"{p2_ms:.3f} [{min(off):.3f}, {max(off):.3f}] (the same calls), "
        f"(p1) after the swap {p1['ms_after']:.3f} [{min(after):.3f}, "
        f"{max(after):.3f}] (calls {commit + 2}-{p1['calls']}); the first "
        f"two differ by {p1['ms_before'] - p2_ms:+.3f}, the header bcast's "
        f"cost and the noise between two jobs [{card}]")
    out = {"p1": p1, "p2": p2, "p2_ms": p2_ms,
           "kernel3_launches": sum(p1["launches_by_rank"]),
           "seconds": time.perf_counter() - t_phase}
    log(f"  phase 34: {out['seconds']:.1f} s [{card}]")
    return out


def _q_job(tmp, name, np_, prog, args, env, flags=()):
    """One ``launch --elastic`` job of path (q), started; its checkpoints
    under ``tmp``."""
    env = dict(env, MPI4JAX_TPU_CKPT_DIR=os.path.join(tmp, f"ck_{name}"))
    return subprocess.Popen(
        [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch", "-n",
         str(np_), "--timeout", "400", "--elastic", *flags,
         os.path.join(REPO, "tests", "torch_world_programs", prog), *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _q_wait(what, proc):
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"path ({what}) exited {proc.returncode}:\n{stdout[-3000:]}\n"
             f"{stderr[-3000:]}")
    return stdout, stderr


def _q_resumed(what, stderr, last):
    """The steps the survivors resumed from, each strictly inside the job,
    and the launcher's "completed after recovery"."""
    import re

    steps = [int(k) for k in re.findall(r"resuming from step (\d+)",
                                        stderr)]
    if not steps or not all(0 < k < last for k in steps) \
            or "completed after recovery" not in stderr:
        fail(f"path ({what}): resumed from {steps} of {last} steps:\n"
             f"{stderr[-3000:]}")
    return steps


def _q_lines(stdout, marker):
    import re

    return [json.loads(m) for m in re.findall(marker + r" (\{.*\})",
                                              stdout)]


def path_q(on_card, card):
    """Phase 35: path (q), elastic worlds on the card, every job under
    ``launch --elastic`` with the shm arena off and its ranks on the card.

    (q1) ``elastic_train.py`` at np 3, 12 steps, a commit every 2, on CUDA
    tensors: uninterrupted, and with slot 1 killed by ``Q1_FAULT`` under
    ``shrink`` and under ``respawn``: every finishing rank's digest equal
    to the clean run's, bit for bit, the post-mortem's "completed after
    recovery", each survivor resumed from a step k with 0 < k < 12.  (q3)
    ``launch --plan --elastic`` of ``elastic_plan_bundle.py`` at np 3, clean
    and with ``Q3_FAULT``: the launcher's bundle covers np 3 and 2, the
    recovery prints "re-proved plan" for np=2 on both survivors, both end
    with "plan_active=1 mismatches=0" and the clean run's digest.  (q1) and
    (q3) run side by side, and beside them (q2)'s clean run.  (q2)
    ``gpt_dp_elastic.py --gpt2 --layers 2`` (GPT-2's widths at 2 of 12
    layers, bf16 compute, SGD through ``dp.elastic_step_fn``, a global
    batch of 12 sequences of 1024 from a seed per step, 8 steps, a commit
    every 2) at np 4 on ``r0,r1|r2,r3`` with the leg forced and every
    gradient allreduce on ``hring``; clean, then alone with slot 1 killed
    at the start of step 5 (``Q2_KILL``), shrinking to np 3 on the islands
    ``{0,1}|{2}`` and replaying step 4: the final full-batch loss within
    ``Q2_LOSS_BOUND`` relative of the clean run's, and the final
    parameters within ``Q2_PARAM_BOUND`` of the clean run's (relative to
    how far training moved them, a bound at least 3 times below the least
    step's update); the killed run's ``--route-check`` in each generation (every
    rank's synced gradient on the kernel route against the plain route's
    within ``gpt_step.ROUTE_TOL``, kernel 3's island sums bit for bit its
    plain version on the same gradients); on the card kernels 5, 6 and 7
    launched by every rank in every step and every route check before and
    after the recovery, kernel 3 by every rank of a two-member island (the
    rebuilt ``{0,1}`` after the recovery, none on rank 2); the step times
    before and after the recovery, and the time from the death to the
    first step of the new generation.  On the CPU (``--rehearse``) (q2)
    runs at the JAX program's small width."""
    if on_card:
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev_args = ["--device", "cuda" if on_card else "cpu"]
    env = dict(os.environ, MPI4JAX_TPU_DISABLE_SHM="1",
               MPI4JAX_TPU_TIMEOUT_S="30" if on_card else "10",
               MPI4JAX_TPU_ELASTIC_GRACE_S="60")
    for knob in ("MPI4JAX_TPU_FAULT", "MPI4JAX_TPU_PLAN",
                 "MPI4JAX_TPU_COLL_ALGO", "MPI4JAX_TPU_ICI_LEG"):
        env.pop(knob, None)
    out = {}
    with tempfile.TemporaryDirectory(prefix="path_q_") as tmp:
        t0 = time.perf_counter()
        side = {
            "q1 clean": _q_job(tmp, "q1c", 3, "elastic_train.py",
                               ["12", *dev_args], env),
            "q1 shrink": _q_job(tmp, "q1s", 3, "elastic_train.py",
                                ["12", *dev_args],
                                dict(env, MPI4JAX_TPU_FAULT=Q1_FAULT)),
            "q1 respawn": _q_job(tmp, "q1r", 3, "elastic_train.py",
                                 ["12", *dev_args],
                                 dict(env, MPI4JAX_TPU_FAULT=Q1_FAULT),
                                 ("--elastic-policy", "respawn")),
            "q3 clean": _q_job(tmp, "q3c", 3, "elastic_plan_bundle.py",
                               ["10", *dev_args], env, ("--plan",)),
            "q3 shrink": _q_job(tmp, "q3s", 3, "elastic_plan_bundle.py",
                                ["10", *dev_args],
                                dict(env, MPI4JAX_TPU_FAULT=Q3_FAULT),
                                ("--plan",)),
            "q2) clean": _q2_job(tmp, "clean", env, dev_args, on_card),
        }
        done = {what: _q_wait(what, proc) for what, proc in side.items()}
        secs = time.perf_counter() - t0
        d_clean = _digests(done["q1 clean"][0], "elastic_train digest")
        want = {r.split()[1] for r in d_clean}
        if len(d_clean) != 3 or len(want) != 1:
            fail(f"path (q1): clean digests {d_clean}")
        resumed = {}
        for policy, n in (("shrink", 2), ("respawn", 3)):
            stdout, stderr = done[f"q1 {policy}"]
            got = _digests(stdout, "elastic_train digest")
            if len(got) != n or {r.split()[1] for r in got} != want:
                fail(f"path (q1) {policy}: digests {got}, clean {want}")
            resumed[policy] = _q_resumed(f"q1) {policy}", stderr, 12)
        launches = {(d["rank"], d["size"], d["generation"]):
                    sum(d["launches"].values()) for d in _q_lines(
                        done["q1 shrink"][0], "elastic_train launches")}
        log(f"  (q1) elastic_train.py at np 3 on {dev_args[1]}, 12 steps: "
            f"shrink to np 2 resumed from step(s) {resumed['shrink']}, "
            f"respawn from {resumed['respawn']}; every finishing rank's "
            f"digest the clean run's {next(iter(want))[:16]}..., bit for "
            f"bit; kernel launches by (rank, size, generation) of the "
            f"shrunk world {launches}")
        stdout, stderr = done["q3 shrink"]
        clean3 = done["q3 clean"][0]
        d3 = {r.split()[1] for r in _digests(
            clean3, "elastic_plan_bundle digest")}
        if "plan bundle covers np=[2, 3]" not in stderr \
                or stderr.count("re-proved plan") != 2 \
                or "for the recovered np=2 world" not in stderr \
                or "plan execution disabled" in stderr \
                or clean3.count("np=3 plan_active=1 mismatches=0") != 3 \
                or stdout.count("np=2 plan_active=1 mismatches=0") != 2 \
                or {r.split()[1] for r in _digests(
                    stdout, "elastic_plan_bundle digest")} != d3 \
                or len(d3) != 1:
            fail(f"path (q3): the plan across the recovery:\n"
                 f"{stdout[-2000:]}\n{stderr[-3000:]}")
        log(f"  (q3) launch --plan --elastic of elastic_plan_bundle.py at "
            f"np 3: the bundle covers np 3 and 2, the recovery re-proved "
            f"the np=2 plan on both survivors, plan_active=1 mismatches=0, "
            f"the clean run's digest; (q1), (q3) and (q2)'s clean run side "
            f"by side {secs:.1f} s")
        out["q1_q3_seconds"] = secs
        out["q2"] = _path_q2(tmp, env, dev_args, on_card, card,
                             done["q2) clean"], secs)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 35: {out['seconds']:.1f} s [{card}]")
    return out


def _q2_job(tmp, name, env, dev_args, on_card):
    """One (q2) job, started: ``clean``, or ``kill`` (slot 1 killed at
    ``Q2_KILL``, the route checked in each generation); rank 0 writes the
    final parameters to ``<tmp>/q2<name>.npz``."""
    width = ["--gpt2", "--layers", "2"] if on_card else ["--batch", "12"]
    env = dict(env, MPI4JAX_TPU_ICI_LEG="force",
               MPI4JAX_TPU_COLL_ALGO="allreduce=hring")
    extra = ["--kill", Q2_KILL, "--route-check"] if name == "kill" else []
    return _q_job(tmp, f"q2{name}", 4, "gpt_dp_elastic.py",
                  [*dev_args, *width, "--steps", "8", "--out",
                   os.path.join(tmp, f"q2{name}.npz"), *extra], env,
                  ("--fake-hosts", ici_leg.FAKE_HOSTS))


def _q2_params_rel(tmp, movement):
    """The L2 of the recovered run's final parameters less the clean run's,
    over every field in f64, over the clean run's movement."""
    clean, kill = (np.load(os.path.join(tmp, f"q2{n}.npz"))
                   for n in ("clean", "kill"))
    diff = sum(float(np.square(kill[f].astype(np.float64) - clean[f]).sum())
               for f in clean.files) ** 0.5
    return diff / movement


def _path_q2(tmp, env, dev_args, on_card, card, clean_out, clean_secs):
    """Path (q2): the elastic DP GPT; the clean np 4 run has ended
    (``clean_out``), the run with slot 1 killed runs now, alone."""
    import re

    t0 = time.perf_counter()
    kill_out = _q_wait("q2) kill", _q2_job(tmp, "kill", env, dev_args,
                                            on_card))
    runs = {}
    for name, (stdout, stderr), secs in (
            ("clean", clean_out, clean_secs),
            ("kill", kill_out, time.perf_counter() - t0)):
        nums = dict(re.findall(
            r"gpt_dp_elastic (initial_loss|final_loss|movement) (\S+)",
            stdout))
        if len(nums) != 3:
            fail(f"path (q2) {name}: no final loss:\n{stdout[-2000:]}")
        runs[name] = {"loss": float(nums["final_loss"]),
                      "loss0": float(nums["initial_loss"]),
                      "movement": float(nums["movement"]),
                      "steps": _q_lines(stdout, "gpt_dp_elastic step"),
                      "routes": _q_lines(stdout, "gpt_dp_elastic route"),
                      "fails": _q_lines(stdout, "gpt_dp_elastic fail"),
                      "kills": _q_lines(stdout, "gpt_dp_elastic kill"),
                      "recovers": _q_lines(stdout, "gpt_dp_elastic recover"),
                      "seconds": secs, "stderr": stderr}
    clean, kill = runs["clean"], runs["kill"]
    resumed = _q_resumed("q2", kill["stderr"], 8)
    rel = abs(kill["loss"] - clean["loss"]) / abs(clean["loss"])
    if not rel <= Q2_LOSS_BOUND:
        fail(f"path (q2): final loss {kill['loss']!r} after the recovery, "
             f"{clean['loss']!r} clean: {rel:.3e} relative")
    # the parameters: a recovery that lost, repeated or part-trained a
    # step moves them by a step's update, far past the bound
    params_rel = _q2_params_rel(tmp, clean["movement"])
    least_update = min(s["update_l2"] for s in clean["steps"]) \
        / clean["movement"]
    if not (params_rel <= Q2_PARAM_BOUND
            and least_update > 3 * Q2_PARAM_BOUND
            and clean["loss0"] > clean["loss"]):
        fail(f"path (q2): final parameters {params_rel:.3e} of the clean "
             f"run's movement {clean['movement']!r} from the clean run's "
             f"(bound {Q2_PARAM_BOUND:g}); the least step's update "
             f"{least_update:.3e} of it; loss {clean['loss0']!r} at the "
             f"initial parameters, {clean['loss']!r} after training")
    before = [s for s in kill["steps"] if s["generation"] == 0]
    after = [s for s in kill["steps"] if s["generation"] == 1]
    if {(s["rank"], s["size"]) for s in after} != {(0, 3), (1, 3), (2, 3)} \
            or any(s["islands"] != [[0, 1], [2]] for s in after) \
            or len(kill["kills"]) != 1 \
            or min(resumed) not in {s["step"] for s in before}:
        fail("path (q2): the new world " + str(
            [(s["rank"], s["size"], s["islands"], s["step"])
             for s in after]) + f", resumed from {resumed}, no replay")
    flash_k = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    routes = {(r["generation"], r["rank"]): r for r in kill["routes"]}
    tol = gpt_bench.ROUTE_TOL["bfloat16" if on_card else "float32"]
    if sorted(routes) != [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1),
                          (1, 2)] \
            or not all(r["sync_bits"] and r["loss_rel"] <= tol["loss"]
                       and r["grad_rel"] <= tol["grad"]
                       for r in routes.values()):
        fail(f"path (q2): the kernel route against the plain route "
             f"{kill['routes']} (tolerance {tol})")
    if on_card:
        for what, steps in (("clean", clean["steps"]), ("before", before),
                            ("after", after),
                            ("route check", kill["routes"])):
            if any(s["launches"][k] <= 0 for s in steps for k in flash_k):
                fail(f"path (q2) {what}: a step without kernels 5-7")
        if any(s["launches"]["fused_ring"] <= 0 for s in clean["steps"]) \
                or any(routes[0, r]["launches"]["fused_ring"] <= 0
                       for r in range(4)):
            fail("path (q2): a clean step or a route check without kernel "
                 "3 on the leg")
        island = [s["launches"]["fused_ring"] for s in after
                  if s["rank"] in (0, 1)] + [
            routes[1, r]["launches"]["fused_ring"] for r in (0, 1)]
        if not island or min(island) <= 0 \
                or routes[1, 2]["launches"]["fused_ring"] != 0:
            fail(f"path (q2): kernel 3 on the rebuilt island {island}")
    t_death = kill["kills"][0]["t"]
    first_new = min(s["step"] for s in after)
    # the step's entry, before its route check
    t_resume = max(s["t_in"] for s in after if s["step"] == first_new)
    t_detect = min(f["t"] for f in kill["fails"]) if kill["fails"] else None
    recs = kill["recovers"]
    if len(recs) != 3:
        fail(f"path (q2): recoveries {recs}")
    # the recovery's split, the slowest survivor's end of each part
    split = {
        "announce_s": max(r["rebuild0"] for r in recs) - t_death,
        "rebuild_s": max(r["rebuild1"] - r["rebuild0"] for r in recs),
        "restore_s": t_resume - max(r["recover1"] for r in recs),
    }

    def step_ms(steps):
        by_step = {}
        for s in steps:
            by_step[s["step"]] = max(by_step.get(s["step"], 0.0),
                                     (s["t1"] - s["t0"]) * 1e3)
        return [by_step[k] for k in sorted(by_step)]

    def total(steps, k):
        return sum(s["launches"][k] for s in steps)

    res = {
        "loss_clean": clean["loss"], "loss_recovered": kill["loss"],
        "loss_initial": clean["loss0"], "loss_rel_diff": rel,
        "params_rel": params_rel, "least_update_rel": least_update,
        "movement": clean["movement"], "resumed": resumed,
        "route_checks": {f"{g}/{r}": {k: c[k] for k in (
            "loss_rel", "grad_rel", "sync_bits", "launches")}
            for (g, r), c in sorted(routes.items())},
        "step_ms_clean": step_ms(clean["steps"]),
        "step_ms_before": step_ms(before), "step_ms_after": step_ms(after),
        "recovery_s": t_resume - t_death,
        "detect_s": None if t_detect is None else t_detect - t_death,
        "recovery_split": split,
        "launches_clean": {k: total(clean["steps"], k)
                           for k in ("fused_ring", *flash_k)},
        "launches_before": {k: total(before, k)
                            for k in ("fused_ring", *flash_k)},
        "launches_after": {k: total(after, k)
                           for k in ("fused_ring", *flash_k)},
        "launches_after_by_rank": {
            s: {k: sum(x["launches"][k] for x in after if x["rank"] == s)
                for k in ("fused_ring", *flash_k)} for s in (0, 1, 2)},
        "seconds": {k: r["seconds"] for k, r in runs.items()},
    }
    at = ("GPT-2 widths, 2 of 12 layers, bf16" if on_card
          else "the small width")
    log(f"  (q2) GPT at {at}, "
        f"np 4 on {ici_leg.FAKE_HOSTS} with every gradient allreduce on the "
        f"leg; slot 1 killed at step {Q2_KILL.split(':')[1]}, resumed from "
        f"step(s) {resumed} on np 3, islands [[0, 1], [2]]; final loss "
        f"{kill['loss']!r} against {clean['loss']!r} clean, {rel:.3e} "
        f"relative (bound {Q2_LOSS_BOUND:g}), {clean['loss0']!r} at the "
        f"initial parameters; final parameters {params_rel:.3e} of the "
        f"clean run's movement {clean['movement']!r} from the clean run's "
        f"(bound {Q2_PARAM_BOUND:g}; the least step's update "
        f"{least_update:.3e} of it) [{card}]")
    log("    route checks (generation/rank: loss, synced gradient relative "
        "L2, kernel 3 bit for bit its plain version): " + ", ".join(
            f"{g}/{r} {c['loss_rel']:.2e} {c['grad_rel']:.2e} "
            f"{c['sync_bits']}" for (g, r), c in sorted(routes.items()))
        + f" (tolerance {tol})")
    log(f"    ms per step, the slowest rank: clean {res['step_ms_clean']}, "
        f"before the death {res['step_ms_before']}, after the recovery "
        f"{res['step_ms_after']}; death to the first step of generation 1 "
        f"{res['recovery_s']:.3f} s (to the first survivor's RankFailure "
        f"{res['detect_s']}); of it, until the slowest survivor began "
        f"its rebuild (detection, the announcement) "
        f"{split['announce_s']:.3f} s, the longest rebuild "
        f"{split['rebuild_s']:.3f} s, the restore and the first step's "
        f"start {split['restore_s']:.3f} s; seconds {res['seconds']} (the "
        f"clean run's beside (q1) and (q3))")
    log(f"    launches: clean {res['launches_clean']}, before the death "
        f"{res['launches_before']}, after {res['launches_after']} (by new "
        f"rank {res['launches_after_by_rank']})")
    return res


def path_m(dev, shape, on_card, card):
    """Phase 31: path (m), parts (m1)-(m3)."""
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    log("  (m1) the joint tuner, then algo=None under its cache")
    m1 = path_m1(dev, on_card, card)
    log("  (m2) checkpoint and resume")
    m2 = path_m2(dev, shape, on_card, card)
    log("  (m3) the token chain")
    m3 = path_m3(dev, on_card, card)
    secs = time.perf_counter() - t0
    log(f"  phase 31: {secs:.1f} s [{card}]")
    return {"m1": m1, "m2": m2, "m3": m3, "seconds": secs}


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
                    help="phases 2-4, 7-10, 12, 13, 15-17, 19-21 and 23-35 "
                         "on the CPU, plain versions, small size; prints no "
                         "result line")
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
    log(f"phase 25: path (h), the DP ResNet-50 step at n = "
        f"{', '.join(map(str, resnet_bench.RANKS))} [{card}]")
    h_runs = path_h(dev, on_card, card)
    log(f"phase 26: path (i), the pipeline-parallel GPT-2 124M step at pp "
        f"= {', '.join(map(str, pp_bench.PPS))} [{card}]")
    i_runs = path_i(dev, on_card, card)
    log(f"phase 27: path (j), Ulysses attention, moe_ffn and the int8 "
        f"allreduce at n = 4 [{card}]")
    j_runs = path_j(dev, on_card, card)
    log(f"phase 28: the world ops on {WORLD_RANKS} ranks on "
        f"{ici_leg.FAKE_HOSTS}, one process each [{card}]")
    path_world_ops(dev)
    log(f"phase 29: path (k), the world-tier solver on {GRID[0]}x{GRID[1]} "
        f"world ranks, {DAYS} day at {shape} [{card}]")
    path_k(dev, a, shape, card)
    log(f"phase 30: path (l), the tuner, then moe_ffn and the alltoall "
        f"family on {WORLD_RANKS} world ranks on {ici_leg.FAKE_HOSTS} with "
        f"the recorder [{card}]")
    l_run = path_l(on_card, card)
    log(f"phase 31: path (m), the joint tuner and algo=None under its cache "
        f"on {WORLD_RANKS} world ranks on {ici_leg.FAKE_HOSTS}, checkpoint "
        f"and resume, the token chain [{card}]")
    m_run = path_m(dev, shape, on_card, card)
    log(f"phase 32: path (n), the static verifier: path (l)'s and path "
        f"(k)'s programs at np=4, a refused launch [{card}]")
    path_n(on_card, card, l_run, shape)
    log(f"phase 33: path (o), plan execution: the chain pipeline, "
        f"launch --plan, a bucketed gradient sync under its plan [{card}]")
    path_o(on_card, card)
    log(f"phase 34: path (p), live re-tuning onto the leg on {WORLD_RANKS} "
        f"world ranks on {ici_leg.FAKE_HOSTS} [{card}]")
    p_run = path_p(dev, on_card, card)
    log(f"phase 35: path (q), elastic worlds: training that loses a rank "
        f"(shrink, respawn), launch --plan --elastic, and the DP GPT on "
        f"{WORLD_RANKS} world ranks on {ici_leg.FAKE_HOSTS} shrinking to 3 "
        f"[{card}]")
    q_run = path_q(on_card, card)
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
    h_launches = {k: sum(r["launches"][k] for key, r in h_runs.items()
                         if key != "route_check")
                  for k in resnet_bench.COLLECTIVES}
    i_launches = {k: sum(r["launches"][k] for key, r in i_runs.items()
                         if key != "route_check")
                  for k in pp_bench.COLLECTIVES}
    j_launches = {k: (j_runs["ulysses"]["launches_forward"][k]
                      + j_runs["ulysses"]["launches_forward_backward"][k]
                      + j_runs["moe"]["launches_forward_backward"][k]
                      + sum(r["launches"][k]
                            for key, r in j_runs["int8"].items()
                            if key != "device"))
                  for k in a2a_bench.COLLECTIVES}
    for row, name in ((hop_row, "hop"), (ring_row, "fused_ring"),
                      (a2a_row, "alltoall")):
        row["launches_path_h"] = h_launches.get(name, 0)
        row["launches_path_i"] = i_launches.get(name, 0)
        row["launches_path_j"] = j_launches.get(name, 0)
    m1, m2, m3 = m_run["m1"], m_run["m2"], m_run["m3"]
    sw_row["launches_path_m"] = m2["sw"]["kernel8_launches"]
    hop_row["launches_path_m"] = m3["launches"]["hop"]
    ring_row["launches_path_m"] = {
        "joint_ici_sub_jobs": m1["ici_launches"]["fused_ring"],
        "algo_none_job": m1["check_launches"]["fused_ring"],
        "token_chain": m3["launches"]["fused_ring"]}
    quant_row["launches_path_m"] = {
        "joint_ici_sub_jobs": m1["ici_launches"]["quant_pack"],
        "algo_none_job": m1["check_launches"]["quant_pack"]}
    quant_row["path_m"] = {
        "seconds": m_run["seconds"], "pick_16MiB": m1["pick"],
        "winners": m1["winners"], "tune_seconds": m1["tune_seconds"],
        "sub_jobs": m1["sub_jobs"],
        "checkpoint": m2}
    ring_row["launches_path_p"] = p_run["kernel3_launches"]
    q2 = q_run["q2"]
    ring_row["launches_path_q"] = {
        k: q2[k]["fused_ring"] for k in ("launches_clean", "launches_before",
                                         "launches_after")}
    flash_row["launches_path_q"] = {
        k: q2[k]["flash_fwd"] for k in ("launches_clean", "launches_before",
                                        "launches_after")}
    for row in bwd_rows:
        row["launches_path_q"] = {
            k: q2[k][row["name"]] for k in (
                "launches_clean", "launches_before", "launches_after")}
    ring_row["path_q"] = {k: q2[k] for k in (
        "loss_clean", "loss_recovered", "loss_rel_diff", "resumed",
        "step_ms_clean", "step_ms_before", "step_ms_after", "recovery_s",
        "detect_s", "recovery_split", "launches_after_by_rank")} | {
        "seconds": q_run["seconds"]}
    ring_row["path_p"] = {k: p_run[k] for k in ("p2_ms", "seconds")} | {
        name: {k: p_run[name][k] for k in (
            "epochs", "swaps", "commit_boundaries", "commit_call", "ms_before",
            "ms_after", "job_seconds", "bytes", "launches_by_rank")}
        for name in ("p1", "p2")}
    ring_row["path_h"] = h_runs
    hop_row["path_i"] = i_runs
    a2a_row["path_j"] = j_runs
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
