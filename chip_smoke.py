#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py             # on a machine with an NVIDIA card
    python3 chip_smoke.py --rehearse  # on the CPU, plain path, small size

Phases, each of which fails the run (non-zero exit) if its check fails:

1. the card's name and power limit; build the fused-step kernel
   ``mpi4jax_tpu_torch/csrc/sw_step.cu`` with nvcc (build time, ptxas
   lines);
2. the kernel against its plain PyTorch version on the card at 1800x3600:
   the Euler step from a check state (the initial jet with seeded
   grid-scale noise), and fuse=1 and fuse=3 from that state after two plain
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
5. the kernel's time per launch (CUDA events) at fuse=3 and fuse=1, beside
   its memory bound and the plain version's time.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a card the run fails and prints
no result.  ``--rehearse`` runs phases 2-4 on the CPU through the plain
path at a small size and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from mpi4jax_tpu_torch import _build
from mpi4jax_tpu_torch.models import _sw_check as chk
from mpi4jax_tpu_torch.models import _sw_kernel as kernel
from mpi4jax_tpu_torch.models import shallow_water as sw

SHAPE = (1800, 3600)
EDGE_SHAPES = [(16, 32), (22, 32), (70, 50)]
DAYS = 0.1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published
# flops of one cell-step of the fused kernel, counted in csrc/sw_step.cu:
# fluxes/q/ke 30, tendencies and Adams-Bashforth 48, viscous fluxes 12,
# viscous update 14
FLOPS_PER_CELL_STEP = 104


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

    kernel.LAUNCHES = 0
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
                    help="phases 2-4 on the CPU, plain path, small size; "
                         "prints no result line")
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
        _build.library("sw_step")
        log(f"build: csrc/sw_step.cu in {time.perf_counter() - t0:.2f} s")
        for line in _build.LOGS.get("sw_step", "").splitlines():
            if "ptxas" in line or "error" in line or "warning" in line:
                log(f"  sw_step: {line.strip()}")
    else:
        dev = torch.device("cpu")
        shape, reps = (64, 128), 1
        card = kind = "cpu (rehearsal)"

    log(f"phase 2: kernel vs plain at {shape}")
    max_abs, max_rel = check_kernel(shape, dev, (1, 3))
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

    if not on_card:
        log("rehearsal done (no result line: not a chip run)")
        return 0

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
    for fuse in (3, 1):
        ms = launch_ms(fuse)
        plain_ms = time_ms(
            lambda: kernel.fused_step_plain(s, p, first=False, fuse=fuse), 5)
        mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        op_ms = FLOPS_PER_CELL_STEP * fuse * cells / F32_FLOPS_PER_S * 1e3
        bound_ms = max(mem_ms, op_ms)
        rows[fuse] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes" if mem_ms >= op_ms else "operations")
        log(f"  fuse={fuse}: {ms:.4f} ms/launch ({ms / fuse:.4f} ms/step), "
            f"bound {bound_ms:.4f} ms ({rows[fuse]['bound_by']}: "
            f"{mem_ms:.4f} ms bytes, {op_ms:.4f} ms flops), "
            f"{bound_ms / ms:.3f} of the bound; plain {plain_ms:.4f} ms")

    row = {
        "name": "sw_fused_step", "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/sw_step.cu",
        "replaces": "mpi4jax_tpu/models/_sw_pallas.py:82",
        "launches": launches, "max_abs_err": max_abs,
        "err_over_scale": max_rel, "tolerance": chk.CHECK_TOL, "ok": True, "ms": rows[3]["ms"], "plain_ms": rows[3]["plain_ms"],
        "bound_ms": rows[3]["bound_ms"], "bound_by": rows[3]["bound_by"],
        "library_ms": None, "fuse": 3, "ms_fuse1": rows[1]["ms"],
        "plain_ms_fuse1": rows[1]["plain_ms"],
        "bound_ms_fuse1": rows[1]["bound_ms"], "shape": list(shape),
        "day_seconds_fuse3": secs3, "day_seconds_fuse1": secs1,
        "plain_day_seconds": plain_secs, "card": card,
    }
    log(f"card: {card}")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
