"""Path (l): MoE on a world comm, the world alltoall family, the recorder.

    python -m mpi4jax_tpu_torch.runtime.launch -n 4 --fake-hosts 'r0,r1|r2,r3' \\
        --trace out/l.json -m mpi4jax_tpu_torch.benchmarks.moe_world [--out DIR]

One process per rank (``MPI4JAX_TPU_DISABLE_SHM=1`` for the TCP schedules:
the shm arena wins over every forced one).  Each rank, on ``--device``
(default ``cuda``; all ranks share card 0):

- ``moe_ffn`` forward on the world comm at GPT-2's widths (d_model 768,
  d_ff 3072, one expert a rank, 8192 f32 tokens a rank, capacity factor
  1.25): four routes, ``auto`` (the installed table's pick), ``int8``
  (``compression="int8"``: qalltoall), ``halltoall`` and ``hqalltoall``
  (``algo=``); the median of ``--reps`` calls each, the stream synchronized
  after every call.  The outputs are held to a forced-``ring`` reference
  (bit for bit for the exact schedules, within the JAX package's int8
  bound, ``tests/world_programs/moe_ops.py``, for the quantized ones);
- the world alltoall alone on a dispatch-sized buffer ``(size, capacity,
  d_model)`` under ``ring``, ``qalltoall``, ``halltoall`` and
  ``hqalltoall``: the first call of each bit for bit against
  ``topo/_simulate.py`` on the ranks' allgathered inputs, then the median
  of ``--reps``;
- two f32 SUM allreduces of ``--leg-bytes`` a rank with ``algo="hring"``
  and ``MPI4JAX_TPU_ICI_LEG=force`` (the intra-island leg: kernel 3 folds
  each island, and under ``MPI4JAX_TPU_COLL_QUANT=force``, set for the
  second call only, kernel 4 packs the island sums; ``compression="int8"``
  would pick ``qring``, which the leg does not carry), each against its
  simulator, which put the leg's ``tier="ici"`` spans into the recording;
- first, the recorder's cost: the exact alltoall on the dispatch buffer
  and a 4 KiB f32 allreduce timed in ``REC_ROUNDS`` rounds, each with the
  recorder running, then after ``obs.stop()`` (the median of the rounds'
  medians), and ``CallTrace`` alone around an empty body, on and off (us
  per call, no transport); then the recorder is started again with the
  job's clock offset (``obs.start`` empties its rings: the rest of the job
  is what the recording holds);
- checks that ``tune.sources()`` names a tune cache (the job is meant to
  run under ``MPI4JAX_TPU_TUNE_CACHE``).

Rank 0 prints one JSON record (or writes ``DIR/record.json`` with
``--out``): per route and schedule the slowest rank's median ms, the
errors, the launches of kernels 3 and 4, the events recorded and dropped.

The same program runs under the static verifier (``python -m
mpi4jax_tpu_torch.analyze -m mpi4jax_tpu_torch.benchmarks.moe_world --np
4``, or ``launch --verify``), which serves every route exactly
(``comm.coll_algo`` answers ``"analysis"``): there each check's oracle is
the exact result (the plain rank-order fold for the leg), the recorder is
left alone (its on/off rounds still run their calls) and no record is
written, so a pre-flight leaves nothing in ``--out``.
``--family COUNTS`` is the test mode instead: every schedule and
``compression="int8"`` on f32, bf16 and int32 payloads, and ``moe_ffn`` on
a small layer, each rank's outputs written to ``DIR/rank<r>.npz`` for the
tests to hold to the simulators and the JAX package (``run_job``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

if __package__ in (None, ""):  # run as a file by the launcher
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

FAMILY = ("ring", "qalltoall", "halltoall", "hqalltoall")
#: moe_ffn's routes: keyword arguments of each
ROUTES = {"auto": {}, "int8": {"compression": "int8"},
          "halltoall": {"algo": "halltoall"},
          "hqalltoall": {"algo": "hqalltoall"}}
D_MODEL, D_FF, TOKENS, CAPACITY_FACTOR = 768, 3072, 8192, 1.25
LEG_BYTES = 16 * 1024 * 1024
LEG_REPS = 3  # timed calls of each leg allreduce
REC_BYTES = 4096  # the recorder-cost allreduce
REC_ROUNDS = 3
TRACE_CALLS = 20000  # CallTrace enter/exit pairs timed on and off
#: the int8 MoE bound against the exact output
#: (``tests/world_programs/moe_ops.py:100``)
INT8_RTOL, INT8_ATOL = 1e-1, 0.2
#: and the tighter bound read at full width: 3x the largest |y - exact|
#: measured there (2.697e-2 on an H100, PERF.md section 5), so a route
#: that misplaced tokens fails although it stays inside the bound above
INT8_MAX_ABS = 3 * 2.697e-2
#: the test mode's payloads and its small layer
FAMILY_COUNTS = (3, 513, 20000)
SMALL = {"d_model": 8, "d_ff": 16, "tokens": 16}
SEED = 11


def family_inputs(size: int, count: int, seed: int = SEED):
    """Every rank's ``(size, count)`` send matrices, from one seed: f32,
    bf16 (as f32 values of bf16 numbers) and int32, each ``(size, size,
    count)`` with ``[r]`` rank r's."""
    rng = np.random.RandomState(seed + count)
    f32 = (rng.randn(size, size, count) * 3).astype(np.float32)
    i32 = rng.randint(-900, 900, size=(size, size, count)).astype(np.int32)
    bf16 = (bf16_bits(f32).view(np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)
    return {"float32": f32, "bfloat16": bf16, "int32": i32}


def bf16_bits(a32: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest, ties to even), as the int16
    bits that a bf16 tensor's ``view(torch.int16)`` shows."""
    bits = np.ascontiguousarray(a32, np.float32).view(np.uint32)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                           & np.uint32(1))) >> np.uint32(16)
    return rounded.astype(np.uint16).view(np.int16)


def schedule_run(label: str, quant="allow", hier="allow") -> str:
    """The schedule that serves a call of the test mode under the gates:
    ``label`` is "auto", "int8" or a forced schedule; the transport
    degrades along one gate axis at a time (``tests/world/
    test_moe_alltoall.py``)."""
    run = {"auto": "ring",
           "int8": "ring" if quant == "deny" else "qalltoall"}.get(label,
                                                                   label)
    if quant == "deny":
        run = {"qalltoall": "ring", "hqalltoall": "halltoall"}.get(run, run)
    elif quant == "force":
        run = {"ring": "qalltoall", "halltoall": "hqalltoall"}.get(run, run)
    if hier == "deny":
        run = {"halltoall": "ring", "hqalltoall": "qalltoall"}.get(run, run)
    return run


def family_expected(sim, inputs, islands, label, dtype, quant="allow",
                    hier="allow"):
    """Every rank's output of the test mode's call ``label`` on
    ``inputs`` (one ``(size, count)`` matrix per rank, bf16 as f32 values)
    under the gates, from ``sim``'s alltoall simulators (the port's
    ``topo`` or the JAX package's): int32 always moves exactly; bf16 as the
    int16 bits of the f32 staging's result rounded to bf16."""
    n = len(inputs)
    exact = [np.stack([inputs[s][d] for s in range(n)]) for d in range(n)]
    run = "ring" if dtype == "int32" else schedule_run(label, quant, hier)
    if run == "qalltoall":
        outs = sim.simulate_qalltoall(inputs)
    elif run == "hqalltoall":
        outs = sim.simulate_hqalltoall(inputs, islands)
    else:
        outs = exact
    if dtype == "bfloat16":
        return [bf16_bits(o) for o in outs]
    return [np.asarray(o, inputs[0].dtype) for o in outs]


def small_moe_inputs(size: int, seed: int = SEED):
    """The test mode's layer: ``(params stacked over ranks, x (size, t,
    d))`` from numpy seeds (``moe.init_moe_params``)."""
    from mpi4jax_tpu_torch.parallel import moe

    params = moe.init_moe_params(SMALL["d_model"], SMALL["d_ff"], size,
                                 seed)
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(size, SMALL["tokens"], SMALL["d_model"]).astype(
        np.float32)
    return params, x


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(fn, reps, dev, barrier):
    times = []
    for _ in range(reps):
        barrier()
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _family_rank(comm, dev, counts, out_dir):
    """The test mode: every schedule's output on this rank, to npz."""
    import torch

    import mpi4jax_tpu_torch as mt
    from mpi4jax_tpu_torch.parallel import moe

    rank, n = comm.rank(), comm.size()
    res = {}
    for count in counts:
        base = family_inputs(n, count)
        for dt, arr in base.items():
            x = torch.from_numpy(arr[rank].copy())
            if dt == "bfloat16":
                x = x.to(torch.bfloat16)
            x = x.to(dev)
            calls = {"auto": {}, **{a: {"algo": a} for a in FAMILY}}
            if dt != "int32":
                calls["int8"] = {"compression": "int8"}
            for label, kw in calls.items():
                out = mt.alltoall(x, comm=comm, **kw).cpu()
                if dt == "bfloat16":
                    out = out.view(torch.int16)
                res[f"{dt}|{label}|{count}"] = out.numpy()
    params, xs = small_moe_inputs(n)
    p = moe.params_from_numpy(params, dev, rank=rank)
    x = torch.from_numpy(xs[rank]).to(dev)
    for label, kw in ROUTES.items():
        res[f"moe|{label}"] = moe.moe_ffn(x, p, comm=comm, **kw).cpu().numpy()
    res["moe|drop"] = moe.moe_ffn(x, p, comm=comm,
                                  capacity_factor=0.5).cpu().numpy()
    # the world alltoall has no gradient, as in the JAX package
    g = torch.ones((n, 4), device=dev, requires_grad=True)
    try:
        mt.alltoall(g, comm=comm, algo="qalltoall").sum().backward()
        res["grad_raises"] = np.array(False)
    except NotImplementedError:
        res["grad_raises"] = np.array(True)
    res["moe|pick"] = np.array(comm.coll_algo(
        "alltoall", 4 * n * moe.expert_capacity(SMALL["tokens"], n)
        * SMALL["d_model"]))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    mt.barrier(comm=comm)


def _check(what, got, want, *, exact):
    """Bit for bit, or within both int8 bounds of the reference."""
    if exact:
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: not bit for bit (max diff "
                                 f"{np.max(np.abs(got - want)):.3e})")
        return 0.0
    err = float(np.max(np.abs(got - want)))
    if not np.allclose(got, want, rtol=INT8_RTOL, atol=INT8_ATOL):
        raise AssertionError(f"{what}: max diff {err:.3e} outside the int8 "
                             f"bound rtol {INT8_RTOL} atol {INT8_ATOL}")
    if err > INT8_MAX_ABS:
        raise AssertionError(f"{what}: max diff {err:.3e} above "
                             f"{INT8_MAX_ABS:.3e}, 3x the full-width reading")
    return err


def _path_rank(comm, dev, args):
    """Path (l) on this rank; returns rank 0's record (None elsewhere)."""
    import torch

    import mpi4jax_tpu_torch as mt
    from mpi4jax_tpu_torch import obs, topo, tune
    from mpi4jax_tpu_torch.benchmarks import ici_leg
    from mpi4jax_tpu_torch.ops import _collectives, quantized
    from mpi4jax_tpu_torch.parallel import moe
    from mpi4jax_tpu_torch.runtime import bridge
    from mpi4jax_tpu_torch.utils import tracing

    rank, n = comm.rank(), comm.size()
    t = comm.topology()
    # the static verifier's virtual world serves every route exactly
    served_exactly = comm.coll_algo("alltoall", 0) == "analysis"
    sources = tune.sources()
    if not any(s.startswith("cache:") for s in sources):
        raise AssertionError(f"rank {rank}: no tune cache in {sources}")
    if not served_exactly and not obs.enabled():
        raise AssertionError(f"rank {rank}: the recorder is not armed "
                             "(run under launch --trace)")

    def barrier():
        mt.barrier(comm=comm)

    def recorder(on):
        # the recorder's rounds; the virtual world records nothing
        if served_exactly:
            return
        if on:
            obs.start(lib=bridge.get_lib(), rank=rank, size=n,
                      clock_offset_s=offset_s)
        else:
            obs.stop()

    d, ff, tok = args.d_model, args.d_ff, args.tokens
    cap = moe.expert_capacity(tok, n, CAPACITY_FACTOR)
    disp_bytes = 4 * n * cap * d
    rec = {"ranks": n, "device": str(dev), "islands": t.islands,
           "tiers": t.tiers, "sources": sources, "d_model": d, "d_ff": ff,
           "tokens": tok, "capacity": cap, "dispatch_bytes": disp_bytes,
           "auto_pick": comm.coll_algo("alltoall", disp_bytes),
           "reps": args.reps}

    buf = torch.from_numpy(np.random.RandomState(args.seed + 100 + rank)
                           .randn(n, cap, d).astype(np.float32)).to(dev)

    # ---- the recorder's cost: rounds on and off ------------------------
    small = torch.ones(REC_BYTES // 4, device=dev)
    calls = {"alltoall": (lambda: mt.alltoall(buf, comm=comm, algo="ring"),
                          args.reps),
             "allreduce_4KiB": (lambda: mt.allreduce(small, comm=comm),
                                args.small_reps)}
    for fn, _ in calls.values():
        fn()  # warm-up
    rounds = {f"{k}_{state}": [] for k in calls for state in ("on", "off")}
    offset_s = obs.clock_offset_us() / 1e6
    for _ in range(REC_ROUNDS):
        for state in ("on", "off"):
            if state == "off":
                recorder(False)
            for k, (fn, reps) in calls.items():
                rounds[f"{k}_{state}"].append(_median_ms(fn, reps, dev,
                                                         barrier))
            if state == "off":
                recorder(True)
    rec_ms = {k: statistics.median(v) for k, v in rounds.items()}
    trace_us = {}
    for state in ("on", "off"):
        if state == "off":
            recorder(False)
        t0 = time.perf_counter()
        for _ in range(TRACE_CALLS):
            with tracing.CallTrace(rank, "Alltoall", "", nbytes=disp_bytes):
                pass
        trace_us[state] = (time.perf_counter() - t0) / TRACE_CALLS * 1e6
    # the recording holds what follows: the job's trace starts here
    recorder(True)

    # ---- moe_ffn, four routes ---------------------------------------
    params = moe.init_moe_params(d, ff, n, args.seed)
    p = moe.params_from_numpy(params, dev, rank=rank)
    del params
    x = torch.from_numpy(np.random.RandomState(args.seed + 1 + rank).randn(
        tok, d).astype(np.float32)).to(dev)
    ref = moe.moe_ffn(x, p, comm=comm, algo="ring").cpu().numpy()
    if not np.isfinite(ref).all() or ref.shape != (tok, d):
        raise AssertionError(f"rank {rank}: exact moe_ffn gave shape "
                             f"{ref.shape} or non-finite values")
    moe_ms, moe_err = {}, {}
    for label, kw in ROUTES.items():
        got = moe.moe_ffn(x, p, comm=comm, **kw).cpu().numpy()
        algo = kw.get("algo") or ("qalltoall" if kw else rec["auto_pick"])
        exact = served_exactly or algo in ("ring", "halltoall")
        moe_err[label] = _check(f"rank {rank} moe_ffn {label}", got, ref,
                                exact=exact)
        moe_ms[label] = _median_ms(
            lambda kw=kw: moe.moe_ffn(x, p, comm=comm, **kw), args.reps,
            dev, barrier)
    rec["moe_bit_for_bit"] = [k for k, v in moe_err.items() if v == 0.0]
    del p, x

    # ---- the alltoall alone on the dispatch buffer -------------------
    every = mt.allgather(buf, comm=comm).cpu().numpy()
    inputs = [every[r] for r in range(n)]
    del every
    exact = topo.simulate_halltoall(inputs)  # the permutation, bit for bit
    sims = {"ring": exact, "halltoall": exact,
            "qalltoall": exact if served_exactly
            else topo.simulate_qalltoall(inputs),
            "hqalltoall": exact if served_exactly
            else topo.simulate_hqalltoall(inputs, t.islands)}
    del inputs, exact
    a2a_ms = {}
    for algo in FAMILY:
        got = mt.alltoall(buf, comm=comm, algo=algo).cpu().numpy()
        _check(f"rank {rank} alltoall {algo}", got, sims[algo][rank],
               exact=True)
        a2a_ms[algo] = _median_ms(
            lambda a=algo: mt.alltoall(buf, comm=comm, algo=a), args.reps,
            dev, barrier)
    del sims

    # ---- the intra-island leg: kernels 3 and 4 in the recording ------
    count = args.leg_bytes // 4
    base = ici_leg.rows_of(args.seed, count, n)
    parts = [base[r] for r in range(n)]
    lx = torch.from_numpy(base[rank].copy()).to(dev)
    del base
    leg = {}
    for label, quant in (("hring", False), ("hring+q", True)):
        knobs = {"MPI4JAX_TPU_ICI_LEG": "force"}
        if quant:
            knobs["MPI4JAX_TPU_COLL_QUANT"] = "force"
        saved = {k: os.environ.get(k) for k in knobs}
        os.environ.update(knobs)
        try:
            _collectives.LAUNCHES["fused_ring"] = 0
            quantized.LAUNCHES["quant_pack"] = 0
            out = mt.allreduce(lx, comm=comm, algo="hring").cpu().numpy()
            if served_exactly:  # the plain rank-order fold
                want = parts[0]
                for part in parts[1:]:
                    want = want + part
                kind, exact_sum = "bits", want
            else:
                want, kind, exact_sum = ici_leg.expected(
                    parts, t.islands, "hring", True, quant)
            err = ici_leg._check(out, want, kind, exact_sum,
                                 f"rank {rank} leg {label}")
            ms = _median_ms(lambda: mt.allreduce(lx, comm=comm,
                                                 algo="hring"),
                            LEG_REPS, dev, barrier)
            calls = 1 + LEG_REPS
            leg[label] = {
                "ms": ms, "check": kind, "rel_err": err,
                "launches": {"fused_ring": _collectives.LAUNCHES["fused_ring"],
                             "quant_pack": quantized.LAUNCHES["quant_pack"]},
                "calls": calls}
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    del lx, parts

    events = obs.events()
    stats = obs.stats()

    # ---- the slowest rank's numbers ----------------------------------
    keys = ([f"moe|{k}" for k in moe_ms] + [f"a2a|{k}" for k in a2a_ms]
            + [f"leg|{k}" for k in leg]
            + [f"rec|{k}" for k in rec_ms]
            + [f"trace|{k}" for k in trace_us])
    vals = ([moe_ms[k] for k in moe_ms] + [a2a_ms[k] for k in a2a_ms]
            + [leg[k]["ms"] for k in leg] + list(rec_ms.values())
            + list(trace_us.values()))
    allv = mt.allgather(torch.tensor(vals, dtype=torch.float64, device=dev),
                        comm=comm).cpu().numpy()
    counts = mt.allgather(torch.tensor(
        [len(events), sum(stats["dropped"].values())]
        + [leg[k]["launches"][c] for k in leg
           for c in ("fused_ring", "quant_pack")], dtype=torch.int64,
        device=dev), comm=comm).cpu().numpy()
    slow = dict(zip(keys, allv.max(0).tolist()))
    mt.barrier(comm=comm)
    if rank != 0:
        return None
    rec.update({
        "moe_ms": {k: slow[f"moe|{k}"] for k in moe_ms},
        "moe_max_abs_err": moe_err,
        "alltoall_ms": {k: slow[f"a2a|{k}"] for k in a2a_ms},
        "alltoall_bit_for_bit": list(FAMILY),
        "leg": {k: dict(v, ms=slow[f"leg|{k}"], launches_all_ranks={
            c: int(counts[:, 2 + 2 * i + j].sum())
            for j, c in enumerate(("fused_ring", "quant_pack"))})
            for i, (k, v) in enumerate(leg.items())},
        "recorder_ms": {k: slow[f"rec|{k}"] for k in rec_ms},
        "recorder_rounds_rank0": rounds,
        "call_trace_us": {k: slow[f"trace|{k}"] for k in trace_us},
        "events_per_rank": counts[:, 0].tolist(),
        "dropped_per_rank": counts[:, 1].tolist(),
    })
    return rec


def run_rank(args) -> None:
    import torch

    from mpi4jax_tpu_torch.runtime import transport
    from mpi4jax_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        torch.set_num_threads(1)  # the ranks share the host's cores
    comm = transport.get_world_comm(device=dev)
    if args.family:
        counts = [int(c) for c in args.family.split(",")]
        _family_rank(comm, dev, counts, args.out)
        return
    rec = _path_rank(comm, dev, args)
    if comm.coll_algo("alltoall", 0) == "analysis":
        return  # under the static verifier: nothing for a job to read
    if rec is not None:
        line = json.dumps(rec)
        if args.out:
            with open(os.path.join(args.out, "record.json"), "w") as f:
                f.write(line)
        else:
            print(line, flush=True)


def run_job(ranks: int, out_dir: str, *, device="cuda", fake_hosts=None,
            env=None, trace=None, family=FAMILY_COUNTS, timeout=300.0):
    """Launch ``ranks`` ranks of the test mode in-process through the
    port's launcher (``env`` is set in the ranks before the transport
    loads); a failed rank raises.  Returns the ranks' npz results."""
    from mpi4jax_tpu_torch.runtime import launch

    spec = {"env": dict(env or {})}
    path = os.path.join(out_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    argv = ["-n", str(ranks), "--timeout", str(timeout)]
    if fake_hosts:
        argv += ["--fake-hosts", fake_hosts]
    if trace:
        argv += ["--trace", trace]
    rc = launch.main(argv + [os.path.abspath(__file__), "--job", path,
                             "--device", str(device), "--out", out_dir,
                             "--family", ",".join(map(str, family))])
    if rc != 0:
        raise RuntimeError(f"moe_world job of {ranks} ranks failed: the "
                           f"launcher exited {rc}")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(ranks)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--d-model", type=int, default=D_MODEL)
    ap.add_argument("--d-ff", type=int, default=D_FF)
    ap.add_argument("--reps", type=int, default=10,
                    help="timed calls of each route and schedule")
    ap.add_argument("--leg-bytes", type=int, default=LEG_BYTES)
    ap.add_argument("--small-reps", type=int, default=100,
                    help="timed calls of the 4 KiB allreduce")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for record.json (rank 0) or, with "
                         "--family, the ranks' npz files")
    ap.add_argument("--family", default=None, metavar="COUNTS",
                    help="the test mode at these payload counts")
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.job:
        with open(args.job) as f:
            os.environ.update(json.load(f)["env"])
    run_rank(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
