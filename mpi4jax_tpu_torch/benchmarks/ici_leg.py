"""Path (g): the world tier's hierarchical f32 allreduce, its intra-island
leg on the card.

The counterpart of ``benchmarks/ici_leg_sweep.py``: 4 ranks on
``--fake-hosts 'r0,r1|r2,r3'`` (2 islands of 2), one process each, all on
the one card; ``ops.allreduce(x, comm=world, algo=...)`` on each rank's
f32 tensor.  The knobs are process-wide, so each variant runs as its own
launched job:

- ``ring``: the native flat ring;
- ``hring``: the native hierarchical ring (``MPI4JAX_TPU_ICI_LEG=off``);
- ``hring+ici``: the leg (``MPI4JAX_TPU_ICI_LEG=force``): kernel 3 folds
  each island on the card;
- ``hring+q``: the native hierarchical ring with its quantized leader leg
  (``MPI4JAX_TPU_COLL_QUANT=force``, the leg off);
- ``hring+q+ici``: the leg with kernel 4 packing every island sum.

Per size, one record: the median ms per call over barrier-synchronized
calls (host clock around the front, which returns with the result on the
device), eff GB/s = 2(n-1)/n x bytes / s (path (b)'s convention), the
leg's phase split in ms per call (``_ici_leg.PHASE_SECONDS``: the intra
allgather; the fold, with its copy to the card and kernel 3; the pack,
kernel 4 with the frame's copy to the host, or in exact mode the island
sum's copy; the leader exchange; the fold of frames; the bcast), the
launches of kernels 3 and 4 per call on rank 0, and a correctness check:
the exact variants bit for bit against the simulators
(``topo/_simulate.py``), ``hring+q+ici`` bit for bit against
``simulate_ici_q_sum``, and ``hring+q`` (no bit model ported) within the
int8 bound 5e-2 of the exact sum and not bit for bit that sum.  The CUDA
contexts' start and the comm's creation are timed apart from the calls.

    python -m mpi4jax_tpu_torch.benchmarks.ici_leg --json
    python -m mpi4jax_tpu_torch.benchmarks.ici_leg --device cpu \\
        --sizes 65536 --variants hring+ici,hring+q+ici

prints one JSON line.  On the CPU the ranks' tensors live on the host, the
leg runs the plain versions, and the times measure nothing of the card.

The same file is the ranks' program (``--job spec.json``): ``run_job``
launches it through ``mpi4jax_tpu_torch.runtime.launch``, as the tests and
``chip_smoke.py`` do.  An algorithm of ``None`` checks the engine's own
pick (``algo=None``) under the job's knobs and tune cache, held to the
simulator of the schedule the comm reports (``WorldComm.coll_algo``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

if __package__ in (None, ""):  # run as the ranks' program by the launcher
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

T_START = time.perf_counter()

FAKE_HOSTS = "r0,r1|r2,r3"
RANKS = 4
# the sweep's sizes, then path (b)'s top size
SIZES = (64 * 1024, 1024 * 1024, 4 * 1024 * 1024, 16 * 1024 * 1024,
         64 * 1024 * 1024)
QUANT_BOUND = 5e-2  # relative to the exact sum (topo_ops.py:159-165)
VARIANTS = {
    "ring": ("ring", {"MPI4JAX_TPU_ICI_LEG": "off"}),
    "hring": ("hring", {"MPI4JAX_TPU_ICI_LEG": "off"}),
    "hring+ici": ("hring", {"MPI4JAX_TPU_ICI_LEG": "force"}),
    "hring+q": ("hring", {"MPI4JAX_TPU_ICI_LEG": "off",
                          "MPI4JAX_TPU_COLL_QUANT": "force"}),
    "hring+q+ici": ("hring", {"MPI4JAX_TPU_ICI_LEG": "force",
                              "MPI4JAX_TPU_COLL_QUANT": "force"}),
}


def calls_for(nbytes: int) -> int:
    """Timed calls per size: more for small payloads."""
    return max(5, min(30, int(4e8 / max(nbytes, 1))))


def rows_of(seed: int, count: int, size: int) -> np.ndarray:
    """Every rank's f32 input ``(size, count)`` from ``seed``."""
    return (np.random.RandomState(seed + count).randn(size, count)
            .astype(np.float32) * 2)


def expected(parts, islands, algo: str, leg: bool, quant: bool):
    """(model, kind, exact): the result the schedule must give, how it is
    held to it (``"bits"``, or ``"int8 bound"`` against the exact sum),
    and the exact schedule's result."""
    from mpi4jax_tpu_torch import topo
    from mpi4jax_tpu_torch.topo import _simulate as sim

    if algo in ("hring", "htree"):
        sim = (topo.simulate_hring_sum if algo == "hring"
               else topo.simulate_htree_sum)
        exact = sim(parts, islands, intra="ring" if leg else "member")
        if leg and quant:
            return topo.simulate_ici_q_sum(parts, islands), "bits", exact
    else:
        exact = {"ring": sim.simulate_ring_sum,
                 "qring": sim.simulate_ring_sum,
                 "rd": sim.simulate_rd_sum, "qrd": sim.simulate_rd_sum,
                 "tree": sim.simulate_tree_sum}[algo](parts)
    # the native quantized schedules are held to the int8 bound
    quant = quant or algo in ("qring", "qrd")
    return exact, "int8 bound" if quant else "bits", exact


def _check(out: np.ndarray, want: np.ndarray, kind: str, exact, what: str):
    """Hold ``out`` to ``want``; returns the relative error against the
    exact sum (0 for a bit-for-bit check of an exact schedule).  A
    quantized schedule (``"int8 bound"``) must also differ from the exact
    sum: bit for bit the exact schedule's result means that one ran."""
    if kind == "bits" and not np.array_equal(out.view(np.uint32),
                                             want.view(np.uint32)):
        raise AssertionError(
            f"{what}: differs from the simulator by "
            f"{float(np.max(np.abs(out - want))):.3e}")
    if kind == "int8 bound" and np.array_equal(out.view(np.uint32),
                                               exact.view(np.uint32)):
        raise AssertionError(f"{what}: bit for bit the exact schedule's "
                             "sum; the quantized schedule did not run")
    denom = max(float(np.max(np.abs(exact))), 1e-6)
    err = float(np.max(np.abs(out - exact))) / denom
    if err >= QUANT_BOUND:
        raise AssertionError(f"{what}: {err:.3e} of the exact sum's scale "
                             f"(bound {QUANT_BOUND})")
    return err


def _rank_job(path: str) -> None:
    """One rank of a launched job: checks, then timed calls; rank 0 writes
    the records to the spec's ``out``."""
    with open(path) as f:
        spec = json.load(f)
    os.environ.update(spec["env"])  # before the transport reads a knob

    import torch

    from mpi4jax_tpu_torch import ops, topo
    from mpi4jax_tpu_torch.ops import _collectives, quantized
    from mpi4jax_tpu_torch.runtime import bridge, transport
    from mpi4jax_tpu_torch.topo import _ici_leg
    from mpi4jax_tpu_torch.utils import config
    from mpi4jax_tpu_torch.utils.device import resolve_device

    dev = resolve_device(spec["device"])
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    else:
        torch.set_num_threads(1)  # four ranks share the host's cores
    ctx_s = time.perf_counter() - t0
    # the kernels' counts over this job, from 0
    _collectives.LAUNCHES["fused_ring"] = 0
    quantized.LAUNCHES["quant_pack"] = 0
    comm = transport.get_world_comm(device=dev)
    t0 = time.perf_counter()
    h = comm.handle
    comm_s = time.perf_counter() - t0
    rank, n = comm.rank(), comm.size()
    t = comm.topology()
    if t is None or t.islands != spec["islands"]:
        raise AssertionError(f"islands {t and t.islands}, expected "
                             f"{spec['islands']}")
    quant = config.quant_mode() == "force"
    leg = _ici_leg.ici_leg_status(h)["active"]
    my_island = len(t.island(rank))

    def counts_now():
        return {"fused_ring": _collectives.LAUNCHES["fused_ring"],
                "quant_pack": quantized.LAUNCHES["quant_pack"]}

    def want_launches(algo):
        on = leg and algo in ("hring", "htree") and dev.type == "cuda"
        return {"fused_ring": int(on and my_island > 1),
                "quant_pack": int(on and quant)}

    def call(x, algo):
        before = counts_now()
        out = ops.allreduce(x, comm=comm, algo=algo)
        after = counts_now()
        return out, {k: after[k] - before[k] for k in after}

    checks = []
    for count in spec["check_counts"]:
        base = rows_of(spec["seed"], count, n)
        parts = [base[r] for r in range(n)]
        x = torch.from_numpy(base[rank].copy()).to(dev)
        for forced in spec["algos"]:
            # None: the engine's pick for this payload
            algo = forced or comm.coll_algo("allreduce", x.nbytes)
            out, launched = call(x, forced)
            what = f"{spec['label']} {algo} count={count} rank {rank}"
            if out.device != dev or out.shape != x.shape:
                raise AssertionError(f"{what}: result on {out.device} of "
                                     f"shape {tuple(out.shape)}")
            got = out.cpu().numpy()
            want, kind, exact = expected(parts, t.islands, algo, leg,
                                         quant)
            err = _check(got, want, kind, exact, what)
            rows = bridge.allgather(h, got, n)
            if not all(np.array_equal(rows[r].view(np.uint32),
                                      got.view(np.uint32))
                       for r in range(n)):
                raise AssertionError(f"{what}: the ranks disagree")
            if launched != want_launches(algo):
                raise AssertionError(f"{what}: launched {launched}, "
                                     f"expected {want_launches(algo)}")
            checks.append({"count": count, "algo": algo, "forced": forced,
                           "check": kind, "rel_err": err,
                           "launches": launched})

    def timed(x, algo, calls):
        times = []
        _ici_leg.reset_phases()
        before = counts_now()
        for _ in range(calls):
            bridge.barrier(h)
            t0 = time.perf_counter()
            ops.allreduce(x, comm=comm, algo=algo)
            times.append(time.perf_counter() - t0)
        after = counts_now()
        return (statistics.median(times),
                {k: v / calls * 1e3 for k, v in
                 _ici_leg.PHASE_SECONDS.items()},
                {k: (after[k] - before[k]) / calls for k in after})

    records = []
    for nbytes in spec["sizes"]:
        count = nbytes // 4
        base = rows_of(spec["seed"], count, n)
        x = torch.from_numpy(base[rank].copy()).to(dev)
        algo = spec["algos"][0]
        out, _ = call(x, algo)  # warm-up, and the check of this size
        want, kind, exact = expected([base[r] for r in range(n)],
                                     t.islands, algo, leg, quant)
        err = _check(out.cpu().numpy(), want, kind, exact,
                     f"{spec['label']} {algo} {nbytes} B rank {rank}")
        del base, want, exact, out
        calls = spec["calls"] or calls_for(nbytes)
        s, phases, per_call = timed(x, algo, calls)
        rec = {"label": spec["label"], "algo": algo, "bytes": nbytes,
               "ranks": n, "calls": calls, "ms": s * 1e3,
               "eff_GBps": 2 * (n - 1) / n * nbytes / s / 1e9,
               "check": kind, "rel_err": err, "leg": leg,
               "phases_ms": phases if leg else None,
               "launches_per_call": per_call}
        if spec["beside"]:
            # the same schedule with the leg off: the native intra paths
            os.environ["MPI4JAX_TPU_ICI_LEG"] = "off"
            ops.allreduce(x, comm=comm, algo=algo)
            s_off, _, _ = timed(x, algo, calls)
            os.environ["MPI4JAX_TPU_ICI_LEG"] = spec["env"].get(
                "MPI4JAX_TPU_ICI_LEG", "auto")
            rec["leg_off_ms"] = s_off * 1e3
        records.append(rec)
        del x

    starts = bridge.allgather(h, np.array([ctx_s, comm_s,
                                           time.perf_counter() - T_START]),
                              n)
    launched = bridge.allgather(h, np.array(list(counts_now().values())), n)
    bridge.barrier(h)
    if rank == 0:
        with open(spec["out"], "w") as f:
            json.dump({"label": spec["label"], "env": spec["env"],
                       "device": str(dev), "leg": leg, "quant": quant,
                       "islands": t.islands, "tiers": t.tiers,
                       "ctx_seconds": starts[:, 0].tolist(),
                       "comm_seconds": starts[:, 1].tolist(),
                       "rank_seconds": starts[:, 2].tolist(),
                       "launches": dict(zip(counts_now(),
                                            launched.sum(0).tolist())),
                       "checks": checks, "records": records}, f)
    bridge.comm_finalize(h)


def run_job(label: str, *, device="cuda", algos=("hring",),
            check_counts=(), sizes=(), calls=None, beside=False, seed=0,
            timeout=600.0, env=None) -> dict:
    """Launch one job of ``RANKS`` ranks on ``FAKE_HOSTS`` with the
    variant ``label``'s knobs (or ``env``, when given) through the port's
    launcher and return rank 0's record; a failed rank or check raises."""
    from mpi4jax_tpu_torch import topo
    from mpi4jax_tpu_torch.runtime import launch

    by_host: dict = {}
    for r, host in enumerate(topo.parse_fake_hosts(FAKE_HOSTS, RANKS)):
        by_host.setdefault(host, []).append(r)
    islands = list(by_host.values())
    with tempfile.TemporaryDirectory(prefix="ici_leg_") as tmp:
        spec = {"label": label, "device": str(device), "algos": list(algos),
                "check_counts": list(check_counts), "sizes": list(sizes),
                "calls": calls, "beside": beside, "seed": seed,
                "env": dict(VARIANTS[label][1] if env is None else env),
                "islands": islands,
                "out": os.path.join(tmp, "out.json")}
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        rc = launch.main(["-n", str(RANKS), "--fake-hosts", FAKE_HOSTS,
                          "--timeout", str(timeout),
                          os.path.abspath(__file__), "--job", path])
        if rc != 0:
            raise RuntimeError(f"path (g) job {label!r} failed: the launcher "
                               f"exited {rc}")
        with open(spec["out"]) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="bytes per rank, comma-separated")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    if args.job:
        _rank_job(args.job)
        return 0

    import torch

    from mpi4jax_tpu_torch import _build
    from mpi4jax_tpu_torch.runtime import bridge

    t0 = time.perf_counter()
    bridge.build()
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("ici_leg: CUDA is not available; pass "
                             "--device cpu to run the plain versions")
        _build.build_all(["fused_ring", "quant_pack"])
    build_s = time.perf_counter() - t0
    sizes = [int(s) for s in args.sizes.split(",")]
    jobs = []
    for label in args.variants.split(","):
        algo = VARIANTS[label][0]
        t0 = time.perf_counter()
        rec = run_job(label, device=args.device, algos=(algo,), sizes=sizes,
                      seed=args.seed)
        rec["job_seconds"] = time.perf_counter() - t0
        jobs.append(rec)
        if not args.json:
            for r in rec["records"]:
                print(f"{label:12s} {r['bytes']:>10d} B: {r['ms']:9.3f} ms, "
                      f"{r['eff_GBps']:.3f} GB/s, launches/call "
                      f"{r['launches_per_call']}", file=sys.stderr)
    card = None
    if args.device.startswith("cuda"):
        import subprocess

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({"path": "g", "device": args.device, "card": card,
                      "ranks": RANKS, "fake_hosts": FAKE_HOSTS,
                      "build_seconds": build_s, "jobs": jobs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
