"""The port's world alltoall family and MoE on a world comm, held to the JAX
package on the CPU.

Launched CPU worlds of ``mpi4jax_tpu_torch/benchmarks/moe_world.py``'s test
mode (``--family``, ``device="cpu"``, one process per rank,
``torch.set_num_threads(1)``, ``MPI4JAX_TPU_DISABLE_SHM=1`` so the TCP
schedules really run, no tune cache), started side by side from one module
fixture while the JAX references compute in this process:

- ``np4``: 4 ranks on ``r0,r1|r2,r3``, under ``launch --trace``;
- ``np6``: 6 ranks on ``r0,r1,r2,r3|r4,r5`` (uneven islands);
- ``deny``, ``force``, ``hier_deny``: 3 ranks on ``r0,r1|r2`` (an island
  of one: its leader exchanges alone) under ``MPI4JAX_TPU_COLL_QUANT=deny``,
  ``=force`` and ``MPI4JAX_TPU_HIER=deny``;
- the tuner's CLI at np=2 (``python -m mpi4jax_tpu_torch.tune``).

Each rank writes the outputs of the auto pick, of ``algo=`` ring,
qalltoall, halltoall and hqalltoall and of ``compression="int8"`` on f32,
bf16 and int32 payloads of 3, 513 and 20000 elements a chunk.  They must
equal, bit for bit, the JAX package's simulators (``topo.
simulate_qalltoall``, ``simulate_halltoall``, ``simulate_hqalltoall``)
computed here on the same seeded inputs, through the schedule that the
gates leave (``moe_world.schedule_run``, the degrades of
``tests/world/test_moe_alltoall.py``); int32 always moves exactly, bf16
rides the f32 staging and is rounded to nearest even.

``moe_ffn`` on the world comm (4 and 6 ranks, d_model 8, d_ff 16, 16
tokens a rank, the port's numpy parameters sliced per rank by
``params_from_numpy(rank=)``) against the JAX package's ``moe_ffn`` on a
mesh of the same size on the same parameters: the exact route within rtol
1e-5 and atol 1e-6 (the expert products sum in other orders), also at a
capacity factor of 0.5 that drops tokens; ``halltoall`` bit for bit the
port's exact route; int8 and ``hqalltoall`` within the JAX package's int8
bound (rtol 1e-1, atol 0.2, ``tests/world_programs/moe_ops.py``).

The ``np4`` job's merged trace passes the JAX package's
``validate_chrome_trace``, its part files load through JAX's
``load_events`` (a stale part of an earlier 8-rank run at the same path is
removed by the launcher), and the tuner's cache loads through JAX's
``load_cache``.
"""

import importlib
import json
import os
import shutil
import tempfile
import threading

import jax
import numpy as np
import pytest

import mpi4jax_tpu as m4j
from mpi4jax_tpu import obs as jobs
from mpi4jax_tpu import topo as jtopo
from mpi4jax_tpu import tune as jtune
from mpi4jax_tpu.parallel import moe as jmoe

from mpi4jax_tpu_torch import obs
from mpi4jax_tpu_torch.benchmarks import moe_world as mw

ISL3 = "r0,r1|r2"
ISL4 = "r0,r1|r2,r3"
ISL6 = "r0,r1,r2,r3|r4,r5"
JOBS = {
    "np4": (4, ISL4, {}),
    "np6": (6, ISL6, {}),
    "deny": (3, ISL3, {"MPI4JAX_TPU_COLL_QUANT": "deny"}),
    "force": (3, ISL3, {"MPI4JAX_TPU_COLL_QUANT": "force"}),
    "hier_deny": (3, ISL3, {"MPI4JAX_TPU_HIER": "deny"}),
}
GATES = {"np4": ("allow", "allow"), "np6": ("allow", "allow"),
         "deny": ("deny", "allow"), "force": ("force", "allow"),
         "hier_deny": ("allow", "deny")}
LABELS = ("auto", "ring", "qalltoall", "halltoall", "hqalltoall", "int8")


def _islands(spec, n):
    groups = {}
    for r, label in enumerate(jtopo.parse_fake_hosts(spec, n)):
        groups.setdefault(label, []).append(r)
    return list(groups.values())


def _jax_moe(n):
    """The JAX package's moe_ffn on an n-rank mesh, on the test mode's
    parameters and tokens, at capacity factors 1.25 and 0.5: ``{cf: (n,
    t, d)}``, one compile."""
    params, xs = mw.small_moe_inputs(n)
    mesh = m4j.make_mesh(n)

    def per(x, p):
        p = {k: v[0] for k, v in p.items()}
        return tuple(jmoe.moe_ffn(x[0], p, capacity_factor=cf)[None]
                     for cf in (1.25, 0.5))

    out = jax.jit(m4j.spmd(per, mesh=mesh))(xs, params)
    return {cf: np.asarray(y) for cf, y in zip((1.25, 0.5), out)}


@pytest.fixture(scope="module")
def world():
    """Every job, launched side by side while the references compute:
    ``{"jobs": {name: per-rank results}, "trace": path, "cache": path,
    "sims": ..., "moe": ...}``."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("g++ is not on PATH: the native transport cannot be "
                    "built here")
    tmp = tempfile.mkdtemp(prefix="world_a2a_")
    results, errors = {}, {}
    trace = os.path.join(tmp, "np4", "l.json")
    cache = os.path.join(tmp, "tune_2.json")

    def job(name):
        n, fake, env = JOBS[name]
        out = os.path.join(tmp, name)
        os.makedirs(out, exist_ok=True)
        env = dict(env, MPI4JAX_TPU_DISABLE_SHM="1",
                   MPI4JAX_TPU_TUNE_CACHE=os.path.join(out, "none.json"))
        try:
            results[name] = mw.run_job(
                n, out, device="cpu", fake_hosts=fake, env=env,
                trace=trace if name == "np4" else None, timeout=120)
        except Exception as e:  # reported below, in the test's thread
            errors[name] = e

    def tuner():
        # the CLI's outer mode in this process: it re-runs the tuner under
        # the launcher, in a subprocess from the repo's root
        cli = importlib.import_module("mpi4jax_tpu_torch.tune.__main__")
        rc = cli.main(["--np", "2", "--device", "cpu", "--sizes",
                       "1024,65536", "--repeats", "3", "--ops",
                       "allreduce,alltoall", "--cache", cache])
        if rc != 0:
            errors["tuner"] = RuntimeError(f"the tuner exited {rc}")

    # a part left by an earlier, wider run at the same path: the launcher
    # must remove it before the ranks start
    os.makedirs(os.path.dirname(trace))
    with open(trace + ".rank7.json", "w") as f:
        json.dump({"version": 1, "rank": 7, "size": 8, "events": [],
                   "dropped": {}}, f)
    threads = [threading.Thread(target=job, args=(name,)) for name in JOBS]
    threads.append(threading.Thread(target=tuner))
    for t in threads:
        t.start()
    sims = {}
    for n, spec in ((3, ISL3), (4, ISL4), (6, ISL6)):
        islands = _islands(spec, n)
        for count in mw.FAMILY_COUNTS:
            base = mw.family_inputs(n, count)
            for dt, arr in base.items():
                inputs = [arr[r] for r in range(n)]
                by_run = {}  # each schedule simulated once
                for gate_job, (quant, hier) in GATES.items():
                    if JOBS[gate_job][0] != n:
                        continue
                    for label in LABELS:
                        if dt == "int32" and label == "int8":
                            continue
                        run = mw.schedule_run(label, quant, hier)
                        if run not in by_run:
                            by_run[run] = mw.family_expected(
                                jtopo, inputs, islands, run, dt)
                        sims[(gate_job, dt, label, count)] = by_run[run]
    moe = {n: _jax_moe(n) for n in (4, 6)}
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"world jobs failed: {errors}")
    yield {"jobs": results, "trace": trace, "cache": cache, "sims": sims,
           "moe": moe}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_family_matches_the_jax_simulators(world, name):
    """Every schedule, dtype and count on every rank, bit for bit."""
    res = world["jobs"][name]
    n = JOBS[name][0]
    checked = 0
    for (job, dt, label, count), want in world["sims"].items():
        if job != name:
            continue
        for r in range(n):
            got = res[r][f"{dt}|{label}|{count}"]
            assert got.shape == want[r].shape, (dt, label, count, r)
            assert np.array_equal(got, want[r]), (
                f"{name} rank {r}: {dt} {label} at {count} differs from "
                f"the JAX simulator of "
                f"{mw.schedule_run(label, *GATES[name])}")
            checked += 1
    assert checked == n * len(mw.FAMILY_COUNTS) * (3 * len(LABELS) - 1)


@pytest.mark.parametrize("name", ["np4", "np6"])
def test_quantized_schedules_are_not_exact(world, name):
    """qalltoall really ran: the off-rank f32 chunks differ from the exact
    exchange and stay within the int8 bound; the own chunk is exact."""
    res = world["jobs"][name]
    n = JOBS[name][0]
    base = mw.family_inputs(n, 513)["float32"]
    for r in range(n):
        exact = base[:, r]
        got = res[r]["float32|qalltoall|513"]
        assert np.array_equal(got[r], exact[r])
        assert not np.array_equal(got, exact)
        err = np.max(np.abs(got - exact)) / np.max(np.abs(exact))
        assert err < 5e-2


@pytest.mark.parametrize("n,name", [(4, "np4"), (6, "np6")])
def test_world_moe_matches_the_jax_mesh(world, n, name):
    res = world["jobs"][name]
    want = world["moe"][n][1.25]
    want_drop = world["moe"][n][0.5]
    for r in range(n):
        assert str(res[r]["moe|pick"]) == "ring"
        exact = res[r]["moe|auto"]
        np.testing.assert_allclose(exact, want[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res[r]["moe|drop"], want_drop[r],
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(res[r]["moe|halltoall"], exact)
        for label in ("int8", "hqalltoall"):
            np.testing.assert_allclose(res[r][f"moe|{label}"], want[r],
                                       rtol=mw.INT8_RTOL, atol=mw.INT8_ATOL)
        assert bool(res[r]["grad_raises"])


def test_trace_loads_in_the_jax_package(world):
    trace = world["trace"]
    with open(trace) as f:
        merged = json.load(f)
    assert jobs.validate_chrome_trace(merged) == []
    assert obs.validate_chrome_trace(merged) == []
    parts = jobs.part_paths(trace)
    assert len(parts) == 4  # the stale rank-7 part was removed
    events, size = [], 0
    for p in parts:
        evs, size = jobs.load_events(p)
        events.extend(evs)
    assert size == 4
    stats = jobs.summarize(events)
    assert stats == obs.summarize(events)
    algos = {r["algo"] for r in stats["per_op"]
             if r["op"] == "Alltoall" and r["src"] == "native"
             and "tier" not in r}
    assert set(mw.FAMILY) <= algos
    # the merged trace reads back through both packages' loader
    assert jobs.load_events(trace)[0] == obs.load_events(trace)[0]


def test_tuner_cache_loads_in_the_jax_package(world):
    cache = world["cache"]
    saved = (jtune._cache_table, jtune._cache_origin, jtune._cache_combos)
    try:
        table = jtune.load_cache(2, path=cache)
    finally:
        jtune._cache_table, jtune._cache_origin, jtune._cache_combos = saved
    assert set(table) == {"allreduce", "alltoall"}
    with open(cache) as f:
        measured = json.load(f)["measurements"]
    # two sizes of allreduce (ring, rd, tree, qring, qrd) and of alltoall
    # (ring, qalltoall), one row each
    assert len(measured) == 2 * 5 + 2 * 2
    port_tune = importlib.import_module("mpi4jax_tpu_torch.tune")
    saved = (port_tune._cache_table, port_tune._cache_origin,
             port_tune._cache_combos)
    try:
        assert port_tune.load_cache(2, path=cache) == table
    finally:
        (port_tune._cache_table, port_tune._cache_origin,
         port_tune._cache_combos) = saved
