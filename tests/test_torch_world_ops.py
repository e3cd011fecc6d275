"""The port's world tier, one process per rank, held to the JAX package.

Two jobs of ``mpi4jax_tpu_torch/benchmarks/world_ops.py`` (``device="cpu"``)
run side by side from one module fixture, through the port's launcher:

- 3 ranks with ``MPI4JAX_TPU_DISABLE_SHM=1``: the transport's TCP
  schedules, a periodic ring of three and recursive doubling's
  non-power-of-two fold;
- 4 ranks on ``--fake-hosts 'r0,r1|r2,r3'``: a multi-island world, so
  ``algo=None`` resolves against the hierarchical default table.

Each rank holds every op to its numpy oracle in the job (bit for bit for
data movement, integer, logical, bitwise, MAX, MIN in all 15 wire
dtypes, the forced f32
schedules against ``topo/_simulate.py``, qring/qrd; status, wildcards,
walls, self-wrap, gradients and refusals analytically) and writes its
results.  Here the same seeded inputs go through the JAX package's mesh tier
on the CPU devices of ``tests/conftest.py`` (a ``MeshComm`` of 3 or 4
ranks, one jitted function per world size, 64-bit types on): every op that
both tiers have must agree bit for bit, but a float SUM or PROD within
``world_ops.RTOL`` of the sum of magnitudes (the folds differ).  The f32
schedules are held to the JAX package's simulators, and the port's copies
of ``simulate_qring_sum`` and ``simulate_qrd_sum`` to JAX's.  Gradients
follow the JAX world tier's rules (``tests/world_programs/autodiff.py``):
the SUM allreduce passes the cotangent, sendrecv sends it back along the
edge; every other world op's backward raises, shown here without a
transport.

The cases are split over three files of at most 45: the 3-rank job's here
(with the tune tables), the 4-rank job's and the gradient refusals in
``tests/test_torch_world_ops_islands.py``, the quantized simulators in
``tests/test_torch_world_ops_quant.py``.  Each job and its JAX compile
stays with all its cases in one file.
"""

import os
import shutil
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mpi4jax_tpu as m4j
from mpi4jax_tpu import tune as jtune
from mpi4jax_tpu.ops import quantized as jquant
from mpi4jax_tpu.topo import _simulate as jsim

from mpi4jax_tpu_torch import tune as ttune
from mpi4jax_tpu_torch.benchmarks import world_ops as wo
from mpi4jax_tpu_torch.ops import _world_impl
from mpi4jax_tpu_torch.runtime import transport
from mpi4jax_tpu_torch.topo import _simulate as sim

JOBS = {3: {"env": {"MPI4JAX_TPU_DISABLE_SHM": "1"}},
        4: {"fake_hosts": "r0,r1|r2,r3"}}
#: this file's job (each world size's cases are a file of at most 45)
WORLD_NS = (3,)
_JAX_ABSMAX = m4j.custom_op(
    "ABSMAX_WORLD_PARITY", lambda a, b: jnp.maximum(jnp.abs(a), jnp.abs(b)))


def _jnp(a, dt):
    return jnp.asarray(a, jnp.bfloat16 if dt == "bfloat16" else a.dtype)


def _jax_reference(n):
    """Every op of the dtype sweep on the JAX mesh tier, per rank: ``{op
    name: (n, ...) array}`` (bf16 as f32)."""
    def f(a):
        a = {k: v[0] for k, v in a.items()}
        out = {}
        for dt in wo.DTYPES:
            x = a[dt]
            for op in wo.reduce_ops_for(dt):
                src = a[dt + "/pos"] if op == "PROD" else x
                out[f"allreduce/{op}/{dt}"] = m4j.allreduce(
                    src, op=getattr(m4j, op))
            out[f"allgather/{dt}"] = m4j.allgather(x)
            out[f"alltoall/{dt}"] = m4j.alltoall(a[dt + "/rows"])
            out[f"scatter/{dt}"] = m4j.scatter(a[dt + "/rows"], root=0)
            out[f"bcast/{dt}"] = m4j.bcast(x, root=n - 1)
            out[f"gather/{dt}"] = m4j.gather(x, root=0)
            out[f"shift+1/{dt}"] = m4j.sendrecv(x, shift=1)
            out[f"perm/{dt}"] = m4j.sendrecv(
                x, perm=[(s, (s - 1) % n) for s in range(n)])
            if dt != "bool":
                out[f"scan/{dt}"] = m4j.scan(x, op=m4j.SUM)
                out[f"reduce/{dt}"] = m4j.reduce(x, op=m4j.SUM, root=0)
        x = a["float32"]
        out["custom/allreduce"] = m4j.allreduce(x, op=_JAX_ABSMAX)
        out["custom/scan"] = m4j.scan(x, op=_JAX_ABSMAX)
        out["int8/513"] = m4j.allreduce(a["quant"], compression="int8")
        return {k: v[None] for k, v in out.items()}

    with jax.enable_x64(True):
        args = {"quant": jnp.asarray(wo.all_inputs("float32", n, (513,),
                                                   "quant"))}
        for dt in wo.DTYPES:
            args[dt] = _jnp(wo.all_inputs(dt, n), dt)
            args[dt + "/pos"] = _jnp(wo.all_inputs(dt, n, tag="pos"), dt)
            args[dt + "/rows"] = _jnp(wo.all_inputs(dt, n, (n, 3), "rows"),
                                      dt)
        res = jax.jit(m4j.spmd(f, mesh=m4j.make_mesh(n)))(args)
        return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                              else v) for k, v in res.items()}


def launch_world(ns):
    """The jobs of the world sizes ``ns``, launched side by side while
    their JAX references compile: yields ``{n: (record, per-rank results,
    JAX results)}`` (the body of each file's module fixture)."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("g++ is not on PATH: the native transport cannot be "
                    "built here")
    tmp = tempfile.mkdtemp(prefix="world_ops_")
    runs, errors = {}, {}

    def job(n):
        out = os.path.join(tmp, str(n))
        os.makedirs(out)
        try:
            runs[n] = (wo.run_job(n, out, device="cpu", timeout=120,
                                  **JOBS[n]), out)
        except Exception as e:  # reported below, in the test's thread
            errors[n] = e

    threads = [threading.Thread(target=job, args=(n,)) for n in ns]
    for t in threads:
        t.start()
    refs = {n: _jax_reference(n) for n in ns}
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"world_ops jobs failed: {errors}")
    yield {n: (runs[n][0], wo.load_results(runs[n][1], n), refs[n])
           for n in ns}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def world():
    """The 3-rank job and its JAX references (the 4-rank one is
    ``tests/test_torch_world_ops_islands.py``'s)."""
    yield from launch_world(WORLD_NS)


@pytest.mark.parametrize("n", WORLD_NS)
def test_every_rank_held_every_oracle(world, n):
    rec, results, _ = world[n]
    assert rec["size"] == n and rec["device"] == "cpu"
    assert rec["arena"] is False  # TCP: the forced schedules really run
    assert rec["multi"] is (n == 4)
    assert rec["islands"] == ([[0, 1], [2, 3]] if n == 4 else [[0, 1, 2]])
    assert min(rec["checks_per_rank"]) > 150
    assert all(set(r) == set(rec["ops"]) for r in results)


def _held(got, want, key, dt, src):
    """Bit for bit, but a float SUM or PROD (allreduce, scan, reduce)
    within ``RTOL`` of the sum of magnitudes (of the product for PROD)."""
    op = key.split("/")[1] if key.startswith("allreduce") else "SUM"
    folds = key.startswith(("allreduce", "scan", "reduce"))
    if folds and wo.inexact(op, dt):
        scale = (np.abs(want).astype(np.float64) if op == "PROD"
                 else np.abs(src).astype(np.float64).sum(0))
        err = np.abs(got.astype(np.complex128) - want.astype(np.complex128))
        assert np.all(err <= wo.RTOL[dt] * scale), key
    else:
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("n", WORLD_NS)
@pytest.mark.parametrize("dt", wo.DTYPES)
def test_reductions_match_jax(world, n, dt):
    _, results, ref = world[n]
    stack = wo.all_inputs(dt, n)
    for op in wo.reduce_ops_for(dt):
        key = f"allreduce/{op}/{dt}"
        src = wo.all_inputs(dt, n, tag="pos") if op == "PROD" else stack
        for r in range(n):
            _held(results[r][key], ref[key][r], key, dt, src)


@pytest.mark.parametrize("n", WORLD_NS)
@pytest.mark.parametrize("dt", wo.OTHER_DTYPES)
def test_other_wire_dtypes_reduce(world, n, dt):
    """The rest of the 15 wire dtypes, held to numpy (their JAX mesh
    reductions are the same ops on the dtypes above)."""
    _, results, _ = world[n]
    stack = wo.all_inputs(dt, n)
    for op in wo.reduce_ops_for(dt):
        key = f"allreduce/{op}/{dt}"
        src = wo.all_inputs(dt, n, tag="pos") if op == "PROD" else stack
        for r in range(n):
            _held(results[r][key], wo.oracle_reduce(src, op, dt), key, dt,
                  src)
    for r in range(n):
        np.testing.assert_array_equal(results[r][f"allgather/{dt}"], stack)


@pytest.mark.parametrize("n", WORLD_NS)
@pytest.mark.parametrize("dt", wo.DTYPES)
def test_data_movement_matches_jax(world, n, dt):
    _, results, ref = world[n]
    stack = wo.all_inputs(dt, n)
    names = ["allgather", "alltoall", "scatter", "bcast", "shift+1", "perm"]
    if dt != "bool":
        names += ["scan", "reduce"]
    for name in names:
        key = f"{name}/{dt}"
        for r in range(n):
            _held(results[r][key], ref[key][r], key, dt,
                  stack[:r + 1] if name == "scan" else stack)
    # gather: the JAX mesh result is the root's, on every rank; a world
    # rank other than the root gets its input back
    key = f"gather/{dt}"
    np.testing.assert_array_equal(results[0][key], ref[key][0])
    for r in range(1, n):
        np.testing.assert_array_equal(results[r][key], stack[r])


@pytest.mark.parametrize("n", WORLD_NS)
def test_custom_op_matches_jax(world, n):
    _, results, ref = world[n]
    for key in ("custom/allreduce", "custom/scan"):
        for r in range(n):
            np.testing.assert_array_equal(results[r][key], ref[key][r])


@pytest.mark.parametrize("n", WORLD_NS)
def test_f32_schedules_match_the_jax_simulators(world, n, monkeypatch):
    rec, results, _ = world[n]
    islands = rec["islands"]
    jfns = {"ring": jsim.simulate_ring_sum, "rd": jsim.simulate_rd_sum,
            "hring": lambda p: jsim.simulate_hring_sum(p, islands),
            "htree": lambda p: jsim.simulate_htree_sum(p, islands)}
    for count in wo.SCHED_COUNTS:
        parts = list(wo.all_inputs("float32", n, (count,), "sched"))
        for algo, fn in jfns.items():
            if algo.startswith("h") and n != 4:
                continue
            want = np.asarray(fn(parts), np.float32)
            for r in range(n):
                np.testing.assert_array_equal(
                    results[r][f"sum/{algo}/{count}"], want)
        # the binomial tree, which the JAX package has no model of
        for r in range(n):
            np.testing.assert_array_equal(results[r][f"sum/tree/{count}"],
                                          sim.simulate_tree_sum(parts))
        # algo=None: the JAX engine's pick under its default layer on the
        # job's topology
        pick = _jax_default_layer(monkeypatch, rec["multi"]).get_algorithm(
            "allreduce", count * 4)
        for r in range(n):
            np.testing.assert_array_equal(results[r][f"sum/auto/{count}"],
                                          results[r][f"sum/{pick}/{count}"])


@pytest.mark.parametrize("n", WORLD_NS)
def test_int8_matches_the_jax_simulators(world, n, monkeypatch):
    rec, results, ref = world[n]
    jax_tune = _jax_default_layer(monkeypatch, rec["multi"])
    for count in wo.QUANT_COUNTS:
        parts = list(wo.all_inputs("float32", n, (count,), "quant"))
        # compression="int8": the JAX engine's quantized pick
        pick = jax_tune.quantized_algorithm(count * 4)
        for algo, fn in (("qring", jquant.simulate_qring_sum),
                         ("qrd", jquant.simulate_qrd_sum)):
            want = fn(parts)
            for r in range(n):
                np.testing.assert_array_equal(
                    results[r][f"{algo}/{count}"], want)
                if algo == pick:
                    np.testing.assert_array_equal(
                        results[r][f"int8/{count}"], want)
    # the Python schedule (MPI4JAX_TPU_COLL_QUANT=deny) is the mesh one:
    # within two quantization steps of the JAX mesh tier's (XLA:CPU
    # rewrites its division, ROADMAP.md §3)
    exact = wo.all_inputs("float32", n, (513,), "quant").sum(0)
    step = np.abs(exact).max() / 127
    for r in range(n):
        assert np.abs(results[r]["int8_python/513"]
                      - ref["int8/513"][r]).max() <= 2 * step


def _jax_default_layer(monkeypatch, multi):
    """The JAX package's engine with only its default layer in force (no
    tune cache, override or ``MPI4JAX_TPU_COLL_ALGO``), on a flat or a
    multi-island topology: what ``algo=None`` means to it here."""
    monkeypatch.delenv("MPI4JAX_TPU_COLL_ALGO", raising=False)
    monkeypatch.setattr(jtune, "_topo_multi", bool(multi))
    monkeypatch.setattr(jtune, "_cache_table", None)
    monkeypatch.setattr(jtune, "_overrides", {op: {} for op in jtune.OPS})
    return jtune


def test_port_tune_tables_are_jax_s():
    assert ttune.OPS == jtune.OPS and ttune.OP_KIND == jtune.OP_KIND
    assert ttune._DEFAULT_TABLE == jtune._DEFAULT_TABLE
    assert ttune._HIER_DEFAULT_TABLE == jtune._HIER_DEFAULT_TABLE
    assert ttune.QUANT_TWIN == jtune.QUANT_TWIN


@pytest.mark.parametrize("multi", [False, True])
def test_port_default_picks_are_jax_s(monkeypatch, multi):
    jax_tune = _jax_default_layer(monkeypatch, multi)
    monkeypatch.setattr(ttune, "_topo_multi", multi)
    for nbytes in (0, 4, 64 * 1024 - 1, 64 * 1024, 1 << 20, 1 << 30):
        for op in ttune.OPS:
            assert ttune.get_algorithm(op, nbytes) == \
                jax_tune.get_algorithm(op, nbytes), (op, nbytes)
        assert ttune.quantized_algorithm(nbytes) == \
            jax_tune.quantized_algorithm(nbytes), nbytes
        assert ttune.decision_table() == jax_tune.decision_table()


@pytest.mark.parametrize("n", WORLD_NS)
def test_gradients_follow_the_jax_rules(world, n):
    """``tests/world_programs/autodiff.py``: the SUM allreduce's gradient
    is the cotangent; sendrecv's goes back along the edge (shift +1's is
    shift -1's), including through an allreduce."""
    _, results, _ = world[n]
    for r in range(n):
        np.testing.assert_array_equal(results[r]["grad/allreduce"],
                                      np.ones(3, np.float32))
        np.testing.assert_array_equal(
            results[r]["grad/sendrecv"],
            np.full(3, float((r + 1) % n + 1), np.float32))
        np.testing.assert_array_equal(
            results[r]["grad/matvec"],
            np.array([float((r - 1) % n + (r + 1) % n)], np.float32))


@pytest.mark.parametrize("n", WORLD_NS)
def test_neighbor_exchange_walls_and_self_wrap(world, n):
    """``tests/world_programs/neighbor_ops.py``: from_lo is lo's to_hi and
    from_hi hi's to_lo on the ring."""
    _, results, _ = world[n]
    for r in range(n):
        np.testing.assert_array_equal(results[r]["neighbor/ring_lo"],
                                      np.full(4, (r - 1) % n + 100.0))
        np.testing.assert_array_equal(results[r]["neighbor/ring_hi"],
                                      np.full(4, float((r + 1) % n)))
        np.testing.assert_array_equal(
            results[r]["stream/allreduce"],
            np.full(5, float(n * (n + 1) // 2), np.float32))


def _fake_comm():
    return transport.WorldComm(0, 4, "127.0.0.1:1", device="cpu")


_LOCAL = {  # the staged ops replaced by local stand-ins (no transport)
    "_allreduce": lambda x, comm, op_code, algo: x.detach() * 4,
    "_allgather": lambda x, comm: x.detach().expand(4, *x.shape).clone(),
    "_bcast": lambda x, root, comm: x.detach().clone(),
    "_gather": lambda x, root, comm: x.detach().expand(4, *x.shape).clone(),
    "_reduce": lambda x, op_code, root, comm: x.detach() * 4,
    "_scan": lambda x, op_code, comm: x.detach() * 2,
    "_scatter": lambda x, root, comm: x.detach()[0].clone(),
    "_alltoall": lambda x, comm, algo=None: x.detach().clone(),
    "_shift2": lambda stack, lo, hi, tag, comm: stack.detach().flip(0),
    "_sendrecv": (lambda x, source, dest, sendtag, recvtag, status, comm:
                  (x.detach() + 100 * dest + sendtag)),
}


@pytest.fixture
def local_world(monkeypatch):
    for name, fn in _LOCAL.items():
        monkeypatch.setattr(_world_impl, name, fn)
    return _fake_comm()
