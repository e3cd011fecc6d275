"""The port's match simulation, symbolic path and schedule compiler against
the JAX package's, on seeded schedules.

Both packages' ``_events``, ``_match``, ``_deps``, ``_plan`` and
``_symbolic`` are pure Python: the JAX side is loaded standalone (no JAX
import), as ``tests/test_schedule_plan.py`` loads it.  Seeded numpy
schedules — rings, pairs, collectives, wildcard receives and
sub-communicators at np 2-16, clean and with one injected fault (a tag,
dtype, shape or reduce-op mismatch, a dropped receive, two events swapped)
— go through ``match_schedules``, ``verify_schedules`` and
``compile_schedules`` of both.  The reports' ``to_json()`` and the plans'
JSON must be equal, with the symbolic path on and off.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest

from mpi4jax_tpu_torch.analysis import (_events, _match, _plan,  # noqa: F401
                                        _symbolic)
from mpi4jax_tpu_torch import analysis as port_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "mpi4jax_tpu", "analysis")


def _load_jax():
    if "m4j_tam._plan" in sys.modules:
        return types.SimpleNamespace(**{
            n[1:]: sys.modules[f"m4j_tam.{n}"]
            for n in ("_events", "_match", "_deps", "_plan", "_symbolic")})
    pkg = types.ModuleType("m4j_tam")
    pkg.__path__ = [JAX_PKG]
    sys.modules["m4j_tam"] = pkg
    mods = {}
    for name in ("_events", "_match", "_deps", "_plan", "_symbolic"):
        spec = importlib.util.spec_from_file_location(
            f"m4j_tam.{name}", os.path.join(JAX_PKG, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f"m4j_tam.{name}"] = mod
        spec.loader.exec_module(mod)
        mods[name[1:]] = mod
    return types.SimpleNamespace(**mods)


JAX = _load_jax()
PORT = types.SimpleNamespace(events=_events, match=_match, plan=_plan,
                             symbolic=_symbolic)

DTYPES = ("float32", "bfloat16", "int32", "float64")
OPS = ("SUM", "MAX", "MIN", "PROD")
FAULTS = ("tag", "dtype", "shape", "reduce_op", "drop_recv", "swap")


# ---- a seeded program: package-neutral event dicts per rank ---------------


def _segments(rng, n):
    """Per-rank event dicts of a random program on ``n`` ranks, and its
    comms (world, and the even/odd split when it was used)."""
    sched = {r: [] for r in range(n)}
    comms = {(0,): tuple(range(n))}
    tag = 0

    def add(r, **ev):
        sched[r].append(dict(ev))

    for _ in range(int(rng.randint(3, 7))):
        kind = rng.choice(["ring", "raw_ring", "pairs", "coll", "wild",
                           "sub"])
        dtype = str(rng.choice(DTYPES))
        shape = (int(rng.choice([1, 4, 64, 70000])),)
        tag += 1
        if kind == "ring":
            k = int(rng.randint(1, n)) if n > 1 else 0
            for r in range(n):
                add(r, kind="sendrecv", dest=(r + k) % n,
                    source=(r - k) % n, sendtag=tag, recvtag=tag,
                    dtype=dtype, shape=shape)
        elif kind == "raw_ring":
            for r in range(n):
                add(r, kind="send", dest=(r + 1) % n, tag=tag,
                    dtype=dtype, shape=shape)
            for r in range(n):
                add(r, kind="recv", source=(r - 1) % n, tag=tag,
                    dtype=dtype, shape=shape)
        elif kind == "pairs":
            for r in range(0, n - 1, 2):
                add(r, kind="send", dest=r + 1, tag=tag, dtype=dtype,
                    shape=shape)
                add(r + 1, kind="recv", source=r, tag=tag, dtype=dtype,
                    shape=shape)
        elif kind == "coll":
            ck = str(rng.choice(["allreduce", "bcast", "gather", "alltoall",
                                 "barrier", "scan", "reduce", "allgather"]))
            root = int(rng.randint(0, n))
            op = str(rng.choice(OPS))
            for r in range(n):
                ev = {"kind": ck}
                if ck != "barrier":
                    ev.update(dtype=dtype, shape=((n,) + shape
                                                  if ck == "alltoall"
                                                  else shape))
                if ck in ("allreduce", "scan", "reduce"):
                    ev["reduce_op"] = op
                if ck in ("bcast", "gather", "reduce"):
                    ev["root"] = root
                add(r, **ev)
        elif kind == "wild":
            for r in range(1, n):
                add(r, kind="send", dest=0, tag=tag, dtype=dtype,
                    shape=shape)
            for _ in range(1, n):
                add(0, kind="recv", source=_events.ANY_SOURCE, tag=tag,
                    dtype=dtype, shape=shape, status=True)
        elif kind == "sub" and n >= 4:
            key = (0, len(comms), 0)
            key1 = (0, len(comms), 1)
            evens = tuple(r for r in range(n) if r % 2 == 0)
            odds = tuple(r for r in range(n) if r % 2 == 1)
            comms[key], comms[key1] = evens, odds
            for r in range(n):
                add(r, kind="split")
            for members, ck in ((evens, key), (odds, key1)):
                m = len(members)
                for i, r in enumerate(members):
                    add(r, kind="allreduce", comm=ck, reduce_op="SUM",
                        dtype=dtype, shape=shape)
                    add(r, kind="sendrecv", comm=ck, dest=(i + 1) % m,
                        source=(i - 1) % m, sendtag=tag, recvtag=tag,
                        dtype=dtype, shape=shape)
    return sched, comms


def _inject(rng, sched, fault, at=None):
    """One fault in a copy of ``sched``, on a random event or the
    ``at=(rank, index)`` one (a no-op when the program has no event the
    fault applies to)."""
    sched = {r: [dict(e) for e in evs] for r, evs in sched.items()}
    ranks = [r for r in sched if sched[r]]
    if at is None:
        r = ranks[int(rng.randint(0, len(ranks)))]
        i = int(rng.randint(0, len(sched[r])))
    else:
        r, i = at
    evs = sched[r]
    if fault == "swap" and len(evs) > 1:
        j = min(i + 1, len(evs) - 1)
        i = j - 1
        evs[i], evs[j] = evs[j], evs[i]
        return sched
    p2p = [k for k, e in enumerate(evs) if e["kind"] in ("send", "recv",
                                                         "sendrecv")]
    colls = [k for k, e in enumerate(evs) if e.get("reduce_op")]
    data = [k for k, e in enumerate(evs) if e.get("dtype")]
    if fault == "tag" and p2p:
        e = evs[p2p[i % len(p2p)]]
        for f in ("tag", "sendtag"):
            if e.get(f) is not None:
                e[f] += 100
                break
    elif fault == "dtype" and data:
        e = evs[data[i % len(data)]]
        e["dtype"] = "int16" if e["dtype"] != "int16" else "float32"
    elif fault == "shape" and data:
        e = evs[data[i % len(data)]]
        e["shape"] = tuple(d + 1 for d in e["shape"])
    elif fault == "reduce_op" and colls:
        e = evs[colls[i % len(colls)]]
        e["reduce_op"] = "MIN" if e["reduce_op"] != "MIN" else "SUM"
    elif fault == "drop_recv":
        recvs = [k for k, e in enumerate(evs) if e["kind"] == "recv"]
        if recvs:
            del evs[recvs[i % len(recvs)]]
    return sched


def _materialize(pkg, sched):
    return {
        r: [pkg.events.CommEvent(
            rank=r, idx=i, kind=e["kind"], comm=tuple(e.get("comm", (0,))),
            dest=e.get("dest"), source=e.get("source"), root=e.get("root"),
            tag=e.get("tag"), sendtag=e.get("sendtag"),
            recvtag=e.get("recvtag"), reduce_op=e.get("reduce_op"),
            dtype=e.get("dtype"), shape=e.get("shape"),
            site=f"prog.py:{10 + i}", status=bool(e.get("status")))
            for i, e in enumerate(evs)]
        for r, evs in sched.items()}


def _cases(seed, n_cases):
    rng = np.random.RandomState(seed)
    for _ in range(n_cases):
        n = int(rng.choice([2, 3, 4, 5, 8, 9, 12, 16]))
        sched, comms = _segments(rng, n)
        fault = None if rng.rand() < 0.4 else str(rng.choice(FAULTS))
        if fault:
            sched = _inject(rng, sched, fault)
        yield n, sched, comms, fault


def _report(pkg, n, events, findings, symmetry=None):
    rep = pkg.events.Report(
        world_size=n, target="prog.py", findings=findings,
        schedules={r: [e.describe() for e in evs]
                   for r, evs in events.items()},
        events=events, cache_key=pkg.events.schedule_cache_key(events, n))
    rep.symmetry = symmetry
    return rep.to_json()


def _sorted(findings):
    return port_analysis._dedupe(findings)


# ---- the differential tests -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_schedules_equal(seed):
    for n, sched, comms, fault in _cases(seed, 12):
        ej, ep = _materialize(JAX, sched), _materialize(PORT, sched)
        fj = JAX.match.match_schedules(ej, comms)
        fp = PORT.match.match_schedules(ep, comms)
        assert json.dumps(_report(JAX, n, ej, fj)) == \
            json.dumps(_report(PORT, n, ep, fp)), (n, fault)


@pytest.mark.parametrize("symbolic", ["auto", "off"])
@pytest.mark.parametrize("seed", [3, 4])
def test_verify_schedules_equal(seed, symbolic, monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_SYMBOLIC", symbolic)
    engaged = 0
    for n, sched, comms, fault in _cases(seed, 12):
        ej, ep = _materialize(JAX, sched), _materialize(PORT, sched)
        fj, pj = JAX.symbolic.verify_schedules(ej, comms)
        fp, pp = PORT.symbolic.verify_schedules(ep, comms)
        engaged += pp is not None
        assert (pj is None) == (pp is None), (n, fault)
        assert json.dumps(_report(JAX, n, ej, _sorted(fj), pj)) == \
            json.dumps(_report(PORT, n, ep, _sorted(fp), pp)), (n, fault)
    # the generator's worlds canonicalize often enough to exercise both
    assert (engaged > 0) == (symbolic == "auto")


@pytest.mark.parametrize("symbolic", ["auto", "off"])
@pytest.mark.parametrize("seed", [5, 6])
def test_compile_schedules_equal(seed, symbolic, monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_SYMBOLIC", symbolic)
    monkeypatch.delenv("MPI4JAX_TPU_TUNE_MODEL", raising=False)
    for n, sched, comms, fault in _cases(seed, 6):
        if n > 9:
            continue  # the prover's interleavings: small worlds suffice
        ej, ep = _materialize(JAX, sched), _materialize(PORT, sched)
        fj, pj = JAX.symbolic.verify_schedules(ej, comms)
        fp, pp = PORT.symbolic.verify_schedules(ep, comms)
        plan_j = JAX.plan.compile_schedules(
            ej, comms, findings=fj, world_size=n, symmetry=pj)
        plan_p = PORT.plan.compile_schedules(
            ep, comms, findings=fp, world_size=n, symmetry=pp)
        assert json.dumps(plan_j.to_json(), sort_keys=True) == \
            json.dumps(plan_p.to_json(), sort_keys=True), (n, fault)


def test_faults_are_found():
    """The generator's faults reach the matcher: every fault kind gives a
    finding in both packages on a ring program."""
    rng = np.random.RandomState(7)
    n = 4
    sched = {r: [{"kind": "sendrecv", "dest": (r + 1) % n,
                  "source": (r - 1) % n, "sendtag": 1, "recvtag": 1,
                  "dtype": "float32", "shape": (4,)},
                 {"kind": "allreduce", "reduce_op": "SUM",
                  "dtype": "float32", "shape": (4,)},
                 {"kind": "send", "dest": (r + 1) % n, "tag": 2,
                  "dtype": "float32", "shape": (4,)},
                 {"kind": "recv", "source": (r - 1) % n, "tag": 2,
                  "dtype": "float32", "shape": (4,)}]
             for r in range(n)}
    comms = {(0,): tuple(range(n))}
    for fault in FAULTS:
        bad = _inject(rng, sched, fault, at=(0, 0))
        fj = JAX.match.match_schedules(_materialize(JAX, bad), comms)
        fp = PORT.match.match_schedules(_materialize(PORT, bad), comms)
        assert fj and [f.to_json() for f in fj] == \
            [f.to_json() for f in fp], fault


def test_plan_files_cross_packages(tmp_path):
    """A plan the port saves loads in the JAX package and back, with the
    same cache key and analyzer version."""
    assert PORT.events.ANALYZER_VERSION == JAX.events.ANALYZER_VERSION
    rng = np.random.RandomState(8)
    sched, comms = _segments(rng, 3)
    ep = _materialize(PORT, sched)
    plan = PORT.plan.compile_schedules(ep, comms, world_size=3)
    path = str(tmp_path / "p.json")
    PORT.plan.save_plan(plan, path)
    back = JAX.plan.load_plan(path)
    assert back.to_json() == plan.to_json()
    assert JAX.plan.diff_plans(back, PORT.plan.load_plan(path)) == ""
