"""The port's joint tuner held to the JAX package's (the pair of
``tests/test_tune_model.py``).

- the port's ``tune/_model.py`` and ``tune/_joint.py`` against the JAX
  package's modules on the same samples and the same
  ``synthetic_measure``: identical fitted coefficients, predictions,
  rankings, bucket and group-cap answers, model files, eligible combos,
  anchors, search winners and rows, and ``merge_winners`` rows (the port's
  copies must agree exactly: both are the same stdlib arithmetic);
- ``fit_model_from_events`` of both on the same event stream;
- a v2 cache from the port's ``cache_from_joint`` loading in the JAX
  ``tune.load_cache``, and the other way round;
- ``python -m mpi4jax_tpu_torch.tune --joint`` end to end on a 4-rank CPU
  world on ``r0,r1|r2,r3`` with a short ladder: the base sub-job and the
  three gated ones (``+q``, ``+ici``, ``+q+ici``), whose ``+ici`` rows run
  the intra-island leg's plain versions on the CPU; its cache loads in
  both packages and names only measured combos.
"""

import json
import os
import subprocess
import sys

import pytest

from mpi4jax_tpu import tune as jtune

from mpi4jax_tpu_torch import tune as ttune
from mpi4jax_tpu_torch.tune import _joint as tjoint
from mpi4jax_tpu_torch.tune import _model as tmodel

jmodel = jtune._submodule("_model")
jjoint = jtune._submodule("_joint")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [1 << p for p in range(10, 25, 2)]  # 1 KiB .. 16 MiB, x4


@pytest.fixture(autouse=True)
def _clean_engines(monkeypatch):
    for knob in ("MPI4JAX_TPU_COLL_ALGO", "MPI4JAX_TPU_TUNE_CACHE",
                 "MPI4JAX_TPU_TUNE_MODEL", "MPI4JAX_TPU_COLL_QUANT",
                 "MPI4JAX_TPU_HIER", "MPI4JAX_TPU_ICI_LEG",
                 "MPI4JAX_TPU_PLAN"):
        monkeypatch.delenv(knob, raising=False)
    saved = [(e, e._cache_table, e._cache_origin, e._cache_combos)
             for e in (jtune, ttune)]
    yield
    for e, table, origin, combos in saved:
        e._cache_table, e._cache_origin, e._cache_combos = \
            table, origin, combos


def _samples():
    """(op, combo, bytes, seconds) rows: exact alpha-beta curves with a
    crossover, plus noise-free oddities (one point, a flat curve)."""
    rows = []
    for combo, alpha, gbps in (("tree", 10e-6, 0.5), ("ring", 60e-6, 3.0),
                               ("qring", 100e-6, 4.0)):
        for b in (1 << 10, 64 << 10, 1 << 20, 16 << 20):
            rows.append(("allreduce", combo, b, alpha + b / (gbps * 1e9)))
    rows.append(("allgather", "rd", 4096, 3e-5))
    rows += [("alltoall", "ring", b, 2e-3) for b in (1024, 1 << 20)]
    return rows


def _models():
    out = []
    for mod in (jmodel, tmodel):
        m = mod.CostModel(world_size=4, topology="t", source="test")
        for op, combo, b, t in _samples():
            m.add_sample(op, combo, b, t, wire_frac=0.5,
                         dispatch_frac=0.25 if b > 4096 else None)
        out.append(m)
    return out


def test_fits_and_predictions_are_the_jax_model_s():
    jm, tm = _models()
    for key in jm.samples:
        assert tm._fit(key) == jm._fit(key), key
    for op, combos in (("allreduce", ["tree", "ring", "qring", "warp"]),
                       ("allgather", ["rd"]), ("alltoall", ["ring"])):
        for b in [1, 512] + SIZES + [3 << 20, 64 << 20]:
            for c in combos:
                assert tm.predict(op, b, c) == jm.predict(op, b, c)
            assert tm.rank_combos(op, b, combos) == \
                jm.rank_combos(op, b, combos)
    for total in (100, 1 << 20, 7 << 20, 33 << 20):
        assert tm.best_bucket_bytes(total) == jm.best_bucket_bytes(total)
        assert tm.best_bucket_bytes(total, combo="ring") == \
            jm.best_bucket_bytes(total, combo="ring")
    for b in (1024, 1 << 20):
        for op, combo in (("allreduce", "tree"), ("send", "ring"),
                          ("alltoall", "ring")):
            assert tm.suggested_group_cap(b, op, combo) == \
                jm.suggested_group_cap(b, op, combo)
    for pts in ({}, {1 << 20: 1e-3}, {1024: 5e-3, 2048: 1e-6},
                {b: 25e-6 + b / 2e9 for b in SIZES}):
        assert tmodel._fit_alpha_beta(pts) == jmodel._fit_alpha_beta(pts)


def test_model_files_cross_between_the_packages(tmp_path, monkeypatch):
    jm, tm = _models()
    assert tm.to_json() == jm.to_json()
    tmodel.save_model(tm, path=str(tmp_path / "t.json"))
    jmodel.save_model(jm, path=str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    back = jmodel.load_model(str(tmp_path / "t.json"))
    assert back.to_json() == tm.to_json()
    assert tmodel.load_model(str(tmp_path / "j.json")).to_json() == \
        jm.to_json()
    rows = [{"op": op, "combo": c, "bytes": b, "seconds": t * k}
            for op, c, b, t in _samples() for k in (1.0, 1.5, 0.75)]
    assert tmodel.CostModel.from_measurements(rows).to_json() == \
        jmodel.CostModel.from_measurements(rows).to_json()
    monkeypatch.setenv("MPI4JAX_TPU_TUNE_MODEL", str(tmp_path / "m.json"))
    assert tmodel.model_path(4, "fp") == jmodel.model_path(4, "fp")
    monkeypatch.delenv("MPI4JAX_TPU_TUNE_MODEL")
    assert tmodel.model_path(4, "fp") == jmodel.model_path(4, "fp")


def test_joint_vocabulary_is_the_jax_one():
    assert tjoint.JOINT_CANDIDATES == jjoint.JOINT_CANDIDATES
    assert ttune.JOINT_CANDIDATES is tjoint.JOINT_CANDIDATES
    for op, combos in tjoint.JOINT_CANDIDATES.items():
        for c in combos:
            assert tjoint.combo_algo(c) == jjoint.combo_algo(c)
            assert tjoint.combo_gates(c) == jjoint.combo_gates(c)
            assert tjoint.check_combo(f" {c} ", op) == c
        with pytest.raises(ValueError, match="unknown joint"):
            tjoint.check_combo("warp+q", op)
    for sizes in ([], [5], [1, 2, 3], SIZES, SIZES[::-1] + [7]):
        assert tjoint._anchor_sizes(sizes) == jjoint._anchor_sizes(sizes)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("quant", ["allow", "deny", "force"])
def test_eligible_combos_are_the_jax_ones(multi, quant):
    for op in tjoint.JOINT_CANDIDATES:
        for hier in ("allow", "deny"):
            for leg in (False, True):
                kw = dict(multi_island=multi, quant_mode=quant,
                          hier_mode=hier, ici_leg=leg)
                assert tjoint.eligible_combos(op, **kw) == \
                    jjoint.eligible_combos(op, **kw)


@pytest.mark.parametrize("ranks", [4, 64])
def test_joint_search_is_the_jax_search(ranks):
    """The model-seeded search on the synthetic cost table: the same
    measurements, winners and fitted model, then the same merge of the
    base rows with a gated sub-job's."""
    results = []
    for joint in (jjoint, tjoint):
        cands = {op: joint.eligible_combos(op, multi_island=True,
                                           quant_mode="allow",
                                           hier_mode="allow", ici_leg=True)
                 for op in joint.JOINT_CANDIDATES}
        measure = joint.synthetic_measure(ranks)
        # the gated combos come from their own sub-job in the driver
        base = {op: [c for c in cs if not joint.combo_gates(c)]
                for op, cs in cands.items()}
        gated = {"allreduce": [c for c in cands["allreduce"]
                               if joint.combo_gates(c)]}
        best, rows, model = joint.joint_search(measure, base, SIZES,
                                               topk=2, ranks=ranks)
        gbest, grows, _ = joint.joint_search(measure, gated, SIZES,
                                             topk=2, ranks=ranks)
        merged = joint.merge_winners([rows, grows])
        values = [measure(op, b, c) for op, cs in cands.items()
                  for c in cs for b in SIZES]
        results.append((best, rows, model.to_json(), gbest, grows, merged,
                        values))
    assert results[0] == results[1]
    best, rows = results[1][0], results[1][1]
    assert {r["phase"] for r in rows} == {"anchor", "refine"}
    assert all(b in best["allreduce"] for b in SIZES)


def test_fit_model_from_events_is_the_jax_fit():
    events = []
    for b, algo, dur in ((1024, "tree", 15.0), (1024, "ring", 60.0),
                         (1 << 20, "tree", 2100.0),
                         (1 << 20, "ring", 1100.0)):
        for rep in range(4):
            events.append({"name": "Allreduce", "src": "native",
                           "ts_us": 0.0, "dur_us": dur + rep,
                           "wait_us": dur * 0.1, "dispatch_us": dur * 0.05,
                           "bytes": b, "peer": -1, "tag": 0, "algo": algo})
    events.append({"name": "Allreduce", "src": "native", "dur_us": 9.0,
                   "bytes": 64, "algo": "hring", "tier": "ici"})
    tm = ttune.fit_model_from_events(events, world_size=4,
                                     topo_fingerprint="fp")
    jm = jtune.fit_model_from_events(events, world_size=4,
                                     topo_fingerprint="fp")
    assert tm.to_json() == jm.to_json()
    assert tm.dispatch_frac[("allreduce", "tree")][1024] == \
        pytest.approx(0.05, abs=0.01)


BEST = {"allreduce": {1024: "rd", 65536: "qrd", 1 << 20: "hring+q+ici",
                      16 << 20: "hring+ici"},
        "allgather": {1024: "rd", 1 << 20: "ring"},
        "alltoall": {1024: "ring", 1 << 20: "hqalltoall"}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_joint_caches_load_in_both_packages(tmp_path, writer):
    path = str(tmp_path / "tune_4.json")
    rows = [{"op": "allreduce", "bytes": 1024, "combo": "rd", "algo": "rd",
             "seconds": 1e-5, "ranks": 4, "phase": "anchor"}]
    engine = ttune if writer == "port" else jtune
    engine.cache_from_joint(4, BEST, rows, path=path,
                            topo_fingerprint="fp", model_file="m.json")
    tables = {}
    for name, e in (("port", ttune), ("jax", jtune)):
        tables[name] = e.load_cache(4, path=path, topo_fingerprint="fp")
        tables[name + "_combos"] = e._cache_combos
    assert tables["port"] == tables["jax"]
    assert tables["port_combos"] == tables["jax_combos"]
    assert tables["port"]["allreduce"] == [
        (0, "rd"), (65536, "qrd"), (1 << 20, "hring")]
    assert tables["port_combos"]["allreduce"][-1] == (16 << 20,
                                                      "hring+ici")
    with open(path) as f:
        payload = json.load(f)
    assert payload["version"] == 2 and payload["model"] == "m.json"
    assert payload["transport"] == "tcp:joint"


def test_joint_cli_on_a_4_rank_cpu_world(tmp_path):
    cache, model_file = str(tmp_path / "c.json"), str(tmp_path / "m.json")
    env = dict(os.environ, MPI4JAX_TPU_FAKE_HOSTS="r0,r1|r2,r3",
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "mpi4jax_tpu_torch.tune", "--joint", "--np",
         "4", "--device", "cpu", "--ops", "allreduce", "--sizes",
         "1024,65536", "--repeats", "3", "--topk", "2", "--cache", cache,
         "--model-out", model_file],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    subs = {x["sub_job"]: x for x in lines if "sub_job" in x}
    assert sorted(subs) == ["+ici", "+q", "+q+ici", "base"]
    assert subs["+ici"]["combos"] == ["hring+ici", "htree+ici"]
    assert subs["+q+ici"]["combos"] == ["hring+q+ici", "htree+q+ici"]
    assert subs["+q"]["combos"] == ["hring+q", "htree+q"]
    assert {"hring", "htree", "ring", "qring"} <= set(
        subs["base"]["combos"])
    for sub in subs.values():
        # the CPU ranks run the leg's plain versions: no kernel launch
        assert sub["launches"] == {"fused_ring": 0, "quant_pack": 0}
        assert sub["rows"] == 2 * len(sub["combos"])  # both are anchors
    rows = [x for x in lines if "phase" in x]
    for r in rows:
        if "+" in r["combo"]:
            assert r["gates"] == tjoint.combo_gates(r["combo"])
    measured = {r["combo"] for r in rows}
    winners = {x["bytes"]: x["winner"] for x in lines if "winner" in x}
    assert set(winners) == {1024, 65536}
    assert set(winners.values()) <= measured
    for name, e in (("port", ttune), ("jax", jtune)):
        e.load_cache(4, path=cache)
        assert {c for _, c in e._cache_combos["allreduce"]} <= measured
    model = tmodel.load_model(model_file)
    assert {c for (op, c) in model.samples} == measured
    assert jmodel.load_model(model_file).to_json() == model.to_json()


def test_driver_skips_only_the_sub_jobs_the_leg_empties():
    from mpi4jax_tpu_torch.tune import __main__ as tmain

    q = {"MPI4JAX_TPU_COLL_QUANT": "force"}
    qici = dict(q, MPI4JAX_TPU_ICI_LEG="force")
    plus_q = ["hring+q", "htree+q"]
    assert tmain._leg_takes_all({"leg": True}, q, plus_q)
    assert not tmain._leg_takes_all({"leg": False}, q, plus_q)
    assert not tmain._leg_takes_all({}, q, plus_q)
    # the leg's own gate set runs its combos under the leg
    assert not tmain._leg_takes_all({"leg": True}, qici,
                                    ["hring+q+ici", "htree+q+ici"])
    # a flat combo is not the leg's to take
    assert not tmain._leg_takes_all({"leg": True}, q, ["hring+q", "qring"])
