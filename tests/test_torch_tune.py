"""The port's tune engine and the topology's tune helpers, held to the JAX
package's on the CPU.

Every case of ``tests/test_tune.py`` runs here on both engines (the port's
``mpi4jax_tpu_torch.tune`` and the JAX package's ``mpi4jax_tpu.tune``),
with the same assertions, and the two engines' answers are compared; so
are the tune and topology cases of ``tests/test_topo.py``: the
fingerprint, ``leg_bytes`` of both families, ``render`` and ``describe``,
the cache's topology suffix and stamp, ``install``'s hierarchical defaults
and its legacy fallback, the algorithm names, the per-leg events that carry
no tuning signal, and the alltoall simulators (the port's against the JAX
package's, bit for bit).  A cache written by either engine loads in the
other, and ``cache_from_trace`` gives the same table from the same
recording in both.

Both engines' ``_push_native`` (the table's push into the transport) is
replaced by a no-op here: these cases need no transport, and the JAX
package's does not build with gcc 12 and newer kernel headers.  The push itself runs
in every launched world of ``tests/test_torch_world_a2a.py``.
"""

import json
import os

import numpy as np
import pytest

from mpi4jax_tpu import obs as jobs
from mpi4jax_tpu import topo as jtopo
from mpi4jax_tpu import tune as jtune

from mpi4jax_tpu_torch import obs, topo, tune

ENGINES = {"port": tune, "jax": jtune}


def _reset(engine):
    engine._cache_table = None
    engine._cache_origin = None
    engine._cache_combos = None
    engine._cache_loaded_for = None
    engine._topo_multi = False
    for op in engine.OPS:
        engine._overrides[op].clear()


@pytest.fixture(autouse=True)
def _clean_engines(monkeypatch):
    for var in ("MPI4JAX_TPU_COLL_ALGO", "MPI4JAX_TPU_TUNE_CACHE",
                "MPI4JAX_TPU_COLL_QUANT", "MPI4JAX_TPU_HIER"):
        monkeypatch.delenv(var, raising=False)
    for engine in ENGINES.values():
        monkeypatch.setattr(engine, "_push_native", lambda: True)
    for engine in ENGINES.values():
        _reset(engine)
    yield
    for engine in ENGINES.values():
        _reset(engine)


def _both(fn):
    """``fn(engine)`` on both engines; they must agree."""
    got = {name: fn(engine) for name, engine in ENGINES.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _fp(host, cards=0):
    # both packages' fingerprint keys: the port reads cards, JAX tpu_chips
    return {"v": 1, "host": host, "boot_id": "b", "fake": None,
            "cards": cards, "tpu_chips": cards}


# ---------------- tests/test_tune.py, on both engines ----------------


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_defaults_mirror_builtin_heuristic(name):
    t = ENGINES[name]
    assert t.get_algorithm("allreduce", 1024) == "tree"
    assert t.get_algorithm("allreduce", 64 * 1024) == "ring"
    assert t.get_algorithm("allreduce", 16 << 20) == "ring"
    assert t.get_algorithm("allgather", 1024) == "ring"
    assert t.sources() == ["defaults"]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_env_force_all_ops(monkeypatch, name):
    t = ENGINES[name]
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "ring")
    assert t.get_algorithm("allreduce", 16) == "ring"
    assert t.get_algorithm("allgather", 16 << 20) == "ring"
    assert "env:MPI4JAX_TPU_COLL_ALGO" in t.sources()


def test_env_forms_agree(monkeypatch):
    for raw in ("ring", "allreduce=rd,allgather=tree", "qring", "hring",
                "qalltoall", "alltoall=hqalltoall, allreduce=qrd", "auto"):
        monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", raw)
        _both(lambda t: (t.decision_table(), t._env_table(),
                         [t.get_algorithm(op, b) for op in t.OPS
                          for b in (64, 1 << 24)]))


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_env_per_op(monkeypatch, name):
    t = ENGINES[name]
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "allreduce=rd,allgather=tree")
    assert t.get_algorithm("allreduce", 16 << 20) == "rd"
    assert t.get_algorithm("allgather", 64) == "tree"


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_env_invalid_raises(monkeypatch, name):
    t = ENGINES[name]
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "warp-drive")
    with pytest.raises(ValueError, match="unknown collective algorithm"):
        t.get_algorithm("allreduce", 64)
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "teleport=ring")
    with pytest.raises(ValueError, match="unknown collective op"):
        t.get_algorithm("allreduce", 64)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_api_override_and_clear(name):
    t = ENGINES[name]
    t.set_algorithm("allreduce", "rd")
    assert t.get_algorithm("allreduce", 16 << 20) == "rd"
    assert "api" in t.sources()
    t.clear_overrides()
    t.set_algorithm("allreduce", "rd", min_bytes=1 << 20)
    assert t.get_algorithm("allreduce", 1024) == "tree"
    assert t.get_algorithm("allreduce", 2 << 20) == "rd"
    t.clear_overrides()
    assert t.get_algorithm("allreduce", 16 << 20) == "ring"


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_env_beats_api_override(monkeypatch, name):
    t = ENGINES[name]
    t.set_algorithm("allreduce", "tree")
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "allreduce=ring")
    assert t.get_algorithm("allreduce", 64) == "ring"


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_algo_name_aliases(name):
    t = ENGINES[name]
    t.set_algorithm("allreduce", "recursive_doubling")
    assert t.get_algorithm("allreduce", 64) == "rd"
    with pytest.raises(ValueError):
        t.set_algorithm("allreduce", "shm")


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_cache_round_trip(tmp_path, name):
    t = ENGINES[name]
    p = tmp_path / "tune_4.json"
    table = {"allreduce": [(0, "rd"), (1 << 20, "ring")],
             "allgather": [(0, "ring")]}
    meas = [{"op": "allreduce", "bytes": 1024, "algo": "rd",
             "seconds": 1e-5}]
    assert t.save_cache(4, table, meas, path=str(p)) == str(p)
    loaded = t.load_cache(4, path=str(p))
    assert loaded == {"allreduce": [(0, "rd"), (1048576, "ring")],
                      "allgather": [(0, "ring")]}
    assert t.get_algorithm("allreduce", 1024) == "rd"
    assert t.get_algorithm("allreduce", 2 << 20) == "ring"
    assert any(s.startswith("cache:") for s in t.sources())
    data = json.loads(p.read_text())
    assert data["version"] == t.CACHE_VERSION == 2
    assert data["world_size"] == 4
    assert data["measurements"] == meas


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_cache_malformed_rejected(tmp_path, name):
    t = ENGINES[name]
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"version": 1, "table": {"allreduce": [[0]]}}))
    with pytest.raises(ValueError, match="malformed"):
        t.load_cache(4, path=str(p))
    p.write_text(json.dumps({"version": 99, "table": {}}))
    with pytest.raises(ValueError, match="version"):
        t.load_cache(4, path=str(p))
    p.write_text(json.dumps({"hello": 1}))
    with pytest.raises(ValueError, match="table"):
        t.load_cache(4, path=str(p))
    with pytest.raises(FileNotFoundError):
        t.load_cache(4, path=str(tmp_path / "missing.json"))


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_cache_world_size_mismatch_rejected(tmp_path, name):
    t = ENGINES[name]
    p = tmp_path / "tune_4.json"
    t.save_cache(4, {"allreduce": [(0, "rd")]}, path=str(p))
    with pytest.raises(ValueError, match="world size"):
        t.load_cache(32, path=str(p))
    assert t._cache_table is None
    assert t.load_cache(4, path=str(p))


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_default_algorithm_ignores_overrides(name):
    t = ENGINES[name]
    t.set_algorithm("allreduce", "rd")
    assert t.default_algorithm("allreduce", 1024) == "tree"
    assert t.default_algorithm("allreduce", 16 << 20) == "ring"
    assert t.default_algorithm("allgather", 64) == "ring"


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_cache_path_knob(monkeypatch, tmp_path, name):
    t = ENGINES[name]
    monkeypatch.setenv("MPI4JAX_TPU_TUNE_CACHE", str(tmp_path / "x.json"))
    assert t.cache_path(8) == str(tmp_path / "x.json")
    monkeypatch.delenv("MPI4JAX_TPU_TUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert t.cache_path(8) == str(tmp_path / "mpi4jax_tpu" / "tune_8.json")


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_entries_from_measurements(name):
    t = ENGINES[name]
    assert t.entries_from_measurements({}) == []
    assert t.entries_from_measurements(
        {1024: "tree", 65536: "ring", 262144: "ring"}
    ) == [(0, "tree"), (65536, "ring")]
    assert t.entries_from_measurements(
        {1024: "rd", 65536: "ring", 262144: "rd"}
    ) == [(0, "rd"), (65536, "ring"), (262144, "rd")]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_describe_shape(name):
    t = ENGINES[name]
    info = t.describe()
    assert set(info) == {"sources", "table", "picks"}
    for op in t.OPS:
        assert info["picks"][op]["1KB"] in ("ring", "rd", "tree")
        assert info["picks"][op]["16MB"] in ("ring", "rd", "tree")


def test_describe_and_quantized_picks_agree():
    tune.set_algorithm("allreduce", "rd", min_bytes=4096)
    jtune.set_algorithm("allreduce", "rd", min_bytes=4096)
    _both(lambda t: (t.describe(), [t.quantized_algorithm(b)
                                    for b in (64, 8192, 1 << 24)]))


# ---------------- caches across the two engines ----------------


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_cache_written_by_one_loads_in_the_other(tmp_path, writer,
                                                 reader):
    w, r = ENGINES[writer], ENGINES[reader]
    p = tmp_path / "tune_4_abc.json"
    table = {"allreduce": [(0, "tree"), (65536, "hring")],
             "alltoall": [(0, "ring"), (1 << 20, "hqalltoall")]}
    combos = {"allreduce": [(0, "tree"), (65536, "hring+q+ici")]}
    w.save_cache(4, table, [{"op": "alltoall"}], path=str(p),
                 topo_fingerprint="abc", combos=combos)
    assert r.load_cache(4, path=str(p), topo_fingerprint="abc") == \
        w.load_cache(4, path=str(p), topo_fingerprint="abc")
    assert r.cache_combos() == w.cache_combos() == combos
    data = json.loads(p.read_text())
    assert data["knobs"] == tune._config.knob_env() == \
        jtune._config_mod().knob_env()
    with pytest.raises(ValueError):
        r.load_cache(4, path=str(p), topo_fingerprint="other")


def test_notice_shadowed_is_jax_s(tmp_path, monkeypatch, capsys):
    p = tmp_path / "tune_4.json"
    tune.save_cache(4, {"allreduce": [(0, "qring")],
                        "alltoall": [(0, "hqalltoall")]}, path=str(p))
    monkeypatch.setenv("MPI4JAX_TPU_COLL_QUANT", "deny")
    monkeypatch.setenv("MPI4JAX_TPU_HIER", "deny")
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "allreduce=ring")
    lines = {}
    for name, t in ENGINES.items():
        t._noticed.clear()
        t.load_cache(4, path=str(p))
        t._notice_shadowed()
        lines[name] = capsys.readouterr().err
    assert lines["port"] == lines["jax"]
    assert lines["port"].count("[tune] NOTICE") == 4


def _trace_parts(w, base):
    ev = lambda name, algo, nbytes, dur, **kw: dict(  # noqa: E731
        {"name": name, "src": "native", "ts_us": 0.0, "dur_us": dur,
         "wait_us": dur * 0.1, "dispatch_us": 0.0, "bytes": nbytes,
         "peer": -1, "tag": 0, "algo": algo}, **kw)
    events = ([ev("Allreduce", "tree", 1024, 100 + i) for i in range(4)]
              + [ev("Allreduce", "rd", 1024, 40 + i) for i in range(4)]
              + [ev("Allreduce", "ring", 1 << 20, 2500 + i)
                 for i in range(3)]
              + [ev("Allreduce", "tree", 1 << 20, 8000 + i)
                 for i in range(3)]
              + [ev("Alltoall", "hqalltoall", 1 << 15, 60.0),
                 ev("Alltoall", "qalltoall", 1 << 15, 90.0),
                 ev("Alltoall", "ring", 8192, 5.0, tier="inter"),
                 ev("Allreduce", "hring", 1 << 20, 1.0, tier="ici")])
    for rank in range(3):
        w.write_part(base, rank=rank, size=3, events=events)
    return w.part_paths(base)


@pytest.mark.parametrize("quantize", [True, False])
def test_cache_from_trace_same_table(tmp_path, quantize):
    parts = _trace_parts(obs, str(tmp_path / "out.json"))
    tables = {}
    for name, t in ENGINES.items():
        cache = str(tmp_path / f"{name}.json")
        assert t.cache_from_trace(parts, cache_path_override=cache,
                                  quantize=quantize) == cache
        data = json.load(open(cache))
        tables[name] = (data["table"], data["measurements"],
                        data["world_size"], data["transport"])
    assert tables["port"] == tables["jax"]
    table = tables["port"][0]
    assert table["alltoall"] == [[0, "hqalltoall"]]
    assert table["allreduce"] == [[0, "rd"], [1 << 20,
                                              "qring" if quantize else "ring"]]


def test_from_trace_refusals_match_jax(tmp_path, capsys):
    base = str(tmp_path / "shm.json")
    obs.write_part(base, rank=0, size=2, events=[
        {"name": "Allreduce", "src": "native", "ts_us": 0.0,
         "dur_us": 5.0, "wait_us": 0.0, "dispatch_us": 0.0, "bytes": 1024,
         "peer": -1, "tag": 0, "algo": "shm"}])
    for t in ENGINES.values():
        with pytest.raises(ValueError, match="no TCP-path collective"):
            t.cache_from_trace(obs.part_paths(base))
    # a recording of a superseded world generation is ignored, loudly
    old = str(tmp_path / "old.json")
    new = str(tmp_path / "new.json")
    ev = {"name": "Allreduce", "src": "native", "ts_us": 0.0,
          "dur_us": 5.0, "wait_us": 0.0, "dispatch_us": 0.0, "bytes": 1024,
          "peer": -1, "tag": 0, "algo": "rd"}
    obs.write_part(old, rank=0, size=4, events=[ev], generation=0)
    obs.write_part(new, rank=0, size=2, events=[dict(ev, algo="tree")],
                   generation=1)
    paths = obs.part_paths(old) + obs.part_paths(new)
    got = {}
    for name, t in ENGINES.items():
        got[name] = t.collect_trace_events(paths)
        got[name + "_err"] = capsys.readouterr().err
    assert got["port"] == got["jax"]
    assert got["port"][1] == 2 and got["port"][0][0]["algo"] == "tree"
    assert got["port_err"] == got["jax_err"] and "superseded" in \
        got["port_err"]


def test_measurements_ignore_leg_events():
    legs = [
        {"name": "Alltoall", "src": "native", "algo": "shm",
         "bytes": 4096, "dur_us": 5.0, "tier": "intra"},
        {"name": "Alltoall", "src": "native", "algo": "qalltoall",
         "bytes": 8192, "wire_bytes": 2176, "dur_us": 20.0,
         "tier": "inter"},
        {"name": "Allreduce", "src": "native", "algo": "ring",
         "bytes": 1 << 20, "dur_us": 10.0, "tier": "inter"},
        {"name": "Allreduce", "src": "ops", "algo": "hring",
         "bytes": 1 << 20, "dur_us": 10.0, "tier": "ici"},
    ]
    whole = [{"name": "Alltoall", "src": "native", "algo": "hqalltoall",
              "bytes": 1 << 15, "dur_us": 60.0},
             {"name": "Allreduce", "src": "native", "algo": "hring",
              "bytes": 1 << 20, "dur_us": 50.0}]
    m = _both(lambda t: t.measurements_from_events(legs + whole))
    assert m == {"alltoall": {1 << 15: {"hqalltoall": 60e-6}},
                 "allreduce": {1 << 20: {"hring": 50e-6}}}
    _both(lambda t: (t.wire_fractions_from_events(legs + whole),
                     t.dispatch_fractions_from_events(legs + whole)))


# ---------------- tests/test_topo.py's tune and topology cases ----------


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_check_algo_names(name):
    t = ENGINES[name]
    assert t._check_algo("hring") == "hring"
    assert t._check_algo("htree", "allgather") == "htree"
    for a in ("qalltoall", "halltoall", "hqalltoall"):
        assert t._check_algo(a, "alltoall") == a
    assert t.ALGO_CODES == jtune.ALGO_CODES
    assert t.HIER_ALGOS == {"hring", "htree"}
    assert t.A2A_QUANT == {"qalltoall", "hqalltoall"}
    assert t.A2A_HIER == {"halltoall", "hqalltoall"}
    assert t.HIER_FLAT_TWIN == jtune.HIER_FLAT_TWIN
    assert t.EXACT_TWIN == jtune.EXACT_TWIN
    for bad, op in (("hband", None), ("qalltoall", "allreduce"),
                    ("qring", "alltoall"), ("qring", "allgather")):
        with pytest.raises(ValueError):
            t._check_algo(bad, op)


def test_joint_combo_grammar_is_jax_s():
    from mpi4jax_tpu.tune import _joint

    assert tune.JOINT_CANDIDATES == _joint.JOINT_CANDIDATES
    for op, combos in _joint.JOINT_CANDIDATES.items():
        for c in combos:
            assert tune.check_combo(c, op) == _joint.check_combo(c, op)
            assert tune.combo_algo(c) == _joint.combo_algo(c)
            assert tune.combo_gates(c) == _joint.combo_gates(c)
    with pytest.raises(ValueError):
        tune.check_combo("hring+q", "allgather")


def test_cache_path_topology_suffix(monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", "/tmp/xdgtest")
    _both(lambda t: (t.cache_path(8), t.cache_path(8, "abc123")))
    assert tune.cache_path(8, "abc123").endswith("tune_8_abc123.json")


def test_install_topology_flips_defaults_and_legacy_fallback(
        tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    multi = {"port": topo.Topology([_fp("a"), _fp("a"), _fp("b"),
                                    _fp("b")]),
             "jax": jtopo.Topology([_fp("a"), _fp("a"), _fp("b"),
                                    _fp("b")])}
    flat = {"port": topo.Topology([_fp("a")] * 4),
            "jax": jtopo.Topology([_fp("a")] * 4)}
    assert multi["port"].fingerprint() == multi["jax"].fingerprint()

    def step(fn):
        return _both(lambda t: fn(t, "port" if t is tune else "jax"))

    step(lambda t, k: (t.install(4, topology=multi[k]),
                       t.get_algorithm("allreduce", 16 << 20),
                       t.sources()))
    assert tune.get_algorithm("allreduce", 16 << 20) == "hring"
    step(lambda t, k: (t.install(4, topology=flat[k]),
                       t.get_algorithm("allreduce", 16 << 20)))
    legacy = {"version": 1, "world_size": 4, "table":
              {"allreduce": [[0, "rd"]]}, "measurements": []}
    os.makedirs(tmp_path / "mpi4jax_tpu", exist_ok=True)
    (tmp_path / "mpi4jax_tpu" / "tune_4.json").write_text(
        json.dumps(legacy))
    step(lambda t, k: (t.install(4, topology=multi[k]),
                       t.get_algorithm("allreduce", 16 << 20)))
    assert tune.get_algorithm("allreduce", 16 << 20) == "rd"
    fp = multi["port"].fingerprint()
    keyed = dict(legacy, table={"allreduce": [[0, "htree"]]}, topology=fp)
    (tmp_path / "mpi4jax_tpu" / f"tune_4_{fp}.json").write_text(
        json.dumps(keyed))
    for t in ENGINES.values():
        t._cache_table = None
        t._cache_loaded_for = None
    step(lambda t, k: (t.install(4, topology=multi[k]),
                       t.get_algorithm("allreduce", 16 << 20)))
    assert tune.get_algorithm("allreduce", 16 << 20) == "htree"


def test_topology_fingerprint_leg_bytes_render():
    hosts = ["a"] * 4 + ["b"] * 4
    pt = topo.Topology([_fp(h) for h in hosts])
    jt = jtopo.Topology([_fp(h) for h in hosts])
    assert pt.fingerprint() == jt.fingerprint()
    assert len(pt.fingerprint()) == 12
    assert pt.render() == jt.render()
    assert pt.describe() == jt.describe()
    for algo in ("hring", "htree", "halltoall", "hqalltoall", "qalltoall",
                 "alltoall", "ring"):
        for nbytes in (1000, 8000, 1 << 20):
            assert pt.leg_bytes(algo, nbytes) == jt.leg_bytes(algo, nbytes)
    assert pt.leg_bytes("hring", 1000) == {"intra": 2 * 1000 * 6,
                                           "inter": 2 * 1000}
    for shape in (["a", "a", "b", "c"], ["x"] * 4, ["a", "b", "c"]):
        p, j = (m.Topology([_fp(h) for h in shape]) for m in (topo, jtopo))
        assert p.fingerprint() == j.fingerprint()
        assert p.render() == j.render()
        assert p.leg_bytes("htree", 1000) == j.leg_bytes("htree", 1000)
    # a card tier changes the shape's key, as a TPU tier does there
    pc = topo.Topology([_fp(h, cards=1) for h in hosts])
    jc = jtopo.Topology([_fp(h, cards=1) for h in hosts])
    assert pc.fingerprint() == jc.fingerprint() != pt.fingerprint()
    assert topo._quant_wire_bytes(1028) == jtopo._quant_wire_bytes(1028)
    for n, k in ((8, 2), (6, 3), (4, 4)):
        assert topo.synthetic_islands(n, k) == jtopo.synthetic_islands(n, k)
    with pytest.raises(ValueError):
        topo.synthetic_islands(6, 4)


@pytest.mark.parametrize("n,islands", [(4, [[0, 1], [2, 3]]),
                                       (5, [[0, 1, 2], [3, 4]]),
                                       (6, [[0, 2, 4], [1, 3, 5]])])
def test_alltoall_simulators_match_jax(n, islands):
    rng = np.random.RandomState(n)
    base = (rng.randn(n, n, 3, 97) * 4).astype(np.float32)
    inputs = [base[r] for r in range(n)]
    for p, j in ((topo.simulate_qalltoall(inputs),
                  jtopo.simulate_qalltoall(inputs)),
                 (topo.simulate_halltoall(inputs),
                  jtopo.simulate_halltoall(inputs)),
                 (topo.simulate_hqalltoall(inputs, islands),
                  jtopo.simulate_hqalltoall(inputs, islands))):
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(p, j))
    want = [base[:, r] for r in range(n)]
    got = topo.simulate_qalltoall(inputs)
    for r in range(n):
        assert np.array_equal(got[r][r], want[r][r])
        assert 0 < np.max(np.abs(got[r] - want[r])) < (
            np.max(np.abs(base)) / 127.0 + 1e-6)


def test_stats_alltoall_quant_rows_match_jax():
    events = [
        {"name": "Alltoall", "src": "native", "ts_us": 0.0,
         "dur_us": 40.0, "wait_us": 0.0, "dispatch_us": 0.0,
         "bytes": 8192, "wire_bytes": 2176, "peer": -1, "tag": 0,
         "algo": "qalltoall"},
        {"name": "Alltoall", "src": "native", "ts_us": 1.0,
         "dur_us": 10.0, "wait_us": 0.0, "dispatch_us": 0.0,
         "bytes": 4096, "peer": -1, "tag": 0, "algo": "shm",
         "tier": "intra"},
        {"name": "Alltoall", "src": "native", "ts_us": 3.0,
         "dur_us": 60.0, "wait_us": 0.0, "dispatch_us": 0.0,
         "bytes": 1 << 15, "peer": -1, "tag": 0, "algo": "hqalltoall"},
    ]
    stats = obs.summarize(events)
    assert stats == jobs.summarize(events)
    assert stats["tier_bytes"] == {"intra": 4096}
