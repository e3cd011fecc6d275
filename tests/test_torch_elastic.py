"""The port's elastic layer (``mpi4jax_tpu_torch/elastic/``) against the
JAX package's, and the bridge's failure and rebuild paths, on the CPU.

The JAX modules load under an alias package, as ``tests/test_torch_planrt.py``
loads them.  Held to the JAX package with the same inputs:

- the knobs' parsing of the same environments (``utils/config.py``);
- ``read_generation`` and ``wait_for_generation`` on the same ``gen_<n>.json``
  files: the newest announcement wins, a torn or mislabelled file is not
  one, an empty directory raises ``RankFailure(op="recover")`` after the
  grace period;
- ``is_rank_failure`` on the same exception chains, ``my_slot`` on the same
  environments, ``Recovery``'s fields and ``recover`` end to end with each
  package's ``bridge.rebuild`` replaced by the same recording fake.

The bridge's own paths, with a recording fake for the native library:
``_abort`` raises ``RankFailure`` under ``MPI4JAX_TPU_ELASTIC`` after
``tpucomm_abort_all`` and exits otherwise; topology discovery, the live arm
and the plan install let a ``RankFailure`` through and soften anything
else; ``rebuild`` finalizes the dead world's sub-comms and disarms live
re-tuning before ``tpucomm_shrink``, reruns the per-world setup, then
calls ``planrt.reinstall_after_rebuild``, and closes the new world when
the setup fails.  ``rebuild`` also runs once on the built transport at
size 1.
"""

import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch import elastic as p_elastic
from mpi4jax_tpu_torch import obs, topo
from mpi4jax_tpu_torch.elastic import _world as p_world
from mpi4jax_tpu_torch.parallel import dp
from mpi4jax_tpu_torch.runtime import bridge, planrt, transport
from mpi4jax_tpu_torch.utils import checkpoint
from mpi4jax_tpu_torch.utils import config as p_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ALIAS = "m4j_lv"
if _ALIAS not in sys.modules:
    _pkg = types.ModuleType(_ALIAS)
    _pkg.__path__ = [os.path.join(REPO, "mpi4jax_tpu")]
    sys.modules[_ALIAS] = _pkg
j_elastic = importlib.import_module(_ALIAS + ".elastic")
j_world = importlib.import_module(_ALIAS + ".elastic._world")
j_config = importlib.import_module(_ALIAS + ".utils.config")
j_bridge = importlib.import_module(_ALIAS + ".runtime.bridge")
j_transport = importlib.import_module(_ALIAS + ".runtime.transport")

PKGS = {"jax": (j_elastic, j_world, j_config),
        "port": (p_elastic, p_world, p_config)}
ELASTIC_KNOBS = ("MPI4JAX_TPU_ELASTIC", "MPI4JAX_TPU_ELASTIC_DIR",
                 "MPI4JAX_TPU_ELASTIC_POLICY", "MPI4JAX_TPU_ELASTIC_GRACE_S",
                 "MPI4JAX_TPU_GENERATION", "MPI4JAX_TPU_SLOT",
                 "MPI4JAX_TPU_RANK")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ELASTIC_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for world in (j_world, p_world):
        monkeypatch.setattr(world, "_generation", None)
        monkeypatch.setattr(world, "_last_attempted", None)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError:
        return ("ValueError", None)


def test_public_surface_matches_jax():
    assert p_elastic.__all__ == j_elastic.__all__
    assert hasattr(p_elastic.training, "run")
    for name in ("Request", "Server", "serve_worker"):
        assert hasattr(p_elastic.serving, name)


@pytest.mark.parametrize("knob,name,value", [
    ("elastic_enabled", "MPI4JAX_TPU_ELASTIC", None),
    ("elastic_enabled", "MPI4JAX_TPU_ELASTIC", "1"),
    ("elastic_enabled", "MPI4JAX_TPU_ELASTIC", "maybe"),
    ("elastic_dir", "MPI4JAX_TPU_ELASTIC_DIR", ""),
    ("elastic_dir", "MPI4JAX_TPU_ELASTIC_DIR", "/tmp/x"),
    ("elastic_policy", "MPI4JAX_TPU_ELASTIC_POLICY", None),
    ("elastic_policy", "MPI4JAX_TPU_ELASTIC_POLICY", " respawn "),
    ("elastic_policy", "MPI4JAX_TPU_ELASTIC_POLICY", "grow"),
    ("elastic_grace_s", "MPI4JAX_TPU_ELASTIC_GRACE_S", "2.5"),
    ("elastic_grace_s", "MPI4JAX_TPU_ELASTIC_GRACE_S", "-1"),
    ("elastic_grace_s", "MPI4JAX_TPU_ELASTIC_GRACE_S", "soon"),
    ("generation", "MPI4JAX_TPU_GENERATION", "3"),
    ("generation", "MPI4JAX_TPU_GENERATION", "  "),
    ("generation", "MPI4JAX_TPU_GENERATION", "two"),
])
def test_knobs_parse_as_jax(monkeypatch, knob, name, value):
    if value is not None:
        monkeypatch.setenv(name, value)
    want = _outcome(getattr(j_config, knob))
    got = _outcome(getattr(p_config, knob))
    assert got == want


def _write(d, n, spec):
    with open(os.path.join(d, f"gen_{n}.json"), "w") as f:
        f.write(spec if isinstance(spec, str) else json.dumps(spec))


def _spec(n, size=2):
    return {"generation": n, "size": size, "base_port": 45000 + n,
            "map": {"0": 0, "2": 1, "1": -1}, "lost": [1],
            "policy": "shrink", "hosts": "", "np0": 3}


@pytest.mark.parametrize("case", ["newest", "torn", "mislabelled", "gap"])
def test_generation_files_read_as_jax(tmp_path, case):
    d = str(tmp_path)
    _write(d, 1, _spec(1))
    if case == "newest":
        _write(d, 2, _spec(2))
        _write(d, 3, _spec(3))
    elif case == "torn":
        _write(d, 2, json.dumps(_spec(2))[:20])
    elif case == "mislabelled":
        _write(d, 2, _spec(5))
    else:
        _write(d, 3, _spec(3))  # gen_2 missing: the walk stops there
    results = {}
    for name, (_, world, _) in PKGS.items():
        results[name] = (
            [world.read_generation(d, n) for n in range(5)],
            world.wait_for_generation(1, grace_s=1.0, gen_dir=d))
    assert results["port"] == results["jax"]
    newest = {"newest": 3, "torn": 1, "mislabelled": 1, "gap": 1}[case]
    assert results["port"][1]["generation"] == newest


def test_no_announcement_raises_rank_failure_as_jax(tmp_path):
    for name, (pkg, world, _) in PKGS.items():
        with pytest.raises(pkg.RankFailure) as err:
            world.wait_for_generation(1, grace_s=0.1, gen_dir=str(tmp_path))
        assert err.value.op == "recover"
        assert "MPI4JAX_TPU_ELASTIC_GRACE_S" in str(err.value)
        with pytest.raises(RuntimeError, match="ELASTIC_DIR"):
            world.wait_for_generation(1, grace_s=0.1)


def _chains(pkg):
    RF = pkg.RankFailure

    def caused(inner, outer):
        try:
            try:
                raise inner
            except BaseException as e:
                raise outer from e
        except BaseException as e:
            return e

    def context(inner, outer):
        try:
            try:
                raise inner
            except BaseException:
                raise outer
        except BaseException as e:
            return e

    looped = RuntimeError("loop")
    looped.__context__ = ValueError("back")
    looped.__context__.__context__ = looped
    return [
        RF("x", op="Send"),
        caused(RF("x"), RuntimeError("wrapped")),
        context(RF("x"), KeyError("k")),
        caused(caused(RF("x"), ValueError("v")), TypeError("t")),
        RuntimeError("tpucomm_Allreduce failed: peer gone"),
        RuntimeError("XlaRuntimeError: RankFailure: tpucomm_Recv"),
        ValueError("unrelated"),
        caused(ValueError("a"), KeyError("b")),
        looped,
    ]


def test_is_rank_failure_on_the_same_chains_as_jax():
    want = [j_elastic.is_rank_failure(e) for e in _chains(j_elastic)]
    got = [p_elastic.is_rank_failure(e) for e in _chains(p_elastic)]
    assert got == want == [True] * 6 + [False] * 3
    e = p_elastic.RankFailure("m")
    assert isinstance(e, RuntimeError) and e.op == "?"


@pytest.mark.parametrize("env", [{"MPI4JAX_TPU_RANK": "2"},
                                 {"MPI4JAX_TPU_RANK": "0",
                                  "MPI4JAX_TPU_SLOT": "3"},
                                 {}])
def test_my_slot_and_generation_as_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("MPI4JAX_TPU_GENERATION", "4")
    out = {}
    for name, (_, world, _) in PKGS.items():
        try:
            slot = world.my_slot()
        except RuntimeError:
            slot = "RuntimeError"
        out[name] = (slot, world.current_generation())
    assert out["port"] == out["jax"]


class _Rebuilds:
    """Each package's ``bridge.rebuild``, recorded; returns a new handle."""

    def __init__(self):
        self.calls = []

    def __call__(self, old, rank, size, port, hosts, **kw):
        self.calls.append((old, rank, size, port, hosts, kw))
        return 99


@pytest.mark.parametrize("hosts", ["", "10.0.0.1,10.0.0.3"])
def test_recover_rebinds_the_world_as_jax(tmp_path, monkeypatch, hosts):
    d = str(tmp_path)
    spec = dict(_spec(1), hosts=hosts)
    _write(d, 1, spec)
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_DIR", d)
    monkeypatch.setenv("MPI4JAX_TPU_RANK", "2")
    monkeypatch.delenv("MPI4JAX_TPU_CONNECT_TIMEOUT_S", raising=False)
    fakes = {"jax": _Rebuilds(), "port": _Rebuilds()}
    monkeypatch.setattr(j_bridge, "rebuild", fakes["jax"])
    monkeypatch.setattr(bridge, "rebuild", fakes["port"])
    jw = j_transport.WorldComm(2, 3, "127.0.0.1:45000", handle=5)
    pw = transport.WorldComm(2, 3, "127.0.0.1:45000", handle=5,
                             device="cpu")
    held = pw  # a reference taken before the recovery
    got = {"jax": j_world.recover(jw)}
    # the JAX recover advanced the process's MPI4JAX_TPU_GENERATION
    monkeypatch.setenv("MPI4JAX_TPU_GENERATION", "0")
    got["port"] = p_world.recover(pw)
    fields = ("generation", "rank", "size", "old_to_new", "lost", "policy",
              "base_port")
    assert ({f: getattr(got["port"], f) for f in fields}
            == {f: getattr(got["jax"], f) for f in fields})
    assert repr(got["port"]) == repr(got["jax"])
    assert fakes["port"].calls == [(5, 1, 2, 45001, hosts,
                                    {"device": torch.device("cpu")})]
    assert [c[:5] for c in fakes["jax"].calls] == \
        [c[:5] for c in fakes["port"].calls]
    for w in (jw, held):
        assert (w.rank(), w.size(), w._handle) == (1, 2, 99)
        assert w._coord == f"{(hosts or '127.0.0.1').split(',')[0]}:45001"
    assert held.device == torch.device("cpu")
    assert got["port"].world is held
    assert p_world.current_generation() == 1
    assert os.environ["MPI4JAX_TPU_GENERATION"] == "1"
    assert os.environ["MPI4JAX_TPU_CONNECT_TIMEOUT_S"] == "30"


def test_recover_refuses_a_lost_slot_as_jax(tmp_path, monkeypatch):
    _write(str(tmp_path), 1, _spec(1))
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_DIR", str(tmp_path))
    monkeypatch.setenv("MPI4JAX_TPU_RANK", "1")
    monkeypatch.setattr(bridge, "rebuild", _Rebuilds())
    monkeypatch.setattr(j_bridge, "rebuild", _Rebuilds())
    jw = j_transport.WorldComm(1, 3, "127.0.0.1:1", handle=5)
    pw = transport.WorldComm(1, 3, "127.0.0.1:1", handle=5, device="cpu")
    for pkg, world, comm in ((j_elastic, j_world, jw),
                             (p_elastic, p_world, pw)):
        monkeypatch.setenv("MPI4JAX_TPU_GENERATION", "0")
        with pytest.raises(pkg.RankFailure, match="declared lost") as err:
            world.recover(comm, grace_s=1.0)
        assert err.value.op == "recover"
    assert pw.rank() == 1 and pw._handle == 5


def test_rebind_is_for_the_world_comm_only():
    world = transport.WorldComm(0, 2, "127.0.0.1:1", handle=3, device="cpu")
    sub = transport.WorldComm(0, 1, "127.0.0.1:1", handle=4, device="cpu",
                              parent=world)
    with pytest.raises(RuntimeError, match="only the world"):
        sub._rebind(0, 1, "127.0.0.1:2", 5)


# ---------------- the bridge, with a recording native library ----------


class FakeLib:
    """The native entries the failure and rebuild paths use, recorded."""

    def __init__(self, shrink_handle=50):
        self.calls = []
        self.shrink_handle = shrink_handle

    def tpucomm_last_error(self):
        return b"r0: recv header from 1 failed"

    def tpucomm_abort_all(self):
        self.calls.append(("abort_all",))

    def tpucomm_finalize(self, h):
        self.calls.append(("finalize", int(h)))

    def tpucomm_shrink(self, old, rank, size, port, hosts):
        self.calls.append(("shrink", int(old), rank, size, port, hosts))
        return self.shrink_handle


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(bridge, "get_lib", lambda: lib)
    return lib


def test_abort_raises_rank_failure_under_elastic(fake_lib, monkeypatch,
                                                 capsys):
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC", "1")
    with pytest.raises(p_elastic.RankFailure) as err:
        bridge._check("Allreduce", 1)
    assert err.value.op == "Allreduce"
    assert "tpucomm_Allreduce failed: r0: recv header" in str(err.value)
    assert fake_lib.calls == [("abort_all",)]
    assert "tpucomm_Allreduce returned error code 1" in \
        capsys.readouterr().err


def test_abort_exits_without_elastic(fake_lib, monkeypatch):
    class Exited(Exception):
        pass

    def _exit(code):
        raise Exited(code)

    monkeypatch.setattr(os, "_exit", _exit)
    with pytest.raises(Exited):
        bridge._abort("Send", 3)
    assert fake_lib.calls == [("abort_all",)]


def _raise(raised, op, other):
    """A rank failure, one wrapped in another error, or another error."""
    if raised == "rank_failure":
        raise p_elastic.RankFailure("peer died", op=op)
    if raised == "wrapped":
        try:
            raise p_elastic.RankFailure("peer died", op=op)
        except p_elastic.RankFailure as e:
            raise RuntimeError("setup step failed") from e
    raise RuntimeError(other)


@pytest.mark.parametrize("raised", ["rank_failure", "wrapped",
                                    "runtime_error"])
def test_topology_discovery_lets_a_rank_failure_through(fake_lib,
                                                        monkeypatch, raised):
    def discover(*a, **k):
        _raise(raised, "Allgather", "mixed fingerprint versions")

    monkeypatch.setattr(topo, "discover", discover)
    if raised != "runtime_error":
        with pytest.raises(RuntimeError) as err:
            bridge._install_topology(fake_lib, 7, 0, 2, None)
        assert isinstance(err.value if raised == "rank_failure"
                          else err.value.__cause__, p_elastic.RankFailure)
    else:
        with pytest.warns(UserWarning, match="stays flat"):
            assert bridge._install_topology(fake_lib, 7, 0, 2, None) is None


@pytest.mark.parametrize("layer", ["live", "plan"])
@pytest.mark.parametrize("raised", ["rank_failure", "runtime_error"])
def test_setup_layers_let_a_rank_failure_through(monkeypatch, layer,
                                                 raised):
    """A rank failure, bare and wrapped in another error, goes through;
    another error is softened to a warning."""
    from mpi4jax_tpu_torch import live, tune

    forms = ["rank_failure", "wrapped"] if raised == "rank_failure" \
        else [raised]
    form = None

    def boom(*a, **k):
        _raise(form, "Bcast", "layer hiccup")

    monkeypatch.setattr(tune, "install", lambda *a, **k: None)
    monkeypatch.setenv("MPI4JAX_TPU_TOPO", "off")
    monkeypatch.delenv("MPI4JAX_TPU_TRACE", raising=False)
    if layer == "live":
        monkeypatch.setenv("MPI4JAX_TPU_LIVE", "auto")
        monkeypatch.setattr(live, "arm", boom)
    else:
        monkeypatch.setattr(planrt, "plan_spec", lambda: "plan.json")
        monkeypatch.setattr(planrt, "maybe_install_from_env", boom)
    run = lambda: bridge._post_init_setup(  # noqa: E731
        None, 7, 0, 2, None, install_plan=True)
    for form in forms:
        if form == "runtime_error":
            with pytest.warns(UserWarning, match="failed"):
                run()
            continue
        with pytest.raises(RuntimeError) as err:
            run()
        assert isinstance(err.value if form == "rank_failure"
                          else err.value.__cause__, p_elastic.RankFailure)


def _dead_world(monkeypatch, handle=7):
    """Topology sub-comms and a registered map for ``handle``, as a
    two-island world leaves them."""
    t = topo.Topology.__new__(topo.Topology)
    monkeypatch.setitem(bridge._topo_handles, handle, [71, 72])
    monkeypatch.setitem(bridge._topo_subcomms, handle, {"topology": t})
    topo._register(handle, t)
    return t


def test_rebuild_tears_down_then_shrinks_then_sets_up(fake_lib,
                                                      monkeypatch):
    order = []
    _dead_world(monkeypatch)
    monkeypatch.setattr(bridge, "_live_disarm",
                        lambda handle=None: order.append(("disarm", handle)))
    monkeypatch.setattr(
        bridge, "_post_init_setup",
        lambda lib, h, r, s, dev, install_plan: order.append(
            ("setup", h, r, s, dev, install_plan)))
    monkeypatch.setattr(
        planrt, "reinstall_after_rebuild",
        lambda old, h, r, s, pin_memory: order.append(
            ("reinstall", old, h, r, s, pin_memory)))
    h = bridge.rebuild(7, 1, 2, 45010, "", device=torch.device("cpu"))
    assert h == 50
    assert fake_lib.calls == [("finalize", 71), ("finalize", 72),
                              ("shrink", 7, 1, 2, 45010, b"")]
    assert order == [("disarm", None),
                     ("setup", 50, 1, 2, torch.device("cpu"), False),
                     ("reinstall", 7, 50, 1, 2, False)]
    # no cache keeps the dead handle
    assert 7 not in bridge._topo_handles and 7 not in bridge._topo_subcomms
    assert topo.get_topology(7) is None


def test_rebuild_closes_the_new_world_when_its_setup_fails(fake_lib,
                                                           monkeypatch):
    dropped = []

    def setup(*a, **k):
        raise p_elastic.RankFailure("another death", op="Allgather")

    monkeypatch.setattr(bridge, "_post_init_setup", setup)
    monkeypatch.setattr(planrt, "drop", dropped.append)
    monkeypatch.setattr(planrt, "reinstall_after_rebuild",
                        lambda *a, **k: pytest.fail("no reinstall"))
    with pytest.raises(p_elastic.RankFailure):
        bridge.rebuild(7, 0, 2, 45010)
    assert fake_lib.calls[-2:] == [("shrink", 7, 0, 2, 45010, b""),
                                   ("finalize", 50)]
    assert dropped == [7]


def test_rebuild_refuses_a_library_without_shrink(monkeypatch):
    monkeypatch.setattr(bridge, "get_lib", lambda: object())
    assert not bridge.shrink_available()
    with pytest.raises(RuntimeError, match="tpucomm_shrink"):
        bridge.rebuild(0, 0, 1, 45000)


def test_planrt_get_lets_a_rank_failure_through(monkeypatch):
    class Dying:
        @property
        def handle(self):
            raise p_elastic.RankFailure("init", op="init")

    monkeypatch.setattr(planrt, "plan_spec", lambda: "plan.json")
    with pytest.raises(p_elastic.RankFailure):
        planrt.get(Dying())


def test_rebuild_on_the_built_transport(monkeypatch):
    """``tpucomm_shrink`` from no world to a world of one, the per-world
    setup on it, and an op on the new handle."""
    port = transport._free_port_block(1)
    assert bridge.shrink_available()
    h = bridge.rebuild(0, 0, 1, port, "", device=torch.device("cpu"))
    try:
        assert bridge.comm_size(h) == 1 and bridge.comm_rank(h) == 0
        bridge.barrier(h)
        out = bridge.allreduce(h, np.arange(4.0), 0)
        np.testing.assert_array_equal(out, np.arange(4.0))
    finally:
        bridge.comm_finalize(h)


def test_checkpoint_and_recording_carry_the_live_generation(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(p_world, "_generation", 2)
    d = checkpoint.save_sharded({"w": torch.ones(3)}, step=4,
                                directory=str(tmp_path))
    with open(os.path.join(d, checkpoint.MANIFEST)) as f:
        assert json.load(f)["generation"] == 2
    path = obs.dump(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert json.load(f)["generation"] == 2


def test_elastic_step_fn_takes_floating_leaves_only():
    class One:
        def rank(self):
            return 0

        def size(self):
            return 1

    step = dp.elastic_step_fn(lambda p, x: (p["w"] * x).sum(), lr=0.1,
                              batch_fn=lambda s, r, n: torch.ones(2))
    with pytest.raises(TypeError, match="floating"):
        step({"w": torch.ones(2, dtype=torch.int64)}, 0, One())
