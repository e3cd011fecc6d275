"""The port's plan runner (``runtime/planrt.py``) against the JAX package's.

The JAX modules load under an alias package, as ``tests/test_live.py``
loads them.  Both packages' bridge entries (``post_send``,
``post_recv_into``, ``send``, ``recv``, ``wait_ticket``,
``post_available``) are replaced by one recording fake, and the JAX
``PlanRunner`` and the port's are driven with the same op streams: the
chain plan of ``schedule_overlap._pipeline_schedule`` at np 3, and the
golden ``false_serialization.np3`` and ``bucketed_dp_grad.np2`` plans.
They must issue the same bridge calls in the same order (kind, peer, tag,
bytes), with the same stats and cursor, also when a stream diverges from
its plan.  ``install``'s refusals, ``maybe_install_from_env`` and
``reinstall_after_rebuild`` are held to the JAX package's outcomes.
"""

import gc
import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch.analysis import _events as p_events
from mpi4jax_tpu_torch.analysis import _plan as p_plan
from mpi4jax_tpu_torch.benchmarks import schedule_overlap
from mpi4jax_tpu_torch.runtime import bridge as p_bridge
from mpi4jax_tpu_torch.runtime import planrt as p_planrt
from mpi4jax_tpu_torch.utils import dtypes as p_dtypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "world_programs", "golden_plans")

_ALIAS = "m4j_lv"
if _ALIAS not in sys.modules:
    _pkg = types.ModuleType(_ALIAS)
    _pkg.__path__ = [os.path.join(REPO, "mpi4jax_tpu")]
    sys.modules[_ALIAS] = _pkg
j_planrt = importlib.import_module(_ALIAS + ".runtime.planrt")
j_bridge = importlib.import_module(_ALIAS + ".runtime.bridge")
j_plan = importlib.import_module(_ALIAS + ".analysis._plan")
j_events = importlib.import_module(_ALIAS + ".analysis._events")

PKGS = {"jax": (j_planrt, j_bridge, j_plan, j_events),
        "port": (p_planrt, p_bridge, p_plan, p_events)}
HANDLE = 7


class Fake:
    """One recording stand-in for a package's bridge entries: every call as
    (kind, peer, tag, bytes), a wait as ("wait", the post's number)."""

    def __init__(self, posts=True):
        self.calls = []
        self.posts = posts
        self._n = 0

    def _ticket(self):
        self._n += 1
        return self._n

    @staticmethod
    def _fill(buf, peer, tag):
        buf.reshape(-1).view(np.uint8)[:] = (31 * peer + tag) % 251

    def post_available(self):
        return self.posts

    def post_send(self, handle, buf, dest, tag):
        self.calls.append(("post_send", dest, tag, buf.nbytes))
        return self._ticket(), (buf,)

    def post_recv_into(self, handle, out, source, tag):
        self.calls.append(("post_recv", source, tag, out.nbytes))
        self._fill(out, source, tag)
        return self._ticket(), None

    def send(self, handle, buf, dest, tag):
        self.calls.append(("send", dest, tag, np.asarray(buf).nbytes))

    def jax_recv(self, handle, shape, dtype, source, tag, reuse=False):
        out = np.empty(shape, dtype)
        self.calls.append(("recv", source, tag, out.nbytes))
        self._fill(out, source, tag)
        return out

    def port_recv(self, handle, out, source, tag):
        self.calls.append(("recv", source, tag, out.nbytes))
        self._fill(out, source, tag)
        return out

    def wait_ticket(self, handle, ticket):
        self.calls.append(("wait", ticket))


def _patch(monkeypatch, which, fake):
    bridge = PKGS[which][1]
    for name in ("post_available", "post_send", "post_recv_into", "send",
                 "wait_ticket"):
        monkeypatch.setattr(bridge, name, getattr(fake, name))
    monkeypatch.setattr(bridge, "recv", getattr(fake, f"{which}_recv"))


@pytest.fixture
def fakes(monkeypatch):
    """The two packages' bridges, each on its own recording fake; the
    runners and the cached knob are reset before and after."""
    out = {w: Fake() for w in PKGS}
    for which, fake in out.items():
        _patch(monkeypatch, which, fake)
    for rt in (j_planrt, p_planrt):
        monkeypatch.setattr(rt, "_runners", {})
        monkeypatch.setattr(rt, "_active", False)
        monkeypatch.setattr(rt, "_spec_cache", False)
        monkeypatch.setattr(rt, "_plan_source", None)
    yield out


def _chain_plan(which, n=3, rounds=3, shape=(128 * 1024,)):
    _, _, plan_mod, ev_mod = PKGS[which]
    events = {}
    for rank in range(n):
        evs = []
        for k in range(rounds):
            if rank < n - 1:
                evs.append(ev_mod.CommEvent(rank, len(evs), "send",
                                            dest=rank + 1, tag=k,
                                            dtype="float32", shape=shape))
            if rank > 0:
                evs.append(ev_mod.CommEvent(rank, len(evs), "recv",
                                            source=rank - 1, tag=k,
                                            dtype="float32", shape=shape))
        events[rank] = evs
    return plan_mod.compile_schedules(events, {(0,): tuple(range(n))})


def _plan_for(which, name):
    if name == "chain":
        return _chain_plan(which)
    return PKGS[which][2].load_plan(
        os.path.join(GOLDEN, f"{name}.plan.json"))


def _stream(plan, rank):
    """A package-neutral op stream: the rank's plan ops as a program
    would present them."""
    ops = []
    for op in plan.ranks[rank].ops:
        if op.kind == "send":
            ops.append(("send", {"dest": op.dest, "tag": op.tag,
                                 "dtype": op.dtype, "shape": op.shape}))
        elif op.kind == "recv":
            ops.append(("recv", {"source": op.source, "tag": op.tag,
                                 "dtype": op.dtype, "shape": op.shape}))
        else:
            sig = {k: getattr(op, k) for k in ("reduce_op", "root", "nbytes")
                   if getattr(op, k) is not None}
            ops.append((op.kind, sig))
    return ops


def _drive(which, rt, fake, ops):
    """Run ``ops`` through a package's runner the way its ops layer does,
    falling back to the (fake) bridge when the runner declines.  Returns
    the received payloads' bytes."""
    got = []
    for kind, p in ops:
        if kind == "send":
            buf = np.zeros(p["shape"], np.dtype(
                "int16" if p["dtype"] == "bfloat16" else p["dtype"]))
            if not rt.run_send(buf, p["dest"], p["tag"]):
                fake.send(HANDLE, buf, p["dest"], p["tag"])
        elif kind == "recv":
            if which == "jax":
                dt = np.dtype("int16" if p["dtype"] == "bfloat16"
                              else p["dtype"])
                out = rt.run_recv(p["shape"], dt, p["source"], p["tag"])
                if out is None:
                    out = fake.jax_recv(HANDLE, p["shape"], dt,
                                        p["source"], p["tag"])
                got.append(np.asarray(out).tobytes())
            else:
                dt = p_dtypes.from_name(p["dtype"])
                out = rt.run_recv(p["shape"], dt, p["source"], p["tag"])
                if out is None:
                    out = torch.empty(p["shape"], dtype=dt)
                    fake.port_recv(HANDLE, p_dtypes.host_view(out),
                                   p["source"], p["tag"])
                got.append(p_dtypes.host_view(out).tobytes())
        else:
            rt.run_sync(kind, lambda k=kind: fake.calls.append(("sync", k)),
                        **p)
    return got


def _install_both(fakes, name, rank):
    runners = {}
    for which in PKGS:
        planrt = PKGS[which][0]
        plan = _plan_for(which, name)
        assert planrt.install(HANDLE, plan, rank)
        runners[which] = planrt._runners[HANDLE]
    assert runners["jax"].plan.cache_key == runners["port"].plan.cache_key
    return runners


def _same(runners, fakes):
    assert fakes["port"].calls == fakes["jax"].calls
    assert runners["port"].stats == runners["jax"].stats
    assert runners["port"].cursor == runners["jax"].cursor
    assert runners["port"].enabled == runners["jax"].enabled


CASES = [("chain", r) for r in range(3)] \
    + [("false_serialization.np3", r) for r in range(3)] \
    + [("bucketed_dp_grad.np2", r) for r in range(2)]


@pytest.mark.parametrize("name,rank", CASES)
def test_same_bridge_calls_as_the_jax_runner(fakes, name, rank):
    runners = _install_both(fakes, name, rank)
    plan = runners["jax"].plan
    ops = _stream(plan, rank)
    got = {}
    for which in PKGS:
        # two passes: the second runs after the plan's wrap
        got[which] = _drive(which, runners[which], fakes[which], ops + ops)
        runners[which].flush()
    _same(runners, fakes)
    assert got["port"] == got["jax"]
    assert runners["port"].stats["mismatches"] == 0
    if any(op.hoisted for op in plan.ranks[rank].ops):
        assert runners["port"].stats["hoisted_recvs"] > 0
    if any(op.deferred for op in plan.ranks[rank].ops):
        assert runners["port"].stats["deferred_sends"] > 0


@pytest.mark.parametrize("k", [1, 2, 3])
def test_diverging_stream_disables_the_plan_the_same_way(fakes, k):
    """A stream that leaves the plan at position ``k`` (a barrier where the
    plan has another op) disables it; a receive left pre-posted is consumed
    by the next matching receive, and the rest runs direct."""
    runners = _install_both(fakes, "false_serialization.np3", 0)
    ops = _stream(runners["jax"].plan, 0)
    stream = ops[:k] + [("barrier", {})] + ops[k:]
    got = {w: _drive(w, runners[w], fakes[w], stream) for w in PKGS}
    _same(runners, fakes)
    assert got["port"] == got["jax"]
    assert runners["port"].stats["mismatches"] == 1
    assert not runners["port"].preposted
    if k == 1:  # the receive hoisted after the first send was left posted
        assert ("wait", 2) in fakes["port"].calls


def test_chain_plan_is_the_benchmarks(fakes):
    """The port's benchmark compiles the same chain as the JAX one."""
    events, comms = schedule_overlap._pipeline_schedule(3, 3, (128 * 1024,))
    port = p_plan.compile_schedules(events, comms)
    assert port.proved and port.rewritten
    assert port.cache_key == _chain_plan("jax").cache_key


def _refusal(which, case):
    planrt, _, plan_mod, _ = PKGS[which]
    plan = _plan_for(which, "false_serialization.np3")
    rank = 0
    if case == "no_rank":
        rank = 5
    elif case == "unproved":
        plan.proved = False
    elif case == "subcomm":
        plan.ranks[0].ops[0].comm = (0, 1)
    return planrt.install(HANDLE, plan, rank)


@pytest.mark.parametrize("case", ["no_rank", "unproved", "subcomm",
                                  "no_post"])
def test_install_refusals_match(fakes, capsys, case):
    out = {}
    for which in PKGS:
        fakes[which].posts = case != "no_post"
        ok = _refusal(which, case)
        out[which] = (ok, capsys.readouterr().err)
        assert PKGS[which][0]._runners == {}
        assert not PKGS[which][0].active()
    assert out["port"][0] is out["jax"][0] is False
    for which in PKGS:
        assert out[which][1].startswith("[plan] ")
    if case != "no_post":  # the last names each package's transport build
        assert out["port"][1] == out["jax"][1]


@pytest.mark.parametrize("spec", ["file", "bundle", "1", "0"])
def test_maybe_install_from_env_matches(fakes, monkeypatch, tmp_path, spec):
    plans = {w: _plan_for(w, "false_serialization.np3") for w in PKGS}
    if spec == "file":
        value = os.path.join(GOLDEN, "false_serialization.np3.plan.json")
    elif spec == "bundle":
        value = str(tmp_path / "bundle.json")
        p_plan.save_bundle({3: plans["port"],
                            2: _plan_for("port", "bucketed_dp_grad.np2")},
                           value)
    else:
        value = spec
    monkeypatch.setenv("MPI4JAX_TPU_PLAN", value)
    keys = {}
    for which in PKGS:
        planrt = PKGS[which][0]
        planrt.maybe_install_from_env(HANDLE, 1, 3)
        rt = planrt._runners.get(HANDLE)
        keys[which] = None if rt is None else (rt.plan.cache_key,
                                               len(rt.ops))
    assert keys["port"] == keys["jax"]
    assert (keys["port"] is not None) == (spec in ("file", "bundle"))


def _source_for(which, kind):
    planrt, _, plan_mod, ev_mod = PKGS[which]
    if kind == "source_plan":
        return lambda size: _plan_for(which, "bucketed_dp_grad.np2")
    if kind == "source_events":
        plan = _plan_for(which, "bucketed_dp_grad.np2")
        return lambda size: plan_mod.events_from_plan(plan)
    if kind == "source_none":
        return lambda size: None
    if kind == "tampered":
        def tampered(size):
            plan = _plan_for(which, "bucketed_dp_grad.np2")
            plan.cache_key = "0" * 32  # not the key of its schedule
            return plan
        return tampered
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["bundle", "source_plan", "source_events",
                                  "source_none", "tampered"])
def test_reinstall_after_rebuild_matches(fakes, monkeypatch, tmp_path,
                                         capsys, kind):
    if kind == "bundle":
        path = str(tmp_path / "bundle.json")
        p_plan.save_bundle({3: _plan_for("port", "false_serialization.np3"),
                            2: _plan_for("port", "bucketed_dp_grad.np2")},
                           path)
        monkeypatch.setenv("MPI4JAX_TPU_PLAN", path)
    out = {}
    for which in PKGS:
        planrt = PKGS[which][0]
        if kind != "bundle":
            planrt.set_plan_source(_source_for(which, kind))
        planrt._runners[99] = "the dead world's runner"
        ok = planrt.reinstall_after_rebuild(99, HANDLE, 1, 2)
        rt = planrt._runners.get(HANDLE)
        out[which] = (ok, 99 in planrt._runners,
                      None if rt is None else rt.plan.cache_key,
                      capsys.readouterr().err.splitlines()[:1])
    assert out["port"] == out["jax"]
    assert out["port"][0] is (kind in ("bundle", "source_plan",
                                       "source_events"))


def test_get_never_reads_the_handle_when_off(monkeypatch):
    monkeypatch.setattr(p_planrt, "_runners", {})
    monkeypatch.setattr(p_planrt, "_active", False)
    monkeypatch.setattr(p_planrt, "_spec_cache", False)
    monkeypatch.delenv("MPI4JAX_TPU_PLAN", raising=False)

    class Comm:
        @property
        def handle(self):
            raise AssertionError("the handle was read")

    assert p_planrt.get(Comm()) is None
    assert not p_planrt.active()


def test_bf16_recv_signature_names_the_tensor_dtype(fakes):
    """The analyzer records "bfloat16"; the runner matches on that name and
    posts the int16 view of the same bytes."""
    ev = p_events.CommEvent
    events = {0: [ev(0, 0, "send", dest=1, tag=3, dtype="bfloat16",
                     shape=(64 * 1024,)),
                  ev(0, 1, "recv", source=1, tag=4, dtype="bfloat16",
                     shape=(64 * 1024,))],
              1: [ev(1, 0, "send", dest=0, tag=4, dtype="bfloat16",
                     shape=(64 * 1024,)),
                  ev(1, 1, "recv", source=0, tag=3, dtype="bfloat16",
                     shape=(64 * 1024,))]}
    plan = p_plan.compile_schedules(events, {(0,): (0, 1)})
    assert plan.proved
    assert p_planrt.install(HANDLE, plan, 0)
    rt = p_planrt._runners[HANDLE]
    host = torch.zeros(64 * 1024, dtype=torch.bfloat16)
    assert rt.run_send(p_dtypes.host_view(host), 1, 3)
    out = rt.run_recv((64 * 1024,), torch.bfloat16, 1, 4)
    assert out is not None and out.dtype == torch.bfloat16
    assert rt.stats["mismatches"] == 0
    assert ("post_recv", 1, 4, 128 * 1024) in fakes["port"].calls \
        or ("recv", 1, 4, 128 * 1024) in fakes["port"].calls


def test_cpu_send_is_copied_and_an_owned_one_is_kept(fakes):
    runners = _install_both(fakes, "chain", 0)
    rt = runners["port"]
    caller = np.full(128 * 1024, 5.0, np.float32)
    assert rt.run_send(caller, 1, 0)                 # not owned: copied
    ticket, (ka, keep), pool_buf = rt.outstanding[-1]
    assert pool_buf is not None and pool_buf is not caller
    caller[:] = -1.0                                 # the caller writes on
    assert (pool_buf == 5.0).all()
    host = torch.full((128 * 1024,), 6.0)
    view = p_dtypes.host_view(host)
    assert rt.run_send(view, 1, 1, owned=True, keep=host)
    ticket, (ka, keep), pool_buf = rt.outstanding[-1]
    assert pool_buf is None and keep is host and ka[0] is view


def test_numpy_view_keeps_the_host_storage_alive():
    """The keepalive of an owned send holds the numpy view: its base is a
    tensor on the same storage, so the block outlives the caller's
    tensor."""
    t = torch.arange(1024, dtype=torch.float32)
    ptr = t.data_ptr()
    view = p_dtypes.host_view(t)
    assert isinstance(view.base, torch.Tensor)
    assert view.base.untyped_storage().data_ptr() == ptr
    del t
    gc.collect()
    assert (view == np.arange(1024, dtype=np.float32)).all()


def test_plans_golden_match_both_packages():
    for name in ("false_serialization.np3", "bucketed_dp_grad.np2"):
        with open(os.path.join(GOLDEN, f"{name}.plan.json")) as f:
            data = json.load(f)
        assert _plan_for("port", name).cache_key == data["cache_key"] \
            == _plan_for("jax", name).cache_key


def test_ticketed_posts_on_the_built_transport():
    """The port's posts on its own build of the transport, a comm of size
    1 sending to itself: a posted send, then a receive posted into a given
    array and one into a fresh array, each ticket waited once; the bytes
    arrive in post order."""
    from mpi4jax_tpu_torch.runtime import transport

    lib = p_bridge.get_lib()
    assert p_bridge.post_available()
    h = lib.tpucomm_init(0, 1, transport._free_port_block(1), b"")
    assert h > 0, "size-1 comm init failed"
    try:
        a = np.arange(4096, dtype=np.float32)
        b = np.arange(4096, dtype=np.float32) * -2.0
        t_a, ka_a = p_bridge.post_send(h, a, 0, 5)
        t_b, ka_b = p_bridge.post_send(h, b, 0, 6)
        into = np.zeros_like(a)
        t_into, ka_into = p_bridge.post_recv_into(h, into, 0, 5)
        t_new, fresh, ka_new = p_bridge.post_recv(h, b.shape, b.dtype, 0, 6)
        assert len({t_a, t_b, t_into, t_new}) == 4
        for t in (t_a, t_b, t_into, t_new):
            p_bridge.wait_ticket(h, t)
        assert np.array_equal(into, a) and np.array_equal(fresh, b)
        assert fresh.dtype == np.float32 and fresh.shape == b.shape
    finally:
        lib.tpucomm_finalize(h)
