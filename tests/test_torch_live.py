"""The port's live re-tuning (``live/``) against the JAX package's.

Twins of ``tests/test_live.py``: the JAX modules load under an alias
package (no JAX import), and each case runs the same inputs through both
packages: the ``MPI4JAX_TPU_LIVE*`` knob parsers (the same values and
errors), the drift detector on the same event streams (the same flags),
the epoch rendezvous on a pair of fake bridges in lockstep (the same
headers, epochs, commits, boundaries, reentrancy, superseding and loud
commit failure), the controller's candidate table from the same baseline
model, and ``consume_retune``.  The three peek-cursor tests run on the
port's own build of the transport, on a comm of size 1.
"""

import importlib
import json
import os
import sys
import types

import numpy as np
import pytest

from mpi4jax_tpu_torch import live as p_live
from mpi4jax_tpu_torch import tune as p_tune
from mpi4jax_tpu_torch.live import _controller as p_controller
from mpi4jax_tpu_torch.live import _drift as p_drift
from mpi4jax_tpu_torch.live import _swap as p_swap
from mpi4jax_tpu_torch.obs import _native as p_obs_native
from mpi4jax_tpu_torch.tune import _model as p_model
from mpi4jax_tpu_torch.utils import config as p_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ALIAS = "m4j_lv"
if _ALIAS not in sys.modules:
    _pkg = types.ModuleType(_ALIAS)
    _pkg.__path__ = [os.path.join(REPO, "mpi4jax_tpu")]
    sys.modules[_ALIAS] = _pkg
J = types.SimpleNamespace(
    live=importlib.import_module(_ALIAS + ".live"),
    tune=importlib.import_module(_ALIAS + ".tune"),
    controller=importlib.import_module(_ALIAS + ".live._controller"),
    drift=importlib.import_module(_ALIAS + ".live._drift"),
    swap=importlib.import_module(_ALIAS + ".live._swap"),
    config=importlib.import_module(_ALIAS + ".utils.config"),
    model=importlib.import_module(_ALIAS + ".tune._model"))
P = types.SimpleNamespace(live=p_live, tune=p_tune, controller=p_controller,
                          drift=p_drift, swap=p_swap, config=p_config,
                          model=p_model)
BOTH = {"jax": J, "port": P}


def _ev(op="Allreduce", nbytes=262144, dur_s=1e-4, algo="ring"):
    return {"name": op, "src": "native", "ts_us": 0.0,
            "dur_us": dur_s * 1e6, "wait_us": 0.0, "dispatch_us": 0.0,
            "bytes": int(nbytes), "peer": -1, "tag": 0, "algo": algo}


def _baseline_model(pkg, extra=()):
    """ring predicted fast, rd a known modest alternative."""
    m = pkg.model.CostModel(world_size=2, source="test")
    m.add_sample("allreduce", "ring", 1024, 1e-6)
    m.add_sample("allreduce", "ring", 262144, 1e-5)
    m.add_sample("allreduce", "rd", 1024, 5e-6)
    m.add_sample("allreduce", "rd", 262144, 1e-4)
    for args in extra:
        m.add_sample(*args)
    return m


# ---------------- knobs ----------------

KNOBS = ("MPI4JAX_TPU_LIVE", "MPI4JAX_TPU_LIVE_WINDOW",
         "MPI4JAX_TPU_LIVE_DRIFT_PCT", "MPI4JAX_TPU_LIVE_COOLDOWN_OPS")


def test_live_knob_defaults_match(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    got = {w: (p.config.live_mode(), p.config.live_window(),
               p.config.live_drift_pct(), p.config.live_cooldown_ops())
           for w, p in BOTH.items()}
    assert got["port"] == got["jax"] == ("off", 256, 30.0, 64)


def _parse(pkg, fn, name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    try:
        return ("ok", getattr(pkg.config, fn)())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("fn,name,value", [
    ("live_mode", "MPI4JAX_TPU_LIVE", "auto"),
    ("live_mode", "MPI4JAX_TPU_LIVE", " off "),
    ("live_mode", "MPI4JAX_TPU_LIVE", "yes"),
    ("live_window", "MPI4JAX_TPU_LIVE_WINDOW", "512"),
    ("live_window", "MPI4JAX_TPU_LIVE_WINDOW", "0"),
    ("live_drift_pct", "MPI4JAX_TPU_LIVE_DRIFT_PCT", "12.5"),
    ("live_drift_pct", "MPI4JAX_TPU_LIVE_DRIFT_PCT", "-3"),
    ("live_drift_pct", "MPI4JAX_TPU_LIVE_DRIFT_PCT", "lots"),
    ("live_cooldown_ops", "MPI4JAX_TPU_LIVE_COOLDOWN_OPS", "many"),
    ("live_cooldown_ops", "MPI4JAX_TPU_LIVE_COOLDOWN_OPS", "8"),
])
def test_live_knob_parsers_match(monkeypatch, fn, name, value):
    got = {w: _parse(p, fn, name, value, monkeypatch)
           for w, p in BOTH.items()}
    assert got["port"] == got["jax"]
    if got["port"][0] == "error":
        assert name in got["port"][1]


# ---------------- drift detector ----------------


def _flags(pkg, phases, min_samples=6, with_model=True):
    """The detector's findings after each phase of events."""
    det = pkg.drift.DriftDetector(
        _baseline_model(pkg) if with_model else None, drift_pct=30.0,
        min_samples=min_samples)
    out = []
    for phase in phases:
        if phase == "set_model":
            det.set_model(_baseline_model(pkg))
            continue
        det.observe(phase)
        out.append([d.as_dict() for d in det.drifts()])
    out.append((det.events_seen, det.events_used))
    return out


def _filtered():
    shm, tiered, span, unseen = (_ev(dur_s=1.0) for _ in range(4))
    shm["algo"] = "shm"
    tiered["tier"] = "intra"
    span["src"] = "ops"
    unseen["algo"] = None
    return [shm, tiered, span, unseen] * 4


SLOW = [_ev(dur_s=8e-5) for _ in range(8)]
NORMAL = [_ev(dur_s=1e-5) for _ in range(8)]
FAST = [_ev(dur_s=1e-6) for _ in range(8)]
STREAMS = {
    "contention": ([SLOW, SLOW], {}),
    "transient": ([SLOW, NORMAL, SLOW, SLOW], {}),
    "quiescent": ([[_ev(dur_s=1.1e-5) for _ in range(50)],
                   [_ev(nbytes=1024, dur_s=0.9e-6) for _ in range(50)]], {}),
    "faster": ([FAST, FAST], {}),
    "needs_model": ([[_ev(dur_s=1.0)] * 8, "set_model",
                     [_ev(dur_s=1.0)] * 8], {"with_model": False}),
    "filter": ([_filtered()], {"min_samples": 2}),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_detector_flags_match(stream):
    phases, kw = STREAMS[stream]
    got = {w: _flags(p, phases, **kw) for w, p in BOTH.items()}
    assert got["port"] == got["jax"]
    if stream == "contention":
        assert got["port"][0] == [] and len(got["port"][1]) == 1
    if stream == "quiescent":
        assert got["port"][:2] == [[], []]


# ---------------- swap protocol (fake bridge) ----------------


class FakeBridge:
    """Two lockstep instances sharing ``channel`` emulate a 2-rank bcast:
    rank 0 appends its buffer, rank 1 reads in order."""

    def __init__(self, rank, channel):
        self.rank = rank
        self.channel = channel
        self._read = 0
        self.staged = []
        self.commits = []
        self.proto = None
        self.stage_ok = True

    def coll_epoch(self):
        return self.commits[-1][1] if self.commits else 0

    def bcast(self, handle, buf, root):
        # a real bcast re-enters the boundary hook; emulate that
        if self.proto is not None:
            self.proto.on_boundary(handle)
        if self.rank == 0:
            self.channel.append(np.array(buf, copy=True))
            return buf
        out = self.channel[self._read]
        self._read += 1
        return out

    def stage_coll_table(self, coded):
        if not self.stage_ok:
            return False
        self.staged.append(coded)
        return True

    def commit_coll_tables(self, handle, epoch):
        self.commits.append((int(handle), int(epoch)))
        return True


def _pair(pkg, period):
    chan = []
    b0, b1 = FakeBridge(0, chan), FakeBridge(1, chan)
    p0 = pkg.swap.SwapProtocol(b0, 7, 0, 2, period)
    p1 = pkg.swap.SwapProtocol(b1, 7, 1, 2, period)
    b0.proto, b1.proto = p0, p1
    return (b0, p0), (b1, p1)


def _drive(p0, p1, n, handle=7):
    for _ in range(n):
        p0.on_boundary(handle)
        p1.on_boundary(handle)


PAYLOAD = {"tables": {"0": [[0, 2]]}, "named": {"allreduce": [[0, "rd"]]},
           "report": {"changes": ["allreduce@0: ring -> rd"],
                      "note": "test"}}


def _scenario(pkg, name):
    """Run one protocol scenario; returns what both ranks saw."""
    period = {"steady": 4, "commit": 4, "reentry": 2, "off_comm": 4,
              "supersede": 4, "stage_fails": 2}[name]
    (b0, p0), (b1, p1) = _pair(pkg, period)
    eps = []
    err = None
    try:
        if name == "steady":
            _drive(p0, p1, 20)
        elif name == "commit":
            _drive(p0, p1, 2)
            eps.append(p0.propose(json.loads(json.dumps(PAYLOAD))))
            _drive(p0, p1, 2)
            eps.append(p0.pending())
            _drive(p0, p1, 3)
            eps.append(p0.boundaries_since_swap())
        elif name == "reentry":
            eps.append(p0.propose({"tables": {"0": [[0, 3]]}, "named": {},
                                   "report": {}}))
            _drive(p0, p1, 10)
        elif name == "off_comm":
            for _ in range(9):
                p0.on_boundary(12345)
        elif name == "supersede":
            eps.append(p0.propose({"tables": {"0": [[0, 2]]}, "named": {},
                                   "report": {}}))
            eps.append(p0.propose({"tables": {"0": [[0, 3]]}, "named": {},
                                   "report": {}}))
            _drive(p0, p1, 4)
        elif name == "stage_fails":
            b1.stage_ok = False
            p0.propose({"tables": {"0": [[0, 2]]}, "named": {},
                        "report": {}})
            _drive(p0, p1, 2)
    except RuntimeError as e:
        err = str(e)
    return {"headers": [(c.dtype.str, c.tolist()) for c in b0.channel],
            "epochs": (p0.epoch, p1.epoch),
            "boundaries": (p0.boundaries, p1.boundaries),
            "staged": (b0.staged, b1.staged),
            "commits": (b0.commits, b1.commits),
            "swaps": ([s["boundary"] for s in p0.swaps],
                      [s["boundary"] for s in p1.swaps]),
            "returns": eps, "error": err}


@pytest.mark.parametrize("name", ["steady", "commit", "reentry", "off_comm",
                                  "supersede", "stage_fails"])
def test_swap_protocol_matches(capsys, name):
    got = {w: _scenario(p, name) for w, p in BOTH.items()}
    logs = capsys.readouterr().err
    assert got["port"] == got["jax"]
    port = got["port"]
    if name == "steady":
        assert len(port["headers"]) == 5 and port["epochs"] == (0, 0)
        assert all(h[1][1] == 0 for h in port["headers"])
    if name == "commit":
        assert port["epochs"] == (1, 1) and port["swaps"] == ([4], [4])
        assert port["commits"] == ([(7, 1)], [(7, 1)])
        assert logs.count("[live] epoch 1 committed at boundary 4") == 2
    if name == "reentry":
        assert port["boundaries"] == (10, 10) and port["epochs"] == (1, 1)
    if name == "off_comm":
        assert port["boundaries"] == (0, 0) and port["headers"] == []
    if name == "supersede":
        assert port["epochs"] == (2, 2)
        assert port["staged"][1] == [{0: [(0, 3)]}]
    if name == "stage_fails":
        assert "stage_coll_table" in port["error"]


# ---------------- controller candidate build ----------------


class FakeSwap:
    def __init__(self):
        self.proposed = []
        self.epoch = 0

    def pending(self):
        return False

    def boundaries_since_swap(self):
        return 10**9

    def propose(self, payload):
        self.proposed.append(payload)
        self.epoch += 1
        return self.epoch


def _candidate(pkg, tmp_path, monkeypatch, extra=(), quant=None):
    mp = tmp_path / f"model_{pkg is P}.json"
    mp.write_text(json.dumps(_baseline_model(pkg, extra).to_json()))
    monkeypatch.setenv("MPI4JAX_TPU_TUNE_MODEL", str(mp))
    if quant:
        monkeypatch.setenv("MPI4JAX_TPU_COLL_QUANT", quant)
    ctrl = pkg.controller.Controller(
        None, 7, 0, 2, FakeSwap(), window=64, drift_pct=30.0,
        cooldown_ops=8)
    slow = [_ev(dur_s=5e-4) for _ in range(10)]
    steps = []
    for _ in range(2):
        ctrl._events.extend(slow)
        ctrl._detector.observe(slow)
        steps.append([d.as_dict() for d in ctrl._detector.drifts()])
    drifts = [d.as_dict() for d in ctrl._detector.drifts()]
    tables, changes = ctrl._candidate(
        [pkg.drift.Drift(**d) for d in steps[-1]])
    payload = ctrl._payload(tables, changes)
    ctrl.note_commit({"named": payload["named"]})
    ctrl._events.extend(slow)
    ctrl._detector.observe(slow)
    again, _ = ctrl._candidate(
        [pkg.drift.Drift(**d) for d in steps[-1]])
    return {"baseline": ctrl.status()["baseline"].split(":")[0],
            "steps": steps, "drifts_after": drifts, "tables": tables,
            "changes": changes, "payload": payload, "again": again}


@pytest.mark.parametrize("case", ["overlay", "quant_deny"])
def test_controller_candidate_matches(tmp_path, monkeypatch, case):
    kw = {} if case == "overlay" else {
        "extra": [("allreduce", "qring", 262144, 1e-7)], "quant": "deny"}
    got = {w: _candidate(p, tmp_path, monkeypatch, **kw)
           for w, p in BOTH.items()}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["baseline"] == "model-file"
    assert port["steps"][0] == [] and port["steps"][1]
    assert p_controller._lookup(port["tables"]["allreduce"], 262144) == "rd"
    assert "allreduce" not in port["again"]


def test_consume_retune_matches():
    for pkg in BOTH.values():
        sched = types.SimpleNamespace(retune_requested=True)
        before = pkg.live.status()["retune_requests"]
        assert pkg.live.consume_retune(sched) is True
        assert sched.retune_requested is False
        assert pkg.live.status()["retune_requests"] == before + 1
        assert pkg.live.consume_retune(sched) is False
        assert pkg.live.status() == {"armed": False,
                                     "retune_requests": before + 1}


def test_propose_needs_an_armed_controller():
    for pkg in BOTH.values():
        with pytest.raises(RuntimeError, match="armed controller"):
            pkg.live.propose({"allreduce": [(0, "rd")]})


# ---------------- native ring: the two-consumer contract ----------------


@pytest.fixture(scope="module")
def native_lib():
    from mpi4jax_tpu_torch.runtime import bridge, transport

    lib = bridge.get_lib()
    h = lib.tpucomm_init(0, 1, transport._free_port_block(1), b"")
    assert h > 0, "size-1 comm init failed"
    yield lib, h
    lib.tpucomm_finalize(h)


def _self_send_recv(lib, h, tag):
    buf = np.arange(8.0)
    out = np.empty_like(buf)
    assert lib.tpucomm_send(h, buf.ctypes.data, buf.nbytes, 0, tag) == 0
    assert lib.tpucomm_recv(h, out.ctypes.data, out.nbytes, 0, tag) == 0


def test_peek_consumer_leaves_drain_byte_complete(native_lib):
    lib, h = native_lib
    assert p_obs_native.peek_available(lib)
    p_obs_native.enable(lib, 64)
    cursor, peeked = 0, []
    for tag in range(70, 75):
        _self_send_recv(lib, h, tag)
        got, cursor, skipped = p_obs_native.peek(lib, cursor)
        assert skipped == 0
        peeked.extend(got)
    drained = p_obs_native.drain(lib)
    p_obs_native.disable(lib)
    assert len(peeked) == len(drained) == 10
    assert [(e["name"], e["tag"]) for e in peeked] \
        == [(e["name"], e["tag"]) for e in drained]


def test_peek_cursor_survives_destructive_drain(native_lib):
    lib, h = native_lib
    p_obs_native.enable(lib, 64)
    _self_send_recv(lib, h, 80)
    _self_send_recv(lib, h, 81)
    got, cursor, skipped = p_obs_native.peek(lib, 0)
    assert len(got) == 4 and cursor == 4 and skipped == 0
    assert len(p_obs_native.drain(lib)) == 4
    _self_send_recv(lib, h, 82)
    got, cursor, skipped = p_obs_native.peek(lib, cursor)
    p_obs_native.disable(lib)
    assert [e["tag"] for e in got] == [82, 82]
    assert cursor == 6 and skipped == 0


def test_peek_reports_overflow_as_skipped(native_lib):
    lib, h = native_lib
    p_obs_native.enable(lib, 16)
    for tag in range(90, 110):                    # 40 events, cap 16
        _self_send_recv(lib, h, tag)
    got, cursor, skipped = p_obs_native.peek(lib, 0, max_events=64)
    p_obs_native.disable(lib)
    assert len(got) == 16 and skipped == 24 and cursor == 40
    assert [e["tag"] for e in got] == \
        [tag for tag in range(102, 110) for _ in (0, 1)]


def test_bridge_epoch_entries_on_the_built_transport(native_lib):
    """The port's bindings of the live entries: a staged table commits
    under a new epoch, and the engine's pick follows it."""
    from mpi4jax_tpu_torch.runtime import bridge

    lib, h = native_lib
    assert bridge.post_available()
    e0 = bridge.coll_epoch()
    assert bridge.stage_coll_table({0: [(0, p_tune.ALGO_CODES["rd"])]})
    assert bridge.commit_coll_tables(h, e0 + 1)
    assert bridge.coll_epoch() == e0 + 1
    p_tune.install(1)  # put the process's table back
