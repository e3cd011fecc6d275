"""The port's observability package held to the JAX package's, on the CPU.

- A fixed event corpus, seeded with numpy, goes through both packages'
  ``percentile``, ``summarize``, ``render_table``, ``merge_parts`` and
  ``validate_chrome_trace``: the results must be equal (the same rows,
  rounding and trace events); ``bench_record`` and the knob stamp too.
- Part files and merged traces written by one package are read by the
  other (``load_part``, ``load_events``, ``part_paths``), and a part of a
  future version is refused by both.
- The span ring keeps the newest events with an exact drop count, in both
  packages' ``Recorder`` and through ``start``/``record_span``; the clock
  offset puts a two-rank sequence back in order in the merge.
- The native event ring of the port's own build of ``native/tpucomm.cc``
  (``runtime/bridge.py``), on a size-1 comm (no sockets): the JAX
  package's ``obs/_native.py`` takes the library as an argument, so its
  decoder reads the port's build beside the port's decoder.  A disabled
  ring writes nothing; the ring records send, recv and allreduce with
  their fields; overflow keeps the newest with exact drops; a partial drain
  counts what it did not deliver; disabling stops recording.  The JAX
  package's own native cases (``tests/test_obs.py``) cannot build its
  transport with gcc 12 and newer kernel headers (the io_uring probe
  struct); these run on the port's build.
- ``CallTrace`` writes the debug lines of the JAX format and a span.
- Both ``profile`` CLIs print the same report of the same recordings.
"""

import json

import numpy as np
import pytest

import mpi4jax_tpu.profile as jprofile
from mpi4jax_tpu import obs as jobs
from mpi4jax_tpu.obs import _native as jnative
from mpi4jax_tpu.obs import _recorder as jrec

from mpi4jax_tpu_torch import obs, profile
from mpi4jax_tpu_torch.obs import _native, _recorder
from mpi4jax_tpu_torch.utils import tracing


def _corpus(seed=7, n=240):
    """Canonical events from numpy: every op, src, algo and tier shape the
    recorder produces (quantized wire bytes, per-leg tiers, syscalls)."""
    rng = np.random.RandomState(seed)
    names = ["Allreduce", "Alltoall", "Send", "Recv", "Allgather",
             "Barrier"]
    algos = [None, "ring", "rd", "tree", "qring", "qalltoall", "halltoall",
             "hqalltoall", "hring"]
    out = []
    for i in range(n):
        ev = {"name": names[rng.randint(len(names))],
              "src": "native" if rng.rand() < 0.6 else "ops",
              "ts_us": float(1e6 + rng.rand() * 1e5),
              "dur_us": float(rng.gamma(2.0, 50.0)),
              "wait_us": 0.0, "dispatch_us": 0.0,
              "bytes": int(rng.choice([0, 64, 4096, 1 << 20])),
              "peer": int(rng.randint(-1, 4)), "tag": int(rng.randint(8)),
              "algo": algos[rng.randint(len(algos))]}
        ev["wait_us"] = float(ev["dur_us"] * rng.rand() * 0.5)
        ev["dispatch_us"] = float(ev["dur_us"] * rng.rand() * 0.2)
        if ev["algo"] in ("qring", "qalltoall") and ev["bytes"]:
            ev["wire_bytes"] = ev["bytes"] // 4 + 4
        if ev["algo"] == "hring" and rng.rand() < 0.5:
            ev["tier"] = ["intra", "inter", "ici"][rng.randint(3)]
        if ev["src"] == "native":
            ev["syscalls"] = int(rng.randint(1, 9))
        out.append(ev)
    return out


def test_percentile_matches_jax_and_numpy():
    rng = np.random.RandomState(3)
    corpus = list(rng.gamma(2.0, 50.0, size=211))
    for q in (0, 12.5, 50, 90, 95, 99, 99.9, 100):
        got = obs.percentile(corpus, q)
        assert got == jobs.percentile(corpus, q)
        assert got == pytest.approx(float(np.percentile(corpus, q)),
                                    abs=1e-9)
    assert obs.percentile([], 50) == jobs.percentile([], 50) == 0.0


def test_summarize_and_render_match_jax():
    events = _corpus()
    dropped = {"native": 3, "ops": 1}
    link = {"retries": 0, "reconnects": 2, "dup_dropped": 0,
            "crc_errors": 0, "replayed": 0, "heartbeats": 0}
    got = obs.summarize(events, dropped=dropped, rank=2, link=link)
    want = jobs.summarize(events, dropped=dropped, rank=2, link=link)
    assert got == want
    assert got["schema"] == obs.STATS_SCHEMA == jobs.STATS_SCHEMA
    assert {"tier_bytes", "self_healing"} <= set(got)
    assert obs.render_table(got) == jobs.render_table(want)
    assert "dropped on ring overflow" in obs.render_table(got)
    assert obs.render_table(obs.summarize([])) == "(no events recorded)"


def test_merge_and_validate_match_jax():
    events = _corpus()
    parts = [{"rank": r, "size": 3, "events": events[r::3],
              "dropped": {"native": r}, "generation": 0} for r in range(3)]
    got = obs.merge_parts(parts)
    assert got == jobs.merge_parts(parts)
    assert obs.validate_chrome_trace(got) == []
    assert jobs.validate_chrome_trace(got) == []
    assert got["otherData"]["schema"] == obs.TRACE_SCHEMA
    bad = [{"traceEvents": [{"ph": "X"}]}, [1, 2],
           {"traceEvents": [{"name": "x", "ph": "X", "pid": 0, "tid": 0,
                             "ts": 1.0, "dur": -4.0}]}]
    for trace in bad:
        assert obs.validate_chrome_trace(trace)
        assert obs.validate_chrome_trace(trace) == \
            jobs.validate_chrome_trace(trace)


def test_bench_record_and_knob_stamp_match_jax(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_COLL_QUANT", "force")
    monkeypatch.setenv("MPI4JAX_TPU_HIER", "deny")
    kw = dict(op="allreduce", nbytes=1 << 20, seconds=0.002, ranks=4,
              tier="world", algo="ring", reps=10)
    assert obs.bench_record(**kw) == jobs.bench_record(**kw)
    solo = dict(op="memcpy", nbytes=100, seconds=1.0)
    assert obs.bench_record(**solo) == jobs.bench_record(**solo)


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_parts_and_traces_cross_packages(tmp_path, writer, reader):
    w = obs if writer == "port" else jobs
    r = obs if reader == "port" else jobs
    events = _corpus(seed=11, n=60)
    base = str(tmp_path / "out.json")
    for rank in range(3):
        w.write_part(base, rank=rank, size=3, events=events[rank::3],
                     dropped={"native": rank, "ops": 0},
                     clock_offset_us=1.5 * rank, generation=0)
    paths = r.part_paths(base)
    assert paths == w.part_paths(base) and len(paths) == 3
    for rank, p in enumerate(paths):
        part = r.load_part(p)
        assert part["rank"] == rank and part["size"] == 3
        assert part["events"] == events[rank::3]
        assert r.load_events_meta(p) == w.load_events_meta(p)
    merged = w.merge_files(paths)
    with open(base, "w") as f:
        json.dump(merged, f)
    assert r.validate_chrome_trace(merged) == []
    evs, size = r.load_events(base)
    assert (evs, size) == w.load_events(base)
    assert size == 3 and len(evs) == len(events)


def test_future_part_version_is_refused(tmp_path):
    path = tmp_path / "future.rank0.json"
    path.write_text(json.dumps({"version": 99, "rank": 0, "size": 2,
                                "events": [], "dropped": {}}))
    for pkg in (obs, jobs):
        with pytest.raises(ValueError, match="version"):
            pkg.load_part(str(path))
        with pytest.raises(ValueError, match="version"):
            pkg.load_events(str(path))


@pytest.mark.parametrize("total", [7, 16, 41])
def test_ring_overflow_keeps_newest_with_exact_drops(total):
    for rec_cls in (obs.Recorder, jobs.Recorder):
        r = rec_cls(16)
        for i in range(total):
            r.append({"i": i})
        kept = [e["i"] for e in r.snapshot()]
        assert kept == list(range(max(0, total - 16), total))
        assert r.dropped == max(0, total - 16)


def test_span_ring_drop_accounting_matches_jax(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_TRACE_BUF_KB", "0.5")  # 16 slots
    assert _recorder.default_capacity_events() == \
        jrec.default_capacity_events() == 16
    got = {}
    for name, rec in (("port", _recorder), ("jax", jrec)):
        rec.start(lib=None, rank=1, size=2, clock_offset_s=0.25)
        for i in range(25):
            rec.record_span("Send", 1.0 + i * 1e-3, 1e-6, peer=0,
                            nbytes=64, tag=i)
        rec.record_span("Allreduce", 2.0, 1e-5, nbytes=4096, algo="hring",
                        tier="ici")
        got[name] = (rec.events(), rec.dropped(), rec.rank(),
                     rec.clock_offset_us())
        rec.stop()
    assert got["port"] == got["jax"]
    events, dropped, rank, off = got["port"]
    assert dropped == {"native": 0, "ops": 10} and len(events) == 16
    assert events[-1]["tier"] == "ici" and off == 0.25e6 and rank == 1


def test_clock_offset_merge_orders_two_rank_sequence():
    rec = _recorder
    rec.start(lib=None, rank=0, size=2, clock_offset_s=0.0)
    rec.record_span("Send", 1.000100, 10e-6, peer=1, nbytes=64, tag=7)
    rec.record_span("Barrier", 1.000300, 5e-6)
    part0 = {"rank": 0, "size": 2, "dropped": rec.dropped(),
             "events": rec.events()}
    rec.start(lib=None, rank=1, size=2, clock_offset_s=-0.005)
    rec.record_span("Recv", 1.005150, 10e-6, peer=0, nbytes=64, tag=7)
    rec.record_span("Barrier", 1.005320, 5e-6)
    part1 = {"rank": 1, "size": 2, "dropped": rec.dropped(),
             "events": rec.events()}
    rec.stop()
    merged = obs.merge_parts([part1, part0])
    assert merged == jobs.merge_parts([part1, part0])
    spans = [(e["name"], e["pid"]) for e in merged["traceEvents"]
             if e["ph"] == "X" and e.get("cat") != "phase"]
    assert spans == [("Send", 0), ("Recv", 1), ("Barrier", 0),
                     ("Barrier", 1)]


def test_call_trace_lines_and_span(capsys):
    _recorder.start(lib=None, rank=3, size=4)
    tracing.set_logging(True)
    try:
        with tracing.CallTrace(3, "Alltoall", lambda: "algo ring (forced)",
                               nbytes=512, algo="ring"):
            pass
    finally:
        tracing.set_logging(False)
        events = _recorder.events()
        _recorder.stop()
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2
    first, second = (line.split(" | ") for line in err)
    assert first[0] == second[0] == "r3" and first[1] == second[1]
    assert len(first[1]) == 8
    assert first[2] == "Alltoall algo ring (forced)"
    assert second[2].startswith("Alltoall done with code 0 (")
    assert second[2].endswith(" s)")
    assert [e["name"] for e in events] == ["Alltoall"]
    assert events[0]["bytes"] == 512 and events[0]["src"] == "ops"
    # disabled: no line, no span
    with tracing.CallTrace(3, "Barrier", ""):
        pass
    assert capsys.readouterr().err == ""


def test_profile_clis_print_the_same(tmp_path, capsys):
    events = _corpus(seed=5, n=90)
    base = str(tmp_path / "out.json")
    for rank in range(3):
        obs.write_part(base, rank=rank, size=3, events=events[rank::3],
                       dropped={"native": rank, "ops": 0})
    parts = obs.part_paths(base)
    outs = {}
    for name, cli in (("port", profile), ("jax", jprofile)):
        merged = str(tmp_path / f"merged_{name}.json")
        assert cli.main(["merge", "--out", merged, *parts]) == 0
        capsys.readouterr()
        assert cli.main(["report", *parts]) == 0
        table = capsys.readouterr().out
        assert cli.main(["report", merged, "--json"]) == 0
        outs[name] = (table, capsys.readouterr().out,
                      json.load(open(merged)))
        assert cli.main(["report", str(tmp_path / "missing.json")]) == 2
    assert outs["port"] == outs["jax"]
    assert "3 dropped" in outs["port"][0]


# ---------------- the native ring of the port's build ----------------


@pytest.fixture(scope="module")
def native():
    """The port's transport, a size-1 comm (self-delivery, no sockets)."""
    from mpi4jax_tpu_torch.runtime import bridge, transport

    lib = bridge.get_lib()
    h = lib.tpucomm_init(0, 1, transport._free_port_block(1), b"")
    assert h > 0, "size-1 comm init failed"
    assert _native.available(lib) and jnative.available(lib)
    yield lib, h
    _native.disable(lib)
    lib.tpucomm_finalize(h)


def _self_send_recv(lib, h, tag):
    buf = np.arange(8.0)
    out = np.empty_like(buf)
    assert lib.tpucomm_send(h, buf.ctypes.data, buf.nbytes, 0, tag) == 0
    assert lib.tpucomm_recv(h, out.ctypes.data, out.nbytes, 0, tag) == 0
    np.testing.assert_array_equal(out, buf)


def _allreduce_f64(lib, h):
    buf = np.arange(8.0)
    out = np.empty_like(buf)
    assert lib.tpucomm_allreduce_algo(h, buf.ctypes.data, out.ctypes.data,
                                      8, 12, 0, 0) == 0


def test_native_disabled_ring_writes_nothing(native):
    lib, h = native
    _native.disable(lib)
    for tag in range(20, 25):
        _self_send_recv(lib, h, tag)
    _allreduce_f64(lib, h)
    assert _native.counts(lib) == (0, 0) == jnative.counts(lib)
    assert _native.drain(lib) == []


def test_native_ring_both_decoders_agree(native):
    lib, h = native
    _native.enable(lib, 64)
    _self_send_recv(lib, h, 42)
    _allreduce_f64(lib, h)
    peeked, cursor, skipped = jnative.peek(lib, 0)  # non-destructive
    assert (cursor, skipped) == (3, 0)
    events = _native.drain(lib)
    _native.disable(lib)
    assert events == peeked
    assert [e["name"] for e in events] == ["Send", "Recv", "Allreduce"]
    send = events[0]
    assert send["peer"] == 0 and send["tag"] == 42 and send["bytes"] == 64
    assert 0 <= send["wait_s"] <= send["dur_s"]
    assert "syscalls" in send  # the build carries tpucomm_uring_status
    assert events[2]["bytes"] == 64 and events[2]["peer"] == -1
    assert events[2]["algo"] in _native.ALGO_NAMES.values()
    assert all(e["t"] <= n["t"] for e, n in zip(events, events[1:]))
    assert _native.link_counters(lib) == jnative.link_counters(lib)
    assert _native.EVENT_BYTES == jnative.EVENT_BYTES == 80


def test_native_overflow_keeps_newest_exact_drops(native):
    lib, h = native
    _native.enable(lib, 16)
    total = 30  # 15 send+recv pairs
    for i in range(total // 2):
        _self_send_recv(lib, h, 1000 + i)
    assert _native.counts(lib) == (16, total - 16)
    events = jnative.drain(lib)
    assert [e["tag"] for e in events] == [1000 + (total - 16 + i) // 2
                                          for i in range(16)]
    assert _native.counts(lib) == (0, total - 16)
    _native.disable(lib)


def test_native_partial_drain_counts_undelivered(native):
    lib, h = native
    _native.enable(lib, 32)
    for i in range(5):
        _self_send_recv(lib, h, 300 + i)
    buf = (_native.TpuObsEvent * 4)()
    assert lib.tpucomm_obs_drain(buf, 4) == 4
    assert [buf[i].tag for i in range(4)] == [303, 303, 304, 304]
    assert _native.counts(lib) == (0, 6)
    _native.disable(lib)


def test_native_disable_after_enable_stops_recording(native):
    lib, h = native
    _native.enable(lib, 16)
    _self_send_recv(lib, h, 7)
    _native.disable(lib)
    _self_send_recv(lib, h, 8)
    assert _native.counts(lib) == (0, 0)


def test_recorder_on_the_native_ring_matches_jax(native):
    """The two recorders over the same library: the port's canonicalizes
    the native events exactly as JAX's does."""
    lib, h = native
    got = {}
    for name, rec in (("port", _recorder), ("jax", jrec)):
        rec.start(lib=lib, rank=0, size=1, capacity_events=64)
        _self_send_recv(lib, h, 9)
        events = rec.events()
        got[name] = [{k: v for k, v in e.items()
                      if k not in ("ts_us", "dur_us", "wait_us",
                                   "dispatch_us")} for e in events]
        assert all(e["src"] == "native" for e in events)
        rec.stop()
    assert got["port"] == got["jax"]
    assert [e["name"] for e in got["port"]] == ["Send", "Recv"]
