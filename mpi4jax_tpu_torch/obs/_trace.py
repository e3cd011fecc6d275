"""Chrome-trace-event export and the cross-rank merge.

A copy of ``mpi4jax_tpu/obs/_trace.py``, field for field, so that a trace
merged by either package is the same file.  Pure stdlib.  Output is the
Trace Event Format's JSON-object form (``{"traceEvents": [...]}``) with
complete ("X") events, which Perfetto and chrome://tracing load:

- ``pid`` = rank (with a ``process_name`` metadata event per rank),
- ``tid`` 0 = the native transport, ``tid`` 1 = the ops layer,
- every op span carries ``args`` with bytes / peer / tag / algorithm /
  the exact ``wait_us`` and ``dispatch_us``,
- each native span gets nested child slices ``dispatch``, ``wait`` and
  ``wire`` (drawn as the span's prefix; ``args`` hold the exact values).

Timestamps are microseconds on the job-global aligned timeline: each
rank's dump already applied its clock offset (``runtime/bridge.py``'s
handshake), so the merge is a concatenation plus metadata.
"""


from __future__ import annotations

TRACE_SCHEMA = "mpi4jax_tpu.obs.trace/1"

_TID_NAMES = {0: "transport (native)", 1: "ops layer (python)"}


def rank_trace_events(events, rank: int):
    """Chrome 'X' events (plus thread metadata) for one rank's canonical
    event list."""
    out = []
    for tid, name in _TID_NAMES.items():
        out.append({"name": "thread_name", "ph": "M", "pid": int(rank),
                    "tid": tid, "args": {"name": name}})
    out.append({"name": "process_name", "ph": "M", "pid": int(rank),
                "tid": 0, "args": {"name": f"rank {rank}"}})
    for ev in events:
        tid = 0 if ev.get("src") == "native" else 1
        ts = float(ev["ts_us"])
        dur = max(float(ev.get("dur_us", 0.0)), 0.001)
        args = {
            "bytes": int(ev.get("bytes", 0)),
            "peer": int(ev.get("peer", -1)),
            "tag": int(ev.get("tag", 0)),
            "wait_us": round(float(ev.get("wait_us", 0.0)), 3),
            "dispatch_us": round(float(ev.get("dispatch_us", 0.0)), 3),
        }
        if ev.get("algo"):
            args["algo"] = ev["algo"]
        if ev.get("tier"):
            args["tier"] = ev["tier"]  # hierarchical leg: intra / inter
        if ev.get("phase"):
            args["phase"] = ev["phase"]  # serving: prefill/decode/kv_xfer
        if "syscalls" in ev:
            # transport syscalls of this op (uring-generation events):
            # the submit-batching win, visible per span in Perfetto
            args["syscalls"] = int(ev["syscalls"])
        wb = int(ev.get("wire_bytes", ev.get("bytes", 0)))
        if wb != args["bytes"]:
            args["wire_bytes"] = wb  # quantized: compressed payload
        out.append({"name": ev.get("name", "?"), "cat": ev.get("src", "?"),
                    "ph": "X", "pid": int(rank), "tid": tid,
                    "ts": round(ts, 3), "dur": round(dur, 3), "args": args})
        wait = float(ev.get("wait_us", 0.0))
        disp = float(ev.get("dispatch_us", 0.0))
        if tid == 0 and (wait > 0.0 or disp > 0.0):
            # nested child slices: dispatch prefix (submission-queue
            # delay), then wait, then the wire phase
            disp = min(max(disp, 0.0), dur)
            wait = min(max(wait, 0.0), dur - disp)
            off = 0.0
            if disp > 0.0:
                out.append({"name": "dispatch", "cat": "phase", "ph": "X",
                            "pid": int(rank), "tid": tid, "ts": round(ts, 3),
                            "dur": round(disp, 3), "args": {}})
                off += disp
            if wait > 0.0:
                out.append({"name": "wait", "cat": "phase", "ph": "X",
                            "pid": int(rank), "tid": tid,
                            "ts": round(ts + off, 3),
                            "dur": round(wait, 3), "args": {}})
                off += wait
            if dur - off > 0.0:
                out.append({"name": "wire", "cat": "phase", "ph": "X",
                            "pid": int(rank), "tid": tid,
                            "ts": round(ts + off, 3),
                            "dur": round(dur - off, 3), "args": {}})
    return out


def merge_parts(parts) -> dict:
    """One Perfetto-loadable trace from per-rank part dicts (the files
    ranks dump at finalize — see ``_dump.py``).  Parts may arrive in any
    order; events are globally time-sorted."""
    trace_events = []
    world_size = 0
    dropped = {}
    generations = {}
    for part in parts:
        rank = int(part.get("rank", 0))
        world_size = max(world_size, int(part.get("size", rank + 1)))
        # elastic worlds: each part says which generation its rank
        # ended in; a merged timeline spanning a recovery shows it here
        generations[f"rank{rank}"] = int(part.get("generation", 0))
        for src, n in (part.get("dropped") or {}).items():
            dropped[f"rank{rank}.{src}"] = int(n)
        trace_events.extend(rank_trace_events(part.get("events", ()), rank))
    meta = [e for e in trace_events if e.get("ph") == "M"]
    spans = sorted((e for e in trace_events if e.get("ph") != "M"),
                   key=lambda e: (e.get("ts", 0.0), e.get("pid", 0)))
    other = {
        "schema": TRACE_SCHEMA,
        "tool": "mpi4jax_tpu.obs",
        "world_size": world_size,
        "dropped": dropped,
    }
    if any(generations.values()):
        other["generations"] = generations
    return {
        "traceEvents": meta + spans,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def validate_chrome_trace(trace) -> list:
    """Errors (empty = valid) against the Chrome trace-event JSON-object
    schema subset this exporter emits; used by the diag ``observability``
    check and the tests."""
    errors = []
    if not isinstance(trace, dict):
        return ["top level must be a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"{where}: missing name")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "M", "i", "C"):
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("pid"), int):
            errors.append(f"{where}: pid must be an int")
        if ph == "X":
            for field in ("ts", "dur"):
                v = ev.get(field)
                if not isinstance(v, (int, float)):
                    errors.append(f"{where}: {field} must be a number")
            if isinstance(ev.get("dur"), (int, float)) and ev["dur"] < 0:
                errors.append(f"{where}: negative dur")
    return errors
