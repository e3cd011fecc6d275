"""Recording dump files: what a rank writes at exit, what the launcher
and the profile CLI read back.

A copy of ``mpi4jax_tpu/obs/_dump.py``: the same part-file format and
version, so each package reads the other's recordings.  Pure stdlib.  A
*part* file (``<base>.rank<r>.json``) is one rank's recording, metadata
plus the canonical event list with timestamps on the aligned job
timeline.  The merged artifact is the Chrome trace
(``_trace.merge_parts``); both carry enough per-event detail for
``python -m mpi4jax_tpu_torch.tune --from-trace`` to derive the algorithm
cache from a real run.
"""


from __future__ import annotations

import glob
import json
import os

PART_VERSION = 1


def part_path(base: str, rank: int) -> str:
    return f"{base}.rank{int(rank)}.json"


def part_paths(base: str):
    """Every rank part written for ``base``, rank order."""
    found = glob.glob(f"{glob.escape(base)}.rank*.json")

    def _rank(p):
        tail = p[len(base):]
        digits = "".join(ch for ch in tail if ch.isdigit())
        return int(digits or 0)

    return sorted(found, key=_rank)


def write_part(base: str, *, rank: int, size: int, events,
               dropped=None, clock_offset_us=0.0, generation=0) -> str:
    """Atomically write one rank's recording; returns the path.

    ``generation`` is the elastic world generation the recording
    belongs to (0 = the original world) — an additive field, so
    pre-elastic readers and parts are unaffected."""
    path = part_path(base, rank)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "version": PART_VERSION,
        "rank": int(rank),
        "size": int(size),
        "generation": int(generation),
        "clock_offset_us": float(clock_offset_us),
        "dropped": dict(dropped or {}),
        "events": list(events),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def load_part(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "events" not in data:
        raise ValueError(f"{path} is not an obs recording part")
    if int(data.get("version", -1)) != PART_VERSION:
        raise ValueError(
            f"{path} has recording version {data.get('version')!r}, "
            f"expected {PART_VERSION}")
    return data


def load_events(path: str):
    """(events, world_size) from EITHER a part file or a merged Chrome
    trace — the tuner's ``--from-trace`` accepts both.  Chrome spans are
    mapped back to canonical events (metadata and phase slices are
    skipped)."""
    events, size, _gens = load_events_meta(path)
    return events, size


def load_events_meta(path: str):
    """(events, world_size, generations) — like :func:`load_events`
    plus the set of elastic world generations the file's recording
    belongs to: a part file carries exactly one; a merged Chrome trace
    reports every per-rank generation it merged (``otherData.
    generations``).  Pre-elastic files report ``{0}``.  The tuner's
    ``--from-trace`` uses this to keep pre- and post-shrink timings
    from pooling into one median."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "events" in data and "version" in data:
        # a part file: the version gate applies here too — silently
        # reading a future format with v1 semantics would render a
        # wrong table instead of the intended loud error
        if int(data.get("version", -1)) != PART_VERSION:
            raise ValueError(
                f"{path} has recording version {data.get('version')!r}, "
                f"expected {PART_VERSION}")
        return (list(data["events"]), int(data.get("size", 1)),
                {int(data.get("generation", 0))})
    if isinstance(data, dict) and "traceEvents" in data:
        events = []
        for ev in data["traceEvents"]:
            if ev.get("ph") != "X" or ev.get("cat") == "phase":
                continue
            args = ev.get("args") or {}
            evd = {
                "name": ev.get("name", "?"),
                "src": "native" if ev.get("tid") == 0 else "ops",
                "ts_us": float(ev.get("ts", 0.0)),
                "dur_us": float(ev.get("dur", 0.0)),
                "wait_us": float(args.get("wait_us", 0.0)),
                "bytes": int(args.get("bytes", 0)),
                "peer": int(args.get("peer", -1)),
                "tag": int(args.get("tag", 0)),
                "algo": args.get("algo"),
            }
            if "wire_bytes" in args:
                evd["wire_bytes"] = int(args["wire_bytes"])
            if args.get("tier"):
                evd["tier"] = args["tier"]  # hierarchical leg label
            if args.get("phase"):
                evd["phase"] = args["phase"]  # serving phase label
            events.append(evd)
        other = data.get("otherData") or {}
        gens = {int(g) for g in (other.get("generations") or {}).values()}
        return events, int(other.get("world_size", 1)), (gens or {0})
    raise ValueError(
        f"{path} is neither an obs recording part nor a Chrome trace")
