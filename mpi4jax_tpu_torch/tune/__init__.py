"""The collective algorithm engine: selection, overrides, persistent tuning.

The counterpart of ``mpi4jax_tpu/tune/__init__.py`` (``:218-900,919-993``
there).  The world tier's TCP collectives carry selectable schedules
(ring, recursive doubling, binomial tree, the quantized qring/qrd, the
hierarchical hring/htree, and the alltoall family qalltoall/halltoall/
hqalltoall, ``native/tpucomm.cc``); this module owns which one runs.
Selection is a per-(op, payload-size bucket) decision table resolved in
layers, strongest last:

1. the defaults (``_DEFAULT_TABLE``, or ``_HIER_DEFAULT_TABLE`` once
   ``install`` has seen a multi-island topology);
2. the persistent cache (``~/.cache/mpi4jax_tpu/tune_<size>[_<topohash>]
   .json``, ``MPI4JAX_TPU_TUNE_CACHE`` overriding the path), written by
   ``python -m mpi4jax_tpu_torch.tune`` and loaded at comm creation;
3. API overrides (:func:`set_algorithm`);
4. ``MPI4JAX_TPU_COLL_ALGO`` (``ring`` or ``allreduce=ring,allgather=tree``).

The merged table is pushed into the transport (``tpucomm_set_coll_table``),
which resolves ``algo=None`` per call from the payload size.  The cache
file is the JAX package's, version for version and key for key, so a
cache written by either package loads in the other; both default to the
same directory.  The joint tuner is the port's copy of the JAX package's:
its cost model (``_model.py``, ``fit_model_from_events``), its search
(``_joint.py``, ``python -m mpi4jax_tpu_torch.tune --joint``) and the v2
cache of winning combinations (``cache_from_joint``); a v2 cache's
``combos`` are validated against the joint space's grammar
(``_joint.JOINT_CANDIDATES``) and kept as stored.

Selection must agree on every rank of a comm (same cache, environment and
override calls); the same-host shm arena wins over every pick.  Only
:func:`install` and the override calls touch the transport.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils import config as _config
from ..utils.algos import A2A_ALGOS, ALGO_CODES, QUANT_ALGOS, check_algo
from ._joint import JOINT_CANDIDATES, check_combo, combo_algo, combo_gates

ALGO_NAMES = {v: k for k, v in ALGO_CODES.items()}
OPS = ("allreduce", "allgather", "alltoall")
OP_KIND = {"allreduce": 0, "allgather": 1, "alltoall": 2}

#: hierarchical allreduce/allgather schedules (multi-island comms only)
HIER_ALGOS = frozenset(("hring", "htree"))
#: the exact schedule a quantized pick degrades to under
#: MPI4JAX_TPU_COLL_QUANT=deny, and the quantized twin an exact pick
#: promotes to under compression="int8" (tree's broadcast shape has none:
#: its latency regime maps to qrd; a hierarchical pick maps to the flat
#: twin of its leader leg)
EXACT_TWIN = {"qring": "ring", "qrd": "rd",
              "qalltoall": "ring", "hqalltoall": "halltoall"}
QUANT_TWIN = {"ring": "qring", "rd": "qrd", "tree": "qrd",
              "qring": "qring", "qrd": "qrd",
              "hring": "qring", "htree": "qrd"}
A2A_QUANT = frozenset(("qalltoall", "hqalltoall"))
A2A_HIER = frozenset(("halltoall", "hqalltoall"))
#: flat twin a hierarchical pick degrades to under MPI4JAX_TPU_HIER=deny
HIER_FLAT_TWIN = {"hring": "ring", "htree": "tree",
                  "halltoall": "ring", "hqalltoall": "qalltoall"}

#: --from-trace promotion: an exact allreduce winner at or above this
#: payload whose recorded wire share is at least this fraction is
#: promoted to its quantized twin (cache_from_trace)
QUANT_PROMOTE_MIN_BYTES = 64 * 1024
QUANT_PROMOTE_WIRE_FRAC = 0.6

#: algorithm labels whose recorded events carry tuning signal
TRACE_ALGOS = frozenset(ALGO_CODES) - {"auto", "shm"}

def _usable_trace_event(ev):
    """(op, nbytes, dur_s) for a native TCP-path collective event with an
    algorithm label and no tier (a hierarchical leg times one leg, not the
    labelled algorithm), or None."""
    op = str(ev.get("name", "")).lower()
    if (op not in OPS or ev.get("src") != "native"
            or ev.get("algo") not in TRACE_ALGOS):
        return None
    if ev.get("tier"):
        return None
    nbytes = int(ev.get("bytes", 0))
    dur_s = float(ev.get("dur_us", 0.0)) / 1e6
    if nbytes <= 0 or dur_s <= 0:
        return None
    return op, nbytes, dur_s


#: the cache's format: v2 may carry the joint layer (``combos``), the knob
#: stamp (``knobs``) and a cost-model pointer (``model``); v1 still loads
CACHE_VERSION = 2
_READABLE_CACHE_VERSIONS = (1, 2)

Entry = Tuple[int, str]
Table = Dict[str, List[Entry]]

#: (min_bytes ascending, algo): the native built-in heuristics
_DEFAULT_TABLE: Table = {
    "allreduce": [(0, "tree"), (64 * 1024, "ring")],
    "allgather": [(0, "ring")],
    "alltoall": [(0, "ring")],
}

#: on a comm with a multi-island topology, bandwidth-bound allreduces take
#: the hierarchical ring
_HIER_DEFAULT_TABLE: Table = {
    "allreduce": [(0, "tree"), (64 * 1024, "hring")],
    "allgather": [(0, "ring")],
    "alltoall": [(0, "ring")],
}

_overrides: Dict[str, Dict[int, str]] = {op: {} for op in OPS}
_cache_table: Optional[Table] = None
_cache_origin: Optional[str] = None  # path the cache table came from
_cache_combos: Optional[Table] = None  # a v2 cache's joint combos
_topo_multi: bool = False            # install() saw a multi-island topology
_cache_loaded_for = None             # (world_size, topo_fp) of _cache_table
_noticed: set = set()                # shadow notices already printed


def _check_op(op: str) -> str:
    if op not in OPS:
        raise ValueError(f"unknown collective op {op!r} (expected one of "
                         f"{OPS})")
    return op


_check_algo = check_algo


def cache_path(world_size: int,
               topo_fingerprint: Optional[str] = None) -> str:
    """Path of the persistent autotune cache for a world size.

    ``MPI4JAX_TPU_TUNE_CACHE`` overrides the full path (tests, shared
    clusters); otherwise ``$XDG_CACHE_HOME``-aware
    ``~/.cache/mpi4jax_tpu/tune_<size>[_<topohash>].json``.  The
    topology fingerprint (``Topology.fingerprint()``: a hash of world
    size, island sizes, and per-island tiers) keys the cache on the
    SHAPE the sweep was measured on — a table tuned on one host layout
    must not silently govern another (2x4 and 8x1 have different
    winners).  ``install`` still falls back to the legacy un-keyed
    ``tune_<size>.json`` when no topology-keyed file exists.  The file
    records the world size it was measured at; loading it for a
    different size is rejected (install() then warns and runs on
    defaults).
    """
    forced = os.environ.get("MPI4JAX_TPU_TUNE_CACHE")
    if forced:
        return forced
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    suffix = f"_{topo_fingerprint}" if topo_fingerprint else ""
    return os.path.join(base, "mpi4jax_tpu",
                        f"tune_{world_size}{suffix}.json")


def _validate_table(raw) -> Table:
    if not isinstance(raw, dict):
        raise ValueError("tune table must be a dict of op -> entries")
    table: Table = {}
    for op, entries in raw.items():
        _check_op(op)
        out: List[Entry] = []
        for e in entries:
            if not isinstance(e, (list, tuple)) or len(e) != 2:
                raise ValueError(f"malformed tune entry for {op}: {e!r}")
            min_bytes = int(e[0])
            if min_bytes < 0:
                raise ValueError(f"negative min_bytes in tune entry: {e!r}")
            out.append((min_bytes, _check_algo(e[1], op)))
        table[op] = sorted(out)
    return table


def load_cache(world_size: int, path: Optional[str] = None,
               topo_fingerprint: Optional[str] = None) -> Table:
    """Parse + validate a persistent cache file; raises ``ValueError`` on
    malformed content (a missing file raises ``FileNotFoundError``).
    On success the table becomes the process's cache layer.

    ``topo_fingerprint`` keys the default path AND cross-checks a
    topology-stamped file: a cache measured on one topology shape must
    not govern another.  Legacy files without a topology stamp load for
    any shape (the documented fallback)."""
    global _cache_table, _cache_origin, _cache_combos
    p = path or cache_path(world_size, topo_fingerprint)
    with open(p) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "table" not in data:
        raise ValueError(f"tune cache {p} has no 'table' key")
    if int(data.get("version", -1)) not in _READABLE_CACHE_VERSIONS:
        raise ValueError(
            f"tune cache {p} has version {data.get('version')!r}, "
            f"expected one of {_READABLE_CACHE_VERSIONS}"
        )
    if int(data.get("world_size", -1)) != int(world_size):
        # a table measured at one world size must not govern another
        # (install() downgrades this to a warning and runs on defaults)
        raise ValueError(
            f"tune cache {p} was measured at world size "
            f"{data.get('world_size')!r}, this job has {world_size}"
        )
    stamped = data.get("topology")
    if (stamped and topo_fingerprint and
            str(stamped) != str(topo_fingerprint)):
        raise ValueError(
            f"tune cache {p} was measured on topology {stamped!r}, "
            f"this job discovered {topo_fingerprint!r}"
        )
    table = _validate_table(data["table"])
    combos = None
    if data.get("combos"):
        combos = _validate_combos(data["combos"])
    _cache_table = table
    _cache_combos = combos
    _cache_origin = p
    return table


def _validate_combos(raw) -> Table:
    """A v2 cache's joint combinations: the algorithm table's bucket
    shape, labels from ``JOINT_CANDIDATES``."""
    if not isinstance(raw, dict):
        raise ValueError("tune cache combos must be a dict of op -> entries")
    combos: Table = {}
    for op, entries in raw.items():
        _check_op(op)
        out: List[Entry] = []
        for e in entries:
            if not isinstance(e, (list, tuple)) or len(e) != 2:
                raise ValueError(f"malformed combo entry for {op}: {e!r}")
            min_bytes = int(e[0])
            if min_bytes < 0:
                raise ValueError(f"negative min_bytes in combo entry: {e!r}")
            out.append((min_bytes, check_combo(e[1], op)))
        combos[op] = sorted(out)
    return combos


def save_cache(world_size: int, table: Table, measurements=(),
               path: Optional[str] = None, transport: str = "tcp",
               topo_fingerprint: Optional[str] = None,
               combos: Optional[Table] = None,
               model_path: Optional[str] = None) -> str:
    """Atomically write the cache file; returns its path.

    Every payload is stamped with the active knob environment
    (``knobs``) so the winners are reproducible without reading the
    shell history; measurement rows of gate-dependent combinations
    (``hring+q``/...) additionally carry their own ``gates`` — they
    were measured in a sub-job whose gates differ from the outer job's
    stamp.  ``combos`` (the joint tuner's per-band algorithm
    *combinations*) and ``model_path`` (the cost-model file the search
    was seeded by) make the payload a v2 joint cache; without them the
    file is still written as v2 but carries only the v1 semantics."""
    p = path or cache_path(world_size, topo_fingerprint)
    table = _validate_table(table)
    if combos is not None:
        combos = _validate_combos(combos)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    payload = {
        "version": CACHE_VERSION,
        "world_size": int(world_size),
        "transport": transport,
        "table": {op: [list(e) for e in entries]
                  for op, entries in table.items()},
        "measurements": list(measurements),
        "knobs": _config.knob_env(),
    }
    if combos is not None:
        payload["combos"] = {op: [list(e) for e in entries]
                             for op, entries in combos.items()}
    if model_path:
        payload["model"] = str(model_path)
    if topo_fingerprint:
        payload["topology"] = str(topo_fingerprint)
    tmp = f"{p}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, p)
    return p


def _env_table() -> Table:
    """Parse ``MPI4JAX_TPU_COLL_ALGO``: a bare algorithm name forces every
    op; ``op=algo[,op=algo...]`` forces per op.  Raises ``ValueError`` on
    anything else (fail-fast, like the boolean knob parser)."""
    raw = os.environ.get("MPI4JAX_TPU_COLL_ALGO", "").strip()
    if not raw:
        return {}
    table: Table = {}
    if "=" not in raw:
        algo = _check_algo(raw)
        # a bare quantized name governs allreduce only (it has no
        # allgather schedule); other ops keep their normal selection
        if algo in QUANT_ALGOS:
            return {"allreduce": [(0, algo)]}
        # the alltoall family only has alltoall schedules
        if algo in A2A_ALGOS:
            return {"alltoall": [(0, algo)]}
        # rd/tree/hring/htree have no alltoall schedule; only
        # auto/ring are valid for every op
        if algo not in ("auto", "ring"):
            return {op: [(0, algo)]
                    for op in ("allreduce", "allgather")}
        return {op: [(0, algo)] for op in OPS}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        op, _, algo = part.partition("=")
        op = _check_op(op.strip())
        table[op] = [(0, _check_algo(algo, op))]
    return table


def set_algorithm(op: str, algo: str, min_bytes: int = 0) -> None:
    """Force ``algo`` for ``op`` payloads >= ``min_bytes`` (the API twin
    of ``MPI4JAX_TPU_COLL_ALGO``, which still wins when set).  Takes
    effect immediately on live communicators — the native layer re-reads
    the table per call."""
    op = _check_op(op)
    _overrides[op][int(min_bytes)] = _check_algo(algo, op)
    _reinstall()


def clear_overrides() -> None:
    """Drop every :func:`set_algorithm` override (cache/env/defaults
    remain in force)."""
    for op in OPS:
        _overrides[op].clear()
    _reinstall()


def decision_table() -> Table:
    """The merged (defaults <- cache <- API overrides <- env) table.
    The default layer is topology-aware: once ``install`` has seen a
    multi-island topology, bandwidth-bound allreduces default to the
    hierarchical ring (``_HIER_DEFAULT_TABLE``)."""
    base = _HIER_DEFAULT_TABLE if _topo_multi else _DEFAULT_TABLE
    table: Table = {op: list(base[op]) for op in OPS}
    if _cache_table:
        for op, entries in _cache_table.items():
            table[op] = list(entries)
    for op in OPS:
        if _overrides[op]:
            merged = dict(table[op])
            # an override at min_bytes B governs [B, inf): drop inherited
            # entries above it so e.g. set_algorithm("allreduce", "rd")
            # at 0 really forces rd everywhere
            lo = min(_overrides[op])
            merged = {mb: a for mb, a in merged.items() if mb < lo}
            merged.update(_overrides[op])
            table[op] = sorted(merged.items())
    for op, entries in _env_table().items():
        table[op] = list(entries)
    return table


def get_algorithm(op: str, nbytes: int) -> str:
    """The algorithm name selected for ``op`` at ``nbytes`` (TCP path;
    the shm arena, when active, overrides this — see
    ``WorldComm.coll_algo`` for the arena-aware probe)."""
    op = _check_op(op)
    entries = decision_table()[op]
    algo = "auto"
    for min_bytes, name in entries:
        if int(nbytes) >= min_bytes:
            algo = name
    if algo == "auto":
        # mirror the native built-in heuristic
        if op == "allreduce":
            algo = "ring" if int(nbytes) >= 64 * 1024 else "tree"
        else:
            algo = "ring"
    return algo


def quantized_algorithm(nbytes: int) -> str:
    """The quantized wire-format algorithm that should carry an
    allreduce of ``nbytes`` (the ``compression="int8"`` route): the
    quantized twin of whatever the engine would pick exactly —
    bandwidth-bound sizes compress as qring, latency-bound ones as
    qrd — so a tuned deployment keeps its shape under compression."""
    return QUANT_TWIN[get_algorithm("allreduce", nbytes)]


def default_algorithm(op: str, nbytes: int) -> str:
    """The static default (pre-engine built-in heuristic) pick, ignoring
    cache/API/env — what a pre-engine native library actually runs (it
    has no table to install into)."""
    op = _check_op(op)
    algo = _DEFAULT_TABLE[op][0][1]
    for min_bytes, name in _DEFAULT_TABLE[op]:
        if int(nbytes) >= min_bytes:
            algo = name
    return algo


def sources() -> List[str]:
    """Which layers contribute to the current decision table."""
    out = ["defaults:topology" if _topo_multi else "defaults"]
    if _cache_table is not None:
        out.append(f"cache:{_cache_origin}")
    if any(_overrides[op] for op in OPS):
        out.append("api")
    if os.environ.get("MPI4JAX_TPU_COLL_ALGO", "").strip():
        out.append("env:MPI4JAX_TPU_COLL_ALGO")
    return out


def describe() -> dict:
    """Diag-friendly summary: table, sources, representative picks."""
    table = decision_table()
    out = {
        "sources": sources(),
        "table": {op: [list(e) for e in entries]
                  for op, entries in table.items()},
        "picks": {
            op: {"1KB": get_algorithm(op, 1024),
                 "16MB": get_algorithm(op, 16 << 20)}
            for op in OPS
        },
    }
    if _cache_combos:
        out["combos"] = {op: [list(e) for e in entries]
                         for op, entries in _cache_combos.items()}
    return out


def cache_combos() -> Optional[Table]:
    """The loaded joint cache's per-band algorithm combinations, or
    None (no cache, or a v1 algo-only cache)."""
    return _cache_combos


def _notice_shadowed() -> None:
    """Satellite of the joint tuner: when a process-wide env knob
    overrides (or degrades) an installed cache pick, say so LOUDLY once
    per distinct conflict instead of letting the precedence chain
    shadow the cache silently — naming both picks, so the operator
    knows which measurement they are discarding.

    Covered shadows: ``MPI4JAX_TPU_COLL_ALGO`` replacing a cached
    algorithm outright; ``MPI4JAX_TPU_COLL_QUANT=deny`` degrading a
    cached quantized pick to its exact twin; a joint-cache ``+q``
    combo whose quantized leader leg needs ``COLL_QUANT=force``; an
    ``+ici`` combo whose intra leg is switched off by
    ``MPI4JAX_TPU_ICI_LEG=off``; and ``MPI4JAX_TPU_HIER=deny``
    flattening a cached hierarchical pick.
    """
    if _cache_table is None:
        return
    msgs: List[str] = []
    env_raw = os.environ.get("MPI4JAX_TPU_COLL_ALGO", "").strip()
    if env_raw:
        env_t = _env_table()
        for op, entries in sorted(_cache_table.items()):
            if op not in env_t:
                continue
            forced = env_t[op][-1][1]
            shadowed = sorted({a for _, a in entries if a != forced})
            if shadowed:
                msgs.append(
                    f"MPI4JAX_TPU_COLL_ALGO={env_raw} overrides the "
                    f"installed tune-cache pick(s) {', '.join(shadowed)} "
                    f"for {op} with '{forced}' (cache: {_cache_origin})")
    try:
        qm, hm = _config.quant_mode(), _config.hier_mode()
        im = _config.ici_leg_mode()
    except ValueError:
        # a malformed gate is about to abort the job loudly anyway
        qm = hm = im = "allow"
    picks = _cache_combos or _cache_table
    for op, entries in sorted(picks.items()):
        for mb, combo in entries:
            algo = combo_algo(combo)
            gates = combo_gates(combo)
            where = f"{op} >= {mb} B (cache: {_cache_origin})"
            if (algo in QUANT_ALGOS or algo in A2A_QUANT) \
                    and qm == "deny":
                msgs.append(
                    f"MPI4JAX_TPU_COLL_QUANT=deny degrades the installed "
                    f"cache pick '{combo}' to its exact twin "
                    f"'{EXACT_TWIN[algo]}' for {where}")
            elif "MPI4JAX_TPU_COLL_QUANT" in gates and qm != "force":
                msgs.append(
                    f"the installed joint-cache pick '{combo}' needs "
                    f"MPI4JAX_TPU_COLL_QUANT=force for its quantized "
                    f"leader leg; the active gate '{qm}' leaves that leg "
                    f"exact ('{algo}' runs) for {where}")
            if "MPI4JAX_TPU_ICI_LEG" in gates and im == "off":
                msgs.append(
                    f"the installed joint-cache pick '{combo}' rides the "
                    f"intra-island leg on the card; MPI4JAX_TPU_ICI_LEG=off "
                    f"keeps the native intra paths ('{algo}' runs) for "
                    f"{where}")
            if (algo in HIER_ALGOS or algo in A2A_HIER) and hm == "deny":
                flat = HIER_FLAT_TWIN[algo]
                msgs.append(
                    f"MPI4JAX_TPU_HIER=deny degrades the installed cache "
                    f"pick '{combo}' to its flat twin '{flat}' for {where}")
    for msg in msgs:
        if msg not in _noticed:
            _noticed.add(msg)
            print(f"[tune] NOTICE: {msg}", file=sys.stderr, flush=True)


def entries_from_measurements(best: Dict[int, str]) -> List[Entry]:
    """Collapse per-size winners ``{bytes: algo}`` into bucket entries:
    the winner at size s governs [s, next measured size); the smallest
    size's winner extends down to 0."""
    if not best:
        return []
    sizes = sorted(best)
    entries: List[Entry] = [(0, best[sizes[0]])]
    for s in sizes[1:]:
        if best[s] != entries[-1][1]:
            entries.append((s, best[s]))
    return entries


def measurements_from_events(events) -> Dict[str, Dict[int, Dict[str, float]]]:
    """Median observed seconds per (op, payload bytes, algorithm) from a
    recorded run's canonical events (``obs`` dumps).

    Only native TCP-path collective events count: the same-host shm
    arena and the ops-layer spans measure a different thing than the
    algorithm engine selects for, and events without an algorithm or
    byte count carry no tuning signal.
    """
    samples: Dict[str, Dict[int, Dict[str, List[float]]]] = {}
    for ev in events:
        usable = _usable_trace_event(ev)
        if usable is None:
            continue
        op, nbytes, dur_s = usable
        samples.setdefault(op, {}).setdefault(nbytes, {}) \
            .setdefault(ev["algo"], []).append(dur_s)
    out: Dict[str, Dict[int, Dict[str, float]]] = {}
    for op, by_size in samples.items():
        for nbytes, by_algo in by_size.items():
            for algo, durs in by_algo.items():
                durs.sort()
                # interpolated median, identical to numpy / the p50 the
                # profile report prints for the same recording — the
                # tuner's "best median" and the operator's table must
                # name the same winner
                n = len(durs)
                med = (durs[(n - 1) // 2] + durs[n // 2]) / 2.0
                out.setdefault(op, {}).setdefault(nbytes, {})[algo] = med
    return out


def wire_fractions_from_events(events) -> Dict[str, Dict[int, Dict[str, float]]]:
    """Mean recorded wire share — ``(dur - wait - dispatch) / dur`` —
    per (op, payload bytes, algorithm), same event filter as
    :func:`measurements_from_events`.  A high wire fraction means the
    op spends its time MOVING bytes (not blocked on peers, not queued):
    exactly the regime where compressing the frames pays, so
    :func:`cache_from_trace` uses this to decide when an exact winner
    should be promoted to its quantized twin."""
    fracs: Dict[str, Dict[int, Dict[str, List[float]]]] = {}
    for ev in events:
        usable = _usable_trace_event(ev)
        if usable is None:
            continue
        op, nbytes, dur_s = usable
        wire_s = max(dur_s - float(ev.get("wait_us", 0.0)) / 1e6
                     - float(ev.get("dispatch_us", 0.0)) / 1e6, 0.0)
        fracs.setdefault(op, {}).setdefault(nbytes, {}) \
            .setdefault(ev["algo"], []).append(wire_s / dur_s)
    return {
        op: {nbytes: {algo: sum(fr) / len(fr)
                      for algo, fr in by_algo.items()}
             for nbytes, by_algo in by_size.items()}
        for op, by_size in fracs.items()
    }


def dispatch_fractions_from_events(events) -> Dict[str, Dict[int, Dict[str, float]]]:
    """Mean recorded dispatch share — ``dispatch / dur`` — per (op,
    payload bytes, algorithm), same event filter as
    :func:`measurements_from_events`.  A high dispatch fraction means
    the op spends its time queued behind the engine, which is what the
    cost model's concurrency-group-cap suggestion keys on."""
    fracs: Dict[str, Dict[int, Dict[str, List[float]]]] = {}
    for ev in events:
        usable = _usable_trace_event(ev)
        if usable is None:
            continue
        op, nbytes, dur_s = usable
        disp_s = float(ev.get("dispatch_us", 0.0)) / 1e6
        fracs.setdefault(op, {}).setdefault(nbytes, {}) \
            .setdefault(ev["algo"], []).append(min(disp_s / dur_s, 1.0))
    return {
        op: {nbytes: {algo: sum(fr) / len(fr)
                      for algo, fr in by_algo.items()}
             for nbytes, by_algo in by_size.items()}
        for op, by_size in fracs.items()
    }


def fit_model_from_events(events, *, world_size: int = 0,
                          topo_fingerprint: Optional[str] = None,
                          source: str = "trace"):
    """A :class:`_model.CostModel` fitted from a recorded run's events:
    the per-(op, size, algorithm) medians become its samples, with the
    recorded wire and dispatch fractions beside them (the event filter of
    ``--from-trace``), stamped with the active knobs (a recording compares
    only with runs under the same gates)."""
    from . import _model

    samples = measurements_from_events(events)
    wire = wire_fractions_from_events(events)
    disp = dispatch_fractions_from_events(events)
    model = _model.CostModel(
        world_size=world_size, topology=topo_fingerprint,
        knobs=_config.knob_env(), source=source)
    for op, by_size in samples.items():
        for nbytes, by_algo in by_size.items():
            for algo, med in by_algo.items():
                model.add_sample(
                    op, algo, nbytes, med,
                    wire_frac=wire.get(op, {}).get(nbytes, {}).get(algo),
                    dispatch_frac=disp.get(op, {}).get(nbytes, {})
                    .get(algo))
    return model


def collect_trace_events(paths: Sequence[str], obs_dump=None):
    """Load recorded events from part files / merged traces with the
    elastic world-generation gate applied: a file spanning generations
    is refused outright, files from superseded generations are skipped
    with a loud notice (pre- and post-shrink timings must never pool
    into one median).  Returns ``(events, seen_world_size)`` — the one
    loader BOTH ``--from-trace`` consumers (cache derivation and the
    ``--joint`` model seed) go through."""
    if obs_dump is None:
        from ..obs import _dump as obs_dump
    per_file = []
    for path in paths:
        evs, size, gens = obs_dump.load_events_meta(path)
        if len(gens) > 1:
            # a merged trace spanning an elastic recovery: its spans
            # cannot be attributed to one world membership, so pre- and
            # post-shrink timings would pool into one median
            raise ValueError(
                f"{path} merges recordings from world generations "
                f"{sorted(gens)} (an elastic recovery happened "
                "mid-job); pass the per-rank part files instead — "
                "only the latest generation's timings are usable")
        per_file.append((path, evs, size, max(gens)))
    latest_gen = max((g for _, _, _, g in per_file), default=0)
    stale = [(path, g) for path, _, _, g in per_file if g != latest_gen]
    if stale:
        # an elastic shrink mid-recording: pre-shrink worlds have a
        # different membership (and size), so their timings must not
        # pool with the survivors' — reject them loudly, keep the rest
        names = ", ".join(f"{os.path.basename(p)} (generation {g})"
                          for p, g in stale)
        print(f"tune: --from-trace: ignoring {len(stale)} recording(s) "
              f"from superseded world generation(s): {names} — only "
              f"generation {latest_gen}, the latest, carries timings "
              "for the surviving world", file=sys.stderr, flush=True)
        per_file = [(p, e, s, g) for p, e, s, g in per_file
                    if g == latest_gen]
    events: List[dict] = []
    seen_size = 0
    for _, evs, size, _ in per_file:
        events.extend(evs)
        seen_size = max(seen_size, size)
    return events, seen_size


def cache_from_trace(paths: Sequence[str], world_size: Optional[int] = None,
                     cache_path_override: Optional[str] = None,
                     quantize: bool = True) -> str:
    """Derive the persistent algorithm cache from a recorded real run
    (the ``python -m mpi4jax_tpu_torch.tune --from-trace`` backend): the
    winner per (op, size) is the algorithm with the best median observed
    time, collapsed into bucket entries exactly like the synthetic
    sweep.  ``paths`` are recording part files and/or merged Chrome
    traces; ``world_size`` defaults to the recordings' own metadata.
    Raises ``ValueError`` when the recording carries no usable TCP-path
    collective timings (e.g. the run rode the shm arena throughout).

    With ``quantize`` (the default), an exact allreduce winner at
    >= QUANT_PROMOTE_MIN_BYTES whose recorded wire share is at least
    QUANT_PROMOTE_WIRE_FRAC is promoted to its quantized twin
    (qring/qrd): the recording says those calls spend their time moving
    bytes, so shrinking the frames is the available lever.  Promotion
    is recorded per measurement (``promoted_from``); it is skipped
    entirely under ``MPI4JAX_TPU_COLL_QUANT=deny`` (the native engine
    would degrade the rows right back) and ineligible calls (integer
    dtypes, non-SUM) degrade natively at dispatch, so a promoted row is
    always safe.  Pass ``quantize=False`` for
    an exact-only table.
    """
    events, seen_size = collect_trace_events(paths)
    n = int(world_size or seen_size)
    if n < 2:
        raise ValueError(
            "cannot tell the recording's world size — pass world_size "
            "(tune --from-trace --np N)")
    samples = measurements_from_events(events)
    if quantize:
        quantize = _config.quant_mode() != "deny"
    wire_fracs = wire_fractions_from_events(events) if quantize else {}
    best: Dict[str, Dict[int, str]] = {}
    measurements = []
    for op, by_size in samples.items():
        for nbytes, by_algo in sorted(by_size.items()):
            winner = min(by_algo, key=by_algo.get)
            promoted_from = None
            if (quantize and op == "allreduce"
                    and winner in ("ring", "rd", "tree")
                    and nbytes >= QUANT_PROMOTE_MIN_BYTES):
                frac = wire_fracs.get(op, {}).get(nbytes, {}) \
                    .get(winner, 0.0)
                if frac >= QUANT_PROMOTE_WIRE_FRAC:
                    promoted_from, winner = winner, QUANT_TWIN[winner]
            best.setdefault(op, {})[nbytes] = winner
            for algo, dt in sorted(by_algo.items()):
                measurements.append({
                    "op": op, "bytes": nbytes, "algo": algo,
                    "seconds": round(dt, 9), "ranks": n,
                    "source": "trace",
                })
            if promoted_from is not None:
                measurements.append({
                    "op": op, "bytes": nbytes, "algo": winner,
                    "promoted_from": promoted_from,
                    "wire_frac": round(wire_fracs[op][nbytes]
                                       [promoted_from], 4),
                    "ranks": n, "source": "trace:quant-promotion",
                })
    if not best:
        raise ValueError(
            "the recording holds no TCP-path collective timings with "
            "algorithm labels (shm-arena runs measure the same-host "
            "fast path, which the engine does not select for)")
    table = {op: entries_from_measurements(b) for op, b in best.items()}
    return save_cache(n, table, measurements, path=cache_path_override,
                      transport="tcp:from-trace")


def cache_from_joint(world_size: int, best: Dict[str, Dict[int, str]],
                     measurements=(), *, path: Optional[str] = None,
                     topo_fingerprint: Optional[str] = None,
                     model_file: Optional[str] = None) -> str:
    """Write the v2 joint cache from the winning combos per (op, size)
    (``--joint``'s output): ``combos`` records the whole winning
    combination per size band, and the derived ``table`` the per-call
    forcible algorithm under each, so the transport's install and v1
    readers see what they always did."""
    combos = {op: entries_from_measurements(b) for op, b in best.items()}

    def _algo_entries(op, entries):
        out: List[Entry] = []
        for mb, combo in entries:
            algo = check_algo(combo_algo(combo), op)
            if not out or out[-1][1] != algo:
                out.append((mb, algo))
        return out

    table = {op: _algo_entries(op, entries)
             for op, entries in combos.items()}
    return save_cache(world_size, table, measurements, path=path,
                      transport="tcp:joint",
                      topo_fingerprint=topo_fingerprint, combos=combos,
                      model_path=model_file)


def install(world_size: Optional[int] = None, topology=None,
            native: bool = True) -> bool:
    """Load the persistent cache (if present) and push the merged
    decision table into the native layer.  Called by
    ``runtime.bridge.comm_init`` at communicator creation; safe to call
    again after overrides.  Returns True when the native table was
    pushed (False: native lib unavailable or too old).

    ``topology`` (a ``topo.Topology``, when discovery ran) does two
    things: a multi-island map flips the default layer to the
    hierarchical table, and its fingerprint keys the cache lookup —
    ``tune_<size>_<topohash>.json`` first, the legacy un-keyed
    ``tune_<size>.json`` as a fallback.

    ``native=False`` loads the layers in Python only and pushes nothing:
    the static verifier's virtual world (``analysis/_sim.py``) gives an
    analyzed program the tables its ranks would read, without the
    transport."""
    global _topo_multi, _cache_table, _cache_origin, _cache_combos, \
        _cache_loaded_for
    topo_fp = None
    if topology is not None:
        _topo_multi = bool(getattr(topology, "multi", False))
        if _topo_multi:
            topo_fp = topology.fingerprint()
    if world_size is not None:
        want = (int(world_size), topo_fp)
        if _cache_loaded_for is not None and _cache_loaded_for != want:
            # an elastic rebuild changed the world shape: the in-memory
            # cache belongs to the old one — drop it and reload below
            _cache_table = None
            _cache_origin = None
            _cache_combos = None
            _cache_loaded_for = None
        if _cache_table is None:
            candidates = []
            if topo_fp:
                candidates.append((cache_path(world_size, topo_fp),
                                   topo_fp))
            legacy = cache_path(world_size)
            if not candidates or candidates[0][0] != legacy:
                candidates.append((legacy, None))
            for path, fp in candidates:
                try:
                    load_cache(world_size, path=path, topo_fingerprint=fp)
                    _cache_loaded_for = want
                    break
                except FileNotFoundError:
                    continue
                except ValueError as e:
                    import warnings

                    warnings.warn(f"ignoring unusable tune cache: {e}")
                    break
            else:
                _cache_loaded_for = want  # nothing on disk for this shape
    # a conflicting env knob silently shadowing a measured cache pick is
    # the one precedence interaction operators cannot see — say so once
    _notice_shadowed()
    return _push_native() if native else False


def _reinstall() -> None:
    """Re-push after an override change, but only into an already-loaded
    transport (never build it from a pure-Python code path)."""
    from ..runtime import bridge

    if bridge._lib is not None:
        _push_native()


def _push_native() -> bool:
    from ..runtime import bridge

    table = decision_table()
    coded = {
        OP_KIND[op]: [(mb, ALGO_CODES[name]) for mb, name in entries]
        for op, entries in table.items()
    }
    bridge.set_coll_table(coded)
    return True
