"""Per-rank event recorder: a fixed-size ring with drop accounting.

A copy of ``mpi4jax_tpu/obs/_recorder.py``.  Two sources feed it:

- the **native ring** in the transport (``native/tpucomm.cc``), drained
  through ``_native.drain``: world-tier wire ops with the wait/transfer
  split measured inside the transport;
- **ops-layer spans** pushed by ``utils/tracing.py``'s ``CallTrace``
  (:func:`record_span`): the host-side view of the same calls, staging to
  pinned memory and the copy back included, and the intra-island leg's
  ``tier="ici"`` span (``topo/_ici_leg.py``).

Disabled (the default) costs one module-global read per call on the
Python side and one relaxed atomic load in the native transport; no clock
is read and no ring slot is written.
"""


from __future__ import annotations

import os
import threading
import time

from . import _native

#: the ONLY thing a disabled hot path reads (module global, no lock)
_ENABLED = False


class Recorder:
    """Fixed-capacity event ring: overflow overwrites the oldest entry
    and counts it, so a snapshot always reports exactly what is missing
    (the Python twin of the native ring's contract)."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 16)
        self._buf = [None] * self.capacity
        self._total = 0
        self._lock = threading.Lock()

    def append(self, event: dict) -> None:
        with self._lock:
            self._buf[self._total % self.capacity] = event
            self._total += 1

    def extend(self, events) -> None:
        with self._lock:
            for event in events:
                self._buf[self._total % self.capacity] = event
                self._total += 1

    @property
    def dropped(self) -> int:
        return max(0, self._total - self.capacity)

    def snapshot(self):
        """Held events, oldest first (does not clear)."""
        with self._lock:
            held = min(self._total, self.capacity)
            first = self._total - held
            return [self._buf[(first + i) % self.capacity]
                    for i in range(held)]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._total = 0


class _State:
    lib = None            # native library (None = python spans only)
    rank = 0
    size = 1
    clock_offset_us = 0.0  # cross-rank alignment shift for this rank
    steady0 = 0.0          # native clock sample ...
    unix0 = 0.0            # ... taken at this unix time
    spans: Recorder = None       # ops-layer spans
    native_acc: Recorder = None  # drained native events (canonical form)
    native_dropped = 0           # native overflow total at last pull


_state = _State()


def enabled() -> bool:
    return _ENABLED


def default_capacity_events() -> int:
    """Ring capacity from ``MPI4JAX_TPU_TRACE_BUF_KB`` (default 256 KB
    of 80-byte native slots = 3276 events; same count on the Python
    side)."""
    raw = os.environ.get("MPI4JAX_TPU_TRACE_BUF_KB", "256")
    try:
        kb = float(raw)
    except ValueError:
        raise ValueError(
            f"cannot parse MPI4JAX_TPU_TRACE_BUF_KB={raw!r} as KB")
    if kb <= 0:
        kb = 256.0
    return max(16, int(kb * 1024) // _native.EVENT_BYTES)


def start(lib=None, capacity_events=None, rank=0, size=1,
          clock_offset_s=0.0) -> None:
    """Arm recording.  ``lib`` (the loaded transport) is optional — the
    Python span recorder works alone for mesh-tier / single-process use.
    ``clock_offset_s`` shifts this rank's timestamps onto the job-global
    timeline (see ``runtime/bridge.py``'s alignment handshake)."""
    global _ENABLED
    cap = capacity_events or default_capacity_events()
    _state.lib = lib if _native.available(lib) else None
    _state.rank = int(rank)
    _state.size = int(size)
    _state.clock_offset_us = float(clock_offset_s) * 1e6
    _state.spans = Recorder(cap)
    _state.native_acc = Recorder(cap)
    _state.native_dropped = 0
    if _state.lib is not None:
        # map the native monotonic clock to the unix epoch: take the
        # sample pair with the tightest bracket (least scheduling noise)
        best = None
        for _ in range(5):
            u0 = time.time()
            s = _native.clock(_state.lib)
            u1 = time.time()
            if best is None or (u1 - u0) < best[0]:
                best = (u1 - u0, s, (u0 + u1) / 2)
        _state.steady0 = best[1]
        _state.unix0 = best[2]
        _native.enable(_state.lib, cap)
    _ENABLED = True


def stop() -> None:
    global _ENABLED
    _ENABLED = False
    if _state.lib is not None:
        _native.disable(_state.lib)


def reset() -> None:
    """Drop everything recorded so far (stays armed)."""
    if _state.spans is not None:
        _state.spans.clear()
        _state.native_acc.clear()
    _state.native_dropped = 0
    if _state.lib is not None:
        _native.enable(_state.lib, _state.spans.capacity)


def record_span(name: str, t_unix: float, dur_s: float, *, peer=-1,
                nbytes=0, tag=0, algo=None, tier=None,
                phase=None) -> None:
    """Ops-layer span hook (called by ``tracing.CallTrace`` only when
    :func:`enabled` — callers guard, so the disabled path never reaches
    here).  ``tier`` marks a per-leg event (e.g. the intra-island
    leg's ``tier="ici"``) nested inside a whole-op record: stats then
    attributes the leg's bytes in ``tier_bytes`` while the tuner keeps
    ignoring tier-carrying events (``_usable_trace_event``), exactly as
    it does for the native hierarchical leg events.  ``phase`` labels a
    serving-plane span (``prefill`` / ``decode`` / ``kv_xfer``) so
    stats and the load generator split percentiles per phase; absent
    on every non-serving span, so pre-serving recordings stay
    schema-identical."""
    if _state.spans is None:
        return
    ev = {
        "name": name,
        "src": "ops",
        "ts_us": t_unix * 1e6 + _state.clock_offset_us,
        "dur_us": dur_s * 1e6,
        "wait_us": 0.0,
        "dispatch_us": 0.0,
        "bytes": int(nbytes),
        "peer": int(peer),
        "tag": int(tag),
        "algo": algo,
    }
    if tier:
        ev["tier"] = str(tier)
    if phase:
        ev["phase"] = str(phase)
    _state.spans.append(ev)


def canonicalize_native(raw, to_unix: float = 0.0,
                        clock_offset_us: float = 0.0):
    """Raw native drain/peek dicts -> canonical events (the dump/stats
    schema).  Shared by the recorder's destructive drain path and the
    live controller's cursor follow, so both consumers speak the one
    schema ``tune.measurements_from_events`` understands.  ``to_unix``
    maps the native monotonic clock onto the unix epoch (0 leaves
    timestamps on the native clock — fine for consumers that only read
    durations)."""
    canon = []
    for e in raw:
        ev = {
            "name": e["name"],
            "src": "native",
            "ts_us": (e["t"] + to_unix) * 1e6 + clock_offset_us,
            "dur_us": e["dur_s"] * 1e6,
            "wait_us": e["wait_s"] * 1e6,
            "dispatch_us": e.get("queue_s", 0.0) * 1e6,
            "bytes": e["bytes"],
            "peer": e["peer"],
            "tag": e["tag"],
            "algo": e["algo"],
        }
        # wire_bytes defaults to the logical bytes everywhere (schema
        # compatibility with pre-quantization recordings); carry it
        # only when it differs — a quantized collective's compressed
        # payload
        wb = e.get("wire_bytes", e["bytes"])
        if wb != e["bytes"]:
            ev["wire_bytes"] = wb
        # transport tier: carried only on a hierarchical collective's
        # per-leg events ("intra"/"inter"), absent on whole-op and
        # flat events — pre-topology recordings stay schema-identical
        if e.get("tier"):
            ev["tier"] = e["tier"]
        # transport syscall count: carried only when the native library
        # writes it (uring-generation .so) — pre-uring recordings stay
        # schema-identical, and a fake 0 never masquerades as data
        if "syscalls" in e:
            ev["syscalls"] = e["syscalls"]
        # link-layer recovery events the op absorbed (self-healing
        # retries/reconnects it rode through); nonzero only under
        # MPI4JAX_TPU_RETRY with an actual fault, so fault-free
        # recordings stay schema-identical
        if e.get("retries"):
            ev["retries"] = e["retries"]
        canon.append(ev)
    return canon


def _pull_native() -> None:
    """Drain the native ring into the canonical accumulator."""
    if _state.lib is None or _state.native_acc is None:
        return
    _, dropped = _native.counts(_state.lib)
    raw = _native.drain(_state.lib)
    _state.native_dropped = dropped
    _state.native_acc.extend(canonicalize_native(
        raw, _state.unix0 - _state.steady0, _state.clock_offset_us))


def events():
    """Everything recorded so far (native + ops spans), canonical form,
    sorted by aligned timestamp."""
    _pull_native()
    out = []
    if _state.native_acc is not None:
        out.extend(_state.native_acc.snapshot())
    if _state.spans is not None:
        out.extend(_state.spans.snapshot())
    out.sort(key=lambda e: e["ts_us"])
    return out


def dropped() -> dict:
    """Exact overflow accounting per source."""
    nat = _state.native_dropped
    if _state.native_acc is not None:
        nat += _state.native_acc.dropped
    return {
        "native": nat,
        "ops": _state.spans.dropped if _state.spans is not None else 0,
    }


def link_counters():
    """Process-total self-healing link counters (retries, reconnects,
    dup_dropped, crc_errors, replayed, heartbeats) from the live
    transport, or ``None`` without one (mesh-tier / pure-span use, or a
    library predating the link layer).  These are cumulative totals,
    not ring entries — they survive ring overflow and drains."""
    if _state.lib is None:
        return None
    return _native.link_counters(_state.lib)


def rank() -> int:
    return _state.rank


def size() -> int:
    return _state.size


def clock_offset_us() -> float:
    return _state.clock_offset_us


