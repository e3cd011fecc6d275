"""ctypes glue to the native transport's observability event ring.

A copy of ``mpi4jax_tpu/obs/_native.py``.  The wire contract lives in
``native/tpucomm.h``: ``TpuObsEvent`` (this module's :class:`TpuObsEvent`
stays field for field identical) and the ``tpucomm_obs_*`` entry points,
which the port's build of the transport carries (``runtime/bridge.py``).
``wire_bytes`` is each event's on-wire payload: the logical ``bytes`` for
every exact op, the packed int8 frame for the quantized schedules.  Every
function takes the loaded library as an argument: this module never loads
or builds the transport, so the JAX package's copy can decode the port's
build and the reverse.
"""


from __future__ import annotations

import ctypes

#: index-matched names for TpuObsEvent.op (enum TpuObsOp in tpucomm.h)
OBS_OP_NAMES = (
    "Send", "Recv", "Sendrecv", "Shift2", "Barrier", "Bcast", "Gather",
    "Scatter", "Allgather", "Alltoall", "Allreduce", "Reduce", "Scan",
)

#: TpuCollAlgo codes -> names (``utils/algos.ALGO_CODES`` inverted)
ALGO_NAMES = {0: "auto", 1: "ring", 2: "rd", 3: "tree", 4: "shm",
              5: "qring", 6: "qrd", 7: "hring", 8: "htree",
              9: "qalltoall", 10: "halltoall", 11: "hqalltoall"}

#: TpuObsTier codes -> names (0 = flat / whole-op, omitted from the
#: canonical events; hierarchical per-leg events carry intra/inter)
TIER_NAMES = {1: "intra", 2: "inter", 3: "ici"}


class TpuObsEvent(ctypes.Structure):
    _fields_ = [
        ("t_start", ctypes.c_double),
        ("dur_s", ctypes.c_double),
        ("wait_s", ctypes.c_double),
        ("queue_s", ctypes.c_double),
        ("nbytes", ctypes.c_int64),
        ("wire_bytes", ctypes.c_int64),
        ("op", ctypes.c_int32),
        ("peer", ctypes.c_int32),
        ("tag", ctypes.c_int32),
        ("algo", ctypes.c_int32),
        ("tier", ctypes.c_int32),
        # transport syscalls issued while the op executed (the uring
        # generation's submit-batching attribution); occupies the former
        # padding slot, so the layout is unchanged — but a pre-uring .so
        # never writes it, which is why drain() gates the field on
        # syscalls_available()
        ("syscalls", ctypes.c_int32),
        # link-layer recovery events absorbed while the op executed
        # (self-healing generation: retries + reconnects the op rode
        # through transparently); widened the struct 72 -> 80 bytes, so
        # available() requires tpucomm_link_counters as the layout probe
        ("retries", ctypes.c_int32),
        ("reserved0", ctypes.c_int32),
    ]

#: process-total link-layer counter names, index-matched to the
#: ``tpucomm_link_counters`` out-params (native/tpucomm.h)
LINK_COUNTER_NAMES = ("retries", "reconnects", "dup_dropped",
                     "crc_errors", "replayed", "heartbeats")


#: bytes per ring slot, for sizing the ring from MPI4JAX_TPU_TRACE_BUF_KB
EVENT_BYTES = ctypes.sizeof(TpuObsEvent)


def available(lib) -> bool:
    """True when the loaded .so carries the event ring (a stale prebuilt
    library predating it keeps working, just unobserved).

    ``tpucomm_set_topology`` doubles as the layout probe: a library
    from before the topology subsystem records events WITHOUT the
    ``tier`` field (pre-quantization ones also lack ``wire_bytes``,
    pre-progress-engine ones ``queue_s``), which this module would
    misparse — such a library is treated as unobserved rather than
    decoded wrong.  ``tpucomm_link_counters`` is the probe for the
    self-healing generation, whose events grew ``retries`` (72 -> 80
    byte slots — an older library's ring would be misparsed too)."""
    if lib is None or not hasattr(lib, "tpucomm_obs_enable"):
        return False
    if not hasattr(lib, "tpucomm_execute"):
        return False
    if not hasattr(lib, "tpucomm_quant_packed_bytes"):
        return False
    if not hasattr(lib, "tpucomm_set_topology"):
        return False
    if not hasattr(lib, "tpucomm_link_counters"):
        return False
    # idempotent signature setup (works for bridge-loaded and
    # standalone-loaded libraries alike)
    lib.tpucomm_obs_enable.argtypes = [ctypes.c_int, ctypes.c_int64]
    lib.tpucomm_obs_enable.restype = None
    lib.tpucomm_obs_counts.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.tpucomm_obs_counts.restype = None
    lib.tpucomm_obs_drain.restype = ctypes.c_int64
    lib.tpucomm_obs_clock.restype = ctypes.c_double
    return True


def syscalls_available(lib) -> bool:
    """True when the loaded .so writes ``TpuObsEvent.syscalls`` —
    ``tpucomm_uring_status`` is the layout probe for the uring
    generation.  A pre-uring library's slot is always 0 (the former
    padding), and reporting a fake 0 as a measurement would poison the
    syscalls-per-message benchmarks, so the field is omitted instead."""
    return lib is not None and hasattr(lib, "tpucomm_uring_status")


def enable(lib, capacity_events: int) -> None:
    lib.tpucomm_obs_enable(1, ctypes.c_int64(int(capacity_events)))


def disable(lib) -> None:
    lib.tpucomm_obs_enable(0, ctypes.c_int64(0))


def counts(lib):
    """(events held, events dropped by overflow) right now."""
    rec = ctypes.c_int64(0)
    drop = ctypes.c_int64(0)
    lib.tpucomm_obs_counts(ctypes.byref(rec), ctypes.byref(drop))
    return rec.value, drop.value


def clock(lib) -> float:
    """The native recorder clock (monotonic seconds, process epoch)."""
    fn = lib.tpucomm_obs_clock
    fn.restype = ctypes.c_double
    return float(fn())


def _decode(buf, got, syscalls_ok):
    """Struct slots -> raw event dicts (shared by drain and peek)."""
    out = []
    for i in range(got):
        e = buf[i]
        op = OBS_OP_NAMES[e.op] if 0 <= e.op < len(OBS_OP_NAMES) else "?"
        ev = {
            "name": op,
            "t": e.t_start,
            "dur_s": e.dur_s,
            "wait_s": e.wait_s,
            "queue_s": e.queue_s,
            "bytes": e.nbytes,
            "wire_bytes": e.wire_bytes,
            "peer": e.peer,
            "tag": e.tag,
            "algo": ALGO_NAMES.get(e.algo),
            "tier": TIER_NAMES.get(e.tier),
        }
        if syscalls_ok:
            # only a uring-generation library writes the field; a
            # pre-uring .so's slot is stale padding, never a count
            ev["syscalls"] = e.syscalls
        if e.retries:
            # link-layer recovery events this op rode through; carried
            # only when nonzero — fault-free recordings (the vast
            # majority) stay schema-identical
            ev["retries"] = e.retries
        out.append(ev)
    return out


def drain(lib, max_events: int = 1 << 20):
    """Pull and clear the held events, oldest first, as raw dicts with
    the native clock's timestamps (seconds): op/peer/tag/bytes/algo/
    t/dur_s/wait_s/queue_s (the dispatch phase: post -> native start,
    0 for inline execution).  Events the buffer cannot take (appended
    between the count probe and the drain, or beyond ``max_events``)
    are counted as dropped by the native side, never silently lost."""
    held, _ = counts(lib)
    # headroom for events appended after the count probe (the native
    # drain clamps to what is actually held)
    n = min(held + 64, max_events)
    if n <= 0 or held <= 0:
        return []
    buf = (TpuObsEvent * n)()
    got = lib.tpucomm_obs_drain(buf, ctypes.c_int64(n))
    return _decode(buf, got, syscalls_available(lib))


def peek_available(lib) -> bool:
    """True when the loaded .so carries the non-destructive cursor read
    (``tpucomm_obs_peek``) — the live controller's follow path.  A
    library predating it still records and drains; only the second
    consumer is unavailable."""
    return available(lib) and hasattr(lib, "tpucomm_obs_peek")


def peek(lib, cursor: int, max_events: int = 4096):
    """Non-destructive follow of the native ring from an absolute
    per-enable sequence ``cursor`` (0 = the oldest held event).
    Returns ``(events, next_cursor, skipped)`` — the same raw dicts as
    :func:`drain`, the cursor to resume from, and how many events
    between ``cursor`` and the oldest still readable were lost to ring
    overflow or a destructive drain.  Never touches the held/dropped
    counts, so the end-of-run :func:`drain` still sees every held
    event (the two-consumer contract the live controller relies on)."""
    n = max(int(max_events), 1)
    buf = (TpuObsEvent * n)()
    cur = ctypes.c_int64(int(cursor))
    skipped = ctypes.c_int64(0)
    lib.tpucomm_obs_peek.restype = ctypes.c_int64
    got = lib.tpucomm_obs_peek(buf, ctypes.c_int64(n), ctypes.byref(cur),
                               ctypes.byref(skipped))
    return (_decode(buf, got, syscalls_available(lib)), cur.value,
            skipped.value)


def link_counters(lib):
    """Process-total self-healing counters as a dict (see
    ``LINK_COUNTER_NAMES``), or ``None`` when the loaded library
    predates the link layer.  All-zero on every fault-free run — and
    with ``MPI4JAX_TPU_RETRY`` unset the layer never arms, so the
    counters stay zero by construction."""
    if lib is None or not hasattr(lib, "tpucomm_link_counters"):
        return None
    vals = [ctypes.c_int64(0) for _ in LINK_COUNTER_NAMES]
    lib.tpucomm_link_counters(*[ctypes.byref(v) for v in vals])
    return {name: int(v.value)
            for name, v in zip(LINK_COUNTER_NAMES, vals)}
