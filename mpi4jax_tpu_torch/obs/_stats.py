"""Aggregation over recorded events, and the shared benchmark serializer.

A copy of ``mpi4jax_tpu/obs/_stats.py``: the same rows, keys and rounding,
so both packages' ``summarize`` and ``render_table`` agree on the same
events.  Pure stdlib (the knobs' parsers aside).

Canonical event shape (every producer, the native ring, the ops-layer
``CallTrace`` hook and part-file loads, normalizes to this):

    {"name": "Allreduce", "src": "native" | "ops", "ts_us": float,
     "dur_us": float, "wait_us": float, "dispatch_us": float,
     "bytes": int, "peer": int, "tag": int,
     "algo": "ring" | ... | None}

plus an optional ``wire_bytes`` carried only when it differs from
``bytes`` (quantized collectives), and an optional ``tier`` (``"intra"`` /
``"inter"`` on the native hierarchical legs; ``"ici"`` on the intra-island
leg's ops span) carried only on a hierarchical collective's per-leg
events.  ``dispatch_us`` is the submission-queue delay of an engine-queued
op, ``wait_us`` the time blocked on peers, the rest the wire.  ``ts_us``
is on the job-global aligned timeline.
"""


from __future__ import annotations

import math

from ..utils import config as _config

STATS_SCHEMA = "mpi4jax_tpu.obs.stats/1"


def _sig(x: float, figures: int = 4) -> float:
    """Round to significant figures: throughputs span nine orders of
    magnitude across benchmark points, so fixed decimals would collapse
    the small end to 0."""
    return float(f"{float(x):.{figures}g}")


def percentile(values, q: float) -> float:
    """``numpy.percentile(values, q)`` (the default linear-interpolation
    method), reimplemented so the stdlib-only paths agree bit-for-bit
    with numpy on the same corpus (test-enforced)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    if len(vals) == 1:
        return vals[0]
    k = (len(vals) - 1) * (float(q) / 100.0)
    f = math.floor(k)
    c = math.ceil(k)
    if f == c:
        return vals[int(k)]
    return vals[f] * (c - k) + vals[c] * (k - f)


def summarize(events, dropped=None, rank=None, link=None) -> dict:
    """Per-(op, source, peer, algorithm) aggregates over canonical
    events.

    Returns ``{"schema", "rank", "total_events", "dropped", "per_op"}``
    where ``per_op`` rows carry count, total bytes, p50/p95/p99 latency
    (microseconds), the dispatch fraction (share of wall time spent in
    the engine's submission queue — host dispatch, not communication),
    the wait fraction (share blocked on peers rather than moving
    bytes), and effective GB/s (``sum(bytes) / sum(seconds)`` —
    payload over wall time, no algorithm factor).

    ``link`` (the transport's process-total self-healing counters,
    see ``obs._recorder.link_counters``) adds a top-level
    ``self_healing`` dict when any counter is nonzero — fault-free
    stats stay schema-identical.
    """
    groups = {}
    tier_bytes = {}
    for ev in events:
        # src is part of the key: the native ring and the ops-layer
        # span record the SAME call from two vantage points — collapsing
        # them would double-count every send/recv and dilute wait_frac.
        # tier is part of the key too: a hierarchical collective's
        # intra/inter leg events must not merge with (or into) the
        # whole-op record.  phase likewise: a serving span labeled
        # prefill must not pool its latencies with decode or kv_xfer
        # ones — per-phase percentiles are the SLO loop's signal.
        key = (ev.get("name", "?"), ev.get("src", "?"),
               int(ev.get("peer", -1)), ev.get("algo") or "-",
               ev.get("tier") or "-", ev.get("phase") or "-")
        groups.setdefault(key, []).append(ev)
        if ev.get("tier"):
            tier_bytes[ev["tier"]] = (tier_bytes.get(ev["tier"], 0)
                                      + int(ev.get("bytes", 0)))
    rows = []
    for (op, src, peer, algo, tier, phase), evs in sorted(groups.items()):
        durs = [float(e.get("dur_us", 0.0)) for e in evs]
        waits = [float(e.get("wait_us", 0.0)) for e in evs]
        disps = [float(e.get("dispatch_us", 0.0)) for e in evs]
        nbytes = sum(int(e.get("bytes", 0)) for e in evs)
        wire_bytes = sum(int(e.get("wire_bytes", e.get("bytes", 0)))
                         for e in evs)
        seconds = sum(durs) / 1e6
        row = {
            "op": op,
            "src": src,
            "peer": peer,
            "algo": algo,
            "count": len(evs),
            "bytes": nbytes,
            "seconds": round(seconds, 9),
            "p50_us": round(percentile(durs, 50), 3),
            "p95_us": round(percentile(durs, 95), 3),
            "p99_us": round(percentile(durs, 99), 3),
            "dispatch_frac": round(sum(disps) / max(sum(durs), 1e-12), 4),
            "wait_frac": round(sum(waits) / max(sum(durs), 1e-12), 4),
            "eff_GBps": _sig(nbytes / max(seconds, 1e-12) / 1e9),
        }
        if tier != "-":
            # hierarchical per-leg row: name the transport tier it
            # moved on (exact rows stay schema-identical)
            row["tier"] = tier
        if phase != "-":
            # serving-plane row: prefill / decode / kv_xfer — present
            # only on labeled spans, so non-serving stats are unchanged
            row["phase"] = phase
        if wire_bytes != nbytes:
            # quantized wire formats: logical vs on-wire payload.  The
            # column appears only when it says something (exact rows
            # stay schema-identical to pre-quantization stats), and
            # eff_GBps above stays LOGICAL bytes over wall time — the
            # number comparable across compressed and exact runs.
            row["wire_bytes"] = wire_bytes
            row["compression"] = _sig(nbytes / max(wire_bytes, 1))
        if any("syscalls" in e for e in evs):
            # transport syscalls (uring-generation recordings only):
            # total + per-op mean, the submit-batching attribution —
            # pre-uring recordings stay schema-identical
            total_sys = sum(int(e.get("syscalls", 0)) for e in evs)
            row["syscalls"] = total_sys
            row["syscalls_per_op"] = _sig(total_sys / max(len(evs), 1))
        if any(e.get("retries") for e in evs):
            # self-healing recoveries these ops rode through (retry +
            # reconnect events absorbed transparently); the column
            # appears only when a fault actually landed, so fault-free
            # recordings stay schema-identical
            row["retries"] = sum(int(e.get("retries", 0)) for e in evs)
        rows.append(row)
    out = {
        "schema": STATS_SCHEMA,
        "total_events": len(events),
        "dropped": dict(dropped or {}),
        "per_op": rows,
    }
    if tier_bytes:
        # intra- vs inter-island byte split of the hierarchical
        # collectives (per-leg events only — whole-op records carry no
        # tier, so nothing is counted twice)
        out["tier_bytes"] = {k: int(v)
                             for k, v in sorted(tier_bytes.items())}
    if link and any(int(v) for v in link.values()):
        # process-total self-healing counters (cumulative, not ring
        # entries: they survive overflow).  Present only when the link
        # layer actually recovered something — retries/reconnects/
        # dup_dropped/crc_errors/replayed/heartbeats, the diag
        # self_healing check's assertion surface
        out["self_healing"] = {k: int(v) for k, v in sorted(link.items())}
    if rank is not None:
        out["rank"] = int(rank)
    return out


def render_table(stats: dict, *, by=("op", "algo")) -> str:
    """Human-readable per-op table (the profile CLI's ``report``)."""
    cols = ("op", "src", "peer", "algo", "count", "bytes", "p50_us",
            "p95_us", "p99_us", "dispatch_frac", "wait_frac", "eff_GBps")
    rows = stats.get("per_op", [])
    if any("tier" in r for r in rows):
        # hierarchical per-leg rows present: show the transport tier
        # (flat rows render blank)
        cols = cols + ("tier",)
    if any("phase" in r for r in rows):
        # serving-plane rows present: show the phase split
        # (non-serving rows render blank)
        cols = cols + ("phase",)
    if any("compression" in r for r in rows):
        # quantized rows present: show the on-wire compression ratio
        # (exact rows render blank — their wire IS the logical payload)
        cols = cols + ("compression",)
    if any("syscalls_per_op" in r for r in rows):
        # uring-generation rows: syscalls per op (submit batching)
        cols = cols + ("syscalls_per_op",)
    if any("retries" in r for r in rows):
        # self-healing rows present: show absorbed recoveries
        # (fault-free rows render blank)
        cols = cols + ("retries",)
    if not rows:
        return "(no events recorded)"
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
    lines.append("  ".join("-" * widths[c] for c in cols))
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(widths[c])
                               for c in cols))
    dropped = stats.get("dropped") or {}
    total_drop = sum(int(v) for v in dropped.values())
    lines.append(
        f"{stats.get('total_events', len(rows))} events"
        + (f", {total_drop} dropped on ring overflow" if total_drop else "")
    )
    return "\n".join(lines)


def bench_record(*, op, nbytes, seconds, ranks=None, tier=None, algo=None,
                 reps=None, **extra) -> dict:
    """The one benchmark-output serializer: ``benchmarks/*.py``,
    ``obs.stats`` rows, and the profile report all speak these field
    names, so BENCH_*.json artifacts, sweep curves, and recorded-run
    reports stay join-able on (op, bytes, seconds).

    ``eff_GBps_per_chip`` uses the ring-effective convention the BENCH
    artifacts established (``2*(n-1)/n * bytes / seconds`` per rank)
    when ``ranks`` is given, falling back to plain payload-over-time.

    Every row is stamped with the active knob environment
    (``config.knob_env()``: the resolved COLL_ALGO/COLL_QUANT/HIER/
    URING/PLAN gates) so a committed BENCH artifact is reproducible
    without reading the shell history; pass ``knobs=...`` in ``extra``
    to override (the ``--knob-grid`` sweep stamps the combination it
    forced on the sub-job).
    """
    seconds = float(seconds)
    try:
        knobs = _config.knob_env()
    except ValueError as e:
        # a malformed gate aborts loudly wherever it MATTERS (the
        # native parser exits on it); a mesh-tier benchmark that never
        # touches those gates must not crash on the stamp — record the
        # problem instead of fabricating a resolution
        knobs = {"unparseable": str(e)}
    rec = {
        "op": str(op),
        "bytes": int(nbytes),
        "seconds": round(seconds, 9),
        "us": round(seconds * 1e6, 3),
        "knobs": knobs,
    }
    if ranks is not None:
        n = max(int(ranks), 1)
        factor = 2 * (n - 1) / n if n > 1 else 1.0
        rec["ranks"] = n
        rec["eff_GBps_per_chip"] = _sig(
            factor * int(nbytes) / max(seconds, 1e-12) / 1e9)
    else:
        rec["eff_GBps_per_chip"] = _sig(
            int(nbytes) / max(seconds, 1e-12) / 1e9)
    if tier is not None:
        rec["tier"] = str(tier)
    if algo is not None:
        rec["algo"] = str(algo)
    if reps is not None:
        rec["reps"] = int(reps)
    rec.update(extra)
    return rec
