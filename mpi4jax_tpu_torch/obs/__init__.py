"""Observability: per-op event recording, stats and traces.

The counterpart of ``mpi4jax_tpu/obs/``, with the same formats field for
field, so each package reads the other's recordings, merged traces and
stats:

- a **per-rank event recorder**: the native transport's event ring
  (world-tier wire ops: op, peer or root, tag, bytes, algorithm, the
  wait/transfer split) and an ops-layer span ring fed by
  ``utils/tracing.CallTrace``, with exact drop accounting on overflow and
  no work when disabled;
- :func:`stats`: per-op, per-peer, per-algorithm aggregates (count, bytes,
  p50/p95/p99 latency, wait fraction, effective GB/s);
- **Chrome-trace export**: ``python -m mpi4jax_tpu_torch.runtime.launch
  --trace out.json`` merges every rank's recording (clock-offset aligned)
  into one Perfetto-loadable timeline; ``python -m
  mpi4jax_tpu_torch.profile`` renders tables from the same dumps;
- the **tuner's feedback path**: ``python -m mpi4jax_tpu_torch.tune
  --from-trace`` derives the algorithm cache from recorded timings.

Recording turns on through ``MPI4JAX_TPU_TRACE=<out-path>`` (the
launcher's ``--trace`` sets it) or :func:`start`; the ring size is
``MPI4JAX_TPU_TRACE_BUF_KB`` (``utils/config.py``).  No module here imports
torch.
"""


from ._dump import (  # noqa: F401
    load_events,
    load_events_meta,
    load_part,
    part_path,
    part_paths,
    write_part,
)
from ._recorder import (  # noqa: F401
    Recorder,
    clock_offset_us,
    default_capacity_events,
    dropped,
    enabled,
    events,
    link_counters,
    record_span,
    reset,
    start,
    stop,
)
from ._stats import (  # noqa: F401
    STATS_SCHEMA,
    bench_record,
    percentile,
    render_table,
    summarize,
)
from ._trace import (  # noqa: F401
    TRACE_SCHEMA,
    merge_parts,
    rank_trace_events,
    validate_chrome_trace,
)
from . import _recorder


def stats(event_list=None) -> dict:
    """Aggregates over ``event_list`` (default: everything this rank has
    recorded so far) — see ``_stats.summarize`` for the row schema."""
    if event_list is None:
        event_list = events()
        return summarize(event_list, dropped=dropped(),
                         rank=_recorder.rank(),
                         link=_recorder.link_counters())
    return summarize(event_list)


def dump(base_path: str) -> str:
    """Write this rank's recording part file (``<base>.rank<r>.json``),
    stamped with the live elastic generation; returns the path.  Called
    automatically at interpreter exit when ``MPI4JAX_TPU_TRACE`` is set
    (see ``runtime/bridge.py``)."""
    from ..elastic import current_generation

    return write_part(
        base_path,
        rank=_recorder.rank(),
        size=_recorder.size(),
        events=events(),
        dropped=dropped(),
        clock_offset_us=clock_offset_us(),
        generation=current_generation(),
    )


def merge_files(part_files) -> dict:
    """Merged Chrome trace dict from part file paths."""
    return merge_parts([load_part(p) for p in part_files])
