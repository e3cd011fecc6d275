"""Recording inspection CLI for the observability subsystem.

    python -m mpi4jax_tpu_torch.profile report out.json.rank0.json [...]
    python -m mpi4jax_tpu_torch.profile report out.json   # merged trace
    python -m mpi4jax_tpu_torch.profile merge --out out.json out.json.rank*.json

The counterpart of ``mpi4jax_tpu/profile.py``, with the same output.
``report`` renders the per-op / per-peer / per-algorithm table (count,
bytes, p50/p95/p99 latency, wait fraction, effective GB/s) from part files
dumped at exit (``MPI4JAX_TPU_TRACE``) or a merged Chrome trace; ``--json``
prints the ``obs.stats`` object instead.  ``merge`` combines part files
into one Perfetto-loadable trace (what ``runtime.launch --trace`` does after
a job).  It also runs as a file: ``python mpi4jax_tpu_torch/profile.py
report ...``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):  # run as a file
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from mpi4jax_tpu_torch import obs  # noqa: E402


def _load_all(paths):
    """(events, dropped, ranks) across recording files of either kind."""
    events = []
    dropped = {}
    ranks = set()
    for path in paths:
        try:
            part = obs.load_part(path)
        except (ValueError, json.JSONDecodeError):
            evs, _ = obs.load_events(path)  # merged chrome trace
            events.extend(evs)
            continue
        rank = int(part.get("rank", 0))
        ranks.add(rank)
        for src, n in (part.get("dropped") or {}).items():
            dropped[f"rank{rank}.{src}"] = int(n)
        events.extend(part["events"])
    return events, dropped, sorted(ranks)


def cmd_report(args) -> int:
    events, dropped, ranks = _load_all(args.recordings)
    stats = obs.summarize(events, dropped=dropped)
    if args.json:
        print(json.dumps(stats, indent=1, sort_keys=True))
        return 0
    if ranks:
        print(f"# {len(events)} events from rank(s) "
              f"{','.join(map(str, ranks))}")
    print(obs.render_table(stats))
    return 0


def cmd_merge(args) -> int:
    merged = obs.merge_files(args.recordings)
    errors = obs.validate_chrome_trace(merged)
    if errors:
        print(f"profile: merged trace failed validation: {errors[:3]}",
              file=sys.stderr, flush=True)
        return 2
    with open(args.out, "w") as f:
        json.dump(merged, f)
    spans = sum(1 for e in merged["traceEvents"] if e.get("ph") == "X")
    print(f"profile: merged {len(args.recordings)} recording(s), "
          f"{spans} spans -> {args.out} (load in https://ui.perfetto.dev)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpi4jax_tpu_torch.profile")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="per-op/per-algo table from "
                                        "recordings")
    rep.add_argument("recordings", nargs="+",
                     help="part files (out.json.rank*.json) and/or merged "
                          "traces")
    rep.add_argument("--json", action="store_true",
                     help="emit the obs.stats object instead of the table")
    rep.set_defaults(fn=cmd_report)
    mrg = sub.add_parser("merge", help="merge part files into one "
                                       "Perfetto trace")
    mrg.add_argument("recordings", nargs="+", help="part files")
    mrg.add_argument("--out", required=True, help="merged trace path")
    mrg.set_defaults(fn=cmd_merge)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:
        print(f"profile: {e}", file=sys.stderr, flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
