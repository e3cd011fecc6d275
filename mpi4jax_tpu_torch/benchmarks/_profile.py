"""Kernel time by group on the card, for the benchmarks' breakdowns.

The profiler may record fewer launches than were made: on the H100 every
session of ``chip_smoke.py``'s phase 23 recorded 16 to 19 of its 20
launches of kernel 4, and now and then a session records no kernel at all
(PERF.md section 6).  So ``kernel_ms_by_group`` also returns the
launches it recorded, and a time per launch is read over those.

Run as a program, it counts the profiler sessions that lose launches:

    python -m mpi4jax_tpu_torch.benchmarks._profile [--after-hop]

runs ``--sessions`` short sessions of kernel 4 (20 launches at 16 MiB per
call, as phase 23 times it, with no rerun) and counts those that recorded
no kernel and those that recorded another number of launches;
``--after-hop`` first runs one session of 200 ``ring_shift2`` calls, as
phase 7 does.  One JSON line, with the environment's ``TEARDOWN_CUPTI``
(PyTorch tears CUPTI down between sessions where it is 1).  Card only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


SESSIONS = 3  # profiler sessions before a run that records nothing fails
RERUNS = []  # why each session was run again, for the callers' logs


def _session(fn, calls, device):
    """``calls`` calls of ``fn`` in one profiler session (CUPTI): the
    host-timed ms per call, the profiler's own cost included, and each
    kernel's (ms, launches) on the card, summed over the session."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, count = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3,
                              count + e.count)
    return wall_ms, kernels


def kernel_ms_by_group(fn, calls: int, group, device, expect=()):
    """Run ``fn`` once, then ``calls`` times under ``torch.profiler``;
    returns the host-timed ms per call, the profiler's own cost included,
    the card's kernel ms per call summed by ``group(name)``, largest first,
    and the launches recorded per call, by group.  A session that recorded
    no kernel, or no launch of a group in ``expect``, is run again, each
    rerun logged on stderr and kept in ``RERUNS``; after ``SESSIONS``
    sessions it raises.  Card only."""
    if device.type != "cuda":
        raise RuntimeError("the breakdown reads the card's kernel times")
    fn()
    torch.cuda.synchronize(device)
    for attempt in range(1, SESSIONS + 1):
        wall_ms, kernels = _session(fn, calls, device)
        groups, launches = {}, {}
        for name, (ms, count) in kernels.items():
            label = group(name)
            groups[label] = groups.get(label, 0.0) + ms / calls
            launches[label] = launches.get(label, 0) + count / calls
        missing = sorted(set(expect) - set(groups))
        if groups and not missing:
            return (wall_ms, dict(sorted(groups.items(),
                                         key=lambda kv: -kv[1])), launches)
        why = f"recorded no launch of {missing}" if groups \
            else "recorded no kernel"
        RERUNS.append(why)
        print(f"kernel_ms_by_group: session {attempt} of {SESSIONS} {why}",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler recorded no kernel it was to time in "
                       f"{SESSIONS} sessions")


def breakdown(fn, calls: int, group, device, top: int = 10):
    """``kernel_ms_by_group`` of ``fn`` by kernel name, summed by
    ``group(name)``: the host-timed and busy ms per call, the busy share,
    the ms per call by group, largest first, and the ``top`` kernels with
    their groups."""
    wall_ms, by_name, _ = kernel_ms_by_group(fn, calls, lambda name: name,
                                             device)
    groups = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    busy = sum(groups.values())
    return {"wall_ms_per_step": wall_ms, "busy_ms_per_step": busy,
            "busy_share": busy / wall_ms,
            "ms_per_step_by_group": dict(sorted(groups.items(),
                                                key=lambda kv: -kv[1])),
            "top_kernels": [(name[:120], group(name), ms) for name, ms in
                            list(by_name.items())[:top]]}


def time_calls(fn, calls: int, device):
    """``calls`` calls of ``fn`` (after none: warm up first): the ms per
    call, from CUDA events on the card (the host clock on the CPU, which
    times the plain versions), and the calls' results."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = [fn() for _ in range(calls)]
    if on_card:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls, out
    return (time.perf_counter() - t0) * 1e3 / calls, out


def time_each(fn, calls: int, device):
    """``calls`` calls of ``fn`` (after none: warm up first), each timed
    on its own: the ms of every call, from CUDA events recorded between
    the calls on the card (the host clock on the CPU), and the calls'
    results."""
    if device.type != "cuda":
        ms, out = [], []
        for _ in range(calls):
            t0 = time.perf_counter()
            out.append(fn())
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, out
    torch.cuda.synchronize(device)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    marks[0].record()
    out = []
    for mark in marks[1:]:
        out.append(fn())
        mark.record()
    marks[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=200)
    ap.add_argument("--after-hop", action="store_true",
                    help="one session of 200 ring_shift2 calls first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("_profile: needs a CUDA card")
    from mpi4jax_tpu_torch.ops import _collectives as coll, quantized
    from mpi4jax_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(23)
    x = torch.randn(4 * 1024 * 1024, generator=g).to(dev)
    quantized.quant_pack(x)
    if args.after_hop:
        comm = make_mesh(2, device=dev)
        a = torch.randn((2, 4, 902), generator=g).to(dev)
        coll.ring_shift2(a, a, comm)
        torch.cuda.synchronize(dev)
        _session(lambda: coll.ring_shift2(a, a, comm), 200, dev)
    empty = short = 0
    for _ in range(args.sessions):
        _, kernels = _session(lambda: quantized.quant_pack(x), 20, dev)
        got = sum(c for k, (_, c) in kernels.items()
                  if "quant_pack_kernel" in k)
        empty += not kernels
        short += bool(kernels) and got != 20
    print(json.dumps(dict(sessions=args.sessions, after_hop=args.after_hop,
                          teardown_cupti=os.environ.get("TEARDOWN_CUPTI"),
                          no_kernel=empty, fewer_launches=short,
                          torch=torch.__version__)))


if __name__ == "__main__":
    main()
