"""Kernel time by group on the card, for the benchmarks' breakdowns."""

from __future__ import annotations

import time

import torch


def kernel_ms_by_group(fn, calls: int, group, device):
    """Run ``fn`` once, then ``calls`` times under ``torch.profiler``
    (CUPTI); returns the host-timed ms per call, the profiler's own cost
    included, and the card's kernel ms per call summed by ``group(name)``,
    largest first.  Card only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        raise RuntimeError("the breakdown reads the card's kernel times")
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    groups = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            label = group(e.key)
            groups[label] = (groups.get(label, 0.0)
                             + e.self_device_time_total / calls / 1e3)
    return wall_ms, dict(sorted(groups.items(), key=lambda kv: -kv[1]))
