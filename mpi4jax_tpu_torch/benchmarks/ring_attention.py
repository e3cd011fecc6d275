"""Ring attention's forward on the flash route (path (d)).

The forward half of ``bench_flash_mfu`` in the repo's ``bench.py`` and of
``benchmarks/flash_sweep.py``: causal ring attention of a global
``(B, T, H, D)`` sequence split over ``--ranks`` ranks of a ``make_mesh``
comm on one card (``T_local = T / ranks``), through
``parallel.ring.ring_attention(impl="pallas")``: one launch of kernel 5 per
ring step, covering every rank, and one hop of k and v between steps.
After a warm-up forward, ``--iters`` forwards are timed with CUDA events.

    python -m mpi4jax_tpu_torch.benchmarks.ring_attention \\
        --shape 4 4096 16 128 --ranks 4 --json

The run prints one JSON line: ``ms_per_forward``, ``tflops`` (at
``2 * 2 * B * H * T^2 * D * 0.5`` flop, the causal half; null on the
CPU),
``flash_launches_per_forward`` and ``hop_launches_per_forward``,
``plain_ms`` (one forward on the plain route, the oracle) and
``max_abs_diff`` (the output against the plain route's), with the shape,
ranks, dtype and ``device``.  On the CPU (``--device cpu``) both routes are
the plain version, timed on the host clock; such a run measures nothing of
the card and launches no kernel.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops import _collectives, flash
from ..parallel.mesh import make_mesh
from ..parallel.ring import ring_attention
from ._profile import kernel_ms_by_group

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "f32": torch.float32}


def causal_flops(b: int, t: int, h: int, d: int) -> float:
    """Flop of one causal forward over the global sequence: two products
    of 2 * B * H * T^2 * D, half of them masked."""
    return 2 * 2 * b * h * t * t * d * 0.5


def shard(x, ranks: int):
    """A global ``(B, T, H, D)`` tensor on the mesh layout ``(ranks, B,
    T / ranks, H, D)``: rank r holds positions ``[r T/ranks, (r+1) T/ranks)``."""
    b, t, h, d = x.shape
    return x.reshape(b, ranks, t // ranks, h, d).transpose(0, 1).contiguous()


def unshard(x):
    """The inverse of ``shard``."""
    ranks, b, t, h, d = x.shape
    return x.transpose(0, 1).reshape(b, ranks * t, h, d)


def make_qkv(shape, dtype, device, seed: int = 0):
    """Global q, k and v ``(B, T, H, D)``, standard normal, made on
    ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((3, *shape), generator=g, device=device)
    return tuple(x[i].to(dtype) for i in range(3))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ms(fn, iters, dev):
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def run(shape=(4, 4096, 16, 128), ranks: int = 4, iters: int = 5,
        dtype=torch.bfloat16, *, device=None, seed: int = 0, qkv=None):
    """Time ``iters`` causal forwards after one warm-up; returns the record
    and the output ``(ranks, B, T/ranks, H, D)``.  ``qkv``: global q, k, v
    to use instead of ``make_qkv``'s."""
    b, t, h, d = shape
    if t % ranks:
        raise ValueError(f"T ({t}) must be divisible by the ranks ({ranks})")
    comm = make_mesh(ranks, device=device)
    dev = comm.device
    if qkv is None:
        qkv = make_qkv(shape, dtype, dev, seed)
    q, k, v = (shard(x, ranks) for x in qkv)

    def forward():
        return ring_attention(q, k, v, comm=comm, causal=True, impl="pallas")

    out = forward()  # warm-up: builds and loads the kernels
    _sync(dev)
    flash0 = flash.LAUNCHES["flash_fwd"]
    hop0 = _collectives.LAUNCHES["hop"]
    ms = _time_ms(forward, iters, dev)
    flash_n = flash.LAUNCHES["flash_fwd"] - flash0
    hop_n = _collectives.LAUNCHES["hop"] - hop0
    refs = []
    with _collectives.use_plain():
        plain_ms = _time_ms(lambda: refs.append(forward()), 1, dev)
    diff = (out.float() - refs[0].float()).abs().max().item()
    rec = {
        "ms_per_forward": ms,
        # a rate of the card only: a CPU run times the plain version
        "tflops": (causal_flops(b, t, h, d) / (ms * 1e-3) / 1e12
                   if dev.type == "cuda" else None),
        "flash_launches_per_forward": flash_n / iters,
        "hop_launches_per_forward": hop_n / iters,
        "plain_ms": plain_ms,
        "max_abs_diff": diff,
        "shape": list(shape), "ranks": ranks, "t_local": t // ranks,
        "dtype": str(dtype).replace("torch.", ""), "causal": True,
        "iters": iters,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    return rec, out


KERNEL_GROUPS = (
    ("flash_fwd", "kernel 5"),
    ("hop_kernel", "hop"),
    ("direct_copy", "copies: the (B, T, H, D) to (B H, T, D) transposes, "
                    "the casts"),
)


def _group(name: str) -> str:
    for key, label in KERNEL_GROUPS:
        if key in name:
            return label
    return "elementwise: the (o, m, l) combine, o / l, q x scale"


def device_profile(shape=(4, 4096, 16, 128), ranks: int = 4,
                   forwards: int = 3, dtype=torch.bfloat16, *, device=None,
                   qkv=None):
    """Where a forward's time goes on the card: kernel time per forward by
    group (``KERNEL_GROUPS``; ``torch.profiler``, CUPTI) and the share of
    the host-timed window in which the card was busy, the profiler's own
    cost included.  Card only."""
    comm = make_mesh(ranks, device=device)
    if qkv is None:
        qkv = make_qkv(shape, dtype, comm.device)
    q, k, v = (shard(x, ranks) for x in qkv)
    wall_ms, groups = kernel_ms_by_group(
        lambda: ring_attention(q, k, v, comm=comm, causal=True,
                               impl="pallas"),
        forwards, _group, comm.device)
    busy_ms = sum(groups.values())
    return {"ranks": ranks, "shape": list(shape),
            "wall_ms_per_forward": wall_ms, "busy_ms_per_forward": busy_ms,
            "busy_share": busy_ms / wall_ms, "ms_per_forward_by_group": groups}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[4, 4096, 16, 128],
                    metavar=("B", "T", "H", "D"),
                    help="the global shape (default 4 4096 16 128)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain version")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    rec, _ = run(tuple(args.shape), args.ranks, args.iters,
                 DTYPES[args.dtype], device=args.device, seed=args.seed)
    if not args.json:
        print(f"ring attention forward {tuple(args.shape)} over "
              f"{args.ranks} ranks on {rec['device']}: "
              f"{rec['ms_per_forward']:.4f} ms per forward")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
