"""Ring attention on the flash route: the forward (path (d)) and the
forward and backward (path (e), ``--backward``).

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

``--backward`` is path (e), the second half of ``bench_flash_mfu``: each
timed step is a forward and a backward (``out.backward(dO)``, dO standard
normal from the seed), one launch each of kernels 6 and 7 per ring step and
n hops of k, v, dk and dv (none at n = 1).  Its line has ``ms_per_step``,
``tflops`` at the JAX package's convention of 3.5 x the causal forward's
flop, the launches of kernels 5, 6 and 7 and the hops per step and in
all (``launches``: the warm-up's and the timed steps'), ``plain_ms``, ``max_abs_diff`` of the gradients against the plain route's,
``grad_errors`` (the f32 gradients against the plain route's over each
component's noise scale, ``_flash_check.bwd_errors``, with ``TOL_BWD``
beside them and ``within`` true when they are inside it),
``grads_are_f32_cast`` (the timed step's gradients are those f32 gradients
cast, bit for bit) and ``sdpa_ms``, the time of
``scaled_dot_product_attention(is_causal=True)`` forward and backward on
the same tensors (the library yardstick; null on the CPU).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops import _collectives, flash
from ..ops import _flash_check as chk
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


# the JAX package's flop convention of a forward and backward
# (bench.py's bench_flash_mfu): 3.5 forwards
FWD_BWD_FLOP_FACTOR = 3.5


def sdpa_fwd_bwd_ms(qkv, do, iters):
    """``scaled_dot_product_attention(is_causal=True)`` forward and
    backward on the global ``(B, T, H, D)`` tensors, ms per step on the
    card (CUDA events, after a warm-up): the library yardstick."""
    q, k, v = (x.transpose(1, 2).detach().requires_grad_() for x in qkv)
    g = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def step():
        for x in (q, k, v):
            x.grad = None
        sdpa(q, k, v, is_causal=True).backward(g)

    step()
    return _time_ms(step, iters, q.device)


def run_backward(shape=(4, 4096, 16, 128), ranks: int = 4, iters: int = 5,
                 dtype=torch.bfloat16, *, device=None, seed: int = 0,
                 qkv=None):
    """Time ``iters`` causal forward-and-backward steps after one warm-up
    (kernels 5, 6 and 7: ``ranks`` launches each per step); returns the
    record and the last timed step's gradients ``(dq, dk, dv)``, each
    ``(ranks, B, T/ranks, H, D)``.  The record holds those gradients
    against the plain route's (``_flash_check.ring_grad_check``, which runs
    both routes again): ``grad_errors`` over their noise, whether they are
    ``within`` ``TOL_BWD``, and whether they are the f32 gradients cast bit
    for bit (``grads_are_f32_cast``)."""
    b, t, h, d = shape
    if t % ranks:
        raise ValueError(f"T ({t}) must be divisible by the ranks ({ranks})")
    comm = make_mesh(ranks, device=device)
    dev = comm.device
    if qkv is None:
        qkv = make_qkv(shape, dtype, dev, seed)
    do_global = make_qkv(shape, dtype, dev, seed + 1)[0]
    do = shard(do_global, ranks)
    q, k, v = (shard(x, ranks).requires_grad_() for x in qkv)

    def step():
        for x in (q, k, v):
            x.grad = None
        ring_attention(q, k, v, comm=comm, causal=True,
                       impl="pallas").backward(do)
        return tuple(x.grad for x in (q, k, v))

    def counts():
        return [flash.LAUNCHES[n] for n in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] + [
                    _collectives.LAUNCHES["hop"]]

    start = counts()
    step()  # warm-up: builds and loads the kernels
    _sync(dev)
    before = counts()
    ms = _time_ms(step, iters, dev)
    end = counts()
    per = [(a - bf) / iters for a, bf in zip(end, before)]
    grads = tuple(x.grad.clone() for x in (q, k, v))  # the last timed step's
    refs = []
    with _collectives.use_plain():
        plain_ms = _time_ms(lambda: refs.append(
            tuple(g.clone() for g in step())), 1, dev)
    diff = max((g.float() - r.float()).abs().max().item()
               for g, r in zip(grads, refs[0]))
    on_card = dev.type == "cuda"
    rec = {
        "ms_per_step": ms,
        "tflops": (FWD_BWD_FLOP_FACTOR * causal_flops(b, t, h, d)
                   / (ms * 1e-3) / 1e12 if on_card else None),
        "flash_fwd_launches_per_step": per[0],
        "flash_bwd_dq_launches_per_step": per[1],
        "flash_bwd_dkv_launches_per_step": per[2],
        "hop_launches_per_step": per[3],
        # the warm-up's and the timed steps', before the check's
        "launches": dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                              "hop"), (a - b for a, b in zip(end, start)))),
        "plain_ms": plain_ms,
        "max_abs_diff": diff,
        "shape": list(shape), "ranks": ranks, "t_local": t // ranks,
        "dtype": str(dtype).replace("torch.", ""), "causal": True,
        "iters": iters,
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
    }
    check = chk.ring_grad_check(*(x.detach() for x in (q, k, v)), do, comm,
                                True, grads)
    rec["grads_are_f32_cast"] = check.pop("grads_are_f32_cast")
    rec["within"] = check.pop("within")
    rec["grad_errors"] = check
    rec["tol_bwd"] = chk.TOL_BWD[dtype]
    rec["sdpa_ms"] = (sdpa_fwd_bwd_ms(qkv, do_global, iters) if on_card
                      else None)
    return rec, grads


KERNEL_GROUPS = (
    ("flash_fwd", "kernel 5"),
    ("flash_bwd_dq", "kernel 6"),
    ("flash_bwd_dkv", "kernel 7"),
    ("hop_kernel", "hop"),
    ("direct_copy", "copies: the (B, T, H, D) to (B H, T, D) transposes, "
                    "the casts"),
)


def _group(name: str) -> str:
    for key, label in KERNEL_GROUPS:
        if key in name:
            return label
    return ("elementwise: the (o, m, l) combine, o / l, q x scale, delta, "
            "the gradients' sums and casts")


def device_profile(shape=(4, 4096, 16, 128), ranks: int = 4,
                   forwards: int = 3, dtype=torch.bfloat16, *, device=None,
                   qkv=None, backward: bool = False):
    """Where a forward's time goes on the card (with ``backward``, a
    forward-and-backward step's): kernel time per call by group
    (``KERNEL_GROUPS``; ``torch.profiler``, CUPTI) and the share of the
    host-timed window in which the card was busy, the profiler's own cost
    included.  Card only."""
    comm = make_mesh(ranks, device=device)
    if qkv is None:
        qkv = make_qkv(shape, dtype, comm.device)
    q, k, v = (shard(x, ranks).requires_grad_(backward) for x in qkv)
    do = shard(qkv[0], ranks)

    def call():
        out = ring_attention(q, k, v, comm=comm, causal=True, impl="pallas")
        if backward:
            for x in (q, k, v):
                x.grad = None
            out.backward(do)

    wall_ms, groups, _ = kernel_ms_by_group(call, forwards, _group,
                                            comm.device)
    busy_ms = sum(groups.values())
    return {"ranks": ranks, "shape": list(shape), "backward": backward,
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
    ap.add_argument("--backward", action="store_true",
                    help="path (e): time forward and backward steps")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    runner = run_backward if args.backward else run
    rec, _ = runner(tuple(args.shape), args.ranks, args.iters,
                    DTYPES[args.dtype], device=args.device, seed=args.seed)
    if not args.json:
        what, key = (("forward and backward", "ms_per_step") if args.backward
                     else ("forward", "ms_per_forward"))
        print(f"ring attention {what} {tuple(args.shape)} over "
              f"{args.ranks} ranks on {rec['device']}: "
              f"{rec[key]:.4f} ms per call")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
