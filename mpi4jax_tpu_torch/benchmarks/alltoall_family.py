"""The alltoall family on the mesh tier at n = 4 on one card (path (j)).

Three layers whose exchanges ride the alltoall kernel (kernel 2):

- **Ulysses attention** (``parallel/ulysses.py``) at path (d)'s shapes,
  B4 T4096 H16 D128 bf16 causal, the sequence cut over the ranks: the
  forward (4 alltoall launches: q, k and v to heads, the output back), and
  the forward and backward (4 more);
- **``moe_ffn``** (``parallel/moe.py``) at d_model 768, d_ff 3072, 4
  experts (one a rank), 8192 f32 tokens a rank, capacity factor 1.25
  (capacity 2560): the forward and backward (2 alltoall launches each
  way);
- **``allreduce(compression="int8")``** (``ops/quantized.py``'s mesh
  schedule: one alltoall and the all-gather's 3 hops) at 16 and 64 MiB of
  f32 a rank, beside the exact allreduce (the fused ring) at the same
  size, with the median and largest error against it.

Inputs are drawn from ``--seed``.  Each layer is timed with CUDA events
(one warm-up call, then ``--reps``), its launches counted over one call,
and ``route_check`` holds one call on the kernel route bit for bit to one
on the plain route (``_collectives.use_plain()``), the collectives being
the only difference.

    python -m mpi4jax_tpu_torch.benchmarks.alltoall_family --json

One JSON line per layer, keyed by name: ``ms`` per call, the reckoned
``bound_ms`` and what bounds it, the launches per call, the route check,
and ``device``.  To try the path on the CPU, call the functions with the
small shapes ``chip_smoke.py --rehearse`` uses.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import SUM, _collectives, allreduce
from ..parallel import moe
from ..parallel.mesh import make_mesh
from ..parallel.ulysses import ulysses_attention
from ._profile import time_calls

RANKS = 4
ULYSSES = (4, 4096, 16, 128)  # B, T, H, D
MOE = dict(d_model=768, d_ff=3072, tokens=8192, capacity_factor=1.25)
INT8_BYTES = (16 * 1024 * 1024, 64 * 1024 * 1024)
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
COLLECTIVES = ("hop", "fused_ring", "alltoall")


def counts():
    return {k: _collectives.LAUNCHES[k] for k in COLLECTIVES}


def _launches(fn):
    before = counts()
    fn()
    after = counts()
    return {k: after[k] - before[k] for k in after}


def _equal(a, b) -> bool:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def route_check(fn):
    """``fn()`` on the kernel route and on the plain route: whether every
    output is bit for bit the same."""
    got = fn()
    with _collectives.use_plain():
        ref = fn()
    return _equal(got, ref)


def _device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def ulysses_inputs(shape, ranks, dtype, device, seed):
    """q, k, v and dO ``(ranks, B, T / ranks, H, D)``, standard normal
    drawn from ``seed``, each rank holding its sequence chunk."""
    b, t, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((4, b, ranks, t // ranks, h, d), generator=g,
                    device=device)
    x = x.movedim(2, 1).to(dtype).contiguous()
    return x.unbind(0)


def run_ulysses(shape=ULYSSES, ranks=RANKS, reps: int = 3, *,
                dtype=torch.bfloat16, device=None, seed: int = 0):
    """Ulysses attention's forward, and its forward and backward."""
    comm = make_mesh(ranks, device=device)
    dev = comm.device
    q, k, v, do = ulysses_inputs(shape, ranks, dtype, dev, seed)

    def fwd():
        return ulysses_attention(q, k, v, comm=comm, causal=True)

    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        out = ulysses_attention(qg, kg, vg, comm=comm, causal=True)
        return torch.autograd.grad(out, (qg, kg, vg), do)

    b, t, h, d = shape
    flops = 4.0 * b * h * t * t * d  # the two f32 products, unmasked
    fwd()
    fwd_ms, _ = time_calls(fwd, reps, dev)
    fwd_bwd()
    fwd_bwd_ms, _ = time_calls(fwd_bwd, reps, dev)
    return {
        "ms_forward": fwd_ms, "ms_forward_backward": fwd_bwd_ms,
        "bound_ms_forward": flops / F32_FLOPS_PER_S * 1e3,
        "bound_ms_forward_backward": 3 * flops / F32_FLOPS_PER_S * 1e3,
        "bound_by": "operations (the f32 score and value products over the "
                    "whole T x T, at the f32 peak outside the tensor cores)",
        "launches_forward": _launches(fwd),
        "launches_forward_backward": _launches(fwd_bwd),
        "bit_equal_forward": route_check(fwd),
        "bit_equal_forward_backward": route_check(fwd_bwd),
        "finite": bool(torch.isfinite(fwd().float()).all()),
        "shape": list(shape), "ranks": ranks, "dtype": str(dtype),
        "device": _device_name(dev),
    }


def moe_inputs(cfg, ranks, device, seed):
    """The tokens ``(ranks, tokens, d_model)`` and the cotangent, standard
    normal from ``seed``, and the parameters from
    ``moe.init_moe_params(..., seed)`` (leaves requiring grad)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((2, ranks, cfg["tokens"], cfg["d_model"]), generator=g,
                    device=device)
    params = moe.params_from_numpy(moe.init_moe_params(
        cfg["d_model"], cfg["d_ff"], ranks, seed), device)
    return x[0], x[1], {k: p.requires_grad_() for k, p in params.items()}


def run_moe(cfg=MOE, ranks=RANKS, reps: int = 3, *, device=None,
            seed: int = 0):
    """``moe_ffn``'s forward and backward."""
    comm = make_mesh(ranks, device=device)
    dev = comm.device
    x, dy, params = moe_inputs(cfg, ranks, dev, seed)
    xg = x.clone().requires_grad_()
    leaves = (xg, *params.values())

    def fwd_bwd():
        y = moe.moe_ffn(xg, params, comm=comm,
                        capacity_factor=cfg["capacity_factor"])
        return (y.detach(), *torch.autograd.grad(y, leaves, dy))

    cap = moe.expert_capacity(cfg["tokens"], ranks, cfg["capacity_factor"])
    # the experts' two products on every slot, and the gate's
    flops = 2.0 * ranks * (ranks * cap * 2 * cfg["d_model"] * cfg["d_ff"]
                           + cfg["tokens"] * cfg["d_model"] * ranks)
    fwd_bwd()
    ms, _ = time_calls(fwd_bwd, reps, dev)
    with torch.no_grad():
        idx, _, _ = moe.router_top1(x, params["w_gate"])
        kept = sum(min(int((idx[r] == e).sum()), cap)
                   for r in range(ranks) for e in range(ranks))
    return {
        "ms_forward_backward": ms,
        "bound_ms_forward_backward": 3 * flops / F32_FLOPS_PER_S * 1e3,
        "bound_by": "operations (every slot's two expert products and the "
                    "gate, x 3, at the f32 peak outside the tensor cores)",
        "launches_forward_backward": _launches(fwd_bwd),
        "bit_equal_forward_backward": route_check(fwd_bwd),
        "capacity": cap, "tokens_kept": kept,
        "tokens_total": ranks * cfg["tokens"],
        "finite": bool(torch.isfinite(fwd_bwd()[0]).all()),
        "ranks": ranks, **cfg, "device": _device_name(dev),
    }


def run_int8(nbytes=INT8_BYTES, ranks=RANKS, reps: int = 5, *, device=None,
             seed: int = 0):
    """The quantized allreduce beside the exact one, per size."""
    comm = make_mesh(ranks, device=device)
    dev = comm.device
    out = {}
    for size in nbytes:
        count = size // 4
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((ranks, count), generator=g, device=dev)

        def exact():
            return allreduce(x, op=SUM, comm=comm)

        def int8():
            return allreduce(x, op=SUM, comm=comm, compression="int8")

        e, a = exact(), int8()
        err = (a - e).abs()
        rel = err / e.abs().clamp_min(1e-3)
        exact_ms, _ = time_calls(exact, reps, dev)
        int8_ms, _ = time_calls(int8, reps, dev)
        out[f"{size}"] = {
            "ms": int8_ms, "exact_ms": exact_ms,
            # each rank's f32 input read once and its f32 output written once
            "bound_ms": 2 * 4 * count * ranks / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "median_rel_err": float(rel.median()),
            "max_abs_err_over_max": float(err.max() / e.abs().max()),
            "launches": _launches(int8),
            "exact_launches": _launches(exact),
            "bit_equal": route_check(int8),
            "bytes_per_rank": size,
        }
    out["device"] = _device_name(dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    rec = {
        "ulysses": run_ulysses(reps=args.reps, device=args.device,
                               seed=args.seed),
        "moe": run_moe(reps=args.reps, device=args.device, seed=args.seed),
        "int8": run_int8(reps=args.reps, device=args.device, seed=args.seed),
    }
    if not args.json:
        u, m = rec["ulysses"], rec["moe"]
        print(f"Ulysses {u['ms_forward']:.3f} / {u['ms_forward_backward']:.3f}"
              f" ms, MoE {m['ms_forward_backward']:.3f} ms on {u['device']}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
