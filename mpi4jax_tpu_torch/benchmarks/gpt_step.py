"""The GPT-2 124M train step on the port (path (f)).

``bench.py``'s ``bench_gpt2_step`` configuration, unchanged: GPT-2 124M
(vocab 50304, d_model 768, 12 heads of 64, 12 layers, d_ff 3072, max_seq
1024) in bf16 compute, B8 T1024, AdamW (``optax.adamw(3e-4)``'s
defaults), weights from ``init_params`` at ``--seed`` and tokens drawn from
it.  ``GPT.train_step`` runs on a ``(dp, tp, sp)`` mesh layout on one card:
``(1, 1, 1)`` is ``bench.py``'s, ``(1, 2, 2)`` puts real traffic on tp
(the row-parallel allreduces, on the hop) and on the sp ring (ring
attention over 2 ranks).  Every layer's attention runs kernels 5, 6 and 7,
one launch each per ring step covering every rank.  After one warm-up step
(the kernels' build), ``--steps`` steps are timed with CUDA events.

    python -m mpi4jax_tpu_torch.benchmarks.gpt_step --mesh 1 2 2 --json

One JSON line: ``ms_per_step``, ``tokens_per_s``, ``model_tflops`` (at
``6 N B T``, N the parameters of the global model), ``params_M``, the
``losses`` of the timed steps (finite), the launches per step of kernels 5,
6 and 7 and of the hop and fused ring, the mesh, the configuration and the
``device``.  ``--profile`` adds the card's kernel time per step by group
(``torch.profiler``) and the kernels that take the most.  ``route_check``
holds one step on the kernel route to one on the plain route
(``ROUTE_TOL``).  ``--device cpu``
runs the plain versions at the full size; to try the path on the CPU,
call ``run`` with a small ``GPTConfig``, as ``chip_smoke.py --rehearse``
does.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ..models.transformer import GPT, GPTConfig, GPTParams, init_params
from ..ops import _collectives, flash
from ..parallel.mesh import MeshComm
from ._profile import breakdown, time_calls

CFG = GPTConfig(vocab=50304, d_model=768, n_heads=12, n_layers=12,
                d_ff=3072, max_seq=1024, dtype="bfloat16")
BATCH, SEQ = 8, 1024
MESHES = ((1, 1, 1), (1, 2, 2))
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
COLLECTIVES = ("hop", "fused_ring")


def make_tokens(batch, seq, vocab, seed, device):
    """``(batch, seq)`` int32 tokens drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, vocab, (batch, seq)).astype(
        np.int32)).to(device)


def attention_inputs(cfg, mesh, batch, seq, seed, device):
    """Standard normal q, k, v and dO in the compute dtype, shaped as one
    layer's attention on ``mesh``'s sp ring in ``GPT._block``, ``(dp, tp,
    sp, B/dp, T/sp, H/tp, D)``, drawn from ``seed``, and the ring's comm
    (``GPT.sp_comm``'s): the shapes and offsets at which a step launches
    kernels 5, 6 and 7."""
    dp, tp, sp = mesh
    comm = MeshComm("sp", device=device,
                    layout=(("dp", dp), ("tp", tp), ("sp", sp)))
    g = torch.Generator(device=comm.device).manual_seed(seed)
    x = torch.randn((4, dp, tp, sp, batch // dp, seq // sp,
                     cfg.n_heads // tp, cfg.d_model // cfg.n_heads),
                    generator=g, device=comm.device)
    return (*x.to(getattr(torch, cfg.dtype)).unbind(0), comm)


def counts():
    """The launch counters of the kernels on the path."""
    return {**{k: flash.LAUNCHES[k] for k in FLASH},
            **{k: _collectives.LAUNCHES[k] for k in COLLECTIVES}}


def param_count(model) -> int:
    """The parameters of the global model (not its per-rank copies)."""
    return sum(x.numel() for x in model.global_params())


def run(mesh=(1, 1, 1), steps: int = 3, *, cfg=CFG, batch: int = BATCH,
        seq: int = SEQ, device=None, seed: int = 0):
    """One warm-up step and ``steps`` timed ones; returns the record and
    the model."""
    model = GPT(cfg, mesh, device=device, seed=seed)
    dev = model.device
    toks = make_tokens(batch, seq, cfg.vocab, seed, dev)
    model.train_step(toks)  # warm-up: builds and loads the kernels
    before = counts()
    on_card = dev.type == "cuda"
    ms, losses = time_calls(lambda: model.train_step(toks), steps, dev)
    after = counts()
    n = param_count(model)
    rec = {
        "ms_per_step": ms,
        "tokens_per_s": batch * seq / (ms * 1e-3),
        # a rate of the card only: a CPU run times the plain versions
        "model_tflops": (6 * n * batch * seq / (ms * 1e-3) / 1e12
                         if on_card else None),
        "params_M": n / 1e6,
        "losses": [float(x) for x in losses],
        "launches_per_step": {k: (after[k] - before[k]) / steps
                              for k in after},
        "mesh": list(model.mesh), "batch": batch, "seq": seq,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "steps": steps,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    return rec, model


# one step on the kernel route against one on the plain route, by compute
# dtype: the loss (relative), and each field's synced gradient and its
# AdamW update (relative L2).  The routes differ in attention's rounding
# (kernels 5-7 against their plain versions), which reaches every gradient
# through the layers; AdamW's first step moves an element by
# lr g / (|g| + eps), so an element whose gradient is within that rounding
# of 0 can flip its update by 2 lr, and the update's bound is the looser
# one.  In f32 the kernels round nothing that the plain versions do not.
# PERF.md gives the sound readings and those of planted kernel faults
# (``flash_tolerance --part gpt``) beside these limits.
ROUTE_TOL = {"bfloat16": {"loss": 1e-3, "grad": 5e-2, "update": 0.25},
             "float32": {"loss": 1e-5, "grad": 1e-3, "update": 1e-2}}


def rel_l2(a, b) -> float:
    """``||a - b|| / ||b||`` in f64 (the norm of the difference when b is
    0)."""
    a, b = a.double(), b.double()
    den = b.norm().item()
    num = (a - b).norm().item()
    return num / den if den else num


def route_check(cfg, mesh, toks, *, device=None, seed: int = 0):
    """One train step on the kernel route against one on the plain route
    (``_collectives.use_plain()``), from the same weights (``init_params``
    at ``seed``) and tokens.  Returns the two losses and ``loss_rel``,
    per field the relative L2 of the synced gradient over every rank
    (``grad_rel``) and of the AdamW update of the global parameters
    (``update_rel``), their worst (``worst_grad``, ``worst_update``), the
    kernel route's launches of kernels 5, 6 and 7 (``launches``), and
    ``within``: all inside ``ROUTE_TOL[cfg.dtype]``."""
    init = init_params(cfg, mesh[1], seed)
    res = {}
    for route in ("kernel", "plain"):
        model = GPT(cfg, mesh, init, device=device)
        before = counts()
        with (_collectives.use_plain() if route == "plain"
              else contextlib.nullcontext()):
            loss = float(model.train_step(toks))
        after = counts()
        after_params = model.global_params()
        res[route] = dict(
            loss=loss, launches={k: after[k] - before[k] for k in FLASH},
            grads={f: getattr(model, f).grad for f in GPTParams._fields},
            upd={f: getattr(after_params, f) - torch.as_tensor(
                getattr(init, f), device=model.device)
                for f in GPTParams._fields})
        del model
    k, p = res["kernel"], res["plain"]
    out = {"loss_kernel": k["loss"], "loss_plain": p["loss"],
           "loss_rel": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
           "grad_rel": {f: rel_l2(k["grads"][f], p["grads"][f])
                        for f in GPTParams._fields},
           "update_rel": {f: rel_l2(k["upd"][f], p["upd"][f])
                          for f in GPTParams._fields},
           "launches": k["launches"]}
    out["worst_grad"] = max(out["grad_rel"].values())
    out["worst_update"] = max(out["update_rel"].values())
    tol = ROUTE_TOL[cfg.dtype]
    out["within"] = (out["loss_rel"] <= tol["loss"]
                     and out["worst_grad"] <= tol["grad"]
                     and out["worst_update"] <= tol["update"])
    return out


GROUPS = (
    ("flash_fwd", "kernel 5"),
    ("flash_bwd_dq", "kernel 6"),
    ("flash_bwd_dkv", "kernel 7"),
    ("hop_kernel", "hop"),
    ("fused_ring", "fused ring"),
)


def group(name: str) -> str:
    """A kernel's group: the port's kernels by name, then the matrix
    products by type (f32, CUDA-core sgemm: the tied head; the others, the
    tensor cores' nvjet and bf16 kernels: the projections and the MLP),
    AdamW, the log-softmax, and the rest."""
    for key, label in GROUPS:
        if key in name:
            return label
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return ("f32 matmuls: the tied head"
                if "sgemm" in low or "f32f32" in low
                else "bf16 matmuls: projections, MLP")
    if "adam" in low or "multi_tensor" in low:
        return "AdamW"
    if "softmax" in low:
        return "log-softmax"
    return "elementwise and the rest"


def profile(model, toks, steps: int = 2, top: int = 12):
    """The card's kernel time per step by ``group`` (``torch.profiler``),
    the ``top`` kernels by time with their groups, and the busy share of
    the host-timed window."""
    return breakdown(lambda: model.train_step(toks), steps, group,
                     model.device, top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", type=int, nargs=3, default=[1, 1, 1],
                    metavar=("DP", "TP", "SP"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    rec, model = run(tuple(args.mesh), args.steps, device=args.device,
                     seed=args.seed)
    if args.profile:
        rec["profile"] = profile(model, make_tokens(
            BATCH, SEQ, CFG.vocab, args.seed, model.device))
    if not args.json:
        print(f"GPT-2 124M step on mesh {tuple(args.mesh)}, {rec['device']}: "
              f"{rec['ms_per_step']:.2f} ms per step, "
              f"{rec['tokens_per_s']:.0f} tokens/s")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
