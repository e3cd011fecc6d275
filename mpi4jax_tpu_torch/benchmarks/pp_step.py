"""The pipeline-parallel GPT-2 124M train step on the port (path (i)).

BASELINE.md's "Pipeline-parallel GPT-2 124M via point-to-point": GPT-2
124M at full width (vocab 50304, d_model 768, 12 heads of 64, 12 layers,
d_ff 3072, max_seq 1024) in f32, as the JAX model computes it, M = 4
microbatches of 2 sequences of 1024 tokens (8192 tokens a step, path (f)'s
count), SGD at lr 3e-4, weights from ``init_params`` at ``--seed`` and
tokens drawn from it.  ``--pp`` stages share one card; at pp = 4 each
step runs ``M + pp - 1 = 7`` ticks of every stage at once, each ending in
one hop launch (``sendrecv`` along ``[(i, i + 1)]``), and autograd's
reverse hops in the backward.  After one warm-up step, ``--steps`` steps
are timed with CUDA events.

    python -m mpi4jax_tpu_torch.benchmarks.pp_step --pp 4 --json

One JSON line: ``ms_per_step``, ``tokens_per_s``, the reckoned bound
(``bound_ms``: ``6 N B T`` times ``(M + pp - 1) / M``, the masked share of
the schedule's compute, at the f32 peak outside the tensor cores), the
``losses`` of the timed steps, the hop and fused-ring launches per step
beside ``expected_launches``, the peak memory and ``device``.
``--profile`` adds the card's kernel time per step by group;
``--route-check`` holds one step on the kernel route bit for bit to one on
the plain route.  To try the path on the CPU, call ``run`` with a small
``GPTConfig``, as ``chip_smoke.py --rehearse`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ..models import pp_transformer as ppm
from ..ops import _collectives
from ._profile import breakdown, time_calls

CFG = ppm.GPTConfig(vocab=50304, d_model=768, n_heads=12, n_layers=12,
                    d_ff=3072, max_seq=1024, dtype="float32")
MICRO, BATCH, SEQ, LR = 4, 2, 1024, 3e-4
PPS = (1, 4)
COLLECTIVES = ("hop", "fused_ring")
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores, published


def make_tokens(micro, batch, seq, vocab, seed, device):
    """``(micro, batch, seq)`` int32 tokens drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, vocab, (micro, batch, seq))
                            .astype(np.int32)).to(device)


def counts():
    return {k: _collectives.LAUNCHES[k] for k in COLLECTIVES}


def expected_launches(cfg, pp, micro) -> dict:
    """Hop and fused-ring launches of one step: a hop per tick in the
    forward, one per tick but the last in the backward (autograd runs no
    reverse hop for the last tick's handoff, which nothing reads), the
    loss's SUM over pp and its gradient, and each replicated field's
    gradient SUM."""
    out = {k: 0 for k in COLLECTIVES}
    if pp > 1:
        ticks = micro + pp - 1
        out["hop"] = ticks + ticks - 1
    counts_ = [1, 1, cfg.vocab * cfg.d_model, cfg.max_seq * cfg.d_model,
               2 * cfg.d_model]  # the loss, its gradient, wte, wpe, lnf
    for n in counts_:
        for k, v in _collectives.allreduce_launches(n, pp).items():
            out[k] += v
    return out


def run(pp=1, steps: int = 3, *, cfg=CFG, micro: int = MICRO,
        batch: int = BATCH, seq: int = SEQ, device=None, seed: int = 0):
    """One warm-up step and ``steps`` timed ones; returns the record and
    the model."""
    model = ppm.PPGPT(cfg, pp, device=device, seed=seed)
    dev = model.device
    toks = make_tokens(micro, batch, seq, cfg.vocab, seed, dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    model.train_step(toks, lr=LR)  # warm-up: builds and loads the kernels
    before = counts()
    ms, losses = time_calls(lambda: model.train_step(toks, lr=LR), steps,
                            dev)
    after = counts()
    n = sum(x.numel() for x in model.global_params())
    tokens = micro * batch * seq
    flops = 6.0 * n * tokens * (micro + pp - 1) / micro
    rec = {
        "ms_per_step": ms,
        "tokens_per_s": tokens / (ms * 1e-3),
        "bound_ms": flops / F32_FLOPS_PER_S * 1e3,
        "bound_by": "operations (6 N B T x (M + pp - 1) / M at the f32 "
                    "peak outside the tensor cores, 67 TFLOP/s)",
        "masked_share": (pp - 1) / (micro + pp - 1),
        "params_M": n / 1e6,
        "losses": [float(v) for v in losses],
        "launches_per_step": {k: (after[k] - before[k]) / steps
                              for k in after},
        "expected_launches": expected_launches(cfg, pp, micro),
        "peak_memory_GB": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if on_card else None),
        "pp": pp, "micro": micro, "batch": batch, "seq": seq,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "steps": steps,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    return rec, (model, toks)


def route_check(cfg, pp, *, micro=MICRO, batch=BATCH, seq=SEQ, device=None,
                seed: int = 0):
    """One step on the kernel route against one on the plain route
    (``_collectives.use_plain()``) from the same weights and tokens: the
    routes differ only in the hops and allreduces, which are bit for bit
    their plain versions, so the loss and every updated parameter must be
    too.  Returns both losses, ``bit_equal``, the largest difference and
    the kernel route's launches."""
    init = ppm.init_params(cfg, pp, seed)
    res = {}
    for route in ("kernel", "plain"):
        model = ppm.PPGPT(cfg, pp, init, device=device)
        toks = make_tokens(micro, batch, seq, cfg.vocab, seed, model.device)
        before = counts()
        with (_collectives.use_plain() if route == "plain"
              else contextlib.nullcontext()):
            loss = float(model.train_step(toks, lr=LR))
        after = counts()
        res[route] = dict(loss=loss, params=model.global_params(),
                          launches={k: after[k] - before[k] for k in after})
        del model
    k, p = res["kernel"], res["plain"]
    equal = k["loss"] == p["loss"] and all(
        torch.equal(a, b) for a, b in zip(k["params"], p["params"]))
    diff = max((a - b).abs().max().item()
               for a, b in zip(k["params"], p["params"]))
    return {"loss_kernel": k["loss"], "loss_plain": p["loss"],
            "bit_equal": equal, "max_abs_diff": diff,
            "launches": k["launches"]}


def group(name: str) -> str:
    """A kernel's group: the port's collectives by name, the f32 matrix
    products (CUDA-core sgemm), the softmaxes, and the rest."""
    low = name.lower()
    if "hop_kernel" in low:
        return "hop"
    if "fused_ring" in low:
        return "fused ring"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "f32 matmuls"
    if "softmax" in low:
        return "softmax and log-softmax"
    return "elementwise and the rest"


def profile(model, toks, steps: int = 2, top: int = 10):
    """The card's kernel time per step by ``group``, the ``top`` kernels,
    and the busy share of the host-timed window."""
    return breakdown(lambda: model.train_step(toks, lr=LR), steps, group,
                     model.device, top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--route-check", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    rec, (model, toks) = run(args.pp, args.steps, device=args.device,
                             seed=args.seed)
    if args.profile:
        rec["profile"] = profile(model, toks)
    del model
    if args.route_check:
        rec["route_check"] = route_check(CFG, args.pp, device=args.device,
                                         seed=args.seed)
    if not args.json:
        print(f"PP GPT-2 124M step, pp={args.pp}, {rec['device']}: "
              f"{rec['ms_per_step']:.2f} ms per step, "
              f"{rec['tokens_per_s']:.0f} tokens/s")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
