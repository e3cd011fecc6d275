"""Train the dp x tp x sp GPT on synthetic data (demo CLI of the port).

The counterpart of ``examples/train_gpt.py``, by default on the card:

    python -m mpi4jax_tpu_torch.examples.train_gpt --mesh 1 2 2 --steps 20

    # on the CPU (ring attention takes its plain recurrence there)
    python -m mpi4jax_tpu_torch.examples.train_gpt --device cpu \\
        --mesh 2 2 2 --steps 3 --seq 64 --batch 4

    # the pipeline-parallel GPT over 4 stages (4 microbatches, SGD)
    python -m mpi4jax_tpu_torch.examples.train_gpt --pp 4 --steps 20

The ranks of the ``(dp, tp, sp)`` mesh, or the ``--pp`` stages, all live on
the one device.  As in the JAX CLI, a first step (which builds the
kernels) comes before the ``--steps`` timed ones, each of which ends in
reading its loss; the run prints the last loss and the ms per step, or with
``--json`` one JSON line (``mesh`` or ``pp``, ``losses`` of every step,
``ms_per_step``, ``device``).  ``--pp`` runs
``models/pp_transformer.PPGPT`` as the JAX CLI does: 4 microbatches of
``--batch`` sequences, ``max(--layers, pp)`` layers, SGD at lr 3e-4.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.pp_transformer import PPGPT
from ..models.transformer import GPT, GPTConfig


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", type=int, nargs=3, default=[1, 1, 1],
                    metavar=("DP", "TP", "SP"),
                    help="dp tp sp, all on the one device (default 1 1 1)")
    ap.add_argument("--pp", type=int, default=None,
                    help="the pipeline-parallel model over PP stages")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    rng = np.random.RandomState(0)
    if args.pp:
        return _train_pp(args, rng)

    dp, tp, sp = args.mesh
    cfg = GPTConfig(vocab=256, d_model=args.d_model, n_heads=args.heads,
                    n_layers=args.layers, d_ff=4 * args.d_model,
                    max_seq=args.seq)
    model = GPT(cfg, (dp, tp, sp), device=args.device)
    toks = torch.from_numpy(
        rng.randint(0, cfg.vocab, (args.batch, args.seq)).astype(np.int32))
    toks = toks.to(model.device)

    losses = [float(model.train_step(toks))]  # builds the kernels
    t0 = time.perf_counter()
    for _ in range(args.steps):
        losses.append(float(model.train_step(toks)))
    dt = (time.perf_counter() - t0) / max(args.steps, 1)
    if args.json:
        print(json.dumps({"mesh": [dp, tp, sp], "losses": losses,
                          "ms_per_step": dt * 1e3,
                          "device": str(model.device)}))
    else:
        print(f"mesh (dp={dp}, tp={tp}, sp={sp}): loss {losses[-1]:.4f}, "
              f"{dt * 1e3:.1f} ms/step on {model.device}")
    return 0


def _train_pp(args, rng):
    """The JAX CLI's pipeline branch: ``PPGPT`` over ``--pp`` stages."""
    pp = args.pp
    cfg = GPTConfig(vocab=256, d_model=args.d_model, n_heads=args.heads,
                    n_layers=max(args.layers, pp), d_ff=4 * args.d_model,
                    max_seq=args.seq)
    model = PPGPT(cfg, pp, device=args.device)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab, (4, args.batch, args.seq)).astype(np.int32))
    toks = toks.to(model.device)

    losses = [float(model.train_step(toks, lr=3e-4))]  # builds the kernels
    t0 = time.perf_counter()
    for _ in range(args.steps):
        losses.append(float(model.train_step(toks, lr=3e-4)))
    dt = (time.perf_counter() - t0) / max(args.steps, 1)
    if args.json:
        print(json.dumps({"pp": pp, "losses": losses,
                          "ms_per_step": dt * 1e3,
                          "device": str(model.device)}))
    else:
        print(f"pp={pp}: loss {losses[-1]:.4f}, {dt * 1e3:.1f} ms/step on "
              f"{model.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
