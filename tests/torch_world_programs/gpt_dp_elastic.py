"""Elastic data-parallel GPT training: the torch twin of
``tests/world_programs/gpt_dp_elastic.py``, on the port's GPT
(``models/transformer.py``).

Every rank holds the whole model (a (1, 1, 1) mesh of its own) and trains
with ``parallel.dp.elastic_step_fn`` (SGD) inside ``elastic.training.run``,
checkpointing every ``--save-every`` steps.  The global batch (made from a
seed per step) is resharded over whatever world size is alive, so a run
that loses a rank and shrinks keeps the global-mean gradient, and its final
parameters and full-batch loss match an uninterrupted run's up to float
reassociation (for the loss, the JAX package's documented bound, 1e-2
relative).

Each step prints one JSON line (``gpt_dp_elastic step {...}``): the slot,
rank, size and generation, the wall-clock times the step was entered
(``t_in``), began (``t0``, after the route check) and ended (``t1``), the
kernel launches of the step (``ops._collectives.LAUNCHES``,
``ops.flash.LAUNCHES``), the L2 norm of its parameter update
(``update_l2``) and the world's islands; a step that fails prints
``gpt_dp_elastic fail`` with the time.  At the end, from rank 0 on the
whole batch after the last step (the mean NLL, in chunks of 4 sequences):
``initial_loss`` at the initial parameters and ``final_loss`` at the final
ones, and ``movement``, the L2 norm of the final parameters less the
initial ones; with ``--out``, the final parameters in the global layout.
``--kill SLOT:STEP`` kills the rank of that launcher slot with SIGKILL at
the start of that step of generation 0, after printing ``gpt_dp_elastic
kill`` with the time: a death whose moment is known, for the recovery's
time.  ``--route-check`` holds the first step that each generation runs
to the plain route (``_collectives.use_plain()``) before the step itself,
uncounted in its launches: every rank's local gradient on the kernel
route and on the plain route; the kernel route's gradients synced twice,
through the kernels (kernel 3 on the leg's islands) and on the plain route,
which must agree bit for bit; and the plain route's gradients synced on
the plain route, held to the kernel route's synced ones.  It prints
``gpt_dp_elastic route {...}``: the two local losses and their relative
difference, the worst field's relative L2 between the two synced
gradients (``grad_rel``), ``sync_bits`` and the check's launches.  Each survivor prints ``gpt_dp_elastic recover`` with the times it
entered ``elastic.recover``, began and ended ``bridge.rebuild`` and left
the recovery, so the recovery splits into the wait for the launcher's
announcement, the rebuild and the restore.

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 --elastic \\
        gpt_dp_elastic.py --device cpu [--steps 8]

``--gpt2`` takes GPT-2's widths (vocab 50304, d_model 768, 12 heads of 64,
d_ff 3072, T 1024, bf16 compute) at ``--layers`` layers and a global batch
of 12; the default is the small configuration of the JAX program (vocab 64,
d_model 32, 2 layers, 4 heads, T 16, d_ff 128, f32, global batch 6).
Checkpoint directory: ``MPI4JAX_TPU_CKPT_DIR``.
"""

import argparse
import contextlib
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi4jax_tpu_torch.benchmarks.gpt_step import rel_l2  # noqa: E402
from mpi4jax_tpu_torch.elastic import current_generation  # noqa: E402
from mpi4jax_tpu_torch.elastic import my_slot, training  # noqa: E402
from mpi4jax_tpu_torch.models import transformer as tf  # noqa: E402
from mpi4jax_tpu_torch.ops import _collectives as coll  # noqa: E402
from mpi4jax_tpu_torch.ops import flash  # noqa: E402
from mpi4jax_tpu_torch.parallel import dp  # noqa: E402
from mpi4jax_tpu_torch.runtime import bridge  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=128,
             max_seq=16, dtype="float32")
GPT2 = dict(vocab=50304, d_model=768, n_heads=12, d_ff=3072, max_seq=1024,
            dtype="bfloat16")


def config(args) -> tf.GPTConfig:
    if args.gpt2:
        return tf.GPTConfig(**GPT2, n_layers=args.layers)
    return tf.GPTConfig(**SMALL)


def global_batch(step, cfg, batch):
    rng = np.random.RandomState(1000 + step)
    return rng.randint(0, cfg.vocab, size=(batch, cfg.max_seq))


class _Loss(torch.nn.Module):
    """The GPT's loss as a module's forward, for ``functional_call``."""

    def __init__(self, gpt):
        super().__init__()
        self.gpt = gpt

    def forward(self, tokens):
        return self.gpt.loss(tokens)[0, 0, 0]


def _counts():
    return dict(coll.LAUNCHES, **flash.LAUNCHES)


def _l2(a, b):
    """The L2 norm of ``a - b`` over every field, in f64."""
    return sum(float((a[f].double() - b[f].double()).square().sum())
               for f in a) ** 0.5


def _route_check(loss_fn, p, tok, comm):
    """The kernel route against the plain route on one step's gradient;
    the dict ``--route-check`` prints."""
    before = _counts()
    local = {}
    for route in ("kernel", "plain"):
        with (coll.use_plain() if route == "plain"
              else contextlib.nullcontext()):
            live = {f: v.detach().requires_grad_(True) for f, v in p.items()}
            loss = loss_fn(live, tok)
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True)
            local[route] = (float(loss), {
                f: torch.zeros_like(live[f]) if g is None else g
                for f, g in zip(live, grads)})
    synced = dp.sync_gradients(local["kernel"][1], comm=comm)
    with coll.use_plain():
        folded = dp.sync_gradients(local["kernel"][1], comm=comm)
        plain = dp.sync_gradients(local["plain"][1], comm=comm)
    after = _counts()
    (lk, _), (lp, _) = local["kernel"], local["plain"]
    return {"loss_kernel": lk, "loss_plain": lp,
            "loss_rel": abs(lk - lp) / abs(lp),
            "grad_rel": max(rel_l2(synced[f], plain[f]) for f in synced),
            "sync_bits": all(torch.equal(synced[f], folded[f])
                             for f in synced),
            "launches": {k: after[k] - before[k] for k in after}}


def _time_recovery():
    """Wrap the training loop's ``recover`` and the bridge's ``rebuild`` so
    that a survivor prints when each began and ended."""
    marks = {}
    rebuild, recover = bridge.rebuild, training.recover

    def timed_rebuild(*a, **k):
        marks["rebuild0"] = time.time()
        out = rebuild(*a, **k)
        marks["rebuild1"] = time.time()
        return out

    def timed_recover(comm):
        marks["recover0"] = time.time()
        rec = recover(comm)
        sys.stdout.write("gpt_dp_elastic recover " + json.dumps(
            dict(marks, recover1=time.time(), slot=my_slot(),
                 generation=rec.generation)) + "\n")
        sys.stdout.flush()
        return rec

    bridge.rebuild, training.recover = timed_rebuild, timed_recover


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--gpt2", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default 12 with --gpt2, else 6)")
    ap.add_argument("--kill", default=None, metavar="SLOT:STEP")
    ap.add_argument("--route-check", action="store_true")
    ap.add_argument("--out", default=None,
                    help="rank 0 writes the final parameters here (.npz)")
    args = ap.parse_args()
    comm = get_world_comm(device=args.device)
    dev = comm.device
    _time_recovery()
    cfg = config(args)
    batch = args.batch or (12 if args.gpt2 else 6)
    model = tf.GPT(cfg, (1, 1, 1), device=dev, seed=0)
    loss_mod = _Loss(model)
    params = {f: getattr(model, f).detach().clone()
              for f in tf.GPTParams._fields}
    init = dict(params)  # the steps make new tensors

    def loss_fn(p, tok):
        return torch.func.functional_call(
            loss_mod, {f"gpt.{f}": v for f, v in p.items()}, (tok,))

    def batch_fn(step, rank, size):
        if batch % size:
            raise ValueError(f"global batch {batch} does not split over "
                             f"{size} ranks")
        per = batch // size
        tok = global_batch(step, cfg, batch)[rank * per:(rank + 1) * per]
        return torch.from_numpy(tok).to(dev)

    inner = dp.elastic_step_fn(loss_fn, lr=args.lr, batch_fn=batch_fn)
    kill = tuple(map(int, args.kill.split(":"))) if args.kill else None
    checked = set()  # the generations whose first step was route-checked

    def step_fn(p, step, comm_):
        t_in = time.time()
        if kill == (my_slot(), step) and current_generation() == 0:
            sys.stdout.write("gpt_dp_elastic kill " + json.dumps(
                {"slot": kill[0], "step": step, "t": time.time()}) + "\n")
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        if args.route_check and current_generation() not in checked:
            checked.add(current_generation())
            res = _route_check(loss_fn, p, batch_fn(
                step, comm_.rank(), comm_.size()), comm_)
            sys.stdout.write("gpt_dp_elastic route " + json.dumps(dict(
                res, slot=my_slot(), rank=comm_.rank(), size=comm_.size(),
                generation=current_generation(), step=step)) + "\n")
            sys.stdout.flush()
        before = _counts()
        t0 = time.time()
        try:
            out = inner(p, step, comm_)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except BaseException:
            sys.stdout.write("gpt_dp_elastic fail " + json.dumps(
                {"slot": my_slot(), "step": step, "t": time.time(),
                 "generation": current_generation()}) + "\n")
            sys.stdout.flush()
            raise
        t1 = time.time()
        after = _counts()
        topo = comm_.topology()
        sys.stdout.write("gpt_dp_elastic step " + json.dumps(
            {"slot": my_slot(), "rank": comm_.rank(), "size": comm_.size(),
             "generation": current_generation(), "step": step,
             "t_in": t_in, "t0": t0, "t1": t1,
             "launches": {k: after[k] - before[k] for k in after},
             "update_l2": _l2(out, p),
             "islands": topo.islands if topo else None}) + "\n")
        sys.stdout.flush()
        return out

    params = training.run(step_fn, params, steps=args.steps,
                          save_every=args.save_every, comm=comm)
    if comm.rank() == 0:
        tok = torch.from_numpy(global_batch(args.steps, cfg, batch)).to(dev)

        def full_loss(p):
            with torch.no_grad():
                for f in tf.GPTParams._fields:
                    getattr(model, f).copy_(p[f])
                # every sequence has the same number of scored tokens, so
                # the chunks' means weighted by their sequences give the
                # mean
                return sum(float(loss_mod(tok[i:i + 4])) * len(tok[i:i + 4])
                           for i in range(0, batch, 4)) / batch

        initial = full_loss(init)
        final = full_loss(params)
        if args.out:
            g = model.global_params()
            np.savez(args.out, **{f: getattr(g, f).cpu().numpy()
                                  for f in tf.GPTParams._fields})
        sys.stdout.write(f"gpt_dp_elastic initial_loss {initial!r}\n"
                         f"gpt_dp_elastic final_loss {final!r}\n"
                         f"gpt_dp_elastic movement {_l2(params, init)!r}\n")
    sys.stdout.write("gpt_dp_elastic OK\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
