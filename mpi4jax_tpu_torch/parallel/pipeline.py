"""Pipeline parallelism over a mesh comm (SPMD GPipe).

The counterpart of ``mpi4jax_tpu/parallel/pipeline.py``.  Every stage
runs the same program: at each tick every stage runs at once (batched over
the leading rank dimensions), ticks on which a stage holds no microbatch
are masked to zero, and the activations move one stage on with one
``sendrecv`` along ``[(i, i + 1)]``, which is not a ring, so it is one hop
launch on the card.  ``M`` microbatches over ``pp`` stages take
``M + pp - 1`` ticks, and every tick ends in its hop, the last one too, as
in the JAX package's ``lax.scan``.  Autograd replays the schedule backward:
each hop's gradient is the reverse hop.  Autograd skips the last tick's
hop there, since nothing reads its output; ``jax.grad`` runs that one too.
"""

from __future__ import annotations

import torch

from ..ops.sendrecv import sendrecv


def pipeline_apply(stage_fn, stage_params, microbatches, *, comm,
                   prepare_fn=None):
    """Run microbatches through the chain of stages of ``comm``.

    Args:
        stage_fn: ``stage_fn(params, x) -> y``, every stage's compute on
            the rank-stacked activations ``(*lead, ...)``; the activation
            has one shape at every stage boundary.
        stage_params: each rank's stage parameters (any value
            ``stage_fn`` takes), with the mesh's rank dimensions leading.
        microbatches: ``(*lead, M, ...)``; only stage 0 reads its rows.
        comm: the mesh comm whose ranks are the stages.
        prepare_fn: an optional map from the rank-stacked raw microbatch
            ``(*lead, ...)`` to the activation fed to stage 0 (an
            embedding lookup, say).

    Returns:
        ``(*lead, M, ...)`` outputs, valid on the last stage; the other
        stages hold zeros.
    """
    size = comm.size()
    lead = comm.layout_shape
    L = len(lead)
    m = microbatches.shape[L]
    n_ticks = m + size - 1
    if prepare_fn is None:
        prepare_fn = lambda mb: mb  # noqa: E731
    dev = microbatches.device
    # every tick's masks from the rank tensor on the device: a tensor made
    # from host values would wait for the stream at each tick
    idx = comm.rank(dev)
    first = (idx == 0)
    is_last = (idx == size - 1)
    flat = microbatches.reshape(-1, *microbatches.shape[L:])
    every = torch.arange(flat.shape[0], device=dev)
    pairs = [(i, i + 1) for i in range(size - 1)]

    def at_rank(mask, y):
        return mask.reshape(mask.shape + (1,) * (y.dim() - L))

    incoming = None
    ys = []
    for t in range(n_ticks):
        # the microbatch each stage processes at tick t
        mb = t - idx
        active = (mb >= 0) & (mb < m)
        pick = mb.clamp(0, m - 1).reshape(-1)
        x0 = prepare_fn(flat[every, pick].reshape(
            *lead, *microbatches.shape[L + 1:]))
        if incoming is None:  # the scan's initial carry
            incoming = torch.zeros_like(x0)
        x_in = torch.where(at_rank(first, x0), x0, incoming)
        y = stage_fn(stage_params, x_in)
        y = torch.where(at_rank(active, y), y, torch.zeros_like(y))
        # a one-stage chain sends nothing: ppermute of no pairs is zeros
        incoming = (sendrecv(y, perm=pairs, comm=comm) if pairs
                    else torch.zeros_like(y))
        ys.append(y)
    # the last stage produced microbatch j at tick j + size - 1
    out = torch.stack(ys[size - 1:], dim=L)
    return torch.where(at_rank(is_last, out), out, torch.zeros_like(out))
