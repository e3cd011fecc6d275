"""Data parallelism: gradient synchronization by SUM allreduce.

The counterpart of ``mpi4jax_tpu/parallel/dp.py``.  Parameters and
gradients are trees (dicts, lists, tuples, named tuples, ``None``) of
tensors with the mesh's rank dimensions leading.  Every rank keeps its own
replica of each parameter, so autograd gives each rank its own gradient;
the sync then adds the ranks' gradients through the allreduce (the hop
and fused-ring kernels on the card).  A weight shared by the ranks would
let autograd add them itself and skip the collective.

``elastic_step_fn`` builds the step of ``elastic.training.run`` on a world
comm: a rank's gradient by ``torch.autograd`` on its share of the global
batch, re-derived from ``(step, rank, size)``, so that a shrunk world
reshards the same batch.
"""

from __future__ import annotations

import os

import torch

from ..ops import SUM, allreduce
from ..utils import config
from ..utils import tree as _tree
from ..utils.validation import is_world


def _resolve(comm):
    if comm is None:
        from .mesh import get_default_comm

        comm = get_default_comm()
    return comm


def pmean(x, *, comm=None):
    """Mean over the ranks (differentiable: a SUM allreduce over the size;
    an integer tensor comes back as a float one, as in the JAX package)."""
    comm = _resolve(comm)
    return allreduce(x, op=SUM, comm=comm) / comm.size()


def _resolve_bucket_bytes(bucket_bytes):
    """``bucket_bytes``, else 0 unless ``MPI4JAX_TPU_PLAN_BUCKET_KB`` is
    set, else its value (1 MiB when set but blank): the JAX package's
    rule."""
    if bucket_bytes is not None:
        return int(bucket_bytes)
    if os.environ.get("MPI4JAX_TPU_PLAN_BUCKET_KB") is None:
        return 0
    return config.plan_bucket_bytes()


def sync_gradients(grads, *, comm=None, bucket_bytes=None):
    """Allreduce-mean every leaf of a gradient tree.

    On a mesh comm the leaves have the mesh's rank dimensions leading; on
    a world comm each is this rank's tensor.  By default one allreduce per
    leaf.  With ``bucket_bytes`` > 0, or
    whenever ``MPI4JAX_TPU_PLAN_BUCKET_KB`` is set in the environment,
    adjacent leaves of one dtype (in ``jax.tree.flatten``'s order: dict keys
    sorted, ``None`` dropped) are joined into buckets of up to that many
    bytes per rank and synced by one allreduce each; a leaf larger than the
    bucket goes alone, and a change of dtype starts a new bucket.

    Bucketed and per-leaf results are equal up to the order in which the
    ranks' values are added, and not bit for bit in the port: the
    allreduce picks its arm on the per-rank element count, so a small leaf
    alone takes the butterfly while the bucket holding it may take the
    fused ring, which adds the ranks in the ring's order.  (The JAX package
    says its two paths are identical: XLA's ``psum`` adds in one order at
    every size.)
    """
    bucket_bytes = _resolve_bucket_bytes(bucket_bytes)
    if bucket_bytes <= 0:
        return _tree.tree_map(lambda g: pmean(g, comm=comm), grads)
    comm = _resolve(comm)
    # a world comm's tensors are this rank's alone: no rank dimensions
    lead = () if is_world(comm) else comm.layout_shape
    nranks = 1 if is_world(comm) else comm.nranks
    leaves, treedef = _tree.flatten(grads)

    synced = [None] * len(leaves)
    bucket = []          # (leaf index, the leaf flattened per rank)
    bucket_nbytes = 0

    def flush():
        nonlocal bucket, bucket_nbytes
        if not bucket:
            return
        if len(bucket) == 1:
            i, flat = bucket[0]
            synced[i] = pmean(flat, comm=comm)
        else:
            red = pmean(torch.cat([flat for _, flat in bucket], -1),
                        comm=comm)
            off = 0
            for i, flat in bucket:
                synced[i] = red[..., off:off + flat.shape[-1]]
                off += flat.shape[-1]
        bucket, bucket_nbytes = [], 0

    prev_dtype = None
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() // nranks * leaf.element_size()
        oversize = nbytes > bucket_bytes
        if (leaf.dtype != prev_dtype or oversize
                or bucket_nbytes + nbytes > bucket_bytes):
            flush()
        if oversize:
            synced[i] = pmean(leaf, comm=comm)
        else:
            bucket.append((i, leaf.reshape(*lead, -1)))
            bucket_nbytes += nbytes
        prev_dtype = leaf.dtype
    flush()
    # the flat slices back to their shapes, with no cast: pmean's
    # promotion (int mean -> float) must match the per-leaf path
    synced = [s.reshape(leaf.shape) for s, leaf in zip(synced, leaves)]
    return _tree.unflatten(treedef, synced)


def value_and_synced_grad(loss_fn, *, comm=None):
    """The value and the DP-synced gradient of a per-rank loss.

    ``loss_fn(params, *batch)`` returns each rank's loss on its own shard,
    a tensor of the mesh's rank dimensions; ``params`` is a tree of
    tensors that require grad, one replica per rank.  The returned function
    gives the mean loss over the ranks (per rank) and the allreduce-mean
    gradient tree (``None`` where ``params`` has ``None``).  Every rank's
    loss is seeded with 1, as each shard's ``jax.value_and_grad`` is.
    """

    def wrapped(params, *batch):
        loss = loss_fn(params, *batch)
        leaves, treedef = _tree.flatten(params)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        synced = sync_gradients(_tree.unflatten(treedef, grads), comm=comm)
        return pmean(loss.detach(), comm=comm), synced

    return wrapped


def elastic_step_fn(loss_fn, *, lr, batch_fn, optimizer=None):
    """A ``step_fn(params, step, comm)`` for ``elastic.training.run`` from
    a per-rank loss: SGD (or ``optimizer(params, grads, lr) -> params``)
    over DP-synced gradients, with the rank's batch re-derived every step
    from ``batch_fn(step, rank, size)`` (a tuple of arguments, or one).

    ``params`` is a tree of floating tensors; ``loss_fn(params, *batch)``
    returns this rank's scalar loss on its shard.  Each step differentiates
    it with ``torch.autograd`` with respect to every leaf and syncs the
    gradients with ``sync_gradients(comm=...)``; the new parameters are
    detached tensors.  The rank and size indirection is the elastic wiring:
    after a recovery shrinks the world, the same function reshards the
    global batch over the new ranks, so with a global batch that every
    surviving size divides, the synced gradient stays the global mean and
    the resumed trajectory matches an uninterrupted run up to float
    reassociation (the JAX package's ``parallel/dp.py:120-150``).
    """

    def sgd(params, grads, lr_):
        return _tree.tree_map(lambda p, g: p - lr_ * g, params, grads)

    opt = optimizer or sgd

    def step_fn(params, step, comm):
        comm_ = _resolve(comm)
        batch = batch_fn(step, int(comm_.rank()), int(comm_.size()))
        if not isinstance(batch, tuple):
            batch = (batch,)
        leaves, treedef = _tree.flatten(params)
        if not all(p.is_floating_point() for p in leaves):
            raise TypeError("elastic_step_fn differentiates every leaf of "
                            "params; they must be floating tensors")
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(_tree.unflatten(treedef, live), *batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        grads = sync_gradients(_tree.unflatten(treedef, grads), comm=comm_)
        with torch.no_grad():
            new = opt(_tree.unflatten(
                treedef, [p.detach() for p in live]), grads, lr)
        return _tree.tree_map(lambda p: p.detach(), new)

    return step_fn
