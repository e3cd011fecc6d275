"""Full world-tier sweep: every dtype, gradients, the batched forms, custom
reduce ops and the int8 allreduce, in one per-rank program.

The torch twin of ``tests/world_programs/full_ops.py``: the same ops,
peers, tags, roots, dtypes, shapes and order.  Where the twin transposes
a linear op without running it, the port sends what the transpose sends:
the SUM allreduce's transpose is the identity (no message), transposing
it twice is the allreduce, and the ring's double transpose is the ring.
``jax.jvp`` is the op on the primal and on the tangent; ``jax.grad`` is
autograd.  A ``jax.vmap`` of a world op issues one message on the stacked
tensor: here that op on the stacked tensor, transposed where the batched
output is.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")

REDUCE_DTYPES = [
    torch.bfloat16, torch.float16, torch.float32, torch.float64,
    torch.int8, torch.int16, torch.int32, torch.int64,
    torch.uint8, torch.uint16, torch.uint32, torch.uint64,
]
MOVE_DTYPES = REDUCE_DTYPES + [torch.bool, torch.complex64,
                               torch.complex128]


def _mk(dtype, rank, dev, n=4):
    if dtype == torch.bool:
        return torch.tensor([True, False, True, bool(rank % 2)], device=dev)
    if dtype.is_complex:
        return torch.complex(
            torch.arange(n, dtype=torch.float64),
            torch.full((n,), float(rank + 1), dtype=torch.float64),
        ).to(dtype).to(dev)
    return (torch.arange(n, dtype=torch.float64) + rank).to(dtype).to(dev)


def _f64(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    a = t.numpy()
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def check_allreduce_dtypes(comm, rank, size, dev):
    for dtype in REDUCE_DTYPES:
        x = _mk(dtype, rank, dev)
        out = mt.allreduce(x, op=mt.SUM, comm=comm)
        assert out.dtype == x.dtype, (dtype, out.dtype)
        expect = np.arange(4) * size + sum(range(size))
        np.testing.assert_allclose(_f64(out), expect, rtol=1e-2)
        out = mt.allreduce(x, op=mt.MAX, comm=comm)
        np.testing.assert_allclose(_f64(out), np.arange(4) + size - 1,
                                   rtol=1e-2)
    # complex SUM / PROD
    for dtype in (torch.complex64, torch.complex128):
        x = torch.full((3,), 1 + 1j, dtype=dtype, device=dev)
        out = mt.allreduce(x, op=mt.SUM, comm=comm)
        np.testing.assert_allclose(_f64(out), size * (1 + 1j))
        out = mt.allreduce(x, op=mt.PROD, comm=comm)
        np.testing.assert_allclose(_f64(out), (1 + 1j) ** size)
    # bool logical ops
    mine = torch.tensor([rank == 0, True, False], device=dev)
    lor = mt.allreduce(mine, op=mt.LOR, comm=comm)
    np.testing.assert_array_equal(lor.cpu().numpy(), [True, True, False])
    land = mt.allreduce(mine, op=mt.LAND, comm=comm)
    np.testing.assert_array_equal(land.cpu().numpy(),
                                  [size == 1, True, False])
    # int bitwise
    bits = torch.tensor([1 << rank, 3], dtype=torch.int32, device=dev)
    bor = mt.allreduce(bits, op=mt.BOR, comm=comm)
    np.testing.assert_array_equal(bor.cpu().numpy(), [(1 << size) - 1, 3])


def check_movement_dtypes(comm, rank, size, dev):
    """allgather / alltoall / bcast / gather / scatter / sendrecv / scan
    across the dtype table."""
    for dtype in MOVE_DTYPES:
        x = _mk(dtype, rank, dev)
        ag = mt.allgather(x, comm=comm)
        assert tuple(ag.shape) == (size, 4) and ag.dtype == x.dtype
        for r in range(size):
            np.testing.assert_allclose(_f64(ag[r]), _f64(_mk(dtype, r, dev)),
                                       rtol=1e-2)

        a2a_in = torch.stack([_mk(dtype, rank, dev)] * size)
        a2a = mt.alltoall(a2a_in, comm=comm)
        for r in range(size):
            np.testing.assert_allclose(_f64(a2a[r]),
                                       _f64(_mk(dtype, r, dev)), rtol=1e-2)

        b = mt.bcast(x, root=size - 1, comm=comm)
        np.testing.assert_allclose(_f64(b), _f64(_mk(dtype, size - 1, dev)),
                                   rtol=1e-2)

        g = mt.gather(x, root=0, comm=comm)
        if rank == 0:
            for r in range(size):
                np.testing.assert_allclose(_f64(g[r]),
                                           _f64(_mk(dtype, r, dev)),
                                           rtol=1e-2)

        sc_in = torch.stack([_mk(dtype, r, dev) for r in range(size)])
        mine = mt.scatter(sc_in, root=0, comm=comm)
        np.testing.assert_allclose(_f64(mine), _f64(_mk(dtype, rank, dev)),
                                   rtol=1e-2)

        ring = mt.sendrecv(x, shift=1, comm=comm)
        np.testing.assert_allclose(
            _f64(ring), _f64(_mk(dtype, (rank - 1) % size, dev)), rtol=1e-2)

    # scan on ordered dtypes
    for dtype in (torch.float32, torch.float64, torch.int32,
                  torch.bfloat16):
        sc = mt.scan(torch.ones((2,), dtype=dtype, device=dev) * (rank + 1),
                     op=mt.SUM, comm=comm)
        np.testing.assert_allclose(_f64(sc), sum(range(1, rank + 2)),
                                   rtol=1e-2)


def check_transpose_identities(comm, rank, size, dev):
    """The twin's linear transposes, what they send, and autograd."""
    x = torch.arange(4, dtype=torch.float32, device=dev) + rank

    def ar(v):
        return mt.allreduce(v, op=mt.SUM, comm=comm)

    # the SUM allreduce's transpose is the identity: no message
    xt = torch.ones((4,), dtype=torch.float32, device=dev)
    np.testing.assert_allclose(xt.cpu().numpy(), 1.0)

    # transposed twice: the allreduce itself
    double_t = mt.allreduce(x, op=mt.SUM, comm=comm)
    np.testing.assert_allclose(double_t.cpu().numpy(), ar(x).cpu().numpy(),
                               rtol=1e-6)

    def ring(v):
        return mt.sendrecv(v, shift=1, comm=comm)

    # the ring's transpose runs shift -1; transposed twice it is shift +1
    ring_double_t = mt.sendrecv(x, shift=1, comm=comm)
    np.testing.assert_allclose(ring_double_t.cpu().numpy(),
                               ring(x).cpu().numpy(), rtol=1e-6)

    # grad through the allreduce (its backward passes the cotangent
    # unreduced) and through the ring (its backward sends the cotangent
    # back along the edge)
    v = x.clone().requires_grad_(True)
    ar(v).sum().backward()
    np.testing.assert_allclose(v.grad.cpu().numpy(), 1.0)
    v = x.clone().requires_grad_(True)
    (ring(v) * (rank + 1.0)).sum().backward()
    np.testing.assert_allclose(v.grad.cpu().numpy(),
                               float((rank + 1) % size + 1))

    # jvp through the allreduce: the op on the primal and on the tangent
    ar(x)
    tang = ar(torch.ones_like(x))
    np.testing.assert_allclose(tang.cpu().numpy(), float(size))


def check_vmap(comm, rank, size, dev):
    xb = torch.stack([torch.arange(4, dtype=torch.float32, device=dev) + rank,
                      torch.full((4,), float(rank), device=dev)])

    out = mt.allreduce(xb, op=mt.SUM, comm=comm)
    np.testing.assert_allclose(out[0].cpu().numpy(),
                               np.arange(4) * size + sum(range(size)))
    np.testing.assert_allclose(out[1].cpu().numpy(), sum(range(size)))

    out = mt.allgather(xb, comm=comm).transpose(0, 1)
    assert tuple(out.shape) == (2, size, 4)
    for r in range(size):
        np.testing.assert_allclose(out[1, r].cpu().numpy(), float(r))

    out = mt.sendrecv(xb, shift=1, comm=comm)
    np.testing.assert_allclose(out[1].cpu().numpy(),
                               float((rank - 1) % size))


def check_custom_op(comm, rank, size, dev):
    """A user-defined reduction on the world tier: allgather and a local
    fold."""
    absmax = mt.custom_op(
        "ABSMAX_W", lambda a, b: torch.maximum(torch.abs(a), torch.abs(b)))
    x = torch.tensor([float(rank) - 1.5, -float(rank)], dtype=torch.float32,
                     device=dev)
    out = mt.allreduce(x, op=absmax, comm=comm)
    expect = np.max(np.abs(np.asarray(
        [[r - 1.5, -r] for r in range(size)], np.float32)), axis=0)
    np.testing.assert_allclose(out.cpu().numpy(), expect)

    red = mt.reduce(x, op=absmax, root=0, comm=comm)
    if rank == 0:
        np.testing.assert_allclose(red.cpu().numpy(), expect)
    else:
        np.testing.assert_allclose(red.cpu().numpy(), x.cpu().numpy())

    sc = mt.scan(x, op=absmax, comm=comm)
    raw = np.asarray([[r - 1.5, -r] for r in range(size)], np.float32)
    want = raw[0]
    for r in range(1, rank + 1):
        want = np.maximum(np.abs(want), np.abs(raw[r]))
    np.testing.assert_allclose(sc.cpu().numpy(), want)


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size >= 2, "run under the launcher with -n >= 2"
    dev = comm.device

    # int8-compressed allreduce over the native transport (~1e-2 rel err)
    xq = torch.linspace(-3.0, 5.0, 257, dtype=torch.float32,
                        device=dev) * (rank + 1)
    outq = mt.allreduce(xq, op=mt.SUM, compression="int8", comm=comm)
    expectq = np.linspace(-3.0, 5.0, 257) * sum(r + 1 for r in range(size))
    np.testing.assert_allclose(outq.cpu().numpy(), expectq, rtol=5e-2,
                               atol=0.2)

    check_custom_op(comm, rank, size, dev)
    check_allreduce_dtypes(comm, rank, size, dev)
    check_movement_dtypes(comm, rank, size, dev)
    check_transpose_identities(comm, rank, size, dev)
    check_vmap(comm, rank, size, dev)

    # everything again in one function (the twin's one jit)
    def prog(v):
        a = mt.allreduce(v, op=mt.SUM, comm=comm)
        b = mt.sendrecv(a, shift=1, comm=comm)
        c = mt.allgather(b, comm=comm)
        return c.sum()

    x = torch.arange(4, dtype=torch.float32, device=dev) + rank
    got = prog(x)
    expect = (np.arange(4) * size + sum(range(size))).sum() * size
    np.testing.assert_allclose(float(got), expect)

    print(f"rank {rank}: full_ops OK", flush=True)


if __name__ == "__main__":
    main()
