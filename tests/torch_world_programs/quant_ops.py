"""The int8 allreduce (``compression="int8"``) beside the exact one: the
same schedule signature, a different wire.

The torch twin of ``tests/world_programs/quant_ops.py``.  In the static
verifier's virtual world every route is served exactly, so the bounds
below hold there too; a real run holds the int8 approximation to them.
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


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    dev = comm.device
    weight = sum(r + 1 for r in range(size))

    # exact vs quantized: same op, same schedule, different wire
    x = torch.linspace(-2.0, 3.0, 1030, dtype=torch.float32,
                       device=dev) * (rank + 1)
    exact = mt.allreduce(x, op=mt.SUM, comm=comm)
    approx = mt.allreduce(x, op=mt.SUM, compression="int8", comm=comm)
    expect = np.linspace(-2.0, 3.0, 1030, dtype=np.float64) * weight
    np.testing.assert_allclose(exact.cpu().numpy(), expect, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(approx.cpu().numpy(), expect, rtol=5e-2,
                               atol=0.5)

    # bf16 payload (the 2x-compression dtype)
    xb = x.to(torch.bfloat16)
    outb = mt.allreduce(xb, op=mt.SUM, compression="int8", comm=comm)
    assert outb.dtype == torch.bfloat16
    np.testing.assert_allclose(outb.float().cpu().numpy(), expect,
                               rtol=6e-2, atol=2.0)

    # quantized gradient synchronization under autograd: the backward
    # passes the cotangent (no message)
    def loss(w):
        y = mt.allreduce(w * w, op=mt.SUM, compression="int8", comm=comm)
        return torch.sum(y)

    w0 = (torch.ones((512,), dtype=torch.float32, device=dev)
          * (rank + 1)).requires_grad_(True)
    loss(w0).backward()
    np.testing.assert_allclose(w0.grad.cpu().numpy(),
                               2.0 * (rank + 1) * np.ones(512),
                               rtol=5e-2, atol=0.1)

    # a large payload routes as qring (the bandwidth twin) — still the
    # same schedule signature
    big = torch.ones((96 * 1024,), dtype=torch.float32, device=dev) * (
        rank + 1)
    outg = mt.allreduce(big, op=mt.SUM, compression="int8", comm=comm)
    np.testing.assert_allclose(outg.cpu().numpy(),
                               np.full(96 * 1024, float(weight)),
                               rtol=5e-2, atol=0.5)

    print("quant_ops OK", flush=True)


if __name__ == "__main__":
    main()
