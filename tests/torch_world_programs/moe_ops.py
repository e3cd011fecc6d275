"""MoE expert parallelism on a world comm: the dispatch and combine
alltoalls, exact, quantized (``compression="int8"``), on a forced
hierarchical schedule (``algo="halltoall"``) and with a tight capacity.

The torch twin of ``tests/world_programs/moe_ops.py`` (run at np 4).  The
quantized and forced routes run the same alltoall op, so the schedule,
the match simulation and the compiled plan equal the exact program's.  In
the static verifier's virtual world the values are exact; under the
launcher the quantized runs are the int8 approximations, and the asserts
accept both within the documented bound.  Routing is deterministic by
construction (each token carries a strong component along its expert's
gate direction), so the numpy reference agrees with the routing.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi4jax_tpu_torch.parallel import moe  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")

T, D, DFF = 8, 16, 32  # tokens/rank, d_model, d_ff


def _reference(params, x, size, capacity):
    """Per-token numpy twin of ``moe.moe_ffn``: route, capacity-drop,
    expert FFN, gate-weight."""
    logits = x @ params["w_gate"]
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = z / z.sum(axis=-1, keepdims=True)
    idx = np.argmax(probs, axis=-1)
    y = np.zeros_like(x)
    seen = {e: 0 for e in range(size)}
    for t in range(x.shape[0]):
        e = int(idx[t])
        pos = seen[e]
        seen[e] += 1
        if pos >= capacity:
            continue  # dropped: output stays the zero vector
        h = np.maximum(x[t] @ params["w_in"][e] + params["b_in"][e], 0)
        out = h @ params["w_out"][e] + params["b_out"][e]
        y[t] = out * probs[t, e]
    return y


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    dev = comm.device

    rng = np.random.RandomState(23)
    # gate with a dominant diagonal: token t of rank r routes to expert
    # (t + r) % size with a wide margin
    w_gate = (rng.randn(D, size) * 0.01).astype(np.float32)
    for e in range(size):
        w_gate[e, e] += 5.0
    full = {
        "w_gate": w_gate,
        "w_in": (rng.randn(size, D, DFF) * 0.2).astype(np.float32),
        "b_in": (rng.randn(size, DFF) * 0.1).astype(np.float32),
        "w_out": (rng.randn(size, DFF, D) * 0.2).astype(np.float32),
        "b_out": (rng.randn(size, D) * 0.1).astype(np.float32),
    }
    xs = (rng.randn(size, T, D) * 0.1).astype(np.float32)
    for r in range(size):
        for t in range(T):
            xs[r, t, (t + r) % size] += 3.0

    params = {
        "w_gate": torch.from_numpy(full["w_gate"]).to(dev),
        "w_in": torch.from_numpy(full["w_in"][rank]).to(dev),
        "b_in": torch.from_numpy(full["b_in"][rank]).to(dev),
        "w_out": torch.from_numpy(full["w_out"][rank]).to(dev),
        "b_out": torch.from_numpy(full["b_out"][rank]).to(dev),
    }
    x = torch.from_numpy(xs[rank].copy()).to(dev)

    # balanced routing, no drops (T/size tokens per expert < capacity)
    cap = moe.expert_capacity(T, size)
    want = _reference(full, xs[rank], size, cap)
    exact = moe.moe_ffn(x, params, comm=comm)
    np.testing.assert_allclose(exact.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-5)

    # quantized dispatch/combine: same op, same schedule, different wire
    approx = moe.moe_ffn(x, params, comm=comm, compression="int8")
    np.testing.assert_allclose(approx.cpu().numpy(), want, rtol=1e-1,
                               atol=0.2)

    # forced hierarchical schedule: a pure permutation on the wire,
    # bit-identical values to the exact run
    hier = moe.moe_ffn(x, params, comm=comm, algo="halltoall")
    np.testing.assert_allclose(hier.cpu().numpy(), exact.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)

    # tight capacity drops the overflow token per expert
    cap_tight = moe.expert_capacity(T, size, 0.5)
    assert cap_tight < T // size, (cap_tight, T // size)
    want_tight = _reference(full, xs[rank], size, cap_tight)
    tight = moe.moe_ffn(x, params, comm=comm, capacity_factor=0.5)
    np.testing.assert_allclose(tight.cpu().numpy(), want_tight, rtol=1e-4,
                               atol=1e-5)

    print("moe_ops OK", flush=True)


if __name__ == "__main__":
    main()
