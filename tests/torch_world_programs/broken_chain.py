"""A forked token chain in explicit-token mode: a world op binds a fresh,
unrooted token while another chain on the same comm is live
(``BROKEN_MODE=fresh_token``, the default), or runs with no token amid a
chain (``BROKEN_MODE=no_token``).

The torch twin of ``tests/world_programs/broken_chain.py``.  The port runs
eagerly, so the job itself is ordered; the static verifier's chain guard
reports the hazard (``token_violation``), and with
``MPI4JAX_TPU_STRICT_TOKENS=1`` raises it, as the JAX package's guard does
at trace time.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch.compat import token_api as tk  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")

comm = get_world_comm(device=DEVICE)
rank, size = comm.rank(), comm.size()

mode = os.environ.get("BROKEN_MODE", "fresh_token")

with mt.explicit_token_ordering():

    def bad(x):
        token = tk.create_token(x)
        if mode == "fresh_token":
            # both ranks thread the first op's chain, then bind a SECOND
            # op with a fresh UNROOTED token while the first chain is live
            token = tk.send(x, dest=(rank + 1) % size, tag=7, comm=comm,
                            token=token)
            rogue = tk.create_token()          # <- the bug
            got, _ = tk.recv(torch.zeros_like(x), source=(rank - 1) % size,
                             tag=7, comm=comm, token=rogue)
        else:  # "no_token": a primary-API (tokenless) op amid a chain
            token = tk.send(x, dest=(rank + 1) % size, tag=7, comm=comm,
                            token=token)
            got = mt.recv(torch.zeros_like(x), source=(rank - 1) % size,
                          tag=7, comm=comm)   # <- the bug
        return got

    try:
        bad(torch.arange(4.0, device=comm.device))
    except RuntimeError as err:
        assert "UNDEFINED" in str(err), err
        print(f"broken_chain CAUGHT AT TRACE TIME r{rank}", flush=True)
        sys.exit(0)

print("UNREACHABLE", flush=True)
