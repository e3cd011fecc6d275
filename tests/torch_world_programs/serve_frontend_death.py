"""The frontend's death releases the survivors: the torch twin of
``tests/world_programs/serve_frontend_death.py`` on the toy plane
(``elastic/serving.py``; the KV-cache plane is not ported).

Rank 0, the frontend, is killed by ``MPI4JAX_TPU_FAULT`` mid-serve.  Its
request state cannot be recovered, but the worker promoted to rank 0 by the
recovery broadcasts STOP, releasing the other survivors from the broadcast
they re-entered, before it raises.  Markers: ``fd promoted clean rN`` (the
promoted worker raised after the release) and ``fd worker done rN`` (every
other survivor returned).

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 --elastic \\
        serve_frontend_death.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from elastic_serve import decode_fn  # noqa: E402

from mpi4jax_tpu_torch.elastic import serving  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402


def run_frontend(comm):
    """Serve until the injected fault kills this process."""
    server = serving.Server(comm, decode_fn, max_batch=4)
    for i in range(8):
        server.submit([i + 1, 2 * i + 1], max_new=6)
    server.run_until_drained()
    server.stop()
    print("fd frontend drained (fault did not fire?)", flush=True)


def run_worker(comm):
    try:
        serving.serve_worker(comm, decode_fn)
        print(f"fd worker done r{comm.rank()}", flush=True)
    except RuntimeError as e:
        assert "became the frontend" in str(e), e
        print(f"fd promoted clean r{comm.rank()}", flush=True)


def main():
    comm = get_world_comm(device="cpu")
    _ = comm.handle
    if comm.rank() == 0:
        run_frontend(comm)
    else:
        run_worker(comm)


if __name__ == "__main__":
    main()
