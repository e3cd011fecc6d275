"""Continuous batching across a worker's death: the torch twin of
``tests/world_programs/elastic_serve.py``.

Rank 0 is the frontend: it submits a stream of requests, half of them
after serving started, and drains them through
``mpi4jax_tpu_torch.elastic.serving``.  The toy ``decode_fn`` is a function
of a row's tokens only, so the transcripts depend neither on the world size
nor on how often an iteration was retried: a run that loses a worker must
print the digest of an uninterrupted run, with every request completed.

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 --elastic \\
        elastic_serve.py [nreq]
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

from mpi4jax_tpu_torch.elastic import serving  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

NREQ = int(sys.argv[1]) if len(sys.argv) > 1 else 10


def decode_fn(toks, lengths, start, stop):
    """Next token per row: a function of the row's tokens alone."""
    out = torch.zeros(stop - start, dtype=torch.int32)
    for i in range(start, stop):
        n = int(lengths[i])
        row = toks[i, :n].to(torch.int64)
        out[i - start] = int((int(row.sum()) * 31 + n * 7 + int(row[-1]))
                             % 997)
    return out


def main():
    comm = get_world_comm(device="cpu")
    _ = comm.handle  # connect before the first broadcast
    if comm.rank() != 0:
        serving.serve_worker(comm, decode_fn)
        print("elastic_serve worker done", flush=True)
        return

    server = serving.Server(comm, decode_fn, max_batch=4)
    for i in range(NREQ // 2):
        server.submit([i + 1, 2 * i + 1], max_new=3 + (i % 3))
    iters = 0
    while server.active or len(server.completed) < NREQ:
        # continuous batching: the second half arrives mid-stream
        if iters == 2:
            for i in range(NREQ // 2, NREQ):
                server.submit([i + 1, 2 * i + 1], max_new=3 + (i % 3))
        server.step()
        iters += 1
        if iters > 500:
            raise RuntimeError("serving did not drain")
    server.stop()

    digest = hashlib.sha256()
    for r in sorted(server.completed, key=lambda r: r.id):
        assert r.done and len(r.generated) >= 3, (r.id, r.tokens)
        digest.update(repr((r.id, r.tokens)).encode())
    print(f"elastic_serve digest {digest.hexdigest()}", flush=True)
    print(f"elastic_serve OK nreq={len(server.completed)} "
          f"recoveries={server.recoveries}", flush=True)


if __name__ == "__main__":
    main()
