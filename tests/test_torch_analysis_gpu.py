"""The static verifier's virtual world on CUDA tensors (marked ``gpu``;
they skip without a card).  This file imports no JAX, so it runs on the
card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_analysis_gpu.py

- every op kind and the folded dtypes, run by ``analysis.check`` on the
  card and on the CPU: the same schedule, and each rank's results bit for
  bit equal (the virtual world folds on the host in rank order either
  way, and hands a result back by a synchronous copy);
- corpus twins on the card: the same ``cache_key`` as on the CPU;
- ``autodiff.py``'s twin on the card analyzes clean, with the same
  ``cache_key`` as on the CPU: its backward world ops (the sendrecv's
  cotangent sent back) run on their rank's thread, which turns torch's
  multithreaded backward off, since the rank threads of one process would
  otherwise share autograd's one device thread and a backward waiting for
  its peer's would hold it; each is sited at the ``backward()`` line.
"""

import os
import threading

import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch import analysis
from mpi4jax_tpu_torch.analysis import _sim

pytestmark = pytest.mark.gpu

PROGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_world_programs")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _every_op(x, comm):
    rank, n = comm.rank(), comm.size()
    out = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64, torch.int32, torch.uint8):
        v = (x.abs() * (rank + 1.37)).to(dtype)
        out.append(mt.allreduce(v, op=mt.SUM, comm=comm))
        out.append(mt.allreduce(v, op=mt.MAX, comm=comm))
        out.append(mt.scan(v, op=mt.SUM, comm=comm))
        out.append(mt.reduce(v, op=mt.SUM, root=1, comm=comm))
    # made on the host: a card's linspace may round otherwise
    big = torch.linspace(-3, 5, 70000).to(x.device) * (rank + 0.3)
    out.append(mt.allreduce(big, op=mt.SUM, comm=comm))
    out.append(mt.allreduce(big, op=mt.SUM, compression="int8", comm=comm))
    out.append(mt.allgather(x, comm=comm))
    out.append(mt.gather(x, root=0, comm=comm))
    out.append(mt.bcast(x + rank, root=n - 1, comm=comm))
    out.append(mt.scatter(torch.stack([x * r for r in range(n)]), root=0,
                          comm=comm))
    out.append(mt.alltoall(torch.stack([x + 10 * r for r in range(n)]),
                           comm=comm))
    out.append(mt.sendrecv(x * rank, shift=1, comm=comm))
    lo, hi = mt.neighbor_exchange(x, x * 2, lo=(rank - 1) % n,
                                  hi=(rank + 1) % n, comm=comm)
    out += [lo, hi]
    mt.barrier(comm=comm)
    if rank == 0:
        mt.send(x * 7, dest=1, tag=3, comm=comm)
    elif rank == 1:
        out.append(mt.recv(torch.zeros_like(x), source=0, tag=3,
                           comm=comm))
    return out


def test_card_results_bit_for_bit_the_cpu_run(dev):
    x = torch.linspace(-1.5, 2.5, 257)
    cpu = analysis.check(_every_op, x, world_size=3)
    card = analysis.check(_every_op, x.to(dev), world_size=3)
    assert cpu.ok and card.ok, (cpu.format_table(), card.format_table())
    assert card.cache_key == cpu.cache_key
    for rank in range(3):
        for a, b in zip(card.results[rank], cpu.results[rank]):
            assert a.device.type == "cuda" and b.device.type == "cpu"
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.cpu().view(torch.uint8),
                               b.view(torch.uint8))


@pytest.mark.parametrize("name,np_", [
    ("basic_ops.py", 2), ("full_ops.py", 2), ("moe_ops.py", 4),
    ("status_ops.py", 2), ("neighbor_ops.py", 3)])
def test_corpus_twins_on_the_card(name, np_, dev):
    path = os.path.join(PROGS, name)
    card = analysis.check_program(path, np_, timeout_s=300,
                                  argv=["--device", "cuda"])
    cpu = analysis.check_program(path, np_, timeout_s=300,
                                 argv=["--device", "cpu"])
    assert card.ok, card.format_table()
    assert card.cache_key == cpu.cache_key


def test_autodiff_backward_on_the_card(dev, monkeypatch):
    threads = []
    real = _sim.VirtualWorld.run_op

    def spy(self, name, data, comm, **params):
        threads.append((comm.members[comm.rank()], name,
                        threading.current_thread().name))
        return real(self, name, data, comm, **params)

    monkeypatch.setattr(_sim.VirtualWorld, "run_op", spy)
    path = os.path.join(PROGS, "autodiff.py")
    card = analysis.check_program(path, 2, timeout_s=300,
                                  argv=["--device", "cuda"])
    assert card.ok, card.format_table()
    # every event, the backward's too, on its own rank's thread
    assert threads and all(t == f"analysis-rank-{r}"
                           for r, _, t in threads), threads
    monkeypatch.setattr(_sim.VirtualWorld, "run_op", real)
    cpu = analysis.check_program(path, 2, timeout_s=300,
                                 argv=["--device", "cpu"])
    assert card.cache_key == cpu.cache_key
    with open(path) as f:
        lines = f.read().splitlines()
    for rank, evs in card.events.items():
        last = evs[-1]  # the backward's sendrecv, sited at backward()
        assert last.kind == "sendrecv"
        lineno = int(last.site.split(":")[1].split(" ")[0])
        assert "backward()" in lines[lineno - 1], last.site
