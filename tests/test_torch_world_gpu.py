"""The world tier's ops on CUDA tensors (marked ``gpu``; they skip without
a card).  This file imports no JAX, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_world_gpu.py

- the staging alone, in this process: a CUDA tensor's pinned host copy
  waits for the kernel queued before it on the stream; bf16 crosses as its
  int16 bits and comes back as bf16 on the card; a tensor on another
  device than the comm's raises ``ValueError`` before any transport use;
- one 2-rank job of ``benchmarks/world_ops.py`` on the card through the
  port's launcher: every op of the dtype sweep (bf16 among them), the f32
  schedules and the int8 allreduce held to their oracles on each rank, and
  an allreduce and a ``neighbor_exchange`` queued right behind a long
  matrix product on the same stream.
"""

import tempfile

import numpy as np
import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.benchmarks import world_ops
from mpi4jax_tpu_torch.ops import _world_impl
from mpi4jax_tpu_torch.runtime import bridge, transport

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_staging_waits_for_the_stream(dev):
    k = 4096
    m = torch.full((k, k), 1.0 / k, device=dev)
    acc = torch.full((k, k), 3.0, device=dev)
    for _ in range(8):
        acc = acc @ m  # about 1 TFLOP queued before the copy
    host = _world_impl._to_host(acc[7, :16])
    assert host.is_pinned() and host.device.type == "cpu"
    assert torch.equal(host, torch.full((16,), 3.0))


def test_bf16_crosses_as_its_bits(dev):
    x = (torch.randn(37, device=dev) * 100).to(torch.bfloat16)
    host = _world_impl._to_host(x)
    bits = _world_impl._np(host)
    assert bits.dtype == np.int16
    assert np.array_equal(bits, x.view(torch.int16).cpu().numpy())
    comm = transport.WorldComm(0, 2, "127.0.0.1:1", device=dev)
    back = _world_impl._to_device(host, comm)
    assert back.device == dev and back.dtype == torch.bfloat16
    assert torch.equal(back, x)


def test_wrong_device_raises_before_the_transport(dev):
    comm = transport.WorldComm(0, 2, "127.0.0.1:1", device=dev)
    for call in (lambda x: mt.allreduce(x, comm=comm),
                 lambda x: mt.allgather(x, comm=comm),
                 lambda x: mt.sendrecv(x, shift=1, comm=comm),
                 lambda x: mt.neighbor_exchange(x, x, lo=1, hi=1,
                                                comm=comm)):
        with pytest.raises(ValueError, match="cpu"):
            call(torch.ones(3))
    assert comm._handle is None


@pytest.fixture(scope="module")
def job(dev):
    bridge.build()
    out = tempfile.mkdtemp(prefix="world_ops_gpu_")
    rec = world_ops.run_job(2, out, device="cuda", timeout=300)
    return rec, world_ops.load_results(out, 2)


def test_world_ops_on_the_card(job):
    rec, results = job
    assert rec["device"].startswith("cuda") and rec["size"] == 2
    assert min(rec["checks_per_rank"]) > 150
    stack = world_ops.all_inputs("bfloat16", 2)
    for r in range(2):
        np.testing.assert_array_equal(results[r]["allgather/bfloat16"],
                                      stack)
        np.testing.assert_array_equal(results[r]["stream/allreduce"],
                                      np.full(5, 3.0, np.float32))
