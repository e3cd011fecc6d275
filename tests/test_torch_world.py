"""The port's world tier on the CPU: launched ranks, the native transport
and the hierarchical allreduce's intra-island leg.

Two jobs of 4 ranks (``device="cpu"``) on ``--fake-hosts 'r0,r1|r2,r3'``,
through the port's launcher (``benchmarks/ici_leg.run_job``), with
``MPI4JAX_TPU_ICI_LEG=force``, exact and with
``MPI4JAX_TPU_COLL_QUANT=force``.  In each, every rank's f32 SUM
allreduce under ``algo="hring"`` and ``"htree"`` at 3, 513 and 70000
elements is held bit for bit to the port's simulators
(``simulate_h{ring,tree}_sum(..., intra="ring")`` or
``simulate_ici_q_sum``, which ``tests/test_torch_topo.py`` holds to the
JAX package's), all ranks hold the same bits, and the quantized result is
within 5e-2 of the exact sum: the assertions of
``tests/world_programs/topo_ops.py:100-170`` on the f32 SUM rows.  Each
job has a hard timeout of 60 s (the launcher reaps the group).

The transport is built from ``native/tpucomm.cc`` here (g++); without g++
the tests that need it skip, saying so.  The world front's argument checks
need no transport.
"""

import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu
from mpi4jax_tpu import tune as jtune
from mpi4jax_tpu.runtime import transport as jtransport
from mpi4jax_tpu_torch import ops
from mpi4jax_tpu_torch import tune as ttune
from mpi4jax_tpu_torch.benchmarks import ici_leg
from mpi4jax_tpu_torch.ops import quantized
from mpi4jax_tpu_torch.runtime import bridge, transport


@pytest.fixture(scope="module")
def built():
    """The transport's build, started in the background: the first job's
    ranks import torch meanwhile, then wait on the build's lock."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("g++ is not on PATH: the native transport cannot be "
                    "built here")
    thread = threading.Thread(target=bridge.build, daemon=True)
    thread.start()
    yield thread
    thread.join()


@pytest.mark.parametrize("label", ["hring+ici", "hring+q+ici"])
def test_path_g_on_cpu_ranks(built, label):
    rec = ici_leg.run_job(label, device="cpu", algos=("hring", "htree"),
                          check_counts=(3, 513, 70000), timeout=60)
    assert rec["device"] == "cpu" and rec["leg"] is True
    assert rec["quant"] is ("+q" in label)
    assert rec["islands"] == [[0, 1], [2, 3]]
    assert [(c["count"], c["algo"]) for c in rec["checks"]] == [
        (c, a) for c in (3, 513, 70000) for a in ("hring", "htree")]
    for c in rec["checks"]:
        # bit for bit against the simulator, on every rank
        assert c["check"] == "bits"
        assert c["rel_err"] < ici_leg.QUANT_BOUND
        assert (c["rel_err"] > 0) is rec["quant"]
        # the CPU route runs the plain versions: no kernel launch
        assert c["launches"] == {"fused_ring": 0, "quant_pack": 0}


@pytest.mark.parametrize("n", [1, 257, 70000])
def test_transport_codec_is_the_plain_frame(built, n):
    built.join()
    bridge.build()  # raises with g++'s messages if the build failed
    for name, x in quantized.check_inputs(n).items():
        plain = quantized.quant_pack_plain(torch.from_numpy(x)).numpy()
        assert np.array_equal(bridge.quant_pack(x), plain), name
    assert bridge.quant_packed_bytes(n) == quantized.quant_packed_bytes(n)


def test_world_front_checks_need_no_transport(monkeypatch):
    comm = transport.WorldComm(0, 4, "127.0.0.1:1", device="cpu")
    jcomm = jtransport.WorldComm(0, 4, "127.0.0.1:1")
    x = torch.ones(8)
    # what the JAX front rejects with ValueError, the port's does too
    for kw in ({"algo": "bogus"}, {"compression": "fp8"},
               {"algo": "ring", "compression": "int8"},
               {"algo": "qalltoall"}):
        with pytest.raises(ValueError):
            mpi4jax_tpu.allreduce(jnp.ones(8), comm=jcomm, **kw)
        with pytest.raises(ValueError):
            ops.allreduce(x, comm=comm, **kw)
    # a token that is no tensor raises TypeError before any transport use
    # (the token API is ported; the JAX package's optimization_barrier
    # raises TypeError on such a token)
    rows = torch.ones(4, 2)
    for call in (lambda: ops.allreduce(x, comm=comm, token=object()),
                 lambda: ops.bcast(x, 0, comm=comm, token=object()),
                 lambda: ops.barrier(comm=comm, token=object()),
                 lambda: ops.alltoall(rows, comm=comm, token=object())):
        with pytest.raises(TypeError, match="token"):
            call()
    # an allreduce schedule on the alltoall, and int8 with algo=, are
    # refused by both fronts before any transport use
    for kw in ({"algo": "qring"}, {"algo": "qalltoall",
                                   "compression": "int8"}):
        with pytest.raises(ValueError):
            mpi4jax_tpu.alltoall(jnp.ones((4, 2)), comm=jcomm, **kw)
        with pytest.raises(ValueError):
            ops.alltoall(rows, comm=comm, **kw)
    # the operator's override resolves as in the JAX package: a bare name
    # forces every op that has it, a malformed value raises ValueError
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "ring")
    assert ttune.decision_table() == jtune.decision_table()
    monkeypatch.setenv("MPI4JAX_TPU_COLL_ALGO", "allreduce=warp")
    for engine in (ttune, jtune):
        with pytest.raises(ValueError, match="unknown collective"):
            engine.decision_table()
    monkeypatch.delenv("MPI4JAX_TPU_COLL_ALGO")
    # a bad root, source or destination raises before any transport use,
    # with the JAX world fronts' exception
    for name, args in (("bcast", (4,)), ("gather", (-1,)),
                       ("scatter", (4,)), ("reduce", ("SUM", 4))):
        with pytest.raises(TypeError, match="out of range"):
            getattr(mpi4jax_tpu, name)(jnp.ones((4, 2)), *args, comm=jcomm)
        with pytest.raises(TypeError, match="out of range"):
            getattr(ops, name)(rows, *args, comm=comm)
    with pytest.raises(TypeError, match="out of range"):
        ops.send(x, 4, comm=comm)
    with pytest.raises(TypeError, match="out of range"):
        ops.recv(x, 9, comm=comm)
    with pytest.raises(TypeError, match="out of range"):
        ops.neighbor_exchange(x, x, lo=7, hi=None, comm=comm)
    # a tensor on another device than the comm's raises, nothing moves
    with pytest.raises(ValueError, match="meta"):
        ops.allgather(torch.ones(2, device="meta"), comm=comm)
    assert comm._handle is None  # nothing touched the transport


def test_world_allreduce_gradient_is_the_identity(monkeypatch):
    """The reference's transposed pass: the cotangent passes unchanged
    (the transport is replaced by a sum of 4 equal ranks)."""
    from mpi4jax_tpu_torch.ops import _world_impl

    monkeypatch.setattr(_world_impl, "_allreduce",
                        lambda x, comm, op_code, algo: (x * 4).detach())
    comm = transport.WorldComm(0, 4, "127.0.0.1:1", device="cpu")
    x = torch.arange(6, dtype=torch.float32).requires_grad_()
    y = ops.allreduce(x, comm=comm, algo="hring")
    assert torch.equal(y, torch.arange(6, dtype=torch.float32) * 4)
    (y * torch.arange(6.0)).sum().backward()
    assert torch.equal(x.grad, torch.arange(6.0))


def test_world_comm_outside_a_world(monkeypatch):
    for var in ("MPI4JAX_TPU_RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK",
                "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    assert transport._detect_rank_size() is None
    with pytest.raises(RuntimeError, match="launch"):
        transport.get_world_comm(device="cpu")
    monkeypatch.setenv("SLURM_PROCID", "1")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert transport._detect_rank_size() is None  # a batch step, no srun
    monkeypatch.setenv("SLURM_LAUNCH_NODE_IPADDR", "10.0.0.1")
    assert transport._detect_rank_size() == (1, 4)
    assert transport.WorldComm(1, 4, "x:1", device="cpu").device.type == \
        "cpu"
