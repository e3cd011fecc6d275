"""The world alltoall family and MoE on a world comm with CUDA tensors
(marked ``gpu``; skips without a card).  This file imports no JAX, so it
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_world_a2a_gpu.py

One 4-rank job of ``benchmarks/moe_world.py``'s test mode on the card
(``r0,r1|r2,r3``, the shm arena off, every rank on ``cuda:0``, staged
through pinned host memory): the auto pick, ring, qalltoall, halltoall,
hqalltoall and ``compression="int8"`` on f32, bf16 and int32 payloads of
3, 513 and 20000 elements a chunk, every rank bit for bit the port's
simulators (``topo/_simulate.py``); ``moe_ffn`` on the world comm against
the port's mesh ``moe_ffn`` on the CPU on the same parameters (rtol 1e-4,
atol 1e-5: cuBLAS and the CPU sum the products in other orders),
``halltoall`` bit for bit the exact route, int8 and ``hqalltoall`` within
the JAX package's int8 bound (rtol 1e-1, atol 0.2).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch import topo
from mpi4jax_tpu_torch.benchmarks import moe_world as mw
from mpi4jax_tpu_torch.parallel import moe

pytestmark = pytest.mark.gpu

LABELS = ("auto", "ring", "qalltoall", "halltoall", "hqalltoall", "int8")


@pytest.fixture(scope="module")
def job():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with tempfile.TemporaryDirectory(prefix="world_a2a_gpu_") as tmp:
        yield mw.run_job(4, tmp, device="cuda", fake_hosts="r0,r1|r2,r3",
                         env={"MPI4JAX_TPU_DISABLE_SHM": "1",
                              "MPI4JAX_TPU_TUNE_CACHE":
                                  os.path.join(tmp, "none.json")},
                         timeout=300)


def test_family_matches_the_simulators_on_the_card(job):
    islands = [[0, 1], [2, 3]]
    for count in mw.FAMILY_COUNTS:
        for dt, arr in mw.family_inputs(4, count).items():
            inputs = [arr[r] for r in range(4)]
            for label in LABELS:
                if dt == "int32" and label == "int8":
                    continue
                want = mw.family_expected(topo, inputs, islands, label, dt)
                for r in range(4):
                    assert np.array_equal(job[r][f"{dt}|{label}|{count}"],
                                          want[r]), (dt, label, count, r)


def test_world_moe_on_the_card(job):
    params, xs = mw.small_moe_inputs(4)
    comm = mt.make_mesh(4, device="cpu")
    want = moe.moe_ffn(torch.from_numpy(xs),
                       moe.params_from_numpy(params, "cpu"),
                       comm=comm).numpy()
    for r in range(4):
        exact = job[r]["moe|auto"]
        np.testing.assert_allclose(exact, want[r], rtol=1e-4, atol=1e-5)
        assert np.array_equal(job[r]["moe|halltoall"], exact)
        for label in ("int8", "hqalltoall"):
            np.testing.assert_allclose(job[r][f"moe|{label}"], exact,
                                       rtol=mw.INT8_RTOL, atol=mw.INT8_ATOL)
        assert bool(job[r]["grad_raises"])
