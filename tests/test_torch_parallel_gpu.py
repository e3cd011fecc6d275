"""The port's parallel layers on the card: launch counts per path (tp's
row-parallel allreduce among them), the kernel route against the plain
route (``_collectives.use_plain()``), and the int8 mesh allreduce on
kernel 2, at small widths.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_parallel_gpu.py

The routes differ only in the collectives, which the kernels compute bit
for bit as their plain versions do, so every comparison here is bit for bit
(the DP step with ``torch.backends.cudnn.deterministic``); the int8
allreduce is held bit for bit to the numpy oracle of its schedule
(``quantized.quantized_allreduce_ref``, IEEE f32).
"""

import contextlib

import numpy as np
import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.benchmarks import alltoall_family as af
from mpi4jax_tpu_torch.benchmarks import pp_step, resnet_step
from mpi4jax_tpu_torch.models import pp_transformer as ppm
from mpi4jax_tpu_torch.models import resnet
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.ops import quantized
from mpi4jax_tpu_torch.parallel import tp

RESNET = resnet.ResNetConfig(stages=(1, 1), widths=(8, 16), n_classes=10,
                             groups=4, block="bottleneck", stem="imagenet")
PPCFG = ppm.GPTConfig(vocab=128, d_model=64, n_heads=4, n_layers=4,
                      d_ff=128, max_seq=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dp_step_launches_and_matches_plain(cuda, dtype):
    cfg = RESNET._replace(dtype=dtype)
    rec, _ = resnet_step.run(4, 1, cfg=cfg, batch=8, image=32, device=cuda)
    want = rec["expected_launches"]
    assert rec["launches_per_step"] == {k: want[k] for k in ("hop",
                                                            "fused_ring")}
    assert np.all(np.isfinite(rec["losses"]))
    res = resnet_step.route_check(cfg, 4, batch=8, image=32, device=cuda)
    assert res["bit_equal"], res


@pytest.mark.gpu
@pytest.mark.parametrize("n,rows,launches", [
    (4, 8, {"hop": 2, "fused_ring": 0}),       # butterfly: log2(4) hops
    (3, 8, {"hop": 4, "fused_ring": 0}),       # reduce-scatter + gather
    (4, 1024, {"hop": 0, "fused_ring": 1}),    # 32 Ki elements a rank
])
def test_row_parallel_on_the_kernels_matches_plain(cuda, n, rows, launches):
    """tp's row-parallel layer: its one SUM allreduce on the hop or the
    fused ring, forward and backward bit for bit the plain route."""
    g = torch.Generator().manual_seed(n * rows)
    x = torch.randn(n, rows, 16, generator=g).to(cuda)
    w = torch.randn(n, 16, 32, generator=g).to(cuda)
    b = torch.randn(32, generator=g).to(cuda)
    comm = mt.make_mesh(n, device=cuda)
    res = {}
    for route in ("kernel", "plain"):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = dict(coll.LAUNCHES)
        with (coll.use_plain() if route == "plain"
              else contextlib.nullcontext()):
            y = tp.row_parallel(xs, ws, b, comm=comm)
            counted = {k: coll.LAUNCHES[k] - before[k]
                       for k in ("hop", "fused_ring")}
            (y * y).sum().backward()
        res[route] = (y.detach(), xs.grad, ws.grad, counted)
    (yk, gxk, gwk, nk), (yp, gxp, gwp, np_) = res["kernel"], res["plain"]
    assert nk == launches and np_ == {"hop": 0, "fused_ring": 0}
    assert torch.equal(yk, yp) and torch.equal(gxk, gxp)
    assert torch.equal(gwk, gwp)
    # every rank holds the whole sum
    assert torch.equal(yk[0], yk[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_step_launches_and_matches_plain(cuda, pp):
    rec, _ = pp_step.run(pp, 1, cfg=PPCFG, micro=3, batch=2, seq=64,
                         device=cuda)
    assert rec["launches_per_step"] == rec["expected_launches"]
    # a hop per tick forward, one per tick but the last backward
    ticks = 3 + pp - 1
    assert rec["expected_launches"]["hop"] >= 2 * ticks - 1
    res = pp_step.route_check(PPCFG, pp, micro=3, batch=2, seq=64,
                              device=cuda)
    assert res["bit_equal"], res


@pytest.mark.gpu
def test_ulysses_on_kernel_2(cuda):
    u = af.run_ulysses((2, 256, 8, 32), 4, 1, device=cuda)
    assert u["launches_forward"] == {"hop": 0, "fused_ring": 0,
                                     "alltoall": 4}
    assert u["launches_forward_backward"]["alltoall"] == 8
    assert u["bit_equal_forward"] and u["bit_equal_forward_backward"]
    assert u["finite"]


@pytest.mark.gpu
def test_moe_on_kernel_2(cuda):
    cfg = dict(d_model=64, d_ff=128, tokens=256, capacity_factor=1.0)
    m = af.run_moe(cfg, 4, 1, device=cuda)
    assert m["launches_forward_backward"] == {"hop": 0, "fused_ring": 0,
                                              "alltoall": 4}
    assert m["bit_equal_forward_backward"] and m["finite"]
    assert m["tokens_kept"] < m["tokens_total"]  # some tokens dropped


@pytest.mark.gpu
@pytest.mark.parametrize("n,shape", [(4, (257,)), (4, (70000,)),
                                     (8, (8, 33)), (3, (4, 4, 5))])
def test_int8_allreduce_on_kernel_2_matches_the_oracle(cuda, n, shape):
    x = np.random.RandomState(n).randn(n, *shape).astype(np.float32)
    comm = mt.make_mesh(n, device=cuda)
    before = dict(coll.LAUNCHES)
    got = mt.allreduce(torch.from_numpy(x).to(cuda), comm=comm,
                       compression="int8")
    launches = {k: coll.LAUNCHES[k] - before[k] for k in before}
    assert launches == {"hop": n - 1, "fused_ring": 0, "alltoall": 1}
    want = quantized.quantized_allreduce_ref(x)
    assert got.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.gpu
def test_int8_allreduce_keeps_bf16_and_has_zero_gradient(cuda):
    comm = mt.make_mesh(4, device=cuda)
    x = torch.randn(4, 300, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    out = mt.allreduce(x, comm=comm, compression="int8")
    assert out.dtype == torch.bfloat16
    (out.float() ** 2).sum().backward()
    assert torch.count_nonzero(x.grad) == 0
