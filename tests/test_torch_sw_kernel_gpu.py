"""The fused-step CUDA kernel against its plain version, on the card.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sw_kernel_gpu.py

One launch is compared on the check states of
``mpi4jax_tpu_torch/models/_sw_check.py`` (the initial jet with seeded
grid-scale noise, at the solver's viscosity and at 1000x it), each field
within ``CHECK_TOL`` of its scale.  The 8-step run through ``step_fn``
starts from the smooth jet and allows rtol 2e-5 / atol 1e-5: nvcc contracts
multiply-adds into FMAs, which moves a result by an ulp or so per step,
and the dynamics carry such differences along.
"""

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch.models import _sw_check, _sw_kernel
from mpi4jax_tpu_torch.models.shallow_water import ShallowWater, SWParams

RTOL = 2e-5
SHAPES = [(32, 64), (16, 32), (22, 32), (70, 32), (70, 50)]
PARAMS = SWParams(dx=5e3, dy=5e3)


def _assert_state_close(got, ref, what, atol):
    for name, a, b in zip(("h", "u", "v", "dh", "du", "dv"), got, ref):
        np.testing.assert_allclose(
            a.cpu().numpy(), b.cpu().numpy(), rtol=RTOL, atol=atol,
            err_msg=f"field {name} {what}",
        )


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", [None, (16, 16)])
def test_cuda_kernel_matches_plain(cuda, shape, tile):
    before = _sw_kernel.LAUNCHES
    launched = 0
    for params in (PARAMS, _sw_check.StiffParams(dx=5e3, dy=5e3)):
        for s, first, fuse in _sw_check.cases(shape, params, cuda, (1, 2, 3)):
            got = _sw_kernel.fused_step(s, params, first=first, fuse=fuse,
                                        tile=tile)
            torch.cuda.synchronize()
            launched += 1
            ref = _sw_kernel.fused_step_plain(s, params, first=first,
                                              fuse=fuse)
            for name, (diff, rel) in zip(("h", "u", "v", "dh", "du", "dv"),
                                         _sw_check.errors(got, ref, s)):
                assert rel <= _sw_check.CHECK_TOL, (
                    f"field {name} {type(params).__name__} first={first} "
                    f"fuse={fuse} tile={tile} at {shape}: {diff:.3e} "
                    f"({rel:.3e} of its scale)")
    assert _sw_kernel.LAUNCHES == before + launched


@pytest.mark.gpu
def test_cuda_step_fn_runs_the_kernel(cuda):
    model = ShallowWater((70, 32), PARAMS, device=cuda)
    s0 = model.init()
    before = _sw_kernel.LAUNCHES
    got = model.step_fn(8, first=True, fuse=3)(s0)
    assert _sw_kernel.LAUNCHES == before + 1 + 2 + 1
    ref = model.step_fn(8, first=True, impl="plain")(s0)
    _assert_state_close(got, ref, "after 8 steps", atol=1e-5)
