"""The port's world-tier shallow-water solver held to the JAX package's.

The grids of ``tests/world/test_world_tier.py:355-375``: (1, 1), (1, 2)
and (2, 2) at 64x128 and (2, 3) at 66x126, for 0.02 model day.  One job
of ``mpi4jax_tpu_torch/benchmarks/sw_world.py`` (6 ranks, ``device="cpu"``,
through the port's launcher) runs each grid on a sub-communicator of its
first ``gy * gx`` ranks, while the JAX references compile in this process.
Rank 0's gathered ``h``, ``u`` and ``v`` are held to the JAX package's 1x1
``ShallowWater`` (``impl="xla"``) on the same domain, within that test's
``rtol=2e-4`` and ``atol=2e-4``.  The grids cover the self-wrap (one rank),
the two-rank periodic ring, the 2x2 of ``BASELINE.json`` and a periodic
ring of three.
"""

import os
import shutil
import tempfile
import threading

import jax
import numpy as np
import pytest

from mpi4jax_tpu.models.shallow_water import ShallowWater as JaxSW
from mpi4jax_tpu.models.shallow_water import SWParams as JaxParams
from mpi4jax_tpu.parallel.grid import ProcessGrid as JaxGrid

from mpi4jax_tpu_torch.benchmarks import sw_world

GRIDS = {(1, 1): (64, 128), (1, 2): (64, 128), (2, 2): (64, 128),
         (2, 3): (66, 126)}
DAYS = 0.02
RTOL = ATOL = 2e-4


def _jax_fields(size):
    params = JaxParams(dx=5e3, dy=5e3)
    n_steps = int(DAYS * params.day_seconds / params.dt)
    ref = JaxSW(JaxGrid((1, 1), devices=jax.devices()[:1]), size, params)
    s = ref.step_fn(1, first=True)(ref.init())
    s = ref.step_fn(n_steps - 1, first=False, impl="xla")(s)
    return {k: np.asarray(ref.interior(getattr(s, k))) for k in "huv"}


@pytest.fixture(scope="module")
def runs():
    """One job of 6 ranks runs the four grids on sub-communicators of its
    first ``gy * gx`` ranks while the JAX references compile: 6 rank
    processes, not 13."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("g++ is not on PATH: the native transport cannot be "
                    "built here")
    tmp = tempfile.mkdtemp(prefix="sw_world_")
    out, errors = {}, []

    def job():
        try:
            out.update(sw_world.run_job(
                sorted(GRIDS.items(), key=lambda r: -r[0][0] * r[0][1]), tmp,
                days=DAYS, device="cpu", timeout=120))
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    thread = threading.Thread(target=job)
    thread.start()
    refs = {size: _jax_fields(size) for size in set(GRIDS.values())}
    thread.join()
    if errors:
        raise RuntimeError(f"the sw_world job failed: {errors}")
    yield {grid: (*out[grid], refs[size]) for grid, size in GRIDS.items()}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_world_solver_matches_the_jax_solver(runs, grid):
    rec, fields, ref = runs[grid]
    assert rec["grid"] == list(grid) and rec["ranks"] == grid[0] * grid[1]
    assert rec["size"] == list(GRIDS[grid])
    assert rec["steps"] == int(DAYS * JaxParams(dx=5e3, dy=5e3).day_seconds
                               / JaxParams(dx=5e3, dy=5e3).dt) - 1
    for k in "huv":
        assert fields[k].shape == GRIDS[grid]
        np.testing.assert_allclose(fields[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_world_solver_record(runs, grid):
    """Five exchanges a step, the mass held, and a halo share in [0, 1]."""
    rec, _, _ = runs[grid]
    assert rec["exchanges_per_step"] == 5
    assert rec["mass_drift"] < 1e-6
    assert 0 <= rec["halo_share"] <= rec["halo_share_max"] <= 1
    assert rec["seconds"] > 0 and rec["device"] == "cpu"
