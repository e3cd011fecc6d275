"""The PyTorch port's decomposed shallow-water solver held against the JAX
package's, on the CPU at 24x48.

The JAX solver runs on ``ProcessGrid(g)`` over the CPU mesh with its plain
XLA step (``impl="xla"``); the port runs on CPU tensors, where its halo
exchanges and the collectives of the initial condition take the plain
versions of the hop kernel.  States are compared in the JAX package's
stacked-block layout (``state_to_numpy``).

Tolerances are those of the single-block test
(``tests/test_torch_shallow_water.py``): rtol 2e-5 and atol 1e-6 wherever
both start from the same state and go one step; a free run of 10 steps
gets atol 1e-5, since XLA on the CPU contracts multiply-adds into FMAs and
PyTorch does not, and the dynamics carry the ulp differences along.  The
port's decomposed run against its own 1x1 run uses the JAX package's
decomposition tolerance (``tests/models/test_shallow_water.py``).
"""

import json

import jax
import numpy as np
import pytest

from mpi4jax_tpu.models.shallow_water import ShallowWater as JaxShallowWater
from mpi4jax_tpu.models.shallow_water import SWParams as JaxSWParams
from mpi4jax_tpu.models.shallow_water import SWState as JaxSWState
from mpi4jax_tpu.parallel.grid import ProcessGrid as JaxProcessGrid

from mpi4jax_tpu_torch import ProcessGrid, ShallowWater, SWParams
from mpi4jax_tpu_torch.models.shallow_water import (
    state_from_numpy,
    state_to_numpy,
)

NY, NX = 24, 48
GRIDS = [(2, 2), (2, 4), (3, 2), (1, 4)]
STEPS = 10
RTOL, ATOL = 2e-5, 1e-6
FREE_ATOL = 1e-5


def _torch_model(grid):
    return ShallowWater((NY, NX), SWParams(dx=5e3, dy=5e3), grid=grid,
                        device="cpu")


def _assert_state_close(got, ref, what, atol=ATOL):
    for name, a, b in zip(("h", "u", "v", "dh", "du", "dv"),
                          state_to_numpy(got), ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol,
                                   err_msg=f"field {name} {what}")


@pytest.fixture(scope="module")
def jax_ref():
    """Per grid: the JAX init and the states after 1..STEPS steps."""
    out = {}
    for g in GRIDS:
        n = g[0] * g[1]
        grid = JaxProcessGrid(g, devices=jax.devices()[:n])
        model = JaxShallowWater(grid, (NY, NX), JaxSWParams(dx=5e3, dy=5e3))
        first = model.step_fn(1, first=True, impl="xla")
        step = model.step_fn(1, impl="xla")
        states = [model.init()]
        states.append(first(states[0]))
        for _ in range(STEPS - 1):
            states.append(step(states[-1]))
        out[g] = [tuple(np.asarray(f) for f in s) for s in states]
    return out


@pytest.mark.parametrize("grid", GRIDS)
def test_init_matches_jax(jax_ref, grid):
    _assert_state_close(_torch_model(grid).init(), jax_ref[grid][0],
                        f"at init on {grid}")


@pytest.mark.parametrize("grid", GRIDS)
def test_one_step_matches_jax(jax_ref, grid):
    model = _torch_model(grid)
    s0 = state_from_numpy(jax_ref[grid][0], "cpu", grid)
    s1 = model.step_fn(1, first=True, impl="plain")(s0)
    _assert_state_close(s1, jax_ref[grid][1], f"after the Euler step on {grid}")


@pytest.mark.parametrize("grid", GRIDS)
def test_free_run_matches_jax(jax_ref, grid):
    model = _torch_model(grid)
    s = model.step_fn(STEPS, first=True)(model.init())
    _assert_state_close(s, jax_ref[grid][STEPS], f"after {STEPS} steps on "
                        f"{grid}", atol=FREE_ATOL)


@pytest.mark.parametrize("grid", GRIDS)
def test_each_step_matches_jax(jax_ref, grid):
    """Steps 2..STEPS, each from the JAX state before it."""
    model = _torch_model(grid)
    step = model.step_fn(1)
    for k in range(2, STEPS + 1):
        before = state_from_numpy(jax_ref[grid][k - 1], "cpu", grid)
        _assert_state_close(step(before), jax_ref[grid][k],
                            f"at step {k} on {grid}")


@pytest.mark.parametrize("grid", GRIDS)
def test_stacked_layout_round_trips(jax_ref, grid):
    ref = jax_ref[grid][STEPS]
    s = state_from_numpy(ref, "cpu", ProcessGrid(grid, device="cpu"))
    gy, gx = grid
    assert s.h.shape == (gy, gx, NY // gy + 2, NX // gx + 2)
    for a, b in zip(state_to_numpy(s), ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grid", GRIDS)
def test_interior_and_mass_match_jax(jax_ref, grid):
    n = grid[0] * grid[1]
    jmodel = JaxShallowWater(JaxProcessGrid(grid, devices=jax.devices()[:n]),
                             (NY, NX), JaxSWParams(dx=5e3, dy=5e3))
    model = _torch_model(grid)
    ref = jax_ref[grid][STEPS]
    s = state_from_numpy(ref, "cpu", grid)
    np.testing.assert_array_equal(model.interior(s.h), jmodel.interior(ref[0]))
    assert model.total_mass(s) == pytest.approx(
        jmodel.total_mass(JaxSWState(*ref)), rel=1e-6)


def test_decomposed_run_matches_the_single_block_run():
    m1 = _torch_model(None)
    m8 = _torch_model((2, 4))
    s1 = m1.step_fn(STEPS, first=True)(m1.init())
    s8 = m8.step_fn(STEPS, first=True)(m8.init())
    np.testing.assert_allclose(m1.interior(s1.h), m8.interior(s8.h),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m1.interior(s1.u), m8.interior(s8.u),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("grid", [(2, 2), (3, 2)])
def test_mass_conserved_over_20_steps(grid):
    model = _torch_model(grid)
    s0 = model.init()
    s = model.step_fn(20, first=True)(s0)
    m0, m1 = model.total_mass(s0), model.total_mass(s)
    assert abs(m1 - m0) / abs(m0) < 1e-5


def test_cli_runs_a_decomposed_grid_on_cpu(capsys):
    from mpi4jax_tpu_torch.examples import shallow_water as cli

    result = cli.main(["--device", "cpu", "--grid", "2", "2", "--size", "24",
                       "48", "--days", "0.01", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert line["grid"] == [2, 2] and line["domain"] == [24, 48]
    assert line["hop_launches"] == 0  # the CPU runs the hop's plain version
    assert line["halo_exchanges_per_step"] == 5
    assert line["steps"] == int(0.01 * 86_400 / SWParams(5e3, 5e3).dt) - 1
