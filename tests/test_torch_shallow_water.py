"""The PyTorch port's shallow-water solver held against the JAX package.

The same initial state and the same steps go through the JAX solver (its
plain XLA step, ``impl="xla"``) and through the port on the CPU, and must
agree to the JAX package's own kernel-vs-XLA tolerance
(``tests/models/test_sw_pallas.py``) wherever they start from the same
state and go at most a few steps.  The JAX references are computed once per
module.

Runs of many free steps get a wider absolute tolerance: XLA on the CPU
contracts multiply-adds into FMAs and divides by a constant through its
reciprocal, PyTorch does neither, and the dynamics carry the one-ulp
differences along (about 3e-6 in v, whose scale is 0.1, after 12 steps at
32x64).  Each step of such a run is also held to the tight tolerance from
the JAX state before it.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mpi4jax_tpu.models.shallow_water import ShallowWater as JaxShallowWater
from mpi4jax_tpu.models.shallow_water import SWParams as JaxSWParams
from mpi4jax_tpu.models.shallow_water import SWState as JaxSWState
from mpi4jax_tpu.parallel.grid import ProcessGrid

from mpi4jax_tpu_torch import ShallowWater, SWParams
from mpi4jax_tpu_torch.models.shallow_water import (
    state_from_numpy,
    state_to_numpy,
)

RTOL, ATOL = 2e-5, 1e-6
FREE_ATOL = 1e-5  # after many free steps (see the module docstring)
REPO = Path(__file__).resolve().parent.parent


def _jax_model(ny, nx):
    grid = ProcessGrid((1, 1), devices=jax.devices()[:1])
    return JaxShallowWater(grid, (ny, nx), JaxSWParams(dx=5e3, dy=5e3))


def _torch_model(ny, nx):
    return ShallowWater((ny, nx), SWParams(dx=5e3, dy=5e3), device="cpu")


def _np(state):
    return tuple(np.asarray(f) for f in state)


def _assert_state_close(got, ref, what, atol=ATOL):
    names = ("h", "u", "v", "dh", "du", "dv")
    for name, a, b in zip(names, got, ref):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=RTOL, atol=atol,
            err_msg=f"field {name} {what}",
        )


@pytest.fixture(scope="module")
def jax_ref():
    """JAX states at 32x64: ``"init"`` and the states after 1..12 steps."""
    model = _jax_model(32, 64)
    states = {"init": model.init()}
    first = model.step_fn(1, first=True, impl="xla")
    step = model.step_fn(1, impl="xla")
    states[1] = first(states["init"])
    for k in range(2, 13):
        states[k] = step(states[k - 1])
    return {k: _np(v) for k, v in states.items()}


def test_init_matches_jax(jax_ref):
    _assert_state_close(_torch_model(32, 64).init(), jax_ref["init"], "at init")


@pytest.mark.parametrize("n_steps", [1, 12])
def test_plain_steps_match_jax(jax_ref, n_steps):
    model = _torch_model(32, 64)
    s = model.step_fn(1, first=True, impl="plain")(model.init())
    s = model.step_fn(n_steps - 1, impl="plain")(s)
    _assert_state_close(s, jax_ref[n_steps], f"after {n_steps} steps",
                        atol=ATOL if n_steps == 1 else FREE_ATOL)


@pytest.mark.parametrize("k", range(1, 13))
def test_each_plain_step_matches_jax(jax_ref, k):
    """Step k of the 12 from the JAX state before it, at the tight
    tolerance."""
    model = _torch_model(32, 64)
    before = state_from_numpy(jax_ref["init" if k == 1 else k - 1], "cpu")
    s = model.step_fn(1, first=k == 1, impl="plain")(before)
    _assert_state_close(s, jax_ref[k], f"at step {k}")


def test_auto_on_cpu_runs_plain(jax_ref):
    model = _torch_model(32, 64)
    s = model.step_fn(12, first=True)(
        state_from_numpy(jax_ref["init"], "cpu"))
    _assert_state_close(s, jax_ref[12], "after 12 steps of impl='auto'",
                        atol=FREE_ATOL)


def test_carried_jax_state_advances_alike(jax_ref):
    """A JAX state after 5 steps, carried across, goes 5 steps more."""
    model = _torch_model(32, 64)
    s5 = state_from_numpy(jax_ref[5], "cpu")
    _assert_state_close(state_to_numpy(s5), jax_ref[5], "carried across")
    s10 = model.step_fn(5, impl="plain")(s5)
    _assert_state_close(state_to_numpy(s10), jax_ref[10],
                        "5 steps after the carry", atol=FREE_ATOL)


def test_mass_conserved_over_20_steps():
    model = _torch_model(32, 64)
    s0 = model.init()
    s = model.step_fn(21, first=True)(s0)
    m0, m1 = model.total_mass(s0), model.total_mass(s)
    assert abs(m1 - m0) / abs(m0) < 1e-5


def test_interior_and_mass_match_jax(jax_ref):
    jmodel = _jax_model(32, 64)
    model = _torch_model(32, 64)
    s12 = state_from_numpy(jax_ref[12], "cpu")
    np.testing.assert_array_equal(model.interior(s12.h),
                                  jmodel.interior(jax_ref[12][0]))
    assert model.total_mass(s12) == pytest.approx(
        jmodel.total_mass(JaxSWState(*jax_ref[12])), rel=1e-6)


def test_no_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShallowWater((16, 32))


def test_kernel_impl_rejects_cpu_state():
    model = _torch_model(16, 32)
    with pytest.raises(ValueError, match="CUDA state"):
        model.step_fn(1, first=True, impl="kernel")(model.init())


@pytest.mark.parametrize("grid", [(2, 1), (1, 4), (2, 2)])
def test_undivided_domain_and_several_devices_raise(grid):
    with pytest.raises(ValueError, match="not divisible"):
        ShallowWater((15, 30), grid=grid, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ShallowWater((16, 32), grid=grid, device=["cuda:0", "cuda:1"])


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown impl"):
        _torch_model(16, 32).step_fn(1, impl="xla")


def test_port_imports_no_jax():
    """Every module of the port, imported, brings in neither JAX nor the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys, mpi4jax_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mpi4jax_tpu' or m.startswith('mpi4jax_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_port_sources_import_no_jax():
    """No source of the port, nor ``chip_smoke.py``, has an import line
    that names JAX or the JAX package."""
    paths = [*(REPO / "mpi4jax_tpu_torch").rglob("*.py"),
             REPO / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert mod.split(".")[0] not in ("jax", "mpi4jax_tpu"), (
                    f"{path}: {line}")


def test_cli_runs_on_cpu(capsys):
    from mpi4jax_tpu_torch.examples import shallow_water as cli

    result = cli.main(["--device", "cpu", "--size", "32", "64",
                       "--days", "0.01", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert line["domain"] == [32, 64] and line["device"] == "cpu"
    assert line["steps"] == int(0.01 * 86_400 / SWParams(5e3, 5e3).dt) - 1
    assert line["seconds"] > 0
