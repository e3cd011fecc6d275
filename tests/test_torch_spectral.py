"""The PyTorch port's slab-decomposed FFT and Poisson solver, held against
the JAX package's ``models/spectral.py`` and numpy, on the CPU.

The same fields, made with numpy from a seed, go through the JAX model on
the 8-device CPU mesh of ``tests/conftest.py`` (``shard_map`` over an axis
of n devices, at the JAX test's 16x16x8) and through the port on CPU
tensors, where each transpose's alltoall runs its plain version.

Tolerance: XLA's CPU FFT and torch's (pocketfft) round differently, so the
spectra and fields are compared to ``FFT_TOL`` = 1e-6 of the largest
magnitude of the reference.  Measured on the CPU at n = 4 and 8: the port
differs from JAX by at most 1.56e-7 of it (fft3; ifft3 1.12e-7, the Poisson
solution 6.0e-8) and from numpy's float64 transforms by at most 1.31e-7,
while JAX itself is 1.38e-7 from numpy; ``FFT_TOL`` leaves a 6x margin over
the largest of these, an f32 FFT of 2048 points rounding each of its 11
stages.  The manufactured Poisson solution (u = sin x cos 2y sin z,
f = -6u) holds to 1e-3, as in ``tests/models/test_spectral.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpi4jax_tpu as m4j
from mpi4jax_tpu.models import spectral as jspectral

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.models import spectral
from mpi4jax_tpu_torch.ops import _collectives as coll

NS = (4, 8)
X, Y, Z = 16, 16, 8
FFT_TOL = 1e-6


def _manufactured():
    xs = np.linspace(0, 2 * np.pi, X, endpoint=False)
    ys = np.linspace(0, 2 * np.pi, Y, endpoint=False)
    zs = np.linspace(0, 2 * np.pi, Z, endpoint=False)
    xx, yy, zz = np.meshgrid(xs, ys, zs, indexing="ij")
    u = np.sin(xx) * np.cos(2 * yy) * np.sin(zz)
    return (-6.0 * u).astype(np.float32), u


def _fields():
    rng = np.random.default_rng(21)
    field = rng.standard_normal((X, Y, Z)).astype(np.float32)
    spec = np.fft.fftn(rng.standard_normal((X, Y, Z))).astype(np.complex64)
    return field, spec


@pytest.fixture(scope="module")
def jax_ref():
    """Per n, global arrays: fft3 of the field, ifft3 of the spectrum, and
    the Poisson solution of the manufactured right-hand side."""
    field, spec = _fields()
    rhs, _ = _manufactured()
    out = {}
    for n in NS:
        mesh = m4j.make_mesh(n, axis="fft")

        def f(fl, sl, rl):
            return (jspectral.fft3(fl, axis="fft"),
                    jspectral.ifft3(sl, axis="fft"),
                    jspectral.poisson_solve(rl, axis="fft", shape=(X, Y, Z)))

        res = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("fft"), P(None, "fft"), P("fft")),
            out_specs=(P(None, "fft"), P("fft"), P("fft")),
            check_vma=False))(jnp.asarray(field), jnp.asarray(spec),
                              jnp.asarray(rhs))
        out[n] = [np.asarray(r) for r in res]
    return out


def _x_slabs(a, n):
    """A global ``(X, Y, Z)`` array as the port's X-slab stack."""
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(n, X // n, Y, Z)


def _y_slabs(a, n):
    """A global ``(X, Y, Z)`` array as the port's Y-slab stack
    ``(n, X, Y/n, Z)``."""
    return torch.from_numpy(np.ascontiguousarray(
        a.reshape(X, n, Y // n, Z).transpose(1, 0, 2, 3)))


def _from_y_slabs(t):
    return t.numpy().transpose(1, 0, 2, 3).reshape(X, Y, Z)


def _close(got, want):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= FFT_TOL * scale, (err, scale)


@pytest.mark.parametrize("n", NS)
def test_fft3_matches_jax_and_numpy(jax_ref, n):
    field, _ = _fields()
    comm = mt.make_mesh(n, device="cpu")
    got = spectral.fft3(_x_slabs(field, n), comm=comm)
    assert got.dtype == torch.complex64 and got.shape == (n, X, Y // n, Z)
    got = _from_y_slabs(got)
    _close(got, jax_ref[n][0])
    _close(got, np.fft.fftn(field.astype(np.float64)))


@pytest.mark.parametrize("n", NS)
def test_ifft3_matches_jax_and_numpy(jax_ref, n):
    _, spec = _fields()
    comm = mt.make_mesh(n, device="cpu")
    got = spectral.ifft3(_y_slabs(spec, n), comm=comm)
    assert got.dtype == torch.complex64 and got.shape == (n, X // n, Y, Z)
    got = got.numpy().reshape(X, Y, Z)
    _close(got, jax_ref[n][1])
    _close(got, np.fft.ifftn(spec.astype(np.complex128)))


@pytest.mark.parametrize("n", NS)
def test_fft3_roundtrip(n):
    field, _ = _fields()
    comm = mt.make_mesh(n, device="cpu")
    back = spectral.ifft3(spectral.fft3(_x_slabs(field, n), comm=comm),
                          comm=comm).real
    _close(back.numpy().reshape(X, Y, Z), field)


@pytest.mark.parametrize("n", NS)
def test_poisson_matches_jax_and_the_manufactured_solution(jax_ref, n):
    rhs, u_true = _manufactured()
    comm = mt.make_mesh(n, device="cpu")
    u = spectral.poisson_solve(_x_slabs(rhs, n), comm=comm, shape=(X, Y, Z))
    assert u.dtype == torch.float32 and u.shape == (n, X // n, Y, Z)
    u = u.numpy().reshape(X, Y, Z)
    np.testing.assert_allclose(u, u_true, rtol=1e-3, atol=1e-3)
    _close(u, jax_ref[n][2])


@pytest.mark.parametrize("n,launches", [(1, 0), (4, 2), (8, 2)])
def test_one_solve_runs_two_alltoalls(monkeypatch, n, launches):
    """On the CPU each alltoall of n > 1 ranks runs ``alltoall_plain`` once,
    where the card launches the kernel once: two per solve."""
    calls = []
    plain = coll.alltoall_plain
    monkeypatch.setattr(coll, "alltoall_plain",
                        lambda x, c: calls.append(x.shape) or plain(x, c))
    rhs, u_true = _manufactured()
    comm = mt.make_mesh(n, device="cpu")
    u = spectral.poisson_solve(_x_slabs(rhs, n), comm=comm, shape=(X, Y, Z))
    assert len(calls) == launches
    np.testing.assert_allclose(u.numpy().reshape(X, Y, Z), u_true,
                               rtol=1e-3, atol=1e-3)


def test_poisson_on_a_grid_axis_is_batched_over_the_other():
    """On the column comm of a 2x4 grid, each grid row solves its own
    problem: row 1's right-hand side is twice row 0's."""
    rhs, u_true = _manufactured()
    grid = mt.ProcessGrid((2, 4), device="cpu")
    comm = grid.axis_comm(1)
    f = torch.stack([_x_slabs(rhs, 4), 2 * _x_slabs(rhs, 4)])
    with comm:
        u = spectral.poisson_solve(f, shape=(X, Y, Z))
    assert u.shape == (2, 4, X // 4, Y, Z)
    one = spectral.poisson_solve(_x_slabs(rhs, 4),
                                 comm=mt.make_mesh(4, device="cpu"),
                                 shape=(X, Y, Z))
    np.testing.assert_array_equal(u[0].numpy(), one.numpy())
    np.testing.assert_allclose(u[1].numpy().reshape(X, Y, Z), 2 * u_true,
                               rtol=1e-3, atol=1e-3)


def test_cpu_benchmark_line():
    from mpi4jax_tpu_torch.benchmarks import spectral as bench

    rec, u = bench.run(16, 4, 2, device="cpu")
    assert rec["ranks"] == 4 and rec["n"] == 16 and rec["solves"] == 2
    assert rec["device"] == "cpu" and rec["ms_per_solve"] > 0
    assert rec["alltoall_launches_per_solve"] == 0  # no kernel on the CPU
    assert rec["max_abs_err"] < 1e-3 and u.shape == (4, 4, 16, 16)
