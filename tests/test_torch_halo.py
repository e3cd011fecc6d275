"""The PyTorch port's halo exchange held against the JAX package's.

The setup of ``tests/parallel/test_halo.py`` (a 4x2 grid of 6x4 interior
blocks with one ghost ring), plus a (1, 4) and a (3, 1) grid: the same
blocks, made with numpy from a seed and with random values in the ghost
rings too (so that a boundary that must keep its ghosts is seen to keep
them), go through the JAX ``halo_exchange`` inside ``shard_map`` on the
CPU mesh and through the port's on CPU tensors, where ``ring_shift2``
runs the hop's plain version.  The exchange only moves values, so the
results must agree exactly.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpi4jax_tpu.parallel.grid import ProcessGrid as JaxProcessGrid
from mpi4jax_tpu.parallel.halo import halo_exchange as jax_halo_exchange

from mpi4jax_tpu_torch import ProcessGrid, halo_exchange

LOC = (6, 4)  # interior block per rank
H = 1
GRIDS = [(4, 2), (1, 4), (3, 1)]
PERIODIC = [True, False, (False, True)]
NFIELDS = [1, 3]
CASES = [(g, p, k) for g in GRIDS for p in PERIODIC for k in NFIELDS]


def _blocks(grid_shape, nfields, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(grid_shape) + (LOC[0] + 2 * H, LOC[1] + 2 * H)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(nfields)]


def _jax_exchange(grid_shape, periodic, blocks):
    grid = JaxProcessGrid(grid_shape)
    spec = P(*grid.axes)
    k = len(blocks)

    def step(*bs):
        local = tuple(b.reshape(b.shape[2:]) for b in bs)
        out = jax_halo_exchange(local if k > 1 else local[0], grid, halo=H,
                                periodic=periodic)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o.reshape((1, 1) + o.shape) for o in out)

    fn = jax.jit(jax.shard_map(step, mesh=grid.mesh, in_specs=(spec,) * k,
                               out_specs=(spec,) * k))
    return [np.asarray(o) for o in fn(*blocks)]


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for i, (g, p, k) in enumerate(CASES):
        blocks = _blocks(g, k, i)
        out[(g, str(p), k)] = (blocks, _jax_exchange(g, p, blocks))
    return out


@pytest.mark.parametrize("grid_shape,periodic,nfields", CASES)
def test_halo_exchange_matches_jax(jax_ref, grid_shape, periodic, nfields):
    blocks, ref = jax_ref[(grid_shape, str(periodic), nfields)]
    grid = ProcessGrid(grid_shape, device="cpu")
    fields = [torch.from_numpy(b.copy()) for b in blocks]
    out = halo_exchange(tuple(fields) if nfields > 1 else fields[0], grid,
                        halo=H, periodic=periodic)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == nfields
    for got, want, before, f in zip(out, ref, blocks, fields):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(f.numpy(), before)  # not modified


def test_halo_exchange_against_a_global_array():
    """The 4x2 periodic exchange fills every ghost from the global array,
    as ``tests/parallel/test_halo.py`` checks the JAX one."""
    gx, gy = 4, 2
    g = np.random.RandomState(0).rand(gx * LOC[0], gy * LOC[1]).astype(
        np.float32)
    blocks = np.zeros((gx, gy, LOC[0] + 2, LOC[1] + 2), np.float32)
    for i in range(gx):
        for j in range(gy):
            blocks[i, j, 1:-1, 1:-1] = g[i * LOC[0]:(i + 1) * LOC[0],
                                         j * LOC[1]:(j + 1) * LOC[1]]
    out = halo_exchange(torch.from_numpy(blocks),
                        ProcessGrid((gx, gy), device="cpu")).numpy()
    gp = np.pad(g, 1, mode="wrap")
    for i in range(gx):
        for j in range(gy):
            np.testing.assert_array_equal(
                out[i, j], gp[i * LOC[0]:(i + 1) * LOC[0] + 2,
                              j * LOC[1]:(j + 1) * LOC[1] + 2])


def test_halo_exchange_rejects_a_field_without_the_grid_axes():
    grid = ProcessGrid((2, 2), device="cpu")
    with pytest.raises(ValueError, match="grid's shape"):
        halo_exchange(torch.zeros(8, 6), grid)
