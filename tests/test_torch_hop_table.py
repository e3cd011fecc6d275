"""The hop kernel's launch tables past 64 (rank, payload) pairs, on the CPU.

One hop launch holds at most ``MAX_PAIRS`` pairs in its parameter table
(``csrc/hop.cu``); a larger hop takes several launches.  These tests replay
the kernel route's table building on CPU tensors, with ``on_kernel``
forced true and ``_build.library`` replaced by a recorder of the pairs each
launch would copy (no kernel runs, so the outputs are not compared here;
``tests/test_torch_collectives_gpu.py`` holds the kernel's results to the
plain route on the card).  Each (rank, payload) pair must be launched
exactly once, no launch may hold more than ``MAX_PAIRS`` pairs, and a hop
of ``MAX_PAIRS`` pairs or fewer stays one launch.
"""

import contextlib
import ctypes
import types

import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import _collectives as coll


class _HopLaunch:
    """Stands in for the loaded library's ``hop_launch``: records the
    (source, target, bytes) triples of each launch."""

    argtypes = None
    restype = None

    def __init__(self):
        self.launches = []

    def __call__(self, src, dst, nbytes, m, stream):
        def read(addr, ctype):
            return list((ctype * m).from_address(addr))

        self.launches.append(list(zip(read(src, ctypes.c_ulonglong),
                                      read(dst, ctypes.c_ulonglong),
                                      read(nbytes, ctypes.c_longlong))))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    launch = _HopLaunch()
    lib = types.SimpleNamespace(hop_launch=launch)
    monkeypatch.setattr(coll, "on_kernel", lambda x: True)
    monkeypatch.setattr(coll._build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return launch


def _pairs(launches):
    return [p for launch in launches for p in launch]


def _shift_pairs(x, out, n, shift):
    block = x.numel() * x.element_size() // n
    return {(x.data_ptr() + r * block,
             out.data_ptr() + ((r + shift) % n) * block, block)
            for r in range(n)}


@pytest.mark.parametrize("n,launches", [(64, 1), (65, 2), (130, 3)])
def test_ring_shift_past_the_cap(recorder, n, launches):
    comm = mt.make_mesh(n, device="cpu")
    x = torch.zeros(n, 5)
    out = coll.ring_shift(x, comm, 1)
    assert len(recorder.launches) == launches
    assert max(map(len, recorder.launches)) <= coll.MAX_PAIRS
    pairs = _pairs(recorder.launches)
    assert len(pairs) == n and set(pairs) == _shift_pairs(x, out, n, 1)


@pytest.mark.parametrize("n,launches", [(32, 1), (33, 2), (65, 3)])
def test_ring_shift_n_past_the_cap(recorder, n, launches):
    comm = mt.make_mesh(n, device="cpu")
    x, y = torch.zeros(n, 4), torch.zeros(n, 2, dtype=torch.float64)
    a, b = coll.ring_shift_n((x, y), comm, 1)
    assert len(recorder.launches) == launches
    assert max(map(len, recorder.launches)) <= coll.MAX_PAIRS
    pairs = _pairs(recorder.launches)
    assert len(pairs) == 2 * n
    assert set(pairs) == _shift_pairs(x, a, n, 1) | _shift_pairs(y, b, n, 1)


@pytest.mark.parametrize("shape", [(6, 6), (8, 8)])
def test_halo_exchange_on_large_grids(recorder, shape):
    grid = mt.ProcessGrid(shape, device="cpu")
    f = torch.zeros(*shape, 2, 6, 7)
    mt.halo_exchange(f, grid)
    ranks = shape[0] * shape[1]
    # one ring_shift2 per grid dimension, two payloads of every mesh rank
    per_call = -(-2 * ranks // coll.MAX_PAIRS)
    assert len(recorder.launches) == 2 * per_call
    assert max(map(len, recorder.launches)) <= coll.MAX_PAIRS
    for call in range(2):
        pairs = _pairs(recorder.launches[call * per_call:
                                         (call + 1) * per_call])
        assert len(pairs) == len(set(pairs)) == 2 * ranks


def test_allreduce_on_65_ranks(recorder):
    comm = mt.make_mesh(65, device="cpu")
    x = torch.zeros(65, 3)
    mt.allreduce(x, comm=comm)  # the reduce-scatter / all-gather arm
    assert coll.allreduce_arm(3, 65) == "hop_rs_ag"
    assert recorder.launches
    # each hop is one ring_shift of 65 pairs: two launches
    assert all(len(launch) <= coll.MAX_PAIRS for launch in recorder.launches)
    assert len(_pairs(recorder.launches)) == 65 * len(recorder.launches) // 2
