"""The hop kernel's launch plans and launch arguments, on the CPU.

A hop launch takes a plan made once per hop table and device (a (k, n)
int32 table: the source rank of every output block, or -1 where the kernel
writes zeros) and, per payload, an input base, an output base and a block
length.  These tests replay the kernel route on CPU tensors, with
``on_kernel`` forced true and ``_build.library`` replaced by a recorder
that reads the plan and the launch arguments and turns them into the
(source, target, bytes) copies and the zeroed blocks the kernel would make
(no kernel runs, so the outputs are not compared here;
``tests/test_torch_collectives_gpu.py`` holds the kernel's results to the
plain route on the card).  Every hop, of any number of ranks, must be one
launch that copies each (rank, payload) pair exactly once.
"""

import contextlib
import ctypes
import struct
import types

import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import _collectives as coll


class _HopLaunch:
    """Stands in for the loaded library's ``hop_launch``: records each
    launch's copies ``(source, target, bytes)`` and zeroed blocks
    ``(target, bytes)``, read from the plan and the argument block as the
    kernel reads them."""

    argtypes = None
    restype = None

    def __init__(self):
        self.launches = []
        self.zeroed = []

    def __call__(self, plan, n, k, args, stream):
        vals = struct.unpack(f"{2 * k}Q{k}q", args)
        srcs, dsts, blocks = vals[:k], vals[k:2 * k], vals[2 * k:]
        table = list((ctypes.c_int * (n * k)).from_address(plan))
        copies, zeroed = [], []
        for i in range(k):
            for d in range(n):
                s = table[i * n + d]
                target = dsts[i] + d * blocks[i]
                if s >= 0:
                    copies.append((srcs[i] + s * blocks[i], target,
                                   blocks[i]))
                else:
                    zeroed.append((target, blocks[i]))
        self.launches.append(copies)
        self.zeroed.append(zeroed)
        return 0


@pytest.fixture
def recorder(monkeypatch):
    launch = _HopLaunch()
    lib = types.SimpleNamespace(hop_launch=launch)
    monkeypatch.setattr(coll, "on_kernel", lambda x: True)
    monkeypatch.setattr(coll._build, "library", lambda name: lib)
    monkeypatch.setattr(coll, "_stream", lambda dev: 0)
    monkeypatch.setattr(coll, "_device_guard",
                        lambda dev: contextlib.nullcontext())
    return launch


def _pairs(launches):
    return [p for launch in launches for p in launch]


def _shift_pairs(x, out, n, shift):
    block = x.numel() * x.element_size() // n
    return {(x.data_ptr() + r * block,
             out.data_ptr() + ((r + shift) % n) * block, block)
            for r in range(n)}


@pytest.mark.parametrize("n", [64, 65, 130])
def test_ring_shift_past_the_cap(recorder, n):
    comm = mt.make_mesh(n, device="cpu")
    x = torch.zeros(n, 5)
    out = coll.ring_shift(x, comm, 1)
    assert len(recorder.launches) == 1
    pairs = _pairs(recorder.launches)
    assert len(pairs) == n and set(pairs) == _shift_pairs(x, out, n, 1)
    assert recorder.zeroed == [[]]


@pytest.mark.parametrize("n", [32, 33, 65])
def test_ring_shift_n_past_the_cap(recorder, n):
    comm = mt.make_mesh(n, device="cpu")
    x, y = torch.zeros(n, 4), torch.zeros(n, 2, dtype=torch.float64)
    a, b = coll.ring_shift_n((x, y), comm, 1)
    assert len(recorder.launches) == 1
    pairs = _pairs(recorder.launches)
    assert len(pairs) == 2 * n
    assert set(pairs) == _shift_pairs(x, a, n, 1) | _shift_pairs(y, b, n, 1)


@pytest.mark.parametrize("shape", [(6, 6), (8, 8)])
def test_halo_exchange_on_large_grids(recorder, shape):
    grid = mt.ProcessGrid(shape, device="cpu")
    f = torch.zeros(*shape, 2, 6, 7)
    mt.halo_exchange(f, grid)
    ranks = shape[0] * shape[1]
    # one ring_shift2 per grid dimension, two payloads of every mesh rank,
    # one launch each
    assert len(recorder.launches) == 2
    for pairs in recorder.launches:
        assert len(pairs) == len(set(pairs)) == 2 * ranks


def test_allreduce_on_65_ranks(recorder):
    comm = mt.make_mesh(65, device="cpu")
    x = torch.zeros(65, 3)
    mt.allreduce(x, comm=comm)  # the reduce-scatter / all-gather arm
    assert coll.allreduce_arm(3, 65) == "hop_rs_ag"
    assert recorder.launches
    # each hop is one ring_shift of 65 pairs in one launch
    assert all(len(launch) == 65 for launch in recorder.launches)


@pytest.mark.parametrize("k", [coll.MAX_PAYLOADS, coll.MAX_PAYLOADS + 1])
def test_payloads_of_one_launch(recorder, k):
    """Up to MAX_PAYLOADS payloads are one launch; more raise on the card
    instead of taking a second launch."""
    n = 3
    xs = [torch.zeros(n, 2) for _ in range(k)]
    dst = [(r + 1) % n for r in range(n)]
    table = [tuple([d] * k) for d in dst]
    if k > coll.MAX_PAYLOADS:
        with pytest.raises(ValueError, match="at most"):
            coll.hop(xs, table)
        assert recorder.launches == []
        return
    outs = coll.hop(xs, table)
    assert len(recorder.launches) == 1
    assert set(_pairs(recorder.launches)) == set().union(
        *(_shift_pairs(x, o, n, 1) for x, o in zip(xs, outs)))


def test_plan_is_made_once_per_table_and_device(recorder):
    comm = mt.make_mesh(5, device="cpu")
    x = torch.zeros(5, 3)
    y = torch.zeros(5, 7, dtype=torch.bfloat16)
    coll.ring_shift2(x, y, comm)
    table = comm.tables[("shift", 1, -1)]
    plan = table.plans[torch.device("cpu")]
    # other sizes and dtypes reuse the plan: it holds neither
    coll.ring_shift2(torch.zeros(5, 11, dtype=torch.int8),
                     torch.zeros(5, 2, dtype=torch.float64), comm)
    assert comm.tables[("shift", 1, -1)] is table
    assert table.plans == {torch.device("cpu"): plan}
    assert plan.dtype == torch.int32 and plan.shape == (2, 5)
    # another table has its own
    coll.ring_shift(x, comm, 2)
    assert comm.tables[("shift", 2)].plans[torch.device("cpu")] is not plan
    assert len(recorder.launches) == 3


def test_halo_exchange_reuses_its_plans(recorder):
    """The grid's axis comms are made once, so each halo exchange after the
    first finds its tables and launch plans cached."""
    grid = mt.ProcessGrid((2, 3), device="cpu")
    f = torch.zeros(2, 3, 2, 6, 7)
    mt.halo_exchange(f, grid)
    comms = [grid.axis_comm(d) for d in range(2)]
    plans = [c.tables[("shift", 1, -1)].plans[torch.device("cpu")]
             for c in comms]
    mt.halo_exchange(f, grid)
    assert all(grid.axis_comm(d) is c for d, c in enumerate(comms))
    assert all(c.tables[("shift", 1, -1)].plans[torch.device("cpu")] is p
               for c, p in zip(comms, plans))
    assert len(recorder.launches) == 4


def test_plan_matches_hop_plain_on_a_partial_table(recorder):
    """The plan's copies and zeroed blocks are hop_plain's: each block
    carries its rank's number plus one, so hop_plain's output names the
    source of every output block, 0 where it writes zeros."""
    n = 6
    # payload 0: an open chain (rank 0 gets nothing, rank 5 sends nothing);
    # payload 1: two ranks swap, the rest send nothing
    dst = [(1, 5), (2, None), (3, None), (4, None), (5, None), (None, 0)]
    xs = (torch.arange(1, n + 1, dtype=torch.float32)[:, None].repeat(1, 3),
          torch.arange(1, n + 1, dtype=torch.int16)[:, None].repeat(1, 5))
    outs = coll.hop(xs, dst)
    ref = coll.hop_plain(xs, coll._check_table(dst, 2))
    assert len(recorder.launches) == 1
    want_pairs, want_zero = set(), set()
    for x, out, r in zip(xs, outs, ref):
        block = x.numel() * x.element_size() // n
        for d in range(n):
            s = int(r[d, 0]) - 1
            target = (out.data_ptr() + d * block, block)
            if s >= 0:
                want_pairs.add((x.data_ptr() + s * block,) + target)
            else:
                want_zero.add(target)
    assert set(recorder.launches[0]) == want_pairs
    assert len(recorder.launches[0]) == len(want_pairs) == 7
    assert set(recorder.zeroed[0]) == want_zero
    assert len(recorder.zeroed[0]) == len(want_zero) == 5
