"""The phases of the port's intra-island leg against the JAX leg's, on the
CPU route and without a transport.

``mpi4jax_tpu_torch/topo/_ici_leg.py`` folds an island's rows with the
fused ring (its plain version on the CPU), packs the island sum into the
int8 wire frame (``quant_pack``, the plain version on the CPU) and folds
the leaders' frames in island order.  Each phase is held bit for bit to
``mpi4jax_tpu/topo/_ici_leg.py`` and ``mpi4jax_tpu/topo/_simulate.py`` on
the same seeded rows, and the phases composed over a world to
``topo.simulate_ici_q_sum``.
"""

import numpy as np
import pytest
import torch

from mpi4jax_tpu import topo as jtopo
from mpi4jax_tpu.topo import _ici_leg as jleg
from mpi4jax_tpu_torch.ops import _collectives, quantized
from mpi4jax_tpu_torch.runtime import bridge
from mpi4jax_tpu_torch.topo import _ici_leg as leg

CPU = torch.device("cpu")
COUNTS = (3, 513, 70000)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _rows(m, count, seed=0):
    return np.random.RandomState(seed + 7 * m + count).randn(
        m, count).astype(np.float32) * 2


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("count", COUNTS)
def test_island_ring_sum_is_simulate_ring_sum(m, count):
    rows = _rows(m, count)
    before = dict(_collectives.LAUNCHES)
    island = leg._island_ring_sum(rows, CPU)
    assert island.device == CPU and island.dtype == torch.float32
    assert _same(island.numpy(), jtopo.simulate_ring_sum(list(rows)))
    assert _collectives.LAUNCHES == before  # the plain version, no kernel


@pytest.mark.parametrize("count", COUNTS)
def test_pack_is_the_jax_legs_frame(count):
    island = jtopo.simulate_ring_sum(list(_rows(2, count)))
    before = dict(quantized.LAUNCHES)
    frame = leg._pack(torch.from_numpy(island))
    assert _same(frame, jleg._pack_numpy(island))
    assert quantized.LAUNCHES == before


@pytest.mark.parametrize("count", COUNTS)
def test_unpack_fold_matches_jax(count):
    sums = [jtopo.simulate_ring_sum(list(_rows(2, count, seed)))
            for seed in range(3)]
    frames = np.stack([jleg._pack_numpy(s) for s in sums])
    for order in ([0, 1, 2], [2, 0, 1]):
        assert _same(leg._unpack_fold(frames, order, count),
                     jleg._unpack_fold(frames, order, count))


@pytest.mark.parametrize("spec,size", [("r0,r1|r2,r3", 4),
                                       ("r0,r1,r2,r3|r4,r5", 6),
                                       ("r0,r2|r1,r3", 4)])
@pytest.mark.parametrize("count", COUNTS)
def test_composed_leg_is_simulate_ici_q_sum(spec, size, count):
    labels = jtopo.parse_fake_hosts(spec, size)
    islands = [[r for r in range(size) if labels[r] == lab]
               for lab in dict.fromkeys(labels)]
    parts = np.random.RandomState(size + count).randn(
        size, count).astype(np.float32) * 2
    # phase 1 on every island, then the leaders' fold in island order
    frames = np.stack([leg._pack(leg._island_ring_sum(parts[members], CPU))
                       for members in islands])
    got = leg._unpack_fold(frames, range(len(islands)), count)
    assert _same(got, jtopo.simulate_ici_q_sum(list(parts), islands))


def test_gates_fall_through_without_a_topology(monkeypatch):
    buf = np.ones(8, np.float32)
    out = np.zeros_like(buf)
    monkeypatch.setenv("MPI4JAX_TPU_ICI_LEG", "force")
    # no topology sub-comms for this handle: the native paths take it
    assert not leg.maybe_allreduce(12345, buf, out, 11, 0, 7)
    assert not bridge._ici_leg_hook(12345, buf, out, 11, 0, 7)
    # not f32 SUM
    assert not leg.maybe_allreduce(12345, buf, out, 11, 2, 7)
    assert not leg.maybe_allreduce(12345, buf, out, 12, 0, 7)
    monkeypatch.setenv("MPI4JAX_TPU_ICI_LEG", "off")
    assert not leg.maybe_allreduce(12345, buf, out, 11, 0, 7)
    assert np.all(out == 0)
    monkeypatch.setenv("MPI4JAX_TPU_ICI_LEG", "sometimes")
    with pytest.raises(ValueError, match="MPI4JAX_TPU_ICI_LEG"):
        leg.maybe_allreduce(12345, buf, out, 11, 0, 7)
