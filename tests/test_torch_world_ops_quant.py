"""The port's copies of the JAX package's quantized-allreduce simulators
(``simulate_qring_sum``, ``simulate_qrd_sum``), bit for bit on seeded
inputs (a part of ``tests/test_torch_world_ops.py``).
"""

import numpy as np
import pytest

from mpi4jax_tpu.ops import quantized as jquant

from mpi4jax_tpu_torch.topo import _simulate as sim


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("count", [1, 7, 513, 70001])
def test_port_quant_simulators_are_jax_bit_for_bit(n, count):
    rng = np.random.default_rng([n, count])
    parts = [(rng.standard_normal(count) * 10 ** rng.uniform(-3, 3))
             .astype(np.float32) for _ in range(n)]
    np.testing.assert_array_equal(sim.simulate_qring_sum(parts),
                                  jquant.simulate_qring_sum(parts))
    np.testing.assert_array_equal(sim.simulate_qrd_sum(parts),
                                  jquant.simulate_qrd_sum(parts))
