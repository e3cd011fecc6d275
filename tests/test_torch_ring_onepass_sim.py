"""The fused ring's one-pass fold order held to its plain version (u64)
and to the JAX package's ``topo.simulate_ring_sum`` (f32), on the CPU (the
model, the inputs and the other dtypes are in
``tests/test_torch_ring_onepass.py``).
"""

import pytest
import torch

from mpi4jax_tpu.topo._simulate import simulate_ring_sum

from test_torch_ring_onepass import (COUNTS, DTYPES, NS,  # noqa: F401
                                     _one_pass, _one_thread, _rows,
                                     _same_bits, check_plain_ring)


@pytest.mark.parametrize("dtype", DTYPES[4:], ids=str)
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", NS)
def test_one_pass_is_the_plain_ring(n, count, dtype):
    check_plain_ring(n, count, dtype)


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", NS)
def test_one_pass_is_simulate_ring_sum(n, count):
    rows = _rows(n, count, torch.float32)
    want = torch.from_numpy(simulate_ring_sum(list(rows.numpy())))
    got = _one_pass(rows)
    assert _same_bits(got, want.expand(n, count))
