"""The fused ring's one-pass fold order held to its plain version, on the
CPU.

``csrc/fused_ring.cu`` sums every element in one pass: an element of chunk
c (``per = ceil(count / n)``) starts from row c and folds rows
``(c + 1) % n``, ``(c + 2) % n``, ... in turn, each fold ``local +
incoming``, and the sum goes to every row.  ``_one_pass`` below is that
arithmetic in torch, a model of the kernel for these tests and not a second
plain version: f16 and bf16 fold in f32 and round after every fold,
integers wrap, the wide unsigned types add as their signed twins.  It must
equal ``fused_ring_allreduce_plain``, the step-by-step replay of the TPU
kernel's schedule, bit for bit at every n, count and dtype here, and in f32
the JAX package's ``topo.simulate_ring_sum`` too.  No JAX function is
compiled: the simulator is numpy.

The dtypes are split over three files of at most 45 cases: f32 and f16
here, bf16 and int32 in ``tests/test_torch_ring_onepass_bf16.py``, u64
and the simulator in ``tests/test_torch_ring_onepass_sim.py``; those
import the model and the inputs from here.
"""

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch.ops import _collectives as coll

NS = (2, 3, 4, 8, 65)
COUNTS = (1, 5, 513, 16 * 1024 + 37)
DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.int32,
          torch.uint64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are thousands
    of small slices, which threads only slow down when the suite runs
    several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _one_pass(rows):
    """Every row the one-pass sum of the n rows of ``rows`` (n, count)."""
    n, count = rows.shape
    signed = coll._SIGNED.get(rows.dtype)
    x = rows.view(signed) if signed is not None else rows
    per = -(-count // n)
    i = torch.arange(count)
    c = i // per
    acc = x[c, i]
    for j in range(1, n):
        local = x[(c + j) % n, i]
        if x.dtype in (torch.float16, torch.bfloat16):
            acc = (local.float() + acc.float()).to(x.dtype)
        else:
            acc = local + acc
    out = acc.expand(n, count)
    return out.view(rows.dtype) if signed is not None else out


def _rows(n, count, dtype):
    rng = np.random.default_rng([n, count])
    if dtype == torch.uint64:
        bits = rng.integers(-2**63, 2**63, (n, count), dtype=np.int64)
        return torch.from_numpy(bits).view(torch.uint64)
    if dtype == torch.int32:
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, (n, count), dtype=np.int64)
            .astype(np.int32))
    # magnitudes over several binades, so that the order of the folds shows
    x = rng.standard_normal((n, count)) * np.exp2(rng.integers(-8, 9, (n, 1)))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _same_bits(a, b):
    a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def check_plain_ring(n, count, dtype):
    rows = _rows(n, count, dtype)
    assert _same_bits(_one_pass(rows), coll.fused_ring_allreduce_plain(rows))


@pytest.mark.parametrize("dtype", DTYPES[:2], ids=str)
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", NS)
def test_one_pass_is_the_plain_ring(n, count, dtype):
    check_plain_ring(n, count, dtype)
