"""Kernel 4 and path (g) on the card (marked ``gpu``; they skip without
one).  This file imports no JAX, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_quant_gpu.py

- ``csrc/quant_pack.cu`` against ``quant_pack_plain`` on the card, bit for
  bit, at the edge cases of ``quantized.check_inputs`` and the lengths of
  ``chip_smoke.py`` phase 23, with an input that is not 16-byte aligned,
  and against the transport's own codec (``bridge.quant_pack``);
- one 4-rank path (g) job on the card through the port's launcher: the
  quantized leg (``MPI4JAX_TPU_ICI_LEG=force``,
  ``MPI4JAX_TPU_COLL_QUANT=force``) under hring and htree, bit for bit
  against ``simulate_ici_q_sum`` on every rank, one launch each of kernels
  3 and 4 per rank and call.
"""

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch import _build
from mpi4jax_tpu_torch.benchmarks import ici_leg
from mpi4jax_tpu_torch.ops import quantized
from mpi4jax_tpu_torch.runtime import bridge

pytestmark = pytest.mark.gpu

LENGTHS = (1, 255, 256, 257, 70000, 4 * 1024 * 1024, 16 * 1024 * 1024)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _build.build_all(["quant_pack", "fused_ring"])
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", LENGTHS)
def test_kernel_matches_plain_at_the_edges(dev, n):
    for name, x in quantized.check_inputs(n).items():
        t = torch.from_numpy(x).to(dev)
        before = quantized.LAUNCHES["quant_pack"]
        got = quantized.quant_pack(t)
        assert quantized.LAUNCHES["quant_pack"] == before + 1
        ref = quantized.quant_pack_plain(t)
        torch.cuda.synchronize()
        assert got.device == dev and got.dtype == torch.int8
        assert torch.equal(got, ref), (n, name)
        if n <= 70000:
            assert np.array_equal(got.cpu().numpy(), bridge.quant_pack(x)), \
                (n, name)


def test_unaligned_and_empty_inputs(dev):
    x = torch.from_numpy(quantized.check_inputs(70001)["near_ties"]).to(dev)
    view = x[1:]  # 4 bytes past a 16-byte boundary: the scalar loads
    assert view.data_ptr() % 16 != 0
    assert torch.equal(quantized.quant_pack(view),
                       quantized.quant_pack_plain(view))
    before = dict(quantized.LAUNCHES)
    assert quantized.quant_pack(x[:0]).numel() == 0
    assert quantized.LAUNCHES == before
    with pytest.raises(TypeError):
        quantized.quant_pack(x.double())


def test_path_g_quantized_leg_on_the_card(dev):
    rec = ici_leg.run_job("hring+q+ici", device="cuda",
                          algos=("hring", "htree"),
                          check_counts=(3, 513, 70000), timeout=300)
    assert rec["leg"] and rec["quant"] and rec["device"] == "cuda:0"
    for c in rec["checks"]:
        assert c["check"] == "bits"
        assert c["launches"] == {"fused_ring": 1, "quant_pack": 1}
