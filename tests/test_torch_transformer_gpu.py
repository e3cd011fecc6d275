"""The port's GPT step on the card: the kernel route (kernels 5, 6 and 7 in
every layer's attention, the hop and fused ring in the collectives) against
the plain route (``_collectives.use_plain()``), at a small width.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_transformer_gpu.py

The comparison and its tolerances are ``benchmarks/gpt_step.route_check``
and ``ROUTE_TOL``, as ``chip_smoke.py`` applies them to the GPT-2 step: in
bf16 the loss within 1e-3 relative, each field's synced gradient within
5e-2 and its AdamW update within 0.25 in relative L2; in f32, where the
kernels round nothing that the plain versions do not, 1e-5, 1e-3 and 1e-2.
"""

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch.benchmarks import gpt_step
from mpi4jax_tpu_torch.models import transformer as gpt

CFG = dict(vocab=512, d_model=128, n_heads=4, n_layers=2, d_ff=512,
           max_seq=256)
B, T = 4, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [(1, 1, 1), (1, 2, 2), (2, 1, 2)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_step_matches_plain_step(cuda, mesh, dtype):
    cfg = gpt.GPTConfig(**CFG, dtype=dtype)
    toks = gpt_step.make_tokens(B, T, cfg.vocab, 0, cuda)
    res = gpt_step.route_check(cfg, mesh, toks, device=cuda)
    # one launch of each kernel per layer and ring step
    assert res["launches"] == dict.fromkeys(gpt_step.FLASH,
                                            cfg.n_layers * mesh[2])
    assert np.isfinite(res["loss_kernel"])
    assert res["within"], (res, gpt_step.ROUTE_TOL[dtype])
