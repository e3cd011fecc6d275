"""Kernel 6's tile walk (``_dq_walk``, dQ) held to ``flash_bwd_block_plain``
within ``_flash_check.TOL_BWD``, on the CPU, at every case of
``tests/test_torch_flash_tiles.py`` (which holds the models and the
cases).
"""

import pytest

from test_torch_flash_tiles import (CASES, DTYPES, _bwd_case,  # noqa: F401
                                    _check_bwd_walk, _dq_walk,
                                    _one_thread)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dq_walk_matches_plain(case, causal, dtype):
    args, scale = _bwd_case(case, causal, dtype)
    dq, done, idle = _dq_walk(*args, scale=scale, causal=causal)
    _check_bwd_walk(args, scale, causal, dtype, (dq, None, None), done, idle)
