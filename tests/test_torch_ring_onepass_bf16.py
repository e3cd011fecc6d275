"""The fused ring's one-pass fold order held to its plain version, on the
CPU: bf16 and int32 (the model, the inputs and the other dtypes are in
``tests/test_torch_ring_onepass.py``).
"""

import pytest

from test_torch_ring_onepass import (COUNTS, DTYPES, NS,  # noqa: F401
                                     _one_thread, check_plain_ring)


@pytest.mark.parametrize("dtype", DTYPES[2:4], ids=str)
@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", NS)
def test_one_pass_is_the_plain_ring(n, count, dtype):
    check_plain_ring(n, count, dtype)
