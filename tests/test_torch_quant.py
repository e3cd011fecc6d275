"""The port's int8 wire codec against the JAX package's, on the CPU.

``mpi4jax_tpu_torch/ops/quantized.py`` holds a numpy copy of the codec's
reference (``quant_pack_ref``, ``quant_pack_wire_ref``,
``quant_unpack_ref``), its plain PyTorch version ``quant_pack_plain`` and
``quant_pack``, which runs kernel 4 on a CUDA tensor and the plain version
on a CPU tensor.  Each is held bit for bit to
``mpi4jax_tpu/ops/quantized.py`` on the edge cases of
``quantized.check_inputs`` at lengths 1, 255, 256, 257 and 70000.

``pallas_collectives.quant_pack_pallas`` in interpret mode runs its kernel
through XLA on the CPU, whose arithmetic is not IEEE in two places: XLA
rewrites the division ``amax / 127`` into a product with the rounded
reciprocal of 127, and XLA:CPU flushes subnormal numbers to zero.  So the
Pallas frame is held bit for bit to the port's on every block where those
two rules give the IEEE scale, and on the other blocks its scale is held
to the scale that the two rules give.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4jax_tpu.ops import pallas_collectives as pc
from mpi4jax_tpu.ops import quantized as jq
from mpi4jax_tpu_torch.ops import quantized as q

LENGTHS = (1, 255, 256, 257, 70000)
F32_TINY = np.finfo(np.float32).tiny


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("n", LENGTHS)
def test_numpy_copy_matches_the_jax_reference(n):
    for name, x in q.check_inputs(n).items():
        s, c = q.quant_pack_ref(x)
        js, jc = jq.quant_pack_ref(x)
        assert np.array_equal(_bits(s), _bits(js)), name
        assert np.array_equal(c, jc), name
        assert np.array_equal(q.quant_pack_wire_ref(x),
                              jq.quant_pack_wire_ref(x)), name
        assert np.array_equal(_bits(q.quant_unpack_ref(s, c)),
                              _bits(jq.quant_unpack_ref(js, jc))), name


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_version_matches_the_reference_bit_for_bit(n):
    for name, x in q.check_inputs(n).items():
        want = jq.quant_pack_wire_ref(x)
        t = torch.from_numpy(x)
        plain = q.quant_pack_plain(t)
        assert plain.dtype == torch.int8
        assert plain.numel() == q.quant_packed_bytes(n) == want.size
        assert np.array_equal(plain.numpy(), want), name
        # the wrapper on a CPU tensor is the plain version; a 2-D view is
        # read flat
        assert np.array_equal(q.quant_pack(t.reshape(1, n)).numpy(), want)


@functools.lru_cache(maxsize=None)
def _pallas():
    return jax.jit(functools.partial(pc.quant_pack_pallas, interpret=True))


def _xla_cpu_scales(x):
    """The block scales that the Pallas kernel computes in interpret mode on
    XLA:CPU: subnormals flushed to zero, and amax times the f32 reciprocal
    of 127."""
    nb = -(-x.size // q.QUANT_BLOCK)
    padded = np.zeros(nb * q.QUANT_BLOCK, np.float32)
    padded[:x.size] = x
    padded[np.abs(padded) < F32_TINY] = 0
    amax = np.abs(padded.reshape(nb, q.QUANT_BLOCK)).max(axis=1)
    s = (amax * (np.float32(1) / np.float32(127))).astype(np.float32)
    s[np.abs(s) < F32_TINY] = 0
    return np.where(amax > 0, s, np.float32(1)).astype(np.float32), padded


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_version_matches_pallas_interpret(n):
    nb = -(-n // q.QUANT_BLOCK)
    compared = {}
    for name, x in q.check_inputs(n).items():
        wire = np.asarray(_pallas()(jnp.asarray(x)))
        plain = q.quant_pack_plain(torch.from_numpy(x)).numpy()
        assert wire.size == plain.size == q.quant_packed_bytes(n)
        ieee = plain[:4 * nb].view(np.float32)
        got = wire[:4 * nb].copy().view(np.float32)
        xla, flushed = _xla_cpu_scales(x)
        same = (xla == ieee) & (np.abs(ieee) >= F32_TINY) & np.all(
            flushed.reshape(nb, -1) == np.pad(
                x, (0, nb * q.QUANT_BLOCK - n)).reshape(nb, -1), axis=1)
        # where XLA's arithmetic gives the IEEE scale, the frames agree
        assert np.array_equal(_bits(got[same]), _bits(ieee[same])), name
        codes_w = np.pad(wire[4 * nb:], (0, nb * q.QUANT_BLOCK - n))
        codes_p = np.pad(plain[4 * nb:], (0, nb * q.QUANT_BLOCK - n))
        assert np.array_equal(codes_w.reshape(nb, -1)[same],
                              codes_p.reshape(nb, -1)[same]), name
        # elsewhere the Pallas scale is the one XLA's two rules give
        assert np.array_equal(_bits(got[~same]), _bits(xla[~same])), name
        compared[name] = int(same.sum())
    # every case but the subnormal one keeps most of its blocks
    for name, k in compared.items():
        if name == "subnormal":
            assert k == 0
        else:
            assert k >= 0.8 * nb, (name, k, nb)


def test_empty_frame_and_rejected_types():
    before = dict(q.LAUNCHES)
    out = q.quant_pack(torch.zeros(0))
    assert out.dtype == torch.int8 and out.numel() == 0
    assert q.LAUNCHES == before
    assert q.quant_packed_bytes(0) == 0
    assert np.asarray(pc.quant_pack_pallas(jnp.zeros((0,), jnp.float32),
                                           interpret=True)).size == 0
    with pytest.raises(TypeError):
        q.quant_pack(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(TypeError):
        q.quant_pack_plain(np.zeros(3, np.float32))


def test_frame_layout_and_round_trip():
    x = q.check_inputs(70000)["normal"]
    frame = q.quant_pack_plain(torch.from_numpy(x)).numpy()
    nb = -(-x.size // q.QUANT_BLOCK)
    scales = frame[:4 * nb].copy().view(np.float32)
    codes = frame[4 * nb:]
    # little-endian scale bytes first, then one code per element
    assert np.array_equal(scales, q.quant_pack_ref(x)[0])
    back = q.quant_unpack_ref(scales, codes)
    err = np.abs(back - x).reshape(-1)
    bound = np.repeat(scales, q.QUANT_BLOCK)[:x.size] / 2
    assert np.all(err <= bound * (1 + 1e-6))
