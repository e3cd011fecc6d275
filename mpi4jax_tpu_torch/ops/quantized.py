"""The native int8 wire codec: its numpy reference, its plain PyTorch
version and kernel 4.

The frame of ``n`` f32 elements is ``ceil(n/256)`` f32 block scales, as
their little-endian bytes, then the ``n`` int8 codes:
``quant_packed_bytes(n) = 4 ceil(n/256) + n`` bytes.  For each 256-element
block (the last one padded with zeros): ``amax = max |x|``, ``scale =
amax / 127`` (1 for an all-zero block), ``inv = 1 / scale``, and ``code =
rint(clip(x * inv, -127, 127))``, rounded half to even, all in IEEE f32.
This is the codec of ``native/tpucomm.cc`` (``quant_pack_f32``).

- ``quant_pack_ref``, ``quant_pack_wire_ref`` and ``quant_unpack_ref`` are
  numpy copies of ``mpi4jax_tpu/ops/quantized.py``'s (``:266-306``), the
  bit-defined oracle;
- ``quant_pack_plain`` computes the same frame in torch ops;
- ``quant_pack`` launches kernel 4 (``csrc/quant_pack.cu``, which
  replaces ``mpi4jax_tpu/ops/pallas_collectives.py:862``
  ``_quant_pack_kernel``) on a CUDA tensor and runs ``quant_pack_plain``
  on a CPU tensor.

The mesh tier's int8 allreduce is another codec, ported below from the
same module (``:69-235``): ``_quantize`` takes one absmax per destination
chunk and divides by the scale, and ``_quantized_schedule`` moves the
codes with their scales packed in through one alltoall (kernel 2) and one
all-gather (hops), as ``quantized_allreduce_sum`` there does with
``lax.all_to_all`` and ``lax.all_gather``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..utils import validation as _validation

#: elements per f32 absmax scale (``kQuantBlock`` in native/tpucomm.cc)
QUANT_BLOCK = 256

LAUNCHES = {"quant_pack": 0}  # kernel 4's launches, read by chip_smoke


def quant_packed_bytes(count: int) -> int:
    """Bytes of the frame of ``count`` elements."""
    return 4 * (-(-int(count) // QUANT_BLOCK)) + int(count)


# ---------------- numpy reference of the native wire codec ----------------


def quant_pack_ref(x):
    """(scales f32 (nblocks,), codes int8 (n,)) for a 1-D f32 array."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    n = x.size
    nb = max((n + QUANT_BLOCK - 1) // QUANT_BLOCK, 0)
    padded = np.zeros(nb * QUANT_BLOCK, np.float32)
    padded[:n] = x
    blocks = padded.reshape(nb, QUANT_BLOCK)
    amax = np.max(np.abs(blocks), axis=1)
    scale = np.where(amax > 0, amax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    inv = (np.float32(1.0) / scale).astype(np.float32)
    v = (blocks * inv[:, None]).astype(np.float32)
    v = np.clip(v, np.float32(-127.0), np.float32(127.0))
    codes = np.rint(v).astype(np.int8).reshape(-1)[:n]
    return scale, codes


def quant_pack_wire_ref(x):
    """The whole frame of a 1-D f32 array: the scales' bytes, then the
    codes."""
    scales, codes = quant_pack_ref(x)
    return np.concatenate([scales.view(np.int8), codes])


def quant_unpack_ref(scales, codes):
    """f32 values from (scales, codes): exactly scale * code."""
    codes = np.asarray(codes, np.int8)
    n = codes.size
    nb = scales.size
    padded = np.zeros(nb * QUANT_BLOCK, np.float32)
    padded[:n] = codes.astype(np.float32)
    out = (padded.reshape(nb, QUANT_BLOCK)
           * scales.astype(np.float32)[:, None]).astype(np.float32)
    return out.reshape(-1)[:n]


def check_inputs(n: int) -> dict:
    """The codec's edge cases at length ``n``, f32 arrays seeded by ``n``:

    - ``normal``: normal samples;
    - ``zero_blocks``: blocks 0 and 2 all zero (scale 1);
    - ``at_amax``: every fifth element at +-amax (codes +-127);
    - ``ties``: (k + 0.5) / 8 with amax 127 / 8 in every block, so the
      scale is 1/8, inv 8, and every code an exact tie, rounded to even;
    - ``near_ties``: (k + 0.5) fl(3/127) with amax 3;
    - ``subnormal``: amax 1e-36 in every block, so the scale is subnormal
      and its reciprocal finite, a third of the elements subnormal (their
      codes are not 0: flushing them to zero changes the frame);
    - ``huge``: magnitudes near 1e30, a few near 3e38.
    """
    rng = np.random.RandomState(n)
    f32 = np.float32
    normal = rng.randn(n).astype(f32)
    zero = rng.randn(n).astype(f32)
    zero[:QUANT_BLOCK] = 0
    zero[2 * QUANT_BLOCK:3 * QUANT_BLOCK] = 0
    at_amax = rng.randn(n).astype(f32)
    amax = np.abs(at_amax).max()
    at_amax[::5] = amax * np.where(np.arange(0, n, 5) % 2, -1, 1)
    ties = ((rng.randint(-127, 127, n) + 0.5) / 8).astype(f32)
    ties[::QUANT_BLOCK] = f32(127 / 8)
    step = f32(3) / f32(127)
    near = ((rng.randint(-127, 127, n) + f32(0.5)) * step).astype(f32)
    near[::QUANT_BLOCK] = f32(3)
    sub = (rng.uniform(-1, 1, n) * 1e-36).astype(f32)
    sub[1::3] = (rng.uniform(-1, 1, sub[1::3].size) * 1.1e-38).astype(f32)
    sub[::QUANT_BLOCK] = f32(1e-36)
    huge = (rng.randn(n) * 1e30).astype(f32)
    huge[::997] = f32(3e38) * np.sign(huge[::997])
    return {"normal": normal, "zero_blocks": zero, "at_amax": at_amax,
            "ties": ties, "near_ties": near, "subnormal": sub, "huge": huge}


def quantized_allreduce_ref(x):
    """The mesh tier's int8 SUM allreduce in numpy, IEEE f32 throughout:
    ``x`` ``(n, ...)`` float32, row r rank r's block; returns every rank's
    result, ``(n, ...)``.  The oracle of ``_quantized_schedule``: the same
    chunks, scales (``absmax / 127``), codes (``rint(x / scale)``,
    clipped), and the partial sums added in rank order."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    flat = x.reshape(n, -1)
    count = flat.shape[1]
    flat = np.concatenate([flat, np.zeros((n, (-count) % n), np.float32)], 1)

    def quant(v):
        amax = np.max(np.abs(v), axis=-1)
        scale = np.where(amax > 0, amax / np.float32(127.0),
                         np.float32(1.0)).astype(np.float32)
        q = np.clip(np.rint(v / scale[..., None]), -127, 127)
        return q.astype(np.int8), scale

    q, s = quant(flat.reshape(n, n, -1))  # [source rank, chunk, k]
    parts = q.astype(np.float32) * s[..., None]
    mine = parts[0]
    for r in range(1, n):
        mine = mine + parts[r]
    q2, s2 = quant(mine)  # chunk j, reduced on rank j
    full = (q2.astype(np.float32) * s2[:, None]).reshape(-1)[:count]
    return np.broadcast_to(full.reshape(x.shape[1:]), x.shape).copy()


# ---------------- the plain version and kernel 4 ----------------


def _flat_f32(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"quant_pack takes a torch.Tensor, got "
                        f"{type(x).__qualname__}")
    if x.dtype != torch.float32:
        raise TypeError(f"the int8 wire codec packs float32, got {x.dtype}")
    return x.reshape(-1)


def quant_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """The frame of ``x`` (f32, any shape, read flat) in torch ops, as an
    int8 tensor on ``x``'s device.

    Every division has a tensor divisor: a CUDA division by a Python
    scalar multiplies by the scalar's reciprocal, which rounds otherwise."""
    flat = _flat_f32(x)
    n = flat.numel()
    nb = -(-n // QUANT_BLOCK)
    padded = torch.zeros(nb * QUANT_BLOCK, dtype=torch.float32,
                         device=flat.device)
    padded[:n] = flat
    blocks = padded.view(nb, QUANT_BLOCK)
    amax = blocks.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    inv = torch.ones_like(scale) / scale
    v = (blocks * inv[:, None]).clamp(-127.0, 127.0)
    codes = torch.round(v).to(torch.int8).view(-1)[:n]
    return torch.cat([scale.view(torch.int8), codes])


def _kernel(flat: torch.Tensor) -> torch.Tensor:
    n = flat.numel()
    out = torch.empty(quant_packed_bytes(n), dtype=torch.int8,
                      device=flat.device)
    lib = _build.library("quant_pack")
    fn = lib.quant_pack_launch
    if fn.argtypes is None:  # declared once per loaded library
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    with torch.cuda.device(flat.device):
        err = fn(flat.data_ptr(), n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"quant_pack_launch failed: {_build.error_string(lib, err)}")
    LAUNCHES["quant_pack"] += 1
    return out


def quant_pack(x: torch.Tensor) -> torch.Tensor:
    """The frame of ``x`` (f32, read flat) as an int8 tensor on its device:
    one launch of kernel 4 on a CUDA tensor, ``quant_pack_plain`` on a CPU
    tensor.  An empty ``x`` gives an empty frame and launches nothing, as
    ``quant_pack_pallas`` returns one."""
    flat = _flat_f32(x)
    if flat.numel() == 0:
        return torch.zeros(0, dtype=torch.int8, device=flat.device)
    if flat.device.type == "cpu":
        return quant_pack_plain(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"tensors on {flat.device} are not supported")
    return _kernel(flat.contiguous())


# ---------------- the mesh tier's quantized allreduce ----------------


def _pad_to(flat: torch.Tensor, n: int):
    """``flat`` ``(*lead, count)`` zero-padded to a multiple of ``n`` along
    its last dimension, and the padding."""
    pad = (-flat.shape[-1]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(*flat.shape[:-1], pad)], -1)
    return flat, pad


def _quantize(x: torch.Tensor):
    """Per-row int8 quantization: ``x`` ``(..., k)`` to ``(q int8 (..., k),
    scale f32 (...))``.  The scale is ``absmax / 127`` in ``x``'s dtype (1
    for a zero row) and ``q = clip(round(x / scale), -127, 127)`` in f32,
    rounded half to even, as the JAX package's ``_quantize``.  Both
    divisions have tensor divisors, so they are IEEE divisions on every
    device."""
    absmax = x.abs().amax(-1)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax)).float()
    q = torch.round(x.float() / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def check_quantizable(x, comm=None):
    """int8 compression is defined for real floating inputs only, as in the
    JAX package: complex would drop its imaginary part, integers their
    exactness."""
    if not x.dtype.is_floating_point:
        _validation.fail(
            f"compression='int8' requires a real floating dtype, got "
            f"{str(x.dtype).replace('torch.', '')}; use the uncompressed "
            "allreduce", op="allreduce(compression='int8')", comm=comm, x=x,
            exc=TypeError)


def _pack_scales(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Each row's f32 scale appended to its int8 codes as its four
    little-endian bytes (``lax.bitcast_convert_type``'s): ``(..., k)`` and
    ``(...)`` to ``(..., k + 4)``."""
    sbytes = scale.float().reshape(*scale.shape, 1).contiguous()
    return torch.cat([q, sbytes.view(torch.int8)], -1)


def _unpack_scales(packed: torch.Tensor):
    """The inverse of ``_pack_scales``: ``(..., k + 4)`` to ``((..., k)
    int8, (...) f32)``."""
    scale = packed[..., -4:].contiguous().view(torch.float32)[..., 0]
    return packed[..., :-4], scale


def _quantized_schedule(x: torch.Tensor, lead, n: int, alltoall,
                        all_gather) -> torch.Tensor:
    """The JAX package's ``_quantized_schedule``: each rank's ``x``
    flattened, zero-padded and cut into ``n`` destination chunks, quantized
    per chunk, moved with one alltoall of the packed rows, dequantized and
    summed in f32 (rank 0's row first, then each next one added), quantized
    again and shared with one all-gather of the packed row, dequantized,
    cast back to ``x``'s dtype.  ``lead`` is the rank dimensions in front
    of each rank's values (the mesh layout's, or none on the world tier);
    ``alltoall`` and ``all_gather`` are the tier's legs."""
    flat, pad = _pad_to(x.reshape(*lead, -1), n)
    chunks = flat.reshape(*lead, n, -1)  # row j -> comm rank j

    q, scale = _quantize(chunks)
    packed = alltoall(_pack_scales(q, scale))
    q_t, s_t = _unpack_scales(packed)
    # rows: every rank's contribution to our chunk, reduced in f32
    partial = q_t.float() * s_t[..., None]
    mine = partial.select(len(lead), 0)
    for j in range(1, n):
        mine = mine + partial.select(len(lead), j)

    q2, s2 = _quantize(mine)
    rows = all_gather(_pack_scales(q2, s2))
    q_all, s_all = _unpack_scales(rows)
    full = (q_all.float() * s_all[..., None]).reshape(*lead, -1)
    if pad:
        full = full[..., :-pad]
    return full.reshape(x.shape).to(x.dtype)


def _mesh_schedule(x: torch.Tensor, comm) -> torch.Tensor:
    """The schedule on the mesh layout: kernel 2 and the hops."""
    from . import _collectives

    return _quantized_schedule(
        x, comm.layout_shape, comm.size(),
        lambda rows: _collectives.alltoall(rows, comm),
        lambda row: _collectives.all_gather(row, comm))


class _QuantizedSum(torch.autograd.Function):
    """The schedule with the gradient of the JAX one: every value crosses
    int8, so ``jax.grad`` through it is zero everywhere."""

    @staticmethod
    def forward(ctx, x, schedule):
        return schedule(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None


def quantized_allreduce_sum(x: torch.Tensor, comm) -> torch.Tensor:
    """SUM allreduce with int8 transfers on a mesh comm: an approximation
    of the sum with about 1e-2 relative error, a quarter of the f32 bytes on
    the wire.  ``x`` has the mesh's rank dimensions leading; the result has
    its dtype.  Its gradient is zero, as ``jax.grad``'s of the JAX
    schedule."""
    check_quantizable(x, comm)
    return _QuantizedSum.apply(x, lambda v: _mesh_schedule(v, comm))


def quantized_allreduce_sum_world(x: torch.Tensor, comm) -> torch.Tensor:
    """The same schedule on a world comm (``x`` is this rank's tensor), its
    legs on the world tier's alltoall and allgather: the route of
    ``compression="int8"`` when ``MPI4JAX_TPU_COLL_QUANT=deny`` vetoes the
    transport's quantized schedules (``mpi4jax_tpu/ops/quantized.py:
    236-251``).  Its gradient is zero, as the mesh schedule's."""
    from . import _world_impl

    check_quantizable(x, comm)
    return _QuantizedSum.apply(x, lambda v: _quantized_schedule(
        v, (), comm.size(), lambda rows: _world_impl._alltoall(rows, comm),
        lambda row: _world_impl._allgather(row, comm)))


def native_quant_algo(comm, x) -> "str | None":
    """The transport's quantized schedule ("qring" or "qrd") that carries
    a world ``compression="int8"`` allreduce: the twin of the exact pick of
    the decision table for the payload (``tune.quantized_algorithm``); None
    under ``MPI4JAX_TPU_COLL_QUANT=deny``, where the Python schedule serves
    (``mpi4jax_tpu/ops/quantized.py:98-133``)."""
    from .. import tune
    from ..utils import config

    if config.quant_mode() == "deny":
        return None
    return tune.quantized_algorithm(x.numel() * x.element_size())


def native_quant_alltoall() -> "str | None":
    """The schedule ("qalltoall") that carries a world
    ``compression="int8"`` alltoall, or None for the exact exchange under
    ``MPI4JAX_TPU_COLL_QUANT=deny``: unlike the allreduce there is no
    Python schedule to fall back to (``mpi4jax_tpu/ops/quantized.py:
    136-161``).  The gate is process-wide, the same on every rank."""
    from ..utils import config

    if config.quant_mode() == "deny":
        return None
    return "qalltoall"
