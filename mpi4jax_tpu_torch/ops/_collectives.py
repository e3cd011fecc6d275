"""The mesh tier's collectives on the hop, fused-ring and alltoall CUDA
kernels.

The counterpart of ``mpi4jax_tpu/ops/pallas_collectives.py``.  Three
kernels carry every function here:

- ``hop`` (``csrc/hop.cu``): k payloads, each rank's block of payload i
  copied to rank ``dst[r][i]``, in one launch over any number of ranks,
  from a launch plan made once per hop table and device; blocks that no
  rank targets are zeroed in the same launch.  ``ring_shift``,
  ``ring_shift2`` (the halo),
  ``ring_shift_n`` (ring attention's k/v rotation), ``exchange`` (the
  butterfly), the hop-composed ``all_gather`` and ``reduce_scatter_sum``
  are built from it, as on the TPU;
- ``fused_ring_allreduce_sum`` (``csrc/fused_ring.cu``): the whole ring
  allreduce in one barrier-free pass, bit for bit
  ``topo.simulate_ring_sum``;
- ``alltoall`` (``csrc/alltoall.cu``): every rank's n rows to their
  destinations in one launch, the own row as a loopback copy.

``allreduce_sum`` keeps the JAX dispatch on the per-rank element count: the
butterfly up to ``BUTTERFLY_MAX_ELEMS`` with a power-of-two n, the fused
ring from ``BIDIR_MIN_ELEMS`` with n > 2, else reduce-scatter + all-gather
over hops with zero padding.

Tensors follow the mesh layout (``parallel/mesh.py``): the leading
dimensions are the mesh's rank axes and each rank's block is contiguous.
On a CUDA tensor every function launches the kernels; on a CPU tensor it
runs the plain versions (``hop_plain``, ``fused_ring_allreduce_plain``,
``alltoall_plain``), which sit beside the kernels.  ``use_plain()`` makes
the plain versions run on a CUDA tensor too: the test oracle of
``chip_smoke.py`` and the tests, never a default.  The hop and the ring
move complex tensors as their float pair; the alltoall moves bytes.

Gradients: each function is a ``torch.autograd.Function`` whose backward
launches the same kernels: a hop transposes to the inverse hop (a ring
shift to the reverse shift, ``ring_shift2`` to the swapped pair; a hop
that records no gradient skips ``autograd.Function``),
``all_gather`` to ``reduce_scatter_sum`` and back, and an allreduce-SUM and
an alltoall each to itself.
"""

from __future__ import annotations

import contextlib
import ctypes
import struct

import torch

from .. import _build

LAUNCHES = {"hop": 0, "fused_ring": 0, "alltoall": 0}  # read by chip_smoke

MAX_PAYLOADS = 16  # payloads of one hop launch: kMaxPayloads in csrc/hop.cu

# Below this many elements per rank the allreduce is latency-bound and takes
# the butterfly: log2(n) full-payload exchanges (power-of-two n only).
BUTTERFLY_MAX_ELEMS = 4 * 1024
# From this many elements per rank (and n > 2) it takes the fused ring.
BIDIR_MIN_ELEMS = 16 * 1024

# fused_ring_launch's kind codes, by element type
_RING_KINDS = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3,
    torch.uint8: 4, torch.int8: 4, torch.int16: 5, torch.uint16: 5,
    torch.int32: 6, torch.uint32: 6, torch.int64: 7, torch.uint64: 7,
}
# the signed type of each unsigned width: the plain version adds in it
# (torch has no add for the wide unsigned types; the bits are the same)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


class _Route:
    # process-wide, not per thread: autograd runs a CUDA tensor's backward
    # on its own device thread, which must see the route of the forward
    plain = False


_route = _Route()


@contextlib.contextmanager
def use_plain():
    """Run the plain versions on CUDA tensors too, inside the block, in
    every thread (the backward of a CUDA tensor runs on autograd's device
    thread): the oracle a kernel run is compared with."""
    before = _route.plain
    _route.plain = True
    try:
        yield
    finally:
        _route.plain = before


def on_kernel(x: torch.Tensor) -> bool:
    """True where ``x`` goes through the kernels: a CUDA tensor outside
    ``use_plain()``.  A tensor on any other device than CPU or CUDA
    raises."""
    if x.device.type == "cuda":
        return not _route.plain
    if x.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {x.device} are not supported")


def _real(x):
    """A complex tensor as its float pair (last dimension doubled)."""
    return torch.view_as_real(x) if x.is_complex() else x


def _check_blocks(x, nranks):
    if x.numel() % nranks:
        raise ValueError(
            f"a tensor of shape {tuple(x.shape)} does not split into "
            f"{nranks} rank blocks")


def _blocks(x, nranks):
    """``x`` as ``(nranks, block)``: row r is rank r's block."""
    _check_blocks(x, nranks)
    return x.reshape(nranks, -1)


# ---------------------------------------------------------------------------
# kernel 1: the hop
# ---------------------------------------------------------------------------


class _HopTable(tuple):
    """A checked hop table: n rows, one per rank, of k destinations (an int
    or None).  What is derived from it lives with it, so it is made once
    per table, and the table itself is cached on its comm (``_table``):
    the launch plan per device (``_hop_plan``) and the inverse table."""

    def __new__(cls, rows):
        table = super().__new__(cls, rows)
        table.plans = {}  # device -> the launch plan, (k, n) int32
        table.inverse = None
        return table


def _check_table(dst, k):
    """``dst`` as a ``_HopTable`` of rows, one per rank, of k destinations
    (an int or None); each payload's destinations must be distinct."""
    dst = _HopTable(tuple(row) for row in dst)
    n = len(dst)
    for row in dst:
        if len(row) != k:
            raise ValueError(f"a destination row has {len(row)} entries, "
                             f"expected {k}")
    for i in range(k):
        seen = [row[i] for row in dst if row[i] is not None]
        if any(not 0 <= d < n for d in seen):
            raise ValueError(f"payload {i}: destination out of range 0..{n - 1}")
        if len(set(seen)) != len(seen):
            raise ValueError(f"payload {i}: two ranks send to one rank")
    return dst


def _invert(dst):
    """The table of the reverse hop (the backward's), made once per
    table: rank d sends payload i to the rank that sent it to d."""
    if dst.inverse is None:
        k = len(dst[0]) if dst else 0
        inv = [[None] * k for _ in dst]
        for r, row in enumerate(dst):
            for i, d in enumerate(row):
                if d is not None:
                    inv[d][i] = r
        dst.inverse = _HopTable(tuple(row) for row in inv)
    return dst.inverse


def hop_plain(xs, dst):
    """The plain version of the hop: an index copy per payload."""
    n = len(dst)
    outs = []
    for i, x in enumerate(xs):
        src = _blocks(x, n)
        out = torch.zeros_like(src)
        rows = [r for r in range(n) if dst[r][i] is not None]
        if rows:
            to = torch.tensor([dst[r][i] for r in rows], device=x.device)
            out[to] = src[torch.tensor(rows, device=x.device)]
        outs.append(out.reshape(x.shape))
    return tuple(outs)


def _hop_plan(dst, dev):
    """The launch plan of the hop table ``dst`` on ``dev``, made once per
    table and device: a (k, n) int32 tensor on ``dev`` whose entry
    ``[i, d]`` is the rank whose block of payload i lands in block d, or -1
    where no rank sends there (the kernel zeroes that block).  It depends
    on neither the payloads' sizes nor their dtypes: the kernel takes
    those per launch."""
    plan = dst.plans.get(dev)
    if plan is None:
        inv = _invert(dst)
        k = len(dst[0])
        plan = torch.tensor(
            [[-1 if row[i] is None else row[i] for row in inv]
             for i in range(k)], dtype=torch.int32, device=dev)
        dst.plans[dev] = plan
    return plan


def _stream(dev):
    """The handle of ``dev``'s current stream, a plain int."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _device_guard(dev):
    """A context that makes ``dev`` the current device, and nothing where
    it already is."""
    if torch._C._cuda_getDevice() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _hop_kernel(xs, dst):
    """The hop on the card: one launch of ``csrc/hop.cu`` over every rank
    and payload, the untargeted blocks zeroed by the kernel.  A launch
    holds at most ``MAX_PAYLOADS`` payloads (callers pass at most 4)."""
    n, k = len(dst), len(xs)
    if k > MAX_PAYLOADS:
        raise ValueError(f"a hop on the card takes at most {MAX_PAYLOADS} "
                         f"payloads, got {k}")
    dev = xs[0].device
    plan = _hop_plan(dst, dev)
    # the contiguous inputs stay referenced until the launch is enqueued
    xs = [x.contiguous() for x in xs]
    outs = tuple(torch.empty_like(x) for x in xs)
    blocks = [x.numel() * x.element_size() // n for x in xs]
    if not any(blocks):
        return outs
    lib = _build.library("hop")
    fn = lib.hop_launch
    if fn.argtypes is None:  # declared once per loaded library
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    args = struct.pack(f"{2 * k}Q{k}q", *(x.data_ptr() for x in xs),
                       *(o.data_ptr() for o in outs), *blocks)
    with _device_guard(dev):
        err = fn(plan.data_ptr(), n, k, args, _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"hop_launch failed: {_build.error_string(lib, err)}")
    LAUNCHES["hop"] += 1
    return outs


def _hop_impl(xs, dst):
    n = len(dst)
    dev = xs[0].device
    for x in xs:
        _check_blocks(x, n)
        if x.device != dev:
            raise ValueError(f"payloads on {x.device} and {dev}")
    if on_kernel(xs[0]):
        return _hop_kernel(xs, dst)
    return hop_plain(xs, dst)


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dst, *xs):
        ctx.dst = dst
        return _hop_impl(xs, dst)

    @staticmethod
    def backward(ctx, *gs):
        # the cotangent flows back along each message edge
        return (None, *_hop_apply(_invert(ctx.dst), gs))


def _hop_apply(dst, xs):
    """The hop of the checked table ``dst``: through ``_Hop`` where a
    gradient is to be recorded, else straight to the launch."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _Hop.apply(dst, *xs)
    return _hop_impl(xs, dst)


def hop(xs, dst):
    """k payloads, one launch: ``out_i[dst[r][i]] = xs[i][r]``.

    ``xs``: k tensors whose leading dimensions hold the ranks (row r of
    ``x.reshape(n, -1)`` is rank r's block).  ``dst``: n rows of k
    destination ranks; ``None`` sends nothing.  An output block that no
    rank targets is zero, as ``ppermute`` leaves it.  On the card k is at
    most ``MAX_PAYLOADS``.  Returns a tuple.
    """
    xs = tuple(xs)
    dst = _check_table(dst, len(xs))
    return tuple(_hop_apply(dst, xs))


# ---------------------------------------------------------------------------
# functions composed from hops
# ---------------------------------------------------------------------------


def _table(comm, key, targets):
    """The checked hop table that sends payload i of each mesh rank to the
    rank with comm rank ``targets()[i][c]`` in its group (c its own comm
    rank), cached on the comm under ``key`` (``targets`` is called only
    to make it)."""
    table = comm.tables.get(key)
    if table is None:
        targets = targets()
        table = _check_table(
            [tuple(comm.peer(f, t[c]) for t in targets)
             for f, c in enumerate(comm.ranks())], len(targets))
        comm.tables[key] = table
    return table


def _shifts(comm, *shifts):
    n = comm.size()
    return _table(comm, ("shift",) + shifts,
                  lambda: [[(c + s) % n for c in range(n)] for s in shifts])


def ring_shift(x, comm, shift: int = 1):
    """One hop around the ring of ``comm``: each rank receives the block of
    rank ``me - shift``."""
    if shift == 0:
        return x
    return _hop_apply(_shifts(comm, shift), (x,))[0]


def ring_shift2(a, b, comm):
    """One bidirectional ring step in one launch: ``a`` moves right and
    ``b`` left; returns ``(a', b')``, ``a'`` the left neighbour's ``a`` and
    ``b'`` the right neighbour's ``b``."""
    return _hop_apply(_shifts(comm, 1, -1), (a, b))


def ring_shift_n(xs, comm, shift: int = 1):
    """k payloads one ring hop together, in one launch: each rank receives
    the blocks of comm rank ``me - shift`` (ring attention's k/v
    rotation).  ``shift == 0`` returns the inputs.  Differentiable: the
    gradient is the reverse shift."""
    xs = tuple(xs)
    if shift == 0:
        return xs
    return tuple(_hop_apply(_shifts(comm, *(shift,) * len(xs)), xs))


def exchange(x, comm, partners):
    """Pairwise exchange: comm rank c receives the block of comm rank
    ``partners[c]`` (an involution, such as the butterfly's XOR)."""
    partners = tuple(partners)
    return _hop_apply(_table(comm, ("exchange", partners), lambda: [partners]),
                      (x,))[0]


def _all_gather_impl(x, comm):
    n = comm.size()
    lead = comm.layout_shape
    local = x.shape[len(lead):]
    if n == 1:
        return x.unsqueeze(len(lead)).clone()
    cur, stacked = x, [x]
    for _ in range(n - 1):
        cur = ring_shift(cur, comm, 1)
        stacked.append(cur)
    # stacked[s] holds comm rank (me - s)'s block; row j wants rank j's
    rows = torch.stack([_blocks(s, comm.nranks) for s in stacked], dim=1)
    me = comm.rank(x.device).reshape(-1)  # cached per device
    src = (me[:, None] - torch.arange(n, device=x.device)[None, :]) % n
    out = rows[torch.arange(comm.nranks, device=x.device)[:, None], src]
    return out.reshape(*lead, n, *local)


def _reduce_scatter_impl(x, comm):
    n = comm.size()
    lead = comm.layout_shape
    local = x.shape[len(lead):]
    if not local or local[0] % n:
        raise ValueError(
            f"reduce_scatter_sum requires a leading local dimension divisible "
            f"by the ring size ({n}), got local shape {tuple(local)}")
    if n == 1:
        return x.clone()
    view = _blocks(x, comm.nranks).reshape(comm.nranks, n, -1)
    me = comm.rank(x.device).reshape(-1)  # cached per device
    every = torch.arange(comm.nranks, device=x.device)

    def chunk(s):
        # chunk forwarded at step s: after n-1 hops chunk `me` lands
        return view[every, (me - 1 - s) % n]

    partial = chunk(0)
    for s in range(1, n):
        partial = chunk(s) + ring_shift(partial, comm, 1)
    return partial.reshape(*lead, local[0] // n, *local[1:])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        ctx.shape = x.shape
        return _all_gather_impl(x, comm)

    @staticmethod
    def backward(ctx, g):
        # y_r[j] = x_j on every rank r, so dx = sum_r g_r[me]: this rank's
        # chunk of a reduce-scatter over the flattened cotangent rows
        lead = ctx.comm.layout_shape
        flat = g.reshape(*lead, -1)
        return reduce_scatter_sum(flat, ctx.comm).reshape(ctx.shape), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        ctx.shape = x.shape
        return _reduce_scatter_impl(x, comm)

    @staticmethod
    def backward(ctx, g):
        # y_me = sum_r x_r[chunk me]: dx[chunk j] = g_j, an all-gather
        rows = all_gather(g, ctx.comm)
        return rows.reshape(ctx.shape), None


def all_gather(x, comm):
    """Ring all-gather over hops: ``(*lead, n, *local)``, row j = comm rank
    j's block (n-1 hops of one block each)."""
    return _AllGather.apply(x, comm)


def reduce_scatter_sum(x, comm):
    """Ring reduce-scatter (SUM) over hops: the local ``(n*c, ...)``
    becomes this rank's fully reduced chunk ``(c, ...)`` (chunk = rank).
    At step s each rank forwards the partial of chunk ``(me - 1 - s) % n``
    and adds its own contribution as the partial passes."""
    return _ReduceScatter.apply(x, comm)


def _allreduce_butterfly(flat, comm):
    n = comm.size()
    acc = flat
    k = 1
    while k < n:
        acc = acc + exchange(acc, comm, [c ^ k for c in range(n)])
        k *= 2
    return acc


# ---------------------------------------------------------------------------
# kernel 3: the fused ring allreduce
# ---------------------------------------------------------------------------


def _chunk_lo(count, n, i):
    per = -(-count // n)
    return min(per * i, count)


def fused_ring_allreduce_plain(rows: torch.Tensor) -> torch.Tensor:
    """The plain version of the fused ring: a torch replay of
    ``topo.simulate_ring_sum``'s association over the n rows of ``rows``
    ``(n, count)``; every row of the result is the sum."""
    n, count = rows.shape
    signed = _SIGNED.get(rows.dtype)
    bufs = rows.view(signed) if signed is not None else rows
    bufs = bufs.clone()
    for s in range(n - 1):
        for r in range(n):
            # rank r folds chunk (r-1-s) % n arriving from its left; no
            # chunk is read and written in one step
            c = (r - 1 - s) % n
            lo, hi = _chunk_lo(count, n, c), _chunk_lo(count, n, c + 1)
            bufs[r, lo:hi] = bufs[r, lo:hi] + bufs[(r - 1) % n, lo:hi]
    out = torch.empty_like(bufs)
    for c in range(n):
        lo, hi = _chunk_lo(count, n, c), _chunk_lo(count, n, c + 1)
        out[:, lo:hi] = bufs[(c - 1) % n, lo:hi]
    return out.view(rows.dtype) if signed is not None else out


def fused_ring_kernel(rows: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/fused_ring.cu`` on contiguous CUDA ``rows``
    ``(n, count)``: the same function as ``fused_ring_allreduce_plain``."""
    n, count = rows.shape
    kind = _RING_KINDS.get(rows.dtype)
    if kind is None:
        raise TypeError(f"the fused ring takes no {rows.dtype}")
    if not rows.is_cuda:
        raise ValueError(f"fused_ring_kernel needs a CUDA tensor, got "
                         f"{rows.device}")
    rows = rows.contiguous()
    out = torch.empty_like(rows)
    if count == 0 or n == 1:
        return out.copy_(rows)
    lib = _build.library("fused_ring")
    fn = lib.fused_ring_launch
    if fn.argtypes is None:  # declared once per loaded library
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with _device_guard(rows.device):
        err = fn(rows.data_ptr(), out.data_ptr(), count, n, kind,
                 _stream(rows.device))
    if err != 0:
        raise RuntimeError(
            f"fused_ring_launch failed: {_build.error_string(lib, err)}")
    LAUNCHES["fused_ring"] += 1
    return out


def _to_front(x, comm):
    """``x`` as ``(n, groups, *local)``: the comm's rank dimensions first
    and flattened, the mesh's other rank dimensions next."""
    lead = len(comm.layout)
    dims = comm.dims
    rest = [d for d in range(lead) if d not in dims]
    perm = list(dims) + rest + list(range(lead, x.dim()))
    return x.permute(perm).reshape(comm.size(), -1, *x.shape[lead:])


def _from_front(y, comm, shape):
    """The inverse of ``_to_front`` for a tensor of the mesh shape
    ``shape``."""
    lead = len(comm.layout)
    dims = comm.dims
    rest = [d for d in range(lead) if d not in dims]
    order = list(dims) + rest
    permuted = [shape[d] for d in order] + list(shape[lead:])
    y = y.reshape(permuted)
    inverse = [0] * lead
    for i, d in enumerate(order):
        inverse[d] = i
    return y.permute(inverse + list(range(lead, len(shape))))


def _fused_ring_impl(x, comm):
    n = comm.size()
    if n == 1:
        return x.clone()
    real = _real(x)
    front = _to_front(real, comm)
    rows = front.reshape(n, front.shape[1], -1)
    ring = (fused_ring_kernel if on_kernel(x)
            else fused_ring_allreduce_plain)
    if rows.shape[1] == 1:  # the comm spans the mesh: one ring
        out = ring(rows[:, 0].contiguous()).reshape(real.shape)
    else:  # one ring per group of the comm
        out = torch.stack([ring(rows[:, g].contiguous())
                           for g in range(rows.shape[1])], dim=1)
        out = _from_front(out, comm, real.shape).contiguous()
    return torch.view_as_complex(out) if x.is_complex() else out


class _FusedRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _fused_ring_impl(x, comm)

    @staticmethod
    def backward(ctx, g):
        # the cotangent of an allreduce-SUM is an allreduce-SUM
        return fused_ring_allreduce_sum(g, ctx.comm), None


def fused_ring_allreduce_sum(x, comm):
    """Ring allreduce (SUM) in one kernel launch per ring, with the native
    ``_chunk_lo`` chunks: the f32 result is bit for bit
    ``topo.simulate_ring_sum`` of the ranks' blocks."""
    return _FusedRing.apply(x, comm)


# ---------------------------------------------------------------------------
# the allreduce dispatch
# ---------------------------------------------------------------------------


def allreduce_arm(count: int, n: int) -> str:
    """The arm ``allreduce_sum`` takes for ``count`` elements per rank over
    ``n`` ranks: "identity", "butterfly", "fused_ring" or "hop_rs_ag"."""
    if n == 1:
        return "identity"
    if count <= BUTTERFLY_MAX_ELEMS and (n & (n - 1)) == 0:
        return "butterfly"
    if count >= BIDIR_MIN_ELEMS and n > 2:
        return "fused_ring"
    return "hop_rs_ag"


def allreduce_launches(count: int, n: int) -> dict:
    """The launches of one ``allreduce_sum`` of ``count`` elements per rank
    over ``n`` ranks (one ring), by kernel: the butterfly's log2(n) hops,
    the fused ring's one launch, or the 2(n-1) hops of reduce-scatter and
    all-gather."""
    arm = allreduce_arm(count, n)
    hops = {"identity": 0, "fused_ring": 0, "hop_rs_ag": 2 * (n - 1),
            "butterfly": max(n - 1, 0).bit_length()}[arm]
    return {"hop": hops, "fused_ring": int(arm == "fused_ring")}


def _allreduce_sum_impl(x, comm):
    n = comm.size()
    lead = comm.layout_shape
    local = x.shape[len(lead):]
    flat = x.reshape(*lead, -1)
    count = flat.shape[-1]
    arm = allreduce_arm(count, n)
    if arm == "identity":
        return x.clone()
    if arm == "butterfly":
        return _allreduce_butterfly(flat, comm).reshape(x.shape)
    if arm == "fused_ring":
        return _fused_ring_impl(x, comm)
    pad = (-count) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(*lead, pad)], dim=-1)
    mine = _reduce_scatter_impl(flat, comm)
    full = _all_gather_impl(mine, comm).reshape(*lead, -1)
    if pad:
        full = full[..., :count]
    return full.reshape(*lead, *local)


class _AllreduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _allreduce_sum_impl(x, comm)

    @staticmethod
    def backward(ctx, g):
        return allreduce_sum(g, ctx.comm), None


def allreduce_sum(x, comm):
    """Allreduce (SUM) over ``comm``, dispatched on the per-rank element
    count (see ``allreduce_arm``).  Differentiable: the cotangent of an
    allreduce-SUM is an allreduce-SUM."""
    return _AllreduceSum.apply(x, comm)


# ---------------------------------------------------------------------------
# kernel 2: the alltoall
# ---------------------------------------------------------------------------


def _alltoall_sources(comm, device):
    """Per output row ``(f, j)`` of the flattened ``(nranks * n)`` rows,
    the input row it copies: ``(comm.peer(f, j), c)`` with c the comm rank
    of mesh rank f.  An int32 tensor on ``device``, cached on the comm."""
    key = ("alltoall", str(device))
    src = comm.tables.get(key)
    if src is None:
        n = comm.size()
        rows = [comm.peer(f, j) * n + c
                for f, c in enumerate(comm.ranks()) for j in range(n)]
        src = torch.tensor(rows, dtype=torch.int32, device=device)
        comm.tables[key] = src
    return src


def _check_alltoall(x, comm):
    n = comm.size()
    local = x.shape[len(comm.layout):]
    if not local or local[0] != n:
        raise ValueError(
            f"alltoall requires leading axis == communicator size ({n}), "
            f"got local shape {tuple(local)}")


def alltoall_plain(x, comm):
    """The plain version of the alltoall: an index copy of the rows."""
    npairs = comm.nranks * comm.size()
    rows = x.reshape(npairs, x.numel() // npairs)
    src = _alltoall_sources(comm, x.device)
    return torch.index_select(rows, 0, src).reshape(x.shape)


def _alltoall_kernel(x, comm):
    x = x.contiguous()
    out = torch.empty_like(x)
    npairs = comm.nranks * comm.size()
    row_bytes = x.numel() * x.element_size() // npairs
    if row_bytes == 0:
        return out
    src = _alltoall_sources(comm, x.device)
    lib = _build.library("alltoall")
    fn = lib.alltoall_launch
    if fn.argtypes is None:  # declared once per loaded library
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with _device_guard(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), src.data_ptr(), row_bytes,
                 npairs, _stream(x.device))
    if err != 0:
        raise RuntimeError(
            f"alltoall_launch failed: {_build.error_string(lib, err)}")
    LAUNCHES["alltoall"] += 1
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        if on_kernel(x):
            return _alltoall_kernel(x, comm)
        return alltoall_plain(x, comm)

    @staticmethod
    def backward(ctx, g):
        # out[f, j] = x[peer(f, j), c_f]: the cotangent of row i is what
        # rank i holds for us, another alltoall (the op is its own
        # transpose)
        return alltoall(g, ctx.comm), None


def alltoall(x, comm):
    """Direct alltoall in one launch: ``x`` is ``(*lead, n, *rest)``; mesh
    rank f, with comm rank c, receives ``out[f, j] = x[comm.peer(f, j), c]``
    (``lax.all_to_all(split_axis=0, concat_axis=0)`` per rank).  With n = 1
    it returns ``x`` and launches nothing.  Differentiable: the op is its
    own transpose."""
    _check_alltoall(x, comm)
    if comm.size() == 1:
        return x
    return _AllToAll.apply(x, comm)


def ring_shift_of(perm, size: int):
    """If ``perm`` is exactly the ring pattern ``i -> (i+k) % n`` for some
    nonzero k, return k; else None."""
    pairs = set((int(a), int(b)) for a, b in perm)
    if len(pairs) != size:
        return None
    shifts = set((b - a) % size for a, b in pairs)
    if len(shifts) != 1:
        return None
    k = shifts.pop()
    if k == 0:
        return None
    if pairs != {(i, (i + k) % size) for i in range(size)}:
        return None
    return k
