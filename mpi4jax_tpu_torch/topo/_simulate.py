"""Numpy models of the hierarchical allreduce's exact f32 arithmetic.

A copy of ``mpi4jax_tpu/topo/_simulate.py:34-212`` for f32 SUM: each
function replays the association of a native schedule, so a world run is
held to it bit for bit.

- ``simulate_ring_sum``: the chunked ring (native ``ring_allreduce``, and
  the fused ring kernel, ``csrc/fused_ring.cu``);
- ``simulate_rd_sum``: recursive doubling with the non-power-of-two fold;
- ``simulate_hring_sum`` / ``simulate_htree_sum``: the island sums, then
  the ring or recursive doubling over the leaders.  ``intra="member"`` is
  the native intra fold (island members in order), ``intra="ring"`` the
  intra-island leg's ring (``topo/_ici_leg.py``);
- ``simulate_ici_q_sum``: the quantized leg: the ring island sums, each
  packed once with the int8 codec, dequantized and folded in island order;
- ``simulate_qring_sum`` / ``simulate_qrd_sum``: the transport's quantized
  schedules, copies of ``mpi4jax_tpu/ops/quantized.py:319-377``;
- ``simulate_tree_sum``: the binomial tree (native ``tree_allreduce``),
  which the JAX package has no model of: the world tier's forced ``tree``
  is held to it;
- ``simulate_qalltoall`` / ``simulate_halltoall`` / ``simulate_hqalltoall``:
  the alltoall family, copies of ``mpi4jax_tpu/topo/_simulate.py:219-280``
  (every off-rank chunk through the codec; the exact permutation; each
  cross-island block one codec frame on the leader leg).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..ops import quantized as _q


def _chunk_lo(count: int, size: int, i: int) -> int:
    per = (count + size - 1) // size
    return min(per * i, count)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def simulate_ring_sum(inputs: Sequence[np.ndarray]) -> np.ndarray:
    """The chunked ring allreduce's f32 SUM: the reduce-scatter folds each
    chunk in ring arrival order, the allgather copies bytes; every rank
    holds the returned bits."""
    n = len(inputs)
    if n == 1:
        return _f32(inputs[0]).copy()
    bufs = [_f32(v).copy() for v in inputs]
    count = bufs[0].size
    for step in range(n - 1):
        # every rank sends before it receives within a step: snapshot the
        # outgoing chunks, then fold
        outgoing = []
        for r in range(n):
            sc = (r - step) % n
            lo, hi = _chunk_lo(count, n, sc), _chunk_lo(count, n, sc + 1)
            outgoing.append((r, sc, bufs[r][lo:hi].copy()))
        for r, sc, data in outgoing:
            dst = (r + 1) % n
            lo, hi = _chunk_lo(count, n, sc), _chunk_lo(count, n, sc + 1)
            bufs[dst][lo:hi] = (bufs[dst][lo:hi] + data).astype(np.float32)
    out = np.empty_like(bufs[0])
    for c in range(n):
        # chunk c is complete at rank (c-1) % n
        owner = (c - 1) % n
        lo, hi = _chunk_lo(count, n, c), _chunk_lo(count, n, c + 1)
        out[lo:hi] = bufs[owner][lo:hi]
    return out


def simulate_rd_sum(inputs: Sequence[np.ndarray]) -> np.ndarray:
    """Recursive doubling's f32 SUM, with the non-power-of-two fold."""
    n = len(inputs)
    if n == 1:
        return _f32(inputs[0]).copy()
    bufs = [_f32(v).copy() for v in inputs]
    pof2 = 1
    while pof2 * 2 <= n:
        pof2 *= 2
    rem = n - pof2
    participants = {}  # newrank -> rank
    for r in range(n):
        if r < 2 * rem:
            if r % 2 == 1:
                # the odd member folds its even neighbour
                bufs[r] = (bufs[r] + bufs[r - 1]).astype(np.float32)
                participants[r // 2] = r
        else:
            participants[r - rem] = r
    mask = 1
    while mask < pof2:
        snapshot = {nr: bufs[pr].copy() for nr, pr in participants.items()}
        for nr, pr in participants.items():
            bufs[pr] = (bufs[pr] + snapshot[nr ^ mask]).astype(np.float32)
        mask <<= 1
    for r in range(2 * rem):
        if r % 2 == 0:
            bufs[r] = bufs[r + 1].copy()
    return bufs[0]


def simulate_tree_sum(inputs: Sequence[np.ndarray]) -> np.ndarray:
    """The binomial tree's f32 SUM (native ``tree_allreduce``): at each
    mask, a rank with that bit clear folds in rank ``r + mask``'s partial
    sum; rank 0's total is broadcast."""
    n = len(inputs)
    bufs = [_f32(v).copy() for v in inputs]
    mask = 1
    while mask < n:
        for r in range(0, n, 2 * mask):
            if r + mask < n:
                bufs[r] = (bufs[r] + bufs[r + mask]).astype(np.float32)
        mask <<= 1
    return bufs[0]


def _qdq(x: np.ndarray) -> np.ndarray:
    """The codec's quantize-dequantize round trip, in ``x``'s shape."""
    x = np.asarray(x)
    return _q.quant_unpack_ref(*_q.quant_pack_ref(x)).reshape(x.shape)


def simulate_qring_sum(parts: Sequence[np.ndarray]) -> np.ndarray:
    """The native ``qring`` allreduce: a direct quantized reduce-scatter
    (each rank's inputs quantized once, contributions folded in fixed rank
    order) followed by the once-quantized allgather; the one result every
    rank holds."""
    parts = [np.ascontiguousarray(p, np.float32).reshape(-1) for p in parts]
    size = len(parts)
    count = parts[0].size
    if size == 1:
        return parts[0].copy()
    out = np.empty(count, np.float32)
    for c in range(size):
        lo, hi = _chunk_lo(count, size, c), _chunk_lo(count, size, c + 1)
        acc = parts[c][lo:hi].astype(np.float32)  # owner's own data, exact
        # arrival order rank-1, rank-2, ... (the fixed fold order)
        for round_ in range(1, size):
            src = (c - round_) % size
            acc = (acc + _qdq(parts[src][lo:hi])).astype(np.float32)
        out[lo:hi] = _qdq(acc)  # once-quantized allgather
    return out


def simulate_qrd_sum(parts: Sequence[np.ndarray]) -> np.ndarray:
    """The native ``qrd`` allreduce: quantized recursive doubling with the
    non-power-of-two fold and the final requantize that keeps every rank
    bit-identical."""
    parts = [np.ascontiguousarray(p, np.float32).reshape(-1) for p in parts]
    size = len(parts)
    if size == 1:
        return parts[0].copy()
    accs = [p.astype(np.float32) for p in parts]
    pof2 = 1
    while pof2 * 2 <= size:
        pof2 *= 2
    rem = size - pof2
    group = {}  # newrank -> acc
    for rank in range(size):
        if rank < 2 * rem:
            if rank % 2 == 1:
                group[rank // 2] = (_qdq(accs[rank])
                                    + _qdq(accs[rank - 1])
                                    ).astype(np.float32)
        else:
            group[rank - rem] = accs[rank]
    for shift in range(pof2.bit_length() - 1):
        mask = 1 << shift
        nxt = {}
        for nr, acc in group.items():
            peer = nr ^ mask
            nxt[nr] = (_qdq(acc) + _qdq(group[peer])).astype(np.float32)
        group = nxt
    # all butterfly participants are bit-identical now
    result = group[0]
    if rem > 0:
        result = _qdq(result)  # the quantized return frame
    return result


def _island_sums(inputs: Sequence[np.ndarray],
                 islands: Sequence[Sequence[int]]) -> List[np.ndarray]:
    """The native intra fold: island members in order, in f32."""
    sums = []
    for members in islands:
        acc = _f32(inputs[members[0]]).copy()
        for m in members[1:]:
            acc = (acc + _f32(inputs[m])).astype(np.float32)
        sums.append(acc)
    return sums


def _intra_sums(inputs: Sequence[np.ndarray],
                islands: Sequence[Sequence[int]],
                intra: str) -> List[np.ndarray]:
    if intra == "member":
        return _island_sums(inputs, islands)
    if intra == "ring":
        return [simulate_ring_sum([inputs[m] for m in members])
                for members in islands]
    raise ValueError(f"unknown intra association {intra!r} "
                     "(expected 'member' or 'ring')")


def simulate_hring_sum(inputs: Sequence[np.ndarray],
                       islands: Sequence[Sequence[int]],
                       intra: str = "member") -> np.ndarray:
    """The native ``hring`` f32 SUM: ``inputs`` one array per world rank,
    ``islands`` the member lists in island order (``Topology.islands``);
    the ring over the island sums."""
    return simulate_ring_sum(_intra_sums(inputs, islands, intra))


def simulate_htree_sum(inputs: Sequence[np.ndarray],
                       islands: Sequence[Sequence[int]],
                       intra: str = "member") -> np.ndarray:
    """The native ``htree`` f32 SUM: recursive doubling over the island
    sums."""
    return simulate_rd_sum(_intra_sums(inputs, islands, intra))


def simulate_ici_q_sum(inputs: Sequence[np.ndarray],
                       islands: Sequence[Sequence[int]]) -> np.ndarray:
    """The quantized leg's f32 SUM: each ring island sum packed once,
    dequantized, and folded in island order (no re-quantization)."""
    acc = None
    for s in _intra_sums(inputs, islands, "ring"):
        scales, codes = _q.quant_pack_ref(s)
        d = _q.quant_unpack_ref(scales, codes)
        acc = d if acc is None else (acc + d).astype(np.float32)
    return acc


def simulate_qalltoall(inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Bit-exact model of the native ``qalltoall`` f32 exchange:
    ``inputs`` is one ``(size, count...)`` array per world rank; returns
    each rank's output.  Every off-rank chunk rides the int8+scales wire
    codec — the destination dequantizes the SENDER's packed bytes, so
    rank consistency is by construction — while the own-rank chunk is a
    local copy and stays exact.  bf16 callers model the native staging
    by upcasting to f32 before and RNE-rounding after (the codec itself
    always runs in f32)."""
    n = len(inputs)
    outs = []
    for dst in range(n):
        chunks = []
        for src in range(n):
            c = _f32(inputs[src][dst])
            chunks.append(c.copy() if src == dst else _qdq(c))
        outs.append(np.stack(chunks))
    return outs


def simulate_halltoall(inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Model of the exact hierarchical alltoall: ``halltoall`` is a pure
    permutation (every leg moves bytes verbatim), so its output is
    bit-identical to the flat pairwise exchange regardless of the island
    partition — which is exactly what this returns."""
    n = len(inputs)
    return [np.stack([_f32(inputs[src][dst]) for src in range(n)])
            for dst in range(n)]


def simulate_hqalltoall(inputs: Sequence[np.ndarray],
                        islands: Sequence[Sequence[int]]
                        ) -> List[np.ndarray]:
    """Bit-exact model of ``hqalltoall``: intra-island chunks (own chunk
    included) are exact; each cross-island block — all chunks from
    island ``a`` to island ``b``, concatenated src-member-major in
    member order — is quantized as ONE codec frame on the leader leg,
    so the 256-element codec blocks span chunk boundaries exactly as
    the native leader exchange packs them."""
    n = len(inputs)
    chunk_shape = _f32(inputs[0][0]).shape
    count = int(np.prod(chunk_shape, dtype=np.int64)) if chunk_shape else 1
    outs = [np.empty((n,) + chunk_shape, np.float32) for _ in range(n)]
    for a, mem_a in enumerate(islands):
        for b, mem_b in enumerate(islands):
            if a == b:
                for s in mem_a:
                    for t in mem_b:
                        outs[t][s] = _f32(inputs[s][t])
                continue
            block = np.concatenate([_f32(inputs[s][t]).reshape(-1)
                                    for s in mem_a for t in mem_b])
            d = _qdq(block)
            i = 0
            for s in mem_a:
                for t in mem_b:
                    outs[t][s] = d[i * count:(i + 1) * count].reshape(
                        chunk_shape)
                    i += 1
    return outs
