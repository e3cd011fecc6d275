"""Every world-tier op on seeded inputs, each rank held to numpy oracles.

The counterpart of ``tests/world_programs/basic_ops.py``, ``full_ops.py``,
``status_ops.py``, ``neighbor_ops.py`` and the torch-expressible parts of
``autodiff.py``.  Every rank makes every rank's inputs from the seed
(``rank_input``), runs the ops on its own tensor on ``--device`` and holds
each result to an oracle computed from all the inputs:

- bit for bit: data movement (allgather, alltoall, bcast, gather, scatter,
  sendrecv, send/recv, neighbor_exchange) in ``DTYPES``, integer, logical
  and bitwise reductions, MAX and MIN in all 15 wire dtypes (``DTYPES``
  and ``OTHER_DTYPES``, the latter with an allgather), the custom op; the f32 SUM under the engine's
  pick and forced ``ring``, ``rd``, ``tree`` (and ``hring``/``htree`` on a
  multi-island world) against ``topo/_simulate.py``; ``qring``/``qrd``
  against ``simulate_q{ring,rd}_sum``; the int8 Python schedule against
  ``quantized.quantized_allreduce_ref``.  On a comm whose collectives ride
  the same-host shared-memory arena every algorithm is the arena's, so
  there the forced f32 SUMs are held to the engine's pick bit for bit, and
  the sums to a tolerance;
- to a stated tolerance (``RTOL``, of the sum of magnitudes): the other
  float sums and products, whose fold the transport does in its own
  order;
- analytically: status and wildcards, walls and self-wrap, gather's
  non-root result, the gradients (the SUM allreduce's is the cotangent;
  sendrecv's goes back along the edge, tags swapped), and the refusals
  (a MAX allreduce's and an allgather's backward raise).

It also holds an op queued right behind a kernel on the same stream to
its oracle (on the card that is the pinned copy's wait), and ``split`` and
``dup`` sub-communicators.  Each rank writes its results to
``rank<r>.npz`` (bf16 as f32) for the tests, which hold them to the JAX
package's mesh tier.

Run as the ranks' program:

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 \\
        -m mpi4jax_tpu_torch.benchmarks.world_ops -- --device cpu --out DIR

or through ``run_job`` (the launcher in-process), which returns rank 0's
record.  ``MPI4JAX_TPU_ICI_LEG`` is set to ``off``, on the card too: the
forced ``hring``/``htree`` here are the transport's own schedules, and
the intra-island leg (``topo/_ici_leg.py``) in front of them is held to
its simulators by ``benchmarks/ici_leg.py`` instead.  The transport reads
its knobs once, so a job sets them before it loads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

if __package__ in (None, ""):  # run as a file by the launcher's ranks
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

DTYPES = ("float32", "float64", "float16", "bfloat16", "complex64", "int32",
          "int64", "uint8", "bool")
#: the rest of the 15 wire dtypes: their reductions and an allgather
OTHER_DTYPES = ("int8", "int16", "uint16", "uint32", "uint64", "complex128")
_INTS = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
         "uint64")
COUNT = 7                         # elements per rank of the dtype sweep
SCHED_COUNTS = (5, 513, 70000)    # f32 SUM schedules (below and above 64 KiB)
QUANT_COUNTS = (513, 70000)       # the int8 allreduce: qrd, qring
SEED = 0
#: tolerance of a float SUM/PROD whose fold order is the transport's, of
#: the sum of the ranks' magnitudes (the rounding of n - 1 additions)
RTOL = {"float32": 1e-6, "float64": 1e-14, "float16": 4e-3,
        "bfloat16": 3e-2, "complex64": 1e-6, "complex128": 1e-14}
ABSMAX_NAME = "ABSMAX_WORLD_OPS"


# ---------------- inputs ----------------


def rank_input(dtype: str, rank: int, shape=(COUNT,), tag: str = "x"
               ) -> np.ndarray:
    """Rank ``rank``'s input ``tag`` of ``dtype`` as numpy (bf16 as the f32
    values of bf16 numbers).  Integers are small, so sums and products of a
    few ranks do not leave int32; ``tag="pos"`` floats lie in [0.5, 1.5]
    (products)."""
    import torch

    rng = np.random.default_rng(
        [SEED, rank, zlib.crc32(f"{dtype}/{tag}".encode())])
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype in _INTS:
        low = 0 if dtype.startswith("u") else -9
        return rng.integers(low, 10 if low else 40, shape).astype(dtype)
    if tag == "pos":
        v = rng.uniform(0.5, 1.5, shape)
    else:
        v = rng.standard_normal(shape)
    if dtype.startswith("complex"):
        w = rng.standard_normal(shape)
        return (v + 1j * w).astype(dtype)
    if dtype == "bfloat16":
        t = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        return t.float().numpy()
    return v.astype(dtype)


def all_inputs(dtype, n, shape=(COUNT,), tag="x"):
    return np.stack([rank_input(dtype, r, shape, tag) for r in range(n)])


def to_tensor(a: np.ndarray, dtype: str, dev):
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    return t.to(dev)


def to_numpy(t) -> np.ndarray:
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def reduce_ops_for(dtype: str):
    """The built-in ops that ``dtype`` admits (complex: SUM and PROD, as
    the transport)."""
    if dtype == "bool":
        return ("LAND", "LOR", "LXOR", "BAND", "BOR", "BXOR")
    if dtype in _INTS:
        return ("SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND",
                "BOR", "BXOR")
    if dtype.startswith("complex"):
        return ("SUM", "PROD")
    return ("SUM", "PROD", "MAX", "MIN")


def oracle_reduce(stack: np.ndarray, op: str, dtype: str) -> np.ndarray:
    """The reduction of the ranks' rows in numpy: exact for every op but a
    float SUM or PROD (there in float64 or complex128)."""
    if op in ("SUM", "PROD") and dtype not in _INTS:
        wide = stack.astype(np.complex128 if dtype.startswith("complex")
                            else np.float64)
        return wide.sum(0) if op == "SUM" else wide.prod(0)
    fn = {"SUM": np.add, "PROD": np.multiply, "MAX": np.maximum,
          "MIN": np.minimum, "LAND": np.logical_and, "LOR": np.logical_or,
          "LXOR": np.logical_xor, "BAND": np.bitwise_and,
          "BOR": np.bitwise_or, "BXOR": np.bitwise_xor}[op]
    return fn.reduce(stack, axis=0).astype(stack.dtype)


def inexact(op: str, dtype: str) -> bool:
    return op in ("SUM", "PROD") and dtype in RTOL


# ---------------- the rank program ----------------


class _Checks:
    def __init__(self, rank):
        self.rank = rank
        self.n = 0
        self.worst = {}

    def bits(self, what, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape or got.dtype != want.dtype \
                or not np.array_equal(got, want):
            raise AssertionError(
                f"rank {self.rank}: {what}: got {got!r}, want {want!r}")
        self.n += 1

    def close(self, what, got, want, scale, rtol):
        got = np.asarray(got)
        err = np.abs(got.astype(want.dtype) - want)
        bound = rtol * np.maximum(scale, np.finfo(np.float32).tiny)
        if got.shape != want.shape or not np.all(err <= bound):
            raise AssertionError(
                f"rank {self.rank}: {what}: got {got!r}, want {want!r} "
                f"(rtol {rtol} of {scale!r})")
        rel = float(np.max(err / bound) * rtol) if err.size else 0.0
        self.worst[what.split(" ")[0]] = max(
            self.worst.get(what.split(" ")[0], 0.0), rel)
        self.n += 1

    def true(self, what, cond):
        if not cond:
            raise AssertionError(f"rank {self.rank}: {what}")
        self.n += 1


def _raises(fn, exc=NotImplementedError):
    try:
        fn()
    except exc:
        return True
    return False


def _sum_sim(name, parts, islands):
    from mpi4jax_tpu_torch.topo import _simulate as sim

    if name == "ring":
        return sim.simulate_ring_sum(parts)
    if name == "rd":
        return sim.simulate_rd_sum(parts)
    if name == "tree":
        return sim.simulate_tree_sum(parts)
    if name == "hring":
        return sim.simulate_hring_sum(parts, islands)
    if name == "htree":
        return sim.simulate_htree_sum(parts, islands)
    raise ValueError(name)


def run_rank(device: str, out_dir: str) -> dict:
    """Run every check on this rank; returns its record (the results go to
    ``out_dir/rank<r>.npz``)."""
    import torch

    import mpi4jax_tpu_torch as mt
    from mpi4jax_tpu_torch import tune
    from mpi4jax_tpu_torch.ops import quantized
    from mpi4jax_tpu_torch.runtime import bridge, transport
    from mpi4jax_tpu_torch.topo import _simulate as sim

    t_start = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    comm = transport.get_world_comm(device=dev)
    rank, n = comm.rank(), comm.size()
    h = comm.handle
    arena = bridge.shm_active(h)
    topo = comm.topology()
    multi = topo is not None and topo.multi
    islands = topo.islands if multi else [list(range(n))]
    ck = _Checks(rank)
    res = {}

    def keep(name, t):
        res[name] = to_numpy(t) if isinstance(t, torch.Tensor) else t
        return res[name]

    def ops_of(name):
        return getattr(mt, name)

    # -- the dtype sweep: every built-in op on every dtype it admits ------
    for dt in DTYPES + OTHER_DTYPES:
        stack = all_inputs(dt, n)
        pos = all_inputs(dt, n, tag="pos")
        x = to_tensor(stack[rank], dt, dev)
        for op in reduce_ops_for(dt):
            src = pos if op == "PROD" else stack
            xin = to_tensor(src[rank], dt, dev)
            got = keep(f"allreduce/{op}/{dt}",
                       mt.allreduce(xin, op=ops_of(op), comm=comm))
            want = oracle_reduce(src, op, dt)
            if inexact(op, dt):
                scale = (np.abs(src).astype(np.float64).sum(0)
                         if op == "SUM" else np.abs(want))
                ck.close(f"allreduce/{op}/{dt}", got, want, scale, RTOL[dt])
            else:
                ck.bits(f"allreduce/{op}/{dt}", got, want)
        # data movement: bit for bit in every dtype
        ck.bits(f"allgather/{dt}", keep(f"allgather/{dt}",
                                        mt.allgather(x, comm=comm)), stack)
        if dt in OTHER_DTYPES:
            continue
        rows = all_inputs(dt, n, shape=(n, 3), tag="rows")
        got = keep(f"alltoall/{dt}", mt.alltoall(to_tensor(rows[rank], dt,
                                                           dev), comm=comm))
        ck.bits(f"alltoall/{dt}", got, rows[:, rank])
        got = keep(f"scatter/{dt}", mt.scatter(to_tensor(rows[rank], dt,
                                                         dev), root=0,
                                               comm=comm))
        ck.bits(f"scatter/{dt}", got, rows[0, rank])
        ck.bits(f"bcast/{dt}", keep(f"bcast/{dt}", mt.bcast(
            x, root=n - 1, comm=comm)), stack[n - 1])
        got = keep(f"gather/{dt}", mt.gather(x, root=0, comm=comm))
        ck.bits(f"gather/{dt}", got, stack if rank == 0 else stack[rank])
        ck.bits(f"shift+1/{dt}", keep(f"shift+1/{dt}", mt.sendrecv(
            x, shift=1, comm=comm)), stack[(rank - 1) % n])
        perm = [(s, (s - 1) % n) for s in range(n)]
        ck.bits(f"perm/{dt}", keep(f"perm/{dt}", mt.sendrecv(
            x, perm=perm, comm=comm)), stack[(rank + 1) % n])
        if dt != "bool":
            got = keep(f"scan/{dt}", mt.scan(x, op=mt.SUM, comm=comm))
            want = stack[0].copy()
            for r in range(1, rank + 1):
                want = (want + stack[r]).astype(stack.dtype)
            if dt in RTOL:
                if dt == "float32" and not arena:
                    ck.bits(f"scan/{dt}", got, want)  # the chain's fold
                else:
                    ck.close(f"scan/{dt}", got, want, np.abs(
                        stack[:rank + 1]).astype(np.float64).sum(0), RTOL[dt])
            else:
                ck.bits(f"scan/{dt}", got, want)
            got = keep(f"reduce/{dt}", mt.reduce(x, op=mt.SUM, root=0,
                                                 comm=comm))
            if rank != 0:
                ck.bits(f"reduce/{dt}", got, stack[rank])
            elif dt in RTOL:
                ck.close(f"reduce/{dt}", got, oracle_reduce(stack, "SUM", dt),
                         np.abs(stack).astype(np.float64).sum(0), RTOL[dt])
            else:
                ck.bits(f"reduce/{dt}", got, oracle_reduce(stack, "SUM", dt))

    # -- the f32 SUM schedules: the engine's pick and each forced one -----
    forced = ["ring", "rd", "tree"] + (["hring", "htree"] if multi else [])
    for count in SCHED_COUNTS:
        parts = list(all_inputs("float32", n, (count,), "sched"))
        x = to_tensor(parts[rank], "float32", dev)
        pick = tune.get_algorithm("allreduce", count * 4)
        auto = keep(f"sum/auto/{count}", mt.allreduce(x, comm=comm))
        if arena:
            want = auto
            ck.close(f"sum/auto/{count}", auto, np.sum(
                np.asarray(parts, np.float64), 0), np.abs(
                np.asarray(parts, np.float64)).sum(0), RTOL["float32"])
        else:
            want = _sum_sim(pick, parts, islands)
            ck.bits(f"sum/auto/{count} ({pick})", auto, want)
        for algo in forced:
            got = keep(f"sum/{algo}/{count}",
                       mt.allreduce(x, comm=comm, algo=algo))
            ck.bits(f"sum/{algo}/{count}", got,
                    want if arena else _sum_sim(algo, parts, islands))

    # -- compression="int8": the transport's qring/qrd, and the Python
    # schedule under MPI4JAX_TPU_COLL_QUANT=deny -----------------------
    for count in QUANT_COUNTS:
        parts = list(all_inputs("float32", n, (count,), "quant"))
        x = to_tensor(parts[rank], "float32", dev)
        exact = np.sum(np.asarray(parts, np.float64), 0)
        scale = np.abs(exact).max()
        qalgo = tune.quantized_algorithm(count * 4)
        runs = {"int8": mt.allreduce(x, comm=comm, compression="int8"),
                "qring": mt.allreduce(x, comm=comm, algo="qring"),
                "qrd": mt.allreduce(x, comm=comm, algo="qrd")}
        for name, out in runs.items():
            got = keep(f"{name}/{count}", out)
            algo = qalgo if name == "int8" else name
            if arena:
                ck.close(f"{name}/{count}", got, exact, np.abs(
                    np.asarray(parts, np.float64)).sum(0), RTOL["float32"])
                continue
            simf = (sim.simulate_qring_sum if algo == "qring"
                    else sim.simulate_qrd_sum)
            ck.bits(f"{name}/{count} ({algo})", got, simf(parts))
            ck.true(f"{name}/{count} within 5e-2 of the exact sum",
                    np.abs(got - exact).max() <= 5e-2 * scale)
        os.environ["MPI4JAX_TPU_COLL_QUANT"] = "deny"
        try:
            got = keep(f"int8_python/{count}",
                       mt.allreduce(x, comm=comm, compression="int8"))
        finally:
            del os.environ["MPI4JAX_TPU_COLL_QUANT"]
        ck.bits(f"int8_python/{count}", got,
                quantized.quantized_allreduce_ref(np.asarray(parts))[rank])

    # -- the custom op: allgather (gather) and a local fold --------------
    absmax = mt.custom_op(ABSMAX_NAME,
                          lambda a, b: torch.maximum(a.abs(), b.abs()))
    stack = all_inputs("float32", n)
    x = to_tensor(stack[rank], "float32", dev)
    want = np.abs(stack).max(0)
    ck.bits("custom/allreduce", keep("custom/allreduce", mt.allreduce(
        x, op=absmax, comm=comm)), want)
    got = keep("custom/reduce", mt.reduce(x, op=absmax, root=0, comm=comm))
    ck.bits("custom/reduce", got, want if rank == 0 else stack[rank])
    pre = stack[0]
    for r in range(1, rank + 1):
        pre = np.maximum(np.abs(pre), np.abs(stack[r]))
    ck.bits("custom/scan", keep("custom/scan", mt.scan(x, op=absmax,
                                                       comm=comm)), pre)

    # -- status, tags and wildcards (status_ops.py, basic_ops.py) --------
    arr = torch.full((3, 2), float(rank), device=dev)
    if n >= 2 and rank < 2:
        other = 1 - rank
        st = mt.Status()
        got = mt.sendrecv(arr, source=other, dest=other, status=st,
                          comm=comm)
        ck.bits("status/sendrecv", to_numpy(got),
                np.full((3, 2), float(other), np.float32))
        ck.true("status/sendrecv fields", (st.Get_source(), st.Get_tag(),
                                           st.Get_count(),
                                           st.Get_count(np.float32))
                == (other, 0, 24, 6))
        st = mt.Status()
        mt.sendrecv(arr, source=other, dest=other, sendtag=10 + rank,
                    recvtag=mt.ANY_TAG, status=st, comm=comm)
        ck.true("status/split tags", st.Get_tag() == 10 + other)
        st = mt.Status()
        if rank == 0:
            mt.send(arr * 2, dest=1, tag=7, comm=comm)
            mt.send(torch.arange(2, dtype=torch.float32, device=dev), dest=1,
                    tag=3, comm=comm)
        else:
            got = mt.recv(torch.zeros_like(arr), source=0, status=st,
                          comm=comm)
            ck.bits("status/recv", to_numpy(got), np.zeros((3, 2),
                                                           np.float32))
            ck.true("status/recv fields", (st.Get_source(), st.Get_tag(),
                                           st.Get_count(torch.float32))
                    == (0, 7, 6))
            st = mt.Status()
            got = mt.recv(torch.zeros(6, device=dev), source=0, tag=3,
                          status=st, comm=comm)
            ck.bits("status/short message", to_numpy(got),
                    np.array([0, 1, 0, 0, 0, 0], np.float32))
            ck.true("status/short count", st.Get_count(np.float32) == 2)
    # ANY_SOURCE: rank 0 drains every other rank (on one tag: with any
    # tag the wildcard would also match a later op's early frame)
    if rank == 0:
        heard = []
        for _ in range(n - 1):
            st = mt.Status()
            got = mt.recv(torch.zeros(4, device=dev), source=mt.ANY_SOURCE,
                          tag=100, status=st, comm=comm)
            src = st.Get_source()
            ck.bits("any_source payload", to_numpy(got),
                    np.full(4, float(src), np.float32))
            ck.true("any_source tag", st.Get_tag() == 100)
            heard.append(src)
        ck.true("any_source senders", sorted(heard) == list(range(1, n)))
    else:
        mt.send(torch.full((4,), float(rank), device=dev), dest=0, tag=100,
                comm=comm)

    # -- neighbor_exchange: a periodic ring, a chain with walls, self-wrap
    strip = torch.full((4,), float(rank), device=dev)
    lo, hi = (rank - 1) % n, (rank + 1) % n
    f_lo, f_hi = mt.neighbor_exchange(strip, strip + 100, lo=lo, hi=hi,
                                      comm=comm)
    ck.bits("neighbor/ring lo", keep("neighbor/ring_lo", f_lo),
            np.full(4, lo + 100.0, np.float32))
    ck.bits("neighbor/ring hi", keep("neighbor/ring_hi", f_hi),
            np.full(4, float(hi), np.float32))
    lo_w = rank - 1 if rank > 0 else None
    hi_w = rank + 1 if rank < n - 1 else None
    a, b = mt.neighbor_exchange(strip, strip * 2, lo=lo_w, hi=hi_w,
                                comm=comm)
    want_a = 2.0 * (rank - 1) if rank > 0 else 2.0 * rank  # wall: passthrough
    want_b = float(rank + 1) if rank < n - 1 else float(rank)
    ck.bits("neighbor/chain", to_numpy(a + b),
            np.full(4, want_a + want_b, np.float32))
    a, b = mt.neighbor_exchange(strip, strip + 10, lo=rank, hi=rank,
                                comm=comm)
    ck.bits("neighbor/self-wrap", to_numpy(torch.stack([a, b])),
            np.stack([np.full(4, rank + 10.0, np.float32),
                      np.full(4, float(rank), np.float32)]))

    # -- gradients (autodiff.py, status_ops.py) and refusals -------------
    x = (torch.arange(3, dtype=torch.float32, device=dev) + 1.0)
    x.requires_grad_(True)
    mt.allreduce(x, comm=comm).sum().backward()
    ck.bits("grad/allreduce", keep("grad/allreduce", x.grad),
            np.ones(3, np.float32))
    x.grad = None
    (mt.sendrecv(x, shift=1, comm=comm) * (rank + 1.0)).sum().backward()
    ck.bits("grad/sendrecv", keep("grad/sendrecv", x.grad),
            np.full(3, float((rank + 1) % n + 1), np.float32))
    mine = torch.tensor([float(rank)], device=dev, requires_grad=True)
    moved = mt.sendrecv(mine, shift=1, comm=comm)
    mt.allreduce((moved * mine).sum(), comm=comm).backward()
    ck.bits("grad/matvec", keep("grad/matvec", mine.grad), np.array(
        [float((rank - 1) % n + (rank + 1) % n)], np.float32))
    if n >= 2 and rank < 2:
        other = 1 - rank
        v = torch.ones((3, 2), device=dev, requires_grad=True)
        mt.sendrecv(v, source=other, dest=other, sendtag=rank + 1,
                    recvtag=other + 1, comm=comm).sum().backward()
        ck.bits("grad/split tags", to_numpy(v.grad), np.ones((3, 2),
                                                             np.float32))
    x.grad = None
    y = mt.allreduce(x, op=mt.MAX, comm=comm)
    ck.true("grad/MAX raises", _raises(lambda: y.sum().backward()))
    y = mt.allgather(x, comm=comm)
    ck.true("grad/allgather raises", _raises(lambda: y.sum().backward()))

    # -- sub-communicators ----------------------------------------------
    half = comm.split(color=rank % 2, key=rank)
    members = [r for r in range(n) if r % 2 == rank % 2]
    got = mt.allreduce(torch.tensor([rank], device=dev), comm=half)
    ck.bits("split/allreduce", to_numpy(got), np.array([sum(members)]))
    twin = comm.dup()
    got = mt.allgather(torch.tensor([rank], device=dev), comm=twin)
    ck.bits("dup/allgather", to_numpy(got), np.arange(n)[:, None])

    # -- an op queued behind a kernel on the same stream -----------------
    k = 4096 if dev.type == "cuda" else 128  # about 1 TFLOP on the card
    m = torch.full((k, k), 1.0 / k, device=dev)
    acc = torch.full((k, k), float(rank + 1), device=dev)
    for _ in range(8):
        acc = acc @ m  # each product keeps the rows' constant value
    got = keep("stream/allreduce", mt.allreduce(acc[0, :5], comm=comm))
    ck.bits("stream/allreduce", got,
            np.full(5, float(n * (n + 1) // 2), np.float32))
    got = keep("stream/neighbor", torch.stack(mt.neighbor_exchange(
        acc[1, :3], acc[2, :3] * 2, lo=lo, hi=hi, comm=comm)))
    ck.bits("stream/neighbor", got, np.stack([
        np.full(3, 2.0 * (lo + 1), np.float32),
        np.full(3, float(hi + 1), np.float32)]))

    # -- refusals of the JAX fronts --------------------------------------
    rows = torch.zeros((n, 2), device=dev)
    ck.true("alltoall token=object() raises", _raises(
        lambda: mt.alltoall(rows, comm=comm, token=object()), TypeError))
    ck.true("alltoall algo=qring raises", _raises(
        lambda: mt.alltoall(rows, comm=comm, algo="qring"), ValueError))
    ck.true("wrong device raises", _raises(
        lambda: mt.allreduce(torch.zeros(2, device="meta"), comm=comm),
        ValueError))

    mt.barrier(comm=comm)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k.replace("/", "|"): v for k, v in res.items()})
    record = {"rank": rank, "size": n, "device": str(dev), "arena": arena,
              "multi": multi, "islands": islands, "checks": ck.n,
              "worst_rel": ck.worst, "ops": sorted(res),
              "seconds": time.perf_counter() - t_start}
    counts = bridge.allgather(h, np.array([ck.n]), n)
    record["checks_per_rank"] = counts[:, 0].tolist()
    if rank == 0:
        with open(os.path.join(out_dir, "record.json"), "w") as f:
            json.dump(record, f)
    for sub in (twin, half):
        bridge.comm_finalize(sub.handle)
    bridge.comm_finalize(h)
    return record


def load_results(out_dir: str, n: int) -> list:
    """Each rank's results, ``{op name: array}``."""
    out = []
    for r in range(n):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k.replace("|", "/"): z[k] for k in z.files})
    return out


def run_job(ranks: int, out_dir: str, *, device="cuda", fake_hosts=None,
            env=None, timeout=120.0) -> dict:
    """Launch ``ranks`` ranks of this program through the port's launcher
    in-process and return rank 0's record; a failed rank raises."""
    from mpi4jax_tpu_torch.runtime import launch

    spec = {"device": str(device), "out": out_dir,
            "env": {"MPI4JAX_TPU_ICI_LEG": "off", **(env or {})}}
    path = os.path.join(out_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    argv = ["-n", str(ranks), "--timeout", str(timeout)]
    if fake_hosts:
        argv += ["--fake-hosts", fake_hosts]
    rc = launch.main(argv + [os.path.abspath(__file__), "--job", path])
    if rc != 0:
        raise RuntimeError(f"world_ops job of {ranks} ranks failed: the "
                           f"launcher exited {rc}")
    with open(os.path.join(out_dir, "record.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="directory for the ranks' .npz files")
    args = ap.parse_args(argv)
    if args.job:
        with open(args.job) as f:
            spec = json.load(f)
        os.environ.update(spec["env"])
        run_rank(spec["device"], spec["out"])
        return 0
    out = args.out or tempfile.mkdtemp(prefix="world_ops_")
    record = run_rank(args.device, out)
    if record["rank"] == 0:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
