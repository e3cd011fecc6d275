"""The world tier's ops on eager torch tensors: one process per rank.

The counterpart of ``mpi4jax_tpu/ops/_world_impl.py``, whose ops are host
callbacks into the native transport.  Here each op is a staged function:

- **staging.**  A CUDA tensor is copied into pinned host memory; the copy
  waits for the work queued on the current stream (this rank's stream, not
  the device), so an op queued behind a kernel sees the kernel's result.
  The native call runs on the host buffers (``runtime/bridge.py``), and the
  result is copied back to ``comm.device`` from pinned memory without
  waiting (the stream orders it before later work).  A CPU tensor crosses
  as it is.  The input is never written.  The fronts have checked that
  every tensor is on ``comm.device``: nothing moves quietly between
  devices.  bf16 crosses as its int16 bits with wire code 10
  (``utils/dtypes.py``), so the transport reduces real bf16.
- **custom reduce ops** ride the allgather (the gather for ``reduce``) and
  a local fold, as ``:1664-1700`` there: the wire carries no user code.
- **gradients**, as the JAX package's rules (``:1518-1599`` there): the
  SUM allreduce passes the cotangent unchanged; a non-SUM allreduce's
  backward raises ("differentiable for SUM only"); ``sendrecv`` sends the
  cotangent back along the edge, source and destination swapped and the
  tags with them (a wildcard receive tag keeps the own send tag and
  accepts any); every other op is an ``autograd.Function`` whose backward
  raises ``NotImplementedError``, where ``jax.grad`` raises for want of a
  rule.  Nothing is detached silently.

Program order is the ordering contract: every rank calls the ops of a comm
in the same order, as in the JAX package's ordered effects.

**analysis.**  Each staged op first offers itself to the static
verifier's executor (``analysis/_sim.py``) when one is installed
(``SCHEDULE_SIGNATURES``, ``_set_analysis_executor``); the chain guard of
``explicit_token_ordering`` is live only under the verifier's hooks.

**tracing.**  Each staged op runs inside ``utils/tracing.CallTrace``, as
the JAX package's 13 host sites do (``:931-1160`` there): the debug lines
of ``MPI4JAX_TPU_DEBUG`` and, when the recorder is armed, one ops-layer
span per call, timing the whole call as the caller sees it (staging, the
native call, the copy back).

**plan execution.**  Inside its ``CallTrace``, after the analysis
executor's offer, each staged op consults the plan runner
(``runtime/planrt.py``) with the JAX executors' kinds and signatures
(``:879-1160`` there): ``send`` goes to ``run_send`` (a CUDA tensor's
fresh pinned copy as an owned payload, a CPU tensor's storage copied by the
runner), a ``recv`` without a status to ``run_recv``, a ``recv`` with one
and every other op to ``run_sync``.  With ``MPI4JAX_TPU_PLAN`` unset that
is one module-global check.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import torch

from ..runtime import bridge, planrt
from ..utils import dtypes as _dtypes
from ..utils import tracing
from ..utils.algos import ALGO_CODES
from ..utils.status import ANY_TAG
from .reduce_ops import OP_CODES, ReduceOp

# ---------------- static-analysis hooks (analysis/) ----------------
#
# Each staged op exports its *schedule signature* (how to read one
# communication event off its arguments) and, first thing, offers itself
# to an installed analysis executor: the virtual world of
# ``analysis/_sim.py``, which owns the ops whose comm is an
# ``AbstractComm`` and serves them in memory, before any staging,
# ``coll_algo`` probe or native call.  With none installed the offer is one
# predicate.  As ``mpi4jax_tpu/ops/_world_impl.py:55-121``.

#: staged op name -> event field -> the op's argument that carries it
#: (the JAX package's primitive param names; the values are comm-local
#: ranks, tags and the reduce op's name)
SCHEDULE_SIGNATURES = {
    "allreduce": {"kind": "allreduce", "reduce_op": "op"},
    "reduce": {"kind": "reduce", "reduce_op": "op", "root": "root"},
    "scan": {"kind": "scan", "reduce_op": "op"},
    "bcast": {"kind": "bcast", "root": "root"},
    "allgather": {"kind": "allgather"},
    "gather": {"kind": "gather", "root": "root"},
    "scatter": {"kind": "scatter", "root": "root"},
    "alltoall": {"kind": "alltoall"},
    "barrier": {"kind": "barrier"},
    "send": {"kind": "send", "dest": "dest", "tag": "tag"},
    "recv": {"kind": "recv", "source": "source", "tag": "tag"},
    "sendrecv": {"kind": "sendrecv", "source": "source", "dest": "dest",
                 "sendtag": "sendtag", "recvtag": "recvtag"},
    "shift2": {"kind": "shift2", "lo": "lo", "hi": "hi", "tag": "tag"},
}


def schedule_signature(name: str):
    """``(name, signature)`` for a staged world op's name, or None.  The
    port has no token-variant ops: a token never reaches the staged ops."""
    sig = SCHEDULE_SIGNATURES.get(name)
    return None if sig is None else (name, sig)


_analysis_executor = None


def _set_analysis_executor(executor):
    """Install (or with None remove) the virtual-world executor that
    serves the staged ops during program analysis."""
    global _analysis_executor
    _analysis_executor = executor


# During analysis the chain guard below is handed a per-rank pseudo-trace
# to key its state on, and a hook that turns its warnings into findings.
# Both are None outside analysis, where the guard tracks nothing.
_analysis_token_trace = None   # fn(tok=None, comm=None) -> pseudo-trace
_analysis_warn_hook = None     # fn(comm, n_heads, how) -> None


def _set_analysis_token_hooks(token_trace, warn_hook):
    global _analysis_token_trace, _analysis_warn_hook
    _analysis_token_trace = token_trace
    _analysis_warn_hook = warn_hook


# ---------------- ordering mode ----------------


class _ExplicitMode(threading.local):
    def __init__(self):
        self.depth = 0


_explicit = _ExplicitMode()


@contextlib.contextmanager
def explicit_token_ordering():
    """Context manager: ordering of world ops is the caller's explicit
    token chain (``compat.token_api``), as in the JAX package
    (``mpi4jax_tpu/ops/_world_impl.py:159-185``).

    There the mode lets one jitted program mix mesh collectives with
    world ops, and a trace-time guard watches for a world op binding a
    fresh token while another chain on the same comm is live
    (``MPI4JAX_TPU_STRICT_TOKENS``: unset warns, 1 raises, 0 is silent).
    That guard tracks tracers, and a concrete (eager) token runs in Python
    order, where nothing can reorder.  The port is eager throughout, so in
    a run the context changes no op and flags nothing.  Under the static
    verifier (``analysis``) the guard is live, as in the JAX package's
    virtual world: each rank's chains are tracked, and a fresh token bound
    amid a live chain, or a tokenless op amid one, is a
    ``token_violation`` finding.  The mode is per thread, as a JAX config
    context is.
    """
    _explicit.depth += 1
    _chain_guard.enter()
    try:
        yield
    finally:
        _explicit.depth -= 1
        _chain_guard.exit()


class _TokenChainGuard:
    """Detector for unthreaded and forked token chains, live only under
    the analysis hooks (``mpi4jax_tpu/ops/_world_impl.py:188-345``).

    Live chain heads (tokens returned by world ops, not yet consumed) are
    tracked per ``(comm, pseudo-trace)`` while ``explicit_token_ordering``
    is active; the pseudo-trace is the analyzed rank's.
    A bare ``create_token()`` registers a *fresh* token (one tied to a
    value, ``create_token(x)``, legitimately roots a new chain).  Binding a
    known-fresh token while the same comm has a live head, or a world op
    with no token while one is live, is the footgun.  Tokens never seen
    are not flagged.
    """

    def __init__(self):
        self._depth = 0
        # (id(comm), id(trace)) -> [trace, set of id(token)]; the trace
        # keeps the tokens alive, so their ids cannot alias
        self._heads = {}
        self._fresh = {}    # id(trace) -> [trace, set of id(tok)]
        self._lock = threading.Lock()

    def enter(self):
        with self._lock:
            self._depth += 1

    def exit(self):
        with self._lock:
            self._depth -= 1
            if self._depth <= 0:
                self._depth = 0
                self._heads.clear()
                self._fresh.clear()

    @property
    def active(self):
        return self._depth > 0

    @staticmethod
    def _trace_of(tok, comm=None):
        if _analysis_token_trace is None:
            return None
        return _analysis_token_trace(tok, comm)

    def note_fresh(self, tok):
        trace = self._trace_of(tok) if self.active else None
        if trace is None:
            return
        ent = self._fresh.setdefault(id(trace), [trace, set()])
        ent[1].add(id(tok))

    def _is_fresh(self, trace, tok):
        ent = self._fresh.get(id(trace))
        return ent is not None and id(tok) in ent[1]

    def note_op(self, comm, tok_in, tok_out):
        if not self.active:
            return
        trace = self._trace_of(tok_in, comm)
        if trace is None:
            return
        trace.refs.append(tok_out)
        key = (id(comm), id(trace))
        ent = self._heads.setdefault(key, [trace, set()])
        heads = ent[1]
        if id(tok_in) in heads:
            heads.discard(id(tok_in))       # chain continues
        elif heads and self._is_fresh(trace, tok_in):
            self._warn(comm, len(heads), "binding a fresh (unrooted) token")
        heads.add(id(tok_out))

    def note_unthreaded(self, comm):
        """A world op with no token inside explicit mode: undefined order
        against any live chain on the same comm."""
        if not self.active:
            return
        trace = self._trace_of(None, comm)
        if trace is None:
            return
        ent = self._heads.get((id(comm), id(trace)))
        if ent and ent[1]:
            self._warn(comm, len(ent[1]), "traced with no token")

    def _warn(self, comm, n_heads, how):
        import warnings

        from ..utils import config as _config

        if _analysis_warn_hook is not None:
            _analysis_warn_hook(comm, n_heads, how)
        msg = (
            f"explicit_token_ordering: a world op on comm {comm!r} is "
            f"{how} while {n_heads} other "
            "token chain(s) on the same comm are live in this trace — "
            "the ops' relative order is UNDEFINED and can deadlock at "
            "run time.  Thread the previous op's token (or root a new "
            "chain with create_token(x) tied to a value that depends on "
            "it).  Set MPI4JAX_TPU_STRICT_TOKENS=1 to make this an "
            "error, or =0 to silence it."
        )
        strict = _config.flag("MPI4JAX_TPU_STRICT_TOKENS", None)
        if strict:
            raise RuntimeError(msg)
        if strict is None:
            warnings.warn(msg, stacklevel=4)


_chain_guard = _TokenChainGuard()


def chain_token(comm, token):
    """The token a world front hands back, after the chain guard has seen
    the op.  Outside analysis (or outside explicit mode) the caller's
    token itself, as before; under the analysis hooks a new head (a
    token op returns a new token in the JAX package, and the guard tells
    chains apart by identity)."""
    if _analysis_token_trace is None or not _explicit.depth:
        return token
    if token is None:
        _chain_guard.note_unthreaded(comm)
        return None
    out = torch.zeros_like(token)
    _chain_guard.note_op(comm, token, out)
    return out


# ---------------- plan execution (runtime/planrt.py) ----------------


def _plan_sync(comm, kind, execute, **sig):
    """Run a staged op under the plan runner's cursor, or directly when no
    plan serves ``comm``."""
    rt = planrt.get(comm)
    if rt is None:
        return execute()
    return rt.run_sync(kind, execute, **sig)


# ---------------- staging ----------------


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values in contiguous host memory: for a CUDA tensor a pinned
    copy made after the work queued on its stream; a CPU tensor itself
    when contiguous (the transport does not write a send buffer)."""
    x = x.detach()
    if x.device.type != "cuda":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)  # waits for this rank's stream, not the device
    return host


def _host_empty(shape, dtype, comm) -> torch.Tensor:
    """A result buffer in host memory, pinned when the comm is on a card."""
    return torch.empty(tuple(shape), dtype=dtype,
                       pin_memory=comm.device.type == "cuda")


def _to_device(host: torch.Tensor, comm) -> torch.Tensor:
    """A host result on ``comm.device``; the copy from pinned memory does
    not wait (the caching host allocator keeps the block until the copy is
    done)."""
    if comm.device.type != "cuda":
        return host
    return host.to(comm.device, non_blocking=True)


_np = _dtypes.host_view


def _code(t: torch.Tensor) -> int:
    return _dtypes.wire_code(t.dtype)


def _algo_code(algo) -> int:
    return ALGO_CODES[algo] if algo is not None else 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_OP_NAMES = {code: name for name, code in OP_CODES.items()}


def _coll_algo_detail(comm, opname, nbytes):
    """The algorithm name for a debug line; the probe never takes down the
    op."""
    try:
        return comm.coll_algo(opname, nbytes)
    except Exception as e:
        from ..elastic import is_rank_failure

        if is_rank_failure(e):
            raise
        return "?"


def _algo_detail(comm, opname, nbytes, algo):
    if algo is not None:
        return f"algo {algo} (forced)"
    return f"algo {_coll_algo_detail(comm, opname, nbytes)}"


# ---------------- the staged ops (no autograd) ----------------


def _allreduce(x, comm, op_code: int, algo=None):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("allreduce", x, comm, op=_OP_NAMES[op_code])
    nb = _nbytes(x)
    with tracing.CallTrace(
            comm.rank(), "Allreduce",
            lambda: f"op {_OP_NAMES[op_code]} "
                    + _algo_detail(comm, "allreduce", nb, algo),
            nbytes=nb):
        def run():
            send = _to_host(x)
            out = _host_empty(send.shape, send.dtype, comm)
            bridge.allreduce_raw(comm.handle, _np(send), _np(out),
                                 _code(send), op_code, algo=_algo_code(algo))
            return _to_device(out, comm)

        # the signature stays ("allreduce", op, bytes) under a forced
        # schedule: only the wire differs
        return _plan_sync(comm, "allreduce", run,
                          reduce_op=_OP_NAMES[op_code], nbytes=nb)


def _allgather(x, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("allgather", x, comm)
    nb = _nbytes(x)
    with tracing.CallTrace(
            comm.rank(), "Allgather",
            lambda: _algo_detail(comm, "allgather", nb, None), nbytes=nb):
        def run():
            send = _to_host(x)
            out = _host_empty((comm.size(),) + tuple(send.shape),
                              send.dtype, comm)
            bridge.allgather_raw(comm.handle, _np(send), _np(out))
            return _to_device(out, comm)

        return _plan_sync(comm, "allgather", run, nbytes=nb)


def _gather(x, root, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("gather", x, comm, root=root)
    with tracing.CallTrace(comm.rank(), "Gather", f"root {root}", peer=root,
                           nbytes=_nbytes(x)):
        def run():
            send = _to_host(x)
            if comm.rank() != root:
                bridge.gather(comm.handle, _np(send), comm.size(), root,
                              comm.rank())
                return x.detach().clone()  # the non-root result: its input
            out = _host_empty((comm.size(),) + tuple(send.shape),
                              send.dtype, comm)
            bridge.gather(comm.handle, _np(send), comm.size(), root,
                          comm.rank(), out=_np(out))
            return _to_device(out, comm)

        return _plan_sync(comm, "gather", run, root=root, nbytes=_nbytes(x))


def _reduce(x, op_code, root, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("reduce", x, comm, op=_OP_NAMES[op_code],
                         root=root)
    with tracing.CallTrace(comm.rank(), "Reduce",
                           f"op {_OP_NAMES[op_code]} root {root}", peer=root,
                           nbytes=_nbytes(x)):
        def run():
            send = _to_host(x)
            out = _host_empty(send.shape, send.dtype, comm)
            bridge.reduce(comm.handle, _np(send), op_code, root,
                          out=_np(out), dtype_code=_code(send))
            if comm.rank() != root:
                return x.detach().clone()  # the transport hands it back
            return _to_device(out, comm)

        return _plan_sync(comm, "reduce", run, reduce_op=_OP_NAMES[op_code],
                          root=root, nbytes=_nbytes(x))


def _scan(x, op_code, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("scan", x, comm, op=_OP_NAMES[op_code])
    with tracing.CallTrace(comm.rank(), "Scan", f"op {_OP_NAMES[op_code]}",
                           nbytes=_nbytes(x)):
        def run():
            send = _to_host(x)
            out = _host_empty(send.shape, send.dtype, comm)
            bridge.scan(comm.handle, _np(send), op_code, out=_np(out),
                        dtype_code=_code(send))
            return _to_device(out, comm)

        return _plan_sync(comm, "scan", run, reduce_op=_OP_NAMES[op_code],
                          nbytes=_nbytes(x))


def _bcast(x, root, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("bcast", x, comm, root=root)
    with tracing.CallTrace(comm.rank(), "Bcast", f"root {root}", peer=root,
                           nbytes=_nbytes(x)):
        def run():
            send = _to_host(x)
            out = _host_empty(send.shape, send.dtype, comm)
            bridge.bcast(comm.handle, _np(send), root, out=_np(out))
            return _to_device(out, comm)

        return _plan_sync(comm, "bcast", run, root=root, nbytes=_nbytes(x))


def _scatter(x, root, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("scatter", x, comm, root=root)
    with tracing.CallTrace(comm.rank(), "Scatter", f"root {root}", peer=root,
                           nbytes=_nbytes(x)):
        def run():
            send = _to_host(x)
            out = _host_empty(send.shape[1:], send.dtype, comm)
            bridge.scatter(comm.handle, _np(send), root, out=_np(out))
            return _to_device(out, comm)

        return _plan_sync(comm, "scatter", run, root=root, nbytes=_nbytes(x))


def _alltoall(x, comm, algo=None):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("alltoall", x, comm)
    with tracing.CallTrace(comm.rank(), "Alltoall",
                           f"algo {algo} (forced)" if algo is not None
                           else "", nbytes=_nbytes(x)):
        def run():
            send = _to_host(x)
            out = _host_empty(send.shape, send.dtype, comm)
            bridge.alltoall(comm.handle, _np(send), out=_np(out),
                            algo=_algo_code(algo), dtype_code=_code(send))
            return _to_device(out, comm)

        # quantized or hierarchical, it is an alltoall to the plan
        return _plan_sync(comm, "alltoall", run, nbytes=_nbytes(x))


def _shift2(stack, lo, hi, tag, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("shift2", stack, comm, lo=lo, hi=hi, tag=tag)
    with tracing.CallTrace(comm.rank(), "Shift2", f"lo {lo} hi {hi}",
                           peer=hi, nbytes=_nbytes(stack), tag=tag):
        def run():
            send = _to_host(stack)
            out = _host_empty(send.shape, send.dtype, comm)
            bridge.shift2(comm.handle, _np(send), lo, hi, tag, out=_np(out))
            return _to_device(out, comm)

        return _plan_sync(comm, "shift2", run, lo=lo, hi=hi, tag=tag,
                          nbytes=_nbytes(stack))


def _recv(x, source, tag, comm, status):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("recv", x, comm, source=source, tag=tag,
                         status=status)
    with tracing.CallTrace(comm.rank(), "Recv", f"from {source} tag {tag}",
                           peer=source, nbytes=_nbytes(x), tag=tag):
        rt = planrt.get(comm)
        if status is None:
            if rt is not None:
                got = rt.run_recv(x.shape, x.dtype, source, tag)
                if got is not None:
                    return _to_device(got, comm)
            # strict: the arrived size must equal the buffer exactly
            out = _host_empty(x.shape, x.dtype, comm)
            bridge.recv(comm.handle, _np(out), source, tag)
            return _to_device(out, comm)

        def run():
            out = _host_empty(x.shape, x.dtype, comm)
            _, src, tg, cnt = bridge.recv_status(comm.handle, _np(out),
                                                 source, tag)
            status._fill(src, tg, cnt)
            return _to_device(out, comm)

        if rt is None:
            return run()
        return rt.run_sync("recv", run, source=source, tag=tag)


def _sendrecv(x, source, dest, sendtag, recvtag, status, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("sendrecv", x, comm, source=source, dest=dest,
                         sendtag=sendtag, recvtag=recvtag, status=status)
    with tracing.CallTrace(comm.rank(), "Sendrecv",
                           f"to {dest} from {source}", peer=dest,
                           nbytes=2 * _nbytes(x), tag=sendtag):
        return _plan_sync(
            comm, "sendrecv",
            lambda: _sendrecv_staged(x, source, dest, sendtag, recvtag,
                                     status, comm),
            dest=dest, source=source, sendtag=sendtag, recvtag=recvtag)


def _sendrecv_staged(x, source, dest, sendtag, recvtag, status, comm):
    send = _to_host(x)
    out = _host_empty(send.shape, send.dtype, comm)
    if status is None and sendtag == recvtag:
        bridge.sendrecv(comm.handle, _np(send), _np(out), source, dest,
                        sendtag)
        return _to_device(out, comm)
    _, src, tg, cnt = bridge.sendrecv_status(
        comm.handle, _np(send), _np(out), source, dest, sendtag, recvtag)
    if status is None:
        # no status to report a short message through: the strict
        # exact-size contract of the plain path (``:1139-1152`` there)
        if cnt != out.numel() * out.element_size():
            print(f"tpucomm_Sendrecv: size mismatch from rank {source}: "
                  f"expected {out.numel() * out.element_size()} bytes, got "
                  f"{cnt}", file=sys.stderr, flush=True)
            os._exit(1)
    else:
        status._fill(src, tg, cnt)
    return _to_device(out, comm)


# ---------------- autograd ----------------


class _AllreduceSum(torch.autograd.Function):
    """The SUM allreduce: its transposed pass is the identity on the
    cotangent (``:1543-1550`` there)."""

    @staticmethod
    def forward(ctx, x, comm, algo):
        return _allreduce(x, comm, OP_CODES["SUM"], algo)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _NoGradient(torch.autograd.Function):
    """A world op whose backward raises, as ``jax.grad`` does where the JAX
    package registers no rule (``what`` names the op in the message)."""

    @staticmethod
    def forward(ctx, what, fn, *tensors):
        ctx.what = what
        return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(f"{ctx.what} has no gradient on the world "
                                  "tier, as in the JAX package")


def _no_grad_op(what, fn, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _NoGradient.apply(what, fn, *tensors)
    return fn(*tensors)


class _Sendrecv(torch.autograd.Function):
    """The cotangent goes back along the message edge: source and dest
    swapped, and the tags with them (``:1576-1595`` there)."""

    @staticmethod
    def forward(ctx, x, comm, source, dest, sendtag, recvtag, status):
        ctx.edge = (comm, source, dest, sendtag, recvtag)
        return _sendrecv(x, source, dest, sendtag, recvtag, status, comm)

    @staticmethod
    def backward(ctx, g):
        comm, source, dest, sendtag, recvtag = ctx.edge
        if recvtag == ANY_TAG:
            t_send, t_recv = sendtag, ANY_TAG
        else:
            t_send, t_recv = recvtag, sendtag
        ct = _sendrecv(g.contiguous(), dest, source, t_send, t_recv, None,
                       comm)
        return ct, None, None, None, None, None, None


# ---------------- entry points (called from the op fronts) ----------------


def allreduce(x, op: ReduceOp, comm, algo=None):
    """``algo`` forces a schedule for this call (the ``compression="int8"``
    route passes "qring" or "qrd"); None is the engine's pick from the
    installed decision table."""
    if op.custom:
        # the wire carries no user code: allgather and a local fold
        return op.reduce(allgather(x, comm)).to(x.dtype)
    if op.name == "SUM":
        return _AllreduceSum.apply(x, comm, algo)
    return _no_grad_op(
        f"allreduce with op={op.name} (differentiable for SUM only)",
        lambda t: _allreduce(t, comm, OP_CODES[op.name], algo), x)


def reduce(x, op: ReduceOp, root, comm):
    if op.custom:
        rows = gather(x, root, comm)
        if comm.rank() == root:
            return op.reduce(rows).to(x.dtype)
        return rows
    return _no_grad_op("reduce",
                       lambda t: _reduce(t, OP_CODES[op.name], root, comm), x)


def scan(x, op: ReduceOp, comm):
    if op.custom:
        rows = allgather(x, comm)
        return op.reduce(rows[: comm.rank() + 1]).to(x.dtype)
    return _no_grad_op("scan", lambda t: _scan(t, OP_CODES[op.name], comm), x)


def bcast(x, root, comm):
    return _no_grad_op("bcast", lambda t: _bcast(t, root, comm), x)


def allgather(x, comm):
    return _no_grad_op("allgather", lambda t: _allgather(t, comm), x)


def gather(x, root, comm):
    return _no_grad_op("gather", lambda t: _gather(t, root, comm), x)


def scatter(x, root, comm):
    return _no_grad_op("scatter", lambda t: _scatter(t, root, comm), x)


def alltoall(x, comm, algo=None):
    return _no_grad_op("alltoall", lambda t: _alltoall(t, comm, algo), x)


def neighbor_exchange(to_lo, to_hi, *, lo, hi, comm, tag=60):
    """``(from_lo, from_hi)``: both strips in one ``shift2``; a ``None``
    neighbour is a wall, where the opposite input passes through, and a
    self-wrap is a local rotation (in the transport)."""
    lo_i = -1 if lo is None else int(lo)
    hi_i = -1 if hi is None else int(hi)

    def run(a, b):
        return _shift2(torch.stack([a, b]), lo_i, hi_i, int(tag), comm)

    out = _no_grad_op("neighbor_exchange", run, to_lo, to_hi)
    return out[0], out[1]


def barrier(comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("barrier", None, comm)
    with tracing.CallTrace(comm.rank(), "Barrier", ""):
        _plan_sync(comm, "barrier", lambda: bridge.barrier(comm.handle))


def send(x, dest, tag, comm):
    ex = _analysis_executor
    if ex is not None and ex.owns(comm):
        return ex.run_op("send", x, comm, dest=dest, tag=tag)
    with tracing.CallTrace(comm.rank(), "Send", f"to {dest} tag {tag}",
                           peer=dest, nbytes=_nbytes(x), tag=tag):
        host = _to_host(x)
        rt = planrt.get(comm)
        # a CUDA tensor's staged copy is fresh and the runner's to keep; a
        # CPU tensor's is the caller's storage, which the runner copies
        if rt is None or not rt.run_send(_np(host), dest, tag,
                                         owned=x.device.type == "cuda",
                                         keep=host):
            bridge.send(comm.handle, _np(host), dest, tag)


def recv(x, source, tag, comm, status=None):
    return _no_grad_op("recv", lambda t: _recv(t, source, tag, comm, status),
                       x)


def sendrecv(x, *, comm, source, dest, sendtag, recvtag, status=None):
    return _Sendrecv.apply(x, comm, source, dest, sendtag, recvtag, status)


def resolve_edge(comm, perm, shift, wrap):
    """Per-rank ``(source, dest)`` from the mesh-style ``perm=`` or
    ``shift=``, with the JAX world tier's edge errors (``:1840-1860``
    there)."""
    rank, size = comm.rank(), comm.size()
    if shift is not None:
        dest = (rank + shift) % size if wrap else rank + shift
        source = (rank - shift) % size if wrap else rank - shift
        if not (0 <= dest < size) or not (0 <= source < size):
            raise ValueError(
                "shift moves past the edge with wrap=False; world-tier "
                "sendrecv needs a valid partner on every rank — use "
                "send/recv for edge ranks")
        return source, dest
    if perm is not None:
        src_map = {d: s for s, d in perm}
        dst_map = {s: d for s, d in perm}
        if rank not in src_map or rank not in dst_map:
            raise ValueError(
                f"perm must cover rank {rank} as both source and dest on "
                "the world tier; use send/recv for one-sided edges")
        return src_map[rank], dst_map[rank]
    raise ValueError("pass source/dest, perm=, or shift=")

