"""Plan execution: a verified schedule plan run against the live op stream.

The counterpart of ``mpi4jax_tpu/runtime/planrt.py``.  The schedule
compiler (``analysis/_plan.py``) turns a program's per-rank schedule into
an :class:`~mpi4jax_tpu_torch.analysis._plan.ExecutionPlan` whose
equivalence the match simulator has proved.  A :class:`PlanRunner`
installed on the world comm follows the staged ops (``ops/_world_impl.py``
consults it inside each op's ``CallTrace``) and, where the plan allows,

- **pre-posts hoisted receives**: at the plan's post point the receive
  goes on the progress engine as a ticket (``bridge.post_recv_into``), so
  the wire drains into a host buffer while the host computes; the receive
  itself then only waits the ticket;
- **defers send completions**: a send past the buffered-send threshold
  posts as a ticket (``bridge.post_send``) and is waited at the next
  synchronous op (FIFO: by then it costs nothing); smaller sends keep the
  native detached path and its coalescing;
- leaves every other op on its path, in program order: the engine drains
  FIFO, so the wire order is the one the prover checked.

Every op is matched against the plan's op signatures.  A mismatch, a
program whose schedule left the verified one, disables the plan for that
comm loudly, drains the outstanding tickets and runs the ops directly.
With ``MPI4JAX_TPU_PLAN`` unset the module is inert: ``get`` is one
module-global check and one cached environment read.

Buffers, where the port differs from the JAX runner (whose callback
operands die with the callback):

- a **deferred send's payload** must stay unchanged until its ticket is
  waited.  A CUDA tensor reaches the runner as a fresh pinned copy
  (``_to_host``), which the runner may take as it is (``owned=True``); its
  keepalive holds that host tensor, so the caching host allocator cannot
  hand its block out before the wait.  A CPU tensor reaches it as the
  caller's own storage, which the caller may write after ``send`` returns,
  so it is copied into a pooled buffer first, as in the JAX runner.
- a **pre-posted receive** lands in a fresh host tensor (pinned when the
  comm is on a card), which becomes the op's result: the ops layer copies
  it to the card without waiting, and the caching host allocator records
  that copy's stream before the block can be reused.  The runner keeps no
  receive pool, so no buffer is written by the engine while a copy out of
  it may still be queued.  (The JAX runner recycles served buffers at its
  next entry, once XLA has copied the result out.)
- a **signature** names the tensor's dtype (``"bfloat16"``, as the
  analyzer records it), while a bf16 payload crosses as its int16 view
  (``utils/dtypes.host_view``).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import dtypes as _dtypes

#: handle -> PlanRunner; empty = every hook is one boolean check
_runners: Dict[int, "PlanRunner"] = {}
_active = False


def _plan_mod():
    from ..analysis import _plan

    return _plan


_spec_cache = False  # False = unresolved (None is a valid resolution)


def plan_spec() -> Optional[str]:
    """``config.plan_spec()``, resolved once per process: the launcher
    exports ``MPI4JAX_TPU_PLAN`` before any rank starts, and this sits on
    every op's path."""
    global _spec_cache
    if _spec_cache is False:
        from ..utils import config

        _spec_cache = config.plan_spec()
    return _spec_cache


def _bare_enable(spec: str) -> bool:
    return spec.lower() in ("1", "true", "on", "yes", "auto")


def active() -> bool:
    return _active


def get(comm) -> Optional["PlanRunner"]:
    """The runner serving ``comm``, or None.

    With no runner installed and ``MPI4JAX_TPU_PLAN`` unset this is one
    module-global check and one cached read; it never touches
    ``comm.handle``, so the analyzer's ``AbstractComm`` is safe.  With the
    knob set and no runner yet, reading ``comm.handle`` connects the comm
    on purpose: its creation installs the runner, so the job's first op
    does not slip past the plan."""
    if _active:
        try:
            return _runners.get(comm.handle)
        except Exception as e:
            _absorb(e)
            return None
    if plan_spec() is None:
        return None
    try:
        handle = comm.handle  # creating the comm installs the runner
    except Exception as e:
        _absorb(e)
        return None
    return _runners.get(handle)


def _absorb(e: Exception) -> None:
    """``get`` absorbs the analyzer's comm, which has no handle; a rank
    failure while the comm connects reaches the caller."""
    from ..elastic import is_rank_failure

    if is_rank_failure(e):
        raise e


def install(handle: int, plan, rank: int, *, pin_memory: bool = False
            ) -> bool:
    """Attach a verified plan's schedule for ``rank`` to a comm.

    Refuses (False, with a warning) what the runner cannot run faithfully:
    a plan with no schedule for the rank, an unproved plan, a schedule with
    sub-communicator ops, or a library without the ticketed post entry.
    ``pin_memory``: the comm's tensors live on a card, so pre-posted
    receives land in pinned host memory."""
    global _active
    from . import bridge

    rp = plan.ranks.get(rank)
    if rp is None:
        _warn(f"plan {plan.cache_key} has no schedule for rank {rank}")
        return False
    if not plan.proved:
        _warn(f"plan {plan.cache_key} was not proved equivalent; "
              "refusing to execute it")
        return False
    if any(tuple(op.comm) != (0,) for op in rp.ops):
        # the compiler leaves sub-comm schedules unrewritten; a plan file
        # that carries sub-comm ops anyway would desync the world cursor
        _warn(f"plan {plan.cache_key} contains sub-communicator ops; "
              "the runner serves the world communicator only")
        return False
    if not bridge.post_available():
        _warn("native library predates ticketed posting (tpucomm_post); "
              "rebuild the transport to execute schedule plans")
        return False
    _runners[int(handle)] = PlanRunner(int(handle), plan, rp,
                                       pin_memory=pin_memory)
    _active = True
    return True


def maybe_install_from_env(handle: int, rank: int, size: int, *,
                           pin_memory: bool = False) -> None:
    """``bridge.comm_init``'s hook: when ``MPI4JAX_TPU_PLAN`` names a plan
    file (``launch --plan``) or a plan bundle, load the plan for this world
    size and attach this rank's schedule.  Never fatal: a bad file warns,
    and the job runs its ops directly."""
    spec = plan_spec()
    if spec is None or _bare_enable(spec):
        return  # a bare enable: plans attach through the API
    try:
        plan = _plan_mod().load_plan_for_size(spec, size)
    except Exception as err:
        _warn(f"cannot load MPI4JAX_TPU_PLAN={spec}: {err}")
        return
    if plan is None:
        _warn(f"MPI4JAX_TPU_PLAN={spec} holds no plan for np={size}; "
              "ignoring it")
        return
    install(handle, plan, rank, pin_memory=pin_memory)


#: ``world_size -> ExecutionPlan | (events_by_rank, comms) | None``, set by
#: a program that installs plans through the API (:func:`set_plan_source`)
_plan_source = None


def set_plan_source(fn) -> None:
    """Register how to derive this job's plan for a new world size
    (elastic recovery): ``fn(world_size)`` returns an ``ExecutionPlan`` (it
    is re-proved before it is installed), an ``(events_by_rank, comms)``
    pair to compile, or None.  ``None`` unregisters."""
    global _plan_source
    _plan_source = fn


def drop(handle: int) -> None:
    """Forget a comm's runner without waiting its tickets: the rebuild
    path, where the old world's sockets are dead."""
    global _active
    _runners.pop(int(handle), None)
    if not _runners:
        _active = False


def reinstall_after_rebuild(old_handle, handle: int, rank: int, size: int,
                            *, pin_memory: bool = False) -> bool:
    """Elastic recovery's plan step: drop the dead world's runner, derive
    the plan for the new world size (from :func:`set_plan_source`, or the
    ``MPI4JAX_TPU_PLAN`` file or bundle), prove it again and install it.
    Nothing runs without a fresh proof: a stored plan is recompiled from
    its own schedule and must keep its ``cache_key``.  Every outcome is
    loud.  True when a re-proved plan serves the new world."""
    if old_handle:
        drop(old_handle)
    spec = plan_spec()
    source = _plan_source
    if source is None and (spec is None or _bare_enable(spec)):
        return False  # no plan was driving this job
    plan_mod = _plan_mod()
    try:
        if source is not None:
            stored = source(size)
        else:
            stored = plan_mod.load_plan_for_size(spec, size)
    except Exception as err:
        _warn(f"cannot re-derive a plan for the recovered np={size} "
              f"world: {err}; continuing on the historic path")
        return False
    if stored is None:
        _warn(f"no plan available for the recovered np={size} world "
              "(the bundle/source does not cover this size); "
              "continuing on the historic path")
        return False
    try:
        if isinstance(stored, tuple):
            events_by_rank, comms = stored
            fresh = plan_mod.compile_schedules(events_by_rank, comms,
                                               world_size=size)
        else:
            fresh = plan_mod.recompile_plan(stored)
            if fresh.cache_key != stored.cache_key:
                _warn(f"re-derived plan signature {fresh.cache_key} does "
                      f"not match the stored plan {stored.cache_key} for "
                      f"np={size}; refusing it — the file does not "
                      "contain the schedule it claims to")
                return False
    except Exception as err:
        _warn(f"plan re-derivation failed for np={size}: {err}; "
              "continuing on the historic path")
        return False
    if fresh.world_size != size:
        _warn(f"re-derived plan is for np={fresh.world_size}, the "
              f"recovered world is np={size}; refusing it")
        return False
    if not fresh.proved:
        _warn(f"re-derived plan for np={size} failed its re-proof:"
              + "".join(f"\n    {r}" for r in fresh.reasons)
              + "\n  continuing on the historic path")
        return False
    if not install(handle, fresh, rank, pin_memory=pin_memory):
        return False
    _warn(f"re-proved plan {fresh.cache_key} for the recovered "
          f"np={size} world ({fresh.proof.get('interleavings', 0)} "
          "interleavings re-verified); overlap preserved across "
          "recovery")
    return True


def detach(handle: int) -> None:
    """Wait out and remove a comm's runner."""
    global _active
    rt = _runners.pop(int(handle), None)
    if rt is not None:
        rt.flush()
    if not _runners:
        _active = False


def _warn(msg: str) -> None:
    print(f"[plan] {msg}", file=sys.stderr, flush=True)


#: cap on outstanding send tickets per runner (bounds the payloads kept
#: alive; FIFO makes waiting the oldest nearly free by then)
MAX_OUTSTANDING = 16


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        n *= int(d)
    return n


class PlanRunner:
    """Runs one rank's verified plan against the op stream."""

    def __init__(self, handle: int, plan, rank_plan, *,
                 pin_memory: bool = False):
        self.handle = handle
        self.plan = plan
        self.ops = rank_plan.ops
        self.pin_memory = bool(pin_memory)
        self.cursor = 0
        self.enabled = True
        # post point -> positions of the hoisted receives posted after it
        self.hoists_after: Dict[int, List[int]] = {}
        for pos, op in enumerate(self.ops):
            if op.kind == "recv" and op.post_at < pos:
                self.hoists_after.setdefault(op.post_at, []).append(pos)
        self.preposted: Dict[int, tuple] = {}   # pos -> (ticket, out, ka)
        self.outstanding: List[tuple] = []      # (ticket, ka, pool_buf)
        # payload copies of deferred CPU sends, pooled by (dtype, shape):
        # a fresh multi-MB buffer per send would cost page faults
        self._send_pool: Dict[tuple, List[np.ndarray]] = {}
        self.stats = {"hoisted_recvs": 0, "deferred_sends": 0,
                      "mismatches": 0}

    # -- bookkeeping ---------------------------------------------------

    def _host_empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=dtype,
                           pin_memory=self.pin_memory)

    def _pool_return(self, pool_buf) -> None:
        if pool_buf is not None:
            free = self._send_pool.setdefault(
                (pool_buf.dtype, pool_buf.shape), [])
            if len(free) < MAX_OUTSTANDING:
                free.append(pool_buf)

    def _drain(self) -> None:
        from . import bridge

        while self.outstanding:
            ticket, _ka, pool_buf = self.outstanding.pop(0)
            bridge.wait_ticket(self.handle, ticket)
            self._pool_return(pool_buf)

    def flush(self) -> None:
        """Wait everything outstanding (detach and disable paths)."""
        from . import bridge

        self._drain()
        for pos in sorted(self.preposted):
            ticket, _out, _ka = self.preposted.pop(pos)
            bridge.wait_ticket(self.handle, ticket)

    def _disable(self, why: str) -> None:
        self.enabled = False
        self.stats["mismatches"] += 1
        _warn(
            f"runtime op stream diverged from plan "
            f"{self.plan.cache_key} at position {self.cursor} ({why}); "
            "plan execution disabled for this communicator — the job "
            "continues on the historic path"
        )
        # posted sends are real work: wait them out.  A pre-posted receive
        # cannot be cancelled; the next matching direct receive consumes
        # it (run_recv's disabled path)
        if self.preposted:
            chans = sorted(
                {(self.ops[p].source, self.ops[p].tag)
                 for p in self.preposted})
            _warn(
                f"{len(self.preposted)} pre-posted receive ticket(s) "
                f"remain outstanding on (source, tag) {chans}; they own "
                "the next wire message on their channels and will be "
                "consumed by the next matching receive.  If this job "
                "misbehaves, rerun with MPI4JAX_TPU_PLAN=0."
            )
        self._drain()

    def _advance(self) -> None:
        from . import bridge

        pos = self.cursor
        for hoist_pos in self.hoists_after.get(pos, ()):
            if hoist_pos in self.preposted or not self.enabled:
                continue
            op = self.ops[hoist_pos]
            out = self._host_empty(op.shape or (),
                                   _dtypes.from_name(op.dtype))
            ticket, ka = bridge.post_recv_into(
                self.handle, _dtypes.host_view(out), op.source, op.tag)
            self.preposted[hoist_pos] = (ticket, out, ka)
            self.stats["hoisted_recvs"] += 1
        self.cursor = pos + 1
        if self.cursor >= len(self.ops):
            # a whole cycle of the plan (a loop's body): wait every
            # deferred completion, then start over
            self._drain()
            self.cursor = 0

    def _expect(self, kind: str, **sig):
        """The plan op at the cursor if the runtime op matches it, else
        None (after disabling)."""
        if self.cursor >= len(self.ops):
            self.cursor = 0
        op = self.ops[self.cursor]
        if op.kind != kind:
            self._disable(f"expected {op.kind}, saw {kind}")
            return None
        for name, value in sig.items():
            want = getattr(op, name)
            if want is not None and value is not None and want != value:
                self._disable(
                    f"{kind}.{name}: plan has {want!r}, runtime has "
                    f"{value!r}")
                return None
        return op

    # -- op entry points (called by the staged ops) ----------------------

    def run_send(self, buf: np.ndarray, dest: int, tag: int,
                 owned: bool = False, keep=None) -> bool:
        """True when the runner sent (or posted) ``buf``; False: the caller
        sends it itself.

        ``owned=True`` is the MPI_Isend contract: ``buf``'s storage stays
        valid and unchanged until the runner's next drain point (the next
        receive or synchronous op, the plan's wrap, or a flush), and the
        post skips the copy.  ``keep`` (the host tensor ``buf`` views) is
        held with the ticket."""
        from . import bridge

        if not self.enabled:
            return False
        op = self._expect("send", dest=dest, tag=tag, nbytes=buf.nbytes)
        if op is None:
            return False
        if not op.deferred or buf.nbytes <= self.plan.detach_threshold:
            # the native detached path buffers small sends (and keeps
            # them coalescible); no ticket needed
            bridge.send(self.handle, buf, dest, tag)
            self._advance()
            return True
        if len(self.outstanding) >= MAX_OUTSTANDING:
            ticket, _ka, pool_buf = self.outstanding.pop(0)
            bridge.wait_ticket(self.handle, ticket)
            self._pool_return(pool_buf)
        if owned:
            wire_buf, pool_buf = buf, None
        else:
            free = self._send_pool.get((buf.dtype, buf.shape))
            wire_buf = free.pop() if free else np.empty_like(buf)
            np.copyto(wire_buf, buf)
            pool_buf = wire_buf
        ticket, ka = bridge.post_send(self.handle, wire_buf, dest, tag)
        self.outstanding.append((ticket, (ka, keep), pool_buf))
        self.stats["deferred_sends"] += 1
        self._advance()
        return True

    def run_recv(self, shape, dtype: torch.dtype, source: int, tag: int):
        """The received host tensor when the runner served the receive
        (perhaps from a pre-posted ticket), else None.  ``dtype`` is the
        tensor's: the signature names it as the analyzer does."""
        from . import bridge

        shape = tuple(int(d) for d in shape)
        nbytes = _nbytes(shape, dtype)
        if not self.enabled:
            # a pre-posted descriptor left from before the mismatch owns
            # the next message on its channel: consume it here, so the
            # direct path does not race it
            for pos, (ticket, out, _ka) in sorted(self.preposted.items()):
                pop = self.ops[pos]
                if (pop.source == source and pop.tag == tag
                        and out.numel() * out.element_size() == nbytes):
                    del self.preposted[pos]
                    bridge.wait_ticket(self.handle, ticket)
                    if tuple(out.shape) == shape and out.dtype == dtype:
                        return out
                    return (out.reshape(-1).view(torch.uint8).view(dtype)
                            .reshape(shape).clone())
            return None
        # dtype and shape are part of the signature: a stale plan's
        # buffer must not be bit-reinterpreted (f32[64] against i32[64])
        op = self._expect("recv", source=source, tag=tag, nbytes=nbytes,
                          dtype=_dtypes.dtype_name(dtype), shape=shape)
        if op is None:
            return None
        pos = self.cursor
        if pos in self.preposted:
            ticket, out, _ka = self.preposted.pop(pos)
            bridge.wait_ticket(self.handle, ticket)
        else:
            out = self._host_empty(shape, dtype)
            bridge.recv(self.handle, _dtypes.host_view(out), source, tag)
        # a completed receive proves every earlier ticket on this FIFO
        # engine done: collect them now (each wait returns at once)
        self._drain()
        self._advance()
        return out

    def run_sync(self, kind: str, execute, **sig):
        """Every other op: check it against the plan, run it, then collect
        the completed tickets (FIFO: the op queued behind them).
        ``execute`` is a closure that runs the op."""
        if not self.enabled:
            return execute()
        op = self._expect(kind, **sig)
        if op is None:
            return execute()
        result = execute()
        self._drain()
        self._advance()
        return result
