"""Virtual-world executor: run a per-rank program under analysis.

The counterpart of ``mpi4jax_tpu/analysis/_sim.py``.  Executes the *whole
program* once per rank, each rank a thread inside one process, with every
world-tier op intercepted at the top of its staged function
(``ops/_world_impl.py``) and served by an in-memory matcher instead of the
native transport:

- no processes are spawned and no live communication is created (sockets,
  shm, the native library are never touched);
- values are real tensors: collectives and point-to-point ops compute their
  actual semantics, folding in rank order with numpy exactly as the JAX
  package's ``_fold`` does (bf16, which numpy lacks, folds with torch's
  elementwise ops, which round each step as ``ml_dtypes`` does), so
  known-good programs' assertions pass and "clean" means the full program
  ran.  A result goes back as a new tensor of the input's dtype on the
  input's device, copied synchronously;
- torch is eager, so each op runs on its rank's thread in program order:
  the analyzer sees the true per-rank schedule (the branch taken, the real
  trip count) and names the source line of every event.  An event's rank
  comes from its comm, never from the thread that issues it.  Autograd
  runs a CUDA tensor's backward on one device thread per card, which the
  rank threads of this one process would share: a backward world op
  waiting there for a peer's backward would hold the thread that the
  peer's backward is queued on.  So each rank thread turns torch's
  multithreaded backward off (``torch.autograd.set_multithreading_enabled``,
  a thread-local switch) and runs its backward itself, as a launched rank
  runs its own on its process's device thread;
- matching failures (tag, dtype or shape mismatch, divergent collectives)
  are findings mirroring the native transport's fail-fast aborts; a global
  stall is classified by the wait graph (deadlock cycles, unmatched ops,
  wildcard starvation) in milliseconds instead of a runtime deadline.

A program that reads what a launcher gives a rank gets it from its
``AbstractComm``: ``get_world_comm`` returns the rank's comm (on the device
the program names), ``comm.topology()`` the islands of
``MPI4JAX_TPU_FAKE_HOSTS``, and the tune layers are loaded as a rank's
comm init would (``tune.install(native=False)``), from the environment the
ranks would get.  ``comm.coll_algo`` answers ``"analysis"``: every
``algo=`` and ``compression=`` route is served exactly here.

The conservative schedule-level passes (``order_critical_findings``) run
on the recorded schedules afterwards, so hazards that do not bite under
correct ordering are still reported.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import sys
import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from . import _match
from ._events import ANY_SOURCE, ANY_TAG, CommEvent, Finding, Report
from ._fake import AbstractComm, AnalysisError


class SimAbort(RuntimeError):
    """Raised inside a rank thread when the virtual world aborts the job
    (mirrors the native transport's fail-fast poison cascade)."""


_NP_COMBINE = {
    "SUM": np.add, "PROD": np.multiply,
    "MAX": np.maximum, "MIN": np.minimum,
    "LAND": np.logical_and, "LOR": np.logical_or, "LXOR": np.logical_xor,
    "BAND": np.bitwise_and, "BOR": np.bitwise_or, "BXOR": np.bitwise_xor,
}

_TORCH_COMBINE = {
    "SUM": torch.add, "PROD": torch.mul,
    "MAX": torch.maximum, "MIN": torch.minimum,
    "LAND": torch.logical_and, "LOR": torch.logical_or,
    "LXOR": torch.logical_xor,
}


def _fold(op_name, tensors):
    """The rank-order fold of host tensors, as the JAX package's ``_fold``:
    ``out = op(out, next)`` from the first rank on, in the first operand's
    dtype."""
    dtype = tensors[0].dtype
    if dtype == torch.bfloat16:
        uf = _TORCH_COMBINE[op_name]
        out = tensors[0]
        for t in tensors[1:]:
            out = uf(out, t)
        return out.to(dtype)
    uf = _NP_COMBINE[op_name]
    arrays = [t.numpy() for t in tensors]
    out = arrays[0]
    for a in arrays[1:]:
        out = uf(out, a)
    return torch.from_numpy(np.array(out, dtype=arrays[0].dtype))


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.float32`` ->
    ``"float32"``), the events' vocabulary."""
    return str(dtype).replace("torch.", "")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A private contiguous host copy of ``t``'s values (a send's payload
    is what it held when sent)."""
    return t.detach().to("cpu", copy=True).contiguous()


class _TokenCtx:
    """Per-rank pseudo-trace for the chain guard, keeping analyzed tokens
    alive so id()-keyed tracking cannot alias."""

    __slots__ = ("refs", "__weakref__")

    def __init__(self):
        self.refs = []


_TUNE_STATE = ("_overrides", "_cache_table", "_cache_origin",
               "_cache_combos", "_topo_multi", "_cache_loaded_for")


def resolve_program(program: str, module: bool = False):
    """``(path, globals seed)`` of a program file, or of a module under
    ``module=True`` (run as ``python -m`` runs it: a package's
    ``__main__``, ``__package__`` set for relative imports)."""
    if not module:
        path = os.path.abspath(program)
        if not os.path.isfile(path):
            raise OSError(f"no such program file: {program}")
        return path, {}
    spec = importlib.util.find_spec(program)
    if spec is None:
        raise ValueError(f"no module named {program!r}")
    if spec.submodule_search_locations is not None:
        spec = importlib.util.find_spec(program + ".__main__")
        if spec is None:
            raise ValueError(f"package {program!r} has no __main__")
    if not spec.origin or not os.path.isfile(spec.origin):
        raise ValueError(f"module {program!r} has no source file")
    return os.path.abspath(spec.origin), {
        "__package__": spec.parent, "__spec__": spec,
        "__loader__": spec.loader}


class VirtualWorld:
    """One analysis run of ``program`` (a file, or a module under
    ``module=True``) at world size ``size``."""

    def __init__(self, size: int, program: str, timeout_s=None, argv=None,
                 module: bool = False):
        from ..utils import config

        self.size = int(size)
        # None: the caller sets ``program`` (a function's file, ``check``)
        self.program, self._globals_seed = (
            resolve_program(program, module) if program is not None
            else ("<fn>", {}))
        self.argv = list(argv or ())
        if timeout_s is None:
            timeout_s = config.analyze_timeout_s()
        # 0 = no deadline, matching MPI4JAX_TPU_TIMEOUT_S's convention
        self.timeout_s = float(timeout_s)
        self.cv = threading.Condition()
        self.channels = {}      # (comm_key, src_w, dst_w) -> deque
        self.schedules = {r: [] for r in range(self.size)}
        self.comms = {(0,): tuple(range(self.size))}
        self.findings = []
        self._finding_keys = set()
        self.state = {r: "init" for r in range(self.size)}
        self.blocked = {}       # rank -> (CommEvent, waits_on_fn)
        self.coll = {}          # (comm_key, seq) -> {rank: (event, payload)}
        self.coll_results = {}  # (comm_key, seq) -> {rank: value}
        self.coll_counter = {}  # (rank, comm_key) -> int
        self.aborted = False
        self._token_ctx = {}    # world rank -> _TokenCtx
        self._rank_thread = {}  # world rank -> thread ident
        self._thread_rank = {}  # thread ident -> world rank

    # -- executor protocol (ops/_world_impl hooks) ----------------------

    def owns(self, comm) -> bool:
        # require OUR session: a rank thread leaked by a timed-out earlier
        # run must not inject events into a later run's world
        return isinstance(comm, AbstractComm) and comm._session is self

    def run_op(self, name, data, comm, **params):
        return self._serve(self._record(name, data, comm, params), comm,
                           data, params)

    def _record(self, name, data, comm, params) -> CommEvent:
        """The op's event, appended to its rank's schedule."""
        from ..ops import _world_impl

        sig = _world_impl.schedule_signature(name)
        if sig is None:
            raise AnalysisError(f"no schedule signature for op {name!r}")
        event = self._make_event(sig[1], comm, data, params)
        with self.cv:
            event.idx = len(self.schedules[event.rank])
            self.schedules[event.rank].append(event)
        return event

    def _serve(self, event, comm, data, params):
        """The op's result on this rank, once its peers have run theirs."""
        payload = None if data is None else _host(data)
        value = self._dispatch(event, comm, payload, params)
        if value is None or data is None:
            return None
        # each rank's value is its own host tensor (``_compute_collective``);
        # to a card it goes by a copy from pageable memory, which returns
        # only once the host buffer has been read
        out = value.to(data.dtype)
        if data.device.type == "cpu":
            return out
        return out.to(data.device, non_blocking=False)

    def _make_event(self, spec, comm, data, params):
        world_rank = comm.members[comm.rank()]
        fields = {}
        for field, pname in spec.items():
            if field == "kind":
                continue
            fields[field] = params.get(pname)
        return CommEvent(
            rank=world_rank,
            idx=-1,  # set where the event is appended
            kind=spec["kind"],
            comm=comm.key,
            dtype=None if data is None else dtype_name(data.dtype),
            shape=None if data is None else tuple(int(d) for d in
                                                  data.shape),
            site=self._site(world_rank),
            status=params.get("status") is not None,
            **fields,
        )

    def _frame_of(self, rank):
        """The innermost frame to search for ``rank``'s call site: this
        thread's when it is the rank's, else the rank thread's own (a
        backward running on autograd's device thread while the rank
        thread waits in ``backward()``)."""
        ident = threading.get_ident()
        if rank is None or self._rank_thread.get(rank) in (None, ident):
            return sys._getframe(2)
        return sys._current_frames().get(self._rank_thread[rank])

    def _site(self, rank=None) -> str:
        # walk raw frames (cheap) instead of materializing the whole
        # stack per event: the DEEPEST frame in the analyzed file wins
        import linecache

        frame = self._frame_of(rank)
        lineno = None
        while frame is not None:
            if frame.f_code.co_filename == self.program:
                lineno = frame.f_lineno
                break  # walking outward: first hit IS the deepest
            frame = frame.f_back
        if lineno is None:
            return "<analysis>"
        text = linecache.getline(self.program, lineno).strip()
        loc = f"{os.path.basename(self.program)}:{lineno}"
        return f"{loc} `{text[:70]}`" if text else loc

    # -- op dispatch ----------------------------------------------------

    def _dispatch(self, event, comm, data, params):
        kind = event.kind
        if kind == "send":
            self._push_send(event, comm, event.dest, data)
            return None
        if kind == "recv":
            payload, src_local, tag, nbytes = self._complete_recv(
                event, comm, event.source, event.tag)
            self._fill_status(params, src_local, tag, nbytes)
            return self._into_buffer(payload, data)
        if kind == "sendrecv":
            send_part = CommEvent(
                rank=event.rank, idx=event.idx, kind="send",
                comm=event.comm, dest=event.dest, tag=event.sendtag,
                dtype=event.dtype, shape=event.shape, site=event.site)
            self._push_send(send_part, comm, event.dest, data)
            payload, src_local, tag, nbytes = self._complete_recv(
                event, comm, event.source, event.recvtag)
            self._fill_status(params, src_local, tag, nbytes)
            return self._into_buffer(payload, data)
        if kind == "shift2":
            return self._do_shift2(event, comm, data)
        if kind == "barrier":
            self._do_collective(event, comm, None)
            return None
        return self._do_collective(event, comm, data)

    @staticmethod
    def _into_buffer(payload, buf):
        """A received payload in the receive buffer's shape: a shorter
        message fills its front, the rest stays zero (the transport leaves
        it unwritten)."""
        if payload.shape == buf.shape:
            return payload
        flat = torch.zeros(buf.numel() * buf.element_size(),
                           dtype=torch.uint8)
        raw = payload.reshape(-1).view(torch.uint8)
        flat[:raw.numel()] = raw
        return flat.view(buf.dtype).reshape(buf.shape)

    @staticmethod
    def _fill_status(params, src_local, tag, nbytes):
        status = params.get("status")
        if status is not None:
            status._fill(src_local, tag, nbytes)

    def _push_send(self, event, comm, dest_local, payload):
        with self.cv:
            self._raise_if_aborted()
            dst_w = comm.members[dest_local]
            key = (comm.key, event.rank, dst_w)
            self.channels.setdefault(key, deque()).append((payload, event))
            self.cv.notify_all()

    def _complete_recv(self, event, comm, source_local, tag):
        me = event.rank
        with self.cv:
            while True:
                self._raise_if_aborted()
                got = self._match_recv_locked(event, comm, source_local,
                                              tag)
                if got is not None:
                    self._set_running(me)
                    payload, send_ev, src_w = got
                    return (payload, comm.members.index(src_w),
                            send_ev.tag,
                            payload.numel() * payload.element_size())
                self._block(me, event,
                            ("recv", comm, source_local, tag))
                self._stall_check_locked()
                self.cv.wait(0.05)

    def _match_recv_locked(self, event, comm, source_local, tag):
        me = event.rank
        if source_local == ANY_SOURCE:
            for src_w in comm.members:  # self-sends are legal; scan all
                q = self.channels.get((comm.key, src_w, me))
                if not q:
                    continue
                head_payload, head_ev = q[0]
                if tag not in (None, ANY_TAG) and head_ev.tag != tag:
                    continue  # wildcard scan skips incompatible heads
                q.popleft()
                self._settle_match(head_ev, event)
                return head_payload, head_ev, src_w
            return None
        src_w = comm.members[source_local]
        q = self.channels.get((comm.key, src_w, me))
        if not q:
            return None
        # strict in-order channel: the head IS the match; any field
        # disagreement is a fail-fast program error (native abort)
        head_payload, head_ev = q.popleft()
        self._settle_match(head_ev, event)
        return head_payload, head_ev, src_w

    def _settle_match(self, send_ev, recv_ev):
        found = _match.compare_p2p(send_ev, recv_ev)
        if found:
            self._record_locked(found)
            self._abort_locked()
            raise SimAbort(found[0].message)

    def _do_shift2(self, event, comm, data):
        me = event.rank
        out = [None, None]
        for i, peer in enumerate((event.lo, event.hi)):
            if peer is None or peer < 0:
                continue
            send_part = CommEvent(
                rank=me, idx=event.idx, kind="send", comm=event.comm,
                dest=peer, tag=event.tag,
                dtype=event.dtype, shape=event.shape, site=event.site)
            self._push_send(send_part, comm, peer, data[i])
        with self.cv:
            for i, peer in enumerate((event.lo, event.hi)):
                if peer is None or peer < 0:
                    # wall: passthrough of the opposite input strip
                    out[i] = data[1 - i]
                    continue
                src_w = comm.members[peer]
                while True:
                    self._raise_if_aborted()
                    q = self.channels.get((comm.key, src_w, me))
                    if q:
                        payload, send_ev = q.popleft()
                        self._settle_match(send_ev, event)
                        out[i] = payload
                        break
                    self._block(me, event, ("recv", comm, peer, event.tag))
                    self._stall_check_locked()
                    self.cv.wait(0.05)
            self._set_running(me)
        return torch.stack(out)

    def _do_collective(self, event, comm, payload):
        me = event.rank
        with self.cv:
            self._raise_if_aborted()
            seq = self.coll_counter.get((me, comm.key), 0)
            self.coll_counter[(me, comm.key)] = seq + 1
            gkey = (comm.key, seq)
            group = self.coll.setdefault(gkey, {})
            group[me] = (event, payload)
            members = comm.members
            if set(group) == set(members):
                events = [group[m][0] for m in members]
                found = _match.compare_collective(events)
                if found:
                    self._record_locked(found)
                    self._abort_locked()
                    raise SimAbort(found[0].message)
                self.coll_results[gkey] = self._compute_collective(
                    gkey, members)
                self.cv.notify_all()
            else:
                while gkey not in self.coll_results:
                    self._block(me, event, ("coll", gkey, members))
                    self._stall_check_locked()
                    self.cv.wait(0.05)
                    self._raise_if_aborted()
            self._set_running(me)
            results = self.coll_results[gkey]
            value = results.pop(me)
            if not results:
                del self.coll_results[gkey]
                del self.coll[gkey]
            return value

    def _compute_collective(self, gkey, members):
        """Every member's result, each its own tensor (no two ranks share
        storage: a rank may write its result in place)."""
        group = self.coll[gkey]
        kind = group[members[0]][0].kind
        stack = [group[m][1] for m in members if group[m][1] is not None]
        out = {}
        if kind == "barrier":
            for m in members:
                out[m] = None
        elif kind == "allreduce":
            red = _fold(group[members[0]][0].reduce_op, stack)
            for m in members:
                out[m] = red.clone()
        elif kind == "reduce":
            root_ev = group[members[0]][0]
            red = _fold(root_ev.reduce_op, stack)
            for i, m in enumerate(members):
                out[m] = red if i == root_ev.root else group[m][1]
        elif kind == "scan":
            op = group[members[0]][0].reduce_op
            for i, m in enumerate(members):
                out[m] = _fold(op, stack[:i + 1]).clone()
        elif kind == "bcast":
            root = group[members[0]][0].root
            val = group[members[root]][1]
            for m in members:
                out[m] = val.clone()
        elif kind == "allgather":
            for m in members:
                out[m] = torch.stack(stack)
        elif kind == "gather":
            root = group[members[0]][0].root
            for i, m in enumerate(members):
                out[m] = torch.stack(stack) if i == root else group[m][1]
        elif kind == "scatter":
            root = group[members[0]][0].root
            rows = group[members[root]][1]
            for i, m in enumerate(members):
                out[m] = rows[i].clone()
        elif kind == "alltoall":
            for i, m in enumerate(members):
                out[m] = torch.stack([group[mj][1][i] for mj in members])
        else:  # split/dup rendezvous values are computed by the caller
            for m in members:
                out[m] = None
        return out

    # -- comm management (AbstractComm.split/dup route here) ------------

    def split_collective(self, comm, color, key, _dup=False):
        comm._split_seq += 1
        seq = comm._split_seq
        me_local = comm.rank()
        me_world = comm.members[me_local]
        sort_key = me_local if key is None else int(key)
        event = CommEvent(rank=me_world, idx=-1, kind="split",
                          comm=comm.key, site=self._site(me_world))
        with self.cv:
            event.idx = len(self.schedules[me_world])
            self.schedules[me_world].append(event)
            gkey = (comm.key, "split", seq)
            group = self.coll.setdefault(gkey, {})
            group[me_world] = (event, (color, sort_key, me_local))
            members = comm.members
            if set(group) == set(members):
                results = {}
                by_color = {}
                for m in members:
                    c, k, loc = group[m][1]
                    if c < 0:
                        results[m] = None
                        continue
                    by_color.setdefault(c, []).append((k, loc, m))
                for c, entries in by_color.items():
                    entries.sort()
                    sub_members = tuple(m for _, _, m in entries)
                    new_key = comm.key + (seq, c)
                    self.comms[new_key] = sub_members
                    for sub_rank, (_, _, m) in enumerate(entries):
                        results[m] = (new_key, sub_members, sub_rank)
                self.coll_results[gkey] = results
                self.cv.notify_all()
            else:
                while gkey not in self.coll_results:
                    self._block(me_world, event, ("coll", gkey, members))
                    self._stall_check_locked()
                    self.cv.wait(0.05)
                    self._raise_if_aborted()
            self._set_running(me_world)
            results = self.coll_results[gkey]
            mine = results.pop(me_world)
            if not results:
                del self.coll_results[gkey]
                del self.coll[gkey]
        if mine is None:
            return None
        new_key, sub_members, sub_rank = mine
        sub = AbstractComm(sub_rank, len(sub_members), key=new_key,
                           members=sub_members, session=self,
                           device=comm.device)
        sub._device_named = comm._device_named
        return sub

    def dup_collective(self, comm):
        return self.split_collective(comm, 0, None, _dup=True)

    # -- chain-guard hooks ----------------------------------------------

    def _rank_of(self, comm=None):
        if isinstance(comm, AbstractComm):
            return comm.members[comm.rank()]
        ident = threading.get_ident()
        return self._thread_rank.get(ident, ("thread", ident))

    def _token_trace(self, tok=None, comm=None):
        """The pseudo-trace of the rank that owns ``comm`` (or of this
        rank thread): keyed by rank, never by thread, as the events are."""
        rank = self._rank_of(comm)
        with self.cv:
            ctx = self._token_ctx.get(rank)
            if ctx is None:
                ctx = self._token_ctx[rank] = _TokenCtx()
        if tok is not None:
            ctx.refs.append(tok)
        return ctx

    def _token_warn(self, comm, n_heads, how):
        rank = self._rank_of(comm) if isinstance(comm, AbstractComm) \
            else None
        finding = Finding(
            "token_violation",
            f"a world op on {comm!r} is {how} while {n_heads} other token "
            "chain(s) on the same comm are live — relative order is "
            "UNDEFINED in explicit-token mode and can deadlock",
            ranks=() if rank is None else (rank,),
            comm=comm.key if isinstance(comm, AbstractComm) else (),
            sites=(self._site(rank),),
        )
        with self.cv:
            self._record_locked([finding])

    # -- bookkeeping ----------------------------------------------------

    def _record_locked(self, findings):
        for f in findings:
            key = (f.kind, f.ranks, f.comm, f.message)
            if key in self._finding_keys:
                continue
            self._finding_keys.add(key)
            self.findings.append(f)

    def _raise_if_aborted(self):
        if self.aborted:
            raise SimAbort("virtual world aborted")

    def _abort_locked(self):
        self.aborted = True
        self.cv.notify_all()

    def _block(self, rank, event, info):
        self.state[rank] = "blocked"
        self.blocked[rank] = (event, info)

    def _set_running(self, rank):
        self.state[rank] = "running"
        self.blocked.pop(rank, None)

    def _satisfiable_locked(self, event, info) -> bool:
        """Fresh check: can this blocked op still make progress?"""
        kind = info[0]
        if kind == "recv":
            comm, source_local, tag = info[1], info[2], info[3]
            me = event.rank
            if source_local == ANY_SOURCE:
                for src_w in comm.members:
                    q = self.channels.get((comm.key, src_w, me))
                    if q and (tag in (None, ANY_TAG)
                              or q[0][1].tag == tag):
                        return True
                return False
            return bool(self.channels.get(
                (comm.key, comm.members[source_local], me)))
        if kind == "coll":
            gkey, members = info[1], info[2]
            if gkey in self.coll_results:
                return True  # result computed, pickup pending
            group = self.coll.get(gkey, {})
            return set(group) == set(members)
        return True  # unknown: never declare a stall on it

    def _waits_on_locked(self, event, info):
        kind = info[0]
        if kind == "recv":
            comm, source_local = info[1], info[2]
            if source_local == ANY_SOURCE:
                return tuple(m for m in comm.members if m != event.rank)
            return (comm.members[source_local],)
        if kind == "coll":
            gkey, members = info[1], info[2]
            group = self.coll.get(gkey, {})
            return tuple(m for m in members if m not in group)
        return ()

    def _stall_check_locked(self):
        """Declare a stall only when it is PROVEN: nobody is running and
        no blocked op can make progress.  Every predicate is re-evaluated
        fresh under the lock — state captured at block time can be stale
        (a result may be computed but not yet picked up)."""
        if self.aborted:
            return
        if any(s in ("init", "running") for s in self.state.values()):
            return
        blocked = {r: be for r, be in self.blocked.items()
                   if self.state[r] == "blocked"}
        if not blocked:
            return
        if any(self._satisfiable_locked(ev, info)
               for ev, info in blocked.values()):
            return
        blocked_evs = {r: ev for r, (ev, _) in blocked.items()}
        waits_on = {r: self._waits_on_locked(ev, info)
                    for r, (ev, info) in blocked.items()}
        done = frozenset(r for r, s in self.state.items()
                         if s in ("done", "failed"))
        found = _match.wait_graph_findings(blocked_evs, waits_on, done)
        if found:
            self._record_locked(found)
        self._abort_locked()

    def _record_rank_error(self, rank, err):
        site = ""
        if isinstance(err, BaseException):
            for frame in traceback.extract_tb(err.__traceback__):
                if os.path.abspath(frame.filename) == self.program:
                    site = (f"{os.path.basename(frame.filename)}:"
                            f"{frame.lineno} `{(frame.line or '').strip()[:70]}`")
            message = (f"rank {rank} raised "
                       f"{type(err).__name__}: {err}")
        else:
            message = f"rank {rank} {err}"
        with self.cv:
            self._record_locked([Finding(
                "rank_error", message, ranks=(rank,),
                sites=(site,) if site else (),
            )])

    # -- the run --------------------------------------------------------

    def _rank_comm(self, rank):
        return AbstractComm(rank, self.size, key=(0,),
                            members=tuple(range(self.size)), session=self)

    def _rank_main(self, rank, body):
        from ..parallel import mesh
        from ..runtime import transport

        ident = threading.get_ident()
        comm = self._rank_comm(rank)
        with self.cv:
            self._rank_thread[rank] = ident
            self._thread_rank[ident] = rank
            self.state[rank] = "running"
        mesh._push_comm(comm)
        transport._virtual.comm = comm
        ok = False
        try:
            with torch.autograd.set_multithreading_enabled(False):
                body(rank, comm)
            ok = True
        except SystemExit as e:
            ok = e.code in (None, 0)
            if not ok:
                self._record_rank_error(rank, f"exited with code {e.code}")
        except SimAbort:
            pass  # the abort's cause is already a finding
        except BaseException as e:  # noqa: BLE001 - report, then classify
            self._record_rank_error(rank, e)
        finally:
            transport._virtual.comm = None
            with self.cv:
                self.state[rank] = "done" if ok else "failed"
                self.blocked.pop(rank, None)
                self.cv.notify_all()
                self._stall_check_locked()

    def _install_tune(self):
        """The tune layers a rank's comm init would load, in Python only;
        returns the state to restore."""
        from .. import tune

        saved = {k: getattr(tune, k) for k in _TUNE_STATE}
        saved["_overrides"] = {op: dict(v)
                               for op, v in tune._overrides.items()}
        world = AbstractComm(0, self.size, session=self,
                             device=torch.device("cpu"))
        try:
            tune.install(self.size, topology=world.topology(), native=False)
        except Exception as e:  # a broken knob surfaces in the ranks
            print(f"analysis: tune layers not loaded: {e}",
                  file=sys.stderr)
        return saved

    def run(self) -> Report:
        with open(self.program) as f:
            src = f.read()
        code = compile(src, self.program, "exec")

        def body(rank, comm):
            g = {"__name__": "__main__", "__file__": self.program,
                 "__builtins__": __builtins__, **self._globals_seed}
            exec(code, g)

        # the program sees its own argv, exactly as under the launcher
        self._run_ranks(body, [self.program] + self.argv)
        return self._report()

    def _run_ranks(self, body, argv):
        """Run ``body(rank, comm)`` on one thread per rank, under the
        analysis hooks, until every rank ends or the deadline passes."""
        from .. import tune
        from ..ops import _world_impl

        # programs mutate process-global state (the knobs in os.environ,
        # torch's thread count, the tune layers): snapshot so that one
        # analyzed program cannot leak into the next run in this process
        old_env = dict(os.environ)
        old_threads = torch.get_num_threads()
        old_argv = sys.argv
        sys.argv = list(argv)
        saved_tune = self._install_tune()
        _world_impl._set_analysis_executor(self)
        _world_impl._set_analysis_token_hooks(self._token_trace,
                                              self._token_warn)
        self.output = io.StringIO()
        threads = [
            threading.Thread(target=self._rank_main, args=(r, body),
                             daemon=True, name=f"analysis-rank-{r}")
            for r in range(self.size)
        ]
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(self.output), \
                    contextlib.redirect_stderr(self.output):
                for t in threads:
                    t.start()
                if self.timeout_s > 0:
                    deadline = t0 + self.timeout_s
                    for t in threads:
                        t.join(max(0.1, deadline - time.monotonic()))
                else:  # 0 = no deadline (the stall detector still runs)
                    for t in threads:
                        t.join()
                if any(t.is_alive() for t in threads):
                    with self.cv:
                        self._record_locked([Finding(
                            "analysis_timeout",
                            f"virtual world did not finish within "
                            f"{self.timeout_s:g}s; rank states: "
                            f"{dict(sorted(self.state.items()))}",
                        )])
                        self._abort_locked()
                    for t in threads:
                        t.join(2.0)
        finally:
            _world_impl._set_analysis_executor(None)
            _world_impl._set_analysis_token_hooks(None, None)
            sys.argv = old_argv
            for k, v in saved_tune.items():
                setattr(tune, k, v)
            torch.set_num_threads(old_threads)
            os.environ.clear()
            os.environ.update(old_env)
        self.seconds = time.monotonic() - t0

    def _report(self) -> Report:
        with self.cv:
            if not self.aborted:
                seen_chan = set()
                for (ckey, s, d), q in self.channels.items():
                    if not q or (ckey, s, d) in seen_chan:
                        continue
                    seen_chan.add((ckey, s, d))
                    _, ev = q[0]
                    self._record_locked([Finding(
                        "unmatched_send",
                        f"rank {s} sends to rank {d} (tag {ev.tag}) but "
                        "no matching receive ever runs "
                        f"({len(q)} message(s) queued)",
                        ranks=(s, d), comm=ckey,
                        sites=(f"rank {s}: {ev.describe()}",),
                    )])
            self._record_locked(
                _match.order_critical_findings(self.schedules, self.comms))
        from ._events import schedule_cache_key

        return Report(
            world_size=self.size,
            target=self.program,
            findings=list(self.findings),
            schedules={r: [e.describe() for e in evs]
                       for r, evs in self.schedules.items()},
            output=self.output.getvalue(),
            events=dict(self.schedules),
            comms=dict(self.comms),
            cache_key=schedule_cache_key(self.schedules, self.size),
        )
