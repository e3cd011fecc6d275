"""Continuous-batching inference that survives a rank's death.

The counterpart of ``mpi4jax_tpu/elastic/serving.py``: the *toy* plane
(full-sequence re-decode every iteration, no KV cache, no admission
control), kept small as the elastic regression surface.  Rank 0 is the
*frontend*: it owns the request queue and the state of every in-flight
sequence, and every rank, the frontend included, is a *worker* computing
next tokens for its slice of the running batch.

Each iteration decodes one token for every active request; a finished
request retires at once and a queued one joins the next iteration.  Per
iteration the frontend broadcasts the padded token matrix, every rank
decodes rows ``[rank*chunk, (rank+1)*chunk)`` with ``decode_fn``, and an
allgather returns the next tokens to everyone.  The frontend commits only
after the whole exchange succeeded, so when a rank dies mid-iteration
nothing was committed: the survivors recover (``elastic.recover``) and the
same active set is re-batched on the shrunk world.  A request in flight on
the dead rank is retried, not lost.

Rank 0's own death loses the in-flight sequences (their state lived in its
process); the survivor promoted to rank 0 releases the others before it
raises.  Any other rank may die at any moment.

``decode_fn(toks, lengths, start, stop)`` takes CPU tensors (int32 tokens
right-padded to ``(nreq, seqlen)`` and int64 lengths) and returns the next
token of rows ``start..stop`` as a tensor or array of that many integers;
it may run a model on any device.  The exchanges are the bridge's, on
host buffers.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ._errors import is_rank_failure
from ._world import recover

#: header opcodes (an int64 header [op, nreq, seqlen] is broadcast each turn)
_OP_STOP = 0
_OP_STEP = 1


class Request:
    """One generation request: ``tokens`` grows by one per decode
    iteration until ``max_new`` tokens were added (or ``eos`` came)."""

    def __init__(self, req_id, prompt, max_new: int):
        self.id = req_id
        self.prompt = [int(t) for t in prompt]
        self.tokens = list(self.prompt)
        self.max_new = int(max_new)
        self.done = False
        self.submitted_at = time.perf_counter()
        self.completed_at = None
        self.retries = 0  # decode iterations run again after recoveries

    @property
    def generated(self):
        return self.tokens[len(self.prompt):]

    @property
    def latency_s(self):
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


def _bcast(comm, arr):
    from ..runtime import bridge

    return bridge.bcast(comm.handle, arr, 0)


def _allgather(comm, arr):
    from ..runtime import bridge

    return bridge.allgather(comm.handle, arr, comm.size())


def _decode_round(comm, decode_fn, toks, lengths):
    """One collective decode iteration (all ranks): the next token of every
    row."""
    nreq = toks.shape[0]
    chunk = -(-nreq // comm.size())
    start = comm.rank() * chunk
    stop = min(nreq, start + chunk)
    out = np.zeros(chunk, np.int32)
    if start < stop:
        nxt = torch.as_tensor(decode_fn(torch.from_numpy(toks),
                                        torch.from_numpy(lengths), start,
                                        stop))
        nxt = nxt.reshape(-1).to("cpu", torch.int32).numpy()
        if nxt.shape[0] != stop - start:
            raise ValueError(
                f"decode_fn returned {nxt.shape[0]} tokens for rows "
                f"[{start},{stop})")
        out[:stop - start] = nxt
    return _allgather(comm, out).reshape(-1)[:nreq]


def serve_worker(comm, decode_fn) -> None:
    """The loop of a rank other than the frontend: follow the frontend's
    broadcasts until it says stop.  Recovers in place on a rank failure
    (the frontend re-batches; this worker re-enters the loop on the shrunk
    world)."""
    while True:
        try:
            hdr = _bcast(comm, np.zeros(3, np.int64))
            if int(hdr[0]) == _OP_STOP:
                return
            nreq, seqlen = int(hdr[1]), int(hdr[2])
            lengths = _bcast(comm, np.zeros(nreq, np.int64))
            toks = _bcast(comm, np.zeros((nreq, seqlen), np.int32))
            _decode_round(comm, decode_fn, toks, lengths)
        except BaseException as e:
            if not is_rank_failure(e):
                raise
            recover(comm)
            if comm.rank() == 0:
                # release the other survivors first: they re-entered this
                # loop in a bcast rooted at the new rank 0 and would wait
                # there until the transport's deadline
                try:
                    _bcast(comm, np.array([_OP_STOP, 0, 0], np.int64))
                except BaseException as stop_err:  # noqa: BLE001
                    if not is_rank_failure(stop_err):
                        raise
                raise RuntimeError(
                    "this worker became the frontend after recovery — "
                    "frontend state (the request queue) lived on the "
                    "dead rank 0 and cannot be reconstructed")


class Server:
    """The frontend (run on rank 0; every other rank runs
    :func:`serve_worker` with the same ``decode_fn``).

    ``decode_fn`` must depend only on the rows' contents, not on the rank
    or the world size, so that an iteration retried on a shrunk world gives
    the same tokens.
    """

    def __init__(self, comm, decode_fn, *, max_batch: int = 8,
                 eos: Optional[int] = None):
        if comm.rank() != 0:
            raise ValueError("Server runs on rank 0; other ranks run "
                             "serve_worker()")
        self.comm = comm
        self.decode_fn = decode_fn
        self.max_batch = int(max_batch)
        self.eos = eos
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.recoveries = 0
        self._next_id = 0

    def submit(self, prompt, max_new: int, req_id=None) -> Request:
        if req_id is None:
            req_id = self._next_id
            self._next_id += 1
        req = Request(req_id, prompt, max_new)
        self.queue.append(req)
        return req

    @property
    def active(self):
        return [r for r in self.queue if not r.done]

    def step(self) -> List[Request]:
        """One iteration: decode one token for up to ``max_batch`` active
        requests; returns the requests completed in it.  On a rank failure
        nothing is committed: the world recovers and the same requests are
        retried on the next call."""
        batch = self.active[:self.max_batch]
        if not batch:
            return []
        try:
            seqlen = max(len(r.tokens) for r in batch)
            toks = np.zeros((len(batch), seqlen), np.int32)
            lengths = np.zeros(len(batch), np.int64)
            for i, r in enumerate(batch):
                toks[i, :len(r.tokens)] = r.tokens
                lengths[i] = len(r.tokens)
            _bcast(self.comm,
                   np.array([_OP_STEP, len(batch), seqlen], np.int64))
            _bcast(self.comm, lengths)
            _bcast(self.comm, toks)
            nxt = _decode_round(self.comm, self.decode_fn, toks, lengths)
        except BaseException as e:
            if not is_rank_failure(e):
                raise
            self.recoveries += 1
            for r in batch:
                r.retries += 1
            recover(self.comm)
            print(f"[elastic] serving: recovered (world size now "
                  f"{self.comm.size()}); retrying {len(batch)} in-flight "
                  "request(s)", file=sys.stderr, flush=True)
            return []
        # the commit point: everything above can be replayed
        done_now = []
        for i, r in enumerate(batch):
            r.tokens.append(int(nxt[i]))
            if (len(r.generated) >= r.max_new
                    or (self.eos is not None and int(nxt[i]) == self.eos)):
                r.done = True
                r.completed_at = time.perf_counter()
                done_now.append(r)
                self.completed.append(r)
        self.queue = [r for r in self.queue if not r.done]
        return done_now

    def run_until_drained(self, *, max_iters: int = 100000):
        """Decode until no request is active; returns every completed
        request."""
        it = 0
        while self.active:
            it += 1
            if it > max_iters:
                raise RuntimeError(
                    f"serving did not drain within {max_iters} "
                    "iterations")
            self.step()
        return self.completed

    def stop(self) -> None:
        """Release the workers (broadcast the stop opcode)."""
        try:
            _bcast(self.comm, np.array([_OP_STOP, 0, 0], np.int64))
        except BaseException as e:
            if not is_rank_failure(e):
                raise
