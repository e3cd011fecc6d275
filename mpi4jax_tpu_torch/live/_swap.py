"""Epoch rendezvous: when every rank installs a new decision table.

A copy of ``mpi4jax_tpu/live/_swap.py``.  Every rank of a comm must run
each collective with the same schedule (frames carry the algorithm and a
receiver aborts on a mismatch), so a table may change only where every
rank changes it.  The SPMD invariant (every rank runs the same collective
sequence on a comm) makes a per-comm boundary counter a shared clock:

- ``on_boundary`` runs at the top of every collective wrapper of the
  bridge; every ``period``-th boundary of the world comm is a rendezvous;
- there every rank runs a bcast from rank 0 of an int64 header
  ``(epoch, payload_len)``: ``(current epoch, 0)`` when no proposal waits,
  the steady-state cost of one 16-byte bcast every ``period`` collectives;
- a header with ``epoch`` above the local one is followed by a bcast of
  the JSON payload; every rank stages its tables and commits them under
  the comm lock with the progress engine quiesced, stamping the epoch.

Rank 0 is the sole proposer.  The rendezvous' own bcasts re-enter the
hook; the ``_in_rv`` guard keeps them off the counter, or it would drift
from the application's collective sequence.  Another comm's collectives
(the topology sub-comms of the leg) carry another handle and never count.
``tests/torch_world_programs/epoch_rendezvous.py`` is the protocol's
schedule for the static verifier.
"""


from __future__ import annotations

import json
import sys
import threading

import numpy as np


class SwapProtocol:
    """Per-comm boundary counter + the rendezvous/commit state machine.

    ``bridge`` is injected (the module object) so unit tests can drive
    the protocol against a fake bridge without a native library."""

    def __init__(self, bridge, handle, rank: int, size: int,
                 period: int):
        self.bridge = bridge
        self.handle = int(handle)
        self.rank = int(rank)
        self.size = int(size)
        self.period = max(int(period), 1)
        cur = bridge.coll_epoch()
        self.epoch = int(cur) if cur is not None else 0
        self.boundaries = 0
        self.last_swap_boundary: int | None = None
        self.swaps: list = []     # [{epoch, boundary, report}, ...]
        self.on_commit = None     # callback(spec) after a commit
        self._pending = None      # rank 0: payload dict awaiting rendezvous
        self._next_epoch = self.epoch  # rank 0: highest epoch proposed
        self._lock = threading.Lock()
        self._in_rv = False

    # -- proposer side (rank 0) -----------------------------------------

    def propose(self, payload: dict) -> int:
        """Park a payload (``{"tables": {kind: [[mb, code]...]},
        "named": ..., "report": ...}``) for the next rendezvous; a
        newer proposal before that simply replaces it (latest wins —
        the superseded table was never installed anywhere).  Returns
        the epoch the proposal will commit as."""
        with self._lock:
            self._next_epoch = max(self._next_epoch, self.epoch) + 1
            self._pending = (self._next_epoch, dict(payload))
            return self._next_epoch

    def pending(self) -> bool:
        with self._lock:
            return self._pending is not None

    def boundaries_since_swap(self) -> int:
        if self.last_swap_boundary is None:
            return self.boundaries
        return self.boundaries - self.last_swap_boundary

    # -- every rank ------------------------------------------------------

    def on_boundary(self, handle) -> None:
        """The bridge hook: count this comm's collectives, rendezvous on
        every ``period``-th.  Other comms' collectives (topology
        sub-comms, serving side channels) don't advance the clock —
        their sequences are not synchronized with the world's."""
        if self._in_rv or int(handle) != self.handle:
            return
        self.boundaries += 1
        if self.boundaries % self.period:
            return
        self._rendezvous()

    def _rendezvous(self) -> None:
        # every rank reaches this at the same world-collective boundary
        # (SPMD invariant); the bcasts below are therefore matched
        self._in_rv = True
        try:
            pend = None
            if self.rank == 0:
                with self._lock:
                    pend = self._pending
            hdr = np.zeros(2, dtype=np.int64)
            payload_bytes = b""
            if pend is not None:
                payload_bytes = json.dumps(
                    pend[1], sort_keys=True).encode("utf-8")
                hdr[0] = pend[0]
                hdr[1] = len(payload_bytes)
            else:
                hdr[0] = self.epoch
            hdr = self.bridge.bcast(self.handle, hdr, 0)
            epoch, nbytes = int(hdr[0]), int(hdr[1])
            if epoch <= self.epoch or nbytes <= 0:
                return
            buf = np.zeros(nbytes, dtype=np.uint8)
            if self.rank == 0:
                buf[:] = np.frombuffer(payload_bytes, dtype=np.uint8)
            buf = self.bridge.bcast(self.handle, buf, 0)
            spec = json.loads(bytes(buf.tobytes()).decode("utf-8"))
            self._commit(epoch, spec)
            if self.rank == 0:
                with self._lock:
                    # clear only the proposal just installed; a newer
                    # one that raced in waits for the next rendezvous
                    if self._pending is not None \
                            and self._pending[0] == epoch:
                        self._pending = None
        finally:
            self._in_rv = False

    def _commit(self, epoch: int, spec: dict) -> None:
        coded = {int(k): [(int(mb), int(code)) for mb, code in entries]
                 for k, entries in spec.get("tables", {}).items()}
        if not self.bridge.stage_coll_table(coded):
            # arm() verified the native capability, so this is a bug,
            # not a version skew — but never desynchronize silently
            raise RuntimeError("live swap: tpucomm_stage_coll_table "
                               "unavailable mid-run")
        self.bridge.commit_coll_tables(self.handle, epoch)
        self.epoch = epoch
        self.last_swap_boundary = self.boundaries
        record = {"epoch": epoch, "boundary": self.boundaries,
                  "named": spec.get("named", {}),
                  "report": spec.get("report", {})}
        self.swaps.append(record)
        if self.rank == 0:
            changes = (spec.get("report") or {}).get("changes") or []
            detail = "; ".join(changes) if changes \
                else (spec.get("report") or {}).get("note", "")
            print(f"[live] epoch {epoch} committed at boundary "
                  f"{self.boundaries}: {detail}",
                  file=sys.stderr, flush=True)
        cb = self.on_commit
        if cb is not None:
            cb(record)
