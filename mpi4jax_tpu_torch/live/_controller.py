"""The live controller: follow the event ring, detect drift, propose.

A copy of ``mpi4jax_tpu/live/_controller.py``.  One daemon thread per
armed comm, on every rank (each rank's drift picture feeds
``live.status``), but only rank 0's proposes a table.  The loop:

1. ``peek`` new events off the native ring (a cursor follow: the
   end-of-run drain still sees everything), canonicalize them, feed the
   rolling window and the :class:`._drift.DriftDetector`;
2. the baseline: the tuner's persisted cost model for this world size
   when there is one (``MPI4JAX_TPU_TUNE_MODEL``), else a fit of the first
   half-window of events;
3. on drift past the threshold, outside the cooldown, with no proposal
   waiting: a candidate model (the baseline's samples with the detector's
   fresh medians laid over them) re-ranks every measured algorithm at the
   observed sizes and the table's breakpoints (``tune._model``), and the
   winners become a new table;
4. winners that changed go to the swap protocol; the rendezvous and the
   commit run at the application's collective boundary, never on this
   thread.

The overlay keeps the re-ranking sound: the window only times the
incumbent, so the alternatives keep their baseline predictions while the
incumbent's drifted cost replaces its own.  On a commit the candidate
becomes the baseline, so the new pick is compared with what the old one
really cost and the controller does not swap straight back.  A tick never
takes the job down: its exceptions are counted (``live.status``).  The
thread touches no torch state and no card.
"""


from __future__ import annotations

import os
import sys
import threading
import traceback
from collections import deque

from .. import tune
from ..tune import _model
from ..utils import config
from . import _drift


def _lookup(entries, nbytes: int):
    """The algorithm a (min_bytes, algo) ladder selects at ``nbytes``."""
    algo = None
    for mb, name in entries or []:
        if int(nbytes) >= int(mb):
            algo = name
    return algo


class Controller:
    def __init__(self, lib, handle, rank: int, size: int, swap, *,
                 window: int, drift_pct: float, cooldown_ops: int,
                 poll_s: float = 0.05):
        self._lib = lib
        self._handle = int(handle)
        self._rank = int(rank)
        self._size = int(size)
        self._swap = swap
        self._window = max(int(window), 16)
        self._cooldown = max(int(cooldown_ops), 1)
        # hysteresis: a re-pick must beat the incumbent's OBSERVED cost
        # by half the drift threshold — when two algorithms degrade to
        # within noise of each other under the same contention, the
        # honest answer is "not worth a swap", not a ping-pong
        self._hyst = max(0.5, min(0.9, 1.0 - float(drift_pct) / 200.0))
        self._poll_s = float(poll_s)
        self._cursor = 0
        self._skipped = 0
        self._events = deque(maxlen=self._window)
        self._detector = _drift.DriftDetector(
            None, drift_pct=drift_pct,
            per_key=max(8, self._window // 4))
        # current installed ladder, by op name — what a candidate must
        # beat; starts from the tuner's merged view and tracks commits
        self._current = {op: [(int(mb), str(name)) for mb, name in ent]
                         for op, ent in tune.decision_table().items()}
        self._baseline = None
        self._baseline_source = None
        self._cand_model = None   # candidate awaiting adoption on commit
        # self-fit once the window is half full (a full window could
        # take arbitrarily long on a quiet job)
        self._selffit_at = max(self._window // 2, 16)
        self._drift_flags = 0
        self._proposals = 0
        self._pokes = 0
        self._errors = 0
        self._last_drifts: list = []
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="mpi4jax-tpu-live", daemon=True)
        self._load_baseline()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)

    def poke(self, reason: str = "api") -> None:
        """Request an immediate evaluation (the SLO retune path)."""
        self._pokes += 1
        self._wake.set()

    def status(self) -> dict:
        with self._mu:
            return {
                "cursor": self._cursor,
                "cursor_skipped": self._skipped,
                "window_events": len(self._events),
                "baseline": self._baseline_source,
                "drift_flags": self._drift_flags,
                "proposals": self._proposals,
                "pokes": self._pokes,
                "errors": self._errors,
                "last_drifts": list(self._last_drifts),
            }

    def note_commit(self, record: dict) -> None:
        """Swap-commit callback (application thread): track the newly
        installed ladders and drop the detector's windows — the
        incumbent's pre-swap timings are stale evidence now."""
        with self._mu:
            for op, entries in (record.get("named") or {}).items():
                self._current[op] = [(int(mb), str(name))
                                     for mb, name in entries]
            if self._cand_model is not None:
                # adopt: the candidate carries the window's learned
                # costs for the drifted bands, so post-swap re-ranking
                # measures the new incumbent against what the old one
                # ACTUALLY cost — not its stale quiescent prediction
                # (which would flag drift and swap straight back)
                self._baseline = self._cand_model
                self._cand_model = None
                if self._baseline_source and not \
                        self._baseline_source.endswith("+live-overlay"):
                    self._baseline_source += "+live-overlay"
                self._detector.set_model(self._baseline)
            self._detector.reset()

    # -- the loop --------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self._poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - the job outlives us
                self._errors += 1
                if self._errors <= 3:
                    traceback.print_exc(file=sys.stderr)

    def _tick(self) -> None:
        from ..obs import _native as obs_native
        from ..obs import _recorder

        raw, self._cursor, sk = obs_native.peek(self._lib, self._cursor)
        self._skipped += sk
        with self._mu:
            if raw:
                canon = _recorder.canonicalize_native(raw)
                self._events.extend(canon)
                self._detector.observe(canon)
            if self._baseline is None:
                if len(self._events) < self._selffit_at:
                    return
                # self-fit: the first window becomes "normal" — drift
                # is then measured as departure from the job's own
                # early behavior
                self._baseline = tune.fit_model_from_events(
                    list(self._events), world_size=self._size,
                    source="live-selffit")
                self._baseline_source = "self-fit"
                self._detector.set_model(self._baseline)
                return
            if self._rank != 0:
                return
            if self._swap.pending():
                return
            if self._swap.boundaries_since_swap() < self._cooldown:
                return
            drifts = self._detector.drifts()
            if not drifts:
                return
            self._drift_flags += len(drifts)
            self._last_drifts = [d.as_dict() for d in drifts]
            tables, changes = self._candidate(drifts)
        if not tables:
            return
        payload = self._payload(tables, changes)
        self._swap.propose(payload)
        with self._mu:
            self._proposals += 1

    # -- baseline / candidate -------------------------------------------

    def _load_baseline(self) -> None:
        path = _model.model_path(self._size)
        if not os.path.exists(path):
            return
        try:
            self._baseline = _model.load_model(path)
            self._baseline_source = f"model-file:{path}"
            self._detector.set_model(self._baseline)
        except Exception as e:
            print(f"[live] ignoring unreadable cost model {path}: {e}",
                  file=sys.stderr, flush=True)

    def _eligible(self, combo: str) -> bool:
        """Combos the controller may install: plain algorithm names the
        native table accepts (gated variants like ``hring+q`` need knob
        forcing the controller does not own), quantized families only
        when the active mode permits lossy wires."""
        if combo not in tune.ALGO_CODES:
            return False
        if combo in ("auto", "shm"):
            return False
        if combo in (tune.QUANT_ALGOS | tune.A2A_QUANT) \
                and config.quant_mode() == "deny":
            return False
        return True

    def _candidate(self, drifts):
        """(tables, changes): per-op ladders whose winners moved, plus
        human-readable old -> new lines for the drifted bands."""
        cand = _model.CostModel.from_json(self._baseline.to_json())
        # overlay the DETECTOR's per-key windows, not the raw event
        # window: the detector medians are current-regime (its short
        # deques evict pre-drift samples), while the raw window can
        # still be half quiescent — an overlay that averages regimes
        # under-records the incumbent's drifted cost, and the adopted
        # baseline then invites an immediate swap back
        meas = tune.measurements_from_events(
            self._detector.window_events())
        for op, by_size in meas.items():
            for nbytes, by_algo in by_size.items():
                for algo, med in by_algo.items():
                    cand.add_sample(op, algo, nbytes, med)
        tables, changes = {}, []
        for op in tune.OPS:
            sizes = {s for (o, _c), pts in cand.samples.items()
                     if o == op for s in pts}
            cur = self._current.get(op) or []
            # keep the existing ladder's breakpoints in play so a
            # candidate refines the installed structure instead of
            # collapsing it to only the observed sizes
            sizes |= {max(int(mb), 1) for mb, _ in cur}
            if not sizes:
                continue
            combos = [c for c in cand.combos(op) if self._eligible(c)]
            if not combos:
                continue
            best = {}
            for s in sorted(sizes):
                ranked = cand.rank_combos(op, s, combos)
                pick = next((c for c, p in ranked if p is not None),
                            None)
                if pick is not None:
                    best[s] = pick
            if not best:
                continue
            entries = [(int(mb), str(name)) for mb, name in
                       tune.entries_from_measurements(best)]
            if entries == cur:
                continue
            tables[op] = entries
            for d in drifts:
                if d.op != op:
                    continue
                old = _lookup(cur, d.nbytes)
                new = _lookup(entries, d.nbytes)
                if old == new:
                    continue
                pred_new = cand.predict(op, d.nbytes, new) \
                    if new is not None else None
                if pred_new is not None and \
                        pred_new >= d.observed_s * self._hyst:
                    # within the hysteresis band of what the incumbent
                    # actually costs — not worth paying for a swap
                    continue
                changes.append(f"{op}@{d.band}: {old} -> {new}")
        if tables and not changes:
            # ladders moved only at non-drifted sizes — too weak a
            # signal to pay a swap for
            return {}, []
        if tables:
            # staged for adoption when (if) this proposal commits
            self._cand_model = cand
        return tables, changes

    def _payload(self, tables, changes) -> dict:
        return {
            "tables": {str(tune.OP_KIND[op]):
                       [[mb, tune.ALGO_CODES[name]]
                        for mb, name in entries]
                       for op, entries in tables.items()},
            "named": {op: [[mb, name] for mb, name in entries]
                      for op, entries in tables.items()},
            "report": {"changes": changes, "note": "drift"},
        }
