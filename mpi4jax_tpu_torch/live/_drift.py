"""Drift detection: rolling observed medians against the cost model.

A copy of ``mpi4jax_tpu/live/_drift.py``.  A :class:`DriftDetector` is fed
canonical events (the obs dump schema) and compares, per (op, power-of-two
size band, algorithm), the rolling median of the observed durations with
what the tune cost model predicts for that algorithm at the band's sizes.
A finding means the model's picture of that algorithm at that size is
wrong by more than the threshold, slower or faster: either can flip a
table's winner.

Findings confirm in two phases.  The first median that crosses the
threshold mixes the quiet and the contended regimes (the window straddles
the onset), so it only marks the key suspect and clears its window; the
finding is reported when a window of samples all after the onset crosses
again.  A suspect whose fresh window comes back inside the threshold was a
transient, and the suspicion is dropped.

The detector carries no policy: the controller decides what a finding
does.
"""


from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import tune
from ..tune import _model


def band_of(nbytes: int) -> int:
    """The power-of-two size band a payload falls in (floor)."""
    n = max(int(nbytes), 1)
    return 1 << (n.bit_length() - 1)


class Drift:
    """One finding: (op, band, algo) whose observed median left the
    model's prediction by more than the threshold."""

    __slots__ = ("op", "band", "algo", "nbytes", "observed_s",
                 "predicted_s", "deviation_pct", "samples")

    def __init__(self, op, band, algo, nbytes, observed_s, predicted_s,
                 deviation_pct, samples):
        self.op = op
        self.band = band
        self.algo = algo
        self.nbytes = nbytes            # median payload size in the band
        self.observed_s = observed_s
        self.predicted_s = predicted_s
        self.deviation_pct = deviation_pct
        self.samples = samples

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Drift({self.op}@{self.band} {self.algo}: "
                f"{self.observed_s * 1e6:.0f}us observed vs "
                f"{self.predicted_s * 1e6:.0f}us predicted, "
                f"{self.deviation_pct:+.0f}%)")


class DriftDetector:
    """Rolling per-(op, band, algo) duration windows + the comparison
    against ``model.predict``.

    ``model`` may be ``None`` (no baseline yet): events still
    accumulate, :meth:`drifts` reports nothing, and :meth:`set_model`
    arms the comparison once the controller has a baseline.  Only
    events ``tune._usable_trace_event`` accepts are counted — the same
    filter the offline ``--from-trace`` fit applies, so the detector
    never flags an event class the model could not have learned from
    (shm, per-leg tiers, ops spans)."""

    def __init__(self, model: Optional[_model.CostModel], *,
                 drift_pct: float = 30.0, per_key: int = 64,
                 min_samples: int = 6):
        self.model = model
        self.drift_pct = float(drift_pct)
        self.per_key = max(int(per_key), min_samples)
        self.min_samples = max(int(min_samples), 2)
        #: (op, band, algo) -> deque[(nbytes, dur_s)]
        self._windows: Dict[Tuple[str, int, str], deque] = {}
        #: keys whose first threshold crossing cleared their window —
        #: confirmed (reported) only if a fully fresh window re-crosses
        self._suspect: set = set()
        self.events_seen = 0
        self.events_used = 0

    def set_model(self, model: Optional[_model.CostModel]) -> None:
        self.model = model

    def reset(self) -> None:
        """Forget all samples (a table swap makes the incumbent's
        pre-swap timings stale evidence)."""
        self._windows.clear()
        self._suspect.clear()

    def observe(self, events) -> None:
        """Feed canonical events (obs dump schema)."""
        for ev in events:
            self.events_seen += 1
            usable = tune._usable_trace_event(ev)
            if usable is None:
                continue
            op, nbytes, dur_s = usable
            algo = ev.get("algo")
            key = (op, band_of(nbytes), algo)
            win = self._windows.get(key)
            if win is None:
                win = self._windows[key] = deque(maxlen=self.per_key)
            win.append((int(nbytes), float(dur_s)))
            self.events_used += 1

    def drifts(self) -> List[Drift]:
        """CONFIRMED findings, largest deviation first (empty without a
        model or before any key holds ``min_samples``).

        Stateful: a key's first threshold crossing marks it suspect and
        clears its window instead of reporting (see the module
        docstring) — callers poll this as new events arrive, so a real
        regime change confirms one fresh window later with regime-pure
        medians, while a transient spike clears itself."""
        if self.model is None:
            return []
        out: List[Drift] = []
        crossed = set()
        for key, win in self._windows.items():
            op, band, algo = key
            if len(win) < self.min_samples:
                continue
            med_bytes = int(_model._median([b for b, _ in win]))
            med_dur = _model._median([d for _, d in win])
            pred = self.model.predict(op, med_bytes, algo)
            if pred is None or pred <= 0:
                # the model has never seen this algorithm: there is no
                # prediction to drift from (the candidate build will
                # still learn the fresh samples)
                continue
            dev = (med_dur - pred) / pred * 100.0
            if abs(dev) <= self.drift_pct:
                # a full fresh window back inside the threshold: the
                # suspected onset was a transient, not a regime change
                self._suspect.discard(key)
                continue
            crossed.add(key)
            if key in self._suspect:
                out.append(Drift(op, band, algo, med_bytes, med_dur,
                                 pred, dev, len(win)))
        for key in crossed - self._suspect:
            # phase 1: the window straddles the onset — its median mixes
            # regimes, so it may only arm suspicion, never a finding
            self._suspect.add(key)
            self._windows[key].clear()
        out.sort(key=lambda d: -abs(d.deviation_pct))
        return out

    def window_events(self) -> List[dict]:
        """The held samples re-shaped as minimal canonical events —
        what the controller overlays on the baseline to build a
        candidate model."""
        out = []
        for (op, _band, algo), win in self._windows.items():
            for nbytes, dur_s in win:
                out.append({"name": op, "src": "native", "ts_us": 0.0,
                            "dur_us": dur_s * 1e6, "wait_us": 0.0,
                            "dispatch_us": 0.0, "bytes": nbytes,
                            "peer": -1, "tag": 0, "algo": algo})
        return out
