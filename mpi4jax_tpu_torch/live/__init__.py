"""Live drift detection and collective re-tuning.

The counterpart of ``mpi4jax_tpu/live/``, its code copied, its formats
(the proposal payload, the epoch header, the status keys) kept.  ``tune``
installs a static decision table at comm creation; this package keeps it
honest at run time.  Under ``MPI4JAX_TPU_LIVE=auto`` (``launch --live``)
a controller thread follows the native event ring through the
non-destructive cursor (``obs/_native.peek``: the end-of-run dump still
sees every event), compares per-(op, size band, algorithm) medians with the
cost model's predictions (``_drift.py``), and on drift past
``MPI4JAX_TPU_LIVE_DRIFT_PCT`` rank 0 refits the model on the window and
proposes a new table when the winners change (``_controller.py``).

Every rank must install a new table at the same collective boundary, or
the ranks dispatch one call with different schedules and the first
mismatched frame aborts the job.  The swap is an epoch rendezvous
(``_swap.py``) on the SPMD invariant: every collective wrapper of
``runtime/bridge.py`` calls the boundary hook once, with its comm's
handle; every ``cooldown // 4``-th world boundary all ranks bcast a
16-byte header from rank 0, and a header with a newer epoch is followed by
the JSON table, which every rank stages and commits there
(``bridge.stage_coll_table``, ``bridge.commit_coll_tables``: the comm lock
held, the progress engine quiesced).

``off`` (the default) installs no hook and starts no thread.  Nothing here
touches torch or the card: the controller thread reads the event ring and
fits numbers, and the rendezvous' bcasts move numpy bytes on the
application's thread.  :func:`propose` is the entry that drives the whole
stage, rendezvous and commit path without waiting for drift.
"""


from __future__ import annotations

import sys
import threading

from ..utils import config
from . import _controller, _drift, _swap  # noqa: F401 (re-export)

_lock = threading.Lock()
_ctrl = None     # the armed Controller (None = disarmed)
_swap_state = None
_retune_requests = 0


def arm(lib, handle, rank: int, size: int) -> bool:
    """Start the controller + boundary hook for one world comm (the
    bridge calls this from ``_post_init_setup`` under
    ``MPI4JAX_TPU_LIVE=auto``).  Returns False — disarmed, loudly —
    when the loaded .so predates the cursor read or the epoch
    plumbing (recording and dispatch keep working, just untuned)."""
    global _ctrl, _swap_state
    from ..obs import _native as obs_native
    from ..runtime import bridge

    disarm()
    if bridge.coll_epoch() is None or not obs_native.peek_available(lib):
        print("[live] native library predates live re-tuning "
              "(tpucomm_obs_peek/tpucomm_coll_epoch missing) — "
              "controller disarmed", file=sys.stderr, flush=True)
        return False
    window = config.live_window()
    cooldown = config.live_cooldown_ops()
    drift_pct = config.live_drift_pct()
    # the controller follows the native ring; when no recording armed
    # it (MPI4JAX_TPU_TRACE / obs.start() ran _install_obs first), arm
    # the ring itself — sized past the window so the cursor outruns
    # overflow.  Never re-enable over an armed recording: that would
    # clear events the end-of-run dump owns.
    from .. import obs

    if not obs.enabled():
        obs_native.enable(lib, max(4 * window, 4096))
    period = max(1, cooldown // 4)
    with _lock:
        _swap_state = _swap.SwapProtocol(bridge, handle, rank, size,
                                         period)
        _ctrl = _controller.Controller(
            lib, handle, rank, size, _swap_state, window=window,
            drift_pct=drift_pct, cooldown_ops=cooldown)
        _swap_state.on_commit = _ctrl.note_commit
    bridge.set_live_boundary(_on_boundary)
    _ctrl.start()
    return True


def disarm(handle=None) -> None:
    """Stop the controller and clear the boundary hook.  ``handle``
    restricts the disarm to that comm's controller (closing an
    unrelated sub-comm must not kill the world's loop)."""
    global _ctrl, _swap_state
    with _lock:
        ctrl, sw = _ctrl, _swap_state
        if ctrl is None:
            return
        if handle is not None and int(handle) != int(sw.handle):
            return
        _ctrl = None
        _swap_state = None
    from ..runtime import bridge

    bridge.set_live_boundary(None)
    ctrl.stop()


def armed() -> bool:
    return _ctrl is not None


def _on_boundary(handle) -> None:
    """The bridge's collective-boundary hook while armed."""
    sw = _swap_state
    if sw is not None:
        sw.on_boundary(handle)


def status() -> dict:
    """One snapshot of the live plane: epoch, boundary count, swap
    history, drift/proposal counters, and the cursor's health — what
    diag and the world programs print."""
    ctrl, sw = _ctrl, _swap_state
    out = {
        "armed": ctrl is not None,
        "retune_requests": _retune_requests,
    }
    if ctrl is None:
        return out
    out.update(ctrl.status())
    out.update({
        "epoch": sw.epoch,
        "boundaries": sw.boundaries,
        "swaps": list(sw.swaps),
    })
    return out


def propose(named_tables, note: str = "manual") -> int:
    """Stage a candidate decision table for the next rendezvous —
    ``{op: [(min_bytes, algo_name), ...], ...}`` — from rank 0 (other
    ranks: a loud no-op returning the current epoch).  The test/tooling
    entry that exercises the full stage -> rendezvous -> quiesced
    commit path without waiting for organic drift.  Returns the epoch
    the proposal will carry."""
    ctrl, sw = _ctrl, _swap_state
    if ctrl is None:
        raise RuntimeError("live.propose() needs an armed controller "
                           "(MPI4JAX_TPU_LIVE=auto)")
    if sw.rank != 0:
        print("[live] propose() ignored off rank 0 (rank 0 is the sole "
              "proposer)", file=sys.stderr, flush=True)
        return sw.epoch
    from .. import tune

    coded = {}
    for op, entries in named_tables.items():
        kind = tune.OP_KIND[op]
        coded[str(kind)] = [[int(mb), int(tune.ALGO_CODES[name])]
                            for mb, name in entries]
    payload = {
        "tables": coded,
        "named": {op: [[int(mb), str(name)] for mb, name in entries]
                  for op, entries in named_tables.items()},
        "report": {"note": str(note), "changes": []},
    }
    return sw.propose(payload)


def request_retune(reason: str = "api") -> None:
    """Poke the controller for an immediate drift evaluation (the SLO
    floor-hit consumer).  Counted even when disarmed, so callers can
    always fire-and-forget."""
    global _retune_requests
    _retune_requests += 1
    ctrl = _ctrl
    if ctrl is not None:
        ctrl.poke(reason)


def consume_retune(scheduler) -> bool:
    """Consume (and RESET) a serving ``SLOController.retune_requested``
    flag, translating it into an immediate drift evaluation.  Returns
    whether a request was consumed — the serving engine calls this
    every step; the flag never sticks."""
    if not getattr(scheduler, "retune_requested", False):
        return False
    scheduler.retune_requested = False
    request_retune("slo-floor")
    return True
