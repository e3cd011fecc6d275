"""Checkpoint-resumed training across rank failures.

The counterpart of ``mpi4jax_tpu/elastic/training.py``.  Each step of the
job is a function of ``(state, step, comm)``, and the state is checkpointed
through ``utils/checkpoint.py``'s committed sharded writer.  On
:class:`RankFailure` the loop recovers the world (``elastic.recover``),
restores the last committed checkpoint and replays from there: the steps
after the last commit are recomputed on the new world, so the trajectory
goes on as if the job had been restarted from that checkpoint by hand.

The loop never looks inside the state: a tree of tensors synced through
the ops (``parallel.dp.elastic_step_fn``) or numpy arrays synced at the
bridge level serve alike.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Optional

from ..utils import checkpoint
from ._errors import is_rank_failure
from ._world import current_generation, my_slot, recover


def run(step_fn: Callable[[Any, int, Any], Any], init_state: Any, *,
        steps: int, directory: Optional[str] = None, save_every: int = 1,
        comm=None, replicated: bool = True, keep: Optional[int] = 3,
        max_recoveries: Optional[int] = None):
    """Run ``steps`` training steps elastically; returns the final state.

    ``step_fn(state, step, comm) -> state`` must be collective over
    ``comm`` and, for the resumed trajectory to mean anything,
    deterministic given ``(state, step, world size)``.  The state is
    checkpointed every ``save_every`` steps (``step_<k>`` holds the state
    after ``k`` steps), and step 0 is committed first, so a failure before
    the first save still has a restore point.  ``replicated=True`` (every
    rank holds the same state, the DP pattern) lets a restore land on a
    shrunk world; pass False for truly sharded state, which then survives
    ``respawn`` recoveries only.

    On a failure the loop recovers, restores the newest committed
    checkpoint and goes on, at most ``max_recoveries`` times (None: no
    bound but the launcher's generation cap).
    """
    if comm is None:
        from ..runtime import transport

        comm = transport.get_world_comm()
    directory = checkpoint._resolve_dir(directory)

    recoveries = 0

    def bootstrap():
        """Restore the newest committed checkpoint, or commit step 0."""
        try:
            state, start, _ = checkpoint.restore_sharded(
                init_state, directory=directory, comm=comm)
            _log(f"resuming from step {start} "
                 f"(generation {current_generation()})")
            return state, start
        except FileNotFoundError:
            checkpoint.save_sharded(init_state, step=0,
                                    directory=directory, comm=comm,
                                    replicated=replicated, keep=keep)
            return init_state, 0

    # the bootstrap is collective (the step-0 commit barriers), so a rank
    # dying there recovers as a death inside a step would
    while True:
        try:
            state, start = bootstrap()
            break
        except BaseException as e:
            if not is_rank_failure(e):
                raise
            recoveries += 1
            if max_recoveries is not None and recoveries > max_recoveries:
                raise
            _log(f"bootstrap failed ({type(e).__name__}); recovering")
            recover(comm)

    step = start
    while step < steps:
        try:
            state = step_fn(state, step, comm)
            step += 1
            if step % max(int(save_every), 1) == 0 or step == steps:
                checkpoint.save_sharded(state, step=step,
                                        directory=directory, comm=comm,
                                        replicated=replicated, keep=keep)
        except BaseException as e:
            if not is_rank_failure(e):
                raise
            recoveries += 1
            if max_recoveries is not None and recoveries > max_recoveries:
                raise
            _log(f"step {step} failed ({type(e).__name__}); recovering")
            recover(comm)
            state, step, _ = checkpoint.restore_sharded(
                init_state, directory=directory, comm=comm)
            # the launcher's recovery post-mortem greps this line
            _log(f"resuming from step {step} "
                 f"(generation {current_generation()})")
    return state


def _log(msg: str) -> None:
    try:
        slot = my_slot()
    except RuntimeError:
        slot = -1
    print(f"[elastic] slot {slot}: {msg}", file=sys.stderr, flush=True)
