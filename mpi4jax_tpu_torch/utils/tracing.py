"""Debug tracing: per-call entry and exit lines with rank, call id and time.

The counterpart of ``mpi4jax_tpu/utils/tracing.py``.  When enabled
(``MPI4JAX_TPU_DEBUG=1`` or :func:`set_logging`), every communicating call
writes

    r<rank> | <id8> | <Op> <details>
    r<rank> | <id8> | <Op> done with code 0 (<dt> s)

to **stderr**, one atomic ``write`` per line (stdout belongs to programs'
own output, and a whole line per write keeps the ranks' lines from
interleaving).  The native transport writes the same format for its own
calls (``tpucomm_set_logging``, armed by ``runtime/bridge.py``).

The world tier logs from the host around each staged op: :class:`CallTrace`
wraps the whole call as the caller sees it, the staging to pinned memory,
the native call and the copy back (``ops/_world_impl.py``).  The JAX mesh
tier logs at execution time through ``jax.debug.callback``; eager torch has
no host callback inside a launch to hang that on, so the port's mesh tier
logs at the front's call instead (:func:`trace_mesh_op`, called by the op
fronts, ``ops/*.py``): one line per rank of the mesh, at the time the call
is issued, before its kernels run.

``CallTrace`` also feeds the observability recorder (``obs/``) when it is
armed: every traced op becomes a span with its peer, bytes, tag and
algorithm, whether or not the debug lines are on.  Disabled, it costs one
global read for the recorder and one for the debug flag
(``MPI4JAX_TPU_DEBUG`` is read once, at the first traced call).
"""

from __future__ import annotations

import itertools
import sys
import time

from . import config

_PRINT_DEBUG = None  # set_logging's value, else the knob's, read once


def set_logging(enabled: bool) -> None:
    global _PRINT_DEBUG
    _PRINT_DEBUG = bool(enabled)


def logging_enabled() -> bool:
    """``set_logging``'s value, else ``MPI4JAX_TPU_DEBUG`` as read at the
    first traced call (once a process, as the transport reads it once:
    parsing the environment on every op would cost microseconds a call)."""
    global _PRINT_DEBUG
    if _PRINT_DEBUG is None:
        _PRINT_DEBUG = config.debug_enabled()
    return _PRINT_DEBUG


# a per-process counter: the 8-hex-digit ids count up
_CALL_COUNTER = itertools.count()


def new_call_id() -> str:
    return f"{next(_CALL_COUNTER) & 0xFFFFFFFF:08x}"


def log_line(rank, call_id: str, message: str) -> None:
    # one write per line: atomic up to PIPE_BUF, so ranks sharing the
    # launcher's stderr cannot interleave mid-line
    sys.stderr.write(f"r{rank} | {call_id} | {message}\n")
    sys.stderr.flush()


_obs_state = None  # obs._recorder, bound on the first traced call


def _obs_enabled() -> bool:
    global _obs_state
    if _obs_state is None:
        from ..obs import _recorder

        _obs_state = _recorder
    return _obs_state._ENABLED


class CallTrace:
    """Context manager around one world-tier op.

    ``details`` may be a zero-argument callable, evaluated only when the
    debug lines are on.  ``peer``/``nbytes``/``tag``/``algo`` label the
    recorded span when the recorder is armed; they are not written into
    the debug lines."""

    __slots__ = ("rank", "opname", "details", "call_id", "peer", "nbytes",
                 "tag", "algo", "_t0", "_t0_unix", "_log", "_obs")

    def __init__(self, rank: int, opname: str, details="", *, peer=-1,
                 nbytes=0, tag=0, algo=None):
        self.rank = rank
        self.opname = opname
        self.details = details
        self.peer = peer
        self.nbytes = nbytes
        self.tag = tag
        self.algo = algo

    def __enter__(self):
        self._log = logging_enabled()
        self._obs = _obs_enabled()
        if self._log:
            self.call_id = new_call_id()
            details = self.details() if callable(self.details) \
                else self.details
            log_line(self.rank, self.call_id,
                     f"{self.opname} {details}".rstrip())
        if self._log or self._obs:
            if self._obs:
                self._t0_unix = time.time()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and (self._log or self._obs):
            dt = time.perf_counter() - self._t0
            if self._log:
                log_line(self.rank, self.call_id,
                         f"{self.opname} done with code 0 ({dt:.6f} s)")
            if self._obs:
                _obs_state.record_span(
                    self.opname, self._t0_unix, dt, peer=self.peer,
                    nbytes=self.nbytes, tag=self.tag, algo=self.algo)
        return False


def trace_mesh_op(comm, opname: str, details: str = "") -> None:
    """The mesh tier's debug line, one per rank of ``comm``, written when
    the front is called (see the module docstring)."""
    if not logging_enabled():
        return
    call_id = new_call_id()
    for r in range(comm.size()):
        log_line(r, call_id, f"{opname} {details}".rstrip())
