"""The failure type elastic recovery is built around (stdlib only).

The counterpart of ``mpi4jax_tpu/elastic/_errors.py``.
"""

from __future__ import annotations


class RankFailure(RuntimeError):
    """A world-tier transport operation failed because a peer died, hung
    past its deadline, or aborted.

    Raised by the bridge's abort path when ``MPI4JAX_TPU_ELASTIC`` is set
    (otherwise the bridge prints and exits the process, as before).  By the
    time this surfaces, every peer socket has been poisoned and shut down:
    the old communicator is unusable and every surviving rank is unblocking
    toward its own :func:`mpi4jax_tpu_torch.elastic.recover` call.  ``op``
    names the transport entry that failed.
    """

    def __init__(self, message: str, *, op: str = "?"):
        super().__init__(message)
        self.op = op


def is_rank_failure(exc: BaseException) -> bool:
    """True when ``exc`` is, wraps, or was caused by a :class:`RankFailure`.

    The cause and context chains are walked; a string probe backs the walk
    for a failure that reached the caller as text (in the JAX package, a
    host callback's error inside a compiled program): a transport failure
    string in elastic mode has one meaning.
    """
    seen = set()
    stack = [exc]
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, RankFailure):
            return True
        stack.extend((e.__cause__, e.__context__))
    text = f"{type(exc).__name__}: {exc}"
    return "RankFailure" in text or "tpucomm_" in text
