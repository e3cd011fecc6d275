"""Elastic worlds: surviving a dead rank instead of dying with it.

The counterpart of ``mpi4jax_tpu/elastic/``, on the port's world tier:

- with ``MPI4JAX_TPU_ELASTIC`` set (``launch --elastic`` sets it), a
  transport failure raises :class:`RankFailure` after poisoning every peer,
  so the whole group unblocks and reaches its own recovery point, instead
  of exiting the process;
- :func:`recover` waits for the elastic launcher's next *generation*
  announcement (the survivors, their dense renumbering, a re-derived port
  block), rebuilds the native comm over the survivors through
  ``tpucomm_shrink`` (``runtime/bridge.py:rebuild``) and rebinds the
  process's ``WorldComm`` in place, so every reference keeps working;
- :mod:`~mpi4jax_tpu_torch.elastic.training` runs a checkpoint-resumed
  training loop across recoveries (``utils/checkpoint.py``'s committed
  sharded checkpoints); :mod:`~mpi4jax_tpu_torch.elastic.serving` is the
  toy continuous-batching plane that keeps answering requests across a
  worker's death.

Everything is deterministic under ``MPI4JAX_TPU_FAULT``, the native fault
injector, which is how the tests drive it.
"""

from ._errors import RankFailure, is_rank_failure  # noqa: F401
from ._world import (  # noqa: F401
    Recovery,
    current_generation,
    my_slot,
    read_generation,
    recover,
    wait_for_generation,
)
from . import serving, training  # noqa: F401

__all__ = [
    "RankFailure",
    "Recovery",
    "current_generation",
    "is_rank_failure",
    "my_slot",
    "read_generation",
    "recover",
    "serving",
    "training",
    "wait_for_generation",
]
