"""Schedule extraction for ``check(fn)``: run a function once per rank.

The counterpart of ``mpi4jax_tpu/analysis/_schedule.py``, which traces
``fn`` to a closed jaxpr per rank and walks it.  Torch has no jaxpr: here
``fn`` runs once per rank in a virtual session (``_sim.VirtualWorld``: one
thread per rank, real values built from the caller's arguments, each rank
its own copy), and every world op is recorded as the rank issues it.  Loops
are unrolled by running them and the branch taken is the one that runs,
so the JAX analyzer's ``control_divergence`` and ``comm_in_while`` never
fire here (they stay in ``FINDING_KINDS``, so reports stay compatible).

On top of the schedule, the **true data dependence** the schedule compiler
(``_plan``) must keep: the pairs ``(producer_pos, consumer_pos)`` where the
consumer's payload was computed from the producer's output, as the JAX
extractor reads them off the jaxpr's use/def chains.  A
``torch.overrides.TorchFunctionMode`` on each rank thread carries a set of
producer positions through every torch call:

- a result takes the union of its tensor operands' sets; a world op's
  result takes its payload's set plus its own position;
- the sets live on *storages*, and only ever grow: a view shares its
  base's set, and an in-place op (``add_``, ``__setitem__``, ``out=``)
  adds its operands' sets to the tensor it writes, so no label is dropped;
- a tensor whose provenance was never seen (one that autograd made, say)
  takes every event of its rank so far: a missing data edge would let a
  plan reorder what the program orders, an extra one costs only overlap.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode

from ._fake import AbstractComm
from ._sim import VirtualWorld


def _tensors(obj):
    """Every tensor in a (nested) argument or result structure."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


#: getters whose result is not a view of the tensor read (autograd made
#: ``.grad``): their result keeps no label, so its provenance is unknown
_NOT_A_VIEW = frozenset({torch.Tensor.grad.__get__})


def _writes_in_place(func, kwargs) -> bool:
    name = getattr(func, "__name__", "") or ""
    return ("out" in kwargs or (name.endswith("_") and not
                                name.endswith("__"))
            or name.startswith("__i") or name == "__setitem__")


class _Labels:
    """One rank's producer sets, keyed by storage."""

    def __init__(self):
        self.sets: Dict[Tuple, frozenset] = {}
        # the storages stay alive for the run, so an address is never
        # reused by another storage within it
        self._keep: List = []

    @staticmethod
    def _key(t: torch.Tensor):
        storage = t.untyped_storage()
        ptr = storage.data_ptr()
        if ptr == 0:  # an empty tensor carries no data
            return None, None
        return (t.device.type, t.device.index, ptr, storage.nbytes()), \
            storage

    def deps(self, t: torch.Tensor, unknown: frozenset) -> frozenset:
        key, _ = self._key(t)
        if key is None:
            return frozenset()
        return self.sets.get(key, unknown)

    def add(self, t: torch.Tensor, deps: frozenset) -> None:
        key, storage = self._key(t)
        if key is None:
            return
        old = self.sets.get(key)
        if old is None:
            self._keep.append(storage)
            self.sets[key] = deps
        elif not deps <= old:
            self.sets[key] = old | deps

    def set(self, t: torch.Tensor, deps: frozenset) -> None:
        key, storage = self._key(t)
        if key is None:
            return
        if key not in self.sets:
            self._keep.append(storage)
        self.sets[key] = deps


class _ProvenanceMode(TorchFunctionMode):
    """Carries producer sets through every torch call on one rank
    thread (paused while the executor builds an op's result)."""

    def __init__(self, labels: _Labels, seen):
        super().__init__()
        self.labels = labels
        self.seen = seen      # () -> frozenset of this rank's events
        self.paused = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        unknown = None
        ins = frozenset()
        for t in _tensors((args, kwargs)):
            if unknown is None:
                unknown = self.seen()
            ins = ins | self.labels.deps(t, unknown)
        out = func(*args, **kwargs)
        if func in _NOT_A_VIEW:
            return out
        for t in _tensors(out):
            self.labels.add(t, ins)
        if ins and _writes_in_place(func, kwargs):
            for t in _tensors((args[:1], kwargs.get("out"))):
                self.labels.add(t, ins)
        return out


class FunctionWorld(VirtualWorld):
    """A virtual session that runs ``fn`` (not a program file) on every
    rank and records each rank's schedule and data dependence.  As the
    JAX package's ``check``, a ``split``/``dup`` inside it raises: a
    function's membership questions belong to ``check_program``."""

    def __init__(self, fn, args, kwargs, size, takes_comm):
        code = getattr(fn, "__code__", None)
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.takes_comm = takes_comm
        super().__init__(size, None)
        # sites name the function's own file
        if code is not None:
            self.program = code.co_filename
        self.labels = {r: _Labels() for r in range(self.size)}
        self.value_deps = {r: set() for r in range(self.size)}
        self.results = {}       # rank -> fn's return value
        self._modes = {}        # thread ident -> _ProvenanceMode
        dev = next((a.device for a in _tensors((args, kwargs))), None)
        self.device = dev

    def _rank_comm(self, rank):
        return AbstractComm(rank, self.size, key=(0,),
                            members=tuple(range(self.size)), session=self,
                            device=self.device)

    def split_collective(self, comm, color, key, _dup=False):
        raise NotImplementedError(
            "comm.split()/dup() inside analysis.check() is not supported: "
            "a split's membership depends on every rank's color.  Analyze "
            "the full program instead: python -m "
            "mpi4jax_tpu_torch.analyze prog.py --np N")

    def _seen(self, rank):
        return lambda: frozenset(range(len(self.schedules[rank])))

    def run_op(self, name, data, comm, **params):
        labels = self.labels[comm.members[comm.rank()]]
        mode = self._modes.get(threading.get_ident())
        if mode is not None:
            mode.paused += 1
        try:
            event = self._record(name, data, comm, params)
            epos = event.idx
            ins = frozenset() if data is None else labels.deps(
                data, frozenset(range(epos)))
            out = self._serve(event, comm, data, params)
        finally:
            if mode is not None:
                mode.paused -= 1
        self.value_deps[event.rank].update((d, epos) for d in ins)
        if out is not None:
            labels.set(out, ins | {epos})
        return out

    def _body(self, rank, comm):
        args = tuple(_copy(a) for a in self.args)
        kwargs = {k: _copy(v) for k, v in self.kwargs.items()}
        if self.takes_comm:
            kwargs["comm"] = comm
        labels = self.labels[rank]
        for t in _tensors((args, kwargs)):
            labels.set(t, frozenset())
        mode = _ProvenanceMode(labels, self._seen(rank))
        self._modes[threading.get_ident()] = mode
        with mode:
            self.results[rank] = self.fn(*args, **kwargs)

    def trace(self):
        self._run_ranks(self._body, [self.program])


def _copy(value):
    if isinstance(value, torch.Tensor):
        out = value.detach().clone()
        return out.requires_grad_(value.requires_grad)
    return value


def trace_rank_schedules(fn, args, kwargs, world_size: int,
                         takes_comm: bool = False) -> FunctionWorld:
    """Run ``fn`` once per rank of a virtual world of ``world_size``; the
    returned session holds each rank's events (``schedules``), the
    findings of the run itself (``findings``: the chain guard's
    ``token_violation``, a rank's ``rank_error``, and, when the run had to
    stop, the matcher's verdict that stopped it), each rank's true data
    dependence pairs (``value_deps``), ``fn``'s return value on each rank
    (``results``) and whether the run stopped early (``aborted``: then the
    schedules end where the ranks stopped)."""
    world = FunctionWorld(fn, args, kwargs, world_size, takes_comm)
    world.trace()
    return world
