"""Reduction operators.

The counterpart of ``mpi4jax_tpu/ops/reduce_ops.py`` on torch tensors.  Each
op carries

- ``kind``: "sum" | "max" | "min" | None, the key into the mesh tier's
  direct paths (SUM through the collective kernels, MAX and MIN as a
  reduction over the rank dimension);
- ``combine(a, b)``, elementwise, used by the prefix-scan ladder;
- ``reduce(stack)``, over the leading dimension of a stack of per-rank
  values, used by the gather-then-reduce path (PROD, bitwise, custom);
- dtype admissibility (logical ops want bools or integers, bitwise ops
  integers) and differentiability (SUM only).

``OP_CODES`` gives the built-in ops' codes on the native transport's wire.

Ops are identified by name, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..utils import dtypes as _dtypes


@dataclass(frozen=True, eq=False)  # eq/hash are name-based, defined below
class ReduceOp:
    name: str
    kind: Optional[str]
    combine: Callable = field(compare=False)
    reduce: Callable = field(compare=False)  # over dim 0 of a stack
    # "any" | "numeric" | "bool" | "integer"
    domain: str = "numeric"
    differentiable: bool = False
    custom: bool = False

    def __repr__(self):
        return f"ReduceOp({self.name})"

    def __hash__(self):
        return hash(("mpi4jax_tpu_torch.ReduceOp", self.name))

    def __eq__(self, other):
        return isinstance(other, ReduceOp) and other.name == self.name

    def check_dtype(self, dtype: torch.dtype):
        name = _dtypes.dtype_name(dtype)
        if self.domain == "numeric" and dtype == torch.bool:
            raise TypeError(
                f"{self!r} is not defined for boolean tensors; use "
                "LAND/LOR/LXOR"
            )
        if self.domain == "integer" and not (
            _dtypes.is_integer(dtype) or dtype == torch.bool
        ):
            raise TypeError(f"{self!r} requires an integer dtype, got {name}")
        if self.domain == "bool" and not (
            dtype == torch.bool or _dtypes.is_integer(dtype)
        ):
            raise TypeError(
                f"{self!r} requires a boolean or integer dtype, got {name}"
            )


def _fold(binop):
    """A stack reduction that folds ``binop`` left to right over dim 0."""

    def run(s):
        acc = s[0]
        for i in range(1, s.shape[0]):
            acc = binop(acc, s[i])
        return acc

    return run


SUM = ReduceOp("SUM", "sum", torch.add, lambda s: torch.sum(s, dim=0),
               differentiable=True)
PROD = ReduceOp("PROD", None, torch.mul, lambda s: torch.prod(s, dim=0))
MAX = ReduceOp("MAX", "max", torch.maximum, lambda s: torch.amax(s, dim=0))
MIN = ReduceOp("MIN", "min", torch.minimum, lambda s: torch.amin(s, dim=0))
LAND = ReduceOp("LAND", None, torch.logical_and,
                lambda s: torch.all(s, dim=0), domain="bool")
LOR = ReduceOp("LOR", None, torch.logical_or,
               lambda s: torch.any(s, dim=0), domain="bool")
LXOR = ReduceOp("LXOR", None, torch.logical_xor,
                lambda s: torch.sum(s.to(torch.int32), dim=0) % 2 == 1,
                domain="bool")
BAND = ReduceOp("BAND", None, torch.bitwise_and,
                _fold(torch.bitwise_and), domain="integer")
BOR = ReduceOp("BOR", None, torch.bitwise_or,
               _fold(torch.bitwise_or), domain="integer")
BXOR = ReduceOp("BXOR", None, torch.bitwise_xor,
                _fold(torch.bitwise_xor), domain="integer")

ALL_OPS = (SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR)
_BY_NAME = {op.name: op for op in ALL_OPS}
#: the native transport's op codes (``TpuOp`` in ``native/tpucomm.h``), in
#: the order of ``ALL_OPS``, as ``mpi4jax_tpu/ops/_world_impl.py:42``
OP_CODES = {op.name: i for i, op in enumerate(ALL_OPS)}
_CUSTOM_REGISTRY: dict = {}  # name -> (combine sig, reduce sig, domain)


def _capture_sig(v):
    """Type-tagged value signature: 2, 2.0 and True are different
    captures."""
    try:
        hash(v)
    except TypeError:
        return (type(v).__name__, id(v))  # unhashable capture: identity
    return (type(v).__name__, v)


def _fn_sig(fn):
    """Best-effort signature of a user callable: code object, closure
    captures and defaults; anything else by identity."""
    if fn is None:
        return None
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn
    cells = []
    for cell in fn.__closure__ or ():
        try:
            v = cell.cell_contents
        except ValueError:  # empty cell
            v = "<empty>"
        cells.append(_capture_sig(v))
    defaults = tuple(_capture_sig(v) for v in fn.__defaults__ or ())
    kwdefaults = tuple(
        (k, _capture_sig(v))
        for k, v in sorted((fn.__kwdefaults__ or {}).items())
    )
    return (code, tuple(cells), defaults, kwdefaults)


def custom_op(name: str, combine: Callable, *, reduce: Callable = None,
              domain: str = "any") -> ReduceOp:
    """A user-defined reduction operator (MPI_Op_create analog).

    ``combine(a, b)`` is an associative, commutative elementwise torch
    function; ``reduce(stack)`` an optional reduction over dim 0 (default:
    a left fold of ``combine``).  The op is identified by ``name``: one name
    may not mean two semantics, and built-in names are refused.  The mesh
    tier runs it as all-gather plus a local fold.  Not differentiable.
    """
    if not isinstance(name, str) or not name:
        raise TypeError(f"custom op name must be a non-empty str: {name!r}")
    if name.upper() in _BY_NAME:
        raise ValueError(
            f"{name!r} is a built-in ReduceOp name; pick a distinct one"
        )
    if domain not in ("any", "numeric", "bool", "integer"):
        raise ValueError(f"unknown domain {domain!r}")
    sig = (_fn_sig(combine), _fn_sig(reduce), domain)
    prior = _CUSTOM_REGISTRY.get(name)
    if prior is not None and prior != sig:
        raise ValueError(
            f"custom op {name!r} already registered with different "
            "semantics (combine/reduce/domain); use a distinct name"
        )
    _CUSTOM_REGISTRY[name] = sig
    return ReduceOp(
        name, None, combine, reduce if reduce is not None else _fold(combine),
        domain=domain, custom=True,
    )


def as_reduce_op(op) -> ReduceOp:
    """Coerce ``op`` (a ReduceOp or a name) to a ReduceOp."""
    if isinstance(op, ReduceOp):
        return op
    if isinstance(op, str) and op.upper() in _BY_NAME:
        return _BY_NAME[op.upper()]
    raise TypeError(
        "expected a mpi4jax_tpu_torch ReduceOp (e.g. mpi4jax_tpu_torch.SUM), "
        f"a custom_op(...), or one of {sorted(_BY_NAME)}, got {op!r}"
    )
