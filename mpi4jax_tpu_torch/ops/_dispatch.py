"""Token threading shared by the op fronts.

The counterpart of ``mpi4jax_tpu/ops/_dispatch.py`` (``:43-105``).  The
primary API is tokenless on both tiers; every front also takes ``token=``
for the reference's signatures (``compat/token_api.py``): with a token it
returns ``(result, token)``, or the token alone for ``send`` and
``barrier``.

The port runs eagerly, so program order already orders the ops of one
rank, and the stream orders their launches: a token carries no data and
adds no edge that the program does not have.  It is a 0-d ``uint32`` zero
on the comm's device, the JAX package's token dtype.  Threading it never
touches the op's inputs or result, so a tokened call gives bit for bit the
tokenless call's result, launches the same kernels, and keeps autograd.
Under the static verifier (``analysis/``) the tokens of
``explicit_token_ordering`` feed its chain guard
(``_world_impl.chain_token``).
"""

from __future__ import annotations

import torch

#: the JAX package's token dtype (``jnp.zeros((), jnp.uint32)``)
TOKEN_DTYPE = torch.uint32


def _device_of(x=None, comm=None):
    if isinstance(x, torch.Tensor):
        return x.device
    if comm is not None:
        return comm.device
    from ..parallel.mesh import get_default_comm

    return get_default_comm().device


def create_token(x=None, *, comm=None):
    """A fresh ordering token: a 0-d ``uint32`` zero on ``x``'s device (or
    the comm's, or the ambient comm's).  ``x`` only places it: in eager
    order every earlier op on ``x`` has already been issued.  Under the
    static verifier the chain guard notes a bare token as fresh (one tied
    to ``x`` roots a new chain), as in the JAX package (``:43-57`` there)."""
    token = torch.zeros((), dtype=TOKEN_DTYPE, device=_device_of(x, comm))
    if x is None:
        from . import _world_impl

        _world_impl._chain_guard.note_fresh(token)
    return token


def attach(result, token):
    """What a front returns: ``result`` without a token, else ``(result,
    token)``.  The token passes through unchanged: the op was issued after
    whatever produced it, and a later op is issued after this one.  The
    JAX package's ``token_in``/``token_out``/``maybe_tokenized`` have no
    work to do here, so the port has none of them."""
    if token is None:
        return result
    return result, token


def attach_world(result, token, comm):
    """``attach`` for a world-tier front: the chain guard sees the op
    first (``_world_impl.chain_token``), which under the static verifier
    may hand back a new token."""
    from . import _world_impl

    return attach(result, _world_impl.chain_token(comm, token))


def check_token(token):
    """A token is a tensor (``create_token()``); anything else raises
    ``TypeError`` before the op runs, as a non-array token does in the
    JAX package's ``lax.optimization_barrier``."""
    if token is not None and not isinstance(token, torch.Tensor):
        raise TypeError(f"token must be a token tensor (create_token()), "
                        f"got {type(token).__name__}")
