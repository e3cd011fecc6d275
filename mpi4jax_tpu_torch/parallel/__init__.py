"""The mesh tier's communicators and the parallel layers built on the ops:
``dp``, ``tp``, ``pipeline``, ``ulysses``, ``moe``, ``ring`` and ``halo``
(import them as submodules; ``moe`` is also an attribute, as in the JAX
package)."""

from .mesh import (
    CommBase,
    MeshComm,
    current_comm,
    get_default_comm,
    make_mesh,
    spmd,
)

__all__ = [
    "CommBase",
    "MeshComm",
    "current_comm",
    "get_default_comm",
    "make_mesh",
    "moe",
    "spmd",
]


def __getattr__(name):  # lazy, as in the JAX package
    if name == "moe":
        import importlib

        mod = importlib.import_module(".moe", __name__)
        globals()["moe"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
