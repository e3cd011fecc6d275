"""mpi4jax_tpu_torch — the PyTorch/CUDA port of mpi4jax_tpu.

The port lives beside the JAX package and imports nothing of it (nor of
JAX): plain tensor code is PyTorch, and every Pallas kernel of the JAX
package becomes a kernel written by hand for Hopper (``csrc/``), built
with ``nvcc`` at first use (``_build.py``).

Ported so far: the single-block shallow-water solver
(``models/shallow_water.py``) and its fused-step kernel
(``models/_sw_kernel.py`` around ``csrc/sw_step.cu``).  Entry points run
on the card (``cuda:0``) unless the caller passes ``device="cpu"``.
"""

from .models.shallow_water import ShallowWater, SWParams, SWState

__version__ = "0.1.0"

__all__ = ["ShallowWater", "SWParams", "SWState", "__version__"]
