"""``python -m mpi4jax_tpu_torch.analyze`` — static communication verifier
CLI.

Thin entry point; the implementation lives in
:mod:`mpi4jax_tpu_torch.analysis._cli`.
"""

import sys

from .analysis import _cli

if __name__ == "__main__":
    sys.exit(_cli.main())
