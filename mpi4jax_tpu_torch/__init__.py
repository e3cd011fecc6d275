"""mpi4jax_tpu_torch — the PyTorch/CUDA port of mpi4jax_tpu.

The port lives beside the JAX package and imports nothing of it (nor of
JAX): plain tensor code is PyTorch, and every Pallas kernel of the JAX
package becomes a kernel written by hand for Hopper (``csrc/``), built
with ``nvcc`` at first use (``_build.py``).

Ported so far:

- the mesh tier on one card: ``MeshComm``, ``make_mesh``, ``spmd``,
  ``ProcessGrid``, ``halo_exchange`` and the twelve ops (``allreduce``,
  ``allgather``, ``alltoall``, ``bcast``, ``reduce``, ``gather``,
  ``scatter``, ``scan``, ``sendrecv``, ``barrier``; ``send``, ``recv`` and
  ``neighbor_exchange`` raise on the mesh tier, as in the JAX package),
  whose communication runs on the hop kernel (``csrc/hop.cu``), the fused
  ring allreduce (``csrc/fused_ring.cu``) and the alltoall
  (``csrc/alltoall.cu``) through ``ops/_collectives.py``.  Every rank
  lives on the one device; the rank axes are leading tensor dimensions;
- the shallow-water solver (``models/shallow_water.py``) on any 2-D grid,
  and its fused single-block step kernel (``csrc/sw_step.cu``);
- the slab-decomposed 3-D FFT and Poisson solver
  (``models/spectral.py``), whose transposes ride the alltoall;
- ring attention (``parallel/ring.py``, ``ops/flash.py``): one launch of
  the flash forward kernel (``csrc/flash_fwd.cu``) per ring step for every
  rank, and k and v one hop further between steps (``ring_shift_n``); its
  backward, one launch each of the dq and dk/dv kernels
  (``csrc/flash_bwd.cu``) per step, dk and dv riding the ring home;
- the dp x tp x sp GPT (``models/transformer.py``), whose train step runs
  those three kernels in every layer, and its CLI
  (``examples/train_gpt.py``);
- the parallel layers above the ops (``parallel/``): ``dp`` (the gradient
  sync, per leaf or bucketed), ``tp``, ``pipeline`` (the SPMD GPipe, one
  hop per tick), ``ulysses`` and ``moe`` (their exchanges on the alltoall
  kernel); and ``allreduce(compression="int8")`` on a mesh comm
  (``ops/quantized.py``: one alltoall and one all-gather of int8 rows);
- the pipeline-parallel GPT (``models/pp_transformer.py``, the CLI's
  ``--pp``) and the data-parallel ResNet (``models/resnet.py``) with its
  CLI (``examples/train_resnet.py``);
- the world tier, one process per rank (``runtime/``: the launcher,
  ``WorldComm`` with ``split`` and ``dup``, and the native transport's
  binding; ``tune``: the default decision table that ``algo=None``
  resolves against): every op of the twelve and ``neighbor_exchange`` on
  this rank's tensor, staged through pinned host memory when it lives on
  the card (``ops/_world_impl.py``), with every reduce op and custom op,
  the 15 dtypes, forced ``algo=`` schedules, ``compression="int8"`` on
  the transport's qring/qrd, ``Status``, ``ANY_TAG`` and ``ANY_SOURCE``;
  ``topo/``: discovery, the simulators and the hierarchical allreduce's
  intra-island leg, which folds each island with the fused ring kernel
  and packs the quantized wire frame with ``csrc/quant_pack.cu``;
- the world-tier shallow-water solver
  (``models/shallow_water_world.py``): a rank per block, its halos on
  ``neighbor_exchange``;
- the world alltoall family (``algo="qalltoall"``, ``"halltoall"``,
  ``"hqalltoall"``, ``compression="int8"``) and ``moe_ffn`` on a world
  comm (``parallel/moe.py``);
- observability and tuning on the world tier: ``MPI4JAX_TPU_DEBUG``'s
  debug lines (``utils/tracing.py``), the recorder, stats and Chrome
  traces (``obs/``, ``runtime.launch --trace``, ``python -m
  mpi4jax_tpu_torch.profile``), and the tune layers above the default
  table (the persistent cache, ``set_algorithm``,
  ``MPI4JAX_TPU_COLL_ALGO``; ``python -m mpi4jax_tpu_torch.tune``, also
  ``--from-trace``), each reading and writing the JAX package's formats;
- the token API: ``token=`` on every front, ``create_token``,
  ``explicit_token_ordering`` and ``compat.token_api``'s ``(result,
  token)`` signatures (a token is a 0-d ``uint32`` zero: eager program
  order already orders the ops); the world bootstrap
  (``WorldComm.from_mpi``, the launcher's ``--hosts``,
  ``runtime.distributed``); checkpoints (``utils/checkpoint.py``, files
  either package reads); and the joint tuner (``tune/_model.py``,
  ``tune/_joint.py``, ``python -m mpi4jax_tpu_torch.tune --joint``),
  whose ``+ici`` sub-jobs run the intra-island leg's kernels 3 and 4;
- the static communication verifier (``analysis/``: ``check``,
  ``check_program``, ``plan_for``; ``python -m
  mpi4jax_tpu_torch.analyze``; the launcher's ``--verify``): a program
  runs once per rank as threads of one process, its world ops served in
  memory, and mismatched collectives, unpaired sends and receives,
  deadlocks and forked token chains are reported before any rank starts,
  in the JAX package's report and plan formats.

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``.
"""

from .models.shallow_water import ShallowWater, SWParams, SWState
from .ops import (
    ALL_OPS,
    BAND,
    BOR,
    BXOR,
    LAND,
    LOR,
    LXOR,
    MAX,
    MIN,
    PROD,
    SUM,
    ReduceOp,
    allgather,
    allreduce,
    alltoall,
    barrier,
    bcast,
    create_token,
    custom_op,
    explicit_token_ordering,
    gather,
    neighbor_exchange,
    recv,
    reduce,
    scan,
    scatter,
    send,
    sendrecv,
)
from .parallel.grid import ProcessGrid
from .parallel.halo import halo_exchange
from .parallel.mesh import MeshComm, get_default_comm, make_mesh, spmd
from .parallel.ring import ring_attention
from .runtime.transport import WorldComm
from .utils.status import ANY_SOURCE, ANY_TAG, Status

__version__ = "0.3.0"

__all__ = [
    "ShallowWater", "SWParams", "SWState",
    "MeshComm", "make_mesh", "spmd", "get_default_comm",
    "ProcessGrid", "halo_exchange", "ring_attention",
    "allreduce", "allgather", "alltoall", "bcast", "reduce", "gather",
    "scatter", "scan", "sendrecv", "barrier", "send", "recv",
    "neighbor_exchange", "create_token", "explicit_token_ordering",
    "WorldComm", "Status", "ANY_SOURCE", "ANY_TAG",
    "ReduceOp", "custom_op", "ALL_OPS",
    "SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND", "BOR", "BXOR",
    "__version__",
]
