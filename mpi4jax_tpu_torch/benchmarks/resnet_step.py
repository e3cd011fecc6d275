"""The data-parallel ResNet-50 train step on the port (path (h)).

``bench.py``'s ``bench_dp_resnet`` configuration: ResNet-50
(``resnet50_config(dtype="bfloat16")``: bottleneck blocks (3, 4, 6, 3),
1000 classes, the imagenet stem), 224x224 images, a global batch of 32,
SGD at lr 0.05, weights from ``init_params`` at ``--seed`` and normal
images with uniform labels drawn from it.  The batch is cut over ``--ranks``
dp ranks on one card (n = 1 is ``bench.py``'s mesh; n = 4 gives 8 images a
rank), each rank with its replica of the weights, so the step's gradient
sync is one allreduce per leaf (153 leaves) on the hop and fused-ring
kernels, plus the loss's ``pmean``.  After one warm-up step (the kernels'
build), ``--steps`` steps are timed one by one with CUDA events: the step
is bound by the host's launches, so its time moves from step to step and
the record gives the median and the spread.

    python -m mpi4jax_tpu_torch.benchmarks.resnet_step --ranks 4 --json

One JSON line: ``ms_per_step`` (the median step), ``ms_min`` and
``ms_max``, ``images_per_s`` at the median, the reckoned bound
(``bound_ms``: the convolutions' and the head's products of a training
step, three times the forward's, at the bf16 tensor-core peak), the
``losses`` of the timed steps, the hop and fused-ring launches per step
beside what the leaves' allreduce arms give (``expected_launches``),
``ranks`` and ``device``.  ``--profile`` adds the card's kernel time per
step by group; ``--route-check`` holds one step on the kernel route bit
for bit to one on the plain route.  ``--device cpu``
runs the plain versions at the full size; to try the path on the CPU, call
``run`` with a small ``ResNetConfig``, as ``chip_smoke.py --rehearse``
does.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ..models import resnet
from ..ops import _collectives
from ..parallel.mesh import make_mesh
from ..utils import tree as _tree
from ._profile import breakdown, time_each

CFG = resnet.resnet50_config(dtype="bfloat16")
IMAGE, BATCH, LR = 224, 32, 0.05
RANKS = (1, 4)
STEPS = 20
COLLECTIVES = ("hop", "fused_ring")
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores, published


def make_data(batch, image, cfg, seed, device):
    """``(batch, image, image, C)`` f32 normal images and ``(batch,)``
    int32 labels drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, image, image, cfg.in_channels).astype(np.float32)
    y = rng.randint(0, cfg.n_classes, (batch,)).astype(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def counts():
    return {k: _collectives.LAUNCHES[k] for k in COLLECTIVES}


def expected_launches(cfg, ranks) -> dict:
    """Hop and fused-ring launches of one step's sync: one allreduce per
    leaf, on the arm its per-rank count picks, and the loss's ``pmean``
    (one element); the leaves' counts per arm too."""
    leaves = _tree.leaves(resnet.init_params(cfg))
    out = {k: 0 for k in COLLECTIVES}
    arms = {}
    for n in [x.size for x in leaves] + [1]:
        for k, v in _collectives.allreduce_launches(n, ranks).items():
            out[k] += v
        arm = _collectives.allreduce_arm(n, ranks)
        arms[arm] = arms.get(arm, 0) + 1
    out["allreduce_calls"] = len(leaves) + 1
    out["calls_by_arm"] = arms
    return out


def step_flops(cfg, batch, image) -> float:
    """The products of one training step: every convolution's and the
    head's multiply-adds (2 flop each) in the forward, times three
    (forward, the input gradient and the weight gradient)."""
    def conv(hw, k, cin, cout, s):
        ho = -(-hw // s)
        return 2.0 * k * k * cin * cout * ho * ho * batch, ho

    exp = 4 if cfg.block == "bottleneck" else 1
    stem_k, stem_s = (7, 2) if cfg.stem == "imagenet" else (3, 1)
    f, hw = conv(image, stem_k, cfg.in_channels, cfg.widths[0], stem_s)
    if cfg.stem == "imagenet":
        hw = -(-hw // 2)
    cin = cfg.widths[0]
    for si, (depth, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for b in range(depth):
            stride, proj = resnet._block_plan(cfg, si, b, cin)
            cout = width * exp
            if cfg.block == "bottleneck":
                a, _ = conv(hw, 1, cin, width, 1)
                c, ho = conv(hw, 3, width, width, stride)
                d, _ = conv(ho, 1, width, cout, 1)
                parts = a + c + d
            else:
                a, ho = conv(hw, 3, cin, width, stride)
                c, _ = conv(ho, 3, width, width, 1)
                parts = a + c
            if proj:
                parts += conv(hw, 1, cin, cout, stride)[0]
            f += parts
            hw, cin = ho, cout
    f += 2.0 * cin * cfg.n_classes * batch
    return 3.0 * f


def run(ranks=1, steps: int = STEPS, *, cfg=CFG, batch: int = BATCH,
        image: int = IMAGE, device=None, seed: int = 0):
    """One warm-up step and ``steps`` timed ones; returns the record and
    the step's parameters."""
    comm = make_mesh(ranks, device=device)
    dev = comm.device
    params = resnet.params_from_numpy(resnet.init_params(cfg, seed), ranks,
                                      dev)
    x, y = make_data(batch, image, cfg, seed, dev)
    step = resnet.make_dp_train_step(cfg, comm, lr=LR)
    step(params, x, y)  # warm-up: builds and loads the kernels
    before = counts()
    each, losses = time_each(lambda: step(params, x, y)[0], steps, dev)
    ms = float(np.median(each))
    after = counts()
    on_card = dev.type == "cuda"
    flops = step_flops(cfg, batch, image)
    rec = {
        "ms_per_step": ms, "ms_min": min(each), "ms_max": max(each),
        "images_per_s": batch / (ms * 1e-3),
        "bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
        "bound_by": "operations (bf16 tensor-core peak, the convolutions' "
                    "and the head's products x 3)",
        "step_tflop": flops / 1e12,
        "losses": [float(v) for v in losses],
        "launches_per_step": {k: (after[k] - before[k]) / steps
                              for k in after},
        "expected_launches": expected_launches(cfg, ranks),
        "params_M": resnet.param_count(params) / 1e6,
        "leaves": len(_tree.leaves(params)),
        "ranks": ranks, "batch": batch, "image": image,
        "dtype": cfg.dtype, "steps": steps,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    return rec, (step, params, x, y)


def route_check(cfg, ranks, *, batch=BATCH, image=IMAGE, device=None,
                seed: int = 0):
    """One step on the kernel route against one on the plain route
    (``_collectives.use_plain()``) from the same weights and data, with
    ``torch.backends.cudnn.deterministic``: the routes differ only in the
    collectives, which are bit for bit their plain versions, so the loss
    and every updated parameter must be too.  Returns both losses,
    ``bit_equal``, the largest difference and the kernel route's
    launches."""
    comm = make_mesh(ranks, device=device)
    x, y = make_data(batch, image, cfg, seed, comm.device)
    init = resnet.init_params(cfg, seed)
    res = {}
    before_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for route in ("kernel", "plain"):
            params = resnet.params_from_numpy(init, ranks, comm.device)
            step = resnet.make_dp_train_step(cfg, comm, lr=LR)
            before = counts()
            with (_collectives.use_plain() if route == "plain"
                  else contextlib.nullcontext()):
                loss, params = step(params, x, y)
            after = counts()
            res[route] = dict(loss=float(loss),
                              leaves=_tree.leaves(params),
                              launches={k: after[k] - before[k]
                                        for k in after})
    finally:
        torch.backends.cudnn.deterministic = before_det
    k, p = res["kernel"], res["plain"]
    equal = k["loss"] == p["loss"] and all(
        torch.equal(a, b) for a, b in zip(k["leaves"], p["leaves"]))
    diff = max((a.detach() - b.detach()).abs().max().item()
               for a, b in zip(k["leaves"], p["leaves"]))
    return {"loss_kernel": k["loss"], "loss_plain": p["loss"],
            "bit_equal": equal, "max_abs_diff": diff,
            "launches": k["launches"]}


def group(name: str) -> str:
    """A kernel's group: the port's collectives by name, cuDNN's
    convolutions (forward, data and weight gradients), layout
    conversions, reductions (GroupNorm's statistics, the pooled mean), and
    the rest."""
    low = name.lower()
    if "hop_kernel" in low:
        return "hop"
    if "fused_ring" in low:
        return "fused ring"
    if any(k in low for k in ("nchwtonhwc", "nhwctonchw", "transpose")):
        return "layout conversions"
    if any(k in low for k in ("conv", "xmma", "cudnn", "implicit", "wgrad",
                              "dgrad", "fprop", "cutlass", "nvjet", "gemm",
                              "sm90")):
        return "convolutions and matmuls"
    if any(k in low for k in ("reduce", "welford", "norm")):
        return "reductions (GroupNorm statistics)"
    return "elementwise and the rest"


def profile(step_args, steps: int = 2, top: int = 10):
    """The card's kernel time per step by ``group``, the ``top`` kernels,
    and the busy share of the host-timed window."""
    step, params, x, y = step_args
    return breakdown(lambda: step(params, x, y), steps, group, x.device,
                     top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--route-check", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    out, step_args = run(args.ranks, args.steps, device=args.device,
                         seed=args.seed)
    if args.profile:
        out["profile"] = profile(step_args)
    del step_args
    if not args.json:
        print(f"ResNet-50 DP step, {args.ranks} ranks, {out['device']}: "
              f"{out['ms_per_step']:.2f} ms per step (median of "
              f"{args.steps}; {out['ms_min']:.2f}-{out['ms_max']:.2f}), "
              f"{out['images_per_s']:.1f} images/s")
    if args.route_check:
        out["route_check"] = route_check(CFG, args.ranks, device=args.device,
                                         seed=args.seed)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
