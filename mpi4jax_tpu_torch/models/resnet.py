"""Data-parallel residual CNN (the gradient-allreduce training model).

The counterpart of ``mpi4jax_tpu/models/resnet.py`` (BASELINE.md's
"Data-parallel ResNet-50 grad allreduce"): the same configurations, the
same initial parameters, the same forward pass, trained data-parallel with
the allreduce-synced gradients of ``parallel/dp.py``.

Parameters are the JAX package's tree (dicts, lists and ``(scale, bias)``
tuples, ``None`` for a block without a projection) with convolution
weights kept HWIO, as there, and turned into PyTorch's OIHW at each use.
Every leaf holds one replica per rank, ``(R, ...)``, so that autograd gives
each rank its own gradient (``dp`` then syncs them on the collectives).
Images come in NHWC per rank, ``(R, B, H, W, C)``, as the JAX model takes
them; inside, activations are NCHW.  Convolutions are ``F.conv2d`` (the
JAX package leaves them to XLA, outside any Pallas kernel), in the compute
dtype with the weights cast per use; the master weights, the update, the
pooled mean and the head are f32.

Two details of the JAX model need care here:

- ``"SAME"`` padding is asymmetric at stride 2 on even sizes (the 7x7/2
  stem pads 2 before and 3 after, a 3x3/2 0 and 1), so such a convolution
  pads explicitly first;
- the imagenet stem's pool is a depthwise 3x3/2 convolution with the
  constant ``1/9`` in the compute dtype and SAME padding: the zeros of the
  padding count, and the divisor is always 9.

The ranks' replicas run side by side on one card: activations are ``(B,
R, C, H, W)``, the ranks folded into the channels, so each convolution is
one grouped ``F.conv2d`` (``groups=R``) and each GroupNorm one
``F.group_norm`` over ``R x groups`` groups.  That was 1.05-1.65x faster
on the H100 at path (h)'s n = 4 than a loop of one convolution per rank
(PERF.md section 5); the tests hold each rank to the same rank run alone.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import dp
from ..utils import tree as _tree
from ..utils.device import resolve_device

class ResNetConfig(NamedTuple):
    stages: Sequence[int] = (2, 2, 2, 2)   # blocks per stage (ResNet-18)
    widths: Sequence[int] = (64, 128, 256, 512)
    n_classes: int = 10
    in_channels: int = 3
    groups: int = 8
    block: str = "basic"  # or "bottleneck": 1x1 -> 3x3 -> 1x1, 4x wider
    dtype: str = "float32"  # the convolutions' compute dtype
    stem: str = "small"  # or "imagenet": 7x7/2 conv + 3x3/2 average pool


def _expansion(cfg: ResNetConfig) -> int:
    return 4 if cfg.block == "bottleneck" else 1


def resnet50_config(**overrides) -> ResNetConfig:
    """ResNet-50: bottleneck blocks (3, 4, 6, 3), 1000 classes, the
    imagenet stem."""
    base = dict(stages=(3, 4, 6, 3), block="bottleneck", n_classes=1000,
                stem="imagenet")
    base.update(overrides)
    return ResNetConfig(**base)


def _block_plan(cfg: ResNetConfig, stage: int, block: int, cin: int):
    """A block's stride and whether it needs a projection."""
    width = cfg.widths[stage] * _expansion(cfg)
    stride = 2 if (block == 0 and stage > 0) else 1
    return stride, (cin != width or stride > 1)


def init_params(cfg: ResNetConfig, seed: int = 0):
    """The JAX package's initial parameters as float32 numpy arrays: the
    same draws from ``np.random.RandomState(seed)`` in the same order (the
    stem, the head, then each block's convolutions)."""
    rng = np.random.RandomState(seed)

    def conv_w(k, cin, cout):
        fan = k * k * cin
        return (rng.randn(k, k, cin, cout) * np.sqrt(2.0 / fan)).astype(
            np.float32)

    def gn(c):
        return (np.ones(c, np.float32), np.zeros(c, np.float32))

    exp = _expansion(cfg)
    stem_k = 7 if cfg.stem == "imagenet" else 3
    params = {
        "stem": conv_w(stem_k, cfg.in_channels, cfg.widths[0]),
        "stem_gn": gn(cfg.widths[0]),
        "stages": [],
        "head": (rng.randn(cfg.widths[-1] * exp, cfg.n_classes)
                 * 0.01).astype(np.float32),
        "head_b": np.zeros(cfg.n_classes, np.float32),
    }
    cin = cfg.widths[0]
    for si, (depth, width) in enumerate(zip(cfg.stages, cfg.widths)):
        blocks = []
        for b in range(depth):
            _, has_proj = _block_plan(cfg, si, b, cin)
            cout = width * exp
            if cfg.block == "bottleneck":
                blk = {
                    "conv1": conv_w(1, cin, width), "gn1": gn(width),
                    "conv2": conv_w(3, width, width), "gn2": gn(width),
                    "conv3": conv_w(1, width, cout), "gn3": gn(cout),
                    "proj": conv_w(1, cin, cout) if has_proj else None,
                }
            else:
                blk = {
                    "conv1": conv_w(3, cin, width), "gn1": gn(width),
                    "conv2": conv_w(3, width, width), "gn2": gn(width),
                    "proj": conv_w(1, cin, cout) if has_proj else None,
                }
            blocks.append(blk)
            cin = cout
        params["stages"].append(blocks)
    return params


def params_from_numpy(params, ranks: int = 1, device=None):
    """A parameter tree of array-likes (the JAX package's through
    ``np.asarray``, or ``init_params``'s) as float32 tensors on ``device``
    (default ``cuda:0``), one replica per rank, ``(ranks, ...)``, each a
    leaf that requires grad; ``None`` stays ``None``."""
    dev = resolve_device(device)

    def one(x):
        x = x.detach().cpu() if isinstance(x, torch.Tensor) else x
        t = torch.tensor(np.asarray(x, np.float32), device=dev)
        return t[None].expand(ranks, *t.shape).contiguous().requires_grad_()

    return _tree.tree_map(one, params)


def global_params(params):
    """Rank 0's replica of every leaf, detached."""
    return _tree.tree_map(lambda x: x.detach()[0], params)


def param_count(params) -> int:
    """The parameters of one replica."""
    return sum(x[0].numel() for x in _tree.leaves(params))


def _same_pads(size: int, k: int, s: int):
    """XLA's ``"SAME"`` padding of one dimension: ``(before, after)``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad(x, k, stride):
    """``x`` ``(N, C, H, W)`` and the symmetric padding for conv2d;
    asymmetric SAME padding is applied here."""
    (ht, hb), (wl, wr) = (_same_pads(x.shape[-2], k, stride),
                          _same_pads(x.shape[-1], k, stride))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb)), (0, 0)


def _conv(h, w, stride=1):
    """SAME convolution of each rank's activations ``(B, R, C, H, W)``
    with its HWIO weight ``w`` ``(R, kh, kw, cin, cout)``, in ``h``'s
    dtype: one convolution with ``groups=R``."""
    k, cout = w.shape[1], w.shape[4]
    wt = w.permute(0, 4, 3, 1, 2).to(h.dtype,
                                     memory_format=torch.contiguous_format)
    b, r, c, hh, ww = h.shape
    x, pad = _pad(h.reshape(b, r * c, hh, ww), k, stride)
    y = F.conv2d(x, wt.reshape(r * cout, c, k, k), stride=stride,
                 padding=pad, groups=r)
    return y.reshape(b, r, cout, *y.shape[-2:])


def _pool(h):
    """The stem's 3x3/2 average pool: a depthwise convolution with the
    constant 1/9 in ``h``'s dtype, SAME padding."""
    b, r, c, hh, ww = h.shape
    kern = torch.full((c, 1, 3, 3), 1.0 / 9.0, dtype=h.dtype,
                      device=h.device)
    x, pad = _pad(h.reshape(b * r, c, hh, ww), 3, 2)
    y = F.conv2d(x, kern, stride=2, padding=pad, groups=c)
    return y.reshape(b, r, c, *y.shape[-2:])


def _groupnorm(h, scale, bias, groups):
    """GroupNorm in f32 over ``min(groups, C)`` groups of contiguous
    channels of each rank's images, population variance, eps 1e-5, the
    per-rank affine ``(R, C)`` (``F.group_norm`` over each rank's groups
    side by side), then the cast back to ``h``'s dtype."""
    b, r, c, hh, ww = h.shape
    y = F.group_norm(h.float().reshape(b, r * c, hh, ww),
                     r * min(groups, c), scale.reshape(-1),
                     bias.reshape(-1), eps=1e-5)
    return y.reshape(h.shape).to(h.dtype)


def forward(params, x, cfg: ResNetConfig):
    """Each rank's logits ``(R, B, n_classes)`` in f32 from its images
    ``(R, B, H, W, C)`` NHWC and its replica of the parameters."""
    g = cfg.groups
    dt = getattr(torch, cfg.dtype)
    h = x.to(dt).permute(1, 0, 4, 2, 3).contiguous()
    stem_stride = 2 if cfg.stem == "imagenet" else 1
    h = torch.relu(_groupnorm(_conv(h, params["stem"], stem_stride),
                              *params["stem_gn"], g))
    if cfg.stem == "imagenet":
        h = _pool(h)
    cin = cfg.widths[0]
    exp = _expansion(cfg)
    for si, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            stride, _ = _block_plan(cfg, si, b, cin)
            if cfg.block == "bottleneck":
                y = torch.relu(_groupnorm(_conv(h, blk["conv1"]),
                                          *blk["gn1"], g))
                y = torch.relu(_groupnorm(
                    _conv(y, blk["conv2"], stride), *blk["gn2"], g))
                y = _groupnorm(_conv(y, blk["conv3"]), *blk["gn3"], g)
            else:
                y = _conv(h, blk["conv1"], stride)
                y = torch.relu(_groupnorm(y, *blk["gn1"], g))
                y = _groupnorm(_conv(y, blk["conv2"]), *blk["gn2"], g)
            skip = h
            if blk["proj"] is not None:
                skip = _conv(h, blk["proj"], stride)
            h = torch.relu(y + skip)
            cin = cfg.widths[si] * exp
    pooled = h.float().mean((3, 4)).transpose(0, 1)
    return torch.matmul(pooled, params["head"]) + params["head_b"][:, None]


def make_dp_train_step(cfg: ResNetConfig, comm, lr=1e-2):
    """The DP training step of the JAX package's ``make_dp_train_step``:
    ``step(params, images, labels) -> (loss, params)`` with global
    ``(B, H, W, C)`` images and ``(B,)`` labels cut into the ranks' shards
    in order, each rank's mean NLL, ``dp.value_and_synced_grad`` over
    ``comm`` (a 1-D mesh comm; ``params`` from ``params_from_numpy`` with
    one replica per rank), then SGD in place, ``p - lr g``.  Returns rank
    0's mean loss over the ranks and ``params``."""
    r = comm.size()

    def local_loss(params, xb, yb):
        logits = forward(params, xb, cfg)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, yb[..., None].long())[..., 0].mean(-1)

    grad_fn = dp.value_and_synced_grad(local_loss, comm=comm)

    def step(params, images, labels):
        b = images.shape[0]
        if b % r:
            raise ValueError(f"batch {b} does not split over {r} ranks")
        xb = images.reshape(r, b // r, *images.shape[1:])
        yb = labels.reshape(r, b // r)
        loss, grads = grad_fn(params, xb, yb)
        with torch.no_grad():
            _tree.tree_map(lambda p, g: p.sub_(lr * g), params, grads)
        return loss[0], params

    return step
