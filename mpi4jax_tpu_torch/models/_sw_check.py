"""How the fused-step kernel is held against its plain version.

``chip_smoke.py`` and the tests compare ``_sw_kernel.fused_step`` with
``fused_step_plain`` on the states made here, at the tolerance stated here.

The states.  The solver's own initial condition is a smooth jet: on it the
viscous pass moves u by less than one f32 ulp, and a tile window one cell
too shallow gives the same bits as a deep one, so a kernel that dropped
the viscous pass or shrank its halo would pass.  ``check_state`` adds
uniform grid-scale noise (from a seed) to h, u and v, which drives every
stencil term at every cell, and ``StiffParams`` raises the lateral
viscosity 1000-fold (still 60x inside the explicit scheme's stability
limit), so that the viscous pass moves u and v by a tenth or more of the
step's whole change.

The tolerance.  Per field, ``max|kernel - plain|`` over a scale: for h, u
and v the largest change the plain version made to the field in this call,
for dh, du and dv the largest value.  The kernel and the plain version
round differently (nvcc contracts multiply-adds into FMAs).  On an H100
the largest difference was 1.26e-5 of the scale (one ulp of u at the Euler
step, 1800x3600; ``chip_smoke.py``), and f32 against f64 rounding of the
plain version on these states is at most 1.54e-5 of the scale (CPU).
``CHECK_TOL`` is 16x the first and 15x below the smallest error of three
broken kernels emulated on the CPU from 16x32 to 128x256: one cell of halo
per step instead of two (3.1e-3), no viscous pass (0.42), and a 1% error in
the flux divergence (1.7e-2).
"""

from __future__ import annotations

import numpy as np
import torch

from .shallow_water import ShallowWater, SWParams, SWState

CHECK_TOL = 2e-4
NOISE = (0.5, 1.0, 1.0)  # amplitude of the noise on h (m), u and v (m/s)
VISCOSITY_SCALE = 1000.0


class StiffParams(SWParams):
    """``SWParams`` with ``VISCOSITY_SCALE`` times the lateral viscosity."""

    __slots__ = ()

    @property
    def viscosity(self) -> float:
        return VISCOSITY_SCALE * super().viscosity


def check_state(model: ShallowWater, seed: int) -> SWState:
    """The model's initial state with uniform noise of amplitude ``NOISE``
    on the interior of h, u and v; ghost columns and the wall are restored
    by the model's exchange."""
    s = model.init()
    rng = np.random.default_rng(seed)
    noisy = []
    for field, amp in zip(s[:3], NOISE):
        noise = rng.uniform(-amp, amp, (model.ny, model.nx))
        field = field.clone()
        field[1:-1, 1:-1] += torch.from_numpy(noise.astype(np.float32)).to(
            field.device)
        noisy.append(field)
    return SWState(*model._exchange(noisy, ("h", "u", "v")), *s[3:])


def cases(shape, params: SWParams, device, fuses, seed: int = 0):
    """``(state, first, fuse)`` to compare at one shape: the Euler step from
    the check state, and each of ``fuses`` from that state after two plain
    steps (so that the Adams–Bashforth history is a real one)."""
    model = ShallowWater(shape, params, device=device)
    s0 = check_state(model, seed)
    s2 = model._step_local(model._step_local(s0, True), False)
    return [(s0, True, 1)] + [(s2, False, f) for f in fuses]


def errors(got, ref, before):
    """Per field ``(max abs difference, difference over scale)``; see the
    module docstring for the scale."""
    out = []
    for i, (g, r, b) in enumerate(zip(got, ref, before)):
        diff = (g - r).abs().max().item()
        scale = ((r - b) if i < 3 else r).abs().max().item()
        out.append((diff, diff / scale if scale > 0 else float(diff > 0)))
    return out
