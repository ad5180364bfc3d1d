"""Lens analysis.

PyTorch counterpart of ``torchoptics_tpu.analysis``. So far it holds the
wavefront objective, :func:`wavefront_rms`; the rest of the JAX module
(tolerancing, MTF, fans, Seidel sums, ...) is still to be ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import pupil as pupil_mod
from torchoptics_tpu_torch.ops import trace as trace_mod
from torchoptics_tpu_torch.ops import wavefront as wf

__all__ = ["wavefront_rms"]


def wavefront_rms(specs: Specs, lens: Lens, config: trace_mod.TraceConfig,
                  xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, remove_j: int = 4,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean (over systems, fields and wavelengths) RMS wavefront error in mm,
    with the first ``remove_j`` Noll terms (by default piston, tilt and
    defocus) fitted and removed per (field, λ): the best-focus wavefront
    error.

    Differentiable, so usable as an optimization objective (minimizing it
    maximizes the Strehl ratio, by Maréchal). With ``config.engine="fused"``
    the OPL runs in the opl mode of kernels K1-K4 and their hand adjoints;
    otherwise on the unroll engine's ``"dist"`` aggregate. The pupil is
    sampled once: the same points serve the trace and the fit.
    """
    if xy is None:
        xy = pupil_mod.sample_pupil(config.mode, config.n_rays, len(lens), generator=generator,
                                    device=lens.device)
    out = wf.opd_map(specs, lens, config, xy=xy)
    opd, ok = out["opd"], out["ok"]                               # (B, F, P, W)
    # The samples along P go minor for the fit: (B, F, W, P).
    minor = lambda v: torch.movedim(torch.broadcast_to(v, opd.shape), 2, -1)
    opd_m, ok_m, xr_m, yr_m = minor(opd), minor(ok), minor(xy[0]), minor(xy[1])
    coef = wf.zernike_fit(opd_m, xr_m, yr_m, ok_m, j_max=remove_j)
    # An elementwise contraction, as the JAX package writes it.
    low = torch.sum(wf.zernike_basis(remove_j, xr_m, yr_m) * coef[..., None, :], dim=-1)
    resid = opd_m - low
    w = ok_m.to(opd.dtype)
    nrm = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = torch.sum(resid * w, dim=-1) / nrm
    var = torch.sum(w * (resid - mean[..., None]) ** 2, dim=-1) / nrm
    return torch.mean(torch.sqrt(var + 1e-20))
