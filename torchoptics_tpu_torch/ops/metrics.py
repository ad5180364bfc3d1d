"""Spot-size metrics computed from trace results.

PyTorch counterpart of the spot metrics of ``torchoptics_tpu.ops.metrics``.
"""

from __future__ import annotations

import torch


def compute_rms2d(x: torch.Tensor, y: torch.Tensor,
                  ray_ok: torch.Tensor) -> torch.Tensor:
    """Mean RMS spot size per system, (B,).

    Reference semantics: the per-(field, wavelength) centroid is the plain
    mean over ALL rays (failed rays sit at the origin after
    ``reset_bad_rays``), the squared deviations are summed over valid rays
    only, and the denominator counts all rays.
    """
    B, F, P, W = torch.broadcast_shapes(x.shape, y.shape)
    y = y.expand(B, F, P, W)
    ray_ok = ray_ok.expand(B, F, P, W)
    ycent = torch.mean(y, dim=2)                 # (B, F, W)
    ymean = torch.mean(ycent, dim=-1)            # (B, F)
    dev2 = torch.where(ray_ok, (y - ymean[:, :, None, None]) ** 2, 0.0)
    ss = torch.sum(dev2, dim=(2, 3))             # (B, F)
    # sqrt'(0) is infinite; a field whose valid rays all coincide (or all
    # failed) would otherwise produce NaN gradients through 0 * inf.
    pos = ss > 0
    rms_f = torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / (P * W)), 0.0)
    return torch.mean(rms_f, dim=1)


def compute_spot_rms_xy(x: torch.Tensor, y: torch.Tensor,
                        ray_ok: torch.Tensor) -> torch.Tensor:
    """Radial RMS spot size about the per-field centroid, (B, F).

    Centroid and denominator count valid rays only; the sqrt is
    gradient-safe at 0 (all-failed fields return 0 with zero gradient)."""
    w = ray_ok.to(x.dtype)
    count = torch.clamp(torch.sum(w, dim=(2, 3)), min=1.0)
    xc = torch.sum(x * w, dim=(2, 3)) / count
    yc = torch.sum(y * w, dim=(2, 3)) / count
    d2 = (x - xc[:, :, None, None]) ** 2 + (y - yc[:, :, None, None]) ** 2
    ss = torch.sum(torch.where(ray_ok, d2, 0.0), dim=(2, 3))
    pos = ss > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / count), 0.0)


def compute_spot_rms(x: torch.Tensor, y: torch.Tensor, ray_ok: torch.Tensor,
                     metric: str = "y") -> torch.Tensor:
    """Per-system mean spot RMS, (B,): ``'y'`` = reference-parity
    ``compute_rms2d``; ``'xy'`` = field-mean of ``compute_spot_rms_xy``."""
    if metric == "y":
        return compute_rms2d(x, y, ray_ok)
    if metric == "xy":
        return torch.mean(compute_spot_rms_xy(x, y, ray_ok), dim=1)
    raise ValueError(f"spot metric must be 'y' or 'xy', got {metric!r}")


def compute_relative_illumination(specs, lens, relative_fields, vig_fn=None,
                                  n_ray_aiming_iter: int = 1, wavelengths=("d",),
                                  double_precision: bool = False) -> torch.Tensor:
    """Relative illumination per field, (B, F, W): two marginal rays and one
    sagittal ray per field (doi:10.1117/12.938414), traced as an internal
    sub-trace on the pure-torch engine. The first relative field must be 0;
    fields where a ray fails fall back to 1."""
    from torchoptics_tpu_torch.ops import trace as trace_mod
    eps = 1e-6
    assert relative_fields[0] == 0.0, "first relative field must be 0"
    cfg = trace_mod.TraceConfig(mode="tee", rel_fields=tuple(relative_fields), vig_fn=vig_fn,
                                n_ray_aiming_iter=n_ray_aiming_iter,
                                wavelengths=tuple(wavelengths),
                                double_precision=double_precision)
    as_xy = lambda v: torch.tensor(v, dtype=cfg.dtype, device=lens.device).reshape(1, 1, -1, 1)
    res = trace_mod.trace_rays(specs, lens, cfg, xy=(as_xy([0.0, 0.0, 1.0]),
                                                      as_xy([1.0, -1.0, 0.0])))
    cx, cy, ray_ok = res.cx, res.cy, res.ray_ok
    rel_illum = ((cy[..., 0, :] - cy[..., 1, :]) * cx[..., 2, :]
                 / torch.clamp(2.0 * cy[:, 0, 0, 0][:, None, None] ** 2, min=eps))
    validity = torch.all(torch.all(ray_ok, dim=3), dim=2)[..., None]     # (B, F, 1)
    validity = validity & validity[:, 0, :][:, None, :]
    return torch.where(validity, rel_illum, 1.0)
