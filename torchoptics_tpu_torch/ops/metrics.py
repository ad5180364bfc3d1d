"""Optical quality metrics computed from trace results.

PyTorch counterpart of ``torchoptics_tpu.ops.metrics``: the spot RMS
metrics, distortion, relative illumination, the effective semi-apertures,
the residual ray-aiming error and the axial and lateral colour. Every
internal trace runs on the pure-torch engine (``engine="unroll"``) on the
lens's device.
"""

from __future__ import annotations

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import aiming as aiming_mod


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


def _last_surfaces(lens: Lens):
    """(rows, last): each system's row and last real surface, as indices."""
    rows = torch.as_tensor(np.arange(len(lens)), device=lens.device)
    return rows, torch.as_tensor(lens.structure.n_surfaces - 1, device=lens.device)


def compute_distortion(specs: Specs, lens: Lens, relative_fields,
                       double_precision: bool = False) -> torch.Tensor:
    """Relative distortion at each field, (B, F): the chief ray's height
    against the paraxial height at the paraxial image plane, with a defocus
    correction."""
    from torchoptics_tpu_torch.ops import trace as trace_mod
    cfg = trace_mod.TraceConfig(mode="chief", rel_fields=tuple(relative_fields),
                                wavelengths=("d",), double_precision=double_precision)
    res = trace_mod.trace_rays(specs, lens, cfg)
    y = res.y.reshape(len(specs), -1)
    cy = res.cy.reshape(len(specs), -1)

    rel = torch.as_tensor(np.asarray(relative_fields), dtype=y.dtype, device=y.device)
    efl, bfl = abcd_mod.get_first_order(lens)
    paraxial_heights = torch.tan(rel[None, :] * specs.hfov[:, None]) * efl[:, None]

    defocus = lens.t[_last_surfaces(lens)] - bfl
    ref_y = paraxial_heights + defocus[:, None] * cy / torch.sqrt(1.0 - cy ** 2)
    return (y - ref_y) / ref_y


def compute_semi_apertures(specs: Specs, lens: Lens, n_rays: int = 33,
                           rel_fields=(0.0, 0.707, 1.0),
                           n_ray_aiming_iter: int = 1) -> torch.Tensor:
    """Per-surface effective semi-apertures, (B, S): the largest hit radius
    of a meridional fan across the fields, from the unroll engine's ``x``
    and ``y`` aggregate stacks. A ray that fails at surface k sits on the
    axis from k on, so its heights before the failure still count."""
    from torchoptics_tpu_torch.ops import trace as trace_mod
    cfg = trace_mod.TraceConfig(mode="meridional_uniform", n_rays=(n_rays,),
                                rel_fields=tuple(rel_fields), wavelengths=("d",),
                                n_ray_aiming_iter=n_ray_aiming_iter)
    res = trace_mod.trace_rays(specs, lens, cfg, aggregate=("x", "y"))
    r = torch.sqrt(res.stacks["x"] ** 2 + res.stacks["y"] ** 2)      # (S, B, F, P, W)
    return torch.amax(r, dim=(2, 3, 4)).transpose(0, 1)              # (B, S)


def compute_ray_aiming_error(specs: Specs, lens: Lens, rel_fields, vig_fn=None,
                             n_ray_aiming_iter: int = 1, ray_aiming_mode: str = "real",
                             double_precision: bool = False):
    """Residual relative aiming error of the meridional ray pair at the
    stop, (B, F, 2, 1); the float 0.0 when the stop is the first surface of
    every system."""
    from torchoptics_tpu_torch.ops import pupil as pupil_mod
    from torchoptics_tpu_torch.ops import trace as trace_mod
    specs = specs.up_to_stop()
    lens = lens.up_to_stop()
    if all(k == 0 for k in lens.structure.stop_idx):
        return 0.0

    if ray_aiming_mode == "paraxial":
        magnification = abcd_mod.compute_magnification(lens)
        rs = (magnification * specs.epd / 2.0).reshape(-1, 1, 1, 1)
    elif ray_aiming_mode == "real":
        rs = aiming_mod.compute_pupil_radius(specs, lens, double_precision).reshape(-1, 1, 1, 1)
    else:
        raise ValueError(ray_aiming_mode)

    cfg = trace_mod.TraceConfig(mode="tee", rel_fields=tuple(rel_fields), vig_fn=vig_fn,
                                wavelengths=("d",), n_ray_aiming_iter=n_ray_aiming_iter,
                                ray_aiming_mode=ray_aiming_mode,
                                double_precision=double_precision)
    y = torch.tensor([-1.0, 1.0], dtype=cfg.dtype, device=lens.device).reshape(1, 1, -1, 1)
    x = torch.zeros_like(y)
    res = trace_mod.trace_rays(specs, lens, cfg, xy=(x, y), use_vig=True)

    if vig_fn is not None:
        fields = torch.tensor(cfg.rel_fields, dtype=cfg.dtype, device=lens.device)[None, :]
        y = pupil_mod.apply_vignetting(y, vig_fn(fields, specs.vig_up),
                                       vig_fn(fields, specs.vig_down))
    return res.y / rs - y


def compute_axial_color(lens: Lens, wavelengths=("F", "C")) -> torch.Tensor:
    """Axial (longitudinal) chromatic aberration BFL(λ₁) - BFL(λ₂), (B,):
    the paraxial per-wavelength ABCD chain, through the elementwise 2x2
    products of ``ops.abcd``."""
    from torchoptics_tpu_torch.models import glass as glass_mod
    wl = glass_mod.resolve_wavelengths(tuple(wavelengths))
    n = lens.get_refractive_indices(wl)                           # (B, S, 2)
    t = lens.t.index_put(_last_surfaces(lens), torch.zeros(len(lens), dtype=lens.dtype,
                                                           device=lens.device))

    def bfl_at(n_w):
        n_full = torch.cat((torch.ones_like(n_w[:, :1]), n_w), dim=1)
        m = abcd_mod.reduce_abcd(abcd_mod.interface_propagation_abcd(lens.c, t, n_full))
        return -m[:, 0, 0] / m[:, 1, 0]

    return bfl_at(n[..., 0]) - bfl_at(n[..., 1])


def compute_lateral_color(specs: Specs, lens: Lens, rel_field: float = 1.0,
                          wavelengths=("F", "C"), n_ray_aiming_iter: int = 1) -> torch.Tensor:
    """Lateral (transverse) chromatic aberration y(λ₁) - y(λ₂) of the real
    chief ray at ``rel_field``, (B,), in mm."""
    from torchoptics_tpu_torch.ops import trace as trace_mod
    cfg = trace_mod.TraceConfig(mode="chief", n_rays=(1,), rel_fields=(float(rel_field),),
                                wavelengths=tuple(wavelengths),
                                n_ray_aiming_iter=n_ray_aiming_iter)
    res = trace_mod.trace_rays(specs, lens, cfg)
    return res.y[:, 0, 0, 0] - res.y[:, 0, 0, 1]
