"""Vignetting-factor solving.

PyTorch counterpart of ``torchoptics_tpu.ops.vignetting``. The trace takes
vignetting coefficients through ``TraceConfig.vig_fn``; this module solves
them, so that each field's beam just clears the physical apertures:

* :func:`quadratic_vig_fn`: the ``v · field²`` coefficient model, a
  ready-made ``TraceConfig.vig_fn``.
* :func:`solve_vignetting`: from per-surface clear semi-apertures, the
  per-field ``vig_up``/``vig_down``/``vig_x`` factors of the largest
  vignetted pupil whose marginal rays pass every aperture. The fan traces,
  the aperture margins and the first-blocked-crossing search are tensor
  code on the lens's device, differentiable end to end.
* :func:`table_vig_fn` and :func:`solved_tables_vig_fn`: solved per-field
  tables as a ``vig_fn``, linearly interpolated in relative field.
* :func:`fit_quadratic_vig`: the least-squares projection of a solved table
  onto the quadratic model.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs

__all__ = ["quadratic_vig_fn", "table_vig_fn", "solved_tables_vig_fn", "fit_quadratic_vig",
           "solve_vignetting"]


def quadratic_vig_fn(fields, coeff):
    """``vig(field) = coeff · field²``: zero on axis, ``coeff`` at the field
    edge. ``fields`` is (1, F) relative fields, ``coeff`` (B,)."""
    return torch.reshape(coeff, (-1, 1)) * fields ** 2


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for every row of ``fp`` (B, N) at once:
    piecewise-linear in the ascending ``xp`` (N,), clamped to the end values
    outside it, with JAX's guard of a zero-width interval (the left value,
    no division). Returns (B, len(x))."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[:, i] - fp[:, i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[:, i - 1], fp[:, i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def _sorted_fields(solved_fields: Sequence[float]):
    sf = np.asarray(solved_fields, np.float64)
    order = np.argsort(sf)
    return sf[order].astype(np.float32), order


def table_vig_fn(solved_fields: Sequence[float], table):
    """A ``vig_fn`` that linearly interpolates a solved per-field table
    (B, F_solved) in relative field. Its ``coeff`` argument (normally
    ``specs.vig_*``) is ignored: the table carries the per-system values."""
    sf_np, order = _sorted_fields(solved_fields)
    tb = torch.as_tensor(table)
    tb = tb[:, torch.as_tensor(order, device=tb.device)]
    sf = torch.as_tensor(sf_np, device=tb.device)

    def vig_fn(fields, coeff):
        del coeff
        return _interp(torch.reshape(torch.as_tensor(fields), (-1,)), sf, tb)   # (B, F)

    return vig_fn


def solved_tables_vig_fn(solved_fields: Sequence[float]):
    """A ``vig_fn`` that reads the ``specs.vig_*`` coefficient itself as a
    solved (B, F_solved) table, interpolated in relative field, so that one
    ``TraceConfig`` carries distinct up, down and x tables::

        out = solve_vignetting(specs, lens, fields)
        specs_v = specs.replace(vig_up=out["vig_up"], vig_down=out["vig_down"],
                                vig_x=out["vig_x"])
        cfg = TraceConfig(..., vig_fn=solved_tables_vig_fn(fields))
    """
    sf_np, order = _sorted_fields(solved_fields)

    def vig_fn(fields, coeff):
        tb = torch.as_tensor(coeff)[:, torch.as_tensor(order, device=coeff.device)]
        sf = torch.as_tensor(sf_np, device=tb.device)
        return _interp(torch.reshape(torch.as_tensor(fields), (-1,)), sf, tb)   # (B, F)

    return vig_fn


def fit_quadratic_vig(rel_fields: Sequence[float], table) -> torch.Tensor:
    """Least-squares ``coeff`` (B,) with ``table[b, f] ≈ coeff[b] · field²``."""
    t = torch.as_tensor(table)
    f2 = torch.as_tensor(np.asarray(rel_fields, np.float64) ** 2, dtype=t.dtype,
                         device=t.device)
    denom = torch.sum(f2 * f2)
    coeff = torch.sum(t * f2[None, :], dim=1) / torch.clamp(denom, min=1e-30)
    return torch.where(denom > 0, coeff, 0.0)


def _edge(margins: torch.Tensor, pupil: np.ndarray, upper: bool) -> torch.Tensor:
    """Sub-sample pupil edge from per-ray aperture margins: a vectorized
    first-blocked crossing.

    ``margins`` (..., P): the largest hit radius over semi-aperture across
    the surfaces (inf for rays the trace killed); a ray passes iff its
    margin is <= 1. ``pupil`` (P,) is an ascending host array holding 0.
    Walking out from the chief ray, the first blocked sample going up (down)
    is the smallest (largest) blocked index above (below) the chief: a
    masked argmax, the first maximum winning; the crossing is interpolated
    linearly.
    """
    pupil = np.asarray(pupil, np.float64)
    P = pupil.shape[0]
    i0 = int(np.argmin(np.abs(pupil)))        # the pupil grid is on the host
    pj = torch.as_tensor(pupil, dtype=margins.dtype, device=margins.device)
    ar = np.arange(P)
    blocked = margins > 1.0

    # torch.argmax takes no bool: an int8 0/1 array, whose first maximum wins.
    if upper:
        cand = blocked & torch.as_tensor(ar > i0, device=margins.device)
        j = torch.argmax(cand.to(torch.int8), dim=-1)                       # first True
        default = float(pupil[-1])
    else:
        cand = blocked & torch.as_tensor(ar < i0, device=margins.device)
        j = P - 1 - torch.argmax(torch.flip(cand, dims=(-1,)).to(torch.int8), dim=-1)
        default = float(pupil[0])
    has = torch.any(cand, dim=-1)
    j = torch.where(has, j, i0 + 1 if upper else i0 - 1)                     # safe indices
    i = j - 1 if upper else j + 1                                            # last passing

    take = lambda a, idx: torch.gather(a, -1, idx[..., None])[..., 0]
    mi = take(margins, i)
    mj = take(margins, j)
    # Killed rays carry m = inf: the crossing collapses onto the last passing
    # sample (t = 0).
    fin = torch.isfinite(mj)
    t = torch.where(fin, (1.0 - mi) / torch.where(fin, mj - mi, 1.0), 0.0)
    edge = pj[i] + t * (pj[j] - pj[i])
    edge = torch.where(has, edge, default)
    return torch.where(take(margins, torch.full_like(j, i0)) > 1.0, 0.0, edge)


def _fan_margins(specs: Specs, lens: Lens, cfg, xp: torch.Tensor, yp: torch.Tensor,
                 sa: torch.Tensor) -> torch.Tensor:
    """(B, F, P): the largest hit radius / semi-aperture over the real
    surfaces, per ray of the fan (xp, yp); inf where the trace killed it."""
    from torchoptics_tpu_torch.ops import trace as trace_mod
    res = trace_mod.trace_rays(specs, lens, cfg, xy=(xp, yp), aggregate=("x", "y"))
    # _safe_sqrt: the chief ray's hit radius is 0 on every surface at field
    # 0, and sqrt's gradient there would make the solver's NaN.
    r = trace_mod._safe_sqrt(res.stacks["x"] ** 2 + res.stacks["y"] ** 2)  # (S, B, F, P, W)
    r = torch.movedim(r, 0, 1)[..., 0]                                    # (B, S, F, P)
    m = r / torch.clamp(sa[:, :, None, None], min=1e-12)
    surf_mask = torch.as_tensor(lens.structure.mask, device=lens.device)
    m = torch.where(surf_mask[:, :, None, None], m, 0.0)
    m = torch.amax(m, dim=1)                                              # (B, F, P)
    return torch.where(res.ray_ok[..., 0], m, torch.inf)


def solve_vignetting(specs: Specs, lens: Lens, rel_fields: Sequence[float],
                     semi_apertures: Optional[torch.Tensor] = None, n_scan: int = 129,
                     n_ray_aiming_iter: int = 1, wavelength="d",
                     tol: float = 1e-6) -> Dict[str, torch.Tensor]:
    """Solve per-field vignetting factors against per-surface apertures.

    Args:
      semi_apertures: (B, S) clear semi-apertures. ``None`` sizes them from
        the axial (field-0) beam, so the stop defines the apertures: no
        vignetting on axis, off-axis beams clipped to the axial footprint.
      rel_fields: fields to solve at (include 0.0 and the edge).
      n_scan: meridional and sagittal fan density (edge resolution about
        2 / n_scan, refined by linear interpolation of the margin).

    Returns a dict of the per-field tables ``vig_up``/``vig_down``/``vig_x``
    (B, F), ready for :func:`table_vig_fn`, the fitted quadratic
    coefficients ``q_up``/``q_down``/``q_x`` (B,) for
    :func:`quadratic_vig_fn`, and ``semi_apertures`` (B, S).

    The factors are the largest pupil rescaling
    (``ops.pupil.apply_vignetting``) whose meridional edge rays and sagittal
    edge ray pass every aperture; rays the trace kills (miss, TIR) count as
    blocked. The trace applies vignetting, then ray aiming, and the aiming
    map is built from vignetted probe rays: solving with
    ``n_ray_aiming_iter > 0`` against apertures generated under another
    vignetting carries an aiming offset of a few percent, so use
    ``n_ray_aiming_iter=0`` for exact round trips.
    """
    from torchoptics_tpu_torch.ops import trace as trace_mod

    device = lens.device
    cfg = trace_mod.TraceConfig(mode="tee", rel_fields=tuple(float(f) for f in rel_fields),
                                wavelengths=(wavelength,), n_ray_aiming_iter=n_ray_aiming_iter)

    # One scan grid for the axial fan and the solved fans: the float64
    # linspace rounded to float32 (JAX's axial fan takes jnp.linspace, which
    # is one rounding off at some n_scan, e.g. 25; equal at 65, 129, 257).
    grid = torch.as_tensor(np.linspace(-1.0, 1.0, n_scan).astype(np.float32),
                           device=device).reshape(1, 1, -1, 1)
    zeros = torch.zeros_like(grid)
    if semi_apertures is None:
        # The axial beam's footprint: a meridional and a sagittal fan at field 0.
        cfg0 = trace_mod.TraceConfig(mode="tee", rel_fields=(0.0,), wavelengths=(wavelength,),
                                     n_ray_aiming_iter=n_ray_aiming_iter)
        res0 = trace_mod.trace_rays(specs, lens, cfg0,
                                    xy=(torch.cat((zeros, grid), dim=2),
                                        torch.cat((grid, zeros), dim=2)),
                                    aggregate=("x", "y"))
        r0 = trace_mod._safe_sqrt(res0.stacks["x"] ** 2 + res0.stacks["y"] ** 2)
        sa = torch.amax(torch.movedim(r0, 0, 1)[..., 0], dim=(2, 3))          # (B, S)
    else:
        sa = torch.as_tensor(semi_apertures, device=device)
    sa = sa * (1.0 + tol)

    pupil = np.linspace(-1.0, 1.0, n_scan)
    m_y = _fan_margins(specs, lens, cfg, zeros, grid, sa)     # meridional fan
    m_x = _fan_margins(specs, lens, cfg, grid, zeros, sa)     # sagittal fan

    up_edge = _edge(m_y, pupil, upper=True)               # (B, F)
    down_edge = _edge(m_y, pupil, upper=False)
    x_hi = _edge(m_x, pupil, upper=True)
    x_lo = _edge(m_x, pupil, upper=False)
    x_edge = torch.minimum(x_hi, -x_lo)                   # symmetric in x

    out = {
        "vig_up": torch.clamp(1.0 - up_edge, min=0.0),
        "vig_down": torch.clamp(1.0 + down_edge, min=0.0),
        "vig_x": torch.clamp(1.0 - x_edge, min=0.0),
        "semi_apertures": sa / (1.0 + tol),
    }
    rf = [float(f) for f in rel_fields]
    out["q_up"] = fit_quadratic_vig(rf, out["vig_up"])
    out["q_down"] = fit_quadratic_vig(rf, out["vig_down"])
    out["q_x"] = fit_quadratic_vig(rf, out["vig_x"])
    return out
