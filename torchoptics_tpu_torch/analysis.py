"""Lens analysis: Monte-Carlo tolerancing, sensitivity tables, MTFs, ray
fans, field curvature, longitudinal aberration, Seidel sums and the
wavefront objective.

PyTorch counterpart of ``torchoptics_tpu.analysis``, with the same public
names. A tolerance run is one batched trace: the perturbed copies of a
design form a (B, S) population, which ``trace_engine="fused"`` scores in
one launch of kernel K2 (K4 for a conic/asphere design), and the
sensitivity table is one ``torch.autograd.grad`` of the same spot-size
objective (K2's or K4's backward kernel). Every function follows its lens's
device. Where the JAX module takes a PRNG ``key`` these take an explicit
``generator: Optional[torch.Generator]``: a ``torch.Generator`` cannot
reproduce ``jax.random``, so :func:`perturb_lens` draws the noise and
``_apply_perturbation`` applies it, and :func:`tolerance_analysis` is
tile -> perturb -> ``_score_population``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch import simulator as sim_mod
from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure
from torchoptics_tpu_torch.optimize import _add_at_last_surface
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import metrics as metrics_mod
from torchoptics_tpu_torch.ops import pupil as pupil_mod
from torchoptics_tpu_torch.ops import trace as trace_mod
from torchoptics_tpu_torch.ops import wavefront as wf

__all__ = [
    "Tolerances", "tile_population", "perturb_lens",
    "tolerance_analysis", "sensitivities", "field_mtf",
    "diffraction_mtf", "wavefront_rms", "refocus",
    "ray_fans", "field_curvature", "longitudinal_aberration",
    "seidel_coefficients", "seidel_focal_shifts",
]


def _add_at_last(lens: Lens, delta: torch.Tensor) -> Lens:
    """``lens`` with ``delta`` (B,) added to each system's last thickness,
    out of place, so that autograd reaches ``delta``."""
    return lens.replace(t=_add_at_last_surface(lens.structure, lens.t, delta.to(lens.dtype)))


def field_mtf(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Per-field geometric MTF of a (B=1) design.

    Renders the per-field PSFs at ``config.psf_shape`` /
    ``config.psf_abs_pixel_size`` (the imaging path's sampling; kernel K1's
    plain mode with ``trace_engine="fused"``) and returns
    ``ops.psf.compute_mtf``'s cuts: ``freqs_t``/``freqs_s`` in cycles/mm and
    ``mtf_t``/``mtf_s`` (n_fields, 3, n_freq), the tangential and sagittal
    modulation per field and colour channel. Differentiable."""
    from torchoptics_tpu_torch import imaging
    from torchoptics_tpu_torch.ops import psf as psf_mod
    model = imaging.sample_optics_model(specs, lens, config, generator=generator)
    psfs = model.sampled_psfs.permute(0, 3, 1, 2)                 # (F, 3, ph, pw)
    return psf_mod.compute_mtf(psfs, config.psf_abs_pixel_size)


def through_focus_mtf(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig, deltas,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Through-focus geometric MTF: modulation against image-plane shift.

    Tiles the (B=1) design over the ``deltas`` sweep (mm, added to the last
    thickness, as :func:`refocus` does), traces the sweep as one population
    (one launch of kernel K2's plain mode with ``trace_engine="fused"``),
    renders centroid-referenced per-(delta, field) PSFs at the configured
    sampling, and returns ``ops.psf.compute_mtf``'s cuts:

      ``deltas``              (D,) the sweep
      ``freqs_t``/``freqs_s`` (K,) cycles/mm
      ``mtf_t``/``mtf_s``     (D, F, W, K) per focus shift, field and wavelength

    Differentiable."""
    from torchoptics_tpu_torch.ops import psf as psf_mod

    deltas_np = np.asarray(deltas, np.float64).reshape(-1)
    D = deltas_np.shape[0]
    specs_n, lens_n = tile_population(specs, lens, D)
    lens_n = _add_at_last(lens_n, torch.as_tensor(deltas_np, dtype=lens.dtype,
                                                  device=lens.device))
    res = trace_mod.trace_rays(specs_n, lens_n, config.trace_config(), generator=generator)
    F, W = res.x.shape[1], res.x.shape[3]
    # compute_psf takes (B, F, channels, rays): one PSF per wavelength here,
    # centred on each grid's centroid; failed rays sit at the origin.
    x = res.x.permute(0, 1, 3, 2)
    y = res.y.permute(0, 1, 3, 2)
    *_, kernels, _ = psf_mod.compute_psf(x, y, n_bins=tuple(config.psf_shape),
                                         increment=config.psf_abs_pixel_size)
    ny, nx = kernels.shape[-2:]
    out = psf_mod.compute_mtf(kernels.reshape(D, F, W, ny, nx), config.psf_abs_pixel_size)
    out["deltas"] = torch.as_tensor(deltas_np, dtype=res.x.dtype, device=res.x.device)
    return out


@dataclass(frozen=True)
class Tolerances:
    """1-sigma (normal) or half-width (uniform) manufacturing perturbations.

    Units match the lens parameters: ``c`` in 1/mm, ``t`` in mm, ``nd``/``v``
    absolute index/Abbe error, ``kappa`` absolute, ``asph`` *relative*
    (multiplies each coefficient). Scalars broadcast over surfaces; (S,)
    arrays give per-surface tolerances.
    """

    c: float = 0.0
    t: float = 0.0
    nd: float = 0.0
    v: float = 0.0
    kappa: float = 0.0
    asph_rel: float = 0.0
    distribution: str = "normal"  # or "uniform"

    def __post_init__(self):
        if self.distribution not in ("normal", "uniform"):
            raise ValueError(
                f"distribution must be 'normal' or 'uniform', "
                f"got {self.distribution!r}")


def _tile_structure(structure: Structure, n: int) -> Structure:
    return Structure(structure.stop_idx * n, structure.sequence * n, pad_to=structure.pad_to)


def tile_population(specs: Specs, lens: Lens, n: int) -> Tuple[Specs, Lens]:
    """Tile a single design (B=1) into an n-sample population."""
    if len(lens) != 1:
        raise ValueError(f"tile_population expects a single design (B=1), got B={len(lens)}")
    st = _tile_structure(lens.structure, n)
    rep = lambda a: None if a is None else a.repeat((n,) + (1,) * (a.ndim - 1))
    lens_n = Lens(st, rep(lens.c), rep(lens.t), rep(lens.nd), rep(lens.v),
                  kappa=rep(lens.kappa), asph=rep(lens.asph))
    specs_n = Specs(st, rep(specs.epd), rep(specs.hfov), rep(specs.vig_up),
                    rep(specs.vig_down), rep(specs.vig_x))
    return specs_n, lens_n


def _noise(generator: Optional[torch.Generator], shape, distribution: str, dtype,
           device) -> torch.Tensor:
    """One noise array: U(-1, 1) or N(0, 1), drawn on the generator's device
    (the default generator's on ``device`` when None)."""
    on = device if generator is None else generator.device
    if distribution == "uniform":
        a = torch.rand(shape, generator=generator, dtype=dtype, device=on) * 2.0 - 1.0
    else:
        a = torch.randn(shape, generator=generator, dtype=dtype, device=on)
    return a.to(device)


def _nonzero(tol_value) -> bool:
    return bool(np.any(np.asarray(tol_value) != 0))


def perturb_lens(lens: Lens, generator: Optional[torch.Generator], tol: Tolerances,
                 keep_first_nominal: bool = True) -> Lens:
    """Add independent manufacturing noise to every valid surface of every
    system in the population. With ``keep_first_nominal`` sample 0 stays
    exactly the nominal design (a free nominal reference in the same launch).

    The noise arrays are drawn from ``generator`` in the JAX module's order:
    c, t, nd and v (each (B, S)), then kappa (B, S) where the lens has conic
    constants and ``tol.kappa`` is nonzero, then asph (B, S, K) where it has
    asphere terms and ``tol.asph_rel`` is nonzero."""
    B, S = lens.structure.mask.shape
    draw = lambda shape: _noise(generator, shape, tol.distribution, lens.dtype, lens.device)
    noise = {k: draw((B, S)) for k in ("c", "t", "nd", "v")}
    if lens.kappa is not None and _nonzero(tol.kappa):
        noise["kappa"] = draw((B, S))
    if lens.asph is not None and _nonzero(tol.asph_rel):
        noise["asph"] = draw((B, S, lens.asph.shape[-1]))
    return _apply_perturbation(lens, noise, tol, keep_first_nominal)


def _apply_perturbation(lens: Lens, noise: Dict[str, torch.Tensor], tol: Tolerances,
                        keep_first_nominal: bool) -> Lens:
    """``perturb_lens`` with the noise given: ``noise`` holds (B, S) arrays
    ``c``, ``t``, ``nd``, ``v`` and, where used, ``kappa`` (B, S) and
    ``asph`` (B, S, K), each N(0, 1) or U(-1, 1) as ``tol.distribution``
    says."""
    st = lens.structure
    B = st.mask.shape[0]
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=lens.dtype, device=lens.device)
    mask = as_t(st.mask)
    mask_G = as_t(st.mask_G)
    if keep_first_nominal:
        live = torch.cat([torch.zeros((1, 1), dtype=lens.dtype, device=lens.device),
                          torch.ones((B - 1, 1), dtype=lens.dtype, device=lens.device)])
        mask = mask * live
        mask_G = mask_G * live
    c = lens.c + as_t(tol.c) * mask * noise["c"]
    t = lens.t + as_t(tol.t) * mask * noise["t"]
    nd = lens.nd + as_t(tol.nd) * mask_G * noise["nd"]
    v = lens.v + as_t(tol.v) * mask_G * noise["v"]
    kappa = lens.kappa
    if kappa is not None and _nonzero(tol.kappa):
        kappa = kappa + as_t(tol.kappa) * mask * noise["kappa"]
    asph = lens.asph
    if asph is not None and _nonzero(tol.asph_rel):
        asph = asph * (1.0 + as_t(tol.asph_rel) * mask[..., None] * noise["asph"])
    return Lens(st, c, t, nd, v, kappa=kappa, asph=asph)


def _per_sample_rms(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-system polychromatic spot RMS, (B,), under ``config.spot_metric``.

    ``trace_engine="fused"`` scores the whole population on one launch of
    ``fused_batch.batched_unsupervised_loss`` (kernel K2's Lu mode, K4's for
    a conic/asphere population); the unroll engine traces and reduces."""
    cfg = config.trace_config()
    if cfg.engine == "fused":
        from torchoptics_tpu_torch.ops import fused_batch
        _, ld = fused_batch.batched_unsupervised_loss(specs, lens, config, generator=generator)
        return ld["rms"]
    res = trace_mod.trace_rays(specs, lens, cfg, generator=generator)
    return metrics_mod.compute_spot_rms(res.x, res.y, res.ray_ok, config.spot_metric)


def tolerance_analysis(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
                       tol: Tolerances, n_samples: int,
                       generator: Optional[torch.Generator] = None,
                       rms_threshold: Optional[float] = None,
                       percentiles: Tuple[float, ...] = (50.0, 90.0, 99.0),
                       compensator: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Monte-Carlo tolerance run over ``n_samples`` perturbed copies of a
    (B=1) design, scored in one batched launch.

    ``compensator="refocus"`` refocuses every perturbed sample (the
    closed-form least-squares image-plane shift of :func:`refocus`, per
    system) before scoring: back focus is the free compensator a
    manufacturer always adjusts, so uncompensated yields are pessimistic.
    ``None`` scores at the nominal focus.

    Returns a dict of tensors:
      ``rms``            (n_samples,) per-sample spot RMS (sample 0 nominal)
      ``nominal_rms``    RMS of sample 0, the unperturbed design (refocused
                         like the others under ``compensator="refocus"``)
      ``mean``/``std``   moments over the perturbed samples (std of the
                         population, ddof 0)
      ``p<q>``           the requested RMS percentiles (linear interpolation)
      ``yield_fraction`` the fraction with RMS <= rms_threshold (if given)
      ``refocus_delta``  (n_samples,) the applied focus shifts (compensator on)
    """
    if compensator not in (None, "refocus"):
        raise ValueError(f"compensator must be None or 'refocus', got {compensator!r}")
    specs_n, lens_n = tile_population(specs, lens, n_samples)
    lens_p = perturb_lens(lens_n, generator, tol, keep_first_nominal=True)
    return _score_population(specs_n, lens_p, config, compensator, percentiles, rms_threshold)


def _score_population(specs_n: Specs, lens_p: Lens, config: sim_mod.SimulatorConfig,
                      compensator: Optional[str], percentiles: Tuple[float, ...],
                      rms_threshold: Optional[float]) -> Dict[str, torch.Tensor]:
    """Refocus (with ``compensator="refocus"``), score and summarize a
    perturbed population whose sample 0 is the nominal design."""
    delta = None
    if compensator == "refocus":
        lens_p, delta = refocus(specs_n, lens_p, config)
    rms = _per_sample_rms(specs_n, lens_p, config)
    perturbed = rms[1:]
    out: Dict[str, torch.Tensor] = {
        "rms": rms,
        "nominal_rms": rms[0],
        "mean": torch.mean(perturbed),
        "std": torch.std(perturbed, correction=0),
    }
    if delta is not None:
        out["refocus_delta"] = delta
    for q in percentiles:
        out[f"p{q:g}"] = torch.quantile(perturbed, q / 100.0, interpolation="linear")
    if rms_threshold is not None:
        out["yield_fraction"] = torch.mean((perturbed <= rms_threshold).to(rms.dtype))
    return out


def refocus(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
            generator: Optional[torch.Generator] = None) -> Tuple[Lens, torch.Tensor]:
    """Shift each system's image distance to its least-squares best focus.

    Ray intercepts move linearly with an image-plane shift δ
    (x' = x + δ·cx/cz), so the RMS-minimizing shift has the closed form
    δ* = -Σ ok·(x·tx + y·ty) / Σ ok·(tx² + ty²) with t = (cx, cy)/cz and the
    per-field centroid removed: one trace (kernel K2's plain mode for a
    population with ``trace_engine="fused"``), differentiable. The minimized
    functional follows ``config.spot_metric``: ``'xy'`` pools both
    transverse axes, ``'y'`` the y deviations alone (the two best foci differ
    on astigmatic designs). Returns (refocused lens, δ* per system)."""
    res = trace_mod.trace_rays(specs, lens, config.trace_config(), generator=generator)
    w = res.ray_ok.to(lens.dtype)                                   # (B, F, P, W)
    cz = torch.sqrt(torch.clamp(1.0 - res.cx ** 2 - res.cy ** 2, min=1e-12))
    tx = res.cx / cz
    ty = res.cy / cz
    nrm = torch.clamp(torch.sum(w, dim=2, keepdim=True), min=1.0)

    def centered(a):
        return a - torch.sum(a * w, dim=2, keepdim=True) / nrm

    x, y = centered(res.x), centered(res.y)
    txc, tyc = centered(tx), centered(ty)
    if config.spot_metric == "y":
        num = torch.sum(w * (y * tyc), dim=(1, 2, 3))                          # (B,)
        den = torch.clamp(torch.sum(w * tyc ** 2, dim=(1, 2, 3)), min=1e-12)
    else:
        num = torch.sum(w * (x * txc + y * tyc), dim=(1, 2, 3))                # (B,)
        den = torch.clamp(torch.sum(w * (txc ** 2 + tyc ** 2), dim=(1, 2, 3)), min=1e-12)
    delta = -num / den
    return _add_at_last(lens, delta), delta


def diffraction_mtf(specs: Specs, lens: Lens, config: trace_mod.TraceConfig,
                    grid_n: int = 32, pad: int = 4,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Diffraction MTF per (field, wavelength) from the traced wavefront.

    The physical transfer function is the pupil autocorrelation, computed
    as the transform of the diffraction PSF of the traced OPD
    (``ops.wavefront.opd_map`` on a ``grid_n``² pupil grid: with
    ``engine="fused"`` two launches of kernel K1's opl mode, the bundle and
    the chief rays). Returns:

      ``rel_freqs``       (K,) spatial frequencies in units of the cutoff
      ``mtf_t``/``mtf_s`` (F, W, K) tangential/sagittal cuts
      ``cutoff_cyc_mm``   (F, W) the cutoff 1/(λ·f#_working)

    The line-spread transforms are ``torch.fft.rfft`` calls (no matrix
    product, so TF32 never enters)."""
    device = lens.device
    n = grid_n
    g = (np.arange(n) + 0.5) / n * 2.0 - 1.0                  # cell centres
    X, Y = np.meshgrid(g, g, indexing="xy")
    incircle = (X ** 2 + Y ** 2) <= 1.0
    as_xy = lambda a: torch.as_tensor(a.ravel()[None, None, :, None], dtype=torch.float32,
                                      device=device)
    out = wf.opd_map(specs, lens, config, generator=generator, xy=(as_xy(X), as_xy(Y)))
    opd = out["opd"][0]                                       # (F, P, W)
    ok = out["ok"][0] & torch.as_tensor(incircle.ravel(), device=device)[None, :, None]
    F, _, W = opd.shape

    z_xp = wf.exit_pupil_distance(lens)[0]
    r_xp = specs.epd[0] / 2.0 * wf.pupil_magnification(lens)[0]
    R = torch.sqrt(z_xp ** 2 + out["x_img"][0] ** 2 + out["y_img"][0] ** 2)   # (F, W)
    fnum = R / (2.0 * r_xp)

    wavelengths_mm = [float(w) * 1e-6 for w in config.wavelengths]
    mtf_t, mtf_s = [], []
    for wi, lam in enumerate(wavelengths_mm):
        psf = wf.diffraction_psf(opd[:, :, wi].reshape(F, n, n), ok[:, :, wi].reshape(F, n, n),
                                 lam, pad=pad)["psf"]
        mt = torch.abs(torch.fft.rfft(torch.sum(psf, dim=-1), dim=-1))
        ms = torch.abs(torch.fft.rfft(torch.sum(psf, dim=-2), dim=-1))
        mtf_t.append(mt / torch.clamp(mt[..., :1], min=1e-20))
        mtf_s.append(ms / torch.clamp(ms[..., :1], min=1e-20))
    M = pad * n
    K = M // 2 + 1
    # The PSF pixel is λ·f#/pad, so rfft frequency k/(M·pixel) in cutoff
    # units 1/(λ·f#) is k·pad/M, independent of field and wavelength.
    rel = torch.as_tensor(np.arange(K) * pad / M, dtype=torch.float32, device=device)
    lam_t = torch.as_tensor(wavelengths_mm, dtype=fnum.dtype, device=device)
    return {"rel_freqs": rel, "mtf_t": torch.stack(mtf_t, dim=1),
            "mtf_s": torch.stack(mtf_s, dim=1), "cutoff_cyc_mm": 1.0 / (lam_t[None, :] * fnum)}


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


def _fan_trace(specs: Specs, lens: Lens, config: trace_mod.TraceConfig, px, py,
               generator: Optional[torch.Generator] = None) -> trace_mod.TraceResult:
    """Trace an explicit pupil fan (relative coordinates) through the whole
    front-end (vignetting, aiming, EPD scaling), on the unroll engine."""
    as_xy = lambda a: torch.as_tensor(np.asarray(a), dtype=config.dtype,
                                      device=lens.device).reshape(1, 1, -1, 1)
    return trace_mod.trace_rays(specs, lens, config, generator=generator,
                                xy=(as_xy(px), as_xy(py)))


def ray_fans(specs: Specs, lens: Lens, config: trace_mod.TraceConfig, n: int = 33,
             pupil_fraction: float = 1.0,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Transverse ray-aberration fans: a meridional fan (px = 0, py in
    ±``pupil_fraction``) and a sagittal one (py = 0) at every field and
    wavelength of ``config``, as image-plane deviations from the chief ray:

      ``p``               (n,)        relative pupil coordinate of the fan
      ``eps_y``/``eps_x`` (B, F, n, W) tangential εy(py) / sagittal εx(px), mm
      ``ok_t``/``ok_s``   (B, F, n, W) validity masks

    ``n`` must be odd, so that the chief ray is a fan member. Honours the
    vignetting and ray aiming of ``config``; differentiable."""
    if n % 2 == 0:
        raise ValueError(f"ray_fans needs an odd n so the chief ray is a fan member; got n={n}")
    p = np.linspace(-1.0, 1.0, n, dtype=np.float32) * float(pupil_fraction)
    zeros = np.zeros_like(p)
    res_t = _fan_trace(specs, lens, config, zeros, p, generator=generator)
    res_s = _fan_trace(specs, lens, config, p, zeros, generator=generator)
    chief = n // 2
    # The deviations are referred to the chief ray; where it failed the whole
    # (field, λ) column is meaningless and masked out.
    chief_ok_t = res_t.ray_ok[:, :, chief:chief + 1, :]
    chief_ok_s = res_s.ray_ok[:, :, chief:chief + 1, :]
    eps_y = torch.where(chief_ok_t, res_t.y - res_t.y[:, :, chief:chief + 1, :], 0.0)
    eps_x = torch.where(chief_ok_s, res_s.x - res_s.x[:, :, chief:chief + 1, :], 0.0)
    return {"p": torch.as_tensor(p, device=lens.device), "eps_y": eps_y,
            "ok_t": res_t.ray_ok & chief_ok_t, "eps_x": eps_x, "ok_s": res_s.ray_ok & chief_ok_s}


def _slopes(res: trace_mod.TraceResult):
    cz = torch.sqrt(torch.clamp(1.0 - res.cx ** 2 - res.cy ** 2, min=1e-12))
    return res.cx / cz, res.cy / cz


def _best_focus_shift(a, u, ok):
    """Least-squares image-plane shift collapsing intercepts ``a`` with
    transverse slopes ``u`` over the pupil axis (axis 2):
    a(δ) = a + δ·u gives δ* = -Σw(a-ā)(u-ū)/Σw(u-ū)², per (field, λ)."""
    w = ok.to(a.dtype)
    nrm = torch.clamp(torch.sum(w, dim=2, keepdim=True), min=1.0)
    ac = a - torch.sum(a * w, dim=2, keepdim=True) / nrm
    uc = u - torch.sum(u * w, dim=2, keepdim=True) / nrm
    num = torch.sum(w * ac * uc, dim=2)                                  # (B, F, W)
    den = torch.clamp(torch.sum(w * uc ** 2, dim=2), min=1e-12)
    return -num / den


def field_curvature(specs: Specs, lens: Lens, config: trace_mod.TraceConfig, n: int = 11,
                    pupil_fraction: float = 0.25,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Astigmatic field curves: the tangential and sagittal best-focus shift
    per field. For each (field, λ) a narrow meridional (sagittal) fan about
    the chief ray is traced and the image-plane shift that collapses it is
    solved in closed form. Returns, each (B, F, W) in mm (positive: focus
    beyond the image plane), ``dz_t``, ``dz_s`` and ``astigmatism``
    (dz_t - dz_s). Differentiable."""
    if n % 2 == 0:
        raise ValueError(f"field_curvature needs an odd n; got n={n}")
    p = np.linspace(-1.0, 1.0, n, dtype=np.float32) * float(pupil_fraction)
    zeros = np.zeros_like(p)
    res_t = _fan_trace(specs, lens, config, zeros, p, generator=generator)
    dz_t = _best_focus_shift(res_t.y, _slopes(res_t)[1], res_t.ray_ok)
    res_s = _fan_trace(specs, lens, config, p, zeros, generator=generator)
    dz_s = _best_focus_shift(res_s.x, _slopes(res_s)[0], res_s.ray_ok)
    return {"dz_t": dz_t, "dz_s": dz_s, "astigmatism": dz_t - dz_s}


def longitudinal_aberration(specs: Specs, lens: Lens, config: trace_mod.TraceConfig,
                            n: int = 17, pupil_fraction: float = 1.0,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, torch.Tensor]:
    """Longitudinal spherical aberration and spherochromatism: an on-axis
    meridional fan (``config.rel_fields`` replaced by field 0) and each
    ray's axial crossing past the image plane, dz(p) = -y/(cy/cz):

      ``p``   (n,)      relative pupil heights in (0, ``pupil_fraction``]
      ``dz``  (B, n, W) longitudinal focus shift per pupil height and λ, mm

    dz(p -> 0) is the paraxial chromatic focal shift
    (``metrics.compute_axial_color``); dz(1) - dz(0+) is the classical LSA."""
    cfg0 = dataclasses.replace(config, rel_fields=(0.0,))
    p = (np.arange(1, n + 1, dtype=np.float32) / n) * float(pupil_fraction)
    res = _fan_trace(specs, lens, cfg0, np.zeros_like(p), p, generator=generator)
    ty = _slopes(res)[1]
    big = torch.abs(ty) > 1e-12
    dz = torch.where(big, -res.y / torch.where(big, ty, 1.0), 0.0)
    return {"p": torch.as_tensor(p, device=lens.device), "dz": dz[:, 0, :, :]}


def seidel_coefficients(specs: Specs, lens: Lens, wavelength="d",
                        chromatic=("F", "C")) -> Dict[str, torch.Tensor]:
    """Third-order (Seidel) wavefront aberration sums, per system.

    Traces the paraxial marginal ray (infinite conjugate, height EPD/2,
    u = 0) and chief ray (paraxial field angle ``specs.hfov`` through the
    entrance-pupil centre) and accumulates Welford's refraction-invariant
    per-surface forms with A = n(u + yc), Ā = n(ū + ȳc):

      ``S1``  spherical        -A²·y·Δ(u/n)
      ``S2``  coma             -A·Ā·y·Δ(u/n)
      ``S3``  astigmatism      -Ā²·y·Δ(u/n)
      ``S4``  Petzval          -H²·c·Δ(1/n)
      ``S5``  distortion       (Ā/A)·(S3ₖ + S4ₖ)
      ``C1``/``C2`` axial/lateral colour  A·y·Δ(δn/n), Ā·y·Δ(δn/n)
        (δn = n(λ₁) - n(λ₂) of the ``chromatic`` pair per medium)

    plus ``H`` (the Lagrange invariant), ``u_img`` (the marginal image-space
    angle) and ``per_surface`` (each sum per surface, (B, S)). All (B,)
    unless noted; lengths (wavefront measure). Conic/asphere surfaces add
    through their effective 4th-order sag (κ·c³/8 + asph₀); the chromatic
    sums take the asphere terms as achromatic. Padding surfaces are masked
    out; differentiable."""
    lam = (wavelength,) + tuple(chromatic)
    n_all = lens.get_refractive_indices(lam)                          # (B, S, 3)
    mask = torch.as_tensor(lens.structure.mask, dtype=lens.dtype, device=lens.device)
    # Masked-out surfaces are no-op interfaces: n_next := n_prev.
    n_cols = [torch.ones_like(n_all[:, 0, :])]
    for k in range(n_all.shape[1]):
        keep = mask[:, k:k + 1]
        n_cols.append(keep * n_all[:, k, :] + (1 - keep) * n_cols[-1])
    n_full = torch.stack(n_cols, dim=1)                               # (B, S+1, 3)
    nd_prev, nd_next = n_full[:, :-1, 0], n_full[:, 1:, 0]            # (B, S)
    dn = n_full[..., 1] - n_full[..., 2]                              # δn, (B, S+1)
    dn_prev, dn_next = dn[:, :-1], dn[:, 1:]

    c = lens.c * mask
    t = lens.t
    S = c.shape[1]
    a4_eff = _a4_effective(lens)

    y = torch.broadcast_to(specs.epd[:, None] / 2.0, c[:, :1].shape)[:, 0]
    u = torch.zeros_like(y)
    ub = torch.broadcast_to(specs.hfov, y.shape)
    z_p = abcd_mod.compute_pupil_position(lens)
    yb = -z_p * ub
    H = nd_prev[:, 0] * (ub * y - u * yb)                             # Lagrange invariant

    names = ("S1", "S2", "S3", "S4", "S5", "C1", "C2")
    sums = {k: [] for k in names}
    for k in range(S):
        ck, mk = c[:, k], mask[:, k]
        n0, n1 = nd_prev[:, k], nd_next[:, k]
        A = n0 * (u + y * ck)
        Ab = n0 * (ub + yb * ck)
        u_new = (n0 * u - y * ck * (n1 - n0)) / n1
        ub_new = (n0 * ub - yb * ck * (n1 - n0)) / n1
        d_un = u_new / n1 - u / n0
        d_inv = 1.0 / n1 - 1.0 / n0
        d_dnn = dn_next[:, k] / n1 - dn_prev[:, k] / n0
        s1 = -(A ** 2) * y * d_un * mk
        s2 = -A * Ab * y * d_un * mk
        s3 = -(Ab ** 2) * y * d_un * mk
        s4 = -(H ** 2) * ck * d_inv * mk
        big = torch.abs(A) > 1e-12
        s5 = torch.where(big, (Ab / torch.where(big, A, 1.0)) * (s3 + s4), 0.0)
        if a4_eff is not None:
            # The classical aspheric increments: an added 4th-order sag G·r⁴
            # gives δS_I = 8G(n' - n)y⁴ in this sign convention, scaling down
            # the (ȳ/y) ladder; no S4 term.
            K = 8.0 * a4_eff[:, k] * (n1 - n0) * mk
            s1 = s1 + K * y ** 4
            s2 = s2 + K * y ** 3 * yb
            s3 = s3 + K * y ** 2 * yb ** 2
            s5 = s5 + K * y * yb ** 3
        c1 = A * y * d_dnn * mk
        c2 = Ab * y * d_dnn * mk
        for name, val in zip(names, (s1, s2, s3, s4, s5, c1, c2)):
            sums[name].append(val)
        u, ub = u_new, ub_new
        tk = t[:, k]
        y = y + tk * u
        yb = yb + tk * ub

    per_surface = {k: torch.stack(v, dim=1) for k, v in sums.items()}
    out: Dict[str, torch.Tensor] = {k: torch.sum(v, dim=1) for k, v in per_surface.items()}
    out["H"] = H
    out["u_img"] = u
    out["per_surface"] = per_surface
    return out


def _a4_effective(lens: Lens) -> Optional[torch.Tensor]:
    """The extra 4th-order sag coefficient against the paraxial sphere,
    (B, S): the conic sag expands as (c/2)r² + (1+κ)c³/8·r⁴ + ..., and the
    even-asphere series adds ``asph[..., 0]``·r⁴, so a₄ = κ·c³/8 + asph₀."""
    a4 = None
    if lens.kappa is not None:
        a4 = lens.kappa * lens.c ** 3 / 8.0
    if lens.asph is not None:
        a4 = lens.asph[..., 0] if a4 is None else a4 + lens.asph[..., 0]
    return a4


def seidel_focal_shifts(seidel: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Predicted longitudinal focal shifts from the Seidel sums, (B,), in
    the real-ray analyses' convention (positive: focus beyond the image
    plane):

      ``lsa_marginal``     marginal-ray focus shift  -S1/(2·u'²)
      ``dz_t``/``dz_s``    tangential/sagittal field curvature at full field
                           -(3·S3 + S4)/(2·u'²), -(S3 + S4)/(2·u'²)
      ``chromatic_shift``  axial-colour focal shift  -C1/u'²
    """
    u2 = torch.clamp(seidel["u_img"] ** 2, min=1e-16)
    return {
        "lsa_marginal": -seidel["S1"] / (2.0 * u2),
        "dz_t": -(3.0 * seidel["S3"] + seidel["S4"]) / (2.0 * u2),
        "dz_s": -(seidel["S3"] + seidel["S4"]) / (2.0 * u2),
        "chromatic_shift": -seidel["C1"] / u2,
    }


def sensitivities(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Tolerance sensitivity table: d(spot RMS)/d(parameter), per surface.

    One ``torch.autograd.grad`` of the objective :func:`tolerance_analysis`
    scores (one forward and one backward launch of kernel K2, K4 for a
    conic/asphere design, with ``trace_engine="fused"``) in place of one
    re-trace per parameter. Returns ``{'c', 't', 'nd', 'v'[, 'kappa',
    'asph']}`` tensors shaped like the lens parameters; entries on padding
    surfaces are zero."""
    names = ["c", "t", "nd", "v"]
    if lens.kappa is not None:
        names.append("kappa")
    if lens.asph is not None:
        names.append("asph")
    params = {k: getattr(lens, k).detach().clone().requires_grad_(True) for k in names}
    with torch.enable_grad():
        rms = torch.sum(_per_sample_rms(specs, lens.replace(**params), config,
                                        generator=generator))
        grads = torch.autograd.grad(rms, [params[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
