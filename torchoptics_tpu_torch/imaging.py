"""End-to-end image formation: lens -> PSF grid -> aberrated sensor image.

PyTorch counterpart of ``torchoptics_tpu.imaging``::

    model = sample_optics_model(specs, lens, config)        # trace once
    irradiance, psnr, ssim = apply_optics_model(model, radiance, field_lim,
                                                config)      # render images

Rendering is differentiable, on the card too (kernel P2 has its adjoint), so
a lens trains on rendered image quality: :func:`image_quality_loss`, and
:func:`make_image_loss_fn` as ``LensOptimizer(loss_fn=...)``. On the fused
engine such a step launches K1 forward and backward once each, P2 once and
P2's d/dpsf once.

``sample_optics_model`` traces the PSF bundle (on kernel K1's plain mode
with ``trace_engine="fused"``, or K1's opl mode through ``opd_map`` with
``psf_source="diffraction"``), splats or transforms it into per-field PSFs,
and samples the distortion and the relative illumination.
``apply_optics_model`` blends, rotates and resizes the PSFs onto the patch
grid, convolves the image patch by patch (SVOLA, kernel P2 on the card),
scales by the illumination map and warps by the distortion field. Serve
under ``torch.no_grad()`` (ray aiming needs autograd, so not
``torch.inference_mode()``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch import simulator as sim_mod
from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import image as image_mod
from torchoptics_tpu_torch.ops import metrics as metrics_mod
from torchoptics_tpu_torch.ops import psf as psf_mod
from torchoptics_tpu_torch.ops import trace as trace_mod

__all__ = [
    "OpticsModel", "diffraction_sampling_report", "sample_optics_model", "sample_field_lim",
    "compute_distortion_shift", "resolve_max_warp_px", "required_warp_band", "patch_psfs",
    "apply_optics_model", "simulate", "image_quality_loss", "make_image_loss_fn",
]


class OpticsModel(NamedTuple):
    """Sampled optical data of one lens, ready for rendering."""
    sampled_psfs: torch.Tensor                                # (n_fields, ph, pw, 3)
    sampled_distortion_shifts: Optional[torch.Tensor]         # (n_fields,)
    sampled_relative_illumination: Optional[torch.Tensor]     # (n_fields,)
    y_center: torch.Tensor                                    # (n_fields,)
    # The PSF energy inside the sampling window: (n_fields,) ray fraction for
    # psf_source='geometric', (n_fields, channels) energy fraction for
    # 'diffraction' (> 1 there means DFT aliasing).
    accounted: Optional[torch.Tensor] = None


def _pupil_grid(config: sim_mod.SimulatorConfig, lens: Lens):
    """The regular pupil grid of the diffraction path, cell centres spanning
    [-1, 1]², and its in-circle mask."""
    n = int(config.diffraction_grid_n)
    g = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    X, Y = np.meshgrid(g, g, indexing="xy")
    incircle = (X ** 2 + Y ** 2) <= 1.0
    as_xy = lambda a: torch.tensor(a.ravel()[None, None, :, None], dtype=lens.dtype,
                                   device=lens.device)
    return n, incircle, (as_xy(X), as_xy(Y))


def _sample_diffraction_psfs(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
                             y_center: Optional[torch.Tensor]):
    """Per-field diffraction PSFs on the sensor window: the pupil function
    from one grid-sampled OPD trace (``wavefront.opd_map``; on the fused
    engine K1's opl mode), matrix-DFT'd onto the ``config.psf_shape`` x
    ``psf_abs_pixel_size`` window (``wavefront.diffraction_psf_window``),
    wavelengths grouped into channels as on the geometric path.

    ``psf_shape`` is read as (n_y, n_x) here and as (n_x, n_y) by the
    geometric path, and the exit-pupil radius r_xp = EPD/2 · m_p is not made
    unsigned, both as in the JAX package.

    Returns (psfs (F, n_y, n_x, C) image-oriented with unit sum per channel,
    accounted (F, C) in-window energy fraction, y_center (F,): the chief-ray
    image heights, mean over wavelengths, when not supplied)."""
    from torchoptics_tpu_torch.models import glass as glass_mod
    from torchoptics_tpu_torch.ops import wavefront as wf

    n, incircle, xy = _pupil_grid(config, lens)
    cfg = config.trace_config()
    out = wf.opd_map(specs, lens, cfg, xy=xy)
    opd = out["opd"][0]                                       # (F, P, W)
    ok = out["ok"][0] & torch.as_tensor(incircle.ravel(), device=lens.device)[None, :, None]
    F, _, W = opd.shape
    opd_g = opd.permute(0, 2, 1).reshape(F, W, n, n)
    ok_g = ok.permute(0, 2, 1).reshape(F, W, n, n)

    z_xp = wf.exit_pupil_distance(lens)[0]
    r_xp = specs.epd[0] / 2.0 * wf.pupil_magnification(lens)[0]
    x_img = out["x_img"][0]                                   # (F, W)
    y_img = out["y_img"][0]
    R = torch.sqrt(z_xp ** 2 + x_img ** 2 + y_img ** 2)
    if y_center is None:
        y_center = torch.mean(y_img, dim=1)                   # (F,)
    lam_mm = torch.tensor([w * 1e-6 for w in glass_mod.resolve_wavelengths(cfg.wavelengths)],
                          dtype=lens.dtype, device=lens.device)
    res = wf.diffraction_psf_window(opd_g, ok_g, lam_mm[None, :], R, r_xp,
                                    pitch_mm=config.psf_abs_pixel_size,
                                    shape=config.psf_shape, x_offset=-x_img,
                                    y_offset=y_center[:, None] - y_img,
                                    oversample=config.diffraction_oversample)
    psf_fw = res["psf"]                                       # (F, W, n_y, n_x)
    acc_fw = res["accounted"]                                 # (F, W)

    # Wavelength -> channel grouping, as an elementwise contraction.
    ch = np.asarray(psf_mod.channel_assignment(W, 3))
    onehot = torch.as_tensor(ch[None, :] == np.arange(3)[:, None], dtype=lens.dtype,
                             device=lens.device)              # (C, W)
    psfs = torch.sum(onehot[None, :, :, None, None] * psf_fw[:, None], dim=2)
    psfs = psfs / torch.clamp(torch.sum(psfs, dim=(-1, -2), keepdim=True), min=1e-20)
    accounted = (torch.sum(acc_fw[:, None, :] * onehot[None, :, :], dim=-1)
                 / torch.clamp(torch.sum(onehot, dim=1)[None, :], min=1.0))   # (F, C)
    psfs = psfs.permute(0, 2, 3, 1)                           # (F, n_y, n_x, C)
    return torch.flip(psfs, dims=(1,)), accounted, y_center


def diffraction_sampling_report(specs: Specs, lens: Lens,
                                config: sim_mod.SimulatorConfig) -> Dict:
    """Host-side adequacy check of the ``psf_source='diffraction'`` sampling
    parameters, as the JAX package's: the pupil-phase Nyquist condition
    (``diffraction_grid_n`` >= ~4 x the worst peak-to-valley OPD in waves),
    the DFT alias period against the window plus the geometric blur, and the
    sub-pixel pitch against the intensity Nyquist pitch. Returns the measured
    numbers, an ``ok`` flag and ``warnings``. The pupil is the fixed grid,
    so no generator is taken."""
    from torchoptics_tpu_torch.models import glass as glass_mod
    from torchoptics_tpu_torch.ops import wavefront as wf

    n, incircle, xy = _pupil_grid(config, lens)
    cfg = config.trace_config()
    with torch.no_grad():
        out = wf.opd_map(specs, lens, cfg, xy=xy)
        opd = out["opd"][0].cpu().numpy()                     # (F, P, W)
        ok = out["ok"][0].cpu().numpy() & incircle.ravel()[None, :, None]
        z_xp = float(wf.exit_pupil_distance(lens)[0])
        r_xp = float(specs.epd[0] / 2.0 * wf.pupil_magnification(lens)[0])
    lam_mm = np.asarray(glass_mod.resolve_wavelengths(cfg.wavelengths)) * 1e-6
    pv_waves = 0.0
    blur_mm = 0.0
    for f in range(opd.shape[0]):
        for w in range(opd.shape[2]):
            sel = ok[f, :, w]
            if not sel.any():
                continue
            vals = opd[f, sel, w]
            pv_waves = max(pv_waves, float(np.ptp(vals)) / lam_mm[w])
            # Transverse blur radius from the wavefront slope:
            # eps ~ (R / r_xp) · dOPD/drho, bounded by P-V over one grid step.
            grid = np.where(sel.reshape(n, n), opd[f, :, w].reshape(n, n), np.nan)
            gy = np.abs(np.diff(grid, axis=0))
            gx = np.abs(np.diff(grid, axis=1))
            slope = np.nanmax([np.nanmax(gy, initial=0.0),
                               np.nanmax(gx, initial=0.0)]) / (2.0 / n)
            blur_mm = max(blur_mm, abs(z_xp) / r_xp * float(slope))
    fno = abs(z_xp) / (2.0 * r_xp)
    lam_min = float(lam_mm.min())
    alias_mm = lam_min * abs(z_xp) * n / (2.0 * r_xp)
    window_mm = math.hypot(*config.psf_shape) / 2.0 * config.psf_abs_pixel_size
    sub_pitch = config.psf_abs_pixel_size / max(int(config.diffraction_oversample), 1)
    nyq_pitch = lam_min * fno / 2.0
    warnings = []
    if n < 4.0 * pv_waves:
        warnings.append(
            f"pupil grid {n} undersamples {pv_waves:.1f}λ P-V OPD — set "
            f"diffraction_grid_n >= {int(math.ceil(4 * pv_waves))} (or use "
            f"psf_source='geometric': this lens is aberration-dominated)")
    if alias_mm < window_mm + blur_mm:
        warnings.append(
            f"DFT alias period {alias_mm * 1e3:.0f} um < window+blur "
            f"{(window_mm + blur_mm) * 1e3:.0f} um — replicas fold into the window "
            f"(accounted > 1 is the symptom); raise diffraction_grid_n")
    if sub_pitch > 1.5 * nyq_pitch:
        warnings.append(
            f"sub-pixel pitch {sub_pitch * 1e3:.2f} um > ~1.5x the intensity Nyquist pitch "
            f"{nyq_pitch * 1e3:.2f} um (λ·f#/2) — raise diffraction_oversample")
    return {"pv_waves": pv_waves, "blur_mm": blur_mm, "alias_mm": alias_mm,
            "window_mm": window_mm, "sub_pitch_mm": sub_pitch,
            "nyquist_pitch_mm": nyq_pitch, "fno_working": fno,
            "ok": not warnings, "warnings": warnings}


def sample_optics_model(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
                        generator: Optional[torch.Generator] = None) -> OpticsModel:
    """Trace the lens and sample the PSFs, the distortion and the relative
    illumination at ``config.n_sampled_fields`` field values.

    ``config.psf_source`` selects the PSF physics: ``'geometric'`` (the ray
    splat of :func:`ops.psf.sample_psfs`, one launch of kernel S1 on the
    card; with ``trace_engine='fused'`` the bundle is one launch of kernel
    K1's plain mode) or ``'diffraction'``
    (the pupil-function transform; K1's opl mode through ``opd_map``)."""
    cfg = config.trace_config()
    n_fields = len(cfg.rel_fields)

    if config.apply_distortion and not config.distortion_by_warping:
        y_center = abcd_mod.get_paraxial_heights_at_image_plane(
            specs, lens, np.linspace(0, 1, n_fields))[0]
    else:
        y_center = None

    if config.psf_source == "diffraction":
        psfs, accounted, y_center = _sample_diffraction_psfs(specs, lens, config, y_center)
    elif config.psf_source == "geometric":
        res = trace_mod.trace_rays(specs, lens, cfg, generator=generator)
        if y_center is None:
            y_center = torch.mean(res.y.reshape(n_fields, -1), dim=1)
        psfs, accounted = psf_mod.sample_psfs(res.x, res.y, y_center, config.psf_shape,
                                              config.psf_abs_pixel_size)
    else:
        raise ValueError(f"psf_source must be 'geometric' or 'diffraction', got "
                         f"{config.psf_source!r}")
    psfs = image_mod.ensure_finite(psfs, 0.0)
    accounted = image_mod.ensure_finite(accounted, 0.0)

    shifts = None
    if config.apply_distortion and config.distortion_by_warping:
        shifts = image_mod.ensure_finite(
            image_mod.sample_distortion_shifts(specs, lens, y_center), 0.0)

    rel_illum = None
    if config.apply_relative_illumination:
        mean_wavelength = float(np.mean(config.wavelengths))
        ri = metrics_mod.compute_relative_illumination(
            specs, lens, tuple(np.linspace(0, 1, n_fields)), wavelengths=(mean_wavelength,),
            n_ray_aiming_iter=config.n_ray_aiming_iter)[0, :, 0]
        rel_illum = image_mod.ensure_finite(ri, 1.0)
    return OpticsModel(psfs, shifts, rel_illum, y_center, accounted)


def sample_field_lim(img_h: int, img_w: int, simulated_res_factor: int = 1,
                     roi_index: int = 0) -> Tuple[float, float, float, float]:
    """Object-space coordinates of the image corners, normalized so that
    x² + y² = 1 is the full-field edge."""
    factor = int(simulated_res_factor)
    roi_index = roi_index % (factor ** 2)
    row, col = roi_index // factor, roi_index % factor
    diag = math.sqrt(img_h ** 2 + img_w ** 2)
    y0 = -img_h / diag * (2 * row / factor - 1)
    y1 = -img_h / diag * (2 * (row + 1) / factor - 1)
    x0 = img_w / diag * (2 * col / factor - 1)
    x1 = img_w / diag * (2 * (col + 1) / factor - 1)
    return x0, x1, y0, y1


def compute_distortion_shift(model: OpticsModel, x, y, x_lim, y_lim, field_lim):
    """Distortion shift of image coordinates (relative to x_lim / y_lim)."""
    x0, x1, y0, y1 = field_lim
    x_field = (x - x_lim[0]) / (x_lim[1] - x_lim[0]) * (x1 - x0) + x0
    y_field = (y - y_lim[0]) / (y_lim[1] - y_lim[0]) * (y1 - y0) + y0
    dx_f, dy_f = image_mod.interpolate_distortion_shifts(model.sampled_distortion_shifts,
                                                         x_field, y_field)
    delta_x = dx_f * (x_lim[1] - x_lim[0]) / (x1 - x0)
    delta_y = dy_f * (y_lim[1] - y_lim[0]) / (y1 - y0)
    return delta_x, delta_y


def resolve_max_warp_px(config: sim_mod.SimulatorConfig, img_h: int, img_w: int) -> int:
    """Per-axis shift bound of the separable and tap warps:
    ``config.max_warp_px`` if set, else ceil(4.5 % of the image half-diagonal),
    at least 8 px. Those warps clamp shifts into the band; an
    :func:`apply_optics_model` call whose shifts exceed it raises."""
    if config.max_warp_px is not None:
        return int(config.max_warp_px)
    half_diag = 0.5 * math.sqrt(img_h ** 2 + img_w ** 2)
    return max(8, int(math.ceil(0.045 * half_diag)))


def required_warp_band(model: OpticsModel, field_lim, img_h: int, img_w: int,
                       n_grid: int = 129) -> torch.Tensor:
    """Largest |distortion shift| in pixels over the image, on an
    ``n_grid``² pixel grid that includes the exact corners: the per-axis band
    the separable and tap warps need to render ``model`` unclamped."""
    shifts = model.sampled_distortion_shifts
    if shifts is None:
        return torch.zeros(())
    dtype, device = shifts.dtype, shifts.device
    ii = torch.linspace(0.0, float(img_h - 1), n_grid, dtype=dtype, device=device)[:, None]
    jj = torch.linspace(0.0, float(img_w - 1), n_grid, dtype=dtype, device=device)[None, :]
    xn = jj * (2.0 / (img_w - 1)) - 1.0
    yn = ii * (2.0 / (img_h - 1)) - 1.0
    xn, yn = torch.broadcast_tensors(xn, yn)
    dx, dy = compute_distortion_shift(model, xn, yn, (-1, 1), (-1, 1), field_lim)
    return torch.maximum(torch.amax(torch.abs(dx)) * (img_w - 1) / 2.0,
                         torch.amax(torch.abs(dy)) * (img_h - 1) / 2.0)


def psf_kernel_shape(img_hw: Tuple[int, int], config) -> Tuple[int, int]:
    """(kh, kw) of the patch PSFs at an image of ``img_hw`` pixels: the PSF
    window at the sensor's pixel pitch for this diagonal, odd, at least 3."""
    diag = math.sqrt(img_hw[0] ** 2 + img_hw[1] ** 2)
    resized = (np.asarray(config.psf_shape) * config.psf_abs_pixel_size
               * int(config.simulated_res_factor) * diag / config.sensor_diagonal)
    resized = np.maximum((np.floor(resized / 2) * 2 + 1).astype(int), 3)
    return tuple(int(v) for v in resized)


def patch_psfs(model: OpticsModel, img_hw: Tuple[int, int], field_lim,
               config: sim_mod.SimulatorConfig):
    """The PSF of each SVOLA patch of an (H, W) render: the per-field PSFs
    blended onto the patch grid, rotated to each patch's azimuth and resized
    to the simulated resolution (odd, at least 3). Returns (psfs (1, N, kh,
    kw, C), the half-overlap (oh, ow) of the patches, the (H, W) normalized
    field-radius map)."""
    x0, x1, y0, y1 = (float(v) for v in field_lim)
    img_h, img_w = img_hw
    y_map = np.linspace(y0, y1, img_h, dtype=np.float32)
    x_map = np.linspace(x0, x1, img_w, dtype=np.float32)
    # Static geometry, in numpy: the per-patch PSF weights and the
    # illumination map's hat weights come from it.
    field_map = np.sqrt(x_map[None, :] ** 2 + y_map[:, None] ** 2)
    gh, gw = config.psf_grid_shape
    psfs = image_mod.interpolate_psfs(model.sampled_psfs, field_map, (gh, gw))
    psfs = image_mod.rotate_and_resize_psfs(psfs, x_map, y_map, (gh, gw),
                                            psf_kernel_shape(img_hw, config))
    overlap = tuple(int(v) for v in (0.25 * np.asarray(img_hw)
                                     / np.asarray(config.psf_grid_shape)).astype(int))
    return psfs, overlap, field_map


def apply_optics_model(model: OpticsModel, radiance: torch.Tensor, field_lim,
                       config: sim_mod.SimulatorConfig, max_value: float = 255.0):
    """Render the aberrated image.

    Args:
      model: sampled optics (PSFs per field, distortion, illumination).
      radiance: (B, H, W, 3) ideal image, on the model's device.
      field_lim: (x0, x1, y0, y1) object-space limits of the image (Python
        floats: they fix the patch geometry).

    Returns (irradiance, psnr, ssim). The warp methods ``'separable'``
    (default) and ``'taps'`` clamp shifts into :func:`resolve_max_warp_px`'s
    band and raise when :func:`required_warp_band` exceeds it;
    ``'gather'`` is exact for any shift.
    """
    img_h, img_w = radiance.shape[1:3]
    psfs, overlap, field_map = patch_psfs(model, (img_h, img_w), field_lim, config)
    irradiance = image_mod.svola_convolution(
        radiance, overlap, torch.broadcast_to(psfs, (radiance.shape[0],) + psfs.shape[1:]),
        config.psf_grid_shape, "hann")

    psnr = image_mod.psnr(radiance, irradiance, max_value)
    ssim = image_mod.ssim(radiance, irradiance, max_value)

    if config.apply_relative_illumination and model.sampled_relative_illumination is not None:
        ri_map = image_mod.interpolate_relative_illumination(
            model.sampled_relative_illumination,
            torch.as_tensor(field_map, device=irradiance.device))
        irradiance = irradiance * ri_map[None, ..., None]

    if config.apply_distortion and config.distortion_by_warping and \
            model.sampled_distortion_shifts is not None:
        # The shift field in pixels at float pixel coordinates (the [-1, 1]
        # grid maps column j to pixel j exactly: shift_px =
        # shift_norm · (N - 1) / 2).
        def shifts_px(iip, jjp):
            xn = jjp * (2.0 / (img_w - 1)) - 1.0
            yn = iip * (2.0 / (img_h - 1)) - 1.0
            xn, yn = torch.broadcast_tensors(xn, yn)
            dx, dy = compute_distortion_shift(model, xn, yn, (-1, 1), (-1, 1), field_lim)
            return dx * (img_w - 1) / 2.0, dy * (img_h - 1) / 2.0

        warp_band = resolve_max_warp_px(config, img_h, img_w)
        if config.warp_method in ("separable", "taps"):
            # The band clamps shifts; a lens whose shifts exceed it would
            # render with flattened corners, so it raises instead.
            with torch.no_grad():
                need = float(required_warp_band(model, field_lim, img_h, img_w))
            if need > warp_band:
                raise ValueError(
                    f"distortion shifts reach {need:.1f} px but the static warp band is "
                    f"{warp_band} px — tap-sum warping would clamp the corners. Set "
                    f"SimulatorConfig.max_warp_px >= {math.ceil(need)} or use "
                    f"warp_method='gather' (exact for any shift).")
        dtype, device = irradiance.dtype, irradiance.device
        if config.warp_method == "separable":
            irradiance = image_mod.warp_bicubic_separable(
                irradiance, lambda ii, jj: shifts_px(ii, jj)[0],
                lambda ii, jj: shifts_px(ii, jj)[1], warp_band)
        elif config.warp_method == "taps":
            ii = torch.arange(img_h, dtype=dtype, device=device)[:, None]
            jj = torch.arange(img_w, dtype=dtype, device=device)[None, :]
            sx_px, sy_px = shifts_px(ii, jj)
            irradiance = image_mod.warp_bicubic_shifts(irradiance, sx_px, sy_px, warp_band)
        elif config.warp_method == "gather":
            x_img = torch.broadcast_to(
                torch.linspace(-1.0, 1.0, img_w, dtype=dtype, device=device)[None, :],
                (img_h, img_w)).reshape(-1)
            y_img = torch.broadcast_to(
                torch.linspace(-1.0, 1.0, img_h, dtype=dtype, device=device)[:, None],
                (img_h, img_w)).reshape(-1)
            x_shift, y_shift = compute_distortion_shift(model, x_img, y_img, (-1, 1), (-1, 1),
                                                        field_lim)
            irradiance = image_mod.apply_distortion_by_warping(irradiance, x_img - x_shift,
                                                               y_img - y_shift)
        else:
            raise ValueError(f"warp_method must be 'separable', 'gather', or 'taps', got "
                             f"{config.warp_method!r}")
    return irradiance, psnr, ssim


def simulate(specs: Specs, lens: Lens, radiance: torch.Tensor,
             config: sim_mod.SimulatorConfig, generator: Optional[torch.Generator] = None,
             field_lim=None, roi_index: int = 0):
    """One call: sample the optics model and render ``radiance``."""
    model = sample_optics_model(specs, lens, config, generator=generator)
    if field_lim is None:
        field_lim = sample_field_lim(radiance.shape[1], radiance.shape[2],
                                     config.simulated_res_factor, roi_index)
    return apply_optics_model(model, radiance, field_lim, config)


def image_quality_loss(specs: Specs, lens: Lens, radiance: torch.Tensor,
                       config: sim_mod.SimulatorConfig,
                       generator: Optional[torch.Generator] = None,
                       field_lim=None, roi_index: int = 0, ssim_weight: float = 0.0,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Differentiable image-quality objective for lens design: ``-PSNR +
    ssim_weight · (1 - SSIM)`` of the rendered sensor image against the
    ideal radiance (expected in [0, 255]), batch means.

    PSNR and SSIM are taken before the illumination map and the warp (as
    :func:`apply_optics_model` returns them), so the loss reaches the lens
    through the PSFs: trace -> PSF splat -> SVOLA (P2 and its d/dpsf kernel
    on the card).

    Returns ``(total, {"psnr", "ssim", "image_loss", "psf_accounted"})``;
    ``psf_accounted`` is the mean in-window PSF energy fraction. Once a blur
    spot outgrows the ``psf_shape × psf_abs_pixel_size`` window the clipped
    PSF is renormalized and the rendered image stops degrading, so watch it
    and keep starting perturbations inside the window.
    """
    model = sample_optics_model(specs, lens, config, generator=generator)
    if field_lim is None:
        field_lim = sample_field_lim(radiance.shape[1], radiance.shape[2],
                                     config.simulated_res_factor, roi_index)
    _, psnr, ssim = apply_optics_model(model, radiance, field_lim, config)
    psnr = torch.mean(psnr)
    ssim = torch.mean(ssim)
    total = -psnr + ssim_weight * (1.0 - ssim)
    return total, {"psnr": psnr, "ssim": ssim, "image_loss": total,
                   "psf_accounted": torch.mean(model.accounted)}


def make_image_loss_fn(radiance: torch.Tensor, ssim_weight: float = 0.0, field_lim=None,
                       roi_index: int = 0):
    """:func:`image_quality_loss` with ``LensOptimizer.loss_fn``'s signature
    ``(specs, lens, config, g, catalog_g, generator)``, so a stock
    :class:`~torchoptics_tpu_torch.optimize.LensOptimizer` runs Adam on
    rendered image quality instead of the ray-space loss."""
    def loss_fn(specs, lens, config, g, catalog_g, generator):
        del g, catalog_g
        return image_quality_loss(specs, lens, radiance, config, generator=generator,
                                  field_lim=field_lim, roi_index=roi_index,
                                  ssim_weight=ssim_weight)
    return loss_fn
