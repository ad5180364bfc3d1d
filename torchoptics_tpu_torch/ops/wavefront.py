"""Wavefront analysis: optical path lengths, OPD maps, Zernike fits, the
Strehl ratio and the diffraction PSF.

PyTorch counterpart of ``torchoptics_tpu.ops.wavefront``, the wave-optics
layer on top of the differentiable trace:

* **OPL** per ray: the plane-wave phase at the entrance-pupil launch point
  (``y_p·sin(u)`` for field angle u) plus ``Σ_k n_k · d_k`` over the
  marching distances of every surface leg and the final leg to the image
  plane. On ``engine="unroll"`` it is the ``"dist"`` aggregate of
  ``trace.trace_skew`` contracted with the leg indices; on
  ``engine="fused"`` the opl mode of kernels K1-K4 accumulates it per ray,
  with its hand adjoint.
* **OPD**: OPL to the reference sphere (centred on the chief ray's image
  point, through the paraxial exit pupil), minus the chief ray's; each ray
  is marched back from the image plane onto the sphere in closed form.
* **Zernike** coefficients by least squares on the unit pupil disk (Noll
  indexing), and the **Strehl ratio** from the pupil phase sum.
* The **diffraction PSF**: the FFT of the pupil function, or a matrix DFT
  onto an image-plane pixel window at any pitch.

Everything is differentiable. OPD is a ~100 nm difference of ~100 mm path
sums, so float32 carries a few-nm noise floor; ``double_precision`` configs
(unroll engine) go below it.

Two choices differ from the JAX package. The pupil is sampled once and the
same points serve the trace and the launch phase (JAX samples twice with one
key; a ``torch.Generator`` would give other points the second time). The
back-march onto the reference sphere takes a square root whose argument can
reach zero; it is guarded so that its gradient is zero there (JAX's
``sqrt(maximum(., 0))`` gives NaN on such lanes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import pupil as pupil_mod
from torchoptics_tpu_torch.ops import trace as trace_mod

__all__ = [
    "optical_path_lengths", "exit_pupil_distance", "pupil_magnification", "opd_map",
    "zernike_basis", "zernike_fit", "strehl_ratio", "diffraction_psf",
    "diffraction_psf_window",
]


def optical_path_lengths(specs: Specs, lens: Lens, config: trace_mod.TraceConfig,
                         generator: Optional[torch.Generator] = None,
                         xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                         ) -> Tuple[trace_mod.TraceResult, torch.Tensor]:
    """Trace and return (result, OPL) with OPL (B, F, P, W) in mm, referred
    to the incoming plane wave through the entrance-pupil origin.

    ``config.engine="fused"`` runs the opl mode of kernel K1 (one spherical
    system), K3 (one conic/asphere system), K2 (a spherical population) or K4
    (a conic/asphere population; an absent ``kappa`` or ``asph`` as zeros).
    ``xy`` (relative pupil points, (1 or B, 1, P, 1)) defaults to one draw of
    ``config.mode``'s sampler, used by the trace and the launch phase alike.
    """
    cfg = config
    if xy is None:
        xy = pupil_mod.sample_pupil(cfg.mode, cfg.n_rays, len(lens), generator=generator,
                                    device=lens.device)
    if cfg.engine == "fused":
        if cfg.double_precision:
            raise NotImplementedError(
                "engine='fused' OPL is float32 (the kernels' per-ray accumulator); use "
                "engine='unroll' for double precision")
        from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, fused_trace
        if lens.is_spherical:
            if len(lens) == 1:
                return fused_trace.optical_paths_fused(specs, lens, cfg, xy=xy)
            return fused_batch.optical_paths_fused_batch(specs, lens, cfg, xy=xy)
        if len(lens) == 1:
            return fused_asphere.optical_paths_fused_asphere(specs, lens, cfg, xy=xy)
        return fused_asphere.optical_paths_fused_asphere_batch(specs, lens, cfg, xy=xy)
    if cfg.double_precision:
        # Cast here, so that the launch points below and the index table see
        # the values the trace computes with.
        specs = specs.to(dtype=torch.float64)
        lens = lens.to(dtype=torch.float64)
    res = trace_mod.trace_rays(specs, lens, cfg, xy=xy, aggregate=("dist",))
    dist = res.stacks["dist"]                                   # (S+1, B, F, P, W)
    dtype = dist.dtype
    # The index of the medium each leg travels in: air before surface 0, then
    # the gap indices (a padded gap carries n = 1 and a zero-length leg).
    n = lens.get_refractive_indices(cfg.wavelengths).to(dtype)   # (B, S, W)
    n_full = torch.cat((torch.ones_like(n[:, :1]), n), dim=1)    # (B, S+1, W)
    n_legs = n_full.permute(1, 0, 2)[:, :, None, None, :]         # (S+1, B, 1, 1, W)
    opl = torch.sum(dist * n_legs, dim=0)                        # (B, F, P, W)

    # Plane-wave launch phase: for field angle u the incoming wavefront
    # reaches launch point (x_p, y_p) with path advance y_p·sin(u). The
    # launch points are the trace's own: the same pupil points through the
    # same vignetting and ray aiming as trace.trace_rays.
    fields = torch.tensor(cfg.rel_fields, dtype=dtype, device=lens.device)
    u = (specs.hfov[:, None] * fields[None, :])[..., None, None]
    xp_rel, yp_rel = xy
    if cfg.vig_fn is not None and cfg.mode != "chief":
        vig_fields = fields[None, :]
        yp_rel = pupil_mod.apply_vignetting(yp_rel, cfg.vig_fn(vig_fields, specs.vig_up),
                                            cfg.vig_fn(vig_fields, specs.vig_down))
        vig_x = cfg.vig_fn(vig_fields, specs.vig_x)
        xp_rel = pupil_mod.apply_vignetting(xp_rel, vig_x, vig_x)
    if cfg.n_ray_aiming_iter > 0:
        from torchoptics_tpu_torch.ops import aiming
        aiming_fn = aiming.ray_aiming(specs, lens.detach(), cfg, True)
        xp_rel, yp_rel = [torch.clamp(v, -2.0, 2.0).detach()
                          for v in aiming_fn(xp_rel, yp_rel)]
    yp = pupil_mod.scale_to_epd(yp_rel, specs.epd).to(dtype)
    return res, opl + yp * torch.sin(u)


def _system_abcd(lens: Lens) -> torch.Tensor:
    nd = torch.cat((torch.ones_like(lens.nd[:, :1]), lens.nd), dim=1)
    return abcd_mod.reduce_abcd(abcd_mod.interface_propagation_abcd(lens.c, lens.t, nd))


def exit_pupil_distance(lens: Lens) -> torch.Tensor:
    """Paraxial exit-pupil distance from the image plane, (B,), signed
    (negative: the pupil before the image plane, the usual case). The
    paraxial chief ray (height 0 at the entrance pupil) crosses the axis at
    the exit pupil: z = -y_img / u_img."""
    z0 = abcd_mod.compute_pupil_position(lens)
    m = _system_abcd(lens)
    # The chief ray at surface 0 (before refraction): y = -z0·u with u = 1.
    y0 = -z0
    y_img = m[:, 0, 0] * y0 + m[:, 0, 1]
    u_img = m[:, 1, 0] * y0 + m[:, 1, 1]
    return -y_img / u_img


def pupil_magnification(lens: Lens) -> torch.Tensor:
    """Paraxial exit-/entrance-pupil size ratio, (B,): the marginal ray
    (height 1, slope 0 at the entrance pupil) at the exit-pupil plane. The
    transverse ray aberration then obeys ε ≈ (R / r_xp)·∂OPD/∂ρ with
    r_xp = m_p·EPD/2 and R the reference-sphere radius."""
    z_xp = exit_pupil_distance(lens)
    m = _system_abcd(lens)
    return m[:, 0, 0] + z_xp * m[:, 1, 0]


def opd_map(specs: Specs, lens: Lens, config: trace_mod.TraceConfig,
            generator: Optional[torch.Generator] = None,
            xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Dict[str, torch.Tensor]:
    """Optical path difference across the pupil, per (field, wavelength).

    Returns a dict:
      ``opd``  (B, F, P, W) OPD in mm on the reference sphere (positive: the
               wavefront lags the reference; the chief ray's is 0, piston is
               not removed beyond that);
      ``ok``   (B, F, P, W) valid-ray mask;
      ``x_img``, ``y_img`` (B, F, W) the chief ray's image points.

    The chief bundle is traced with the same config in ``mode='chief'``.
    """
    res, opl = optical_path_lengths(specs, lens, config, generator=generator, xy=xy)
    cfg_chief = dataclasses.replace(config, mode="chief", n_rays=(1,))
    res_c, opl_c = optical_path_lengths(specs, lens, cfg_chief)

    dtype = opl.dtype
    # The reference sphere: centred on the chief image point, through the
    # paraxial exit-pupil centre (0, 0, z_xp). The axial distance |z_xp| as
    # radius would add ~(r_p²/2)·ΔR/R² of spurious defocus off axis.
    z_xp = exit_pupil_distance(lens).to(dtype).reshape(-1, 1, 1, 1)
    x_c, y_c = res_c.x, res_c.y                                  # (B, F, 1, W)
    R = torch.sqrt(z_xp * z_xp + x_c * x_c + y_c * y_c)
    # Each ray back from its image-plane point onto the sphere:
    # |p0 - s·d - C| = R with p0 = (x, y, 0), C = (x_c, y_c, 0).
    qx = res.x - x_c
    qy = res.y - y_c
    qd = qx * res.cx + qy * res.cy
    q2 = qx * qx + qy * qy
    s = qd + trace_mod._safe_sqrt(qd * qd + R * R - q2)
    # The chief ray's own back-leg is R (q = 0). Image space is air.
    opd = (opl - s) - (opl_c - R)
    return {"opd": opd, "ok": res.ray_ok & res_c.ray_ok,
            "x_img": x_c[:, :, 0, :], "y_img": y_c[:, :, 0, :]}


# ---------------------------------------------------------------------------
# Zernike polynomials (Noll indexing, unit disk), Strehl ratio.
# ---------------------------------------------------------------------------


def _zernike_nm(j: int) -> Tuple[int, int]:
    """Noll index j (1-based) -> (n, m); m < 0 selects the sine term. Z4 is
    defocus, Z5/Z6 astigmatism, Z7/Z8 coma, Z11 primary spherical."""
    n = 0
    j1 = j - 1
    while j1 > n:
        n += 1
        j1 -= n
    m = (n % 2) + 2 * ((j1 + ((n + 1) % 2)) // 2)
    if j % 2 == 1:
        m = -m
    return n, m


def zernike_basis(j_max: int, xr: torch.Tensor, yr: torch.Tensor) -> torch.Tensor:
    """Zernike polynomials Z_1..Z_{j_max} (Noll, unit radius) at relative
    pupil coordinates. Returns (..., j_max)."""
    rho2 = xr * xr + yr * yr
    rho = torch.sqrt(torch.clamp(rho2, min=1e-30))
    theta = torch.atan2(yr, xr)
    cols = []
    for j in range(1, j_max + 1):
        n, m = _zernike_nm(j)
        am = abs(m)
        radial = torch.zeros_like(rho)
        for k in range((n - am) // 2 + 1):
            coef = ((-1) ** k * math.factorial(n - k)
                    / (math.factorial(k) * math.factorial((n + am) // 2 - k)
                       * math.factorial((n - am) // 2 - k)))
            radial = radial + coef * rho ** (n - 2 * k)
        norm = math.sqrt(2.0 * (n + 1)) if m != 0 else math.sqrt(n + 1.0)
        if m > 0:
            cols.append(norm * radial * torch.cos(am * theta))
        elif m < 0:
            cols.append(norm * radial * torch.sin(am * theta))
        else:
            cols.append(norm * radial)
    return torch.stack(cols, dim=-1)


def zernike_fit(opd: torch.Tensor, xr: torch.Tensor, yr: torch.Tensor, ok: torch.Tensor,
                j_max: int = 11) -> torch.Tensor:
    """Least-squares Noll coefficients (..., j_max) of ``opd`` sampled at
    relative pupil coordinates (the unit disk), failed rays weighted zero.
    The normal equations are summed elementwise, as the JAX package sums
    them, and solved with ``torch.linalg.solve``."""
    A = zernike_basis(j_max, xr, yr)                              # (..., P, K)
    w = ok.to(opd.dtype)[..., None]                               # (..., P, 1)
    Aw = A * w
    G = torch.sum(Aw[..., :, :, None] * Aw[..., :, None, :], dim=-3)
    b = torch.sum(Aw * (opd * w[..., 0])[..., None], dim=-2)
    # A Tikhonov floor keeps the solve finite when a mode is unsampled.
    G = G + 1e-12 * torch.eye(j_max, dtype=opd.dtype, device=opd.device)
    return torch.linalg.solve(G, b[..., None])[..., 0]


def strehl_ratio(opd: torch.Tensor, ok: torch.Tensor, wavelength_mm) -> torch.Tensor:
    """Strehl ratio from the pupil phase sum, |<exp(i 2π OPD/λ)>|² over valid
    rays (exact for uniformly sampled pupils; piston-invariant). ``opd``
    (..., P); ``wavelength_mm`` broadcastable."""
    phase = 2.0 * math.pi * opd / wavelength_mm
    w = ok.to(opd.dtype)
    nrm = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    re = torch.sum(w * torch.cos(phase), dim=-1) / nrm
    im = torch.sum(w * torch.sin(phase), dim=-1) / nrm
    return re * re + im * im


# ---------------------------------------------------------------------------
# Diffraction PSFs.
# ---------------------------------------------------------------------------


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def diffraction_psf(opd_grid: torch.Tensor, ok_grid: torch.Tensor, wavelength_mm,
                    pad: int = 4) -> Dict[str, torch.Tensor]:
    """Diffraction PSF as the Fraunhofer transform of the pupil function.

    Args:
      opd_grid: (..., N, N) OPD on a regular grid spanning the pupil square
        [-1, 1]²; entries outside the aperture are ignored.
      ok_grid: (..., N, N) aperture mask (vignetting, failures).
      pad: zero-padding factor (transform size pad·N).

    Returns a dict:
      ``psf``    (..., pad·N, pad·N), normalized so that a perfect wavefront
                 peaks at 1 (the centre pixel is the Strehl ratio);
      ``coords`` (pad·N,) image-plane coordinates in λ·f/# units (the first
                 Airy zero sits at 1.22).
    """
    N = opd_grid.shape[-1]
    amp = ok_grid.to(opd_grid.dtype)
    phase = 2.0 * math.pi * opd_grid / wavelength_mm
    pupil = amp * torch.exp(1j * phase.to(_complex_of(opd_grid.dtype)))
    M = pad * N
    field = torch.fft.fftshift(torch.fft.fft2(pupil, s=(M, M), dim=(-2, -1)), dim=(-2, -1))
    inten = torch.abs(field) ** 2
    peak_ideal = torch.sum(amp, dim=(-2, -1)) ** 2
    psf = inten / torch.clamp(peak_ideal, min=1.0)[..., None, None]
    # The pupil pitch is D/N, so the FFT's image-plane step is
    # λ·F/(M·D/N) = λ·f#/pad.
    coords = (torch.arange(M, device=opd_grid.device) - M // 2) / float(pad)
    return {"psf": psf, "coords": coords.to(opd_grid.dtype)}


def diffraction_psf_window(opd_grid: torch.Tensor, ok_grid: torch.Tensor, wavelength_mm,
                           R_mm, r_xp_mm, pitch_mm: float, shape: Tuple[int, int],
                           x_offset=0.0, y_offset=0.0, oversample: int = 4
                           ) -> Dict[str, torch.Tensor]:
    """Diffraction PSF on an image-plane pixel window at any sensor pitch: a
    matrix-DFT Fraunhofer evaluation of the pupil function, two complex
    products per (field, λ).

    Args:
      opd_grid: (..., N, N) OPD in mm on a regular pupil grid whose cell
        centres span [-1, 1]² of the relative pupil (axis -2 = y, -1 = x).
      ok_grid: (..., N, N) aperture mask.
      wavelength_mm, R_mm, r_xp_mm: wavelength, reference-sphere radius and
        exit-pupil semi-diameter in mm, broadcastable to the batch shape.
      pitch_mm: window pixel pitch on the sensor (mm).
      shape: (n_y, n_x); pixel (a, b) sits at ((a-(n_y-1)/2)·pitch +
        y_offset, (b-(n_x-1)/2)·pitch + x_offset) from the chief image point.
      x_offset, y_offset: (...,) offset of the window centre from the chief
        image point, mm.
      oversample: sub-samples per pixel axis; each pixel is the mean of an
        ``oversample``² sub-grid (the pixel-aperture model).

    The products run on the card's float32 path only: with
    ``torch.backends.cuda.matmul.allow_tf32`` set, cuBLAS would round their
    inputs to TF32 (10-bit mantissas), so this raises then.

    Returns a dict:
      ``psf``       (..., n_y, n_x) intensity with unit sum over the window;
      ``accounted`` (...,) the share of the PSF's energy inside the window
                    (Parseval: the total is the open pupil area).
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "diffraction_psf_window needs full float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    n_y, n_x = int(shape[0]), int(shape[1])
    N = opd_grid.shape[-1]
    bshape = tuple(opd_grid.shape[:-2])
    dtype, device = opd_grid.dtype, opd_grid.device
    cdtype = _complex_of(dtype)
    amp = ok_grid.to(dtype)
    batch = lambda v: torch.broadcast_to(torch.as_tensor(v, dtype=dtype, device=device),
                                         bshape).reshape(-1)
    lam, R, r_xp = batch(wavelength_mm), batch(R_mm), batch(r_xp_mm)
    x_off, y_off = batch(x_offset), batch(y_offset)

    # Physical pupil coordinates of the grid cell centres.
    g = (torch.arange(N, dtype=dtype, device=device) + 0.5) / N * 2.0 - 1.0
    u = g[None, :] * r_xp[:, None]                                # (bat, N)
    lam_r = lam * R
    q = max(int(oversample), 1)

    def sub(n):
        idx = (torch.arange(n * q, dtype=dtype, device=device) + 0.5) / q - 0.5
        return (idx - (n - 1) / 2.0) * pitch_mm

    oy = sub(n_y)[None, :] + y_off[:, None]                       # (bat, ny·q)
    ox = sub(n_x)[None, :] + x_off[:, None]                       # (bat, nx·q)
    # The pupil function with the wavefront phase (+i convention, as
    # diffraction_psf), then the separable DFT kernels e^{-i·2π·u·δ/(λR)}.
    phase = (2.0 * math.pi / lam).reshape(bshape + (1, 1)) * opd_grid
    pupil = (amp * torch.exp(1j * phase.to(cdtype))).reshape(-1, N, N)
    kernel = lambda o: torch.exp(-1j * (2.0 * math.pi * u[:, None, :] * o[:, :, None]
                                        / lam_r[:, None, None]).to(cdtype))
    ky, kx = kernel(oy), kernel(ox)                               # (bat, n·q, N)
    e = torch.matmul(torch.matmul(ky, pupil), kx.transpose(-1, -2))   # (bat, ny·q, nx·q)
    inten = e.real ** 2 + e.imag ** 2
    # Box-integrate the q x q sub-grid of each pixel.
    bat = inten.shape[0]
    inten = torch.mean(inten.reshape(bat, n_y, q, n_x, q), dim=(2, 4))

    # Energy accounting: the in-window Riemann sum against Parseval's total
    # Σamp²·ΔuΔv (the block mean already folded in the sub-pixel step).
    du = 2.0 * r_xp / N
    total = torch.clamp(torch.sum(amp.reshape(-1, N, N), dim=(-2, -1)), min=1.0)
    in_window = torch.sum(inten, dim=(-2, -1))
    accounted = (du * pitch_mm / lam_r) ** 2 * in_window / total
    psf = inten / torch.clamp(in_window, min=1e-20)[:, None, None]
    return {"psf": psf.reshape(bshape + (n_y, n_x)), "accounted": accounted.reshape(bshape)}
