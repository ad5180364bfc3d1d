"""Point-spread functions from traced spot coordinates.

PyTorch counterpart of ``torchoptics_tpu.ops.psf``: the soft-histogram PSF.
Rays are splatted onto a pixel grid with a Gaussian of sigma = pixel / 2,
the x half is mirrored (lens systems are meridionally symmetric), and each
kernel is normalized to unit area. Differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def compute_psf(x: torch.Tensor, y: torch.Tensor, n_bins: Tuple[int, int] = (21, 21),
                increment: Optional[float] = None, y_target: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None):
    """Soft-histogram PSF per (system, field) grid.

    Args:
      x, y: spot coordinates, (n_lens, n_fields, n_channels, n_rays)
        (channels before rays).
      n_bins: (n_x_bins, n_y_bins) PSF grid size.
      increment: pixel pitch; None sizes the grid from the data extents.
      y_target: (n_lens * n_fields,) grid centres; None uses the y centroid.
      weights: optional per-ray splat weights, broadcastable to
        (n_lens * n_fields, n_channels, n_rays): they assign wavelengths to
        colour channels (zero weight = the ray is invisible to the channel);
        the accounted fraction is weighted alike.

    Returns:
      (x_size, y_size, y_target, kernels, accounted_ray_proportion), kernels
      (n_grids, n_channels, n_y_bins, n_x_bins).
    """
    nw = x.shape[-2]
    n_grids = x.shape[0] * x.shape[1]
    n_x_bins, n_y_bins = n_bins
    dtype, device = x.dtype, x.device

    if y_target is None:
        y_target = torch.mean(y.reshape(n_grids, -1), dim=1)
    y = y.reshape(n_grids, nw, -1) - y_target[:, None, None]
    x = x.reshape(n_grids, nw, -1)

    if increment is not None:
        x_incr = y_incr = torch.full((n_grids,), increment, dtype=dtype, device=device)
        x_size = torch.full((n_grids,), increment * n_x_bins, dtype=dtype, device=device)
        y_size = torch.full((n_grids,), increment * n_y_bins, dtype=dtype, device=device)
    else:
        y_min = torch.amin(y.reshape(n_grids, -1), dim=1)
        y_max = torch.amax(y.reshape(n_grids, -1), dim=1)
        x_size = torch.amax(x.reshape(n_grids, -1), dim=1)
        y_size = 2 * torch.maximum(y_max, -y_min)
        x_incr = x_size / n_x_bins
        y_incr = y_size / n_y_bins

    # Half-grid pixel centres in x (the meridional symmetry fold).
    if n_x_bins % 2 == 1:
        gx = torch.arange(n_x_bins // 2 + 1, dtype=dtype, device=device)[None, :] * x_incr[:, None]
    else:
        gx = ((torch.arange(n_x_bins // 2, dtype=dtype, device=device) + 0.5)[None, :]
              * x_incr[:, None])
    gy = ((torch.arange(n_y_bins, dtype=dtype, device=device) + 0.5 - n_y_bins / 2)[None, :]
          * y_incr[:, None])

    sigma_x = x_incr / 2
    sigma_y = y_incr / 2
    dx2 = (x.reshape(n_grids, nw, 1, 1, -1) - gx.reshape(n_grids, 1, 1, -1, 1)) ** 2
    dy2 = (y.reshape(n_grids, nw, 1, 1, -1) - gy.reshape(n_grids, 1, -1, 1, 1)) ** 2
    gaussian = (torch.exp(-(dx2 / sigma_x.reshape(-1, 1, 1, 1, 1) ** 2) / 2)
                * torch.exp(-(dy2 / sigma_y.reshape(-1, 1, 1, 1, 1) ** 2) / 2))
    if weights is not None:
        weights = torch.broadcast_to(torch.as_tensor(weights, dtype=dtype, device=device),
                                     x.shape)                    # (g, nw, n_rays)
        gaussian = gaussian * weights[:, :, None, None, :]
    kernels = torch.sum(gaussian, dim=-1)                         # (g, nw, n_y, n_x_half)

    if n_x_bins % 2 == 1:
        kernels = torch.cat((torch.flip(kernels[..., 1:], dims=(-1,)), kernels), dim=-1)
    else:
        kernels = torch.cat((torch.flip(kernels, dims=(-1,)), kernels), dim=-1)

    # The floor guards channels with no assigned wavelength (W < channels); a
    # real channel's Gaussian sum is strictly positive, so it is exact there.
    kernels = kernels / torch.clamp(torch.sum(kernels, dim=(-1, -2), keepdim=True), min=1e-20)

    accounted = ((torch.abs(y) < y_size[:, None, None] / 2)
                 & (torch.abs(x) < x_size[:, None, None] / 2)).to(dtype)
    if weights is None:
        accounted_ray_proportion = torch.mean(accounted, dim=(-1, -2))
    else:
        wsum = torch.clamp(torch.sum(weights, dim=(-1, -2)), min=1e-20)
        accounted_ray_proportion = torch.sum(accounted * weights, dim=(-1, -2)) / wsum
    return x_size, y_size, y_target, kernels, accounted_ray_proportion


def compute_mtf(psf: torch.Tensor, pixel_size: float):
    """Geometric MTF from a sampled PSF: the magnitude of the 1-D transforms
    of its line-spread functions, each normalized by its DC term.

    Args:
      psf: (..., n_y, n_x) sampled PSF (any non-negative normalization).
      pixel_size: PSF grid pitch in mm.

    Returns:
      dict with ``freqs_t`` / ``mtf_t``, the tangential cut (modulation
      along y; (n_y//2+1,) and (..., n_y//2+1)), and ``freqs_s`` / ``mtf_s``,
      the sagittal cut (along x). Frequencies in cycles / mm.
    """
    n_y, n_x = psf.shape[-2], psf.shape[-1]
    lsf_y = torch.sum(psf, dim=-1)
    lsf_x = torch.sum(psf, dim=-2)
    mtf_t = torch.abs(torch.fft.rfft(lsf_y, dim=-1))
    mtf_s = torch.abs(torch.fft.rfft(lsf_x, dim=-1))
    mtf_t = mtf_t / torch.clamp(mtf_t[..., :1], min=1e-20)
    mtf_s = mtf_s / torch.clamp(mtf_s[..., :1], min=1e-20)
    as_t = lambda a: torch.as_tensor(a, dtype=psf.dtype, device=psf.device)
    return {"freqs_t": as_t(np.fft.rfftfreq(n_y, d=pixel_size)), "mtf_t": mtf_t,
            "freqs_s": as_t(np.fft.rfftfreq(n_x, d=pixel_size)), "mtf_s": mtf_s}


def channel_assignment(n_wavelengths: int, n_channels: int = 3):
    """Static wavelength -> colour-channel map: consecutive groups, sized as
    evenly as possible (``channel_of[i] = i * C // W``)."""
    return [i * n_channels // n_wavelengths for i in range(n_wavelengths)]


def sample_psfs(x: torch.Tensor, y: torch.Tensor, y_center: torch.Tensor,
                psf_size: Tuple[int, int], psf_increment: float, n_channels: int = 3):
    """Sample per-field PSFs from trace outputs.

    Args:
      x, y: (1, n_fields, n_pupil, n_wavelengths) spot coordinates.
      y_center: (n_fields,) PSF grid centres on the image plane.
      n_channels: colour channels of the rendered image. Wavelengths are
        grouped into channels by :func:`channel_assignment`.

    Returns:
      (psfs, accounted_energy): psfs (n_fields, n_y, n_x, n_channels),
      flipped vertically to image orientation.
    """
    W = x.shape[-1]
    x = x.permute(0, 1, 3, 2)                                  # (1, F, W, P)
    y = y.permute(0, 1, 3, 2)
    weights = None
    if W % n_channels == 0:
        # Even grouping: an exact reshape, no redundant splats.
        x = x.reshape(*x.shape[:2], n_channels, -1)
        y = y.reshape(*y.shape[:2], n_channels, -1)
    else:
        # Uneven W: every ray splats into every channel with a static one-hot
        # weight selecting its assigned channel.
        ch = np.asarray(channel_assignment(W, n_channels))
        onehot = ch[None, :] == np.arange(n_channels)[:, None]
        P = x.shape[-1]
        weights = torch.as_tensor(np.repeat(onehot, P, axis=1)[None], dtype=x.dtype,
                                  device=x.device)            # (1, C, W*P)
        x = torch.broadcast_to(x.reshape(*x.shape[:2], 1, -1),
                               x.shape[:2] + (n_channels, W * P))
        y = torch.broadcast_to(y.reshape(*y.shape[:2], 1, -1),
                               y.shape[:2] + (n_channels, W * P))

    # Mirror every ray in x (meridional symmetry).
    x = torch.cat((x, -x), dim=3)
    y = torch.cat((y, y), dim=3)
    if weights is not None:
        weights = torch.cat((weights, weights), dim=2)

    *_, psfs, accounted = compute_psf(x, y, n_bins=psf_size, increment=psf_increment,
                                      y_target=y_center, weights=weights)
    psfs = psfs.permute(0, 2, 3, 1)                            # (F, n_y, n_x, C)
    return torch.flip(psfs, dims=(1,)), accounted
