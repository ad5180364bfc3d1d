"""Glass parameterization and chromatic dispersion.

PyTorch counterpart of ``torchoptics_tpu.models.glass``: the
named-wavelength table, the invertible (n_d, V_d) whitening map, the
two-parameter Cauchy model, the 3-line linear-partial-dispersion model, and
the glass catalogs with the straight-through snap of quantized-continuous
glass variables.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models.catalog import OHARA_GLASSES

# Fraunhofer line wavelengths [nm]
WAVELENGTH_NAMES = {"C": 656.3, "d": 587.6, "F": 486.1}
W_C, W_D, W_F = 656.3, 587.6, 486.1

# Whitening map constants, kept bit-identical with the JAX package so trained
# generators transfer.
_G_W = np.array(
    [[-7.497527849096219, -7.49752916467739],
     [0.07842101471405442, -0.07842100095362642]], dtype=np.float64)
_G_MEAN = np.array([[1.6426209211349487, 48.8505973815918]], dtype=np.float64)
_NV_W = np.array(
    [[-0.06668863644654068, 6.3758429552417315],
     [-0.0666886481483064, -6.375841836481304]], dtype=np.float64)


def resolve_wavelengths(wavelengths) -> Tuple[float, ...]:
    """Map named Fraunhofer lines ('C'/'d'/'F') to nm; pass floats through."""
    return tuple(WAVELENGTH_NAMES[w] if isinstance(w, str) else float(w)
                 for w in wavelengths)


def g_from_n_v(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N,) n_d, (N,) V_d -> (N, 2) normalized glass variables, written
    elementwise so the 2x2 map runs in exact float32."""
    dn = n - _G_MEAN[0, 0]
    dv = v - _G_MEAN[0, 1]
    g0 = dn * _G_W[0, 0] + dv * _G_W[1, 0]
    g1 = dn * _G_W[0, 1] + dv * _G_W[1, 1]
    return torch.stack((g0, g1), dim=-1)


def n_v_from_g(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) normalized glass variables -> ((N,) n_d, (N,) V_d), elementwise
    like ``g_from_n_v``."""
    g0, g1 = g[..., 0], g[..., 1]
    n = g0 * _NV_W[0, 0] + g1 * _NV_W[1, 0] + _G_MEAN[0, 0]
    v = g0 * _NV_W[0, 1] + g1 * _NV_W[1, 1] + _G_MEAN[0, 1]
    return n, v


def catalog_distances(g: torch.Tensor, catalog_g: torch.Tensor) -> torch.Tensor:
    """(N, M) L2 distances of each glass variable to each catalog glass, as
    sqrt(sum(d * d)): the JAX package's ``jnp.linalg.norm``, whose gradient
    is NaN at a zero distance (``torch.linalg.norm`` would give 0 there)."""
    d = g[:, None, :] - catalog_g[None, :, :]
    return torch.sqrt(torch.sum(d * d, dim=-1))


def catalog_glass_indices(g: torch.Tensor, catalog_g: torch.Tensor) -> torch.Tensor:
    """Index of the closest catalog glass for each glass variable (the first
    one on a tie)."""
    return torch.argmin(catalog_distances(g, catalog_g), dim=1)


def map_glass_to_closest(g: torch.Tensor, catalog_g: torch.Tensor) -> torch.Tensor:
    """Snap each continuous glass variable to its nearest catalog glass (L2)."""
    return catalog_g[catalog_glass_indices(g, catalog_g)]


def quantize_glass_st(g: torch.Tensor, catalog_g: torch.Tensor) -> torch.Tensor:
    """Quantized-continuous glass with a straight-through gradient: the
    forward snaps to the catalog, the backward is the identity."""
    snapped = map_glass_to_closest(g, catalog_g)
    return g + (snapped - g).detach()


def _catalog_g(raw: np.ndarray, device, dtype) -> torch.Tensor:
    n = torch.tensor(raw[:, 0], dtype=dtype, device=device)
    v = torch.tensor(raw[:, 1], dtype=dtype, device=device)
    return g_from_n_v(n, v).reshape(-1, 2)


def load_catalog(path: str, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Load a headerless CSV glass catalog of (n_d, V_d) rows and return the
    normalized ``g`` coordinates, shape (N, 2)."""
    return _catalog_g(np.loadtxt(path, delimiter=",", dtype=np.float32).reshape(-1, 2),
                      device, dtype)


def default_catalog_g(device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Normalized ``g`` coordinates of the built-in Ohara glass catalog."""
    return _catalog_g(np.asarray(OHARA_GLASSES, dtype=np.float32), device, dtype)


def refractive_indices(nd: torch.Tensor, v: torch.Tensor, mask_G: np.ndarray,
                       wavelengths) -> torch.Tensor:
    """Refractive indices at ``wavelengths`` [nm] from n(λ) = A + B/λ², with

        B = (n_d - 1) / (V_d (λ_F^-2 - λ_C^-2)),  A = n_d - B/λ_d².

    Air gaps (mask_G False) give n = 1; zero-Abbe entries are dispersionless
    and pass n_d through unchanged.

    Args:
      nd, v: (B, S) padded glass parameters.
      mask_G: (B, S) static numpy glass mask.
      wavelengths: sequence of floats [nm] or Fraunhofer names.

    Returns:
      (B, S, W) refractive index of the gap after each surface.
    """
    wl = torch.tensor(resolve_wavelengths(wavelengths), dtype=nd.dtype,
                      device=nd.device)
    dispersive = v != 0
    v_safe = torch.where(dispersive, v, 1.0)
    b = (nd - 1.0) / (v_safe * (W_F ** -2 - W_C ** -2))
    a = nd - b / W_D ** 2
    n = a[..., None] + b[..., None] / wl[None, None, :] ** 2
    n = torch.where(dispersive[..., None], n, nd[..., None])
    glass = torch.as_tensor(mask_G, device=nd.device)[..., None]
    return torch.where(glass, n, 1.0)


def compute_n(nd: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Refractive indices at the (C, d, F) lines via a linear partial
    dispersion model w.r.t. the Abbe number, anchored on K7 and F2 glasses.
    ``nd, v`` are (...,) glass parameters; returns (..., 3)."""
    alpha = -4.5757e-4
    beta = 7.2264e-1
    nf = nd + (nd - 1.0) * (alpha + beta / v)
    nc = nf - (nd - 1.0) / v
    return torch.stack((nc, nd, nf), dim=-1)
