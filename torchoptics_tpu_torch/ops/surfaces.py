"""Surface geometry: ray-surface intersection and refraction.

PyTorch counterpart of ``torchoptics_tpu.ops.surfaces`` with identical
failure-mask semantics (the masks shape gradients and must match): the
closed-form sphere, and the conic + even asphere with its fixed-iteration
Newton intersection and one attached polish step (implicit
differentiation).

Conventions (vertex-local frame): surface vertex at z = 0, axis along +z;
direction cosines (cx, cy, cz) are unit vectors;
sag(r²) = c r² / (1 + sqrt(1 - (1+κ) c² r²)) + Σ_k a_k (r²)^(k+2); the unit
normal at a hit point is (2x g, 2y g, -1) / sqrt(1 + 4 r² g²) with
g = d sag / d(r²). Missed surfaces, TIR, and numerical cz² collapse mark rays
failed; the guarded values keep the computation NaN-free in both passes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-6


class Intersection(NamedTuple):
    failures: torch.Tensor    # bool: ray missed the surface
    distance: torch.Tensor    # marching distance along the ray
    cos_theta: torch.Tensor   # |cos| of incidence angle (guarded)
    cos2_theta: torch.Tensor  # raw cos² of incidence angle


def update_ray_coordinates(x, y, z, cx, cy, cz, distance):
    """Advance a ray by ``distance``."""
    delta_z = distance * cz
    return x + distance * cx, y + distance * cy, z + delta_z, delta_z


def find_marching_distance_spherical(c, x, y, z, cx, cy, cz) -> Intersection:
    """Closed-form ray-sphere intersection in the vertex-local frame, in the
    numerically stable quotient form, with the cos²θ >= eps miss test."""
    e = -(x * cx + y * cy + z * cz)
    mz = z + e * cz
    m2 = x ** 2 + y ** 2 + z ** 2 - e ** 2
    temp = c * m2 - 2.0 * mz
    cos2_theta = cz ** 2 - c * temp

    failures = cos2_theta - EPS < 0
    cos_theta = torch.sqrt(torch.where(failures, 1.0, cos2_theta))
    dist = e + temp / (cz + cos_theta)
    return Intersection(failures, dist, cos_theta, cos2_theta)


def apply_snell_spherical(c, mu, x, y, cx, cy, cos_theta):
    """Snell's law on direction cosines at a spherical interface: TIR mask
    via cos²θ' >= eps, then cz from renormalization with its own guard."""
    cos2_prime = 1.0 - mu ** 2 * (1.0 - cos_theta ** 2)
    failures = cos2_prime - EPS < 0

    cos_prime = torch.sqrt(torch.where(failures, 1.0, cos2_prime))
    g = cos_prime - mu * cos_theta
    cx = mu * cx - g * c * x
    cy = mu * cy - g * c * y
    cz2 = 1.0 - (cx ** 2 + cy ** 2)

    failures = failures | (cz2 - EPS < 0)
    cz = torch.sqrt(torch.where(failures, 1.0, cz2))
    return failures, cx, cy, cz, cos2_prime


def reset_bad_rays(ray_ok, x, y, z, cx, cy, cz):
    """Zero-out failed rays so neither pass produces NaNs. Gradients through
    failed lanes are exactly zero."""
    return (torch.where(ray_ok, x, 0.0), torch.where(ray_ok, y, 0.0),
            torch.where(ray_ok, z, 0.0), torch.where(ray_ok, cx, 0.0),
            torch.where(ray_ok, cy, 0.0), torch.where(ray_ok, cz, 1.0))


# ---------------------------------------------------------------------------
# Conic + even asphere.
# ---------------------------------------------------------------------------


def sag_and_slope(c, kappa, asph, r2):
    """Sag s(r²), g = ds/d(r²) and the domain guard of the conic + even
    asphere. ``kappa`` may be None (zero conic); ``asph`` is None or holds
    the coefficients of (r²)^(k+2) on its last axis, broadcastable against
    ``r2[..., None]``. Lanes with ``guard`` lie beyond the conic's aperture,
    where the sag is undefined: callers treat them as a miss."""
    if kappa is None:
        kappa = 0.0
    u = (1.0 + kappa) * c ** 2 * r2
    guard = 1.0 - u < EPS
    root = torch.sqrt(torch.where(guard, 1.0, 1.0 - u))
    denom = 1.0 + root
    s = c * r2 / denom
    # d/d(r²) of c r²/(1+sqrt(1-(1+κ)c²r²)) = c/denom + c(1+κ)c² r²/(2 root denom²)
    g = c / denom + c * u / (2.0 * root * denom ** 2)
    if asph is not None:
        powers = torch.arange(asph.shape[-1], dtype=r2.dtype, device=r2.device) + 2.0
        r2e = r2[..., None]
        s = s + torch.sum(asph * r2e ** powers, dim=-1)
        g = g + torch.sum(asph * powers * r2e ** (powers - 1.0), dim=-1)
    return s, g, guard


def _newton_f(c, kappa, asph, x, y, z, cx, cy, cz, s):
    """F(s) = z(s) - sag(r²(s)) and its derivative along the ray."""
    xs = x + s * cx
    ys = y + s * cy
    zs = z + s * cz
    r2 = xs ** 2 + ys ** 2
    sag, g, guard = sag_and_slope(c, kappa, asph, r2)
    f = zs - sag
    fp = cz - g * 2.0 * (xs * cx + ys * cy)
    return f, fp, guard


def find_marching_distance_asphere(c, kappa, asph, x, y, z, cx, cy, cz,
                                   n_iter: int = 10, tol: float = 1e-5) -> Intersection:
    """Ray-(conic + even asphere) intersection by Newton iteration: the
    closed-form best-fit-sphere guess (the vertex plane where it misses),
    ``n_iter`` Newton steps outside autograd, then one attached step. By
    the implicit function theorem that step gives the root's exact
    first-order derivative in every surface and ray parameter, so the
    backward pass does not grow with ``n_iter``.

    A miss of the sphere guess is not fatal. Fatal are the sag-domain guard
    at the solution, non-convergence (|F| > tol), a stationary Newton
    derivative, and a negative incidence cos²."""
    with torch.no_grad():
        sph = find_marching_distance_spherical(c, x, y, z, cx, cy, cz)
        plane_ok = torch.abs(cz) > EPS
        plane = torch.where(plane_ok, -z / torch.where(plane_ok, cz, 1.0), 0.0)
        s = torch.where(sph.failures, plane, sph.distance)
        for _ in range(n_iter):
            f, fp, _ = _newton_f(c, kappa, asph, x, y, z, cx, cy, cz, s)
            fp_safe = torch.where(torch.abs(fp) > EPS, fp,
                                  torch.where(fp >= 0, fp.new_tensor(EPS), fp.new_tensor(-EPS)))
            s = s - f / fp_safe
    s_star = s.detach()

    # Attached polish step: s = s* - F(s*)/F'(s*) with s* constant.
    f, fp, guard = _newton_f(c, kappa, asph, x, y, z, cx, cy, cz, s_star)
    stationary = torch.abs(fp.detach()) < EPS
    fp_safe = torch.where(stationary, 1.0, fp)
    dist = s_star - f / fp_safe
    not_converged = torch.abs(f.detach()) > tol

    # Incidence angle at the hit point: cos(theta) = -d . n.
    xs = x + dist * cx
    ys = y + dist * cy
    r2 = xs ** 2 + ys ** 2
    _, g, guard2 = sag_and_slope(c, kappa, asph, r2)
    inv_norm = torch.rsqrt(1.0 + 4.0 * r2 * g ** 2)
    cos_theta_raw = (cz - 2.0 * g * (xs * cx + ys * cy)) * inv_norm
    cos2_theta = cos_theta_raw ** 2

    failures = guard | guard2 | stationary | not_converged | (cos2_theta - EPS < 0)
    cos_theta = torch.sqrt(torch.where(failures, 1.0, cos2_theta))
    return Intersection(failures, dist, cos_theta, cos2_theta)


def apply_snell_general(c, kappa, asph, mu, x, y, cx, cy, cz, cos_theta):
    """Snell's law at a general sag surface with its true unit normal:
    d' = mu d - (cos(theta') - mu cos(theta)) n. The same TIR and cz²
    failure masks as ``apply_snell_spherical``."""
    cos2_prime = 1.0 - mu ** 2 * (1.0 - cos_theta ** 2)
    failures = cos2_prime - EPS < 0
    cos_prime = torch.sqrt(torch.where(failures, 1.0, cos2_prime))
    gsnell = cos_prime - mu * cos_theta

    r2 = x ** 2 + y ** 2
    _, g, _ = sag_and_slope(c, kappa, asph, r2)
    inv_norm = torch.rsqrt(1.0 + 4.0 * r2 * g ** 2)
    nx = 2.0 * x * g * inv_norm
    ny = 2.0 * y * g * inv_norm

    cx = mu * cx - gsnell * nx
    cy = mu * cy - gsnell * ny
    cz2 = 1.0 - (cx ** 2 + cy ** 2)
    failures = failures | (cz2 - EPS < 0)
    cz = torch.sqrt(torch.where(failures, 1.0, cz2))
    return failures, cx, cy, cz, cos2_prime
