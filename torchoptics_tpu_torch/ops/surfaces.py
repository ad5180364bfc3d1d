"""Spherical surface geometry: ray-surface intersection and refraction.

PyTorch counterpart of the spherical part of ``torchoptics_tpu.ops.surfaces``
with identical failure-mask semantics (the masks shape gradients and must
match). The conic/asphere Newton intersection comes with the asphere kernels.

Conventions (vertex-local frame): surface vertex at z = 0, axis along +z;
direction cosines (cx, cy, cz) are unit vectors. Missed surfaces, TIR, and
numerical cz² collapse mark rays failed; the guarded values keep the
computation NaN-free in both passes.
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
