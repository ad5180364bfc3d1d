"""Entrance-pupil sampling patterns and pupil-coordinate transforms.

PyTorch counterpart of ``torchoptics_tpu.ops.pupil``, with all ten sampling
modes. The deterministic samplers are built with numpy exactly as the JAX
package builds them; the one stochastic sampler, ``circle_pseudo_random``
(mode ``skew_random``), draws from an explicit ``torch.Generator``.

Samplers return relative pupil coordinates ``(x, y)`` shaped
``(B_or_1, 1, n_rays, 1)`` in the (systems, fields, rays, wavelengths)
layout; broadcasting against fields/wavelengths happens in the tracer.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

Coords = Tuple[torch.Tensor, torch.Tensor]


def _const(x, y, device=None) -> Coords:
    as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return as_t(x).reshape(1, 1, -1, 1), as_t(y).reshape(1, 1, -1, 1)


def tee(device=None) -> Coords:
    """Bottom meridional, top meridional, and positive sagittal rays."""
    return _const([0.0, 0.0, 1.0], [-1.0, 1.0, 0.0], device)


def meridional_uniform(n_rays: int, device=None) -> Coords:
    """n uniformly spaced meridional rays."""
    y = np.linspace(-1.0, 1.0, n_rays, dtype=np.float32)
    return _const(np.zeros_like(y), y, device)


def sagittal_uniform(n_rays: int, device=None) -> Coords:
    """n uniformly spaced positive sagittal rays."""
    x = np.linspace(0.0, 1.0, n_rays, dtype=np.float32)
    return _const(x, np.zeros_like(x), device)


def chief(device=None) -> Coords:
    """The chief ray: pupil center."""
    return _const([0.0], [0.0], device)


def circle_pseudo_random(generator: torch.Generator, batch: int, n_r: int,
                         n_theta: int) -> Coords:
    """Stratified-random polar sampling: jittered r² x θ grid, one
    independent draw per system, on the generator's device. It cannot give
    the JAX package's numbers: ``jax.random`` and torch draw differently."""
    n_rays = n_r * n_theta
    dev = generator.device
    delta_r2 = torch.rand((batch, n_r, n_theta), generator=generator, device=dev) / n_r
    delta_th = torch.rand((batch, n_r, n_theta), generator=generator, device=dev) / n_theta
    r2_incr = torch.tensor(np.linspace(0, 1, n_r, endpoint=False, dtype=np.float32),
                           device=dev)[None, :, None]
    th_incr = torch.tensor(np.linspace(0, 1, n_theta, endpoint=False, dtype=np.float32),
                           device=dev)[None, None, :]
    r = torch.sqrt(delta_r2 + r2_incr)
    theta = (delta_th + th_incr) * 2.0 * math.pi
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    return x.reshape(-1, 1, n_rays, 1), y.reshape(-1, 1, n_rays, 1)


def circle(n_r: int, n_theta: int, device=None) -> Coords:
    """Deterministic polar rings."""
    r = np.linspace(0, 1.0, n_r, endpoint=False, dtype=np.float32)[:, None]
    theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False,
                        dtype=np.float32)[None, :]
    return _const(r * np.cos(theta), r * np.sin(theta), device)


def skew_uniform_half_equidistant(n_r: int, n_i: int, device=None) -> Coords:
    """Right-half pupil, equidistant shells: n_i*(2i+1) rays on shell i."""
    rays_per_shell = [n_i * (i * 2 + 1) for i in range(n_r)]
    shell_idx = [i for i in range(n_r) for _ in range(rays_per_shell[i])]
    r = ((np.arange(n_r) + 0.5) / n_r)[shell_idx]
    theta = np.array([(i / n - 0.5) * np.pi for n in rays_per_shell
                      for i in (np.arange(n) + 0.5)])
    return _const(r * np.cos(theta), r * np.sin(theta), device)


def skew_uniform_half_jittered(n_r: int, n_i: int, device=None) -> Coords:
    """Right-half pupil, alternating-radius shells that sample the pupil
    edge. Deterministic despite the name."""
    rays_per_shell = np.array([n_i * (i * 2 + 1) for i in range(n_r)])
    shell_idx = np.array([i for i in range(n_r)
                          for _ in range(int(rays_per_shell[i]))])
    inner_r = np.linspace(0, 1, n_r * 2)[::2]
    delta_r = 1 / (2 * n_r - 1)
    r = inner_r[shell_idx] + delta_r * ((np.arange(len(shell_idx)) + shell_idx) % 2)
    theta = np.array([(i / n - 0.5) * np.pi for n in rays_per_shell
                      for i in (np.arange(n) + 0.5)])
    return _const(r * np.cos(theta), r * np.sin(theta), device)


def skew_inner_square_half(n_y: int, device=None) -> Coords:
    """Right-half inner-square grid."""
    x = np.linspace(-1, 1, n_y * 2)[-n_y:] / np.sqrt(2)
    y = np.linspace(-1, 1, n_y) / np.sqrt(2)
    xg = np.broadcast_to(x[None, :], (n_y, n_y))
    yg = np.broadcast_to(y[:, None], (n_y, n_y))
    return _const(xg, yg, device)


def circle_outer_edge_uniform(n_rays: int, device=None) -> Coords:
    """Uniform ring on the pupil edge."""
    theta = np.linspace(0, 2 * np.pi, n_rays, endpoint=False, dtype=np.float32)
    return _const(np.cos(theta), np.sin(theta), device)


SAMPLER_MODES = (
    "skew_random", "skew_uniform_half_equidistant", "skew_uniform_half_jittered",
    "skew_inner_square_half", "skew_outer_edge_uniform", "meridional_uniform",
    "sagittal_uniform", "chief", "tee", "circular",
)


def sample_pupil(mode: str, n_rays, batch: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> Coords:
    """Dispatch a pupil sampling mode. ``skew_random`` draws from
    ``generator`` (on its own device); the others are built on ``device``."""
    first = n_rays[0] if isinstance(n_rays, (tuple, list)) else n_rays
    if mode == "skew_random":
        if generator is None:
            raise ValueError("skew_random sampling requires a torch.Generator")
        return circle_pseudo_random(generator, batch, *n_rays)
    if mode == "skew_uniform_half_equidistant":
        return skew_uniform_half_equidistant(*n_rays, device=device)
    if mode == "skew_uniform_half_jittered":
        return skew_uniform_half_jittered(*n_rays, device=device)
    if mode == "skew_inner_square_half":
        return skew_inner_square_half(first, device=device)
    if mode == "skew_outer_edge_uniform":
        return circle_outer_edge_uniform(first, device=device)
    if mode == "meridional_uniform":
        return meridional_uniform(first, device=device)
    if mode == "sagittal_uniform":
        return sagittal_uniform(first, device=device)
    if mode == "chief":
        return chief(device=device)
    if mode == "tee":
        return tee(device=device)
    if mode == "circular":
        return circle(*n_rays, device=device)
    raise ValueError(
        f"Unknown pupil sampling mode {mode!r}; expected one of {SAMPLER_MODES}")


def apply_vignetting(y: torch.Tensor, vig_up: torch.Tensor,
                     vig_down: torch.Tensor) -> torch.Tensor:
    """Linearly rescale normalized pupil coordinates for vignetting."""
    trailing = (1,) * (y.ndim - vig_down.ndim)
    vig_up = vig_up.reshape(tuple(vig_up.shape) + trailing)
    vig_down = vig_down.reshape(tuple(vig_down.shape) + trailing)
    scale = 1.0 - (vig_up + vig_down) / 2.0
    offset = (vig_down - vig_up) / 2.0
    return y * scale + offset


def scale_to_epd(y: torch.Tensor, epd: torch.Tensor) -> torch.Tensor:
    """Relative pupil coordinates -> absolute heights via EPD/2, assuming
    infinite conjugates."""
    trailing = (1,) * (y.ndim - 1)
    return y * epd.reshape((-1,) + trailing) / 2.0
