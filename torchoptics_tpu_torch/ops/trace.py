"""Exact skew ray tracing through a sequential surface chain.

PyTorch counterpart of ``torchoptics_tpu.ops.trace``. Two engines:

* ``engine="unroll"``: the pure-torch engine below. The surface loop is a
  Python loop; every step is plain tensor code, so it runs on any device
  and autograd differentiates it. It is also the engine of every internal
  sub-trace (ray aiming, the pupil radius).
* ``engine="fused"``: a single spherical system goes through
  ``ops.fused_trace`` (kernel K1), a single conic/asphere system through
  ``ops.fused_asphere`` (kernel K3), a population through
  ``ops.fused_batch`` (kernel K2 for spheres, K4 of ``ops.fused_asphere``
  for conic/asphere systems); their forward and backward passes are
  hand-written CUDA kernels on a GPU tensor.

Failure-mask semantics are replicated exactly (miss, TIR, cz² collapse,
backward-ray bookkeeping): they define the gradients at invalid rays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from torchoptics_tpu_torch.models import glass as glass_mod
from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import pupil as pupil_mod
from torchoptics_tpu_torch.ops import surfaces as surf

# Aggregate stack names.
AGG_TORCH = ("z_RELU", "theta_norm", "theta_prime_norm")
AGG_TF = ("z", "sin", "sin_prime")
# "dist": per-surface marching distance, with the final surface->image-plane
# leg appended (S+1 entries).
AGG_ALL = AGG_TORCH + AGG_TF + ("cos2", "cos2_prime", "x", "y", "dist")

ENGINES = ("unroll", "fused")


class TraceResult(NamedTuple):
    x: torch.Tensor             # (B, F, P, W) image-plane x
    y: torch.Tensor             # (B, F, P, W) image-plane y
    cx: torch.Tensor            # final direction cosines
    cy: torch.Tensor
    ray_ok: torch.Tensor        # (B, F, P, W) bool: traced successfully
    ray_backward: torch.Tensor  # (B, F, P, W) bool: traveled backward
    stacks: Optional[Dict[str, torch.Tensor]] = None  # name -> (S[+1], B, F, P, W)


@dataclass(frozen=True)
class TraceConfig:
    """Static ray-tracer configuration; hashable."""

    mode: str = "skew_random"
    n_rays: Tuple[int, ...] = (8, 8)
    rel_fields: Tuple[float, ...] = (0.0, 0.707, 1.0)
    wavelengths: Tuple[Any, ...] = (656.3, 587.6, 486.1)
    vig_fn: Optional[Callable] = None
    n_ray_aiming_iter: int = 0
    ray_aiming_mode: str = "real"
    allow_backward_rays: bool = True
    double_precision: bool = False
    newton_iters: int = 10
    engine: str = "unroll"  # 'unroll' | 'fused'

    def __post_init__(self):
        object.__setattr__(self, "n_rays", tuple(self.n_rays)
                           if isinstance(self.n_rays, (tuple, list)) else (self.n_rays,))
        object.__setattr__(self, "rel_fields", tuple(float(f) for f in self.rel_fields))
        object.__setattr__(self, "wavelengths",
                           glass_mod.resolve_wavelengths(self.wavelengths))
        if self.mode not in pupil_mod.SAMPLER_MODES:
            raise ValueError(
                f"Ray tracing mode must be one of {pupil_mod.SAMPLER_MODES}, "
                f"got {self.mode!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.double_precision else torch.float32


def _safe_sqrt(x, floor=0.0):
    """sqrt with a finite gradient at/below ``floor``.

    ``sqrt`` has an infinite derivative at 0, and ``0 * inf = NaN`` leaks
    through downstream ``where`` masks. Forward value is exact: sqrt(x) for
    x > floor, sqrt(floor) otherwise; the gradient below the floor is 0."""
    ok = x > floor
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), math.sqrt(floor))


def _agg_entry(name, ray_ok, z, cos2_theta, cos2_prime, full_shape):
    """One per-surface aggregate entry, broadcast to (B, F, P, W)."""
    eps = 1e-7
    if name == "z":
        return z.expand(full_shape)
    if name == "z_RELU":
        return torch.clamp(z, min=0.0).expand(full_shape)
    if name == "sin":
        return _safe_sqrt(1.0 - cos2_theta).expand(full_shape)
    if name == "sin_prime":
        return _safe_sqrt(1.0 - cos2_prime).expand(full_shape)
    if name == "cos2":
        return cos2_theta.expand(full_shape)
    if name == "cos2_prime":
        return cos2_prime.expand(full_shape)
    if name in ("theta_norm", "theta_prime_norm"):
        # Normalized incidence/refraction angle in [0, 1]; failed rays pinned
        # to 1. cos² <= 0 only occurs on lanes already failure-masked, so the
        # sqrt guard keeps the forward exact and the backward NaN-free.
        # The clip to [-1 + eps, 1 - eps] has zero gradient at its upper
        # bound, as the fused kernels' hand adjoint has (torch.clamp would
        # pass the gradient, ~2000x amplified, on lanes sitting there).
        cos2 = cos2_theta if name == "theta_norm" else cos2_prime
        safe = _safe_sqrt(cos2)
        clipped = torch.where(safe < 1.0 - eps, torch.clamp(safe, min=-1.0 + eps), 1.0 - eps)
        theta = torch.acos(clipped) / (0.5 * math.pi)
        return torch.where(ray_ok, theta, 1.0).expand(full_shape)
    raise ValueError(f"Unknown aggregate stack {name!r}; expected one of {AGG_ALL}")


def trace_skew(x, y, z, cx, cy, c, t, mu, mask,
               kappa=None, asph=None,
               aggregate: Tuple[str, ...] = (),
               allow_backward_rays: bool = True,
               newton_iters: int = 10) -> TraceResult:
    """March a batch of skew rays through every surface to the image plane.
    Inputs are broadcastable within the (B, F, P, W) layout; per-surface
    parameters carry a trailing surface axis:

      c, t, mask: (B, 1, 1, 1, S);  mu: (B, 1, 1, W, S)
      kappa: like c (optional);     asph: (B, 1, 1, 1, S, K) (optional)

    Without ``kappa`` and ``asph`` every surface is a sphere with a
    closed-form intersection; with either, a conic/asphere whose
    intersection takes ``newton_iters`` Newton steps and a polish step.
    """
    n_surf = c.shape[-1]
    spherical = kappa is None and asph is None
    full_shape = torch.broadcast_shapes(x.shape, y.shape, cx.shape, cy.shape,
                                        mu[..., 0].shape)
    ray_ok = torch.ones(full_shape, dtype=torch.bool, device=c.device)
    ray_backward = torch.zeros(full_shape, dtype=torch.bool, device=c.device)
    cz = torch.sqrt(1.0 - cx ** 2 - cy ** 2)
    x, y, z, cx, cy, cz = [a.expand(full_shape).to(c.dtype)
                           for a in (x, y, z, cx, cy, cz)]
    stacks = {k: [] for k in aggregate}

    for k in range(n_surf):
        ck, tk, muk = c[..., k], t[..., k], mu[..., k]
        kapk = None if kappa is None else kappa[..., k]
        asphk = None if asph is None else asph[..., k, :]
        if spherical:
            inter = surf.find_marching_distance_spherical(ck, x, y, z, cx, cy, cz)
        else:
            inter = surf.find_marching_distance_asphere(
                ck, kapk, asphk, x, y, z, cx, cy, cz, n_iter=newton_iters)
        x, y, z, delta_z = surf.update_ray_coordinates(
            x, y, z, cx, cy, cz, inter.distance)
        ray_ok = ray_ok & ~inter.failures
        x, y, z, cx, cy, cz = surf.reset_bad_rays(ray_ok, x, y, z, cx, cy, cz)
        if spherical:
            failures, cx, cy, cz, cos2_prime = surf.apply_snell_spherical(
                ck, muk, x, y, cx, cy, inter.cos_theta)
        else:
            failures, cx, cy, cz, cos2_prime = surf.apply_snell_general(
                ck, kapk, asphk, muk, x, y, cx, cy, cz, inter.cos_theta)

        # Backward-ray bookkeeping, skipping the pupil -> first-surface leg.
        if k > 0:
            went_backward = (delta_z < 0) & ray_ok & mask[..., k - 1]
            if allow_backward_rays:
                ray_backward = ray_backward | went_backward
            else:
                ray_ok = ray_ok & ~went_backward

        ray_ok = ray_ok & ~failures
        x, y, z, cx, cy, cz = surf.reset_bad_rays(ray_ok, x, y, z, cx, cy, cz)
        z = z - tk

        for name in aggregate:
            if name in ("x", "y", "dist"):
                value = {"x": x, "y": y, "dist": inter.distance}[name]
                stacks[name].append(value.expand(full_shape))
            else:
                stacks[name].append(_agg_entry(name, ray_ok, z, inter.cos2_theta,
                                               cos2_prime, full_shape))

    # Transfer to the image plane.
    delta_z = -z
    dist = delta_z / cz
    x = x + dist * cx
    y = y + dist * cy

    went_backward = (delta_z < 0) & ray_ok & mask[..., -1]
    if allow_backward_rays:
        ray_backward = ray_backward | went_backward
    else:
        ray_ok = ray_ok & ~went_backward

    out_stacks = None
    if aggregate:
        out_stacks = {k: torch.stack(v, dim=0) for k, v in stacks.items()}
        if "z" in out_stacks:
            # The image-plane z (0 in the image-plane frame) closes the stack.
            out_stacks["z"] = torch.cat(
                (out_stacks["z"], (z + delta_z).expand(full_shape)[None]), dim=0)
        if "dist" in out_stacks:
            # Final leg: last surface -> image plane.
            out_stacks["dist"] = torch.cat(
                (out_stacks["dist"], dist.expand(full_shape)[None]), dim=0)
    return TraceResult(x, y, cx, cy, ray_ok, ray_backward, out_stacks)


def _broadcast_surface_params(lens: Lens, n: torch.Tensor):
    """Arrange per-surface parameters into the 5-D trace layout."""
    B, S = lens.c.shape
    c = lens.c.reshape(B, 1, 1, 1, S)
    t = lens.t.reshape(B, 1, 1, 1, S)
    # n: (B, S, W) -> prepend air -> mu_k = n_k / n_{k+1}: (B, 1, 1, W, S)
    n_full = torch.cat((torch.ones_like(n[:, 0:1, :]), n), dim=1)
    n_full = n_full.permute(0, 2, 1)  # (B, W, S+1)
    mu = n_full[..., :-1] / n_full[..., 1:]
    mu = mu.reshape(B, 1, 1, mu.shape[1], S)
    mask = torch.as_tensor(lens.structure.mask, device=lens.device).reshape(B, 1, 1, 1, S)
    kappa = None if lens.kappa is None else lens.kappa.reshape(B, 1, 1, 1, S)
    asph = None if lens.asph is None else lens.asph.reshape(B, 1, 1, 1, S, lens.asph.shape[-1])
    return c, t, mu, mask, kappa, asph


def trace_rays(specs: Specs, lens: Lens, config: TraceConfig,
               generator: Optional[torch.Generator] = None,
               xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               use_vig: bool = True,
               up_to_stop: bool = False,
               aggregate: Tuple[str, ...] = ()) -> TraceResult:
    """Trace a full bundle: dispersion -> pupil placement -> sampling ->
    vignetting -> ray aiming -> EPD scaling -> direction cosines ->
    ``trace_skew``.

    ``config.engine='fused'`` sends a single system to
    ``fused_trace.trace_rays_fused`` (kernel K1 for spheres, K3 for a
    conic/asphere system) and a population to
    ``fused_batch.trace_rays_fused_batch`` (kernel K2 for spheres, K4 for
    conic/asphere systems); what they cannot take (double precision,
    aggregate stacks) raises instead of silently running another engine. Internal sub-traces (``xy``
    given, or ``up_to_stop``) always run the pure-torch engine.
    """
    internal = xy is not None or up_to_stop
    if config.engine == "fused" and not internal:
        if aggregate:
            raise NotImplementedError(
                "engine='fused' does not materialize per-surface aggregate "
                "stacks; the Lu loss has a fused form (simulator.do_ray_tracing "
                "with trace_engine='fused'), otherwise use engine='unroll'")
        if len(lens) > 1:
            from torchoptics_tpu_torch.ops import fused_batch
            return fused_batch.trace_rays_fused_batch(specs, lens, config,
                                                      generator=generator, use_vig=use_vig)
        from torchoptics_tpu_torch.ops import fused_trace
        return fused_trace.trace_rays_fused(specs, lens, config,
                                            generator=generator, use_vig=use_vig)
    dtype = config.dtype
    if config.double_precision:
        specs = specs.to(dtype=dtype)
        lens = lens.to(dtype=dtype)
    device = lens.device

    n = lens.get_refractive_indices(config.wavelengths)  # (B, S, W)
    z = abcd_mod.compute_pupil_position(lens).reshape(-1, 1, 1, 1)

    if xy is None:
        xp_rel, yp_rel = pupil_mod.sample_pupil(
            config.mode, config.n_rays, len(lens), generator=generator, device=device)
    else:
        xp_rel, yp_rel = xy

    if use_vig and config.vig_fn is not None and config.mode != "chief":
        fields = torch.tensor(config.rel_fields, dtype=dtype, device=device)[None, :]
        vig_up = config.vig_fn(fields, specs.vig_up)
        vig_down = config.vig_fn(fields, specs.vig_down)
        vig_x = config.vig_fn(fields, specs.vig_x)
        yp_rel = pupil_mod.apply_vignetting(yp_rel, vig_up, vig_down)
        xp_rel = pupil_mod.apply_vignetting(xp_rel, vig_x, vig_x)

    if config.n_ray_aiming_iter > 0 and not up_to_stop:
        from torchoptics_tpu_torch.ops import aiming
        aiming_fn = aiming.ray_aiming(specs, lens.detach(), config, use_vig)
        xp_rel, yp_rel = [torch.clamp(v, -2.0, 2.0).detach()
                          for v in aiming_fn(xp_rel, yp_rel)]

    xp = pupil_mod.scale_to_epd(xp_rel, specs.epd)
    yp = pupil_mod.scale_to_epd(yp_rel, specs.epd)

    fields = torch.tensor(config.rel_fields, dtype=dtype, device=device)
    u = (specs.hfov[:, None] * fields[None, :])[..., None, None]
    cy = torch.sin(u)
    cx = torch.zeros((1, 1, 1, 1), dtype=dtype, device=device)

    c, t, mu, mask, kappa, asph = _broadcast_surface_params(lens, n)
    return trace_skew(xp.to(dtype), yp.to(dtype), z.to(dtype), cx, cy,
                      c, t, mu, mask, kappa=kappa, asph=asph, aggregate=aggregate,
                      allow_backward_rays=config.allow_backward_rays,
                      newton_iters=config.newton_iters)
