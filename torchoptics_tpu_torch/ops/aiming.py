"""Ray aiming: Newton correction of pupil coordinates so rays fill the stop.

PyTorch counterpart of ``torchoptics_tpu.ops.aiming``. The JAX package takes
d(stop coordinates)/d(pupil coordinates) from one ``jax.vjp`` with all-ones
cotangents on both outputs; here the same accumulated derivative comes from
one ``torch.autograd.grad`` on detached leaf clones of the tee-ray
coordinates, under ``torch.enable_grad()``. So the solve also runs inside
``torch.no_grad()``, the mode the serving entry points use. It cannot run
under ``torch.inference_mode()``, where autograd records nothing: the solve
raises there rather than skip aiming. The caller treats the result as a
constant (clamped and detached).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import pupil as pupil_mod

AimingFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def compute_pupil_radius(specs: Specs, lens2stop: Lens,
                         double_precision: bool = False) -> torch.Tensor:
    """Entrance-pupil radius via a real marginal-ray trace to the stop.
    Returns (B,)."""
    from torchoptics_tpu_torch.ops import trace as trace_mod
    dtype = torch.float64 if double_precision else torch.float32
    x = torch.zeros((1, 1, 1, 1), dtype=dtype, device=lens2stop.device)
    y = torch.ones((1, 1, 1, 1), dtype=dtype, device=lens2stop.device)
    cfg = trace_mod.TraceConfig(mode="tee", rel_fields=(0.0,), wavelengths=("d",),
                                double_precision=double_precision)
    res = trace_mod.trace_rays(specs, lens2stop, cfg, xy=(x, y), use_vig=False)
    return res.y.reshape(-1)


def _stop_coords_and_slopes(stop_trace, xp: torch.Tensor, yp: torch.Tensor):
    """Stop-plane coordinates and the all-ones-cotangent pull-back of both
    w.r.t. the pupil coordinates (the reference's two accumulated
    ``backward()`` calls)."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError(
            "ray aiming differentiates the stop trace and cannot run under "
            "torch.inference_mode(); call under torch.no_grad() instead")
    with torch.enable_grad():
        xp = xp.detach().clone().requires_grad_(True)
        yp = yp.detach().clone().requires_grad_(True)
        xs, ys = stop_trace(xp, yp)
        x_grad, y_grad = torch.autograd.grad(
            (xs, ys), (xp, yp), grad_outputs=(torch.ones_like(xs), torch.ones_like(ys)))
    return xs.detach(), ys.detach(), x_grad, y_grad


def ray_aiming(specs: Specs, lens: Lens, config, use_vig: bool) -> AimingFn:
    """Build the linear pupil-coordinate correction function.

    Args:
      specs/lens: full system (the caller passes a detached lens).
      config: the calling tracer's ``TraceConfig`` (wavelengths and fields
        are reused for the tee rays).
      use_vig: apply vignetting to the reference tee coordinates.

    Returns:
      ``fn(xp_rel, yp_rel) -> (xp_rel', yp_rel')``; identity when every
      system's stop is the first surface.
    """
    from torchoptics_tpu_torch.ops import trace as trace_mod

    if all(k == 0 for k in lens.structure.stop_idx):
        return lambda xp_rel, yp_rel: (xp_rel, yp_rel)

    dtype = config.dtype
    device = lens.device
    specs2stop = specs.up_to_stop()
    lens2stop = lens.up_to_stop()

    if config.ray_aiming_mode == "paraxial":
        magnification = abcd_mod.compute_magnification(lens2stop)
        rs = (magnification * specs2stop.epd / 2.0).reshape(-1, 1, 1, 1)
    elif config.ray_aiming_mode == "real":
        rs = compute_pupil_radius(
            specs2stop, lens2stop, config.double_precision).reshape(-1, 1, 1, 1)
    else:
        raise ValueError(
            f"ray_aiming_mode must be 'real' or 'paraxial', got "
            f"{config.ray_aiming_mode!r}")
    rs = rs.detach()

    # Reference tee rays for every system, field, and wavelength.
    xp_tee, yp_tee = pupil_mod.tee(device=device)
    shape = (len(lens), len(config.rel_fields), xp_tee.shape[2], len(config.wavelengths))
    xp_tee = xp_tee.to(dtype).expand(shape)
    yp_tee = yp_tee.to(dtype).expand(shape)
    if use_vig and config.vig_fn is not None:
        fields = torch.tensor(config.rel_fields, dtype=dtype, device=device)[None, :]
        vig_down = config.vig_fn(fields, specs.vig_down)
        vig_up = config.vig_fn(fields, specs.vig_up)
        vig_x = config.vig_fn(fields, specs.vig_x)
        yp_tee = pupil_mod.apply_vignetting(yp_tee, vig_up, vig_down)
        xp_tee = pupil_mod.apply_vignetting(xp_tee, vig_x, vig_x)
    xp_tee_ref, yp_tee_ref = xp_tee, yp_tee

    def stop_trace(xp, yp):
        res = trace_mod.trace_rays(specs2stop, lens2stop, config, xy=(xp, yp),
                                   use_vig=False, up_to_stop=True)
        return res.x / rs, res.y / rs

    aiming_fn = None
    for _ in range(config.n_ray_aiming_iter):
        if aiming_fn is not None:
            xp_tee, yp_tee = aiming_fn(xp_tee, yp_tee)

        xs_rel, ys_rel, x_grad, y_grad = _stop_coords_and_slopes(
            stop_trace, xp_tee, yp_tee)

        # Newton step; non-finite steps disable aiming for that ray.
        delta_xp_tee = -(xs_rel - xp_tee_ref) / x_grad
        delta_yp_tee = -(ys_rel - yp_tee_ref) / y_grad
        delta_xp_tee = torch.where(torch.isfinite(delta_xp_tee), delta_xp_tee, 0.0)
        delta_yp_tee = torch.where(torch.isfinite(delta_yp_tee), delta_yp_tee, 0.0)

        # Linear interpolation between the tee corrections: x scales through
        # the sagittal ray; y maps affinely through the meridional pair.
        delta_xp = delta_xp_tee[..., -1:, :]
        delta_yp_l = delta_yp_tee[..., 0:1, :]
        delta_yp_u = delta_yp_tee[..., 1:2, :]
        xp = xp_tee[..., -1:, :]
        yp_l = yp_tee[..., 0:1, :]
        yp_u = yp_tee[..., 1:2, :]
        yp_scale = (yp_u + delta_yp_u - (yp_l + delta_yp_l)) / (yp_u - yp_l)
        yp_offset = (yp_l * delta_yp_u - yp_u * delta_yp_l) / (yp_l - yp_u)

        def aiming_fn(xp_rel, yp_rel, _xp=xp, _dxp=delta_xp,
                      _scale=yp_scale, _offset=yp_offset):
            return (xp_rel * (_xp + _dxp) / _xp, yp_rel * _scale + _offset)

    return aiming_fn
