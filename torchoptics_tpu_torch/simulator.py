"""Lens simulator: configuration and the unsupervised lens-design loss.

PyTorch counterpart of the evaluation path of ``torchoptics_tpu.simulator``:
pure functions over (Specs, Lens, SimulatorConfig). ``do_ray_tracing``
returns the raw trace and the loss Lu = rms + rate·ΣQ. With
``trace_engine="fused"`` the trace and the Lu penalty sums come from kernel
K1 (``ops.fused_trace``); with ``"unroll"`` from the pure-torch engine and
its per-surface stacks.

The fused engine has no backward kernel yet: on a GPU, call it under
``torch.no_grad()`` (not ``torch.inference_mode()``, under which ray aiming
cannot differentiate its stop trace).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import metrics as metrics_mod
from torchoptics_tpu_torch.ops import trace as trace_mod


@dataclass(frozen=True)
class SimulatorConfig:
    """Static simulator configuration, with the same fields and defaults as
    ``torchoptics_tpu.simulator.SimulatorConfig``. The loss weights, PSF,
    imaging and warp fields are carried for the later ports of the full loss
    and the imaging path; this module reads the trace and Lu fields.
    ``trace_engine`` is ``"unroll"`` (pure torch) or ``"fused"`` (kernel K1,
    the counterpart of the JAX package's ``"pallas"``)."""

    wavelengths: Tuple[float, ...] = (459.0, 520.0, 640.0)
    penalty_rate: float = 0.2
    n_pupil_rings: int = 32
    n_ray_aiming_iter: int = 1
    pupil_sampling: str = "skew_uniform_half_jittered"
    n_sampled_fields: int = 21
    sensor_diagonal: float = 16.0
    spot_size_weight: float = 1.0
    ray_path_weight: float = 100.0
    ray_path_lower_thresholds: Tuple[Optional[float], ...] = (0.01, 1.0, 12.0)
    ray_path_upper_thresholds: Tuple[Optional[float], ...] = (None, 3.0, None)
    ray_angle_weight: float = 100.0
    ray_angle_threshold: float = 60.0
    glass_weight: float = 0.01
    unsup_weight: float = 1.0
    loss_multiplier: float = 1.0
    psf_shape: Tuple[int, int] = (65, 65)
    psf_abs_pixel_size: float = 4.0e-3
    psf_grid_shape: Tuple[int, int] = (9, 9)
    simulated_res_factor: int = 1
    psf_source: str = "geometric"
    diffraction_grid_n: int = 64
    diffraction_oversample: int = 4
    warp_method: str = "separable"
    max_warp_px: Optional[int] = None
    distortion_by_warping: bool = True
    apply_distortion: bool = True
    apply_relative_illumination: bool = True
    double_precision: bool = False
    trace_engine: str = "unroll"
    # 'y' replicates the reference's Y-deviation-only spot RMS; 'xy' is the
    # radial 2-D metric.
    spot_metric: str = "y"

    def rel_fields(self) -> Tuple[float, ...]:
        """Field ladder: linspace(0, 1, n); a single field collapses to the
        full-field corner."""
        if self.n_sampled_fields == 1:
            return (1.0,)
        return tuple(float(f) for f in np.linspace(0, 1, self.n_sampled_fields))

    def trace_config(self, **overrides) -> trace_mod.TraceConfig:
        kw = dict(
            mode=self.pupil_sampling,
            n_rays=(self.n_pupil_rings, self.n_pupil_rings),
            rel_fields=self.rel_fields(),
            wavelengths=self.wavelengths,
            n_ray_aiming_iter=self.n_ray_aiming_iter,
            double_precision=self.double_precision,
            engine=self.trace_engine,
        )
        kw.update(overrides)
        return trace_mod.TraceConfig(**kw)

    @property
    def loss_weights(self) -> Dict[str, float]:
        return {
            "glass": self.glass_weight * self.loss_multiplier,
            "spot_size": self.spot_size_weight * self.loss_multiplier,
            "ray_path": self.ray_path_weight * self.loss_multiplier,
            "ray_angle": self.ray_angle_weight * self.loss_multiplier,
            "loss_unsup": self.unsup_weight,
        }


def compute_loss_out(res: trace_mod.TraceResult, n_sequence,
                     penalty_rate: float,
                     surface_mask: Optional[torch.Tensor] = None,
                     spot_metric: str = "y") -> Dict[str, torch.Tensor]:
    """Unsupervised loss Lu = rms + rate * ΣQ with
    Q = (Σθ + Σθ' + Σrelu(z)) / n_surfaces, NaN -> 0. Batched lenses follow
    per-system semantics: Lu_i = rms_i + rate·ΣQ_i with Q_i normalized by
    system i's own surface count, then the batch mean.

    ``n_sequence`` is a scalar or a per-system (B,) array of surface counts.
    ``surface_mask`` (B, S) restricts the per-surface penalty sums to each
    system's real surfaces. Requires the trace to have been run with
    ``aggregate`` ⊇ AGG_TORCH."""
    rms_b = metrics_mod.compute_spot_rms(res.x, res.y, res.ray_ok, spot_metric)
    stacks = res.stacks
    n_seq = torch.as_tensor(np.asarray(n_sequence), dtype=res.x.dtype,
                            device=res.x.device)
    if n_seq.ndim:  # per-system counts -> broadcast over (B, F, P, W)
        n_seq = n_seq.reshape(-1, 1, 1, 1)
    per_surf = (stacks["theta_norm"] + stacks["theta_prime_norm"]
                + stacks["z_RELU"])                     # (S, B, F, P, W)
    if surface_mask is not None:
        m = surface_mask.to(torch.bool).T               # (S, B)
        per_surf = torch.where(m[:, :, None, None, None], per_surf, 0.0)
    q = torch.sum(per_surf, dim=0) / n_seq
    q = torch.where(torch.isnan(q), 0.0, q)
    sum_q_b = torch.sum(q, dim=(1, 2, 3))               # (B,)
    lu_b = rms_b + penalty_rate * sum_q_b
    return {"loss_unsup": torch.mean(lu_b), "rms": torch.mean(rms_b),
            "penalty": torch.mean(sum_q_b)}


def _do_ray_tracing_fused(specs: Specs, lens: Lens, config: SimulatorConfig,
                          generator: Optional[torch.Generator]):
    """Fused form of ``do_ray_tracing`` for one spherical system: the Lu
    penalty terms accumulate in kernel K1, so no per-surface stack is
    materialized."""
    from torchoptics_tpu_torch.ops import fused_trace
    res, (pth, ptp, pz) = fused_trace.trace_rays_fused(
        specs, lens, config.trace_config(), generator=generator, penalties=True)
    rms_b = metrics_mod.compute_spot_rms(res.x, res.y, res.ray_ok,
                                         config.spot_metric)         # (B,)
    n_seq = float(lens.structure.n_surfaces[0])
    sum_q_b = (torch.sum(pth, dim=(1, 2, 3)) + torch.sum(ptp, dim=(1, 2, 3))
               + torch.sum(pz, dim=(1, 2, 3))) / n_seq
    lu_b = rms_b + config.penalty_rate * sum_q_b
    return res, {"loss_unsup": torch.mean(lu_b), "rms": torch.mean(rms_b),
                 "penalty": torch.mean(sum_q_b)}


def do_ray_tracing(specs: Specs, lens: Lens, config: SimulatorConfig,
                   generator: Optional[torch.Generator] = None,
                   aggregate: Tuple[str, ...] = trace_mod.AGG_TORCH,
                   ) -> Tuple[trace_mod.TraceResult, Dict[str, torch.Tensor]]:
    """Run the raw trace and the unsupervised loss.

    With ``config.trace_engine='fused'`` the loss comes from kernel K1's
    in-kernel penalty sums (``TraceResult.stacks`` is None); non-default
    aggregates, batches and aspheres raise there."""
    cfg = config.trace_config()
    if cfg.engine == "fused":
        if tuple(aggregate) != trace_mod.AGG_TORCH:
            raise NotImplementedError(
                "trace_engine='fused' computes the default Lu penalties "
                "in-kernel; custom aggregate stacks need trace_engine='unroll'")
        return _do_ray_tracing_fused(specs, lens, config, generator)
    res = trace_mod.trace_rays(specs, lens, cfg, generator=generator,
                               aggregate=aggregate)
    mask = torch.as_tensor(lens.structure.mask, device=lens.device)
    loss_dict = compute_loss_out(res, lens.structure.n_surfaces,
                                 config.penalty_rate, surface_mask=mask,
                                 spot_metric=config.spot_metric)
    return res, loss_dict


def unsupervised_loss(specs: Specs, lens: Lens, config: SimulatorConfig,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Scalar Lu, the main lens-design objective."""
    _, loss_dict = do_ray_tracing(specs, lens, config, generator=generator)
    return loss_dict["loss_unsup"]
