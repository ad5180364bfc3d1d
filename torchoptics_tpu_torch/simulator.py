"""Lens simulator: configuration, the unsupervised lens-design loss and the
full weighted loss.

PyTorch counterpart of ``torchoptics_tpu.simulator``: pure functions over
(Specs, Lens, SimulatorConfig), and the stateful wrappers
``OpticsSimulator`` and ``RaytracedOptics`` over them. ``do_ray_tracing`` returns the raw trace and
the loss Lu = rms + rate·ΣQ; ``compute_losses`` the full weighted loss
(spot + ray-path + ray-angle + glass + Lu). With ``trace_engine="fused"``
the trace and the penalty sums come from kernel K1 (``ops.fused_trace``)
for one spherical system, from kernel K3 (``ops.fused_asphere``) for one
conic/asphere system and from kernel K2 (``ops.fused_batch``) for a
population,
whose backward kernels make them differentiable on the GPU; with
``"unroll"`` they come from the pure-torch engine and its per-surface
stacks.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models import glass as glass_mod
from torchoptics_tpu_torch.models import io as io_mod
from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure, mask_scatter
from torchoptics_tpu_torch.ops import metrics as metrics_mod
from torchoptics_tpu_torch.ops import trace as trace_mod


@dataclass(frozen=True)
class SimulatorConfig:
    """Static simulator configuration, with the same fields and defaults as
    ``torchoptics_tpu.simulator.SimulatorConfig``. The PSF, imaging and warp
    fields are carried for the later port of the imaging path.
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


def ray_path_hinges(lens: Lens, z_stack: torch.Tensor, min_thickness,
                    max_thickness) -> torch.Tensor:
    """The ray-path hinges of :func:`compute_ray_path_penalty` per gap and
    ray, (S, B, F, P, W), before the mean over rays."""
    lo_air, lo_glass, lo_image = (-np.inf if v is None else v for v in min_thickness)
    hi_air, hi_glass, hi_image = (np.inf if v is None else v for v in max_thickness)
    st = lens.structure
    rows = np.arange(len(lens))
    # Absolute vertex positions; the image-plane entry reuses the last vertex.
    vertex_z = torch.cumsum(lens.t, dim=1)                              # (B, S)
    ref_z = torch.cat((vertex_z, vertex_z[:, -1:]), dim=1).T            # (S+1, B)
    abs_z = z_stack + ref_z[:, :, None, None, None]
    delta_z = abs_z[1:] - abs_z[:-1]                                    # (S, B, F, P, W)

    def bound_map(glass_value, air_value, image_value, pad):
        m = np.where(st.mask_G, glass_value, air_value).astype(np.float32)
        m[rows, st.n_surfaces - 1] = image_value
        # Padded gaps of heterogeneous batches have delta_z == 0 and must not
        # be penalized against the air-gap bounds.
        m = np.where(st.mask, m, pad).astype(np.float32)
        return torch.as_tensor(m.T.copy(), device=lens.device)[:, :, None, None, None]

    min_map = bound_map(lo_glass, lo_air, lo_image, -np.inf)
    max_map = bound_map(hi_glass, hi_air, hi_image, np.inf)
    return (torch.clamp(min_map - delta_z, min=0.0)
            + torch.clamp(delta_z - max_map, min=0.0))


#: The stacks the unroll engine's full loss reads.
FULL_AGGREGATE = ("z", "cos2", "cos2_prime") + trace_mod.AGG_TORCH


def compute_ray_path_penalty(lens: Lens, z_stack: torch.Tensor, min_thickness,
                             max_thickness) -> torch.Tensor:
    """Hinge penalty on the inter-surface ray path Δz against the air, glass
    and image thickness bounds.

    Args:
      z_stack: (S+1, B, F, P, W): per-surface z (next-vertex frame) plus the
        image-plane entry, i.e. the trace's ``stacks['z']``.
      min/max_thickness: (air, glass, image) bounds; None disables a bound.

    Returns: scalar penalty (mean over rays, summed over gaps).
    """
    penalty = ray_path_hinges(lens, z_stack, min_thickness, max_thickness)
    return torch.sum(torch.mean(penalty, dim=(1, 2, 3, 4)))


def compute_ray_angle_penalty(cos_squared: torch.Tensor,
                              angle_threshold: float) -> torch.Tensor:
    """Hinge penalty on cos² of the incidence and refraction angles beyond
    the threshold angle in degrees."""
    threshold = math.cos(math.radians(angle_threshold)) ** 2
    return torch.sum(torch.mean(torch.clamp(threshold - cos_squared, min=0.0),
                                dim=(1, 2, 3, 4)))


def masked_cos2(lens: Lens, stacks: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The (2S, B, F, P, W) cos² of the incidence and refraction angles that
    the angle hinge reads. Padding surfaces of heterogeneous batches are
    straight-through no-ops; their cos² is pinned to 1 so the hinge never
    fires on them."""
    m_s = torch.as_tensor(lens.structure.mask, device=lens.device).T[:, :, None, None, None]
    cos2 = torch.cat((stacks["cos2"], stacks["cos2_prime"]), dim=0)
    return torch.where(torch.cat((m_s, m_s), dim=0), cos2, 1.0)


def compute_glass_penalty(structure: Structure, g: torch.Tensor,
                          catalog_g: Optional[torch.Tensor]) -> torch.Tensor:
    """Squared distance of each glass variable to its nearest catalog glass."""
    if catalog_g is None:
        return torch.zeros((), dtype=g.dtype, device=g.device)
    min_dist = torch.min(glass_mod.catalog_distances(g, catalog_g), dim=1).values
    return torch.sum(mask_scatter(structure.mask_G, min_dist, 0.0) ** 2)


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
    """Fused form of ``do_ray_tracing``: the Lu penalty terms accumulate in
    kernel K1 (one spherical system), K3 (one conic/asphere system), K2 (a
    spherical population) or K4 (a population of conic/asphere systems), so
    no per-surface stack is materialized. Each system's Q is
    normalized by its own surface count."""
    cfg = config.trace_config()
    if len(lens) == 1:
        from torchoptics_tpu_torch.ops import fused_trace
        res, (pth, ptp, pz) = fused_trace.trace_rays_fused(
            specs, lens, cfg, generator=generator, penalties=True)
    else:
        from torchoptics_tpu_torch.ops import fused_batch
        res, (pth, ptp, pz) = fused_batch.trace_rays_fused_batch(
            specs, lens, cfg, generator=generator, penalties=True)
    rms_b = metrics_mod.compute_spot_rms(res.x, res.y, res.ray_ok,
                                         config.spot_metric)         # (B,)
    n_seq = torch.as_tensor(lens.structure.n_surfaces, dtype=rms_b.dtype,
                            device=rms_b.device)
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

    With ``config.trace_engine='fused'`` the loss comes from the in-kernel
    penalty sums of kernel K1 (one spherical system), K3 (one conic/asphere
    system), K2 (a spherical population) or K4 (a population of
    conic/asphere systems) (``TraceResult.stacks`` is None); non-default
    aggregates raise there."""
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


def compute_losses(specs: Specs, lens: Lens, config: SimulatorConfig,
                   g: Optional[torch.Tensor] = None,
                   catalog_g: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full weighted loss: spot size + ray-path, ray-angle and glass
    penalties + Lu, weighted by ``config.loss_weights``.

    Returns (total_loss, loss_dict). ``config.trace_engine='fused'`` runs
    one spherical system on K1's full mode (``fused_trace.compute_losses_fused``),
    a population of one lens type on K2's full mode
    (``fused_batch.batched_compute_losses_fused``) and a population of mixed
    lens types as one K2 launch per type (``_compute_losses_fused_grouped``);
    one conic/asphere system runs on K3's full mode
    (``fused_asphere.compute_losses_fused_asphere``), a population of them
    on K4's (one launch per lens type when the types are mixed)."""
    cfg = config.trace_config()
    if cfg.engine == "fused":
        if len(lens) == 1:
            from torchoptics_tpu_torch.ops import fused_trace
            return fused_trace.compute_losses_fused(specs, lens, config, g=g,
                                                    catalog_g=catalog_g, generator=generator)
        if len(set(lens.structure.sequence)) == 1:
            from torchoptics_tpu_torch.ops import fused_batch
            return fused_batch.batched_compute_losses_fused(
                specs, lens, config, g=g, catalog_g=catalog_g, generator=generator)
        return _compute_losses_fused_grouped(specs, lens, config, g, catalog_g, generator)
    res = trace_mod.trace_rays(specs, lens, cfg, generator=generator,
                               aggregate=FULL_AGGREGATE)
    mask = torch.as_tensor(lens.structure.mask, device=lens.device)
    loss_dict = compute_loss_out(res, lens.structure.n_surfaces, config.penalty_rate,
                                 surface_mask=mask, spot_metric=config.spot_metric)
    loss_dict["spot_size"] = torch.mean(
        metrics_mod.compute_spot_rms(res.x, res.y, res.ray_ok, config.spot_metric))
    loss_dict["ray_path"] = compute_ray_path_penalty(
        lens, res.stacks["z"], config.ray_path_lower_thresholds,
        config.ray_path_upper_thresholds)
    loss_dict["ray_angle"] = compute_ray_angle_penalty(masked_cos2(lens, res.stacks),
                                                       config.ray_angle_threshold)
    if g is not None:
        loss_dict["glass"] = compute_glass_penalty(lens.structure, g, catalog_g)
    total = sum(loss_dict[k] * w for k, w in config.loss_weights.items()
                if k in loss_dict and w is not None)
    return total, loss_dict


def _compute_losses_fused_grouped(specs: Specs, lens: Lens, config: SimulatorConfig,
                                  g: Optional[torch.Tensor],
                                  catalog_g: Optional[torch.Tensor],
                                  generator: Optional[torch.Generator],
                                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The fused full loss of a population of mixed lens types: systems
    grouped by sequence on the host (static), one K2 launch (K4 for
    conic/asphere systems) per lens type at its own surface count,
    recombined. Every loss entry is a mean over
    systems or over all rays, which have the same shape in every group, so
    group g weighs B_g / B. The glass penalty depends on ``g`` only and is
    computed once on the whole population. The caller's generator serves
    the groups in order."""
    from torchoptics_tpu_torch.ops import fused_batch

    groups: Dict[str, list] = {}
    for i, seq in enumerate(lens.structure.sequence):
        groups.setdefault(seq, []).append(i)
    combined: Dict[str, torch.Tensor] = {}
    for idx in groups.values():
        idx = np.asarray(idx)
        _, d = fused_batch.batched_compute_losses_fused(specs[idx], lens[idx], config,
                                                        generator=generator)
        for k in ("loss_unsup", "rms", "penalty", "spot_size", "ray_path", "ray_angle"):
            term = d[k] * (len(idx) / len(lens))
            combined[k] = term if k not in combined else combined[k] + term
    if g is not None:
        combined["glass"] = compute_glass_penalty(lens.structure, g, catalog_g)
    total = sum(combined[k] * w for k, w in config.loss_weights.items()
                if k in combined and w is not None)
    return total, combined


# ---------------------------------------------------------------------------
# Stateful wrappers
# ---------------------------------------------------------------------------


def _numbers(t: torch.Tensor) -> list:
    return t.detach().cpu().numpy().tolist()


class OpticsSimulator:
    """Stateful wrapper with the reference ``OpticsSimulator``'s constructor
    surface: a lens from a prescription (a YAML path or a dict) or from the
    constructor's arrays, built on ``device`` by :meth:`initialize`. The
    compute path is the pure functions above."""

    def __init__(self,
                 initial_lens_path="",
                 stop_index=np.array([1]),
                 sequence=np.array(["AGA"]),
                 hfov=(0.0, 17.5, 25.0),
                 epd=(0.7,),
                 curvature=(0.0, -0.242432341, -0.424975232),
                 thickness=(1.21071062, 0.25, 9.86362667),
                 n_refractive=(1.5224147149313454,),
                 abbe_number=(59.450346241693694,),
                 n_sampled_fields=21,
                 sensor_diagonal=16.0,
                 config: Optional[SimulatorConfig] = None,
                 device="cuda",
                 **extra_config):
        self.device = torch.device(device)
        self.config = config or SimulatorConfig(n_sampled_fields=n_sampled_fields,
                                                sensor_diagonal=sensor_diagonal,
                                                **extra_config)
        if initial_lens_path:
            self.initial_lens = io_mod.load_prescription(initial_lens_path)
        else:
            self.initial_lens = None
            self._stop_index = np.asarray(stop_index)
            self._sequence = np.asarray(sequence)
            self._hfov = np.asarray(hfov, dtype=np.float32)
            self._epd = np.asarray(epd, dtype=np.float32)
            as_tensor = lambda v: torch.tensor(np.asarray(v, dtype=np.float32),
                                               device=self.device)
            self._curvature = as_tensor(curvature)
            self._thickness = as_tensor(thickness)
            self._n_refractive = as_tensor(n_refractive)
            self._abbe_number = as_tensor(abbe_number)
        self.logged_metrics: Dict[str, Any] = {}
        self.loss_dict: Optional[Dict[str, torch.Tensor]] = None

    def initialize(self):
        """Build the structure, specs and lens, and the EFL the sensor needs."""
        if self.initial_lens is not None:
            self.specs, self.lensR = io_mod.load_lens(self.initial_lens, device=self.device)
            self.structure = self.lensR.structure
            self.hfov = self.specs.hfov
            self.epd = self.specs.epd
        else:
            self.structure = Structure(tuple(int(i) for i in self._stop_index),
                                       tuple(str(s) for s in self._sequence))
            # The reference keeps only the outermost field angle as the HFOV.
            self.hfov = torch.deg2rad(torch.tensor(self._hfov[-1:].copy(), device=self.device))
            self.epd = torch.tensor(self._epd, device=self.device)
            self.specs = Specs(self.structure, self.epd, self.hfov)
            self.lensR = Lens(self.structure, self._curvature, self._thickness,
                              self._n_refractive, self._abbe_number)
        self.efl = self.config.sensor_diagonal / 2 / torch.tan(self.hfov)


class RaytracedOptics(OpticsSimulator):
    """Exact-ray-trace simulator: :meth:`do_ray_tracing` traces the lens
    (on kernel K1 with ``trace_engine="fused"``) and logs the loss terms.
    Keyword arguments that name ``SimulatorConfig`` fields configure it; the
    rest go to :class:`OpticsSimulator`."""

    def __init__(self, initial_lens_path="", glass_catalog_path=None,
                 quantized_continuous_glass_variables=True, device="cuda", **kwargs):
        sim_keys = {f.name for f in dataclasses.fields(SimulatorConfig)}
        cfg_kw = {k: kwargs.pop(k) for k in list(kwargs) if k in sim_keys}
        super().__init__(initial_lens_path, config=SimulatorConfig(**cfg_kw), device=device,
                         **kwargs)
        self.quantized_continuous_glass_variables = quantized_continuous_glass_variables
        if glass_catalog_path:
            self.catalog_g = glass_mod.load_catalog(glass_catalog_path, device=self.device)
        else:
            self.catalog_g = glass_mod.default_catalog_g(device=self.device)
        self.initialize()

    def do_ray_tracing(self, lens: Optional[Lens] = None,
                       generator: Optional[torch.Generator] = None, should_log=True):
        """Trace ``lens`` (the loaded one by default); returns (x, y, ray_ok)
        and keeps the loss terms in ``loss_dict``, logged under ``loss/``
        with the failed and backward ray counts under ``ray_tracing/``."""
        lens = lens if lens is not None else self.lensR
        res, loss_dict = do_ray_tracing(self.specs, lens, self.config, generator=generator)
        self.loss_dict = loss_dict
        if should_log:
            self.logged_metrics.update({"loss/" + k: v for k, v in loss_dict.items()})
            self.logged_metrics.update({
                "ray_tracing/ray_failures": torch.sum(~res.ray_ok),
                "ray_tracing/backward_rays": torch.sum(res.ray_backward),
            })
        return res.x, res.y, res.ray_ok

    def get_catalog_glass_indices(self, g):
        """The closest catalog glass of each optimized glass."""
        return glass_mod.catalog_glass_indices(g, self.catalog_g)

    def get_vars(self) -> Dict[str, Any]:
        """State dump of the current design."""
        lens = self.lensR
        st = lens.structure
        return {
            "nd": _numbers(lens.flat_nd),
            "v": _numbers(lens.flat_v),
            "t": _numbers(lens.flat_t),
            "lens_c": _numbers(lens.flat_c),
            "g": _numbers(glass_mod.g_from_n_v(lens.flat_nd, lens.flat_v)),
            "stop_idx": list(st.stop_idx),
            "mask": st.mask.tolist(),
            "mask_G": st.mask_G.tolist(),
            "hfov": _numbers(self.hfov),
            "epd": _numbers(self.epd),
            "efl": _numbers(self.efl),
        }

    def ShowTraceResult(self, x, y, ray_ok, loss_unsup, show=True):
        """Spot diagram colored by wavelength; returns the figure."""
        from torchoptics_tpu_torch.utils.plotting import show_trace_result
        return show_trace_result(x, y, ray_ok, loss_unsup, self.config.wavelengths, show=show)
