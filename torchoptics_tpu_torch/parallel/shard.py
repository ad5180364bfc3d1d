"""Data-parallel traces, losses and lens-optimization steps over a mesh of
ranks.

PyTorch counterpart of ``torchoptics_tpu.parallel.shard``. Every rank runs
the same code on its block of the (systems x pupil samples) work, as the
JAX package's ``shard_map`` bodies do on each device:

* :func:`sharded_trace_rays`: one trace whose pupil-sample axis is split
  over the mesh's ``rays`` axis (kernel K1 on the fused engine, one launch
  a rank), the full result on every rank;
* :func:`shard_map_mean_rms`: the spot-RMS reduction of ray shards;
* :func:`sharded_fused_losses`: the fused population loss, one K2 (or K4)
  launch a rank on its block, the loss moments summed over the mesh;
* :func:`sharded_unroll_losses`: the same loss on the pure-torch engine,
  each rank tracing its block with the per-surface stacks;
* :func:`make_sharded_train_step`: a ``LensOptimizer`` step on a
  population whose parameters are replicated, the gradients summed over
  the world before Adam.

Each rank's gradient is its block's share (see ``mesh``); the train step
sums them. The pupil sample is drawn whole on every rank, from the same
generator state, and sliced, so a sharded call sees the rays a single
process would.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch import optimize as opt_mod
from torchoptics_tpu_torch import simulator as sim_mod
from torchoptics_tpu_torch.models.structure import Lens, Specs
from torchoptics_tpu_torch.ops import fused_batch
from torchoptics_tpu_torch.ops import fused_trace
from torchoptics_tpu_torch.ops import pupil as pupil_mod
from torchoptics_tpu_torch.ops import trace as trace_mod
from torchoptics_tpu_torch.parallel import mesh as mesh_mod
from torchoptics_tpu_torch.parallel.mesh import LENS_AXIS, RAY_AXIS, Mesh


def _pupil_block(mode, n_rays, n_systems, generator, device, mesh: Mesh):
    """The global pupil sample, padded to a 'rays'-axis multiple with
    chief-ray clones at the pupil center, and this rank's slice of it.
    Returns (xp, yp, P_total, P_loc, first index of this rank's rays)."""
    xp, yp = pupil_mod.sample_pupil(mode, n_rays, n_systems, generator=generator,
                                    device=device)
    p_total = xp.shape[2]
    p_pad = mesh_mod.pad_to_multiple(p_total, mesh.shape[RAY_AXIS])
    if p_pad != p_total:
        pad = lambda a: torch.cat((a, a.new_zeros(a.shape[:2] + (p_pad - p_total, 1))), dim=2)
        xp, yp = pad(xp), pad(yp)
    block = mesh_mod.axis_block(mesh, RAY_AXIS, p_pad)
    return xp[:, :, block], yp[:, :, block], p_total, block.stop - block.start, block.start


def _gather_rays(mesh: Mesh, a: torch.Tensor, dim: int, start: int, p_pad: int):
    """The full pupil axis ``dim`` of a ray-block array on every rank: each
    rank writes its block into zeros, and the ranks sum the buffers."""
    before = list(a.shape)
    before[dim] = start
    after = list(a.shape)
    after[dim] = p_pad - start - a.shape[dim]
    full = torch.cat((a.new_zeros(before), a, a.new_zeros(after)), dim=dim)
    return mesh.sum(full, RAY_AXIS)


def sharded_trace_rays(specs: Specs, lens: Lens, config: trace_mod.TraceConfig, mesh: Mesh,
                       generator: Optional[torch.Generator] = None,
                       aggregate: Tuple[str, ...] = ()) -> trace_mod.TraceResult:
    """Trace with the pupil axis split over the mesh's ``rays`` axis.

    The pupil sample is drawn whole, padded to a multiple of the axis with
    chief-ray clones and sliced; each rank traces its slice (on the fused
    engine: K1 for one spherical system, K3 for a conic/asphere one, K2 or
    K4 for a population, one launch), and the full ``TraceResult``, padding
    dropped, is returned on every rank."""
    if config.engine == "fused" and aggregate:
        raise NotImplementedError(
            "engine='fused' does not materialize per-surface aggregate stacks; "
            "use engine='unroll'")
    xp, yp, p_total, p_loc, start = _pupil_block(config.mode, config.n_rays, len(lens),
                                                 generator, lens.device, mesh)
    if config.engine == "fused" and len(lens) == 1:
        res = fused_trace.trace_rays_fused(specs, lens, config, xy=(xp, yp))
    elif config.engine == "fused":
        res = fused_batch.trace_rays_fused_batch(specs, lens, config, xy=(xp, yp))
    else:
        res = trace_mod.trace_rays(specs, lens, config, xy=(xp, yp), aggregate=aggregate)
    p_pad = p_loc * mesh.shape[RAY_AXIS]
    # One sum for the six ray arrays, the masks as 0/1 in the float type.
    rays = torch.stack((res.x, res.y, res.cx, res.cy, res.ray_ok.to(res.x.dtype),
                        res.ray_backward.to(res.x.dtype)))
    rays = _gather_rays(mesh, rays, 3, start, p_pad)[:, :, :, :p_total]
    stacks = None
    if res.stacks is not None:
        stacks = {k: _gather_rays(mesh, s, 3, start, p_pad)[:, :, :, :p_total]
                  for k, s in res.stacks.items()}
    return trace_mod.TraceResult(rays[0], rays[1], rays[2], rays[3], rays[4] > 0.5,
                                 rays[5] > 0.5, stacks)


def shard_map_mean_rms(x: torch.Tensor, y: torch.Tensor, ray_ok: torch.Tensor, mesh: Mesh,
                       n_pupil: int) -> torch.Tensor:
    """The spot-RMS reduction (``metrics.compute_rms2d``) of ray shards:
    each rank passes its (B, F, P_loc, W) block of the pupil axis, padded to
    a multiple of the 'rays' axis, and the global pupil count ``n_pupil``;
    each reduces its block and the partial sums are summed over 'rays'.
    Returns the per-system RMS (B,) on every rank."""
    B, F, p_loc, W = y.shape
    start = mesh.coords[RAY_AXIS] * p_loc
    real = (start + torch.arange(p_loc, device=y.device)) < n_pupil
    real = real[None, None, :, None]
    ycent = mesh.sum(torch.sum(torch.where(real, y, 0.0), dim=2), RAY_AXIS) / n_pupil
    ymean = mesh.vary(torch.mean(ycent, dim=-1), RAY_AXIS)                # (B, F)
    dev2 = torch.where(ray_ok & real, (y - ymean[:, :, None, None]) ** 2, 0.0)
    ss = mesh.sum(torch.sum(dev2, dim=(2, 3)), RAY_AXIS)                  # (B, F)
    pos = ss > 0
    rms_f = torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / (n_pupil * W)), 0.0)
    return torch.mean(rms_f, dim=1)


def _replicated_once(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """A term every rank computes from replicated inputs: the same value on
    every rank, its gradient on rank 0 only, so that the world-sum of the
    ranks' gradients counts it once."""
    return value if mesh.rank == 0 else value.detach()


def _weighted_total(loss_dict, config) -> torch.Tensor:
    return sum(loss_dict[k] * w for k, w in config.loss_weights.items()
               if k in loss_dict and w is not None)


def _block(specs: Specs, lens: Lens, cfg: trace_mod.TraceConfig, mesh: Mesh, generator):
    """This rank's block of a population loss: its rows of the population
    padded to a 'lens'-axis multiple with clones of system 0, which of them
    are real systems, their specs and lens, and their pupil block
    (``_pupil_block``). Returns (rows, real_sys, specs_loc, lens_loc, xp,
    yp, P_total, P_loc, start)."""
    B = len(lens)
    b_pad = mesh_mod.pad_to_multiple(B, mesh.shape[LENS_AXIS])
    rows = np.arange(b_pad)[mesh_mod.lens_sharding(mesh, b_pad)]
    real_sys = rows < B
    rows = np.where(real_sys, rows, 0)
    xp, yp, p_total, p_loc, start = _pupil_block(cfg.mode, cfg.n_rays, B, generator,
                                                 lens.device, mesh)
    if xp.shape[0] == B:
        xp, yp = xp[rows], yp[rows]
    return rows, real_sys, specs[rows], lens[rows], xp, yp, p_total, p_loc, start


def _reduce_losses(mesh: Mesh, config: sim_mod.SimulatorConfig, lens: Lens, rows, real_sys,
                   x4, y4, ok4, real_ray, p_total: int, sums, g, catalog_g, full: bool):
    """The population loss from this rank's block: ``x4``, ``y4``, ``ok4``
    the (B_loc, W, F, P_loc) rays of the systems ``rows`` of ``lens``,
    ``real_ray`` (P_loc,) the block's real pupil rays, ``sums`` each
    system's sums over its real rays of the per-ray penalty ΣQ (over
    surfaces, before the division by the surface count) and, when ``full``,
    of the ray-path and the ray-angle hinges. The spot moments and ``sums``
    are summed over 'rays', the per-system terms over 'lens'; padded systems
    and rays weigh zero. Returns (total, loss_dict), the same on every rank."""
    B = len(lens)
    b_loc, W, F, p_loc = x4.shape
    # Spot RMS from moments summed over 'rays': 'y' is compute_rms2d's
    # (all-ray centroid, ok-masked deviations, all-ray denominator), 'xy'
    # the radial metric (masked centroid and count).
    if config.spot_metric == "xy":
        w = ok4.to(x4.dtype)
        m1 = mesh.sum(torch.stack((torch.sum(w, dim=(1, 3)), torch.sum(x4 * w, dim=(1, 3)),
                                   torch.sum(y4 * w, dim=(1, 3)))), RAY_AXIS)
        count = torch.clamp(m1[0], min=1.0)                                # (B_loc, F)
        xc, yc = mesh.vary(m1[1:] / count, RAY_AXIS)
        dev2 = torch.where(ok4, (x4 - xc[:, None, :, None]) ** 2
                           + (y4 - yc[:, None, :, None]) ** 2, 0.0)
    else:
        ycent = mesh.sum(torch.sum(torch.where(real_ray, y4, 0.0), dim=3),
                         RAY_AXIS) / p_total                               # (B_loc, W, F)
        ymean = mesh.vary(torch.mean(ycent, dim=1), RAY_AXIS)              # (B_loc, F)
        dev2 = torch.where(ok4, (y4 - ymean[:, None, :, None]) ** 2, 0.0)
        count = p_total * W
    # The second moments, the penalty sums and the hinge sums in one sum.
    m2 = mesh.sum(torch.cat([torch.sum(dev2, dim=(1, 3))] + [v[:, None] for v in sums], dim=1),
                  RAY_AXIS)
    ss = m2[:, :F]
    pos = ss > 0
    rms_b = torch.mean(torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / count), 0.0),
                       dim=1)                                              # (B_loc,)
    n_seq = torch.as_tensor(lens.structure.n_surfaces[rows], dtype=m2.dtype, device=m2.device)
    sum_q = m2[:, F] / n_seq
    per_sys = [rms_b + config.penalty_rate * sum_q, rms_b, sum_q]
    if full:
        per_sys += [m2[:, F + 1], m2[:, F + 2]]
    sysw = torch.as_tensor(real_sys, device=m2.device)                    # (B_loc,)
    means = mesh.sum(torch.stack([torch.sum(torch.where(sysw, v, 0.0)) for v in per_sys]),
                     LENS_AXIS)
    loss_dict = {"loss_unsup": means[0] / B, "rms": means[1] / B, "penalty": means[2] / B}
    if not full:
        return loss_dict["loss_unsup"], loss_dict
    n_rays = B * F * p_total * W
    loss_dict.update(spot_size=loss_dict["rms"], ray_path=means[3] / n_rays,
                     ray_angle=means[4] / n_rays)
    if g is not None:
        loss_dict["glass"] = _replicated_once(
            mesh, sim_mod.compute_glass_penalty(lens.structure, g, catalog_g))
    return _weighted_total(loss_dict, config), loss_dict


def sharded_fused_losses(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig, mesh: Mesh,
                         g: Optional[torch.Tensor] = None,
                         catalog_g: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         full: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The fused population loss over the ('lens', 'rays') mesh: each rank
    launches K2 (K4 for conic/asphere systems) once on its (system block x
    pupil block); the spot moments are summed over 'rays', the per-system
    terms over 'lens'. The multi-rank form of
    ``fused_batch.batched_compute_losses_fused`` (``full=True``) and of
    ``batched_unsupervised_loss``'s mean (``full=False``): the same math, the
    same in-kernel penalty sums, numerics differing only by the order of
    the sums.

    Populations and pupils that the mesh's axes do not divide are padded
    (systems with clones of system 0, rays with chief-ray clones) and the
    padding weighs zero in every sum. The glass penalty is computed from
    the replicated ``g``; its gradient is rank 0's share.

    Requirements (loud): one ``sequence`` and ``stop_idx``, float32.
    Returns (total, loss_dict) with the same scalars on every rank."""
    cfg = config.trace_config()
    if config.double_precision:
        raise NotImplementedError(
            "sharded_fused_losses is float32 (fused kernels); use trace_engine='unroll' "
            "for double_precision")
    if (len(set(lens.structure.sequence)) != 1
            or len(set(lens.structure.stop_idx)) != 1):
        raise NotImplementedError(
            "sharded_fused_losses expects a homogeneous population (one "
            "lens type/stop per launch); group mixed populations by "
            "sequence as simulator._compute_losses_fused_grouped does")
    if config.spot_metric not in ("y", "xy"):
        raise ValueError(f"spot metric must be 'y' or 'xy', got {config.spot_metric!r}")
    rows, real_sys, specs_loc, lens_loc, xp, yp, p_total, p_loc, start = _block(
        specs, lens, cfg, mesh, generator)
    xpb, ypb, cyb, z0, mu, shape = fused_batch.prepare_fused_inputs_batch(
        specs_loc, lens_loc, cfg, xy=(xp, yp))
    b_loc, F, _, W = shape
    penalties, full_args = True, ()
    if full:
        vertex_z = torch.cumsum(lens_loc.t, dim=1)
        penalties, full_args = "full", (
            torch.cat((vertex_z, vertex_z[:, -1:]), dim=1),
            fused_trace._path_bounds(lens_loc.structure, config.ray_path_lower_thresholds,
                                     config.ray_path_upper_thresholds),
            math.cos(math.radians(config.ray_angle_threshold)) ** 2)
    outs = fused_batch._trace_population(xpb, ypb, cyb, z0, mu, lens_loc, cfg, penalties,
                                         F * p_loc, *full_args)

    real_ray = (start + torch.arange(p_loc, device=xpb.device)) < p_total  # (P_loc,)
    # The (B, W, F, P_loc) view of the flat wavelength-outer outputs.
    per_ray = lambda a: a.reshape(b_loc, W, F, p_loc)
    ray_sum = lambda a: torch.sum(torch.where(real_ray, per_ray(a), 0.0), dim=(1, 2, 3))
    sums = [ray_sum(outs[6]) + ray_sum(outs[7]) + ray_sum(outs[8])]
    if full:
        sums += [ray_sum(outs[9]), ray_sum(outs[10])]
    return _reduce_losses(mesh, config, lens, rows, real_sys, per_ray(outs[0]),
                          per_ray(outs[1]), per_ray(outs[4]) & real_ray, real_ray, p_total,
                          sums, g, catalog_g, full)


def sharded_unroll_losses(specs: Specs, lens: Lens, config: sim_mod.SimulatorConfig,
                          mesh: Mesh, g: Optional[torch.Tensor] = None,
                          catalog_g: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          full: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The unroll engine's population loss over the ('lens', 'rays') mesh:
    each rank traces its (system block x pupil block) on the pure-torch
    engine with the per-surface stacks, and the loss is reduced as
    :func:`sharded_fused_losses` reduces it (the same padding, spot moments
    and sums over 'rays' and 'lens'). ``full=True`` is
    ``simulator.compute_losses``, ``full=False`` ``do_ray_tracing``'s Lu;
    each system's penalty is normalized by its own surface count, so mixed
    populations and double precision are taken. The result is the
    single-process loss up to the order of the sums."""
    cfg = config.trace_config(engine="unroll")
    if config.spot_metric not in ("y", "xy"):
        raise ValueError(f"spot metric must be 'y' or 'xy', got {config.spot_metric!r}")
    rows, real_sys, specs_loc, lens_loc, xp, yp, p_total, p_loc, start = _block(
        specs, lens, cfg, mesh, generator)
    res = trace_mod.trace_rays(specs_loc, lens_loc, cfg, xy=(xp, yp),
                               aggregate=sim_mod.FULL_AGGREGATE if full else trace_mod.AGG_TORCH)
    st = res.stacks
    real_ray = (start + torch.arange(p_loc, device=res.x.device)) < p_total   # (P_loc,)
    # Per-ray sums over the surfaces, (B_loc, F, P_loc, W), summed over the
    # real rays of each system.
    ray_sum = lambda a: torch.sum(torch.where(real_ray[:, None], a, 0.0), dim=(1, 2, 3))
    mask = torch.as_tensor(lens_loc.structure.mask, device=res.x.device).T[:, :, None, None, None]
    q = torch.sum(torch.where(mask, st["theta_norm"] + st["theta_prime_norm"] + st["z_RELU"],
                              0.0), dim=0)
    sums = [ray_sum(torch.where(torch.isnan(q), 0.0, q))]
    if full:
        threshold = math.cos(math.radians(config.ray_angle_threshold)) ** 2
        sums += [ray_sum(torch.sum(sim_mod.ray_path_hinges(
                     lens_loc, st["z"], config.ray_path_lower_thresholds,
                     config.ray_path_upper_thresholds), dim=0)),
                 ray_sum(torch.sum(torch.clamp(threshold - sim_mod.masked_cos2(lens_loc, st),
                                               min=0.0), dim=0))]
    wfp = lambda a: a.permute(0, 3, 1, 2)                    # (B, F, P, W) -> (B, W, F, P)
    return _reduce_losses(mesh, config, lens, rows, real_sys, wfp(res.x), wfp(res.y),
                          wfp(res.ray_ok) & real_ray, real_ray, p_total, sums, g, catalog_g,
                          full)


@dataclass
class ShardedLensOptimizer(opt_mod.LensOptimizer):
    """``LensOptimizer`` whose parameters are replicated on every rank of
    ``mesh``: each rank's gradient (its block's share of the loss) is summed
    over the world before the step, so every rank takes the same step."""

    mesh: Optional[Mesh] = None

    def _gradients(self, total, params):
        tensors = list(params.values())
        grads = torch.autograd.grad(total, tensors, allow_unused=True)
        for p, gr in zip(tensors, grads):
            p.grad = gr
        self.mesh.sum_gradients(tensors)
        grads = [p.grad for p in tensors]
        for p in tensors:
            p.grad = None
        return grads


def make_sharded_train_step(specs: Specs, config: sim_mod.SimulatorConfig, mesh: Mesh,
                            learning_rate: float = 1e-3,
                            trainable: Tuple[str, ...] = ("c", "t", "g"),
                            use_full_loss: bool = False, add_bfl: bool = True,
                            qc_variables: bool = True, efl_target: Optional[float] = None):
    """Build ``(optimizer, init_fn, step_fn)`` for data-parallel optimization
    of a lens population.

    The step is the single-process ``LensOptimizer`` step (the same
    normalized variables, quantized-continuous glass and Adam update) with
    the population's parameters replicated: each rank backpropagates the
    global loss through its own block, and the gradients are summed over
    the world before Adam. ``init_fn(lens)`` starts every rank from rank
    0's parameters; ``step_fn(state, generator=None) -> (state, total,
    loss_dict)``. ``efl_target`` is ``LensOptimizer``'s (trace at that
    EFL rather than at EFL = 1).

    With ``config.trace_engine == "fused"`` the loss is
    :func:`sharded_fused_losses`, on the unroll engine (the JAX package's
    GSPMD route) :func:`sharded_unroll_losses`; both over both axes."""
    losses = sharded_fused_losses if config.trace_engine == "fused" else sharded_unroll_losses

    def loss_fn(specs_, lens_, config_, g_, catalog_g_, generator_):
        return losses(specs_, lens_, config_, mesh, g=g_, catalog_g=catalog_g_,
                      generator=generator_, full=use_full_loss)

    opt = ShardedLensOptimizer(specs, config, learning_rate=learning_rate, add_bfl=add_bfl,
                               qc_variables=qc_variables, use_full_loss=use_full_loss,
                               trainable=trainable, efl_target=efl_target, loss_fn=loss_fn,
                               mesh=mesh)

    def init_fn(lens: Lens):
        state = opt.init(lens)
        mesh.broadcast_(state.params.values())
        return state

    return opt, init_fn, opt.step
