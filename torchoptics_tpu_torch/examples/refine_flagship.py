"""Multi-start refinement of a lens design against mean spot RMS.

The recipe behind the shipped double-Gauss flagships (``zoo.DOUBLE_GAUSS``
and, with ``--aspherize``, ``zoo.DOUBLE_GAUSS_ASPH``): a population of
perturbed copies of the starting design is optimized simultaneously, one
population trace a step, against

    mean spot RMS
    + 1e-4 * Lu penalty (keeps geometry away from ray failure)
    + hinge(min thickness >= --min-t)
    + 0.1 * hinge(image clearance >= --min-image)
    + 0.01 * hinge(total track <= --max-track)

with catalog glass frozen and EFL pinned by the last-curvature solve.
The best valid member is then polished solo with denser sampling.

On the GPU (``--engine fused``) a step is one K2 forward and one K2
backward launch in Lu mode (K4 with ``--aspherize``), the population of
one of ``--aspherize`` and of the polish included; ``--engine unroll``
traces with the pure-torch engine's per-surface stacks.

Examples:
  python -m torchoptics_tpu_torch.examples.refine_flagship --lens double_gauss --steps 25000
  python -m torchoptics_tpu_torch.examples.refine_flagship --lens double_gauss --aspherize \\
      --steps 30000 --save out.json
  python -m torchoptics_tpu_torch.examples.refine_flagship --device cpu --pop 2 --steps 2 \\
      --polish-steps 1

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from torchoptics_tpu_torch.examples import _cli


class LossConfig(NamedTuple):
    """What ``fused_batch.batched_unsupervised_loss`` reads of a
    ``SimulatorConfig``: the trace configuration, the spot metric and the
    penalty weight (1e-4 here, so its per-system Lu is the example's
    rms + 1e-4 ΣQ)."""

    cfg: object
    spot_metric: str
    penalty_rate: float = 1e-4

    def trace_config(self):
        return self.cfg


def population_loss(specs, lens, cfg, metric, min_t, min_image, max_track):
    """The example's objective on a population (B >= 1): the mean over
    systems of rms + 1e-4 ΣQ plus the thickness, image-clearance and track
    hinges. ``cfg.engine`` "fused" reads rms and ΣQ (the stacks' sum over
    surfaces, fields, pupil and wavelengths over each system's surface
    count) from one K2 (K4) launch; "unroll" from the per-surface stacks."""
    from torchoptics_tpu_torch.ops import fused_batch, metrics
    from torchoptics_tpu_torch.ops import trace as trace_mod

    if cfg.engine == "fused":
        _, terms = fused_batch.batched_unsupervised_loss(specs, lens, LossConfig(cfg, metric))
        lu = terms["loss_unsup"]
    else:
        res = trace_mod.trace_rays(specs, lens, cfg, aggregate=trace_mod.AGG_TORCH)
        rms = metrics.compute_spot_rms(res.x, res.y, res.ray_ok, metric)
        nseq = torch.as_tensor(lens.structure.n_surfaces, dtype=rms.dtype, device=rms.device)
        q = (torch.sum(res.stacks["theta_norm"], 0) + torch.sum(res.stacks["theta_prime_norm"], 0)
             + torch.sum(res.stacks["z_RELU"], 0))
        lu = rms + 1e-4 * torch.sum(q, dim=(1, 2, 3)) / nseq
    t = lens.t
    tmin_pen = torch.sum(torch.clamp(min_t - t, min=0.0) ** 2, dim=1)
    bfl_pen = torch.clamp(min_image - t[:, -1], min=0.0) ** 2
    track_pen = torch.clamp(torch.sum(t, dim=1) - max_track, min=0.0) ** 2
    return torch.mean(lu + tmin_pen + 0.1 * bfl_pen + 0.01 * track_pen)


def build_lens(structure, params, catalog_g, efl_target):
    """The population's lenses from normalized parameters: the last
    curvature solved (EFL = 1), the back focal length added back, catalog
    glass (straight-through), scaled to ``efl_target``."""
    from torchoptics_tpu_torch import optimize as opt
    lens = opt.lens_from_normalized(structure, params, catalog_g, add_bfl=True,
                                    qc_variables=True)
    return lens.scale(efl_target / lens.efl)


def starting_population(name, n_pop, aspherize, device="cuda"):
    """(Specs, Lens) of the perturbed starting population: curvature and
    thickness noise from ``np.random.default_rng(11)`` (the JAX example's
    draws), member 0 unperturbed; one member with zero conics and r^4, r^6
    terms for ``aspherize``."""
    from torchoptics_tpu_torch import zoo
    from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure

    rng = np.random.default_rng(11)
    p = zoo.get_prescription(name)
    base_specs, base_lens = zoo.build(name, device=device)
    S = base_lens.c.shape[1]
    B = 1 if aspherize else n_pop
    st = Structure(tuple(p["stop_idx"] * B), tuple(p["sequence"] * B))
    tile = lambda v: np.tile(v.cpu().numpy().astype(np.float32)[None, 0], (B, 1))
    c0, t0 = tile(base_lens.c), tile(base_lens.t)
    sig = np.resize(np.repeat([0.0, 0.002, 0.005, 0.01, 0.02, 0.04], 4), B)
    c = (c0 * (1 + sig[:, None] * rng.standard_normal((B, S)))).astype(np.float32)
    t = np.maximum(t0 * (1 + 0.5 * sig[:, None] * rng.standard_normal((B, S))).astype(np.float32),
                   1.0)
    as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    kw = {}
    if aspherize:
        kw = dict(kappa=torch.zeros((B, S), device=device),
                  asph=torch.zeros((B, S, 2), device=device))
    lens = Lens(st, as_t(c), as_t(t), as_t(tile(base_lens.nd)), as_t(tile(base_lens.v)), **kw)
    specs = Specs(st, base_specs.epd.repeat(B), base_specs.hfov.repeat(B))
    return specs, lens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="double_gauss")
    ap.add_argument("--pop", type=int, default=24)
    ap.add_argument("--steps", type=int, default=25000)
    ap.add_argument("--polish-steps", type=int, default=12000)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--min-t", type=float, default=0.8)
    ap.add_argument("--min-image", type=float, default=12.0)
    ap.add_argument("--max-track", type=float, default=110.0)
    ap.add_argument("--aspherize", action="store_true",
                    help="add conic + r^4/r^6 terms (population of 1)")
    ap.add_argument("--metric", default="y", choices=("y", "xy"),
                    help="spot metric: 'y' = reference-parity Y-deviation RMS; 'xy' = radial "
                    "2-D RMS (sees sagittal blur)")
    ap.add_argument("--save", default=None, help="write the result as JSON")
    _cli.add_device_arguments(ap)
    args = ap.parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch import optimize as opt, zoo
    from torchoptics_tpu_torch.models import glass as glass_mod
    from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure
    from torchoptics_tpu_torch.ops import metrics
    from torchoptics_tpu_torch.ops import trace as trace_mod

    device = args.device
    p = zoo.get_prescription(args.lens)
    base_specs, base_lens = zoo.build(args.lens, device=device)
    specs, lens = starting_population(args.lens, args.pop, args.aspherize, device)
    st = lens.structure
    efl_target = float(base_lens.efl[0])
    catalog_g = glass_mod.default_catalog_g(device=device)

    def trace_config(n_rays, rel_fields):
        return trace_mod.TraceConfig(mode="circular", n_rays=n_rays, rel_fields=rel_fields,
                                     wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1,
                                     engine=engine)

    train_cfg = trace_config((10, 10), (0.0, 0.45, 0.707, 0.88, 1.0))
    eval_cfg = trace_config((10, 10), (0.0, 0.707, 1.0))

    def evaluate(l, s):
        with torch.no_grad():
            res = trace_mod.trace_rays(s, l, eval_cfg)
            rms = metrics.compute_spot_rms(res.x, res.y, res.ray_ok, args.metric)
            okf = torch.mean(res.ray_ok.float(), dim=(1, 2, 3))
        return rms.cpu().numpy(), okf.cpu().numpy()

    def evaluate_both(l, s):
        """Final report: y-only (reference parity) AND radial xy, plus the
        field-edge xy RMS the y-metric is blind to."""
        with torch.no_grad():
            res = trace_mod.trace_rays(s, l, eval_cfg)
            rms_y = metrics.compute_rms2d(res.x, res.y, res.ray_ok)
            rms_xy_f = metrics.compute_spot_rms_xy(res.x, res.y, res.ray_ok)
        return [a.cpu().numpy() for a in (rms_y, torch.mean(rms_xy_f, dim=1), rms_xy_f[:, -1])]

    def run(st_, specs_, lens_, steps, lr, cfg):
        build = lambda params: build_lens(st_, params, catalog_g, efl_target)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in opt.get_normalized_lens_variables(lens_, add_bfl=True).items()}
        adam = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)

        def step():
            val = population_loss(specs_, build(params), cfg, args.metric, args.min_t,
                                  args.min_image, args.max_track)
            grads = torch.autograd.grad(val, list(params.values()), allow_unused=True)
            grads = [torch.zeros_like(p_) if g is None or k == "g" else g   # glass frozen
                     for (k, p_), g in zip(params.items(), grads)]
            # A non-finite loss or gradient keeps both the parameters and
            # Adam's state.
            if bool(torch.isfinite(val)) and all(bool(torch.isfinite(g).all()) for g in grads):
                for p_, g in zip(params.values(), grads):
                    p_.grad = g
                adam.step()
                for p_ in params.values():
                    p_.grad = None
            return float(val.detach())

        # Keep the best-seen snapshot (by the eval metric over valid
        # members) rather than the last step: Adam can wander off a
        # minimum late in a long run.
        snapshot = lambda: {k: v.detach().clone() for k, v in params.items()}
        eval_every = max(100, min(500, steps // 50 or 1))
        best_score, best_params = np.inf, snapshot()
        for i in range(steps):
            val = step()
            if i % 2500 == 0:
                print(f"  step {i}: loss={val:.6f}", flush=True)
            if (i + 1) % eval_every == 0 or i + 1 == steps:
                with torch.no_grad():
                    l = build(params)
                rms_e, okf_e = evaluate(l, specs_)
                t_ = l.t.detach().cpu().numpy()
                valid = ((okf_e >= 1.0) & (t_.min(axis=1) > 0.5)
                         & (t_[:, -1] > args.min_image - 1.0) & np.isfinite(rms_e))
                score = float(np.min(np.where(valid, rms_e, np.inf)))
                if score < best_score:
                    best_score, best_params = score, snapshot()
        with torch.no_grad():
            return build(best_params if np.isfinite(best_score) else params)

    t0_ = time.time()
    lens_out = run(st, specs, lens, args.steps, args.lr, train_cfg)
    rms, okf = evaluate(lens_out, specs)
    t_out = lens_out.t.cpu().numpy()
    tmin, tlast = t_out.min(axis=1), t_out[:, -1]
    valid = ((okf >= 1.0) & (tmin > 0.5) & (tlast > args.min_image - 1.0) & np.isfinite(rms))
    best = int(np.argsort(np.where(valid, rms, np.inf))[0])
    print(f"best member {best}: rms={rms[best]:.5f} "
          f"(member 0 = unperturbed: {rms[0]:.5f}) "
          f"[{time.time() - t0_:.0f}s]", flush=True)

    # Polish the best member solo with denser sampling.
    st1 = Structure(tuple(p["stop_idx"]), tuple(p["sequence"]))
    mg = torch.as_tensor(st1.mask_G[0], device=device)
    kw = {}
    if lens_out.kappa is not None:
        kw = dict(kappa=lens_out.kappa[best][None], asph=lens_out.asph[best][None])
    bl = Lens(st1, lens_out.c[best], lens_out.t[best], lens_out.nd[best][mg],
              lens_out.v[best][mg], **kw)
    sp1 = Specs(st1, base_specs.epd, base_specs.hfov)
    polish_cfg = trace_config((14, 14), (0.0, 0.3, 0.55, 0.707, 0.85, 1.0))
    final = run(st1, sp1, bl, args.polish_steps, args.lr / 4, polish_cfg)
    rms1, okf1 = evaluate(final, sp1)
    ry, rxy, rxy_edge = evaluate_both(final, sp1)
    print(f"FINAL rms({args.metric})={float(rms1[0]):.6f} "
          f"ok={float(okf1[0]):.4f} "
          f"efl={float(final.efl[0]):.4f} tmin={float(final.t.min()):.3f} "
          f"t_last={float(final.t[0, -1]):.3f}")
    print(f"FINAL metrics: rms_y={float(ry[0]):.6f} "
          f"rms_xy={float(rxy[0]):.6f} rms_xy_edge={float(rxy_edge[0]):.6f}")
    if args.save:
        as_list = lambda a: a.detach().cpu().numpy().tolist()
        out = dict(c=as_list(final.flat_c), t=as_list(final.flat_t),
                   nd=as_list(final.flat_nd), v=as_list(final.flat_v))
        if final.kappa is not None:
            out["kappa"] = as_list(final.kappa[0])
            out["asph"] = as_list(final.asph[0])
        with open(args.save, "w") as f:
            json.dump(out, f)
        print("saved", args.save)


if __name__ == "__main__":
    main()
