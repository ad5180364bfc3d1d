"""Train a neural lens-design generator against the unsupervised optical loss.

A small MLP maps lens specifications (EPD, HFOV) to design vectors (glass
g-pairs, curvatures, thicknesses); the differentiable ray tracer scores
each design by spot RMS + physical penalties; gradients flow through the
trace back into the network. The whole batch traces in one population
launch: on the GPU one K2 forward and one K2 backward launch a step
(``--engine fused``), or the pure-torch engine (``--engine unroll``; the
JAX example's ``xla`` engine). ``--engine fused`` is the JAX example's
``pallas``.

Usage:
  python -m torchoptics_tpu_torch.examples.train_generator --steps 300 --batch 32
  python -m torchoptics_tpu_torch.examples.train_generator --device cpu --steps 2 --batch 4

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse

import numpy as np
import torch

from torchoptics_tpu_torch.examples import _cli
from torchoptics_tpu_torch.models.generator import (GeneratorMLP, base_design, batch_loss,
                                                   generate, sample_specs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lens-type", default="GA")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--penalty-rate", type=float, default=0.2,
                    help="Lu penalty weight (reference default 0.2). The stock rate lets the "
                    "penalty sum dominate the spot term over long runs; drop it for "
                    "spot-quality-focused training")
    ap.add_argument("--metric", default="y", choices=("y", "xy"),
                    help="spot metric: 'y' = reference parity (blind to sagittal blur), "
                    "'xy' = radial 2-D (use for real runs)")
    ap.add_argument("--eval-designs", type=int, default=256,
                    help="designs sampled for the post-training quality distribution "
                    "(0 disables)")
    ap.add_argument("--snap-glass", action="store_true",
                    help="quantize glass to the Ohara catalog inside training "
                    "(straight-through gradient, glass.quantize_glass_st), so the generator "
                    "optimizes the catalog-snapped designs the eval scores")
    _cli.add_device_arguments(
        ap, "loss engine: fused (one K2 launch a step, forward and backward; the JAX "
        "example's 'pallas'; the default on the GPU) or unroll (pure torch; the JAX "
        "example's 'xla'; the default on the CPU)")
    args = ap.parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch.loss import OpticalLoss
    from torchoptics_tpu_torch.models import glass as glass_mod

    device = args.device
    ol = OpticalLoss(args.lens_type, n_sampled_fields=4, n_pupil_rings=6,
                     spot_metric=args.metric, penalty_rate=args.penalty_rate)
    net = GeneratorMLP((2, args.hidden, args.hidden, ol.numout),
                       torch.Generator().manual_seed(args.seed), device)
    base = base_design(ol, device)
    spec_gen = torch.Generator(device=device).manual_seed(args.seed)
    catalog_g = glass_mod.default_catalog_g(device=device) if args.snap_glass else None
    optimizer = torch.optim.Adam(net.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    params = list(net.parameters())

    print(f"training {args.lens_type} generator: batch={args.batch}, "
          f"metric={args.metric}, engine={engine}, device={device}")
    first = loss = float("nan")
    for i in range(args.steps):
        loss = batch_loss(ol, net, sample_specs(spec_gen, args.batch, device), base, engine,
                          catalog_g)
        grads = torch.autograd.grad(loss, params)
        # Generator training can hit non-finite designs early on: such a
        # step applies zero gradients, as the JAX example's does.
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                    for g in grads)
        for p, g in zip(params, grads):
            p.grad = g if finite else torch.zeros_like(g)
        optimizer.step()
        loss = float(loss.detach())
        if i == 0:
            first = loss
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:5d}: loss={loss:.5f}", flush=True)
    print(f"final loss {loss:.5f} (from {first:.5f})")

    if args.eval_designs > 0:
        # Design-quality distribution of the trained generator: sample
        # specs, generate designs, snap glass to the Ohara catalog, rebuild
        # and score both spot metrics.
        from torchoptics_tpu_torch.ops import metrics as metrics_mod
        from torchoptics_tpu_torch.ops import trace as trace_mod

        G = ol.numglass
        with torch.no_grad():
            inputs = sample_specs(spec_gen, args.eval_designs, device)
            outputs = generate(net, inputs, base)
            g_snap = glass_mod.map_glass_to_closest(
                outputs[:, : 2 * G].reshape(-1, 2), glass_mod.default_catalog_g(device=device))
            outputs_snap = torch.cat((g_snap.reshape(args.eval_designs, 2 * G),
                                      outputs[:, 2 * G:]), dim=1)
        cfg = ol._sim_config().trace_config(engine=engine)
        for label, outs in (("catalog-snapped glass", outputs_snap),
                            ("raw (unsnapped) glass", outputs)):
            with torch.no_grad():
                specs_b, lens_b = ol.build_batch(inputs, outs, stop_idx=1)
                res = trace_mod.trace_rays(specs_b, lens_b, cfg)
                rms_y = metrics_mod.compute_rms2d(res.x, res.y, res.ray_ok).cpu().numpy()
                rms_xy = torch.mean(metrics_mod.compute_spot_rms_xy(res.x, res.y, res.ray_ok),
                                    dim=1).cpu().numpy()
                frac_ok = torch.mean(res.ray_ok.float(), dim=(1, 2, 3)).cpu().numpy()
            valid = np.isfinite(rms_xy) & (frac_ok > 0.5)
            print(f"\ndesign-quality distribution ({args.eval_designs} specs, {label}; "
                  f"{valid.mean() * 100:.0f}% trace >50% of rays):")
            for name, v in (("rms_y", rms_y[valid]), ("rms_xy", rms_xy[valid])):
                if v.size == 0:
                    print(f"  {name}: no valid designs")
                    continue
                q = np.percentile(v, (10, 50, 90))
                print(f"  {name}  p10 {q[0]:.5f}  p50 {q[1]:.5f}  p90 {q[2]:.5f}  "
                      "(EFL=1 units)")


if __name__ == "__main__":
    main()
