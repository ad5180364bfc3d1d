"""Monte-Carlo tolerancing of a lens design in one batched kernel launch.

Tiles the design into a perturbed population, scores every sample in one
launch of kernel K2 (K4 for a conic/asphere design) on the card, and
reports the RMS spot-size distribution at the nominal focus and refocused,
the manufacturing yield, the gradient-based sensitivity table (one K2
forward and backward), the per-field MTF and the on-axis Strehl ratio.

Examples:
  python -m torchoptics_tpu_torch.examples.tolerance_analysis --lens double_gauss --samples 4096
  python -m torchoptics_tpu_torch.examples.tolerance_analysis --lens cooke --sigma-c 2e-4 \\
      --sigma-t 0.02 --rms-threshold 0.01 --seed 7
  python -m torchoptics_tpu_torch.examples.tolerance_analysis --device cpu --samples 8

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse

import numpy as np
import torch

from torchoptics_tpu_torch.examples import _cli


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="double_gauss",
                    help="zoo prescription name (default: double_gauss)")
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--sigma-c", type=float, default=1e-4, help="curvature sigma, 1/mm")
    ap.add_argument("--sigma-t", type=float, default=0.01, help="thickness sigma, mm")
    ap.add_argument("--sigma-nd", type=float, default=5e-4)
    ap.add_argument("--sigma-v", type=float, default=0.1)
    ap.add_argument("--rms-threshold", type=float, default=None,
                    help="spot-RMS spec (mm) for the yield estimate")
    ap.add_argument("--uniform", action="store_true",
                    help="uniform (half-width) instead of normal tolerances")
    ap.add_argument("--seed", type=int, default=0)
    _cli.add_device_arguments(ap)
    args = ap.parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch import analysis, simulator as sim, zoo
    from torchoptics_tpu_torch.ops import trace as trace_mod
    from torchoptics_tpu_torch.ops import wavefront as wfront

    specs, lens = zoo.build(args.lens, device=args.device)
    config = sim.SimulatorConfig(
        n_sampled_fields=5, n_pupil_rings=8, pupil_sampling="circular",
        n_ray_aiming_iter=1, wavelengths=(459.0, 520.0, 640.0),
        psf_shape=(33, 33), psf_abs_pixel_size=4e-3, trace_engine=engine)
    tol = analysis.Tolerances(
        c=args.sigma_c, t=args.sigma_t, nd=args.sigma_nd, v=args.sigma_v,
        distribution="uniform" if args.uniform else "normal")

    def run(compensator):
        # The same seed for both runs: the same perturbed population.
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        with torch.no_grad():
            return analysis.tolerance_analysis(specs, lens, config, tol, args.samples, gen,
                                               rms_threshold=args.rms_threshold,
                                               compensator=compensator)

    out = run(None)
    # Back focus is the free compensator a manufacturer always adjusts: every
    # sample is refocused (the closed-form least-squares image shift) before
    # scoring. Uncompensated yields are what a rigid as-built stack shows.
    out_c = run("refocus")

    print(f"{args.lens}: {args.samples} perturbed samples, engine={engine}, "
          f"device={args.device}")
    print(f"  {'':24s} {'nominal focus':>14s} {'refocused':>14s}")
    for label, key in (("nominal RMS", "nominal_rms"), ("mean", "mean"), ("std", "std")):
        print(f"  {label:24s} {float(out[key]):14.5f} {float(out_c[key]):14.5f}")
    for q in (50, 90, 99):
        print(f"  {f'p{q}':24s} {float(out[f'p{q}']):14.5f} {float(out_c[f'p{q}']):14.5f}")
    if args.rms_threshold is not None:
        print(f"  {f'yield(RMS<={args.rms_threshold})':24s} "
              f"{float(out['yield_fraction']) * 100:13.1f}% "
              f"{float(out_c['yield_fraction']) * 100:13.1f}%")
    d = out_c["refocus_delta"][1:].cpu().numpy()
    print(f"  refocus shifts: mean |dz| {np.abs(d).mean():.4f} mm, "
          f"max |dz| {np.abs(d).max():.4f} mm")

    sens = analysis.sensitivities(specs, lens, config)
    np.set_printoptions(precision=3, suppress=False, linewidth=120)
    print("\nSensitivity d(RMS)/d(param), per surface:")
    for k in ("c", "t", "nd", "v"):
        print(f"  {k:3}", sens[k][0].cpu().numpy())

    with torch.no_grad():
        mtf = analysis.field_mtf(specs, lens, config)
    f = mtf["freqs_t"].cpu().numpy()
    # The tangential MTF at about 25 and 50 cycles/mm, green channel.
    for target in (25.0, 50.0):
        i = int(np.argmin(np.abs(f - target)))
        vals = mtf["mtf_t"][:, 1, i].cpu().numpy()
        print(f"MTF_t @ {f[i]:5.1f} cyc/mm per field: " + " ".join(f"{v:.3f}" for v in vals))

    # The wave picture: on-axis OPD -> Zernikes -> Strehl (ops.wavefront).
    n = 15
    g = np.linspace(-0.9, 0.9, n)
    X, Y = np.meshgrid(g, g, indexing="xy")
    as_xy = lambda a: torch.tensor(a.ravel()[None, None, :, None], dtype=torch.float32,
                                   device=args.device)
    xr, yr = as_xy(X), as_xy(Y)
    cfg0 = trace_mod.TraceConfig(mode="circular", n_rays=(2, 2), rel_fields=(0.0,),
                                 wavelengths=(520.0,), n_ray_aiming_iter=0, engine=engine)
    with torch.no_grad():
        out_w = wfront.opd_map(specs, lens, cfg0, xy=(xr, yr))
        opd = out_w["opd"][0, 0, :, 0]
        ok = out_w["ok"][0, 0, :, 0] & torch.as_tensor(((X ** 2 + Y ** 2) <= 1.0).ravel(),
                                                       device=opd.device)
        lam = 520e-6
        cz = wfront.zernike_fit(opd, xr[0, 0, :, 0], yr[0, 0, :, 0], ok)
        low = torch.sum(wfront.zernike_basis(4, xr[0, 0, :, 0], yr[0, 0, :, 0]) * cz[:4], dim=-1)
        s = float(wfront.strehl_ratio(torch.where(ok, opd - low, 0.0), ok, lam))
    print(f"\nOn-axis wavefront @ 520nm: Strehl {s:.3f} "
          f"(piston/tilt/defocus removed); Z11 spherical {float(cz[10]) / lam:+.3f} waves")


if __name__ == "__main__":
    main()
