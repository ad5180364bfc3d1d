"""Classical aberration report for a lens design.

Prints the Seidel per-surface contribution table (S_I-S_V, C_1/C_2), the
third-order focal-shift predictions next to the real-ray measurements
(astigmatic field curves, LSA), the transverse ray-fan extrema per field
and the through-focus MTF: the standard first look a lens designer takes at
a design. The Seidel sums, fans and field curves run on the pure-torch
engine (small paraxial and fan traces); the through-focus MTF traces its
13 focus shifts as one population, one K2 forward launch on the GPU
(``--engine fused``).

Examples:
  python -m torchoptics_tpu_torch.examples.aberration_report --lens cooke
  python -m torchoptics_tpu_torch.examples.aberration_report --lens double_gauss_asph_xy \\
      --plot out.png
  python -m torchoptics_tpu_torch.examples.aberration_report --device cpu

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse

import numpy as np
import torch

from torchoptics_tpu_torch.examples import _cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="cooke")
    ap.add_argument("--fields", default="0,0.707,1.0")
    ap.add_argument("--plot", default=None,
                    help="save a fan/field-curve/layout figure to this path")
    _cli.add_device_arguments(ap)
    args = ap.parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch import analysis, zoo
    from torchoptics_tpu_torch import simulator as sim_mod
    from torchoptics_tpu_torch.ops import trace as trace_mod

    numpy = lambda v: v.detach().cpu().numpy()
    specs, lens = zoo.build(args.lens, device=args.device)
    fields = tuple(float(f) for f in args.fields.split(","))
    wavelengths = ("C", "d", "F")
    cfg = trace_mod.TraceConfig(mode="meridional_uniform", n_rays=(9,), rel_fields=fields,
                                wavelengths=wavelengths, n_ray_aiming_iter=1, engine=engine)

    # The report prints d-line columns; derive the index from the wavelengths
    # so that editing them can't silently mislabel the table.
    d_idx = wavelengths.index("d")

    with torch.no_grad():
        sd = analysis.seidel_coefficients(specs, lens)
    ps = {k: numpy(v)[0] for k, v in sd["per_surface"].items()}
    names = ("S1", "S2", "S3", "S4", "S5", "C1", "C2")
    print(f"== Seidel per-surface contributions ({args.lens}) ==")
    print("surf  " + "".join(f"{n:>11}" for n in names))
    for k in range(ps["S1"].shape[0]):
        print(f"{k:4d}  " + "".join(f"{ps[n][k]:11.5f}" for n in names))
    print(" sum  " + "".join(f"{ps[n].sum():11.5f}" for n in names))

    fs = {k: float(numpy(v)[0]) for k, v in analysis.seidel_focal_shifts(sd).items()}
    fc = analysis.field_curvature(specs, lens, cfg, n=9, pupil_fraction=0.1)
    la = analysis.longitudinal_aberration(specs, lens, cfg, n=9)
    dz_t = numpy(fc["dz_t"])[0, :, d_idx]
    dz_s = numpy(fc["dz_s"])[0, :, d_idx]
    print("\n== Field curves (d-line, mm; real rays vs third-order) ==")
    print("field   dz_t      dz_s      astig")
    for i, f in enumerate(fields):
        print(f"{f:5.3f}  {dz_t[i]:8.4f}  {dz_s[i]:8.4f}  {dz_t[i] - dz_s[i]:8.4f}")
    print(f"Seidel full-field prediction: dz_t {fs['dz_t'] + dz_t[0]:.4f}  "
          f"dz_s {fs['dz_s'] + dz_s[0]:.4f} (relative to on-axis focus)")
    print(f"LSA marginal (real rays): {numpy(la['dz'])[0, -1, d_idx]:.4f}  "
          f"third-order: {fs['lsa_marginal']:.4f}  "
          f"axial color F-C: {fs['chromatic_shift']:.4f}")

    with torch.no_grad():
        fans = analysis.ray_fans(specs, lens, cfg, n=17)
    eps_y = numpy(fans["eps_y"])[0]   # (F, n, W)
    eps_x = numpy(fans["eps_x"])[0]
    print("\n== Ray-fan extrema (d-line, mm) ==")
    for i, f in enumerate(fields):
        print(f"field {f:5.3f}: max|eps_y| {np.abs(eps_y[i, :, d_idx]).max():.5f}"
              f"  max|eps_x| {np.abs(eps_x[i, :, d_idx]).max():.5f}")

    # Through-focus MTF scan: modulation vs image-plane shift at ~mid
    # frequency, per field: the classical focus-budget plot.
    deltas = np.linspace(-0.15, 0.15, 13)
    tf_cfg = sim_mod.SimulatorConfig(
        n_sampled_fields=len(fields), n_pupil_rings=12,
        pupil_sampling="circular", n_ray_aiming_iter=1,
        wavelengths=(520.0,), psf_shape=(65, 65), psf_abs_pixel_size=2e-3,
        trace_engine=engine)
    with torch.no_grad():
        tf = analysis.through_focus_mtf(specs, lens, tf_cfg, deltas)
    freqs_t = numpy(tf["freqs_t"])
    k30 = int(np.argmin(np.abs(freqs_t - 30.0)))
    mtf_tf = numpy(tf["mtf_t"])[:, :, 0, k30]       # (D, F)
    print(f"\n== Through-focus MTF (tangential, {freqs_t[k30]:.0f} cyc/mm, "
          f"520 nm; fields = linspace ladder) ==")
    print("  dz[mm]  " + "".join(f"f={f:5.3f} " for f in np.linspace(0, 1, mtf_tf.shape[1])))
    for di, dz in enumerate(deltas):
        print(f"  {dz:+.3f}  " + "".join(f"{mtf_tf[di, fi]:7.3f} "
                                         for fi in range(mtf_tf.shape[1])))

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from torchoptics_tpu_torch.utils.plotting import plot_lens_layout
        fig, axs = plt.subplots(1, 4, figsize=(20, 4))
        p = numpy(fans["p"])
        for i, f in enumerate(fields):
            axs[0].plot(p, eps_y[i, :, d_idx], label=f"field {f:g}")
        axs[0].set_title("tangential fan (d)")
        axs[0].set_xlabel("py")
        axs[0].set_ylabel("eps_y [mm]")
        axs[0].legend()
        axs[1].plot(dz_t, fields, "o-", label="tangential")
        axs[1].plot(dz_s, fields, "s-", label="sagittal")
        axs[1].set_title("field curves")
        axs[1].set_xlabel("dz [mm]")
        axs[1].set_ylabel("rel field")
        axs[1].legend()
        plot_lens_layout(specs, lens, n_rays=5, ax=axs[2], show=False)
        for fi in range(mtf_tf.shape[1]):
            axs[3].plot(deltas, mtf_tf[:, fi],
                        label=f"field {fi / max(mtf_tf.shape[1] - 1, 1):.2f}")
        axs[3].set_title(f"through-focus MTF @ {freqs_t[k30]:.0f} cyc/mm")
        axs[3].set_xlabel("dz [mm]")
        axs[3].set_ylabel("MTF")
        axs[3].legend()
        fig.tight_layout()
        fig.savefig(args.plot, dpi=110)
        print(f"\nsaved {args.plot}")


if __name__ == "__main__":
    main()
