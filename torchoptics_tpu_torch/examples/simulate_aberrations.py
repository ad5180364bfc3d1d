"""Simulate optical aberrations of a lens on a test image.

A render traces the PSF bundle (on the GPU one K1 forward launch with
``--engine fused``; ``--psf-source diffraction`` runs K1's opl mode for the
pupil's OPD) and convolves the image with the patch PSFs on P2. P2's route
goes by the patch PSFs' taps (the PSF resized to the image's pixel pitch),
printed before the render: direct below ``image.P2_FFT_MIN_KW`` taps, FFT
from there.

Examples:
  python -m torchoptics_tpu_torch.examples.simulate_aberrations --lens cooke --output out.png
  python -m torchoptics_tpu_torch.examples.simulate_aberrations --lens-yaml my_lens.yml \\
      --image photo.png --psf-size 33 --show-spots
  python -m torchoptics_tpu_torch.examples.simulate_aberrations --device cpu --image-size 32

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse
import os

import numpy as np
import torch

from torchoptics_tpu_torch.examples import _cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="cooke",
                    help="built-in lens name (singlet/doublet/cooke/tessar/double_gauss)")
    ap.add_argument("--lens-yaml", default=None,
                    help="YAML prescription path (overrides --lens)")
    ap.add_argument("--image", default=None,
                    help="input image path, or 'real' for the bundled photograph, or 'chart' "
                         "for the synthetic chart (default: real photo when available, else "
                         "chart)")
    ap.add_argument("--image-size", type=int, default=128,
                    help="side length for the bundled images")
    ap.add_argument("--output", default="aberrated.png")
    ap.add_argument("--fields", type=int, default=9)
    ap.add_argument("--rings", type=int, default=16)
    ap.add_argument("--psf-size", type=int, default=33)
    ap.add_argument("--psf-pixel", type=float, default=4e-3)
    ap.add_argument("--psf-grid", type=int, default=5)
    ap.add_argument("--psf-source", default="geometric", choices=("geometric", "diffraction"),
                    help="PSF physics: the reference's geometric ray splat, or the Fraunhofer "
                         "pupil-function transform (captures the Airy floor of "
                         "diffraction-limited designs; prints a sampling-adequacy report)")
    ap.add_argument("--diffraction-grid", type=int, default=64,
                    help="pupil grid side for --psf-source diffraction")
    ap.add_argument("--oversample", type=int, default=4,
                    help="sub-pixel box-integration factor (diffraction)")
    ap.add_argument("--no-distortion", action="store_true")
    ap.add_argument("--no-illumination", action="store_true")
    ap.add_argument("--show-spots", action="store_true",
                    help="also save a spot diagram next to the output")
    _cli.add_device_arguments(ap)
    args = ap.parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch import imaging, zoo
    from torchoptics_tpu_torch import simulator as sim
    from torchoptics_tpu_torch.models import io as tio
    from torchoptics_tpu_torch.ops import metrics
    from torchoptics_tpu_torch.ops import trace as trace_mod
    from torchoptics_tpu_torch.utils import images as img_util

    device = args.device
    if args.lens_yaml:
        specs, lens = tio.load_lens(args.lens_yaml, device=device)
    else:
        specs, lens = zoo.build(args.lens, device=device)

    hw = (args.image_size, args.image_size)
    if args.image in (None, "real"):
        radiance = img_util.load_test_image(hw, prefer_real=True)[None]
    elif args.image == "chart":
        radiance = img_util.synthetic_test_image(*hw)[None]
    else:
        import matplotlib.image as mpimg
        radiance = mpimg.imread(args.image).astype(np.float32)
        if radiance.max() <= 1.0:
            radiance = radiance * 255.0
        if radiance.ndim == 2:  # grayscale -> replicate to RGB
            radiance = np.repeat(radiance[..., None], 3, axis=-1)
        radiance = radiance[..., :3][None]

    config = sim.SimulatorConfig(
        n_sampled_fields=args.fields, n_pupil_rings=args.rings,
        pupil_sampling="circular", n_ray_aiming_iter=1,
        psf_shape=(args.psf_size, args.psf_size),
        psf_abs_pixel_size=args.psf_pixel,
        psf_grid_shape=(args.psf_grid, args.psf_grid),
        apply_distortion=not args.no_distortion,
        apply_relative_illumination=not args.no_illumination,
        psf_source=args.psf_source,
        diffraction_grid_n=args.diffraction_grid,
        diffraction_oversample=args.oversample,
        trace_engine=engine)

    if args.psf_source == "diffraction":
        rep = imaging.diffraction_sampling_report(specs, lens, config)
        print(f"diffraction sampling: P-V {rep['pv_waves']:.1f} waves, "
              f"alias period {rep['alias_mm'] * 1e3:.0f} um vs window+blur "
              f"{(rep['window_mm'] + rep['blur_mm']) * 1e3:.0f} um, working "
              f"f/{rep['fno_working']:.2f}")
        for w in rep["warnings"]:
            print(f"  WARNING: {w}")

    print(f"{_cli.p2_route_line(radiance.shape[1:3], config)}; engine={engine}, "
          f"device={device}")
    with torch.no_grad():
        irr, psnr, ssim = imaging.simulate(specs, lens, torch.tensor(radiance, device=device),
                                           config)
    print(f"rendered {irr.shape[1]}x{irr.shape[2]} image: "
          f"PSNR={float(psnr[0]):.2f} dB, SSIM={float(ssim[0]):.4f}")

    img_util.encode_png(args.output, irr[0].cpu().numpy() / 255.0)
    print(f"wrote {args.output}")

    if args.show_spots:
        from torchoptics_tpu_torch.utils.plotting import show_trace_result
        with torch.no_grad():
            res = trace_mod.trace_rays(specs, lens, config.trace_config())
            rms = metrics.compute_rms2d(res.x, res.y, res.ray_ok)
        fig = show_trace_result(res.x, res.y, res.ray_ok, float(rms[0]),
                                config.wavelengths, show=False)
        spot_path = os.path.splitext(args.output)[0] + "_spots.png"
        fig.savefig(spot_path, dpi=120)
        print(f"wrote {spot_path} (rms spot = {float(rms[0]):.5f})")


if __name__ == "__main__":
    main()
