"""Optimize a lens through RENDERED image quality (end-to-end design).

Adam on (c, t) against -PSNR + w·(1-SSIM) of the full imaging pipeline
(trace -> PSF -> SVOLA convolution -> distortion warp). On the GPU a step
launches K1 forward and K1 backward (the PSF bundle), P2 (the SVOLA patch
convolution) and P2's d/dpsf once each. The route of P2 and of d/dpsf goes
by the patch PSFs' taps, printed at the start: the default 25-tap PSF at
96^2 is 3 x 3 patch PSFs, the direct routes.

Examples:
  python -m torchoptics_tpu_torch.examples.optimize_through_image --lens double_gauss \\
      --defocus 0.3 --steps 60
  python -m torchoptics_tpu_torch.examples.optimize_through_image --lens cooke \\
      --perturb 0.05 --steps 200 --image-size 128
  python -m torchoptics_tpu_torch.examples.optimize_through_image --device cpu --steps 1 \\
      --image-size 32 --psf 9

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse
import time

import torch

from torchoptics_tpu_torch.examples import _cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="double_gauss")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--defocus", type=float, default=0.3,
                    help="mm added to the image distance before optimizing")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="multiply curvatures by (1+p) before optimizing")
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--fields", type=int, default=5)
    ap.add_argument("--rings", type=int, default=8)
    ap.add_argument("--psf", type=int, default=25)
    ap.add_argument("--ssim-weight", type=float, default=10.0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--save-yaml", default=None)
    _cli.add_device_arguments(ap)
    args = ap.parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch import imaging
    from torchoptics_tpu_torch import optimize as opt
    from torchoptics_tpu_torch import simulator as sim
    from torchoptics_tpu_torch import zoo
    from torchoptics_tpu_torch.utils import images as img_util

    specs, lens = zoo.build(args.lens, device=args.device)
    efl = float(lens.efl[0])
    if args.defocus:
        t = lens.t.clone()
        t[0, -1] += args.defocus
        lens = lens.replace(t=t)
    if args.perturb:
        lens = lens.replace(c=lens.c * (1.0 + args.perturb))

    size = (args.image_size, args.image_size)
    radiance = torch.tensor(img_util.load_test_image(size, prefer_real=True)[None],
                            device=args.device)

    config = sim.SimulatorConfig(
        n_sampled_fields=args.fields, n_pupil_rings=args.rings,
        pupil_sampling="circular", n_ray_aiming_iter=1,
        psf_shape=(args.psf, args.psf), psf_abs_pixel_size=4e-3,
        psf_grid_shape=(3, 3), trace_engine=engine)
    print(f"{_cli.p2_route_line(size, config)}; engine={engine}, device={args.device}")

    with torch.no_grad():
        _, psnr0, ssim0 = imaging.simulate(specs, lens, radiance, config)
    print(f"start: psnr={float(psnr0[0]):.2f} dB ssim={float(ssim0[0]):.4f}")

    optimizer = opt.LensOptimizer(
        specs=specs, config=config, learning_rate=args.lr,
        trainable=("c", "t"), qc_variables=False, efl_target=efl,
        loss_fn=imaging.make_image_loss_fn(radiance, ssim_weight=args.ssim_weight))
    state = optimizer.init(lens)
    t0 = time.time()
    for i in range(args.steps):
        state, total, ld = optimizer.step(state)
        if i % args.log_every == 0:
            print(f"step {i:4d}: psnr={float(ld['psnr']):.2f} dB "
                  f"ssim={float(ld['ssim']):.4f}", flush=True)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} steps/s)")

    with torch.no_grad():
        final = optimizer.build_lens(state.params)
        _, psnr1, ssim1 = imaging.simulate(specs, final, radiance, config)
    print(f"final: psnr={float(psnr1[0]):.2f} dB ssim={float(ssim1[0]):.4f} "
          f"(recovered {float(psnr1[0]) - float(psnr0[0]):+.2f} dB)")
    if args.save_yaml:
        from torchoptics_tpu_torch.models import io as tio
        tio.save_lens(args.save_yaml, specs, final)
        print(f"wrote {args.save_yaml}")


if __name__ == "__main__":
    main()
