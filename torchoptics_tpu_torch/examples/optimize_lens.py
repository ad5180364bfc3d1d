"""Optimize a lens design by gradient descent on the optical loss.

``LensOptimizer`` Adam steps; on the GPU each step launches K1 forward and
K1 backward once (K3 for a lens with conic constants), in the Lu mode, or
the full mode with ``--full-loss``.

Examples:
  python -m torchoptics_tpu_torch.examples.optimize_lens --lens cooke --steps 500
  python -m torchoptics_tpu_torch.examples.optimize_lens --lens-yaml start.yml --steps 2000 \\
      --save-yaml optimized.yml --checkpoint opt.npz
  python -m torchoptics_tpu_torch.examples.optimize_lens --device cpu --steps 3

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse
import time

import torch

from torchoptics_tpu_torch.examples import _cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="cooke")
    ap.add_argument("--lens-yaml", default=None)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fields", type=int, default=8)
    ap.add_argument("--rings", type=int, default=8)
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="multiply curvatures by (1+p) before optimizing")
    ap.add_argument("--freeze-glass", action="store_true")
    ap.add_argument("--full-loss", action="store_true",
                    help="include ray-path/angle/glass penalties")
    ap.add_argument("--save-yaml", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=50)
    _cli.add_device_arguments(ap)
    args = ap.parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch import optimize as opt
    from torchoptics_tpu_torch import simulator as sim
    from torchoptics_tpu_torch import zoo
    from torchoptics_tpu_torch.models import io as tio

    if args.lens_yaml:
        specs, lens = tio.load_lens(args.lens_yaml, device=args.device)
    else:
        specs, lens = zoo.build(args.lens, device=args.device)
    # Target the NOMINAL focal length, not the perturbed one, so
    # perturb-and-recover runs converge back to the design scale.
    efl_target = float(lens.efl[0])
    if args.perturb:
        lens = lens.replace(c=lens.c * (1.0 + args.perturb))

    config = sim.SimulatorConfig(
        n_sampled_fields=args.fields, n_pupil_rings=args.rings,
        pupil_sampling="circular", n_ray_aiming_iter=1, trace_engine=engine)
    trainable = ("c", "t") if args.freeze_glass else ("c", "t", "g")
    optimizer = opt.LensOptimizer(
        specs=specs, config=config, learning_rate=args.lr,
        trainable=trainable, use_full_loss=args.full_loss,
        qc_variables=not args.freeze_glass,
        efl_target=efl_target)

    state = optimizer.init(lens)
    t0 = time.time()
    for i in range(args.steps):
        state, total, loss_dict = optimizer.step(state)
        if i % args.log_every == 0:
            parts = " ".join(f"{k}={float(v):.5f}" for k, v in sorted(loss_dict.items()))
            print(f"step {i:5d}: total={float(total):.5f} {parts}", flush=True)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s ({args.steps / dt:.1f} steps/s)")

    with torch.no_grad():
        final = optimizer.build_lens(state.params)
    if args.save_yaml:
        tio.save_lens(args.save_yaml, specs, final)
        print(f"wrote {args.save_yaml}")
    if args.checkpoint:
        from torchoptics_tpu_torch.utils import checkpoint as ckpt
        ckpt.save(args.checkpoint, state, metadata={"steps": args.steps, "lr": args.lr})
        print(f"wrote {args.checkpoint}")


if __name__ == "__main__":
    main()
