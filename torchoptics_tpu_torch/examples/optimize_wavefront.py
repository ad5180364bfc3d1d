"""Optimize a lens directly on its WAVEFRONT error.

At the diffraction limit the physical objective is the OPD across the
pupil. Here Adam runs on d(mean wavefront RMS)/d(c, t) through the
differentiable trace -> optical-path-length -> reference-sphere chain
(``ops.wavefront``), and the result is reported as Strehl per field. On the
GPU (``--engine fused``) a step is two K1 opl forward launches (the pupil
grid and the chief rays) and two K1 opl backward launches. The JAX
example's ``scan`` engine is an XLA compile-time loop; its eager
counterpart is ``--engine unroll``.

Example:
  python -m torchoptics_tpu_torch.examples.optimize_wavefront --lens cooke --steps 60 \\
      --defocus 0.4
  python -m torchoptics_tpu_torch.examples.optimize_wavefront --device cpu --steps 2 --grid 5

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse

import numpy as np
import torch

from torchoptics_tpu_torch.examples import _cli


#: The wavelength of the OPD sampling (520 nm) and of the Strehl ratios, mm.
LAM = 520e-6


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="cooke")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--defocus", type=float, default=0.4,
                    help="image-distance perturbation to recover from (mm)")
    ap.add_argument("--grid", type=int, default=11,
                    help="pupil grid side for the OPD sampling")
    ap.add_argument("--fields", type=float, nargs="+", default=(0.0, 0.7))
    _cli.add_device_arguments(
        ap, "trace engine: fused (K1's opl mode; the default on the GPU) or unroll (pure "
        "torch, the JAX example's 'scan'; the default on the CPU)")
    return ap.parse_args(argv)


def setup(args, engine):
    """(specs, lens, efl_target, cfg, xy): ``--lens`` with its image
    distance moved by ``--defocus`` mm (the EFL target is the nominal
    lens's), the OPD trace's config and the ``--grid``-square pupil grid
    (1, 1, n², 1) over [-0.85, 0.85]²."""
    from torchoptics_tpu_torch import trace, zoo
    specs, lens = zoo.build(args.lens, device=args.device)
    efl_target = float(lens.efl[0])
    t = lens.t.clone()
    t[0, -1] += args.defocus
    lens = lens.replace(t=t)
    g = np.linspace(-0.85, 0.85, args.grid)
    X, Y = np.meshgrid(g, g, indexing="xy")
    as_xy = lambda a: torch.tensor(a.ravel()[None, None, :, None], dtype=torch.float32,
                                   device=args.device)
    cfg = trace.TraceConfig(mode="circular", n_rays=(2, 2), rel_fields=tuple(args.fields),
                            wavelengths=(520.0,), n_ray_aiming_iter=0, engine=engine)
    return specs, lens, efl_target, cfg, (as_xy(X), as_xy(Y))


def main(argv=None):
    args = parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch import analysis
    from torchoptics_tpu_torch import optimize as opt_mod
    from torchoptics_tpu_torch import simulator as sim
    from torchoptics_tpu_torch.ops import wavefront as wf

    specs, lens, efl_target, cfg, xy = setup(args, engine)
    xg, yg = xy[0][0, 0, :, 0], xy[1][0, 0, :, 0]

    def strehls(l):
        with torch.no_grad():
            out = wf.opd_map(specs, l, cfg, xy=xy)
            vals = []
            for fi in range(len(args.fields)):
                opd = out["opd"][0, fi, :, 0]
                ok = out["ok"][0, fi, :, 0]
                # Piston and tilt removed: the same reference as the
                # objective, so the before/after Strehl compare alike
                # (defocus counts).
                cz = wf.zernike_fit(opd, xg, yg, ok, j_max=3)
                low = torch.sum(wf.zernike_basis(3, xg, yg) * cz[None, :], dim=-1)
                vals.append(float(wf.strehl_ratio(torch.where(ok, opd - low, 0.0), ok, LAM)))
        return vals

    def wf_loss(specs_, lens_, config_, g_, catalog_g_, generator_):
        w = analysis.wavefront_rms(specs_, lens_, cfg, xy=xy, remove_j=3)
        return w, {"wavefront_rms": w}

    opt = opt_mod.LensOptimizer(
        specs, sim.SimulatorConfig(trace_engine=engine), learning_rate=args.lr,
        add_bfl=False, trainable=("c", "t"), efl_target=efl_target, loss_fn=wf_loss)
    state = opt.init(lens)
    with torch.no_grad():
        v0 = float(opt.loss(state.params)[0])
    print(f"{args.lens} +{args.defocus}mm defocus: "
          f"initial wavefront RMS {v0 / LAM:.3f} waves, "
          f"Strehl {strehls(lens)}")
    for i in range(args.steps):
        state, v, _ = opt.step(state, None)
        if (i + 1) % max(1, args.steps // 6) == 0:
            print(f"  step {i + 1:4d}: wavefront RMS {float(v) / LAM:.4f} waves")
    with torch.no_grad():
        final = opt.build_lens(state.params)
        v1 = float(opt.loss(state.params)[0])
    print(f"final: wavefront RMS {v1 / LAM:.4f} waves, Strehl {strehls(final)}")


if __name__ == "__main__":
    main()
