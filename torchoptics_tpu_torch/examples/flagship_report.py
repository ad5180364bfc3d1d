"""Image-quality report card for a lens design.

Prints, per relative field: the reference-parity Y-deviation spot RMS, the
radial 2-D spot RMS (sees the sagittal blur the y-metric is blind to), and
the monochromatic Strehl ratio at 520 nm from the exact-OPD wavefront
(``ops.wavefront``); unless ``--no-vignetting``, the solved vignetting
factors and the relative illumination. On the GPU (``--engine fused``) the
report is one K1 forward launch (24 x 24 rings, 3 wavelengths) and two K1
opl forward launches (the 24 x 24 pupil grid and the chief rays).

Examples:
  python -m torchoptics_tpu_torch.examples.flagship_report --lens double_gauss
  python -m torchoptics_tpu_torch.examples.flagship_report --lens double_gauss --design out.json
  python -m torchoptics_tpu_torch.examples.flagship_report --device cpu --lens cooke

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

import argparse
import dataclasses
import json

import numpy as np
import torch

from torchoptics_tpu_torch.examples import _cli

#: The explicit pupil grid of the wavefront pass: side and extent.
GRID_N, GRID_EXTENT = 24, 0.95


def rms_y_per_field(y, ray_ok):
    """``metrics.compute_rms2d`` without the final field mean, (B, F): the
    all-ray centroid, valid-ray deviations, the all-ray denominator."""
    B, F, P, W = ray_ok.shape
    y = torch.broadcast_to(y, (B, F, P, W))
    ymean = torch.mean(torch.mean(y, dim=2), dim=-1)
    dev2 = torch.where(ray_ok, (y - ymean[:, :, None, None]) ** 2, 0.0)
    ss = torch.sum(dev2, dim=(2, 3))
    pos = ss > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / (P * W)), 0.0)


def pupil_grid(n=GRID_N, device="cuda"):
    """(xy, in_pupil): the (1, 1, n², 1) relative pupil grid of the
    wavefront pass and its points inside the unit circle (n²,)."""
    gg = np.linspace(-GRID_EXTENT, GRID_EXTENT, n)
    GX, GY = np.meshgrid(gg, gg, indexing="xy")
    as_xy = lambda a: torch.tensor(a.ravel()[None, None, :, None], dtype=torch.float32,
                                   device=device)
    in_pupil = torch.as_tensor(((GX ** 2 + GY ** 2) <= 1.0).ravel(), device=device)
    return (as_xy(GX), as_xy(GY)), in_pupil


def strehl_per_field(opd_out, xy, in_pupil, lam=520e-6):
    """(Strehl, wavefront RMS in waves) per field, (F,) each, from an
    ``opd_map`` on the grid ``xy``: piston and tilt (Noll Z1-Z3, a pure
    image-point displacement) fitted and removed; defocus and everything
    above stay in (the planar-sensor Strehl)."""
    from torchoptics_tpu_torch.ops import wavefront as wf
    xg, yg = xy[0][0, 0, :, 0], xy[1][0, 0, :, 0]
    strehls, wrms = [], []
    for fi in range(opd_out["opd"].shape[1]):
        opd = opd_out["opd"][0, fi, :, 0]
        okw = opd_out["ok"][0, fi, :, 0] & in_pupil
        cz = wf.zernike_fit(opd, xg, yg, okw, j_max=3)
        low = wf.zernike_basis(3, xg, yg) @ cz
        resid = torch.where(okw, opd - low, 0.0)
        strehls.append(wf.strehl_ratio(resid, okw, lam))
        w = okw.to(opd.dtype)
        wrms.append(torch.sqrt(torch.sum(w * resid * resid)
                               / torch.clamp(torch.sum(w), min=1.0)) / lam)
    return torch.stack(strehls), torch.stack(wrms)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lens", default="double_gauss",
                    help="zoo prescription supplying structure/specs")
    ap.add_argument("--design", default=None,
                    help="JSON with c/t/nd/v (+kappa/asph) overriding the zoo parameters "
                         "(refine_flagship --save output)")
    ap.add_argument("--fields", default="0,0.45,0.707,0.88,1.0")
    ap.add_argument("--no-vignetting", action="store_true",
                    help="skip the aperture model (solved vignetting factors + relative "
                    "illumination columns)")
    _cli.add_device_arguments(ap)
    return ap.parse_args(argv)


def load_design(args, device):
    """(specs, lens, fields) of the report: the zoo prescription ``--lens``
    with ``--design``'s parameters over it, and the relative fields."""
    from torchoptics_tpu_torch import zoo
    p = zoo.get_prescription(args.lens)
    if args.design:
        with open(args.design) as f:
            d = json.load(f)
        for k in ("c", "t", "nd", "v", "kappa", "asph"):
            if k in d:
                p[k] = d[k]
            elif k in p and k in ("kappa", "asph"):
                del p[k]
    specs, lens = zoo.build(p, device=device)
    return specs, lens, tuple(float(f) for f in args.fields.split(","))


def wavefront_config(fields, engine):
    """The wavefront pass's trace: 520 nm, one ray-aiming iteration."""
    from torchoptics_tpu_torch.ops import trace as trace_mod
    return trace_mod.TraceConfig(mode="circular", n_rays=(24, 24), rel_fields=fields,
                                 wavelengths=(520.0,), n_ray_aiming_iter=1, engine=engine)


def main(argv=None):
    args = parse_args(argv)
    engine = _cli.resolve_engine(args)

    from torchoptics_tpu_torch.ops import metrics
    from torchoptics_tpu_torch.ops import trace as trace_mod
    from torchoptics_tpu_torch.ops import wavefront as wf

    device = args.device
    specs, lens, fields = load_design(args, device)
    cfg = trace_mod.TraceConfig(
        mode="circular", n_rays=(24, 24), rel_fields=fields,
        wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1, engine=engine)
    wf_cfg = wavefront_config(fields, engine)
    xy, in_pupil = pupil_grid(device=device)

    with torch.no_grad():
        res = trace_mod.trace_rays(specs, lens, cfg)
        ok = float(torch.mean(res.ray_ok.float()))
        rms_y = rms_y_per_field(res.y, res.ray_ok).cpu().numpy()
        rms_xy = metrics.compute_spot_rms_xy(res.x, res.y, res.ray_ok).cpu().numpy()
        strehl, wrms = (a[None].cpu().numpy() for a in strehl_per_field(
            wf.opd_map(specs, lens, wf_cfg, xy=xy), xy, in_pupil))

    # The aperture model: solve the per-field vignetting factors against the
    # axial-beam apertures, feed them back through a vignetted trace, and
    # report the relative illumination.
    vig = ri = None
    ok_vig = float("nan")
    if not args.no_vignetting:
        from torchoptics_tpu_torch.ops import vignetting as vig_mod
        with torch.no_grad():
            vig = vig_mod.solve_vignetting(specs, lens, fields, n_ray_aiming_iter=0)
            vf = vig_mod.solved_tables_vig_fn(fields)
            specs_v = dataclasses.replace(specs, vig_up=vig["vig_up"],
                                          vig_down=vig["vig_down"], vig_x=vig["vig_x"])
            ri = metrics.compute_relative_illumination(specs_v, lens, fields, vig_fn=vf,
                                                       n_ray_aiming_iter=1).cpu().numpy()
            res_v = trace_mod.trace_rays(specs_v, lens, dataclasses.replace(cfg, vig_fn=vf))
            ok_vig = float(torch.mean(res_v.ray_ok.float()))

    efl = float(lens.efl[0])
    trans = (f"transmission={ok:.4f} (full pupil), {ok_vig:.4f} (solved vignetting)"
             if vig is not None else f"transmission={ok:.4f}")
    print(f"lens={args.lens} design={args.design or 'zoo'} efl={efl:.4f} {trans}")
    hdr = (f"{'field':>6} {'rms_y mm':>10} {'rms_xy mm':>10} "
           f"{'wfe rms λ':>10} {'strehl(d)':>10}")
    if vig is not None:
        hdr += f" {'vig_up':>8} {'vig_dn':>8} {'vig_x':>8} {'rel_illum':>9}"
    print(hdr)
    for i, f in enumerate(fields):
        row = (f"{f:6.3f} {rms_y[0, i]:10.5f} {rms_xy[0, i]:10.5f} "
               f"{wrms[0, i]:10.3f} {strehl[0, i]:10.4f}")
        if vig is not None:
            row += (f" {float(vig['vig_up'][0, i]):8.4f}"
                    f" {float(vig['vig_down'][0, i]):8.4f}"
                    f" {float(vig['vig_x'][0, i]):8.4f}"
                    f" {float(ri[0, i, 0]):9.4f}")
        print(row)
    print(f"  mean {np.mean(rms_y[0]):10.5f} {np.mean(rms_xy[0]):10.5f} "
          f"{np.mean(wrms[0]):10.3f} {np.mean(strehl[0]):10.4f}")
    print("  (wfe/strehl at d-line, piston+tilt removed; strehl is only meaningful when "
          "wfe ≲ 0.2λ; vig/rel_illum columns from the solved axial-beam aperture model)")


if __name__ == "__main__":
    main()
