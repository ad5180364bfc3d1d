"""Spot diagrams and lens layouts.

PyTorch counterpart of ``torchoptics_tpu.utils.plotting``: the reference's
``ShowTraceResult`` spot diagram, coloured by ``utils.wavelength``, and the
2-D layout of a lens with meridional ray fans. ``matplotlib`` is imported
inside each function, so the package needs it only to draw.
"""

from __future__ import annotations

import numpy as np
import torch

from torchoptics_tpu_torch.utils.wavelength import wavelength_to_rgb


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def show_trace_result(x, y, ray_ok, loss_unsup, wavelengths, show=True, ax=None):
    """Scatter the image-plane spot, one color per wavelength.

    Args:
      x, y, ray_ok: (B, F, P, W) trace outputs (system 0 is plotted).
      loss_unsup: scalar shown in the title.
      wavelengths: sequence of wavelengths [nm].

    Returns the matplotlib figure.
    """
    import matplotlib
    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    xd, yd, ok = _numpy(x), _numpy(y), _numpy(ray_ok)
    ok = np.broadcast_to(ok, np.broadcast_shapes(ok.shape, xd.shape, yd.shape))
    xd, yd = np.broadcast_arrays(xd, yd)

    if ax is None:
        fig = plt.figure()
        fig.suptitle("Unsupervised Loss Function Output:\n" + str(_numpy(loss_unsup)),
                     fontsize=12)
        ax = fig.add_subplot()
    else:
        fig = ax.figure

    for w, wave in enumerate(wavelengths):
        rgb = wavelength_to_rgb(float(wave))
        sel = ok[0, :, :, w]
        ax.plot(xd[0, :, :, w][sel], yd[0, :, :, w][sel], ".",
                color=(rgb[0] / 255, rgb[1] / 255, rgb[2] / 255), markersize=4)

    ax.axis("equal")
    if show:
        plt.show()
    return fig


def plot_lens_layout(specs, lens, n_rays: int = 7, *, fields=(0.0, 1.0), ax=None, show=True):
    """2-D cross-section of system 0 of the lens with meridional ray fans
    overlaid: surfaces drawn from their sag functions to their effective
    semi-apertures, ray paths from one traced fan per field (the unroll
    engine's ``"y"`` and ``"z"`` aggregate stacks)."""
    import matplotlib.pyplot as plt
    from torchoptics_tpu_torch.ops import metrics as metrics_mod
    from torchoptics_tpu_torch.ops import trace as trace_mod

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4))
    else:
        fig = ax.figure

    t = _numpy(lens.t)[0]
    c = _numpy(lens.c)[0]
    n_surf = int(lens.structure.n_surfaces[0])
    vertex = np.concatenate(([0.0], np.cumsum(t)))[:n_surf]

    # Each surface to its effective semi-aperture.
    with torch.no_grad():
        semi_ap = _numpy(metrics_mod.compute_semi_apertures(specs, lens))[0]
    semi_ap = np.maximum(semi_ap * 1.05, 1e-3)
    for k in range(n_surf):
        h = np.linspace(-semi_ap[k], semi_ap[k], 61)
        ck = c[k]
        kap = 0.0 if lens.kappa is None else float(_numpy(lens.kappa)[0, k])
        r2 = h ** 2
        u = (1 + kap) * ck ** 2 * r2
        valid = 1 - u > 1e-6
        sag = np.where(valid, ck * r2 / (1 + np.sqrt(np.clip(1 - u, 1e-6, None))), np.nan)
        if lens.asph is not None:
            for j, aj in enumerate(_numpy(lens.asph)[0, k]):
                sag = sag + aj * r2 ** (j + 2)
        ax.plot(vertex[k] + sag, h, "k-", lw=1)

    z_img = vertex[-1] + t[n_surf - 1]
    ax.axvline(z_img, color="gray", lw=1, ls="--")

    # A meridional fan per field from the "y"/"z" stacks ("z" is recorded
    # after the z -= t_k frame shift, so the global hit is vertex[k] + z_k +
    # t_k).
    cfg = trace_mod.TraceConfig(mode="meridional_uniform", n_rays=(int(n_rays),),
                                rel_fields=tuple(float(f) for f in fields), wavelengths=("d",),
                                n_ray_aiming_iter=1)
    with torch.no_grad():
        res = trace_mod.trace_rays(specs, lens, cfg, aggregate=("y", "z"))
    y_hits = _numpy(res.stacks["y"])[:n_surf, 0]                       # (S, F, P, 1)
    z_hits = _numpy(res.stacks["z"])[:n_surf, 0] + (vertex + t[:n_surf])[:, None, None, None]
    y_img = _numpy(res.y)[0]                                            # (F, P, 1)
    ok = _numpy(res.ray_ok)[0]
    u = float(_numpy(specs.hfov)[0])
    z_start = vertex[0] - 0.12 * max(z_img - vertex[0], 1e-6)
    colors = plt.cm.viridis(np.linspace(0.0, 0.8, len(cfg.rel_fields)))
    for f in range(len(cfg.rel_fields)):
        ty = np.tan(u * cfg.rel_fields[f])
        for r in range(y_hits.shape[2]):
            if not ok[f, r, 0]:
                continue
            zs = np.concatenate(([z_start], z_hits[:, f, r, 0], [z_img]))
            # The entry segment: the incoming field angle extrapolated back.
            y0 = y_hits[0, f, r, 0] - (z_hits[0, f, r, 0] - z_start) * ty
            ys = np.concatenate(([y0], y_hits[:, f, r, 0], [y_img[f, r, 0]]))
            ax.plot(zs, ys, "-", color=colors[f], lw=0.7, alpha=0.8)

    ax.set_xlabel("z")
    ax.set_ylabel("y")
    ax.set_title("Lens layout")
    if show:
        plt.show()
    return fig
