"""The fused spherical trace of one lens system: front-end, kernel, reductions.

PyTorch counterpart of ``torchoptics_tpu.ops.pallas_trace``. The Pallas TPU
kernel ``_fwd_kernel`` there becomes kernel K1 forward, hand-written in CUDA
C++ (``csrc/fused_trace_fwd.cu``) and reached through :func:`trace_fused`:

* on a CUDA tensor the wrapper checks its inputs and launches the kernel, or
  raises; it never falls back;
* on a CPU tensor it runs :func:`trace_fused_reference`, the plain PyTorch
  version of the same function (differentiable by autograd). On the GPU it
  is the version the kernel is checked against.

The front-end keeps one ray order, wavelength-outer: the flat ray block is a
(W, F, P) block, so ray i has wavelength ``min(i // n_per_w, W - 1)`` with
``n_per_w = F * P``. Vignetting, the ray-aiming correction and EPD scaling
are affine in the pupil coordinates; the front-end evaluates that chain on
two (1, F, 1, W) probes and applies the coefficients once while building the
block. The spot reductions run on that flat layout too.

The K1 backward kernel is not ported yet: a CUDA tensor that requires grad
under grad mode raises, so the fused path serves under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torchoptics_tpu_torch.models.structure import Lens, Structure
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import pupil as pupil_mod
from torchoptics_tpu_torch.ops import trace as trace_mod

#: Launches of the K1 forward CUDA kernel in this process. The wrapper adds
#: one per launch; reset it to 0 to count the launches of one run.
K1_FWD_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Kernel K1 forward: the plain version and the CUDA wrapper.
# ---------------------------------------------------------------------------


def trace_fused_reference(xp, yp, cy, z0, c, t, mu, penalties: bool,
                          allow_backward: bool, n_per_w: int):
    """Plain PyTorch version of kernel K1 forward: the pure-torch engine
    (``trace.trace_skew``) on the flat ray block, each ray with its own
    wavelength's index ratios. It rounds every product and sum as the kernel
    does (which is built without FMA contraction), so the two agree bit for
    bit on coordinates and masks.

    Args:
      xp, yp: (N,) absolute pupil coordinates, wavelength-outer flat order.
      cy: (N,) launch direction sine (per-ray field angle).
      z0: scalar entrance-pupil axial position.
      c, t: (S,) curvatures / thicknesses.
      mu: (S, W) index-ratio table; ray i uses column min(i // n_per_w, W-1).
      penalties: also return the per-ray sums over surfaces of theta_norm,
        theta_prime_norm and relu(z) (the Lu penalty terms).
      allow_backward: False removes backward rays instead of flagging them.

    Returns (x, y, cx, cy, ray_ok, ray_backward[, pen_theta, pen_theta_p,
    pen_zrelu]), each (N,).
    """
    n, n_surf = xp.shape[0], c.shape[0]
    widx = torch.clamp(torch.arange(n, device=xp.device) // n_per_w, max=mu.shape[1] - 1)
    ray = lambda a: a.reshape(1, 1, n, 1)
    surface = lambda a: a.reshape(1, 1, 1, 1, n_surf)
    res = trace_mod.trace_skew(
        ray(xp), ray(yp), z0.reshape(1, 1, 1, 1), torch.zeros_like(z0).reshape(1, 1, 1, 1),
        ray(cy), surface(c), surface(t), mu[:, widx].T.reshape(1, 1, n, 1, n_surf),
        torch.ones(n_surf, dtype=torch.bool, device=xp.device).reshape(1, 1, 1, 1, n_surf),
        aggregate=trace_mod.AGG_TORCH if penalties else (),
        allow_backward_rays=allow_backward)
    outs = tuple(a.reshape(n) for a in res[:6])
    for name in ("theta_norm", "theta_prime_norm", "z_RELU") if penalties else ():
        # Surface by surface, in the kernel's order: a tree sum of the stack
        # rounds differently by ~1e-5 on sums of order 100.
        total = torch.zeros_like(xp)
        for term in res.stacks[name]:
            total = total + term.reshape(n)
        outs += (total,)
    return outs


def _check_k1_inputs(xp, yp, cy, z0, c, t, mu, n_per_w, max_surf, max_w):
    device = xp.device
    named = dict(xp=xp, yp=yp, cy=cy, z0=z0, c=c, t=t, mu=mu)
    for name, a in named.items():
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, xp on {device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = xp.shape[0]
    if xp.ndim != 1 or yp.shape != xp.shape or cy.shape != xp.shape:
        raise ValueError(f"xp, yp, cy must be equal (N,) vectors, got "
                         f"{tuple(xp.shape)}, {tuple(yp.shape)}, {tuple(cy.shape)}")
    if z0.numel() != 1:
        raise ValueError(f"z0 must be a scalar, got shape {tuple(z0.shape)}")
    n_surf = c.shape[0]
    if c.ndim != 1 or t.shape != c.shape or mu.ndim != 2 or mu.shape[0] != n_surf:
        raise ValueError(f"c, t must be (S,) and mu (S, W), got {tuple(c.shape)}, "
                         f"{tuple(t.shape)}, {tuple(mu.shape)}")
    if not 1 <= n_surf <= max_surf or not 1 <= mu.shape[1] <= max_w:
        raise ValueError(f"K1 takes 1..{max_surf} surfaces and 1..{max_w} "
                         f"wavelengths, got {n_surf} and {mu.shape[1]}")
    if not 1 <= n_per_w or n >= 2 ** 31:
        raise ValueError(f"bad ray block: N={n}, n_per_w={n_per_w}")


def _launch_k1_fwd(xp, yp, cy, z0, c, t, mu, penalties, allow_backward, n_per_w):
    global K1_FWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    _check_k1_inputs(xp, yp, cy, z0, c, t, mu, n_per_w,
                     lib.k1_fwd_max_surf(), lib.k1_fwd_max_w())
    n = xp.shape[0]
    new = lambda dtype: torch.empty(n, dtype=dtype, device=xp.device)
    outs = [new(torch.float32) for _ in range(4)] + [new(torch.bool) for _ in range(2)]
    pens = [new(torch.float32) for _ in range(3)] if penalties else []
    ptr = lambda a: a.data_ptr()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k1_fwd_launch(
            ptr(xp), ptr(yp), ptr(cy), ptr(z0), ptr(c), ptr(t), ptr(mu),
            n, c.shape[0], mu.shape[1], n_per_w, int(penalties), int(allow_backward),
            *map(ptr, outs), *(map(ptr, pens) if penalties else (None,) * 3), stream)
    if err != 0:
        raise RuntimeError(
            f"K1 forward kernel launch failed: {lib.k1_fwd_error_string(err).decode()}")
    K1_FWD_LAUNCHES += 1
    return tuple(outs + pens)


def trace_fused(xp, yp, cy, z0, c, t, mu, penalties: bool, allow_backward: bool,
                n_per_w: int):
    """Kernel K1 forward on a flat wavelength-outer ray block; arguments and
    results as :func:`trace_fused_reference`.

    On CUDA tensors it launches the CUDA kernel (float32, contiguous, one
    device; anything else raises). On CPU tensors it runs the plain version.
    """
    args = (xp, yp, cy, z0, c, t, mu)
    if xp.device.type == "cpu":
        return trace_fused_reference(*args, penalties, allow_backward, n_per_w)
    if xp.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {xp.device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError(
            "the K1 backward kernel is not ported yet (ROADMAP.md); call the "
            "fused engine under torch.no_grad(), or differentiate with "
            "trace_engine='unroll'")
    return _launch_k1_fwd(*args, penalties, allow_backward, n_per_w)


# ---------------------------------------------------------------------------
# Front-end and packaging (wavelength-outer layout only).
# ---------------------------------------------------------------------------


def compress_padded_tail(lens: Lens) -> Lens:
    """Strip trailing padded surface slots from a single-system Lens. The
    pure-torch engine traces through them as identity surfaces; the kernel
    skips them. x/y/ray_ok are identical; ``ray_backward`` may differ on
    already-past-focus rays (flagged at the first dummy slot instead of at the
    image transfer)."""
    st = lens.structure
    if bool(np.all(st.mask)):
        return lens
    if len(lens) != 1:
        raise ValueError("tail compression is for single-system lenses")
    n = int(st.n_surfaces[0])
    pick = lambda a: None if a is None else a[:, :n]
    return Lens(Structure(st.stop_idx, st.sequence), lens.c[:, :n], lens.t[:, :n],
                lens.nd[:, :n], lens.v[:, :n], kappa=pick(lens.kappa),
                asph=pick(lens.asph))


def _check_fused_lens(lens: Lens, config) -> Lens:
    if len(lens) != 1:
        raise NotImplementedError(
            "the fused engine traces one system; the population kernel (K2) "
            "is not ported yet (ROADMAP.md), use trace_engine='unroll'")
    if not lens.is_spherical:
        raise NotImplementedError(
            "the fused engine traces spherical surfaces; the asphere kernels "
            "(K3/K4) are not ported yet (ROADMAP.md)")
    if config.double_precision:
        raise NotImplementedError(
            "the fused engine is float32-only; use trace_engine='unroll' for "
            "double_precision traces")
    return compress_padded_tail(lens)


def prepare_fused_inputs(specs, lens: Lens, config,
                         generator: Optional[torch.Generator] = None,
                         xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         use_vig: bool = True):
    """Front-end of the fused path: dispersion, pupil position, sampling,
    vignetting, ray aiming (pure-torch engine, treated as a constant), EPD
    scaling, and the flat wavelength-outer (W, F, P) ray block.

    Returns (xp_flat, yp_flat, cy_flat, z0, mu, (1, F, P, W))."""
    device = lens.device
    n = lens.get_refractive_indices(config.wavelengths)  # (1, S, W)
    n_full = torch.cat((torch.ones_like(n[:, :1, :]), n), dim=1)
    mu = n_full[0, :-1, :] / n_full[0, 1:, :]  # (S, W)
    z0 = abcd_mod.compute_pupil_position(lens)[0]

    if xy is None:
        xp_rel, yp_rel = pupil_mod.sample_pupil(
            config.mode, config.n_rays, 1, generator=generator, device=device)
    else:
        xp_rel, yp_rel = xy
    if xp_rel.ndim != 4 or xp_rel.shape[0] != 1 or xp_rel.shape[1] != 1 \
            or xp_rel.shape[3] != 1:
        raise ValueError("the fused front-end needs plain (1, 1, P, 1) pupil "
                         f"samples, got {tuple(xp_rel.shape)}")
    px = xp_rel[0, 0, :, 0]
    py = yp_rel[0, 0, :, 0]
    F = len(config.rel_fields)
    W = len(config.wavelengths)
    P = px.shape[0]

    aiming_fn = None
    if config.n_ray_aiming_iter > 0:
        from torchoptics_tpu_torch.ops import aiming
        aiming_fn = aiming.ray_aiming(specs, lens.detach(), config, use_vig)

    def chain(vx, vy):
        if use_vig and config.vig_fn is not None and config.mode != "chief":
            fields = torch.tensor(config.rel_fields, dtype=torch.float32,
                                  device=device)[None, :]
            vig_up = config.vig_fn(fields, specs.vig_up)
            vig_down = config.vig_fn(fields, specs.vig_down)
            vig_x = config.vig_fn(fields, specs.vig_x)
            vy = pupil_mod.apply_vignetting(vy, vig_up, vig_down)
            vx = pupil_mod.apply_vignetting(vx, vig_x, vig_x)
        if aiming_fn is not None:
            vx, vy = aiming_fn(vx, vy)
        return vx, vy

    # The chain is affine in x and in y per (field, wavelength): two probes
    # give its offset and slope.
    zero = torch.zeros((1, F, 1, W), dtype=torch.float32, device=device)
    one = torch.ones((1, F, 1, W), dtype=torch.float32, device=device)
    ox, oy = chain(zero, zero)
    sx, sy = chain(one, one)
    sx = sx - ox
    sy = sy - oy
    wf = lambda a: a.expand(1, F, 1, W)[0, :, 0, :].T[:, :, None]  # (W, F, 1)
    xrel = px[None, None, :] * wf(sx) + wf(ox)                       # (W, F, P)
    yrel = py[None, None, :] * wf(sy) + wf(oy)
    if aiming_fn is not None:
        xrel = torch.clamp(xrel, -2.0, 2.0).detach()
        yrel = torch.clamp(yrel, -2.0, 2.0).detach()
    half_epd = specs.epd[0] / 2.0
    fields = torch.tensor(config.rel_fields, dtype=torch.float32, device=device)
    u = specs.hfov[:, None] * fields[None, :]
    cyb = torch.sin(u)[0][None, :, None].expand(W, F, P)
    return ((xrel * half_epd).reshape(-1), (yrel * half_epd).reshape(-1),
            cyb.reshape(-1), z0, mu, (1, F, P, W))


def package_fused_result(outs, shape, penalties: bool):
    """Package flat (W, F, P)-ordered kernel outputs as the (1, F, P, W)
    ``TraceResult`` (plus the penalty sums when ``penalties``)."""
    _, F, P, W = shape
    pack = lambda a: a.reshape(W, F, P).permute(1, 2, 0)[None]
    result = trace_mod.TraceResult(*(pack(a) for a in outs[:6]), None)
    if penalties:
        return result, tuple(pack(p) for p in outs[6:])
    return result


def _run(specs, lens, config, generator, xy, use_vig, penalties):
    lens = _check_fused_lens(lens, config)
    xp, yp, cyb, z0, mu, shape = prepare_fused_inputs(
        specs, lens, config, generator=generator, xy=xy, use_vig=use_vig)
    _, F, P, W = shape
    outs = trace_fused(xp, yp, cyb, z0, lens.c[0], lens.t[0], mu, penalties,
                       config.allow_backward_rays, F * P)
    return lens, outs, shape


def trace_rays_fused(specs, lens: Lens, config,
                     generator: Optional[torch.Generator] = None,
                     xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     penalties: bool = False, use_vig: bool = True):
    """``trace_rays`` on kernel K1 (one spherical system). Returns a
    ``TraceResult`` shaped (1, F, P, W); with ``penalties`` it returns
    ``(TraceResult, (pen_theta, pen_theta_p, pen_zrelu))``, each the per-ray
    sum over surfaces."""
    _, outs, shape = _run(specs, lens, config, generator, xy, use_vig, penalties)
    return package_fused_result(outs, shape, penalties)


# ---------------------------------------------------------------------------
# Spot reductions on the flat wavelength-outer layout.
# ---------------------------------------------------------------------------


def rms2d_flat_wouter(y_flat, ok_flat, F, P, W):
    """``metrics.compute_rms2d`` (B=1) on flat (W, F, P)-ordered outputs: the
    per-(field, wavelength) centroid is the plain mean over ALL rays, the
    squared deviations sum over valid rays only, the denominator counts all
    rays."""
    y3 = y_flat.reshape(W, F, P)
    ok3 = ok_flat.reshape(W, F, P)
    ycent = torch.mean(y3, dim=2)                    # (W, F)
    ymean = torch.mean(ycent, dim=0)                 # (F,)
    dev2 = torch.where(ok3, (y3 - ymean[None, :, None]) ** 2, 0.0)
    ss = torch.sum(dev2, dim=(0, 2))                 # (F,)
    pos = ss > 0
    rms_f = torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / (P * W)), 0.0)
    return torch.mean(rms_f)


def spot_rms_xy_flat_wouter(x_flat, y_flat, ok_flat, F, P, W):
    """``metrics.compute_spot_rms_xy`` (B=1), field-mean, on flat (W, F, P)
    outputs: masked centroid, masked count denominator, gradient-safe sqrt."""
    x3 = x_flat.reshape(W, F, P)
    y3 = y_flat.reshape(W, F, P)
    ok3 = ok_flat.reshape(W, F, P)
    w = ok3.to(x3.dtype)
    count = torch.clamp(torch.sum(w, dim=(0, 2)), min=1.0)   # (F,)
    xc = torch.sum(x3 * w, dim=(0, 2)) / count
    yc = torch.sum(y3 * w, dim=(0, 2)) / count
    d2 = (x3 - xc[None, :, None]) ** 2 + (y3 - yc[None, :, None]) ** 2
    ss = torch.sum(torch.where(ok3, d2, 0.0), dim=(0, 2))    # (F,)
    pos = ss > 0
    rms_f = torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / count), 0.0)
    return torch.mean(rms_f)


def spot_rms_flat_wouter(outs, F, P, W, spot_metric: str = "y"):
    """The per-system spot reduction on flat kernel outputs: ``'y'`` =
    ``rms2d_flat_wouter``; ``'xy'`` = ``spot_rms_xy_flat_wouter``."""
    if spot_metric == "y":
        return rms2d_flat_wouter(outs[1], outs[4], F, P, W)
    if spot_metric == "xy":
        return spot_rms_xy_flat_wouter(outs[0], outs[1], outs[4], F, P, W)
    raise ValueError(f"spot metric must be 'y' or 'xy', got {spot_metric!r}")


def spot_rms_fused(specs, lens: Lens, config,
                   generator: Optional[torch.Generator] = None,
                   xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   use_vig: bool = True, spot_metric: str = "y"):
    """Mean RMS spot size of one spherical system on the fused path:
    wavelength-outer front-end -> K1 (plain mode) -> flat reduction."""
    _, outs, (_, F, P, W) = _run(specs, lens, config, generator, xy, use_vig, False)
    return spot_rms_flat_wouter(outs, F, P, W, spot_metric)


def unsupervised_loss_fused(specs, lens: Lens, config,
                            generator: Optional[torch.Generator] = None):
    """The unsupervised lens-design objective Lu = rms + rate·ΣQ on K1's Lu
    mode; ``config`` is a ``simulator.SimulatorConfig``. Returns
    (Lu, loss_dict)."""
    lens, outs, (_, F, P, W) = _run(specs, lens, config.trace_config(), generator,
                                    None, True, True)
    pth, ptp, pz = outs[6:9]
    rms = spot_rms_flat_wouter(outs, F, P, W, config.spot_metric)
    n_sequence = int(lens.structure.n_surfaces[0])
    sum_q = (torch.sum(pth) + torch.sum(ptp) + torch.sum(pz)) / n_sequence
    lu = rms + config.penalty_rate * sum_q
    return lu, {"loss_unsup": lu, "rms": rms, "penalty": sum_q}
