"""The fused spherical trace of one lens system: front-end, kernels, losses.

PyTorch counterpart of ``torchoptics_tpu.ops.pallas_trace``. The Pallas TPU
kernels there become kernel K1, hand-written in CUDA C++:

* K1 forward (``_fwd_kernel``) in ``csrc/fused_trace_fwd.cu``, in plain, Lu,
  full and opl (optical path length) modes;
* K1 backward (``_bwd_kernel``), the hand adjoint with a forward recompute,
  in ``csrc/fused_trace_bwd.cu``, in the same four modes.

Both are reached through one ``torch.autograd.Function`` behind
:func:`trace_fused`, :func:`trace_fused_full` and :func:`trace_fused_opl`. It saves only its inputs
for the backward pass. On CUDA tensors it checks them and launches the
kernels, or raises; it never falls back. On CPU tensors it runs the plain
versions of both passes, :func:`trace_fused_reference` and
:func:`trace_fused_backward_reference`; on the GPU these are what the
kernels are checked against.

The front-end keeps one ray order, wavelength-outer: the flat ray block is a
(W, F, P) block, so ray i has wavelength ``min(i // n_per_w, W - 1)`` with
``n_per_w = F * P``. It is the population front-end of ``ops.fused_batch``
on one system (vignetting, ray aiming and EPD scaling applied as an affine
map found with two probes). The spot reductions run on that flat layout.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from torchoptics_tpu_torch.models.structure import Lens, Structure
from torchoptics_tpu_torch.ops import trace as trace_mod

#: Launches of the K1 forward and backward CUDA kernels in this process. The
#: wrappers add one per launch; reset them to 0 to count the launches of one
#: run.
K1_FWD_LAUNCHES = 0
K1_BWD_LAUNCHES = 0
#: The same launches by the kernels' template mode (0 plain, 1 Lu, 2 full,
#: 3 opl), counted where the totals are; reset each to [0] * 4.
K1_FWD_MODE_LAUNCHES = [0, 0, 0, 0]
K1_BWD_MODE_LAUNCHES = [0, 0, 0, 0]

_EPS_CLIP = 1e-7
_HALF_PI = math.pi / 2.0


def _mode(penalties) -> int:
    """0 = plain, 1 = Lu, 2 = full, 3 = opl (the kernels' template modes)."""
    if penalties is False or penalties is None:
        return 0
    if penalties is True:
        return 1
    if penalties == "full":
        return 2
    if penalties == "opl":
        return 3
    raise ValueError(f"penalties must be False, True, 'full' or 'opl', got {penalties!r}")


def _lu(mode: int) -> bool:
    """Whether a kernel mode accumulates the Lu penalty sums."""
    return mode in (1, 2)


# ---------------------------------------------------------------------------
# Kernel K1: the plain versions of both passes.
# ---------------------------------------------------------------------------


def _hinge(delta, lo: float, hi: float):
    """Path-bound hinge max(lo - d, 0) + max(d - hi, 0); ±inf disables a side."""
    pen = torch.zeros_like(delta)
    if lo != -math.inf:
        pen = pen + torch.clamp(lo - delta, min=0.0)
    if hi != math.inf:
        pen = pen + torch.clamp(delta - hi, min=0.0)
    return pen


def _hinge_grad(delta, lo: float, hi: float):
    """d(_hinge)/d(delta): -1 below lo, +1 above hi, 0 inside."""
    g = torch.zeros_like(delta)
    if lo != -math.inf:
        g = g - (delta < lo).to(delta.dtype)
    if hi != math.inf:
        g = g + (delta > hi).to(delta.dtype)
    return g


def trace_fused_reference(xp, yp, cy, z0, c, t, mu, penalties, allow_backward: bool,
                          n_per_w: int, ref_z=None, path_bounds=(), angle_thr=0.25,
                          n_legs=None):
    """Plain PyTorch version of kernel K1 forward: the pure-torch engine
    (``trace.trace_skew``) on the flat ray block, each ray with its own
    wavelength's index ratios. It rounds every product and sum as the kernel
    does (which is built without FMA contraction), so the two agree bit for
    bit on coordinates and masks. Autograd differentiates it.

    Args:
      xp, yp: (N,) absolute pupil coordinates, wavelength-outer flat order.
      cy: (N,) launch direction sine (per-ray field angle).
      z0: scalar entrance-pupil axial position.
      c, t: (S,) curvatures / thicknesses.
      mu: (S, W) index-ratio table; ray i uses column min(i // n_per_w, W-1).
      penalties: False; True for the per-ray sums over surfaces of
        theta_norm, theta_prime_norm and relu(z) (the Lu penalty terms);
        "full" for those plus the ray-path hinge against ``ref_z`` (S+1,)
        absolute vertex positions with the static per-gap ``path_bounds``
        (lo, hi) pairs, and the angle hinge of both cos² against
        ``angle_thr`` = cos²(threshold); "opl" for the optical path length
        OPL = Σ_k n_legs[k]·dist_k per ray, over the surface legs and the
        final leg to the image plane, with ``n_legs`` (S+1, W) the index of
        the medium each leg travels in (air first), each leg added before a
        backward ray is removed.
      allow_backward: False removes backward rays instead of flagging them.

    Returns (x, y, cx, cy, ray_ok, ray_backward[, pen_theta, pen_theta_p,
    pen_zrelu[, pen_path, pen_angle]]), or in opl mode the six and ``opl``,
    each (N,).
    """
    mode = _mode(penalties)
    n, n_surf = xp.shape[0], c.shape[0]
    widx = torch.clamp(torch.arange(n, device=xp.device) // n_per_w, max=mu.shape[1] - 1)
    ray = lambda a: a.reshape(1, 1, n, 1)
    surface = lambda a: a.reshape(1, 1, 1, 1, n_surf)
    aggregate = ((trace_mod.AGG_TORCH if _lu(mode) else ())
                 + (("z", "cos2", "cos2_prime") if mode == 2 else ())
                 + (("dist",) if mode == 3 else ()))
    res = trace_mod.trace_skew(
        ray(xp), ray(yp), z0.reshape(1, 1, 1, 1), torch.zeros_like(z0).reshape(1, 1, 1, 1),
        ray(cy), surface(c), surface(t), mu[:, widx].T.reshape(1, 1, n, 1, n_surf),
        torch.ones(n_surf, dtype=torch.bool, device=xp.device).reshape(1, 1, 1, 1, n_surf),
        aggregate=aggregate, allow_backward_rays=allow_backward)
    outs = tuple(a.reshape(n) for a in res[:6])
    stack = lambda name: [a.reshape(n) for a in res.stacks[name]]
    for name in ("theta_norm", "theta_prime_norm", "z_RELU") if _lu(mode) else ():
        # Surface by surface, in the kernel's order: a tree sum of the stack
        # rounds differently by ~1e-5 on sums of order 100.
        total = torch.zeros_like(xp)
        for term in stack(name):
            total = total + term
        outs += (total,)
    if mode == 2:
        z, cos2, cos2p = stack("z"), stack("cos2"), stack("cos2_prime")
        pen_path = torch.zeros_like(xp)
        pen_ang = torch.zeros_like(xp)
        for k in range(n_surf):
            pen_ang = (pen_ang + torch.clamp(angle_thr - cos2[k], min=0.0)
                       + torch.clamp(angle_thr - cos2p[k], min=0.0))
            if k > 0:
                delta = (z[k] + ref_z[k]) - (z[k - 1] + ref_z[k - 1])
                pen_path = pen_path + _hinge(delta, *path_bounds[k - 1])
        # The image-plane entry: its own frame's z is 0, and ref_z[S] repeats
        # the last vertex.
        delta = ref_z[n_surf] - (z[n_surf - 1] + ref_z[n_surf - 1])
        pen_path = pen_path + _hinge(delta, *path_bounds[n_surf - 1])
        outs += (pen_path, pen_ang)
    if mode == 3:
        # Leg by leg, in the kernel's order.
        n_ray = n_legs[:, widx]                                      # (S+1, N)
        opl = torch.zeros_like(xp)
        for k, leg in enumerate(stack("dist")):
            opl = opl + leg * n_ray[k]
        outs += (opl,)
    return outs


def _fwd_surface(c, t, mu, x, y, z, cx, cy, cz, ok):
    """One spherical surface step with the locals its adjoint needs; the same
    operations, in the same order, as both kernels."""
    e = -(x * cx + y * cy + z * cz)
    mz = z + e * cz
    m2 = x * x + y * y + z * z - e * e
    temp = c * m2 - 2.0 * mz
    cos2 = cz * cz - c * temp
    fail1 = cos2 - 1e-6 < 0
    cos = torch.sqrt(torch.where(fail1, 1.0, cos2))
    denom = cz + cos
    dist = e + temp / denom
    delta_z = dist * cz
    ok1 = ok & ~fail1
    xB = torch.where(ok1, x + dist * cx, 0.0)
    yB = torch.where(ok1, y + dist * cy, 0.0)
    zB = torch.where(ok1, z + delta_z, 0.0)
    cxB = torch.where(ok1, cx, 0.0)
    cyB = torch.where(ok1, cy, 0.0)
    cos2p = 1.0 - mu * mu * (1.0 - cos * cos)
    fail2a = cos2p - 1e-6 < 0
    cosp = torch.sqrt(torch.where(fail2a, 1.0, cos2p))
    g = cosp - mu * cos
    cxC = mu * cxB - g * c * xB
    cyC = mu * cyB - g * c * yB
    cz2 = 1.0 - (cxC * cxC + cyC * cyC)
    fail2 = fail2a | (cz2 - 1e-6 < 0)
    czC = torch.sqrt(torch.where(fail2, 1.0, cz2))
    ok2 = ok1 & ~fail2
    post = (torch.where(ok2, xB, 0.0), torch.where(ok2, yB, 0.0),
            torch.where(ok2, zB, 0.0) - t, torch.where(ok2, cxC, 0.0),
            torch.where(ok2, cyC, 0.0), torch.where(ok2, czC, 1.0), ok2)
    loc = dict(delta_z=delta_z, ok1=ok1, fail1=fail1, fail2a=fail2a, fail2=fail2,
               cos=cos, cosp=cosp, g=g, denom=denom, dist=dist, temp=temp, m2=m2,
               e=e, xB=xB, yB=yB, cxB=cxB, cyB=cyB, cxC=cxC, cyC=cyC, czC=czC,
               cos2=cos2, cos2p=cos2p)
    return post, loc


def _bwd_surface(c, mu, pre, loc, d, dcos2_extra=None, dcos2p_extra=None,
                 ddist_extra=None):
    """Adjoint of ``_fwd_surface`` (``pallas_trace._bwd_surface``): ``pre`` is
    the pre-surface state, ``d`` the post-surface cotangents (dx, dy, dz, dcx,
    dcy, dcz); ``dcos2*_extra`` inject the penalty cotangents on the raw cos²
    locals, ``ddist_extra`` the OPL cotangent on the marching distance.
    Returns (d_pre_state, dc_ray, dt_ray, dmu_ray), per ray."""
    x, y, z, cx, cy, cz, _ = pre
    dxD, dyD, dzD, dcxD, dcyD, dczD = d
    ok1 = loc["ok1"]
    ok2 = ok1 & ~loc["fail2"]
    cos, cosp, g = loc["cos"], loc["cosp"], loc["g"]
    denom, dist, temp, m2, e = loc["denom"], loc["dist"], loc["temp"], loc["m2"], loc["e"]
    xB, yB, cxB, cyB = loc["xB"], loc["yB"], loc["cxB"], loc["cyB"]
    cxC, cyC, czC = loc["cxC"], loc["cyC"], loc["czC"]
    where = lambda m, a: torch.where(m, a, 0.0)

    dt_ray = -dzD  # z_next = zD - t
    dczC = where(ok2, dczD)
    dcz2 = torch.where(loc["fail2"], 0.0, dczC / (2.0 * czC))
    dcxC = where(ok2, dcxD) - 2.0 * cxC * dcz2
    dcyC = where(ok2, dcyD) - 2.0 * cyC * dcz2
    dxB = where(ok2, dxD) - dcxC * g * c
    dyB = where(ok2, dyD) - dcyC * g * c
    dzB = where(ok2, dzD)
    dcxB = mu * dcxC
    dcyB = mu * dcyC
    dg = -(dcxC * c * xB + dcyC * c * yB)
    dc_ray = -(dcxC * g * xB + dcyC * g * yB)
    dmu_ray = dcxC * cxB + dcyC * cyB
    dcosp = dg
    dmu_ray = dmu_ray - dg * cos
    dcos = -dg * mu
    dcos2p = torch.where(loc["fail2a"], 0.0, dcosp / (2.0 * cosp))
    if dcos2p_extra is not None:
        dcos2p = dcos2p + dcos2p_extra
    dmu_ray = dmu_ray + dcos2p * (-2.0 * mu * (1.0 - cos * cos))
    dcos = dcos + dcos2p * (2.0 * mu * mu * cos)

    # reset1 adjoint (czB is dead: Snell rebuilds cz from renormalization).
    dxA, dyA, dzA = where(ok1, dxB), where(ok1, dyB), where(ok1, dzB)
    dcx, dcy = where(ok1, dcxB), where(ok1, dcyB)
    # update_ray_coordinates adjoint
    ddist = dxA * cx + dyA * cy + dzA * cz
    if ddist_extra is not None:
        ddist = ddist + ddist_extra
    dx, dy, dz = dxA, dyA, dzA
    dcx = dcx + dxA * dist
    dcy = dcy + dyA * dist
    dcz = dzA * dist
    # dist = e + temp / denom
    de = ddist
    dtemp = ddist / denom
    ddenom = -ddist * temp / (denom * denom)
    dcz = dcz + ddenom
    dcos = dcos + ddenom
    dcos2 = torch.where(loc["fail1"], 0.0, dcos / (2.0 * cos))
    if dcos2_extra is not None:
        dcos2 = dcos2 + dcos2_extra
    # cos2 = cz^2 - c * temp
    dcz = dcz + 2.0 * cz * dcos2
    dc_ray = dc_ray - dcos2 * temp
    dtemp = dtemp - c * dcos2
    # temp = c * m2 - 2 * mz
    dc_ray = dc_ray + dtemp * m2
    dm2 = c * dtemp
    dmz = -2.0 * dtemp
    # m2 = x^2 + y^2 + z^2 - e^2
    dx = dx + 2.0 * x * dm2
    dy = dy + 2.0 * y * dm2
    dz = dz + 2.0 * z * dm2
    de = de - 2.0 * e * dm2
    # mz = z + e * cz
    dz = dz + dmz
    de = de + dmz * cz
    dcz = dcz + dmz * e
    # e = -(x cx + y cy + z cz)
    dx = dx - de * cx
    dy = dy - de * cy
    dz = dz - de * cz
    dcx = dcx - de * x
    dcy = dcy - de * y
    dcz = dcz - de * z
    return (dx, dy, dz, dcx, dcy, dcz), dc_ray, dt_ray, dmu_ray


def _theta_norm_adjoint(cos2, ok_end, dpen):
    """d(theta_norm)/d(cos2) * dpen, zero on pinned and clipped lanes."""
    pos = cos2 > 0
    u = torch.sqrt(torch.where(pos, cos2, 1.0))
    active = ok_end & pos & (u < 1.0 - _EPS_CLIP)
    # d theta/du = -1/sqrt(1 - u^2); du/dcos2 = 1/(2u)
    denom = torch.sqrt(torch.where(active, 1.0 - u * u, 1.0))
    d = -dpen / (_HALF_PI * denom * 2.0 * u)
    return torch.where(active, d, 0.0)


def trace_fused_backward_reference(inputs, cotangents, penalties, allow_backward: bool,
                                   n_per_w: int, path_bounds=(), angle_thr=0.25):
    """Plain PyTorch version of kernel K1 backward, a vectorised
    transcription of ``pallas_trace._bwd_kernel``: the population version
    ``fused_batch.trace_fused_batch_backward_reference`` on a population of
    one system without padding, whose arithmetic is K1's. It recomputes the
    forward surface by surface, then applies the hand adjoint in reverse, one
    torch operation per rounding as the kernel does, so the per-ray
    cotangents agree with the kernel's bit for bit. The parameter cotangents
    are summed over rays in float64 and returned in float32.

    Args:
      inputs: (xp, yp, cy, z0, c, t, mu[, ref_z (full) or n_legs (opl)]) as
        for the forward.
      cotangents: (dx, dy, dcx, dcy[, dpth, dptp, dpz[, dppath, dpang]]), or
        in opl mode (dx, dy, dcx, dcy, dopl), each (N,): the cotangents of
        the forward's float outputs.
      penalties, allow_backward, n_per_w, path_bounds, angle_thr: as for the
        forward.

    Returns (dxp, dyp, dcy, dz0, dc, dt, dmu[, dref_z or dn_legs]).
    """
    from torchoptics_tpu_torch.ops import fused_batch
    z0 = inputs[3]
    one = [a.reshape(1) if i == 3 else a[None] for i, a in enumerate(inputs)]
    grads = fused_batch.trace_fused_batch_backward_reference(
        one, [a[None] for a in cotangents], penalties, allow_backward, n_per_w,
        path_bounds=path_bounds, angle_thr=angle_thr)
    return tuple(g.reshape(z0.shape) if i == 3 else g[0] for i, g in enumerate(grads))


# ---------------------------------------------------------------------------
# Kernel K1: the CUDA wrappers and the autograd Function.
# ---------------------------------------------------------------------------


def _check_tensors(named, device, dtypes=None):
    """Every tensor of ``named`` on ``device``, contiguous, and float32 (or
    the dtype ``dtypes`` names for it); raises otherwise."""
    for name, a in named.items():
        if a is None:
            continue
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, xp on {device}")
        dtype = (dtypes or {}).get(name, torch.float32)
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {str(dtype).split('.')[-1]}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_k1_inputs(xp, yp, cy, z0, c, t, mu, n_per_w, max_surf, max_w, ref_z=None,
                     n_legs=None):
    _check_tensors(dict(xp=xp, yp=yp, cy=cy, z0=z0, c=c, t=t, mu=mu, ref_z=ref_z,
                        n_legs=n_legs), xp.device)
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
    if ref_z is not None and tuple(ref_z.shape) != (n_surf + 1,):
        raise ValueError(f"ref_z must be (S+1,) = ({n_surf + 1},), got {tuple(ref_z.shape)}")
    if n_legs is not None and tuple(n_legs.shape) != (n_surf + 1, mu.shape[1]):
        raise ValueError(f"n_legs must be (S+1, W) = ({n_surf + 1}, {mu.shape[1]}), got "
                         f"{tuple(n_legs.shape)}")
    if not 1 <= n_per_w or n >= 2 ** 31:
        raise ValueError(f"bad ray block: N={n}, n_per_w={n_per_w}")


@functools.lru_cache(maxsize=64)
def _bound_tensors(path_bounds, device):
    """The per-gap (lo, hi) hinge bounds as two (S,) device tensors, ±inf
    where a side is off."""
    lo = torch.tensor([b[0] for b in path_bounds], dtype=torch.float32, device=device)
    hi = torch.tensor([b[1] for b in path_bounds], dtype=torch.float32, device=device)
    return lo, hi


def _full_args(mode, ref_z, path_bounds, n_surf, device):
    if mode != 2:
        return None, None, None
    if len(path_bounds) != n_surf:
        raise ValueError(f"path_bounds needs one (lo, hi) per surface gap: "
                         f"{n_surf}, got {len(path_bounds)}")
    return (ref_z, *_bound_tensors(tuple(path_bounds), device))


def _split_extra(inputs, n_base, mode):
    """(ref_z, n_legs) from the tensor that follows the ``n_base`` base
    inputs: ref_z in full mode, n_legs in opl mode, else neither."""
    extra = inputs[n_base] if len(inputs) > n_base else None
    return (extra if mode == 2 else None), (extra if mode == 3 else None)


#: Float outputs beyond the six trace outputs, per mode.
N_EXTRA_OUTS = (0, 3, 5, 1)


def n_extra_params(mode, n_surf, n_w):
    """Parameter cotangents beyond the base ones, per system: dref_z (S+1) in
    full mode, dn_legs ((S+1) x W) in opl mode."""
    return {2: n_surf + 1, 3: (n_surf + 1) * n_w}.get(mode, 0)


def _ptr(a):
    return None if a is None else a.data_ptr()


def _out_ptrs(outs, mode):
    """The five penalty-output pointers and the opl-output pointer of a
    forward launch (null where the mode has none)."""
    extra = [_ptr(a) for a in outs[6:]]
    if mode == 3:
        return [None] * 5, extra[0]
    return extra + [None] * (5 - len(extra)), None


def _cot_ptrs(cot, mode):
    """The ten cotangent pointers of a backward launch: dx, dy, dcx, dcy,
    dpth, dptp, dpz, dppath, dpang, dopl (null where the mode has none)."""
    if mode == 3:
        cot = list(cot[:4]) + [None] * 5 + list(cot[4:])
    return [_ptr(a) for a in cot] + [None] * (10 - len(cot))


def _prepare_cotangents(cotangents, xp):
    """Autograd may hand over expanded or strided cotangents: float32 and
    contiguous, each shaped like ``xp``."""
    cot = [a.to(torch.float32).contiguous() for a in cotangents]
    for a in cot:
        if a.device != xp.device or a.shape != xp.shape:
            raise ValueError(f"cotangents must be {tuple(xp.shape)} on {xp.device}, got "
                             f"{tuple(a.shape)} on {a.device}")
    return cot


def _raise_on_error(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.k1_error_string(err).decode()}")


def _launch_k1_fwd(inputs, penalties, allow_backward, n_per_w, path_bounds, angle_thr):
    global K1_FWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    xp, yp, cy, z0, c, t, mu = inputs[:7]
    ref_z, n_legs = _split_extra(inputs, 7, mode)
    _check_k1_inputs(xp, yp, cy, z0, c, t, mu, n_per_w, lib.k1_max_surf(),
                     lib.k1_max_w(), ref_z, n_legs)
    ref_z, lo, hi = _full_args(mode, ref_z, path_bounds, c.shape[0], xp.device)
    n = xp.shape[0]
    new = lambda dtype: torch.empty(n, dtype=dtype, device=xp.device)
    outs = [new(torch.float32) for _ in range(4)] + [new(torch.bool) for _ in range(2)]
    outs += [new(torch.float32) for _ in range(N_EXTRA_OUTS[mode])]
    pens, opl = _out_ptrs(outs, mode)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k1_fwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs)), float(angle_thr),
            n, c.shape[0], mu.shape[1], n_per_w, mode, int(allow_backward),
            *map(_ptr, outs[:6]), *pens, opl, stream)
    _raise_on_error(lib, err, "K1 forward kernel")
    K1_FWD_LAUNCHES += 1
    K1_FWD_MODE_LAUNCHES[mode] += 1
    return tuple(outs)


def _launch_k1_bwd(inputs, cotangents, penalties, allow_backward, n_per_w, path_bounds,
                   angle_thr):
    global K1_BWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    xp, yp, cy, z0, c, t, mu = inputs[:7]
    ref_z, n_legs = _split_extra(inputs, 7, mode)
    _check_k1_inputs(xp, yp, cy, z0, c, t, mu, n_per_w, lib.k1_max_surf(),
                     lib.k1_max_w(), ref_z, n_legs)
    ref_z, lo, hi = _full_args(mode, ref_z, path_bounds, c.shape[0], xp.device)
    n, n_surf, n_w = xp.shape[0], c.shape[0], mu.shape[1]
    cot = _prepare_cotangents(cotangents, xp)
    n_params = 1 + 2 * n_surf + n_surf * n_w + n_extra_params(mode, n_surf, n_w)
    n_blocks = -(-n // lib.k1_bwd_block())
    new = lambda size: torch.empty(size, dtype=torch.float32, device=xp.device)
    dxp, dyp, dcy = new(n), new(n), new(n)
    params = new(n_params)
    partials = torch.empty(n_params * n_blocks, dtype=torch.float64, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k1_bwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs)), float(angle_thr),
            *_cot_ptrs(cot, mode), n, n_surf, n_w, n_per_w, mode, int(allow_backward),
            *map(_ptr, (dxp, dyp, dcy, partials, params)), stream)
    _raise_on_error(lib, err, "K1 backward kernel")
    K1_BWD_LAUNCHES += 1
    K1_BWD_MODE_LAUNCHES[mode] += 1
    off = np.cumsum([1, n_surf, n_surf, n_surf * n_w])
    grads = (dxp, dyp, dcy, params[0].reshape(z0.shape), params[off[0]:off[1]],
             params[off[1]:off[2]], params[off[2]:off[3]].reshape(n_surf, n_w))
    if mode == 2:
        grads += (params[off[3]:],)
    if mode == 3:
        grads += (params[off[3]:].reshape(n_surf + 1, n_w),)
    return grads


class _K1(torch.autograd.Function):
    """Kernel K1 with its hand adjoint. The forward saves only the inputs;
    the backward recomputes the trace (``pallas_trace._fused_fwd`` /
    ``_fused_bwd``). ``extra`` is ref_z in full mode, n_legs in opl mode."""

    @staticmethod
    def forward(ctx, penalties, allow_backward, n_per_w, path_bounds, angle_thr,
                xp, yp, cy, z0, c, t, mu, extra):
        mode = _mode(penalties)
        inputs = (xp, yp, cy, z0, c, t, mu) + ((extra,) if mode in (2, 3) else ())
        config = (penalties, allow_backward, n_per_w, path_bounds, angle_thr)
        if xp.device.type == "cpu":
            ref_z, n_legs = _split_extra(inputs, 7, mode)
            outs = trace_fused_reference(*inputs[:7], penalties, allow_backward, n_per_w,
                                         ref_z, path_bounds, angle_thr, n_legs)
        else:
            outs = _launch_k1_fwd(inputs, *config)
        ctx.mark_non_differentiable(outs[4], outs[5])
        ctx.save_for_backward(*inputs)
        ctx.config = config
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        xp = inputs[0]
        cot = [torch.zeros_like(xp) if g is None else g
               for i, g in enumerate(grads) if i not in (4, 5)]
        if xp.device.type == "cpu":
            penalties, allow_backward, n_per_w, path_bounds, angle_thr = ctx.config
            out = trace_fused_backward_reference(inputs, cot, penalties, allow_backward,
                                                 n_per_w, path_bounds, angle_thr)
        else:
            out = _launch_k1_bwd(inputs, cot, *ctx.config)
        return (None,) * 5 + tuple(out) + (None,) * (8 - len(out))


def _apply_k1(inputs, penalties, allow_backward, n_per_w, path_bounds=(), angle_thr=0.25):
    if inputs[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {inputs[0].device}")
    extra = inputs[7] if len(inputs) > 7 else None
    return _K1.apply(penalties, bool(allow_backward), int(n_per_w), tuple(path_bounds),
                     float(angle_thr), *inputs[:7], extra)


def trace_fused(xp, yp, cy, z0, c, t, mu, penalties: bool, allow_backward: bool,
                n_per_w: int):
    """Kernel K1 on a flat wavelength-outer ray block, plain (``penalties``
    False) or Lu (True) mode; arguments and results as
    :func:`trace_fused_reference`. Differentiable in all seven inputs.

    On CUDA tensors it launches the CUDA kernels (float32, contiguous, one
    device; anything else raises). On CPU tensors it runs the plain versions.
    """
    if _mode(penalties) >= 2:
        raise ValueError("the full and opl modes need their tables: use trace_fused_full "
                         "or trace_fused_opl")
    return _apply_k1((xp, yp, cy, z0, c, t, mu), penalties, allow_backward, n_per_w)


def trace_fused_full(xp, yp, cy, z0, c, t, mu, ref_z, allow_backward: bool,
                     path_bounds, angle_thr: float, n_per_w: int):
    """``trace_fused`` with the full weighted-loss penalty set accumulated in
    the kernel: the Lu terms plus the ray-path hinge against ``ref_z`` (S+1,)
    absolute vertex positions (differentiable; the caller passes cumsum(t)
    with the last entry repeated) with static per-gap ``path_bounds`` (lo, hi)
    pairs, and the ray-angle hinge against ``angle_thr`` = cos²(threshold).
    Returns the 6 trace outputs plus (pen_theta, pen_theta_p, pen_zrelu,
    pen_path, pen_angle), each (N,)."""
    return _apply_k1((xp, yp, cy, z0, c, t, mu, ref_z), "full", allow_backward, n_per_w,
                     path_bounds, angle_thr)


def trace_fused_opl(xp, yp, cy, z0, c, t, mu, n_legs, allow_backward: bool, n_per_w: int):
    """``trace_fused`` with the optical path length accumulated in the kernel
    (``pallas_trace.trace_fused_opl``): per ray, OPL = Σ_k n_legs[k]·dist_k
    over the surface legs and the final leg to the image plane, without a
    per-surface stack. ``n_legs`` (S+1, W) is the differentiable index of the
    medium of each leg, air first. Returns the 6 trace outputs plus ``opl``
    (N,); the launch phase y_p·sin(u) is not included (the caller adds it)."""
    return _apply_k1((xp, yp, cy, z0, c, t, mu, n_legs), "opl", allow_backward, n_per_w)


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
        raise ValueError("kernels K1 and K3 trace one system; a population goes through "
                         "ops.fused_batch (kernel K2, or K4 for aspheres)")
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
    scaling, and the flat wavelength-outer (W, F, P) ray block; the
    population front-end ``fused_batch.prepare_fused_inputs_batch`` on one
    system, whose arithmetic it is.

    Returns (xp_flat, yp_flat, cy_flat, z0, mu, (1, F, P, W))."""
    from torchoptics_tpu_torch.ops import fused_batch
    xp, yp, cyb, z0, mu, shape = fused_batch.prepare_fused_inputs_batch(
        specs, lens, config, generator=generator, xy=xy, use_vig=use_vig)
    return xp[0], yp[0], cyb[0], z0[0], mu[0], shape


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
    """One single-system trace on the fused engine: K1 for a spherical lens,
    K3 (``ops.fused_asphere``) for a conic/asphere one. Returns the
    (compressed) lens, the flat kernel outputs and (1, F, P, W)."""
    if not lens.is_spherical:
        from torchoptics_tpu_torch.ops import fused_asphere
        return fused_asphere._run(specs, lens, config, generator, xy, use_vig, penalties)
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
    """``trace_rays`` on kernel K1 (one spherical system; a conic/asphere
    system goes through kernel K3, absent ``kappa`` or ``asph`` terms as
    zeros). Returns a ``TraceResult`` shaped (1, F, P, W); with ``penalties``
    it returns
    ``(TraceResult, (pen_theta, pen_theta_p, pen_zrelu))``, each the per-ray
    sum over surfaces."""
    _, outs, shape = _run(specs, lens, config, generator, xy, use_vig, penalties)
    return package_fused_result(outs, shape, penalties)


def leg_indices(lens: Lens, wavelengths) -> torch.Tensor:
    """n_legs (B, S+1, W): the index of the medium each leg of the trace
    travels in, air before the first surface, then each gap's index (a padded
    gap has n = 1)."""
    n = lens.get_refractive_indices(wavelengths)                     # (B, S, W)
    return torch.cat((torch.ones_like(n[:, :1, :]), n), dim=1)


def package_opl(opl_flat, ypb, cyb, shape):
    """OPL (B, F, P, W) from the kernel's flat (B, N) sums, with the launch
    phase of the incoming plane wave added: y_p·sin(u) at the launch point
    (``pallas_trace.optical_paths_fused``)."""
    B, F, P, W = shape
    opl = opl_flat + ypb * cyb
    return opl.reshape(B, W, F, P).permute(0, 2, 3, 1)


def optical_paths_fused(specs, lens: Lens, config,
                        generator: Optional[torch.Generator] = None,
                        xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``wavefront.optical_path_lengths`` on kernel K1's opl mode (one
    spherical system, float32; ``pallas_trace.optical_paths_fused``): returns
    (TraceResult, OPL) with OPL (1, F, P, W) in mm, launch phase included.
    The per-surface distances never leave the kernel; the OPL is
    differentiable through c, t and the dispersion model."""
    if not lens.is_spherical:
        raise ValueError("K1's opl mode is spherical; a conic/asphere system goes through "
                         "fused_asphere.optical_paths_fused_asphere")
    lens = _check_fused_lens(lens, config)
    xp, yp, cyb, z0, mu, shape = prepare_fused_inputs(
        specs, lens, config, generator=generator, xy=xy)
    _, F, P, _ = shape
    outs = trace_fused_opl(xp, yp, cyb, z0, lens.c[0], lens.t[0], mu,
                           leg_indices(lens, config.wavelengths)[0],
                           config.allow_backward_rays, F * P)
    return (package_fused_result(outs[:6], shape, False),
            package_opl(outs[6][None], yp[None], cyb[None], shape))


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
    """Mean RMS spot size of one system on the fused path: wavelength-outer
    front-end -> K1 or K3 (plain mode) -> flat reduction."""
    _, outs, (_, F, P, W) = _run(specs, lens, config, generator, xy, use_vig, False)
    return spot_rms_flat_wouter(outs, F, P, W, spot_metric)


def unsupervised_loss_fused(specs, lens: Lens, config,
                            generator: Optional[torch.Generator] = None):
    """The unsupervised lens-design objective Lu = rms + rate·ΣQ on K1's (or,
    for a conic/asphere system, K3's) Lu mode; ``config`` is a
    ``simulator.SimulatorConfig``. Returns (Lu, loss_dict)."""
    lens, outs, (_, F, P, W) = _run(specs, lens, config.trace_config(), generator,
                                    None, True, True)
    pth, ptp, pz = outs[6:9]
    rms = spot_rms_flat_wouter(outs, F, P, W, config.spot_metric)
    n_sequence = int(lens.structure.n_surfaces[0])
    sum_q = (torch.sum(pth) + torch.sum(ptp) + torch.sum(pz)) / n_sequence
    lu = rms + config.penalty_rate * sum_q
    return lu, {"loss_unsup": lu, "rms": rms, "penalty": sum_q}


def _path_bounds(structure: Structure, lower, upper):
    """Static per-gap (lo, hi) hinge bounds of one compressed system: the
    (air, glass, image) thickness bounds mapped onto its gaps, ±inf where a
    bound is None."""
    lo_air, lo_glass, lo_image = (-math.inf if v is None else float(v) for v in lower)
    hi_air, hi_glass, hi_image = (math.inf if v is None else float(v) for v in upper)
    mask_G = structure.mask_G[0]
    n_surf = int(structure.n_surfaces[0])
    bounds = [(lo_glass, hi_glass) if mask_G[k] else (lo_air, hi_air) for k in range(n_surf)]
    bounds[n_surf - 1] = (lo_image, hi_image)
    return tuple(bounds)


def compute_losses_fused(specs, lens: Lens, config, g=None, catalog_g=None,
                         generator: Optional[torch.Generator] = None):
    """The full weighted loss (spot + ray-path + ray-angle + glass + Lu) of
    one spherical system on one launch of K1's full mode; the fused form of
    ``simulator.compute_losses``. A conic/asphere system goes to
    ``fused_asphere.compute_losses_fused_asphere`` (kernel K3). ``config`` is
    a ``simulator.SimulatorConfig``. Returns (total, loss_dict)."""
    if not lens.is_spherical:
        from torchoptics_tpu_torch.ops import fused_asphere
        return fused_asphere.compute_losses_fused_asphere(
            specs, lens, config, g=g, catalog_g=catalog_g, generator=generator)
    cfg = config.trace_config()
    lens = _check_fused_lens(lens, cfg)
    bounds = _path_bounds(lens.structure, config.ray_path_lower_thresholds,
                          config.ray_path_upper_thresholds)
    angle_thr = math.cos(math.radians(config.ray_angle_threshold)) ** 2
    xp, yp, cyb, z0, mu, (_, F, P, W) = prepare_fused_inputs(specs, lens, cfg,
                                                             generator=generator)
    vertex_z = torch.cumsum(lens.t[0], dim=0)
    ref_z = torch.cat((vertex_z, vertex_z[-1:]))
    outs = trace_fused_full(xp, yp, cyb, z0, lens.c[0], lens.t[0], mu, ref_z,
                            cfg.allow_backward_rays, bounds, angle_thr, F * P)
    return full_loss_terms(outs, lens, config, (F, P, W), g, catalog_g)


def full_loss_terms(outs, lens: Lens, config, shape, g=None, catalog_g=None):
    """(total, loss_dict) of the full weighted loss from a single system's
    full-mode kernel outputs on the flat (W, F, P) layout; ``shape`` is
    (F, P, W)."""
    from torchoptics_tpu_torch import simulator as sim_mod

    F, P, W = shape
    pth, ptp, pz, ppath, pang = outs[6:]
    n_rays = F * P * W
    rms = spot_rms_flat_wouter(outs, F, P, W, config.spot_metric)
    n_sequence = int(lens.structure.n_surfaces[0])
    sum_q = (torch.sum(pth) + torch.sum(ptp) + torch.sum(pz)) / n_sequence
    lu = rms + config.penalty_rate * sum_q
    loss_dict = {
        "loss_unsup": lu, "rms": rms, "penalty": sum_q, "spot_size": rms,
        # The sum over gaps of the per-ray mean is the total over n_rays.
        "ray_path": torch.sum(ppath) / n_rays,
        "ray_angle": torch.sum(pang) / n_rays,
    }
    if g is not None:
        loss_dict["glass"] = sim_mod.compute_glass_penalty(lens.structure, g, catalog_g)
    total = sum(loss_dict[k] * w for k, w in config.loss_weights.items()
                if k in loss_dict and w is not None)
    return total, loss_dict
