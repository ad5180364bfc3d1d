"""The fused conic/asphere trace of one lens system and of a population:
kernels, front-end, losses.

PyTorch counterpart of ``torchoptics_tpu.ops.pallas_asphere``. Its Pallas
TPU kernels become kernels K3 (one system) and K4 (a population),
hand-written in CUDA C++:

* K3 forward (``_fwd_kernel_a``) in ``csrc/fused_asphere_fwd.cu``, in plain,
  Lu, full and opl modes;
* K3 backward (``_bwd_kernel_a``), the hand adjoint through the Newton
  polish step, in ``csrc/fused_asphere_bwd.cu``, in the same four modes;
* K4 forward and backward (``_fwd_kernel_ab``, ``_bwd_kernel_ab``) in
  ``csrc/fused_asphere_batch_fwd.cu`` and ``csrc/fused_asphere_batch_bwd.cu``:
  K3 over a grid of (ray blocks x systems), with per-system z0 (B,), c,
  kappa, t (B, S), mu (B, S, W), asph (B, S, K), ref_z (B, S+1) or n_legs
  (B, S+1, W) and, for a padded population of mixed lens types, a (B, S)
  surface mask with ``fused_batch``'s semantics.

Their device code lives in ``csrc/asphere_common.cuh``. Each pair is reached
through one ``torch.autograd.Function`` (behind :func:`trace_fused_asphere`,
:func:`trace_fused_asphere_full`, :func:`trace_fused_asphere_opl` and their
``_batch`` forms), which saves only its inputs. On
CUDA tensors it checks them and launches the kernels, or raises; it never
falls back. On CPU tensors it runs the plain versions,
:func:`trace_fused_asphere_batch_reference` and
:func:`trace_fused_asphere_batch_backward_reference` (K3's,
:func:`trace_fused_asphere_reference` and
:func:`trace_fused_asphere_backward_reference`, are these on a population
of one); on the GPU these are what the kernels are checked against.

Per surface: the closed-form sphere guess (the vertex plane where it
misses), ``n_iter`` Newton steps treated as constants, one differentiable
polish step, the incidence angle at the hit point, and Snell's law with the
true normal. The sag and its slope are written as the Pallas kernel writes
them (g = c/(2w) + Σ aₖ (k+2) (r²)^(k+1) with w = sqrt(1 - (1+κ)c²r²)), not
as the pure-torch engine (``ops.surfaces``) does: the two agree in exact
arithmetic and round differently. Integer powers of r² are chains of
products, p_{j+1} = p_j · r², and 1/sqrt stands for rsqrt, the same in the
kernels and here, so that masks, plain-mode coordinates and per-ray
cotangents agree bit for bit. The parameter cotangents are summed over each
system's rays in float64 and rounded once.

The front-ends are K1's and K2's (``fused_trace.prepare_fused_inputs``,
``fused_batch.prepare_fused_inputs_batch``), wavelength-outer: ray i of a
system has wavelength ``min(i // n_per_w, W - 1)`` with ``n_per_w = F * P``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from torchoptics_tpu_torch.models.structure import Lens
from torchoptics_tpu_torch.ops import fused_batch, fused_trace
from torchoptics_tpu_torch.ops.fused_batch import _theta_norm, _widx
from torchoptics_tpu_torch.ops.fused_trace import (
    N_EXTRA_OUTS, _cot_ptrs, _hinge, _hinge_grad, _lu, _mode, _out_ptrs, _prepare_cotangents,
    _ptr, _split_extra, _theta_norm_adjoint, n_extra_params)

#: Launches of the K3 and K4 forward and backward CUDA kernels in this
#: process. The wrappers add one per launch; reset them to 0 to count the
#: launches of one run.
K3_FWD_LAUNCHES = 0
K3_BWD_LAUNCHES = 0
K4_FWD_LAUNCHES = 0
K4_BWD_LAUNCHES = 0
#: The same launches by the kernels' template mode (0 plain, 1 Lu, 2 full,
#: 3 opl), counted where the totals are; reset each to [0] * 4.
K3_FWD_MODE_LAUNCHES = [0, 0, 0, 0]
K3_BWD_MODE_LAUNCHES = [0, 0, 0, 0]
K4_FWD_MODE_LAUNCHES = [0, 0, 0, 0]
K4_BWD_MODE_LAUNCHES = [0, 0, 0, 0]

EPS = 1e-6
NEWTON_ITERS = 10
NEWTON_TOL = 1e-5


# ---------------------------------------------------------------------------
# Kernels K3 and K4: the plain versions of both passes. One copy of the
# surface math, over a leading system axis: K3's plain versions are K4's on
# a population of one. ``a`` is one surface's list of asphere coefficients,
# each a (B, 1) column (a scalar tensor where a caller passes one).
# ---------------------------------------------------------------------------


def _powers(r2, n: int):
    """[r2^0 (None: the factor 1 is left out), r2^1, ..., r2^n] as a chain
    of products, as the kernels compute them."""
    p = [None, r2]
    for _ in range(n - 1):
        p.append(p[-1] * r2)
    return p


def _sag_terms(c, kappa, a, r2):
    """sag, g = d sag/d r², the domain guard, w and u at r² (pallas_asphere
    ``_sag_terms``)."""
    beta = (1.0 + kappa) * c * c
    u = beta * r2
    guard = 1.0 - u < EPS
    w = torch.sqrt(torch.where(guard, 1.0, 1.0 - u))
    sag = c * r2 / (1.0 + w)
    g = c / (2.0 * w)
    p = _powers(r2, len(a) + 1)
    for k, ak in enumerate(a):
        sag = sag + ak * p[k + 2]
        g = g + ak * (k + 2.0) * p[k + 1]
    return sag, g, guard, w, u


def _g_partials(c, kappa, a, r2, w, u):
    """(h = dg/dr², dg/dc, dg/dκ, dsag/dc, dsag/dκ) at r² (pallas_asphere
    ``_g_partials``); the aₖ partials are powers of r². The terms that
    divide by powers of w and of 1 + w share one reciprocal of each, as the
    kernels compute them (within 4 float32 roundings of the closed forms,
    ``tests/test_torch_newton_exit.py``)."""
    beta = (1.0 + kappa) * c * c
    c3 = c * c * c
    iw = 1.0 / w
    iw3 = iw * iw * iw
    q4 = 0.25 * iw3                      # 1/(4 w³)
    h = c * beta * q4
    g_c = 0.5 * iw + u * (0.5 * iw3)
    g_kap = c3 * r2 * q4
    iopw = 1.0 / (1.0 + w)
    iw_opw2 = iw * iopw * iopw           # 1/(w (1+w)²)
    sag_c = r2 * iopw + u * r2 * iw_opw2
    sag_kap = c3 * r2 * r2 * (0.5 * iw_opw2)
    p = _powers(r2, len(a))
    for k, ak in enumerate(a):
        term = ak * (k + 2.0) * (k + 1.0)
        h = h + (term if k == 0 else term * p[k])
    return h, g_c, g_kap, sag_c, sag_kap


def _f_fp(c, kappa, a, x, y, z, cx, cy, cz, s):
    """F(s) = z(s) - sag(r²(s)), F'(s) and the domain guard at s."""
    xs = x + s * cx
    ys = y + s * cy
    r2 = xs * xs + ys * ys
    sag, g, guard, _, _ = _sag_terms(c, kappa, a, r2)
    f = (z + s * cz) - sag
    fp = cz - 2.0 * g * (xs * cx + ys * cy)
    return f, fp, guard


def _newton_point(c, kappa, a, x, y, z, cx, cy, cz, n_iter: int):
    """The pre-polish Newton point: the closed-form sphere guess (the vertex
    plane where it misses), then ``n_iter`` Newton steps."""
    e = -(x * cx + y * cy + z * cz)
    mz = z + e * cz
    m2 = x * x + y * y + z * z - e * e
    temp = c * m2 - 2.0 * mz
    cos2_s = cz * cz - c * temp
    fail_s = cos2_s - EPS < 0
    cos_s = torch.sqrt(torch.where(fail_s, 1.0, cos2_s))
    dist_s = e + temp / (cz + cos_s)
    plane_ok = torch.abs(cz) > EPS
    plane = torch.where(plane_ok, -z / torch.where(plane_ok, cz, 1.0), 0.0)
    s = torch.where(fail_s, plane, dist_s)
    eps, neg_eps = s.new_tensor(EPS), s.new_tensor(-EPS)
    for _ in range(n_iter):
        f, fp, _ = _f_fp(c, kappa, a, x, y, z, cx, cy, cz, s)
        fp_s = torch.where(torch.abs(fp) > EPS, fp, torch.where(fp >= 0, eps, neg_eps))
        s = s - f / fp_s
    return s


def newton_point_with_exit(c, kappa, a, x, y, z, cx, cy, cz, n_iter: int):
    """The kernels' Newton solve: ``_newton_point``'s steps, each lane left
    as soon as its steps repeat. A step is a function of s alone, so once
    s_{i+1} equals s_i bit for bit (a fixed point) every later step returns
    s_i, and once it equals s_{i-1} (a 2-cycle) the steps alternate: the
    ``n_iter``-th is s_{i+1} when n_iter - i - 1 is even, else s_i.

    Returns (s, steps, period), each shaped as x: s with the bits of
    ``_newton_point``'s, the Newton steps each lane evaluates before it
    leaves (``n_iter`` where no period <= 2 shows), and the period it left
    on (1 or 2; 0 for none)."""
    s = _newton_point(c, kappa, a, x, y, z, cx, cy, cz, 0)  # the sphere guess
    bits = lambda v: v.view(torch.int32)
    eps, neg_eps = s.new_tensor(EPS), s.new_tensor(-EPS)
    out = s
    steps = torch.full(s.shape, n_iter, dtype=torch.int32, device=s.device)
    period = torch.zeros(s.shape, dtype=torch.int8, device=s.device)
    done = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    s_prev = s
    for i in range(n_iter):
        f, fp, _ = _f_fp(c, kappa, a, x, y, z, cx, cy, cz, s)
        fp_s = torch.where(torch.abs(fp) > EPS, fp, torch.where(fp >= 0, eps, neg_eps))
        s_next = s - f / fp_s
        one = ~done & (bits(s_next) == bits(s))
        two = ~done & ~one & (bits(s_next) == bits(s_prev)) & (i > 0)
        out = torch.where(one, s, out)
        out = torch.where(two, s_next if (n_iter - i) % 2 else s, out)
        steps = torch.where(one | two, i + 1, steps)
        period = torch.where(one, 1, torch.where(two, 2, period)).to(torch.int8)
        done = done | one | two
        s_prev, s = s, s_next
    return torch.where(done, out, s), steps, period


def _finish_surface(c, kappa, t, mu, a, x, y, z, cx, cy, cz, ok, s_pre):
    """The rest of one surface step from the pre-polish point ``s_pre``: the
    polish step, the failure masks, the hit point and Snell's law with the
    true normal (pallas_asphere ``_fwd_surface_a``). Returns the post-surface
    state and the locals its adjoint reads."""
    f, fp, guard_pre = _f_fp(c, kappa, a, x, y, z, cx, cy, cz, s_pre)
    stationary = torch.abs(fp) < EPS
    fp_safe = torch.where(stationary, 1.0, fp)
    dist = s_pre - f / fp_safe
    not_conv = torch.abs(f) > NEWTON_TOL

    xs = x + dist * cx
    ys = y + dist * cy
    delta_z = dist * cz
    zA = z + delta_z
    r2 = xs * xs + ys * ys
    _, g, guard2, w, u = _sag_terms(c, kappa, a, r2)
    inv_norm = 1.0 / torch.sqrt(1.0 + 4.0 * r2 * g * g)
    dots = xs * cx + ys * cy
    cosr = (cz - 2.0 * g * dots) * inv_norm
    cos2 = cosr * cosr
    fail1 = guard_pre | guard2 | stationary | not_conv | (cos2 - EPS < 0)
    cos = torch.sqrt(torch.where(fail1, 1.0, cos2))

    ok1 = ok & ~fail1
    xB = torch.where(ok1, xs, 0.0)
    yB = torch.where(ok1, ys, 0.0)
    zB = torch.where(ok1, zA, 0.0)
    cxB = torch.where(ok1, cx, 0.0)
    cyB = torch.where(ok1, cy, 0.0)

    r2B = xB * xB + yB * yB
    _, gB, _, wB, uB = _sag_terms(c, kappa, a, r2B)
    inv_normB = 1.0 / torch.sqrt(1.0 + 4.0 * r2B * gB * gB)
    cos2p = 1.0 - mu * mu * (1.0 - cos * cos)
    fail2a = cos2p - EPS < 0
    cosp = torch.sqrt(torch.where(fail2a, 1.0, cos2p))
    gsn = cosp - mu * cos
    nx = 2.0 * xB * gB * inv_normB
    ny = 2.0 * yB * gB * inv_normB
    cxC = mu * cxB - gsn * nx
    cyC = mu * cyB - gsn * ny
    cz2 = 1.0 - (cxC * cxC + cyC * cyC)
    fail2 = fail2a | (cz2 - EPS < 0)
    czC = torch.sqrt(torch.where(fail2, 1.0, cz2))

    ok2 = ok1 & ~fail2
    post = (torch.where(ok2, xB, 0.0), torch.where(ok2, yB, 0.0),
            torch.where(ok2, zB, 0.0) - t, torch.where(ok2, cxC, 0.0),
            torch.where(ok2, cyC, 0.0), torch.where(ok2, czC, 1.0), ok2)
    loc = dict(s_pre=s_pre, f=f, fp_safe=fp_safe, stationary=stationary, not_conv=not_conv,
               guard_pre=guard_pre, guard2=guard2, dist=dist, delta_z=delta_z, xs=xs, ys=ys,
               r2=r2, g=g, w=w, u=u, inv_norm=inv_norm, dots=dots, cosr=cosr, cos2=cos2,
               cos=cos, fail1=fail1, ok1=ok1, xB=xB, yB=yB, cxB=cxB, cyB=cyB, r2B=r2B, gB=gB,
               wB=wB, uB=uB, inv_normB=inv_normB, cos2p=cos2p, fail2a=fail2a, cosp=cosp,
               gsn=gsn, nx=nx, ny=ny, cxC=cxC, cyC=cyC, czC=czC, fail2=fail2)
    return post, loc


def _fwd_surface_a(c, kappa, t, mu, a, x, y, z, cx, cy, cz, ok, n_iter: int):
    """One conic/asphere surface step: the Newton solve, a constant of the
    derivative (so that autograd through this function sees the polish step
    only, as the hand adjoint does), then ``_finish_surface``."""
    with torch.no_grad():
        s_pre = _newton_point(c, kappa, a, x, y, z, cx, cy, cz, n_iter)
    return _finish_surface(c, kappa, t, mu, a, x, y, z, cx, cy, cz, ok, s_pre)


def _polish_adjoint(ddist, f, fp_safe, stationary):
    """(df, dfp) of the polish step dist = s_pre - f/fp_safe with s_pre held,
    through one reciprocal of fp_safe, as the kernels compute them."""
    ifp = 1.0 / fp_safe
    return -ddist * ifp, torch.where(stationary, 0.0, ddist * f * (ifp * ifp))


def _bwd_surface_a(c, kappa, mu, a, pre, loc, d, dcos2_extra=None, dcos2p_extra=None,
                   ddist_extra=None):
    """Adjoint of ``_fwd_surface_a`` (pallas_asphere ``_bwd_surface_a``)
    through the polish step, with the Newton point held constant. ``pre`` is
    the pre-surface state, ``d`` the post-surface cotangents (dx, dy, dz, dcx,
    dcy, dcz); ``dcos2*_extra`` inject the penalty cotangents on the raw cos²
    locals, ``ddist_extra`` the OPL cotangent on the marching distance. Returns (d_pre_state, dc_ray, dkappa_ray, dt_ray, dmu_ray,
    da_ray), per ray; da_ray holds one term per coefficient."""
    x, y, z, cx, cy, cz, _ = pre
    dxD, dyD, dzD, dcxD, dcyD, dczD = d
    L = loc
    ok1, ok2 = L["ok1"], L["ok1"] & ~L["fail2"]
    where = lambda m, v: torch.where(m, v, 0.0)
    n_asph = len(a)

    dt_ray = -dzD
    # reset2 and the cz renormalization
    dczC = where(ok2, dczD)
    dcz2 = torch.where(L["fail2"], 0.0, dczC / (2.0 * L["czC"]))
    dcxC = where(ok2, dcxD) - 2.0 * L["cxC"] * dcz2
    dcyC = where(ok2, dcyD) - 2.0 * L["cyC"] * dcz2
    # Snell: cxC = mu cxB - gsn nx
    dxB = where(ok2, dxD)
    dyB = where(ok2, dyD)
    dzB = where(ok2, dzD)
    dcxB = mu * dcxC
    dcyB = mu * dcyC
    dmu_ray = dcxC * L["cxB"] + dcyC * L["cyB"]
    dgsn = -(dcxC * L["nx"] + dcyC * L["ny"])
    dnx = -dcxC * L["gsn"]
    dny = -dcyC * L["gsn"]
    # nx = 2 xB gB inv_normB, inv_normB = 1/sqrt(1 + 4 r2B gB²)
    xB, yB, gB, r2B, inv_normB = L["xB"], L["yB"], L["gB"], L["r2B"], L["inv_normB"]
    dxB = dxB + dnx * 2.0 * gB * inv_normB
    dyB = dyB + dny * 2.0 * gB * inv_normB
    dgB = (dnx * xB + dny * yB) * 2.0 * inv_normB
    dinv_normB = (dnx * xB + dny * yB) * 2.0 * gB
    dnorm2B = dinv_normB * (-0.5) * (inv_normB * inv_normB * inv_normB)
    dr2B = dnorm2B * 4.0 * gB * gB
    dgB = dgB + dnorm2B * 8.0 * r2B * gB
    # gsn = cosp - mu cos
    cos = L["cos"]
    dcosp = dgsn
    dmu_ray = dmu_ray - dgsn * cos
    dcos = -dgsn * mu
    dcos2p = torch.where(L["fail2a"], 0.0, dcosp / (2.0 * L["cosp"]))
    if dcos2p_extra is not None:
        dcos2p = dcos2p + dcos2p_extra
    dmu_ray = dmu_ray + dcos2p * (-2.0 * mu * (1.0 - cos * cos))
    dcos = dcos + dcos2p * (2.0 * mu * mu * cos)
    # gB(r2B; c, kappa, a)
    hB, gB_c, gB_kap, _, _ = _g_partials(c, kappa, a, r2B, L["wB"], L["uB"])
    dc_ray = dgB * gB_c
    dkap_ray = dgB * gB_kap
    dr2B = dr2B + dgB * hB
    dxB = dxB + 2.0 * xB * dr2B
    dyB = dyB + 2.0 * yB * dr2B

    # reset1 (czB is dead: Snell renormalizes cz)
    dxs = where(ok1, dxB)
    dys = where(ok1, dyB)
    dzA = where(ok1, dzB)
    dcx = where(ok1, dcxB)
    dcy = where(ok1, dcyB)

    # cos = sqrt(cos2), cos2 = cosr², cosr = (cz - 2 g dots) inv_norm
    xs, ys, r2, g, inv_norm, dots = L["xs"], L["ys"], L["r2"], L["g"], L["inv_norm"], L["dots"]
    dcos2 = torch.where(L["fail1"], 0.0, dcos / (2.0 * cos))
    if dcos2_extra is not None:
        dcos2 = dcos2 + dcos2_extra
    dcosr = 2.0 * L["cosr"] * dcos2
    dFsv = dcosr * inv_norm
    dinv_norm = dcosr * (cz - 2.0 * g * dots)
    dnorm2 = dinv_norm * (-0.5) * (inv_norm * inv_norm * inv_norm)
    dr2 = dnorm2 * 4.0 * g * g
    dg = dnorm2 * 8.0 * r2 * g
    dcz = dFsv
    dg = dg - dFsv * 2.0 * dots
    ddots = -dFsv * 2.0 * g
    dxs = dxs + ddots * cx
    dcx = dcx + ddots * xs
    dys = dys + ddots * cy
    dcy = dcy + ddots * ys
    # g(r2; c, kappa, a) at the hit point
    h_, g_c, g_kap, _, _ = _g_partials(c, kappa, a, r2, L["w"], L["u"])
    dc_ray = dc_ray + dg * g_c
    dkap_ray = dkap_ray + dg * g_kap
    dr2 = dr2 + dg * h_
    dxs = dxs + 2.0 * xs * dr2
    dys = dys + 2.0 * ys * dr2

    # xs = x + dist cx, zA = z + dist cz
    dist = L["dist"]
    ddist = dxs * cx + dys * cy + dzA * cz
    if ddist_extra is not None:
        ddist = ddist + ddist_extra
    dx, dy, dz = dxs, dys, dzA
    dcx = dcx + dxs * dist
    dcy = dcy + dys * dist
    dcz = dcz + dzA * dist

    # polish: dist = s_pre - f/fp_safe, s_pre constant
    s_pre = L["s_pre"]
    df, dfp = _polish_adjoint(ddist, L["f"], L["fp_safe"], L["stationary"])
    # f and fp were evaluated at s_pre: that point's locals.
    xsp = x + s_pre * cx
    ysp = y + s_pre * cy
    r2p = xsp * xsp + ysp * ysp
    _, g_p, _, wp, up = _sag_terms(c, kappa, a, r2p)
    hp, gp_c, gp_kap, sagp_c, sagp_kap = _g_partials(c, kappa, a, r2p, wp, up)
    dotsp = xsp * cx + ysp * cy
    # f = (z + s_pre cz) - sag(r2p)
    dz = dz + df
    dcz = dcz + df * s_pre
    dsag = -df
    dc_ray = dc_ray + dsag * sagp_c
    dkap_ray = dkap_ray + dsag * sagp_kap
    dr2p = dsag * g_p
    # fp = cz - 2 g_p dotsp
    dcz = dcz + dfp
    dgp = -dfp * 2.0 * dotsp
    ddotsp = -dfp * 2.0 * g_p
    dc_ray = dc_ray + dgp * gp_c
    dkap_ray = dkap_ray + dgp * gp_kap
    dr2p = dr2p + dgp * hp
    dxsp = 2.0 * xsp * dr2p + ddotsp * cx
    dysp = 2.0 * ysp * dr2p + ddotsp * cy
    dcx = dcx + ddotsp * xsp
    dcy = dcy + ddotsp * ysp
    dx = dx + dxsp
    dy = dy + dysp
    dcx = dcx + dxsp * s_pre
    dcy = dcy + dysp * s_pre

    # The coefficients' terms: dsag/da_k = (r²)^(k+2), dg/da_k = (k+2)(r²)^(k+1),
    # at the Snell point, the hit point and the Newton point, in that order.
    pB, ph, pp = _powers(r2B, n_asph + 1), _powers(r2, n_asph + 1), _powers(r2p, n_asph + 1)
    da_ray = [dgB * (k + 2.0) * pB[k + 1] + dg * (k + 2.0) * ph[k + 1] + dsag * pp[k + 2]
              + dgp * (k + 2.0) * pp[k + 1] for k in range(n_asph)]
    return (dx, dy, dz, dcx, dcy, dcz), dc_ray, dkap_ray, dt_ray, dmu_ray, da_ray


def _trace_batch(xp, yp, cy, z0, c, kappa, t, mu, asph, allow_backward, n_per_w, n_iter, keep,
                 mask=None):
    """The forward trace of a population surface by surface, on (B, N) rays
    with per-system parameters; ``keep(k, pre, loc, kill, post)`` sees each
    surface, ``kill`` the backward-ray test at k > 0, gated by mask[:, k-1]
    where a ``mask`` is given. Returns the state after the last surface."""
    n_sys, n = xp.shape
    n_surf = c.shape[1]
    mu_ray = mu[:, :, _widx(n, n_per_w, mu.shape[2], xp.device)]     # (B, S, N)
    x, y = xp, yp
    z = z0[:, None].expand(n_sys, n)
    cx = torch.zeros_like(xp)
    cz = torch.sqrt(1.0 - cy * cy)
    ok = torch.ones(xp.shape, dtype=torch.bool, device=xp.device)
    for k in range(n_surf):
        pre = (x, y, z, cx, cy, cz, ok)
        a = [asph[:, k, j, None] for j in range(asph.shape[2])]
        tk = t[:, k, None]
        (x, y, z, cx, cy, cz, ok), loc = _fwd_surface_a(c[:, k, None], kappa[:, k, None], tk,
                                                        mu_ray[:, k], a, x, y, z, cx, cy, cz,
                                                        ok, n_iter)
        kill = None
        if k > 0:
            kill = (loc["delta_z"] < 0) & loc["ok1"]
            if mask is not None:
                kill = kill & mask[:, k - 1, None]
            if not allow_backward:
                ok = ok & ~kill
                x, y, cx, cy = (torch.where(kill, 0.0, v) for v in (x, y, cx, cy))
                z = torch.where(kill, -tk, z)
                cz = torch.where(kill, 1.0, cz)
        keep(k, pre, loc, kill, (x, y, z, cx, cy, cz, ok))
    return x, y, z, cx, cy, cz, ok


def _one(inputs):
    """Single-system inputs (z0 a scalar, the rest without the B axis) as a
    population of one."""
    return [a.reshape(1) if i == 3 else a[None] for i, a in enumerate(inputs)]


def _trace(xp, yp, cy, z0, c, kappa, t, mu, asph, allow_backward, n_per_w, n_iter, keep):
    """K3's trace: ``_trace_batch`` on a population of one; ``keep`` sees (N,)
    tensors."""
    def keep_one(k, pre, loc, kill, post):
        keep(k, tuple(v[0] for v in pre), {name: v[0] for name, v in loc.items()},
             None if kill is None else kill[0], tuple(v[0] for v in post))
    state = _trace_batch(*_one((xp, yp, cy, z0, c, kappa, t, mu, asph)), allow_backward,
                         n_per_w, n_iter, keep_one)
    return tuple(v[0] for v in state)


def trace_fused_asphere_batch_reference(xp, yp, cy, z0, c, kappa, t, mu, asph, penalties,
                                        allow_backward: bool, n_per_w: int,
                                        n_iter: int = NEWTON_ITERS, mask=None, ref_z=None,
                                        path_bounds=(), angle_thr=0.25, n_legs=None):
    """Plain PyTorch version of kernel K4 forward, a vectorised transcription
    of ``pallas_asphere._fwd_kernel_ab``: K3's surface step on (B, N) ray
    blocks, each system with its own parameters, in the kernel's order of
    operations, so that the two agree bit for bit on masks and plain-mode
    coordinates. Autograd differentiates it (the Newton steps are constants).

    Args:
      xp, yp, cy: (B, N) absolute pupil coordinates and launch direction
        sines, each system's rays in wavelength-outer flat order.
      z0: (B,) entrance-pupil positions.
      c, kappa, t: (B, S); mu: (B, S, W), ray i of a system uses column
        min(i // n_per_w, W-1); asph: (B, S, K) coefficients of r⁴, r⁶, ...
      penalties, allow_backward, ref_z (B, S+1), path_bounds, angle_thr,
        n_legs (B, S+1, W): as for ``fused_trace.trace_fused_reference``; the
        bounds are shared.
      n_iter: Newton steps before the polish step.
      mask: (B, S) bool tensor of real surfaces, or None when no surface is
        padded; the semantics of ``fused_batch.trace_fused_batch_reference``
        (padded surfaces traced with the conic and coefficients they carry).

    Returns (x, y, cx, cy, ray_ok, ray_backward[, pen_theta, pen_theta_p,
    pen_zrelu[, pen_path, pen_angle]]), or in opl mode the six and ``opl``,
    each (B, N).
    """
    mode = _mode(penalties)
    n_surf = c.shape[1]
    widx = _widx(xp.shape[1], n_per_w, mu.shape[2], xp.device)
    gate = ((lambda k, v: v) if mask is None
            else (lambda k, v: torch.where(mask[:, k, None], v, 0.0)))
    sums = dict(bw=torch.zeros(xp.shape, dtype=torch.bool, device=xp.device),
                pth=torch.zeros_like(xp), ptp=torch.zeros_like(xp), pz=torch.zeros_like(xp),
                ppath=torch.zeros_like(xp), pang=torch.zeros_like(xp), opl=torch.zeros_like(xp),
                z_prev=None)
    ref = lambda j: ref_z[:, j, None]

    def keep(k, pre, loc, kill, post):
        z, ok = post[2], post[6]
        if mode == 3:
            # Leg k, in the medium before surface k, added before a backward
            # ray is removed.
            sums["opl"] = sums["opl"] + loc["dist"] * n_legs[:, k, widx]
        if k > 0 and allow_backward:
            sums["bw"] = sums["bw"] | kill
        if _lu(mode):
            sums["pth"] = sums["pth"] + gate(k, _theta_norm(loc["cos2"], ok))
            sums["ptp"] = sums["ptp"] + gate(k, _theta_norm(loc["cos2p"], ok))
            sums["pz"] = sums["pz"] + gate(k, torch.clamp(z, min=0.0))
        if mode == 2:
            sums["pang"] = (sums["pang"] + gate(k, torch.clamp(angle_thr - loc["cos2"], min=0.0))
                            + gate(k, torch.clamp(angle_thr - loc["cos2p"], min=0.0)))
            if k > 0:
                delta = (z + ref(k)) - (sums["z_prev"] + ref(k - 1))
                sums["ppath"] = sums["ppath"] + _hinge(delta, *path_bounds[k - 1])
            sums["z_prev"] = z

    x, y, z, cx, cy, cz, ok = _trace_batch(xp, yp, cy, z0, c, kappa, t, mu, asph, allow_backward,
                                           n_per_w, n_iter, keep, mask)
    if mode == 2:
        # The image-plane entry: ref_z[S] repeats the last vertex.
        delta = ref(n_surf) - (sums["z_prev"] + ref(n_surf - 1))
        sums["ppath"] = sums["ppath"] + _hinge(delta, *path_bounds[n_surf - 1])

    # Transfer to the image plane.
    delta_z = -z
    dist = delta_z / cz
    x = x + dist * cx
    y = y + dist * cy
    went = (delta_z < 0) & ok
    if mask is not None:
        went = went & mask[:, n_surf - 1, None]
    bw = sums["bw"]
    if allow_backward:
        bw = bw | went
    else:
        ok = ok & ~went
    if mode == 3:
        # The final leg, in the image-space medium.
        return x, y, cx, cy, ok, bw, sums["opl"] + dist * n_legs[:, n_surf, widx]
    return ((x, y, cx, cy, ok, bw) + ((sums["pth"], sums["ptp"], sums["pz"]) if mode else ())
            + ((sums["ppath"], sums["pang"]) if mode == 2 else ()))


def trace_fused_asphere_reference(xp, yp, cy, z0, c, kappa, t, mu, asph, penalties,
                                  allow_backward: bool, n_per_w: int,
                                  n_iter: int = NEWTON_ITERS, ref_z=None, path_bounds=(),
                                  angle_thr=0.25, n_legs=None):
    """Plain PyTorch version of kernel K3 forward (``pallas_asphere._fwd_kernel_a``):
    the population version :func:`trace_fused_asphere_batch_reference` on a
    population of one system without padding, whose arithmetic is K3's.

    Args:
      xp, yp: (N,) absolute pupil coordinates, wavelength-outer flat order.
      cy: (N,) launch direction sine (per-ray field angle).
      z0: scalar entrance-pupil axial position.
      c, kappa, t: (S,) curvatures, conic constants, thicknesses.
      mu: (S, W) index-ratio table; ray i uses column min(i // n_per_w, W-1).
      asph: (S, K) even-asphere coefficients of r⁴, r⁶, ...
      penalties, allow_backward, ref_z, path_bounds, angle_thr, n_legs: as
        for ``fused_trace.trace_fused_reference``.
      n_iter: Newton steps before the polish step.

    Returns (x, y, cx, cy, ray_ok, ray_backward[, pen_theta, pen_theta_p,
    pen_zrelu[, pen_path, pen_angle]]), or in opl mode the six and ``opl``,
    each (N,).
    """
    batch = lambda v: None if v is None else v[None]
    outs = trace_fused_asphere_batch_reference(
        *_one((xp, yp, cy, z0, c, kappa, t, mu, asph)), penalties, allow_backward, n_per_w,
        n_iter, None, batch(ref_z), path_bounds, angle_thr, batch(n_legs))
    return tuple(v[0] for v in outs)


def trace_fused_asphere_batch_backward_reference(inputs, cotangents, penalties,
                                                 allow_backward: bool, n_per_w: int,
                                                 n_iter: int = NEWTON_ITERS, mask=None,
                                                 path_bounds=(), angle_thr=0.25):
    """Plain PyTorch version of kernel K4 backward, a vectorised transcription
    of ``pallas_asphere._bwd_kernel_ab``: the forward surface by surface on
    (B, N) ray blocks, then the hand adjoint in reverse, one torch operation
    per rounding as the kernel does, so that the per-ray cotangents agree
    with the kernel's bit for bit. The parameter cotangents are per system,
    summed over its rays in float64 and returned in float32. The penalty
    cotangents are gated by the surface mask as the forward gates the sums.

    Args:
      inputs: (xp, yp, cy, z0, c, kappa, t, mu, asph[, ref_z (full) or
        n_legs (opl)]) as for the forward.
      cotangents: (dx, dy, dcx, dcy[, dpth, dptp, dpz[, dppath, dpang]]), or
        in opl mode (dx, dy, dcx, dcy, dopl), each (B, N): the cotangents of
        the forward's float outputs.
      penalties, allow_backward, n_per_w, n_iter, mask, path_bounds,
        angle_thr: as for the forward.

    Returns (dxp, dyp, dcy (B, N), dz0 (B,), dc, dkappa, dt (B, S), dmu
    (B, S, W), dasph (B, S, K)[, dref_z (B, S+1) or dn_legs (B, S+1, W)]).
    """
    mode = _mode(penalties)
    xp, yp, cyin, z0, c, kappa, t, mu, asph = inputs[:9]
    ref_z, n_legs = _split_extra(inputs, 9, mode)
    dx_img, dy_img, dcx_img, dcy_img = cotangents[:4]
    if _lu(mode):
        dpth, dptp, dpz = cotangents[4:7]
    if mode == 2:
        dppath, dpang = cotangents[7:9]
    dopl = cotangents[4] if mode == 3 else None
    n_sys, n = xp.shape
    n_surf, n_w, n_asph = c.shape[1], mu.shape[2], asph.shape[2]
    widx = _widx(n, n_per_w, n_w, xp.device)
    mu_ray = mu[:, :, widx]                                          # (B, S, N)
    total = lambda v: torch.sum(v, dim=1, dtype=torch.float64)       # (B,)
    bounds = [(min(w * n_per_w, n), n if w == n_w - 1 else min((w + 1) * n_per_w, n))
              for w in range(n_w)]
    per_w = lambda v: [total(v[:, lo:hi]) for lo, hi in bounds]
    dn = [None] * (n_surf + 1)
    gate = ((lambda k, v: v) if mask is None
            else (lambda k, v: torch.where(mask[:, k, None], v, 0.0)))

    pres, locs, kills = [], [], []

    def keep(k, pre, loc, kill, post):
        pres.append(pre)
        locs.append(loc)
        kills.append(None if allow_backward else kill)

    x, y, z, cx, cy, cz, ok = _trace_batch(xp, yp, cyin, z0, c, kappa, t, mu, asph,
                                           allow_backward, n_per_w, n_iter, keep, mask)
    cz0 = pres[0][5]

    # Image-transfer adjoint.
    dist_f = -z / cz
    dcx = dcx_img + dx_img * dist_f
    dcy = dcy_img + dy_img * dist_f
    ddist = dx_img * cx + dy_img * cy
    if mode == 3:
        # opl += dist_f * n_S: into the final leg's distance adjoint.
        ddist = ddist + dopl * n_legs[:, n_surf, widx]
        dn[n_surf] = per_w(dopl * dist_f)
    dz = -ddist / cz
    dcz = ddist * (z / (cz * cz))
    dx, dy = dx_img, dy_img

    zpost = lambda m: pres[m + 1][2] if m + 1 < n_surf else z
    ref = lambda j: ref_z[:, j, None]

    def hinge_cot(j):
        """dppath · d(hinge_j)/d(delta_j) for path gap j."""
        if j == n_surf - 1:
            delta = ref(n_surf) - (zpost(n_surf - 1) + ref(n_surf - 1))
        else:
            delta = (zpost(j + 1) + ref(j + 1)) - (zpost(j) + ref(j))
        return dppath * _hinge_grad(delta, *path_bounds[j])

    dc, dkap, dt = [None] * n_surf, [None] * n_surf, [None] * n_surf
    dmu = [[None] * n_w for _ in range(n_surf)]
    da = [[None] * n_asph for _ in range(n_surf)]
    dref = [torch.zeros(n_sys, dtype=torch.float64, device=xp.device)] * (n_surf + 1)
    for k in range(n_surf - 1, -1, -1):
        loc, kill = locs[k], kills[k]
        dcos2_extra = dcos2p_extra = ddist_extra = None
        if mode == 3:
            # opl += dist_k * n_k, added before the kill: not cut by it.
            ddist_extra = dopl * n_legs[:, k, widx]
            dn[k] = per_w(dopl * loc["dist"])
        if _lu(mode):
            ok_end = loc["ok1"] & ~loc["fail2"]
            if kill is not None:
                ok_end = ok_end & ~kill
            # pen_z += relu(z after surface k): into the incoming z adjoint.
            relu_on = zpost(k) > 0
            if mask is not None:
                relu_on = relu_on & mask[:, k, None]
            dz = dz + dpz * relu_on.to(dz.dtype)
            dcos2_extra = gate(k, _theta_norm_adjoint(loc["cos2"], ok_end, dpth))
            dcos2p_extra = gate(k, _theta_norm_adjoint(loc["cos2p"], ok_end, dptp))
        if mode == 2:
            # z after surface k enters gap k-1 (+) and gap k (-).
            hp_k = hinge_cot(k)
            dz = dz - hp_k
            if k > 0:
                dz = dz + hinge_cot(k - 1)
            s = total(hp_k)
            dref[k + 1] = dref[k + 1] + s
            dref[k] = dref[k] - s
            dcos2_extra = dcos2_extra - gate(k, dpang * (loc["cos2"] < angle_thr).to(dz.dtype))
            dcos2p_extra = dcos2p_extra - gate(
                k, dpang * (loc["cos2p"] < angle_thr).to(dz.dtype))
        dt_kill = 0.0
        if kill is not None:
            # Killed lanes got z = -t (dz flows to dt) and a zeroed state.
            dt_kill = -total(torch.where(kill, dz, 0.0))
            dx, dy, dz, dcx, dcy, dcz = (torch.where(kill, 0.0, v)
                                         for v in (dx, dy, dz, dcx, dcy, dcz))
        a = [asph[:, k, j, None] for j in range(n_asph)]
        (dx, dy, dz, dcx, dcy, dcz), dc_ray, dkap_ray, dt_ray, dmu_ray, da_ray = _bwd_surface_a(
            c[:, k, None], kappa[:, k, None], mu_ray[:, k], a, pres[k], loc,
            (dx, dy, dz, dcx, dcy, dcz), dcos2_extra, dcos2p_extra, ddist_extra)
        dc[k] = total(dc_ray)
        dkap[k] = total(dkap_ray)
        dt[k] = total(dt_ray) + dt_kill
        dmu[k] = per_w(dmu_ray)
        for j in range(n_asph):
            da[k][j] = total(da_ray[j])

    # Launch adjoint: cz0 = sqrt(1 - cy^2), cx0 = 0 (a constant).
    dcy = dcy + dcz * (-cyin / cz0)
    f32 = lambda vals: torch.stack(vals, dim=1).to(torch.float32)
    grads = (dx.contiguous(), dy.contiguous(), dcy, total(dz).to(torch.float32), f32(dc),
             f32(dkap), f32(dt), torch.stack([f32(row) for row in dmu], dim=1),
             torch.stack([f32(row) for row in da], dim=1))
    if mode == 2:
        grads += (f32(dref),)
    if mode == 3:
        grads += (torch.stack([f32(row) for row in dn], dim=1),)
    return grads


def trace_fused_asphere_backward_reference(inputs, cotangents, penalties,
                                           allow_backward: bool, n_per_w: int,
                                           n_iter: int = NEWTON_ITERS, path_bounds=(),
                                           angle_thr=0.25):
    """Plain PyTorch version of kernel K3 backward (``pallas_asphere._bwd_kernel_a``):
    the population version :func:`trace_fused_asphere_batch_backward_reference`
    on a population of one system without padding, whose arithmetic is K3's.

    Args:
      inputs: (xp, yp, cy, z0, c, kappa, t, mu, asph[, ref_z (full) or
        n_legs (opl)]) as for the forward.
      cotangents: (dx, dy, dcx, dcy[, dpth, dptp, dpz[, dppath, dpang]]), or
        in opl mode (dx, dy, dcx, dcy, dopl), each (N,): the cotangents of
        the forward's float outputs.
      penalties, allow_backward, n_per_w, n_iter, path_bounds, angle_thr: as
        for the forward.

    Returns (dxp, dyp, dcy, dz0, dc, dkappa, dt, dmu, dasph[, dref_z or
    dn_legs]).
    """
    z0 = inputs[3]
    grads = trace_fused_asphere_batch_backward_reference(
        _one(inputs), [v[None] for v in cotangents], penalties, allow_backward, n_per_w, n_iter,
        None, path_bounds, angle_thr)
    return tuple(g.reshape(z0.shape) if i == 3 else g[0] for i, g in enumerate(grads))


# ---------------------------------------------------------------------------
# Kernel K3: the CUDA wrappers and the autograd Function.
# ---------------------------------------------------------------------------


def _check_k3_inputs(inputs, n_per_w, n_iter, lib, mode=0):
    xp, yp, cy, z0, c, kappa, t, mu, asph = inputs[:9]
    ref_z, n_legs = _split_extra(inputs, 9, mode)
    fused_trace._check_k1_inputs(xp, yp, cy, z0, c, t, mu, n_per_w, lib.k1_max_surf(),
                                 lib.k1_max_w(), ref_z, n_legs)
    fused_trace._check_tensors(dict(kappa=kappa, asph=asph), xp.device)
    n_surf = c.shape[0]
    if tuple(kappa.shape) != (n_surf,) or asph.ndim != 2 or asph.shape[0] != n_surf:
        raise ValueError(f"kappa must be (S,) and asph (S, K) with S = {n_surf}, got "
                         f"{tuple(kappa.shape)}, {tuple(asph.shape)}")
    if not 1 <= asph.shape[1] <= lib.k3_max_asph():
        raise ValueError(f"K3 takes 1..{lib.k3_max_asph()} asphere coefficients, got "
                         f"{asph.shape[1]}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")


def _param_sizes(mode, n_surf, n_w, n_asph):
    """The parameter layout of K3 and K4 backward, per system: dz0, dc,
    dkappa, dt, dmu, dasph[, dref_z or dn_legs]."""
    sizes = [1, n_surf, n_surf, n_surf, n_surf * n_w, n_surf * n_asph]
    return sizes + ([n_extra_params(mode, n_surf, n_w)] if mode in (2, 3) else [])


def _launch_k3_fwd(inputs, penalties, allow_backward, n_per_w, n_iter, path_bounds, angle_thr):
    global K3_FWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    _check_k3_inputs(inputs, n_per_w, n_iter, lib, mode)
    xp, yp, cy, z0, c, kappa, t, mu, asph = inputs[:9]
    ref_z, n_legs = _split_extra(inputs, 9, mode)
    ref_z, lo, hi = fused_trace._full_args(mode, ref_z, path_bounds, c.shape[0], xp.device)
    n = xp.shape[0]
    new = lambda dtype: torch.empty(n, dtype=dtype, device=xp.device)
    outs = [new(torch.float32) for _ in range(4)] + [new(torch.bool) for _ in range(2)]
    outs += [new(torch.float32) for _ in range(N_EXTRA_OUTS[mode])]
    pens, opl = _out_ptrs(outs, mode)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k3_fwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs)),
            float(angle_thr), n, c.shape[0], mu.shape[1], asph.shape[1], n_per_w, n_iter, mode,
            int(allow_backward), *map(_ptr, outs[:6]), *pens, opl, stream)
    fused_trace._raise_on_error(lib, err, "K3 forward kernel")
    K3_FWD_LAUNCHES += 1
    K3_FWD_MODE_LAUNCHES[mode] += 1
    return tuple(outs)


def _launch_k3_bwd(inputs, cotangents, penalties, allow_backward, n_per_w, n_iter, path_bounds,
                   angle_thr):
    global K3_BWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    _check_k3_inputs(inputs, n_per_w, n_iter, lib, mode)
    xp, yp, cy, z0, c, kappa, t, mu, asph = inputs[:9]
    ref_z, n_legs = _split_extra(inputs, 9, mode)
    ref_z, lo, hi = fused_trace._full_args(mode, ref_z, path_bounds, c.shape[0], xp.device)
    n, n_surf, n_w, n_asph = xp.shape[0], c.shape[0], mu.shape[1], asph.shape[1]
    cot = _prepare_cotangents(cotangents, xp)
    sizes = _param_sizes(mode, n_surf, n_w, n_asph)
    n_params = sum(sizes)
    n_blocks = -(-n // lib.k1_bwd_block())
    new = lambda size: torch.empty(size, dtype=torch.float32, device=xp.device)
    dxp, dyp, dcy = new(n), new(n), new(n)
    params = new(n_params)
    partials = torch.empty(n_params * n_blocks, dtype=torch.float64, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k3_bwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs)),
            float(angle_thr), *_cot_ptrs(cot, mode), n, n_surf, n_w, n_asph, n_per_w, n_iter,
            mode, int(allow_backward), *map(_ptr, (dxp, dyp, dcy, partials, params)), stream)
    fused_trace._raise_on_error(lib, err, "K3 backward kernel")
    K3_BWD_LAUNCHES += 1
    K3_BWD_MODE_LAUNCHES[mode] += 1
    dz0, dc, dkap, dt, dmu, da, *extra = torch.split(params, sizes)
    if mode == 3:
        extra = [extra[0].reshape(n_surf + 1, n_w)]
    return (dxp, dyp, dcy, dz0.reshape(z0.shape), dc, dkap, dt, dmu.reshape(n_surf, n_w),
            da.reshape(n_surf, n_asph), *extra)


class _K3(torch.autograd.Function):
    """Kernel K3 with its hand adjoint. The forward saves only the inputs;
    the backward recomputes the trace (``pallas_asphere._fused_fwd_a`` /
    ``_fused_bwd_a``). ``extra`` is ref_z in full mode, n_legs in opl mode."""

    @staticmethod
    def forward(ctx, penalties, allow_backward, n_per_w, n_iter, path_bounds, angle_thr,
                xp, yp, cy, z0, c, kappa, t, mu, asph, extra):
        mode = _mode(penalties)
        inputs = (xp, yp, cy, z0, c, kappa, t, mu, asph)
        inputs += (extra,) if mode in (2, 3) else ()
        config = (penalties, allow_backward, n_per_w, n_iter, path_bounds, angle_thr)
        if xp.device.type == "cpu":
            ref_z, n_legs = _split_extra(inputs, 9, mode)
            outs = trace_fused_asphere_reference(*inputs[:9], penalties, allow_backward, n_per_w,
                                                 n_iter, ref_z, path_bounds, angle_thr, n_legs)
        else:
            outs = _launch_k3_fwd(inputs, *config)
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
            out = trace_fused_asphere_backward_reference(inputs, cot, *ctx.config)
        else:
            out = _launch_k3_bwd(inputs, cot, *ctx.config)
        return (None,) * 6 + tuple(out) + (None,) * (10 - len(out))


def _apply_k3(inputs, penalties, allow_backward, n_per_w, n_iter, path_bounds=(),
              angle_thr=0.25):
    if inputs[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"K3 runs on CUDA or CPU tensors, got {inputs[0].device}")
    extra = inputs[9] if len(inputs) > 9 else None
    return _K3.apply(penalties, bool(allow_backward), int(n_per_w), int(n_iter),
                     tuple(path_bounds), float(angle_thr), *inputs[:9], extra)


def trace_fused_asphere(xp, yp, cy, z0, c, kappa, t, mu, asph, penalties: bool,
                        allow_backward: bool, n_per_w: int, n_iter: int = NEWTON_ITERS):
    """Kernel K3 on a flat wavelength-outer ray block, plain (``penalties``
    False) or Lu (True) mode; arguments and results as
    :func:`trace_fused_asphere_reference`. Differentiable in all nine inputs.

    On CUDA tensors it launches the CUDA kernels (float32, contiguous, one
    device; anything else raises). On CPU tensors it runs the plain versions.
    """
    if _mode(penalties) >= 2:
        raise ValueError("the full and opl modes need their tables: use "
                         "trace_fused_asphere_full or trace_fused_asphere_opl")
    return _apply_k3((xp, yp, cy, z0, c, kappa, t, mu, asph), penalties, allow_backward,
                     n_per_w, n_iter)


def trace_fused_asphere_full(xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z,
                             allow_backward: bool, path_bounds, angle_thr: float, n_per_w: int,
                             n_iter: int = NEWTON_ITERS):
    """``trace_fused_asphere`` with the full weighted-loss penalty set
    accumulated in the kernel, as ``fused_trace.trace_fused_full`` (the same
    ``ref_z``, ``path_bounds`` and ``angle_thr`` contract). Returns the 6
    trace outputs plus (pen_theta, pen_theta_p, pen_zrelu, pen_path,
    pen_angle), each (N,)."""
    return _apply_k3((xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z), "full", allow_backward,
                     n_per_w, n_iter, path_bounds, angle_thr)


def trace_fused_asphere_opl(xp, yp, cy, z0, c, kappa, t, mu, asph, n_legs,
                            allow_backward: bool, n_per_w: int, n_iter: int = NEWTON_ITERS):
    """``trace_fused_asphere`` with the optical path length accumulated in
    the kernel (``pallas_asphere.trace_fused_asphere_opl``), with
    ``fused_trace.trace_fused_opl``'s ``n_legs`` (S+1, W) contract. Returns
    the 6 trace outputs plus ``opl``, each (N,)."""
    return _apply_k3((xp, yp, cy, z0, c, kappa, t, mu, asph, n_legs), "opl", allow_backward,
                     n_per_w, n_iter)


# ---------------------------------------------------------------------------
# Kernel K4: the CUDA wrappers and the autograd Function.
# ---------------------------------------------------------------------------


def _check_k4_inputs(inputs, mask, n_per_w, n_iter, lib, mode=0):
    xp, yp, cy, z0, c, kappa, t, mu, asph = inputs[:9]
    spherical = (xp, yp, cy, z0, c, t, mu) + tuple(inputs[9:])
    fused_batch._check_k2_inputs(spherical, mask, n_per_w, lib.k1_max_surf(), lib.k1_max_w(),
                                 kernel="K4", mode=mode)
    fused_trace._check_tensors(dict(kappa=kappa, asph=asph), xp.device)
    if kappa.shape != c.shape or asph.ndim != 3 or asph.shape[:2] != c.shape:
        raise ValueError(f"kappa must be (B, S) and asph (B, S, K) with (B, S) = "
                         f"{tuple(c.shape)}, got {tuple(kappa.shape)}, {tuple(asph.shape)}")
    if not 1 <= asph.shape[2] <= lib.k3_max_asph():
        raise ValueError(f"K4 takes 1..{lib.k3_max_asph()} asphere coefficients, got "
                         f"{asph.shape[2]}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")


def _launch_k4_fwd(inputs, penalties, allow_backward, n_per_w, n_iter, mask, path_bounds,
                   angle_thr):
    global K4_FWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    _check_k4_inputs(inputs, mask, n_per_w, n_iter, lib, mode)
    xp, yp, cy, z0, c, kappa, t, mu, asph = inputs[:9]
    n_sys, n = xp.shape
    ref_z, n_legs = _split_extra(inputs, 9, mode)
    ref_z, lo, hi = fused_trace._full_args(mode, ref_z, path_bounds, c.shape[1], xp.device)
    new = lambda dtype: torch.empty(xp.shape, dtype=dtype, device=xp.device)
    outs = [new(torch.float32) for _ in range(4)] + [new(torch.bool) for _ in range(2)]
    outs += [new(torch.float32) for _ in range(N_EXTRA_OUTS[mode])]
    pens, opl = _out_ptrs(outs, mode)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k4_fwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, kappa, t, mu, asph, mask, ref_z, lo, hi, n_legs)),
            float(angle_thr), n_sys, n, c.shape[1], mu.shape[2], asph.shape[2], n_per_w, n_iter,
            mode, int(allow_backward), *map(_ptr, outs[:6]), *pens, opl, stream)
    fused_trace._raise_on_error(lib, err, "K4 forward kernel")
    K4_FWD_LAUNCHES += 1
    K4_FWD_MODE_LAUNCHES[mode] += 1
    return tuple(outs)


def _launch_k4_bwd(inputs, cotangents, penalties, allow_backward, n_per_w, n_iter, mask,
                   path_bounds, angle_thr):
    global K4_BWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    _check_k4_inputs(inputs, mask, n_per_w, n_iter, lib, mode)
    xp, yp, cy, z0, c, kappa, t, mu, asph = inputs[:9]
    n_sys, n = xp.shape
    n_surf, n_w, n_asph = c.shape[1], mu.shape[2], asph.shape[2]
    ref_z, n_legs = _split_extra(inputs, 9, mode)
    ref_z, lo, hi = fused_trace._full_args(mode, ref_z, path_bounds, n_surf, xp.device)
    cot = _prepare_cotangents(cotangents, xp)
    sizes = _param_sizes(mode, n_surf, n_w, n_asph)
    n_params = sum(sizes)
    n_blocks = -(-n // lib.k1_bwd_block())
    new = lambda *size: torch.empty(size, dtype=torch.float32, device=xp.device)
    dxp, dyp, dcy = new(n_sys, n), new(n_sys, n), new(n_sys, n)
    params = new(n_sys, n_params)
    partials = torch.empty(n_sys * n_params * n_blocks, dtype=torch.float64, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k4_bwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, kappa, t, mu, asph, mask, ref_z, lo, hi, n_legs)),
            float(angle_thr), *_cot_ptrs(cot, mode), n_sys, n, n_surf, n_w, n_asph, n_per_w,
            n_iter, mode, int(allow_backward), *map(_ptr, (dxp, dyp, dcy, partials, params)),
            stream)
    fused_trace._raise_on_error(lib, err, "K4 backward kernel")
    K4_BWD_LAUNCHES += 1
    K4_BWD_MODE_LAUNCHES[mode] += 1
    dz0, dc, dkap, dt, dmu, da, *extra = torch.split(params, sizes, dim=1)
    if mode == 3:
        extra = [extra[0].reshape(n_sys, n_surf + 1, n_w)]
    return (dxp, dyp, dcy, dz0.reshape(n_sys), dc, dkap, dt, dmu.reshape(n_sys, n_surf, n_w),
            da.reshape(n_sys, n_surf, n_asph), *extra)


class _K4(torch.autograd.Function):
    """Kernel K4 with its hand adjoint. The forward saves only the inputs;
    the backward recomputes the trace (``pallas_asphere._fused_fwd_ab`` /
    ``_fused_bwd_ab``). ``extra`` is ref_z in full mode, n_legs in opl mode."""

    @staticmethod
    def forward(ctx, penalties, allow_backward, n_per_w, n_iter, mask, path_bounds, angle_thr,
                xp, yp, cy, z0, c, kappa, t, mu, asph, extra):
        mode = _mode(penalties)
        inputs = (xp, yp, cy, z0, c, kappa, t, mu, asph)
        inputs += (extra,) if mode in (2, 3) else ()
        config = (penalties, allow_backward, n_per_w, n_iter, mask, path_bounds, angle_thr)
        if xp.device.type == "cpu":
            ref_z, n_legs = _split_extra(inputs, 9, mode)
            outs = trace_fused_asphere_batch_reference(*inputs[:9], penalties, allow_backward,
                                                       n_per_w, n_iter, mask, ref_z, path_bounds,
                                                       angle_thr, n_legs)
        else:
            outs = _launch_k4_fwd(inputs, *config)
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
            out = trace_fused_asphere_batch_backward_reference(inputs, cot, *ctx.config)
        else:
            out = _launch_k4_bwd(inputs, cot, *ctx.config)
        return (None,) * 7 + tuple(out) + (None,) * (10 - len(out))


def _apply_k4(inputs, penalties, allow_backward, n_per_w, n_iter, mask, path_bounds=(),
              angle_thr=0.25):
    if inputs[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"K4 runs on CUDA or CPU tensors, got {inputs[0].device}")
    inputs = [v.contiguous() for v in inputs]
    extra = inputs[9] if len(inputs) > 9 else None
    return _K4.apply(penalties, bool(allow_backward), int(n_per_w), int(n_iter), mask,
                     tuple(path_bounds), float(angle_thr), *inputs[:9], extra)


def trace_fused_asphere_batch(xp, yp, cy, z0, c, kappa, t, mu, asph, penalties: bool,
                              allow_backward: bool, n_per_w: int, n_iter: int = NEWTON_ITERS,
                              mask: Optional[torch.Tensor] = None):
    """Kernel K4 on a population's (B, N) wavelength-outer ray blocks, plain
    (``penalties`` False) or Lu (True) mode; arguments and results as
    :func:`trace_fused_asphere_batch_reference`. Differentiable in all nine
    inputs.

    On CUDA tensors it launches the CUDA kernels (float32, one device;
    anything else raises). On CPU tensors it runs the plain versions."""
    if _mode(penalties) >= 2:
        raise ValueError("the full and opl modes need their tables: use "
                         "trace_fused_asphere_batch_full or trace_fused_asphere_batch_opl")
    return _apply_k4((xp, yp, cy, z0, c, kappa, t, mu, asph), penalties, allow_backward,
                     n_per_w, n_iter, mask)


def trace_fused_asphere_batch_full(xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z,
                                   allow_backward: bool, path_bounds, angle_thr: float,
                                   n_per_w: int, n_iter: int = NEWTON_ITERS,
                                   mask: Optional[torch.Tensor] = None):
    """``trace_fused_asphere_batch`` with the full weighted-loss penalty set,
    the population form of :func:`trace_fused_asphere_full`: each system's
    absolute vertex positions in ``ref_z`` (B, S+1), the static per-gap
    ``path_bounds`` shared by the population. Returns the 6 trace outputs
    plus (pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_angle), each
    (B, N)."""
    return _apply_k4((xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z), "full", allow_backward,
                     n_per_w, n_iter, mask, path_bounds, angle_thr)


def trace_fused_asphere_batch_opl(xp, yp, cy, z0, c, kappa, t, mu, asph, n_legs,
                                  allow_backward: bool, n_per_w: int,
                                  n_iter: int = NEWTON_ITERS,
                                  mask: Optional[torch.Tensor] = None):
    """``trace_fused_asphere_batch`` with the optical path length accumulated
    in the kernel (``pallas_asphere.trace_fused_asphere_batch_opl``), the
    population form of :func:`trace_fused_asphere_opl`, with each system's
    per-leg indices in ``n_legs`` (B, S+1, W). Returns the 6 trace outputs
    plus ``opl``, each (B, N)."""
    return _apply_k4((xp, yp, cy, z0, c, kappa, t, mu, asph, n_legs), "opl", allow_backward,
                     n_per_w, n_iter, mask)


# ---------------------------------------------------------------------------
# Front-end, packaging and losses (K1's, wavelength-outer).
# ---------------------------------------------------------------------------


def with_asphere_terms(lens: Lens) -> Lens:
    """The lens K3 and K4 trace: zeros for an absent ``kappa`` (B, S) or
    ``asph`` (B, S, 1)."""
    if lens.kappa is None:
        lens = lens.replace(kappa=torch.zeros_like(lens.c))
    if lens.asph is None:
        lens = lens.replace(asph=torch.zeros(lens.c.shape + (1,), dtype=lens.c.dtype,
                                             device=lens.c.device))
    return lens


def _check_asphere_lens(lens: Lens, config) -> Lens:
    """The lens K3 traces: ``with_asphere_terms``, then K1's checks and tail
    compression."""
    return fused_trace._check_fused_lens(with_asphere_terms(lens), config)


def _run(specs, lens, config, generator, xy, use_vig, penalties):
    lens = _check_asphere_lens(lens, config)
    xp, yp, cyb, z0, mu, shape = fused_trace.prepare_fused_inputs(
        specs, lens, config, generator=generator, xy=xy, use_vig=use_vig)
    _, F, P, _ = shape
    outs = trace_fused_asphere(xp, yp, cyb, z0, lens.c[0], lens.kappa[0], lens.t[0], mu,
                               lens.asph[0], penalties, config.allow_backward_rays, F * P,
                               config.newton_iters)
    return lens, outs, shape


def trace_rays_fused_asphere(specs, lens: Lens, config,
                             generator: Optional[torch.Generator] = None,
                             xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                             penalties: bool = False, use_vig: bool = True):
    """``trace_rays`` on kernel K3 (one conic/asphere system; an absent
    ``kappa`` or ``asph`` is taken as zeros). Returns a
    ``TraceResult`` shaped (1, F, P, W); with ``penalties`` it returns
    ``(TraceResult, (pen_theta, pen_theta_p, pen_zrelu))``, each the per-ray
    sum over surfaces. ``config.newton_iters`` sets the kernel's Newton
    count."""
    _, outs, shape = _run(specs, lens, config, generator, xy, use_vig, penalties)
    return fused_trace.package_fused_result(outs, shape, penalties)


def trace_rays_fused_asphere_batch(specs, lens: Lens, config,
                                   generator: Optional[torch.Generator] = None,
                                   xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                   penalties: bool = False, use_vig: bool = True):
    """``trace_rays`` on kernel K4: a population of conic/asphere systems (an
    absent ``kappa`` or ``asph`` taken as zeros; a padded population of
    mixed lens types through its surface mask), through
    ``fused_batch.trace_rays_fused_batch``. Returns a ``TraceResult`` shaped
    (B, F, P, W); with ``penalties`` it returns ``(TraceResult, (pen_theta,
    pen_theta_p, pen_zrelu))``, each the per-ray sum over a system's real
    surfaces."""
    return fused_batch.trace_rays_fused_batch(specs, with_asphere_terms(lens), config,
                                              generator=generator, xy=xy, penalties=penalties,
                                              use_vig=use_vig)


def optical_paths_fused_asphere(specs, lens: Lens, config,
                                generator: Optional[torch.Generator] = None,
                                xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``wavefront.optical_path_lengths`` on kernel K3's opl mode (one
    conic/asphere system, an absent ``kappa`` or ``asph`` as zeros, float32;
    ``pallas_asphere.optical_paths_fused_asphere``): returns (TraceResult,
    OPL) with OPL (1, F, P, W) in mm, launch phase included; differentiable
    through c, kappa, t, asph and the dispersion model."""
    lens = _check_asphere_lens(lens, config)
    xp, yp, cyb, z0, mu, shape = fused_trace.prepare_fused_inputs(
        specs, lens, config, generator=generator, xy=xy)
    _, F, P, _ = shape
    outs = trace_fused_asphere_opl(xp, yp, cyb, z0, lens.c[0], lens.kappa[0], lens.t[0], mu,
                                   lens.asph[0],
                                   fused_trace.leg_indices(lens, config.wavelengths)[0],
                                   config.allow_backward_rays, F * P, config.newton_iters)
    return (fused_trace.package_fused_result(outs[:6], shape, False),
            fused_trace.package_opl(outs[6][None], yp[None], cyb[None], shape))


def optical_paths_fused_asphere_batch(specs, lens: Lens, config,
                                      generator: Optional[torch.Generator] = None,
                                      xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``wavefront.optical_path_lengths`` on kernel K4's opl mode (B >= 1
    conic/asphere systems, an absent ``kappa`` or ``asph`` as zeros, float32;
    ``pallas_asphere.optical_paths_fused_asphere_batch``), a padded
    population through its surface mask: returns (TraceResult, OPL) with OPL
    (B, F, P, W) in mm, launch phase included."""
    lens = with_asphere_terms(lens)
    fused_batch._check_population(config)
    xpb, ypb, cyb, z0, mu, shape = fused_batch.prepare_fused_inputs_batch(
        specs, lens, config, generator=generator, xy=xy)
    _, F, P, _ = shape
    outs = trace_fused_asphere_batch_opl(
        xpb, ypb, cyb, z0, lens.c, lens.kappa, lens.t, mu, lens.asph,
        fused_trace.leg_indices(lens, config.wavelengths), config.allow_backward_rays, F * P,
        config.newton_iters, fused_batch._static_mask(lens.structure, lens.device))
    return (fused_batch.package_fused_result_batch(outs[:6], shape, False),
            fused_trace.package_opl(outs[6], ypb, cyb, shape))


def compute_losses_fused_asphere(specs, lens: Lens, config, g=None, catalog_g=None,
                                 generator: Optional[torch.Generator] = None):
    """The full weighted loss (spot + ray-path + ray-angle + glass + Lu) of
    one conic/asphere system on one launch of K3's full mode; the asphere
    form of ``fused_trace.compute_losses_fused``. ``config`` is a
    ``simulator.SimulatorConfig``. Returns (total, loss_dict)."""
    cfg = config.trace_config()
    lens = _check_asphere_lens(lens, cfg)
    bounds = fused_trace._path_bounds(lens.structure, config.ray_path_lower_thresholds,
                                      config.ray_path_upper_thresholds)
    angle_thr = math.cos(math.radians(config.ray_angle_threshold)) ** 2
    xp, yp, cyb, z0, mu, (_, F, P, W) = fused_trace.prepare_fused_inputs(
        specs, lens, cfg, generator=generator)
    vertex_z = torch.cumsum(lens.t[0], dim=0)
    ref_z = torch.cat((vertex_z, vertex_z[-1:]))
    outs = trace_fused_asphere_full(xp, yp, cyb, z0, lens.c[0], lens.kappa[0], lens.t[0], mu,
                                    lens.asph[0], ref_z, cfg.allow_backward_rays, bounds,
                                    angle_thr, F * P, cfg.newton_iters)
    return fused_trace.full_loss_terms(outs, lens, config, (F, P, W), g, catalog_g)
