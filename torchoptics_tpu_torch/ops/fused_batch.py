"""The fused spherical trace of a lens population: front-end, kernels, losses.

PyTorch counterpart of ``torchoptics_tpu.ops.pallas_batch``. Many lens
systems trace in one launch, the generator-training workload (a population
of designs scored by the unsupervised loss) and every multi-system call of
the fused engine. The Pallas TPU kernels there become kernel K2,
hand-written in CUDA C++:

* K2 forward (``_fwd_kernel_b``) in ``csrc/fused_batch_fwd.cu``, in plain,
  Lu, full and opl modes;
* K2 backward (``_bwd_kernel_b``), the hand adjoint with a forward
  recompute and per-system parameter cotangents, in
  ``csrc/fused_batch_bwd.cu``.

K2 is K1 (``ops.fused_trace``) over a grid of (ray blocks x systems), with
per-system z0 (B,), c, t (B, S), mu (B, S, W), ref_z (B, S+1) or n_legs
(B, S+1, W) and, for a padded population of mixed lens types, a (B, S)
surface mask. Both kernels
share K1's device code (``csrc/trace_common.cuh``) and are reached through
one ``torch.autograd.Function``; on CPU tensors it runs the plain versions,
:func:`trace_fused_batch_reference` and
:func:`trace_fused_batch_backward_reference`, which are built on K1's plain
surface step and its adjoint.

The mask semantics are ``pallas_batch``'s. Padded surfaces (c = t = 0,
n = V = 1) are traced, not skipped. The backward-ray test at surface k is
gated by mask[k-1] and the last one by mask[S-1]; the Lu sums and the angle
hinge by mask[k]; the path hinge and the optical path length are not gated
(the full mode is reached by homogeneous populations only; a padded gap has
n = 1 and a zero-length leg).

The front-end keeps one ray order, wavelength-outer: each system's rays are
a flat (W, F, P) block, the rows of a (B, N) array. The front-end, the
losses and ``trace_rays_fused_batch`` also serve a population of
conic/asphere systems, which goes to kernel K4 (``ops.fused_asphere``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from torchoptics_tpu_torch.models.structure import Lens, Structure
from torchoptics_tpu_torch.ops import abcd as abcd_mod
from torchoptics_tpu_torch.ops import fused_trace
from torchoptics_tpu_torch.ops import pupil as pupil_mod
from torchoptics_tpu_torch.ops import trace as trace_mod
from torchoptics_tpu_torch.ops.fused_trace import (
    N_EXTRA_OUTS, _bwd_surface, _cot_ptrs, _fwd_surface, _hinge, _hinge_grad, _lu, _mode,
    _out_ptrs, _prepare_cotangents, _ptr, _split_extra, _theta_norm_adjoint, n_extra_params)

#: Launches of the K2 forward and backward CUDA kernels in this process. The
#: wrappers add one per launch; reset them to 0 to count the launches of one
#: run.
K2_FWD_LAUNCHES = 0
K2_BWD_LAUNCHES = 0
#: The same launches by the kernels' template mode (0 plain, 1 Lu, 2 full,
#: 3 opl), counted where the totals are; reset each to [0] * 4.
K2_FWD_MODE_LAUNCHES = [0, 0, 0, 0]
K2_BWD_MODE_LAUNCHES = [0, 0, 0, 0]


# ---------------------------------------------------------------------------
# Kernel K2: the plain versions of both passes.
# ---------------------------------------------------------------------------


def _theta_norm(cos2, ok):
    """The kernels' theta_norm: ``trace._agg_entry``'s guards and clip."""
    return trace_mod._agg_entry("theta_norm", ok, None, cos2, None, ok.shape)


def _widx(n: int, n_per_w: int, n_w: int, device):
    """Wavelength column of each system-local ray: min(i // n_per_w, W-1)."""
    return torch.clamp(torch.arange(n, device=device) // n_per_w, max=n_w - 1)


def trace_fused_batch_reference(xp, yp, cy, z0, c, t, mu, penalties, allow_backward: bool,
                                n_per_w: int, mask=None, ref_z=None, path_bounds=(),
                                angle_thr=0.25, n_legs=None):
    """Plain PyTorch version of kernel K2 forward: K1's surface step
    (``fused_trace._fwd_surface``) on (B, N) ray blocks, each system with its
    own parameters, in the kernel's order of operations, so that the two
    agree bit for bit on masks and coordinates. Autograd differentiates it.

    Args:
      xp, yp, cy: (B, N) absolute pupil coordinates and launch direction
        sines, each system's rays in wavelength-outer flat order.
      z0: (B,) entrance-pupil positions.
      c, t: (B, S); mu: (B, S, W), ray i of a system uses column
        min(i // n_per_w, W-1).
      penalties, allow_backward, ref_z (B, S+1), path_bounds, angle_thr,
        n_legs (B, S+1, W): as for ``fused_trace.trace_fused_reference``; the
        bounds are shared.
      mask: (B, S) bool tensor of real surfaces, or None when no surface is
        padded.

    Returns (x, y, cx, cy, ray_ok, ray_backward[, pen_theta, pen_theta_p,
    pen_zrelu[, pen_path, pen_angle]]), or in opl mode the six and ``opl``,
    each (B, N).
    """
    mode = _mode(penalties)
    n_sys, n = xp.shape
    n_surf = c.shape[1]
    widx = _widx(n, n_per_w, mu.shape[2], xp.device)
    mu_ray = mu[:, :, widx]                                         # (B, S, N)
    gate = ((lambda k, a: a) if mask is None
            else (lambda k, a: torch.where(mask[:, k, None], a, 0.0)))
    x, y = xp, yp
    z = z0[:, None].expand(n_sys, n)
    cx = torch.zeros_like(xp)
    cz = torch.sqrt(1.0 - cy * cy)
    ok = torch.ones(xp.shape, dtype=torch.bool, device=xp.device)
    bw = torch.zeros_like(ok)
    pth = ptp = pz = ppath = pang = opl = torch.zeros_like(xp)
    z_prev = None
    for k in range(n_surf):
        tk = t[:, k, None]
        (x, y, z, cx, cy, cz, ok2), loc = _fwd_surface(c[:, k, None], tk, mu_ray[:, k],
                                                       x, y, z, cx, cy, cz, ok)
        if mode == 3:
            # Leg k, in the medium before surface k, before a backward ray
            # is removed.
            opl = opl + loc["dist"] * n_legs[:, k, widx]
        if k > 0:
            went = (loc["delta_z"] < 0) & loc["ok1"]
            if mask is not None:
                went = went & mask[:, k - 1, None]
            if allow_backward:
                bw = bw | went
            else:
                ok2 = ok2 & ~went
                x, y, cx, cy = (torch.where(went, 0.0, a) for a in (x, y, cx, cy))
                z = torch.where(went, -tk, z)
                cz = torch.where(went, 1.0, cz)
        ok = ok2
        if _lu(mode):
            pth = pth + gate(k, _theta_norm(loc["cos2"], ok))
            ptp = ptp + gate(k, _theta_norm(loc["cos2p"], ok))
            pz = pz + gate(k, torch.clamp(z, min=0.0))
        if mode == 2:
            pang = (pang + gate(k, torch.clamp(angle_thr - loc["cos2"], min=0.0))
                    + gate(k, torch.clamp(angle_thr - loc["cos2p"], min=0.0)))
            if k > 0:
                delta = (z + ref_z[:, k, None]) - (z_prev + ref_z[:, k - 1, None])
                ppath = ppath + _hinge(delta, *path_bounds[k - 1])
            z_prev = z
    if mode == 2:
        # The image-plane entry: ref_z[S] repeats the last vertex.
        delta = ref_z[:, n_surf, None] - (z_prev + ref_z[:, n_surf - 1, None])
        ppath = ppath + _hinge(delta, *path_bounds[n_surf - 1])

    # Transfer to the image plane.
    delta_z = -z
    dist = delta_z / cz
    x = x + dist * cx
    y = y + dist * cy
    went = (delta_z < 0) & ok
    if mask is not None:
        went = went & mask[:, n_surf - 1, None]
    if allow_backward:
        bw = bw | went
    else:
        ok = ok & ~went
    if mode == 3:
        # The final leg, in the image-space medium.
        return x, y, cx, cy, ok, bw, opl + dist * n_legs[:, n_surf, widx]
    return (x, y, cx, cy, ok, bw) + ((pth, ptp, pz) if mode else ()) + (
        (ppath, pang) if mode == 2 else ())


def trace_fused_batch_backward_reference(inputs, cotangents, penalties,
                                         allow_backward: bool, n_per_w: int, mask=None,
                                         path_bounds=(), angle_thr=0.25):
    """Plain PyTorch version of kernel K2 backward, a vectorised
    transcription of ``pallas_batch._bwd_kernel_b``: the forward recomputed
    surface by surface on (B, N) ray blocks, then K1's hand adjoint
    (``fused_trace._bwd_surface``) in reverse, one torch operation per
    rounding as the kernel does, so the per-ray cotangents agree with the
    kernel's bit for bit. The parameter cotangents are per system, summed
    over its rays in float64 and returned in float32.

    Args:
      inputs: (xp, yp, cy, z0, c, t, mu[, ref_z (full) or n_legs (opl)]) as
        for the forward.
      cotangents: (dx, dy, dcx, dcy[, dpth, dptp, dpz[, dppath, dpang]]), or
        in opl mode (dx, dy, dcx, dcy, dopl), each (B, N): the cotangents of
        the forward's float outputs.
      penalties, allow_backward, n_per_w, mask, path_bounds, angle_thr: as
        for the forward.

    Returns (dxp, dyp, dcy (B, N), dz0 (B,), dc, dt (B, S), dmu (B, S, W)
    [, dref_z (B, S+1) or dn_legs (B, S+1, W)]).
    """
    mode = _mode(penalties)
    xp, yp, cyin, z0, c, t, mu = inputs[:7]
    ref_z, n_legs = _split_extra(inputs, 7, mode)
    dx_img, dy_img, dcx_img, dcy_img = cotangents[:4]
    if _lu(mode):
        dpth, dptp, dpz = cotangents[4:7]
    if mode == 2:
        dppath, dpang = cotangents[7:9]
    dopl = cotangents[4] if mode == 3 else None
    n_sys, n = xp.shape
    n_surf, n_w = c.shape[1], mu.shape[2]
    widx = _widx(n, n_per_w, n_w, xp.device)
    mu_ray = mu[:, :, widx]                                          # (B, S, N)
    total = lambda a: torch.sum(a, dim=1, dtype=torch.float64)       # (B,)
    valid = lambda k: None if mask is None else mask[:, k, None]
    gate = ((lambda k, a: a) if mask is None
            else (lambda k, a: torch.where(mask[:, k, None], a, 0.0)))

    # Forward recompute, keeping the pre-surface states and the locals.
    x, y, cy = xp, yp, cyin
    z = z0[:, None].expand(n_sys, n)
    cx = torch.zeros_like(x)
    cz0 = torch.sqrt(1.0 - cy * cy)
    cz = cz0
    ok = torch.ones(xp.shape, dtype=torch.bool, device=xp.device)
    pres, locs, kills = [], [], []
    for k in range(n_surf):
        pres.append((x, y, z, cx, cy, cz, ok))
        (x, y, z, cx, cy, cz, ok), loc = _fwd_surface(c[:, k, None], t[:, k, None],
                                                      mu_ray[:, k], x, y, z, cx, cy, cz, ok)
        kill = None
        if not allow_backward and k > 0:
            kill = (loc["delta_z"] < 0) & loc["ok1"]
            if mask is not None:
                kill = kill & valid(k - 1)
            ok = ok & ~kill
            x, y, cx, cy = (torch.where(kill, 0.0, a) for a in (x, y, cx, cy))
            z = torch.where(kill, -t[:, k, None], z)
            cz = torch.where(kill, 1.0, cz)
        locs.append(loc)
        kills.append(kill)

    bounds = [(min(w * n_per_w, n), n if w == n_w - 1 else min((w + 1) * n_per_w, n))
              for w in range(n_w)]
    per_w = lambda v: [total(v[:, lo:hi]) for lo, hi in bounds]
    dn = [None] * (n_surf + 1)

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

    dc, dt = [None] * n_surf, [None] * n_surf
    dmu = [[None] * n_w for _ in range(n_surf)]
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
                relu_on = relu_on & valid(k)
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
            dx, dy, dz, dcx, dcy, dcz = (torch.where(kill, 0.0, a)
                                         for a in (dx, dy, dz, dcx, dcy, dcz))
        (dx, dy, dz, dcx, dcy, dcz), dc_ray, dt_ray, dmu_ray = _bwd_surface(
            c[:, k, None], mu_ray[:, k], pres[k], loc, (dx, dy, dz, dcx, dcy, dcz),
            dcos2_extra, dcos2p_extra, ddist_extra)
        dc[k] = total(dc_ray)
        dt[k] = total(dt_ray) + dt_kill
        dmu[k] = per_w(dmu_ray)

    # Launch adjoint: cz0 = sqrt(1 - cy^2), cx0 = 0 (a constant).
    dcy = dcy + dcz * (-cyin / cz0)
    f32 = lambda vals: torch.stack(vals, dim=1).to(torch.float32)
    grads = (dx.contiguous(), dy.contiguous(), dcy, total(dz).to(torch.float32),
             f32(dc), f32(dt), torch.stack([f32(row) for row in dmu], dim=1))
    if mode == 2:
        grads += (f32(dref),)
    if mode == 3:
        grads += (torch.stack([f32(row) for row in dn], dim=1),)
    return grads


# ---------------------------------------------------------------------------
# Kernel K2: the CUDA wrappers and the autograd Function.
# ---------------------------------------------------------------------------


def _check_k2_inputs(inputs, mask, n_per_w, max_surf, max_w, kernel="K2", mode=0):
    xp, yp, cy, z0, c, t, mu = inputs[:7]
    ref_z, n_legs = _split_extra(inputs, 7, mode)
    fused_trace._check_tensors(
        dict(xp=xp, yp=yp, cy=cy, z0=z0, c=c, t=t, mu=mu, ref_z=ref_z, n_legs=n_legs,
             mask=mask), xp.device, dtypes=dict(mask=torch.bool))
    if xp.ndim != 2 or yp.shape != xp.shape or cy.shape != xp.shape:
        raise ValueError(f"xp, yp, cy must be equal (B, N) blocks, got "
                         f"{tuple(xp.shape)}, {tuple(yp.shape)}, {tuple(cy.shape)}")
    n_sys, n = xp.shape
    n_surf = c.shape[-1]
    if (tuple(z0.shape) != (n_sys,) or tuple(c.shape) != (n_sys, n_surf)
            or t.shape != c.shape or mu.ndim != 3 or tuple(mu.shape[:2]) != (n_sys, n_surf)):
        raise ValueError(f"z0 must be (B,), c and t (B, S), mu (B, S, W) with B = {n_sys}, "
                         f"got {tuple(z0.shape)}, {tuple(c.shape)}, {tuple(t.shape)}, "
                         f"{tuple(mu.shape)}")
    if not 1 <= n_surf <= max_surf or not 1 <= mu.shape[2] <= max_w:
        raise ValueError(f"{kernel} takes 1..{max_surf} surfaces and 1..{max_w} "
                         f"wavelengths, got {n_surf} and {mu.shape[2]}")
    if ref_z is not None and tuple(ref_z.shape) != (n_sys, n_surf + 1):
        raise ValueError(f"ref_z must be (B, S+1) = ({n_sys}, {n_surf + 1}), "
                         f"got {tuple(ref_z.shape)}")
    if n_legs is not None and tuple(n_legs.shape) != (n_sys, n_surf + 1, mu.shape[2]):
        raise ValueError(f"n_legs must be (B, S+1, W) = ({n_sys}, {n_surf + 1}, "
                         f"{mu.shape[2]}), got {tuple(n_legs.shape)}")
    if mask is not None and tuple(mask.shape) != (n_sys, n_surf):
        raise ValueError(f"mask must be (B, S) = ({n_sys}, {n_surf}), got {tuple(mask.shape)}")
    if not 1 <= n_per_w or n >= 2 ** 31 or n_sys >= 2 ** 31:
        raise ValueError(f"bad ray block: B={n_sys}, N={n}, n_per_w={n_per_w}")


def _launch_k2_fwd(inputs, penalties, allow_backward, n_per_w, mask, path_bounds, angle_thr):
    global K2_FWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    xp, yp, cy, z0, c, t, mu = inputs[:7]
    _check_k2_inputs(inputs, mask, n_per_w, lib.k1_max_surf(), lib.k1_max_w(), mode=mode)
    ref_z, n_legs = _split_extra(inputs, 7, mode)
    ref_z, lo, hi = fused_trace._full_args(mode, ref_z, path_bounds, c.shape[1], xp.device)
    n_sys, n = xp.shape
    new = lambda dtype: torch.empty(xp.shape, dtype=dtype, device=xp.device)
    outs = [new(torch.float32) for _ in range(4)] + [new(torch.bool) for _ in range(2)]
    outs += [new(torch.float32) for _ in range(N_EXTRA_OUTS[mode])]
    pens, opl = _out_ptrs(outs, mode)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k2_fwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, t, mu, mask, ref_z, lo, hi, n_legs)),
            float(angle_thr), n_sys, n, c.shape[1], mu.shape[2], n_per_w, mode,
            int(allow_backward), *map(_ptr, outs[:6]), *pens, opl, stream)
    fused_trace._raise_on_error(lib, err, "K2 forward kernel")
    K2_FWD_LAUNCHES += 1
    K2_FWD_MODE_LAUNCHES[mode] += 1
    return tuple(outs)


def _launch_k2_bwd(inputs, cotangents, penalties, allow_backward, n_per_w, mask, path_bounds,
                   angle_thr):
    global K2_BWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    mode = _mode(penalties)
    xp, yp, cy, z0, c, t, mu = inputs[:7]
    _check_k2_inputs(inputs, mask, n_per_w, lib.k1_max_surf(), lib.k1_max_w(), mode=mode)
    ref_z, n_legs = _split_extra(inputs, 7, mode)
    ref_z, lo, hi = fused_trace._full_args(mode, ref_z, path_bounds, c.shape[1], xp.device)
    n_sys, n = xp.shape
    n_surf, n_w = c.shape[1], mu.shape[2]
    cot = _prepare_cotangents(cotangents, xp)
    n_params = 1 + 2 * n_surf + n_surf * n_w + n_extra_params(mode, n_surf, n_w)
    n_blocks = -(-n // lib.k1_bwd_block())
    new = lambda *size: torch.empty(size, dtype=torch.float32, device=xp.device)
    dxp, dyp, dcy = new(n_sys, n), new(n_sys, n), new(n_sys, n)
    params = new(n_sys, n_params)
    partials = torch.empty(n_sys * n_params * n_blocks, dtype=torch.float64, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.k2_bwd_launch(
            *map(_ptr, (xp, yp, cy, z0, c, t, mu, mask, ref_z, lo, hi, n_legs)),
            float(angle_thr), *_cot_ptrs(cot, mode), n_sys, n, n_surf, n_w, n_per_w, mode,
            int(allow_backward), *map(_ptr, (dxp, dyp, dcy, partials, params)), stream)
    fused_trace._raise_on_error(lib, err, "K2 backward kernel")
    K2_BWD_LAUNCHES += 1
    K2_BWD_MODE_LAUNCHES[mode] += 1
    off = np.cumsum([1, n_surf, n_surf, n_surf * n_w])
    grads = (dxp, dyp, dcy, params[:, 0], params[:, off[0]:off[1]], params[:, off[1]:off[2]],
             params[:, off[2]:off[3]].reshape(n_sys, n_surf, n_w))
    if mode == 2:
        grads += (params[:, off[3]:],)
    if mode == 3:
        grads += (params[:, off[3]:].reshape(n_sys, n_surf + 1, n_w),)
    return grads


class _K2(torch.autograd.Function):
    """Kernel K2 with its hand adjoint. The forward saves only the inputs;
    the backward recomputes the trace (``pallas_batch._fused_fwd_b`` /
    ``_fused_bwd_b``). ``extra`` is ref_z in full mode, n_legs in opl mode."""

    @staticmethod
    def forward(ctx, penalties, allow_backward, n_per_w, path_bounds, angle_thr, mask,
                xp, yp, cy, z0, c, t, mu, extra):
        mode = _mode(penalties)
        inputs = (xp, yp, cy, z0, c, t, mu) + ((extra,) if mode in (2, 3) else ())
        config = (penalties, allow_backward, n_per_w, mask, path_bounds, angle_thr)
        if xp.device.type == "cpu":
            ref_z, n_legs = _split_extra(inputs, 7, mode)
            outs = trace_fused_batch_reference(*inputs[:7], penalties, allow_backward,
                                               n_per_w, mask, ref_z, path_bounds, angle_thr,
                                               n_legs)
        else:
            outs = _launch_k2_fwd(inputs, *config)
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
            penalties, allow_backward, n_per_w, mask, path_bounds, angle_thr = ctx.config
            out = trace_fused_batch_backward_reference(inputs, cot, penalties, allow_backward,
                                                       n_per_w, mask, path_bounds, angle_thr)
        else:
            out = _launch_k2_bwd(inputs, cot, *ctx.config)
        return (None,) * 6 + tuple(out) + (None,) * (8 - len(out))


def _apply_k2(inputs, penalties, allow_backward, n_per_w, mask, path_bounds=(),
              angle_thr=0.25):
    if inputs[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"K2 runs on CUDA or CPU tensors, got {inputs[0].device}")
    inputs = [a.contiguous() for a in inputs]
    extra = inputs[7] if len(inputs) > 7 else None
    return _K2.apply(penalties, bool(allow_backward), int(n_per_w), tuple(path_bounds),
                     float(angle_thr), mask, *inputs[:7], extra)


def trace_fused_batch(xp, yp, cy, z0, c, t, mu, penalties: bool, allow_backward: bool,
                      n_per_w: int, mask: Optional[torch.Tensor] = None):
    """Kernel K2 on a population's (B, N) wavelength-outer ray blocks, plain
    (``penalties`` False) or Lu (True) mode; arguments and results as
    :func:`trace_fused_batch_reference`. Differentiable in all seven inputs.

    On CUDA tensors it launches the CUDA kernels (float32, one device;
    anything else raises). On CPU tensors it runs the plain versions."""
    if _mode(penalties) >= 2:
        raise ValueError("the full and opl modes need their tables: use "
                         "trace_fused_batch_full or trace_fused_batch_opl")
    return _apply_k2((xp, yp, cy, z0, c, t, mu), penalties, allow_backward, n_per_w, mask)


def trace_fused_batch_full(xp, yp, cy, z0, c, t, mu, ref_z, allow_backward: bool,
                           path_bounds, angle_thr: float, n_per_w: int,
                           mask: Optional[torch.Tensor] = None):
    """``trace_fused_batch`` with the full weighted-loss penalty set, the
    population form of ``fused_trace.trace_fused_full``: each system's
    differentiable absolute vertex positions in ``ref_z`` (B, S+1), the
    static per-gap ``path_bounds`` shared by the population. Returns the 6
    trace outputs plus (pen_theta, pen_theta_p, pen_zrelu, pen_path,
    pen_angle), each (B, N)."""
    return _apply_k2((xp, yp, cy, z0, c, t, mu, ref_z), "full", allow_backward, n_per_w,
                     mask, path_bounds, angle_thr)


def trace_fused_batch_opl(xp, yp, cy, z0, c, t, mu, n_legs, allow_backward: bool,
                          n_per_w: int, mask: Optional[torch.Tensor] = None):
    """``trace_fused_batch`` with the optical path length accumulated in the
    kernel (``pallas_batch.trace_fused_batch_opl``), the population form of
    ``fused_trace.trace_fused_opl``: each system's differentiable per-leg
    indices in ``n_legs`` (B, S+1, W); a padded gap carries n = 1 and a
    zero-length leg. Returns the 6 trace outputs plus ``opl``, each (B, N)."""
    return _apply_k2((xp, yp, cy, z0, c, t, mu, n_legs), "opl", allow_backward, n_per_w, mask)


# ---------------------------------------------------------------------------
# Front-end and packaging (wavelength-outer layout only).
# ---------------------------------------------------------------------------


def _static_mask(structure: Structure, device) -> Optional[torch.Tensor]:
    """The (B, S) surface mask as a device tensor; None when no surface is
    padded."""
    if bool(np.all(structure.mask)):
        return None
    return torch.as_tensor(structure.mask, device=device)


def _check_population(config):
    if config.double_precision:
        raise NotImplementedError(
            "the fused engine is float32-only; use trace_engine='unroll' for "
            "double_precision traces")


def prepare_fused_inputs_batch(specs, lens: Lens, config,
                               generator: Optional[torch.Generator] = None,
                               xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                               use_vig: bool = True):
    """Batched front-end, the population form of
    ``fused_trace.prepare_fused_inputs``: dispersion, pupil positions,
    sampling, vignetting, ray aiming (all B systems at once, treated as a
    constant), EPD scaling, and each system's flat wavelength-outer (W, F, P)
    ray block. The vignetting -> aiming -> EPD chain is affine in the pupil
    coordinates per (system, field, wavelength); two probes give its
    coefficients. Pupil samples ``xy`` are (Bp, 1, P, 1) with Bp in {1, B}.

    Returns (xpb, ypb, cyb (B, N), z0 (B,), mu (B, S, W), (B, F, P, W))."""
    device = lens.device
    B = len(lens)
    n = lens.get_refractive_indices(config.wavelengths)          # (B, S, W)
    n_full = torch.cat((torch.ones_like(n[:, :1, :]), n), dim=1)
    mu = n_full[:, :-1, :] / n_full[:, 1:, :]                       # (B, S, W)
    z0 = abcd_mod.compute_pupil_position(lens)                      # (B,)

    if xy is None:
        xp_rel, yp_rel = pupil_mod.sample_pupil(
            config.mode, config.n_rays, B, generator=generator, device=device)
    else:
        xp_rel, yp_rel = xy
    if (xp_rel.ndim != 4 or xp_rel.shape[0] not in (1, B) or xp_rel.shape[1] != 1
            or xp_rel.shape[3] != 1):
        raise ValueError("the fused front-end needs plain (1 or B, 1, P, 1) pupil "
                         f"samples, got {tuple(xp_rel.shape)}")
    px = xp_rel[:, 0, :, 0]                                         # (Bp, P)
    py = yp_rel[:, 0, :, 0]
    F = len(config.rel_fields)
    W = len(config.wavelengths)
    P = px.shape[1]

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

    zero = torch.zeros((B, F, 1, W), dtype=torch.float32, device=device)
    one = torch.ones((B, F, 1, W), dtype=torch.float32, device=device)
    ox, oy = chain(zero, zero)
    sx, sy = chain(one, one)
    sx = sx - ox
    sy = sy - oy
    # (B?, F, 1, W) -> (B, W, F, 1): the large P axis minor.
    wf = lambda a: a.expand(B, F, 1, W).permute(0, 3, 1, 2)
    xrel = px[:, None, None, :] * wf(sx) + wf(ox)                   # (B, W, F, P)
    yrel = py[:, None, None, :] * wf(sy) + wf(oy)
    if aiming_fn is not None:
        xrel = torch.clamp(xrel, -2.0, 2.0).detach()
        yrel = torch.clamp(yrel, -2.0, 2.0).detach()
    half_epd = specs.epd[:, None, None, None] / 2.0
    fields = torch.tensor(config.rel_fields, dtype=torch.float32, device=device)
    u = specs.hfov[:, None] * fields[None, :]
    cyb = torch.sin(u)[:, None, :, None].expand(B, W, F, P)
    return ((xrel * half_epd).reshape(B, -1), (yrel * half_epd).reshape(B, -1),
            cyb.reshape(B, -1), z0, mu, (B, F, P, W))


def package_fused_result_batch(outs, shape, penalties: bool):
    """Package flat (B, N) (W, F, P)-ordered kernel outputs as the
    (B, F, P, W) ``TraceResult`` (plus the penalty sums when ``penalties``)."""
    B, F, P, W = shape
    pack = lambda a: a.reshape(B, W, F, P).permute(0, 2, 3, 1)
    result = trace_mod.TraceResult(*(pack(a) for a in outs[:6]), None)
    if penalties:
        return result, tuple(pack(p) for p in outs[6:])
    return result


def _trace_population(xpb, ypb, cyb, z0, mu, lens: Lens, config, penalties, n_per_w,
                      ref_z=None, path_bounds=(), angle_thr=0.25):
    """One launch on a population's prepared (B, N) rays: K2 for a
    spherical population, K4 (``ops.fused_asphere``) for one whose lens
    carries ``kappa`` or ``asph`` (an absent one as zeros), as
    ``pallas_batch.batched_unsupervised_loss`` dispatches; ``penalties``
    False, True or "full" (with ``ref_z``, ``path_bounds``, ``angle_thr``)."""
    mask = _static_mask(lens.structure, lens.device)
    full = _mode(penalties) == 2
    if lens.is_spherical:
        if full:
            return trace_fused_batch_full(xpb, ypb, cyb, z0, lens.c, lens.t, mu, ref_z,
                                          config.allow_backward_rays, path_bounds, angle_thr,
                                          n_per_w, mask)
        return trace_fused_batch(xpb, ypb, cyb, z0, lens.c, lens.t, mu, penalties,
                                 config.allow_backward_rays, n_per_w, mask)
    from torchoptics_tpu_torch.ops import fused_asphere
    lens = fused_asphere.with_asphere_terms(lens)
    args = (xpb, ypb, cyb, z0, lens.c, lens.kappa, lens.t, mu, lens.asph)
    if full:
        return fused_asphere.trace_fused_asphere_batch_full(
            *args, ref_z, config.allow_backward_rays, path_bounds, angle_thr, n_per_w,
            config.newton_iters, mask)
    return fused_asphere.trace_fused_asphere_batch(
        *args, penalties, config.allow_backward_rays, n_per_w, config.newton_iters, mask)


def trace_rays_fused_batch(specs, lens: Lens, config,
                           generator: Optional[torch.Generator] = None,
                           xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           penalties: bool = False, use_vig: bool = True):
    """``trace_rays`` on kernel K2 (B >= 1 spherical systems) or K4 (B >= 1
    conic/asphere systems, an absent ``kappa`` or ``asph`` as zeros); a
    padded population of mixed lens types through its surface mask. Returns
    a ``TraceResult`` shaped (B, F, P, W); with ``penalties`` it returns
    ``(TraceResult, (pen_theta, pen_theta_p, pen_zrelu))``, each the per-ray
    sum over a system's real surfaces."""
    _check_population(config)
    xpb, ypb, cyb, z0, mu, shape = prepare_fused_inputs_batch(
        specs, lens, config, generator=generator, xy=xy, use_vig=use_vig)
    _, F, P, _ = shape
    outs = _trace_population(xpb, ypb, cyb, z0, mu, lens, config, penalties, F * P)
    return package_fused_result_batch(outs, shape, penalties)


def optical_paths_fused_batch(specs, lens: Lens, config,
                              generator: Optional[torch.Generator] = None,
                              xy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """``wavefront.optical_path_lengths`` on kernel K2's opl mode (B >= 1
    spherical systems, float32; ``pallas_batch.optical_paths_fused_batch``),
    a padded population of mixed lens types through its surface mask: returns
    (TraceResult, OPL) with OPL (B, F, P, W) in mm, launch phase included."""
    if not lens.is_spherical:
        raise ValueError("K2's opl mode is spherical; a conic/asphere population goes "
                         "through fused_asphere.optical_paths_fused_asphere_batch")
    _check_population(config)
    xpb, ypb, cyb, z0, mu, shape = prepare_fused_inputs_batch(
        specs, lens, config, generator=generator, xy=xy)
    _, F, P, _ = shape
    outs = trace_fused_batch_opl(xpb, ypb, cyb, z0, lens.c, lens.t, mu,
                                 fused_trace.leg_indices(lens, config.wavelengths),
                                 config.allow_backward_rays, F * P,
                                 _static_mask(lens.structure, lens.device))
    return (package_fused_result_batch(outs[:6], shape, False),
            fused_trace.package_opl(outs[6], ypb, cyb, shape))


# ---------------------------------------------------------------------------
# Spot reductions on the flat wavelength-outer layout, and the losses.
# ---------------------------------------------------------------------------


def rms2d_flat_wouter_batch(y_flat, ok_flat, F, P, W):
    """``metrics.compute_rms2d`` on flat (B, N) wavelength-outer outputs (see
    ``fused_trace.rms2d_flat_wouter``); returns per-system RMS, (B,)."""
    B = y_flat.shape[0]
    y4 = y_flat.reshape(B, W, F, P)
    ok4 = ok_flat.reshape(B, W, F, P)
    ycent = torch.mean(y4, dim=3)                    # (B, W, F)
    ymean = torch.mean(ycent, dim=1)                 # (B, F)
    dev2 = torch.where(ok4, (y4 - ymean[:, None, :, None]) ** 2, 0.0)
    ss = torch.sum(dev2, dim=(1, 3))                 # (B, F)
    pos = ss > 0
    rms_f = torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / (P * W)), 0.0)
    return torch.mean(rms_f, dim=1)


def spot_rms_xy_flat_wouter_batch(x_flat, y_flat, ok_flat, F, P, W):
    """``metrics.compute_spot_rms_xy`` field-mean on flat (B, N)
    wavelength-outer outputs (see ``fused_trace.spot_rms_xy_flat_wouter``);
    returns (B,)."""
    B = x_flat.shape[0]
    x4 = x_flat.reshape(B, W, F, P)
    y4 = y_flat.reshape(B, W, F, P)
    ok4 = ok_flat.reshape(B, W, F, P)
    w = ok4.to(x4.dtype)
    count = torch.clamp(torch.sum(w, dim=(1, 3)), min=1.0)          # (B, F)
    xc = torch.sum(x4 * w, dim=(1, 3)) / count
    yc = torch.sum(y4 * w, dim=(1, 3)) / count
    d2 = (x4 - xc[:, None, :, None]) ** 2 + (y4 - yc[:, None, :, None]) ** 2
    ss = torch.sum(torch.where(ok4, d2, 0.0), dim=(1, 3))           # (B, F)
    pos = ss > 0
    rms_f = torch.where(pos, torch.sqrt(torch.where(pos, ss, 1.0) / count), 0.0)
    return torch.mean(rms_f, dim=1)


def spot_rms_flat_wouter_batch(outs, F, P, W, spot_metric: str = "y"):
    """The per-system spot reduction on flat (B, N) kernel outputs: ``'y'`` =
    ``rms2d_flat_wouter_batch``; ``'xy'`` = ``spot_rms_xy_flat_wouter_batch``.
    Returns (B,)."""
    if spot_metric == "y":
        return rms2d_flat_wouter_batch(outs[1], outs[4], F, P, W)
    if spot_metric == "xy":
        return spot_rms_xy_flat_wouter_batch(outs[0], outs[1], outs[4], F, P, W)
    raise ValueError(f"spot metric must be 'y' or 'xy', got {spot_metric!r}")


def _lu_terms(outs, lens: Lens, config, shape):
    """Per-system (rms, ΣQ, Lu), each (B,): Q normalized by each system's own
    surface count."""
    _, F, P, W = shape
    pth, ptp, pz = outs[6:9]
    rms = spot_rms_flat_wouter_batch(outs, F, P, W, config.spot_metric)
    n_seq = torch.as_tensor(lens.structure.n_surfaces, dtype=rms.dtype, device=rms.device)
    sum_q = (torch.sum(pth, dim=1) + torch.sum(ptp, dim=1) + torch.sum(pz, dim=1)) / n_seq
    return rms, sum_q, rms + config.penalty_rate * sum_q


def batched_compute_losses_fused(specs, lens: Lens, config, g=None, catalog_g=None,
                                 generator: Optional[torch.Generator] = None):
    """The full weighted loss (spot + ray-path + ray-angle + glass + Lu) of a
    homogeneous population on one launch of K2's full mode (K4's for
    conic/asphere systems); the population form of
    ``fused_trace.compute_losses_fused``. The hinge terms
    are means over all (B, F, P, W) rays, the Lu terms means over systems.
    ``config`` is a ``simulator.SimulatorConfig``. Returns (total, loss_dict)."""
    from torchoptics_tpu_torch import simulator as sim_mod

    cfg = config.trace_config()
    if len(set(lens.structure.sequence)) != 1:
        raise ValueError("batched fused full loss expects a homogeneous population (one "
                         "lens type); simulator.compute_losses groups mixed ones")
    _check_population(cfg)
    bounds = fused_trace._path_bounds(lens.structure, config.ray_path_lower_thresholds,
                                      config.ray_path_upper_thresholds)
    angle_thr = math.cos(math.radians(config.ray_angle_threshold)) ** 2
    xpb, ypb, cyb, z0, mu, shape = prepare_fused_inputs_batch(specs, lens, cfg,
                                                              generator=generator)
    B, F, P, W = shape
    vertex_z = torch.cumsum(lens.t, dim=1)                           # (B, S)
    ref_z = torch.cat((vertex_z, vertex_z[:, -1:]), dim=1)
    outs = _trace_population(xpb, ypb, cyb, z0, mu, lens, cfg, "full", F * P, ref_z, bounds,
                             angle_thr)
    ppath, pang = outs[9:11]
    rms, sum_q, lu = _lu_terms(outs, lens, config, shape)
    n_rays = B * F * P * W
    loss_dict = {
        "loss_unsup": torch.mean(lu), "rms": torch.mean(rms), "penalty": torch.mean(sum_q),
        "spot_size": torch.mean(rms),
        "ray_path": torch.sum(ppath) / n_rays,
        "ray_angle": torch.sum(pang) / n_rays,
    }
    if g is not None:
        loss_dict["glass"] = sim_mod.compute_glass_penalty(lens.structure, g, catalog_g)
    total = sum(loss_dict[k] * w for k, w in config.loss_weights.items()
                if k in loss_dict and w is not None)
    return total, loss_dict


def batched_unsupervised_loss(specs, lens: Lens, config,
                              generator: Optional[torch.Generator] = None):
    """The unsupervised loss Lu of a whole population on one launch of K2's
    Lu mode (K4's for conic/asphere systems): the generator-training loss.
    Padded populations of mixed lens types normalize each system's Q by its
    own surface count. ``config`` is a ``simulator.SimulatorConfig``.

    Returns (mean Lu, {"loss_unsup", "rms", "penalty"}, each (B,))."""
    cfg = config.trace_config()
    _check_population(cfg)
    xpb, ypb, cyb, z0, mu, shape = prepare_fused_inputs_batch(specs, lens, cfg,
                                                              generator=generator)
    _, F, P, _ = shape
    outs = _trace_population(xpb, ypb, cyb, z0, mu, lens, cfg, True, F * P)
    rms, sum_q, lu = _lu_terms(outs, lens, config, shape)
    return torch.mean(lu), {"loss_unsup": lu, "rms": rms, "penalty": sum_q}
