"""The Newton solve of kernels K3 and K4 leaves a lane as soon as its steps
repeat (``fused_asphere.newton_point_with_exit``, the plain form of
``newton_point`` in ``csrc/asphere_common.cuh``). The exit is exact: a
Newton step is a function of s alone, so a fixed point or a 2-cycle fixes
every later step. Here, on the CPU, the exit written over the plain
``_f_fp`` gives the bits of ``_newton_point``'s fixed count of steps at every
surface of the aspherized double-Gauss and of its c x 3 variant (which fails
rays at the sag-domain guard and in non-convergence), for several step
counts, and both exits occur. Also: the backward's sag partials, which
share reciprocals where they divided, stay within a few float32 roundings
of their closed forms, and the surface adjoint built on them (with the
polish step's one reciprocal) is as accurate as the quotient form it
replaced, against that form in float64.
"""

import numpy as np
import pytest
import torch

from torchoptics_tpu_torch import simulator, zoo
from torchoptics_tpu_torch.ops import fused_asphere, fused_trace

# 8 fields x 16^2 pupil x 3 wavelengths = 6,144 rays.
CONFIG = dict(n_sampled_fields=8, n_pupil_rings=16, pupil_sampling="circular",
              n_ray_aiming_iter=1)
N_ITERS = (0, 1, 2, 3, 10, 17)


def _surface_states(c_scale):
    """Per surface: its parameters (c, kappa, mu per ray, the asphere
    coefficients), the pre-surface ray state and the locals of the plain
    forward (10 Newton steps), on the aspherized double-Gauss."""
    specs, lens = zoo.build("double_gauss_asph", device="cpu")
    lens = lens.replace(c=lens.c * c_scale)
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_trace.prepare_fused_inputs(specs, lens, cfg)
        inputs = fused_asphere._one((xp, yp, cyb, z0, lens.c[0], lens.kappa[0], lens.t[0], mu,
                                     lens.asph[0]))
        c, kappa, mu, asph = inputs[4], inputs[5], inputs[7], inputs[8]
        mu_ray = mu[:, :, fused_asphere._widx(xp.shape[0], F * P, mu.shape[2], xp.device)]
        states = []

        def keep(k, pre, loc, kill, post):
            params = (c[:, k, None], kappa[:, k, None], mu_ray[:, k],
                      [asph[:, k, j, None] for j in range(asph.shape[2])])
            states.append((params, pre, loc))
        fused_asphere._trace_batch(*inputs, True, F * P, 10, keep)
    return states


@pytest.fixture(scope="module")
def states():
    return {c_scale: _surface_states(c_scale) for c_scale in (1.0, 3.0)}


@pytest.mark.parametrize("c_scale", [1.0, 3.0])
@pytest.mark.parametrize("n_iter", N_ITERS)
def test_exit_gives_the_bits_of_every_step(states, c_scale, n_iter):
    periods = torch.zeros(3, dtype=torch.int64)
    for (c, kappa, _, a), pre, loc in states[c_scale]:
        want = fused_asphere._newton_point(c, kappa, a, *pre[:6], n_iter)
        got, steps, period = fused_asphere.newton_point_with_exit(c, kappa, a, *pre[:6], n_iter)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        if n_iter == 10:
            assert torch.equal(want.view(torch.int32), loc["s_pre"].view(torch.int32))
        assert bool(((steps >= 1) & (steps <= n_iter)).all()) or n_iter == 0
        assert bool((steps[period == 0] == n_iter).all())
        periods += torch.bincount(period.reshape(-1).long(), minlength=3)
    if n_iter >= 10:
        # Both exits are taken, so both branches are held to the bits.
        assert periods[1] > 0 and periods[2] > 0, periods


def test_g_partials_reciprocal_form_is_accurate():
    """The backward's sag partials (``_g_partials``, the kernels' form: one
    reciprocal of w and one of 1 + w, and products) within 4 float32 ulps,
    relative (4 * 2^-23 of the value), of the closed forms evaluated in
    float64 on the same float32 inputs and per-surface constants ((1+kappa)
    c^2, c (1+kappa) c^2, c^3), over r^2 from 0 up to the sag-domain guard,
    on curvatures and conic constants of the zoo's range (kappa > -1)."""
    rng = np.random.default_rng(0)
    n = 100_000
    c = torch.tensor(rng.uniform(-0.2, 0.2, n), dtype=torch.float32)
    kappa = torch.tensor(rng.uniform(-0.9, 1.0, n), dtype=torch.float32)
    beta = (1.0 + kappa) * c * c
    r2 = (torch.tensor(rng.uniform(0.0, 1.0, n), dtype=torch.float32) * (1.0 - 2e-6)
          / beta).float()
    u = beta * r2
    guard = 1.0 - u < fused_asphere.EPS
    assert not bool(guard.any())
    w = torch.sqrt(1.0 - u)
    got = fused_asphere._g_partials(c, kappa, [], r2, w, u)
    d = lambda v: v.double()
    cbeta, c3, r2d, wd, ud = d(c * beta), d(c * c * c), d(r2), d(w), d(u)
    want = (cbeta / (4 * wd ** 3), 1 / (2 * wd) + ud / (2 * wd ** 3), c3 * r2d / (4 * wd ** 3),
            r2d / (1 + wd) + ud * r2d / (wd * (1 + wd) ** 2),
            c3 * r2d * r2d / (2 * wd * (1 + wd) ** 2))
    for name, g, ref in zip(("h", "g_c", "g_kap", "sag_c", "sag_kap"), got, want):
        rel = float(((d(g) - ref).abs() / ref.abs().clamp(min=1e-300)).max())
        assert rel <= 4 * 2.0 ** -23, (name, rel / 2.0 ** -23)


def _g_partials_quotient(c, kappa, a, r2, w, u):
    """``_g_partials`` as quotients, the form the reciprocals replaced."""
    beta = (1.0 + kappa) * c * c
    w3 = w * w * w
    h = c * beta / (4.0 * w3)
    g_c = 1.0 / (2.0 * w) + u / (2.0 * w3)
    g_kap = c * c * c * r2 / (4.0 * w3)
    opw = 1.0 + w
    sag_c = r2 / opw + u * r2 / (w * opw * opw)
    sag_kap = c * c * c * r2 * r2 / (2.0 * w * opw * opw)
    p = fused_asphere._powers(r2, len(a))
    for k, ak in enumerate(a):
        term = ak * (k + 2.0) * (k + 1.0)
        h = h + (term if k == 0 else term * p[k])
    return h, g_c, g_kap, sag_c, sag_kap


def _polish_adjoint_quotient(ddist, f, fp_safe, stationary):
    """``_polish_adjoint`` as quotients, the form the reciprocal replaced."""
    return -ddist / fp_safe, torch.where(stationary, 0.0, ddist * f / (fp_safe * fp_safe))


def _surface_adjoint(params, pre, loc, cot, quotients, dtype):
    """``_bwd_surface_a``'s per-ray cotangents (the pre-surface state's six,
    dc, dkappa, dt, dmu, da_j) in ``dtype``, with the quotient forms of the
    sag partials and the polish step where ``quotients`` is set."""
    cast = lambda v: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
    c, kappa, mu, a = params
    with pytest.MonkeyPatch.context() as patch:
        if quotients:
            patch.setattr(fused_asphere, "_g_partials", _g_partials_quotient)
            patch.setattr(fused_asphere, "_polish_adjoint", _polish_adjoint_quotient)
        d_pre, dc, dkap, dt, dmu, da = fused_asphere._bwd_surface_a(
            cast(c), cast(kappa), cast(mu), [cast(v) for v in a], tuple(map(cast, pre)),
            {name: cast(v) for name, v in loc.items()}, [cast(v) for v in cot[:6]],
            *[cast(v) for v in cot[6:]])
    return [*d_pre, dc, dkap, dt, dmu, *da]


@pytest.mark.parametrize("c_scale", [1.0, 3.0])
def test_surface_adjoint_reciprocal_form_is_accurate(states, c_scale):
    """The plain backward's surface adjoint (``_bwd_surface_a``, the
    reciprocal forms of the kernels K3 and K4 backward) against the quotient
    forms evaluated in float64 on the same float32 inputs: at every surface,
    for every per-ray and parameter cotangent, under random post-surface,
    penalty and path-length cotangents, no ray's error exceeds the error of
    the quotient forms in float32 by more than 2 float32 ulps of the
    cotangent's largest magnitude at that surface (2 * 2^-23 of it). On the
    c x 3 variant both forms lose ~270 of those ulps against float64 on one
    ray whose Newton point lies near the edge of the sag's domain
    (1 - u ~ 0.008), where the rounding of the recomputed u is amplified
    alike in either."""
    rng = np.random.default_rng(1)
    for params, pre, loc in states[c_scale]:
        n = pre[0].shape[1]
        cot = [torch.tensor(rng.standard_normal((1, n)), dtype=torch.float32) for _ in range(9)]
        new = _surface_adjoint(params, pre, loc, cot, False, torch.float32)
        old = _surface_adjoint(params, pre, loc, cot, True, torch.float32)
        ref = _surface_adjoint(params, pre, loc, cot, True, torch.float64)
        for got, was, want in zip(new, old, ref):
            ulp = float(want.abs().max()) * 2.0 ** -23
            excess = (got.double() - want).abs() - (was.double() - want).abs()
            assert float(excess.max()) <= 2 * ulp, float(excess.max()) / ulp
