"""Port parity for kernel K3's module, ``ops.fused_asphere``, and the fused
engine's ``trace_rays`` on a conic/asphere system (the losses and the
optimizer step on it are held against JAX by
``test_torch_asphere_training.py``).

The same flat wavelength-outer inputs (the port's front-end on the Cooke
triplet with the aspheres of ``test_pallas_asphere.py``, 3 fields x 8²
circular pupil x 3 wavelengths, 1 ray-aiming iteration, as numpy) and the
same seeded cotangents go through:

* ``trace_fused_asphere_reference`` and
  ``trace_fused_asphere_backward_reference`` (the plain versions of the CUDA
  kernels), against JAX's jnp engine (``trace_skew``, its scan form, jitted)
  and its ``jax.vjp`` in both backward-ray policies, and against JAX's Pallas
  K3 (``trace_fused_asphere_full`` and its vjp, interpret mode, jitted) with
  backward rays flagged. One Pallas vjp serves the three modes: its Lu and
  plain adjoints are that vjp with the hinge cotangents, then all five
  penalty cotangents, set to zero. Tight path and angle bounds, so that both
  hinges fire.
* the hand adjoint against ``torch.autograd.grad`` through the plain forward
  (whose Newton steps are constants of the derivative), an independent
  check that it is the derivative.

Bars: coordinates on rays ok in both within 5e-6 mm + 1e-6 relative; masks
identical; penalty sums within 1e-5 + 4e-6 relative (sums of 7 terms of up
to ~60 mm); cotangents within 1e-4 of each one's largest magnitude. Against
the Pallas kernel each value may also deviate by JAX's own jnp-vs-Pallas
distance: interpret mode rounds differently, its theta_norm takes a
polynomial arccos, and its launch adjoint reads the traced cy where the
launch cy belongs (ROADMAP queue 3). The plain version writes the sag's
slope as the Pallas kernel does, JAX's jnp engine in another form, and their
cos² differ by up to ~7 ulps (4e-7); near normal incidence theta_norm
amplifies that by |d theta/d cos²| ~ 1e2-1e3 (``_theta_sensitivity``). So
the theta sums are also allowed 1e-6 x the sum of that factor over the
surfaces, and rays where it exceeds 20 at some surface (within ~1e-4 of
normal incidence) get no theta cotangent against JAX (the clip edge of
``test_torch_fused_backward.py`` is the extreme of the same effect).

The CUDA kernels are held against the plain versions on a GPU by
``test_torch_kernels_cuda.py``.
"""

import dataclasses
import functools
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu.ops import pallas_asphere as jpa
from torchoptics_tpu.ops import trace as jtrace_mod
from torchoptics_tpu_torch import simulator, trace, zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, fused_trace
from test_torch_asphere import asphere_cooke, port

CONFIG = dict(n_sampled_fields=3, n_pupil_rings=8, pupil_sampling="circular",
              n_ray_aiming_iter=1)
N_PER_W = 3 * 8 * 8
TIGHT = dict(ray_path_lower_thresholds=(0.5, 1.5, 12.0),
             ray_path_upper_thresholds=(None, 3.0, 40.0), ray_angle_threshold=30.0)
THR = math.cos(math.radians(30.0)) ** 2
MODES = [False, True, "full"]
N_COT = {False: 4, True: 7, "full": 9}
BAR = 1e-4
LABELS = ("dxp", "dyp", "dcy", "dz0", "dc", "dkappa", "dt", "dmu", "dasph", "dref_z")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jnp_outputs(bounds, allow_backward, xp, yp, cyb, z0, c, kappa, t, mu, asph, ref_z):
    """K3's eleven outputs in full mode from JAX's jnp engine and its stacks,
    the sums accumulated surface by surface in the kernel's order."""
    n, n_surf = xp.shape[0], c.shape[0]
    widx = np.minimum(np.arange(n) // N_PER_W, mu.shape[1] - 1)
    col = lambda a: a.reshape(1, 1, -1, 1)
    surf = lambda a: a.reshape(1, 1, 1, 1, n_surf)
    res = jtrace_mod.trace_skew(
        col(xp), col(yp), z0.reshape(1, 1, 1, 1), jnp.zeros((1, 1, 1, 1)), col(cyb),
        surf(c), surf(t), mu[:, widx].T.reshape(1, 1, n, 1, n_surf),
        jnp.ones((1, 1, 1, 1, n_surf), bool), kappa=surf(kappa),
        asph=asph.reshape(1, 1, 1, 1, n_surf, -1),
        aggregate=("z", "cos2", "cos2_prime") + jtrace_mod.AGG_TORCH,
        allow_backward_rays=allow_backward, engine="scan")
    stack = lambda k: [a.reshape(n) for a in res.stacks[k]]
    sums = []
    for k in ("theta_norm", "theta_prime_norm", "z_RELU"):
        total = jnp.zeros(n)
        for term in stack(k):
            total = total + term
        sums.append(total)
    z, cos2, cos2p = stack("z"), stack("cos2"), stack("cos2_prime")
    path = jnp.zeros(n)
    ang = jnp.zeros(n)
    hinge = lambda d, lo, hi: ((jnp.maximum(lo - d, 0.0) if lo != -math.inf else 0.0)
                               + (jnp.maximum(d - hi, 0.0) if hi != math.inf else 0.0))
    for k in range(n_surf):
        ang = ang + jnp.maximum(THR - cos2[k], 0.0) + jnp.maximum(THR - cos2p[k], 0.0)
        if k > 0:
            path = path + hinge((z[k] + ref_z[k]) - (z[k - 1] + ref_z[k - 1]), *bounds[k - 1])
    path = path + hinge(ref_z[n_surf] - (z[n_surf - 1] + ref_z[n_surf - 1]), *bounds[n_surf - 1])
    return tuple(a.reshape(n) for a in res[:6]) + tuple(sums) + (path, ang)


def _theta_sensitivity(inputs):
    """Per ray, from the plain forward's locals: the sum and the largest over
    the surfaces of |d theta_norm/d cos²| = 1/(pi u sqrt(1 - u²)),
    u = sqrt(cos²), for cos² and cos²' (0 where the clip holds theta). Near
    normal incidence it reaches ~1e3 and passes on the few ulps by which the
    plain version's cos² (the slope as the Pallas kernel writes it) and JAX's
    jnp engine's (another form of it) differ."""
    xp, yp, cy, z0, c, kappa, t, mu, asph = inputs[:9]
    total = torch.zeros(xp.shape, dtype=torch.float64)
    largest = torch.zeros(xp.shape, dtype=torch.float64)

    def keep(k, pre, loc, kill, post):
        nonlocal total, largest
        for v in (loc["cos2"], loc["cos2p"]):
            u = torch.sqrt(torch.clamp(v.double(), min=1e-12))
            active = (u < 1.0 - 1e-7) & (v > 0)
            sens = torch.where(active, 1.0 / (math.pi * u * torch.sqrt(
                torch.where(active, 1.0 - u * u, 1.0))), 0.0)
            total = total + sens
            largest = torch.maximum(largest, sens)
    fused_asphere._trace(xp, yp, cy, z0, c, kappa, t, mu, asph, True, N_PER_W, 10, keep)
    return total.numpy(), largest.numpy()


def _pallas_vjp(bounds, inputs, cot):
    """The Pallas K3 in full mode (interpret mode, backward rays flagged) and
    its vjp, lowered for these argument shapes."""
    fwd = functools.partial(jpa.trace_fused_asphere_full, allow_backward=True,
                            path_bounds=bounds, angle_thr=THR, n_per_w=N_PER_W)

    def run(inputs, cot):
        outs, vjp = jax.vjp(lambda *a: fwd(*a), *inputs)
        none = np.zeros(outs[4].shape, jax.dtypes.float0)
        return outs, vjp(tuple(list(cot[:4]) + [none, none] + list(cot[4:])))
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(run).lower(inputs, cot)


@pytest.fixture(scope="module")
def jax_side():
    jspecs, jlens = asphere_cooke()
    specs, lens = port(jspecs, jlens)
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    xp, yp, cyb, z0, mu, shape = fused_trace.prepare_fused_inputs(specs, lens, cfg)
    assert shape[1] * shape[2] == N_PER_W
    arrays = [a.detach().numpy() for a in (xp, yp, cyb, z0, lens.c[0], lens.kappa[0],
                                           lens.t[0], mu, lens.asph[0])]
    vertex_z = np.cumsum(arrays[6], dtype=np.float32)
    ref_z = np.concatenate((vertex_z, vertex_z[-1:]))
    bounds = fused_trace._path_bounds(lens.structure, TIGHT["ray_path_lower_thresholds"],
                                      TIGHT["ray_path_upper_thresholds"])
    n = arrays[0].shape[0]
    rng = np.random.default_rng(0)
    cot = [rng.standard_normal(n).astype(np.float32) for _ in range(9)]
    sens_sum, sens_max = _theta_sensitivity([torch.tensor(a) for a in arrays])
    # Against JAX, no theta cotangent on rays within ~1e-4 of normal
    # incidence at some surface (|d theta/d cos²| > 20): there the theta
    # adjoint itself moves by ~1e-3 relative per ulp of cos².
    near_normal = sens_max > 20.0
    cot_jax = [np.where(near_normal, 0.0, a).astype(np.float32) if i in (4, 5) else a
               for i, a in enumerate(cot)]
    kept = lambda p: cot_jax[:N_COT[p]] + [np.zeros(n, np.float32)] * (9 - N_COT[p])
    keep = lambda p: 10 if p == "full" else 9
    args = arrays + [ref_z]
    out = dict(inputs=arrays, ref_z=ref_z, bounds=bounds, cot=cot, cot_jax=cot_jax, jnp={},
               theta_tol=1e-6 * sens_sum)

    # XLA compiles without the GIL: the Pallas program compiles on a thread
    # while the jnp engine's vjps run here.
    with ThreadPoolExecutor(1) as pool:
        pallas = pool.submit(_pallas_vjp(bounds, args, kept("full")).compile,
                             compiler_options=FAST_COMPILE)
        for ab in (True, False):
            outs, vjp = jax.vjp(functools.partial(_jnp_outputs, bounds, ab),
                                *map(jnp.asarray, args))
            none = np.zeros(n, jax.dtypes.float0)
            out["jnp"][ab] = ([np.asarray(o) for o in outs],
                              {p: [np.asarray(a) for a in vjp(tuple(
                                  kept(p)[:4] + [none, none] + kept(p)[4:]))][:keep(p)]
                               for p in MODES})
        pallas = pallas.result()
    # One run at a time: the interpret mode's callbacks share state.
    out["pallas"] = {}
    for p in MODES:
        outs, grads = pallas(args, kept(p))
        out["pallas_outs"] = [np.asarray(o) for o in outs]
        out["pallas"][p] = [np.asarray(a) for a in grads][:keep(p)]
    return out


def _torch_inputs(ref, penalties, requires_grad=False):
    ins = [torch.tensor(a) for a in ref["inputs"]]
    if penalties == "full":
        ins.append(torch.tensor(ref["ref_z"]))
    return [a.requires_grad_(requires_grad) for a in ins]


def _assert_rel_close(got, want, label, bar=BAR, slack=0.0):
    """|got - want| <= bar x max|want| + slack, elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(np.abs(want).max(), 1e-30)
    excess = np.abs(got - want) - slack
    assert excess.max() <= bar * scale, (
        f"{label}: max deviation beyond the slack {excess.max() / scale:.3e} of the largest "
        f"magnitude (bar {bar})")


def _assert_forward_close(got, want, slack=None, theta_tol=None):
    """Masks identical; coordinates on rays ok in both within 5e-6 + 1e-6
    relative; penalty sums within 1e-5 + 4e-6 relative, the theta sums also
    within ``theta_tol`` per ray; each widened by ``slack`` where given."""
    got = [a.detach().numpy() for a in got]
    np.testing.assert_array_equal(got[4], want[4], err_msg="ray_ok")
    ok = got[4] & want[4]
    floats = [i for i in range(len(got)) if i not in (4, 5)]
    for i in floats:
        w = np.asarray(want[i], np.float64)
        sel = ok if i < 4 else np.ones_like(ok)
        tol = (5e-6 + 1e-6 * np.abs(w)) if i < 4 else (1e-5 + 4e-6 * np.abs(w))
        if theta_tol is not None and i in (6, 7):
            tol = tol + theta_tol
        if slack is not None:
            tol = tol + slack[i]
        bad = sel & ~(np.abs(got[i] - w) <= tol)
        assert not bad.any(), (f"output {i}: {int(bad.sum())} rays out of tolerance, max "
                               f"excess {np.max((np.abs(got[i] - w) - tol)[sel])}")


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_reference_matches_jax_engine(penalties, allow_backward, jax_side):
    ins = _torch_inputs(jax_side, "full")
    got = fused_asphere.trace_fused_asphere_reference(
        *ins[:9], penalties, allow_backward, N_PER_W, 10, ins[9], jax_side["bounds"], THR)
    assert len(got) == {False: 6, True: 9, "full": 11}[penalties]
    want = jax_side["jnp"][allow_backward][0][:len(got)]
    np.testing.assert_array_equal(got[5].numpy(), want[5], err_msg="ray_backward")
    _assert_forward_close(got, want, theta_tol=jax_side["theta_tol"])
    if penalties == "full":
        assert got[9].mean() > 0 and got[10].mean() > 0, "both hinges must fire"


@pytest.mark.parametrize("penalties", MODES)
def test_reference_matches_pallas_kernel(penalties, jax_side):
    ins = _torch_inputs(jax_side, "full")
    got = fused_asphere.trace_fused_asphere_reference(
        *ins[:9], penalties, True, N_PER_W, 10, ins[9], jax_side["bounds"], THR)
    pallas = jax_side["pallas_outs"][:len(got)]
    np.testing.assert_array_equal(got[5].numpy(), pallas[5], err_msg="ray_backward")
    jnp_outs = jax_side["jnp"][True][0][:len(got)]
    slack = [None if i in (4, 5) else np.abs(np.asarray(j, np.float64) - p)
             for i, (j, p) in enumerate(zip(jnp_outs, pallas))]
    _assert_forward_close(got, pallas, slack, theta_tol=jax_side["theta_tol"])


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_backward_reference_matches_jax_vjp(penalties, allow_backward, jax_side):
    ins = _torch_inputs(jax_side, penalties)
    cot = [torch.tensor(a) for a in jax_side["cot_jax"][:N_COT[penalties]]]
    got = fused_asphere.trace_fused_asphere_backward_reference(
        ins, cot, penalties, allow_backward, N_PER_W, 10, jax_side["bounds"], THR)
    jnp_want = jax_side["jnp"][allow_backward][1][penalties]
    assert len(got) == len(jnp_want) == (10 if penalties == "full" else 9)
    for g, j, label in zip(got, jnp_want, LABELS):
        _assert_rel_close(g.numpy(), j, label)
    if allow_backward:
        for g, w, j, label in zip(got, jax_side["pallas"][penalties], jnp_want, LABELS):
            _assert_rel_close(g.numpy(), w, label, slack=np.abs(j.astype(np.float64) - w))


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_backward_reference_matches_autograd(penalties, allow_backward, jax_side):
    ins = _torch_inputs(jax_side, penalties, requires_grad=True)
    cot = [torch.tensor(a) for a in jax_side["cot"][:N_COT[penalties]]]
    outs = fused_asphere.trace_fused_asphere_reference(
        *ins[:9], penalties, allow_backward, N_PER_W, 10,
        ins[9] if penalties == "full" else None, jax_side["bounds"], THR)
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    want = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    got = fused_asphere.trace_fused_asphere_backward_reference(
        [a.detach() for a in ins], cot, penalties, allow_backward, N_PER_W, 10,
        jax_side["bounds"], THR)
    for g, w, label in zip(got, want, LABELS):
        _assert_rel_close(g.numpy(), w.numpy(), label)


def test_function_runs_the_plain_versions_on_cpu(jax_side):
    """The autograd Function on CPU tensors: forward equal to the plain
    version, backward equal to the backward plain version, no launch."""
    before = (fused_asphere.K3_FWD_LAUNCHES, fused_asphere.K3_BWD_LAUNCHES)
    ins = _torch_inputs(jax_side, "full", requires_grad=True)
    outs = fused_asphere.trace_fused_asphere_full(*ins, True, jax_side["bounds"], THR, N_PER_W)
    want = fused_asphere.trace_fused_asphere_reference(
        *[a.detach() for a in ins[:9]], "full", True, N_PER_W, 10, ins[9].detach(),
        jax_side["bounds"], THR)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert not outs[4].requires_grad and not outs[5].requires_grad
    cot = [torch.tensor(a) for a in jax_side["cot"][:9]]
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    grads = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    hand = fused_asphere.trace_fused_asphere_backward_reference(
        [a.detach() for a in ins], cot, "full", True, N_PER_W, 10, jax_side["bounds"], THR)
    assert all(torch.equal(a, b) for a, b in zip(grads, hand))
    assert (fused_asphere.K3_FWD_LAUNCHES, fused_asphere.K3_BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="trace_fused_asphere_full"):
        fused_asphere.trace_fused_asphere(*ins[:9], "full", True, N_PER_W)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_asphere.trace_fused_asphere(*[a.detach().to("meta") for a in ins[:9]], False,
                                          True, N_PER_W)


@pytest.mark.parametrize("name", ["cooke_asph", "double_gauss_asph"])
def test_fused_engine_matches_unroll_engine(name):
    """``trace_rays`` on the fused engine (K3's plain version here) against
    the pure-torch engine on the same lens: the two write the slope as
    c/(2w) and as c/(1+w) + c u/(2 w (1+w)²), equal in exact arithmetic, so
    masks agree and coordinates within the module's tolerance."""
    if name == "cooke_asph":
        specs, lens = port(*asphere_cooke())
    else:
        specs, lens = zoo.build(name, device="cpu")
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    want = trace.trace_rays(specs, lens, cfg)
    got = trace.trace_rays(specs, lens, dataclasses.replace(cfg, engine="fused"))
    assert got.x.shape == want.x.shape == (1, 3, 64, 3) and got.stacks is None
    _assert_forward_close([a.reshape(-1) for a in got[:6]],
                          [a.reshape(-1).numpy() for a in want[:6]])
    np.testing.assert_array_equal(got.ray_backward.numpy(), want.ray_backward.numpy())


def test_k3_without_asphere_terms_matches_k1():
    """K3 with kappa = asph = 0 against K1, both plain versions: masks
    identical on the double-Gauss and on its c x 3 variant; on the
    double-Gauss the coordinates and the relu(z) sums within JAX's own
    K3-vs-K1 bar (``test_pallas_asphere.py``: 1e-5 + 1e-4 relative)."""
    specs, lens = zoo.build("double_gauss", device="cpu")
    for c_scale in (1.0, 3.0):
        lens_c = lens.replace(c=lens.c * c_scale)
        cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
        xp, yp, cyb, z0, mu, _ = fused_trace.prepare_fused_inputs(specs, lens_c, cfg)
        c, t = lens_c.c[0], lens_c.t[0]
        zero = torch.zeros_like(c)
        for penalties in (False, True):
            k1 = fused_trace.trace_fused_reference(xp, yp, cyb, z0, c, t, mu, penalties, True,
                                                   N_PER_W)
            k3 = fused_asphere.trace_fused_asphere_reference(
                xp, yp, cyb, z0, c, zero, t, mu, torch.zeros(c.shape + (2,)), penalties, True,
                N_PER_W)
            assert torch.equal(k1[4], k3[4])
            # Where the sphere guess misses, the Newton solve may still find a
            # (backward) root and flag the ray before a later surface fails
            # it: ray_backward is held on the rays that pass.
            ok = k1[4]
            assert torch.equal(k1[5][ok], k3[5][ok])
            if c_scale != 1.0:
                # On the c x 3 lens a few grazing rays amplify one ulp of the
                # two intersections to ~2e-5 mm (queue 3 of ROADMAP.md).
                continue
            for a, b in zip(k3[:4], k1[:4]):
                np.testing.assert_allclose(a[ok].numpy(), b[ok].numpy(), rtol=1e-4, atol=1e-5)
            if penalties:
                # relu(z); the theta sums carry the near-normal amplification
                # of ``_theta_sensitivity``.
                np.testing.assert_allclose(k3[8].numpy(), k1[8].numpy(), rtol=1e-4, atol=1e-5)


def test_fused_engine_routes_and_refuses():
    """A lens with only one of kappa/asph gets zeros for the other; a
    population of aspheres runs on kernel K4 (it raised before K4 was
    ported): two copies give the single system's outputs and loss on K3;
    double precision raises."""
    specs, lens = zoo.build("double_gauss_asph", device="cpu")
    cfg = simulator.SimulatorConfig(**CONFIG, trace_engine="fused").trace_config()
    only_kappa = lens.replace(asph=None)
    res = trace.trace_rays(specs, only_kappa, cfg)
    zero_asph = trace.trace_rays(specs, lens.replace(asph=torch.zeros_like(lens.asph)), cfg)
    assert torch.equal(res.ray_ok, zero_asph.ray_ok)
    np.testing.assert_allclose(res.y.numpy(), zero_asph.y.numpy(), rtol=0, atol=1e-6)
    two = convert.lens_from_numpy((5, 5), ("GAGGAAGGAGA",) * 2, lens.c.repeat(2, 1).numpy(),
                                  lens.t.repeat(2, 1).numpy(), lens.nd.repeat(2, 1).numpy(),
                                  lens.v.repeat(2, 1).numpy(), device="cpu",
                                  kappa=lens.kappa.repeat(2, 1).numpy(),
                                  asph=lens.asph.repeat(2, 1, 1).numpy())
    pair = np.array([0, 0])
    one = trace.trace_rays(specs, lens, cfg)
    for res in (trace.trace_rays(specs[pair], two, cfg),
                fused_batch.trace_rays_fused_batch(specs[pair], two, cfg)):
        assert res.x.shape == (2,) + tuple(one.x.shape[1:])
        for a, b in zip(res[:6], one[:6]):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[0])
    sim_cfg = simulator.SimulatorConfig(**CONFIG, trace_engine="fused")
    _, loss_two = simulator.do_ray_tracing(specs[pair], two, sim_cfg)
    _, loss_one = simulator.do_ray_tracing(specs, lens, sim_cfg)
    for key in ("loss_unsup", "rms", "penalty"):
        np.testing.assert_allclose(float(loss_two[key]), float(loss_one[key]), rtol=1e-6,
                                   err_msg=key)
    with pytest.raises(NotImplementedError, match="float32"):
        trace.trace_rays(specs, lens, dataclasses.replace(cfg, double_precision=True))
