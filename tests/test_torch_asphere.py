"""Port parity for the conic/asphere surface math and the pure-torch trace
engine's asphere branch (``ops.surfaces``, ``ops.trace``, ``ops.aiming``),
against the JAX package on the same numbers.

The JAX side is its jnp engine in its ``scan`` form, jitted (the same
``surfaces.find_marching_distance_asphere`` per surface; the unrolled form
runs 30 s eagerly per value-and-grad on the CPU), evaluated once per module.
Lenses: the zoo's aspherized double-Gauss (conics on 10 of 11 surfaces, r⁴
and r⁶ on all) and the Cooke triplet with the aspheres of
``test_pallas_asphere.py``; 3 fields x 8² circular pupil x 3 wavelengths,
1 ray-aiming iteration.

Bars (ROADMAP's north star): image-plane coordinates on rays that are ok in
both within 5e-6 mm + 1e-6 relative (float32 ulp at the ~10 mm image
heights is ~1e-6 mm); ``ray_ok`` and ``ray_backward`` identical; aimed pupil
coordinates within 5e-6; d rms/d(c, kappa, t, asph) within 2e-3 of each
gradient's largest magnitude (the asphere-gradient bar between JAX's own
engines, RESULTS.md). The surface functions on seeded random rays within
1e-6 relative (elementwise float32 maps) and their gradients within 1e-4 of
scale. On the double-Gauss with c x 3, whose Newton solves land on far and
grazing roots, float32 rounding differs by ~1e-4 mm at the image between the
two packages' operation orders (ROADMAP queue 3); there the masks are held
identical and the coordinates are not compared. The gradients are compared
on the Cooke and on the flagship defocused by 0.05 mm: at the flagship's own
~1 um spot, float32 rounding of ~10 mm image heights moves d rms/dc by ~1 %,
and JAX's own jitted and eager forms of its engine differ by 1.1e-2 of
scale there (ROADMAP queue 3).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import metrics as jmetrics
from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import trace as jtrace
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.models.structure import Lens as JLens
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import aiming as jaiming
from torchoptics_tpu.ops import pupil as jpupil
from torchoptics_tpu.ops import surfaces as jsurf
from torchoptics_tpu_torch import metrics, simulator, trace
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import aiming, surfaces

CONFIG = dict(n_sampled_fields=3, n_pupil_rings=8, pupil_sampling="circular",
              n_ray_aiming_iter=1)
CASES = ("double_gauss_asph", "cooke_asph", "double_gauss_asph_c3", "double_gauss_asph_defocus")
# The defocused flagship (image plane 0.05 mm further): its ~20 um spot keeps
# d rms/d(params) well above the float32 floor of the ~1 um designed spot.
GRAD_CASES = ("cooke_asph", "double_gauss_asph_defocus")
GRAD_BAR = 2e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def asphere_cooke():
    """The Cooke triplet with two conics and three asphere terms, as
    ``test_pallas_asphere.py`` builds it (JAX)."""
    p = jzoo.get_prescription("cooke")
    kappa = np.zeros((1, 7), np.float32)
    asph = np.zeros((1, 7, 2), np.float32)
    kappa[0, 0], kappa[0, 3] = -0.6, 0.4
    asph[0, 0, 0], asph[0, 3, 0], asph[0, 5, 1] = 2e-5, -1e-5, 3e-8
    lens = JLens(JStructure(tuple(p["stop_idx"]), tuple(p["sequence"])), jnp.asarray(p["c"]),
                 jnp.asarray(p["t"]), jnp.asarray(p["nd"]), jnp.asarray(p["v"]),
                 kappa=jnp.asarray(kappa), asph=jnp.asarray(asph))
    return jzoo.build("cooke")[0], lens


def jax_case(name):
    if name == "cooke_asph":
        return asphere_cooke()
    jspecs, jlens = jzoo.build("double_gauss_asph")
    if name.endswith("defocus"):
        return jspecs, jlens.replace(t=jlens.t.at[0, -1].add(0.05))
    return jspecs, jlens.replace(c=jlens.c * (3.0 if name.endswith("c3") else 1.0))


def port(jspecs, jlens):
    st = jlens.structure
    lens = convert.lens_from_numpy(
        st.stop_idx, st.sequence, *(np.asarray(a) for a in (jlens.c, jlens.t, jlens.nd, jlens.v)),
        device="cpu", kappa=np.asarray(jlens.kappa), asph=np.asarray(jlens.asph))
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    return specs, lens


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the trace with aiming, JAX's aimed pupil coordinates, and
    the value and gradient of the spot RMS in (c, kappa, asph, t), from one
    jitted program per lens, compiled on threads."""
    cfg = jsim.SimulatorConfig(**CONFIG).trace_config(engine="scan")
    xy = jpupil.sample_pupil(cfg.mode, cfg.n_rays, 1)

    def program(jspecs, jlens):
        def rms(c, kappa, asph, t):
            res = jtrace.trace_rays(jspecs, jlens.replace(c=c, kappa=kappa, asph=asph, t=t), cfg)
            return jmetrics.compute_rms2d(res.x, res.y, res.ray_ok)[0], res

        def run(c, kappa, asph, t):
            (value, res), grads = jax.value_and_grad(rms, argnums=(0, 1, 2, 3), has_aux=True)(
                c, kappa, asph, t)
            lens = jlens.replace(c=c, kappa=kappa, asph=asph, t=t)
            aimed = [jnp.clip(a, -2.0, 2.0) for a in jaiming.ray_aiming(jspecs, lens, cfg, True)(*xy)]
            return value, grads, res[:6], aimed
        return jax.jit(run)

    out = {}
    with ThreadPoolExecutor(len(CASES)) as pool:
        jobs = {}
        for name in CASES:
            jspecs, jlens = jax_case(name)
            args = (jlens.c, jlens.kappa, jlens.asph, jlens.t)
            compiled = pool.submit(program(jspecs, jlens).lower(*args).compile,
                                   compiler_options=FAST_COMPILE)
            jobs[name] = (jspecs, jlens, args, compiled)
        for name, (jspecs, jlens, args, compiled) in jobs.items():
            value, grads, res, aimed = compiled.result()(*args)
            out[name] = dict(specs=jspecs, lens=jlens, rms=float(value),
                             grads=[np.asarray(g) for g in grads],
                             res=[np.asarray(a) for a in res],
                             aimed=[np.asarray(a) for a in aimed])
    out["xy"] = [np.asarray(a) for a in xy]
    return out


def _assert_trace_close(got, want, coordinates=True):
    got = [a.detach().numpy() for a in got[:6]]
    np.testing.assert_array_equal(got[4], want[4], err_msg="ray_ok")
    np.testing.assert_array_equal(got[5], want[5], err_msg="ray_backward")
    if not coordinates:
        return
    ok = got[4] & want[4]
    for i, label in enumerate(("x", "y", "cx", "cy")):
        np.testing.assert_allclose(got[i][ok], want[i][ok], rtol=1e-6, atol=5e-6, err_msg=label)


@pytest.mark.parametrize("name", CASES[:3])
def test_unroll_engine_matches_jax(name, jax_side):
    """``trace_rays`` with aiming on the pure-torch engine against JAX's jnp
    engine; the aimed pupil coordinates through ``aiming.ray_aiming``, whose
    Newton slopes (autograd through the stop trace) see the polish step only,
    as JAX's do."""
    ref = jax_side[name]
    specs, lens = port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    res = trace.trace_rays(specs, lens, cfg)
    assert res.x.shape == (1, 3, 64, 3)
    _assert_trace_close(res, ref["res"], coordinates=not name.endswith("c3"))
    xy = [torch.tensor(a) for a in jax_side["xy"]]
    aimed = [torch.clamp(a, -2.0, 2.0) for a in aiming.ray_aiming(specs, lens, cfg, True)(*xy)]
    for got, want in zip(aimed, ref["aimed"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    ok_share = float(res.ray_ok.float().mean())
    assert (0 < ok_share < 1) if name.endswith("c3") else ok_share == 1.0


@pytest.mark.parametrize("name", GRAD_CASES)
def test_unroll_engine_gradients_match_jax(name, jax_side):
    ref = jax_side[name]
    specs, lens = port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    params = [p.clone().requires_grad_(True) for p in (lens.c, lens.kappa, lens.asph, lens.t)]
    res = trace.trace_rays(specs, lens.replace(c=params[0], kappa=params[1], asph=params[2],
                                               t=params[3]), cfg)
    rms = metrics.compute_rms2d(res.x, res.y, res.ray_ok)[0]
    np.testing.assert_allclose(float(rms.detach()), ref["rms"], rtol=2e-4)
    grads = torch.autograd.grad(rms, params)
    for got, want, label in zip(grads, ref["grads"], ("dc", "dkappa", "dasph", "dt")):
        got = got.numpy().astype(np.float64)
        assert np.isfinite(got).all(), label
        scale = np.abs(want).max()
        assert scale > 0, label
        assert np.abs(got - want).max() <= GRAD_BAR * scale, (
            label, np.abs(got - want).max() / scale)


def _random_rays(rng, n):
    """Rays near a surface vertex, some beyond the conic's aperture."""
    x = rng.uniform(-12, 12, n).astype(np.float32)
    y = rng.uniform(-12, 12, n).astype(np.float32)
    z = rng.uniform(-3, -0.5, n).astype(np.float32)
    cx = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    cy = rng.uniform(-0.3, 0.3, n).astype(np.float32)
    cz = np.sqrt(1 - cx ** 2 - cy ** 2).astype(np.float32)
    return x, y, z, cx, cy, cz


@pytest.mark.parametrize("with_kappa,with_asph", [(True, True), (True, False), (False, True)])
def test_surface_functions_match_jax(with_kappa, with_asph):
    """``sag_and_slope``, ``find_marching_distance_asphere`` and
    ``apply_snell_general`` on seeded rays, values and gradients."""
    rng = np.random.default_rng(0)
    rays = _random_rays(rng, 512)
    c, kappa = np.float32(0.08), np.float32(0.5) if with_kappa else None
    asph = np.asarray([2e-5, -3e-7], np.float32) if with_asph else None
    mu = np.float32(1.0 / 1.5)

    def jax_fn(c, kappa, asph, rays):
        inter = jsurf.find_marching_distance_asphere(c, kappa, asph, *rays)
        x1 = rays[0] + inter.distance * rays[3]
        y1 = rays[1] + inter.distance * rays[4]
        snell = jsurf.apply_snell_general(c, kappa, asph, mu, x1, y1, *rays[3:], inter.cos_theta)
        sag = jsurf.sag_and_slope(c, kappa, asph, x1 ** 2 + y1 ** 2)
        return inter, snell, sag

    def torch_fn(c, kappa, asph, rays):
        inter = surfaces.find_marching_distance_asphere(c, kappa, asph, *rays)
        x1 = rays[0] + inter.distance * rays[3]
        y1 = rays[1] + inter.distance * rays[4]
        snell = surfaces.apply_snell_general(c, kappa, asph, mu, x1, y1, *rays[3:],
                                             inter.cos_theta)
        sag = surfaces.sag_and_slope(c, kappa, asph, x1 ** 2 + y1 ** 2)
        return inter, snell, sag

    to_j = lambda a: None if a is None else jnp.asarray(a)
    to_t = lambda a: None if a is None else torch.tensor(a)
    j_inter, j_snell, j_sag = jax_fn(to_j(c), to_j(kappa), to_j(asph), [to_j(a) for a in rays])
    t_params = [to_t(a) for a in (c, kappa, asph)]
    for p in t_params:
        if p is not None:
            p.requires_grad_(True)
    t_inter, t_snell, t_sag = torch_fn(*t_params, [to_t(a) for a in rays])
    fail = j_inter.failures | j_snell[0]
    np.testing.assert_array_equal(t_inter.failures.numpy(), np.asarray(j_inter.failures))
    np.testing.assert_array_equal(t_snell[0].numpy(), np.asarray(j_snell[0]))
    np.testing.assert_array_equal(t_sag[2].numpy(), np.asarray(j_sag[2]))
    assert 0.05 < float(np.mean(fail)) < 0.95
    ok = ~np.asarray(fail)
    for got, want in [(t_inter.distance, j_inter.distance), (t_inter.cos2_theta, j_inter.cos2_theta),
                      *zip(t_snell[1:], j_snell[1:]), *zip(t_sag[:2], j_sag[:2])]:
        np.testing.assert_allclose(got.detach().numpy()[ok], np.asarray(want)[ok], rtol=1e-5,
                                   atol=1e-6)

    # d(sum over the ok rays of the distance and the new direction)/d(the
    # surface's parameters): the polish step only, in both packages.
    present = [i for i, v in enumerate((c, kappa, asph)) if v is not None]

    def full(values):
        params = [None, None, None]
        for i, v in zip(present, values):
            params[i] = v
        return params

    def jax_objective(*values):
        inter, snell, _ = jax_fn(*full(values), [to_j(a) for a in rays])
        return sum(jnp.where(ok, v, 0.0).sum() for v in (inter.distance, snell[1], snell[2]))

    jgrad = jax.grad(jax_objective, argnums=tuple(range(len(present))))(
        *[to_j((c, kappa, asph)[i]) for i in present])
    mask = torch.tensor(ok)
    t_obj = sum(torch.where(mask, v, 0.0).sum()
                for v in (t_inter.distance, t_snell[1], t_snell[2]))
    tgrad = torch.autograd.grad(t_obj, [t_params[i] for i in present])
    for got, want in zip(tgrad, jgrad):
        want = np.asarray(want, np.float64)
        assert np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy() - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-30)


def test_trace_config_passes_newton_iters():
    """``TraceConfig.newton_iters`` reaches the Newton solve: with no steps
    the sphere guess stays unpolished by Newton and most rays fail the
    convergence test, as in JAX."""
    jspecs, jlens = asphere_cooke()
    specs, lens = port(jspecs, jlens)
    cfg = simulator.SimulatorConfig(**dict(CONFIG, n_ray_aiming_iter=0)).trace_config()
    assert cfg.newton_iters == 10
    few = dataclasses.replace(cfg, newton_iters=0)
    jcfg = dataclasses.replace(jsim.SimulatorConfig(**dict(CONFIG, n_ray_aiming_iter=0))
                               .trace_config(), newton_iters=0)
    got = trace.trace_rays(specs, lens, few)
    want = jtrace.trace_rays(jspecs, jlens, jcfg)
    np.testing.assert_array_equal(got.ray_ok.numpy(), np.asarray(want.ray_ok))
    assert float(got.ray_ok.float().mean()) < float(trace.trace_rays(specs, lens, cfg)
                                                     .ray_ok.float().mean())
