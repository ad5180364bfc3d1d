"""Port parity: pupil samplers, surfaces, ray aiming and the pure-torch trace
engine against the JAX package's unroll engine, on the same parameters.

Tolerances: image-plane coordinates on rays that are ok in both engines
within 5e-6 mm + 1e-6 relative (float32 ulp at the ~7 mm image heights is
~5e-7 mm; ray aiming adds a few ulp); failure masks identical; d rms/d(c, t)
within 1e-4 relative to the gradient's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import metrics as jmetrics
from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import trace as jtrace
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.ops import aiming as jaiming
from torchoptics_tpu.ops import pupil as jpupil
from torchoptics_tpu_torch import metrics, simulator, trace
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import aiming, pupil

CONFIG = dict(n_sampled_fields=3, n_pupil_rings=8, pupil_sampling="circular",
              n_ray_aiming_iter=1)
CASES = {"double_gauss": ("double_gauss", 1.0), "cooke": ("cooke", 1.0),
         "double_gauss_c3": ("double_gauss", 3.0)}


def _jax_case(name):
    lens_name, c_scale = CASES[name]
    jspecs, jlens = jzoo.build(lens_name)
    return jspecs, jlens.replace(c=jlens.c * c_scale)


def _port(jspecs, jlens):
    st = jlens.structure
    lens = convert.lens_from_numpy(st.stop_idx, st.sequence, np.asarray(jlens.c),
                                   np.asarray(jlens.t), np.asarray(jlens.nd),
                                   np.asarray(jlens.v), device="cpu")
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    return specs, lens



@pytest.fixture(scope="module")
def jax_side():
    """JAX unroll traces of every case (aiming on), JAX's aimed pupil
    coordinates and the trace of exactly those coordinates (aiming off), and
    jax.grad of the spot RMS."""
    cfg = jsim.SimulatorConfig(**CONFIG).trace_config()
    cfg_fixed = dataclasses.replace(cfg, n_ray_aiming_iter=0)
    xy = jpupil.sample_pupil(cfg.mode, cfg.n_rays, 1)
    out = {}
    for name in CASES:
        jspecs, jlens = _jax_case(name)
        res = jtrace.trace_rays(jspecs, jlens, cfg)
        aimed = [jnp.clip(a, -2.0, 2.0) for a in
                 jaiming.ray_aiming(jspecs, jlens, cfg, True)(*xy)]
        fixed = jtrace.trace_rays(jspecs, jlens, cfg_fixed, xy=tuple(aimed))
        out[name] = dict(specs=jspecs, lens=jlens,
                         res=[np.asarray(a) for a in res[:6]],
                         aimed=[np.asarray(a) for a in aimed],
                         fixed=[np.asarray(a) for a in fixed[:6]])

    jspecs, jlens = _jax_case("double_gauss")

    def rms(c, t):
        r = jtrace.trace_rays(jspecs, jlens.replace(c=c, t=t), cfg)
        return jmetrics.compute_rms2d(r.x, r.y, r.ray_ok)[0]

    out["grad"] = [np.asarray(g) for g in jax.grad(rms, argnums=(0, 1))(jlens.c, jlens.t)]
    return out


def _assert_trace_close(res, ref):
    x, y, cx, cy, ok, bw = [a.detach().numpy() for a in res[:6]]
    jx, jy, jcx, jcy, jok, jbw = ref
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(bw, jbw)
    for a, b, label in ((x, jx, "x"), (y, jy, "y"), (cx, jcx, "cx"), (cy, jcy, "cy")):
        np.testing.assert_allclose(a[ok & jok], b[ok & jok], rtol=1e-6, atol=5e-6,
                                   err_msg=label)


@pytest.mark.parametrize("name", list(CASES))
def test_trace_rays_unroll_matches_jax(name, jax_side):
    """Masks with ray aiming on, and coordinates on the same (aimed) pupil
    coordinates: the trace engine itself agrees to float32 rounding."""
    ref = jax_side[name]
    specs, lens = _port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    res = trace.trace_rays(specs, lens, cfg)
    np.testing.assert_array_equal(res.ray_ok.numpy(), ref["res"][4])
    np.testing.assert_array_equal(res.ray_backward.numpy(), ref["res"][5])
    if name == "double_gauss_c3":
        assert 0 < res.ray_ok.float().mean() < 1, "the c x 3 lens must fail some rays"
    fixed = trace.trace_rays(specs, lens, dataclasses.replace(cfg, n_ray_aiming_iter=0),
                             xy=tuple(torch.tensor(a) for a in ref["aimed"]))
    _assert_trace_close(fixed, ref["fixed"])


@pytest.mark.parametrize("name", ["double_gauss", "cooke"])
def test_aimed_trace_matches_jax(name, jax_side):
    """Coordinates with ray aiming on, for the well-conditioned designs. (On
    the c x 3 lens the aiming slopes differ by ~3e-6 relative, see below, and
    the lens amplifies that to ~1e-4 mm at the image.)"""
    ref = jax_side[name]
    specs, lens = _port(ref["specs"], ref["lens"])
    res = trace.trace_rays(specs, lens, simulator.SimulatorConfig(**CONFIG).trace_config())
    _assert_trace_close(res, ref["res"])


@pytest.mark.parametrize("name", list(CASES))
def test_ray_aiming_matches_jax(name, jax_side):
    """Aimed pupil coordinates within 1e-5 of their scale: the Newton slopes
    are reverse-mode derivatives whose float32 operation order differs
    between autograd and JAX's transpose (measured 2.9e-6 relative on the
    c x 3 lens)."""
    ref = jax_side[name]
    specs, lens = _port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    fn = aiming.ray_aiming(specs, lens, cfg, use_vig=True)
    for a, b in zip(fn(*pupil.sample_pupil(cfg.mode, cfg.n_rays, 1)), ref["aimed"]):
        np.testing.assert_allclose(torch.clamp(a, -2.0, 2.0).numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def _rms_of(specs, lens, cfg):
    def rms(c, t):
        r = trace.trace_rays(specs, lens.replace(c=c, t=t), cfg)
        return metrics.compute_rms2d(r.x, r.y, r.ray_ok)[0]
    return rms


def test_rms_gradient_matches_jax(jax_side):
    ref = jax_side["double_gauss"]
    specs, lens = _port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    c = lens.c.clone().requires_grad_(True)
    t = lens.t.clone().requires_grad_(True)
    grads = torch.autograd.grad(_rms_of(specs, lens, cfg)(c, t), (c, t))
    for g, jg, label in zip(grads, jax_side["grad"], ("dc", "dt")):
        scale = np.abs(jg).max()
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=1e-4,
                                   err_msg=label)


def test_rms_gradient_finite_with_failed_rays(jax_side):
    ref = jax_side["double_gauss_c3"]
    specs, lens = _port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    c = lens.c.clone().requires_grad_(True)
    t = lens.t.clone().requires_grad_(True)
    grads = torch.autograd.grad(_rms_of(specs, lens, cfg)(c, t), (c, t))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0].abs().sum()) > 0


def test_safe_sqrt_gradient_is_finite_at_zero():
    x = torch.tensor([0.0, -1.0, 4.0], requires_grad=True)
    y = trace._safe_sqrt(x)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), [0.0, 0.0, 2.0])
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 0.0, 0.25])


DETERMINISTIC = [("tee", (8,)), ("chief", (8,)), ("meridional_uniform", (7,)),
                 ("sagittal_uniform", (7,)), ("circular", (4, 6)),
                 ("skew_uniform_half_equidistant", (3, 2)),
                 ("skew_uniform_half_jittered", (3, 2)),
                 ("skew_inner_square_half", (5,)),
                 ("skew_outer_edge_uniform", (9,))]


@pytest.mark.parametrize("mode,n_rays", DETERMINISTIC)
def test_deterministic_samplers_match_jax(mode, n_rays):
    xt, yt = pupil.sample_pupil(mode, n_rays, 1)
    xj, yj = jpupil.sample_pupil(mode, n_rays, 1)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_skew_random_uses_the_generator():
    draw = lambda seed: pupil.sample_pupil(
        "skew_random", (4, 8), 2, generator=torch.Generator().manual_seed(seed))
    (x1, y1), (x2, _), (x3, _) = draw(0), draw(0), draw(1)
    assert x1.shape == (2, 1, 32, 1)
    assert torch.equal(x1, x2) and not torch.equal(x1, x3)
    assert float((x1 ** 2 + y1 ** 2).max()) <= 1.0 + 1e-6
    with pytest.raises(ValueError):
        pupil.sample_pupil("skew_random", (4, 8), 1)


def test_vignetting_and_epd_scaling_match_jax():
    rng = np.random.default_rng(1)
    y = rng.uniform(-1, 1, (2, 3, 5, 1)).astype(np.float32)
    up = rng.uniform(0, 0.3, (2, 3)).astype(np.float32)
    down = rng.uniform(0, 0.3, (2, 3)).astype(np.float32)
    epd = np.array([10.0, 25.0], np.float32)
    got = pupil.scale_to_epd(pupil.apply_vignetting(
        torch.tensor(y), torch.tensor(up), torch.tensor(down)), torch.tensor(epd))
    want = jpupil.scale_to_epd(jpupil.apply_vignetting(
        jnp.asarray(y), jnp.asarray(up), jnp.asarray(down)), jnp.asarray(epd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_trace_config_validates_mode_and_engine():
    with pytest.raises(ValueError, match="circular"):
        trace.TraceConfig(mode="bogus")
    with pytest.raises(ValueError, match="engine"):
        trace.TraceConfig(engine="pallas")


def test_aiming_refuses_inference_mode(jax_side):
    ref = jax_side["double_gauss"]
    specs, lens = _port(ref["specs"], ref["lens"])
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    with torch.no_grad():
        res = trace.trace_rays(specs, lens, cfg)
    np.testing.assert_array_equal(res.y.numpy(), trace.trace_rays(specs, lens, cfg).y.detach().numpy())
    with torch.inference_mode(), pytest.raises(RuntimeError, match="no_grad"):
        aiming.ray_aiming(specs, lens, cfg, use_vig=True)
