"""Port parity for ``ops.wavefront`` and ``analysis.wavefront_rms``.

The same lens and pupil points go through the JAX package and the port:
``opd_map`` and ``wavefront_rms`` on the double-Gauss (3 fields x 6²
circular pupil, the d line, one ray-aiming iteration), the exit pupil and
the pupil magnification, the Zernike basis and fit (Noll indexing, exact
recovery), the Strehl ratio, and the two diffraction PSFs. On the JAX side
the jnp engine runs once for the module, in its scan form, jitted with a
fast compile on threads (eagerly, its JAX programs took ~50 s here); the
complex ``diffraction_psf_window`` and ``zernike_fit`` are jitted too.

Bars, the JAX package's own (``tests/test_wavefront.py``,
``tests/test_opl_fused.py``, ``tests/test_diffraction_imaging.py``): masks
identical; OPD within 5e-5 mm; ``wavefront_rms`` within rtol 1e-2 and atol
2e-7 mm, its gradient within rtol 0.05 and atol 0.02 x the largest (a
float32-noise-floor quantity, JAX's bar between its Pallas and XLA paths);
the Airy window's energy accounting in (0.90, 1.005].
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import analysis as janalysis
from torchoptics_tpu import trace as jtrace
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.ops import wavefront as jwf
from torchoptics_tpu_torch import analysis, trace
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import pupil
from torchoptics_tpu_torch.ops import wavefront as wf

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LAM = 520e-6   # mm
CONFIG = dict(mode="circular", n_rays=(6, 6), rel_fields=(0.0, 0.7, 1.0), wavelengths=("d",),
              n_ray_aiming_iter=1)
# The c x 3 double-Gauss, where two thirds of the rays fail.
C3 = dict(CONFIG, n_rays=(4, 4))


def _port(jspecs, jlens):
    st = jlens.structure
    opt = lambda a: None if a is None else np.asarray(a)
    lens = convert.lens_from_numpy(
        st.stop_idx, st.sequence, *(np.asarray(a) for a in (jlens.c, jlens.t, jlens.nd, jlens.v)),
        device="cpu", kappa=opt(jlens.kappa), asph=opt(jlens.asph))
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    return specs, lens


def _double_gauss(c_scale=1.0):
    jspecs, jlens = jzoo.build("double_gauss")
    return jspecs, jlens.replace(c=jlens.c * c_scale)


def _jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def jax_side():
    """opd_map, the value and d/d(c, t) of wavefront_rms, and d/dc of the
    masked OPD sum on the c x 3 lens: three programs compiled on threads."""
    jspecs, jlens = _double_gauss()
    cfg = jtrace.TraceConfig(**CONFIG, engine="scan")
    jspecs3, jlens3 = _double_gauss(3.0)
    cfg3 = jtrace.TraceConfig(**C3, engine="scan")

    def masked_opd(c):
        o = jwf.opd_map(jspecs3, jlens3.replace(c=c), cfg3)
        return jnp.sum(jnp.where(o["ok"], o["opd"], 0.0))

    programs = {
        "opd": lambda: _jitted(lambda c: jwf.opd_map(jspecs, jlens.replace(c=c), cfg), jlens.c),
        "rms": lambda: _jitted(jax.value_and_grad(
            lambda c, t: janalysis.wavefront_rms(jspecs, jlens.replace(c=c, t=t), cfg),
            argnums=(0, 1)), jlens.c, jlens.t),
        "grad_c3": lambda: _jitted(jax.grad(masked_opd), jlens3.c),
    }
    with ThreadPoolExecutor(len(programs)) as pool:
        out = dict(zip(programs, pool.map(lambda f: f(), programs.values())))
    rms, grads = out["rms"]
    return {"opd": {k: np.asarray(v) for k, v in out["opd"].items()}, "rms": float(rms),
            "rms_grads": [np.asarray(g) for g in grads], "grad_c3": np.asarray(out["grad_c3"]),
            "z_xp": np.asarray(jwf.exit_pupil_distance(jlens)),
            "m_p": np.asarray(jwf.pupil_magnification(jlens))}


def test_noll_indexing():
    expected = {1: (0, 0), 2: (1, 1), 3: (1, -1), 4: (2, 0), 5: (2, -2), 6: (2, 2),
                7: (3, -1), 8: (3, 1), 9: (3, -3), 10: (3, 3), 11: (4, 0)}
    for j in range(1, 23):
        assert wf._zernike_nm(j) == jwf._zernike_nm(j), j
        if j in expected:
            assert wf._zernike_nm(j) == expected[j], j


def _grid(n, extent=0.9):
    g = np.linspace(-extent, extent, n)
    X, Y = np.meshgrid(g, g, indexing="xy")
    return X, Y, X.ravel().astype(np.float32), Y.ravel().astype(np.float32)


def test_zernike_basis_and_fit():
    """The basis equals JAX's; the fit recovers seeded coefficients exactly
    (``tests/test_wavefront.py``'s bar) and equals JAX's jitted fit."""
    rng = np.random.default_rng(0)
    X, Y, xr, yr = _grid(17)
    basis = wf.zernike_basis(11, torch.tensor(xr), torch.tensor(yr))
    jbasis = np.asarray(jwf.zernike_basis(11, jnp.asarray(xr), jnp.asarray(yr)))
    np.testing.assert_allclose(basis.numpy(), jbasis, rtol=1e-5, atol=1e-5)
    coeffs = rng.normal(size=11).astype(np.float32)
    opd = (basis @ torch.tensor(coeffs)).numpy()
    ok = ((X ** 2 + Y ** 2) <= 1.0).ravel()
    fit = wf.zernike_fit(torch.tensor(opd), torch.tensor(xr), torch.tensor(yr), torch.tensor(ok))
    np.testing.assert_allclose(fit.numpy(), coeffs, rtol=1e-4, atol=1e-5)
    jfit = jax.jit(jwf.zernike_fit, static_argnames="j_max")(
        jnp.asarray(opd), jnp.asarray(xr), jnp.asarray(yr), jnp.asarray(ok), j_max=11)
    np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), rtol=1e-4, atol=1e-5)


def test_strehl_ratio():
    """1 for a flat wavefront; Maréchal's exp(-(2π σ/λ)²) within 5 %; equal
    to JAX's on the same OPD."""
    rng = np.random.default_rng(1)
    ok = torch.ones(500, dtype=torch.bool)
    assert abs(float(wf.strehl_ratio(torch.zeros(500), ok, LAM)) - 1.0) <= 1e-6
    sigma = LAM / 30.0
    opd = rng.normal(scale=sigma, size=500).astype(np.float32)
    opd = opd - opd.mean()
    s = float(wf.strehl_ratio(torch.tensor(opd), ok, LAM))
    np.testing.assert_allclose(s, np.exp(-(2 * np.pi * sigma / LAM) ** 2), rtol=0.05)
    np.testing.assert_allclose(
        s, float(jwf.strehl_ratio(jnp.asarray(opd), jnp.ones(500, bool), LAM)), rtol=1e-5)


def test_exit_pupil_and_magnification(jax_side):
    jspecs, jlens = _double_gauss()
    _, lens = _port(jspecs, jlens)
    np.testing.assert_allclose(wf.exit_pupil_distance(lens).numpy(), jax_side["z_xp"], rtol=1e-6)
    np.testing.assert_allclose(wf.pupil_magnification(lens).numpy(), jax_side["m_p"], rtol=1e-6)


@pytest.mark.parametrize("engine", ["unroll", "fused"])
def test_opd_map_matches_jax(engine, jax_side):
    """``opd_map`` on either engine (the fused one through K1's opl mode):
    masks identical, OPD within 5e-5 mm, the chief image points within
    1e-5 mm; the on-axis OPD of the flagship is sub-wave."""
    want = jax_side["opd"]
    specs, lens = _port(*_double_gauss())
    got = wf.opd_map(specs, lens, trace.TraceConfig(**dict(CONFIG, engine=engine)))
    np.testing.assert_array_equal(got["ok"].numpy(), want["ok"])
    ok = want["ok"]
    np.testing.assert_allclose(got["opd"].numpy()[ok], want["opd"][ok], atol=5e-5)
    for k in ("x_img", "y_img"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5)
    on_axis = got["opd"][0, 0, :, 0][got["ok"][0, 0, :, 0]]
    assert float(on_axis.std()) < LAM


@pytest.mark.parametrize("engine", ["unroll", "fused"])
def test_wavefront_rms_matches_jax(engine, jax_side):
    """The objective's value and d/d(c, t) on either engine (the fused one
    differentiates through K1's opl backward) against JAX's, at JAX's bar
    between its Pallas and XLA paths."""
    specs, lens = _port(*_double_gauss())
    c = lens.c.clone().requires_grad_(True)
    t = lens.t.clone().requires_grad_(True)
    rms = analysis.wavefront_rms(specs, lens.replace(c=c, t=t),
                                 trace.TraceConfig(**dict(CONFIG, engine=engine)))
    np.testing.assert_allclose(float(rms.detach()), jax_side["rms"], rtol=1e-2, atol=2e-7)
    for g, w, k in zip(torch.autograd.grad(rms, (c, t)), jax_side["rms_grads"], ("dc", "dt")):
        np.testing.assert_allclose(g.numpy(), w, rtol=0.05, atol=0.02 * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("engine", ["unroll", "fused"])
def test_opd_gradient_finite_on_failing_lens(engine, jax_side):
    """On the c x 3 double-Gauss (two thirds of the rays fail), JAX's
    gradient of the masked OPD sum is finite, and so is the port's on either
    engine, equal to JAX's within 1e-4 of the largest. The back-march onto
    the reference sphere takes its square root with a zero gradient where
    the argument reaches zero (JAX: NaN there); no lane reaches it here."""
    want = jax_side["grad_c3"]
    assert np.isfinite(want).all()
    specs, lens = _port(*_double_gauss(3.0))
    c = lens.c.clone().requires_grad_(True)
    out = wf.opd_map(specs, lens.replace(c=c), trace.TraceConfig(**dict(C3, engine=engine)))
    assert 0.2 < float(out["ok"].float().mean()) < 0.5
    g, = torch.autograd.grad(torch.sum(torch.where(out["ok"], out["opd"], 0.0)), (c,))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_pupil_drawn_once():
    """With the random sampler, the trace and the launch phase use one draw:
    a seeded generator gives the OPL of the points it draws, on both
    engines."""
    specs, lens = _port(*_double_gauss())
    cfg = trace.TraceConfig(**dict(CONFIG, mode="skew_random", n_rays=(3, 4)))
    xy = pupil.sample_pupil("skew_random", (3, 4), 1, generator=torch.Generator().manual_seed(7))
    want = wf.optical_path_lengths(specs, lens, cfg, xy=xy)[1]
    for engine in ("unroll", "fused"):
        got = wf.optical_path_lengths(specs, lens, dataclasses.replace(cfg, engine=engine),
                                      generator=torch.Generator().manual_seed(7))[1]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def _flat_pupil(n):
    g = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    X, Y = np.meshgrid(g, g, indexing="xy")
    return np.zeros((n, n), np.float32), (X ** 2 + Y ** 2) <= 1.0, X, Y


def test_diffraction_psf_airy():
    """A perfect wavefront peaks at 1 with its first zero at 1.22 λ f/#; an
    aberrated one peaks lower; equal to JAX's FFT PSF."""
    n = 64
    opd, ok, X, Y = _flat_pupil(n)
    g = np.linspace(-1, 1, n, endpoint=False) + 1.0 / n
    X, Y = np.meshgrid(g, g, indexing="xy")
    ok = (X ** 2 + Y ** 2) <= 1.0
    out = wf.diffraction_psf(torch.tensor(opd), torch.tensor(ok), LAM, pad=8)
    psf, coords = out["psf"].numpy(), out["coords"].numpy()
    M = psf.shape[-1]
    np.testing.assert_allclose(psf[M // 2, M // 2], 1.0, rtol=1e-5)
    assert psf.max() <= 1.0 + 1e-5
    row, c = psf[M // 2, M // 2:], coords[M // 2:]
    sel = (c > 0.6) & (c < 2.0)
    np.testing.assert_allclose(c[sel][np.argmin(row[sel])], 1.22, atol=0.08)
    opd_ab = ((0.15 * LAM) * (2 * (X ** 2 + Y ** 2) - 1)).astype(np.float32)
    out_ab = wf.diffraction_psf(torch.tensor(opd_ab), torch.tensor(ok), LAM, pad=8)
    assert float(out_ab["psf"][M // 2, M // 2]) < 0.95
    want = np.asarray(jax.jit(lambda o: jwf.diffraction_psf(o, jnp.asarray(ok), LAM, pad=8)["psf"])(
        jnp.asarray(opd_ab)))
    np.testing.assert_allclose(out_ab["psf"].numpy(), want, atol=1e-5)


def test_diffraction_psf_window_matches_jax():
    """The Airy window (``tests/test_diffraction_imaging.py``): peak at the
    centre, unit sum, accounted energy in (0.90, 1.005]; an aberrated,
    offset batch equal to JAX's jitted window within 1e-4 of each PSF's
    peak, accounted within 1e-4."""
    R, R_XP = 100.0, 25.0
    opd, ok, X, Y = _flat_pupil(64)
    out = wf.diffraction_psf_window(torch.tensor(opd), torch.tensor(ok), 0.5e-3, R, R_XP, 0.5e-3,
                                    (33, 33), oversample=2)
    psf, acc = out["psf"].numpy(), float(out["accounted"])
    np.testing.assert_allclose(psf.sum(), 1.0, rtol=1e-5)
    assert np.unravel_index(np.argmax(psf), psf.shape) == (16, 16)
    assert 0.90 < acc <= 1.005, acc

    n = 32
    opd, ok, X, Y = _flat_pupil(n)
    opd_b = np.stack([(a * 0.5e-3 * (2 * (X ** 2 + Y ** 2) - 1) + b * 0.5e-3 * Y).astype(np.float32)
                      for a, b in ((0.3, 0.0), (0.1, 0.4))])
    ok_b = np.stack([ok, ok])
    lam = np.asarray([0.5e-3, 0.6e-3], np.float32)
    kw = dict(pitch_mm=2e-3, shape=(9, 11), oversample=2)
    offs = dict(x_offset=np.asarray([0.0, 1e-3], np.float32),
                y_offset=np.asarray([-2e-3, 0.0], np.float32))
    got = wf.diffraction_psf_window(torch.tensor(opd_b), torch.tensor(ok_b), torch.tensor(lam), R,
                                    R_XP, **kw, **{k: torch.tensor(v) for k, v in offs.items()})
    want = jax.jit(lambda o, okk, l, xo, yo: jwf.diffraction_psf_window(
        o, okk, l, R, R_XP, x_offset=xo, y_offset=yo, **kw))(
        jnp.asarray(opd_b), jnp.asarray(ok_b), jnp.asarray(lam), *map(jnp.asarray, offs.values()))
    for k in ("psf", "accounted"):
        w = np.asarray(want[k])
        scale = np.abs(w).max(axis=(-2, -1), keepdims=True) if k == "psf" else 1.0
        np.testing.assert_allclose(got[k].numpy() / scale, w / scale, atol=1e-4, err_msg=k)


def test_psf_window_requires_full_float32_products():
    """TF32 is off by default, and the window raises if it is switched on
    (cuBLAS would round the DFT's inputs to 10-bit mantissas)."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    opd, ok, _, _ = _flat_pupil(8)
    args = (torch.tensor(opd), torch.tensor(ok), 0.5e-3, 100.0, 25.0, 1e-3, (3, 3))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            wf.diffraction_psf_window(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.isfinite(wf.diffraction_psf_window(*args)["psf"]).all()
