"""Port parity for ``imaging``: the optics model, rendering and the whole
``simulate``, plus the test images and the reference's two pinned findings.

The double-Gauss at a small size (5 fields, 8 pupil rings, circular pupil,
one ray-aiming iteration, a 9 x 9 PSF at 8 um, a 3 x 3 patch grid, a 48^2
crop of the sample photograph) goes through the JAX package and the port.
On the JAX side the scan engine runs, jitted with a fast compile, each
program once for the module, on threads; on the port's side the fused
engine on CPU tensors (K1's plain versions, P2's plain version).

Bars, with their reasons:

- The optics model: the PSF splat is a sum of Gaussians of sigma = 4 um
  around traced spots; the two engines' traces differ by float32 rounding
  (~2e-6 mm at the image), which moves a pixel's weight by ~1e-3 of itself:
  geometric PSFs within 1e-3 of their peak; distortion shifts within 1e-6,
  the relative illumination and the PSF centres within 1e-5 relative.
- The diffraction PSFs are the transform of exp(2 pi i OPD / lambda), and
  the two engines' OPDs differ by float32's floor on ~124 mm path sums
  (up to ~1e-5 mm, a tenth of a radian of phase; ``test_torch_wavefront.py``
  holds the OPD itself): from independent traces the PSFs differ by up to
  13 % of their peak on this undersampled grid. So the PSF assembly is held
  on one OPD: JAX's model is built from the port's ``opd_map`` output
  (handed to it in place of its own). What is left is one float32 ulp of
  the window centre (the mean of three ~16 mm chief-ray heights, 1e-6 mm),
  which moves this aliased, speckled PSF (micron-sized grains) by up to
  1.7e-3 of its peak, and the DFT's rounding (1e-5): PSFs within 5e-3 of
  their peak, energy fractions within 1e-3.
- Rendering from one model (JAX's, handed to both): the port convolves tap
  by tap where JAX transforms by FFT (~1e-3 grey levels on [0, 255]) and
  warps by gathers where JAX sums taps: irradiance within 5e-3 grey levels,
  PSNR within 1e-4 dB, SSIM within 1e-6.
- ``simulate`` end to end, each package's own model: the model's gap above
  through a convex blend: irradiance within 0.05 grey levels, PSNR within
  2e-3 dB, SSIM within 1e-5.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import imaging as jimaging
from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.ops import abcd as jabcd
from torchoptics_tpu.ops import metrics as jmetrics
from torchoptics_tpu.ops import psf as jpsf
from torchoptics_tpu.ops import wavefront as jwf
from torchoptics_tpu.utils import images as jimages
from torchoptics_tpu_torch import imaging, simulator, zoo
from torchoptics_tpu_torch.ops import abcd, metrics, psf
from torchoptics_tpu_torch.ops import wavefront as wf
from torchoptics_tpu_torch.utils import images

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SIZE = dict(n_sampled_fields=5, n_pupil_rings=8, pupil_sampling="circular",
            n_ray_aiming_iter=1, psf_shape=(9, 9), psf_abs_pixel_size=8e-3,
            psf_grid_shape=(3, 3), diffraction_grid_n=16, diffraction_oversample=2)
WARPS = ("separable", "taps", "gather")
PX = 48
MODEL_FIELDS = ("sampled_psfs", "sampled_distortion_shifts", "sampled_relative_illumination",
                "y_center", "accounted")


def _jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _jcfg(**kw):
    return jsim.SimulatorConfig(**SIZE, trace_engine="scan", **kw)


def _cfg(**kw):
    return simulator.SimulatorConfig(**SIZE, trace_engine="fused", **kw)


def _radiance():
    return images.load_test_image((PX, PX))[None]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's optics models (both PSF sources), its renders from the geometric
    model with each warp, and its relative illumination: programs compiled on
    threads."""
    jspecs, jlens = jzoo.build("double_gauss")
    radiance = jnp.asarray(_radiance())
    field_lim = jimaging.sample_field_lim(PX, PX)

    def model(source):
        return _jitted(lambda c: jimaging.sample_optics_model(
            jspecs, jlens.replace(c=c), _jcfg(psf_source=source)), jlens.c)

    def lowered_on_port_opd():
        # JAX's diffraction path fed the port's OPD trace (see the docstring):
        # traced here, alone, so no other program resolves the patched opd_map.
        specs, lens = zoo.build("double_gauss", device="cpu")
        cfg = _cfg(psf_source="diffraction")
        with torch.no_grad():
            opd = wf.opd_map(specs, lens, cfg.trace_config(), xy=imaging._pupil_grid(cfg, lens)[2])
        fixed = {k: jnp.asarray(v.numpy()) for k, v in opd.items()}
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jwf, "opd_map", lambda *args, **kw: fixed)
            return jax.jit(lambda c: jimaging.sample_optics_model(
                jspecs, jlens.replace(c=c), _jcfg(psf_source="diffraction"))).lower(jlens.c)

    def render(m, warp):
        return _jitted(lambda mm, r: jimaging.apply_optics_model(
            mm, r, field_lim, _jcfg(warp_method=warp)), m, radiance)

    def illumination():
        fields = tuple(np.linspace(0, 1, 5))
        return _jitted(lambda c: jmetrics.compute_relative_illumination(
            jspecs, jlens.replace(c=c), fields, wavelengths=(520.0,)), jlens.c)

    dif_lowered = lowered_on_port_opd()
    with ThreadPoolExecutor(5) as pool:
        geo = pool.submit(model, "geometric")
        dif = pool.submit(lambda: dif_lowered.compile(FAST_COMPILE)(jlens.c))
        ri = pool.submit(illumination)
        geo_model = geo.result()
        renders = dict(zip(WARPS, pool.map(lambda w: render(geo_model, w), WARPS)))
        out = {"geometric": geo_model, "diffraction": dif.result(), "ri": ri.result()}
    as_np = lambda m: {k: np.asarray(getattr(m, k)) for k in MODEL_FIELDS}
    return {"models": {k: as_np(out[k]) for k in ("geometric", "diffraction")},
            "renders": {w: [np.asarray(v) for v in r] for w, r in renders.items()},
            "ri": np.asarray(out["ri"]),
            "heights": np.asarray(jabcd.get_paraxial_heights_at_image_plane(
                jspecs, jlens, np.linspace(0, 1, 5)))}


@pytest.fixture(scope="module")
def port_lens():
    return zoo.build("double_gauss", device="cpu")


def _port_model(m):
    return imaging.OpticsModel(*[torch.tensor(m[k]) for k in MODEL_FIELDS])


@pytest.mark.parametrize("source,psf_bar,acc_bar", [("geometric", 1e-3, 1e-6),
                                                     ("diffraction", 5e-3, 1e-3)])
def test_sample_optics_model(jax_side, port_lens, source, psf_bar, acc_bar):
    """Both PSF sources; the diffraction model against JAX's on the same OPD
    (the docstring says why)."""
    specs, lens = port_lens
    with torch.no_grad():
        got = imaging.sample_optics_model(specs, lens, _cfg(psf_source=source))
    want = jax_side["models"][source]
    psfs = got.sampled_psfs.numpy()
    assert psfs.shape == want["sampled_psfs"].shape == (5, 9, 9, 3)
    peak = np.abs(want["sampled_psfs"]).max(axis=(1, 2), keepdims=True)
    assert (np.abs(psfs - want["sampled_psfs"]) <= psf_bar * peak).all()
    np.testing.assert_allclose(got.accounted.numpy(), want["accounted"], rtol=acc_bar)
    np.testing.assert_allclose(got.sampled_distortion_shifts.numpy(),
                               want["sampled_distortion_shifts"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sampled_relative_illumination.numpy(),
                               want["sampled_relative_illumination"], rtol=1e-5)
    np.testing.assert_allclose(got.y_center.numpy(), want["y_center"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("warp", WARPS)
def test_apply_optics_model(jax_side, warp):
    """One model, JAX's, rendered by both packages with each warp method."""
    model = _port_model(jax_side["models"]["geometric"])
    with torch.no_grad():
        irr, p, s = imaging.apply_optics_model(model, torch.tensor(_radiance()),
                                               imaging.sample_field_lim(PX, PX),
                                               _cfg(warp_method=warp))
    j_irr, j_p, j_s = jax_side["renders"][warp]
    np.testing.assert_allclose(irr.numpy(), j_irr, rtol=0, atol=5e-3)
    np.testing.assert_allclose(p.numpy(), j_p, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), j_s, rtol=0, atol=1e-6)


def test_simulate(jax_side, port_lens):
    """The whole pipeline on the port (fused engine, plain versions on the
    CPU) against JAX's ``simulate`` (its model, its render)."""
    specs, lens = port_lens
    with torch.no_grad():
        irr, p, s = imaging.simulate(specs, lens, torch.tensor(_radiance()), _cfg())
    j_irr, j_p, j_s = jax_side["renders"]["separable"]
    assert irr.shape == (1, PX, PX, 3)
    np.testing.assert_allclose(irr.numpy(), j_irr, rtol=0, atol=0.05)
    np.testing.assert_allclose(p.numpy(), j_p, rtol=0, atol=2e-3)
    np.testing.assert_allclose(s.numpy(), j_s, rtol=0, atol=1e-5)


def test_relative_illumination_and_paraxial_heights(jax_side, port_lens):
    specs, lens = port_lens
    with torch.no_grad():
        ri = metrics.compute_relative_illumination(specs, lens, tuple(np.linspace(0, 1, 5)),
                                                   wavelengths=(520.0,))
    assert ri.shape == (1, 5, 1)
    np.testing.assert_allclose(ri.numpy(), jax_side["ri"], rtol=1e-5)
    heights = abcd.get_paraxial_heights_at_image_plane(specs, lens, np.linspace(0, 1, 5))
    np.testing.assert_allclose(heights.numpy(), jax_side["heights"], rtol=1e-6)


def test_png_decode_and_test_images():
    """The port decodes the shipped PNG (8-bit RGBA) itself, alpha dropped as
    ``convert("RGB")`` drops it, equal to PIL's decode; the loaders and the
    synthetic chart equal the JAX package's."""
    Image = pytest.importorskip("PIL.Image")
    want = np.asarray(Image.open(images.ASSET).convert("RGB"), dtype=np.float32)
    got = images.load_shipped_test_image()
    assert got.shape == (512, 512, 3)
    np.testing.assert_array_equal(got, want)
    for size in ((256, 256), (48, 64)):
        np.testing.assert_array_equal(images.load_test_image(size),
                                      jimages.load_test_image(size))
    np.testing.assert_array_equal(images.synthetic_test_image(40, 56),
                                  jimages.synthetic_test_image(40, 56))


def test_psf_shape_axis_order(port_lens):
    """Pinned finding of the reference (its ``imaging.py:113``): the
    geometric path reads ``psf_shape`` as (n_x, n_y), the diffraction path as
    (n_y, n_x). The port mirrors both: a (9, 7) shape gives 7 x 9 geometric
    PSFs and 9 x 7 diffraction PSFs, as JAX's pieces do."""
    specs, lens = port_lens
    shapes = {}
    with torch.no_grad():
        for source in ("geometric", "diffraction"):
            cfg = dataclasses.replace(_cfg(psf_source=source), psf_shape=(9, 7),
                                      n_sampled_fields=2)
            shapes[source] = tuple(imaging.sample_optics_model(specs, lens, cfg)
                                   .sampled_psfs.shape)
    assert shapes == {"geometric": (2, 7, 9, 3), "diffraction": (2, 9, 7, 3)}
    x = jnp.zeros((1, 2, 4, 3))
    assert jpsf.sample_psfs(x, x, jnp.zeros(2), (9, 7), 8e-3)[0].shape == (2, 7, 9, 3)
    win = jwf.diffraction_psf_window(jnp.zeros((1, 8, 8)), jnp.ones((1, 8, 8)), 5e-4, 50.0,
                                     5.0, pitch_mm=4e-3, shape=(9, 7))
    assert win["psf"].shape == (1, 9, 7)
    assert psf.sample_psfs(torch.zeros(1, 2, 4, 3), torch.zeros(1, 2, 4, 3), torch.zeros(2),
                           (9, 7), 8e-3)[0].shape == (2, 7, 9, 3)


def test_exit_pupil_radius_is_signed(port_lens, monkeypatch):
    """Pinned finding of the reference (its ``imaging.py:101``): the
    diffraction path's exit-pupil radius r_xp = EPD/2 · m_p is not made
    unsigned, so a lens with a negative pupil magnification hands the window
    a negative radius. The port mirrors it: with m_p negated, the radius it
    passes is the negated one."""
    specs, lens = port_lens
    seen = []
    window = wf.diffraction_psf_window

    def spy(*args, **kw):
        seen.append(float(torch.as_tensor(args[4]).reshape(-1)[0]))
        return window(*args, **kw)
    monkeypatch.setattr(wf, "diffraction_psf_window", spy)
    cfg = dataclasses.replace(_cfg(psf_source="diffraction"), n_sampled_fields=2)
    m_p = float(wf.pupil_magnification(lens)[0])
    with torch.no_grad():
        imaging.sample_optics_model(specs, lens, cfg)
        monkeypatch.setattr(wf, "pupil_magnification",
                            lambda l, f=wf.pupil_magnification: -f(l))
        imaging.sample_optics_model(specs, lens, cfg)
    r_xp = float(specs.epd[0]) / 2.0 * m_p
    np.testing.assert_allclose(seen, [r_xp, -r_xp], rtol=1e-6)
    assert seen[1] < 0


def test_warp_band_check_raises(jax_side):
    """The band check runs on every call (the port is always eager): shifts
    beyond ``max_warp_px`` raise in both packages for the separable and tap
    warps; the gather warp takes any shift."""
    model = jax_side["models"]["geometric"]
    radiance = _radiance()
    field_lim = imaging.sample_field_lim(PX, PX)
    need = float(imaging.required_warp_band(_port_model(model), field_lim, PX, PX))
    assert 0.0 < need < imaging.resolve_max_warp_px(_cfg(), PX, PX)
    jmodel = jimaging.OpticsModel(*[jnp.asarray(model[k]) for k in MODEL_FIELDS])
    for warp in ("separable", "taps"):
        with pytest.raises(ValueError, match="warp band"):
            imaging.apply_optics_model(_port_model(model), torch.tensor(radiance), field_lim,
                                       _cfg(warp_method=warp, max_warp_px=0))
        with pytest.raises(ValueError, match="warp band"):
            jimaging.apply_optics_model(jmodel, jnp.asarray(radiance), field_lim,
                                        _jcfg(warp_method=warp, max_warp_px=0))
    irr, _, _ = imaging.apply_optics_model(_port_model(model), torch.tensor(radiance),
                                           field_lim, _cfg(warp_method="gather", max_warp_px=0))
    assert torch.isfinite(irr).all()


def test_sampling_report_flags_undersampling():
    """The adequacy check of the diffraction sampling, as the JAX package's
    test holds its own (``tests/test_diffraction_imaging.py``): a Cooke
    triplet on a 16^2 pupil grid is flagged as undersampled; the numbers are
    finite."""
    specs, lens = zoo.build("cooke", device="cpu")
    cfg = dataclasses.replace(_cfg(psf_source="diffraction"), n_sampled_fields=3,
                              psf_shape=(33, 33), psf_abs_pixel_size=2e-3)
    rep = imaging.diffraction_sampling_report(specs, lens, cfg)
    assert not rep["ok"]
    assert any("undersamples" in w for w in rep["warnings"])
    assert rep["pv_waves"] > 4.0
    for k in ("blur_mm", "alias_mm", "window_mm", "fno_working"):
        assert np.isfinite(rep[k])
