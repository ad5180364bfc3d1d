"""Port parity for ``analysis``: tolerancing, sensitivities, MTFs, ray fans,
field curvature, longitudinal aberration and the Seidel sums; the public
names of the three analysis modules; the example's smoke run.

The same lenses go through the JAX package and the port (on the CPU): the
Cooke triplet and the Tessar at the JAX package's own test sizes
(``tests/test_analysis.py``: 3 fields x a 4-ring circular pupil x 3
wavelengths, one ray-aiming iteration), an aspheric Cooke
(``zoo.aspheric_population``) for the conic/asphere path, and a padded
Cooke + Tessar population for the Seidel sums' surface mask. On the JAX side
every program runs once for the module, on its XLA engine in scan form,
jitted with a fast compile on threads. The port runs both its engines: the
fused one (kernels K2 and K4 through their plain versions here) and the
unroll one.

A ``torch.Generator`` cannot reproduce ``jax.random``, so the tolerance
parity feeds JAX's noise (``jax.random.split`` and ``_noise``) to the port's
``_apply_perturbation`` and JAX's perturbed population to the port's
``_score_population``; ``perturb_lens`` itself is pinned to draw its noise in
JAX's order.

Bars (the JAX package's between its engines): perturbed parameters within
1e-6 relative; per-sample RMS and the tolerance statistics rtol 2e-4, atol
1e-6; refocus shifts, fan deviations, focus shifts and longitudinal
aberration within 5e-6 mm or relative; masks identical; Seidel sums rtol
1e-5; MTF cuts within 1e-4; sensitivities within 1.2e-7 of the largest
entry (spherical) and 2e-3 (aspheric).
"""

import contextlib
import importlib.util
import inspect
import io
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import analysis as janalysis
from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import trace as jtrace
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.models.structure import Lens as JLens
from torchoptics_tpu.models.structure import Specs as JSpecs
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import metrics as jmetrics
from torchoptics_tpu.ops import vignetting as jvig
from torchoptics_tpu.ops import wavefront as jwf
from torchoptics_tpu_torch import analysis, simulator, trace, zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import metrics, vignetting

# chip_smoke.py's float64 diffraction-MTF cuts (the module imports only the
# standard library and numpy).
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BASE = dict(n_sampled_fields=3, n_pupil_rings=4, pupil_sampling="circular",
            n_ray_aiming_iter=1, wavelengths=(459.0, 520.0, 640.0))
IMAGING = dict(BASE, psf_shape=(33, 33), psf_abs_pixel_size=4e-3)
FANS = dict(mode="circular", n_rays=(2, 2), rel_fields=(0.0, 0.7, 1.0),
            wavelengths=("F", "d", "C"), n_ray_aiming_iter=0)
DIFFRACTION = dict(mode="circular", n_rays=(2, 2), rel_fields=(0.0, 1.0),
                   wavelengths=(520.0, 640.0), n_ray_aiming_iter=0)
N_SAMPLES = 7            # six perturbed samples: an even-length percentile sample
TOL = dict(c=2e-4, t=0.02, nd=1e-3, v=0.2)
TOL_ASPH = dict(c=1e-4, t=0.01, kappa=0.02, asph_rel=0.05)
DELTAS = (-0.2, 0.0, 0.25)
STATS = ("nominal_rms", "mean", "std", "p50", "p90", "p99", "yield_fraction")
RMS_THRESHOLD = 0.02
ENGINES = ("fused", "unroll")


def _port(jspecs, jlens):
    st = jlens.structure
    opt = lambda a: None if a is None else np.asarray(a)
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    lens = convert.lens_from_numpy(
        st.stop_idx, st.sequence, *(np.asarray(a) for a in (jlens.c, jlens.t, jlens.nd, jlens.v)),
        device="cpu", kappa=opt(jlens.kappa), asph=opt(jlens.asph))
    return specs, lens


def _jax_of(specs, lens):
    st = lens.structure
    jst = JStructure(st.stop_idx, st.sequence)
    arr = lambda a: None if a is None else jnp.asarray(a.detach().numpy())
    return (JSpecs(jst, arr(specs.epd), arr(specs.hfov)),
            JLens(jst, arr(lens.c), arr(lens.t), arr(lens.nd), arr(lens.v),
                  kappa=arr(lens.kappa), asph=arr(lens.asph)))


def _lenses():
    return {"cooke": jzoo.build("cooke"), "tessar": jzoo.build("tessar"),
            "asph": _jax_of(*zoo.aspheric_population(1, device="cpu")),
            "mixed": _jax_of(*zoo.mixed_population(2, names=("cooke", "tessar"), device="cpu"))}


def _jcfg(**kw):
    return jsim.SimulatorConfig(**dict(BASE, trace_engine="scan", **kw))


def _cfg(engine, **kw):
    return simulator.SimulatorConfig(**dict(BASE, trace_engine=engine, **kw))


def _jax_perturbation(jspecs, jlens, tol, key, asph=False):
    """JAX's noise (``jax.random.split`` and ``_noise``) and its perturbed
    population."""
    B = N_SAMPLES
    S = jlens.c.shape[1]
    k = jax.random.split(key, 6)
    dist = tol.distribution
    noise = {n: janalysis._noise(k[i], (B, S), dist) for i, n in enumerate(("c", "t", "nd", "v"))}
    if asph:
        noise["kappa"] = janalysis._noise(k[4], (B, S), dist)
        noise["asph"] = janalysis._noise(k[5], (B, S, jlens.asph.shape[-1]), dist)
    _, lens_n = janalysis.tile_population(jspecs, jlens, B)
    lens_p = janalysis.perturb_lens(lens_n, key, tol)
    fields = {n: getattr(lens_p, n) for n in ("c", "t", "nd", "v", "kappa", "asph")
              if getattr(lens_p, n) is not None}
    return {"noise": noise, "lens_p": fields}


def _jax_tolerance(jspecs, jlens, tol, key):
    """JAX's perturbation and both compensators' runs."""
    out = _jax_perturbation(jspecs, jlens, tol, key)
    out["runs"] = {str(comp): janalysis.tolerance_analysis(
        jspecs, jlens, _jcfg(), tol, N_SAMPLES, key, rms_threshold=RMS_THRESHOLD,
        compensator=comp) for comp in (None, "refocus")}
    return out


def _programs(lenses):
    """name -> (function of the lens's c, lens name) for the JAX side."""
    key = jax.random.key(3)
    tol = janalysis.Tolerances(**TOL)

    def with_c(name, fn):
        specs, lens = lenses[name]
        return lambda c: fn(specs, lens.replace(c=c))

    def mtfs(s, l):
        cfg = jsim.SimulatorConfig(**dict(IMAGING, trace_engine="scan"))
        return {"field": janalysis.field_mtf(s, l, cfg),
                "focus": janalysis.through_focus_mtf(s, l, cfg, DELTAS)}

    def fans(s, l):
        cfg = jtrace.TraceConfig(**FANS, engine="scan")
        return {"fans": janalysis.ray_fans(s, l, cfg, n=9),
                "curvature": janalysis.field_curvature(s, l, cfg, n=9),
                "longitudinal": janalysis.longitudinal_aberration(s, l, cfg, n=9)}

    def diffraction(s, l):
        cfg = jtrace.TraceConfig(**DIFFRACTION, engine="scan")
        g = (np.arange(16) + 0.5) / 16 * 2.0 - 1.0
        X, Y = np.meshgrid(g, g, indexing="xy")
        xy = tuple(jnp.asarray(a.ravel()[None, None, :, None], jnp.float32) for a in (X, Y))
        return {"mtf": janalysis.diffraction_mtf(s, l, cfg, grid_n=16, pad=4),
                "opd": jwf.opd_map(s, l, cfg, xy=xy)}

    def seidel(s, l):
        sd = janalysis.seidel_coefficients(s, l)
        return {"sums": sd, "shifts": janalysis.seidel_focal_shifts(sd)}

    return {
        "tolerance": (with_c("cooke", lambda s, l: _jax_tolerance(s, l, tol, key)), "cooke"),
        "sensitivities": (with_c("cooke", lambda s, l: janalysis.sensitivities(s, l, _jcfg())),
                          "cooke"),
        "sensitivities asph": (with_c("asph", lambda s, l: janalysis.sensitivities(
            s, l, _jcfg())), "asph"),
        "mtf": (with_c("cooke", mtfs), "cooke"),
        "diffraction": (with_c("cooke", diffraction), "cooke"),
        "fans": (with_c("tessar", fans), "tessar"),
        "seidel": (with_c("cooke", seidel), "cooke"),
        "seidel asph": (with_c("asph", seidel), "asph"),
        "seidel mixed": (with_c("mixed", seidel), "mixed"),
    }


@pytest.fixture(scope="module")
def jax_side():
    lenses = _lenses()
    progs = _programs(lenses)

    def run(item):
        fn, name = item
        c = lenses[name][1].c
        out = jax.jit(fn).lower(c).compile(FAST_COMPILE)(c)
        return jax.tree_util.tree_map(np.asarray, out)

    with ThreadPoolExecutor(len(progs)) as pool:
        out = dict(zip(progs, pool.map(run, progs.values())))
    # The aspheric population's perturbation alone: no trace, eagerly.
    out["perturbation asph"] = jax.tree_util.tree_map(np.asarray, _jax_perturbation(
        *lenses["asph"], janalysis.Tolerances(**TOL_ASPH), jax.random.key(3), asph=True))
    out["lenses"] = {k: _port(*v) for k, v in lenses.items()}
    return out


def _rel_close(got, want, bar, label=""):
    """|got - want| <= bar x max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(np.abs(want).max(), 1e-30)
    dev = np.abs(got - want).max() / scale
    assert dev <= bar, f"{label}: {dev:.3e} of the largest magnitude (bar {bar})"


def _population(jax_side, name, tol):
    """The port's tiled population with JAX's noise applied."""
    specs, lens = jax_side["lenses"][name]
    specs_n, lens_n = analysis.tile_population(specs, lens, N_SAMPLES)
    ref = jax_side["perturbation asph" if name == "asph" else "tolerance"]
    noise = {k: torch.tensor(v) for k, v in ref["noise"].items()}
    return specs_n, analysis._apply_perturbation(lens_n, noise, tol, True), ref


@pytest.mark.parametrize("name", ["cooke", "asph"])
def test_apply_perturbation_with_jax_noise(jax_side, name):
    tol = analysis.Tolerances(**(TOL_ASPH if name == "asph" else TOL))
    _, lens_p, ref = _population(jax_side, name, tol)
    for k, want in ref["lens_p"].items():
        np.testing.assert_allclose(getattr(lens_p, k).numpy(), want, rtol=1e-6, atol=0, err_msg=k)
    # Sample 0 is the nominal design, the padding surfaces untouched.
    specs, lens = jax_side["lenses"][name]
    assert torch.equal(lens_p.c[0], lens.c[0]) and torch.equal(lens_p.t[0], lens.t[0])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("compensator", [None, "refocus"])
def test_score_population_matches_jax(jax_side, engine, compensator):
    ref = jax_side["tolerance"]
    want = ref["runs"][str(compensator)]
    specs_n, _ = analysis.tile_population(*jax_side["lenses"]["cooke"], N_SAMPLES)
    lens_jp = convert.lens_from_numpy(specs_n.structure.stop_idx, specs_n.structure.sequence,
                                      *(ref["lens_p"][k] for k in ("c", "t", "nd", "v")),
                                      device="cpu")
    got = analysis._score_population(specs_n, lens_jp, _cfg(engine), compensator,
                                     (50.0, 90.0, 99.0), RMS_THRESHOLD)
    np.testing.assert_allclose(got["rms"].numpy(), want["rms"], rtol=2e-4, atol=1e-6)
    for k in STATS:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-4, atol=1e-6, err_msg=k)
    if compensator is not None:
        np.testing.assert_allclose(got["refocus_delta"].numpy(), want["refocus_delta"],
                                   rtol=5e-6, atol=5e-6)
    assert float(got["std"]) > 0.0


def test_aspheric_tolerance_engines_agree(jax_side):
    """JAX's perturbed aspheric population (kappa and relative asphere
    tolerances), scored on the fused engine (kernel K4's Lu mode through its
    plain version here) and on the unroll engine, at JAX's own bar between
    its Pallas and XLA tolerance runs."""
    tol = analysis.Tolerances(**TOL_ASPH)
    specs_n, lens_p, _ = _population(jax_side, "asph", tol)
    got = {engine: analysis._score_population(specs_n, lens_p, _cfg(engine), None,
                                              (50.0, 90.0, 99.0), RMS_THRESHOLD)
           for engine in ENGINES}
    for k in ("rms",) + STATS:
        np.testing.assert_allclose(got["fused"][k].numpy(), got["unroll"][k].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    assert float(got["fused"]["std"]) > 0.0


def test_statistics_semantics():
    """``std`` is the population std (ddof 0, JAX's ``jnp.std``) and the
    percentiles interpolate linearly (``jnp.percentile``), on an even-length
    sample, through ``_score_population``'s own summary."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(0.01, 0.03, 6).astype(np.float32))
    qs = (12.5, 50.0, 90.0, 99.0)
    got = {f"p{q:g}": torch.quantile(x, q / 100.0, interpolation="linear") for q in qs}
    for q in qs:
        np.testing.assert_allclose(got[f"p{q:g}"].numpy(),
                                   np.asarray(jnp.percentile(jnp.asarray(x.numpy()), q)),
                                   rtol=1e-6)
    np.testing.assert_allclose(torch.std(x, correction=0).numpy(),
                               np.asarray(jnp.std(jnp.asarray(x.numpy()))), rtol=1e-6)
    assert not np.isclose(float(torch.std(x)), float(torch.std(x, correction=0)))


def test_perturb_lens_draws_in_jax_order():
    """``perturb_lens`` draws c, t, nd, v, kappa, asph from its generator in
    that order; sample 0 stays nominal; uniform noise is U(-1, 1); a
    tolerance of zero leaves a parameter alone."""
    specs, lens = zoo.aspheric_population(1, device="cpu")
    _, lens_n = analysis.tile_population(specs, lens, 5)
    for dist in ("normal", "uniform"):
        tol = analysis.Tolerances(**TOL_ASPH, distribution=dist)
        got = analysis.perturb_lens(lens_n, torch.Generator().manual_seed(11), tol)
        gen = torch.Generator().manual_seed(11)
        B, S = lens_n.c.shape
        noise = {}
        for k, shape in (("c", (B, S)), ("t", (B, S)), ("nd", (B, S)), ("v", (B, S)),
                         ("kappa", (B, S)), ("asph", (B, S, lens_n.asph.shape[-1]))):
            noise[k] = (torch.rand(shape, generator=gen) * 2 - 1 if dist == "uniform"
                        else torch.randn(shape, generator=gen))
        want = analysis._apply_perturbation(lens_n, noise, tol, True)
        for k in ("c", "t", "nd", "v", "kappa", "asph"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
            assert torch.equal(getattr(got, k)[0], getattr(lens_n, k)[0]), k
        assert not torch.equal(got.c, lens_n.c) and torch.equal(got.nd, lens_n.nd)
    assert torch.equal(analysis.perturb_lens(lens_n, None, analysis.Tolerances(c=1e-4)).t,
                       lens_n.t)


def test_tolerances_and_tile_population():
    with pytest.raises(ValueError, match="distribution"):
        analysis.Tolerances(distribution="lognormal")
    specs, lens = zoo.build("cooke", device="cpu")
    specs_n, lens_n = analysis.tile_population(specs, lens, 5)
    assert len(lens_n) == 5 and len(specs_n) == 5
    assert torch.equal(lens_n.c, lens.c.repeat(5, 1))
    js, jl = jzoo.build("cooke")
    _, jl_n = janalysis.tile_population(js, jl, 5)
    assert lens_n.structure.stop_idx == tuple(jl_n.structure.stop_idx)
    assert lens_n.structure.sequence == tuple(jl_n.structure.sequence)
    with pytest.raises(ValueError, match="single design"):
        analysis.tile_population(specs_n, lens_n, 2)
    with pytest.raises(ValueError, match="compensator"):
        analysis.tolerance_analysis(specs, lens, _cfg("unroll"), analysis.Tolerances(), 2,
                                    compensator="tilt")
    # Zero tolerances give the nominal design in every sample.
    out = analysis.tolerance_analysis(specs, lens, _cfg("fused"), analysis.Tolerances(), 4,
                                      torch.Generator().manual_seed(0))
    assert torch.all(out["rms"] == out["rms"][0]) and float(out["std"]) == 0.0


@pytest.mark.parametrize("name", ["cooke", "asph"])
def test_sensitivities_match_jax(jax_side, name):
    """d(spot RMS)/d(parameter) on the fused engine (K2's or K4's Lu mode and
    its hand adjoint, through their plain versions here) and the unroll
    engine's autograd, against ``jax.grad`` on JAX's XLA engine.

    The bars are each entry's deviation over the largest entry of its table.
    Aspheric: 2e-3. Spherical: 5e-5, which is the float32 floor of this
    quantity and not the 1.2e-7 the JAX package holds its kernels' per-ray
    adjoints to: the same sensitivities in float64 (the unroll engine with
    ``double_precision``) sit 1.4e-5 to 2.3e-5 of the largest entry from the
    float32 ones (their sum over rays cancels), and JAX's Pallas and XLA
    population gradients are held to 1e-2 (``tests/test_pallas_batch.py``).
    Between the port's two engines the spherical tables agree within 1e-6."""
    sph = name == "cooke"
    want = jax_side["sensitivities" if sph else "sensitivities asph"]
    specs, lens = jax_side["lenses"][name]
    got = {engine: analysis.sensitivities(specs, lens, _cfg(engine)) for engine in ENGINES}
    mask = lens.structure.mask[0]
    for engine, table in got.items():
        assert set(table) == set(want)
        for k, w in want.items():
            _rel_close(table[k].numpy(), w, 5e-5 if sph else 2e-3, f"{name} {engine} d/d{k}")
            assert np.all(table[k].numpy()[0, ~mask] == 0.0), k
    if sph:
        f64 = analysis.sensitivities(specs, lens, _cfg("unroll", double_precision=True))
        for k in want:
            _rel_close(got["fused"][k].numpy(), got["unroll"][k].numpy(), 1e-6, f"engines d/d{k}")
            _rel_close(got["fused"][k].numpy(), f64[k].numpy(), 5e-5, f"float64 d/d{k}")


def test_mtfs_match_jax(jax_side):
    """The geometric MTFs within 5e-4: they splat float32 ray coordinates,
    and JAX's own unroll and scan engines give MTFs 2.2e-4 apart on these
    inputs (the through-focus tangential cut)."""
    specs, lens = jax_side["lenses"]["cooke"]
    for engine in ENGINES:
        cfg = simulator.SimulatorConfig(**dict(IMAGING, trace_engine=engine))
        got = {"field": analysis.field_mtf(specs, lens, cfg),
               "focus": analysis.through_focus_mtf(specs, lens, cfg, DELTAS)}
        for part in ("field", "focus"):
            want = jax_side["mtf"][part]
            assert set(got[part]) == set(want)
            for k, w in want.items():
                assert got[part][k].shape == w.shape, (part, k)
                np.testing.assert_allclose(got[part][k].numpy(), w, rtol=0, atol=5e-4,
                                           err_msg=f"{engine} {part} {k}")
    assert got["focus"]["mtf_t"].shape == (len(DELTAS), 3, 3, 17)


def test_diffraction_mtf_matches_jax(jax_side, monkeypatch):
    """From JAX's own OPD map the port's cuts are within 1e-4 of the same
    cuts in float64 (they come within 7e-7), and no farther from JAX's than
    JAX's are from float64 plus 1e-4: JAX's jitted float32 cuts on the CPU
    sit up to 6.5e-4 from float64 here. Its frequencies and cutoffs match
    JAX's. End to end (the port's own OPD, held to JAX's within 5e-5 mm by
    ``test_torch_wavefront.py``) the cuts are finite and 1 at zero
    frequency."""
    specs, lens = jax_side["lenses"]["cooke"]
    want = jax_side["diffraction"]
    for engine in ENGINES:
        cfg = trace.TraceConfig(**DIFFRACTION, engine=engine)
        got = analysis.diffraction_mtf(specs, lens, cfg, grid_n=16, pad=4)
        assert all(np.isfinite(v.numpy()).all() for v in got.values())
        np.testing.assert_allclose(got["mtf_t"][..., 0].numpy(), 1.0, rtol=1e-6)
        np.testing.assert_allclose(got["rel_freqs"].numpy(), want["mtf"]["rel_freqs"])
        np.testing.assert_allclose(got["cutoff_cyc_mm"].numpy(), want["mtf"]["cutoff_cyc_mm"],
                                   rtol=5e-6)
    jax_opd = {k: torch.tensor(v) for k, v in want["opd"].items()}
    monkeypatch.setattr(analysis.wf, "opd_map", lambda *a, **kw: jax_opd)
    got = analysis.diffraction_mtf(specs, lens, cfg, grid_n=16, pad=4)
    f64 = chip_smoke.float64_cuts(want["opd"], [w * 1e-6 for w in DIFFRACTION["wavelengths"]],
                                  16, 4)
    for k, ref in f64.items():
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0, atol=1e-4, err_msg=k)
        jax_err = np.abs(want["mtf"][k] - ref).max()
        assert np.abs(got[k].numpy() - want["mtf"][k]).max() <= jax_err + 1e-4, k


def test_fans_curvature_and_longitudinal_match_jax(jax_side):
    """Masks identical; fan deviations and the longitudinal focus shifts
    within 5e-6 mm or relative; the field curves within 5e-5 mm: their
    closed-form best focus divides differences of nearby float32 rays, and
    JAX's own unroll and scan engines give them 2.3e-5 mm apart here."""
    specs, lens = jax_side["lenses"]["tessar"]
    want = jax_side["fans"]
    for engine in ENGINES:
        cfg = trace.TraceConfig(**FANS, engine=engine)
        got = {"fans": analysis.ray_fans(specs, lens, cfg, n=9),
               "curvature": analysis.field_curvature(specs, lens, cfg, n=9),
               "longitudinal": analysis.longitudinal_aberration(specs, lens, cfg, n=9)}
        for part, values in want.items():
            for k, w in values.items():
                g = got[part][k].numpy()
                assert g.shape == w.shape, (part, k)
                if w.dtype == bool:
                    np.testing.assert_array_equal(g, w, err_msg=f"{part} {k}")
                elif part == "curvature":
                    np.testing.assert_allclose(g, w, rtol=0, atol=5e-5, err_msg=f"{engine} {k}")
                else:
                    np.testing.assert_allclose(g, w, rtol=5e-6, atol=5e-6,
                                               err_msg=f"{engine} {part} {k}")
    with pytest.raises(ValueError, match="odd"):
        analysis.ray_fans(specs, lens, cfg, n=8)
    with pytest.raises(ValueError, match="odd"):
        analysis.field_curvature(specs, lens, cfg, n=8)


@pytest.mark.parametrize("name", ["cooke", "asph", "mixed"])
def test_seidel_matches_jax(jax_side, name):
    """Each sum, per-surface contribution and focal shift within 1e-5 of the
    largest per-surface magnitude of its kind (a sum like S3 cancels to a
    tenth of its terms)."""
    specs, lens = jax_side["lenses"][name]
    sd = analysis.seidel_coefficients(specs, lens)
    got = {"sums": sd, "shifts": analysis.seidel_focal_shifts(sd)}
    want = jax_side["seidel" if name == "cooke" else f"seidel {name}"]
    per = want["sums"]["per_surface"]
    for k, w in per.items():
        scale = np.abs(w).max()
        for a, b in ((sd["per_surface"][k].numpy(), w), (sd[k].numpy(), want["sums"][k])):
            assert np.abs(a - b).max() <= 1e-5 * scale, (k, np.abs(a - b).max() / scale)
    for k in ("H", "u_img"):
        np.testing.assert_allclose(sd[k].numpy(), want["sums"][k], rtol=1e-5)
    u2 = np.maximum(want["sums"]["u_img"] ** 2, 1e-16)
    for k, w in want["shifts"].items():
        term = {"lsa_marginal": "S1", "dz_t": "S3", "dz_s": "S3", "chromatic_shift": "C1"}[k]
        scale = 3.0 * np.abs(per[term]).max() / u2 + np.abs(per["S4"]).max() / u2
        assert np.all(np.abs(got["shifts"][k].numpy() - w) <= 1e-5 * scale), k


def _public(module):
    names = set(getattr(module, "__all__", ()))
    names |= {n for n, v in vars(module).items()
              if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == module.__name__}
    return names


@pytest.mark.parametrize("jax_module,port_module", [
    (jmetrics, metrics), (jvig, vignetting), (janalysis, analysis)])
def test_public_names_have_counterparts(jax_module, port_module):
    missing = {n for n in _public(jax_module) if not hasattr(port_module, n)}
    assert not missing, missing
    assert set(getattr(jax_module, "__all__", ())) <= set(getattr(port_module, "__all__", ()))
    if jax_module is janalysis:
        assert analysis.__all__ == janalysis.__all__


def test_example_runs_on_the_cpu():
    """``python -m torchoptics_tpu_torch.examples.tolerance_analysis --device
    cpu --samples 8`` prints the JAX example's report; without ``--device
    cpu`` it raises on a machine without a GPU."""
    from torchoptics_tpu_torch.examples import tolerance_analysis as example
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        example.main(["--device", "cpu", "--samples", "8", "--rms-threshold", "0.01"])
    text = buf.getvalue()
    for line in ("8 perturbed samples", "nominal RMS", "yield(RMS<=0.01)", "refocus shifts",
                 "Sensitivity d(RMS)/d(param)", "MTF_t @", "On-axis wavefront @ 520nm: Strehl"):
        assert line in text, (line, text)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            example.main(["--samples", "8"])
