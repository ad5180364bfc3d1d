"""Port parity for the rest of ``ops.metrics``: distortion, the effective
semi-apertures, the residual ray-aiming error and the axial and lateral
colour.

The same lenses go through the JAX package and the port (on the CPU): a
padded population of the Cooke triplet and the Tessar, each system's stop
and last surface at its own index, also with vignetting factors. On the JAX
side every metric runs once for the module, jitted with a fast compile on
threads (the metrics build their own unroll-engine trace configurations).

Bars: masks identical; heights, semi-apertures, aiming errors, distortion
and colour within 5e-6 mm or relative (the forward bar between the JAX
package's engines).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.models.structure import Lens as JLens
from torchoptics_tpu.models.structure import Specs as JSpecs
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import metrics as jmetrics
from torchoptics_tpu.ops import vignetting as jvig
from torchoptics_tpu_torch import zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import metrics
from torchoptics_tpu_torch.ops import vignetting as vig

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BAR = 5e-6
FIELDS = (0.0, 0.3, 0.7, 1.0)      # distortion is 0/0 = NaN on axis, in both packages
AIM_FIELDS = (0.0, 0.7, 1.0)
VIG = (0.3, 0.15, 0.1)      # vig_up, vig_down, vig_x of the vignetted aiming case


def _port(jspecs, jlens):
    st = jlens.structure
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), np.asarray(jspecs.vig_up),
                                     np.asarray(jspecs.vig_down), np.asarray(jspecs.vig_x),
                                     device="cpu")
    lens = convert.lens_from_numpy(st.stop_idx, st.sequence,
                                   *(np.asarray(a) for a in (jlens.c, jlens.t, jlens.nd,
                                                             jlens.v)), device="cpu")
    return specs, lens


def _jax_of(specs, lens):
    st = lens.structure
    jst = JStructure(st.stop_idx, st.sequence)
    arr = lambda a: jnp.asarray(a.detach().numpy())
    return (JSpecs(jst, arr(specs.epd), arr(specs.hfov), arr(specs.vig_up),
                   arr(specs.vig_down), arr(specs.vig_x)),
            JLens(jst, arr(lens.c), arr(lens.t), arr(lens.nd), arr(lens.v)))


def _lenses():
    """name -> (JAX specs, lens): a padded population of the Cooke and the
    Tessar (each system's stop and last surface at its own index), and the
    same with the vignetting factors VIG."""
    js, jl = _jax_of(*zoo.mixed_population(2, names=("cooke", "tessar"), device="cpu"))
    vig_specs = dataclasses.replace(js, **{k: jnp.full((2,), v, jnp.float32) for k, v in
                                           zip(("vig_up", "vig_down", "vig_x"), VIG)})
    return {"mixed": (js, jl), "mixed_vig": (vig_specs, jl)}


def _programs():
    """key -> (JAX metric, port metric, lens name), each metric a function
    of (specs, lens)."""
    progs = {
        "distortion": (lambda s, l: jmetrics.compute_distortion(s, l, FIELDS),
                       lambda s, l: metrics.compute_distortion(s, l, FIELDS)),
        "semi_apertures": (lambda s, l: jmetrics.compute_semi_apertures(s, l, n_rays=9),
                           lambda s, l: metrics.compute_semi_apertures(s, l, n_rays=9)),
        "axial_color": (lambda s, l: jmetrics.compute_axial_color(l),
                        lambda s, l: metrics.compute_axial_color(l)),
        "lateral_color": (lambda s, l: jmetrics.compute_lateral_color(s, l, rel_field=0.8),
                          lambda s, l: metrics.compute_lateral_color(s, l, rel_field=0.8)),
    }
    progs = {k: v + ("mixed",) for k, v in progs.items()}
    for mode in ("real", "paraxial"):
        progs[f"aiming_error {mode}"] = (
            lambda s, l, m=mode: jmetrics.compute_ray_aiming_error(
                s, l, AIM_FIELDS, n_ray_aiming_iter=1, ray_aiming_mode=m),
            lambda s, l, m=mode: metrics.compute_ray_aiming_error(
                s, l, AIM_FIELDS, n_ray_aiming_iter=1, ray_aiming_mode=m), "mixed")
    progs["aiming_error vignetted"] = (
        lambda s, l: jmetrics.compute_ray_aiming_error(
            s, l, AIM_FIELDS, vig_fn=jvig.quadratic_vig_fn, n_ray_aiming_iter=2),
        lambda s, l: metrics.compute_ray_aiming_error(
            s, l, AIM_FIELDS, vig_fn=vig.quadratic_vig_fn, n_ray_aiming_iter=2), "mixed_vig")
    return progs


@pytest.fixture(scope="module")
def sides():
    lenses = _lenses()
    progs = _programs()

    def run_jax(item):
        jfn, _, name = item
        jspecs, jlens = lenses[name]
        fn = lambda c: jfn(jspecs, jlens.replace(c=c))
        return np.asarray(jax.jit(fn).lower(jlens.c).compile(FAST_COMPILE)(jlens.c))

    with ThreadPoolExecutor(8) as pool:
        jax_out = dict(zip(progs, pool.map(run_jax, progs.values())))
    port_out = {}
    for key, (_, pfn, name) in progs.items():
        port_out[key] = pfn(*_port(*lenses[name])).numpy()
    return jax_out, port_out


def _close(got, want, bar=BAR):
    np.testing.assert_allclose(got, want, rtol=bar, atol=bar)


@pytest.mark.parametrize("metric", ["distortion", "semi_apertures", "axial_color",
                                    "lateral_color"])
def test_metric_matches_jax(sides, metric):
    jax_out, port_out = sides
    got, want = port_out[metric], jax_out[metric]
    assert got.shape == want.shape and got.shape[0] == 2
    if metric == "distortion":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[:, 0]).all()
        got, want = got[:, 1:], want[:, 1:]
    assert np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("mode", ["real", "paraxial", "vignetted"])
def test_ray_aiming_error_matches_jax(sides, mode):
    jax_out, port_out = sides
    got, want = port_out[f"aiming_error {mode}"], jax_out[f"aiming_error {mode}"]
    assert got.shape == want.shape == (2, len(AIM_FIELDS), 2, 1)
    _close(got, want)


def test_ray_aiming_error_zero_when_stop_first():
    """The stop is the singlet's first surface: the float 0.0, as in JAX."""
    specs, lens = zoo.build("singlet", device="cpu")
    out = metrics.compute_ray_aiming_error(specs, lens, [0.0, 1.0])
    assert out == 0.0 and isinstance(out, float)
    js, jl = jzoo.build("singlet")
    assert jmetrics.compute_ray_aiming_error(js, jl, [0.0, 1.0]) == out
    with pytest.raises(ValueError):
        metrics.compute_ray_aiming_error(*zoo.build("cooke", device="cpu"), [0.0, 1.0],
                                         ray_aiming_mode="bogus")


def test_axial_color_closes_on_bfl():
    """BFL(F) - BFL(C) from the ABCD chain equals the difference of the
    port's own first-order BFLs of the lens re-glassed at each line (the
    dispersion model evaluated at one wavelength as a dispersionless nd)."""
    specs, lens = zoo.build("cooke", device="cpu")
    n = lens.get_refractive_indices(("F", "C"))
    bfl = []
    for w in range(2):
        lw = lens.replace(nd=torch.where(torch.as_tensor(lens.structure.mask_G), n[..., w], 1.0),
                          v=torch.zeros_like(lens.v))
        bfl.append(lw.bfl)
    np.testing.assert_allclose(metrics.compute_axial_color(lens).numpy(),
                               (bfl[0] - bfl[1]).numpy(), rtol=1e-4, atol=1e-7)
