"""Port parity for the population losses: ``fused_batch.batched_unsupervised_loss``,
``fused_batch.batched_compute_losses_fused``, the grouped full loss of a
population of mixed lens types (``simulator.compute_losses``), and the
population paths of ``simulator.do_ray_tracing`` and ``trace.trace_rays``,
against the JAX package's counterparts on the same numbers.

The JAX side is the Pallas engine in interpret mode, jitted (eager Pallas
recompiles every call), compiled on threads. Its kernels' hand adjoints have
the port's semantics at the theta clip edge and at a hinge bound, where the
unrolled engines differ from them (ROADMAP.md queue 3); the bounds are the
tight ones of ``test_torch_optimize``, away from any tie.

Populations (``zoo.population``, ``zoo.mixed_population``, seeded):
three perturbed Cooke triplets; two Cooke triplets and two double-Gauss
lenses padded to 11 surfaces. 3 fields x 4x4 circular pupil x 3 wavelengths,
ray aiming on. Bars: loss values 1e-5 relative (``rms`` and ``spot_size``
2e-4, as ``test_torch_simulator``); d/d(c, t) within 1e-4 of their largest
magnitude.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu import simulator as jsim
from torchoptics_tpu.models import glass as jglass
from torchoptics_tpu.models.structure import Lens as JLens
from torchoptics_tpu.models.structure import Specs as JSpecs
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu_torch import simulator, trace, zoo
from torchoptics_tpu_torch.models import glass
from torchoptics_tpu_torch.ops import fused_batch

BASE = dict(n_sampled_fields=3, n_pupil_rings=4, pupil_sampling="circular",
            n_ray_aiming_iter=1, ray_path_lower_thresholds=(0.5, 1.5, 12.0),
            ray_path_upper_thresholds=(None, 3.0, 40.0), ray_angle_threshold=30.0)
VALUE_RTOL = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4, "spot_size": 2e-4,
              "ray_path": 1e-5, "ray_angle": 1e-5, "glass": 1e-5}
GRAD_BAR = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _populations():
    return {"cooke": zoo.population("cooke", 3, device="cpu"),
            "mixed": zoo.mixed_population(4, device="cpu")}


def _jax(specs, lens):
    st = lens.structure
    jst = JStructure(st.stop_idx, st.sequence)
    arr = lambda a: jnp.asarray(a.detach().numpy())
    return (JSpecs(jst, arr(specs.epd), arr(specs.hfov)),
            JLens(jst, arr(lens.c), arr(lens.t), arr(lens.nd), arr(lens.v)))


def _g(lens):
    """Glass variables moved off the catalog (the glass penalty's gradient is
    NaN exactly on it)."""
    return (glass.g_from_n_v(lens.flat_nd, lens.flat_v) + 0.01).detach()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's full loss of each population on the Pallas engine (the mixed one
    grouped by lens type), its value and d/d(c, t), and for the Cooke
    population also d Lu/d(c, t) (the vjp of the same trace with the
    cotangent on ``loss_unsup`` alone: the full-mode kernel with zero hinge
    cotangents, which the Pallas adjoint adds as exact zeros)."""
    pops = _populations()
    cfg = jsim.SimulatorConfig(trace_engine="pallas", **BASE)
    catalog = jglass.default_catalog_g()
    lowered = {}
    # The mixed population's program is the largest: it compiles on a thread
    # while the next one is lowered here.
    with ThreadPoolExecutor(2) as pool:
        for name in ("mixed", "cooke"):
            specs, lens = pops[name]
            jspecs, jlens = _jax(specs, lens)
            g = jnp.asarray(_g(lens).numpy())

            def run(c, t, jspecs=jspecs, jlens=jlens, g=g):
                (total, ld), vjp = jax.vjp(lambda c, t: jsim.compute_losses(
                    jspecs, jlens.replace(c=c, t=t), cfg, g=g, catalog_g=catalog), c, t)
                cot = lambda key: (jnp.ones(()) if key == "total" else jnp.zeros(()),
                                   {k: jnp.ones(()) if k == key else jnp.zeros(()) for k in ld})
                grads = {"total": vjp(cot("total"))}
                if name == "cooke":
                    grads["lu"] = vjp(cot("loss_unsup"))
                return total, ld, grads
            with pltpu.force_tpu_interpret_mode():
                low = jax.jit(run).lower(jlens.c, jlens.t)
            lowered[name] = (pool.submit(low.compile, compiler_options=FAST_COMPILE), jlens)
        compiled = {k: (c.result(), jlens) for k, (c, jlens) in lowered.items()}
    out = dict(pops=pops)
    for name, (fn, jlens) in compiled.items():
        total, ld, grads = fn(jlens.c, jlens.t)
        loss = {k: float(v) for k, v in ld.items()}
        out[name, "full"] = dict(total=float(total), loss=loss,
                                 grads=[np.asarray(a) for a in grads["total"]])
        if "lu" in grads:
            out[name, "lu"] = dict(total=loss["loss_unsup"],
                                   loss={k: loss[k] for k in ("loss_unsup", "rms", "penalty")},
                                   grads=[np.asarray(a) for a in grads["lu"]])
    return out


def _rel_close(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), label
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= GRAD_BAR, f"{label}: {err:.3e} of the largest magnitude"


def _check(loss, total, grads, want, mask):
    """Values, and the gradients on real surfaces: on a padded population the
    padded slots' thicknesses move the image plane (d/dt there is d/dt of
    the last real gap), while the grouped loss traces each type at its own
    length and gives them no gradient."""
    assert set(want["loss"]) <= set(loss)
    for k, v in want["loss"].items():
        np.testing.assert_allclose(float(loss[k]), v, rtol=VALUE_RTOL[k], atol=0, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), want["total"], rtol=1e-5, atol=0)
    for got, w, label in zip(grads, want["grads"], ("dc", "dt")):
        _rel_close(np.where(mask, got.numpy(), 0.0), np.where(mask, w, 0.0), label)


def _leaves(lens):
    c = lens.c.clone().requires_grad_(True)
    t = lens.t.clone().requires_grad_(True)
    return lens.replace(c=c, t=t), (c, t)


@pytest.mark.parametrize("route", ["batched_unsupervised_loss", "fused", "unroll"])
def test_population_lu_matches_jax(route, jax_side):
    """The Lu objective of a population: ``batched_unsupervised_loss``
    directly, and ``simulator.do_ray_tracing`` on both engines."""
    specs, lens = jax_side["pops"]["cooke"]
    lens, leaves = _leaves(lens)
    cfg = simulator.SimulatorConfig(trace_engine="unroll" if route == "unroll" else "fused",
                                    **BASE)
    if route == "batched_unsupervised_loss":
        total, per_system = fused_batch.batched_unsupervised_loss(specs, lens, cfg)
        assert all(v.shape == (3,) for v in per_system.values())
        loss = {k: torch.mean(v).detach() for k, v in per_system.items()}
    else:
        _, loss = simulator.do_ray_tracing(specs, lens, cfg)
        total = loss["loss_unsup"]
        loss = {k: v.detach() for k, v in loss.items()}
    _check(loss, total, torch.autograd.grad(total, leaves), jax_side["cooke", "lu"],
           lens.structure.mask)


@pytest.mark.parametrize("name", ["cooke", "mixed"])
@pytest.mark.parametrize("engine", ["fused", "unroll"])
def test_population_full_loss_matches_jax(name, engine, jax_side):
    """``simulator.compute_losses`` on a population of one lens type (one K2
    launch) and of mixed lens types (one launch per type), both engines."""
    specs, lens = jax_side["pops"][name]
    g = _g(lens)
    lens, leaves = _leaves(lens)
    cfg = simulator.SimulatorConfig(trace_engine=engine, **BASE)
    total, loss = simulator.compute_losses(specs, lens, cfg, g=g,
                                           catalog_g=glass.default_catalog_g(device="cpu"))
    loss = {k: v.detach() for k, v in loss.items()}
    want = jax_side[name, "full"]
    assert want["loss"]["ray_path"] > 0 and want["loss"]["glass"] > 0
    _check(loss, total, torch.autograd.grad(total, leaves), want, lens.structure.mask)


def test_grouped_loss_is_the_weighted_groups(jax_side):
    """The grouped full loss is the B_g / B weighted sum of each group's
    batched loss, with the glass penalty once; the grouping calls K2's full
    mode once per lens type."""
    from torchoptics_tpu_torch import simulator as sim
    specs, lens = jax_side["pops"]["mixed"]
    cfg = simulator.SimulatorConfig(trace_engine="fused", **BASE)
    _, loss = sim.compute_losses(specs, lens, cfg)
    parts = [fused_batch.batched_compute_losses_fused(specs[idx], lens[idx], cfg)[1]
             for idx in (np.array([0, 1]), np.array([2, 3]))]
    for k, v in loss.items():
        np.testing.assert_allclose(float(v), sum(0.5 * float(p[k]) for p in parts), rtol=1e-6)
    with pytest.raises(ValueError, match="homogeneous"):
        fused_batch.batched_compute_losses_fused(specs, lens, cfg)


def test_population_trace_rays_matches_unroll(jax_side):
    """``trace_rays(engine='fused')`` on the padded population equals the
    pure-torch engine: masks identical, coordinates within 5e-6."""
    specs, lens = jax_side["pops"]["mixed"]
    cfg = simulator.SimulatorConfig(**BASE)
    res_u = trace.trace_rays(specs, lens, cfg.trace_config())
    res_f = trace.trace_rays(specs, lens, cfg.trace_config(engine="fused"))
    assert res_f.x.shape == res_u.x.shape == (4, 3, 16, 3) and res_f.stacks is None
    assert torch.equal(res_f.ray_ok, res_u.ray_ok)
    assert torch.equal(res_f.ray_backward, res_u.ray_backward)
    for a, b in zip(res_f[:4], res_u[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=5e-6)


def test_population_refuses_aspheres():
    """A population of aspheres runs on kernel K4 (it raised before K4 was
    ported): two copies of the aspherized double-Gauss give kernel K3's
    single-system Lu and full losses and their per-ray outputs; double
    precision still raises."""
    from torchoptics_tpu_torch.ops import fused_asphere, fused_trace
    specs, lens = zoo.build("double_gauss_asph", device="cpu")
    pair = np.array([0, 0])
    cfg = simulator.SimulatorConfig(trace_engine="fused", **BASE)
    lu, lu_dict = fused_batch.batched_unsupervised_loss(specs[pair], lens[pair], cfg)
    want_lu, want_dict = fused_trace.unsupervised_loss_fused(specs, lens, cfg)
    np.testing.assert_allclose(float(lu), float(want_lu), rtol=1e-6)
    for k, v in lu_dict.items():
        assert v.shape == (2,) and float(v[0]) == float(v[1])
        np.testing.assert_allclose(float(v[0]), float(want_dict[k]), rtol=1e-6, err_msg=k)
    total, full = fused_batch.batched_compute_losses_fused(specs[pair], lens[pair], cfg)
    want_total, want_full = fused_asphere.compute_losses_fused_asphere(specs, lens, cfg)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
    for k, v in want_full.items():
        np.testing.assert_allclose(float(full[k]), float(v), rtol=1e-6, err_msg=k)
    res = fused_batch.trace_rays_fused_batch(specs[pair], lens[pair], cfg.trace_config())
    want = fused_trace.trace_rays_fused(specs, lens, cfg.trace_config())
    for a, b in zip(res[:6], want[:6]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[0])
    with pytest.raises(NotImplementedError, match="float32"):
        fused_batch.batched_unsupervised_loss(
            specs[pair], lens[pair], simulator.SimulatorConfig(
                trace_engine="fused", double_precision=True, **BASE))
