"""Port parity for the losses and the trainer on a conic/asphere system:
``simulator.do_ray_tracing`` and ``compute_losses`` on the fused engine
(kernel K3's plain versions here) and on the pure-torch engine, against the
JAX package's Pallas engine, and one ``LensOptimizer`` Adam step with
``kappa`` and ``asph`` among the trained variables, from the same state as
JAX (``convert.opt_state_from_numpy``).

The lens is the Cooke triplet with the aspheres of ``test_pallas_asphere.py``
at 3 fields x 4² circular pupil x 3 wavelengths, without ray aiming, with
tight path and angle bounds so that both hinges fire, and its glasses off the
catalog. The JAX side is evaluated once per module: its losses on the Pallas
engine (interpret mode) and on the jnp engine's scan form, each one jitted
program compiled on a thread, and its Adam steps on the scan form, jitted.

Bars, as ``test_torch_optimize.py``: loss values 1e-5 relative (the RMS
2e-4); gradients in (c, kappa, asph, t) within 1e-4 of their largest
magnitude plus JAX's own scan-vs-Pallas distance; one Adam step: the loss
within 1e-5 relative and every parameter within 5e-6 + 1e-6 relative (a step
moves each by about the learning rate, 1e-4).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu import optimize as jopt
from torchoptics_tpu import simulator as jsim
from torchoptics_tpu.models import glass as jglass
from torchoptics_tpu_torch import LensOptimizer, simulator
from torchoptics_tpu_torch.models import convert, glass
from test_torch_asphere import asphere_cooke, port

BAR = 1e-4
TIGHT = dict(ray_path_lower_thresholds=(0.5, 1.5, 12.0),
             ray_path_upper_thresholds=(None, 3.0, 40.0), ray_angle_threshold=30.0)
BASE = dict(n_sampled_fields=3, n_pupil_rings=4, pupil_sampling="circular", n_ray_aiming_iter=0,
            **TIGHT)
VALUE_RTOL = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4, "spot_size": 2e-4,
              "ray_path": 1e-5, "ray_angle": 1e-5, "glass": 1e-5}
# kappa and asph are trained beside the default (c, t, g).
TRAINABLE = ("c", "t", "g", "kappa", "asph")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _losses_program(jspecs, jlens, g, catalog):
    """JAX's compute_losses (value and d/d(c, kappa, asph, t)) and
    do_ray_tracing's loss dict on one engine, as one jitted program."""
    def run(engine):
        cfg = jsim.SimulatorConfig(trace_engine=engine, **BASE)

        def total(c, kappa, asph, t):
            lens = jlens.replace(c=c, kappa=kappa, asph=asph, t=t)
            return jsim.compute_losses(jspecs, lens, cfg, g=g, catalog_g=catalog)

        def program(c, kappa, asph, t):
            (tot, ld), grads = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(
                c, kappa, asph, t)
            _, lu = jsim.do_ray_tracing(jspecs, jlens.replace(c=c, kappa=kappa, asph=asph, t=t),
                                        cfg)
            return tot, ld, grads, lu
        return jax.jit(program)
    return run


def _seeded_state(jparams, seed=0):
    """Adam moments from a seed, count 3: a state in the middle of a run."""
    rng = np.random.default_rng(seed)
    mu = {k: (rng.normal(0.0, 1.0, np.shape(v)) * 1e-2).astype(np.float32)
          for k, v in jparams.items()}
    nu = {k: (rng.uniform(0.5, 2.0, np.shape(v)) * 1e-4).astype(np.float32)
          for k, v in jparams.items()}
    return mu, nu, 3


def _jax_step(jspecs, jlens, full):
    """One JAX Adam step (scan engine, jitted) from a seeded state."""
    o = jopt.LensOptimizer(specs=jspecs, config=jsim.SimulatorConfig(trace_engine="scan", **BASE),
                           learning_rate=1e-4, use_full_loss=full,
                           efl_target=float(jlens.efl[0]), trainable=TRAINABLE)
    state = o.init(jlens)
    assert {"kappa", "asph"} <= set(state.params)
    mu, nu, count = _seeded_state(state.params)
    adam = state.opt_state[0]._replace(count=jnp.asarray(count, jnp.int32),
                                       mu={k: jnp.asarray(v) for k, v in mu.items()},
                                       nu={k: jnp.asarray(v) for k, v in nu.items()})
    state = jopt.OptState(state.params, (adam,) + tuple(state.opt_state[1:]), state.step)
    step = jax.jit(lambda s: o._step_impl(s, None)[:2])
    return state, dict(params={k: np.asarray(v) for k, v in state.params.items()}, mu=mu, nu=nu,
                       count=count), step


@pytest.fixture(scope="module")
def jax_side():
    jspecs, jlens = asphere_cooke()
    catalog = jglass.default_catalog_g()
    g = jglass.g_from_n_v(jlens.flat_nd, jlens.flat_v) + 0.01
    out = dict(specs=jspecs, lens=jlens, g=np.asarray(g), losses={}, step={})
    lens_args = (jlens.c, jlens.kappa, jlens.asph, jlens.t)
    losses = _losses_program(jspecs, jlens, g, catalog)
    # XLA compiles without the GIL: both loss programs compile on threads
    # while the Adam steps run here.
    with ThreadPoolExecutor(2) as pool:
        with pltpu.force_tpu_interpret_mode():
            lowered = losses("pallas").lower(*lens_args)
        compiled = {"pallas": pool.submit(lowered.compile, compiler_options=FAST_COMPILE),
                    "scan": pool.submit(losses("scan").lower(*lens_args).compile,
                                        compiler_options=FAST_COMPILE)}
        for full in (False, True):
            state, seed, step = _jax_step(jspecs, jlens.replace(nd=jlens.nd + 2e-3), full)
            new, total = step(state)
            out["step"][full] = dict(seed, total=float(total),
                                     new={k: np.asarray(v) for k, v in new.params.items()})
        for engine, program in compiled.items():
            tot, ld, grads, lu = program.result()(*lens_args)
            out["losses"][engine] = dict(total=float(tot),
                                         loss={k: float(v) for k, v in ld.items()},
                                         grads=[np.asarray(a) for a in grads],
                                         lu={k: float(v) for k, v in lu.items()})
    return out


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


@pytest.mark.parametrize("engine", ["unroll", "fused"])
def test_do_ray_tracing_and_compute_losses_match_jax(engine, jax_side):
    """The Lu loss and the full loss with d/d(c, kappa, asph, t) on the
    port's engines against JAX's Pallas engine, with JAX's own
    scan-vs-Pallas distance allowed on the gradients."""
    jspecs, jlens = jax_side["specs"], jax_side["lens"]
    specs, lens = port(jspecs, jlens)
    cfg = simulator.SimulatorConfig(trace_engine=engine, **BASE)
    want = jax_side["losses"]["pallas"]
    other = jax_side["losses"]["scan"]
    with torch.no_grad():
        _, lu = simulator.do_ray_tracing(specs, lens, cfg)
    for k, v in lu.items():
        np.testing.assert_allclose(float(v), want["lu"][k], rtol=VALUE_RTOL[k], err_msg=k)
    params = [p.clone().requires_grad_(True) for p in (lens.c, lens.kappa, lens.asph, lens.t)]
    total, loss = simulator.compute_losses(
        specs, lens.replace(c=params[0], kappa=params[1], asph=params[2], t=params[3]), cfg,
        g=torch.tensor(jax_side["g"]), catalog_g=glass.default_catalog_g(device="cpu"))
    assert set(loss) == set(want["loss"])
    assert want["loss"]["ray_path"] > 0 and want["loss"]["ray_angle"] > 0
    for k, v in loss.items():
        np.testing.assert_allclose(float(v.detach()), want["loss"][k], rtol=VALUE_RTOL[k], err_msg=k)
    np.testing.assert_allclose(float(total.detach()), want["total"], rtol=1e-5)
    for got, w, o, label in zip(torch.autograd.grad(total, params), want["grads"],
                                other["grads"], ("dc", "dkappa", "dasph", "dt")):
        _assert_rel_close(got.numpy(), w, label, slack=np.abs(np.asarray(o, np.float64) - w))


@pytest.mark.parametrize("full", [False, True])
def test_one_adam_step_with_kappa_and_asph_matches_jax(full, jax_side):
    """One ``LensOptimizer`` step on the fused engine (K3's plain versions)
    from JAX's seeded state, with kappa and asph among the trained variables:
    the loss within 1e-5, every parameter within 5e-6 + 1e-6 relative (one
    step moves each by about the learning rate, 1e-4)."""
    ref = jax_side["step"][full]
    jspecs, jlens = jax_side["specs"], jax_side["lens"]
    specs, lens = port(jspecs, jlens)
    lens = lens.replace(nd=lens.nd + 2e-3)
    opt = LensOptimizer(specs=specs,
                        config=simulator.SimulatorConfig(trace_engine="fused", **BASE),
                        learning_rate=1e-4, use_full_loss=full, efl_target=float(lens.efl[0]),
                        trainable=TRAINABLE)
    state = convert.opt_state_from_numpy(opt, ref["params"], ref["mu"], ref["nu"], ref["count"],
                                         device="cpu")
    assert {"kappa", "asph"} <= set(state.params)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    state, total, _ = opt.step(state)
    np.testing.assert_allclose(float(total), ref["total"], rtol=1e-5)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), ref["new"][k], rtol=1e-6, atol=5e-6,
                                   err_msg=k)
        assert int(state.opt_state.state[v]["step"]) == ref["count"] + 1
    for k in ("kappa", "asph"):
        assert not torch.equal(state.params[k].detach(), start[k]), k
