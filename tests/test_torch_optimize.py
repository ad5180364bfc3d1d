"""Port parity for the training path: glass snapping, the last-curvature
solve, the normalized lens variables, ``simulator.compute_losses`` and one
``LensOptimizer`` step, against the JAX package on the same numbers.

The JAX side runs eagerly (a jitted value-and-grad of the unrolled trace
takes minutes to compile on the CPU), except the Pallas engine, which runs
jitted, in interpret mode. Configurations are small and without ray aiming, which has its own
parity tests (``test_torch_trace.py``).

Bars: the glass maps, the solve and the variables 1e-6 relative (float32
elementwise maps); loss values 1e-5 relative (``rms`` 2e-4, as in
``test_torch_simulator``); gradients 1e-4 of their largest magnitude plus
JAX's own unroll-vs-Pallas distance, as ``test_torch_fused_backward``. One
Adam step from the same seeded state:
parameters within 5e-6 + 1e-6 relative, 5 % of the step. Adam moves each
parameter by about the learning rate (1e-4) and rounds float32 differently
in optax (which divides the bias corrections into the moments) and torch
(into the step size and the root), and the two Lu gradients differ on rays
at the theta clip edge (jnp.clip passes half the gradient there, the port's
engines none), which moves a few thickness steps by up to 2 %.
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
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.models import glass as jglass
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.models.structure import find_valid_curvatures as jfind_valid
from torchoptics_tpu.ops import abcd as jabcd
from torchoptics_tpu_torch import LensOptimizer, optimize, simulator, zoo
from torchoptics_tpu_torch.models import convert, glass
from torchoptics_tpu_torch.models.structure import Structure, find_valid_curvatures
from torchoptics_tpu_torch.ops import abcd

BASE = dict(n_sampled_fields=3, n_pupil_rings=4, pupil_sampling="circular",
            n_ray_aiming_iter=0, ray_path_lower_thresholds=(0.5, 1.5, 12.0),
            ray_path_upper_thresholds=(None, 3.0, 40.0), ray_angle_threshold=30.0)
VALUE_RTOL = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4, "spot_size": 2e-4,
              "ray_path": 1e-5, "ray_angle": 1e-5, "glass": 1e-5}
GRAD_BAR = 1e-4
# The interpret-mode kernels lower to a large XLA CPU program: without LLVM's
# optimizations it compiles in a fraction of the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _port(jlens):
    st = jlens.structure
    return convert.lens_from_numpy(st.stop_idx, st.sequence, np.asarray(jlens.c),
                                   np.asarray(jlens.t), np.asarray(jlens.nd),
                                   np.asarray(jlens.v), device="cpu")


def _close(got, want, rtol=1e-6, atol=1e-7, label=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=label)


def _rel_close(got, want, label, slack=0.0):
    """|got - want| <= GRAD_BAR x max|want| + slack, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), label
    scale = max(np.abs(want).max(), 1e-30)
    excess = np.abs(got - want) - slack
    assert excess.max() <= GRAD_BAR * scale, (
        f"{label}: {excess.max() / scale:.3e} of the largest magnitude beyond the slack")


# ---------------------------------------------------------------------------
# Glass, the last-curvature solve and the normalized variables.
# ---------------------------------------------------------------------------


def test_glass_maps_and_catalog_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.normal(0.0, 1.0, (16, 2)).astype(np.float32)
    n, v = glass.n_v_from_g(torch.tensor(g))
    jn, jv = jglass.n_v_from_g(jnp.asarray(g))
    _close(n.numpy(), jn)
    _close(v.numpy(), jv)
    catalog = glass.default_catalog_g(device="cpu")
    jcatalog = np.asarray(jglass.default_catalog_g())
    assert catalog.shape == (65, 2) and catalog.device.type == "cpu"
    _close(catalog.numpy(), jcatalog)
    g_near = torch.tensor(jcatalog[[3, 17, 40]] + 0.01)
    np.testing.assert_array_equal(glass.catalog_glass_indices(g_near, catalog).numpy(),
                                  np.asarray(jglass.catalog_glass_indices(
                                      jnp.asarray(g_near.numpy()), jnp.asarray(jcatalog))))
    _close(glass.map_glass_to_closest(g_near, catalog).numpy(), jcatalog[[3, 17, 40]])
    path = tmp_path / "catalog.csv"
    np.savetxt(path, np.asarray([[1.5168, 64.17], [1.7552, 27.58]]), delimiter=",")
    _close(glass.load_catalog(str(path), device="cpu").numpy(),
           np.asarray(jglass.load_catalog(str(path))))


def test_quantize_glass_straight_through():
    """The forward snaps to the catalog; the gradient is the identity: d/dg
    of sum(snap(g)^2) is 2 snap(g), as in the JAX package's test."""
    catalog = glass.default_catalog_g(device="cpu")
    g = (catalog[3] + 0.01).clone().requires_grad_(True)
    snapped = glass.quantize_glass_st(g[None], catalog)
    _close(snapped.detach().numpy(), catalog[3:4].numpy(), atol=1e-6)
    (grad,) = torch.autograd.grad(torch.sum(snapped ** 2), g)
    _close(grad.numpy(), 2 * catalog[3].numpy(), rtol=1e-5)
    jcatalog = jglass.default_catalog_g()
    jgrad = jax.grad(lambda x: jnp.sum(jglass.quantize_glass_st(x[None], jcatalog) ** 2))(
        jcatalog[3] + 0.01)
    _close(grad.numpy(), jgrad, rtol=1e-5)


@pytest.mark.parametrize("sequence,stop", [(("GAGGAAGGAGA",), (5,)), (("GAGA",), (2,)),
                                           (("GAGAAGA", "GAAGA"), (4, 2)),
                                           (("AGA", "GAGAAGGA"), (0, 4))])
def test_find_valid_curvatures_matches_jax(sequence, stop):
    np.testing.assert_array_equal(find_valid_curvatures(Structure(stop, sequence)),
                                  jfind_valid(JStructure(stop, sequence)))


@pytest.mark.parametrize("name", ["cooke", "double_gauss", "tessar"])
def test_last_curvature_and_scale_match_jax(name):
    _, jlens = jzoo.build(name)
    lens = _port(jlens)
    st = lens.structure
    got = abcd.compute_last_curvature(st, lens.flat_c_but_last, lens.flat_t, lens.flat_nd)
    want = jabcd.compute_last_curvature(jlens.structure, jlens.flat_c_but_last,
                                        jlens.flat_t, jlens.flat_nd)
    _close(got.numpy(), want, rtol=1e-5, atol=1e-7)
    for factor in (0.5, float(np.asarray(jlens.efl)[0])):
        scaled, jscaled = lens.scale(factor), jlens.scale(factor)
        _close(scaled.c.numpy(), jscaled.c)
        _close(scaled.t.numpy(), jscaled.t)
    efl = lens.efl
    scaled = lens.scale(1.0 / efl)
    _close(scaled.efl.numpy(), [1.0], rtol=1e-5)
    specs, _ = zoo.build(name, device="cpu")
    _close(specs.scale(2.0).epd.numpy(), 2.0 * specs.epd.numpy())
    for attr in ("flat_c", "flat_t", "flat_nd", "flat_v", "flat_c_but_last"):
        _close(getattr(lens, attr).numpy(), getattr(jlens, attr), label=attr)
    moved = lens.with_flat_t(lens.flat_t + 1.0).with_flat_nd(lens.flat_nd + 0.01)
    _close(moved.flat_t.numpy(), np.asarray(jlens.flat_t) + 1.0)
    _close(moved.nd.numpy(), np.asarray(jlens.with_flat_nd(jlens.flat_nd + 0.01).nd))
    _close(lens.with_flat_c(lens.flat_c).c.numpy(), jlens.c)
    _close(lens.with_flat_v(lens.flat_v).v.numpy(), jlens.v)


@pytest.mark.parametrize("add_bfl", [False, True])
@pytest.mark.parametrize("qc_variables", [False, True])
def test_normalized_variables_match_jax(add_bfl, qc_variables):
    _, jlens = jzoo.build("double_gauss")
    lens = _port(jlens)
    params = optimize.get_normalized_lens_variables(lens, add_bfl=add_bfl)
    jparams = jopt.get_normalized_lens_variables(jlens, add_bfl=add_bfl)
    assert set(params) == set(jparams) == {"c", "t", "g"}
    for k in params:
        _close(params[k].numpy(), jparams[k], rtol=1e-5, atol=1e-6, label=k)
    catalog = glass.default_catalog_g(device="cpu")
    rebuilt = optimize.lens_from_normalized(lens.structure, params, catalog, add_bfl=add_bfl,
                                            qc_variables=qc_variables)
    jrebuilt = jopt.lens_from_normalized(jlens.structure, jparams, jglass.default_catalog_g(),
                                         add_bfl=add_bfl, qc_variables=qc_variables)
    for attr in ("c", "t", "nd", "v"):
        _close(getattr(rebuilt, attr).numpy(), getattr(jrebuilt, attr), rtol=1e-5, atol=1e-6,
               label=attr)
    _close(rebuilt.efl.numpy(), [1.0], rtol=1e-5)


# ---------------------------------------------------------------------------
# The full weighted loss.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's compute_losses on the double-Gauss with g off the catalog: the
    loss dict and d total/d(c, t), with the unroll engine and with the
    Pallas kernels in interpret mode."""
    jspecs, jlens = jzoo.build("double_gauss")
    catalog = jglass.default_catalog_g()
    g = jglass.g_from_n_v(jlens.flat_nd, jlens.flat_v) + 0.01
    out = dict(specs=jspecs, lens=jlens, g=np.asarray(g))

    def value_and_grad(engine):
        cfg = jsim.SimulatorConfig(trace_engine=engine, **BASE)

        def total(c, t):
            return jsim.compute_losses(jspecs, jlens.replace(c=c, t=t), cfg, g=g,
                                       catalog_g=catalog)
        return jax.value_and_grad(total, argnums=(0, 1), has_aux=True)

    # Eager Pallas recompiles its kernels on every call: jit it, and compile
    # it on a thread (XLA releases the GIL) while the unroll engine runs here.
    with pltpu.force_tpu_interpret_mode():
        lowered = jax.jit(value_and_grad("pallas")).lower(jlens.c, jlens.t)
    with ThreadPoolExecutor(1) as pool:
        pallas = pool.submit(lowered.compile, compiler_options=FAST_COMPILE)
        results = {"unroll": value_and_grad("unroll")(jlens.c, jlens.t),
                   "pallas": pallas.result()(jlens.c, jlens.t)}
    for engine, ((tot, ld), grads) in results.items():
        out[engine] = dict(total=float(tot), loss={k: float(v) for k, v in ld.items()},
                           grads=[np.asarray(a) for a in grads])
    return out


@pytest.mark.parametrize("engine", ["unroll", "fused"])
@pytest.mark.parametrize("jax_engine", ["unroll", "pallas"])
def test_compute_losses_matches_jax(engine, jax_engine, jax_losses):
    jspecs, jlens = jax_losses["specs"], jax_losses["lens"]
    st = jlens.structure
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    lens = _port(jlens)
    cfg = simulator.SimulatorConfig(trace_engine=engine, **BASE)
    g = torch.tensor(jax_losses["g"])
    catalog = glass.default_catalog_g(device="cpu")
    c = lens.c.clone().requires_grad_(True)
    t = lens.t.clone().requires_grad_(True)
    total, loss = simulator.compute_losses(specs, lens.replace(c=c, t=t), cfg, g=g,
                                           catalog_g=catalog)
    want = jax_losses[jax_engine]
    assert set(loss) == set(want["loss"])
    assert want["loss"]["ray_path"] > 0 and want["loss"]["ray_angle"] > 0
    assert want["loss"]["glass"] > 0
    for k, v in loss.items():
        _close(float(v), want["loss"][k], rtol=VALUE_RTOL[k], atol=0, label=k)
    _close(float(total), want["total"], rtol=1e-5, atol=0)
    # Slack: JAX's own unroll-vs-Pallas distance. At the theta clip edge
    # jnp.clip passes half the gradient, the hand adjoints none.
    other = jax_losses["pallas" if jax_engine == "unroll" else "unroll"]["grads"]
    for got, w, o, label in zip(torch.autograd.grad(total, (c, t)), want["grads"], other,
                                ("dc", "dt")):
        _rel_close(got.numpy(), w, label, slack=np.abs(np.asarray(o, np.float64) - w))


def test_fused_compute_losses_refuses_batches_and_aspheres():
    """An asphere runs on the fused engine (kernel K3's full mode): its full
    loss agrees with the pure-torch engine's (the two write the sag's slope
    in forms equal in exact arithmetic) and its gradients are finite. A
    population runs (on kernel K2's full mode): two copies of the flagship
    give its loss."""
    specs, lens = zoo.build("double_gauss_asph", device="cpu")
    cfg = simulator.SimulatorConfig(trace_engine="fused", **BASE)
    kappa = lens.kappa.clone().requires_grad_(True)
    total, loss = simulator.compute_losses(specs, lens.replace(kappa=kappa), cfg)
    want_total, want = simulator.compute_losses(specs, lens, simulator.SimulatorConfig(**BASE))
    assert set(loss) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(loss[k]), float(v), rtol=VALUE_RTOL[k], err_msg=k)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    (grad,) = torch.autograd.grad(total, kappa)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
    specs, lens = zoo.build("double_gauss", device="cpu")
    batch = convert.lens_from_numpy((5, 5), ("GAGGAAGGAGA",) * 2, lens.c.repeat(2, 1).numpy(),
                                    lens.t.repeat(2, 1).numpy(), lens.nd.repeat(2, 1).numpy(),
                                    lens.v.repeat(2, 1).numpy(), device="cpu")
    total, loss = simulator.compute_losses(specs[np.array([0, 0])], batch, cfg)
    want_total, want = simulator.compute_losses(specs, lens, cfg)
    for k, v in want.items():
        np.testing.assert_allclose(float(loss[k]), float(v), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)


# ---------------------------------------------------------------------------
# LensOptimizer.
# ---------------------------------------------------------------------------


def _seeded_state(jparams, seed=0):
    """Adam moments from a seed, count 3: a state in the middle of a run."""
    rng = np.random.default_rng(seed)
    mu = {k: (rng.normal(0.0, 1.0, np.shape(v)) * 1e-2).astype(np.float32)
          for k, v in jparams.items()}
    nu = {k: (rng.uniform(0.5, 2.0, np.shape(v)) * 1e-4).astype(np.float32)
          for k, v in jparams.items()}
    return mu, nu, 3


@pytest.fixture(scope="module")
def jax_step():
    """One eager JAX Adam step (unroll engine) from a seeded state, for the
    Lu loss and the full loss, on the double-Gauss with its glasses moved off
    the catalog and its EFL kept."""
    jspecs, jlens = jzoo.build("double_gauss")
    jlens = jlens.replace(nd=jlens.nd + 2e-3)
    out = dict(specs=jspecs, lens=jlens)
    for full in (False, True):
        o = jopt.LensOptimizer(specs=jspecs, config=jsim.SimulatorConfig(**BASE),
                               learning_rate=1e-4, use_full_loss=full,
                               efl_target=float(jlens.efl[0]))
        state = o.init(jlens)
        mu, nu, count = _seeded_state(state.params)
        adam = state.opt_state[0]._replace(count=jnp.asarray(count, jnp.int32),
                                           mu={k: jnp.asarray(v) for k, v in mu.items()},
                                           nu={k: jnp.asarray(v) for k, v in nu.items()})
        state = jopt.OptState(state.params, (adam,) + tuple(state.opt_state[1:]), state.step)
        new, total, _ = o._step_impl(state, None)
        out[full] = dict(params={k: np.asarray(v) for k, v in state.params.items()},
                         mu=mu, nu=nu, count=count, total=float(total),
                         new={k: np.asarray(v) for k, v in new.params.items()})
    return out


@pytest.mark.parametrize("engine", ["unroll", "fused"])
@pytest.mark.parametrize("full", [False, True])
def test_one_step_from_the_same_state_matches_jax(engine, full, jax_step):
    ref = jax_step[full]
    jspecs, jlens = jax_step["specs"], jax_step["lens"]
    st = jlens.structure
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    opt = LensOptimizer(specs=specs, config=simulator.SimulatorConfig(trace_engine=engine,
                                                                      **BASE),
                        learning_rate=1e-4, use_full_loss=full,
                        efl_target=float(np.asarray(jlens.efl)[0]))
    state = convert.opt_state_from_numpy(opt, ref["params"], ref["mu"], ref["nu"],
                                         ref["count"], device="cpu")
    state, total, loss = opt.step(state)
    assert state.step == 1
    _close(float(total), ref["total"], rtol=1e-5, atol=0)
    for k, v in state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), ref["new"][k], rtol=1e-6, atol=5e-6,
                                   err_msg=k)
        assert int(state.opt_state.state[v]["step"]) == ref["count"] + 1


def _cooke_optimizer(**kw):
    specs, lens = zoo.build("cooke", device="cpu")
    cfg = simulator.SimulatorConfig(n_sampled_fields=3, n_pupil_rings=4,
                                    pupil_sampling="circular", n_ray_aiming_iter=1)
    opt = LensOptimizer(specs=specs, config=cfg, qc_variables=False, add_bfl=False,
                        efl_target=float(lens.efl[0]), **kw)
    return opt, lens


def test_optimizer_run_reduces_loss():
    opt, lens = _cooke_optimizer(learning_rate=3e-4)
    lens_bad = lens.replace(c=lens.c * 1.08)
    loss0 = float(opt.loss(opt.init(lens_bad).params)[0])
    final, state, history = opt.run(lens_bad, 25, log_every=5)
    assert state.step == 25 and len(history) == 5
    assert np.isfinite(history[-1]["loss_unsup"])
    assert float(opt.loss(state.params)[0]) < loss0
    assert isinstance(final.c, torch.Tensor) and not final.c.requires_grad


def test_optimizer_respects_trainable_mask():
    opt, lens = _cooke_optimizer(trainable=("c",))
    state = opt.init(lens)
    t0, g0 = state.params["t"].detach().clone(), state.params["g"].detach().clone()
    c0 = state.params["c"].detach().clone()
    for _ in range(3):
        state, *_ = opt.step(state)
    assert torch.equal(state.params["t"].detach(), t0)
    assert torch.equal(state.params["g"].detach(), g0)
    assert not torch.allclose(state.params["c"].detach(), c0)
    # Zeroed, not dropped: Adam keeps a state for every group.
    assert all(int(s["step"]) == 3 for s in state.opt_state.state.values())


def test_step_rejects_nonfinite():
    """A diverging iterate (NaN gradients) changes no parameter, no moment
    and not Adam's step count; the optimizer's step count still advances."""
    specs, lens = zoo.build("singlet", device="cpu")
    cfg = simulator.SimulatorConfig(n_sampled_fields=3, n_pupil_rings=4,
                                    pupil_sampling="circular", n_ray_aiming_iter=1)
    opt = LensOptimizer(specs=specs, config=cfg, qc_variables=False, add_bfl=False,
                        efl_target=float(lens.efl[0]))
    state = opt.init(lens)
    state, *_ = opt.step(state)
    with torch.no_grad():
        state.params["t"][0] = float("nan")
    before = {k: v.detach().clone() for k, v in state.params.items()}
    moments = {k: {m: v.clone() for m, v in state.opt_state.state[p].items()}
               for k, p in state.params.items()}
    grads = torch.autograd.grad(opt.loss(state.params)[0], list(state.params.values()))
    assert not all(bool(torch.isfinite(g).all()) for g in grads)
    new, _, _ = opt.step(state)
    assert new.step == state.step + 1
    for k, p in new.params.items():
        assert torch.equal(p.detach().nan_to_num(), before[k].nan_to_num()), k
        for m, v in new.opt_state.state[p].items():
            assert torch.equal(v, moments[k][m]), (k, m)
