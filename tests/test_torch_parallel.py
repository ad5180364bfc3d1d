"""Port parity for ``parallel/`` (``torchoptics_tpu_torch.parallel``): the
mesh, the sharded trace, the sharded spot RMS, the sharded fused losses on
K2's and K4's plain versions, the sharded training step and the generator
loss over ranks, on gloo groups of CPU processes.

A module fixture spawns one 2-rank group (layouts lens x rays = 1 x 2 and
2 x 1) and one 4-rank group (2 x 2) once, through
``parallel.mesh.spawn``; the ranks run ``torch_parallel_ranks.cpu_rank``
(no JAX) and write their results to ``.npz`` files that the tests read.
The population cases are the JAX package's ``tests/test_sharding.py`` ones:
B = 3 perturbed Cooke designs at 2 fields x 3 rings x 3 wavelengths, so
both a 2-wide 'lens' axis (3 -> 4 systems) and a 2-wide 'rays' axis (9 ->
10 pupil rays) pad.

Bars: against the single-process port, traces within 1e-6 mm and equal
masks (the same rays, each traced alone: measured bit for bit); values
rtol 2e-5 and gradients (the world-sum of the ranks' shares) rtol 1e-3,
atol 1e-6 (``tests/test_sharding.py``'s; measured: values 1.3e-7 relative,
gradients one float32 rounding), train-step parameters rtol 1e-4, atol
1e-6 and totals rtol 1e-5 (``tests/test_distributed.py``'s), bit for bit
across ranks. Against JAX's ``shard_mod.sharded_fused_losses`` on a 2 x 2
mesh of the conftest's CPU devices, its Pallas kernels in interpret mode:
the value rtol 2e-5 plus the interpret-mode distance of ROADMAP section 3
(JAX's Pallas Lu sums sit up to 5.9e-5 from its jnp engine, which the port
follows), gradients rtol 1e-3, atol 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parallel_ranks as ranks
from torchoptics_tpu_torch import LensOptimizer, simulator, trace, zoo
from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure
from torchoptics_tpu_torch.ops import metrics
from torchoptics_tpu_torch.parallel import mesh as mesh_mod
from torchoptics_tpu_torch.parallel import shard

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
VALUE_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-3, 1e-6
#: ROADMAP section 3: JAX's interpret-mode Pallas Lu sums against its jnp
#: engine (the port's), relative to the loss.
INTERPRET_DISTANCE = 5.9e-5
GROUPS = [(2, 1), (2, 2), (4, 2)]
GROUP_IDS = ["1x2", "2x1", "2x2"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{world size: future of its ranks' results}, both groups started at
    once in the background."""
    out = tmp_path_factory.mktemp("ranks")
    pool = ThreadPoolExecutor(2)

    def run(n):
        mesh_mod.spawn(ranks.cpu_rank, n, args=(str(out / f"group{n}"),), device="cpu")
        return [dict(np.load(out / f"group{n}_{r}.npz")) for r in range(n)]

    futures = {n: pool.submit(run, n) for n in (2, 4)}
    yield futures
    pool.shutdown()


def _results(groups, n):
    return groups[n].result(timeout=600)


def _tag(n, lp):
    return f"{lp}x{n // lp}"


@pytest.fixture(scope="module")
def jax_sharded(groups):
    """JAX's sharded fused full loss of the B = 3 case and d/d(c, t), on a
    2 x 2 mesh (interpret mode), while the rank groups run."""
    from torchoptics_tpu import simulator as jsim
    from torchoptics_tpu.models.structure import Lens as JLens, Specs as JSpecs, Structure as JSt
    from torchoptics_tpu.parallel import mesh as jmesh
    from torchoptics_tpu.parallel import shard as jshard

    specs, lens = ranks.tiled_population("cooke", 3, perturb=0.02)
    st = JSt(lens.structure.stop_idx, lens.structure.sequence)
    jlens = JLens(st, *(getattr(lens, k).numpy() for k in ("c", "t", "nd", "v")))
    jspecs = JSpecs(st, specs.epd.numpy(), specs.hfov.numpy())
    config = jsim.SimulatorConfig(**dict(ranks.POP_KW, trace_engine="pallas"))
    mesh = jmesh.make_mesh(jax.devices()[:4], lens_parallel=2)

    def loss(c, t):
        return jshard.sharded_fused_losses(jspecs, jlens.replace(c=c, t=t), config, mesh)[0]

    with pltpu.force_tpu_interpret_mode():
        low = jax.jit(jax.value_and_grad(loss, argnums=(0, 1))).lower(jlens.c, jlens.t)
    value, (dc, dt) = low.compile(compiler_options=FAST_COMPILE)(jlens.c, jlens.t)
    return float(value), {"c": np.asarray(dc), "t": np.asarray(dt)}


def test_sharded_fused_losses_match_jax(groups, jax_sharded):
    """The padded B = 3 case on the 2 x 2 layout against JAX's sharded
    fused loss: the value and the world-sum of d/d(c, t). (First in the
    module, so that JAX's program runs while the rank groups start.)"""
    value, grads = jax_sharded
    results = _results(groups, 4)
    key = "2x2/loss/sph_full"
    for res in results:
        np.testing.assert_allclose(float(res[f"{key}/value"]), value,
                                   rtol=VALUE_RTOL + INTERPRET_DISTANCE)
    for k, want in grads.items():
        got = sum(res[f"{key}/d{k}"] for res in results)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_mesh_construction(groups):
    """Shapes, row-major coordinates and blocks of every layout; a single
    process is the 1 x 1 mesh, and a layout that does not divide the world
    raises."""
    for n, lp in GROUPS:
        for rank, res in enumerate(_results(groups, n)):
            tag = _tag(n, lp)
            assert res[f"{tag}/shape"].tolist() == [lp, n // lp]
            li, ri = divmod(rank, n // lp)
            assert res[f"{tag}/coords"].tolist() == [li, ri]
            # This rank's block of 4 systems x 10 pupil rays.
            b, p = 4 // lp, 10 // (n // lp)
            assert res[f"{tag}/blocks"].tolist() == [li * b, (li + 1) * b, ri * p, (ri + 1) * p]
    mesh = mesh_mod.make_mesh()
    assert mesh.shape == {"lens": 1, "rays": 1} and mesh.world_size == 1
    with pytest.raises(ValueError, match="not divisible by lens_parallel=2"):
        mesh_mod.make_mesh(2)


def test_all_reduce_sum_passes_the_cotangent_through(groups):
    """y = all_reduce_sum(x): every rank holds sum_r (r + 1), and each
    rank's d sum(y)/dx is 1, not the world size."""
    for n in (2, 4):
        for res in _results(groups, n):
            np.testing.assert_array_equal(res["all_reduce_value"], n * (n + 1) / 2)
            np.testing.assert_array_equal(res["all_reduce_grad"], 1.0)


@pytest.mark.parametrize("n, lp", GROUPS, ids=GROUP_IDS)
def test_sharded_trace_matches_single_process(groups, n, lp):
    """The 13-ray singlet fan (padded on the 'rays' axis) and the Cooke,
    unroll and fused engines, sharded over 'rays': the full result on every
    rank, padding dropped."""
    for label, specs, lens, cfg in ranks.trace_cases():
        want = trace.trace_rays(specs, lens, cfg)
        for res in _results(groups, n):
            key = f"{_tag(n, lp)}/trace/{label}"
            assert res[f"{key}/y"].shape == tuple(want.y.shape)
            for field in ("x", "y"):
                np.testing.assert_allclose(res[f"{key}/{field}"], getattr(want, field).numpy(),
                                           rtol=0, atol=1e-6, err_msg=f"{label} {field}")
            for field in ("ray_ok", "ray_backward"):
                np.testing.assert_array_equal(res[f"{key}/{field}"],
                                              getattr(want, field).numpy(), err_msg=label)


@pytest.mark.parametrize("n, lp", GROUPS, ids=GROUP_IDS)
def test_shard_map_mean_rms_matches_compute_rms2d(groups, n, lp):
    specs, lens = zoo.build("cooke", device="cpu")
    res = trace.trace_rays(specs, lens, trace.TraceConfig(
        mode="circular", n_rays=(4, 4), rel_fields=(0.0, 1.0), wavelengths=("d",)))
    want = metrics.compute_rms2d(res.x, res.y, res.ray_ok).numpy()
    for out in _results(groups, n):
        np.testing.assert_allclose(out[f"{_tag(n, lp)}/mean_rms"], want, rtol=1e-5)


@pytest.mark.parametrize("case", [c[0] for c in ranks.loss_cases()])
@pytest.mark.parametrize("n, lp", GROUPS, ids=GROUP_IDS)
def test_sharded_fused_losses_match_single_process(groups, n, lp, case):
    """Spherical (K2) and aspheric (K4) populations, full and Lu, 'y' and
    'xy' metrics: every rank's value, and the world-sum of the ranks'
    gradients, against the single-process fused loss. The sum does not
    scale with the world size (1, 2 or 4), and the glass penalty's
    gradient is counted once."""
    label, specs, lens, cfg, full, glass = next(c for c in ranks.loss_cases() if c[0] == case)
    value, grads = ranks.loss_and_grads(specs, lens, cfg, full, glass)
    world1 = ranks.loss_and_grads(specs, lens, cfg, full, glass, mesh_mod.make_mesh())
    results = _results(groups, n)
    for got_value, got in [world1] + [
            (float(res[f"{_tag(n, lp)}/loss/{label}/value"]),
             {k: sum(r[f"{_tag(n, lp)}/loss/{label}/d{k}"] for r in results) for k in grads})
            for res in results]:
        np.testing.assert_allclose(got_value, value, rtol=VALUE_RTOL)
        for k, want in grads.items():
            np.testing.assert_allclose(got[k], want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    if glass:
        # Rank 0 holds the glass term's gradient; the others none of it.
        assert np.any(results[0][f"{_tag(n, lp)}/loss/{label}/dg"] != 0)
        for res in results[1:]:
            np.testing.assert_array_equal(res[f"{_tag(n, lp)}/loss/{label}/dg"], 0.0)


@pytest.mark.parametrize("n, lp", GROUPS, ids=GROUP_IDS)
def test_sharded_train_step_matches_lens_optimizer(groups, n, lp):
    """Three sharded full-loss steps on the fused engine against three
    single-process LensOptimizer steps; every rank's parameters are rank
    0's bit for bit."""
    params, total = ranks.train_steps(simulator.SimulatorConfig(**ranks.POP_KW))
    results = _results(groups, n)
    key = f"{_tag(n, lp)}/train/fused"
    for res in results:
        np.testing.assert_allclose(float(res[f"{key}/total"]), total, rtol=1e-5)
        for k, want in params.items():
            np.testing.assert_allclose(res[f"{key}/{k}"], want, rtol=1e-4, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(res[f"{key}/{k}"], results[0][f"{key}/{k}"])


def _unroll_steps_match(groups, n, lp, full, case=None):
    """The unroll engine's sharded steps on this layout against the
    single-process steps; every rank's parameters are rank 0's bit for bit.
    ``case`` names one of ``ranks.UNROLL_CASES`` (the Cooke population in
    float32 without one)."""
    population, f64 = ranks.UNROLL_CASES[case] if case else (ranks.train_population, False)
    cfg = simulator.SimulatorConfig(**dict(ranks.POP_KW, trace_engine="unroll",
                                           double_precision=f64))
    params, total = ranks.train_steps(cfg, use_full_loss=full, population=population)
    specs, lens = population()
    start = LensOptimizer(specs, cfg).init(lens).params
    # The steps were taken (a rejected step keeps the parameters).
    assert not np.array_equal(params["c"], start["c"].detach().numpy())
    results = _results(groups, n)
    key = f"unroll/{_tag(n, lp)}/{'full' if full else 'lu'}" + (f"/{case}" if case else "")
    for res in results:
        np.testing.assert_allclose(float(res[f"{key}/total"]), total, rtol=1e-5)
        for k, want in params.items():
            np.testing.assert_allclose(res[f"{key}/{k}"], want, rtol=1e-4, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(res[f"{key}/{k}"], results[0][f"{key}/{k}"])


@pytest.mark.parametrize("n", [2, 4])
def test_unroll_train_step_shards_over_lens(groups, n):
    """The unroll engine's step over 'lens' alone (one or two systems a
    rank, full loss), and on Lu with a 'rays' axis (lens 1 x rays 2 and
    2 x 2: each rank traces its pupil block, the spot moments and penalty
    sums summed over 'rays'), is the single-process step."""
    _unroll_steps_match(groups, n, n, True)
    _unroll_steps_match(groups, n, 1 if n == 2 else 2, False)


@pytest.mark.parametrize("n, lp", [(2, 1), (4, 2)], ids=["1x2", "2x2"])
def test_unroll_full_loss_step_shards_over_rays(groups, n, lp):
    """The unroll engine's full-loss step with a 'rays' axis (the ray-path
    and ray-angle hinge sums summed over 'rays' too) is the single-process
    step."""
    _unroll_steps_match(groups, n, lp, True)


@pytest.mark.parametrize("case", list(ranks.UNROLL_CASES))
@pytest.mark.parametrize("n, lp", [(2, 1), (4, 2)], ids=["1x2", "2x2"])
def test_unroll_step_over_rays_takes_mixed_and_float64(groups, n, lp, case):
    """The unroll engine's full-loss step with a 'rays' axis on a population
    mixing three lens types (each rank's block cut to its own widest
    sequence, its own masks and surface counts; on 2 x 2 the 3 systems pad
    the 'lens' axis) and in double precision is the single-process step."""
    _unroll_steps_match(groups, n, lp, True, case)


@pytest.mark.parametrize("n, lp", GROUPS, ids=GROUP_IDS)
def test_generator_loss_over_ranks(groups, n, lp):
    """OpticalLoss.unsupervised(engine='fused', mesh=...) against the
    unsharded fused loss: mean Lu, rms, penalty, and the world-sum of
    d Lu/d(outputs)."""
    loss, grad = ranks.generator_loss()
    results = _results(groups, n)
    key = f"{_tag(n, lp)}/generator"
    for res in results:
        np.testing.assert_allclose(res[f"{key}/loss"], loss, rtol=VALUE_RTOL)
    np.testing.assert_allclose(sum(res[f"{key}/grad"] for res in results), grad,
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_sharded_fused_losses_refuse_what_jax_refuses():
    """A population mixing sequences or stops, and double precision, raise
    as the JAX package's sharded loss does."""
    st = Structure((0, 2), ("AGA", "GAAGA"))
    lens = Lens(st, torch.zeros(2, 5), torch.ones(2, 5), torch.full((2, 5), 1.5),
                torch.full((2, 5), 50.0))
    specs = Specs(st, torch.ones(2), torch.full((2,), 0.3))
    config = simulator.SimulatorConfig(n_sampled_fields=2, n_pupil_rings=4,
                                       pupil_sampling="circular", n_ray_aiming_iter=0,
                                       wavelengths=(520.0,), trace_engine="fused")
    mesh = mesh_mod.make_mesh()
    with pytest.raises(NotImplementedError, match="homogeneous"):
        shard.sharded_fused_losses(specs, lens, config, mesh)
    specs, lens = ranks.tiled_population("cooke", 2)
    with pytest.raises(NotImplementedError, match="float32"):
        shard.sharded_fused_losses(specs, lens, simulator.SimulatorConfig(
            double_precision=True, trace_engine="fused"), mesh)
