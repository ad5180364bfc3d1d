"""Port parity for kernel K4 (``ops.fused_asphere``, the population
conic/asphere trace) and for the paths that send a population of
conic/asphere designs to it.

Kernel level. The padded mixed population of the JAX package's own
batched-asphere test (``test_pallas_coverage.py``: sequences GAGA, GAGAAGA,
GA from ``random_mixed_batch``, conics U(-0.8, 0.4) and two even-asphere
terms U(-1, 1) x [1e-5, 1e-8], both multiplied by the surface mask) at 2
fields x 4² circular pupil x 2 wavelengths, ray aiming on, goes through the
port's batched front-end; its (B, N) inputs (as numpy) and seeded
cotangents go through:

* ``trace_fused_asphere_batch_reference`` and
  ``trace_fused_asphere_batch_backward_reference`` (the plain versions of
  the CUDA kernels), against JAX's jnp engine (``trace_skew`` with the
  surface mask, its scan form, its stacks gated and summed surface by
  surface as the kernel does) and its ``jax.vjp`` in both backward-ray
  policies, and against JAX's Pallas K4 (``trace_fused_asphere_batch_full``
  and its vjp, interpret mode, jitted) with backward rays flagged. One
  Pallas vjp serves the three modes: the Lu and plain adjoints are that vjp
  with the hinge cotangents, then all five penalty cotangents, set to zero.
  The path bounds are the widest system's, tight, so both hinges fire;
* the hand adjoint against ``torch.autograd.grad`` through the plain
  forward (whose Newton steps are constants);
* K4's plain versions at B = 1 against K3's, and at kappa = asph = 0
  against K2's.

Paths. ``trace_rays``, ``do_ray_tracing``, ``batched_unsupervised_loss``
and ``compute_losses`` (a homogeneous population: one K4 full launch; a
padded mixed one: one per lens type) on the fused engine, on
``zoo.aspheric_population`` populations (3 Cooke triplets; 2 Cooke + 2
double-Gauss padded to 11 surfaces), against JAX: the loss values on its
Pallas engine (the homogeneous population's serving path, one forward
program), the traces, values and d/d(c, t, kappa, asph) on its jnp
engine, and the traces against the port's own unrolled engine. JAX's jnp
engine runs in its scan form, jitted: its unrolled form computes the same
function and takes tens of seconds a call eagerly on a CPU.

Bars (PR 4's, ``test_torch_fused_asphere.py``): masks identical;
coordinates on rays ok in both within 5e-6 mm + 1e-6 relative; penalty
sums within 1e-5 + 4e-6 relative, the theta sums also within 1e-6 x the
per-ray sum over surfaces of |d theta/d cos²| (the plain version writes the
sag's slope as the Pallas kernel does, the jnp engine in another form;
their cos² differ by a few ulps, which near normal incidence theta_norm
amplifies); cotangents within 1e-4 of each one's largest magnitude, rays
within ~1e-4 of normal incidence or at the theta clip edge given no theta
cotangent against JAX. Against the Pallas kernel each value may also
deviate by JAX's own jnp-vs-Pallas distance (interpret mode rounds
differently, and its launch adjoint reads the traced cy: ROADMAP queue 3).
Against K2 at kappa = asph = 0: JAX's own K3-vs-K1 bar, 1e-5 + 1e-4
relative. Losses: 1e-5 relative (rms 2e-4, ``test_torch_simulator``);
d/d(c, t, kappa, asph) on real surfaces within 1e-4 of each group's largest
magnitude.

The file compiles its JAX programs on threads with ``FAST_COMPILE`` and
takes about a minute alone. The CUDA kernels are held against these plain
versions on a GPU by ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import functools
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu import simulator as jsim
from torchoptics_tpu.models.structure import Lens as JLens
from torchoptics_tpu.models.structure import Specs as JSpecs
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import pallas_asphere as jpa
from torchoptics_tpu.ops import pallas_batch as jpb
from torchoptics_tpu.ops import trace as jtrace_mod
from torchoptics_tpu_torch import simulator, trace, zoo
from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, fused_trace
from test_fuzz_engines import random_mixed_batch
from test_torch_asphere import port

SEQS = ("GAGA", "GAGAAGA", "GA")
CONFIG = dict(n_sampled_fields=2, n_pupil_rings=4, pupil_sampling="circular",
              n_ray_aiming_iter=1, wavelengths=(486.0, 589.0))
N_PER_W = 2 * 16
LOWER, UPPER = (0.5, 1.5, 12.0), (None, 3.0, 40.0)
TIGHT = dict(ray_path_lower_thresholds=LOWER, ray_path_upper_thresholds=UPPER,
             ray_angle_threshold=30.0)
# The kernel-level angle bound, tight for this population (incidence
# angles up to ~13 degrees), so that the angle hinge fires.
THR = math.cos(math.radians(10.0)) ** 2
MODES = [False, True, "full"]
N_COT = {False: 4, True: 7, "full": 9}
N_OUT = {False: 6, True: 9, "full": 11}
BAR = 1e-4
LABELS = ("dxp", "dyp", "dcy", "dz0", "dc", "dkappa", "dt", "dmu", "dasph", "dref_z")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
VALUE_RTOL = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4, "spot_size": 2e-4,
              "ray_path": 1e-5, "ray_angle": 1e-5}
PARAMS = ("c", "t", "kappa", "asph")


def _kernel_population():
    """The JAX test's padded mixed population with masked conics and
    coefficients (JAX objects)."""
    rng = np.random.default_rng(800)
    jspecs, jlens, _ = random_mixed_batch(rng, SEQS)
    n_sys, n_surf = jlens.c.shape
    mask = jlens.structure.mask
    kappa = rng.uniform(-0.8, 0.4, (n_sys, n_surf)).astype(np.float32) * mask
    asph = ((rng.uniform(-1, 1, (n_sys, n_surf, 2)) * np.asarray([1e-5, 1e-8])).astype(np.float32)
            * mask[..., None])
    return jspecs, jlens.replace(kappa=jnp.asarray(kappa), asph=jnp.asarray(asph))


def _jax(specs, lens):
    """A port population as JAX objects."""
    st = lens.structure
    jst = JStructure(st.stop_idx, st.sequence)
    arr = lambda a: jnp.asarray(a.detach().numpy())
    return (JSpecs(jst, arr(specs.epd), arr(specs.hfov)),
            JLens(jst, arr(lens.c), arr(lens.t), arr(lens.nd), arr(lens.v), kappa=arr(lens.kappa),
                  asph=arr(lens.asph)))


def _jnp_outputs(mask, bounds, allow_backward, xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z,
                 n_per_w=N_PER_W):
    """K4's nine float outputs in full mode from JAX's jnp engine with the
    surface mask, the stacks gated and summed surface by surface in the
    kernel's order; the masks ride along as aux."""
    n_sys, n = xp.shape
    n_surf = c.shape[1]
    widx = np.minimum(np.arange(n) // n_per_w, mu.shape[2] - 1)
    col = lambda a: a.reshape(n_sys, 1, n, 1)
    surf = lambda a: a.reshape(n_sys, 1, 1, 1, n_surf)
    res = jtrace_mod.trace_skew(
        col(xp), col(yp), z0.reshape(n_sys, 1, 1, 1), jnp.zeros((1, 1, 1, 1)), col(cy),
        surf(c), surf(t), jnp.transpose(mu[:, :, widx], (0, 2, 1)).reshape(n_sys, 1, n, 1, n_surf),
        jnp.asarray(mask).reshape(n_sys, 1, 1, 1, n_surf), kappa=surf(kappa),
        asph=asph.reshape(n_sys, 1, 1, 1, n_surf, -1),
        aggregate=("z", "cos2", "cos2_prime") + jtrace_mod.AGG_TORCH,
        allow_backward_rays=allow_backward, engine="scan")
    stack = lambda k: [a.reshape(n_sys, n) for a in res.stacks[k]]
    gate = lambda k, a: jnp.where(mask[:, k, None], a, 0.0)
    outs = [a.reshape(n_sys, n) for a in res[:4]]
    for name in ("theta_norm", "theta_prime_norm", "z_RELU"):
        total = jnp.zeros((n_sys, n))
        for k, term in enumerate(stack(name)):
            total = total + gate(k, term)
        outs.append(total)
    z, cos2, cos2p = stack("z"), stack("cos2"), stack("cos2_prime")
    path = ang = jnp.zeros((n_sys, n))
    for k in range(n_surf):
        ang = (ang + gate(k, jnp.maximum(THR - cos2[k], 0.0))
               + gate(k, jnp.maximum(THR - cos2p[k], 0.0)))
        if k > 0:
            path = path + jpb._hinge((z[k] + ref_z[:, k, None]) - (z[k - 1] + ref_z[:, k - 1, None]),
                                     *bounds[k - 1])
    path = path + jpb._hinge(ref_z[:, n_surf, None] - (z[n_surf - 1] + ref_z[:, n_surf - 1, None]),
                             *bounds[n_surf - 1])
    return outs + [path, ang], (res.ray_ok.reshape(n_sys, n), res.ray_backward.reshape(n_sys, n))


def _theta_sensitivity(inputs, mask, n_per_w=N_PER_W):
    """Per ray, from the plain forward's locals over the real surfaces: the
    sum and the largest of |d theta_norm/d cos²| = 1/(pi u sqrt(1 - u²)),
    u = sqrt(cos²), for cos² and cos²' (0 where the clip holds theta), and
    whether cos² or cos²' reaches the clip edge (1 - 3e-7)²."""
    total = torch.zeros(inputs[0].shape, dtype=torch.float64)
    largest = torch.zeros_like(total)
    edge = torch.zeros(inputs[0].shape, dtype=torch.bool)

    def keep(k, pre, loc, kill, post):
        nonlocal total, largest, edge
        for v in (loc["cos2"], loc["cos2p"]):
            real = mask[:, k, None]
            u = torch.sqrt(torch.clamp(v.double(), min=1e-12))
            active = (u < 1.0 - 1e-7) & (v > 0) & real
            sens = torch.where(active, 1.0 / (math.pi * u * torch.sqrt(
                torch.where(active, 1.0 - u * u, 1.0))), 0.0)
            total = total + sens
            largest = torch.maximum(largest, sens)
            edge = edge | ((v >= (1.0 - 3e-7) ** 2) & real)
    fused_asphere._trace_batch(*inputs[:9], True, n_per_w, 10, keep, mask)
    return total.numpy(), largest.numpy(), edge.numpy()


def _pallas_vjp(static_mask, bounds):
    """The Pallas K4 in full mode (interpret mode, backward rays flagged) and
    its vjp."""
    fwd = functools.partial(jpa.trace_fused_asphere_batch_full, allow_backward=True,
                            mask=static_mask, path_bounds=bounds, angle_thr=THR,
                            n_per_w=N_PER_W)

    def run(args, cot):
        outs, vjp = jax.vjp(lambda *a: fwd(*a), *args)
        none = np.zeros(outs[4].shape, jax.dtypes.float0)
        return outs, vjp(tuple(list(cot[:4]) + [none, none] + list(cot[4:])))
    return run


def _routing_populations():
    return {"cooke": zoo.aspheric_population(3, device="cpu"),
            "mixed": zoo.aspheric_population(4, ("cooke", "double_gauss"), mask_pad=True,
                                             device="cpu")}


def _jnp_losses(jspecs, jlens):
    """JAX's compute_losses (value, dict and d/d(c, t, kappa, asph)) and
    do_ray_tracing (its trace, loss dict and d loss_unsup/d(c, t, kappa,
    asph)) on the jnp engine's scan form, as one jitted program."""
    cfg = jsim.SimulatorConfig(trace_engine="scan", **CONFIG, **TIGHT)
    lens_of = lambda c, t, kappa, asph: jlens.replace(c=c, t=t, kappa=kappa, asph=asph)

    def program(*params):
        total = lambda *p: jsim.compute_losses(jspecs, lens_of(*p), cfg)
        def lu(*p):
            res, loss_dict = jsim.do_ray_tracing(jspecs, lens_of(*p), cfg)
            return loss_dict["loss_unsup"], (loss_dict, res[:6])
        (tot, ld), g_tot = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(*params)
        (_, (lu_dict, res)), g_lu = jax.value_and_grad(lu, argnums=(0, 1, 2, 3),
                                                       has_aux=True)(*params)
        return tot, ld, g_tot, lu_dict, g_lu, res
    return jax.jit(program)


@pytest.fixture(scope="module")
def jax_side():
    """The kernel-level inputs, cotangents and JAX's outputs and vjps (jnp
    engine per policy, Pallas in full mode), JAX's front-end on the same
    population, and JAX's losses on the routing populations."""
    jspecs, jlens = _kernel_population()
    specs, lens = port(jspecs, jlens)
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    xp, yp, cyb, z0, mu, shape = fused_batch.prepare_fused_inputs_batch(specs, lens, cfg)
    assert shape[1] * shape[2] == N_PER_W
    arrays = [a.detach().numpy() for a in (xp, yp, cyb, z0, lens.c, lens.kappa, lens.t, mu,
                                           lens.asph)]
    vertex_z = np.cumsum(arrays[6], axis=1, dtype=np.float32)
    arrays.append(np.concatenate((vertex_z, vertex_z[:, -1:]), axis=1))
    mask = lens.structure.mask
    widest = int(np.argmax(lens.structure.n_surfaces))
    bounds = fused_trace._path_bounds(lens[np.array([widest])].structure, LOWER, UPPER)
    n_sys, n = arrays[0].shape
    rng = np.random.default_rng(0)
    cot = [rng.standard_normal((n_sys, n)).astype(np.float32) for _ in range(9)]
    sens_sum, sens_max, edge = _theta_sensitivity([torch.tensor(a) for a in arrays],
                                                  torch.tensor(mask))
    # Against JAX, no theta cotangent on rays within ~1e-4 of normal
    # incidence (|d theta/d cos²| > 20) or at the clip edge at some surface.
    cut = (sens_max > 20.0) | edge
    cot_jax = [np.where(cut, 0.0, a).astype(np.float32) if i in (4, 5) else a
               for i, a in enumerate(cot)]
    kept = lambda p: cot_jax[:N_COT[p]] + [np.zeros((n_sys, n), np.float32)] * (9 - N_COT[p])
    n_grads = lambda p: 10 if p == "full" else 9
    out = dict(specs=specs, lens=lens, inputs=arrays, mask=mask, bounds=bounds, cot=cot,
               cot_jax=cot_jax, theta_tol=1e-6 * sens_sum, jnp={}, pallas={}, routing={})

    static = tuple(tuple(int(v) for v in row) for row in mask)
    jcfg = jsim.SimulatorConfig(**CONFIG).trace_config()
    pops = _routing_populations()
    out["pops"] = pops
    lowered = {}
    with pltpu.force_tpu_interpret_mode():
        lowered["pallas"] = jax.jit(_pallas_vjp(static, bounds)).lower(arrays, kept("full"))
        hs, hl = _jax(*pops["cooke"])
        serve_cfg = jsim.SimulatorConfig(trace_engine="pallas", **CONFIG, **TIGHT)
        lowered["serve"] = jax.jit(
            lambda l: jsim.do_ray_tracing(hs, l, serve_cfg)[1]).lower(hl)
    lowered["front"] = jax.jit(lambda s, l: jpb.prepare_fused_inputs_batch(
        s, l, jcfg, w_order="outer")[:5]).lower(jspecs, jlens)
    for name, pop in pops.items():
        js, jl = _jax(*pop)
        lowered[name] = _jnp_losses(js, jl).lower(jl.c, jl.t, jl.kappa, jl.asph)
    as_np = lambda seq: [np.asarray(a) for a in seq]
    # XLA compiles without the GIL: the programs compile on threads while the
    # jnp engine's vjps run here.
    with ThreadPoolExecutor(4) as pool:
        compiled = {k: pool.submit(low.compile, compiler_options=FAST_COMPILE)
                    for k, low in lowered.items()}
        for ab in (True, False):
            outs, vjp, masks = jax.vjp(functools.partial(_jnp_outputs, mask, bounds, ab),
                                       *map(jnp.asarray, arrays), has_aux=True)
            grads = {}
            for p in MODES:
                g = vjp([jnp.asarray(a) for a in kept(p)])
                grads[p] = as_np(g)[:n_grads(p)]
            out["jnp"][ab] = (as_np(outs), as_np(masks), grads)
        compiled = {k: c.result() for k, c in compiled.items()}
    # One run at a time: the interpret mode's callbacks share state.
    for p in MODES:
        outs, grads = compiled["pallas"](arrays, kept(p))
        out["pallas_outs"] = as_np(outs)
        out["pallas"][p] = as_np(grads)[:n_grads(p)]
    out["jfront"] = as_np(compiled["front"](jspecs, jlens))
    out["serve"] = {k: float(v) for k, v in compiled["serve"](_jax(*pops["cooke"])[1]).items()}
    for name, pop in pops.items():
        jl = _jax(*pop)[1]
        tot, ld, g_tot, lu_dict, g_lu, res = compiled[name](jl.c, jl.t, jl.kappa, jl.asph)
        out["routing"][name] = dict(total=float(tot), losses={k: float(v) for k, v in ld.items()},
                                    grads=as_np(g_tot), lu={k: float(v) for k, v in lu_dict.items()},
                                    lu_grads=as_np(g_lu), trace=as_np(res))
    return out


def _torch_inputs(ref, penalties, requires_grad=False):
    n = 10 if penalties == "full" else 9
    return [torch.tensor(a).requires_grad_(requires_grad) for a in ref["inputs"][:n]]


def _forward(ref, penalties, allow_backward, ins=None):
    ins = _torch_inputs(ref, penalties) if ins is None else ins
    return fused_asphere.trace_fused_asphere_batch_reference(
        *ins[:9], penalties, allow_backward, N_PER_W, 10, torch.tensor(ref["mask"]),
        ins[9] if penalties == "full" else None, ref["bounds"], THR)


def _backward(ref, penalties, allow_backward, cot, ins=None):
    ins = _torch_inputs(ref, penalties) if ins is None else ins
    return fused_asphere.trace_fused_asphere_batch_backward_reference(
        ins, cot, penalties, allow_backward, N_PER_W, 10, torch.tensor(ref["mask"]),
        ref["bounds"], THR)


def _assert_rel_close(got, want, label, bar=BAR, slack=0.0, where=None):
    """|got - want| <= bar x max|want| + slack, elementwise (on ``where``)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    if where is not None:
        got, want = np.where(where, got, 0.0), np.where(where, want, 0.0)
    scale = max(np.abs(want).max(), 1e-30)
    excess = np.abs(got - want) - slack
    assert excess.max() <= bar * scale, (
        f"{label}: max deviation beyond the slack {excess.max() / scale:.3e} of the largest "
        f"magnitude (bar {bar})")


def _assert_forward_close(got, want, theta_tol, slack=None):
    """Coordinates on rays ok in both within 5e-6 + 1e-6 relative; penalty
    sums within 1e-5 + 4e-6 relative, the theta sums also within
    ``theta_tol``; each widened by ``slack`` where given. ``want`` holds the
    float outputs only, in order."""
    floats = [i for i in range(len(got)) if i not in (4, 5)]
    ok = got[4].numpy()
    for j, i in enumerate(floats):
        w = np.asarray(want[j], np.float64)
        g = got[i].detach().numpy()
        sel = ok if i < 4 else np.ones_like(ok)
        tol = (5e-6 + 1e-6 * np.abs(w)) if i < 4 else (1e-5 + 4e-6 * np.abs(w))
        if i in (6, 7):
            tol = tol + theta_tol
        if slack is not None:
            tol = tol + slack[j]
        bad = sel & ~(np.abs(g - w) <= tol)
        assert not bad.any(), (f"output {i}: {int(bad.sum())} rays out of tolerance, max "
                               f"excess {np.max((np.abs(g - w) - tol)[sel])}")


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_forward_reference_matches_jax(penalties, allow_backward, jax_side):
    ref = jax_side
    got = _forward(ref, penalties, allow_backward)
    assert len(got) == N_OUT[penalties]
    floats, masks, _ = ref["jnp"][allow_backward]
    n_float = N_OUT[penalties] - 2
    for i in (4, 5):
        np.testing.assert_array_equal(got[i].numpy(), masks[i - 4])
    _assert_forward_close(got, floats[:n_float], ref["theta_tol"])
    if allow_backward:
        pallas = ref["pallas_outs"]
        for i in (4, 5):
            np.testing.assert_array_equal(got[i].numpy(), pallas[i])
        p_floats = [pallas[i] for i in range(11) if i not in (4, 5)][:n_float]
        slack = [np.abs(np.asarray(j, np.float64) - p) for j, p in zip(floats, p_floats)]
        _assert_forward_close(got, p_floats, ref["theta_tol"], slack)
    if penalties == "full":
        assert got[9].mean() > 0 and got[10].mean() > 0, "both hinges must fire"


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_backward_reference_matches_jax_vjp(penalties, allow_backward, jax_side):
    ref = jax_side
    cot = [torch.tensor(a) for a in ref["cot_jax"][:N_COT[penalties]]]
    got = _backward(ref, penalties, allow_backward, cot)
    jnp_want = ref["jnp"][allow_backward][2][penalties]
    assert len(got) == len(jnp_want) == (10 if penalties == "full" else 9)
    for g, j, label in zip(got, jnp_want, LABELS):
        _assert_rel_close(g.numpy(), j, label)
    if allow_backward:
        for g, w, j, label in zip(got, ref["pallas"][penalties], jnp_want, LABELS):
            _assert_rel_close(g.numpy(), w, label, slack=np.abs(j.astype(np.float64) - w))


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_backward_reference_matches_autograd(penalties, allow_backward, jax_side):
    ref = jax_side
    ins = _torch_inputs(ref, penalties, requires_grad=True)
    cot = [torch.tensor(a) for a in ref["cot"][:N_COT[penalties]]]
    outs = _forward(ref, penalties, allow_backward, ins)
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    want = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    got = _backward(ref, penalties, allow_backward, cot, [a.detach() for a in ins])
    for g, w, label in zip(got, want, LABELS):
        _assert_rel_close(g.numpy(), w.numpy(), label)


@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_population_of_one_is_k3(penalties, allow_backward, jax_side):
    """K4's plain versions at B = 1 without a mask equal K3's bit for bit, on
    the population's widest system (no padded surface)."""
    ref = jax_side
    b = int(np.argmax(ref["lens"].structure.n_surfaces))
    ins = [a[b:b + 1] for a in _torch_inputs(ref, penalties)]
    cot = [torch.tensor(a[b:b + 1]) for a in ref["cot"][:N_COT[penalties]]]
    ref_z = ins[9] if penalties == "full" else None
    got = fused_asphere.trace_fused_asphere_batch_reference(
        *ins[:9], penalties, allow_backward, N_PER_W, 10, None, ref_z, ref["bounds"], THR)
    one = [a.reshape(()) if i == 3 else a[0] for i, a in enumerate(ins)]
    want = fused_asphere.trace_fused_asphere_reference(
        *one[:9], penalties, allow_backward, N_PER_W, 10, None if ref_z is None else one[9],
        ref["bounds"], THR)
    assert len(got) == len(want) == N_OUT[penalties]
    assert all(torch.equal(a[0], w) for a, w in zip(got, want))
    g_batch = fused_asphere.trace_fused_asphere_batch_backward_reference(
        ins, cot, penalties, allow_backward, N_PER_W, 10, None, ref["bounds"], THR)
    g_one = fused_asphere.trace_fused_asphere_backward_reference(
        one, [c[0] for c in cot], penalties, allow_backward, N_PER_W, 10, ref["bounds"], THR)
    assert all(torch.equal(a.reshape(-1), w.reshape(-1)) for a, w in zip(g_batch, g_one))


@pytest.mark.parametrize("penalties", [False, True])
def test_k4_without_asphere_terms_matches_k2(penalties, jax_side):
    """K4's plain versions at kappa = asph = 0 against K2's on the padded
    population: masks identical, coordinates and the relu(z) sums within
    JAX's own K3-vs-K1 bar (1e-5 + 1e-4 relative), the cotangents K2 has
    within 1e-4 of each one's largest magnitude."""
    ref = jax_side
    xp, yp, cy, z0, c, kappa, t, mu, asph = _torch_inputs(ref, penalties)
    mask = torch.tensor(ref["mask"])
    zero_k, zero_a = torch.zeros_like(kappa), torch.zeros_like(asph)
    k4 = fused_asphere.trace_fused_asphere_batch_reference(
        xp, yp, cy, z0, c, zero_k, t, mu, zero_a, penalties, True, N_PER_W, 10, mask)
    k2 = fused_batch.trace_fused_batch_reference(xp, yp, cy, z0, c, t, mu, penalties, True,
                                                 N_PER_W, mask)
    assert torch.equal(k4[4], k2[4])
    ok = k2[4]
    assert torch.equal(k4[5][ok], k2[5][ok])
    pairs = list(zip(k4[:4], k2[:4])) + ([(k4[8], k2[8])] if penalties else [])
    for a, b in pairs:
        np.testing.assert_allclose(a[ok].numpy(), b[ok].numpy(), rtol=1e-4, atol=1e-5)
    cot = [torch.tensor(a) for a in ref["cot_jax"][:N_COT[penalties]]]
    g4 = fused_asphere.trace_fused_asphere_batch_backward_reference(
        (xp, yp, cy, z0, c, zero_k, t, mu, zero_a), cot, penalties, True, N_PER_W, 10, mask)
    g2 = fused_batch.trace_fused_batch_backward_reference((xp, yp, cy, z0, c, t, mu), cot,
                                                          penalties, True, N_PER_W, mask)
    for a, b, label in zip(g4[:5] + (g4[6], g4[7]), g2, ("dxp", "dyp", "dcy", "dz0", "dc", "dt",
                                                          "dmu")):
        _assert_rel_close(a.numpy(), b.numpy(), label)


def test_function_runs_the_plain_versions_on_cpu(jax_side):
    """The autograd Function on CPU tensors: forward equal to the plain
    version, backward equal to the backward plain version, no launch."""
    ref = jax_side
    before = (fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES)
    mask = torch.tensor(ref["mask"])
    ins = _torch_inputs(ref, "full", requires_grad=True)
    outs = fused_asphere.trace_fused_asphere_batch_full(*ins, True, ref["bounds"], THR, N_PER_W,
                                                        10, mask)
    assert all(torch.equal(a, b) for a, b in zip(outs, _forward(ref, "full", True)))
    assert not outs[4].requires_grad and not outs[5].requires_grad
    cot = [torch.tensor(a) for a in ref["cot"]]
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    grads = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    hand = _backward(ref, "full", True, cot, [a.detach() for a in ins])
    assert all(torch.equal(a, b) for a, b in zip(grads, hand))
    lu = fused_asphere.trace_fused_asphere_batch(*ins[:9], True, False, N_PER_W, 10, mask)
    assert all(torch.equal(a, b) for a, b in zip(lu, _forward(ref, True, False)))
    assert (fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="trace_fused_asphere_batch_full"):
        fused_asphere.trace_fused_asphere_batch(*ins[:9], "full", True, N_PER_W)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_asphere.trace_fused_asphere_batch(*[a.detach().to("meta") for a in ins[:9]],
                                                False, True, N_PER_W)


def test_front_end_matches_jax(jax_side):
    """The batched front-end on the aspheric population (ray aiming through
    the pure-torch Newton engine for B > 1) against JAX's (W-outer branch):
    aimed pupil coordinates within 1e-5 of their scale, the rest 1e-6
    relative."""
    ref = jax_side
    jxp, jyp, jcy, jz0, jmu = ref["jfront"]
    xp, yp, cyb, z0 = ref["inputs"][:4]
    for a, b in ((xp, jxp), (yp, jyp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(cyb, jcy, rtol=1e-6)
    np.testing.assert_allclose(z0, jz0, rtol=1e-6)
    np.testing.assert_allclose(ref["inputs"][7], jmu, rtol=1e-6)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of K2's and K4's plain forward versions."""
    calls = {"K2": 0, "K4": 0}

    def counting(kernel, fn):
        def wrapped(*args, **kwargs):
            calls[kernel] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(fused_batch, "trace_fused_batch_reference",
                        counting("K2", fused_batch.trace_fused_batch_reference))
    monkeypatch.setattr(fused_asphere, "trace_fused_asphere_batch_reference",
                        counting("K4", fused_asphere.trace_fused_asphere_batch_reference))
    return calls


def test_zoo_population_carries_the_aspheres(plain_calls):
    """``zoo.population`` of an aspheric prescription is an aspheric
    population: it goes to K4's plain version, not K2's, and its system 0 at
    zero perturbation traces like ``zoo.build``'s lens."""
    specs, lens = zoo.population("double_gauss_asph", 2, device="cpu")
    base_specs, base = zoo.build("double_gauss_asph", device="cpu")
    assert torch.equal(lens.kappa, base.kappa.repeat(2, 1))
    assert torch.equal(lens.asph, base.asph.repeat(2, 1, 1))
    cfg = simulator.SimulatorConfig(trace_engine="fused", **CONFIG)
    with torch.no_grad():
        res = trace.trace_rays(specs, lens, cfg.trace_config())
    assert plain_calls == {"K2": 0, "K4": 1} and res.x.shape == (2, 2, 16, 2)
    pair = np.array([0, 0])
    with torch.no_grad():
        got = trace.trace_rays(specs[pair], lens[pair].replace(c=base.c.repeat(2, 1)),
                               cfg.trace_config())
        want = trace.trace_rays(base_specs, base, cfg.trace_config())
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[0])
    # The benchmark's draws: the same numbers as bench_generator_loss.py's
    # "pallas-asphere" population for the same seeds.
    _, asph_lens = zoo.aspheric_population(4, device="cpu")
    _, cooke = zoo.population("cooke", 4, device="cpu")
    rng = np.random.default_rng(1)
    kappa = rng.uniform(-0.3, 0.1, (4, 7)).astype(np.float32)
    asph = (rng.uniform(-1, 1, (4, 7, 2)) * np.asarray([1e-5, 1e-8])).astype(np.float32)
    assert torch.equal(asph_lens.c, cooke.c)
    np.testing.assert_array_equal(asph_lens.kappa.numpy(), kappa)
    np.testing.assert_array_equal(asph_lens.asph.numpy(), asph)


@pytest.mark.parametrize("name", ["cooke", "mixed"])
def test_loss_paths_match_jax(name, jax_side, plain_calls):
    """``do_ray_tracing``, ``batched_unsupervised_loss`` and
    ``compute_losses`` on the fused engine (K4's plain versions) against
    JAX's jnp engine: values and d/d(c, t, kappa, asph) on real surfaces;
    the homogeneous population's served losses also against JAX's Pallas
    engine. The full loss is one K4 launch on the homogeneous population and
    one per lens type on the mixed one."""
    specs, lens = jax_side["pops"][name]
    want = jax_side["routing"][name]
    cfg = simulator.SimulatorConfig(trace_engine="fused", **CONFIG, **TIGHT)
    mask = torch.as_tensor(lens.structure.mask)
    where = lambda k: mask[..., None].numpy() if k == "asph" else mask.numpy()

    with torch.no_grad():
        _, served = simulator.do_ray_tracing(specs, lens, cfg)
    for k, v in want["lu"].items():
        np.testing.assert_allclose(float(served[k]), v, rtol=VALUE_RTOL[k], err_msg=k)
    if name == "cooke":
        for k, v in jax_side["serve"].items():
            np.testing.assert_allclose(float(served[k]), v, rtol=VALUE_RTOL[k], err_msg=k)

    params = [getattr(lens, k).clone().requires_grad_(True) for k in PARAMS]
    trained = lens.replace(**dict(zip(PARAMS, params)))
    lu, lu_dict = fused_batch.batched_unsupervised_loss(specs, trained, cfg)
    np.testing.assert_allclose(float(lu.detach()), want["lu"]["loss_unsup"], rtol=1e-5)
    for k, g, w in zip(PARAMS, torch.autograd.grad(lu, params), want["lu_grads"]):
        _assert_rel_close(g.numpy(), w, f"d loss_unsup/d{k}", where=where(k))

    calls = dict(plain_calls)
    total, losses = simulator.compute_losses(specs, trained, cfg)
    n_types = len(set(lens.structure.sequence))
    assert plain_calls["K4"] - calls["K4"] == n_types and plain_calls["K2"] == 0
    np.testing.assert_allclose(float(total.detach()), want["total"], rtol=1e-5)
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=VALUE_RTOL[k], err_msg=k)
    for k, g, w in zip(PARAMS, torch.autograd.grad(total, params), want["grads"]):
        _assert_rel_close(g.numpy(), w, f"d total/d{k}", where=where(k))
    if name == "cooke":
        direct, _ = fused_batch.batched_compute_losses_fused(specs, trained, cfg)
        assert float(direct.detach()) == float(total.detach())


@pytest.mark.parametrize("name", ["cooke", "mixed"])
def test_trace_rays_matches_unroll(name, jax_side):
    """``trace_rays(engine='fused')`` on the aspheric populations (K4's plain
    version) against the pure-torch engine and JAX's jnp engine: masks
    identical, coordinates within the module's forward bar;
    ``trace_rays_fused_asphere_batch`` gives the same result, and an absent
    ``asph`` is taken as zeros."""
    specs, lens = jax_side["pops"][name]
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    res_u = trace.trace_rays(specs, lens, cfg)
    res_f = trace.trace_rays(specs, lens, dataclasses.replace(cfg, engine="fused"))
    assert res_f.x.shape == res_u.x.shape == (len(lens), 2, 16, 2) and res_f.stacks is None
    for want in (res_u[:6], jax_side["routing"][name]["trace"]):
        want = [np.asarray(a) for a in want]
        np.testing.assert_array_equal(res_f.ray_ok.numpy(), want[4])
        np.testing.assert_array_equal(res_f.ray_backward.numpy(), want[5])
        ok = want[4]
        for a, b in zip(res_f[:4], want[:4]):
            assert (np.abs(a.numpy() - b) <= 5e-6 + 1e-6 * np.abs(b))[ok].all()
    # The K4 entry point gives the same result; a lens with only conics gets
    # zero coefficients.
    fused_cfg = dataclasses.replace(cfg, engine="fused")
    direct = fused_asphere.trace_rays_fused_asphere_batch(specs, lens, fused_cfg)
    assert all(torch.equal(a, b) for a, b in zip(direct[:6], res_f[:6]))
    zero = torch.zeros(lens.c.shape + (1,))
    for a, b in zip(trace.trace_rays(specs, lens.replace(asph=None), fused_cfg)[:6],
                    trace.trace_rays(specs, lens.replace(asph=zero), fused_cfg)[:6]):
        assert torch.equal(a, b)
