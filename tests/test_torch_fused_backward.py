"""Port parity for kernel K1's backward pass and full mode (``ops.fused_trace``).

The same flat wavelength-outer inputs (the double-Gauss ray block of the
port's front-end, as numpy) and the same cotangents (numpy, seeded) go
through:

* ``trace_fused_reference`` in full mode, against JAX's Pallas kernel
  ``trace_fused_full`` in interpret mode and against JAX's jnp engine
  stacks; with tight path and angle bounds, so that both hinges fire;
* ``trace_fused_backward_reference`` (the plain version of the CUDA
  backward kernel), against ``jax.vjp`` of the Pallas kernel, and against
  ``torch.autograd.grad`` through ``trace_fused_reference``, an independent
  check that the hand adjoint is the derivative. JAX's vjp is taken of
  ``trace_fused_full`` once per backward-ray policy (an interpret-mode
  compile costs ~20 s); its Lu and plain adjoints are that vjp with the
  hinge cotangents, and then all five penalty cotangents, set to zero: its
  ``_bwd_kernel`` then adds exact zeros where the Lu and plain modes add
  nothing.

Both backward-ray policies, on the flagship and on the c x 3 double-Gauss
that fails rays. Bars, relative to the largest magnitude of each cotangent
(as ``test_pallas_trace.py`` compares gradients): 1e-4 against JAX and
against autograd. The forward's hinge sums: 1e-5 + 1e-6 relative against
the jnp stacks, plus the jnp-vs-Pallas distance against the Pallas kernel
(the interpret mode rounds differently from the jnp engine, see
``test_torch_fused_trace``).
The CUDA kernels are held against these plain versions on a GPU by
``test_torch_kernels_cuda.py``.
"""

import functools
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.ops import pallas_trace as jpt
from torchoptics_tpu.ops import trace as jtrace_mod
from torchoptics_tpu_torch import simulator, zoo
from torchoptics_tpu_torch.ops import fused_trace
from torchoptics_tpu_torch.ops import trace as trace_mod

CONFIG = dict(n_sampled_fields=3, n_pupil_rings=8, pupil_sampling="circular",
              n_ray_aiming_iter=1)
LENSES = {"double_gauss": 1.0, "double_gauss_c3": 3.0}
N_PER_W = 3 * 8 * 8
# Tight bounds (test_pallas_coverage.py), so that both hinges fire.
LOWER, UPPER, ANGLE = (0.5, 1.5, 12.0), (None, 3.0, 40.0), 30.0
THR = math.cos(math.radians(ANGLE)) ** 2
MODES = [False, True, "full"]
N_COT = {False: 4, True: 7, "full": 9}
BAR = 1e-4
# The interpret-mode kernels lower to a large XLA CPU program: without LLVM's
# optimizations it compiles in half the time (~13 s instead of ~26 s).
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _pallas_vjp(allow_backward, bounds, inputs, cot, n_per_w=N_PER_W):
    """The outputs and vjp of the Pallas K1 in full mode (interpret mode),
    lowered for these argument shapes."""
    fwd = functools.partial(jpt.trace_fused_full, allow_backward=allow_backward,
                            path_bounds=bounds, angle_thr=THR, n_per_w=n_per_w)

    def run(inputs, cot):
        outs, vjp = jax.vjp(lambda *a: fwd(*a), *inputs)
        none = np.zeros(outs[4].shape, jax.dtypes.float0)
        return outs, vjp(tuple(list(cot[:4]) + [none, none] + list(cot[4:])))
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(run).lower(inputs, cot)


def _jnp_outputs(bounds, allow_backward, xp, yp, cyb, z0, c, t, mu, ref_z, n_per_w=N_PER_W):
    """The nine float outputs of K1's full mode from JAX's jnp engine and its
    stacks, the sums accumulated surface by surface in the kernel's order."""
    n, n_surf = xp.shape[0], c.shape[0]
    widx = np.minimum(np.arange(n) // n_per_w, mu.shape[1] - 1)
    col = lambda a: a.reshape(1, 1, -1, 1)
    surf = lambda a: a.reshape(1, 1, 1, 1, n_surf)
    res = jtrace_mod.trace_skew(
        col(xp), col(yp), z0.reshape(1, 1, 1, 1), jnp.zeros((1, 1, 1, 1)), col(cyb),
        surf(c), surf(t), mu[:, widx].T.reshape(1, 1, n, 1, n_surf),
        jnp.ones((1, 1, 1, 1, n_surf), bool),
        aggregate=("z", "cos2", "cos2_prime") + jtrace_mod.AGG_TORCH,
        allow_backward_rays=allow_backward)
    stack = lambda k: [a.reshape(n) for a in res.stacks[k]]
    sums = []
    for k in ("theta_norm", "theta_prime_norm", "z_RELU"):
        total = jnp.zeros(n)
        for term in stack(k):
            total = total + term
        sums.append(total)
    z, cos2, cos2p = stack("z"), stack("cos2"), stack("cos2_prime")
    path = jnp.zeros(n)
    ang = jnp.zeros(n)
    for k in range(n_surf):
        ang = ang + jnp.maximum(THR - cos2[k], 0.0) + jnp.maximum(THR - cos2p[k], 0.0)
        if k > 0:
            path = path + jpt._hinge((z[k] + ref_z[k]) - (z[k - 1] + ref_z[k - 1]),
                                     *bounds[k - 1])
    path = path + jpt._hinge(ref_z[n_surf] - (z[n_surf - 1] + ref_z[n_surf - 1]),
                             *bounds[n_surf - 1])
    return tuple(a.reshape(n) for a in res[:4]) + tuple(sums) + (path, ang)


def _at_clip_edge(inputs, n_per_w=N_PER_W):
    """Rays whose cos² or cos²' reaches (1 - 3e-7)² at some surface."""
    xp, yp, cyb, z0, c, t, mu = inputs
    n, n_surf = xp.shape[0], c.shape[0]
    widx = torch.clamp(torch.arange(n) // n_per_w, max=mu.shape[1] - 1)
    res = trace_mod.trace_skew(
        xp.reshape(1, 1, n, 1), yp.reshape(1, 1, n, 1), z0.reshape(1, 1, 1, 1),
        torch.zeros(1, 1, 1, 1), cyb.reshape(1, 1, n, 1), c.reshape(1, 1, 1, 1, n_surf),
        t.reshape(1, 1, 1, 1, n_surf), mu[:, widx].T.reshape(1, 1, n, 1, n_surf),
        torch.ones(1, 1, 1, 1, n_surf, dtype=torch.bool), aggregate=("cos2", "cos2_prime"))
    cos2 = torch.cat((res.stacks["cos2"], res.stacks["cos2_prime"])).reshape(-1, n)
    return (cos2 >= (1.0 - 3e-7) ** 2).any(dim=0).numpy()


@pytest.fixture(scope="module")
def jax_side():
    """Per lens: the flat inputs, ref_z, the path bounds, seeded cotangents,
    and per policy the Pallas kernel's full-mode outputs and its vjp for
    each mode's cotangents; plus the jnp engine's full-mode penalty sums."""
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    rng = np.random.default_rng(0)
    out = {}
    for name, c_scale in LENSES.items():
        specs, lens = zoo.build("double_gauss", device="cpu")
        lens = lens.replace(c=lens.c * c_scale)
        xp, yp, cyb, z0, mu, shape = fused_trace.prepare_fused_inputs(specs, lens, cfg)
        assert shape[1] * shape[2] == N_PER_W
        arrays = [a.detach().numpy() for a in (xp, yp, cyb, z0, lens.c[0], lens.t[0], mu)]
        vertex_z = np.cumsum(arrays[5], dtype=np.float32)
        ref_z = np.concatenate((vertex_z, vertex_z[-1:]))
        bounds = fused_trace._path_bounds(lens.structure, LOWER, UPPER)
        assert bounds == jpt._path_bounds(jzoo.build("double_gauss")[1].structure, LOWER, UPPER)
        n = arrays[0].shape[0]
        cot = [rng.standard_normal(n).astype(np.float32) for _ in range(9)]
        # Against JAX, no theta_norm cotangent on rays that reach the clip
        # edge u = sqrt(cos²) = 1 - 1e-7 at some surface: there one ulp of
        # cos² switches d(theta)/d(cos²) between ~1,600x and 0, and the Pallas
        # kernel, the jnp engine (whose clip passes half the gradient at the
        # edge) and the port land on different sides.
        edge = _at_clip_edge([torch.tensor(a) for a in arrays])
        cot_jax = [np.where(edge, 0.0, a).astype(np.float32) if i in (4, 5) else a
                   for i, a in enumerate(cot)]
        out[name] = dict(inputs=arrays, ref_z=ref_z, bounds=bounds, cot=cot, cot_jax=cot_jax,
                         pallas={}, jnp={})
    first = out["double_gauss"]
    args = lambda ref: ref["inputs"] + [ref["ref_z"]]
    kept = lambda ref, penalties: (ref["cot_jax"][:N_COT[penalties]]
                                   + [np.zeros_like(ref["cot"][0])] * (9 - N_COT[penalties]))
    keep = lambda penalties: 8 if penalties == "full" else 7
    # XLA compiles without the GIL: the two policies' kernels compile on
    # threads while the jnp engine's vjps run here.
    with ThreadPoolExecutor(2) as pool:
        runners = {ab: pool.submit(_pallas_vjp(ab, first["bounds"], args(first),
                                               first["cot_jax"]).compile,
                               compiler_options=FAST_COMPILE)
                   for ab in (True, False)}
        for ref in out.values():
            for ab in (True, False):
                jnp_outs, jnp_vjp = jax.vjp(functools.partial(_jnp_outputs, ref["bounds"], ab),
                                            *map(jnp.asarray, args(ref)))
                ref["jnp"][ab] = ([np.asarray(o) for o in jnp_outs],
                                  {p: [np.asarray(a) for a in jnp_vjp(tuple(kept(ref, p)))][:keep(p)]
                                   for p in MODES})
        runners = {ab: runner.result() for ab, runner in runners.items()}
    # One run at a time: the interpret mode's callbacks share state.
    for ref in out.values():
        for ab in (True, False):
            for p in MODES:
                outs, g = runners[ab](args(ref), kept(ref, p))
                # Every mode's run has the same full-mode outputs.
                ref["pallas"].setdefault(ab, ([np.asarray(o) for o in outs], {}))
                ref["pallas"][ab][1][p] = [np.asarray(a) for a in g][:keep(p)]
    return out


def _torch_inputs(ref, penalties, requires_grad=False):
    ins = [torch.tensor(a) for a in ref["inputs"]]
    if penalties == "full":
        ins.append(torch.tensor(ref["ref_z"]))
    return [a.requires_grad_(requires_grad) for a in ins]


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


LABELS = ("dxp", "dyp", "dcy", "dz0", "dc", "dt", "dmu", "dref_z")


@pytest.mark.parametrize("name", list(LENSES))
@pytest.mark.parametrize("allow_backward", [True, False])
def test_full_mode_forward_matches_jax(name, allow_backward, jax_side):
    """The plain version's full mode against the Pallas kernel and the jnp
    engine: the first nine outputs as ``test_torch_fused_trace`` holds them,
    the two hinge sums within 1e-5 of the jnp stacks and within 1e-5 plus
    the jnp-vs-Pallas distance of the Pallas kernel."""
    ref = jax_side[name]
    ins = _torch_inputs(ref, "full")
    got = [a.numpy() for a in fused_trace.trace_fused_reference(
        *ins[:7], "full", allow_backward, N_PER_W, ins[7], ref["bounds"], THR)]
    pallas = ref["pallas"][allow_backward][0]
    assert len(got) == len(pallas) == 11
    np.testing.assert_array_equal(got[4], pallas[4])
    np.testing.assert_array_equal(got[5], pallas[5])
    jnp_outs = ref["jnp"][allow_backward][0]
    for i in (9, 10):
        # Sums of ~10 gap terms of up to ~60 mm (float32's ulp there is
        # 4e-6); on the c x 3 lens, rays at grazing incidence before they
        # fail amplify one ulp to ~3e-6 relative.
        want_jnp = jnp_outs[i - 2]
        tol = 1e-5 + 4e-6 * np.abs(want_jnp)
        err = np.abs(got[i] - want_jnp)
        assert (err <= tol).all(), f"output {i}: max excess {(err - tol).max()}"
        slack = np.abs(want_jnp.astype(np.float64) - pallas[i])
        assert (np.abs(got[i] - pallas[i]) <= tol + slack).all()
    assert got[9].mean() > 0 and got[10].mean() > 0, "both hinges must fire"
    if name == "double_gauss_c3":
        assert 0 < got[4].mean() < 1


@pytest.mark.parametrize("name", list(LENSES))
@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_backward_reference_matches_jax_vjp(name, penalties, allow_backward, jax_side):
    ref = jax_side[name]
    ins = _torch_inputs(ref, penalties)
    cot = [torch.tensor(a) for a in ref["cot_jax"][:N_COT[penalties]]]
    got = fused_trace.trace_fused_backward_reference(
        ins, cot, penalties, allow_backward, N_PER_W, ref["bounds"], THR)
    want = ref["pallas"][allow_backward][1][penalties]
    jnp_want = ref["jnp"][allow_backward][1][penalties]
    assert len(got) == len(want) == (8 if penalties == "full" else 7)
    for g, w, j, label in zip(got, want, jnp_want, LABELS):
        _assert_rel_close(g.numpy(), w, label, slack=np.abs(j.astype(np.float64) - w))


@pytest.mark.parametrize("name", list(LENSES))
@pytest.mark.parametrize("penalties", MODES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_backward_reference_matches_autograd(name, penalties, allow_backward, jax_side):
    ref = jax_side[name]
    ins = _torch_inputs(ref, penalties, requires_grad=True)
    cot = [torch.tensor(a) for a in ref["cot"][:N_COT[penalties]]]
    outs = fused_trace.trace_fused_reference(
        *ins[:7], penalties, allow_backward, N_PER_W, ins[7] if penalties == "full" else None,
        ref["bounds"], THR)
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    want = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    got = fused_trace.trace_fused_backward_reference(
        [a.detach() for a in ins], cot, penalties, allow_backward, N_PER_W, ref["bounds"], THR)
    for g, w, label in zip(got, want, LABELS):
        _assert_rel_close(g.numpy(), w.numpy(), label)


def test_failed_lanes_get_exactly_zero_gradient(jax_side):
    """On the c x 3 lens, rays that fail at a surface carry no cotangent back
    to the pupil (plain mode, backward rays flagged, not removed)."""
    ref = jax_side["double_gauss_c3"]
    ins = _torch_inputs(ref, False)
    outs = fused_trace.trace_fused_reference(*ins, False, True, N_PER_W)
    failed = ~outs[4].numpy()
    assert failed.any()
    cot = [torch.tensor(a) for a in ref["cot"][:4]]
    got = fused_trace.trace_fused_backward_reference(ins, cot, False, True, N_PER_W)
    for g in got[:3]:
        assert (g.numpy()[failed] == 0).all()
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_function_runs_the_plain_versions_on_cpu(jax_side):
    """The autograd Function on CPU tensors: forward equal to the plain
    version, backward equal to the backward plain version, no launch."""
    ref = jax_side["double_gauss"]
    before = (fused_trace.K1_FWD_LAUNCHES, fused_trace.K1_BWD_LAUNCHES)
    ins = _torch_inputs(ref, "full", requires_grad=True)
    outs = fused_trace.trace_fused_full(*ins, True, ref["bounds"], THR, N_PER_W)
    want = fused_trace.trace_fused_reference(*[a.detach() for a in ins[:7]], "full", True,
                                             N_PER_W, ins[7].detach(), ref["bounds"], THR)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert not outs[4].requires_grad and not outs[5].requires_grad
    cot = [torch.tensor(a) for a in ref["cot"][:9]]
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    grads = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    hand = fused_trace.trace_fused_backward_reference(
        [a.detach() for a in ins], cot, "full", True, N_PER_W, ref["bounds"], THR)
    assert all(torch.equal(a, b) for a, b in zip(grads, hand))
    assert (fused_trace.K1_FWD_LAUNCHES, fused_trace.K1_BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="trace_fused_full"):
        fused_trace.trace_fused(*ins[:7], "full", True, N_PER_W)
