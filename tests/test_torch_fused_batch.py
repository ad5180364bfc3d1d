"""Port parity for kernel K2 (``ops.fused_batch``), the population trace.

The same (B, N) wavelength-outer inputs (the port's batched front-end, as
numpy) and the same seeded cotangents go through:

* ``trace_fused_batch_reference`` (the plain version of the CUDA forward
  kernel), against JAX's Pallas kernel ``pallas_batch.trace_fused_batch[_full]``
  in interpret mode and against JAX's jnp engine (``trace.trace_skew`` with
  the surface mask, its stacks summed surface by surface and gated as the
  kernel gates them);
* ``trace_fused_batch_backward_reference`` (the plain version of the CUDA
  backward kernel), against ``jax.vjp`` of the Pallas kernel and of the jnp
  engine, and against ``torch.autograd.grad`` through the forward plain
  version. JAX's vjp is taken once per population and backward-ray policy in
  the widest mode the population reaches (full on the homogeneous
  population, Lu on the padded one); the narrower modes are that vjp with
  the extra penalty cotangents set to zero, which the Pallas adjoint adds as
  exact zeros.

Populations, 3 fields x 4x4 circular pupil x 3 wavelengths (144 rays per
system), ray aiming on: three perturbed Cooke triplets, the second with its
curvatures x 1.5 so that rays fail and turn back; and a padded population of
one Cooke triplet (7 surfaces) and one double-Gauss (11). Tight path and
angle bounds make both hinges fire.

Bars: masks bit-identical; coordinates within 5e-6 + 1e-6 relative and
penalty sums within 1e-5 + 4e-6 relative of the jnp engine, plus the
jnp-vs-Pallas distance against the Pallas kernel (interpret mode rounds
differently, see ``test_torch_fused_trace``); cotangents within 1e-4 of
their largest magnitude, plus the jnp-vs-Pallas distance. Rays that reach
the theta clip edge get no theta cotangent in the comparisons with JAX (see
``test_torch_fused_backward``). The CUDA kernels are held against these
plain versions on a GPU by ``test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
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

from torchoptics_tpu import simulator as jsim
from torchoptics_tpu.models.structure import Lens as JLens
from torchoptics_tpu.models.structure import Specs as JSpecs
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import pallas_batch as jpb
from torchoptics_tpu.ops import trace as jtrace_mod
from torchoptics_tpu_torch import simulator, zoo
from torchoptics_tpu_torch.ops import fused_batch, fused_trace

CONFIG = dict(n_sampled_fields=3, n_pupil_rings=4, pupil_sampling="circular",
              n_ray_aiming_iter=1)
N_PER_W = 3 * 16
LOWER, UPPER = (0.5, 1.5, 12.0), (None, 3.0, 40.0)
THR = math.cos(math.radians(30.0)) ** 2
MODES = {"cooke": [False, True, "full"], "mixed": [False, True]}
CASES = [(pop, p, ab) for pop, modes in MODES.items() for p in modes for ab in (True, False)]
N_COT = {False: 4, True: 7, "full": 9}
BAR = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LABELS = ("dxp", "dyp", "dcy", "dz0", "dc", "dt", "dmu", "dref_z")


def _population(name):
    if name == "cooke":
        specs, lens = zoo.population("cooke", 3, device="cpu")
        return specs, lens.replace(c=lens.c * torch.tensor([[1.0], [1.5], [1.0]]))
    return zoo.mixed_population(2, device="cpu")


def _jax_population(specs, lens):
    st = lens.structure
    jst = JStructure(st.stop_idx, st.sequence)
    arr = lambda a: jnp.asarray(a.detach().numpy())
    return (JSpecs(jst, arr(specs.epd), arr(specs.hfov)),
            JLens(jst, arr(lens.c), arr(lens.t), arr(lens.nd), arr(lens.v)))


def _jnp_outputs(mask, bounds, allow_backward, xp, yp, cy, z0, c, t, mu, ref_z=None):
    """K2's float outputs from JAX's jnp engine with the surface mask, the
    penalty stacks gated and summed surface by surface in the kernel's
    order; the masks ride along as aux."""
    n_sys, n = xp.shape
    n_surf = c.shape[1]
    widx = np.minimum(np.arange(n) // N_PER_W, mu.shape[2] - 1)
    col = lambda a: a.reshape(n_sys, 1, n, 1)
    surf = lambda a: a.reshape(n_sys, 1, 1, 1, n_surf)
    m = np.ones((n_sys, n_surf), bool) if mask is None else mask
    res = jtrace_mod.trace_skew(
        col(xp), col(yp), z0.reshape(n_sys, 1, 1, 1), jnp.zeros((1, 1, 1, 1)), col(cy),
        surf(c), surf(t), jnp.transpose(mu[:, :, widx], (0, 2, 1)).reshape(n_sys, 1, n, 1, n_surf),
        jnp.asarray(m).reshape(n_sys, 1, 1, 1, n_surf),
        aggregate=("z", "cos2", "cos2_prime") + jtrace_mod.AGG_TORCH,
        allow_backward_rays=allow_backward)
    stack = lambda k: [a.reshape(n_sys, n) for a in res.stacks[k]]
    gate = lambda k, a: jnp.where(m[:, k, None], a, 0.0)
    outs = [a.reshape(n_sys, n) for a in res[:4]]
    for name in ("theta_norm", "theta_prime_norm", "z_RELU"):
        total = jnp.zeros((n_sys, n))
        for k, term in enumerate(stack(name)):
            total = total + gate(k, term)
        outs.append(total)
    if ref_z is not None:
        z, cos2, cos2p = stack("z"), stack("cos2"), stack("cos2_prime")
        path = ang = jnp.zeros((n_sys, n))
        for k in range(n_surf):
            ang = (ang + gate(k, jnp.maximum(THR - cos2[k], 0.0))
                   + gate(k, jnp.maximum(THR - cos2p[k], 0.0)))
            if k > 0:
                path = path + jpb._hinge(
                    (z[k] + ref_z[:, k, None]) - (z[k - 1] + ref_z[:, k - 1, None]),
                    *bounds[k - 1])
        path = path + jpb._hinge(
            ref_z[:, n_surf, None] - (z[n_surf - 1] + ref_z[:, n_surf - 1, None]),
            *bounds[n_surf - 1])
        outs += [path, ang]
    return outs, (res.ray_ok.reshape(n_sys, n), res.ray_backward.reshape(n_sys, n))


def _at_clip_edge(inputs, mask):
    """Rays whose cos² or cos²' reaches (1 - 3e-7)² at some surface."""
    xp, yp, cy, z0, c, t, mu = (torch.tensor(a) for a in inputs[:7])
    n_sys, n = xp.shape
    n_surf = c.shape[1]
    widx = fused_batch._widx(n, N_PER_W, mu.shape[2], "cpu")
    m = torch.ones(n_sys, n_surf, dtype=torch.bool) if mask is None else torch.tensor(mask)
    res = simulator.trace_mod.trace_skew(
        xp.reshape(n_sys, 1, n, 1), yp.reshape(n_sys, 1, n, 1), z0.reshape(n_sys, 1, 1, 1),
        torch.zeros(1, 1, 1, 1), cy.reshape(n_sys, 1, n, 1), c.reshape(n_sys, 1, 1, 1, n_surf),
        t.reshape(n_sys, 1, 1, 1, n_surf),
        mu[:, :, widx].permute(0, 2, 1).reshape(n_sys, 1, n, 1, n_surf),
        m.reshape(n_sys, 1, 1, 1, n_surf), aggregate=("cos2", "cos2_prime"))
    cos2 = torch.cat((res.stacks["cos2"], res.stacks["cos2_prime"])).reshape(-1, n_sys, n)
    return (cos2 >= (1.0 - 3e-7) ** 2).any(dim=0).numpy()


def _pallas_vjp(name, allow_backward, mask, bounds):
    """The outputs and vjp of the Pallas K2 (interpret mode) in the widest
    mode of the population."""
    if name == "cooke":
        fwd = functools.partial(jpb.trace_fused_batch_full, allow_backward=allow_backward,
                                path_bounds=bounds, angle_thr=THR, n_per_w=N_PER_W)
    else:
        static = tuple(tuple(int(v) for v in row) for row in mask)
        fwd = functools.partial(jpb.trace_fused_batch, penalties=True,
                                allow_backward=allow_backward, mask=static, n_per_w=N_PER_W)

    def run(args, cot):
        outs, vjp = jax.vjp(lambda *a: fwd(*a), *args)
        none = np.zeros(outs[4].shape, jax.dtypes.float0)
        return outs, vjp(tuple(list(cot[:4]) + [none, none] + list(cot[4:])))
    return run


@pytest.fixture(scope="module")
def jax_side():
    """Per population: the flat inputs (numpy), mask, bounds, seeded
    cotangents, the JAX front-end's outputs, and per backward-ray policy the
    Pallas kernel's and the jnp engine's outputs and vjps in the widest mode
    of the population."""
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    jcfg = jsim.SimulatorConfig(**CONFIG).trace_config()
    rng = np.random.default_rng(0)
    out = {}
    for name in MODES:
        specs, lens = _population(name)
        xp, yp, cyb, z0, mu, shape = fused_batch.prepare_fused_inputs_batch(specs, lens, cfg)
        assert shape[1] * shape[2] == N_PER_W
        arrays = [a.detach().numpy() for a in (xp, yp, cyb, z0, lens.c, lens.t, mu)]
        mask = None if bool(np.all(lens.structure.mask)) else lens.structure.mask
        wide = "full" if name == "cooke" else True
        if wide == "full":
            vertex_z = np.cumsum(arrays[5], axis=1, dtype=np.float32)
            arrays.append(np.concatenate((vertex_z, vertex_z[:, -1:]), axis=1))
        bounds = fused_trace._path_bounds(lens.structure, LOWER, UPPER)
        cot = [rng.standard_normal(arrays[0].shape).astype(np.float32)
               for _ in range(N_COT[wide])]
        edge = _at_clip_edge(arrays, mask)
        cot_jax = [np.where(edge, 0.0, a).astype(np.float32) if i in (4, 5) else a
                   for i, a in enumerate(cot)]
        out[name] = dict(specs=specs, lens=lens, inputs=arrays, mask=mask, bounds=bounds,
                         wide=wide, cot=cot, cot_jax=cot_jax, shape=shape,
                         jax_lens=_jax_population(specs, lens), pallas={}, jnp={})

    # Eager JAX compiles every primitive on first use and eager Pallas every
    # call: the front-end and the Pallas kernels are jitted and compile on
    # threads (XLA releases the GIL) while the jnp engine's vjps run eagerly
    # here (jitted, its unrolled vjp takes minutes to compile).
    lowered = {}
    for name, ref in out.items():
        jspecs, jlens = ref["jax_lens"]
        lowered[name, "front"] = jax.jit(lambda s, l: jpb.prepare_fused_inputs_batch(
            s, l, jcfg, w_order="outer")[:5]).lower(jspecs, jlens)
        for ab in (True, False):
            with pltpu.force_tpu_interpret_mode():
                lowered[name, ab] = jax.jit(_pallas_vjp(
                    name, ab, ref["mask"], ref["bounds"])).lower(ref["inputs"], ref["cot_jax"])
    as_np = lambda seq: [np.asarray(a) for a in seq]
    with ThreadPoolExecutor(4) as pool:
        compiled = {k: pool.submit(low.compile, compiler_options=FAST_COMPILE)
                    for k, low in lowered.items()}
        for name, ref in out.items():
            for ab in (True, False):
                outs, vjp, masks = jax.vjp(
                    functools.partial(_jnp_outputs, ref["mask"], ref["bounds"], ab),
                    *map(jnp.asarray, ref["inputs"]), has_aux=True)
                ref["jnp"][ab] = (as_np(outs), as_np(masks),
                                  as_np(vjp(list(map(jnp.asarray, ref["cot_jax"])))))
        compiled = {k: c.result() for k, c in compiled.items()}
    # One run at a time: the interpret mode's callbacks share state.
    for name, ref in out.items():
        ref["jfront"] = as_np(compiled[name, "front"](*ref["jax_lens"]))
        for ab in (True, False):
            outs, grads = compiled[name, ab](ref["inputs"], ref["cot_jax"])
            ref["pallas"][ab] = (as_np(outs), as_np(grads))
    return out


def _torch_inputs(ref, penalties, requires_grad=False):
    n = 8 if penalties == "full" else 7
    return [torch.tensor(a).requires_grad_(requires_grad) for a in ref["inputs"][:n]]


def _mask(ref):
    return None if ref["mask"] is None else torch.tensor(ref["mask"])


def _forward(ref, penalties, allow_backward, ins=None):
    ins = _torch_inputs(ref, penalties) if ins is None else ins
    return fused_batch.trace_fused_batch_reference(
        *ins[:7], penalties, allow_backward, N_PER_W, _mask(ref),
        ins[7] if penalties == "full" else None, ref["bounds"], THR)


def _assert_rel_close(got, want, label, slack=0.0):
    """|got - want| <= BAR x max|want| + slack, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(np.abs(want).max(), 1e-30)
    excess = np.abs(got - want) - slack
    assert excess.max() <= BAR * scale, (
        f"{label}: max deviation beyond the slack {excess.max() / scale:.3e} of the largest "
        f"magnitude (bar {BAR})")


@pytest.mark.parametrize("name,penalties,allow_backward", CASES)
def test_forward_reference_matches_jax(name, penalties, allow_backward, jax_side):
    ref = jax_side[name]
    got = [a.numpy() for a in _forward(ref, penalties, allow_backward)]
    pallas = ref["pallas"][allow_backward][0]
    jnp_floats, jnp_masks, _ = ref["jnp"][allow_backward]
    n_out = {False: 6, True: 9, "full": 11}[penalties]
    assert len(got) == n_out
    for i in (4, 5):
        np.testing.assert_array_equal(got[i], pallas[i])
        np.testing.assert_array_equal(got[i], jnp_masks[i - 4])
    both = got[4]
    floats = [i for i in range(n_out) if i not in (4, 5)]
    for j, i in enumerate(floats):
        want = jnp_floats[j]
        if i < 4:
            tol, sel = 5e-6 + 1e-6 * np.abs(want), both
        else:
            tol, sel = 1e-5 + 4e-6 * np.abs(want), np.ones_like(both)
        assert (np.abs(got[i] - want) <= tol)[sel].all(), f"output {i} vs the jnp engine"
        slack = np.abs(want.astype(np.float64) - pallas[i])
        assert (np.abs(got[i] - pallas[i]) <= tol + slack)[sel].all(), f"output {i} vs Pallas"
    if name == "cooke":
        assert 0 < got[4][1].mean() < 1 and got[4][0].all(), "only system 1 fails rays"
        if penalties == "full":
            assert got[9].mean() > 0 and got[10].mean() > 0, "both hinges must fire"


def _backward(ref, penalties, allow_backward, cot):
    return fused_batch.trace_fused_batch_backward_reference(
        _torch_inputs(ref, penalties), cot, penalties, allow_backward, N_PER_W, _mask(ref),
        ref["bounds"], THR)


@pytest.mark.parametrize("name,penalties,allow_backward", CASES)
def test_backward_reference_matches_jax_vjp(name, penalties, allow_backward, jax_side):
    """The widest mode against the Pallas kernel's vjp (plus the
    jnp-vs-Pallas distance); a narrower mode equals the widest mode with the
    extra penalty cotangents set to zero, bit for bit, as the Pallas adjoint
    adds them as exact zeros."""
    ref = jax_side[name]
    cot = [torch.tensor(a) for a in ref["cot_jax"]]
    n = N_COT[penalties]
    got = _backward(ref, penalties, allow_backward, cot[:n])
    assert len(got) == (8 if penalties == "full" else 7)
    if penalties != ref["wide"]:
        widest = _backward(ref, ref["wide"], allow_backward,
                           cot[:n] + [torch.zeros_like(cot[0])] * (len(cot) - n))
        assert all(torch.equal(a, b) for a, b in zip(got, widest))
        return
    want, jnp_want = ref["pallas"][allow_backward][1], ref["jnp"][allow_backward][2]
    for g, w, j, label in zip(got, want, jnp_want, LABELS):
        _assert_rel_close(g.numpy(), w, label, slack=np.abs(j.astype(np.float64) - w))


@pytest.mark.parametrize("name,penalties,allow_backward", CASES)
def test_backward_reference_matches_autograd(name, penalties, allow_backward, jax_side):
    ref = jax_side[name]
    ins = _torch_inputs(ref, penalties, requires_grad=True)
    cot = [torch.tensor(a) for a in ref["cot"][:N_COT[penalties]]]
    outs = _forward(ref, penalties, allow_backward, ins)
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    want = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    got = fused_batch.trace_fused_batch_backward_reference(
        [a.detach() for a in ins], cot, penalties, allow_backward, N_PER_W, _mask(ref),
        ref["bounds"], THR)
    for g, w, label in zip(got, want, LABELS):
        _assert_rel_close(g.numpy(), w.numpy(), label)


@pytest.mark.parametrize("penalties", [False, True, "full"])
@pytest.mark.parametrize("allow_backward", [True, False])
def test_population_of_one_is_k1(penalties, allow_backward, jax_side):
    """K2's plain version at B = 1 without a mask equals K1's (built on the
    jnp-style engine ``trace_skew``) bit for bit, on the system that fails
    rays."""
    ref = jax_side["cooke"]
    ins = [a[1:2] for a in _torch_inputs(ref, penalties)]
    got = fused_batch.trace_fused_batch_reference(
        *ins[:7], penalties, allow_backward, N_PER_W, None,
        ins[7] if penalties == "full" else None, ref["bounds"], THR)
    one = [a.reshape(()) if i == 3 else a[0] for i, a in enumerate(ins)]
    want = fused_trace.trace_fused_reference(
        *one[:7], penalties, allow_backward, N_PER_W, one[7] if penalties == "full" else None,
        ref["bounds"], THR)
    assert len(got) == len(want)
    assert all(torch.equal(a[0], b) for a, b in zip(got, want))
    assert 0 < float(want[4].float().mean()) < 1


def test_systems_are_independent(jax_side):
    """Perturbing one system's parameters leaves every other system's
    outputs and cotangents bit-identical."""
    ref = jax_side["cooke"]
    ins = _torch_inputs(ref, "full")
    moved = [a.clone() for a in ins]
    moved[4][0] = moved[4][0] * 1.01
    moved[5][0] = moved[5][0] + 0.05
    cot = [torch.tensor(a) for a in ref["cot"]]

    def run(args):
        grads = fused_batch.trace_fused_batch_backward_reference(
            args, cot, "full", False, N_PER_W, None, ref["bounds"], THR)
        return _forward(ref, "full", False, args) + grads
    base, new = run(ins), run(moved)
    assert not torch.equal(base[0][0], new[0][0])
    for a, b in zip(base, new):
        assert torch.equal(a[1:], b[1:])


def test_padded_system_matches_its_own_length(jax_side):
    """In the padded population the Cooke triplet (7 of 11 surfaces) traces
    as it does alone: masks identical, coordinates and penalty sums within
    the forward bars (the padded surfaces march the ray to the image plane
    with other roundings), and its real surfaces' cotangents within the
    gradient bar."""
    ref = jax_side["mixed"]
    ins = _torch_inputs(ref, True)
    padded = _forward(ref, True, True, ins)
    alone = [a[:1, :7] if i in (4, 5, 6) else a[:1] for i, a in enumerate(ins)]
    own = fused_batch.trace_fused_batch_reference(*alone, True, True, N_PER_W)
    for i, (a, b) in enumerate(zip(padded, own)):
        if i in (4, 5):
            assert torch.equal(a[0], b[0])
        else:
            np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-6, atol=1e-5)
    cot = [torch.tensor(a) for a in ref["cot"][:7]]
    g_pad = fused_batch.trace_fused_batch_backward_reference(ins, cot, True, True, N_PER_W,
                                                             _mask(ref))
    g_own = fused_batch.trace_fused_batch_backward_reference(alone, [c[:1] for c in cot], True,
                                                             True, N_PER_W)
    for i, (a, b) in enumerate(zip(g_pad, g_own)):
        a = a[:1, :7] if i >= 4 else a[:1]
        _assert_rel_close(a.numpy(), b.numpy(), LABELS[i])


def test_function_runs_the_plain_versions_on_cpu(jax_side):
    """The autograd Function on CPU tensors: forward equal to the plain
    version, backward equal to the backward plain version, no launch."""
    ref = jax_side["cooke"]
    before = (fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES)
    ins = _torch_inputs(ref, "full", requires_grad=True)
    outs = fused_batch.trace_fused_batch_full(*ins, True, ref["bounds"], THR, N_PER_W)
    want = _forward(ref, "full", True)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert not outs[4].requires_grad and not outs[5].requires_grad
    cot = [torch.tensor(a) for a in ref["cot"]]
    floats = [o for i, o in enumerate(outs) if i not in (4, 5)]
    grads = torch.autograd.grad(sum(torch.sum(o * c) for o, c in zip(floats, cot)), ins)
    hand = fused_batch.trace_fused_batch_backward_reference(
        [a.detach() for a in ins], cot, "full", True, N_PER_W, None, ref["bounds"], THR)
    assert all(torch.equal(a, b) for a, b in zip(grads, hand))
    assert (fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES) == before
    mixed = jax_side["mixed"]
    m_ins = _torch_inputs(mixed, True)
    got = fused_batch.trace_fused_batch(*m_ins, True, True, N_PER_W, _mask(mixed))
    assert all(torch.equal(a, b) for a, b in zip(got, _forward(mixed, True, True)))
    with pytest.raises(ValueError, match="trace_fused_batch_full"):
        fused_batch.trace_fused_batch(*ins[:7], "full", True, N_PER_W)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_batch.trace_fused_batch(*[a.detach().to("meta") for a in ins[:7]], False, True,
                                      N_PER_W)


@pytest.mark.parametrize("name", list(MODES))
def test_front_end_matches_jax(name, jax_side):
    """The batched front-end against JAX's (W-outer branch): ray blocks,
    pupil positions and index ratios. The aimed pupil coordinates agree
    within 1e-5 of their scale (see test_torch_trace's ray-aiming test)."""
    ref = jax_side[name]
    jxp, jyp, jcy, jz0, jmu = ref["jfront"]
    xp, yp, cyb, z0 = ref["inputs"][:4]
    assert ref["shape"] == (len(ref["lens"]), 3, 16, 3)
    for a, b in ((xp, jxp), (yp, jyp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(cyb, jcy, rtol=1e-6)
    np.testing.assert_allclose(z0, jz0, rtol=1e-6)
    np.testing.assert_allclose(ref["inputs"][6], jmu, rtol=1e-6)
    assert (fused_batch._static_mask(ref["lens"].structure, "cpu") is None) == (name == "cooke")
