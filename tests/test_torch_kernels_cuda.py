"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: without a CUDA device every test skips (a CUDA kernel has
no CPU mode). The module imports neither JAX nor the JAX package, so it runs
on a machine with the card but without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

K1 forward is built without FMA contraction and must agree with its plain
version bit for bit on coordinates and masks; the Lu and full penalty sums
within 1e-5 (acosf rounding, measured <= 2e-6 on an H100), on each of its
routes (the 7- and 11-surface kernels and the runtime-S kernel at 64
surfaces) and on odd lanes (NaN, 1e30, -inf), NaN where the plain version's
is; theta_norm's division by pi / 2 in the kernel is the IEEE division on
every float32 in [2^-100, 4), and the surface step's roots sqrtf from
2^-100 to +inf (exhaustive checks). K1 backward must
agree with its plain version bit for bit on the per-ray cotangents, and its
parameter sums (double sums in another order than the plain version's
float64 sums, rounded to float32) within 1e-5 of their largest magnitude; two launches on the
same inputs agree bit for bit. K2, the population kernel pair, is held to
the same bars per system (parameter sums within 2e-6 of each system's
largest, penalty sums within 1e-6), and at B = 1 to K1 bit for bit. K3,
the conic/asphere kernel pair, to the same bars on the masks, coordinates,
penalty sums and per-ray cotangents, and its parameter sums within one
float32 rounding of the plain version's float64 sums. K4, the conic/asphere
population pair, to K3's bars per system, with and without the surface
mask, and at B = 1 to K3 bit for bit; K2 and K4 forward on each of their
routes and shapes (``chip_smoke.POP_ROUTE_CASES``: 7, 11 and 64 surfaces,
K4 at 1 to 3 asphere terms), every mode, policy and mask flag, odd lanes
included, bit for bit on masks, coordinates and the opl. The opl mode of
each (the wavefront path) to the same bars: forward outputs (opl included)
and per-ray cotangents bit for bit, parameter and dn_legs sums within one
float32 rounding, K2 and K4 at B = 1 equal to K1 and K3; the wavefront functions on
the card against the CPU; and K4's training path at a fixed bar. P2, the
SVOLA patch convolution, bit for bit with its plain version (the same tap
order, no FMA contraction); PSFs from ``P2_FFT_MIN_KW`` taps take its FFT route
(``csrc/svola_fft.cu``), bit for bit with the route's plain version and
within 1e-5 of the largest entry of the float64 torch.fft product; its
adjoint: d/dpsf (from ``P2_DPSF_FFT_MIN_KW`` taps the FFT route's
correlation, within 1e-4 of the float64 one) and d/dpatch bit for bit with
their routes' plain versions, the direct d/dpsf kernel alone at K = 1 to 22,
and a backward launches d/dpatch only when the patches need it;
S1, the PSF splat, forward and adjoint bit for bit with their plain
versions on ``chip_smoke.SPLAT_CASES`` (the default configuration's own
splat included, and half grids up to 513 x 257 above the former ceiling,
with the windows' edge, non-finite, off-grid and wide-window cases, and
both forward routes forced off their grids), one launch each a call,
``compute_psf`` on CUDA tensors launching S1 both ways and never a plain
version (at a 257 x 257 grid too), S1's tensor-core probe (mma.sync .f64
rounding as the fma chain in k order) and the windows' threshold probe
(every factor above q_max is 0);
P2's FFT route cut into sub-patches bit for bit with its plain version;
``resize_bilinear``'s matrix products against the CPU; P1's chains:
sqrt and div bit for bit with their plain versions, fma within one float32
ulp a step, relative (``fmaf`` rounds once, the plain ``a * k1 + k2``
twice); a small
render on the card against the CPU's; the analysis layer's tolerance runs
and sensitivity tables on K2 and K4 against the unroll engine on the card;
the sharded fused losses of two gloo ranks sharing the card against the
single-process K2 and K4 losses; each example at tiny flags, its printed
numbers on the fused engine against the unroll engine's (``chip_smoke.py``
phase 42's bars).
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from torchoptics_tpu_torch import LensOptimizer, simulator, zoo
from torchoptics_tpu_torch.ops import fused_trace

pytestmark = pytest.mark.cuda

# The card checks' cases and comparisons that chip_smoke.py runs too
# (K1_ROUTE_CASES, k1_route_inputs, k1_route_compare, POP_ROUTE_CASES,
# pop_route_inputs, pop_route_compare, DPSF_SHAPES, dpsf_direct_case); the
# module imports only the standard library and numpy.
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CONFIG = dict(n_sampled_fields=16, n_pupil_rings=96, pupil_sampling="circular",
              n_ray_aiming_iter=1)
PENALTY_MODES = [False, True, "full"]
# Tight bounds, so that the path and angle hinges fire.
LOWER, UPPER, THR = (0.5, 1.5, 12.0), (None, 3.0, 40.0), math.cos(math.radians(30.0)) ** 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("allow_backward", [True, False])
@pytest.mark.parametrize("penalties", [False, True, "full", "opl"])
@pytest.mark.parametrize("case", [c[0] for c in chip_smoke.K1_ROUTE_CASES])
def test_k1_forward_matches_plain_version(cuda, case, penalties, allow_backward):
    """K1 forward on each of its routes (``chip_smoke.K1_ROUTE_CASES``: the
    double-Gauss and its c x 3 on the 11-surface kernel, the Cooke on the
    7-surface kernel, 64 surfaces on the runtime-S kernel, the first 8 rays
    odd lanes: NaN, 1e30, -inf), every mode and policy, against its plain
    version (``chip_smoke.k1_route_compare``): masks, coordinates and the
    opl bit for bit, NaN where the plain version's is; theta_norm's sums
    within 1e-5 on every lane (the kernel takes the roots that the surface
    step took), relu(z) and the hinges within 1e-5 past the odd lanes; one
    launch; K2 at B = 1 equal to K1 bit for bit."""
    from torchoptics_tpu_torch.ops import _kernels, fused_batch
    _, name, c_scale, width = next(c for c in chip_smoke.K1_ROUTE_CASES if c[0] == case)
    inputs = chip_smoke.k1_route_inputs(torch, zoo, simulator, fused_trace, name, c_scale, width)
    n_surf = inputs[0][4].shape[0]
    assert _kernels.load().k1_fwd_specialized(n_surf) == (n_surf in (7, 11))
    r = chip_smoke.k1_route_compare(torch, fused_trace, fused_batch, inputs, penalties,
                                    allow_backward)
    assert r["launches"] == 1
    assert len(r["got"]) == {False: 6, True: 9, "full": 11, "opl": 7}[penalties]
    assert r["bits"] and r["pen_nan"] and r["pen"] <= 1e-5 and r["k2_same"]
    assert bool(torch.isnan(r["got"][0][:8]).any()) and 0 < float(r["got"][4].float().mean()) < 1


def test_k1_forward_refuses_bad_inputs(cuda):
    x = torch.zeros(8, device=cuda)
    c = torch.zeros(3, device=cuda)
    mu = torch.ones(3, 2, device=cuda)
    z0 = torch.zeros((), device=cuda)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32"):
            fused_trace.trace_fused(x.double(), x, x, z0, c, c, mu, False, True, 4)
        with pytest.raises(ValueError, match="contiguous"):
            fused_trace.trace_fused(torch.zeros(16, device=cuda)[::2], x, x, z0, c, c, mu,
                                    False, True, 4)
        with pytest.raises(ValueError, match="surfaces"):
            fused_trace.trace_fused(x, x, x, z0, torch.zeros(65, device=cuda),
                                    torch.zeros(65, device=cuda), torch.ones(65, 2, device=cuda),
                                    False, True, 4)
        with pytest.raises(ValueError, match="is on"):
            fused_trace.trace_fused(x, x, x, z0.cpu(), c, c, mu, False, True, 4)
    # A CUDA tensor that requires grad goes through K1 backward.
    c_grad = c.clone().requires_grad_(True)
    before = fused_trace.K1_BWD_LAUNCHES
    outs = fused_trace.trace_fused(x, x, x, z0, c_grad, c, mu, False, True, 4)
    (grad,) = torch.autograd.grad(outs[1].sum(), c_grad)
    torch.cuda.synchronize()
    assert fused_trace.K1_BWD_LAUNCHES == before + 1
    assert grad.shape == c.shape and bool(torch.isfinite(grad).all())


def test_fused_loss_on_gpu_matches_cpu(cuda):
    cfg = simulator.SimulatorConfig(**CONFIG, trace_engine="fused")
    specs, lens = zoo.build("double_gauss", device=cuda)
    with torch.no_grad():
        _, loss = simulator.do_ray_tracing(specs, lens, cfg)
        _, want = simulator.do_ray_tracing(specs.to("cpu"), lens.to("cpu"), cfg)
    for key, rtol in (("loss_unsup", 1e-5), ("penalty", 1e-5), ("rms", 2e-4)):
        assert abs(float(loss[key]) - float(want[key])) <= rtol * abs(float(want[key])), key


def _k1_inputs(device, c_scale, **width):
    cfg = simulator.SimulatorConfig(**dict(CONFIG, **width)).trace_config()
    specs, lens = zoo.build("double_gauss", device=device)
    lens = lens.replace(c=lens.c * c_scale)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_trace.prepare_fused_inputs(specs, lens, cfg)
    t = lens.t[0].detach()
    vertex_z = torch.cumsum(t, 0)
    ref_z = torch.cat((vertex_z, vertex_z[-1:]))
    bounds = fused_trace._path_bounds(lens.structure, LOWER, UPPER)
    return (xp, yp, cyb, z0, lens.c[0].detach(), t, mu, ref_z), F * P, bounds


@pytest.mark.parametrize("c_scale", [1.0, 3.0])
@pytest.mark.parametrize("allow_backward", [True, False])
def test_k1_forward_full_mode_matches_plain_version(cuda, c_scale, allow_backward):
    inputs, n_per_w, bounds = _k1_inputs(cuda, c_scale)
    before = fused_trace.K1_FWD_LAUNCHES
    got = fused_trace._launch_k1_fwd(inputs, "full", allow_backward, n_per_w, bounds, THR)
    want = fused_trace.trace_fused_reference(*inputs[:7], "full", allow_backward, n_per_w,
                                             inputs[7], bounds, THR)
    torch.cuda.synchronize()
    assert fused_trace.K1_FWD_LAUNCHES == before + 1
    assert len(got) == len(want) == 11
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a, b)
    for a, b in zip(got[6:], want[6:]):
        assert float((a - b).abs().max()) <= 1e-5
    assert float(got[9].mean()) > 0 and float(got[10].mean()) > 0


@pytest.mark.parametrize("c_scale", [1.0, 3.0])
@pytest.mark.parametrize("allow_backward", [True, False])
@pytest.mark.parametrize("penalties", PENALTY_MODES)
def test_k1_backward_matches_plain_version(cuda, c_scale, allow_backward, penalties):
    inputs, n_per_w, bounds = _k1_inputs(cuda, c_scale)
    if penalties != "full":
        inputs = inputs[:7]
    gen = torch.Generator(device=cuda).manual_seed(0)
    n_cot = {False: 4, True: 7, "full": 9}[penalties]
    cot = [torch.randn(inputs[0].shape[0], device=cuda, generator=gen) for _ in range(n_cot)]
    before = fused_trace.K1_BWD_LAUNCHES
    got = fused_trace._launch_k1_bwd(inputs, cot, penalties, allow_backward, n_per_w, bounds,
                                     THR)
    again = fused_trace._launch_k1_bwd(inputs, cot, penalties, allow_backward, n_per_w, bounds,
                                       THR)
    want = fused_trace.trace_fused_backward_reference(inputs, cot, penalties, allow_backward,
                                                      n_per_w, bounds, THR)
    torch.cuda.synchronize()
    assert fused_trace.K1_BWD_LAUNCHES == before + 2
    assert len(got) == len(want) == (8 if penalties == "full" else 7)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two launches differ"
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for a, b in zip(got[3:], want[3:]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("use_full_loss", [False, True])
def test_optimizer_step_on_gpu_matches_cpu(cuda, use_full_loss):
    """One LensOptimizer step at the entry width on the card and on the CPU:
    one K1 forward and one K1 backward launch, the same loss and the same
    parameters after the step."""
    after = {}
    for device in (cuda, torch.device("cpu")):
        cfg = simulator.SimulatorConfig(n_sampled_fields=5, n_pupil_rings=16,
                                        pupil_sampling="circular", trace_engine="fused")
        specs, lens = zoo.build("double_gauss", device=device)
        lens = lens.replace(nd=lens.nd + 2e-3)
        opt = LensOptimizer(specs=specs, config=cfg, learning_rate=1e-4,
                            use_full_loss=use_full_loss, efl_target=float(lens.efl[0]))
        state = opt.init(lens)
        fwd, bwd = fused_trace.K1_FWD_LAUNCHES, fused_trace.K1_BWD_LAUNCHES
        state, total, _ = opt.step(state)
        launches = (fused_trace.K1_FWD_LAUNCHES - fwd, fused_trace.K1_BWD_LAUNCHES - bwd)
        after[device.type] = (float(total), {k: v.detach().cpu() for k, v in state.params.items()},
                              launches)
    assert after["cuda"][2] == (1, 1) and after["cpu"][2] == (0, 0)
    assert abs(after["cuda"][0] - after["cpu"][0]) <= 1e-5 * abs(after["cpu"][0])
    for k, v in after["cpu"][1].items():
        assert float((after["cuda"][1][k] - v).abs().max()) <= 1e-6, k


# ---------------------------------------------------------------------------
# Kernel K2, the population trace.
# ---------------------------------------------------------------------------

GEN = dict(n_sampled_fields=8, n_pupil_rings=8, pupil_sampling="circular", n_ray_aiming_iter=1)


def _k2_inputs(device, name, n_sys=32):
    """A population's (B, N) kernel inputs at the generator width: perturbed
    Cooke triplets with c x 1.5 on every 8th (rays fail), or Cooke and
    double-Gauss lenses padded to 11 surfaces."""
    from torchoptics_tpu_torch.ops import fused_batch
    if name == "cooke":
        specs, lens = zoo.population("cooke", n_sys, device=device)
        scale = torch.ones(n_sys, 1, device=device)
        scale[::8] = 1.5
        lens = lens.replace(c=lens.c * scale)
    else:
        specs, lens = zoo.mixed_population(n_sys, device=device)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(
            specs, lens, simulator.SimulatorConfig(**GEN).trace_config())
    vertex_z = torch.cumsum(lens.t, 1)
    ref_z = torch.cat((vertex_z, vertex_z[:, -1:]), 1)
    bounds = fused_trace._path_bounds(lens.structure, LOWER, UPPER)
    inputs = (xp, yp, cyb, z0, lens.c, lens.t, mu, ref_z)
    return inputs, F * P, fused_batch._static_mask(lens.structure, device), bounds


K2_CASES = [("cooke", p, ab) for p in PENALTY_MODES for ab in (True, False)] + [
    ("mixed", p, ab) for p in (False, True) for ab in (True, False)]


@pytest.mark.parametrize("name,penalties,allow_backward", K2_CASES)
def test_k2_matches_plain_versions(cuda, name, penalties, allow_backward):
    """K2 forward: masks and coordinates bit-identical, penalty sums within
    1e-6 of their largest magnitude. K2 backward: per-ray cotangents
    bit-identical, each system's parameter cotangents within 2e-6 of its
    largest, two launches bit-identical."""
    from torchoptics_tpu_torch.ops import fused_batch
    inputs, n_per_w, mask, bounds = _k2_inputs(cuda, name)
    ins = inputs if penalties == "full" else inputs[:7]
    before = (fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES)
    got = fused_batch._launch_k2_fwd(ins, penalties, allow_backward, n_per_w, mask, bounds, THR)
    want = fused_batch.trace_fused_batch_reference(*ins[:7], penalties, allow_backward, n_per_w,
                                                   mask, inputs[7], bounds, THR)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cot = [torch.randn(inputs[0].shape, device=cuda, generator=gen)
           for _ in range({False: 4, True: 7, "full": 9}[penalties])]
    g1 = fused_batch._launch_k2_bwd(ins, cot, penalties, allow_backward, n_per_w, mask, bounds,
                                    THR)
    g2 = fused_batch._launch_k2_bwd(ins, cot, penalties, allow_backward, n_per_w, mask, bounds,
                                    THR)
    gw = fused_batch.trace_fused_batch_backward_reference(ins, cot, penalties, allow_backward,
                                                          n_per_w, mask, bounds, THR)
    torch.cuda.synchronize()
    assert (fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got[:6], want[:6]))
    for a, b in zip(got[6:], want[6:]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(g1, g2)), "two launches differ"
    assert all(torch.equal(a, b) for a, b in zip(g1[:3], gw[:3]))
    rows = lambda grads: torch.cat([g.reshape(g.shape[0], -1) for g in grads[3:]], 1)
    dev = (rows(g1) - rows(gw)).abs().max(1).values
    assert bool((dev <= 2e-6 * rows(gw).abs().max(1).values).all())
    if name == "cooke":
        assert 0 < float(got[4].float().mean()) < 1


@pytest.mark.parametrize("n_rings", [96, 16])
def test_k2_population_of_one_is_k1(cuda, n_rings):
    """K2 at B = 1 without a mask gives K1's outputs and, both policies, its
    backward's cotangents bit for bit: at 442,368 rays (1,728 blocks: the
    second pass sums the partials) and at 16 x 16^2 x 3 = 12,288 (48 blocks:
    the system's last block sums them, in the second pass's order). The
    double-Gauss's 11 surfaces take K2b's kernel of their own."""
    from torchoptics_tpu_torch.ops import _kernels, fused_batch
    assert _kernels.load().k2_bwd_specialized(11) == 1
    inputs, n_per_w, bounds = _k1_inputs(cuda, 3.0, n_pupil_rings=n_rings)
    one = [a.reshape(1) if i == 3 else a[None] for i, a in enumerate(inputs)]
    gen = torch.Generator(device=cuda).manual_seed(5)
    for penalties in PENALTY_MODES:
        ins = inputs if penalties == "full" else inputs[:7]
        ones = one if penalties == "full" else one[:7]
        k1 = fused_trace._launch_k1_fwd(ins, penalties, True, n_per_w, bounds, THR)
        k2 = fused_batch._launch_k2_fwd(ones, penalties, True, n_per_w, None, bounds, THR)
        assert all(torch.equal(a, b[0]) for a, b in zip(k1, k2))
        cot = [torch.randn(inputs[0].shape, device=cuda, generator=gen)
               for _ in range({False: 4, True: 7, "full": 9}[penalties])]
        for allow_backward in (True, False):
            g1 = fused_trace._launch_k1_bwd(ins, cot, penalties, allow_backward, n_per_w, bounds,
                                            THR)
            g2 = fused_batch._launch_k2_bwd(ones, [c[None] for c in cot], penalties,
                                            allow_backward, n_per_w, None, bounds, THR)
            assert all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(g1, g2)), (
                penalties, allow_backward)


def test_k1_exact_shortcuts_match_ieee(cuda):
    """theta_norm's division by pi / 2 in K1 and K2 forward (div_half_pi: a
    product and two FMAs) equals the IEEE division on every float32 in
    [2^-100, 4), where acosf's results on the clipped arguments lie; the
    surface step's roots (sqrt_from_eps: sqrtf's fast path without its
    range check) equal sqrtf on every float32 from 2^-100 to +inf, NaN on
    NaN."""
    from torchoptics_tpu_torch.ops import _kernels
    mismatches = torch.zeros(2, dtype=torch.int64, device=cuda)
    err = _kernels.load().k1_exact_checks(mismatches.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and mismatches.tolist() == [0, 0]


def test_population_paths_on_gpu_match_cpu(cuda):
    """``do_ray_tracing`` on a padded population (one K2 forward launch) and
    the grouped full loss (one K2 full launch per lens type, forward and
    backward) on the card match the CPU."""
    from torchoptics_tpu_torch.ops import fused_batch
    cfg = simulator.SimulatorConfig(**GEN, trace_engine="fused")
    out = {}
    for device in (cuda, torch.device("cpu")):
        specs, lens = zoo.mixed_population(8, device=device)
        before = (fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES)
        with torch.no_grad():
            _, loss = simulator.do_ray_tracing(specs, lens, cfg)
        c = lens.c.clone().requires_grad_(True)
        total, _ = simulator.compute_losses(specs, lens.replace(c=c), cfg)
        (grad,) = torch.autograd.grad(total, c)
        launches = (fused_batch.K2_FWD_LAUNCHES - before[0],
                    fused_batch.K2_BWD_LAUNCHES - before[1])
        out[device.type] = (loss, float(total), grad.cpu(), launches)
    assert out["cuda"][3] == (3, 2) and out["cpu"][3] == (0, 0)
    for key, rtol in (("loss_unsup", 1e-5), ("penalty", 1e-5), ("rms", 2e-4)):
        got, want = float(out["cuda"][0][key]), float(out["cpu"][0][key])
        assert abs(got - want) <= rtol * abs(want), key
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * abs(out["cpu"][1])
    mask = torch.as_tensor(zoo.mixed_population(8, device="cpu")[1].structure.mask)
    want = torch.where(mask, out["cpu"][2], 0.0)
    assert float((torch.where(mask, out["cuda"][2], 0.0) - want).abs().max()) <= (
        1e-4 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# Kernel K3, the conic/asphere trace of one system.
# ---------------------------------------------------------------------------

# 8 fields x 32^2 pupil x 3 wavelengths = 24,576 rays.
ASPH = dict(n_sampled_fields=8, n_pupil_rings=32, pupil_sampling="circular", n_ray_aiming_iter=1)
# One float32 rounding of a parameter cotangent, relative to the largest.
ONE_ROUNDING = 2.0 ** -23


def _k3_inputs(device, c_scale):
    """K3's inputs on the aspherized double-Gauss (c x 3 fails rays: the
    sag-domain guard and non-convergence fire)."""
    cfg = simulator.SimulatorConfig(**ASPH).trace_config()
    specs, lens = zoo.build("double_gauss_asph", device=device)
    lens = lens.replace(c=lens.c * c_scale)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_trace.prepare_fused_inputs(specs, lens, cfg)
    t = lens.t[0].detach()
    vertex_z = torch.cumsum(t, 0)
    ref_z = torch.cat((vertex_z, vertex_z[-1:]))
    bounds = fused_trace._path_bounds(lens.structure, LOWER, UPPER)
    return ((xp, yp, cyb, z0, lens.c[0].detach(), lens.kappa[0].detach(), t, mu,
             lens.asph[0].detach(), ref_z), F * P, bounds)


@pytest.mark.parametrize("c_scale", [1.0, 3.0])
@pytest.mark.parametrize("allow_backward", [True, False])
@pytest.mark.parametrize("penalties", PENALTY_MODES)
def test_k3_matches_plain_versions(cuda, c_scale, allow_backward, penalties):
    """K3 forward: masks and coordinates bit-identical, penalty sums within
    1e-6 of their largest magnitude. K3 backward: per-ray cotangents
    bit-identical, parameter cotangents within one float32 rounding of the
    plain version's float64 sums, relative to each one's largest magnitude;
    two launches bit-identical."""
    from torchoptics_tpu_torch.ops import fused_asphere
    inputs, n_per_w, bounds = _k3_inputs(cuda, c_scale)
    ins = inputs if penalties == "full" else inputs[:9]
    before = (fused_asphere.K3_FWD_LAUNCHES, fused_asphere.K3_BWD_LAUNCHES)
    got = fused_asphere._launch_k3_fwd(ins, penalties, allow_backward, n_per_w, 10, bounds, THR)
    want = fused_asphere.trace_fused_asphere_reference(*ins[:9], penalties, allow_backward,
                                                       n_per_w, 10, inputs[9], bounds, THR)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cot = [torch.randn(inputs[0].shape[0], device=cuda, generator=gen)
           for _ in range({False: 4, True: 7, "full": 9}[penalties])]
    g1 = fused_asphere._launch_k3_bwd(ins, cot, penalties, allow_backward, n_per_w, 10, bounds,
                                      THR)
    g2 = fused_asphere._launch_k3_bwd(ins, cot, penalties, allow_backward, n_per_w, 10, bounds,
                                      THR)
    gw = fused_asphere.trace_fused_asphere_backward_reference(
        ins, cot, penalties, allow_backward, n_per_w, 10, bounds, THR)
    torch.cuda.synchronize()
    assert (fused_asphere.K3_FWD_LAUNCHES, fused_asphere.K3_BWD_LAUNCHES) == (before[0] + 1,
                                                                              before[1] + 2)
    assert len(got) == len(want) == {False: 6, True: 9, "full": 11}[penalties]
    assert all(torch.equal(a, b) for a, b in zip(got[:6], want[:6]))
    for a, b in zip(got[6:], want[6:]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert len(g1) == len(gw) == (10 if penalties == "full" else 9)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2)), "two launches differ"
    assert all(torch.equal(a, b) for a, b in zip(g1[:3], gw[:3]))
    for a, b in zip(g1[3:], gw[3:]):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= ONE_ROUNDING * float(b.abs().max())
    if c_scale == 3.0:
        assert 0 < float(got[4].float().mean()) < 1


def test_k3_refuses_bad_inputs(cuda):
    from torchoptics_tpu_torch.ops import fused_asphere
    x = torch.zeros(8, device=cuda)
    c = torch.zeros(3, device=cuda)
    mu = torch.ones(3, 2, device=cuda)
    z0 = torch.zeros((), device=cuda)
    asph = torch.zeros(3, 2, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="asphere coefficients"):
            fused_asphere.trace_fused_asphere(x, x, x, z0, c, c, c, mu,
                                              torch.zeros(3, 9, device=cuda), False, True, 4)
        with pytest.raises(ValueError, match="kappa"):
            fused_asphere.trace_fused_asphere(x, x, x, z0, c, torch.zeros(2, device=cuda), c, mu,
                                              asph, False, True, 4)
        with pytest.raises(TypeError, match="float32"):
            fused_asphere.trace_fused_asphere(x, x, x, z0, c, c.double(), c, mu, asph, False,
                                              True, 4)


def test_k3_without_asphere_terms_matches_k1(cuda):
    """K3 with kappa = asph = 0 against K1 on the double-Gauss: masks
    identical, coordinates within JAX's own K3-vs-K1 bar (1e-5 + 1e-4
    relative)."""
    from torchoptics_tpu_torch.ops import fused_asphere
    inputs, n_per_w, bounds = _k1_inputs(cuda, 1.0)
    xp, yp, cyb, z0, c, t, mu = inputs[:7]
    k1 = fused_trace._launch_k1_fwd(inputs[:7], False, True, n_per_w, bounds, THR)
    k3 = fused_asphere._launch_k3_fwd((xp, yp, cyb, z0, c, torch.zeros_like(c), t, mu,
                                       torch.zeros(c.shape[0], 2, device=cuda)), False, True,
                                      n_per_w, 10, bounds, THR)
    torch.cuda.synchronize()
    assert torch.equal(k1[4], k3[4]) and torch.equal(k1[5], k3[5])
    ok = k1[4]
    for a, b in zip(k3[:4], k1[:4]):
        assert bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs())[ok].all())


def _k3_inputs_with_terms(device, n_asph, c_scale):
    """``_k3_inputs`` with ``n_asph`` asphere terms: the lens's r^4 term
    alone, or its r^4 and r^6 terms and seeded higher ones that move the sag
    by ~1e-3 mm at 20 mm from the axis; and the leg indices n_legs."""
    inputs, n_per_w, bounds = _k3_inputs(device, c_scale)
    asph = inputs[8]
    if n_asph < asph.shape[1]:
        asph = asph[:, :n_asph]
    else:
        rng = np.random.default_rng(n_asph)
        extra = [rng.choice((-1.0, 1.0), asph.shape[0]) * 1e-3 / 400.0 ** (j + 2)
                 for j in range(asph.shape[1], n_asph)]
        asph = torch.cat((asph, torch.tensor(np.stack(extra, 1), dtype=torch.float32,
                                             device=device)), 1) if extra else asph
    lens = zoo.build("double_gauss_asph", device=device)[1]
    n_legs = fused_trace.leg_indices(lens, simulator.SimulatorConfig(**ASPH).trace_config()
                                     .wavelengths)[0]
    return (*inputs[:8], asph.contiguous(), inputs[9]), n_per_w, bounds, n_legs


@pytest.mark.parametrize("allow_backward", [True, False])
@pytest.mark.parametrize("n_iter", [0, 1, 10])
@pytest.mark.parametrize("n_asph", list(range(1, 9)))
def test_k3_every_term_count_and_step_count(cuda, n_asph, n_iter, allow_backward):
    """K3, built once per asphere term count (1 to MAX_ASPH = 8) and leaving
    its Newton loop once the steps repeat, against its plain version, which
    runs every step: in plain, Lu, full and opl mode, with backward rays
    allowed and removed, forward masks, coordinates and opl and per-ray
    cotangents bit for bit, penalty sums within 1e-6 and parameter
    cotangents within one float32 rounding of their largest magnitude, two
    backward launches bit for bit; and K4 (built per term count as K3) at
    B = 1 equal to K3 bit for bit. Odd term counts run on the c x 3 lens,
    which fails rays."""
    from torchoptics_tpu_torch.ops import fused_asphere
    c_scale = 3.0 if n_asph % 2 else 1.0
    inputs, n_per_w, bounds, n_legs = _k3_inputs_with_terms(cuda, n_asph, c_scale)
    gen = torch.Generator(device=cuda).manual_seed(n_asph)
    for penalties in PENALTY_MODES + ["opl"]:
        ins = inputs[:9] + {"full": inputs[9:], "opl": (n_legs,)}.get(penalties, ())
        config = (penalties, allow_backward, n_per_w, n_iter)
        got = fused_asphere._launch_k3_fwd(ins, *config, bounds, THR)
        want = fused_asphere.trace_fused_asphere_reference(*ins[:9], *config, inputs[9], bounds,
                                                           THR, n_legs)
        cot = [torch.randn(inputs[0].shape[0], device=cuda, generator=gen)
               for _ in range({False: 4, True: 7, "full": 9, "opl": 5}[penalties])]
        g1 = fused_asphere._launch_k3_bwd(ins, cot, *config, bounds, THR)
        g2 = fused_asphere._launch_k3_bwd(ins, cot, *config, bounds, THR)
        gw = fused_asphere.trace_fused_asphere_backward_reference(ins, cot, *config, bounds, THR)
        one = [a.reshape(1) if i == 3 else a[None] for i, a in enumerate(ins)]
        k4 = fused_asphere._launch_k4_fwd(one, *config, None, bounds, THR)
        g4 = fused_asphere._launch_k4_bwd(one, [c[None] for c in cot], *config, None, bounds,
                                          THR)
        torch.cuda.synchronize()
        exact = 7 if penalties == "opl" else 6
        assert all(torch.equal(a, b) for a, b in zip(got[:exact], want[:exact])), penalties
        for a, b in zip(got[exact:], want[exact:]):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        assert all(torch.equal(a, b) for a, b in zip(g1, g2)), "two launches differ"
        assert all(torch.equal(a, b) for a, b in zip(g1[:3], gw[:3])), penalties
        for a, b in zip(g1[3:], gw[3:]):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert float((a - b).abs().max()) <= ONE_ROUNDING * float(b.abs().max())
        assert all(torch.equal(a, b[0]) for a, b in zip(got, k4))
        assert all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(g1, g4))


def test_asphere_paths_on_gpu_match_cpu(cuda):
    """``do_ray_tracing`` (one K3 forward launch), ``compute_losses`` with
    d/d(c, kappa, asph) (one K3 forward and one K3 backward launch) and one
    ``LensOptimizer`` step on the aspherized double-Gauss, on the card and on
    the CPU."""
    from torchoptics_tpu_torch.ops import fused_asphere
    cfg = simulator.SimulatorConfig(n_sampled_fields=5, n_pupil_rings=16,
                                    pupil_sampling="circular", trace_engine="fused")
    out = {}
    for device in (cuda, torch.device("cpu")):
        specs, lens = zoo.build("double_gauss_asph", device=device)
        before = (fused_asphere.K3_FWD_LAUNCHES, fused_asphere.K3_BWD_LAUNCHES,
                  fused_trace.K1_FWD_LAUNCHES)
        with torch.no_grad():
            _, loss = simulator.do_ray_tracing(specs, lens, cfg)
        params = [p.clone().requires_grad_(True) for p in (lens.c, lens.kappa, lens.asph)]
        total, _ = simulator.compute_losses(
            specs, lens.replace(c=params[0], kappa=params[1], asph=params[2]), cfg)
        grads = [g.cpu() for g in torch.autograd.grad(total, params)]
        launches = (fused_asphere.K3_FWD_LAUNCHES - before[0],
                    fused_asphere.K3_BWD_LAUNCHES - before[1],
                    fused_trace.K1_FWD_LAUNCHES - before[2])
        opt = LensOptimizer(specs=specs, config=cfg, learning_rate=1e-4,
                            efl_target=float(lens.efl[0]),
                            trainable=("c", "t", "g", "kappa", "asph"))
        state, step_total, _ = opt.step(opt.init(lens))
        out[device.type] = (loss, float(total.detach()), grads, launches, float(step_total),
                            {k: v.detach().cpu() for k, v in state.params.items()})
    assert out["cuda"][3] == (2, 1, 0) and out["cpu"][3] == (0, 0, 0)
    for key, rtol in (("loss_unsup", 1e-5), ("penalty", 1e-5), ("rms", 2e-4)):
        got, want = float(out["cuda"][0][key]), float(out["cpu"][0][key])
        assert abs(got - want) <= rtol * abs(want), key
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * abs(out["cpu"][1])
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert abs(out["cuda"][4] - out["cpu"][4]) <= 1e-5 * abs(out["cpu"][4])
    assert {"kappa", "asph"} <= set(out["cuda"][5])
    for k, v in out["cpu"][5].items():
        assert float((out["cuda"][5][k] - v).abs().max()) <= 1e-6, k


# ---------------------------------------------------------------------------
# Kernel K4, the conic/asphere trace of a population.
# ---------------------------------------------------------------------------


def _k4_inputs(device, name, n_sys=32):
    """K4's (B, N) inputs at the generator width: the aspheric Cooke
    population with c x 3 on every 8th system (the sag-domain guard and
    non-convergence fire there), or the padded mixed aspheric population
    (Cooke and double-Gauss, 11 surfaces, masked draws). The path bounds are
    the widest system's."""
    import numpy as np
    from torchoptics_tpu_torch.ops import fused_batch
    if name == "cooke":
        specs, lens = zoo.aspheric_population(n_sys, device=device)
        scale = torch.ones(n_sys, 1, device=device)
        scale[::8] = 3.0
        lens = lens.replace(c=lens.c * scale)
    else:
        specs, lens = zoo.aspheric_population(n_sys, ("cooke", "double_gauss"), mask_pad=True,
                                              device=device)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(
            specs, lens, simulator.SimulatorConfig(**GEN).trace_config())
    vertex_z = torch.cumsum(lens.t, 1)
    ref_z = torch.cat((vertex_z, vertex_z[:, -1:]), 1)
    widest = np.array([int(np.argmax(lens.structure.n_surfaces))])
    bounds = fused_trace._path_bounds(lens[widest].structure, LOWER, UPPER)
    inputs = (xp, yp, cyb, z0, lens.c, lens.kappa, lens.t, mu, lens.asph, ref_z)
    return inputs, F * P, fused_batch._static_mask(lens.structure, device), bounds


K4_CASES = [(name, p, ab) for name in ("cooke", "mixed") for p in PENALTY_MODES
            for ab in (True, False)]


@pytest.mark.parametrize("name,penalties,allow_backward", K4_CASES)
def test_k4_matches_plain_versions(cuda, name, penalties, allow_backward):
    """K4 forward: masks and coordinates bit-identical, penalty sums within
    1e-6 of their largest magnitude. K4 backward: per-ray cotangents
    bit-identical, each system's parameter cotangents within one float32
    rounding of the plain version's float64 sums (relative to that system's
    largest), two launches bit-identical."""
    from torchoptics_tpu_torch.ops import fused_asphere
    inputs, n_per_w, mask, bounds = _k4_inputs(cuda, name)
    assert (mask is None) == (name == "cooke")
    ins = inputs if penalties == "full" else inputs[:9]
    before = (fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES)
    got = fused_asphere._launch_k4_fwd(ins, penalties, allow_backward, n_per_w, 10, mask,
                                       bounds, THR)
    want = fused_asphere.trace_fused_asphere_batch_reference(
        *ins[:9], penalties, allow_backward, n_per_w, 10, mask, inputs[9], bounds, THR)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cot = [torch.randn(inputs[0].shape, device=cuda, generator=gen)
           for _ in range({False: 4, True: 7, "full": 9}[penalties])]
    args = (penalties, allow_backward, n_per_w, 10, mask, bounds, THR)
    g1 = fused_asphere._launch_k4_bwd(ins, cot, *args)
    g2 = fused_asphere._launch_k4_bwd(ins, cot, *args)
    gw = fused_asphere.trace_fused_asphere_batch_backward_reference(ins, cot, *args)
    torch.cuda.synchronize()
    assert (fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES) == (before[0] + 1,
                                                                              before[1] + 2)
    assert len(got) == len(want) == {False: 6, True: 9, "full": 11}[penalties]
    assert all(torch.equal(a, b) for a, b in zip(got[:6], want[:6]))
    for a, b in zip(got[6:], want[6:]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert len(g1) == len(gw) == (10 if penalties == "full" else 9)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2)), "two launches differ"
    assert all(torch.equal(a, b) for a, b in zip(g1[:3], gw[:3]))
    rows = lambda grads: torch.cat([g.reshape(g.shape[0], -1) for g in grads[3:]], 1)
    assert bool(torch.isfinite(rows(g1)).all())
    dev = (rows(g1) - rows(gw)).abs().max(1).values
    assert bool((dev <= ONE_ROUNDING * rows(gw).abs().max(1).values).all())
    if name == "cooke":
        assert 0 < float(got[4].float().mean()) < 1


def test_k4_population_of_one_is_k3(cuda):
    """K4 at B = 1 without a mask gives K3's outputs and cotangents bit for
    bit, every mode, on the aspherized double-Gauss and its c x 3 variant."""
    from torchoptics_tpu_torch.ops import fused_asphere
    for c_scale in (1.0, 3.0):
        inputs, n_per_w, bounds = _k3_inputs(cuda, c_scale)
        one = [a.reshape(1) if i == 3 else a[None] for i, a in enumerate(inputs)]
        gen = torch.Generator(device=cuda).manual_seed(1)
        for penalties in PENALTY_MODES:
            n = 10 if penalties == "full" else 9
            k3 = fused_asphere._launch_k3_fwd(inputs[:n], penalties, True, n_per_w, 10, bounds,
                                              THR)
            k4 = fused_asphere._launch_k4_fwd(one[:n], penalties, True, n_per_w, 10, None,
                                              bounds, THR)
            assert all(torch.equal(a, b[0]) for a, b in zip(k3, k4))
            cot = [torch.randn(inputs[0].shape, device=cuda, generator=gen)
                   for _ in range({False: 4, True: 7, "full": 9}[penalties])]
            g3 = fused_asphere._launch_k3_bwd(inputs[:n], cot, penalties, True, n_per_w, 10,
                                              bounds, THR)
            g4 = fused_asphere._launch_k4_bwd(one[:n], [c[None] for c in cot], penalties, True,
                                              n_per_w, 10, None, bounds, THR)
            assert all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(g3, g4))


def _population_route(kernel, case, penalties, allow_backward, masked):
    """K2 or K4 forward on one of ``chip_smoke.POP_ROUTE_CASES`` against its
    plain version (``chip_smoke.pop_route_compare``), after checking that
    K2 takes the route the case names (K4 has one kernel a term count)."""
    from torchoptics_tpu_torch.ops import _kernels, fused_asphere, fused_batch
    _, name, n_asph = next(c for c in chip_smoke.POP_ROUTE_CASES if c[0] == case)
    inputs = chip_smoke.pop_route_inputs(torch, zoo, simulator, fused_trace, fused_batch,
                                         kernel, name, n_asph)
    n_surf = inputs[0][4].shape[1]
    if kernel == "k2":
        assert _kernels.load().k2_fwd_specialized(n_surf) == (n_surf in (7, 11))
    mask = inputs[4][int(masked)][1]
    assert (mask is None) != masked
    r = chip_smoke.pop_route_compare(torch, (fused_trace, fused_batch, fused_asphere), kernel,
                                     inputs, mask, penalties, allow_backward)
    assert r["launches"] == 1
    assert len(r["got"]) == {False: 6, True: 9, "full": 11, "opl": 7}[penalties]
    assert r["bits"] and r["pen_nan"] and r["pen"] <= chip_smoke.POP_PEN_BAR[kernel]
    assert bool(torch.isnan(r["got"][0][0, :8]).any()) and 0 < float(r["got"][4].float().mean()) < 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("allow_backward", [True, False])
@pytest.mark.parametrize("penalties", [False, True, "full", "opl"])
@pytest.mark.parametrize("case", chip_smoke.POP_ROUTE_K2)
def test_k2_forward_routes_match_plain_version(cuda, case, penalties, allow_backward, masked):
    """K2 forward on each of its routes (the Cooke population on the
    7-surface kernel, the padded mixed one on the 11-surface kernel, 64
    surfaces on the runtime-S kernel; system 0's first 8 rays odd lanes:
    NaN, 1e30, -inf), every mode and policy, unmasked and masked, against
    its plain version: masks, coordinates and the opl bit for bit, NaN where
    the plain version's is; the penalty sums within 1e-6 of their largest;
    one launch."""
    _population_route("k2", case, penalties, allow_backward, masked)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("allow_backward", [True, False])
@pytest.mark.parametrize("penalties", [False, True, "full", "opl"])
@pytest.mark.parametrize("case", [c[0] for c in chip_smoke.POP_ROUTE_CASES])
def test_k4_forward_routes_match_plain_version(cuda, case, penalties, allow_backward, masked):
    """K4 forward on the aspheric Cooke population (7 surfaces), the padded
    mixed one (11) and a seeded 64-surface one, at 2 asphere terms, and at 3
    and 1 (odd lanes as K2's), every mode and policy, unmasked and masked,
    against its plain version: masks, coordinates and the opl bit for bit,
    NaN where the plain version's is; the penalty sums within 8 float32
    roundings of their largest; one launch."""
    _population_route("k4", case, penalties, allow_backward, masked)


def test_k4_refuses_bad_inputs(cuda):
    from torchoptics_tpu_torch.ops import fused_asphere
    x = torch.zeros(2, 8, device=cuda)
    c = torch.zeros(2, 3, device=cuda)
    mu = torch.ones(2, 3, 2, device=cuda)
    z0 = torch.zeros(2, device=cuda)
    asph = torch.zeros(2, 3, 2, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="asphere coefficients"):
            fused_asphere.trace_fused_asphere_batch(x, x, x, z0, c, c, c, mu,
                                                    torch.zeros(2, 3, 9, device=cuda), False,
                                                    True, 4)
        with pytest.raises(ValueError, match="kappa"):
            fused_asphere.trace_fused_asphere_batch(x, x, x, z0, c, c[:1], c, mu, asph, False,
                                                    True, 4)
        with pytest.raises(ValueError, match="mask"):
            fused_asphere.trace_fused_asphere_batch(x, x, x, z0, c, c, c, mu, asph, False, True,
                                                    4, mask=torch.ones(2, 4, dtype=torch.bool,
                                                                       device=cuda))


def _population_losses(specs, lens, cfg, names):
    """``do_ray_tracing`` under no_grad, then ``batched_unsupervised_loss``
    and ``compute_losses`` with their d/d(``names``), on the lens's device."""
    from torchoptics_tpu_torch.ops import fused_batch
    with torch.no_grad():
        res, loss = simulator.do_ray_tracing(specs, lens, cfg)
    params = [getattr(lens, k).clone().requires_grad_(True) for k in names]
    trained = lens.replace(**dict(zip(names, params)))
    lu, lu_dict = fused_batch.batched_unsupervised_loss(specs, trained, cfg)
    g_lu = [g.cpu() for g in torch.autograd.grad(lu, params)]
    total, _ = simulator.compute_losses(specs, trained, cfg)
    g_tot = [g.cpu() for g in torch.autograd.grad(total, params)]
    return dict(ok=res.ray_ok.cpu(), loss={k: float(v) for k, v in loss.items()},
                lu=float(lu.detach()), lu_dict={k: v.detach().cpu() for k, v in lu_dict.items()},
                g_lu=g_lu, total=float(total.detach()), g_tot=g_tot)


@pytest.mark.parametrize("name", ["cooke", "mixed"])
def test_aspheric_population_paths_on_gpu_match_cpu(cuda, name):
    """On 8 systems of an aspheric population (the Cooke one, or the padded
    mixed one): ``do_ray_tracing`` (one K4 forward launch),
    ``batched_unsupervised_loss`` with d/d(c, t, kappa, asph) (one K4
    forward and one K4 backward) and ``compute_losses`` (one K4 full launch
    per lens type, forward and backward), on the card and on the CPU. The
    upper glass path bound is 3.5: the Cooke's glass gap is 3.0, on the
    default bound's kink (see ``chip_smoke.TIGHT_OFF_KINK``).

    The card's front-end rounds otherwise than the CPU's, and on these
    randomly aspherized designs the losses' gradients sit near their float32
    floor: a ray at a failure threshold may flip (a double-Gauss of the
    mixed population has one, whose flip moves that system's rms by a large
    share), and one ulp of c moves the CPU's own gradients by up to ~1e-4 of
    a group's largest, more where a ray flips. So the per-ray masks may
    differ on at most 4 lanes; on each system whose masks agree the
    per-system Lu terms are within 1e-5 relative (rms 2e-4), and its rows
    of each gradient group within 1e-4 plus 4x the CPU's own move under one
    ulp of c, relative to the group's largest on real surfaces; where all
    masks agree, the loss values within 1e-5 relative (rms 2e-4)."""
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch
    cfg = simulator.SimulatorConfig(**GEN, trace_engine="fused",
                                    ray_path_upper_thresholds=(None, 3.5, None))
    names = ("c", "t", "kappa", "asph")
    out = {}
    for device in (cuda, torch.device("cpu")):
        if name == "cooke":
            specs, lens = zoo.aspheric_population(8, device=device)
        else:
            specs, lens = zoo.aspheric_population(8, ("cooke", "double_gauss"), mask_pad=True,
                                                  device=device)
        before = (fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES,
                  fused_batch.K2_FWD_LAUNCHES)
        out[device.type] = _population_losses(specs, lens, cfg, names)
        out[device.type]["launches"] = (fused_asphere.K4_FWD_LAUNCHES - before[0],
                                        fused_asphere.K4_BWD_LAUNCHES - before[1],
                                        fused_batch.K2_FWD_LAUNCHES - before[2])
    nudged = _population_losses(specs, lens.replace(c=lens.c * (1 + 2.0 ** -23)), cfg, names)
    card, host = out["cuda"], out["cpu"]
    n_types = 1 if name == "cooke" else 2
    assert card["launches"] == (2 + n_types, 1 + n_types, 0) and host["launches"] == (0, 0, 0)
    differ = card["ok"] != host["ok"]
    assert int(differ.sum()) <= 4, f"{int(differ.sum())} lanes differ"
    same = ~differ.reshape(differ.shape[0], -1).any(1)
    if name == "cooke":
        assert bool(same.all())
    for key, rtol in (("loss_unsup", 1e-5), ("penalty", 1e-5), ("rms", 2e-4)):
        got, want = card["lu_dict"][key][same], host["lu_dict"][key][same]
        assert bool(((got - want).abs() <= rtol * want.abs()).all()), key
        if bool(same.all()):
            assert abs(card["loss"][key] - host["loss"][key]) <= rtol * abs(host["loss"][key]), key
    if bool(same.all()):
        for key in ("lu", "total"):
            assert abs(card[key] - host[key]) <= 1e-5 * abs(host[key]), key
    real = torch.as_tensor(lens.structure.mask) & same[:, None]
    for grads in ("g_lu", "g_tot"):
        for k, a, b, n in zip(names, card[grads], host[grads], nudged[grads]):
            m = real[..., None] if k == "asph" else real
            scale = float(torch.where(m, b, 0.0).abs().max())
            gap = float(torch.where(m, a - b, 0.0).abs().max()) / scale
            floor = float(torch.where(m, n - b, 0.0).abs().max()) / scale
            assert gap <= 1e-4 + 4 * floor, (grads, k, gap, floor)


# ---------------------------------------------------------------------------
# The opl mode of K1-K4 (the wavefront path) and the wavefront functions.
# ---------------------------------------------------------------------------

OPL_CASES = [("k1", 1.0), ("k1", 3.0), ("k3", 1.0), ("k3", 3.0), ("k2", "cooke"),
             ("k2", "mixed"), ("k4", "cooke"), ("k4", "mixed")]


def _opl_inputs(device, kernel, variant):
    """One opl kernel's inputs, ending with n_legs: K1 on the double-Gauss
    and K3 on the aspherized double-Gauss (c x ``variant``, 8 fields x 32^2 x
    3), K2 and K4 on 32-system populations at the generator width (the
    Cooke with c x 3 on every 8th system, or the padded mixed one)."""
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch
    if kernel in ("k1", "k3"):
        cfg = simulator.SimulatorConfig(**ASPH).trace_config()
        specs, lens = zoo.build("double_gauss" if kernel == "k1" else "double_gauss_asph",
                                device=device)
        lens = lens.replace(c=lens.c * variant)
        with torch.no_grad():
            xp, yp, cyb, z0, mu, (_, F, P, _) = fused_trace.prepare_fused_inputs(specs, lens, cfg)
        n_legs = fused_trace.leg_indices(lens, cfg.wavelengths)[0]
        if kernel == "k1":
            ins = (xp, yp, cyb, z0, lens.c[0], lens.t[0], mu, n_legs)
        else:
            ins = (xp, yp, cyb, z0, lens.c[0], lens.kappa[0], lens.t[0], mu, lens.asph[0], n_legs)
        return [a.detach().contiguous() for a in ins], F * P, None
    cfg = simulator.SimulatorConfig(**GEN).trace_config()
    if kernel == "k2":
        specs, lens = (zoo.population("cooke", 32, device=device) if variant == "cooke"
                       else zoo.mixed_population(32, device=device))
    else:
        specs, lens = (zoo.aspheric_population(32, device=device) if variant == "cooke" else
                       zoo.aspheric_population(32, ("cooke", "double_gauss"), mask_pad=True,
                                               device=device))
    if variant == "cooke":
        scale = torch.ones(32, 1, device=device)
        scale[::8] = 3.0
        lens = lens.replace(c=lens.c * scale)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(specs, lens, cfg)
    n_legs = fused_trace.leg_indices(lens, cfg.wavelengths)
    if kernel == "k2":
        ins = (xp, yp, cyb, z0, lens.c, lens.t, mu, n_legs)
    else:
        ins = (xp, yp, cyb, z0, lens.c, lens.kappa, lens.t, mu, lens.asph, n_legs)
    return ([a.detach().contiguous() for a in ins], F * P,
            fused_batch._static_mask(lens.structure, device))


def _opl_run(kernel, ins, n_per_w, mask, allow_backward, plain, cot=None):
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch
    if kernel == "k1":
        if cot is None:
            return (fused_trace.trace_fused_reference(*ins[:7], "opl", allow_backward, n_per_w,
                                                      n_legs=ins[7]) if plain else
                    fused_trace._launch_k1_fwd(ins, "opl", allow_backward, n_per_w, (), THR))
        return (fused_trace.trace_fused_backward_reference(ins, cot, "opl", allow_backward,
                                                           n_per_w) if plain else
                fused_trace._launch_k1_bwd(ins, cot, "opl", allow_backward, n_per_w, (), THR))
    if kernel == "k2":
        if cot is None:
            return (fused_batch.trace_fused_batch_reference(
                *ins[:7], "opl", allow_backward, n_per_w, mask, n_legs=ins[7]) if plain else
                fused_batch._launch_k2_fwd(ins, "opl", allow_backward, n_per_w, mask, (), THR))
        return (fused_batch.trace_fused_batch_backward_reference(
            ins, cot, "opl", allow_backward, n_per_w, mask) if plain else
            fused_batch._launch_k2_bwd(ins, cot, "opl", allow_backward, n_per_w, mask, (), THR))
    if kernel == "k3":
        if cot is None:
            return (fused_asphere.trace_fused_asphere_reference(
                *ins[:9], "opl", allow_backward, n_per_w, 10, n_legs=ins[9]) if plain else
                fused_asphere._launch_k3_fwd(ins, "opl", allow_backward, n_per_w, 10, (), THR))
        return (fused_asphere.trace_fused_asphere_backward_reference(
            ins, cot, "opl", allow_backward, n_per_w, 10) if plain else
            fused_asphere._launch_k3_bwd(ins, cot, "opl", allow_backward, n_per_w, 10, (), THR))
    args = ("opl", allow_backward, n_per_w, 10, mask, (), THR)
    if cot is None:
        return (fused_asphere.trace_fused_asphere_batch_reference(
            *ins[:9], "opl", allow_backward, n_per_w, 10, mask, n_legs=ins[9]) if plain else
            fused_asphere._launch_k4_fwd(ins, *args))
    return (fused_asphere.trace_fused_asphere_batch_backward_reference(ins, cot, *args) if plain
            else fused_asphere._launch_k4_bwd(ins, cot, *args))


@pytest.mark.parametrize("kernel,variant", OPL_CASES)
@pytest.mark.parametrize("allow_backward", [True, False])
def test_opl_kernels_match_plain_versions(cuda, kernel, variant, allow_backward):
    """Each opl kernel against its plain version: forward outputs (masks,
    coordinates, opl) and per-ray cotangents bit for bit; the parameter and
    dn_legs sums within one float32 rounding of their row's largest (a
    system's, or for one system each group's); two backward launches bit
    for bit."""
    ins, n_per_w, mask = _opl_inputs(cuda, kernel, variant)
    assert (mask is None) == (variant != "mixed")
    with torch.no_grad():
        got = _opl_run(kernel, ins, n_per_w, mask, allow_backward, False)
        want = _opl_run(kernel, ins, n_per_w, mask, allow_backward, True)
    gen = torch.Generator(device=cuda).manual_seed(2)
    cot = [torch.randn(ins[0].shape, device=cuda, generator=gen) for _ in range(5)]
    g1 = _opl_run(kernel, ins, n_per_w, mask, allow_backward, False, cot)
    g2 = _opl_run(kernel, ins, n_per_w, mask, allow_backward, False, cot)
    gw = _opl_run(kernel, ins, n_per_w, mask, allow_backward, True, cot)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 7 and len(g1) == len(gw) == len(ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2)), "two launches differ"
    assert all(torch.equal(a, b) for a, b in zip(g1[:3], gw[:3]))
    if kernel in ("k2", "k4"):
        rows = lambda grads: [torch.cat([g.reshape(g.shape[0], -1) for g in grads[3:]], 1)]
    else:
        rows = lambda grads: [g.reshape(1, -1) for g in grads[3:]]
    for a, b in zip(rows(g1), rows(gw)):
        assert bool(torch.isfinite(a).all())
        assert bool(((a - b).abs().max(1).values <= ONE_ROUNDING * b.abs().max(1).values).all())
    if variant in (3.0, "cooke"):
        assert 0 < float(got[4].float().mean()) < 1


@pytest.mark.parametrize("single,one", [("k1", "k2"), ("k3", "k4")])
def test_opl_population_of_one(cuda, single, one):
    """K2's opl mode at B = 1 gives K1's outputs and cotangents bit for bit,
    K4's K3's."""
    ins, n_per_w, _ = _opl_inputs(cuda, single, 1.0)
    batch = [a.reshape(1) if i == 3 else a[None] for i, a in enumerate(ins)]
    gen = torch.Generator(device=cuda).manual_seed(3)
    cot = [torch.randn(ins[0].shape, device=cuda, generator=gen) for _ in range(5)]
    with torch.no_grad():
        a = _opl_run(single, ins, n_per_w, None, True, False)
        b = _opl_run(one, batch, n_per_w, None, True, False)
    ga = _opl_run(single, ins, n_per_w, None, True, False, cot)
    gb = _opl_run(one, batch, n_per_w, None, True, False, [c[None] for c in cot])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))
    assert all(torch.equal(x.reshape(-1), y.reshape(-1)) for x, y in zip(ga, gb))


@pytest.mark.parametrize("name", ["double_gauss", "double_gauss_asph"])
def test_wavefront_on_gpu_matches_cpu(cuda, name):
    """``opd_map`` (two opl forward launches: the bundle and the chief ray)
    and the fwd+bwd of ``wavefront_rms`` (two more, and two backward) on the
    card against the CPU: masks equal, OPD within 5e-5 mm, the objective
    within rtol 1e-2 and its gradient within rtol 0.05 and 0.02 of the
    largest (JAX's bar between its Pallas and XLA paths)."""
    from torchoptics_tpu_torch import analysis, trace
    from torchoptics_tpu_torch.ops import fused_asphere
    from torchoptics_tpu_torch.ops import wavefront as wf
    cfg = trace.TraceConfig(mode="circular", n_rays=(16, 16), rel_fields=(0.0, 0.7, 1.0),
                            wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1,
                            engine="fused")
    module, key = (fused_trace, "K1") if name == "double_gauss" else (fused_asphere, "K3")
    out = {}
    for device in (cuda, torch.device("cpu")):
        specs, lens = zoo.build(name, device=device)
        before = (getattr(module, f"{key}_FWD_LAUNCHES"), getattr(module, f"{key}_BWD_LAUNCHES"))
        with torch.no_grad():
            opd = wf.opd_map(specs, lens, cfg)
        c = lens.c.detach().clone().requires_grad_(True)
        rms = analysis.wavefront_rms(specs, lens.replace(c=c), cfg)
        (grad,) = torch.autograd.grad(rms, (c,))
        launches = (getattr(module, f"{key}_FWD_LAUNCHES") - before[0],
                    getattr(module, f"{key}_BWD_LAUNCHES") - before[1])
        out[device.type] = (opd, float(rms.detach()), grad.cpu(), launches)
    card, host = out["cuda"], out["cpu"]
    assert card[3] == (4, 2) and host[3] == (0, 0)
    assert torch.equal(card[0]["ok"].cpu(), host[0]["ok"])
    ok = host[0]["ok"]
    assert float((card[0]["opd"].cpu() - host[0]["opd"]).abs()[ok].max()) <= 5e-5
    assert abs(card[1] - host[1]) <= 1e-2 * host[1]
    scale = float(host[2].abs().max())
    assert bool(((card[2] - host[2]).abs() <= 0.05 * host[2].abs() + 0.02 * scale).all())


def test_diffraction_psf_window_on_gpu_matches_cpu(cuda):
    """The matrix-DFT window at the imaging defaults' sizes (64^2 pupil, 65 x
    65 pixels, oversample 4) equals the CPU's within 1e-5 of each PSF's peak:
    TF32 is off (it would round the DFT's inputs to 10-bit mantissas)."""
    from torchoptics_tpu_torch.ops import wavefront as wf
    assert torch.backends.cuda.matmul.allow_tf32 is False
    n = 64
    gen = torch.Generator().manual_seed(4)
    g = (torch.arange(n) + 0.5) / n * 2.0 - 1.0
    Y, X = torch.meshgrid(g, g, indexing="ij")
    ok = (X ** 2 + Y ** 2) <= 1.0
    opd = (0.5e-3 * (0.4 * (2 * (X ** 2 + Y ** 2) - 1) + 0.2 * Y)
           + 1e-5 * torch.randn(n, n, generator=gen))[None].repeat(3, 1, 1)
    lam = torch.tensor([0.459e-3, 0.52e-3, 0.64e-3])
    args = dict(pitch_mm=4e-3, shape=(65, 65), oversample=4)
    host = wf.diffraction_psf_window(opd, ok[None].repeat(3, 1, 1), lam, 60.0, 12.0,
                                     x_offset=torch.tensor([0.0, 1e-3, -2e-3]), **args)
    card = wf.diffraction_psf_window(opd.to(cuda), ok[None].repeat(3, 1, 1).to(cuda),
                                     lam.to(cuda), 60.0, 12.0,
                                     x_offset=torch.tensor([0.0, 1e-3, -2e-3], device=cuda),
                                     **args)
    peak = host["psf"].amax(dim=(-2, -1), keepdim=True)
    assert float(((card["psf"].cpu() - host["psf"]) / peak).abs().max()) <= 1e-5
    assert float((card["accounted"].cpu() - host["accounted"]).abs().max()) <= 1e-5


def test_k4_training_path_at_a_fixed_bar(cuda):
    """K4's training path at a bar that does not scale with the data: 8
    systems of the aspherized double-Gauss population (2 % curvature
    draws), defocused by 0.05 mm, the gradients of the spot term of
    ``batched_unsupervised_loss`` (through K4's Lu mode, forward and
    backward) on the card within a fixed 1e-4 of each group's largest of
    the CPU's. (The whole Lu's theta_norm sums amplify one ulp of cos² near
    normal incidence: its float32 floor here is ~1e-3, see ROADMAP.)"""
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch
    cfg = simulator.SimulatorConfig(**GEN, trace_engine="fused")
    names = ("c", "t", "kappa", "asph")
    grads = {}
    for device in (cuda, torch.device("cpu")):
        specs, lens = zoo.population("double_gauss_asph", 8, device=device)
        last = torch.zeros_like(lens.t)
        last[:, -1] = 0.05
        lens = lens.replace(t=lens.t + last)
        params = [getattr(lens, k).detach().clone().requires_grad_(True) for k in names]
        before = (fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES)
        _, terms = fused_batch.batched_unsupervised_loss(
            specs, lens.replace(**dict(zip(names, params))), cfg)
        grads[device.type] = [g.cpu() for g in torch.autograd.grad(terms["rms"].mean(), params)]
        launched = (fused_asphere.K4_FWD_LAUNCHES - before[0],
                    fused_asphere.K4_BWD_LAUNCHES - before[1])
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
    for k, a, b in zip(names, grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), k


# ---------------------------------------------------------------------------
# The backward kernels at ragged shapes.
# ---------------------------------------------------------------------------

# 5 fields x 13^2 = 845 rays a wavelength, 2,535 a system: warps and blocks
# of 256 straddle two wavelengths and the last block is partly inactive.
# 1 x 9^2 = 81 a wavelength, 243 a system: one partial block holds all
# three wavelengths.
RAGGED = {"845": dict(n_sampled_fields=5, n_pupil_rings=13),
          "81": dict(n_sampled_fields=1, n_pupil_rings=9)}
# K2 also on seeded populations of S surfaces ("s7", "s11", "s12"; "m" for a
# surface mask with the last two surfaces of every other system padded): the
# counts with a K2b kernel of their own (7, 11), masked and unmasked, and one
# past the largest (12, the runtime-S kernel).
RAGGED_CASES = ([(k, v, "845") for k, vs in (("k1", (1.0, 3.0)), ("k3", (1.0, 3.0)),
                                             ("k2", ("cooke", "c3", "mixed")),
                                             ("k4", ("cooke", "c3", "mixed"))) for v in vs]
                + [(k, v, "81") for k, v in (("k1", 1.0), ("k3", 1.0), ("k2", "cooke"),
                                             ("k4", "cooke"))]
                + [("k2", f"s{n}{m}", "845") for n in (7, 11, 12) for m in ("", "m")])
# Each kernel's bar on its parameter sums, as in the tests above.
RAGGED_BAR = {"k1": 1e-5, "k2": 2e-6, "k3": ONE_ROUNDING, "k4": ONE_ROUNDING}


def _short_inputs(device, variant, n_per_w):
    """A seeded 8-system population of S surfaces ('s<S>', 'm' at the end
    for a surface mask), 3 wavelengths of ``n_per_w`` rays: weak glass and
    air surfaces as in ``_largest_inputs``, system 0 with 30x the
    curvatures (rays fail there); masked, every other system's last two
    surfaces padded (c = t = 0, mu = 1, mask False). Returns what
    ``_ragged_inputs`` does."""
    masked = variant.endswith("m")
    n_surf, n_sys, n_w = int(variant[1:].rstrip("m")), 8, 3
    rng = np.random.default_rng(n_surf + 100 * masked)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    n = n_w * n_per_w
    xp, yp = (rng.uniform(-1.0, 1.0, (n_sys, n)) for _ in range(2))
    cy = rng.uniform(-0.05, 0.05, (n_sys, n))
    c = rng.normal(0.0, 0.02, (n_sys, n_surf))
    c[0] *= 30.0
    t = np.full((n_sys, n_surf), 0.5)
    index = 1.5 + 0.01 * np.arange(n_w) / n_w
    legs = np.where(np.arange(n_surf + 1)[:, None] % 2 == 1, index, 1.0)
    legs = np.broadcast_to(legs, (n_sys, n_surf + 1, n_w)).copy()
    mask = np.ones((n_sys, n_surf), bool)
    if masked:
        mask[1::2, -2:] = False
        c[1::2, -2:] = 0.0
        t[1::2, -2:] = 0.0
        legs[1::2, -2:] = legs[1::2, -3:-2]      # the padded legs stay in the last medium
    mu = legs[:, :-1] / legs[:, 1:]
    vertex_z = np.cumsum(t, -1)
    ref_z = np.concatenate((vertex_z, vertex_z[:, -1:]), -1)
    base = tuple(f32(a).contiguous() for a in (xp, yp, cy, np.full(n_sys, -1.0), c, t, mu))
    bounds = ((0.1, 5.0),) * n_surf
    return (base, f32(ref_z), f32(legs), n_per_w,
            torch.tensor(mask, device=device) if masked else None, bounds)


def _ragged_inputs(device, kernel, variant, width):
    """(base inputs, ref_z, n_legs, n_per_w, mask, bounds) at a ragged width:
    K1 on the double-Gauss and K3 on its aspherized form (c x ``variant``),
    K2 and K4 on 32-system Cooke and aspheric Cooke populations ('c3': c x 3
    on every 8th system) or on the padded mixed ones, K2 also on the seeded
    populations of ``_short_inputs``."""
    import numpy as np
    from torchoptics_tpu_torch.ops import fused_batch
    if isinstance(variant, str) and variant.startswith("s"):
        return _short_inputs(device, variant, 845)
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    **RAGGED[width]).trace_config()
    single, asph = kernel in ("k1", "k3"), kernel in ("k3", "k4")
    if single:
        specs, lens = zoo.build("double_gauss_asph" if asph else "double_gauss", device=device)
        lens = lens.replace(c=lens.c * variant)
    elif variant == "mixed":
        specs, lens = (zoo.aspheric_population(32, ("cooke", "double_gauss"), mask_pad=True,
                                               device=device) if asph
                       else zoo.mixed_population(32, device=device))
    else:
        specs, lens = (zoo.aspheric_population(32, device=device) if asph
                       else zoo.population("cooke", 32, device=device))
        if variant == "c3":
            scale = torch.ones(32, 1, device=device)
            scale[::8] = 3.0
            lens = lens.replace(c=lens.c * scale)
    prepare = fused_trace.prepare_fused_inputs if single else fused_batch.prepare_fused_inputs_batch
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = prepare(specs, lens, cfg)
    row = (lambda a: a[0]) if single else (lambda a: a)
    base = (xp, yp, cyb, z0, row(lens.c), row(lens.t), mu)
    if asph:
        base = base[:5] + (row(lens.kappa),) + base[5:] + (row(lens.asph),)
    vertex_z = torch.cumsum(lens.t, 1)
    ref_z = row(torch.cat((vertex_z, vertex_z[:, -1:]), 1))
    n_legs = row(fused_trace.leg_indices(lens, cfg.wavelengths))
    widest = np.array([int(np.argmax(lens.structure.n_surfaces))])
    bounds = fused_trace._path_bounds(lens[widest].structure, LOWER, UPPER)
    mask = None if single else fused_batch._static_mask(lens.structure, device)
    base = tuple(a.detach().contiguous() for a in base)
    return base, ref_z.detach(), n_legs.detach(), F * P, mask, bounds


def _ragged_bwd(kernel, base, ref_z, n_legs, cot, penalties, allow_backward, n_per_w, mask,
                bounds, plain):
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch
    if penalties == "opl":
        return _opl_run(kernel, base + (n_legs,), n_per_w, mask, allow_backward, plain, cot)
    ins = base + (ref_z,) if penalties == "full" else base
    if kernel == "k1":
        return (fused_trace.trace_fused_backward_reference(
            ins, cot, penalties, allow_backward, n_per_w, bounds, THR) if plain else
            fused_trace._launch_k1_bwd(ins, cot, penalties, allow_backward, n_per_w, bounds,
                                       THR))
    if kernel == "k3":
        return (fused_asphere.trace_fused_asphere_backward_reference(
            ins, cot, penalties, allow_backward, n_per_w, 10, bounds, THR) if plain else
            fused_asphere._launch_k3_bwd(ins, cot, penalties, allow_backward, n_per_w, 10,
                                         bounds, THR))
    if kernel == "k2":
        return (fused_batch.trace_fused_batch_backward_reference(
            ins, cot, penalties, allow_backward, n_per_w, mask, bounds, THR) if plain else
            fused_batch._launch_k2_bwd(ins, cot, penalties, allow_backward, n_per_w, mask,
                                       bounds, THR))
    args = (penalties, allow_backward, n_per_w, 10, mask, bounds, THR)
    return (fused_asphere.trace_fused_asphere_batch_backward_reference(ins, cot, *args)
            if plain else fused_asphere._launch_k4_bwd(ins, cot, *args))


@pytest.mark.parametrize("penalties", [False, True, "full", "opl"])
@pytest.mark.parametrize("kernel,variant,width", RAGGED_CASES)
def test_backward_kernels_at_ragged_shapes(cuda, kernel, variant, width, penalties):
    """K1b to K4b where no warp or block boundary falls on a wavelength's
    and the last block is partly inactive, both policies: per-ray
    cotangents bit-identical to the plain version's, two launches
    bit-identical, each row's parameter sums (a system's, or for one
    system each parameter group's) within the kernel's bar of the plain
    version's float64 sums (opl: one float32 rounding)."""
    base, ref_z, n_legs, n_per_w, mask, bounds = _ragged_inputs(cuda, kernel, variant, width)
    n = base[0].shape[-1]
    assert n_per_w % 32 != 0 and n % 256 != 0
    population = kernel in ("k2", "k4")
    if kernel == "k2":
        from torchoptics_tpu_torch.ops import _kernels
        n_surf = base[4].shape[-1]
        assert _kernels.load().k2_bwd_specialized(n_surf) == (n_surf in (7, 11))
    bar = ONE_ROUNDING if penalties == "opl" else RAGGED_BAR[kernel]
    gen = torch.Generator(device=cuda).manual_seed(9)
    n_cot = {False: 4, True: 7, "full": 9, "opl": 5}[penalties]
    cot = [torch.randn(base[0].shape, device=cuda, generator=gen) for _ in range(n_cot)]
    for allow_backward in (True, False):
        run = lambda plain: _ragged_bwd(kernel, base, ref_z, n_legs, cot, penalties,
                                        allow_backward, n_per_w, mask, bounds, plain)
        g1, g2, gw = run(False), run(False), run(True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(g1, g2)), "two launches differ"
        assert all(torch.equal(a, b) for a, b in zip(g1[:3], gw[:3])), allow_backward
        if population:
            rows = lambda grads: [torch.cat([g.reshape(g.shape[0], -1) for g in grads[3:]], 1)]
        else:
            rows = lambda grads: [g.reshape(1, -1) for g in grads[3:]]
        for a, b in zip(rows(g1), rows(gw)):
            assert bool(torch.isfinite(a).all())
            dev = (a - b).abs().max(1).values
            assert bool((dev <= bar * b.abs().max(1).values).all()), allow_backward


def _largest_inputs(device, kernel):
    """Inputs at the largest shape the kernels take: 64 surfaces (MAX_SURF),
    32 wavelengths (MAX_W), 8 asphere terms (MAX_ASPH), 10 rays a
    wavelength (2 systems for K2 and K4), on a weak seeded lens (glass and
    air alternating), ending with ref_z and n_legs."""
    rng = np.random.default_rng(64)
    n_surf, n_w, n_per_w = 64, 32, 10
    n_sys = 2 if kernel in ("k2", "k4") else None
    lead = (n_sys,) if n_sys else ()
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    n = n_w * n_per_w
    xp, yp = (f32(rng.uniform(-1.0, 1.0, lead + (n,))) for _ in range(2))
    cy = f32(rng.uniform(-0.05, 0.05, lead + (n,)))
    z0 = f32(np.full(lead or (), -1.0))
    c = f32(rng.normal(0.0, 0.01, lead + (n_surf,)))
    t = f32(np.full(lead + (n_surf,), 0.5))
    index = 1.5 + 0.01 * np.arange(n_w) / n_w                 # glass, per wavelength
    legs = np.where(np.arange(n_surf + 1)[:, None] % 2 == 1, index, 1.0)  # air first
    mu = f32(np.broadcast_to(legs[:-1] / legs[1:], lead + (n_surf, n_w)))
    n_legs = f32(np.broadcast_to(legs, lead + (n_surf + 1, n_w)))
    vertex_z = torch.cumsum(t, -1)
    ref_z = torch.cat((vertex_z, vertex_z[..., -1:]), -1)
    if kernel in ("k1", "k2"):
        base = (xp, yp, cy, z0, c, t, mu)
    else:
        kappa = f32(rng.normal(0.0, 0.1, lead + (n_surf,)))
        asph = f32(rng.normal(0.0, 1e-7, lead + (n_surf, 8)))
        base = (xp, yp, cy, z0, c, kappa, t, mu, asph)
    return tuple(a.contiguous() for a in base), ref_z.contiguous(), n_legs.contiguous(), n_per_w


@pytest.mark.parametrize("penalties", ["full", "opl"])
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
def test_backward_kernels_at_the_largest_shape(cuda, kernel, penalties):
    """Each backward kernel launches at 64 surfaces and 32 wavelengths (and
    8 asphere terms) in the modes with the most parameters, both policies,
    and equals its plain version: per-ray cotangents bit for bit, parameter
    sums within one float32 rounding of each row's largest (a system's, or
    for one system each group's)."""
    base, ref_z, n_legs, n_per_w = _largest_inputs(cuda, kernel)
    population = kernel in ("k2", "k4")
    bounds = ((0.1, 5.0),) * 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    cot = [torch.randn(base[0].shape, device=cuda, generator=gen)
           for _ in range(9 if penalties == "full" else 5)]
    for allow_backward in (True, False):
        run = lambda plain: _ragged_bwd(kernel, base, ref_z, n_legs, cot, penalties,
                                        allow_backward, n_per_w, None, bounds, plain)
        g1, gw = run(False), run(True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(g1[:3], gw[:3])), allow_backward
        if population:
            rows = lambda grads: [torch.cat([g.reshape(g.shape[0], -1) for g in grads[3:]], 1)]
        else:
            rows = lambda grads: [g.reshape(1, -1) for g in grads[3:]]
        for a, b in zip(rows(g1), rows(gw)):
            assert bool(torch.isfinite(a).all())
            dev = (a - b).abs().max(1).values
            assert bool((dev <= ONE_ROUNDING * b.abs().max(1).values).all()), allow_backward


# ---------------------------------------------------------------------------
# The imaging path: kernel P2 and the issue-rate probe P1.
# ---------------------------------------------------------------------------

# (patches, patch height, width, channels, kh, kw): the 1024^2 and 256^2
# renders' shapes, a non-square patch with K = 23 (a 2048^2 render's PSF)
# and a non-square kernel on a batch of 2 x 4 patches; then ragged shapes
# (outputs no multiple of the 32 x 32 tile): K = 1 and 31, one and three
# channels and five (a group of four and one of one), kh != kw, a kw on each
# side of each kw with a kernel of its own (3, 5, 11, 23), the others on the
# runtime-kw kernel.
P2_SHAPES = [(25, 316, 316, 3, 11, 11), (25, 77, 77, 3, 3, 3), (6, 100, 72, 3, 23, 23),
             (8, 40, 52, 3, 5, 7),
             (3, 45, 50, 1, 1, 1), (2, 70, 75, 3, 31, 31), (2, 66, 63, 1, 31, 29),
             (4, 50, 61, 3, 7, 11), (3, 41, 39, 5, 3, 3), (2, 60, 57, 3, 5, 2),
             (2, 41, 70, 1, 3, 4), (2, 52, 49, 3, 5, 5), (2, 44, 47, 3, 7, 6),
             (3, 66, 45, 3, 9, 10), (2, 47, 80, 3, 13, 12),
             (2, 90, 77, 3, 21, 22), (2, 85, 90, 1, 25, 24), (2, 57, 58, 3, 23, 23),
             (2, 33, 34, 3, 1, 3),
             # Wide PSFs (the FFT route): the default config's K at 1448^2,
             # 2048^2 and 4096^2, kh != kw with one side of 33 or more, a
             # PSF as large as its patch, five channels.
             (3, 110, 104, 3, 33, 33), (2, 150, 141, 3, 47, 47), (2, 190, 200, 3, 95, 95),
             (2, 120, 90, 3, 47, 33), (2, 80, 140, 1, 21, 95), (1, 60, 71, 3, 60, 71),
             (2, 99, 97, 5, 41, 39)]


def _fft_share(torch, got, patches, second, kernel_hw, adjoint):
    """The deviation of the FFT route's result from the float64 torch.fft
    product (or, with ``adjoint``, correlation with the cotangent
    ``second``), a share of the largest entry."""
    P, ph, pw, C = patches.shape
    kh, kw = kernel_hw
    a = torch.fft.rfftn(patches.double(), s=(ph, pw), dim=(1, 2))
    b = torch.fft.rfftn(second.double(), s=(ph, pw), dim=(1, 2))
    if adjoint:
        ref = torch.fft.irfftn(a * b.conj(), s=(ph, pw), dim=(1, 2))
        ref = torch.flip(ref[:, :kh, :kw], dims=(1, 2))
    else:
        ref = torch.fft.irfftn(a * b, s=(ph, pw), dim=(1, 2))[:, kh - 1:, kw - 1:]
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", P2_SHAPES)
def test_p2_matches_plain_version(cuda, shape):
    from torchoptics_tpu_torch.ops import _kernels, image
    P, ph, pw, C, kh, kw = shape
    assert _kernels.load().p2_specialized_kw(kw) == (kw in (3, 5, 11, 23))
    assert image.p2_argument_error((P, ph, pw, C), (P, kh, kw, C)) is None
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    patches = torch.rand((P, ph, pw, C), generator=g, device=cuda) * 255.0
    psfs = torch.rand((P, kh, kw, C), generator=g, device=cuda)
    psfs = psfs / psfs.sum(dim=(1, 2), keepdim=True)
    before = (image.P2_LAUNCHES, image.P2_FFT_LAUNCHES)
    with torch.no_grad():
        got = image.svola_patch_conv(patches, psfs)
    torch.cuda.synchronize()
    # One direct launch below P2_FFT_MIN_KW taps; the FFT route's three from
    # there.
    fft = max(kh, kw) >= image.P2_FFT_MIN_KW
    assert image.p2_takes_fft((kh, kw)) == fft
    assert (image.P2_LAUNCHES - before[0], image.P2_FFT_LAUNCHES - before[1]) == (
        (0, 3) if fft else (1, 0))
    if fft:
        assert torch.equal(got, image.svola_patch_conv_fft_reference(patches, psfs))
        assert _fft_share(torch, got, patches, psfs, (kh, kw), False) <= 1e-5
    else:
        assert torch.equal(got, image.svola_patch_conv_reference(patches, psfs))
    # The direct kernel on every PSF it takes, the route's or not.
    if max(kh, kw) <= image.p2_max_kw():
        with torch.no_grad():
            direct = image._launch_p2(patches, psfs)
        assert torch.equal(direct, image.svola_patch_conv_reference(patches, psfs))


# The FFT route at the default configuration's transform lengths (Lh x Lw):
# 288 (1448^2, K = 33), 400 (2048^2, K = 47) and 800 (4096^2, K = 95), each
# with a kernel of its own, and a generic length beside (270 -> 270).
FAST_LENGTH_SHAPES = [(3, 272, 270, 3, 33, 33), (2, 385, 390, 3, 47, 47),
                      (1, 775, 790, 3, 95, 95), (2, 270, 283, 1, 35, 41)]


@pytest.mark.parametrize("shape", FAST_LENGTH_SHAPES)
def test_fft_route_at_fast_lengths(cuda, shape):
    """Forward, d/dpsf and d/dpatch on the FFT route at the fast lengths
    (``image.fft_len``), bit for bit with the plain versions and within the
    bars of the float64 torch.fft product and correlation."""
    from torchoptics_tpu_torch.ops import image
    P, ph, pw, C, kh, kw = shape
    assert image.p2_takes_fft((kh, kw)) and image.p2_takes_fft((kh, kw), adjoint=True)
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    patches = torch.rand((P, ph, pw, C), generator=g, device=cuda) * 255.0
    psfs = torch.rand((P, kh, kw, C), generator=g, device=cuda)
    psfs = psfs / psfs.sum(dim=(1, 2), keepdim=True)
    cot = torch.randn((P, ph - kh + 1, pw - kw + 1, C), generator=g, device=cuda)
    p_var, k_var = patches.clone().requires_grad_(True), psfs.clone().requires_grad_(True)
    out = image.svola_patch_conv(p_var, k_var)
    d_patch, d_psf = torch.autograd.grad(out, (p_var, k_var), cot)
    torch.cuda.synchronize()
    with torch.no_grad():
        assert torch.equal(out.detach(), image.svola_patch_conv_fft_reference(patches, psfs))
        assert torch.equal(d_psf, image.svola_patch_conv_dpsf_fft_reference(patches, cot,
                                                                          (kh, kw)))
        assert torch.equal(d_patch, image.svola_patch_conv_dpatch_reference(cot, psfs))
    assert _fft_share(torch, out.detach(), patches, psfs, (kh, kw), False) <= 1e-5
    assert _fft_share(torch, d_psf, patches, cot, (kh, kw), True) <= 1e-4


def test_fft_lengths_match_the_launchers(cuda):
    """The launchers' transform length (``p2_fft_len``) is ``image.fft_len``
    for every side the route takes, and their scratch is sized from it."""
    from torchoptics_tpu_torch.ops import _kernels, image
    lib = _kernels.load()
    assert [lib.p2_fft_len(n) for n in range(1, image.P2_FFT_MAX_LEN + 1)] == [
        image.fft_len(n) for n in range(1, image.P2_FFT_MAX_LEN + 1)]
    for P, ph, pw, C, kh, _ in FAST_LENGTH_SHAPES:
        nc = image.fft_len(pw) // 2 + 1
        assert lib.p2_fft_scratch(P, C, ph, pw, kh, 0) == 2 * P * C * (ph + kh) * nc
        assert lib.p2_fft_scratch(P, C, ph, pw, kh, 1) == 2 * P * C * (2 * ph - kh + 1) * nc


def test_p2_refuses_grad_and_bad_inputs(cuda):
    """Under grad P2 runs (its adjoint is in ``csrc/svola_conv_bwd.cu`` and
    ``csrc/svola_fft.cu``); what the kernels cannot take still raises, and
    the library's limits are those ``image`` computes without it: the
    direct kernels reach at least one tap below the FFT route's
    thresholds."""
    from torchoptics_tpu_torch.ops import _kernels, image
    lib = _kernels.load()
    assert lib.p2_max_kw() == image.p2_max_kw() >= image.P2_FFT_MIN_KW - 1
    assert lib.p2_dpsf_max_kw() == image.p2_max_kw(adjoint=True) >= image.P2_DPSF_FFT_MIN_KW - 1
    assert lib.p2_fft_max_len() == image.P2_FFT_MAX_LEN and lib.p2_fft_launches() == 3
    patches = torch.rand((4, 40, 40, 3), device=cuda)
    psfs = torch.rand((4, 5, 5, 3), device=cuda, requires_grad=True)
    out = image.svola_patch_conv(patches, psfs)
    assert out.requires_grad
    # One launch of the FFT route takes patches up to its longest transform;
    # a longer patch is cut into sub-patches (``image.fft_tiles``) first.
    with pytest.raises(ValueError, match="pixels a side"):
        image._launch_fft(torch.rand((1, 40, image.P2_FFT_MAX_LEN + 1, 1), device=cuda),
                          torch.rand((1, 3, image.P2_FFT_MIN_KW, 1), device=cuda),
                          (3, image.P2_FFT_MIN_KW), False)
    long_patch = torch.rand((1, 40, image.P2_FFT_MAX_LEN + 1, 1), device=cuda)
    wide = torch.rand((1, 3, image.P2_FFT_MIN_KW, 1), device=cuda)
    assert len(image.fft_tiles(image.P2_FFT_MAX_LEN + 1, image.P2_FFT_MIN_KW)) == 2
    assert torch.equal(image.svola_patch_conv(long_patch, wide),
                       image.svola_patch_conv_fft_reference(long_patch, wide))
    with pytest.raises(ValueError, match="no larger than the patch"):
        image.svola_patch_conv(torch.rand((1, 40, 40, 3), device=cuda),
                               torch.rand((1, 41, 5, 3), device=cuda))
    # The direct kernels refuse PSFs wider than they take.
    with pytest.raises(RuntimeError, match="launch failed"):
        image._launch_p2(torch.rand((1, 60, 60, 3), device=cuda),
                         torch.rand((1, 3, image.p2_max_kw() + 1, 3), device=cuda))
    with pytest.raises(RuntimeError, match="launch failed"):
        k = image.p2_max_kw(adjoint=True) + 1
        image._launch_p2_dpsf(torch.rand((1, 60, 60, 3), device=cuda),
                              torch.rand((1, 60 - k + 1, 58, 3), device=cuda), (k, 3))


# (P, patch height, width, channels, kh, kw) of P2's adjoint: config 5's
# 1024^2 render (K = 11) and the default config's 2048^2 (K = 47); then
# ragged outputs, kh != kw, one and five channels, a PSF of 95 taps, a
# patch that is one tile; K = 23 (the FFT route's thresholds) and the wide
# cases of the FFT route (K = 33, 47 x 33, 21 x 95, a
# PSF as large as its patch).
P2_ADJOINT_SHAPES = [(25, 316, 316, 3, 11, 11), (81, 385, 385, 3, 47, 47),
                     (3, 70, 75, 3, 5, 9), (2, 45, 50, 1, 9, 3), (2, 130, 129, 3, 95, 95),
                     (2, 99, 97, 5, 41, 39), (1, 34, 34, 3, 3, 3), (2, 100, 90, 3, 23, 23),
                     (3, 110, 104, 3, 33, 33), (2, 120, 90, 3, 47, 33), (2, 80, 140, 1, 21, 95),
                     (1, 60, 71, 3, 60, 71)]


@pytest.mark.parametrize("shape", P2_ADJOINT_SHAPES)
def test_p2_adjoint_matches_plain_versions(cuda, shape):
    """d/dpsf and d/dpatch (P2 on the padded cotangent) through
    ``svola_patch_conv``'s backward, each by its route, bit for bit with the
    routes' plain versions on the card, the FFT route's d/dpsf within 1e-4
    of the float64 correlation; d/dpsf alone when only the PSFs need a
    gradient."""
    from torchoptics_tpu_torch.ops import _kernels, image
    lib = _kernels.load()
    P, ph, pw, C, kh, kw = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    patches = (torch.rand((P, ph, pw, C), generator=g, device=cuda) * 255.0).requires_grad_()
    psfs = torch.rand((P, kh, kw, C), generator=g, device=cuda)
    psfs = (psfs / psfs.sum(dim=(1, 2), keepdim=True)).requires_grad_()
    cot = torch.randn((P, ph - kh + 1, pw - kw + 1, C), generator=g, device=cuda)
    out = image.svola_patch_conv(patches, psfs)
    names = ("P2_LAUNCHES", "P2_FFT_LAUNCHES", "P2_DPSF_LAUNCHES", "P2_DPSF_FFT_LAUNCHES")
    before = [getattr(image, n) for n in names]
    d_patch, d_psf = torch.autograd.grad(out, (patches, psfs), cot)
    torch.cuda.synchronize()
    # d/dpatch is one P2 call by P2's route; the direct d/dpsf launches its
    # kernel once a group of patch-channels, the groups' partials within
    # 64 MB; the FFT route three kernels a call.
    fft, fft_d = max(kh, kw) >= image.P2_FFT_MIN_KW, max(kh, kw) >= image.P2_DPSF_FFT_MIN_KW
    assert (image.p2_takes_fft((kh, kw)), image.p2_takes_fft((kh, kw), True)) == (fft, fft_d)
    assert [getattr(image, n) - b for n, b in zip(names, before)] == [
        0 if fft else 1, 3 if fft else 0,
        0 if fft_d else lib.p2_dpsf_launches(P, C, ph, pw, kh, kw), 3 if fft_d else 0]
    with torch.no_grad():
        if fft_d:
            want_psf = image.svola_patch_conv_dpsf_fft_reference(patches, cot, (kh, kw))
            assert _fft_share(torch, d_psf, patches, cot, (kh, kw), True) <= 1e-4
        else:
            tiles = -(-(ph - kh + 1) // 32) * -(-(pw - kw + 1) // 32)
            assert lib.p2_dpsf_partials(P, C, ph, pw, kh, kw) <= max(1 << 23, tiles * kh * kw)
            want_psf = image.svola_patch_conv_dpsf_reference(patches, cot, (kh, kw))
        want_patch = image.svola_patch_conv_dpatch_reference(cot, psfs)
    assert torch.equal(d_psf, want_psf) and bool(torch.isfinite(d_psf).all())
    assert torch.equal(d_patch, want_patch)
    out = image.svola_patch_conv(patches.detach(), psfs)
    p2 = (image.P2_LAUNCHES, image.P2_FFT_LAUNCHES)
    assert torch.equal(torch.autograd.grad(out, psfs, cot)[0], want_psf)
    assert (image.P2_LAUNCHES, image.P2_FFT_LAUNCHES) == p2


@pytest.mark.parametrize("shape", chip_smoke.DPSF_SHAPES)
def test_p2_dpsf_direct_matches_plain_version(cuda, shape):
    """The direct d/dpsf kernel (register-blocked: a tap row and a chunk of
    tap columns a thread, several tiles a block) bit for bit with its plain
    version on ``chip_smoke.DPSF_SHAPES`` (K = 1 to 22, non-square PSFs,
    ragged tail tiles); its launches one a group of patch-channels."""
    from torchoptics_tpu_torch.ops import _kernels, image
    lib = _kernels.load()
    P, ph, pw, C, kh, kw = shape
    assert lib.p2_dpsf_specialized_kw(kw) == (kw in (3, 5, 11))
    got, want, launches = chip_smoke.dpsf_direct_case(torch, image, shape)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert launches == lib.p2_dpsf_launches(P, C, ph, pw, kh, kw)


@pytest.mark.parametrize("op", ["fma", "sqrt", "div"])
def test_p1_chains_match_plain_version(cuda, op):
    from torchoptics_tpu_torch.benchmarks import issue_peak
    g = torch.Generator(device=cuda).manual_seed(3)
    x = 0.9 + 0.2 * torch.rand(issue_peak.probe_threads(), generator=g, device=cuda)
    got = issue_peak.chains(x, op, 64)
    want = issue_peak.chains_reference(x, op, 64)
    # The plain fma step is fmaf rounded once; the twice-rounded a * k1 + k2
    # chain differs on a few percent of the lanes, so an unfused kernel fails.
    assert torch.equal(got, want)
    if op == "fma":
        unfused = issue_peak.chains_reference(x, op, 64, fused=False)
        assert float((got != unfused).float().mean()) > 0.01


def test_imaging_render_on_gpu_matches_cpu(cuda):
    """A 64^2 render of the sample photograph (double-Gauss, 5 fields, 8
    rings, 9 x 9 PSFs, 3 x 3 patches): one K1 forward and one P2 launch on
    the card; irradiance within 0.05 grey levels of the CPU's, PSNR within
    2e-3 dB, SSIM within 1e-5 (the trace's and the splat's float32 rounding
    differ between the CPU and the card)."""
    from torchoptics_tpu_torch import imaging
    from torchoptics_tpu_torch.ops import image
    from torchoptics_tpu_torch.utils import images
    cfg = simulator.SimulatorConfig(n_sampled_fields=5, n_pupil_rings=8, pupil_sampling="circular",
                                    psf_shape=(9, 9), psf_abs_pixel_size=8e-3,
                                    psf_grid_shape=(3, 3), trace_engine="fused")
    radiance = images.load_test_image((64, 64))[None]
    out = {}
    for device in ("cpu", cuda):
        specs, lens = zoo.build("double_gauss", device=device)
        k1, p2 = fused_trace.K1_FWD_LAUNCHES, image.P2_LAUNCHES
        with torch.no_grad():
            out[str(device)] = [v.cpu() for v in imaging.simulate(
                specs, lens, torch.tensor(radiance, device=device), cfg)]
        launched = (fused_trace.K1_FWD_LAUNCHES - k1, image.P2_LAUNCHES - p2)
        assert launched == ((0, 0) if device == "cpu" else (1, 1))
    (irr_c, p_c, s_c), (irr_g, p_g, s_g) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(irr_g, irr_c, rtol=0, atol=0.05)
    torch.testing.assert_close(p_g, p_c, rtol=0, atol=2e-3)
    torch.testing.assert_close(s_g, s_c, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The analysis layer: tolerancing and the sensitivity table on K2 and K4.
# ---------------------------------------------------------------------------

# The JAX package's own analysis tests' width: 3 fields x a 4-ring circular
# pupil x 3 wavelengths, one ray-aiming iteration.
ANALYSIS = dict(n_sampled_fields=3, n_pupil_rings=4, pupil_sampling="circular",
                n_ray_aiming_iter=1, wavelengths=(459.0, 520.0, 640.0))


def _analysis_case(name, device):
    """(specs, lens, Tolerances, kernel counters' module and name)."""
    from torchoptics_tpu_torch import analysis
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch
    if name == "cooke":
        specs, lens = zoo.build("cooke", device=device)
        return specs, lens, analysis.Tolerances(c=2e-4, t=0.02, nd=1e-3, v=0.2), (fused_batch,
                                                                                    "K2")
    specs, lens = zoo.aspheric_population(1, device=device)
    tol = analysis.Tolerances(c=1e-4, t=0.01, kappa=0.02, asph_rel=0.05)
    return specs, lens, tol, (fused_asphere, "K4")


def _launches(counter):
    module, name = counter
    return getattr(module, f"{name}_FWD_LAUNCHES"), getattr(module, f"{name}_BWD_LAUNCHES")


@pytest.mark.parametrize("compensator", [None, "refocus"])
@pytest.mark.parametrize("name", ["cooke", "aspheric cooke"])
def test_tolerance_on_gpu_matches_unroll(cuda, name, compensator):
    """``tolerance_analysis`` of 64 samples on the fused engine (one K2 or K4
    Lu launch; with the refocus compensator one plain launch more) against
    the unroll engine on the card for the same population (drawn again
    from the same seed): per-sample RMS and the statistics at rtol 2e-4,
    atol 1e-6 (JAX's bar between its Pallas and XLA tolerance runs); the
    refocus shifts, a closed-form focus from nearby float32 rays, within
    5e-5 mm (JAX's own engines give such focus shifts 2.3e-5 mm apart; the
    aspheric population's came 1.28x the rms bar apart on the card)."""
    from torchoptics_tpu_torch import analysis
    specs, lens, tol, counter = _analysis_case(name, cuda)
    fused = simulator.SimulatorConfig(**ANALYSIS, trace_engine="fused")
    unroll = simulator.SimulatorConfig(**ANALYSIS, trace_engine="unroll")
    before = _launches(counter)
    with torch.no_grad():
        got = analysis.tolerance_analysis(specs, lens, fused, tol, 64,
                                          torch.Generator(device=cuda).manual_seed(5),
                                          rms_threshold=0.02, compensator=compensator)
    launched = tuple(a - b for a, b in zip(_launches(counter), before))
    assert launched == (2 if compensator else 1, 0)
    specs_n, lens_n = analysis.tile_population(specs, lens, 64)
    lens_p = analysis.perturb_lens(lens_n, torch.Generator(device=cuda).manual_seed(5), tol)
    with torch.no_grad():
        want = analysis._score_population(specs_n, lens_p, unroll, compensator,
                                          (50.0, 90.0, 99.0), 0.02)
    assert set(got) == set(want)
    for k in got:
        if k == "refocus_delta":
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=5e-5, msg=k)
        else:
            torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=1e-6, msg=k)
    assert float(got["std"]) > 0.0


@pytest.mark.parametrize("name,bar", [("cooke", 5e-5), ("aspheric cooke", 2e-3)])
def test_sensitivities_on_gpu_match_unroll(cuda, name, bar):
    """``sensitivities`` on the fused engine (one K2 or K4 forward and one
    backward) against the unroll engine's autograd on the card, each entry
    within ``bar`` of its table's largest: 5e-5 on the Cooke, twice the
    float32 floor of its table at this width (its float32 and float64
    tables differ by 1.1e-5 to 2.0e-5 of the largest on the CPU port),
    2e-3 on aspheres."""
    from torchoptics_tpu_torch import analysis
    specs, lens, _, counter = _analysis_case(name, cuda)
    before = _launches(counter)
    got = analysis.sensitivities(specs, lens,
                                 simulator.SimulatorConfig(**ANALYSIS, trace_engine="fused"))
    assert tuple(a - b for a, b in zip(_launches(counter), before)) == (1, 1)
    want = analysis.sensitivities(specs, lens,
                                  simulator.SimulatorConfig(**ANALYSIS, trace_engine="unroll"))
    assert set(got) == set(want)
    for k in want:
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= bar * scale, k


#: The sharded population: 255 systems (256 on a 2-wide 'lens' axis) x 54
#: rays (9 pupil rays, 10 on a 2-wide 'rays' axis).
N_SHARDED = 255


@pytest.fixture(scope="module")
def two_ranks_on_the_card(tmp_path_factory):
    """A 2-rank gloo group sharing cuda:0 (``parallel.mesh.spawn``), each
    rank's sharded K2 and K4 losses on the (1 x 2) and (2 x 1) layouts
    (``torch_parallel_ranks.cuda_rank``, which imports no JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import torch_parallel_ranks as ranks
    from torchoptics_tpu_torch.parallel import mesh as mesh_mod
    prefix = str(tmp_path_factory.mktemp("ranks") / "cuda")
    mesh_mod.spawn(ranks.cuda_rank, 2, args=(prefix, N_SHARDED), device="cuda")
    return ranks, [dict(np.load(f"{prefix}_{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("lens_parallel", [1, 2])
@pytest.mark.parametrize("kernel", ["k2", "k4"])
def test_sharded_fused_losses_on_gpu_match_single_process(cuda, two_ranks_on_the_card, kernel,
                                                          lens_parallel, full):
    """Two ranks on the one card (gloo on CUDA tensors), one K2 or K4
    forward and backward launch each: every rank's value within 2e-5 of the
    single-process fused loss on the card, the world-sum of the ranks'
    gradients within rtol 1e-3, atol 1e-6 (``tests/test_sharding.py``'s
    bars)."""
    ranks, results = two_ranks_on_the_card
    specs, lens = (ranks.tiled_population("cooke", N_SHARDED, 0.02, 0, cuda) if kernel == "k2"
                   else ranks.aspheric_population(N_SHARDED, cuda))
    value, grads = ranks.loss_and_grads(specs, lens, simulator.SimulatorConfig(**ranks.POP_KW),
                                        full, False)
    tag = f"{kernel}/{lens_parallel}/{'full' if full else 'lu'}"
    for res in results:
        assert abs(float(res[f"{tag}/value"]) - value) <= 2e-5 * abs(value)
        assert res[f"{tag}/launches"].tolist() == ([1, 1, 0, 0] if kernel == "k2"
                                                   else [0, 0, 1, 1])
    for k, want in grads.items():
        np.testing.assert_allclose(sum(res[f"{tag}/d{k}"] for res in results), want,
                                   rtol=1e-3, atol=1e-6, err_msg=k)


#: Each example at tiny flags (``tests/test_torch_examples.py``'s CPU runs).
EXAMPLE_FLAGS = {
    "optimize_lens": ["--steps", "2", "--fields", "2", "--rings", "3", "--log-every", "1"],
    "refine_flagship": ["--lens", "cooke", "--pop", "2", "--steps", "2", "--polish-steps", "1"],
    "train_generator": ["--steps", "2", "--batch", "4", "--eval-designs", "4"],
    "optimize_through_image": ["--steps", "1", "--image-size", "32", "--psf", "9", "--fields",
                               "3", "--rings", "4"],
    "optimize_wavefront": ["--steps", "2", "--grid", "5"],
    "simulate_aberrations": ["--image-size", "32", "--fields", "3", "--rings", "4",
                             "--psf-source", "diffraction", "--diffraction-grid", "16"],
    "flagship_report": ["--lens", "cooke", "--fields", "0,1.0"],
    "aberration_report": ["--fields", "0,1.0"],
}


@pytest.mark.parametrize("name", list(EXAMPLE_FLAGS))
def test_example_fused_matches_unroll_on_gpu(cuda, name, tmp_path):
    """Each example's ``main`` on the card at tiny flags, on the fused and
    the unroll engine: the printed numbers within ``chip_smoke.py`` phase
    42's bars plus their printed resolution (the Strehl ratios' bar from
    the OPD gap between the engines on the example's lens and grid, that
    gap held at 5e-5 mm)."""
    import contextlib
    import importlib
    import io
    example = importlib.import_module(f"torchoptics_tpu_torch.examples.{name}")
    argv = EXAMPLE_FLAGS[name] + (["--output", str(tmp_path / "out.png")]
                                  if name == "simulate_aberrations" else [])
    printed = {}
    for engine in ("fused", "unroll"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            example.main(argv + ["--engine", engine])
        printed[engine] = buf.getvalue()
    bar = next(run[4] for run in chip_smoke.EXAMPLE_RUNS if run[1] == name)
    strehl = (chip_smoke.strehl_bar(chip_smoke.example_opd_gap(torch, name, argv))
              if name in chip_smoke.STREHL_EXAMPLES else None)
    worst, gap, where = chip_smoke.compare_printouts(
        printed["fused"], printed["unroll"], lambda line, k, w: bar(line, k, w, strehl))
    assert worst <= 0.0, (gap, where)


@pytest.fixture(scope="module")
def splat_cases():
    """``chip_smoke.splat_cases`` on the card: the default configuration's
    splat (the double-Gauss traced on K1) and the seeded ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from torchoptics_tpu_torch import imaging
    from torchoptics_tpu_torch.ops import psf
    return chip_smoke.splat_cases(torch, zoo, simulator, imaging, psf)


@pytest.mark.parametrize("label", chip_smoke.SPLAT_CASES)
def test_s1_matches_plain_versions(cuda, splat_cases, label):
    """S1 forward and adjoint (d/dx, d/dy; d/dweights with the one-hot
    weights; d/dgx, d/dgy, d/dsigma with the auto extent) bit for bit with
    ``splat_reference`` and ``splat_backward_reference``, NaN where theirs
    is; one launch of each. Among the cases the half grids of
    ``chip_smoke.SPLAT_WIDE`` above the former ceiling of 129 x 65 (130 x
    65, 129 x 66, 257 x 129, 513 x 257, 300 x 7, 7 x 300: the forward's
    windowed kernels or its dense kernel's tiles; float32 and float64, with
    and without weights, per-bin sums and d/dw; at 257 x 129 rays at the windows' edges,
    an inf and a NaN ray, a NaN and an inf in a cotangent, an inf weight,
    rays off the grid, sigma of 3 bins, descending centres, a hot spot,
    windows ending at the forward's tiles' edges, sigma of the grid; 7 x
    60000, 9000 x 7 and 7 x 30000, past what the adjoint stages in shared
    memory: the centres read from global memory, the per-bin sums in chunks
    of bins), the windowed forward forced at 65 x 33 (the dense kernel's
    grid) and the dense one at 257 x 129, W = 4's one-hot weights at psf
    257, and the default configuration's splat at psf 257."""
    from torchoptics_tpu_torch.ops import psf
    args, bins, weights_grad, windowed = splat_cases[label]
    out, launches = chip_smoke.splat_compare(torch, psf, label, args, bins, weights_grad,
                                             chip_smoke.SPLAT_CASES.index(label), windowed)
    assert launches == (1, 1)
    assert all(v[0] for v in out.values()), out


def test_s1_window_threshold_probe(cuda):
    """S1's windows skip the bins whose q exceeds ``SPLAT_Q_MAX``,
    which is exact only if the card's exp gives 0 for every factor there:
    every float32 q above it and +inf; of float64 q every double in (q_max,
    q_max + 1], 2^26 spread up to +inf and the binades' end points
    (``psf.exp_zero_probe``); the library's q_max is psf's."""
    from torchoptics_tpu_torch.ops import psf
    probe = psf.exp_zero_probe()
    least = {"float32": 10 ** 9, "float64 band": 2 ** 42, "float64 spread": 2 ** 26,
             "float64 binade ends": 16 * 1013}
    assert set(probe) == set(least)
    for label, v in probe.items():
        dtype = torch.float64 if label.startswith("float64") else torch.float32
        assert v["nonzero"] == 0 and v["q_max"] == psf.SPLAT_Q_MAX[dtype], (label, v)
        assert v["checked"] > least[label], (label, v)


def test_s1_tensor_core_probe(cuda):
    """S1's float32 route takes its products on the FP64 tensor cores, which
    is right only if one mma.sync .f64 (m8n8k4, and m16n8k4, the shape S1
    runs) rounds as the chain of fused multiply-adds in k order: bit for bit
    on every case of ``psf.dmma_probe_inputs`` (ties, cancellation, the
    terms' order, random exact products, float32 subnormals)."""
    from torchoptics_tpu_torch.ops import psf
    probe = psf.dmma_probe()
    assert set(probe) == set(psf.DMMA_SHAPES)
    for shape, labels in probe.items():
        for label, v in labels.items():
            assert v["differ"] == 0 and v["fma_chain_ok"], (shape, label, v)
            assert "fma chain in k order" in v["models"], (shape, label, v)


def test_compute_psf_at_psf_257_launches_s1_once_each_way(cuda, monkeypatch):
    """``compute_psf`` on CUDA tensors under grad at a 257 x 257 grid (half
    grid 257 x 129: the forward's windowed kernels), a fixed pitch: S1
    launches once forward and once backward, never a plain version, the
    gradients finite; the windowed forward's tiles are 16 x 16 bins, 17 x 9
    of them (the dense kernel's would be 144 x 80, 2 x 2)."""
    import ctypes
    from torchoptics_tpu_torch.ops import _kernels, psf
    assert psf.splat_fwd_windowed(257, 129)
    tiles = (ctypes.c_int * 4)()
    _kernels.load().s1_fwd_tiles(257, 129, 1, tiles)
    assert list(tiles) == [16, 16, 17, 9]
    _kernels.load().s1_fwd_tiles(257, 129, 0, tiles)
    assert list(tiles) == [144, 80, 2, 2]

    def refuse(*_):
        raise AssertionError("a plain version ran on CUDA tensors")
    monkeypatch.setattr(psf, "splat_reference", refuse)
    monkeypatch.setattr(psf, "splat_backward_reference", refuse)
    monkeypatch.setattr(psf, "SPLAT_LAUNCHES", 0)
    monkeypatch.setattr(psf, "SPLAT_BWD_LAUNCHES", 0)
    x, y = chip_smoke.seeded_spots(torch, (3, 7, 3, 2000), 37, scale=0.1)
    x.requires_grad_()
    y.requires_grad_()
    kernels = psf.compute_psf(x, y, (257, 257), 8e-4)[3]
    grads = torch.autograd.grad((kernels * kernels).sum(), (x, y))
    torch.cuda.synchronize()
    assert (psf.SPLAT_LAUNCHES, psf.SPLAT_BWD_LAUNCHES) == (1, 1)
    assert kernels.shape == (21, 3, 257, 257)
    assert all(bool(torch.isfinite(g).all()) and bool((g != 0).any()) for g in grads)


def test_resize_contractions_match_the_cpu_and_refuse_tf32(cuda, monkeypatch):
    """``resize_bilinear``'s two matrix products on the card against the CPU
    (a 257 -> 187 downscale and a 47 -> 95 upscale of 9 patches' PSFs, and
    the gradient of a seeded weighting) within 1e-6 of the largest entry;
    with TF32 allowed for matrix products it raises."""
    from torchoptics_tpu_torch.ops import image
    rng = np.random.default_rng(61)
    for n_in, n_out in ((257, 187), (47, 95)):
        x = rng.uniform(0.0, 1.0, (9, n_in, n_in, 3)).astype(np.float32)
        cot = rng.normal(size=(9, n_out, n_out, 3)).astype(np.float32)
        got, want = [], []
        for device, out in ((cuda, got), ("cpu", want)):
            t = torch.tensor(x, device=device, requires_grad=True)
            y = image.resize_bilinear(t, (n_out, n_out))
            out += [y.detach().cpu(), torch.autograd.grad(y, t, torch.tensor(cot, device=device))[
                0].cpu()]
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        image.resize_bilinear(torch.ones((1, 5, 5, 3), device=cuda), (3, 3))


def test_interpolate_psfs_matches_the_cpu_and_refuses_tf32(cuda, monkeypatch):
    """``interpolate_psfs``' matrix product over the fields on the card
    against the CPU (21 fields' 65 x 65 x 3 PSFs blended into 81 patches,
    and the gradient of a seeded weighting) within 1e-5 of the largest
    entry (float32 sums of up to 81 terms in another order); with TF32
    allowed for matrix products it raises."""
    from torchoptics_tpu_torch.ops import image
    rng = np.random.default_rng(67)
    x_map = np.linspace(-0.8, 0.8, 90, dtype=np.float32)
    field_map = np.sqrt(x_map[None, :] ** 2 + x_map[:, None] ** 2)
    psfs = rng.uniform(0.0, 1.0, (21, 65, 65, 3)).astype(np.float32)
    cot = rng.normal(size=(81, 65, 65, 3)).astype(np.float32)
    got, want = [], []
    for device, out in ((cuda, got), ("cpu", want)):
        t = torch.tensor(psfs, device=device, requires_grad=True)
        y = image.interpolate_psfs(t, field_map, (9, 9))
        out += [y.detach().cpu(), torch.autograd.grad(y, t, torch.tensor(cot, device=device))[
            0].cpu()]
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        image.interpolate_psfs(torch.ones((3, 5, 5, 3), device=cuda), field_map, (2, 2))


@pytest.mark.parametrize("kh,kw", [(23, 23), (33, 25)])
def test_fft_route_cut_matches_plain_version(cuda, monkeypatch, kh, kw):
    """P2's FFT route with its cut lowered to 64 pixels (``P2_FFT_TILE``) on
    patches of 150 x 130: forward, d/dpsf and d/dpatch (whose padded
    cotangent is cut too) bit for bit with their plain versions, which cut
    alike; three launches a piece."""
    from torchoptics_tpu_torch.ops import image
    monkeypatch.setattr(image, "P2_FFT_TILE", 64)
    g = torch.Generator(device=cuda).manual_seed(kh + kw)
    patches = torch.rand((2, 150, 130, 3), generator=g, device=cuda) * 255.0
    psfs = torch.rand((2, kh, kw, 3), generator=g, device=cuda)
    cot = torch.randn((2, 151 - kh, 131 - kw, 3), generator=g, device=cuda)
    pieces = len(image.fft_tiles(150, kh)) * len(image.fft_tiles(130, kw))
    assert pieces >= 9
    monkeypatch.setattr(image, "P2_FFT_LAUNCHES", 0)
    monkeypatch.setattr(image, "P2_DPSF_FFT_LAUNCHES", 0)
    t_psfs = psfs.clone().requires_grad_()
    t_patches = patches.clone().requires_grad_()
    out = image.svola_patch_conv(t_patches, t_psfs)
    d_patches, d_psfs = torch.autograd.grad(out, (t_patches, t_psfs), cot)
    torch.cuda.synchronize()
    assert image.P2_DPSF_FFT_LAUNCHES == 3 * pieces
    assert image.P2_FFT_LAUNCHES > 3 * pieces
    assert torch.equal(out, image.svola_patch_conv_fft_reference(patches, psfs))
    assert torch.equal(d_psfs, image.svola_patch_conv_dpsf_fft_reference(patches, cot, (kh, kw)))
    assert torch.equal(d_patches, image.svola_patch_conv_dpatch_reference(cot, psfs))


def test_compute_psf_launches_s1_and_no_plain_version(cuda, monkeypatch):
    """On CUDA tensors under grad, ``compute_psf`` runs S1 forward and its
    adjoint (with the per-bin sums: the auto extent), never a plain version;
    the library's chunk is ``psf``'s; a grid above the former ceiling (a
    132 x 9 PSF, half grid 9 x 66) is taken."""
    from torchoptics_tpu_torch.ops import _kernels, psf
    lib = _kernels.load()
    assert lib.s1_chunk() == psf.SPLAT_CHUNK

    def refuse(*_):
        raise AssertionError("a plain version ran on CUDA tensors")
    monkeypatch.setattr(psf, "splat_reference", refuse)
    monkeypatch.setattr(psf, "splat_backward_reference", refuse)
    monkeypatch.setattr(psf, "SPLAT_LAUNCHES", 0)
    monkeypatch.setattr(psf, "SPLAT_BWD_LAUNCHES", 0)
    x, y = chip_smoke.seeded_spots(torch, (2, 4, 3, 700), 31)
    x.requires_grad_()
    y.requires_grad_()
    kernels = psf.compute_psf(x, y, (21, 17), None)[3]
    grads = torch.autograd.grad((kernels * kernels).sum(), (x, y))
    torch.cuda.synchronize()
    assert (psf.SPLAT_LAUNCHES, psf.SPLAT_BWD_LAUNCHES) == (1, 1)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    wide = psf.compute_psf(x.detach(), y.detach(), (132, 9), 1e-3)[3]
    assert wide.shape == (8, 3, 9, 132) and bool(torch.isfinite(wide).all())
    with pytest.raises(ValueError, match="contiguous"):
        psf._launch_splat(x.detach(), y.detach().double(), *[torch.zeros((2, n), device=cuda)
                                                             for n in (3, 4)],
                          torch.ones(2, device=cuda), torch.ones(2, device=cuda), None)
