#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's two paths through their user entry points on the card: the
double-Gauss lens-evaluation ("serving") path and the lens-training path
(``LensOptimizer`` Adam steps, the main path), and checks every hand-written
CUDA kernel on them against its plain PyTorch version:

1. the card's name and power limit;
2. the build of the CUDA kernels from the sources in this checkout, with
   each kernel's registers, stack frame and spills from ``-Xptxas -v``;
3. K1 forward against ``trace_fused_reference`` at 16 fields x 96^2 pupil
   rays x 3 wavelengths (442,368 rays), plain, Lu and full modes, both
   backward-ray policies, on the flagship and on a c x 3 lens that fails
   rays; the full mode with tight path and angle bounds so both hinges fire;
4. K1 backward against ``trace_fused_backward_reference`` at the same width,
   all three modes, both policies, both lenses, with seeded cotangents; two
   launches must agree bit for bit;
5. three requests served by ``simulator.do_ray_tracing`` on the fused engine,
   each held against the same call on the CPU, with the forward's launches;
6. training: ``LensOptimizer`` on the flagship at 32 fields x 160^2 x 3
   (2,457,600 rays), 5 Adam steps on the Lu loss and 5 on the full weighted
   loss, with one K1 forward and one K1 backward launch per step and every
   step accepted (finite loss and gradients); the first step of each held
   against the same step on the CPU at the entry width (5 x 16^2 x 3);
7. timings with CUDA events at 2,457,600 rays: the kernels against their
   plain versions, each kernel also checked against its plain version at
   this width (masks, coordinates and penalty sums; per-ray and parameter
   cotangents), the fwd+bwd of ``spot_rms_fused`` and of
   ``unsupervised_loss_fused``, and a whole ``LensOptimizer.step``.

Every phase prints its findings; any failure exits nonzero. It needs one CUDA
device and exits 1 without one. The last line is a JSON object with the
device; the line before it is the card's name and power limit, and the line
before that carries the kernels' numbers.

    python3 chip_smoke.py             # the run described above
    python3 chip_smoke.py --profile   # instead: a torch.profiler breakdown of
                                      # LensOptimizer.step at 2,457,600 rays
"""

import json
import math
import statistics
import subprocess
import sys
import time

FULL_WIDTH = dict(n_sampled_fields=16, n_pupil_rings=96)        # 442,368 rays
BENCH_WIDTH = dict(n_sampled_fields=32, n_pupil_rings=160)      # 2,457,600 rays
ENTRY_WIDTH = dict(n_sampled_fields=5, n_pupil_rings=16)        # 3,840 rays
FWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_trace_fwd.cu"
BWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_trace_bwd.cu"
TPU_FWD = "torchoptics_tpu/ops/pallas_trace.py:308"
TPU_BWD = "torchoptics_tpu/ops/pallas_trace.py:424"
PENALTY_MODES = (False, True, "full")
MODE_NAME = {False: "plain", True: "lu", "full": "full"}
# Tight bounds, so that the path and angle hinges fire on the flagship.
TIGHT = dict(ray_path_lower_thresholds=(0.5, 1.5, 12.0),
             ray_path_upper_thresholds=(None, 3.0, 40.0), ray_angle_threshold=30.0)
# The H100's published float32 (non-tensor) and memory rates.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Bytes per ray: the inputs read once and the outputs written once.
FWD_BYTES = {False: 30, True: 42, "full": 50}
BWD_BYTES = {False: 40, True: 52, "full": 60}


def k1_ops(penalties, n_surf, n_sides, backward):
    """Floating-point operations per ray that K1 forward or backward needs,
    read off the kernels' code (see the notes in csrc/): adds, multiplies,
    min/max, and each sqrt, division and acosf counted as one; compares and
    selects not counted. ``n_sides``: the finite sides of the path bounds,
    over all gaps (full mode)."""
    lu, full = penalties in (True, "full"), penalties == "full"
    if not backward:
        # 55 per surface, launch and image transfer 8; Lu: two theta_norm
        # and three sums, 14; full: angle hinges 6, path deltas and sum 4,
        # 3 per finite side.
        return (55 * n_surf + 8 + (14 * n_surf if lu else 0)
                + (10 * n_surf - 1 + 3 * n_sides if full else 0))
    # The forward once (without its penalty sums), the surface adjoint 104
    # and the three parameter sums (dc, dt, dmu) per surface; launch, image
    # and dz0 terms 19 per ray. Lu: the relu and two theta_norm adjoints, 20;
    # full: the hinge gradients 4 per gap plus 1 per finite side, their dz
    # and dref_z terms 4, the angle hinges 4.
    return (162 * n_surf + 19 + (20 * n_surf if lu else 0)
            + (12 * n_surf - 2 + n_sides if full else 0))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(ok, message):
    print(("ok   " if ok else "FAIL ") + message, flush=True)
    if not ok:
        sys.exit(1)


def bound(n_rays, ops_per_ray, bytes_per_ray, extra_bytes=0):
    """(bound_ms, bound_by): the larger of the operations over the FP32 peak
    and the bytes (each input read once, each output written once) over the
    memory rate."""
    t_ops = n_rays * ops_per_ray / PEAK_FLOPS
    t_bytes = (n_rays * bytes_per_ray + extra_bytes) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def full_args(torch, fused_trace, lens):
    """ref_z, the per-gap bounds and cos²(threshold) of the tight full mode."""
    vertex_z = torch.cumsum(lens.t[0].detach(), 0)
    ref_z = torch.cat((vertex_z, vertex_z[-1:]))
    bounds = fused_trace._path_bounds(lens.structure, TIGHT["ray_path_lower_thresholds"],
                                      TIGHT["ray_path_upper_thresholds"])
    return ref_z, bounds, math.cos(math.radians(TIGHT["ray_angle_threshold"])) ** 2


def kernel_inputs(torch, zoo, simulator, fused_trace, width, c_scale=1.0):
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    **width).trace_config()
    specs, lens = zoo.build("double_gauss", device="cuda")
    lens = lens.replace(c=lens.c * c_scale)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, W) = fused_trace.prepare_fused_inputs(specs, lens, cfg)
    ref_z, bounds, thr = full_args(torch, fused_trace, lens)
    inputs = (xp, yp, cyb, z0, lens.c[0].detach(), lens.t[0].detach(), mu, ref_z)
    return inputs, F * P, bounds, thr


def run_fwd(fused_trace, inputs, penalties, allow_backward, n_per_w, bounds, thr, plain):
    ins = inputs if penalties == "full" else inputs[:7]
    if plain:
        return fused_trace.trace_fused_reference(*ins[:7], penalties, allow_backward, n_per_w,
                                                 inputs[7], bounds, thr)
    return fused_trace._launch_k1_fwd(ins, penalties, allow_backward, n_per_w, bounds, thr)


def run_bwd(fused_trace, inputs, cot, penalties, allow_backward, n_per_w, bounds, thr, plain):
    ins = inputs if penalties == "full" else inputs[:7]
    if plain:
        return fused_trace.trace_fused_backward_reference(ins, cot, penalties, allow_backward,
                                                          n_per_w, bounds, thr)
    return fused_trace._launch_k1_bwd(ins, cot, penalties, allow_backward, n_per_w, bounds,
                                      thr)


def fwd_errors(got, want):
    """Mask identity and the largest deviations of K1 forward's outputs from
    the plain version's."""
    import torch
    masks_equal = all(torch.equal(got[i], want[i]) for i in (4, 5))
    ok = want[4]
    rel = lambda a, b: float((((a - b).abs() - 1e-6 * b.abs()) * ok).max())
    err = {
        "xy": max(float(((got[i] - want[i]).abs() * ok).max()) for i in (0, 1)),
        "xy_excess": max(rel(got[i], want[i]) for i in (0, 1)),
        "cxcy": max(float(((got[i] - want[i]).abs() * ok).max()) for i in (2, 3)),
    }
    if len(got) > 6:
        err["pen"] = max(float((got[i] - want[i]).abs().max()) for i in range(6, len(got)))
    return masks_equal, err


def phase_forward(torch, zoo, simulator, fused_trace):
    """K1 forward vs its plain version; returns the largest deviation per
    kernel entry ('k1_fwd' = plain and Lu, 'k1_fwd_full')."""
    worst = {"k1_fwd": 0.0, "k1_fwd_full": 0.0}
    failed = []
    for label, c_scale in (("double_gauss", 1.0), ("double_gauss c x 3", 3.0)):
        inputs, n_per_w, bounds, thr = kernel_inputs(torch, zoo, simulator, fused_trace,
                                                     FULL_WIDTH, c_scale)
        for penalties in PENALTY_MODES:
            for allow_backward in (True, False):
                args = (inputs, penalties, allow_backward, n_per_w, bounds, thr)
                got = run_fwd(fused_trace, *args, plain=False)
                want = run_fwd(fused_trace, *args, plain=True)
                torch.cuda.synchronize()
                masks_equal, err = fwd_errors(got, want)
                # Lu and full: the penalty sums within 1e-5 (acosf rounding;
                # the hinge sums are bit-identical); coordinates bit-identical.
                ok = (masks_equal and err["xy_excess"] <= 5e-6 and err["cxcy"] <= 1e-6
                      and err.get("pen", 0.0) <= 1e-5)
                key = "k1_fwd_full" if penalties == "full" else "k1_fwd"
                worst[key] = max([worst[key]] + [v for k, v in err.items() if k != "xy_excess"])
                hinges = ""
                if penalties == "full":
                    hinges = (f", mean path hinge {float(got[9].mean()):.4f}, mean angle "
                              f"hinge {float(got[10].mean()):.4f}")
                print(f"{'ok  ' if ok else 'FAIL'} K1 forward vs plain, {label}, "
                      f"{MODE_NAME[penalties]} mode, allow_backward={allow_backward}, "
                      f"{inputs[0].shape[0]} rays: masks identical={masks_equal}, ray_ok "
                      f"share={float(got[4].float().mean()):.6f}, max |dx|,|dy|={err['xy']:.3e}, "
                      f"max |dcx|,|dcy|={err['cxcy']:.3e}"
                      + (f", max |dpenalty|={err['pen']:.3e}" if "pen" in err else "")
                      + hinges, flush=True)
                if not ok:
                    failed.append((label, penalties, allow_backward))
    check(not failed, f"phase 3: K1 forward agrees with its plain version (failed: {failed})")
    return worst


def phase_backward(torch, zoo, simulator, fused_trace):
    """K1 backward vs its plain version on seeded cotangents, and two
    launches bit for bit. Returns the largest deviations: per-ray, and of the
    parameter cotangents, absolute and relative to their largest magnitude."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = (0.0, 0.0, 0.0)
    failed = []
    for label, c_scale in (("double_gauss", 1.0), ("double_gauss c x 3", 3.0)):
        inputs, n_per_w, bounds, thr = kernel_inputs(torch, zoo, simulator, fused_trace,
                                                     FULL_WIDTH, c_scale)
        n = inputs[0].shape[0]
        for penalties in PENALTY_MODES:
            for allow_backward in (True, False):
                n_cot = (4, 7, 9)[("plain", "lu", "full").index(MODE_NAME[penalties])]
                cot = [torch.randn(n, device="cuda", generator=gen) for _ in range(n_cot)]
                args = (inputs, cot, penalties, allow_backward, n_per_w, bounds, thr)
                got = run_bwd(fused_trace, *args, plain=False)
                again = run_bwd(fused_trace, *args, plain=False)
                want = run_bwd(fused_trace, *args, plain=True)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                ray_err = max(float((got[i] - want[i]).abs().max()) for i in range(3))
                par_abs = max(float((got[i] - want[i]).abs().max()) for i in range(3, len(got)))
                # The parameter sums differ from the plain version's float64
                # sums by the kernel's float32 block and column sums.
                par_rel = max(float((got[i] - want[i]).abs().max()
                                    / want[i].abs().max().clamp(min=1e-30))
                              for i in range(3, len(got)))
                ok = same and finite and ray_err == 0.0 and par_rel <= 1e-5
                worst = tuple(map(max, worst, (ray_err, par_abs, par_rel)))
                print(f"{'ok  ' if ok else 'FAIL'} K1 backward vs plain, {label}, "
                      f"{MODE_NAME[penalties]} mode, allow_backward={allow_backward}, {n} rays: "
                      f"max per-ray deviation {ray_err:.3e}, max per-parameter deviation "
                      f"{par_abs:.3e} ({par_rel:.2e} of the largest), two launches "
                      f"bit-identical={same}", flush=True)
                if not ok:
                    failed.append((label, penalties, allow_backward))
    check(not failed, f"phase 4: K1 backward agrees with its plain version (failed: {failed})")
    return worst


def phase_serve(torch, zoo, simulator, fused_trace, entry):
    """Three requests on the fused engine, through the user entry points.
    Returns the forward kernel's launch count in that run."""
    specs, lens = zoo.build("double_gauss", device="cuda")
    specs_cpu, lens_cpu = specs.to("cpu"), lens.to("cpu")
    designs = [("flagship", 1.0), ("c x (1 + 1e-3)", 1.0 + 1e-3),
               ("c x (1 - 1e-3)", 1.0 - 1e-3)]
    fn, (c0, t0) = entry.entry()
    served = []
    fused_trace.K1_FWD_LAUNCHES = 0
    fused_trace.K1_BWD_LAUNCHES = 0
    with torch.no_grad():
        for _, scale in designs:
            res, loss = simulator.do_ray_tracing(specs, lens.replace(c=lens.c * scale),
                                                 entry.CONFIG)
            served.append((res, loss))
        lu_entry = fn(c0, t0)
        torch.cuda.synchronize()
    launches = fused_trace.K1_FWD_LAUNCHES
    n_calls = len(designs) + 1
    check(launches == n_calls and fused_trace.K1_BWD_LAUNCHES == 0,
          f"phase 5: K1 forward launched {launches} times for {n_calls} fused calls, "
          f"K1 backward {fused_trace.K1_BWD_LAUNCHES} times")
    tol = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4}
    for (label, scale), (res, loss) in zip(designs, served):
        check(tuple(res.x.shape) == (1, 5, 256, 3)
              and bool(torch.isfinite(res.x[res.ray_ok]).all())
              and all(bool(torch.isfinite(v)) for v in loss.values()),
              f"{label}: finite (1, 5, 256, 3) result, ray_ok share "
              f"{float(res.ray_ok.float().mean()):.6f}")
        with torch.no_grad():
            _, want = simulator.do_ray_tracing(
                specs_cpu, lens_cpu.replace(c=lens_cpu.c * scale), entry.CONFIG)
        rel = {k: abs(float(loss[k]) - float(want[k])) / abs(float(want[k])) for k in tol}
        check(all(rel[k] <= tol[k] for k in tol),
              f"{label}: CUDA vs CPU loss_unsup {float(loss['loss_unsup']):.7f} vs "
              f"{float(want['loss_unsup']):.7f}, rms {float(loss['rms']):.8f} vs "
              f"{float(want['rms']):.8f}, penalty {float(loss['penalty']):.6f} vs "
              f"{float(want['penalty']):.6f}; relative gaps "
              + ", ".join(f"{k} {rel[k]:.2e} (limit {tol[k]:.0e})" for k in tol))
    check(float(lu_entry) == float(served[0][1]["loss_unsup"]),
          f"entry() fn(c, t) = {float(lu_entry):.7f}, equal to the served flagship")
    return launches


def make_optimizer(zoo, simulator, LensOptimizer, device, width, use_full_loss):
    """The flagship with its glasses moved 2e-3 off the catalog (a design in
    progress: exactly on a catalog glass the glass penalty's gradient is NaN,
    in the JAX package too, and every full-loss step would be rejected), at
    its own EFL."""
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    trace_engine="fused", **width)
    specs, lens = zoo.build("double_gauss", device=device)
    lens = lens.replace(nd=lens.nd + 2e-3)
    opt = LensOptimizer(specs=specs, config=cfg, learning_rate=1e-4,
                        use_full_loss=use_full_loss, efl_target=float(lens.efl[0]))
    return opt, opt.init(lens)


def phase_train(torch, zoo, simulator, fused_trace, LensOptimizer, n_steps=5):
    """The main path: Adam steps at bench width on the Lu loss, then on the
    full loss, counts set to 0 before each and read after. Returns the
    (forward, backward) launches of each run."""
    n_rays = 2_457_600
    launches = {}
    for full in (False, True):
        name = "full" if full else "Lu"
        opt, state = make_optimizer(zoo, simulator, LensOptimizer, "cuda", BENCH_WIDTH, full)
        start = {k: v.detach().clone() for k, v in state.params.items()}
        fused_trace.K1_FWD_LAUNCHES = 0
        fused_trace.K1_BWD_LAUNCHES = 0
        totals = []
        for _ in range(n_steps):
            state, total, loss_dict = opt.step(state)
            totals.append(float(total))
        torch.cuda.synchronize()
        fwd, bwd = fused_trace.K1_FWD_LAUNCHES, fused_trace.K1_BWD_LAUNCHES
        adam_steps = [int(s["step"]) for s in state.opt_state.state.values()]
        moved = max(float((state.params[k].detach() - start[k]).abs().max()) for k in start)
        finite = (all(math.isfinite(v) for v in totals)
                  and all(bool(torch.isfinite(v).all()) for v in state.params.values()))
        check(fwd == n_steps and bwd == n_steps and finite
              and adam_steps == [n_steps] * len(adam_steps) and moved > 0,
              f"phase 6: {n_steps} LensOptimizer steps on the {name} loss at {n_rays} rays "
              f"(11 surfaces): K1 forward launched {fwd} times, K1 backward {bwd} times; "
              f"all {n_steps} steps accepted (finite loss and gradients: Adam step counts "
              f"{adam_steps}); losses {['%.6f' % v for v in totals]}; parameters moved by "
              f"up to {moved:.3e}")
        launches[name] = (fwd, bwd)

        # The first step on the card against the same step on the CPU.
        after = {}
        for device in ("cuda", "cpu"):
            opt_d, state_d = make_optimizer(zoo, simulator, LensOptimizer, device,
                                            ENTRY_WIDTH, full)
            state_d, total_d, _ = opt_d.step(state_d)
            after[device] = (float(total_d), {k: v.detach().cpu()
                                              for k, v in state_d.params.items()})
        rel = abs(after["cuda"][0] - after["cpu"][0]) / abs(after["cpu"][0])
        dparam = max(float((after["cuda"][1][k] - after["cpu"][1][k]).abs().max())
                     for k in after["cpu"][1])
        # One Adam step moves each parameter by ~lr = 1e-4; 1e-6 allows a
        # sign flip of no gradient component and float32 rounding of Adam.
        check(rel <= 1e-5 and dparam <= 1e-6,
              f"first {name} step at {3840} rays, CUDA vs CPU: loss {after['cuda'][0]:.7f} vs "
              f"{after['cpu'][0]:.7f} (relative gap {rel:.2e}, limit 1e-05), parameters after "
              f"the step differ by at most {dparam:.3e} (limit 1e-06)")
    return launches


def time_ms(torch, fn, runs=25, batch=10, warmup=3):
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``batch`` back-to-back calls, divided by ``batch``; the median of
    ``runs`` such batches. Back to back, a kernel's time is not padded by the
    host's time to enqueue it, unless the host is the slower of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def host_ms(torch, fn, runs=10, warmup=2):
    """Milliseconds per call on the host clock around work that ends in
    ``torch.cuda.synchronize()``; the median of ``runs`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def phase_timing(torch, zoo, simulator, fused_trace, LensOptimizer, card):
    """The kernels and their plain versions at the main path's width, each
    kernel checked against its plain version there; then the fwd+bwd
    workloads and a whole optimizer step. Returns the times, the kernels'
    deviations at this width, and the shapes that the bounds count."""
    inputs, n_per_w, bounds, thr = kernel_inputs(torch, zoo, simulator, fused_trace,
                                                 BENCH_WIDTH)
    n, n_surf = inputs[0].shape[0], inputs[4].shape[0]
    shape = dict(n_rays=n, n_surf=n_surf, n_w=inputs[6].shape[1], bounds=bounds)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ms, errs = {}, {}
    with torch.no_grad():
        for penalties in PENALTY_MODES:
            mode = MODE_NAME[penalties]
            fwd = lambda plain: run_fwd(fused_trace, inputs, penalties, True, n_per_w,
                                        bounds, thr, plain)
            ms[f"k1_fwd_{mode}"] = time_ms(torch, lambda: fwd(False))
            ms[f"plain_fwd_{mode}"] = time_ms(torch, lambda: fwd(True), runs=5, batch=2)
            masks_equal, err = fwd_errors(fwd(False), fwd(True))
            check(masks_equal and err["xy_excess"] <= 5e-6 and err["cxcy"] <= 1e-6
                  and err.get("pen", 0.0) <= 1e-5,
                  f"K1 forward vs plain at {n} rays, {mode} mode: masks identical, {err}")
            errs[f"fwd_{mode}"] = max(v for k, v in err.items() if k != "xy_excess")
            n_cot = (4, 7, 9)[("plain", "lu", "full").index(mode)]
            cot = [torch.randn(n, device="cuda", generator=gen) for _ in range(n_cot)]
            bwd = lambda plain: run_bwd(fused_trace, inputs, cot, penalties, True, n_per_w,
                                        bounds, thr, plain)
            ms[f"k1_bwd_{mode}"] = time_ms(torch, lambda: bwd(False))
            ms[f"plain_bwd_{mode}"] = time_ms(torch, lambda: bwd(True), runs=5, batch=2)
            got, want = bwd(False), bwd(True)
            ray_err = max(float((got[i] - want[i]).abs().max()) for i in range(3))
            par_abs = max(float((got[i] - want[i]).abs().max()) for i in range(3, len(got)))
            par_rel = max(float((got[i] - want[i]).abs().max()
                                / want[i].abs().max().clamp(min=1e-30))
                          for i in range(3, len(got)))
            errs[f"bwd_{mode}"] = (ray_err, par_abs, par_rel)
            check(ray_err == 0.0 and par_rel <= 1e-5
                  and all(bool(torch.isfinite(a).all()) for a in got),
                  f"K1 backward vs plain at {n} rays, {mode} mode: per-ray cotangents "
                  f"bit-identical (max deviation {ray_err:.3e}); parameter cotangents "
                  f"dz0, dc, dt, dmu{', dref_z' if mode == 'full' else ''} within "
                  f"{par_rel:.2e} of their largest magnitude (limit 1e-05; max absolute "
                  f"deviation {par_abs:.3e})")

    cfg_sim = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                        trace_engine="fused", **BENCH_WIDTH)
    specs, lens = zoo.build("double_gauss", device="cuda")

    def fwd_bwd(loss_of):
        c = lens.c.detach().clone().requires_grad_(True)
        t = lens.t.detach().clone().requires_grad_(True)
        torch.autograd.grad(loss_of(lens.replace(c=c, t=t)), (c, t))

    ms["spot_rms_fused_fwd_bwd"] = time_ms(torch, lambda: fwd_bwd(
        lambda l: fused_trace.spot_rms_fused(specs, l, cfg_sim.trace_config())), runs=5, batch=4)
    ms["unsupervised_loss_fused_fwd_bwd"] = time_ms(torch, lambda: fwd_bwd(
        lambda l: fused_trace.unsupervised_loss_fused(specs, l, cfg_sim)[0]), runs=5, batch=4)
    for full in (False, True):
        opt, state = make_optimizer(zoo, simulator, LensOptimizer, "cuda", BENCH_WIDTH, full)
        holder = [state]

        def step():
            holder[0] = opt.step(holder[0])[0]
        ms[f"optimizer_step_{'full' if full else 'lu'}"] = host_ms(torch, step)
    for key, value in ms.items():
        print(f"time {key}: {value:.4f} ms per call at {n} rays (32 fields x 25,600 pupil "
              f"x 3 wavelengths, {n_surf} surfaces), card: {card}", flush=True)
    return ms, errs, shape


def phase_profile(torch, zoo, simulator, fused_trace, LensOptimizer, card, n_steps=3):
    """Where a LensOptimizer step's time goes at 2,457,600 rays: the device's
    busy time by kernel group from torch.profiler, against the host clock."""
    from torch.profiler import ProfilerActivity, profile
    for full in (False, True):
        opt, state = make_optimizer(zoo, simulator, LensOptimizer, "cuda", BENCH_WIDTH, full)
        for _ in range(2):
            state = opt.step(state)[0]
        torch.cuda.synchronize()
        start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                state = opt.step(state)[0]
            torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3 / n_steps
        groups, n_kernels, kernels = {}, 0, []
        for ev in prof.key_averages():
            if not str(ev.device_type).endswith("CUDA"):
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            name = ev.key
            n_kernels += ev.count
            kernels.append((dev_us / 1e3 / n_steps, ev.count / n_steps, name))
            group = ("K1 forward" if "k1_fwd_kernel" in name else
                     "K1 backward" if "k1_bwd" in name else
                     "Adam" if ("adam" in name.lower() or "multi_tensor" in name) else
                     "reductions" if "reduce" in name.lower() else "front-end and other")
            groups[group] = groups.get(group, 0.0) + dev_us / 1e3 / n_steps
        busy = sum(groups.values())
        print(f"profile: LensOptimizer.step on the {'full' if full else 'Lu'} loss at 2457600 "
              f"rays: host wall {wall:.3f} ms per step, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f} %), {n_kernels / n_steps:.0f} device operations "
              f"per step; card: {card}", flush=True)
        for group, value in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"profile:   {group}: {value:.4f} ms per step", flush=True)
        for value, count, name in sorted(kernels, reverse=True)[:12]:
            print(f"profile:     {value:.4f} ms, {count:.0f} launches: {name[:90]}", flush=True)


def kernel_bound(shape, penalties, backward):
    """(bound_ms, bound_by) of K1 forward or backward at the timed shape."""
    n, n_surf = shape["n_rays"], shape["n_surf"]
    n_sides = sum(math.isfinite(v) for gap in shape["bounds"] for v in gap)
    ops = k1_ops(penalties, n_surf, n_sides, backward)
    if not backward:
        return bound(n, ops, FWD_BYTES[penalties])
    # Plus the partials: one column per block of 256 rays, written once and
    # read once.
    n_params = (1 + 2 * n_surf + n_surf * shape["n_w"]
                + (n_surf + 1 if penalties == "full" else 0))
    return bound(n, ops, BWD_BYTES[penalties], 8 * n_params * -(-n // 256))


def kernel_entries(ms, errs, shape, fwd_err, bwd_err, serve_launches, train_launches):
    """The kernels line. Each entry's main numbers are for the mode of the
    main path's Lu-loss training run, and ``launches`` counts that run; the
    other modes' times and bounds and the other runs' launches stand beside
    them under their own keys. Deviations are the largest of phases 3, 4 and
    the timed width; K1 backward's parameter cotangents, sums over all rays,
    are reported relative to their largest magnitude."""
    def numbers(kind, penalties, suffix=""):
        mode = MODE_NAME[penalties]
        b_ms, b_by = kernel_bound(shape, penalties, kind == "bwd")
        return {f"ms{suffix}": ms[f"k1_{kind}_{mode}"],
                f"plain_ms{suffix}": ms[f"plain_{kind}_{mode}"],
                f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by}
    bwd_errs = [bwd_err] + [errs[f"bwd_{m}"] for m in ("plain", "lu", "full")]
    return [
        {"name": "k1_fwd", "route": "cuda", "source": FWD_SOURCE, "replaces": TPU_FWD,
         "launches": train_launches["Lu"][0],
         "max_abs_err": max(fwd_err["k1_fwd"], errs["fwd_plain"], errs["fwd_lu"]),
         **numbers("fwd", True), "library_ms": None,
         "launches_serving": serve_launches, **numbers("fwd", False, "_plain")},
        {"name": "k1_fwd_full", "route": "cuda", "source": FWD_SOURCE, "replaces": TPU_FWD,
         "launches": train_launches["full"][0],
         "max_abs_err": max(fwd_err["k1_fwd_full"], errs["fwd_full"]),
         **numbers("fwd", "full"), "library_ms": None},
        {"name": "k1_bwd", "route": "cuda", "source": BWD_SOURCE, "replaces": TPU_BWD,
         "launches": train_launches["Lu"][1],
         "max_abs_err": max(e[0] for e in bwd_errs), **numbers("bwd", True),
         "library_ms": None, "launches_full_loss": train_launches["full"][1],
         "param_max_abs_err": max(e[1] for e in bwd_errs),
         "param_max_rel_err": max(e[2] for e in bwd_errs),
         **numbers("bwd", False, "_plain"), **numbers("bwd", "full", "_full")},
    ]


def ptxas_summary(path):
    """One line per kernel from the build's -Xptxas -v report."""
    lines, name = [], None
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            raw = line.split("'")[1]
            for short in ("k1_fwd_kernel", "k1_bwd_kernel", "k1_bwd_reduce"):
                if short in raw:
                    name = short + (raw[raw.index(short) + len(short):][:9]
                                    .replace("ILi", "<").replace("ELb", ",").rstrip("E"))
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split('info    :')[-1].strip()}; {frame}")
            name = None
    return lines


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 1
    from torchoptics_tpu_torch import LensOptimizer, entry, simulator, zoo
    from torchoptics_tpu_torch.ops import _kernels, fused_trace

    card = card_line()
    print(f"card: {card} (nvidia-smi name, power.limit); "
          f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    start = time.perf_counter()
    path = _kernels.build()
    _kernels.load()
    print(f"build: {path.name} in {time.perf_counter() - start:.2f} s", flush=True)
    for line in ptxas_summary(path):
        print(f"ptxas: {line}", flush=True)

    if "--profile" in sys.argv[1:]:
        phase_profile(torch, zoo, simulator, fused_trace, LensOptimizer, card)
        return 0

    with torch.no_grad():
        fwd_err = phase_forward(torch, zoo, simulator, fused_trace)
    bwd_err = phase_backward(torch, zoo, simulator, fused_trace)
    serve_launches = phase_serve(torch, zoo, simulator, fused_trace, entry)
    train_launches = phase_train(torch, zoo, simulator, fused_trace, LensOptimizer)
    ms, errs, shape = phase_timing(torch, zoo, simulator, fused_trace, LensOptimizer, card)
    print(json.dumps({"kernels": kernel_entries(ms, errs, shape, fwd_err, bwd_err,
                                                serve_launches, train_launches)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
