#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's main path, the double-Gauss lens-evaluation ("serving")
path, through its user entry points on the card, and checks the hand-written
CUDA kernel on that path against its plain PyTorch version:

1. the card's name and power limit;
2. the build of the CUDA kernels from the sources in this checkout;
3. kernel K1 forward against ``trace_fused_reference`` on the card, at
   16 fields x 96^2 pupil rays x 3 wavelengths, plain and Lu modes, both
   backward-ray policies, on the flagship and on a c x 3 lens that fails rays;
4. three requests served by ``simulator.do_ray_tracing`` on the fused engine
   (the flagship and two perturbed designs), each held against the same call
   on the CPU, with the kernel's launch count;
5. timings with CUDA events at 32 fields x 160^2 x 3 (2,457,600 rays).

Every phase prints its findings; any failure exits nonzero. It needs one CUDA
device and exits 1 without one. The last line is a JSON object with the
device; the line before it carries the kernel's numbers.

    python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import time

FULL_WIDTH = dict(n_sampled_fields=16, n_pupil_rings=96)        # 442,368 rays
BENCH_WIDTH = dict(n_sampled_fields=32, n_pupil_rings=160)      # 2,457,600 rays
KERNEL_SOURCE = "torchoptics_tpu_torch/csrc/fused_trace_fwd.cu"
TPU_KERNEL = "torchoptics_tpu/ops/pallas_trace.py:308"
MODES = [(True, True), (True, False), (False, True), (False, False)]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(ok, message):
    print(("ok   " if ok else "FAIL ") + message, flush=True)
    if not ok:
        sys.exit(1)


def k1_errors(got, want, penalties):
    """Mask identity and the largest deviations of kernel outputs from the
    plain version's."""
    import torch
    masks_equal = all(torch.equal(got[i], want[i]) for i in (4, 5))
    ok = want[4]
    rel = lambda a, b: float((((a - b).abs() - 1e-6 * b.abs()) * ok).max())
    err = {
        "xy": max(float(((got[i] - want[i]).abs() * ok).max()) for i in (0, 1)),
        "xy_excess": max(rel(got[i], want[i]) for i in (0, 1)),
        "cxcy": max(float(((got[i] - want[i]).abs() * ok).max()) for i in (2, 3)),
    }
    if penalties:
        err["pen"] = max(float((got[i] - want[i]).abs().max()) for i in (6, 7, 8))
    return masks_equal, err


def phase_kernel_vs_plain(torch, zoo, simulator, fused_trace):
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    **FULL_WIDTH).trace_config()
    specs, lens = zoo.build("double_gauss", device="cuda")
    worst = 0.0
    failed = []
    for label, c_scale in (("double_gauss", 1.0), ("double_gauss c x 3", 3.0)):
        lens_k = lens.replace(c=lens.c * c_scale)
        xp, yp, cyb, z0, mu, (_, F, P, W) = fused_trace.prepare_fused_inputs(
            specs, lens_k, cfg)
        args = (xp, yp, cyb, z0, lens_k.c[0], lens_k.t[0], mu)
        for penalties, allow_backward in MODES:
            got = fused_trace.trace_fused(*args, penalties, allow_backward, F * P)
            want = fused_trace.trace_fused_reference(*args, penalties, allow_backward,
                                                     F * P)
            torch.cuda.synchronize()
            masks_equal, err = k1_errors(got, want, penalties)
            ok = (masks_equal and err["xy_excess"] <= 5e-6 and err["cxcy"] <= 1e-6
                  and err.get("pen", 0.0) <= 1e-5)
            worst = max([worst] + list(v for k, v in err.items() if k != "xy_excess"))
            print(f"{'ok  ' if ok else 'FAIL'} K1 vs plain, {label}, "
                  f"{'Lu' if penalties else 'plain'} mode, allow_backward="
                  f"{allow_backward}, {xp.shape[0]} rays: masks identical={masks_equal}, "
                  f"ray_ok share={float(got[4].float().mean()):.6f}, "
                  f"max |dx|,|dy|={err['xy']:.3e}, max |dcx|,|dcy|={err['cxcy']:.3e}"
                  + (f", max |dpenalty|={err['pen']:.3e}" if penalties else ""), flush=True)
            if not ok:
                failed.append((label, penalties, allow_backward))
    check(not failed, f"phase 3: kernel agrees with its plain version on the card "
                      f"(failed: {failed})")
    return worst


def phase_serve(torch, zoo, simulator, fused_trace, entry):
    """Three requests on the fused engine, through the user entry points.
    Returns the kernel's launch count in that run."""
    specs, lens = zoo.build("double_gauss", device="cuda")
    specs_cpu, lens_cpu = specs.to("cpu"), lens.to("cpu")
    designs = [("flagship", 1.0), ("c x (1 + 1e-3)", 1.0 + 1e-3),
               ("c x (1 - 1e-3)", 1.0 - 1e-3)]
    fn, (c0, t0) = entry.entry("cuda")
    served = []
    fused_trace.K1_FWD_LAUNCHES = 0
    with torch.no_grad():
        for _, scale in designs:
            res, loss = simulator.do_ray_tracing(specs, lens.replace(c=lens.c * scale),
                                                 entry.CONFIG)
            served.append((res, loss))
        lu_entry = fn(c0, t0)
        torch.cuda.synchronize()
    launches = fused_trace.K1_FWD_LAUNCHES
    n_calls = len(designs) + 1
    check(launches == n_calls, f"phase 4: K1 launched {launches} times for "
                               f"{n_calls} fused calls")
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


def phase_timing(torch, zoo, simulator, fused_trace, card):
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    **BENCH_WIDTH).trace_config()
    specs, lens = zoo.build("double_gauss", device="cuda")
    prep = lambda: fused_trace.prepare_fused_inputs(specs, lens, cfg)
    xp, yp, cyb, z0, mu, (_, F, P, W) = prep()
    args = (xp, yp, cyb, z0, lens.c[0], lens.t[0], mu)
    n = xp.shape[0]
    ms = {"front_end": time_ms(torch, prep)}
    for penalties, mode in ((False, "plain"), (True, "lu")):
        kernel = lambda: fused_trace.trace_fused(*args, penalties, True, F * P)
        plain = lambda: fused_trace.trace_fused_reference(*args, penalties, True, F * P)
        ms[f"k1_{mode}"] = time_ms(torch, kernel)
        ms[f"plain_{mode}"] = time_ms(torch, plain)
        masks_equal, err = k1_errors(kernel(), plain(), penalties)
        check(masks_equal and err.get("pen", 0.0) <= 1e-5,
              f"K1 vs plain at {n} rays, {mode} mode: masks identical, {err}")
    ms["spot_rms_fused"] = time_ms(torch, lambda: fused_trace.spot_rms_fused(specs, lens, cfg))
    for key, value in ms.items():
        print(f"time {key}: {value:.4f} ms per call (median of 25 batches of 10) at {n} rays "
              f"({F} fields x {P} pupil x {W} wavelengths), card: {card}", flush=True)
    print(f"K1 forward vs plain PyTorch on the card: plain mode {ms['k1_plain']:.4f} vs "
          f"{ms['plain_plain']:.4f} ms, Lu mode {ms['k1_lu']:.4f} vs "
          f"{ms['plain_lu']:.4f} ms", flush=True)
    return ms


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 1
    from torchoptics_tpu_torch import entry, simulator, zoo
    from torchoptics_tpu_torch.ops import _kernels, fused_trace

    card = card_line()
    print(f"card: {card} (nvidia-smi name, power.limit); "
          f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    start = time.perf_counter()
    path = _kernels.build()
    _kernels.load()
    print(f"build: {path.name} in {time.perf_counter() - start:.2f} s", flush=True)

    with torch.no_grad():
        max_err = phase_kernel_vs_plain(torch, zoo, simulator, fused_trace)
    launches = phase_serve(torch, zoo, simulator, fused_trace, entry)
    with torch.no_grad():
        ms = phase_timing(torch, zoo, simulator, fused_trace, card)

    print(json.dumps({"kernels": [{
        "name": "k1_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": max_err,
        "ms": ms["k1_lu"], "plain_ms": ms["plain_lu"]}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
