#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's paths through their user entry points on the card: the
double-Gauss lens-evaluation ("serving") path, the lens-training path
(``LensOptimizer`` Adam steps), the lens-population path (generator
training through ``OpticalLoss``), the aspheric path (serving and training
the aspherized double-Gauss on kernel K3) and the aspheric-population path
(populations of conic/asphere designs on kernel K4) and the wavefront path
(OPD, Zernike, Strehl, the diffraction PSF and the ``wavefront_rms``
objective on the opl mode of K1-K4) and the imaging path (rendering a
photograph through a lens: PSFs, the SVOLA convolution on kernel P2, the
distortion warp; wide PSFs on P2's FFT route) and imaging training
(``LensOptimizer`` on the rendered image's PSNR and SSIM, through P2's
adjoint, at config 5 and at the default configuration) and the stateful simulator
(``RaytracedOptics``) and the analysis layer (tolerancing, sensitivities,
MTFs, fans, Seidel sums, the vignetting solver, the metrics) and
``parallel/`` (the sharded trace, losses, train step and generator step on
rank groups sharing the card) and the examples (``python -m
torchoptics_tpu_torch.examples.<name>``), runs the
card's issue-rate probe P1, and checks every
hand-written CUDA kernel on them against its plain PyTorch version:

1. the card's name and power limit;
2. the build of the CUDA kernels from the sources in this checkout, with
   each kernel's registers, stack frame and spills from ``-Xptxas -v``;
3. K1 forward against ``trace_fused_reference`` at 16 fields x 96^2 pupil
   rays x 3 wavelengths (442,368 rays), plain, Lu and full modes, both
   backward-ray policies, on the flagship and on a c x 3 lens that fails
   rays; the full mode with tight path and angle bounds so both hinges fire;
   then (3b) K1 forward on each of its routes, every mode (opl included) and
   policy: the double-Gauss and its c x 3 at 2,457,600 rays on the
   11-surface kernel, the Cooke on the 7-surface kernel, a seeded
   64-surface system on the runtime-S kernel, each with odd lanes (NaN,
   1e30, -inf), and K2 at B = 1 equal to K1 there; (3c) the exhaustive
   checks of the trace kernels' exact shortcuts (``div_half_pi``,
   ``sqrt_from_eps``) on every float32 of their domains; and (3d) K2 and
   K4 forward, every mode and policy, unmasked and masked: the Cooke
   populations (256 x 1,536 rays; K2's 7-surface kernel), the padded mixed
   populations (K2's 11-surface kernel), seeded 64-surface populations
   (K2's runtime-S kernel), K4 also at 3 and 1 asphere terms, each with
   odd lanes (NaN, 1e30, -inf), against their plain versions; and their
   resident blocks per SM and waves at the generator width;
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
7. K2 forward and backward against ``trace_fused_batch_reference`` and
   ``trace_fused_batch_backward_reference`` on two populations of 256
   systems at the generator width (8 fields x 8^2 x 3 = 1,536 rays each):
   perturbed Cooke triplets with c x 1.5 on every 8th (plain, Lu and full
   modes) and 128 Cooke + 128 double-Gauss padded to 11 surfaces (plain and
   Lu), both policies; and K2 at B = 1 against K1 on the flagship at
   2,457,600 rays, bit for bit;
8. both populations served by ``do_ray_tracing``, one K2 forward launch each,
   held against the CPU on 8 systems;
9. generator training: the ``train_generator`` example's 2 -> 64 -> 64 ->
   numout MLP (tanh GELU) trained 10 Adam steps on ``OpticalLoss("GAGA",
   spot_metric="xy").unsupervised(engine="fused")`` at B = 256, one K2
   forward and one K2 backward launch per step, the first step held
   against the CPU at B = 8;
10. the full loss of the mixed population (one K2 full-mode launch per lens
    type), held against the CPU on 8 systems;
11. timings with CUDA events: K1 and its plain versions at 2,457,600 rays,
    each kernel also checked against its plain version there, the fwd+bwd
    of ``spot_rms_fused`` and of ``unsupervised_loss_fused`` and a whole
    ``LensOptimizer.step``; K2 and its plain versions at 393,216 rays, the
    fwd+bwd of ``batched_unsupervised_loss`` and a generator step;
12. the aspheric path, on the aspherized double-Gauss (conics on 10 of 11
    surfaces, r^4 and r^6 terms on all): K3 forward against
    ``trace_fused_asphere_reference`` at 442,368 rays, every mode and
    policy, on the lens and on its c x 3 variant, whose failure conditions
    (sag-domain guard, non-convergence, ...) are counted from the plain
    version's locals; masks and coordinates bit-identical;
13. K3 backward against ``trace_fused_asphere_backward_reference`` on the
    same inputs with seeded cotangents: per-ray cotangents bit-identical,
    parameter cotangents within one float32 rounding, two launches bit for
    bit;
14. K3 at kappa = asph = 0 against K1 on the double-Gauss;
15. ``do_ray_tracing`` on the aspherized lens at 3,840 and 2,457,600 rays,
    one K3 forward launch each, the smaller held against the CPU;
16. training: 5 ``LensOptimizer`` steps on the Lu loss and 5 on the full
    loss at 2,457,600 rays with kappa and asph trained, one K3 forward and
    one K3 backward launch per step, the first step held against the CPU;
17. how soon K3's Newton steps repeat on the card at 2,457,600 rays, on
    the aspherized double-Gauss and its c x 3 variant (the kernels leave a
    lane there): steps per lane and per warp, the shares that leave on a
    fixed point, on a 2-cycle and on none, by the plain version's
    arithmetic, which must give the bits of all 10 steps; then timings: K3
    and its plain versions per mode at 2,457,600 rays, with the bounds at
    the steps these inputs need and at 10, and one aspheric
    ``LensOptimizer.step`` on each loss (host clock);
18. the aspheric-population path (kernel K4), at the generator width
    (256 x 1,536 = 393,216 rays): K4 forward and backward against
    ``trace_fused_asphere_batch_reference`` and its backward on the aspheric
    Cooke population (``zoo.aspheric_population``), on its c x 3 variant
    (failure conditions counted) and on the padded mixed population (the
    surface mask), every mode and policy: masks, coordinates and per-ray
    cotangents bit-identical, penalty sums within ``PEN_ROUNDINGS``, each
    system's parameter cotangents within ``ONE_ROUNDING``;
19. K4 at B = 1 against K3 on the aspherized double-Gauss at 2,457,600 rays,
    bit for bit, and K4 at kappa = asph = 0 against K2;
20. the population served by ``do_ray_tracing``, one K4 forward launch,
    held against the CPU on 8 systems;
21. training: 10 Adam steps on the population's (c, t, kappa, asph) against
    ``batched_unsupervised_loss``, one K4 forward and one K4 backward launch
    per step, the first step's gradients held against the CPU on 8 systems;
    the grouped full loss of the mixed population, one K4 full launch per
    lens type, held against the CPU on 8 systems;
22. timings: K4 and its plain versions per mode, the Newton steps a lane
    and a warp run on the timed population, the fwd+bwd of
    ``batched_unsupervised_loss`` and one population step (host clock);
    within phase 21, K4's training path at a fixed bar: the spot term's
    gradients on the defocused aspherized double-Gauss population, card vs
    CPU within 1e-4;
23. the wavefront path (the opl mode of K1-K4, ``ops/wavefront.py``,
    ``analysis.wavefront_rms``): each opl kernel, forward and backward,
    against its plain version, both policies (K1, K3 at 442,368 rays on
    their lens and its c x 3 variant; K2, K4 on two 256-system populations
    at 393,216 rays, one padded), bit for bit but the parameter and dn_legs
    sums (one rounding); K2 and K4 at B = 1 against K1 and K3;
24. serving at the JAX OPL benchmark's width (16 fields x 96^2 x 3 =
    442,368 rays): ``opd_map``, ``zernike_fit`` and ``strehl_ratio`` on the
    double-Gauss and its aspherized form, card vs CPU;
25. the population wavefront (K2 and K4 opl): ``opd_map`` and the fwd+bwd
    of ``wavefront_rms`` on the 256-system Cooke and aspheric Cooke
    populations, card vs CPU on 8 systems;
26. ``diffraction_psf_window`` at the imaging defaults (64^2 pupil grid,
    65 x 65 window at 4 um, oversample 4), TF32 off, card vs CPU;
27. training: 5 Adam steps of ``wavefront_rms`` at 442,368 rays on the
    double-Gauss's (c, t) and the aspherized double-Gauss's (c, asph), two
    opl forward and two backward launches a step, the first step held
    against the CPU; the fwd+bwd of the masked OPL sum w.r.t. (c, t);
28. timings: each opl kernel and its plain versions (K1, K3 at 2,457,600
    rays; K2, K4 at 393,216);
29. the imaging path (BASELINE config 5: the double-Gauss, 9 fields x 24
    rings, 33 x 33 PSFs at 4 um, 5 x 5 patches): kernel P2 (the SVOLA patch
    convolution) against its plain version, bit for bit, on the patches of
    the sample photograph at 1024^2, 256^2 and 2048^2 (K = 11, 3, 23), on
    non-square patches and on a batch of two, and ``svola_patch_conv`` on
    each against its route's plain version (from 23 taps the FFT route's);
    under grad it runs;
30. ``imaging.simulate`` of the photograph at 1024^2 and 256^2 (geometric
    PSFs on K1f, the separable warp): one K1 forward and one P2 launch a
    render, the card's render held against the CPU's; a 256^2 diffraction
    render (K1 opl) held the same way;
31. the issue-rate probe P1: its chains against their plain versions, then
    the FP32 FMA, sqrt and division rates (lane-operations per second) and
    the sqrt and division weights, from which every trace kernel's entry
    gets ``bound_ms_issue`` (its bound at the measured issue rates);
32. timings: P2, its plain version and the torch.fft product at the 1024^2
    shape, and the host wall of a render at 256, 512 and 1024^2, split into
    ``sample_optics_model`` and ``apply_optics_model``;
33. P2 with wide PSFs, which take its FFT route (``csrc/svola_fft.cu``,
    three launches a call; mixed-radix transforms at ``image.fft_len``, the
    reference's fast lengths), bit for bit with the route's plain version: the
    default configuration's (65 x 65 PSFs, 9 x 9 patches) renders at
    1448^2, 2048^2 and 4096^2 (K = 33, 47, 95) and seeded non-square cases
    (kh 47 x kw 29, kh 21 x kw 95), a PSF as large as its patch, five
    channels; the route's forward and d/dpsf kernels also within 1e-5 and
    1e-4 of the largest entry of the float64 torch.fft product and
    correlation (cuFFT's float32 deviation printed beside); whole renders of
    the default configuration at 2048^2 and of config 5 at 4096^2, one K1
    forward and one FFT call each;
34. P2's adjoint through ``svola_patch_conv``'s backward at config 5's
    1024^2 shape (K = 11, the direct kernels), its 2048^2 (K = 23) and the
    default configuration's 2048^2 and 4096^2 (K = 47, 95; the FFT route
    from 23 taps both ways): d/dpsf
    and d/dpatch (P2 on the padded cotangent) bit for bit with their
    routes' plain versions, each route's launches counted; the direct
    d/dpsf kernel alone on seeded shapes (K = 1 to 22, non-square, ragged
    tiles, every kernel of its own and the runtime-kw one), bit for bit;
35. image training, this slice's main path: 5 Adam steps of
    ``LensOptimizer(loss_fn=imaging.make_image_loss_fn(...))`` on the
    double-Gauss defocused by 0.3 mm, config 5 at 1024^2, one K1 forward,
    one K1 backward, one P2 and one d/dpsf launch a step, every step
    accepted; the first step's d/d(c, t) at 256^2 held against the CPU's;
    the host wall of a step at 256^2 and 1024^2;
36. ``RaytracedOptics.do_ray_tracing`` on the Cooke (the zoo's prescription
    dict) on the fused engine, held against the CPU;
37. timings: the direct d/dpsf, its plain version and the torch.fft
    correlation at config 5's 1024^2 shape; the FFT route's forward and
    d/dpsf, their plain versions and the torch.fft calls at K = 33, 47 and
    95, with the route's bound at the fast lengths (``fft_route_bound``, the
    same yardstick for any tree; the power-of-two lengths' beside it) and
    the direct sum's; both routes (the direct
    kernels where they take the PSF) and the torch.fft calls at the renders
    that set the route's thresholds (config 5 at 1024^2, 2048^2, the default
    configuration at 1024^2-4096^2);
38. (after 28) K1b to K4b at ragged shapes, where no warp or block boundary
    falls on a wavelength's: 5 fields x 13^2 pupil rays (845 a wavelength,
    2,535 a system; blocks straddle wavelengths, the last block is partly
    inactive) and 1 x 9^2 (81 a wavelength: three wavelengths in one
    partial block), every mode and policy, on each kernel's lens and c x 3
    variant (K2 and K4 on 32-system populations, also padded and mixed):
    per-ray cotangents and two launches bit for bit, parameter sums within
    each kernel's bar of the plain version's;
39. (after 35) image training at the default configuration, this slice's
    main path: 3 Adam steps at 2048^2 (K = 47), one K1 forward, one K1
    backward, one FFT P2 call and one FFT d/dpsf call (three launches each)
    a step, every step accepted, each step's host wall; the first step's
    d/d(c, t) at 1448^2 (K = 33, the FFT route both ways; config 5's
    deterministic PSF bundle) held against the CPU's; then 2 steps at
    psf_shape (257, 257) (K = 187; S1 over a 257 x 129 half grid, its
    forward the windowed kernels), the same launches a step, loss and
    gradients finite.
40. (after 36) the analysis layer at the README's tolerance width, this
    slice's main path (``analysis.py``, ``ops/metrics.py``,
    ``ops/vignetting.py``; the double-Gauss, 5 fields x 64 pupil points x
    3 wavelengths): ``tolerance_analysis`` of 4096 perturbed samples
    (3,932,160 rays: one K2 Lu launch; refocused, one K2 plain launch
    more) and ``sensitivities`` (one K2 forward and one backward), the same
    on the aspherized double-Gauss with kappa and asphere tolerances on K4,
    each held against the unroll engine on the card; ``through_focus_mtf``
    (9 shifts, one K2 plain launch), ``field_mtf`` (one K1 launch), both
    also at psf_shape (257, 257), ``diffraction_mtf`` (grid 32, pad 4: two K1 opl launches),
    ``solve_vignetting`` (Tessar and double-Gauss, n_scan 129), the Seidel
    sums, fans, field curves, longitudinal aberration and the five metrics,
    each held against the CPU; each call's launches counted from 0 and its
    host wall (median of 5).
41. (after 40) ``parallel/`` on ``torch.distributed``, this slice's main
    path: the kernel library built first (by this process), the
    single-process results on the card, then rank groups that share the
    card, each spawned by ``parallel.mesh.spawn``: 1 rank (NCCL), 2 ranks
    (gloo, lens 1 x rays 2) and 4 ranks (gloo, 2 x 2). Every rank checks
    ``all_reduce`` and ``broadcast`` of CUDA tensors; ``sharded_trace_rays``
    of the double-Gauss at 2,457,600 rays (K1 forward, one launch a rank;
    x and y within 5e-6 mm of the single-process trace, ``ray_ok``
    bit-identical); ``sharded_fused_losses``, full and Lu, value and
    d/d(c, t[, kappa, asph]), on the 256-system double-Gauss (K2) and
    aspheric Cooke (K4) populations at 256 x 1,536 rays (values rtol 2e-5,
    the world-summed gradients rtol 1e-3, atol 1e-6); 3
    ``make_sharded_train_step`` steps (full loss) against 3 single-process
    ``LensOptimizer`` steps (total rtol 1e-5, params rtol 1e-4, atol 1e-6,
    bit-identical across ranks); one ``OpticalLoss.unsupervised(mesh=...)``
    generator step at B = 256; each call's launches on the rank. The
    step and trace walls of every rank beside the single process's.
42. (after 41) the examples, this slice's main path: each of
    ``torchoptics_tpu_torch/examples/``'s eight newcomers run through its
    ``main(argv)`` at its default widths, only the step counts cut
    (``EXAMPLE_RUNS``: ``optimize_lens`` 3 steps, and 2 on the full loss;
    ``refine_flagship`` 3 steps and a 2-step polish, at population 24 and
    as a population of one with ``--aspherize``; ``train_generator`` 3
    steps at batch 32 and 64 scored designs; ``optimize_through_image`` 2
    steps at 96^2; ``optimize_wavefront`` 3 steps; ``simulate_aberrations``
    at 128^2 with both PSF sources and at ``--psf-size 257``;
    ``flagship_report`` with vignetting;
    ``aberration_report``), each on ``--engine fused`` and ``--engine
    unroll``: every run's kernel launches counted from 0 by kernel entry,
    the trace kernels' by the template mode each launch ran (the fused
    run's as ``EXAMPLE_RUNS`` predicts, the unroll run's those of P2
    alone), the launches per step measured as a fused run at ``--steps`` +
    1 less the run at ``--steps``, each run's host wall, and the two runs'
    printed numbers held within each number's bar (1e-5 relative on
    losses, 5e-6 mm on coordinates, the wavefront and MTF bars of the
    coordinate bar's move, the Strehl ratios' bar from the OPD gap between
    the engines measured on the examples' lenses and grids, that gap held
    at the wavefront phases' 5e-5 mm) plus its printed resolution.
43. (after 42) kernel S1, the PSF splat (``csrc/psf_splat_fwd.cu``, its
    adjoint ``csrc/psf_splat_bwd.cu``): first its tensor-core probe
    (``csrc/psf_splat_probe.cu``: mma.sync m8n8k4 and m16n8k4 .f64 bit for
    bit with the fma chain in k order, which S1's float32 products rely
    on), the card's FP64 rates (DFMA and both shapes) and S1's registers
    and spills; then forward and adjoint against their
    plain versions, bit for bit, one launch each a call: on the default
    configuration's own splat (the double-Gauss traced on K1: 21 fields x 3
    channels, a 65 x 33 half grid, 65,536 rays), W = 4 with one-hot weights
    (d/dweights too; also at psf 257), an even and a non-square grid, the
    auto extent (increment=None: d/dgx, d/dgy, d/dsigma), a NaN ray, an inf
    ray, float64, rays no multiple of the chunk, half grids above the former
    ceiling of 129 x 65 (``SPLAT_WIDE``: 130 x 65 to 513 x 257, 300 x 7 and
    7 x 300, float32 and float64, with and without weights, per-bin sums
    and d/dw; the windowed forward forced at 65 x 33, where the dense one
    runs, and the dense one at 257 x 129; at 257 x 129 rays at the windows'
    edges, inf, NaN and off-grid rays, a NaN and an inf in a cotangent, an
    inf weight, sigma of 3 bins, descending centres, a hot spot, windows
    ending at the forward's tiles' edges, sigma of the grid) and the
    default configuration's splat at psf_shape (257, 257); ``compute_psf``
    on CUDA tensors under grad launches S1 both ways and no plain version;
    S1, its plain versions and the PyTorch contractions (TF32 off) timed at
    the default configuration's splat at psf 65 and 257; the default
    configuration's 2048^2 render and image-loss ``LensOptimizer.step`` at
    psf 65 and 257, and its 4096^2 render at psf 129
    (``SPLAT_MEMORY_RUNS``): peak device memory, host walls (median of 5),
    the largest allocations (resize_bilinear's within twice its largest
    operand; at psf 257 the step's peak at most 12 GB and no allocation
    above 1.5 GB).
44. (after 43) P2's FFT route past its longest transform: the default
    configuration's 4096^2 render with one PSF (6,238-pixel patches, K =
    95), the route (``image._p2``, ``image._p2_dpsf``) cut into
    sub-patches (``image.fft_tiles``) bit for bit with its plain versions
    and within the FFT bars of float64 torch.fft, at a lowered cut of 2048
    (4 x 4 pieces) and at the route's own (2 x 2); its times; the render,
    its launches counted (three FFT launches a piece) and its host wall.

Every phase prints its findings; any failure exits nonzero. It needs one CUDA
device and exits 1 without one. The last line is a JSON object with the
device; the line before it is the card's name and power limit, and the line
before that carries the kernels' numbers.

    python3 chip_smoke.py             # the run described above
    python3 chip_smoke.py --profile   # instead: torch.profiler breakdowns of
                                      # LensOptimizer.step at 2,457,600 rays
                                      # (double-Gauss and aspherized), of a
                                      # generator step, of an aspheric
                                      # population step, of a
                                      # wavefront_rms step at 442,368 rays,
                                      # of a 1024^2 render and of an
                                      # image-loss step at 256^2 and
                                      # 1024^2
    python3 chip_smoke.py --render-walls  # instead: phase 32's render walls
                                          # alone (no result line)
    python3 chip_smoke.py --kernel-turns TREE...  # instead: K1 to K4,
                                          # every mode, K2b's splits, P2 at
                                          # config 5's four render shapes
                                          # and P2 and d/dpsf by each tree's
                                          # route at the wide ones, and S1
                                          # both ways at the default
                                          # configuration's splat at psf 65
                                          # and 257 beside its PyTorch
                                          # contractions, and the adjoint's
                                          # instantiations at psf 65 and
                                          # 129 (S1_BWD_VARIANTS), each on
                                          # its tree's route, of each
                                          # unpacked tree and of this
                                          # checkout, timed in turns (trees,
                                          # this, this, trees in reverse; no
                                          # result line); --families k2,p2
                                          # (of k1,k2,k3,k4,p2,s1) times only
                                          # those
    python3 chip_smoke.py --ragged        # instead: phase 38 alone
    python3 chip_smoke.py --population-routes  # instead: phase 3d alone
    python3 chip_smoke.py --build-times TREE...  # instead: the kernel
                                          # library's build time of each
                                          # unpacked tree and of this
                                          # checkout, one after another
    python3 chip_smoke.py --p2-fft        # instead: the FFT route's checks
                                          # and both routes' times at the
                                          # crossover renders (no result line)
    python3 chip_smoke.py --default-image-training  # instead: phase 39
    python3 chip_smoke.py --fft-cut       # instead: phase 44 alone
    python3 chip_smoke.py --analysis      # instead: phase 40 alone (no
                                          # result line)
    python3 chip_smoke.py --parallel      # instead: phase 41 alone (no
                                          # result line)
    python3 chip_smoke.py --examples      # instead: phase 42 alone, with
                                          # each run's printout (no result
                                          # line)
    python3 chip_smoke.py --splat         # instead: phase 43 alone (no
                                          # result line)
    python3 chip_smoke.py --s1-crossover  # instead: S1 forward's dense
                                          # and windowed kernels forced, in
                                          # turns, at the default
                                          # configuration's splat at each
                                          # psf size of S1_CROSSOVER_SIZES
                                          # (no result line)
    python3 chip_smoke.py --splat-memory TREE...  # instead: phase 43's
                                          # memory, walls and profile of
                                          # SPLAT_MEMORY_RUNS (2048^2 render
                                          # and step at psf 65 and 257,
                                          # 4096^2 render at psf 129), of
                                          # each unpacked tree and of this
                                          # checkout, in turns (trees, this,
                                          # this, trees in reverse)
"""

import collections
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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
# The same with the upper glass bound at 3.5 for a comparison of the card
# with the CPU: the Cooke's own glass gap is 3.0, and its rays near the axis
# sit on that hinge's kink, where the card's and the CPU's roundings of
# cumsum(t) pick different sides of it.
TIGHT_OFF_KINK = dict(TIGHT, ray_path_upper_thresholds=(None, 3.5, 40.0))
# The population path: 256 designs at the reference's generator-loss width,
# 8 fields x 8x8 circular pupil x 3 wavelengths = 1,536 rays each.
N_SYSTEMS = 256
GEN_WIDTH = dict(n_sampled_fields=8, n_pupil_rings=8, pupil_sampling="circular",
                 n_ray_aiming_iter=1, wavelengths=(459.0, 520.0, 640.0))
K2_FWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_batch_fwd.cu"
K2_BWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_batch_bwd.cu"
TPU_K2_FWD = "torchoptics_tpu/ops/pallas_batch.py:66"
TPU_K2_BWD = "torchoptics_tpu/ops/pallas_batch.py:182"
K3_FWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_asphere_fwd.cu"
K3_BWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_asphere_bwd.cu"
TPU_K3_FWD = "torchoptics_tpu/ops/pallas_asphere.py:367"
TPU_K3_BWD = "torchoptics_tpu/ops/pallas_asphere.py:479"
K4_FWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_asphere_batch_fwd.cu"
K4_BWD_SOURCE = "torchoptics_tpu_torch/csrc/fused_asphere_batch_bwd.cu"
TPU_K4_FWD = "torchoptics_tpu/ops/pallas_asphere.py:963"
TPU_K4_BWD = "torchoptics_tpu/ops/pallas_asphere.py:1075"
# The H100's published float32 (non-tensor) and memory rates.
PEAK_FLOPS = 67e12
TRAINABLE = ("c", "t", "g", "kappa", "asph")
PEAK_BYTES = 3.35e12
# A penalty sum of the card within 8 float32 roundings of its largest value;
# a parameter cotangent within one rounding of the plain version's float64
# sum (both relative to the largest magnitude).
PEN_ROUNDINGS = 8 * 2.0 ** -23
ONE_ROUNDING = 2.0 ** -23
# Bytes per ray: the inputs read once and the outputs written once.
FWD_BYTES = {False: 30, True: 42, "full": 50}
BWD_BYTES = {False: 40, True: 52, "full": 60}


#: A kernel's floating-point operations per ray (``total``, each sqrt,
#: division and acosf counted as one) and, of them, its IEEE square roots,
#: divisions and acosf, which the issue bounds weight by P1's rates, and the
#: square roots and divisions by pi / 2 that the trace kernels take by their
#: exact shortcuts (``fast_sqrt``: sqrt_from_eps, ``fast_div``: div_half_pi
#: in trace_common.cuh), which they weight by the shortcuts' instructions.
OpCounts = collections.namedtuple("OpCounts", "total sqrt div acos fast_sqrt fast_div",
                                  defaults=(0, 0))
#: Instructions a shortcut issues: sqrt_from_eps a MUFU.RSQ, two FMUL and two
#: FFMA; div_half_pi an FMUL and two FFMA.
FAST_SQRT_ISSUES, FAST_DIV_ISSUES = 5, 3


def _transcendentals(penalties, n_surf, backward, sqrt_surf, div_surf):
    """(sqrt, division, acosf) per ray from a family's per-surface sqrt and
    divisions: per ray, the launch's cz (1 sqrt) and the image transfer (1
    division), the backward 2 sqrt and 5 divisions; Lu and full modes, two
    theta_norm a surface (sqrt, acosf, a division each), backward their
    adjoints (2 sqrt and a division each)."""
    acos = 0
    if penalties in (True, "full"):
        sqrt_surf += 2 + (4 if backward else 0)
        div_surf += 2 + (2 if backward else 0)
        acos = 2
    per_ray = (2, 5) if backward else (1, 1)
    return n_surf * sqrt_surf + per_ray[0], n_surf * div_surf + per_ray[1], n_surf * acos


def k1_ops(penalties, n_surf, n_sides, backward):
    """Floating-point operations per ray that K1 forward or backward needs,
    read off the kernels' code (see the notes in csrc/): adds, multiplies,
    min/max, and each sqrt, division and acosf counted as one; compares and
    selects not counted. ``n_sides``: the finite sides of the path bounds,
    over all gaps (full mode). Of them, per surface, from
    trace_common.cuh: cos_theta, cos_theta' and cz (3 sqrt, by
    sqrt_from_eps), the marching distance (1 division), and backward the
    surface adjoint's 5 divisions; the rest as ``_transcendentals``, except
    that the forward's two theta_norm a surface take the surface step's roots
    and divide by pi / 2 by div_half_pi (theta_norm_root)."""
    lu, full = penalties in (True, "full"), penalties == "full"
    sq, dv, ac = _transcendentals(penalties, n_surf, backward, 0, 1 + (5 if backward else 0))
    fast_div = 2 * n_surf if lu and not backward else 0
    sq_dv_ac = (sq - fast_div, dv - fast_div, ac, 3 * n_surf, fast_div)
    if not backward:
        # 55 per surface, launch and image transfer 8; Lu: two theta_norm
        # and three sums, 14; full: angle hinges 6, path deltas and sum 4,
        # 3 per finite side.
        return OpCounts(55 * n_surf + 8 + (14 * n_surf if lu else 0)
                        + (10 * n_surf - 1 + 3 * n_sides if full else 0), *sq_dv_ac)
    # The forward once (without its penalty sums), the surface adjoint 104
    # and the three parameter sums (dc, dt, dmu) per surface; launch, image
    # and dz0 terms 19 per ray. Lu: the relu and two theta_norm adjoints, 20;
    # full: the hinge gradients 4 per gap plus 1 per finite side, their dz
    # and dref_z terms 4, the angle hinges 4.
    return OpCounts(162 * n_surf + 19 + (20 * n_surf if lu else 0)
                    + (12 * n_surf - 2 + n_sides if full else 0), *sq_dv_ac)


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
                # The kernel sums the parameter terms in double in another
                # order than the plain version's float64 sums.
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


# K1 forward's routes (csrc/fused_trace_fwd.cu SHORT_SURF and its runtime-S
# kernel): (label, prescription or None for the seeded 64-surface system, c
# scale, width). The double-Gauss (11 surfaces) and its c x 3 at the main
# path's 2,457,600 rays, the Cooke (7) at 442,368 rays, 64 surfaces (MAX_SURF,
# the runtime-S kernel) at 3 x 65,536 rays.
K1_ROUTE_CASES = (("double_gauss", "double_gauss", 1.0, BENCH_WIDTH),
                  ("double_gauss c x 3", "double_gauss", 3.0, BENCH_WIDTH),
                  ("cooke", "cooke", 1.0, FULL_WIDTH),
                  ("64 surfaces", None, 1.0, None))
K1_MODES = (False, True, "full", "opl")


def k1_route_inputs(torch, zoo, simulator, fused_trace, name, c_scale, width):
    """K1's inputs for one of ``K1_ROUTE_CASES``: (xp, yp, cy, z0, c, t, mu),
    ref_z, n_legs (seeded indices in [1, 1.8], one a leg and wavelength),
    n_per_w, the path bounds and cos^2 of the angle threshold. The first 8
    rays are replaced by odd lanes: NaN pupil coordinates and directions, a
    ray at 1e30 or -inf, directions at the edge of the launch's domain. The
    64-surface system: weak seeded curvatures, 0.5 mm gaps, glass and air
    alternating, 3 wavelengths of 65,536 rays, every gap bounded to (0.1,
    5.0)."""
    gen = np.random.default_rng(64)
    if name is None:
        n_surf, n_w, n_per_w = 64, 3, 65536
        n = n_w * n_per_w
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
        xp, yp = (f32(gen.uniform(-1.0, 1.0, n)) for _ in range(2))
        cyb = f32(gen.uniform(-0.05, 0.05, n))
        z0 = f32(-1.0)
        c = f32(gen.normal(0.0, 0.01, n_surf))
        t = f32(np.full(n_surf, 0.5))
        index = 1.5 + 0.01 * np.arange(n_w) / n_w
        legs = np.where(np.arange(n_surf + 1)[:, None] % 2 == 1, index, 1.0)
        mu = f32(legs[:-1] / legs[1:])
        bounds = ((0.1, 5.0),) * n_surf
        thr = math.cos(math.radians(TIGHT["ray_angle_threshold"])) ** 2
    else:
        cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                        **width).trace_config()
        specs, lens = zoo.build(name, device="cuda")
        lens = lens.replace(c=lens.c * c_scale)
        with torch.no_grad():
            xp, yp, cyb, z0, mu, (_, F, P, W) = fused_trace.prepare_fused_inputs(specs, lens,
                                                                                 cfg)
        n_per_w, n_surf, n_w = F * P, lens.c.shape[1], W
        c, t = lens.c[0].detach(), lens.t[0].detach()
        bounds = fused_trace._path_bounds(lens.structure, TIGHT["ray_path_lower_thresholds"],
                                          TIGHT["ray_path_upper_thresholds"])
        thr = math.cos(math.radians(TIGHT["ray_angle_threshold"])) ** 2
    xp, yp, cyb = (a.detach().clone().contiguous() for a in (xp, yp, cyb))
    odd = torch.tensor
    xp[:8] = odd([math.nan, 0.0, 1e30, -math.inf, 0.5, 0.0, math.nan, 3.0], device="cuda")
    yp[:8] = odd([0.0, math.nan, 0.0, 0.0, -0.5, 1e-30, 0.0, -3.0], device="cuda")
    cyb[:8] = odd([0.0, 0.0, 0.0, 0.0, 0.9999999, 1.0, math.nan, -0.99999], device="cuda")
    vertex_z = torch.cumsum(t, 0)
    ref_z = torch.cat((vertex_z, vertex_z[-1:]))
    n_legs = torch.tensor(gen.uniform(1.0, 1.8, (n_surf + 1, n_w)).astype(np.float32),
                          device="cuda")
    base = (xp, yp, cyb, z0.reshape(()), c.contiguous(), t.contiguous(), mu.contiguous())
    return base, ref_z, n_legs, n_per_w, bounds, thr


def same_bits(a, b):
    """Equal, NaN where the other is NaN."""
    import torch
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def k1_route_compare(torch, fused_trace, fused_batch, inputs, penalties, allow_backward):
    """K1 forward on ``k1_route_inputs``'s inputs in one mode and policy
    against its plain version, and K2 at B = 1 without a mask against K1.
    Returns {"bits": masks, coordinates and the opl bit for bit (NaN lanes
    alike), "pen_nan": the Lu and full sums NaN where the plain version's
    are, "pen": their largest deviation (theta_norm's sums on every lane, a
    NaN cos2 counting 1 in both; relu(z) and the hinges past the odd lanes:
    the kernel's fmaxf drops a NaN, torch.clamp keeps it), "k2_same": K2
    equal to K1, "launches": K1 forward's launches, "got": K1's outputs}."""
    base, ref_z, n_legs, n_per_w, bounds, thr = inputs
    extra = (ref_z,) if penalties == "full" else (n_legs,) if penalties == "opl" else ()
    one = tuple(a.reshape(1) if i == 3 else a[None] for i, a in enumerate(base + extra))
    args = (penalties, allow_backward, n_per_w, bounds, thr)
    before = fused_trace.K1_FWD_LAUNCHES
    with torch.no_grad():
        got = fused_trace._launch_k1_fwd(base + extra, *args)
        want = fused_trace.trace_fused_reference(*base, penalties, allow_backward, n_per_w,
                                                 ref_z, bounds, thr, n_legs=n_legs)
        k2 = fused_batch._launch_k2_fwd(one, *args[:3], None, *args[3:])
    torch.cuda.synchronize()
    exact = 7 if penalties == "opl" else 6
    pen, pen_nan = 0.0, True
    lu = penalties in (True, "full")
    for j, (a, b) in enumerate(zip(got[6:], want[6:]) if lu else ()):
        a, b = (a, b) if j < 2 else (a[8:], b[8:])
        pen_nan = pen_nan and torch.equal(torch.isnan(a), torch.isnan(b))
        pen = max(pen, float((a - b).abs().nan_to_num(0.0).max()))
    return {"bits": all(same_bits(a, b) for a, b in zip(got[:exact], want[:exact])),
            "pen_nan": pen_nan, "pen": pen,
            "k2_same": all(same_bits(a, b[0]) for a, b in zip(got, k2)),
            "launches": fused_trace.K1_FWD_LAUNCHES - before, "got": got}


def phase_k1_routes(torch, zoo, simulator, fused_trace, fused_batch):
    """K1 forward on each of its routes (``K1_ROUTE_CASES``): every mode
    (plain, Lu, full, opl), both backward-ray policies, against its plain
    version, and K2 at B = 1 against K1 (``k1_route_compare``): masks,
    coordinates and the opl bit for bit, the Lu and full sums within 1e-5
    (the plain version's division by pi / 2 is torch's). Then the exhaustive
    checks of div_half_pi (every float32 in [2^-100, 4) divided by pi / 2 as
    the IEEE division does) and sqrt_from_eps (sqrtf's bits from 2^-100 to
    +inf, NaN on NaN). Returns the largest penalty deviations per kernel
    entry ('k1_fwd' = plain and Lu, 'k1_fwd_full')."""
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    worst = {"k1_fwd": 0.0, "k1_fwd_full": 0.0}
    failed = []
    for label, name, c_scale, width in K1_ROUTE_CASES:
        inputs = k1_route_inputs(torch, zoo, simulator, fused_trace, name, c_scale, width)
        n, n_surf = inputs[0][0].shape[0], inputs[0][4].shape[0]
        route = f"{n_surf}-surface kernel" if lib.k1_fwd_specialized(n_surf) else "runtime-S kernel"
        for penalties in K1_MODES:
            for allow_backward in (True, False):
                r = k1_route_compare(torch, fused_trace, fused_batch, inputs, penalties,
                                     allow_backward)
                key = "k1_fwd_full" if penalties == "full" else "k1_fwd"
                worst[key] = max(worst[key], r["pen"])
                ok = r["bits"] and r["pen_nan"] and r["pen"] <= 1e-5 and r["k2_same"]
                print(f"{'ok  ' if ok else 'FAIL'} K1 forward route, {label} ({n_surf} surfaces, "
                      f"{route}), {penalties if penalties == 'opl' else MODE_NAME[penalties]} "
                      f"mode, allow_backward={allow_backward}, {n} rays: masks, coordinates"
                      f"{' and opl' if penalties == 'opl' else ''} bit-identical (NaN lanes "
                      f"alike)={r['bits']}, ray_ok share {float(r['got'][4].float().mean()):.6f}"
                      + (f", max |dpenalty| {r['pen']:.3e} (bar 1e-5)"
                         if penalties in (True, "full") else "")
                      + f"; K2 at B = 1 equal to K1={r['k2_same']}", flush=True)
                if not ok:
                    failed.append((label, penalties, allow_backward))
    check(not failed, f"phase 3b: K1 forward's routes (7, 11, runtime-S at 64 surfaces) agree "
          f"with the plain version, K2 at B = 1 with K1 (failed: {failed})")
    mismatches = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    start = time.perf_counter()
    err = lib.k1_exact_checks(mismatches.data_ptr(), stream)
    torch.cuda.synchronize()
    took = time.perf_counter() - start
    n_div, n_sqrt = 0x40800000 - 0x0D800000, 0x80000000 - 0x0D800000
    bad = mismatches.tolist()
    check(err == 0 and bad == [0, 0],
          f"phase 3c: exhaustive checks on the card ({took * 1e3:.1f} ms): div_half_pi "
          f"(theta_norm's division by pi / 2 in K1f to K4f) equals the IEEE division on all "
          f"{n_div:,} float32 in [2^-100, 4), mismatches {bad[0]}; sqrt_from_eps (the surface "
          f"step's roots in K1 to K4, forward and backward) equals sqrtf on all {n_sqrt:,} "
          f"float32 from 2^-100 to +inf and NaN (NaN on NaN), mismatches {bad[1]}")
    return worst


# K2 forward's routes (csrc/fused_batch_fwd.cu's SHORT_SURF and its
# runtime-S kernel) and K4 forward's shapes (its one kernel a term count):
# (label, population, K4's asphere terms). 'cooke': K2's Cooke population
# (c x 1.5 on every 8th system, 7 surfaces) and K4's aspheric Cooke
# population (7 surfaces, K = 2); 'mixed': 128 Cooke + 128 double-Gauss
# padded to 11 surfaces, spherical and aspheric; None: a seeded population
# of 32 systems of 64 surfaces (K2's runtime-S kernel); K4 also at K = 3 on
# the aspheric Cooke population and at K = 1 on the 64-surface one. Each case
# runs unmasked and masked: the padded population with its own mask, the
# others with a seeded one.
POP_ROUTE_CASES = (("cooke", "cooke", 2), ("mixed", "mixed", 2), ("64 surfaces", None, 2),
                   ("cooke, K = 3", "cooke", 3), ("64 surfaces, K = 1", None, 1))
POP_ROUTE_K2 = ("cooke", "mixed", "64 surfaces")
#: Each family's bar on its penalty sums, relative to their largest (the
#: bars of phases 7 and 18).
POP_PEN_BAR = {"k2": 1e-6, "k4": PEN_ROUNDINGS}


def pop_route_inputs(torch, zoo, simulator, fused_trace, fused_batch, kernel, name, n_asph):
    """K2's or K4's (``kernel``) inputs for one of ``POP_ROUTE_CASES``: the
    (B, N) rays and the system tables (K2: xp, yp, cy, z0, c, t, mu; K4:
    xp, yp, cy, z0, c, kappa, t, mu, asph), ref_z, n_legs (seeded indices in
    [1, 1.8]), n_per_w, the masks to run ((label, mask or None) pairs), the
    path bounds and cos^2 of the angle threshold. System 0's first 8 rays
    are odd lanes, as ``k1_route_inputs``'s."""
    gen = np.random.default_rng(65 + n_asph)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    thr = math.cos(math.radians(TIGHT["ray_angle_threshold"])) ** 2
    if name is None:
        n_sys, n_surf, n_w, n_per_w = 32, 64, 3, 512
        shape = (n_sys, n_w * n_per_w)
        xp, yp = (f32(gen.uniform(-1.0, 1.0, shape)) for _ in range(2))
        cyb = f32(gen.uniform(-0.05, 0.05, shape))
        z0 = f32(np.full(n_sys, -1.0))
        c = f32(gen.normal(0.0, 0.01, (n_sys, n_surf)))
        t = f32(np.full((n_sys, n_surf), 0.5))
        index = 1.5 + 0.01 * np.arange(n_w) / n_w
        legs = np.where(np.arange(n_surf + 1)[:, None] % 2 == 1, index, 1.0)
        mu = f32(np.broadcast_to(legs[:-1] / legs[1:], (n_sys, n_surf, n_w)))
        kappa = f32(gen.uniform(-0.3, 0.1, (n_sys, n_surf)))
        asph = f32(gen.uniform(-1, 1, (n_sys, n_surf, n_asph))
                   * np.asarray([1e-5, 1e-8][:n_asph]))
        bounds, real = ((0.1, 5.0),) * n_surf, None
    elif kernel == "k2":
        _, lens, ins, n_per_w, real, _, thr = population_inputs(torch, zoo, simulator,
                                                                fused_batch, fused_trace, name)
        xp, yp, cyb, z0, c, t, mu = (a.detach() for a in ins[:7])
        # The widest system's bounds, as k4_inputs takes them.
        widest = np.array([int(np.argmax(lens.structure.n_surfaces))])
        bounds = fused_trace._path_bounds(lens[widest].structure,
                                          TIGHT["ray_path_lower_thresholds"],
                                          TIGHT["ray_path_upper_thresholds"])
    else:
        ins, n_per_w, real, bounds, thr = k4_inputs(torch, zoo, simulator, fused_batch,
                                                    fused_trace, name)
        xp, yp, cyb, z0, c, kappa, t, mu, asph = ins[:9]
        if n_asph > asph.shape[2]:
            extra = gen.uniform(-1, 1, asph.shape[:2] + (n_asph - asph.shape[2],)) * 1e-11
            asph = torch.cat((asph, f32(extra)), 2)
    n_sys, n_surf, n_w = c.shape[0], c.shape[1], mu.shape[2]
    xp, yp, cyb = (a.clone().contiguous() for a in (xp, yp, cyb))
    odd = torch.tensor
    xp[0, :8] = odd([math.nan, 0.0, 1e30, -math.inf, 0.5, 0.0, math.nan, 3.0], device="cuda")
    yp[0, :8] = odd([0.0, math.nan, 0.0, 0.0, -0.5, 1e-30, 0.0, -3.0], device="cuda")
    cyb[0, :8] = odd([0.0, 0.0, 0.0, 0.0, 0.9999999, 1.0, math.nan, -0.99999], device="cuda")
    vertex_z = torch.cumsum(t, 1)
    ref_z = torch.cat((vertex_z, vertex_z[:, -1:]), 1)
    n_legs = f32(gen.uniform(1.0, 1.8, (n_sys, n_surf + 1, n_w)))
    if real is None:
        seeded = gen.random((n_sys, n_surf)) > 0.15
        seeded[:, 0] = True
        masks = (("unmasked", None), ("seeded mask", torch.tensor(seeded, device="cuda")))
    else:
        masks = (("unmasked", None), ("padded mask", real))
    base = ((xp, yp, cyb, z0, c, t, mu) if kernel == "k2"
            else (xp, yp, cyb, z0, c, kappa, t, mu, asph))
    return (tuple(a.contiguous() for a in base), ref_z.contiguous(), n_legs, n_per_w, masks,
            bounds, thr)


def pop_route_compare(torch, modules, kernel, inputs, mask, penalties, allow_backward):
    """K2 or K4 forward on ``pop_route_inputs``'s inputs with ``mask`` in one
    mode and policy against its plain version: {"bits": masks, coordinates
    and the opl bit for bit (NaN lanes alike), "pen_nan": the Lu and full
    sums NaN where the plain version's are, "pen": their largest deviation
    relative to their largest magnitude (theta_norm's sums on every lane;
    relu(z) and the hinges past each system's first 8 rays: the kernel's
    fmaxf drops a NaN, torch.clamp keeps it), "launches", "got"}."""
    _, fused_batch, fused_asphere = modules
    base, ref_z, n_legs, n_per_w, _, bounds, thr = inputs
    extra = (ref_z,) if penalties == "full" else (n_legs,) if penalties == "opl" else ()
    args = (penalties, allow_backward, n_per_w)
    with torch.no_grad():
        if kernel == "k2":
            before = fused_batch.K2_FWD_LAUNCHES
            got = fused_batch._launch_k2_fwd(base + extra, *args, mask, bounds, thr)
            launches = fused_batch.K2_FWD_LAUNCHES - before
            want = fused_batch.trace_fused_batch_reference(*base, *args, mask, ref_z, bounds,
                                                           thr, n_legs=n_legs)
        else:
            before = fused_asphere.K4_FWD_LAUNCHES
            got = fused_asphere._launch_k4_fwd(base + extra, *args, 10, mask, bounds, thr)
            launches = fused_asphere.K4_FWD_LAUNCHES - before
            want = fused_asphere.trace_fused_asphere_batch_reference(
                *base, *args, 10, mask, ref_z, bounds, thr, n_legs=n_legs)
    torch.cuda.synchronize()
    exact = 7 if penalties == "opl" else 6
    pen, pen_nan = 0.0, True
    lu = penalties in (True, "full")
    for j, (a, b) in enumerate(zip(got[6:], want[6:]) if lu else ()):
        a, b = (a, b) if j < 2 else (a[:, 8:], b[:, 8:])
        pen_nan = pen_nan and torch.equal(torch.isnan(a), torch.isnan(b))
        scale = float(b.abs().nan_to_num(0.0).max().clamp(min=1e-30))
        pen = max(pen, float((a - b).abs().nan_to_num(0.0).max()) / scale)
    return {"bits": all(same_bits(a, b) for a, b in zip(got[:exact], want[:exact])),
            "pen_nan": pen_nan, "pen": pen, "launches": launches, "got": got}


def population_occupancy(torch, lib):
    """K2 and K4 forward's resident blocks per SM (the occupancy calculator's,
    ``k2_fwd_blocks_per_sm``, ``k4_fwd_blocks_per_sm``) per mode and mask
    flag, backward rays allowed, K2 on its 7- and 11-surface kernels, K4 at
    K = 2, and the waves their launch at the generator width (256 systems x
    1,536 rays) takes on this card's SMs: {kernel: {"<mode> <S> <unmasked|
    masked>": (rays a block, blocks per SM, waves)}} (K4's key without S)."""
    import ctypes
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    block = ctypes.c_int()
    out = {"k2": {}, "k4": {}}
    for mode, label in enumerate(("plain", "lu", "full", "opl")):
        for masked in (0, 1):
            flag = "masked" if masked else "unmasked"
            found = {f"{label} {n_surf} {flag}": ("k2", lib.k2_fwd_blocks_per_sm(
                mode, 1, masked, n_surf, ctypes.byref(block)), block.value) for n_surf in (7, 11)}
            found[f"{label} {flag}"] = ("k4", lib.k4_fwd_blocks_per_sm(
                mode, 1, masked, 2, ctypes.byref(block)), block.value)
            for key, (kernel, per_sm, threads) in found.items():
                blocks = N_SYSTEMS * -(-1536 // threads)
                out[kernel][key] = (threads, per_sm,
                                    blocks / (per_sm * sms) if per_sm > 0 else None)
    return out


def phase_population_routes(torch, zoo, simulator, modules):
    """K2 and K4 forward on each of their routes (``POP_ROUTE_CASES``): every
    mode (plain, Lu, full, opl), both backward-ray policies, unmasked and
    masked, against their plain versions (``pop_route_compare``): masks,
    coordinates and the opl bit for bit (NaN lanes alike), the Lu and full
    sums within ``POP_PEN_BAR``; one launch each. Then each kernel's
    resident blocks per SM and waves at the generator width
    (``population_occupancy``). Returns the largest penalty deviations per
    kernel entry and the occupancy."""
    fused_trace, fused_batch, _ = modules
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    worst = {"k2_fwd": 0.0, "k2_fwd_full": 0.0, "k4_fwd": 0.0, "k4_fwd_full": 0.0}
    failed = []
    for kernel in ("k2", "k4"):
        for label, name, n_asph in POP_ROUTE_CASES:
            if kernel == "k2" and label not in POP_ROUTE_K2:
                continue
            inputs = pop_route_inputs(torch, zoo, simulator, fused_trace, fused_batch, kernel,
                                      name, n_asph)
            n_sys, n = inputs[0][0].shape
            n_surf = inputs[0][4].shape[1]
            if kernel == "k4":
                route = f"its {n_asph}-term kernel"
            else:
                route = ("its runtime-S kernel" if not lib.k2_fwd_specialized(n_surf)
                         else f"its {n_surf}-surface kernel")
            for mask_label, mask in inputs[4]:
                for penalties in K1_MODES:
                    for allow_backward in (True, False):
                        r = pop_route_compare(torch, modules, kernel, inputs, mask, penalties,
                                              allow_backward)
                        key = f"{kernel}_fwd_full" if penalties == "full" else f"{kernel}_fwd"
                        worst[key] = max(worst[key], r["pen"])
                        ok = (r["bits"] and r["pen_nan"] and r["pen"] <= POP_PEN_BAR[kernel]
                              and r["launches"] == 1)
                        mode = penalties if penalties == "opl" else MODE_NAME[penalties]
                        print(f"{'ok  ' if ok else 'FAIL'} {kernel.upper()} forward route, "
                              f"{label} ({n_sys} x {n} rays, {n_surf} surfaces, {route}), "
                              f"{mask_label}, {mode} mode, allow_backward={allow_backward}: "
                              f"masks, coordinates{' and opl' if penalties == 'opl' else ''} "
                              f"bit-identical (NaN lanes alike)={r['bits']}, ray_ok share "
                              f"{float(r['got'][4].float().mean()):.6f}"
                              + (f", penalty sums within {r['pen']:.2e} of their largest "
                                 f"(bar {POP_PEN_BAR[kernel]:.2e})"
                                 if penalties in (True, "full") else ""), flush=True)
                        if not ok:
                            failed.append((kernel, label, mask_label, penalties, allow_backward))
            del inputs
    check(not failed, f"phase 3d: K2 forward's routes (7, 11 surfaces, runtime-S at 64) and K4 "
          f"forward at 7, 11 and 64 surfaces and 1-3 asphere terms agree with their plain "
          f"versions (failed: {failed})")
    occupancy = population_occupancy(torch, lib)
    check(all(per_sm > 0 for table in occupancy.values() for _, per_sm, _ in table.values()),
          f"phase 3d: every population forward kernel has resident blocks ({occupancy})")
    for kernel, table in occupancy.items():
        print(f"occupancy {kernel.upper()} forward (rays a block, blocks per SM, waves at 256 x "
              f"1,536 rays on {torch.cuda.get_device_properties(0).multi_processor_count} SMs): "
              + "; ".join(f"{key} {threads}, {per_sm}, {waves:.3f}" for key, (threads, per_sm, waves)
                          in table.items()), flush=True)
    return worst, occupancy


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


def make_optimizer(zoo, simulator, LensOptimizer, device, width, use_full_loss,
                   name="double_gauss"):
    """The flagship (or the zoo lens ``name``) with its glasses moved 2e-3
    off the catalog (a design in progress: exactly on a catalog glass the
    glass penalty's gradient is NaN, in the JAX package too, and every
    full-loss step would be rejected), at its own EFL."""
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    trace_engine="fused", **width)
    specs, lens = zoo.build(name, device=device)
    lens = lens.replace(nd=lens.nd + 2e-3)
    # Every variable the lens carries is trained (conics and asphere terms too).
    opt = LensOptimizer(specs=specs, config=cfg, learning_rate=1e-4,
                        use_full_loss=use_full_loss, efl_target=float(lens.efl[0]),
                        trainable=TRAINABLE)
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


def time_ms(torch, fn, runs=25, batch=10, warmup=3, queue_ahead=False):
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``batch`` back-to-back calls, divided by ``batch``; the median of
    ``runs`` such batches. Back to back, a kernel's time is not padded by the
    host's time to enqueue it, unless the host is the slower of the two: a
    kernel shorter than its Python wrapper (K2 at the generator width) is
    timed with ``queue_ahead``, where a sleep kernel of ~20 ms holds the
    stream while the host enqueues the batch, so the events see the device's
    time alone (a 2 ms sleep ran out before a slow host had enqueued K2's
    full mode)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(40_000_000)
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


def profile_steps(torch, label, step, card, n_steps=3):
    """Where one step's time goes: the device's busy time by kernel group
    from torch.profiler over ``n_steps`` steps (after 2 warm-up steps),
    against the host clock. Returns (wall ms, busy ms, {group: ms}) a
    step."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
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
        group = ("K4 forward" if "k4_fwd_kernel" in name else
                 "K4 backward" if "k4_bwd_kernel" in name else
                 "K1 forward" if "k1_fwd_kernel" in name else
                 "K1 backward" if "k1_bwd_kernel" in name else
                 "K3 forward" if "k3_fwd_kernel" in name else
                 "K3 backward" if "k3_bwd_kernel" in name else
                 "K2 forward" if "k2_fwd_kernel" in name else
                 "K2 backward" if "k2_bwd_kernel" in name else
                 "kernel parameter sums" if "partials_reduce" in name else
                 "P2 (SVOLA patch convolution)" if "p2_svola_kernel" in name else
                 "P2 d/dpsf" if "p2_dpsf" in name else
                 "P2 FFT route, rows forward" if "fft_rows_fwd" in name else
                 "P2 FFT route, columns" if "fft_cols" in name else
                 "P2 FFT route, rows inverse" if "fft_rows_inv" in name else
                 "S1 forward (PSF splat)" if "s1_fwd" in name else
                 "S1 adjoint" if "s1_bwd" in name else
                 "Adam" if ("adam" in name.lower() or "multi_tensor" in name) else
                 "reductions" if "reduce" in name.lower() else "front-end and other")
        groups[group] = groups.get(group, 0.0) + dev_us / 1e3 / n_steps
    busy = sum(groups.values())
    print(f"profile: {label}: host wall {wall:.3f} ms per step, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f} %), {n_kernels / n_steps:.0f} device operations per "
          f"step; card: {card}", flush=True)
    for group, value in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile:   {group}: {value:.4f} ms per step", flush=True)
    for value, count, name in sorted(kernels, reverse=True)[:12]:
        print(f"profile:     {value:.4f} ms, {count:.0f} launches: {name[:90]}", flush=True)
    return wall, busy, groups


def phase_profile(torch, zoo, simulator, fused_trace, LensOptimizer, OpticalLoss, card):
    """A LensOptimizer step at 2,457,600 rays on each loss (double-Gauss and
    aspherized), a generator step and an aspheric population step at 256 x
    1,536 rays, under torch.profiler."""
    for full in (False, True):
        opt, state = make_optimizer(zoo, simulator, LensOptimizer, "cuda", BENCH_WIDTH, full)
        holder = [state]

        def step():
            holder[0] = opt.step(holder[0])[0]
        profile_steps(torch, f"LensOptimizer.step on the {'full' if full else 'Lu'} loss at "
                      "2457600 rays", step, card)
    profile_steps(torch, f"generator step at {N_SYSTEMS} x 1536 rays",
                  generator_step(torch, OpticalLoss), card)
    for full in (False, True):
        opt, state = make_optimizer(zoo, simulator, LensOptimizer, "cuda", BENCH_WIDTH, full,
                                    "double_gauss_asph")
        holder = [state]

        def step():
            holder[0] = opt.step(holder[0])[0]
        profile_steps(torch, f"aspheric LensOptimizer.step on the {'full' if full else 'Lu'} "
                      "loss at 2457600 rays", step, card)
    from torchoptics_tpu_torch.ops import fused_batch
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused")
    specs, lens = k4_population(torch, zoo, "cooke")
    profile_steps(torch, f"aspheric population step (Adam on c, t, kappa, asph) at {N_SYSTEMS} x "
                  "1536 rays", k4_train_step(torch, fused_batch, specs, lens, cfg), card)
    for name, params in (("double_gauss", ("c", "t")), ("double_gauss_asph", ("c", "asph"))):
        profile_steps(torch, f"wavefront_rms Adam step on the {name} {params} at 442368 rays",
                      wavefront_optimizer(torch, zoo, name, params, "cuda", OPL_CONFIG), card)
    from torchoptics_tpu_torch import imaging
    cfg = imaging_config(simulator)
    specs, lens = zoo.build("double_gauss", device="cuda")
    radiance = torch.tensor(photograph(1024)[None], device="cuda")
    profile_steps(torch, "render of the sample photograph at 1024^2 (config 5, simulate)",
                  lambda: render(torch, imaging, specs, lens, radiance, cfg), card)
    for px in IMAGE_TRAIN_SIZES:
        opt, state = image_optimizer(torch, zoo, simulator, imaging, LensOptimizer, "cuda", px)
        holder = [state]

        def step():
            holder[0] = opt.step(holder[0])[0]
        profile_steps(torch, f"image-loss LensOptimizer.step at {px}^2 (config 5, double-Gauss "
                      "defocused 0.3 mm)", step, card)


# ---------------------------------------------------------------------------
# The population path: kernel K2 and generator training.
# ---------------------------------------------------------------------------


def population_inputs(torch, zoo, simulator, fused_batch, fused_trace, name):
    """The (B, N) kernel inputs of a 256-system population at the generator
    width: 'cooke' (c x 1.5 on every 8th system, so that rays fail) or
    'mixed' (128 Cooke + 128 double-Gauss, padded to 11 surfaces). Returns
    (specs, lens, inputs with ref_z, n_per_w, mask, bounds, thr)."""
    if name == "cooke":
        specs, lens = zoo.population("cooke", N_SYSTEMS, device="cuda")
        scale = torch.ones(N_SYSTEMS, 1, device="cuda")
        scale[::8] = 1.5
        lens = lens.replace(c=lens.c * scale)
    else:
        specs, lens = zoo.mixed_population(N_SYSTEMS, device="cuda")
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(
            specs, lens, simulator.SimulatorConfig(**GEN_WIDTH).trace_config())
    vertex_z = torch.cumsum(lens.t, 1)
    ref_z = torch.cat((vertex_z, vertex_z[:, -1:]), 1)
    bounds = fused_trace._path_bounds(lens.structure, TIGHT["ray_path_lower_thresholds"],
                                      TIGHT["ray_path_upper_thresholds"])
    thr = math.cos(math.radians(TIGHT["ray_angle_threshold"])) ** 2
    inputs = (xp, yp, cyb, z0, lens.c, lens.t, mu, ref_z)
    return (specs, lens, inputs, F * P, fused_batch._static_mask(lens.structure, "cuda"),
            bounds, thr)


def run_k2_fwd(fused_batch, inputs, penalties, allow_backward, n_per_w, mask, bounds, thr,
               plain):
    ins = inputs if penalties == "full" else inputs[:7]
    if plain:
        return fused_batch.trace_fused_batch_reference(*ins[:7], penalties, allow_backward,
                                                       n_per_w, mask, inputs[7], bounds, thr)
    return fused_batch._launch_k2_fwd(ins, penalties, allow_backward, n_per_w, mask, bounds, thr)


def run_k2_bwd(fused_batch, inputs, cot, penalties, allow_backward, n_per_w, mask, bounds, thr,
               plain):
    ins = inputs if penalties == "full" else inputs[:7]
    if plain:
        return fused_batch.trace_fused_batch_backward_reference(
            ins, cot, penalties, allow_backward, n_per_w, mask, bounds, thr)
    return fused_batch._launch_k2_bwd(ins, cot, penalties, allow_backward, n_per_w, mask,
                                      bounds, thr)


def k2_fwd_errors(torch, got, want):
    """(masks and coordinates bit-identical, largest penalty deviation
    relative to each penalty's largest magnitude, largest absolute deviation
    of any float output)."""
    exact = all(torch.equal(got[i], want[i]) for i in range(6))
    floats = [i for i in range(len(got)) if i not in (4, 5)]
    pen_rel = max([float((got[i] - want[i]).abs().max() / want[i].abs().max().clamp(min=1e-30))
                   for i in range(6, len(got))] + [0.0])
    return exact, pen_rel, max(float((got[i] - want[i]).abs().max()) for i in floats)


def k2_bwd_errors(torch, got, want):
    """(per-ray deviation, largest per-system parameter deviation relative to
    that system's largest parameter cotangent, largest absolute parameter
    deviation)."""
    ray = max(float((got[i] - want[i]).abs().max()) for i in range(3))
    rows = lambda grads: torch.cat([g.reshape(g.shape[0], -1) for g in grads[3:]], 1)
    g, w = rows(got), rows(want)
    per_system = (g - w).abs().max(1).values / w.abs().max(1).values.clamp(min=1e-30)
    return ray, float(per_system.max()), float((g - w).abs().max())


def phase_k2_kernels(torch, zoo, simulator, fused_batch, fused_trace):
    """K2 forward and backward against their plain versions on both
    256-system populations, every mode and backward-ray policy; two backward
    launches bit for bit. Returns the largest deviations."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = dict(fwd=0.0, fwd_full=0.0, bwd_ray=0.0, bwd_param=0.0, bwd_param_abs=0.0)
    failed = []
    for name, modes in (("cooke", PENALTY_MODES), ("mixed", (False, True))):
        _, lens, inputs, n_per_w, mask, bounds, thr = population_inputs(
            torch, zoo, simulator, fused_batch, fused_trace, name)
        n_rays = inputs[0].numel()
        inputs = tuple(a.detach() for a in inputs)
        for penalties in modes:
            for allow_backward in (True, False):
                args = (inputs, penalties, allow_backward, n_per_w, mask, bounds, thr)
                with torch.no_grad():
                    got = run_k2_fwd(fused_batch, *args, plain=False)
                    want = run_k2_fwd(fused_batch, *args, plain=True)
                torch.cuda.synchronize()
                exact, pen_rel, max_abs = k2_fwd_errors(torch, got, want)
                key = "fwd_full" if penalties == "full" else "fwd"
                worst[key] = max(worst[key], max_abs)
                cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
                       for _ in range({False: 4, True: 7, "full": 9}[penalties])]
                bargs = (inputs, cot) + args[1:]
                g1 = run_k2_bwd(fused_batch, *bargs, plain=False)
                g2 = run_k2_bwd(fused_batch, *bargs, plain=False)
                gw = run_k2_bwd(fused_batch, *bargs, plain=True)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(g1, g2))
                finite = all(bool(torch.isfinite(a).all()) for a in g1)
                ray, param, param_abs = k2_bwd_errors(torch, g1, gw)
                worst["bwd_ray"] = max(worst["bwd_ray"], ray)
                worst["bwd_param"] = max(worst["bwd_param"], param)
                worst["bwd_param_abs"] = max(worst["bwd_param_abs"], param_abs)
                ok = exact and pen_rel <= 1e-6 and same and finite and ray == 0.0 and param <= 2e-6
                print(f"{'ok  ' if ok else 'FAIL'} K2 vs plain, {name} population "
                      f"({N_SYSTEMS} x {inputs[0].shape[1]} rays, {lens.c.shape[1]} surfaces"
                      f"{', masked' if mask is not None else ''}), {MODE_NAME[penalties]} mode, "
                      f"allow_backward={allow_backward}: forward masks and coordinates "
                      f"bit-identical={exact}, penalty sums within {pen_rel:.2e} (limit 1e-06); "
                      f"backward per-ray deviation {ray:.3e}, per-system parameter cotangents "
                      f"within {param:.2e} (limit 2e-06), two launches bit-identical={same}; "
                      f"ray_ok share {float(got[4].float().mean()):.6f}", flush=True)
                if not ok:
                    failed.append((name, penalties, allow_backward))
        del inputs
    check(not failed, f"K2 agrees with its plain versions on {n_rays} rays (failed: {failed})")
    return worst


def phase_k2_is_k1(torch, zoo, simulator, fused_trace, fused_batch):
    """K2 on a population of one, the flagship at 2,457,600 rays, against K1:
    every output of the forward and the backward, bit for bit."""
    inputs, n_per_w, bounds, thr = kernel_inputs(torch, zoo, simulator, fused_trace,
                                                 BENCH_WIDTH)
    one = tuple(a.reshape(1) if i == 3 else a[None] for i, a in enumerate(inputs))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for penalties in PENALTY_MODES:
        k1 = run_fwd(fused_trace, inputs, penalties, True, n_per_w, bounds, thr, plain=False)
        k2 = run_k2_fwd(fused_batch, one, penalties, True, n_per_w, None, bounds, thr,
                        plain=False)
        cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
               for _ in range({False: 4, True: 7, "full": 9}[penalties])]
        g1 = run_bwd(fused_trace, inputs, cot, penalties, True, n_per_w, bounds, thr,
                     plain=False)
        g2 = run_k2_bwd(fused_batch, one, [c[None] for c in cot], penalties, True, n_per_w,
                        None, bounds, thr, plain=False)
        torch.cuda.synchronize()
        same_f = all(torch.equal(a, b[0]) for a, b in zip(k1, k2))
        same_b = all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(g1, g2))
        check(same_f and same_b,
              f"K2 at B = 1 on the flagship, {inputs[0].shape[0]} rays, "
              f"{MODE_NAME[penalties]} mode: forward equal to K1 bit for bit={same_f}, "
              f"backward (per-ray and parameter cotangents)={same_b}")


def phase_population_serve(torch, zoo, simulator, fused_trace, fused_batch):
    """``do_ray_tracing`` on the fused engine for both populations under
    no_grad: one K2 forward launch per call and no K1 launch; each held
    against the same call on the CPU on 8 systems (rows 0-7 of the Cooke
    population; rows 0-3 and 252-255 of the mixed one, which keep its
    padding). Returns the K2 forward launches of the run."""
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused")
    pops = {}
    for name in ("cooke", "mixed"):
        specs, lens = population_inputs(torch, zoo, simulator, fused_batch, fused_trace, name)[:2]
        pops[name] = (specs, lens.detach())
    fused_trace.K1_FWD_LAUNCHES = 0
    fused_batch.K2_FWD_LAUNCHES = 0
    fused_batch.K2_BWD_LAUNCHES = 0
    served = {}
    with torch.no_grad():
        for name, (specs, lens) in pops.items():
            served[name] = simulator.do_ray_tracing(specs, lens, cfg)
        torch.cuda.synchronize()
    launches = fused_batch.K2_FWD_LAUNCHES
    check(launches == 2 and fused_batch.K2_BWD_LAUNCHES == 0
          and fused_trace.K1_FWD_LAUNCHES == 0,
          f"population serving: K2 forward launched {launches} times for 2 calls, K2 backward "
          f"{fused_batch.K2_BWD_LAUNCHES}, K1 {fused_trace.K1_FWD_LAUNCHES}")
    tol = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4}
    for name, (specs, lens) in pops.items():
        res, loss = served[name]
        rows = np.arange(8) if name == "cooke" else np.r_[0:4, N_SYSTEMS - 4:N_SYSTEMS]
        with torch.no_grad():
            _, on_card = simulator.do_ray_tracing(specs[rows], lens[rows], cfg)
            _, on_cpu = simulator.do_ray_tracing(specs[rows].to("cpu"), lens[rows].to("cpu"),
                                                 cfg)
        rel = {k: abs(float(on_card[k]) - float(on_cpu[k])) / abs(float(on_cpu[k]))
               for k in tol}
        shape = (N_SYSTEMS, GEN_WIDTH["n_sampled_fields"], GEN_WIDTH["n_pupil_rings"] ** 2, 3)
        check(tuple(res.x.shape) == shape
              and bool(torch.isfinite(res.x[res.ray_ok]).all())
              and all(math.isfinite(float(v)) for v in loss.values())
              and all(rel[k] <= tol[k] for k in tol),
              f"{name} population served: {shape} result, ray_ok share "
              f"{float(res.ray_ok.float().mean()):.6f}, loss_unsup "
              f"{float(loss['loss_unsup']):.6f}; on 8 systems CUDA vs CPU relative gaps "
              + ", ".join(f"{k} {rel[k]:.2e} (limit {tol[k]:.0e})" for k in tol))
    return launches


class Generator:
    """The generator of the ``train_generator`` example
    (``models.generator``): its network (``GeneratorMLP``, 2 -> 64 -> 64 ->
    numout, the tanh GELU) from lens
    specs (EPD, HFOV) to design vectors, scaled by 0.1 about its base
    design (``generate``, ``base_design``), the weights drawn from
    ``seed``."""

    def __init__(self, torch, ol, seed, device):
        from torchoptics_tpu_torch.models import generator
        self.net = generator.GeneratorMLP((2, 64, 64, ol.numout),
                                          torch.Generator().manual_seed(seed), device)
        self.base = generator.base_design(ol, device)
        self.params = list(self.net.parameters())
        self.generate = generator.generate

    def __call__(self, inputs):
        return self.generate(self.net, inputs, self.base)


def sample_specs(torch, gen, n, device):
    """Seeded spec draws in the generator example's ranges (its
    ``sample_specs``): EPD in [0.15, 0.35], HFOV in [0.2, 0.45] rad."""
    from torchoptics_tpu_torch.models import generator
    return generator.sample_specs(gen, n, device)


def generator_loss(ol, net, inputs):
    return ol.unsupervised(inputs, net(inputs), stop_idx=1, engine="fused")[0]


def generator_step(torch, OpticalLoss):
    """A closure that runs one step of generator training at B = 256, from
    seeded weights and seeded spec draws."""
    ol = OpticalLoss("GAGA", spot_metric="xy")
    net = Generator(torch, ol, 0, "cuda")
    opt = torch.optim.Adam(net.params, lr=1e-3)
    spec_gen = torch.Generator(device="cuda").manual_seed(5)

    def step():
        loss = generator_loss(ol, net, sample_specs(torch, spec_gen, N_SYSTEMS, "cuda"))
        for p, g in zip(net.params, torch.autograd.grad(loss, net.params)):
            p.grad = g
        opt.step()
    return step


def phase_generator(torch, fused_batch, OpticalLoss, n_steps=10):
    """Generator training, the main path of this slice: 10 Adam steps at
    B = 256, one K2 forward and one K2 backward launch per step, non-finite
    steps skipped and counted; the first step's loss and MLP gradients held
    against the CPU at B = 8 with the same weights. Returns the launches and
    the step count."""
    ol = OpticalLoss("GAGA", spot_metric="xy")
    # The first step on the card against the CPU, B = 8, the same weights.
    first = {}
    for key, device in (("card", "cuda"), ("host", "cpu")):
        net = Generator(torch, ol, 0, device)
        inputs = sample_specs(torch, torch.Generator(device="cpu").manual_seed(1), 8, "cpu")
        loss = generator_loss(ol, net, inputs.to(device))
        grads = torch.autograd.grad(loss, net.params)
        first[key] = (float(loss.detach()), [g.cpu() for g in grads])
    rel = abs(first["card"][0] - first["host"][0]) / abs(first["host"][0])
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(first["card"][1], first["host"][1]))
    check(rel <= 1e-5 and grad_rel <= 1e-4,
          f"first generator step at B = 8, CUDA vs CPU: loss {first['card'][0]:.7f} vs "
          f"{first['host'][0]:.7f} (relative gap {rel:.2e}, limit 1e-05), MLP gradients within "
          f"{grad_rel:.2e} of their largest magnitude (limit 1e-04)")

    net = Generator(torch, ol, 0, "cuda")
    opt = torch.optim.Adam(net.params, lr=1e-3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fused_batch.K2_FWD_LAUNCHES = 0
    fused_batch.K2_BWD_LAUNCHES = 0
    losses, skipped = [], 0
    for _ in range(n_steps):
        loss = generator_loss(ol, net, sample_specs(torch, gen, N_SYSTEMS, "cuda"))
        grads = torch.autograd.grad(loss, net.params)
        # As the example does: a non-finite step applies zero gradients.
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                    for g in grads)
        skipped += not finite
        for p, g in zip(net.params, grads):
            p.grad = g if finite else torch.zeros_like(g)
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    fwd, bwd = fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES
    check(fwd == n_steps and bwd == n_steps and skipped < n_steps,
          f"generator training: {n_steps} Adam steps on OpticalLoss('GAGA', 'xy') at "
          f"B = {N_SYSTEMS} ({N_SYSTEMS * 1536} rays): K2 forward launched {fwd} times, K2 "
          f"backward {bwd} times; {n_steps - skipped} steps accepted, {skipped} skipped; losses "
          f"{['%.5f' % v for v in losses]}")
    return fwd, bwd


def phase_mixed_full_loss(torch, zoo, simulator, fused_trace, fused_batch):
    """The full loss of the mixed population on the fused engine: one K2
    full-mode launch per lens type, forward and backward; value and
    d/d(c, t) held against the CPU on 8 systems of both types. Returns the
    launches."""
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused", **TIGHT_OFF_KINK)
    specs, lens = population_inputs(torch, zoo, simulator, fused_batch, fused_trace, "mixed")[:2]
    lens = lens.detach()

    def value_and_grad(specs, lens):
        c = lens.c.clone().requires_grad_(True)
        t = lens.t.clone().requires_grad_(True)
        total, _ = simulator.compute_losses(specs, lens.replace(c=c, t=t), cfg)
        return float(total.detach()), torch.autograd.grad(total, (c, t))

    fused_batch.K2_FWD_LAUNCHES = 0
    fused_batch.K2_BWD_LAUNCHES = 0
    total, grads = value_and_grad(specs, lens)
    torch.cuda.synchronize()
    fwd, bwd = fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES
    check(fwd == 2 and bwd == 2 and math.isfinite(total)
          and all(bool(torch.isfinite(g).all()) for g in grads),
          f"mixed-sequence full loss of {N_SYSTEMS} systems: K2 full forward launched {fwd} "
          f"times, backward {bwd} times (one per lens type); total {total:.6f}")
    rows = np.r_[0:4, N_SYSTEMS - 4:N_SYSTEMS]
    got = value_and_grad(specs[rows], lens[rows])
    want = value_and_grad(specs[rows].to("cpu"), lens[rows].to("cpu"))
    mask = torch.as_tensor(lens[rows].structure.mask)
    rel = abs(got[0] - want[0]) / abs(want[0])
    grad_rel = max(float(torch.where(mask, (a.cpu() - b).abs(), 0.0).max()
                         / torch.where(mask, b.abs(), 0.0).max())
                   for a, b in zip(got[1], want[1]))
    check(rel <= 1e-5 and grad_rel <= 1e-4,
          f"mixed full loss on 8 systems, CUDA vs CPU: {got[0]:.7f} vs {want[0]:.7f} (relative "
          f"gap {rel:.2e}, limit 1e-05), d/d(c, t) on real surfaces within {grad_rel:.2e} of "
          f"the largest (limit 1e-04)")
    return fwd, bwd


def phase_k2_timing(torch, zoo, simulator, fused_trace, fused_batch, OpticalLoss, card):
    """K2 and its plain versions at the generator width (256 x 1,536 =
    393,216 rays, Cooke population), the fwd+bwd of
    ``batched_unsupervised_loss``, and one generator step (host clock)."""
    specs, lens, inputs, n_per_w, mask, bounds, thr = population_inputs(
        torch, zoo, simulator, fused_batch, fused_trace, "cooke")
    lens = lens.detach()
    inputs = tuple(a.detach() for a in inputs)
    n_rays, n_surf = inputs[0].numel(), inputs[4].shape[1]
    shape = dict(n_rays=n_rays, n_surf=n_surf, n_w=inputs[6].shape[2], bounds=bounds,
                 n_sys=N_SYSTEMS, rays_per_sys=inputs[0].shape[1])
    gen = torch.Generator(device="cuda").manual_seed(4)
    ms = {}
    with torch.no_grad():
        for penalties in PENALTY_MODES:
            mode = MODE_NAME[penalties]
            fwd = lambda plain: run_k2_fwd(fused_batch, inputs, penalties, True, n_per_w, mask,
                                           bounds, thr, plain)
            ms[f"k2_fwd_{mode}"] = time_ms(torch, lambda: fwd(False), queue_ahead=True)
            ms[f"plain_k2_fwd_{mode}"] = time_ms(torch, lambda: fwd(True), runs=5, batch=2)
            cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
                   for _ in range({False: 4, True: 7, "full": 9}[penalties])]
            bwd = lambda plain: run_k2_bwd(fused_batch, inputs, cot, penalties, True, n_per_w,
                                           mask, bounds, thr, plain)
            ms[f"k2_bwd_{mode}"] = time_ms(torch, lambda: bwd(False), queue_ahead=True)
            ms[f"plain_k2_bwd_{mode}"] = time_ms(torch, lambda: bwd(True), runs=5, batch=2)
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused")

    def fwd_bwd():
        c = lens.c.detach().clone().requires_grad_(True)
        t = lens.t.detach().clone().requires_grad_(True)
        loss = fused_batch.batched_unsupervised_loss(specs, lens.replace(c=c, t=t), cfg)[0]
        torch.autograd.grad(loss, (c, t))
    ms["batched_unsupervised_loss_fwd_bwd"] = time_ms(torch, fwd_bwd, runs=5, batch=4)
    ms["generator_step"] = host_ms(torch, generator_step(torch, OpticalLoss))
    for key, value in ms.items():
        print(f"time {key}: {value:.4f} ms per call at {n_rays} rays ({N_SYSTEMS} systems x "
              f"1,536 rays, {n_surf} surfaces), card: {card}", flush=True)
    return ms, shape


def k2_bound(shape, penalties, backward):
    """(bound_ms, bound_by) of K2 forward or backward at the timed shape: K1's
    per-ray operations and bytes at the population's surface count, plus
    each system's tables read once (2 S + S W + 1 floats, + S + 1 in full
    mode) and, for the backward, its partials (one column of doubles per
    block of 256 rays, written once and read once)."""
    n, n_surf, n_w, n_sys = shape["n_rays"], shape["n_surf"], shape["n_w"], shape["n_sys"]
    n_sides = sum(math.isfinite(v) for gap in shape["bounds"] for v in gap)
    ops = k1_ops(penalties, n_surf, n_sides, backward).total
    full = penalties == "full"
    tables = 4 * (2 * n_surf + n_surf * n_w + 1 + (n_surf + 1 if full else 0))
    if not backward:
        return bound(n, ops, FWD_BYTES[penalties], n_sys * tables)
    n_params = 1 + 2 * n_surf + n_surf * n_w + (n_surf + 1 if full else 0)
    blocks = -(-shape["rays_per_sys"] // 256)
    return bound(n, ops, BWD_BYTES[penalties], n_sys * (tables + 16 * n_params * blocks))


def kernel_bound(shape, penalties, backward):
    """(bound_ms, bound_by) of K1 forward or backward at the timed shape."""
    n, n_surf = shape["n_rays"], shape["n_surf"]
    n_sides = sum(math.isfinite(v) for gap in shape["bounds"] for v in gap)
    ops = k1_ops(penalties, n_surf, n_sides, backward).total
    if not backward:
        return bound(n, ops, FWD_BYTES[penalties])
    # Plus the partials: one column of doubles per block of 256 rays,
    # written once and read once.
    n_params = (1 + 2 * n_surf + n_surf * shape["n_w"]
                + (n_surf + 1 if penalties == "full" else 0))
    return bound(n, ops, BWD_BYTES[penalties], 16 * n_params * -(-n // 256))


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


def k2_entries(ms, shape, err, serve_launches, gen_launches, mixed_launches):
    """The K2 entries of the kernels line. ``launches`` counts the main path
    of this slice, generator training (Lu mode; the full mode's from the
    mixed-sequence full loss); each entry's main numbers are for that mode,
    the other modes' under their own keys. K2 backward's parameter deviation
    is per system, relative to its largest parameter cotangent."""
    def numbers(kind, penalties, suffix=""):
        mode = MODE_NAME[penalties]
        b_ms, b_by = k2_bound(shape, penalties, kind == "bwd")
        return {f"ms{suffix}": ms[f"k2_{kind}_{mode}"],
                f"plain_ms{suffix}": ms[f"plain_k2_{kind}_{mode}"],
                f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by}
    return [
        {"name": "k2_fwd", "route": "cuda", "source": K2_FWD_SOURCE, "replaces": TPU_K2_FWD,
         "launches": gen_launches[0], "max_abs_err": err["fwd"], **numbers("fwd", True),
         "library_ms": None, "launches_serving": serve_launches,
         **numbers("fwd", False, "_plain")},
        {"name": "k2_fwd_full", "route": "cuda", "source": K2_FWD_SOURCE,
         "replaces": TPU_K2_FWD, "launches": mixed_launches[0], "max_abs_err": err["fwd_full"],
         **numbers("fwd", "full"), "library_ms": None},
        {"name": "k2_bwd", "route": "cuda", "source": K2_BWD_SOURCE, "replaces": TPU_K2_BWD,
         "launches": gen_launches[1], "max_abs_err": err["bwd_ray"], **numbers("bwd", True),
         "library_ms": None, "launches_full_loss": mixed_launches[1],
         "param_max_abs_err": err["bwd_param_abs"], "param_max_rel_err": err["bwd_param"],
         **numbers("bwd", False, "_plain"),
         **numbers("bwd", "full", "_full"),
         "batched_unsupervised_loss_fwd_bwd_ms": ms["batched_unsupervised_loss_fwd_bwd"],
         "generator_step_ms": ms["generator_step"]},
    ]


# ---------------------------------------------------------------------------
# The aspheric path: kernel K3 on the aspherized double-Gauss.
# ---------------------------------------------------------------------------


def k3_ops(penalties, n_surf, n_asph, n_iter, backward, n_sides=0, no_period=1.0):
    """Floating-point operations per ray that K3 forward or backward needs,
    with ``n_iter`` Newton steps a lane-surface: the kernels leave a lane
    once its steps repeat, so the bounds take the mean that their inputs
    need (``newton_statistics``), and 10, the fixed count, beside it; of the
    lane-surfaces, the share ``no_period`` runs all its steps without a
    repeat (1 at the fixed count);
    counted from the kernels' source notes under ``k1_ops``'s rules (FP32
    arithmetic; a sqrt or a division as one; negations, fabsf, compares and
    selects not counted), each value once: the surface constants
    (1+kappa)c^2 and a_j (j+2), and in the backward c (1+kappa)c^2, c^3 and
    a_j (j+2)(j+1), once per ray and surface, not at each of the 13 sag
    evaluations; a power of r^2 or a local that the kernels compute twice
    (the backward's Newton-point sag terms, its own power chains), once; a
    result nothing reads (the sag at the hit and Snell points, the sag's
    partials there), not at all. K = n_asph >= 1, as the kernels require.

    Per surface the forward is the constants (3 + K), the sphere guess
    (26), ``n_iter`` Newton steps (26 + 5 K each: 18 for F, F' and the step,
    8 + 5 K for the sag and its slope), the polish step (2), whose F and F'
    are the last Newton step's where a lane leaves on a repeat (the kernels
    hand them on) and new (24 + 5 K) on the share ``no_period``, the hit
    point (29 + 3 K: 4 + 3 K for its slope, then the normal and cos^2) and
    Snell's law (31): the Snell point's slope and normal (10 + 3 K) are the
    hit point's on a live ray and read by nothing the forward writes on a
    dead one (the forward kernels take the hit point's); the backward adds
    them, which its adjoint reads on every lane, the constants (3 + K), the
    adjoint chain through Snell's law, the hit point and the polish step
    (163), the sag partials (20 at the Newton point, 10 at each of the hit
    and Snell points, and 2 K - 1 for the asphere terms of dg/dr^2 at each),
    the asphere cotangents (10 K) and one add per ray for each of the 4 + K
    parameter sums. The launch, image and penalty terms are K1's.

    Of them, per surface, from asphere_common.cuh: the sphere guess (1 sqrt,
    2 divisions), each Newton step (the sag's w, its slope g = c/(2w) and
    the sag, and the step F/F': 1 sqrt, 3 divisions), the polish (its step,
    1 division; on the share ``no_period`` its F and F', 1 sqrt and 2
    divisions), the slope at the hit point (w and g) with its normal's
    1/sqrt, and Snell's three square roots: n_iter + 6 + no_period sqrt,
    every one by sqrt_from_eps, and 3 n_iter + 5 + 2 no_period divisions;
    the backward adds the Snell point's slope and normal (2 sqrt, 2
    divisions), 1 sqrt (by
    sqrt_from_eps) and 2 divisions (the Newton point's sag terms) and 8
    divisions: the sag partials, which share one reciprocal of w and one of
    1 + w (2 at the Newton point, 1 at each of the hit and Snell points), and
    the chain through Snell's law and the polish step (4); the rest as
    ``_transcendentals``, except that the forward's two theta_norm a surface
    take the surface step's roots and divide by pi / 2 by div_half_pi
    (theta_norm_root), as ``k1_ops``. The operation totals count the
    partials in their quotient form, the fewer operations."""
    lu, full = penalties in (True, "full"), penalties == "full"
    sq, dv, ac = _transcendentals(penalties, n_surf, backward, 0,
                                  3 * n_iter + 5 + 2 * no_period + (12 if backward else 0))
    fast_div = 2 * n_surf if lu and not backward else 0
    sq_dv_ac = (sq - fast_div, dv - fast_div, ac,
                (n_iter + 6 + no_period + (3 if backward else 0)) * n_surf, fast_div)
    k = n_asph
    surface = 91 + 4 * k + n_iter * (26 + 5 * k) + no_period * (24 + 5 * k)
    if not backward:
        return OpCounts(surface * n_surf + 8 + (14 * n_surf if lu else 0)
                        + (10 * n_surf - 1 + 3 * n_sides if full else 0), *sq_dv_ac)
    surface += (10 + 3 * k) + (3 + k) + 163 + 40 + 3 * (2 * k - 1) + 10 * k + (4 + k)
    return OpCounts(surface * n_surf + 19 + (20 * n_surf if lu else 0)
                    + (12 * n_surf - 2 + n_sides if full else 0), *sq_dv_ac)


def asphere_inputs(torch, zoo, simulator, fused_trace, width, c_scale=1.0, name="double_gauss_asph"):
    """K3's inputs (xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z) on the
    zoo lens ``name`` with c scaled, the tight bounds, n_per_w."""
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    **width).trace_config()
    specs, lens = zoo.build(name, device="cuda")
    lens = lens.replace(c=lens.c * c_scale)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, W) = fused_trace.prepare_fused_inputs(specs, lens, cfg)
    ref_z, bounds, thr = full_args(torch, fused_trace, lens)
    inputs = (xp, yp, cyb, z0, lens.c[0].detach(), lens.kappa[0].detach(), lens.t[0].detach(),
              mu, lens.asph[0].detach(), ref_z)
    return inputs, F * P, bounds, thr


def run_k3_fwd(fused_asphere, inputs, penalties, allow_backward, n_per_w, bounds, thr, plain):
    ins = inputs if penalties == "full" else inputs[:9]
    if plain:
        return fused_asphere.trace_fused_asphere_reference(
            *ins[:9], penalties, allow_backward, n_per_w, 10, inputs[9], bounds, thr)
    return fused_asphere._launch_k3_fwd(ins, penalties, allow_backward, n_per_w, 10, bounds, thr)


def run_k3_bwd(fused_asphere, inputs, cot, penalties, allow_backward, n_per_w, bounds, thr,
               plain):
    ins = inputs if penalties == "full" else inputs[:9]
    if plain:
        return fused_asphere.trace_fused_asphere_backward_reference(
            ins, cot, penalties, allow_backward, n_per_w, 10, bounds, thr)
    return fused_asphere._launch_k3_bwd(ins, cot, penalties, allow_backward, n_per_w, 10, bounds,
                                        thr)


def k3_fwd_compare(torch, got, want):
    """K3 forward's outputs against its plain version's: (ok, masks
    bit-identical, coordinates bit-identical, penalty sums' deviation
    relative to their largest value, largest absolute deviation)."""
    masks = all(torch.equal(got[i], want[i]) for i in (4, 5))
    coords = all(torch.equal(got[i], want[i]) for i in range(4))
    pen_rel = max([float((got[i] - want[i]).abs().max() / want[i].abs().max().clamp(min=1e-30))
                   for i in range(6, len(got))] + [0.0])
    max_abs = max(float((got[i] - want[i]).abs().max())
                  for i in range(len(got)) if i not in (4, 5))
    return masks and coords and pen_rel <= PEN_ROUNDINGS, masks, coords, pen_rel, max_abs


def k3_bwd_compare(torch, got, want):
    """K3 backward's outputs against its plain version's: (ok, largest
    per-ray deviation, largest absolute and relative parameter deviation);
    ok asks for bit-identical per-ray cotangents, finite outputs and each
    parameter cotangent within one float32 rounding of its largest
    magnitude."""
    ray = max(float((got[i] - want[i]).abs().max()) for i in range(3))
    par_abs = max(float((got[i] - want[i]).abs().max()) for i in range(3, len(got)))
    par_rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max().clamp(min=1e-30))
                  for i in range(3, len(got)))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    return finite and ray == 0.0 and par_rel <= ONE_ROUNDING, ray, par_abs, par_rel


def failure_counts(torch, fused_asphere, inputs, n_per_w, mask=None):
    """Per failure condition, the (ray, surface) pairs where it fires on a
    ray still alive before a real surface, read from the plain version's
    locals (backward rays flagged); ``inputs`` are K4's, (B, N) rays, or
    K3's, (N,)."""
    counts = dict(domain_guard=0, not_converged=0, stationary=0, cos2_floor=0, tir=0,
                  cz2_collapse=0)
    if inputs[0].ndim == 1:
        inputs = fused_asphere._one(inputs[:9])

    def keep(k, pre, loc, kill, post):
        alive = pre[6] if mask is None else pre[6] & mask[:, k, None]
        count = lambda m: int((m & alive).sum())
        counts["domain_guard"] += count(loc["guard_pre"] | loc["guard2"])
        counts["not_converged"] += count(loc["not_conv"])
        counts["stationary"] += count(loc["stationary"])
        counts["cos2_floor"] += count(loc["cos2"] - 1e-6 < 0)
        counts["tir"] += count(loc["ok1"] & loc["fail2a"])
        counts["cz2_collapse"] += count(loc["ok1"] & loc["fail2"] & ~loc["fail2a"])
    with torch.no_grad():
        fused_asphere._trace_batch(*inputs[:9], True, n_per_w, 10, keep, mask)
    return counts


def newton_statistics(torch, fused_asphere, inputs, n_per_w, mask=None, n_iter=10):
    """How soon the Newton steps of K3 (``inputs`` (N,) rays) or K4 ((B, N))
    repeat, on this device, by the plain version's arithmetic
    (``newton_point_with_exit`` at every surface of the forward, backward
    rays flagged): over all lane-surfaces, the steps a lane evaluates, the
    steps its warp runs (the most of its 32 lanes, the kernels' ray order:
    32 consecutive rays of a system), the shares that leave on a period of
    1 or 2 and that find none; and whether the exit gave the bits of the
    fixed count of steps everywhere."""
    if inputs[0].ndim == 1:
        inputs = fused_asphere._one(inputs[:9])
    c, kappa, asph = inputs[4], inputs[5], inputs[8]
    lane_steps, warp_steps, periods, same = 0, 0, torch.zeros(3, dtype=torch.int64), True
    n_lanes = n_warps = 0

    def keep(k, pre, loc, kill, post):
        nonlocal lane_steps, warp_steps, periods, same, n_lanes, n_warps
        a = [asph[:, k, j, None] for j in range(asph.shape[2])]
        s, steps, period = fused_asphere.newton_point_with_exit(
            c[:, k, None], kappa[:, k, None], a, *pre[:6], n_iter)
        same = same and torch.equal(s.view(torch.int32), loc["s_pre"].view(torch.int32))
        lane_steps += int(steps.sum())
        n_lanes += steps.numel()
        pad = -steps.shape[1] % 32
        warps = torch.nn.functional.pad(steps, (0, pad)).reshape(steps.shape[0], -1, 32)
        warp_steps += int(warps.amax(-1).sum())
        n_warps += warps.shape[0] * warps.shape[1]
        periods += torch.bincount(period.reshape(-1).long(), minlength=3).cpu()
    with torch.no_grad():
        fused_asphere._trace_batch(*inputs[:9], True, n_per_w, n_iter, keep, mask)
    return dict(steps_per_lane=lane_steps / n_lanes, steps_per_warp=warp_steps / n_warps,
                period_1_share=int(periods[1]) / n_lanes, period_2_share=int(periods[2]) / n_lanes,
                no_period_share=int(periods[0]) / n_lanes, exit_bits_identical=same)


def phase_newton_statistics(torch, zoo, simulator, fused_trace, fused_asphere):
    """How soon K3's Newton steps repeat at the main path's 2,457,600 rays,
    on the aspherized double-Gauss and on its c x 3 variant, by the plain
    version's arithmetic on the card: the kernels leave a lane there, and
    the bounds count the steps these inputs need. Returns the statistics
    by lens."""
    stats = {}
    for label, c_scale in (("double_gauss_asph", 1.0), ("double_gauss_asph c x 3", 3.0)):
        inputs, n_per_w, _, _ = asphere_inputs(torch, zoo, simulator, fused_trace, BENCH_WIDTH,
                                               c_scale)
        st = newton_statistics(torch, fused_asphere, inputs, n_per_w)
        check(st["exit_bits_identical"],
              f"Newton steps on the card, {label}, {inputs[0].shape[0]} rays x "
              f"{inputs[4].shape[0]} surfaces, 10 steps: a lane evaluates "
              f"{st['steps_per_lane']:.4f} steps before they repeat, its warp runs "
              f"{st['steps_per_warp']:.4f}; lane-surfaces leaving on a fixed point "
              f"{st['period_1_share']:.6f}, on a 2-cycle {st['period_2_share']:.6f}, on none "
              f"{st['no_period_share']:.6f}; the exit gives the bits of all 10 steps: "
              f"{st['exit_bits_identical']}")
        stats[label] = st
    return stats


def phase_k3_forward(torch, zoo, simulator, fused_trace, fused_asphere):
    """K3 forward vs its plain version at 442,368 rays, every mode and
    policy, on the aspherized double-Gauss and on its c x 3 variant with the
    failure conditions counted. Returns the largest deviations per entry."""
    worst = {"k3_fwd": 0.0, "k3_fwd_full": 0.0}
    failed = []
    for label, c_scale in (("double_gauss_asph", 1.0), ("double_gauss_asph c x 3", 3.0)):
        inputs, n_per_w, bounds, thr = asphere_inputs(torch, zoo, simulator, fused_trace,
                                                      FULL_WIDTH, c_scale)
        if c_scale != 1.0:
            counts = failure_counts(torch, fused_asphere, inputs, n_per_w)
            check(counts["domain_guard"] > 0 and counts["not_converged"] > 0,
                  f"K3 failure conditions on {label}, {inputs[0].shape[0]} rays x "
                  f"{inputs[4].shape[0]} surfaces, (ray, surface) pairs on rays alive before "
                  f"the surface, from the plain version's locals: {counts}")
        for penalties in PENALTY_MODES:
            for allow_backward in (True, False):
                args = (inputs, penalties, allow_backward, n_per_w, bounds, thr)
                with torch.no_grad():
                    got = run_k3_fwd(fused_asphere, *args, plain=False)
                    want = run_k3_fwd(fused_asphere, *args, plain=True)
                ok, masks, coords, pen_rel, max_abs = k3_fwd_compare(torch, got, want)
                key = "k3_fwd_full" if penalties == "full" else "k3_fwd"
                worst[key] = max(worst[key], max_abs)
                print(f"{'ok  ' if ok else 'FAIL'} K3 forward vs plain, {label}, "
                      f"{MODE_NAME[penalties]} mode, allow_backward={allow_backward}, "
                      f"{inputs[0].shape[0]} rays: masks bit-identical={masks}, coordinates "
                      f"bit-identical={coords}, penalty sums within {pen_rel:.2e} of their "
                      f"largest (limit {PEN_ROUNDINGS:.2e}); ray_ok share "
                      f"{float(got[4].float().mean()):.6f}", flush=True)
                if not ok:
                    failed.append((label, penalties, allow_backward))
        # The card against the CPU: the plain version on CPU copies of the
        # same inputs. Lanes may differ where the CPU's and the card's
        # elementwise operations round differently (the convergence test
        # |F| > 1e-5 sits at float32 resolution for |s| of tens of mm);
        # counted and reported, not required to be zero.
        with torch.no_grad():
            card = run_k3_fwd(fused_asphere, inputs, False, True, n_per_w, bounds, thr,
                              plain=False)
            host = run_k3_fwd(fused_asphere, tuple(a.cpu() for a in inputs), False, True,
                              n_per_w, bounds, thr, plain=True)
        differ = {name: int((card[i].cpu() != host[i]).sum())
                  for i, name in ((4, "ray_ok"), (5, "ray_backward"))}
        both = card[4].cpu() & host[4]
        coord = max(float((card[i].cpu() - host[i]).abs()[both].max()) for i in range(4))
        print(f"info K3 forward on the card vs its plain version on the CPU, {label}, plain "
              f"mode, {inputs[0].shape[0]} rays: lanes that differ {differ}, coordinates of "
              f"rays ok in both within {coord:.3e}", flush=True)
    check(not failed, f"K3 forward agrees with its plain version (failed: {failed})")
    return worst


def phase_k3_backward(torch, zoo, simulator, fused_trace, fused_asphere):
    """K3 backward vs its plain version on seeded cotangents, and two
    launches bit for bit. Returns (per-ray deviation, largest absolute and
    relative parameter deviation)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = (0.0, 0.0, 0.0)
    failed = []
    for label, c_scale in (("double_gauss_asph", 1.0), ("double_gauss_asph c x 3", 3.0)):
        inputs, n_per_w, bounds, thr = asphere_inputs(torch, zoo, simulator, fused_trace,
                                                      FULL_WIDTH, c_scale)
        n = inputs[0].shape[0]
        for penalties in PENALTY_MODES:
            for allow_backward in (True, False):
                cot = [torch.randn(n, device="cuda", generator=gen)
                       for _ in range({False: 4, True: 7, "full": 9}[penalties])]
                args = (inputs, cot, penalties, allow_backward, n_per_w, bounds, thr)
                got = run_k3_bwd(fused_asphere, *args, plain=False)
                again = run_k3_bwd(fused_asphere, *args, plain=False)
                want = run_k3_bwd(fused_asphere, *args, plain=True)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                close, ray, par_abs, par_rel = k3_bwd_compare(torch, got, want)
                worst = tuple(map(max, worst, (ray, par_abs, par_rel)))
                ok = same and close
                print(f"{'ok  ' if ok else 'FAIL'} K3 backward vs plain, {label}, "
                      f"{MODE_NAME[penalties]} mode, allow_backward={allow_backward}, {n} rays: "
                      f"max per-ray deviation {ray:.3e}; parameter cotangents dz0, dc, dkappa, "
                      f"dt, dmu, dasph{', dref_z' if penalties == 'full' else ''} within "
                      f"{par_rel:.2e} of their largest (limit {ONE_ROUNDING:.2e}, max absolute "
                      f"{par_abs:.3e}); two launches bit-identical={same}", flush=True)
                if not ok:
                    failed.append((label, penalties, allow_backward))
    check(not failed, f"K3 backward agrees with its plain version (failed: {failed})")
    return worst


def phase_k3_is_k1(torch, zoo, simulator, fused_trace, fused_asphere):
    """K3 with kappa = asph = 0 against K1 on the double-Gauss at 442,368
    rays: masks equal, coordinates within JAX's own K3-vs-K1 bar."""
    inputs, n_per_w, bounds, thr = kernel_inputs(torch, zoo, simulator, fused_trace, FULL_WIDTH)
    xp, yp, cyb, z0, c, t, mu = inputs[:7]
    with torch.no_grad():
        k1 = run_fwd(fused_trace, inputs, False, True, n_per_w, bounds, thr, plain=False)
        k3 = fused_asphere._launch_k3_fwd(
            (xp, yp, cyb, z0, c, torch.zeros_like(c), t, mu,
             torch.zeros(c.shape[0], 2, device="cuda")), False, True, n_per_w, 10, bounds, thr)
    torch.cuda.synchronize()
    masks = torch.equal(k1[4], k3[4]) and torch.equal(k1[5], k3[5])
    ok = k1[4]
    excess = max(float(((k3[i] - k1[i]).abs() - 1e-4 * k1[i].abs())[ok].max()) for i in range(4))
    dev = max(float((k3[i] - k1[i]).abs()[ok].max()) for i in range(4))
    check(masks and excess <= 1e-5,
          f"K3 at kappa = asph = 0 vs K1 on the double-Gauss, {xp.shape[0]} rays: masks "
          f"equal={masks}, coordinates within {dev:.3e} (limit 1e-05 + 1e-04 relative)")


def phase_k3_serve(torch, zoo, simulator, fused_trace, fused_asphere):
    """``do_ray_tracing(trace_engine="fused")`` on the aspherized
    double-Gauss at 3,840 and at 2,457,600 rays: one K3 forward launch per
    call, no K1 launch; the 3,840-ray call held against the CPU. Returns the
    K3 forward launches of the run."""
    specs, lens = zoo.build("double_gauss_asph", device="cuda")
    configs = [simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                         trace_engine="fused", **width)
               for width in (ENTRY_WIDTH, BENCH_WIDTH)]
    fused_asphere.K3_FWD_LAUNCHES = 0
    fused_asphere.K3_BWD_LAUNCHES = 0
    fused_trace.K1_FWD_LAUNCHES = 0
    with torch.no_grad():
        served = [simulator.do_ray_tracing(specs, lens, cfg) for cfg in configs]
        torch.cuda.synchronize()
    launches = fused_asphere.K3_FWD_LAUNCHES
    check(launches == 2 and fused_asphere.K3_BWD_LAUNCHES == 0
          and fused_trace.K1_FWD_LAUNCHES == 0,
          f"aspheric serving: K3 forward launched {launches} times for 2 calls (3,840 and "
          f"2,457,600 rays), K3 backward {fused_asphere.K3_BWD_LAUNCHES}, K1 "
          f"{fused_trace.K1_FWD_LAUNCHES}")
    for (res, loss), cfg in zip(served, configs):
        check(bool(torch.isfinite(res.x[res.ray_ok]).all())
              and all(math.isfinite(float(v)) for v in loss.values()),
              f"served {tuple(res.x.shape)}: ray_ok share {float(res.ray_ok.float().mean()):.6f}, "
              f"loss_unsup {float(loss['loss_unsup']):.7f}, rms {float(loss['rms']):.8f}")
    with torch.no_grad():
        _, want = simulator.do_ray_tracing(specs.to("cpu"), lens.to("cpu"), configs[0])
    loss = served[0][1]
    tol = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4}
    rel = {k: abs(float(loss[k]) - float(want[k])) / abs(float(want[k])) for k in tol}
    check(all(rel[k] <= tol[k] for k in tol),
          "aspheric serving at 3,840 rays, CUDA vs CPU relative gaps "
          + ", ".join(f"{k} {rel[k]:.2e} (limit {tol[k]:.0e})" for k in tol))
    return launches


def phase_k3_train(torch, zoo, simulator, fused_trace, fused_asphere, LensOptimizer, n_steps=5):
    """The aspheric training path: Adam steps at 2,457,600 rays on the Lu
    and on the full loss with kappa and asph trained, counts set to 0 before
    each run and read after; the first step held against the CPU at 3,840
    rays. Returns the (forward, backward) launches of each run."""
    launches = {}
    for full in (False, True):
        name = "full" if full else "Lu"
        opt, state = make_optimizer(zoo, simulator, LensOptimizer, "cuda", BENCH_WIDTH, full,
                                    "double_gauss_asph")
        trained = sorted(state.params)
        start = {k: v.detach().clone() for k, v in state.params.items()}
        fused_asphere.K3_FWD_LAUNCHES = 0
        fused_asphere.K3_BWD_LAUNCHES = 0
        fused_trace.K1_FWD_LAUNCHES = 0
        totals = []
        for _ in range(n_steps):
            state, total, _ = opt.step(state)
            totals.append(float(total))
        torch.cuda.synchronize()
        fwd, bwd = fused_asphere.K3_FWD_LAUNCHES, fused_asphere.K3_BWD_LAUNCHES
        adam_steps = [int(s["step"]) for s in state.opt_state.state.values()]
        moved = {k: float((state.params[k].detach() - start[k]).abs().max()) for k in start}
        finite = (all(math.isfinite(v) for v in totals)
                  and all(bool(torch.isfinite(v).all()) for v in state.params.values()))
        check(fwd == n_steps and bwd == n_steps and fused_trace.K1_FWD_LAUNCHES == 0 and finite
              and adam_steps == [n_steps] * len(adam_steps)
              and moved["kappa"] > 0 and moved["asph"] > 0,
              f"{n_steps} LensOptimizer steps on the aspherized double-Gauss, {name} loss, "
              f"2457600 rays, variables {trained}: K3 forward launched {fwd} times, K3 backward "
              f"{bwd} times, K1 {fused_trace.K1_FWD_LAUNCHES}; all steps accepted (Adam step "
              f"counts {adam_steps}); losses {['%.6f' % v for v in totals]}; kappa moved by "
              f"up to {moved['kappa']:.3e}, asph by {moved['asph']:.3e}")
        launches[name] = (fwd, bwd)

        # The first step on the card and on the CPU: its loss, the gradients
        # it takes (of the loss in each trained variable group, relative to
        # the group's largest magnitude) and the parameters after it.
        after = {}
        for device in ("cuda", "cpu"):
            opt_d, state_d = make_optimizer(zoo, simulator, LensOptimizer, device, ENTRY_WIDTH,
                                            full, "double_gauss_asph")
            total_d, _ = opt_d.loss(state_d.params)
            grads = torch.autograd.grad(total_d, list(state_d.params.values()),
                                        allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g).cpu()
                     for (k, p), g in zip(state_d.params.items(), grads)}
            state_d, step_total, _ = opt_d.step(state_d)
            after[device] = (float(step_total), grads,
                             {k: v.detach().cpu() for k, v in state_d.params.items()})
        rel = abs(after["cuda"][0] - after["cpu"][0]) / abs(after["cpu"][0])
        grad_rel = {k: float((after["cuda"][1][k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                    for k, g in after["cpu"][1].items()}
        dparam = max(float((after["cuda"][2][k] - after["cpu"][2][k]).abs().max())
                     for k in after["cpu"][2])
        check(rel <= 1e-5 and max(grad_rel.values()) <= 1e-4 and dparam <= 1e-6,
              f"first aspheric {name} step at 3840 rays, CUDA vs CPU: loss {after['cuda'][0]:.7f} "
              f"vs {after['cpu'][0]:.7f} (relative gap {rel:.2e}, limit 1e-05); gradients within "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(grad_rel.items()))
              + f" of their group's largest magnitude (limit 1e-04); parameters after the step "
              f"differ by at most {dparam:.3e} (limit 1e-06)")
    return launches


def reduce_split_ms(torch, fn, calls=20):
    """(the partial sums' reduction, the backward kernel): device
    milliseconds per call of ``fn`` from torch.profiler's kernel times over
    ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    reduce_us = main_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if "partials_reduce" in ev.key:
            reduce_us += dev_us
        elif "_bwd_kernel" in ev.key:
            main_us += dev_us
    return reduce_us / calls / 1e3, main_us / calls / 1e3


def fwd_bwd_times(torch, kernel, suffix, fwd, bwd, plain, queue_ahead, split=False):
    """{kernel}_fwd{suffix} and {kernel}_bwd{suffix}: the milliseconds of
    fwd(False) and bwd(False), the kernels (``time_ms``, behind a sleep
    kernel where ``queue_ahead``), and where ``plain`` is set
    plain_{kernel}_fwd{suffix} and plain_{kernel}_bwd{suffix}, of fwd(True)
    and bwd(True), their plain versions; where ``split`` is set,
    {kernel}_bwd{suffix}_reduce and _main, the backward's two kernels apart
    (``reduce_split_ms``)."""
    ms = {}
    with torch.no_grad():
        for kind, run in (("fwd", fwd), ("bwd", bwd)):
            ms[f"{kernel}_{kind}{suffix}"] = time_ms(torch, lambda: run(False),
                                                     queue_ahead=queue_ahead)
            if plain:
                ms[f"plain_{kernel}_{kind}{suffix}"] = time_ms(torch, lambda: run(True), runs=3,
                                                               batch=2)
        if split:
            (ms[f"{kernel}_bwd{suffix}_reduce"],
             ms[f"{kernel}_bwd{suffix}_main"]) = reduce_split_ms(torch, lambda: bwd(False))
    return ms


def mode_times(torch, zoo, simulator, modules, kernel, plain, gen, on_mode=None, split=False):
    """One kernel's forward and backward in plain, Lu and full mode
    (backward rays allowed) with CUDA events: K1 at 2,457,600 rays of the
    double-Gauss, K3 at 2,457,600 rays of the aspherized double-Gauss, K2 at
    256 x 1,536 = 393,216 rays of the Cooke population, K4 of the aspheric
    Cooke population (the population kernels' batches enqueued behind a
    sleep kernel); their plain versions too where ``plain`` is set, the
    backward's two kernels apart where ``split`` is (``fwd_bwd_times``).
    ``on_mode(penalties, fwd, bwd)`` sees each mode's runners (argument:
    plain) after its times, under no_grad. ``modules`` is (fused_trace,
    fused_batch, fused_asphere). Returns the times and (inputs, n_per_w,
    mask, bounds, thr), mask None for K1 and K3."""
    fused_trace, fused_batch, fused_asphere = modules
    population = kernel in ("k2", "k4")
    mask = None
    if kernel == "k1":
        inputs, n_per_w, bounds, thr = kernel_inputs(torch, zoo, simulator, fused_trace,
                                                     BENCH_WIDTH)
    elif kernel == "k2":
        inputs, n_per_w, mask, bounds, thr = population_inputs(
            torch, zoo, simulator, fused_batch, fused_trace, "cooke")[2:]
        inputs = tuple(a.detach() for a in inputs)
    elif kernel == "k3":
        inputs, n_per_w, bounds, thr = asphere_inputs(torch, zoo, simulator, fused_trace,
                                                      BENCH_WIDTH)
    else:
        inputs, n_per_w, mask, bounds, thr = k4_inputs(torch, zoo, simulator, fused_batch,
                                                      fused_trace, "cooke")
    ms = {}
    for penalties in PENALTY_MODES:
        cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
               for _ in range({False: 4, True: 7, "full": 9}[penalties])]
        args = (penalties, True, n_per_w)
        if kernel == "k1":
            fwd = lambda plain: run_fwd(fused_trace, inputs, *args, bounds, thr, plain)
            bwd = lambda plain: run_bwd(fused_trace, inputs, cot, *args, bounds, thr, plain)
        elif kernel == "k2":
            fwd = lambda plain: run_k2_fwd(fused_batch, inputs, *args, mask, bounds, thr, plain)
            bwd = lambda plain: run_k2_bwd(fused_batch, inputs, cot, *args, mask, bounds, thr,
                                           plain)
        elif kernel == "k3":
            fwd = lambda plain: run_k3_fwd(fused_asphere, inputs, *args, bounds, thr, plain)
            bwd = lambda plain: run_k3_bwd(fused_asphere, inputs, cot, *args, bounds, thr, plain)
        else:
            fwd = lambda plain: run_k4_fwd(fused_asphere, inputs, *args, mask, bounds, thr, plain)
            bwd = lambda plain: run_k4_bwd(fused_asphere, inputs, cot, *args, mask, bounds, thr,
                                           plain)
        ms.update(fwd_bwd_times(torch, kernel, f"_{MODE_NAME[penalties]}", fwd, bwd, plain,
                                population, split))
        if on_mode:
            with torch.no_grad():
                on_mode(penalties, fwd, bwd)
    return ms, (inputs, n_per_w, mask, bounds, thr)


def phase_k3_timing(torch, zoo, simulator, fused_trace, fused_asphere, LensOptimizer, card,
                    newton):
    """K3 and its plain versions per mode at 2,457,600 rays, the main path's
    width, each kernel checked against its plain version there as in the
    442,368-ray phases; then the host clock of one aspheric LensOptimizer
    step on each loss. Returns the times, the deviations at this width (as
    phase_k3_forward and phase_k3_backward return theirs) and the shapes
    that the bounds count, with the Newton steps a lane needs there
    (``newton``: phase_newton_statistics's numbers for these inputs)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    fwd_err, bwd_err = {"k3_fwd": 0.0, "k3_fwd_full": 0.0}, [(0.0, 0.0, 0.0)]

    def check_mode(penalties, fwd, bwd):
        mode = MODE_NAME[penalties]
        got = fwd(False)
        n = got[0].shape[0]
        ok, masks, coords, pen_rel, max_abs = k3_fwd_compare(torch, got, fwd(True))
        key = "k3_fwd_full" if penalties == "full" else "k3_fwd"
        fwd_err[key] = max(fwd_err[key], max_abs)
        check(ok, f"K3 forward vs plain at {n} rays, {mode} mode: masks bit-identical="
                  f"{masks}, coordinates bit-identical={coords}, penalty sums within "
                  f"{pen_rel:.2e} of their largest (limit {PEN_ROUNDINGS:.2e})")
        ok, ray, par_abs, par_rel = k3_bwd_compare(torch, bwd(False), bwd(True))
        bwd_err[0] = tuple(map(max, bwd_err[0], (ray, par_abs, par_rel)))
        check(ok, f"K3 backward vs plain at {n} rays, {mode} mode: per-ray cotangents "
                  f"bit-identical (max deviation {ray:.3e}); parameter cotangents dz0, dc, "
                  f"dkappa, dt, dmu, dasph{', dref_z' if mode == 'full' else ''} within "
                  f"{par_rel:.2e} of their largest (limit {ONE_ROUNDING:.2e}; max absolute "
                  f"deviation {par_abs:.3e})")
    ms, (inputs, _, _, bounds, _) = mode_times(
        torch, zoo, simulator, (fused_trace, None, fused_asphere), "k3", True, gen, check_mode)
    n, n_surf = inputs[0].shape[0], inputs[4].shape[0]
    shape = dict(n_rays=n, n_surf=n_surf, n_w=inputs[7].shape[1], n_asph=inputs[8].shape[1],
                 bounds=bounds, newton_steps=newton["steps_per_lane"],
                 newton_no_period=newton["no_period_share"])
    for full in (False, True):
        opt, state = make_optimizer(zoo, simulator, LensOptimizer, "cuda", BENCH_WIDTH, full,
                                    "double_gauss_asph")
        holder = [state]

        def step():
            holder[0] = opt.step(holder[0])[0]
        ms[f"asphere_optimizer_step_{'full' if full else 'lu'}"] = host_ms(torch, step)
    for key, value in ms.items():
        print(f"time {key}: {value:.4f} ms per call at {n} rays (aspherized double-Gauss, "
              f"{n_surf} surfaces, K = {shape['n_asph']}, n_iter = 10 Newton steps, "
              f"{shape['newton_steps']:.4f} a lane before they repeat), card: {card}",
              flush=True)
    return ms, fwd_err, bwd_err[0], shape


def newton_of(shape, n_iter=None):
    """``k3_ops``'s Newton arguments (n_iter, no_period) at a timed shape:
    the steps its inputs need and the share of lane-surfaces that find no
    repeat (``newton_statistics``), or ``n_iter`` steps without a repeat."""
    if n_iter is None:
        return shape["newton_steps"], shape["newton_no_period"]
    return n_iter, 1.0


def k3_bound(shape, penalties, backward, n_iter=None):
    """(bound_ms, bound_by) of K3 forward or backward at the timed shape,
    at the Newton steps its inputs need (``shape["newton_steps"]``) or at
    ``n_iter``."""
    n, n_surf, n_w, n_asph = shape["n_rays"], shape["n_surf"], shape["n_w"], shape["n_asph"]
    n_sides = sum(math.isfinite(v) for gap in shape["bounds"] for v in gap)
    n_iter, no_period = newton_of(shape, n_iter)
    ops = k3_ops(penalties, n_surf, n_asph, n_iter, backward, n_sides, no_period).total
    if not backward:
        return bound(n, ops, FWD_BYTES[penalties])
    n_params = (1 + 3 * n_surf + n_surf * n_w + n_surf * n_asph
                + (n_surf + 1 if penalties == "full" else 0))
    return bound(n, ops, BWD_BYTES[penalties], 16 * n_params * -(-n // 256))


def k3_entries(ms, shape, fwd_err, bwd_err, serve_launches, train_launches):
    """The K3 entries of the kernels line: main numbers for the mode of the
    aspheric Lu-loss training run, whose launches ``launches`` counts; the
    other modes' and runs' numbers under their own keys. ``fwd_err`` and
    ``bwd_err`` hold the deviations of the 442,368-ray phases and of the
    timed width; each entry reports the largest."""
    fwd_err = {k: max(e[k] for e in fwd_err) for k in fwd_err[0]}
    bwd_err = tuple(map(max, *bwd_err))
    def numbers(kind, penalties, suffix=""):
        mode = MODE_NAME[penalties]
        b_ms, b_by = k3_bound(shape, penalties, kind == "bwd")
        return {f"ms{suffix}": ms[f"k3_{kind}_{mode}"],
                f"plain_ms{suffix}": ms[f"plain_k3_{kind}_{mode}"],
                f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by,
                f"bound_ms_n10{suffix}": k3_bound(shape, penalties, kind == "bwd", 10)[0]}
    return [
        {"name": "k3_fwd", "route": "cuda", "source": K3_FWD_SOURCE, "replaces": TPU_K3_FWD,
         "launches": train_launches["Lu"][0], "max_abs_err": fwd_err["k3_fwd"],
         **numbers("fwd", True), "library_ms": None, "launches_serving": serve_launches,
         **numbers("fwd", False, "_plain")},
        {"name": "k3_fwd_full", "route": "cuda", "source": K3_FWD_SOURCE, "replaces": TPU_K3_FWD,
         "launches": train_launches["full"][0], "max_abs_err": fwd_err["k3_fwd_full"],
         **numbers("fwd", "full"), "library_ms": None},
        {"name": "k3_bwd", "route": "cuda", "source": K3_BWD_SOURCE, "replaces": TPU_K3_BWD,
         "launches": train_launches["Lu"][1], "max_abs_err": bwd_err[0], **numbers("bwd", True),
         "library_ms": None, "launches_full_loss": train_launches["full"][1],
         "param_max_abs_err": bwd_err[1], "param_max_rel_err": bwd_err[2],
         **numbers("bwd", False, "_plain"), **numbers("bwd", "full", "_full"),
         "asphere_optimizer_step_lu_ms": ms["asphere_optimizer_step_lu"],
         "asphere_optimizer_step_full_ms": ms["asphere_optimizer_step_full"]},
    ]


# ---------------------------------------------------------------------------
# The aspheric-population path: kernel K4 on populations of conic/asphere
# designs.
# ---------------------------------------------------------------------------


def k4_population(torch, zoo, name, n_sys=N_SYSTEMS, device="cuda"):
    """An aspheric population at the generator width: 'cooke'
    (``zoo.aspheric_population``, the JAX benchmark's "pallas-asphere"
    draw), 'cooke c x 3' (c x 3 on every 8th system: the sag-domain guard
    and non-convergence fire) or 'mixed' (128 Cooke + 128 double-Gauss padded
    to 11 surfaces, the aspheric terms drawn and masked)."""
    if name == "mixed":
        return zoo.aspheric_population(n_sys, ("cooke", "double_gauss"), mask_pad=True,
                                       device=device)
    specs, lens = zoo.aspheric_population(n_sys, device=device)
    if name == "cooke c x 3":
        scale = torch.ones(n_sys, 1, device=device)
        scale[::8] = 3.0
        lens = lens.replace(c=lens.c * scale)
    return specs, lens


def k4_inputs(torch, zoo, simulator, fused_batch, fused_trace, name):
    """K4's (B, N) inputs (xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z) on
    the population ``name``, n_per_w, the surface mask, the widest system's
    tight bounds and cos²(threshold)."""
    specs, lens = k4_population(torch, zoo, name)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(
            specs, lens, simulator.SimulatorConfig(**GEN_WIDTH).trace_config())
    vertex_z = torch.cumsum(lens.t, 1)
    ref_z = torch.cat((vertex_z, vertex_z[:, -1:]), 1)
    widest = np.array([int(np.argmax(lens.structure.n_surfaces))])
    bounds = fused_trace._path_bounds(lens[widest].structure, TIGHT["ray_path_lower_thresholds"],
                                      TIGHT["ray_path_upper_thresholds"])
    thr = math.cos(math.radians(TIGHT["ray_angle_threshold"])) ** 2
    inputs = (xp, yp, cyb, z0, lens.c, lens.kappa, lens.t, mu, lens.asph, ref_z)
    return (tuple(a.detach() for a in inputs), F * P,
            fused_batch._static_mask(lens.structure, "cuda"), bounds, thr)


def run_k4_fwd(fused_asphere, inputs, penalties, allow_backward, n_per_w, mask, bounds, thr,
               plain):
    ins = inputs if penalties == "full" else inputs[:9]
    if plain:
        return fused_asphere.trace_fused_asphere_batch_reference(
            *ins[:9], penalties, allow_backward, n_per_w, 10, mask, inputs[9], bounds, thr)
    return fused_asphere._launch_k4_fwd(ins, penalties, allow_backward, n_per_w, 10, mask,
                                        bounds, thr)


def run_k4_bwd(fused_asphere, inputs, cot, penalties, allow_backward, n_per_w, mask, bounds,
               thr, plain):
    ins = inputs if penalties == "full" else inputs[:9]
    args = (penalties, allow_backward, n_per_w, 10, mask, bounds, thr)
    if plain:
        return fused_asphere.trace_fused_asphere_batch_backward_reference(ins, cot, *args)
    return fused_asphere._launch_k4_bwd(ins, cot, *args)


def k4_bwd_compare(torch, got, want):
    """K4 backward's outputs against its plain version's: (ok, largest
    per-ray deviation, largest per-system parameter deviation relative to
    that system's largest parameter cotangent, largest absolute parameter
    deviation); ok asks for bit-identical per-ray cotangents, finite outputs
    and each system's parameter cotangents within one float32 rounding."""
    ray, param, param_abs = k2_bwd_errors(torch, got, want)
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    return finite and ray == 0.0 and param <= ONE_ROUNDING, ray, param, param_abs


def phase_k4_kernels(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere):
    """K4 forward and backward against their plain versions at 256 x 1,536
    rays, every mode and backward-ray policy, on the aspheric Cooke
    population, its c x 3 variant (failure conditions counted) and the
    padded mixed population (the MASKED instantiation); two backward
    launches bit for bit. Returns the largest deviations."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = dict(fwd=0.0, fwd_full=0.0, bwd_ray=0.0, bwd_param=0.0, bwd_param_abs=0.0)
    failed = []
    for name in ("cooke", "cooke c x 3", "mixed"):
        inputs, n_per_w, mask, bounds, thr = k4_inputs(torch, zoo, simulator, fused_batch,
                                                      fused_trace, name)
        n_sys, n = inputs[0].shape
        if name == "cooke c x 3":
            counts = failure_counts(torch, fused_asphere, inputs, n_per_w, mask)
            check(counts["domain_guard"] > 0 and counts["not_converged"] > 0,
                  f"K4 failure conditions on the {name} population, {n_sys} x {n} rays, (ray, "
                  f"surface) pairs on rays alive before the surface, from the plain version's "
                  f"locals: {counts}")
        for penalties in PENALTY_MODES:
            for allow_backward in (True, False):
                args = (penalties, allow_backward, n_per_w, mask, bounds, thr)
                with torch.no_grad():
                    got = run_k4_fwd(fused_asphere, inputs, *args, plain=False)
                    want = run_k4_fwd(fused_asphere, inputs, *args, plain=True)
                fwd_ok, masks, coords, pen_rel, max_abs = k3_fwd_compare(torch, got, want)
                key = "fwd_full" if penalties == "full" else "fwd"
                worst[key] = max(worst[key], max_abs)
                cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
                       for _ in range({False: 4, True: 7, "full": 9}[penalties])]
                g1 = run_k4_bwd(fused_asphere, inputs, cot, *args, plain=False)
                g2 = run_k4_bwd(fused_asphere, inputs, cot, *args, plain=False)
                gw = run_k4_bwd(fused_asphere, inputs, cot, *args, plain=True)
                same = all(torch.equal(a, b) for a, b in zip(g1, g2))
                bwd_ok, ray, param, param_abs = k4_bwd_compare(torch, g1, gw)
                worst["bwd_ray"] = max(worst["bwd_ray"], ray)
                worst["bwd_param"] = max(worst["bwd_param"], param)
                worst["bwd_param_abs"] = max(worst["bwd_param_abs"], param_abs)
                ok = fwd_ok and bwd_ok and same
                print(f"{'ok  ' if ok else 'FAIL'} K4 vs plain, {name} population ({n_sys} x {n} "
                      f"rays, {inputs[4].shape[1]} surfaces{', masked' if mask is not None else ''}"
                      f"), {MODE_NAME[penalties]} mode, allow_backward={allow_backward}: forward "
                      f"masks bit-identical={masks}, coordinates bit-identical={coords}, penalty "
                      f"sums within {pen_rel:.2e} (limit {PEN_ROUNDINGS:.2e}); backward per-ray "
                      f"deviation {ray:.3e}, per-system parameter cotangents within {param:.2e} "
                      f"(limit {ONE_ROUNDING:.2e}), two launches bit-identical={same}; ray_ok "
                      f"share {float(got[4].float().mean()):.6f}", flush=True)
                if not ok:
                    failed.append((name, penalties, allow_backward))
        del inputs
    check(not failed, f"K4 agrees with its plain versions (failed: {failed})")
    return worst


def phase_k4_is_k3(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere):
    """K4 on a population of one, the aspherized double-Gauss at 2,457,600
    rays, against K3: every output of the forward and the backward, bit for
    bit, every mode. Then K4 at kappa = asph = 0 against K2 on the Cooke
    population: masks equal, coordinates within JAX's own K3-vs-K1 bar."""
    inputs, n_per_w, bounds, thr = asphere_inputs(torch, zoo, simulator, fused_trace, BENCH_WIDTH)
    one = tuple(a.reshape(1) if i == 3 else a[None] for i, a in enumerate(inputs))
    gen = torch.Generator(device="cuda").manual_seed(9)
    for penalties in PENALTY_MODES:
        with torch.no_grad():
            k3 = run_k3_fwd(fused_asphere, inputs, penalties, True, n_per_w, bounds, thr,
                            plain=False)
            k4 = run_k4_fwd(fused_asphere, one, penalties, True, n_per_w, None, bounds, thr,
                            plain=False)
        cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
               for _ in range({False: 4, True: 7, "full": 9}[penalties])]
        g3 = run_k3_bwd(fused_asphere, inputs, cot, penalties, True, n_per_w, bounds, thr,
                        plain=False)
        g4 = run_k4_bwd(fused_asphere, one, [c[None] for c in cot], penalties, True, n_per_w,
                        None, bounds, thr, plain=False)
        torch.cuda.synchronize()
        same_f = all(torch.equal(a, b[0]) for a, b in zip(k3, k4))
        same_b = all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(g3, g4))
        check(same_f and same_b,
              f"K4 at B = 1 on the aspherized double-Gauss, {inputs[0].shape[0]} rays, "
              f"{MODE_NAME[penalties]} mode: forward equal to K3 bit for bit={same_f}, backward "
              f"(per-ray and parameter cotangents)={same_b}")
    del inputs, one
    inputs, n_per_w, mask, bounds, thr = k4_inputs(torch, zoo, simulator, fused_batch,
                                                  fused_trace, "cooke")
    xp, yp, cyb, z0, c, kappa, t, mu, asph = inputs[:9]
    with torch.no_grad():
        k2 = fused_batch._launch_k2_fwd((xp, yp, cyb, z0, c, t, mu), False, True, n_per_w, None,
                                        bounds, thr)
        k4 = fused_asphere._launch_k4_fwd((xp, yp, cyb, z0, c, torch.zeros_like(kappa), t, mu,
                                           torch.zeros_like(asph)), False, True, n_per_w, 10,
                                          None, bounds, thr)
    torch.cuda.synchronize()
    masks = torch.equal(k2[4], k4[4]) and torch.equal(k2[5], k4[5])
    ok = k2[4]
    excess = max(float(((k4[i] - k2[i]).abs() - 1e-4 * k2[i].abs())[ok].max()) for i in range(4))
    dev = max(float((k4[i] - k2[i]).abs()[ok].max()) for i in range(4))
    check(masks and excess <= 1e-5,
          f"K4 at kappa = asph = 0 vs K2 on the Cooke population, {xp.numel()} rays: masks "
          f"equal={masks}, coordinates within {dev:.3e} (limit 1e-05 + 1e-04 relative)")


def per_system_gap(torch, card_ok, host_ok):
    """(lanes whose ray_ok differs between the card and the CPU, the systems
    whose masks agree) of two (B, F, P, W) ray_ok tensors."""
    differ = card_ok.cpu() != host_ok.cpu()
    return int(differ.sum()), ~differ.reshape(differ.shape[0], -1).any(1)


def phase_k4_serve(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere):
    """``do_ray_tracing(trace_engine="fused")`` on the 256-system aspheric
    Cooke population under no_grad: one K4 forward launch and no other
    kernel's; held against the CPU on its first 8 systems (lanes whose masks
    differ reported). Returns the K4 forward launches of the run."""
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused")
    specs, lens = k4_population(torch, zoo, "cooke")
    counters = ((fused_trace, "K1_FWD_LAUNCHES"), (fused_batch, "K2_FWD_LAUNCHES"),
                (fused_asphere, "K3_FWD_LAUNCHES"), (fused_asphere, "K4_FWD_LAUNCHES"),
                (fused_asphere, "K4_BWD_LAUNCHES"))
    for module, counter in counters:
        setattr(module, counter, 0)
    with torch.no_grad():
        res, loss = simulator.do_ray_tracing(specs, lens, cfg)
        torch.cuda.synchronize()
    k1, k2, k3, launches, k4b = (getattr(m, c) for m, c in counters)
    check(launches == 1 and k4b == 0 and k1 == k2 == k3 == 0,
          f"aspheric population serving: K4 forward launched {launches} times for 1 call, K4 "
          f"backward {k4b}, K1 {k1}, K2 {k2}, K3 {k3}")
    shape = (N_SYSTEMS, GEN_WIDTH["n_sampled_fields"], GEN_WIDTH["n_pupil_rings"] ** 2, 3)
    check(tuple(res.x.shape) == shape and bool(torch.isfinite(res.x[res.ray_ok]).all())
          and all(math.isfinite(float(v)) for v in loss.values()),
          f"aspheric Cooke population served: {shape} result, ray_ok share "
          f"{float(res.ray_ok.float().mean()):.6f}, loss_unsup {float(loss['loss_unsup']):.6f}")
    rows = np.arange(8)
    with torch.no_grad():
        res_card, on_card = simulator.do_ray_tracing(specs[rows], lens[rows], cfg)
        res_host, on_cpu = simulator.do_ray_tracing(specs[rows].to("cpu"), lens[rows].to("cpu"),
                                                    cfg)
    lanes, _ = per_system_gap(torch, res_card.ray_ok, res_host.ray_ok)
    tol = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4}
    rel = {k: abs(float(on_card[k]) - float(on_cpu[k])) / abs(float(on_cpu[k])) for k in tol}
    check(lanes == 0 and all(rel[k] <= tol[k] for k in tol),
          f"aspheric serving on 8 systems, CUDA vs CPU: lanes whose ray_ok differs {lanes}; "
          "relative gaps " + ", ".join(f"{k} {rel[k]:.2e} (limit {tol[k]:.0e})" for k in tol))
    return launches


K4_PARAMS = ("c", "t", "kappa", "asph")


def group_gaps(torch, got, want, real):
    """Per parameter group of ``K4_PARAMS``: the largest deviation of ``got``
    from ``want`` on the real surfaces ``real`` (B, S), relative to the
    group's largest magnitude there."""
    gaps = {}
    for k, a, w in zip(K4_PARAMS, got, want):
        m = real[..., None] if k == "asph" else real
        gaps[k] = float(torch.where(m, (a.cpu() - w).abs(), 0.0).max()
                        / torch.where(m, w.abs(), 0.0).max().clamp(min=1e-30))
    return gaps


def k4_train_step(torch, fused_batch, specs, lens, cfg, lr=1e-3):
    """A closure running one Adam step on the population's (c, t, kappa,
    asph) against ``batched_unsupervised_loss``; returns the loss and the
    gradients."""
    params = [getattr(lens, k).detach().clone().requires_grad_(True) for k in K4_PARAMS]
    opt = torch.optim.Adam(params, lr=lr)

    def step():
        loss, _ = fused_batch.batched_unsupervised_loss(
            specs, lens.replace(**dict(zip(K4_PARAMS, params))), cfg)
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        return loss.detach(), grads
    return step


def k4_gradients(torch, fused_batch, specs, lens, cfg):
    """The loss and d/d(c, t, kappa, asph) of ``batched_unsupervised_loss``
    on the CPU's copy of a population."""
    params = [getattr(lens, k).detach().clone().requires_grad_(True) for k in K4_PARAMS]
    loss, _ = fused_batch.batched_unsupervised_loss(
        specs, lens.replace(**dict(zip(K4_PARAMS, params))), cfg)
    return float(loss.detach()), [g.cpu() for g in torch.autograd.grad(loss, params)]


def phase_k4_train(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere, n_steps=10):
    """The main path of this slice: 10 Adam steps (lr 1e-3) on the aspheric
    Cooke population's (c, t, kappa, asph) against
    ``batched_unsupervised_loss`` at 256 x 1,536 rays, the JAX benchmark's
    "pallas-asphere" fwd+bwd with the update; counts set to 0 before the run
    and read after. The first step's gradients held against the CPU on 8
    systems. Then the grouped full loss of the padded mixed population. Returns
    the (forward, backward) launches of both runs."""
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused")
    specs, lens = k4_population(torch, zoo, "cooke")
    step = k4_train_step(torch, fused_batch, specs, lens, cfg)
    for module, counter in ((fused_trace, "K1_FWD_LAUNCHES"), (fused_batch, "K2_FWD_LAUNCHES"),
                            (fused_asphere, "K4_FWD_LAUNCHES"),
                            (fused_asphere, "K4_BWD_LAUNCHES")):
        setattr(module, counter, 0)
    losses, finite = [], True
    first = None
    for _ in range(n_steps):
        loss, grads = step()
        first = first or (float(loss), [g.cpu() for g in grads])
        finite = finite and bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        losses.append(float(loss))
    torch.cuda.synchronize()
    fwd, bwd = fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES
    check(fwd == n_steps and bwd == n_steps and finite
          and fused_trace.K1_FWD_LAUNCHES == fused_batch.K2_FWD_LAUNCHES == 0,
          f"aspheric population training: {n_steps} Adam steps (lr 1e-3) on (c, t, kappa, asph) "
          f"of {N_SYSTEMS} Cooke designs ({N_SYSTEMS * 1536} rays): K4 forward launched {fwd} "
          f"times, K4 backward {bwd} times, K1 {fused_trace.K1_FWD_LAUNCHES}, K2 "
          f"{fused_batch.K2_FWD_LAUNCHES}; every loss and gradient finite={finite}; losses "
          f"{['%.5f' % v for v in losses]}")
    # The first step's gradients, card vs CPU on 8 systems of the same
    # population (each system's rows of d(mean Lu) are its own; the mean over
    # 8 systems scales them by 256 / 8).
    rows = np.arange(8)
    card = k4_gradients(torch, fused_batch, specs[rows], lens[rows], cfg)
    host = k4_gradients(torch, fused_batch, specs[rows].to("cpu"), lens[rows].to("cpu"), cfg)
    rel = abs(card[0] - host[0]) / abs(host[0])
    every = torch.ones(lens[rows].c.shape, dtype=torch.bool)
    grad_rel = group_gaps(torch, card[1], host[1], every)
    full_rows = group_gaps(torch, [g[rows] * N_SYSTEMS / 8 for g in first[1]], host[1], every)
    check(rel <= 1e-5 and max(grad_rel.values()) <= 1e-4 and max(full_rows.values()) <= 1e-4,
          f"first aspheric population step on 8 systems, CUDA vs CPU: loss {card[0]:.7f} vs "
          f"{host[0]:.7f} (relative gap {rel:.2e}, limit 1e-05); gradients within "
          + ", ".join(f"{k} {v:.2e}" for k, v in grad_rel.items())
          + " of their group's largest (limit 1e-04); the 256-system step's rows of those "
          "systems within " + ", ".join(f"{k} {v:.2e}" for k, v in full_rows.items()))
    train = (fwd, bwd)
    phase_k4_fixed_bar(torch, zoo, simulator, fused_batch, cfg)

    # The grouped full loss of the padded mixed aspheric population.
    cfg_full = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused", **TIGHT_OFF_KINK)
    specs, lens = k4_population(torch, zoo, "mixed")

    def value_and_grad(specs, lens):
        params = [getattr(lens, k).detach().clone().requires_grad_(True) for k in K4_PARAMS]
        total, _ = simulator.compute_losses(specs, lens.replace(**dict(zip(K4_PARAMS, params))),
                                            cfg_full)
        return float(total.detach()), [g.cpu() for g in torch.autograd.grad(total, params)]

    fused_asphere.K4_FWD_LAUNCHES = 0
    fused_asphere.K4_BWD_LAUNCHES = 0
    total, grads = value_and_grad(specs, lens)
    torch.cuda.synchronize()
    full = (fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES)
    check(full == (2, 2) and math.isfinite(total)
          and all(bool(torch.isfinite(g).all()) for g in grads),
          f"mixed aspheric full loss of {N_SYSTEMS} systems: K4 full forward launched {full[0]} "
          f"times, backward {full[1]} times (one per lens type); total {total:.6f}, gradients "
          "finite")
    # Card vs CPU on 8 systems of both types. A ray at a failure threshold
    # may flip between the two (their front-ends round otherwise): the lanes
    # that differ are counted, each system's rows of the gradients are
    # compared where its masks agree (a system's parameters reach only its
    # own rays), the total where all agree. The gradients' float32 floor on
    # these aberrated designs is measured, not assumed: each group is held
    # within 1e-4 plus 4x the CPU's own move when c moves by one ulp.
    rows = np.r_[0:4, N_SYSTEMS - 4:N_SYSTEMS]
    cfg_lu = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused")
    host_specs, host_lens = specs[rows].to("cpu"), lens[rows].to("cpu")
    with torch.no_grad():
        res_card = simulator.do_ray_tracing(specs[rows], lens[rows], cfg_lu)[0]
        res_host = simulator.do_ray_tracing(host_specs, host_lens, cfg_lu)[0]
    lanes, agree = per_system_gap(torch, res_card.ray_ok, res_host.ray_ok)
    got = value_and_grad(specs[rows], lens[rows])
    want = value_and_grad(host_specs, host_lens)
    nudged = value_and_grad(host_specs, host_lens.replace(c=host_lens.c * (1 + 2.0 ** -23)))
    real = torch.as_tensor(lens[rows].structure.mask) & agree[:, None]
    gap, floor = group_gaps(torch, got[1], want[1], real), group_gaps(torch, nudged[1], want[1], real)
    rel = abs(got[0] - want[0]) / abs(want[0])
    check(int(agree.sum()) >= 6 and all(gap[k] <= 1e-4 + 4 * floor[k] for k in K4_PARAMS)
          and (lanes > 0 or rel <= 1e-5),
          f"mixed aspheric full loss on 8 systems, CUDA vs CPU: lanes whose ray_ok differs "
          f"{lanes}, systems whose masks agree {int(agree.sum())}; total {got[0]:.7f} vs "
          f"{want[0]:.7f} (relative gap {rel:.2e}, limit 1e-05 where all masks agree); "
          "d/d(c, t, kappa, asph) on those systems' real surfaces within "
          + ", ".join(f"{k} {gap[k]:.2e} (limit 1e-04 + 4 x {floor[k]:.2e})" for k in K4_PARAMS)
          + " of each group's largest; the parenthesis holds the CPU's own move under one ulp "
          "of c")
    return train, full


def k4_term_gradients(torch, fused_batch, specs, lens, cfg):
    """d/d(c, t, kappa, asph) of the spot term (the mean rms) and of the
    mean Lu of ``batched_unsupervised_loss``, on the CPU."""
    params = [getattr(lens, k).detach().clone().requires_grad_(True) for k in K4_PARAMS]
    lu, terms = fused_batch.batched_unsupervised_loss(
        specs, lens.replace(**dict(zip(K4_PARAMS, params))), cfg)
    g_rms = torch.autograd.grad(terms["rms"].mean(), params, retain_graph=True)
    return [g.cpu() for g in g_rms], [g.cpu() for g in torch.autograd.grad(lu, params)]


def phase_k4_fixed_bar(torch, zoo, simulator, fused_batch, cfg):
    """K4's training path at a bar that does not scale with the data: 8
    systems of ``zoo.population("double_gauss_asph", 8)`` (conics and
    asphere terms, curvatures perturbed by 2 %), defocused by 0.05 mm as
    the asphere tests do, the first step's gradients on the card against the
    CPU. The spot term's gradients (through K4's Lu mode forward and
    backward) within a fixed 1e-4 of each group's largest. The whole Lu's
    gap is reported beside the CPU's own move under one ulp of c: its
    theta_norm sums amplify one ulp of cos² near normal incidence."""
    specs, lens = zoo.population("double_gauss_asph", 8, device="cuda")
    last = torch.zeros_like(lens.t)
    last[:, -1] = 0.05
    lens = lens.replace(t=lens.t + last)
    card = k4_term_gradients(torch, fused_batch, specs, lens, cfg)
    host_specs, host_lens = specs.to("cpu"), lens.to("cpu")
    host = k4_term_gradients(torch, fused_batch, host_specs, host_lens, cfg)
    nudged = k4_term_gradients(torch, fused_batch, host_specs,
                               host_lens.replace(c=host_lens.c * (1 + 2.0 ** -23)), cfg)
    every = torch.ones(lens.c.shape, dtype=torch.bool)
    rms_gap = group_gaps(torch, card[0], host[0], every)
    lu_gap, lu_floor = group_gaps(torch, card[1], host[1], every), group_gaps(torch, nudged[1],
                                                                           host[1], every)
    check(max(rms_gap.values()) <= 1e-4,
          "fixed bar on 8 systems of the defocused aspherized double-Gauss population, CUDA vs "
          "CPU: d(spot term)/d(c, t, kappa, asph) within "
          + ", ".join(f"{k} {v:.2e}" for k, v in rms_gap.items())
          + " of each group's largest (limit 1e-04, fixed); d(Lu) within "
          + ", ".join(f"{k} {lu_gap[k]:.2e} (CPU's own move under one ulp of c "
                      f"{lu_floor[k]:.2e})" for k in K4_PARAMS))


def phase_k4_timing(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere, card):
    """K4 and its plain versions per mode at the generator width (256 x 1,536
    = 393,216 rays, aspheric Cooke population), the kernels' batches
    enqueued behind a sleep kernel as K2's; the fwd+bwd of
    ``batched_unsupervised_loss`` and one training step (host clock)."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    ms, (inputs, n_per_w, mask, bounds, _) = mode_times(
        torch, zoo, simulator, (fused_trace, fused_batch, fused_asphere), "k4", True, gen)
    n_rays, n_surf = inputs[0].numel(), inputs[4].shape[1]
    newton = newton_statistics(torch, fused_asphere, inputs, n_per_w, mask)
    shape = dict(n_rays=n_rays, n_surf=n_surf, n_w=inputs[7].shape[2], n_asph=inputs[8].shape[2],
                 bounds=bounds, n_sys=N_SYSTEMS, rays_per_sys=inputs[0].shape[1],
                 newton_steps=newton["steps_per_lane"],
                 newton_steps_per_warp=newton["steps_per_warp"],
                 newton_no_period=newton["no_period_share"])
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused")
    specs, lens = k4_population(torch, zoo, "cooke")

    def fwd_bwd():
        params = [getattr(lens, k).detach().clone().requires_grad_(True) for k in K4_PARAMS]
        loss = fused_batch.batched_unsupervised_loss(
            specs, lens.replace(**dict(zip(K4_PARAMS, params))), cfg)[0]
        torch.autograd.grad(loss, params)
    ms["asphere_batched_unsupervised_loss_fwd_bwd"] = time_ms(torch, fwd_bwd, runs=5, batch=4)
    ms["asphere_population_step"] = host_ms(torch, k4_train_step(torch, fused_batch, specs, lens,
                                                                  cfg))
    for key, value in ms.items():
        print(f"time {key}: {value:.4f} ms per call at {n_rays} rays ({N_SYSTEMS} aspheric Cooke "
              f"systems x 1,536 rays, {n_surf} surfaces, K = {shape['n_asph']}, n_iter = 10 "
              f"Newton steps, {shape['newton_steps']:.4f} a lane before they repeat, "
              f"{shape['newton_steps_per_warp']:.4f} a warp, a share "
              f"{shape['newton_no_period']:.6f} of lane-surfaces without a repeat), card: "
              f"{card}", flush=True)
    return ms, shape


def k4_bound(shape, penalties, backward, n_iter=None):
    """(bound_ms, bound_by) of K4 forward or backward at the timed shape:
    K3's per-ray operations and bytes (``k3_ops``, at the Newton steps the
    inputs need or at ``n_iter``) at the population's surface count, plus
    each system's tables read once (3 S + S W + S K + 1 floats, + S + 1 in
    full mode) and, for the backward, its partials (one column of doubles
    per block of 256 rays, written once and read once)."""
    n, n_surf, n_w, n_asph = shape["n_rays"], shape["n_surf"], shape["n_w"], shape["n_asph"]
    n_sides = sum(math.isfinite(v) for gap in shape["bounds"] for v in gap)
    n_iter, no_period = newton_of(shape, n_iter)
    ops = k3_ops(penalties, n_surf, n_asph, n_iter, backward, n_sides, no_period).total
    full = penalties == "full"
    tables = 4 * (3 * n_surf + n_surf * n_w + n_surf * n_asph + 1 + (n_surf + 1 if full else 0))
    if not backward:
        return bound(n, ops, FWD_BYTES[penalties], shape["n_sys"] * tables)
    n_params = (1 + 3 * n_surf + n_surf * n_w + n_surf * n_asph + (n_surf + 1 if full else 0))
    blocks = -(-shape["rays_per_sys"] // 256)
    return bound(n, ops, BWD_BYTES[penalties],
                 shape["n_sys"] * (tables + 16 * n_params * blocks))


def k4_entries(ms, shape, err, serve_launches, train_launches, full_launches):
    """The K4 entries of the kernels line. ``launches`` counts the main path
    of this slice, the aspheric population's training (Lu mode; the full
    mode's from the mixed population's grouped full loss); each entry's main
    numbers are for that mode, the other modes' under their own keys. K4
    backward's parameter deviation is per system, relative to its largest
    parameter cotangent."""
    def numbers(kind, penalties, suffix=""):
        mode = MODE_NAME[penalties]
        b_ms, b_by = k4_bound(shape, penalties, kind == "bwd")
        return {f"ms{suffix}": ms[f"k4_{kind}_{mode}"],
                f"plain_ms{suffix}": ms[f"plain_k4_{kind}_{mode}"],
                f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by,
                f"bound_ms_n10{suffix}": k4_bound(shape, penalties, kind == "bwd", 10)[0]}
    return [
        {"name": "k4_fwd", "route": "cuda", "source": K4_FWD_SOURCE, "replaces": TPU_K4_FWD,
         "launches": train_launches[0], "max_abs_err": err["fwd"], **numbers("fwd", True),
         "library_ms": None, "launches_serving": serve_launches,
         "newton_steps_per_lane": shape["newton_steps"],
         "newton_steps_per_warp": shape["newton_steps_per_warp"],
         "newton_no_period_share": shape["newton_no_period"],
         **numbers("fwd", False, "_plain")},
        {"name": "k4_fwd_full", "route": "cuda", "source": K4_FWD_SOURCE, "replaces": TPU_K4_FWD,
         "launches": full_launches[0], "max_abs_err": err["fwd_full"], **numbers("fwd", "full"),
         "library_ms": None},
        {"name": "k4_bwd", "route": "cuda", "source": K4_BWD_SOURCE, "replaces": TPU_K4_BWD,
         "launches": train_launches[1], "max_abs_err": err["bwd_ray"], **numbers("bwd", True),
         "library_ms": None, "launches_full_loss": full_launches[1],
         "param_max_abs_err": err["bwd_param_abs"], "param_max_rel_err": err["bwd_param"],
         **numbers("bwd", False, "_plain"), **numbers("bwd", "full", "_full"),
         "asphere_batched_unsupervised_loss_fwd_bwd_ms":
             ms["asphere_batched_unsupervised_loss_fwd_bwd"],
         "asphere_population_step_ms": ms["asphere_population_step"]},
    ]


# ---------------------------------------------------------------------------
# The wavefront path: the opl mode of K1-K4, ops/wavefront.py and
# analysis.wavefront_rms.
# ---------------------------------------------------------------------------

# The JAX OPL benchmark's width (bench.py _opl_workload): 16 fields x 96^2
# circular pupil x 3 wavelengths = 442,368 rays, one ray-aiming iteration.
OPL_CONFIG = dict(mode="circular", n_rays=(96, 96),
                  rel_fields=tuple(float(f) for f in np.linspace(0.0, 1.0, 16)),
                  wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1)
# 32 fields x 160^2 x 3 = 2,457,600 rays: K1 and K3's timing width.
OPL_BENCH = dict(OPL_CONFIG, n_rays=(160, 160),
                 rel_fields=tuple(float(f) for f in np.linspace(0.0, 1.0, 32)))
# 5 fields x 16^2 x 3 = 3,840 rays: the card-vs-CPU gradients of training.
OPL_ENTRY = dict(OPL_CONFIG, n_rays=(16, 16), rel_fields=(0.0, 0.5, 0.7, 0.85, 1.0))
OPL_KERNELS = ("k1", "k2", "k3", "k4")
OPL_SOURCES = {"k1": (FWD_SOURCE, BWD_SOURCE, TPU_FWD, TPU_BWD),
               "k2": (K2_FWD_SOURCE, K2_BWD_SOURCE, TPU_K2_FWD, TPU_K2_BWD),
               "k3": (K3_FWD_SOURCE, K3_BWD_SOURCE, TPU_K3_FWD, TPU_K3_BWD),
               "k4": (K4_FWD_SOURCE, K4_BWD_SOURCE, TPU_K4_FWD, TPU_K4_BWD)}
# The opl mode's bytes per ray: 12 read, 22 written forward; 12 + 20 read
# and 12 written backward.
OPL_FWD_BYTES, OPL_BWD_BYTES = 34, 44
# Adam's step sizes for the wavefront_rms training runs (c, t; asph).
WAVEFRONT_LR = {"c": 1e-6, "t": 1e-5, "asph": 1e-10}


def opl_counters(fused_trace, fused_batch, fused_asphere):
    """(module, counter name) of every launch counter, by kernel."""
    return {"k1": (fused_trace, "K1"), "k2": (fused_batch, "K2"),
            "k3": (fused_asphere, "K3"), "k4": (fused_asphere, "K4")}


def reset_launches(counters):
    for module, name in counters.values():
        setattr(module, f"{name}_FWD_LAUNCHES", 0)
        setattr(module, f"{name}_BWD_LAUNCHES", 0)


def read_launches(counters):
    """{kernel: (forward, backward)} launches since the last reset."""
    return {k: (getattr(m, f"{n}_FWD_LAUNCHES"), getattr(m, f"{n}_BWD_LAUNCHES"))
            for k, (m, n) in counters.items()}


def opl_kernel_inputs(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere, kernel,
                      variant, config=OPL_CONFIG):
    """One opl kernel's inputs, ending with n_legs, its n_per_w and surface
    mask: K1 on the double-Gauss and K3 on the aspherized double-Gauss at
    ``config``'s width, c x ``variant``; K2 on the 256-system Cooke
    population ('cooke': c x 1.5 on every 8th system; 'mixed': 128 Cooke +
    128 double-Gauss, padded) and K4 on the aspheric Cooke population
    ('cooke c x 3', 'mixed') at the generator width."""
    from torchoptics_tpu_torch import trace
    if kernel in ("k1", "k3"):
        cfg = trace.TraceConfig(**config)
        specs, lens = zoo.build("double_gauss" if kernel == "k1" else "double_gauss_asph",
                                device="cuda")
        lens = lens.replace(c=lens.c * variant)
        with torch.no_grad():
            xp, yp, cyb, z0, mu, (_, F, P, _) = fused_trace.prepare_fused_inputs(specs, lens, cfg)
        n_legs = fused_trace.leg_indices(lens, cfg.wavelengths)[0]
        if kernel == "k1":
            ins = (xp, yp, cyb, z0, lens.c[0], lens.t[0], mu, n_legs)
        else:
            ins = (xp, yp, cyb, z0, lens.c[0], lens.kappa[0], lens.t[0], mu, lens.asph[0], n_legs)
        return tuple(a.detach().contiguous() for a in ins), F * P, None
    cfg = simulator.SimulatorConfig(**GEN_WIDTH).trace_config()
    if kernel == "k2":
        specs, lens = population_inputs(torch, zoo, simulator, fused_batch, fused_trace,
                                        variant)[:2]
    else:
        specs, lens = k4_population(torch, zoo, variant)
    with torch.no_grad():
        xp, yp, cyb, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(specs, lens, cfg)
    n_legs = fused_trace.leg_indices(lens, cfg.wavelengths)
    if kernel == "k2":
        ins = (xp, yp, cyb, z0, lens.c, lens.t, mu, n_legs)
    else:
        ins = (xp, yp, cyb, z0, lens.c, lens.kappa, lens.t, mu, lens.asph, n_legs)
    return (tuple(a.detach().contiguous() for a in ins), F * P,
            fused_batch._static_mask(lens.structure, "cuda"))


def run_opl(modules, kernel, inputs, n_per_w, mask, allow_backward, plain, cot=None):
    """One opl kernel forward (``cot`` None) or backward, launched or its
    plain version."""
    fused_trace, fused_batch, fused_asphere = modules
    if cot is None:
        if kernel == "k1":
            return (fused_trace.trace_fused_reference(*inputs[:7], "opl", allow_backward,
                                                      n_per_w, n_legs=inputs[7]) if plain else
                    fused_trace._launch_k1_fwd(inputs, "opl", allow_backward, n_per_w, (), 0.25))
        if kernel == "k2":
            return (fused_batch.trace_fused_batch_reference(
                *inputs[:7], "opl", allow_backward, n_per_w, mask, n_legs=inputs[7]) if plain else
                fused_batch._launch_k2_fwd(inputs, "opl", allow_backward, n_per_w, mask, (),
                                           0.25))
        if kernel == "k3":
            return (fused_asphere.trace_fused_asphere_reference(
                *inputs[:9], "opl", allow_backward, n_per_w, 10, n_legs=inputs[9]) if plain else
                fused_asphere._launch_k3_fwd(inputs, "opl", allow_backward, n_per_w, 10, (), 0.25))
        return (fused_asphere.trace_fused_asphere_batch_reference(
            *inputs[:9], "opl", allow_backward, n_per_w, 10, mask, n_legs=inputs[9]) if plain else
            fused_asphere._launch_k4_fwd(inputs, "opl", allow_backward, n_per_w, 10, mask, (),
                                         0.25))
    if kernel == "k1":
        return (fused_trace.trace_fused_backward_reference(inputs, cot, "opl", allow_backward,
                                                           n_per_w) if plain else
                fused_trace._launch_k1_bwd(inputs, cot, "opl", allow_backward, n_per_w, (), 0.25))
    if kernel == "k2":
        return (fused_batch.trace_fused_batch_backward_reference(
            inputs, cot, "opl", allow_backward, n_per_w, mask) if plain else
            fused_batch._launch_k2_bwd(inputs, cot, "opl", allow_backward, n_per_w, mask, (),
                                       0.25))
    if kernel == "k3":
        return (fused_asphere.trace_fused_asphere_backward_reference(
            inputs, cot, "opl", allow_backward, n_per_w, 10) if plain else
            fused_asphere._launch_k3_bwd(inputs, cot, "opl", allow_backward, n_per_w, 10, (),
                                         0.25))
    args = ("opl", allow_backward, n_per_w, 10, mask, (), 0.25)
    return (fused_asphere.trace_fused_asphere_batch_backward_reference(inputs, cot, *args)
            if plain else fused_asphere._launch_k4_bwd(inputs, cot, *args))


def opl_param_rows(torch, grads, population):
    """The parameter cotangents as rows, one per system (a single system's
    groups as rows of their own), for the relative comparison."""
    if population:
        return [torch.cat([g.reshape(g.shape[0], -1) for g in grads[3:]], 1)]
    return [g.reshape(1, -1) for g in grads[3:]]


def opl_compare(torch, got, want, g1, g2, gw, population):
    """(ok, largest float deviation forward, per-ray deviation backward,
    largest parameter deviation relative to its row's largest, largest
    absolute parameter deviation, two backward launches bit-identical)."""
    fwd_exact = all(torch.equal(a, b) for a, b in zip(got, want))
    fwd_dev = max(float((got[i] - want[i]).abs().max()) for i in (0, 1, 2, 3, 6))
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    ray = max(float((g1[i] - gw[i]).abs().max()) for i in range(3))
    rel, dev = 0.0, 0.0
    for a, b in zip(opl_param_rows(torch, g1, population), opl_param_rows(torch, gw, population)):
        rel = max(rel, float(((a - b).abs().max(1).values
                              / b.abs().max(1).values.clamp(min=1e-30)).max()))
        dev = max(dev, float((a - b).abs().max()))
    finite = all(bool(torch.isfinite(a).all()) for a in g1)
    ok = fwd_exact and same and finite and ray == 0.0 and rel <= ONE_ROUNDING
    return ok, fwd_dev, ray, rel, dev, same


OPL_VARIANTS = {"k1": (1.0, 3.0), "k3": (1.0, 3.0), "k2": ("cooke", "mixed"),
                "k4": ("cooke c x 3", "mixed")}


def phase_opl_kernels(torch, zoo, simulator, modules):
    """Each opl kernel, forward and backward, against its plain version, both
    backward-ray policies, seeded cotangents (x, y, cx, cy, opl): K1 and K3
    at 442,368 rays on their lens and its c x 3 variant, K2 and K4 on two
    256-system populations at 393,216 rays (one padded: the surface mask).
    Forward outputs (masks, coordinates, opl) and per-ray cotangents bit for
    bit, parameter and dn_legs sums within one float32 rounding, two
    backward launches bit for bit. Returns the largest deviations per
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    worst = {k: dict(fwd=0.0, ray=0.0, param=0.0, param_abs=0.0) for k in OPL_KERNELS}
    failed = []
    for kernel in OPL_KERNELS:
        for variant in OPL_VARIANTS[kernel]:
            inputs, n_per_w, mask = opl_kernel_inputs(torch, zoo, simulator, *modules, kernel,
                                                      variant)
            population = kernel in ("k2", "k4")
            for allow_backward in (True, False):
                with torch.no_grad():
                    got = run_opl(modules, kernel, inputs, n_per_w, mask, allow_backward, False)
                    want = run_opl(modules, kernel, inputs, n_per_w, mask, allow_backward, True)
                cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
                       for _ in range(5)]
                g1 = run_opl(modules, kernel, inputs, n_per_w, mask, allow_backward, False, cot)
                g2 = run_opl(modules, kernel, inputs, n_per_w, mask, allow_backward, False, cot)
                gw = run_opl(modules, kernel, inputs, n_per_w, mask, allow_backward, True, cot)
                torch.cuda.synchronize()
                ok, fwd_dev, ray, rel, dev, same = opl_compare(torch, got, want, g1, g2, gw,
                                                               population)
                w = worst[kernel]
                w.update(fwd=max(w["fwd"], fwd_dev), ray=max(w["ray"], ray),
                         param=max(w["param"], rel), param_abs=max(w["param_abs"], dev))
                label = f"c x {variant}" if not population else f"{variant} population"
                print(f"{'ok  ' if ok else 'FAIL'} {kernel.upper()} opl vs plain, {label} "
                      f"({inputs[0].numel()} rays{', masked' if mask is not None else ''}), "
                      f"allow_backward={allow_backward}: forward bit-identical (masks, "
                      f"coordinates, opl; max deviation {fwd_dev:.3e}), per-ray cotangents "
                      f"deviation {ray:.3e}, parameter and dn_legs sums within {rel:.2e} of "
                      f"their largest (limit {ONE_ROUNDING:.2e}), two launches bit-identical="
                      f"{same}; ray_ok share {float(got[4].float().mean()):.6f}, mean opl "
                      f"{float(got[6][got[4]].mean()):.4f} mm", flush=True)
                if not ok:
                    failed.append((kernel, variant, allow_backward))
            del inputs
    check(not failed, f"the opl modes of K1-K4 agree with their plain versions (failed: "
          f"{failed})")
    return worst


def phase_opl_population_of_one(torch, zoo, simulator, modules):
    """K2's opl mode at B = 1 against K1's, and K4's against K3's, at
    442,368 rays: forward and backward bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    for single, one in (("k1", "k2"), ("k3", "k4")):
        inputs, n_per_w, _ = opl_kernel_inputs(torch, zoo, simulator, *modules, single, 1.0)
        batch = tuple(a.reshape(1) if i == 3 else a[None] for i, a in enumerate(inputs))
        cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen) for _ in range(5)]
        with torch.no_grad():
            a = run_opl(modules, single, inputs, n_per_w, None, True, False)
            b = run_opl(modules, one, batch, n_per_w, None, True, False)
        ga = run_opl(modules, single, inputs, n_per_w, None, True, False, cot)
        gb = run_opl(modules, one, batch, n_per_w, None, True, False, [c[None] for c in cot])
        torch.cuda.synchronize()
        same_f = all(torch.equal(x, y[0]) for x, y in zip(a, b))
        same_b = all(torch.equal(x.reshape(-1), y.reshape(-1)) for x, y in zip(ga, gb))
        check(same_f and same_b,
              f"{one.upper()} opl at B = 1 vs {single.upper()} opl, {inputs[0].numel()} rays: "
              f"forward bit-identical={same_f}, backward (per-ray, parameter and dn_legs "
              f"cotangents) bit-identical={same_b}")


def wavefront_analysis(torch, wf, specs, lens, cfg, xy):
    """opd_map, the Zernike fit (Noll j <= 11) per (system, field,
    wavelength), and the Strehl ratio of the residual after piston, tilt and
    defocus, on pupil points ``xy``."""
    out = wf.opd_map(specs, lens, cfg, xy=xy)
    opd, ok = out["opd"], out["ok"]
    minor = lambda v: torch.movedim(torch.broadcast_to(v, opd.shape), 2, -1)
    opd_m, ok_m, xr, yr = minor(opd), minor(ok), minor(xy[0]), minor(xy[1])
    coef = wf.zernike_fit(opd_m, xr, yr, ok_m, j_max=11)
    low = torch.sum(wf.zernike_basis(4, xr, yr) * coef[..., None, :4], dim=-1)
    lam = torch.tensor([w * 1e-6 for w in cfg.wavelengths], device=opd.device)
    strehl = wf.strehl_ratio(torch.where(ok_m, opd_m - low, 0.0), ok_m, lam.reshape(1, 1, -1, 1))
    return dict(out, coef=coef, strehl=strehl)


def phase_wavefront_serve(torch, zoo, modules):
    """Serving at the JAX OPL benchmark's width (442,368 rays): ``opd_map``,
    ``zernike_fit`` and ``strehl_ratio`` on the double-Gauss (K1 opl) and the
    aspherized double-Gauss (K3 opl), counts set to 0 before each and read
    after, held against the CPU: lanes whose mask differs (the front-ends
    round otherwise: at most 4), OPD within 5e-5 mm where both are ok, the
    Zernike coefficients within 5e-5 mm, the Strehl ratios within the bound
    that OPD gap allows (2 x 2 pi / lambda x the largest OPD gap). Returns
    the launches of each serving run."""
    from torchoptics_tpu_torch import trace
    from torchoptics_tpu_torch.ops import wavefront as wf
    counters = opl_counters(*modules)
    cfg = trace.TraceConfig(**OPL_CONFIG, engine="fused")
    launches = {}
    for name, kernel in (("double_gauss", "k1"), ("double_gauss_asph", "k3")):
        specs, lens = zoo.build(name, device="cuda")
        xy = pupil_points(torch, cfg, "cuda")
        reset_launches(counters)
        with torch.no_grad():
            card = wavefront_analysis(torch, wf, specs, lens, cfg, xy)
        torch.cuda.synchronize()
        runs = read_launches(counters)
        launches[kernel] = runs[kernel]
        others = sum(sum(v) for k, v in runs.items() if k != kernel)
        with torch.no_grad():
            host = wavefront_analysis(torch, wf, specs.to("cpu"), lens.to("cpu"), cfg,
                                      tuple(v.cpu() for v in xy))
        ok_card, ok_host = card["ok"].cpu(), host["ok"]
        lanes = int((ok_card != ok_host).sum())
        both = ok_card & ok_host
        gaps = (card["opd"].cpu() - host["opd"]).abs()[both]
        opd_gap, opd_p999 = float(gaps.max()), float(torch.quantile(gaps, 0.999))
        coef_gap = float((card["coef"].cpu() - host["coef"]).abs().max())
        strehl_gap = float((card["strehl"].cpu() - host["strehl"]).abs().max())
        strehl_bar = 2 * 2 * math.pi / (OPL_CONFIG["wavelengths"][0] * 1e-6) * opd_gap + 1e-5
        finite = bool(torch.isfinite(card["opd"][card["ok"]]).all())
        check(runs[kernel] == (2, 0) and others == 0 and finite and lanes <= 4
              and opd_gap <= 5e-5 and coef_gap <= 5e-5 and strehl_gap <= strehl_bar,
              f"wavefront serving on the {name}, {card['opd'].numel()} rays (16 fields x 96^2 x "
              f"3 wavelengths): {kernel.upper()} opl forward launched {runs[kernel][0]} times "
              f"(the bundle and the chief ray), backward {runs[kernel][1]}, other kernels "
              f"{others}; card vs CPU: lanes whose ray_ok differs {lanes} (limit 4), OPD within "
              f"{opd_gap:.3e} mm (limit 5e-05; 99.9 % of rays within {opd_p999:.3e}), Zernike coefficients within {coef_gap:.3e} mm, "
              f"Strehl within {strehl_gap:.3e} (limit {strehl_bar:.3e}); on-axis Strehl "
              f"{float(card['strehl'][0, 0, 1]):.4f}, edge {float(card['strehl'][0, -1, 1]):.4f}"
              f", RMS OPD {float(card['opd'][card['ok']].std()) * 1e6:.1f} nm")
    return launches


def pupil_points(torch, cfg, device):
    """The relative pupil points of ``cfg``'s sampler, drawn once."""
    from torchoptics_tpu_torch.ops import pupil
    return pupil.sample_pupil(cfg.mode, cfg.n_rays, 1, device=device)


def phase_population_wavefront(torch, zoo, simulator, modules):
    """The population wavefront at the generator width (256 x 1,536 rays):
    ``opd_map`` and the fwd+bwd of ``wavefront_rms`` (d/d c, t) on the
    256-system Cooke population (K2 opl) and the aspheric Cooke population
    (K4 opl), counts set to 0 before each and read after; card vs CPU on 8
    systems: OPD within 5e-5 mm where both are ok, the objective within
    rtol 1e-2 and its gradient within rtol 0.05 and 0.02 of the largest.
    Returns the launches of each kernel's run."""
    from torchoptics_tpu_torch import analysis
    from torchoptics_tpu_torch.ops import wavefront as wf
    counters = opl_counters(*modules)
    cfg = simulator.SimulatorConfig(**GEN_WIDTH, trace_engine="fused").trace_config()
    launches = {}
    for kernel, (specs, lens) in (("k2", zoo.population("cooke", N_SYSTEMS, device="cuda")),
                                  ("k4", k4_population(torch, zoo, "cooke"))):
        def run(specs, lens):
            c = lens.c.detach().clone().requires_grad_(True)
            t = lens.t.detach().clone().requires_grad_(True)
            with torch.no_grad():
                out = wf.opd_map(specs, lens, cfg)
            rms = analysis.wavefront_rms(specs, lens.replace(c=c, t=t), cfg)
            return out, float(rms.detach()), [g.cpu() for g in torch.autograd.grad(rms, (c, t))]
        reset_launches(counters)
        card = run(specs, lens)
        torch.cuda.synchronize()
        runs = read_launches(counters)
        launches[kernel] = runs[kernel]
        others = sum(sum(v) for k, v in runs.items() if k != kernel)
        rows = np.arange(8)
        small = run(specs[rows], lens[rows])
        host = run(specs[rows].to("cpu"), lens[rows].to("cpu"))
        both = small[0]["ok"].cpu() & host[0]["ok"]
        opd_gap = float((small[0]["opd"].cpu() - host[0]["opd"]).abs()[both].max())
        rms_gap = abs(small[1] - host[1]) / host[1]
        grad_gap = max(float(((a - b).abs() - 0.05 * b.abs()).max() / b.abs().max())
                       for a, b in zip(small[2], host[2]))
        check(runs[kernel] == (4, 2) and others == 0 and math.isfinite(card[1])
              and all(bool(torch.isfinite(g).all()) for g in card[2]) and opd_gap <= 5e-5
              and rms_gap <= 1e-2 and grad_gap <= 0.02,
              f"population wavefront, {N_SYSTEMS} {'aspheric ' if kernel == 'k4' else ''}Cooke "
              f"designs x 1,536 rays: {kernel.upper()} opl forward launched {runs[kernel][0]} "
              f"times (opd_map and wavefront_rms, each the bundle and the chief ray), backward "
              f"{runs[kernel][1]}, other kernels {others}; wavefront_rms {card[1] * 1e6:.2f} nm, "
              f"finite gradients; card vs CPU on 8 systems: OPD within {opd_gap:.3e} mm (limit "
              f"5e-05), wavefront_rms within {rms_gap:.2e} (limit 1e-02), d/d(c, t) beyond "
              f"rtol 0.05 by {grad_gap:.2e} of the largest (limit 0.02)")
    return launches


def phase_diffraction(torch, zoo, modules):
    """The diffraction PSF at the imaging defaults (simulator.py:56-79): OPD
    on a 64^2 pupil grid (K1 opl), then ``diffraction_psf_window`` onto a
    65 x 65 window at a 4 um pitch, oversample 4, per (field, wavelength), as
    ``imaging._sample_diffraction_psfs`` places it. TF32 must be off. The
    card's window of the CPU's inputs (OPD, mask, reference sphere, window
    offsets) against the CPU's, within 1e-5 of each PSF's peak (TF32 would
    round the DFT's inputs to 10 bits); the card's whole path against the
    CPU's within the bound that their input gaps allow: 2 x 2 pi / lambda x
    (the largest OPD gap + r_xp / R x the largest offset gap), of each PSF's
    peak. The energy
    share inside the window is reported: the 64^2 grid's alias period
    (lambda R N / (2 r_xp), ~70 um here) is shorter than the 260 um window,
    so replicas fold in and it exceeds 1, the imaging defaults' own limit
    (imaging.diffraction_sampling_report)."""
    from torchoptics_tpu_torch import trace
    from torchoptics_tpu_torch.ops import wavefront as wf
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          f"torch.backends.cuda.matmul.allow_tf32 is {torch.backends.cuda.matmul.allow_tf32} "
          "(must be False: the window's complex products run in full float32)")
    n = 64
    g = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    X, Y = np.meshgrid(g, g, indexing="xy")
    incircle = torch.tensor(((X ** 2 + Y ** 2) <= 1.0).ravel())
    cfg = trace.TraceConfig(mode="circular", n_rays=(n, n), rel_fields=(0.0, 0.7, 1.0),
                            wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1,
                            engine="fused")
    counters = opl_counters(*modules)

    def window_inputs(specs, lens, device):
        """The window's inputs from one opd_map, as imaging places them."""
        xy = tuple(torch.tensor(v.ravel()[None, None, :, None], dtype=torch.float32,
                                device=device) for v in (X, Y))
        with torch.no_grad():
            out = wf.opd_map(specs, lens, cfg, xy=xy)
            opd = out["opd"][0]
            ok = out["ok"][0] & incircle.to(device)[None, :, None]
            F, _, W = opd.shape
            z_xp = wf.exit_pupil_distance(lens)[0]
            r_xp = specs.epd[0] / 2.0 * wf.pupil_magnification(lens)[0]
            x_img, y_img = out["x_img"][0], out["y_img"][0]
            y_center = torch.mean(y_img, dim=1)
        lam = torch.tensor([w * 1e-6 for w in cfg.wavelengths], device=device)
        return dict(opd_grid=opd.permute(0, 2, 1).reshape(F, W, n, n),
                    ok_grid=ok.permute(0, 2, 1).reshape(F, W, n, n), wavelength_mm=lam[None, :],
                    R_mm=torch.sqrt(z_xp ** 2 + x_img ** 2 + y_img ** 2), r_xp_mm=r_xp,
                    x_offset=-x_img, y_offset=y_center[:, None] - y_img)

    def window(inputs):
        with torch.no_grad():
            return wf.diffraction_psf_window(**inputs, pitch_mm=4e-3, shape=(65, 65),
                                             oversample=4)

    specs, lens = zoo.build("double_gauss", device="cuda")
    reset_launches(counters)
    card_in = window_inputs(specs, lens, "cuda")
    card = window(card_in)
    torch.cuda.synchronize()
    runs = read_launches(counters)
    host_in = window_inputs(specs.to("cpu"), lens.to("cpu"), "cpu")
    host = window(host_in)
    same_in = window({k: v.to("cuda") for k, v in host_in.items()})
    peak = host["psf"].amax(dim=(-2, -1), keepdim=True)
    dft_gap = float(((same_in["psf"].cpu() - host["psf"]) / peak).abs().max())
    acc_gap = float((same_in["accounted"].cpu() - host["accounted"]).abs().max())
    ok_c, ok_h = card_in["ok_grid"].cpu(), host_in["ok_grid"]
    opd_gap = float((card_in["opd_grid"].cpu() - host_in["opd_grid"]).abs()[ok_c & ok_h].max())
    off_gap = max(float((card_in[k].cpu() - host_in[k]).abs().max())
                  for k in ("x_offset", "y_offset"))
    tilt = float(host_in["r_xp_mm"]) / float(host_in["R_mm"].min()) * off_gap
    path_gap = float(((card["psf"].cpu() - host["psf"]) / peak).abs().max())
    path_bar = 2 * 2 * math.pi / 459e-6 * (opd_gap + tilt) + 1e-5
    acc = card["accounted"].cpu()
    check(runs["k1"] == (2, 0) and torch.equal(ok_c, ok_h) and dft_gap <= 1e-5
          and acc_gap <= 1e-5 and path_gap <= path_bar and bool(torch.isfinite(acc).all()),
          f"diffraction PSF of the double-Gauss, 3 fields x 3 wavelengths, 64^2 pupil grid, "
          f"65 x 65 window at 4 um, oversample 4: K1 opl forward launched {runs['k1'][0]} times; "
          f"masks equal on the card and the CPU; the card's window of the CPU's inputs within "
          f"{dft_gap:.2e} of each PSF's peak (limit 1e-05), accounted within {acc_gap:.2e}; the "
          f"whole path within {path_gap:.2e} (limit {path_bar:.2e} from the OPD gap "
          f"{opd_gap:.2e} mm and the offset gap {off_gap:.2e} mm); accounted energy {float(acc.min()):.3f}-{float(acc.max()):.3f}")


def wavefront_optimizer(torch, zoo, name, params, device, config):
    """Adam on ``params`` of the zoo lens ``name`` against
    ``analysis.wavefront_rms`` on the fused engine; returns a closure running
    one step (the loss and the gradients)."""
    from torchoptics_tpu_torch import analysis, trace
    cfg = trace.TraceConfig(**config, engine="fused")
    specs, lens = zoo.build(name, device=device)
    xy = pupil_points(torch, cfg, device)
    leaves = {k: getattr(lens, k).detach().clone().requires_grad_(True) for k in params}
    opt = torch.optim.Adam([{"params": [v], "lr": WAVEFRONT_LR[k]} for k, v in leaves.items()])

    def step():
        loss = analysis.wavefront_rms(specs, lens.replace(**leaves), cfg, xy=xy)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for v, g in zip(leaves.values(), grads):
            v.grad = g
        opt.step()
        return loss.detach(), grads
    return step


def phase_wavefront_train(torch, zoo, modules, n_steps=5):
    """The training path of this slice: 5 Adam steps of ``wavefront_rms``
    at 442,368 rays on the double-Gauss's (c, t) (K1 opl forward and
    backward) and the aspherized double-Gauss's (c, asph) (K3 opl), counts
    set to 0 before each run and read after: every loss finite, two forward
    and two backward launches a step (the bundle and the chief ray). The
    first step's value and gradients held against the CPU at 3,840 rays
    (JAX's bar between its Pallas and XLA paths: rtol 1e-2; rtol 0.05 and
    0.02 of the largest). Then one step's host time (the median of 5).
    Returns the launches of each run and the step times."""
    counters = opl_counters(*modules)
    launches, step_ms = {}, {}
    for name, params, kernel in (("double_gauss", ("c", "t"), "k1"),
                                 ("double_gauss_asph", ("c", "asph"), "k3")):
        step = wavefront_optimizer(torch, zoo, name, params, "cuda", OPL_CONFIG)
        reset_launches(counters)
        losses, finite = [], True
        for _ in range(n_steps):
            loss, grads = step()
            losses.append(float(loss))
            finite = finite and math.isfinite(losses[-1]) and all(
                bool(torch.isfinite(g).all()) for g in grads)
        torch.cuda.synchronize()
        runs = read_launches(counters)
        launches[kernel] = runs[kernel]
        others = sum(sum(v) for k, v in runs.items() if k != kernel)
        check(runs[kernel] == (2 * n_steps, 2 * n_steps) and others == 0 and finite,
              f"wavefront_rms training on the {name}, {n_steps} Adam steps on {params} at "
              f"442368 rays: {kernel.upper()} opl forward launched {runs[kernel][0]} times, "
              f"backward {runs[kernel][1]}, other kernels {others}; every loss and gradient "
              f"finite={finite}; losses (nm) {['%.3f' % (v * 1e6) for v in losses]}")
        step_ms[kernel] = host_ms(torch, step, runs=5, warmup=1)
        (got, got_g), (want, want_g) = (
            (float(loss), [g.cpu() for g in grads]) for loss, grads in (
                wavefront_optimizer(torch, zoo, name, params, device, OPL_ENTRY)()
                for device in ("cuda", "cpu")))
        rel = abs(got - want) / want
        gaps = [float(((a - b).abs() - 0.05 * b.abs()).max() / b.abs().max())
                for a, b in zip(got_g, want_g)]
        exact = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got_g, want_g)]
        check(rel <= 1e-2 and max(gaps) <= 0.02,
              f"first wavefront_rms step on the {name} at 3840 rays, CUDA vs CPU: "
              f"{got * 1e6:.4f} vs {want * 1e6:.4f} nm (relative gap "
              f"{rel:.2e}, limit 1e-02); d/d{params} within "
              + ", ".join(f"{e:.2e}" for e in exact) + " of their largest (bar: rtol 0.05 "
              f"plus 0.02 of the largest); one step {step_ms[kernel]:.2f} ms (host clock)")
    return launches, step_ms


def phase_opl_fwd_bwd(torch, zoo, modules, card):
    """The fwd+bwd of the masked OPL sum with respect to (c, t) at 442,368
    rays on the double-Gauss (bench.py _opl_workload), on the fused engine
    (one K1 opl forward and one backward) and on the pure-torch engine,
    timed with CUDA events. Returns (times, launches of one fused call)."""
    from torchoptics_tpu_torch import trace
    from torchoptics_tpu_torch.ops import wavefront as wf
    specs, lens = zoo.build("double_gauss", device="cuda")
    xy = pupil_points(torch, trace.TraceConfig(**OPL_CONFIG), "cuda")
    counters = opl_counters(*modules)

    def fwd_bwd(engine):
        cfg = trace.TraceConfig(**OPL_CONFIG, engine=engine)
        c = lens.c.detach().clone().requires_grad_(True)
        t = lens.t.detach().clone().requires_grad_(True)
        res, opl = wf.optical_path_lengths(specs, lens.replace(c=c, t=t), cfg, xy=xy)
        return torch.autograd.grad(torch.sum(torch.where(res.ray_ok, opl, 0.0)), (c, t))

    reset_launches(counters)
    fused = fwd_bwd("fused")
    torch.cuda.synchronize()
    runs = read_launches(counters)
    unroll = fwd_bwd("unroll")
    gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(fused, unroll))
    ms = {"opl_fwd_bwd_fused": time_ms(torch, lambda: fwd_bwd("fused"), runs=5, batch=4),
          "opl_fwd_bwd_unroll": time_ms(torch, lambda: fwd_bwd("unroll"), runs=3, batch=2)}
    check(runs["k1"] == (1, 1) and gap <= 1e-4,
          f"masked OPL sum fwd+bwd w.r.t. (c, t) at 442368 rays: K1 opl forward launched "
          f"{runs['k1'][0]} times, backward {runs['k1'][1]}; fused vs pure-torch engine "
          f"gradients within {gap:.2e} of the largest (limit 1e-04); "
          f"{ms['opl_fwd_bwd_fused']:.3f} ms fused, {ms['opl_fwd_bwd_unroll']:.3f} ms pure "
          f"torch, card: {card}")
    return ms, runs["k1"]


def phase_opl_timing(torch, zoo, simulator, modules, card):
    """Each opl kernel and its plain versions with CUDA events, as their
    sibling modes are timed: K1 and K3 at 2,457,600 rays, K2 and K4 at
    256 x 1,536 = 393,216 rays (the population kernels' batches enqueued
    behind a sleep kernel). Returns the times and the timed shapes."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    ms, shapes = {}, {}
    for kernel in OPL_KERNELS:
        times, (inputs, n_per_w, mask) = opl_times(torch, zoo, simulator, modules, kernel, True,
                                                   gen)
        ms.update(times)
        c = inputs[4]
        shapes[kernel] = dict(n_rays=inputs[0].numel(), n_surf=c.shape[-1],
                              n_w=inputs[-1].shape[-1],
                              n_asph=inputs[8].shape[-1] if kernel in ("k3", "k4") else 0,
                              n_sys=inputs[0].shape[0] if kernel in ("k2", "k4") else 1,
                              rays_per_sys=inputs[0].shape[-1])
        if kernel in ("k3", "k4"):
            newton = newton_statistics(torch, modules[2], inputs, n_per_w, mask)
            shapes[kernel].update(newton_steps=newton["steps_per_lane"],
                                  newton_no_period=newton["no_period_share"])
        print(f"time {kernel.upper()} opl: forward {ms[f'{kernel}_fwd']:.4f} ms (plain "
              f"{ms[f'plain_{kernel}_fwd']:.2f} ms), backward {ms[f'{kernel}_bwd']:.4f} ms "
              f"(plain {ms[f'plain_{kernel}_bwd']:.2f} ms) per call at {inputs[0].numel()} rays, "
              f"{c.shape[-1]} surfaces, card: {card}", flush=True)
        del inputs
    return ms, shapes


def opl_times(torch, zoo, simulator, modules, kernel, plain, gen, split=False):
    """One opl kernel forward and backward (backward rays allowed) with CUDA
    events: K1 and K3 at 2,457,600 rays, K2 and K4 at 256 x 1,536 = 393,216
    rays (the population kernels' batches enqueued behind a sleep kernel);
    their plain versions too where ``plain`` is set. Returns the times
    ({kernel}_fwd, {kernel}_bwd and plain_...) and (inputs, n_per_w,
    mask)."""
    variant = {"k1": 1.0, "k3": 1.0, "k2": "cooke", "k4": "cooke"}[kernel]
    inputs, n_per_w, mask = opl_kernel_inputs(torch, zoo, simulator, *modules, kernel, variant,
                                              OPL_BENCH)
    cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen) for _ in range(5)]
    run = lambda plain, cot=None: run_opl(modules, kernel, inputs, n_per_w, mask, True, plain,
                                          cot)
    ms = fwd_bwd_times(torch, kernel, "", run, lambda plain: run(plain, cot), plain,
                       kernel in ("k2", "k4"), split)
    return ms, (inputs, n_per_w, mask)


def opl_bound(kernel, shape, backward, n_iter=None):
    """(bound_ms, bound_by) of an opl kernel at the timed shape: the plain
    mode's per-ray operations (``k1_ops``, ``k3_ops``) plus the opl terms
    (forward: a product and a sum per leg; backward: the distance adjoint's
    product and sum and the dn_legs term and its sum per leg), the opl
    bytes per ray, and for a population each system's tables (with the
    (S+1) x W n_legs) and, backward, its partials."""
    n, n_surf, n_w = shape["n_rays"], shape["n_surf"], shape["n_w"]
    legs = n_surf + 1
    if kernel in ("k1", "k2"):
        ops = k1_ops(False, n_surf, 0, backward).total
        tables = 2 * n_surf + n_surf * n_w + 1
        n_params = 1 + 2 * n_surf + n_surf * n_w
    else:
        n_iter, no_period = newton_of(shape, n_iter)
        ops = k3_ops(False, n_surf, shape["n_asph"], n_iter, backward, 0, no_period).total
        tables = 3 * n_surf + n_surf * n_w + n_surf * shape["n_asph"] + 1
        n_params = 1 + 3 * n_surf + n_surf * n_w + n_surf * shape["n_asph"]
    ops += (4 if backward else 2) * legs
    tables, n_params = 4 * (tables + legs * n_w), n_params + legs * n_w
    extra = shape["n_sys"] * tables
    if backward:
        extra += shape["n_sys"] * 16 * n_params * -(-shape["rays_per_sys"] // 256)
    return bound(n, ops, OPL_BWD_BYTES if backward else OPL_FWD_BYTES, extra)


def opl_entries(ms, shapes, worst, serve, pop, train, fwd_bwd_launches, fwd_bwd_ms, step_ms):
    """The eight opl entries of the kernels line. ``launches`` counts the
    main path of this slice: K1 and K3 in their wavefront_rms training run
    (5 steps), K2 and K4 in the population wavefront run (opd_map and one
    wavefront_rms fwd+bwd); the serving runs' launches stand beside them."""
    entries = []
    for kernel in OPL_KERNELS:
        fwd_src, bwd_src, tpu_fwd, tpu_bwd = OPL_SOURCES[kernel]
        main = train[kernel] if kernel in train else pop[kernel]
        for kind, src, tpu, idx in (("fwd", fwd_src, tpu_fwd, 0), ("bwd", bwd_src, tpu_bwd, 1)):
            b_ms, b_by = opl_bound(kernel, shapes[kernel], kind == "bwd")
            entry = {"name": f"{kernel}_{kind}_opl", "route": "cuda", "source": src,
                     "replaces": tpu, "launches": main[idx],
                     "max_abs_err": worst[kernel]["fwd" if kind == "fwd" else "ray"],
                     "ms": ms[f"{kernel}_{kind}"], "plain_ms": ms[f"plain_{kernel}_{kind}"],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            if kernel in ("k3", "k4"):
                entry["bound_ms_n10"] = opl_bound(kernel, shapes[kernel], kind == "bwd", 10)[0]
            if kind == "bwd":
                entry.update(param_max_rel_err=worst[kernel]["param"],
                             param_max_abs_err=worst[kernel]["param_abs"])
            if kernel in serve and kind == "fwd":
                entry["launches_opd_map"] = serve[kernel][0]
            if kernel in step_ms and kind == "bwd":
                entry["wavefront_rms_step_ms"] = step_ms[kernel]
            if kernel == "k1":
                entry["launches_opl_fwd_bwd"] = fwd_bwd_launches[idx]
                if kind == "bwd":
                    entry.update(fwd_bwd_ms)
            entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The backward kernels at ragged shapes: wavelengths and ray counts that no
# warp or block boundary divides.
# ---------------------------------------------------------------------------

# 5 fields x 13^2 pupil rays = 845 a wavelength, 2,535 a system: warps and
# blocks straddle two wavelengths and the last block is partly inactive.
# 1 field x 9^2 = 81 a wavelength, 243 a system: one partly inactive block
# holds all three wavelengths.
RAGGED_WIDTHS = {"5 x 13^2": dict(n_sampled_fields=5, n_pupil_rings=13),
                 "1 x 9^2": dict(n_sampled_fields=1, n_pupil_rings=9)}
RAGGED_VARIANTS = {"k1": (1.0, 3.0), "k3": (1.0, 3.0), "k2": ("cooke", "cooke c x 3", "mixed"),
                   "k4": ("cooke", "cooke c x 3", "mixed")}
RAGGED_SYSTEMS = 32
RAGGED_MODES = (False, True, "full", "opl")
# Parameter sums against the plain version's, relative to their row's
# largest: each kernel's bar in the phases above.
RAGGED_BAR = {"k1": 1e-5, "k2": 2e-6, "k3": ONE_ROUNDING, "k4": ONE_ROUNDING}


def ragged_inputs(torch, zoo, simulator, modules, kernel, variant, width):
    """A backward kernel's base inputs (without ref_z and n_legs), ref_z,
    n_legs, n_per_w, the surface mask, the tight bounds and cos²(threshold)
    at ``width``: K1 on the double-Gauss and K3 on its aspherized form, c x
    ``variant``; K2 on 32 Cooke triplets and K4 on 32 aspheric Cooke
    triplets ('cooke c x 3': c x 3 on every 8th system), or on 32 Cooke and
    double-Gauss designs padded to 11 surfaces ('mixed')."""
    fused_trace, fused_batch, _ = modules
    cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                    **width).trace_config()
    single = kernel in ("k1", "k3")
    asph = kernel in ("k3", "k4")
    if single:
        specs, lens = zoo.build("double_gauss_asph" if asph else "double_gauss", device="cuda")
        lens = lens.replace(c=lens.c * variant)
    elif asph:
        specs, lens = k4_population(torch, zoo, variant, RAGGED_SYSTEMS)
    elif variant == "mixed":
        specs, lens = zoo.mixed_population(RAGGED_SYSTEMS, device="cuda")
    else:
        specs, lens = zoo.population("cooke", RAGGED_SYSTEMS, device="cuda")
        if variant == "cooke c x 3":
            scale = torch.ones(RAGGED_SYSTEMS, 1, device="cuda")
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
    bounds = fused_trace._path_bounds(lens[widest].structure, TIGHT["ray_path_lower_thresholds"],
                                      TIGHT["ray_path_upper_thresholds"])
    thr = math.cos(math.radians(TIGHT["ray_angle_threshold"])) ** 2
    mask = None if single else fused_batch._static_mask(lens.structure, "cuda")
    detach = lambda items: tuple(a.detach().contiguous() for a in items)
    return detach(base), ref_z.detach(), n_legs.detach(), F * P, mask, bounds, thr


def ragged_backward(modules, kernel, base, ref_z, n_legs, cot, penalties, allow_backward,
                    n_per_w, mask, bounds, thr, plain):
    """One backward launch of ``kernel`` in mode ``penalties`` (or 'opl'),
    or its plain version."""
    fused_trace, fused_batch, fused_asphere = modules
    if penalties == "opl":
        return run_opl(modules, kernel, base + (n_legs,), n_per_w, mask, allow_backward, plain,
                       cot)
    ins = base + (ref_z,)
    args = (penalties, allow_backward, n_per_w)
    if kernel == "k1":
        return run_bwd(fused_trace, ins, cot, *args, bounds, thr, plain)
    if kernel == "k2":
        return run_k2_bwd(fused_batch, ins, cot, *args, mask, bounds, thr, plain)
    if kernel == "k3":
        return run_k3_bwd(fused_asphere, ins, cot, *args, bounds, thr, plain)
    return run_k4_bwd(fused_asphere, ins, cot, *args, mask, bounds, thr, plain)


def phase_ragged(torch, zoo, simulator, modules):
    """K1b to K4b against their plain versions where n_per_w is not a
    multiple of 32 and n not one of 256 (``RAGGED_WIDTHS``), every mode
    (plain, Lu, full, opl) and both policies, on each kernel's lens and its
    c x 3 variant (K2, K4 also on the padded mixed population; at 1 x 9^2
    the first variant alone): per-ray cotangents bit-identical, two launches
    bit-identical, each row's parameter sums within the kernel's bar of the
    plain version's (``RAGGED_BAR``; a system's row, or for one system each
    parameter group's). Returns each kernel's worst relative deviation."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    worst = {}
    for width_name, width in RAGGED_WIDTHS.items():
        for kernel, variants in RAGGED_VARIANTS.items():
            population = kernel in ("k2", "k4")
            for variant in variants[:None if width_name == "5 x 13^2" else 1]:
                base, ref_z, n_legs, n_per_w, mask, bounds, thr = ragged_inputs(
                    torch, zoo, simulator, modules, kernel, variant, width)
                n = base[0].shape[-1]
                check(n_per_w % 32 != 0 and n % 256 != 0,
                      f"ragged {width_name}: {n_per_w} rays a wavelength, {n} a system")
                for penalties in RAGGED_MODES:
                    n_cot = {False: 4, True: 7, "full": 9, "opl": 5}[penalties]
                    cot = [torch.randn(base[0].shape, device="cuda", generator=gen)
                           for _ in range(n_cot)]
                    bar = ONE_ROUNDING if penalties == "opl" else RAGGED_BAR[kernel]
                    for allow_backward in (True, False):
                        run = lambda plain: ragged_backward(
                            modules, kernel, base, ref_z, n_legs, cot, penalties,
                            allow_backward, n_per_w, mask, bounds, thr, plain)
                        g1, g2, gw = run(False), run(False), run(True)
                        same = all(torch.equal(a, b) for a, b in zip(g1, g2))
                        ray = max(float((g1[i] - gw[i]).abs().max()) for i in range(3))
                        rel = 0.0
                        for a, b in zip(opl_param_rows(torch, g1, population),
                                        opl_param_rows(torch, gw, population)):
                            rel = max(rel, float(((a - b).abs().max(1).values
                                                  / b.abs().max(1).values.clamp(min=1e-30))
                                                 .max()))
                        finite = all(bool(torch.isfinite(a).all()) for a in g1)
                        label = (f"{kernel.upper()}b ragged {width_name} ({n_per_w} rays a "
                                 f"wavelength, {n} a system), {variant}, "
                                 f"{MODE_NAME.get(penalties, penalties)} mode, allow_backward="
                                 f"{allow_backward}")
                        check(same and finite and ray == 0.0 and rel <= bar,
                              f"{label}: two launches bit-identical ({same}), per-ray "
                              f"cotangents bit-identical (max deviation {ray:.3e}), parameter "
                              f"sums within {rel:.3e} of their row's largest (limit {bar:.3e})")
                        worst[kernel] = max(worst.get(kernel, 0.0), rel)
                print(f"ragged {width_name}: {kernel.upper()}b on {variant} ({n_per_w} rays a "
                      f"wavelength, {n} a system) equals its plain version in every mode and "
                      f"policy: per-ray cotangents bit for bit, two launches bit for bit, "
                      f"parameter sums within {worst[kernel]:.3e} (limits "
                      f"{RAGGED_BAR[kernel]:.3e}, opl {ONE_ROUNDING:.3e})", flush=True)
    return worst


# ---------------------------------------------------------------------------
# The imaging path: kernel P2 (the SVOLA patch convolution), rendering, and
# the issue-rate probe P1.
# ---------------------------------------------------------------------------

P2_SOURCE = "torchoptics_tpu_torch/csrc/svola_conv.cu"
TPU_P2 = "benchmarks/probe_svola_direct.py:60"
P1_SOURCE = "torchoptics_tpu_torch/csrc/issue_peak.cu"
TPU_P1 = "benchmarks/vpu_peak.py:65"
# BASELINE config 5 (bench.py:358-361): the double-Gauss, 9 fields, 24 rings,
# circular pupil, 33 x 33 PSFs at 4 um, a 5 x 5 patch grid; the trace on K1.
IMAGING_CONFIG = dict(n_sampled_fields=9, n_pupil_rings=24, pupil_sampling="circular",
                      n_ray_aiming_iter=1, psf_shape=(33, 33), psf_abs_pixel_size=4e-3,
                      psf_grid_shape=(5, 5), trace_engine="fused")
IMAGING_SIZES = (256, 512, 1024)
# Card against CPU, a render of the same lens and photograph: the trace's
# sqrt and the splat's exp round otherwise on the two (a few 1e-6 of each
# PSF); a render is a convex blend of the image, so that stays ~1e-5 of the
# signal: 0.05 grey levels of 255, PSNR within 2e-3 dB, SSIM within 1e-5.
RENDER_BAR = dict(irradiance=0.05, psnr=2e-3, ssim=1e-5)


def imaging_config(simulator, **kw):
    return simulator.SimulatorConfig(**dict(IMAGING_CONFIG, **kw))


def photograph(px, height=None):
    """The shipped sample photograph at px x px (or height x px), decoded by
    the port; it fails if the loader fell back to the synthetic chart."""
    from torchoptics_tpu_torch.utils import images
    size = (height or px, px)
    img = images.load_test_image(size)
    want = images._resize_nearest_box(images.decode_png(images.ASSET)[..., :3], size)
    check(np.array_equal(img, want.astype(np.float32))
          and not np.array_equal(img, images.synthetic_test_image(*size)),
          f"test image {size}: the sample photograph (decoded from "
          f"{images.ASSET.split('torchoptics_tpu/')[-1]}), not the synthetic chart")
    return img


def p2_inputs(torch, imaging, image, model, radiance, cfg):
    """P2's inputs in a render: the patches of ``radiance`` (B, H, W, C) as
    ``svola_convolution`` cuts them and each patch's PSF, flattened to
    (B N, ph, pw, C) and (B N, kh, kw, C)."""
    B, H, W, C = radiance.shape
    psfs, overlap, _ = imaging.patch_psfs(model, (H, W), imaging.sample_field_lim(H, W), cfg)
    kh, kw = psfs.shape[2:4]
    patches, _, _ = image.svola_patches(radiance, overlap, (kh, kw), cfg.psf_grid_shape)
    N = patches.shape[1]
    psfs = torch.broadcast_to(psfs, (B,) + psfs.shape[1:]).reshape(B * N, kh, kw, C)
    return patches.reshape((B * N,) + patches.shape[2:]).contiguous(), psfs.contiguous()


def phase_p2_kernel(torch, zoo, simulator, imaging, image):
    """P2's direct kernel against its plain version on real data: the
    patches of the sample photograph at 1024^2, 256^2 and 2048^2 with the
    double-Gauss's PSFs resized as a render resizes them (K = 11, 3 and 23);
    a non-square image (256 x 384, non-square patches); a batch of two
    images (the photograph and its mirror); and ``svola_patch_conv`` on each
    against its route's plain version (K = 23 takes the FFT route).
    Bit-identical is the bar (the same tap order, no FMA contraction). Under
    grad it runs, with the same bits (its adjoint is
    ``phase_p2_adjoint``'s). Returns the largest deviation and the 1024^2
    inputs for the timing."""
    cfg = imaging_config(simulator)
    specs, lens = zoo.build("double_gauss", device="cuda")
    with torch.no_grad():
        model = imaging.sample_optics_model(specs, lens, cfg)
    worst, timing_inputs = 0.0, None
    cases = []
    for px in (1024, 256, 2048):
        rad = torch.tensor(photograph(px)[None], device="cuda")
        cases.append((f"{px}^2 render", p2_inputs(torch, imaging, image, model, rad, cfg)))
        if px == 1024:
            timing_inputs = cases[-1][1]
            both = torch.cat((rad, torch.flip(rad, dims=(2,))))
    rect = torch.tensor(photograph(384, 256)[None], device="cuda")
    cases.append(("256 x 384 image (non-square patches)",
                  p2_inputs(torch, imaging, image, model, rect, cfg)))
    cases.append(("B = 2 at 1024^2", p2_inputs(torch, imaging, image, model, both, cfg)))
    for label, (patches, psfs) in cases:
        with torch.no_grad():
            got = image._launch_p2(patches, psfs)
            routed = image.svola_patch_conv(patches, psfs)
            torch.cuda.synchronize()
            want = image.svola_patch_conv_reference(patches, psfs)
            want_routed = plain_p2(image, patches, psfs)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        route = "FFT" if image.p2_takes_fft(psfs.shape[1:3]) else "direct"
        same = (torch.equal(got, want), torch.equal(routed, want_routed))
        check(all(same) and bool(torch.isfinite(got).all()),
              f"P2 vs plain, {label}: patches {tuple(patches.shape)}, PSFs "
              f"{tuple(psfs.shape)} -> {tuple(got.shape)}: the direct kernel bit-identical="
              f"{same[0]} (max deviation {err:.3e}, bar 0); svola_patch_conv on its route "
              f"({route}) bit-identical to that route's plain version={same[1]}")
    patches, psfs = cases[-1][1]
    graded = image.svola_patch_conv(patches, psfs.clone().requires_grad_(True))
    torch.cuda.synchronize()
    with torch.no_grad():
        same = torch.equal(graded.detach(), image.svola_patch_conv(patches, psfs))
    check(graded.requires_grad and same,
          f"P2 under grad: runs, output requires grad={graded.requires_grad}, the same bits as "
          f"under no_grad={same}")
    return worst, timing_inputs


def render(torch, imaging, specs, lens, radiance, cfg):
    with torch.no_grad():
        return imaging.simulate(specs, lens, radiance, cfg)


def render_gap(torch, a, b):
    """Largest gaps of (irradiance, psnr, ssim) between two renders."""
    return [float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(a, b)]


def phase_imaging_serve(torch, zoo, simulator, imaging, image, fused_trace):
    """``imaging.simulate`` of config 5 on the card under no_grad: the
    double-Gauss, the sample photograph at 1024^2 (full width) and 256^2,
    the geometric PSFs (K1f, plain mode), the separable warp, relative
    illumination on. Counts set to 0 before each render and read after: one
    K1 forward and one P2 launch a render. The card's render held against the
    CPU's (the plain versions) within ``RENDER_BAR``; a 256^2 render with
    ``psf_source="diffraction"`` (K1's opl mode through opd_map) held the
    same way, plus four times the gap between the CPU's own renders on its
    two engines (the diffraction PSFs' speckle moves with the float32 OPD
    floor). Returns the launches of the 1024^2 render."""
    cfg = imaging_config(simulator)
    specs, lens = zoo.build("double_gauss", device="cuda")
    specs_h, lens_h = zoo.build("double_gauss", device="cpu")
    launches = None
    for px in (1024, 256):
        img = photograph(px)[None]
        fused_trace.K1_FWD_LAUNCHES = image.P2_LAUNCHES = 0
        card = render(torch, imaging, specs, lens, torch.tensor(img, device="cuda"), cfg)
        torch.cuda.synchronize()
        counts = (fused_trace.K1_FWD_LAUNCHES, image.P2_LAUNCHES)
        if px == 1024:
            launches = counts
        host = render(torch, imaging, specs_h, lens_h, torch.tensor(img), cfg)
        gap = render_gap(torch, card, host)
        check(counts == (1, 1) and bool(torch.isfinite(card[0]).all())
              and all(g <= b for g, b in zip(gap, RENDER_BAR.values())),
              f"render of the sample photograph at {px}^2 (config 5, double-Gauss, geometric "
              f"PSFs, separable warp): K1 forward launched {counts[0]} time(s), P2 "
              f"{counts[1]} (one each a render); PSNR {float(card[1][0]):.4f} dB, SSIM "
              f"{float(card[2][0]):.5f}; card vs CPU: irradiance within {gap[0]:.3e} grey "
              f"levels (limit {RENDER_BAR['irradiance']}), PSNR within {gap[1]:.2e} dB (limit "
              f"{RENDER_BAR['psnr']}), SSIM within {gap[2]:.2e} (limit {RENDER_BAR['ssim']})")
    import dataclasses
    img = photograph(256)[None]
    dcfg = dataclasses.replace(cfg, psf_source="diffraction")
    fused_trace.K1_FWD_LAUNCHES = image.P2_LAUNCHES = 0
    card = render(torch, imaging, specs, lens, torch.tensor(img, device="cuda"), dcfg)
    torch.cuda.synchronize()
    counts = (fused_trace.K1_FWD_LAUNCHES, image.P2_LAUNCHES)
    host = render(torch, imaging, specs_h, lens_h, torch.tensor(img), dcfg)
    host_unroll = render(torch, imaging, specs_h, lens_h, torch.tensor(img),
                         dataclasses.replace(dcfg, trace_engine="unroll"))
    own = render_gap(torch, host, host_unroll)
    bars = [b + 4 * o for b, o in zip(RENDER_BAR.values(), own)]
    gap = render_gap(torch, card, host)
    check(counts == (2, 1) and bool(torch.isfinite(card[0]).all())
          and all(g <= b for g, b in zip(gap, bars)),
          f"diffraction render at 256^2 (64^2 pupil grid, oversample 4): K1 opl forward "
          f"launched {counts[0]} times (the bundle and the chief ray), P2 {counts[1]}; PSNR "
          f"{float(card[1][0]):.4f} dB; card vs CPU: irradiance within {gap[0]:.3e} (limit "
          f"{bars[0]:.3e}), PSNR within {gap[1]:.2e} (limit {bars[1]:.2e}), SSIM within "
          f"{gap[2]:.2e} (limit {bars[2]:.2e}); the CPU's own fused-vs-unroll gap {own[0]:.3e}, "
          f"{own[1]:.2e}, {own[2]:.2e}")
    return launches


def phase_p1_probe(torch, issue_peak):
    """P1's chains against their plain versions on the probe's grid at 64
    iterations, bit for bit (the plain fma step is fmaf rounded once), and
    the kernel's fma chain apart from the twice-rounded a * k1 + k2 chain on
    over 1 % of the lanes, so an unfused multiply and add fails; then the
    rate protocol, its launches counted; then the kernel and its plain
    version timed on the check's work. Returns the rates, the launches, the
    deviation and the times."""
    n = issue_peak.probe_threads()
    g = torch.Generator(device="cuda").manual_seed(11)
    x = 0.9 + 0.2 * torch.rand(n, generator=g, device="cuda")
    worst = 0.0
    for op in issue_peak.OPS:
        got = issue_peak.chains(x, op, 64)
        want = issue_peak.chains_reference(x, op, 64)
        rel = float(((got - want).abs() / want.abs()).max())
        worst = max(worst, float((got - want).abs().max()))
        check(torch.equal(got, want),
              f"P1 {op} chains vs plain at 64 iterations on {n} threads: bit-identical="
              f"{torch.equal(got, want)}, largest relative deviation {rel:.2e}")
    unfused = issue_peak.chains_reference(x, "fma", 64, fused=False)
    apart = float((issue_peak.chains(x, "fma", 64) != unfused).float().mean())
    check(apart > 0.01, f"P1 fma chain vs the twice-rounded a * k1 + k2 chain: {apart:.2%} of "
          f"lanes differ (an unfused kernel would differ on none; bar > 1 %)")
    issue_peak.P1_LAUNCHES = 0
    rates = issue_peak.measure_issue()
    launches = issue_peak.P1_LAUNCHES
    print(json.dumps({"p1_rates": rates}), flush=True)
    check(launches > 0 and all(rates[f"{op}_ops_per_s"] > 0 for op in issue_peak.OPS),
          f"P1 rates (lane-operations/s, min of 5 launches of ~150 ms): fma "
          f"{rates['fma_ops_per_s']:.4e}, sqrt {rates['sqrt_ops_per_s']:.4e}, div "
          f"{rates['div_ops_per_s']:.4e}; sqrt weight {rates['sqrt_weight']:.3f}, div weight "
          f"{rates['div_weight']:.3f}; {launches} launches; card: {card_line()}")
    ms = time_ms(torch, lambda: issue_peak.chains(x, "fma", 64))
    plain_ms = time_ms(torch, lambda: issue_peak.chains_reference(x, "fma", 64), runs=5, batch=2)
    return rates, launches, worst, ms, plain_ms, n


def fft_conv(torch, patches, psfs):
    """The library call computing P2's function as the JAX path does
    (ops/image.py:113-127): rfft2 of the patches and of the zero-padded
    PSFs at the patch's length, their product, the inverse, and the valid
    region, which starts at index (kh - 1, kw - 1) (JAX's roll by -K//2 and
    crop from K//2 for its odd K). Timed, and in float64 the route's
    yardstick; the port never calls it."""
    P, ph, pw, C = patches.shape
    kh, kw = psfs.shape[1:3]
    f = torch.fft.rfftn(patches, s=(ph, pw), dim=(1, 2)) * torch.fft.rfftn(psfs, s=(ph, pw),
                                                                          dim=(1, 2))
    return torch.fft.irfftn(f, s=(ph, pw), dim=(1, 2))[:, kh - 1:, kw - 1:, :]


def p2_bound(patches, psfs):
    """(bound_ms, bound_by, ops, bytes) of P2: kh kw multiply-adds (2
    operations) per output element; the patches and PSFs read once, the
    output written once."""
    P, ph, pw, C = patches.shape
    kh, kw = psfs.shape[1:3]
    out = P * (ph - kh + 1) * (pw - kw + 1) * C
    ops = 2 * out * kh * kw
    nbytes = 4 * (patches.numel() + psfs.numel() + out)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops,
            nbytes)


def phase_imaging_timing(torch, zoo, simulator, imaging, image, inputs, card):
    """P2, its plain version and the torch.fft product at the 1024^2 shape
    (CUDA events); then ``render_walls``."""
    patches, psfs = inputs
    with torch.no_grad():
        want = image.svola_patch_conv_reference(patches, psfs)
        lib_err = float((fft_conv(torch, patches, psfs) - want).abs().max())
        ms = {"p2": time_ms(torch, lambda: image.svola_patch_conv(patches, psfs)),
              "plain_p2": time_ms(torch, lambda: image.svola_patch_conv_reference(patches, psfs),
                                  runs=5, batch=2),
              "fft_p2": time_ms(torch, lambda: fft_conv(torch, patches, psfs))}
    b_ms, b_by, ops, nbytes = p2_bound(patches, psfs)
    print(f"time P2 at {tuple(patches.shape)} * {tuple(psfs.shape)}: {ms['p2']:.4f} ms (plain "
          f"{ms['plain_p2']:.3f} ms, torch.fft product {ms['fft_p2']:.4f} ms, within "
          f"{lib_err:.2e} of the plain version); bound {b_ms:.4f} ms by {b_by} ({ops:.3e} "
          f"operations, {nbytes / 1e6:.1f} MB); card: {card}", flush=True)
    return ms, (b_ms, b_by, ops), render_walls(torch, zoo, simulator, imaging, card)


def render_walls(torch, zoo, simulator, imaging, card):
    """The host wall of one render of config 5 at 256/512/1024^2, split into
    sample_optics_model and apply_optics_model (median of 7 after 2 warm-up
    renders): {px: (sample_ms, apply_ms)}."""
    cfg = imaging_config(simulator)
    specs, lens = zoo.build("double_gauss", device="cuda")
    walls = {}
    for px in IMAGING_SIZES:
        rad = torch.tensor(photograph(px)[None], device="cuda")
        field_lim = imaging.sample_field_lim(px, px)
        holder = {}

        def sample():
            with torch.no_grad():
                holder["model"] = imaging.sample_optics_model(specs, lens, cfg)

        def apply():
            with torch.no_grad():
                imaging.apply_optics_model(holder["model"], rad, field_lim, cfg)
        sample_ms = host_ms(torch, sample, runs=7)
        apply_ms = host_ms(torch, apply, runs=7)
        walls[px] = (sample_ms, apply_ms)
        print(f"time render {px}^2: sample_optics_model {sample_ms:.2f} ms, apply_optics_model "
              f"{apply_ms:.2f} ms, total {sample_ms + apply_ms:.2f} ms (host clock, median of "
              f"7); card: {card}", flush=True)
    return walls


# ---------------------------------------------------------------------------
# Imaging training: wide PSFs, P2's adjoint, the image loss through
# LensOptimizer, and the stateful simulator.
# ---------------------------------------------------------------------------

P2_DPSF_SOURCE = "torchoptics_tpu_torch/csrc/svola_conv_bwd.cu"
# No Pallas kernel computes d/dpsf: XLA differentiates the FFT SVOLA.
TPU_P2_DPSF = ("torchoptics_tpu/ops/image.py:62 (svola_convolution by FFT, differentiated by "
               "XLA; no Pallas kernel)")
# FP64 outside the tensor cores, NVIDIA's H100 SXM data sheet: the rate of
# d/dpsf's double FMAs, the ceiling of its design. Its bound_ms is taken at
# PEAK_FLOPS, the rate of its inputs' float32 (and of FP64 on the tensor
# cores).
PEAK_FP64 = 34e12
# Card against CPU, d/d(c, t) of the image loss at 256^2. Each side traces,
# splats, renders and differentiates on its own: the kernels are held to
# their plain versions on the same inputs elsewhere (K1 at this loss's PSF
# bundle in the same phase), but here the gradient differentiates the
# splat's Gaussians (sigma 4 um) at ray positions that differ by the float32
# rounding of the two traces (~1e-6 mm). Measured on an H100: 3.44e-4 of the
# largest component, cosine 1 to float32; the bar is ~3x that reading.
IMAGE_GRAD_BAR = dict(rel=1e-3, cosine=0.99999)
IMAGE_TRAIN_SIZES = (256, 1024)


def default_imaging_config(simulator, **kw):
    """The default ``SimulatorConfig``'s imaging (65 x 65 PSFs at 4 um, a
    9 x 9 patch grid, 21 fields x 32 rings), its trace on K1."""
    return simulator.SimulatorConfig(trace_engine="fused", **kw)


def plain_p2(image, patches, psfs):
    """P2's plain version for the route the PSFs take."""
    if image.p2_takes_fft(psfs.shape[1:3]):
        return image.svola_patch_conv_fft_reference(patches, psfs)
    return image.svola_patch_conv_reference(patches, psfs)


def plain_dpsf(image, patches, cot, kernel_hw):
    """d/dpsf's plain version for the route the PSFs take."""
    if image.p2_takes_fft(kernel_hw, adjoint=True):
        return image.svola_patch_conv_dpsf_fft_reference(patches, cot, kernel_hw)
    return image.svola_patch_conv_dpsf_reference(patches, cot, kernel_hw)


def phase_p2_wide(torch, zoo, simulator, imaging, image, fused_trace):
    """P2 with wide PSFs, which take the FFT route (``csrc/svola_fft.cu``):
    ``svola_patch_conv`` on the photograph's patches with the double-Gauss's
    PSFs at the default configuration's 1448^2, 2048^2 and 4096^2 renders
    (K = 33, 47, 95) and on seeded cases (kh 47 x kw 29, kh 21 x kw 95, a
    PSF as large as its patch, five channels), counts set to 0 before each
    and read after (three FFT launches, no direct one), bit for bit with the
    route's plain version; then ``fft_route_check`` on each (the forward and
    d/dpsf kernels against the float64 torch.fft product and correlation).
    Then whole renders of the default configuration at 2048^2 and of config
    5 at 4096^2 (K = 47 each): one K1 forward and one FFT call each. Returns
    {label: fft_route_check's deviations}, the render inputs by K, and the
    2048^2 render's FFT launches."""
    cfg = default_imaging_config(simulator)
    inputs = render_inputs(torch, zoo, simulator, imaging, image,
                           [("default", px) for px in (1448, 2048, 4096)])
    cases = {f"default config at {px}^2": args for (_, px), args in inputs.items()}
    cases.update(seeded_fft_cases(torch))
    errs = {}
    for label, (patches, psfs, cot) in cases.items():
        image.P2_LAUNCHES = image.P2_FFT_LAUNCHES = 0
        with torch.no_grad():
            got = image.svola_patch_conv(patches, psfs)
            torch.cuda.synchronize()
            launched = (image.P2_LAUNCHES, image.P2_FFT_LAUNCHES)
            same = torch.equal(got, plain_p2(image, patches, psfs))
        check(same and bool(torch.isfinite(got).all()) and launched == (0, 3),
              f"P2 on the FFT route, {label}: patches {tuple(patches.shape)}, PSFs "
              f"{tuple(psfs.shape)} -> {tuple(got.shape)}: bit-identical to the route's plain "
              f"version={same}; launches (direct, FFT) {launched} (expected (0, 3))")
        errs[label] = fft_route_check(torch, image, label, patches, psfs, cot)
    launches = None
    specs, lens = zoo.build("double_gauss", device="cuda")
    for label, cfg_r, px in (("default config", cfg, 2048),
                             ("config 5", imaging_config(simulator), 4096)):
        rad = torch.tensor(photograph(px)[None], device="cuda")
        fused_trace.K1_FWD_LAUNCHES = image.P2_LAUNCHES = image.P2_FFT_LAUNCHES = 0
        irr, psnr, ssim = render(torch, imaging, specs, lens, rad, cfg_r)
        torch.cuda.synchronize()
        counts = (fused_trace.K1_FWD_LAUNCHES, image.P2_LAUNCHES, image.P2_FFT_LAUNCHES)
        if px == 2048:
            launches = counts[2]
        k = imaging.psf_kernel_shape((px, px), cfg_r)
        check(counts == (1, 0, 3) and tuple(irr.shape) == (1, px, px, 3)
              and bool(torch.isfinite(irr).all()) and math.isfinite(float(psnr[0])),
              f"render of the photograph at {px}^2, {label} (K = {k[0]} x {k[1]}): "
              f"{tuple(irr.shape)}, finite; launches (K1 forward, P2 direct, P2 FFT) {counts} "
              f"(expected (1, 0, 3)); PSNR {float(psnr[0]):.4f} dB, SSIM {float(ssim[0]):.5f}")
    return errs, {args[1].shape[1]: args for args in inputs.values()}, launches


# P2's adjoint at render shapes, (label, configuration, px): both routes
# direct (K = 11), both FFT (K = 23, 47, 95).
ADJOINT_RENDERS = (("config 5 at 1024^2", "config 5", 1024),
                   ("config 5 at 2048^2", "config 5", 2048),
                   ("default config at 2048^2", "default", 2048),
                   ("default config at 4096^2", "default", 4096))


# Seeded d/dpsf cases for the direct kernel (P, patch height, width,
# channels, kh, kw): K = 1, 3, 5, 11, 22, each kw with a kernel of its own
# (3, 5, 11) and kw on the runtime-kw kernel (1, 7, 9, 19, 22),
# non-square PSFs, ragged tail tiles (outputs no multiple of 32), one and
# five channels, a patch that is one tile, config 5's 1024^2 shape with 75
# patch-channels.
DPSF_SHAPES = ((3, 45, 50, 1, 1, 1), (1, 34, 34, 3, 3, 3), (2, 77, 77, 3, 3, 3),
               (3, 70, 75, 3, 5, 9), (2, 45, 50, 1, 9, 3), (2, 60, 57, 3, 11, 11),
               (2, 52, 49, 5, 5, 5), (2, 66, 70, 3, 22, 22), (2, 90, 77, 3, 21, 22),
               (2, 100, 90, 3, 17, 22), (2, 41, 70, 1, 7, 11), (1, 70, 80, 3, 22, 19),
               (1, 64, 70, 1, 13, 22), (25, 316, 316, 3, 11, 11))


def phase_p2_adjoint(torch, zoo, simulator, imaging, image):
    """P2's adjoint through ``svola_patch_conv``'s backward on the render
    shapes of ``ADJOINT_RENDERS``, both inputs requiring grad, counts set to
    0 before and read after: each route's launches (the direct P2 once for
    the forward and once for d/dpatch, its d/dpsf once a group of
    patch-channels; the FFT route three a call). d/dpsf and d/dpatch bit
    for bit with the plain versions of their routes. Then the direct d/dpsf
    kernel alone on ``DPSF_SHAPES``, bit for bit with its plain version.
    Returns {label: (patches, psfs, cot, dpsf deviation, dpatch
    deviation)}."""
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    inputs = render_inputs(torch, zoo, simulator, imaging, image,
                           [(name, px) for _, name, px in ADJOINT_RENDERS])
    out = {}
    for label, name, px in ADJOINT_RENDERS:
        patches, psfs, cot = inputs[(name, px)]
        P, ph, pw, C = patches.shape
        kh, kw = psfs.shape[1:3]
        p_var = patches.clone().requires_grad_(True)
        k_var = psfs.clone().requires_grad_(True)
        counters = ("P2_LAUNCHES", "P2_FFT_LAUNCHES", "P2_DPSF_LAUNCHES", "P2_DPSF_FFT_LAUNCHES")
        for c in counters:
            setattr(image, c, 0)
        d_patch, d_psf = torch.autograd.grad(image.svola_patch_conv(p_var, k_var),
                                             (p_var, k_var), cot)
        torch.cuda.synchronize()
        counts = tuple(getattr(image, c) for c in counters)
        fft, fft_d = image.p2_takes_fft((kh, kw)), image.p2_takes_fft((kh, kw), adjoint=True)
        want = (0 if fft else 2, 6 if fft else 0,
                0 if fft_d else lib.p2_dpsf_launches(P, C, ph, pw, kh, kw), 3 if fft_d else 0)
        with torch.no_grad():
            want_psf = plain_dpsf(image, patches, cot, (kh, kw))
            want_patch = image.svola_patch_conv_dpatch_reference(cot, psfs)
        e_psf = float((d_psf - want_psf).abs().max())
        e_patch = float((d_patch - want_patch).abs().max())
        same = (torch.equal(d_psf, want_psf), torch.equal(d_patch, want_patch))
        routes = f"P2 {'FFT' if fft else 'direct'}, d/dpsf {'FFT' if fft_d else 'direct'}"
        check(all(same) and counts == want and bool(torch.isfinite(d_psf).all()),
              f"P2 adjoint vs plain, {label} ({routes}): patches {tuple(patches.shape)}, PSFs "
              f"{tuple(psfs.shape)}: d/dpsf bit-identical={same[0]} (max deviation "
              f"{e_psf:.3e}, bar 0), d/dpatch bit-identical={same[1]} ({e_patch:.3e}); "
              f"launches (P2 direct, P2 FFT, d/dpsf direct, d/dpsf FFT) {counts} (expected "
              f"{want})")
        out[label] = (patches, psfs, cot, e_psf, e_patch)
    for shape in DPSF_SHAPES:
        P, ph, pw, C, kh, kw = shape
        got, want, launches = dpsf_direct_case(torch, image, shape)
        kernel = "its own kernel" if lib.p2_dpsf_specialized_kw(kw) else "the runtime-kw kernel"
        check(torch.equal(got, want) and bool(torch.isfinite(got).all())
              and launches == lib.p2_dpsf_launches(P, C, ph, pw, kh, kw),
              f"d/dpsf (direct) vs plain, patches {(P, ph, pw, C)}, K = {kh} x {kw} ({kernel}): "
              f"bit-identical={torch.equal(got, want)} (max deviation "
              f"{float((got - want).abs().max()):.3e}, bar 0), launches {launches}")
    return out


def dpsf_direct_case(torch, image, shape):
    """The direct d/dpsf kernel and its plain version on one of
    ``DPSF_SHAPES``, on seeded patches and cotangents: (kernel's, plain
    version's, the kernel's launches)."""
    P, ph, pw, C, kh, kw = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    patches = torch.rand((P, ph, pw, C), generator=g, device="cuda") * 255.0
    cot = torch.randn((P, ph - kh + 1, pw - kw + 1, C), generator=g, device="cuda")
    before = image.P2_DPSF_LAUNCHES
    with torch.no_grad():
        got = image._launch_p2_dpsf(patches, cot, (kh, kw))
        torch.cuda.synchronize()
        want = image.svola_patch_conv_dpsf_reference(patches, cot, (kh, kw))
    return got, want, image.P2_DPSF_LAUNCHES - before


def image_optimizer(torch, zoo, simulator, imaging, LensOptimizer, device, px, config=None):
    """The double-Gauss defocused by 0.3 mm, trained on -PSNR + 10 (1 - SSIM)
    of the photograph at px^2 rendered at ``config`` (config 5 by default):
    Adam on (c, t) at the lens's own EFL, glasses fixed."""
    specs, lens = zoo.build("double_gauss", device=device)
    t = lens.t.clone()
    t[0, -1] += 0.3
    radiance = torch.tensor(photograph(px)[None], device=device)
    opt = LensOptimizer(specs=specs, config=config or imaging_config(simulator),
                        learning_rate=1e-3,
                        trainable=("c", "t"), qc_variables=False,
                        efl_target=float(lens.efl[0]),
                        loss_fn=imaging.make_image_loss_fn(radiance, ssim_weight=10.0))
    return opt, opt.init(lens.replace(t=t))


def image_gradients(torch, opt, state):
    total, _ = opt.loss(state.params)
    grads = torch.autograd.grad(total, [state.params[k] for k in ("c", "t")])
    return float(total.detach()), [g.detach().cpu() for g in grads]


def gradient_card_vs_cpu(torch, zoo, simulator, imaging, LensOptimizer, px, config, label):
    """The first image-loss step's d/d(c, t) at px^2 and ``config`` on the
    card against the port's CPU (the same lens, pupil and radiance), within
    ``IMAGE_GRAD_BAR``. Returns (relative deviation, cosine)."""
    got = {}
    for device in ("cuda", "cpu"):
        opt, state = image_optimizer(torch, zoo, simulator, imaging, LensOptimizer, device, px,
                                     config)
        got[device] = image_gradients(torch, opt, state)
    (l_card, g_card), (l_cpu, g_cpu) = got["cuda"], got["cpu"]
    a, b = torch.cat(g_card), torch.cat(g_cpu)
    rel = float((a - b).abs().max() / b.abs().max())
    cosine = float(a @ b / (a.norm() * b.norm()))
    check(all(map(math.isfinite, (l_card, l_cpu))) and bool(torch.isfinite(a).all())
          and rel <= IMAGE_GRAD_BAR["rel"] and cosine >= IMAGE_GRAD_BAR["cosine"],
          f"image loss at {label}, first step, card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f}; "
          f"d/d(c, t) within {rel:.3e} of the largest (limit {IMAGE_GRAD_BAR['rel']}), "
          f"cosine {cosine:.7f} (limit {IMAGE_GRAD_BAR['cosine']})")
    return rel, cosine


def captured(torch, args):
    """A copy of a launch's arguments: the optimizer updates the lens in
    place after the step."""
    if torch.is_tensor(args):
        return args.detach().clone()
    if isinstance(args, (tuple, list)):
        return type(args)(captured(torch, a) for a in args)
    return args


def capture_k1(torch, fused_trace, step):
    """Run ``step`` with K1's launchers recording (a copy of) the arguments
    of their first launch, then restore them. Returns (step's result,
    {"fwd": args, "bwd": args})."""
    record, launchers = {}, {}
    for kind in ("fwd", "bwd"):
        launchers[kind] = launch = getattr(fused_trace, f"_launch_k1_{kind}")

        def recording(*args, kind=kind, launch=launch):
            record.setdefault(kind, captured(torch, args))
            return launch(*args)
        setattr(fused_trace, f"_launch_k1_{kind}", recording)
    try:
        return step(), record
    finally:
        for kind, launch in launchers.items():
            setattr(fused_trace, f"_launch_k1_{kind}", launch)


def check_k1_at_bundle(torch, fused_trace, record):
    """K1 forward and backward on the arguments an image-loss step gave them
    (the PSF bundle's rays, and the cotangent the splat sent back), against
    their plain versions on the same card tensors, at phases 3 and 4's bars:
    masks equal and coordinates within 5e-6 relative (1e-6 for the
    directions); the backward's per-ray cotangents bit for bit and its
    parameter sums within 1e-5 of the largest. Returns (forward deviation,
    (per-ray, parameter absolute, parameter relative) deviations)."""
    inputs, penalties, allow_backward, n_per_w, bounds, thr = record["fwd"]
    ref_z, n_legs = fused_trace._split_extra(inputs, 7, fused_trace._mode(penalties))
    got = fused_trace._launch_k1_fwd(*record["fwd"])
    want = fused_trace.trace_fused_reference(*inputs[:7], penalties, allow_backward, n_per_w,
                                             ref_z, bounds, thr, n_legs)
    torch.cuda.synchronize()
    masks_equal, err = fwd_errors(got, want)
    fwd_err = max(v for k, v in err.items() if k != "xy_excess")
    check(masks_equal and err["xy_excess"] <= 5e-6 and err["cxcy"] <= 1e-6
          and err.get("pen", 0.0) <= 1e-5,
          f"K1 forward vs plain at the image loss's PSF bundle ({MODE_NAME[penalties]} mode, "
          f"{inputs[0].shape[0]} rays, {n_per_w} a wavelength): masks identical={masks_equal}, "
          f"max |dx|,|dy|={err['xy']:.3e} ({err['xy_excess']:.1e} past 1e-6 relative, bar "
          f"5e-6), max |dcx|,|dcy|={err['cxcy']:.3e} (bar 1e-6)")
    inputs, cot, penalties, allow_backward, n_per_w, bounds, thr = record["bwd"]
    got = fused_trace._launch_k1_bwd(*record["bwd"])
    want = fused_trace.trace_fused_backward_reference(inputs, cot, penalties, allow_backward,
                                                      n_per_w, bounds, thr)
    torch.cuda.synchronize()
    ray_err = max(float((got[i] - want[i]).abs().max()) for i in range(3))
    par_abs = max(float((got[i] - want[i]).abs().max()) for i in range(3, len(got)))
    par_rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max().clamp(min=1e-30))
                  for i in range(3, len(got)))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    live = sum(int((c != 0).sum()) for c in cot)
    check(finite and ray_err == 0.0 and par_rel <= 1e-5 and live > 0,
          f"K1 backward vs plain at the image loss's PSF bundle ({MODE_NAME[penalties]} mode, "
          f"{inputs[0].shape[0]} rays, the step's own cotangent: {live} nonzero entries): max "
          f"per-ray deviation {ray_err:.3e} (bar 0), max per-parameter deviation {par_abs:.3e} "
          f"({par_rel:.2e} of the largest, bar 1e-5)")
    return fwd_err, (ray_err, par_abs, par_rel)


def phase_image_training(torch, zoo, simulator, imaging, image, fused_trace, LensOptimizer,
                         card, n_steps=5):
    """The main path of this slice: 5 Adam steps of ``LensOptimizer`` with
    ``make_image_loss_fn`` at config 5 and 1024^2, the counts set to 0
    before each step and read after (K1 forward and backward, P2, d/dpsf);
    every loss and gradient finite, every step accepted. K1's arguments in
    the first step are recorded, and after the run K1 forward and backward
    are held to their plain versions on them (``check_k1_at_bundle``). The
    first step's d/d(c, t) on the card against the port's CPU at 256^2 (the
    same lens, pupil and radiance) within ``IMAGE_GRAD_BAR``. The host wall
    of a step at 256^2 and 1024^2. Returns the launches of the 5-step run,
    the walls and K1's deviations at the bundle."""
    counters = lambda: (fused_trace.K1_FWD_LAUNCHES, fused_trace.K1_BWD_LAUNCHES,
                        image.P2_LAUNCHES, image.P2_DPSF_LAUNCHES)
    opt, state = image_optimizer(torch, zoo, simulator, imaging, LensOptimizer, "cuda", 1024)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    per_step, totals, psnrs = [], [], []
    record = None
    for i in range(n_steps):
        fused_trace.K1_FWD_LAUNCHES = fused_trace.K1_BWD_LAUNCHES = 0
        image.P2_LAUNCHES = image.P2_DPSF_LAUNCHES = 0
        if i == 0:
            (state, total, terms), record = capture_k1(torch, fused_trace,
                                                        lambda: opt.step(state))
        else:
            state, total, terms = opt.step(state)
        torch.cuda.synchronize()
        per_step.append(counters())
        totals.append(float(total))
        psnrs.append(float(terms["psnr"]))
    adam_steps = [int(s["step"]) for s in state.opt_state.state.values()]
    moved = max(float((state.params[k].detach() - start[k]).abs().max()) for k in start)
    check(all(c == (1, 1, 1, 1) for c in per_step) and all(map(math.isfinite, totals))
          and adam_steps == [n_steps] * len(adam_steps) and moved > 0,
          f"image training at 1024^2 (config 5, double-Gauss defocused 0.3 mm, "
          f"-PSNR + 10 (1 - SSIM)): {n_steps} LensOptimizer steps, launches per step (K1 "
          f"forward, K1 backward, P2, d/dpsf) {per_step}; every step accepted (finite loss and "
          f"gradients: Adam step counts {adam_steps}); losses {['%.5f' % v for v in totals]}; "
          f"PSNR {['%.4f' % v for v in psnrs]} dB; parameters moved by up to {moved:.3e}")
    launches = tuple(sum(c[i] for c in per_step) for i in range(4))
    bundle = check_k1_at_bundle(torch, fused_trace, record)

    gradient_card_vs_cpu(torch, zoo, simulator, imaging, LensOptimizer, 256,
                         imaging_config(simulator), "256^2")

    walls = {}
    for px in IMAGE_TRAIN_SIZES:
        opt_px, state_px = image_optimizer(torch, zoo, simulator, imaging, LensOptimizer, "cuda",
                                           px)
        holder = [state_px]

        def step():
            holder[0] = opt_px.step(holder[0])[0]
        walls[px] = host_ms(torch, step, runs=5, warmup=2)
        print(f"time image-loss LensOptimizer.step at {px}^2 (config 5): {walls[px]:.2f} ms "
              f"(host clock, median of 5); card: {card}", flush=True)
    return launches, walls, bundle


def phase_raytraced_optics(torch, zoo, simulator, fused_trace):
    """``RaytracedOptics`` on the Cooke from the zoo's prescription dict,
    ``do_ray_tracing`` on the card with ``trace_engine="fused"`` (one K1
    forward launch) against the same call on the CPU: the same masks, image
    coordinates within 1e-5 mm, the loss terms within phase 5's bars."""
    kw = dict(initial_lens_path=zoo.get_prescription("cooke"), pupil_sampling="circular",
              trace_engine="fused", **ENTRY_WIDTH)
    card = simulator.RaytracedOptics(**kw)
    fused_trace.K1_FWD_LAUNCHES = 0
    with torch.no_grad():
        x, y, ok = card.do_ray_tracing()
    torch.cuda.synchronize()
    launches = fused_trace.K1_FWD_LAUNCHES
    host = simulator.RaytracedOptics(device="cpu", **kw)
    with torch.no_grad():
        hx, hy, hok = host.do_ray_tracing()
    ok, x, y = ok.cpu(), x.cpu(), y.cpu()
    gap = max(float((x - hx)[hok].abs().max()), float((y - hy)[hok].abs().max()))
    tol = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4}
    rel = {k: abs(float(card.loss_dict[k]) - float(host.loss_dict[k]))
           / abs(float(host.loss_dict[k])) for k in tol}
    fails = int(card.logged_metrics["ray_tracing/ray_failures"])
    check(launches == 1 and torch.equal(ok, hok) and gap <= 1e-5
          and all(rel[k] <= tol[k] for k in tol) and card.lensR.device.type == "cuda",
          f"RaytracedOptics (Cooke, prescription dict) on the card: K1 forward launched "
          f"{launches} time(s); {tuple(x.shape)} rays, {fails} failed, masks equal to the "
          f"CPU's={torch.equal(ok, hok)}; x, y within {gap:.2e} mm of the CPU's (limit 1e-5); "
          + ", ".join(f"{k} {rel[k]:.2e} (limit {tol[k]:.0e})" for k in tol))


def fft_dpsf(torch, patches, cot, kernel_hw):
    """The library call computing d/dpsf: the FFT correlation of each patch
    with the cotangent (rfft2 of both, the patch's times the cotangent's
    conjugate, irfft2), cropped to the taps and flipped. Timed only; the
    port never calls it."""
    P, ph, pw, C = patches.shape
    kh, kw = kernel_hw
    fp = torch.fft.rfftn(patches, s=(ph, pw), dim=(1, 2))
    fg = torch.fft.rfftn(cot, s=(ph, pw), dim=(1, 2))
    corr = torch.fft.irfftn(fp * fg.conj(), s=(ph, pw), dim=(1, 2))
    return torch.flip(corr[:, :kh, :kw, :], dims=(1, 2))


def dpsf_bound(patches, kernel_hw):
    """(bound_ms, bound_by, ops, fp64_ms) of d/dpsf: kh kw products and sums
    per output element of the forward over the peak of the inputs' float32
    (PEAK_FLOPS; FP64 on the tensor cores runs at the same rate); the
    patches and the cotangent read once, the PSF gradient written once.
    ``fp64_ms``: the same operations at PEAK_FP64, the ceiling of this
    design's double FMAs outside the tensor cores."""
    P, ph, pw, C = patches.shape
    kh, kw = kernel_hw
    hp, wp = ph - kh + 1, pw - kw + 1
    ops = 2 * P * C * hp * wp * kh * kw
    nbytes = 4 * (patches.numel() + P * hp * wp * C + P * kh * kw * C)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops,
            max(ops / PEAK_FP64, t_bytes) * 1e3)


def phase_adjoint_timing(torch, image, adjoint, card):
    """CUDA events: the direct d/dpsf kernel (both passes, with its partials'
    allocation) back to back (``dpsf``: the host's time to launch shows where
    it is the longer) and queued behind a sleep kernel (``dpsf_queued``: the
    device's time alone), its plain version and the torch.fft correlation at
    config 5's 1024^2 shape (K = 11, the main path of phase 35)."""
    patches, psfs, cot, _, _ = adjoint["config 5 at 1024^2"]
    kh, kw = psfs.shape[1:3]
    with torch.no_grad():
        want = image.svola_patch_conv_dpsf_reference(patches, cot, (kh, kw))
        lib_err = float((fft_dpsf(torch, patches, cot, (kh, kw)) - want).abs().max())
        direct = lambda: image._launch_p2_dpsf(patches, cot, (kh, kw))
        ms = {"dpsf": time_ms(torch, direct),
              "dpsf_queued": time_ms(torch, direct, queue_ahead=True),
              "plain_dpsf": time_ms(torch, lambda: image.svola_patch_conv_dpsf_reference(
                  patches, cot, (kh, kw)), runs=3, batch=1, warmup=1),
              "fft_dpsf": time_ms(torch, lambda: fft_dpsf(torch, patches, cot, (kh, kw)))}
    b = dpsf_bound(patches, (kh, kw))
    print(f"time d/dpsf (direct) at {tuple(patches.shape)}, K = {kh}: {ms['dpsf']:.4f} ms back "
          f"to back, {ms['dpsf_queued']:.4f} ms queued (plain "
          f"{ms['plain_dpsf']:.2f} ms, torch.fft correlation {ms['fft_dpsf']:.4f} ms, within "
          f"{lib_err:.2e} of the plain version); bound {b[0]:.4f} ms by {b[1]} ({b[2]:.3e} "
          f"operations at 67 TFLOP/s; {b[3]:.4f} ms at FP64's 34 TFLOP/s outside the tensor "
          f"cores, this design's ceiling); card: {card}", flush=True)
    return ms, b


def adjoint_entry(adjoint, train_launches, ms, b):
    """The direct d/dpsf kernel's entry of the kernels line, at config 5's
    1024^2 shape (``launches`` counts phase 35's 5-step image training run,
    its main path)."""
    return {"name": "p2_dpsf", "route": "cuda", "source": P2_DPSF_SOURCE,
            "replaces": TPU_P2_DPSF, "launches": train_launches[3],
            "max_abs_err": adjoint["config 5 at 1024^2"][3], "ms": ms["dpsf"],
            "ms_queued": ms["dpsf_queued"], "plain_ms": ms["plain_dpsf"], "bound_ms": b[0],
            "bound_by": b[1],
            "library_ms": ms["fft_dpsf"], "bound_ms_fp64": b[3],
            "dpatch_max_abs_err": adjoint["config 5 at 1024^2"][4],
            "image_training_launches": dict(zip(("k1_fwd", "k1_bwd", "p2", "p2_dpsf"),
                                                train_launches))}


# ---------------------------------------------------------------------------
# P2's FFT route (csrc/svola_fft.cu): the wide PSFs' forward and d/dpsf.
# ---------------------------------------------------------------------------

P2_FFT_SOURCE = "torchoptics_tpu_torch/csrc/svola_fft.cu"
# The template arguments of the FFT route's kernels at 400 points (the
# default configuration's 2048^2 patches): register blocks (4 4) and (5 5)
# of BLOCK_TYPES, no third (SPECIAL in the source).
FFT_400_BLOCKS = "4,12,-1"
# The route replaces the direct sum for wide PSFs: `_k_acc`'s port, and for
# d/dpsf the direct kernel, which replaced none.
TPU_P2_FFT = (f"{TPU_P2} (wide PSFs; the FFT of torchoptics_tpu/ops/image.py:62 "
              f"svola_convolution)")
# The route against the float64 torch.fft product and correlation (~1e-15 of
# the largest entry, a yardstick only), as a share of the largest entry: a
# float32 FFT's error is relative to a plane's norm, so dark pixels and the
# small edge taps of the PSF gradient carry absolute error. cuFFT's float32
# product and correlation are printed beside.
FFT_BAR = {"fwd": 1e-5, "dpsf": 1e-4}
# The renders whose P2 shapes set P2_FFT_MIN_KW and P2_DPSF_FFT_MIN_KW
# (K = 11, 23, 23, 33, 47) and the widest, K = 95: (configuration, px).
CROSSOVER_RENDERS = (("config 5", 1024), ("config 5", 2048), ("default", 1024),
                     ("default", 1448), ("default", 2048), ("default", 4096))


def render_inputs(torch, zoo, simulator, imaging, image, renders):
    """P2's inputs at renders of the photograph through the double-Gauss,
    ``renders`` a list of (configuration, px): {(name, px): (patches, psfs,
    cot)}, cot a seeded normal cotangent of P2's output."""
    specs, lens = zoo.build("double_gauss", device="cuda")
    cfgs = {"config 5": imaging_config(simulator), "default": default_imaging_config(simulator)}
    models, out = {}, {}
    for name, px in renders:
        with torch.no_grad():
            if name not in models:
                models[name] = imaging.sample_optics_model(specs, lens, cfgs[name])
            rad = torch.tensor(photograph(px)[None], device="cuda")
            patches, psfs = p2_inputs(torch, imaging, image, models[name], rad, cfgs[name])
        P, ph, pw, C = patches.shape
        kh, kw = psfs.shape[1:3]
        gen = torch.Generator(device="cuda").manual_seed(px)
        cot = torch.randn((P, ph - kh + 1, pw - kw + 1, C), generator=gen, device="cuda")
        out[(name, px)] = (patches, psfs, cot)
    return out


def seeded_fft_cases(torch):
    """Seeded cases of the FFT route beyond the renders: non-square PSFs (kh
    47 x kw 29, kh 21 x kw 95), a PSF as large as its patch, five channels
    (a block's sequences split a row pair's channels), one channel."""
    g = torch.Generator(device="cuda").manual_seed(4729)
    cases = {}
    for P, ph, pw, C, kh, kw in ((8, 200, 180, 3, 47, 29), (2, 80, 140, 1, 21, 95),
                                 (1, 60, 71, 3, 60, 71), (2, 99, 97, 5, 41, 39)):
        patches = torch.rand((P, ph, pw, C), generator=g, device="cuda") * 255.0
        psfs = torch.rand((P, kh, kw, C), generator=g, device="cuda")
        cot = torch.randn((P, ph - kh + 1, pw - kw + 1, C), generator=g, device="cuda")
        cases[f"seeded {kh} x {kw}, {C} ch"] = (patches, psfs / psfs.sum(dim=(1, 2), keepdim=True),
                                               cot)
    return cases


def fft_route_check(torch, image, label, patches, psfs, cot):
    """The FFT route's kernels on (patches, psfs, cot), forward and d/dpsf,
    called directly: bit for bit with their plain versions on the card,
    within ``FFT_BAR`` of the float64 torch.fft product and correlation (a
    share of the largest entry), three launches each; cuFFT's float32
    deviation from the same yardstick printed beside. Returns {"fwd": (dev
    from the plain version, the route's share, cuFFT's share), "dpsf": ...}."""
    kh, kw = psfs.shape[1:3]
    image.P2_FFT_LAUNCHES = image.P2_DPSF_FFT_LAUNCHES = 0
    errs = {}
    with torch.no_grad():
        got = {"fwd": image._launch_fft(patches, psfs, (kh, kw), False),
               "dpsf": image._launch_fft(patches, cot, (kh, kw), True)}
        torch.cuda.synchronize()
        launches = (image.P2_FFT_LAUNCHES, image.P2_DPSF_FFT_LAUNCHES)
        plain = {"fwd": lambda: image.svola_patch_conv_fft_reference(patches, psfs),
                 "dpsf": lambda: image.svola_patch_conv_dpsf_fft_reference(patches, cot,
                                                                           (kh, kw))}
        lib_call = {"fwd": lambda p, k, g: fft_conv(torch, p, k),
                    "dpsf": lambda p, k, g: fft_dpsf(torch, p, g, (kh, kw))}
        same = {}
        for key in ("fwd", "dpsf"):
            want = plain[key]()
            same[key] = torch.equal(got[key], want)
            dev = float((got[key] - want).abs().max())
            del want
            ref = lib_call[key](patches.double(), psfs.double(), cot.double())
            scale = float(ref.abs().max())
            share = float((got[key].double() - ref).abs().max()) / scale
            cufft = float((lib_call[key](patches, psfs, cot).double() - ref).abs().max()) / scale
            del ref
            errs[key] = (dev, share, cufft)
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    check(all(same.values()) and finite and launches == (3, 3)
          and all(errs[k][1] <= FFT_BAR[k] for k in errs),
          f"P2's FFT route, {label}: patches {tuple(patches.shape)}, PSFs {tuple(psfs.shape)}; "
          f"forward bit-identical to its plain version={same['fwd']} (max deviation "
          f"{errs['fwd'][0]:.3e}), within {errs['fwd'][1]:.2e} of the float64 torch.fft "
          f"product's largest entry (bar {FFT_BAR['fwd']:.0e}; cuFFT float32 "
          f"{errs['fwd'][2]:.2e}); d/dpsf bit-identical={same['dpsf']} ({errs['dpsf'][0]:.3e}), "
          f"within {errs['dpsf'][1]:.2e} of the float64 correlation (bar "
          f"{FFT_BAR['dpsf']:.0e}; cuFFT float32 {errs['dpsf'][2]:.2e}); launches {launches} "
          f"(3 each)")
    return errs


def next_fast_len(n):
    """The smallest 2^a 3^b 5^c >= n (the reference's ``next_fast_fft_len``,
    copied so that every tree's route is held to the same lengths)."""
    return min(p2 * 3 ** b * 5 ** c for b in range(9) for c in range(7)
               for p2 in [1 << max(0, (-(-n // (3 ** b * 5 ** c)) - 1).bit_length())])


def fft_route_bound(patches, kernel_hw, adjoint, lengths=None):
    """(bound_ms, bound_by, ops, bytes) of the FFT route at these shapes, a
    yardstick that does not move with a tree's design: the transforms at
    lengths Lh, Lw = ``next_fast_len`` of the patch's sides, at least 16
    (``lengths`` = "pow2": the powers of two that the route took before),
    at 5 L log2 L operations a complex transform of L points (pass 1 the
    packed row pairs of both inputs, pass 2 two forward and one inverse
    column transform of each of the Lw//2 + 1 columns, pass 3 the kept rows'
    pairs) and the 6 of each pointwise product, over 67 TFLOP/s; the inputs
    read once and the output written once over 3.35 TB/s."""
    P, ph, pw, C = patches.shape
    kh, kw = kernel_hw
    hp, wp = ph - kh + 1, pw - kw + 1
    if lengths == "pow2":
        lh, lw = (max(16, 1 << (n - 1).bit_length()) for n in (ph, pw))
    else:
        lh, lw = (next_fast_len(max(16, n)) for n in (ph, pw))
    t = lambda n: 5 * n * math.log2(n)
    rows_b, n_out = (hp, kh) if adjoint else (kh, hp)
    nc = lw // 2 + 1
    ops = P * C * ((-(-ph // 2) + -(-rows_b // 2) + -(-n_out // 2)) * t(lw)
                   + nc * (3 * t(lh) + 6 * lh))
    second = P * hp * wp * C if adjoint else P * kh * kw * C
    out = P * kh * kw * C if adjoint else P * hp * wp * C
    nbytes = 4 * (patches.numel() + second + out)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops,
            nbytes)


def auto_ms(torch, fn, budget_ms=600.0, queue_ahead=False):
    """``time_ms`` with its batches sized to the call: one call timed on the
    host clock first, then batches of ~20 ms, as many as fit ``budget_ms``
    (3 to 25); ``queue_ahead`` as ``time_ms``'s."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max((time.perf_counter() - start) * 1e3, 1e-3)
    batch = max(1, min(10, int(20.0 / one)))
    runs = max(3, min(25, int(budget_ms / (one * batch))))
    return time_ms(torch, fn, runs=runs, batch=batch, warmup=1, queue_ahead=queue_ahead)


def phase_p2_crossover(torch, image, inputs, card):
    """P2 and its d/dpsf by both routes on the same render inputs ({(name,
    px): (patches, psfs, cot)}), CUDA events (``auto_ms``): the direct
    kernels where their launchers take the PSF (``p2_max_kw``,
    ``p2_dpsf_max_kw``), the FFT route's kernels, and the torch.fft product
    and correlation, each back to back (``key``) and queued behind a sleep
    kernel (``key_queued``: the device's time alone). Returns {label: {key:
    ms}}."""
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    out = {}
    for (name, px), (patches, psfs, cot) in inputs.items():
        kh, kw = psfs.shape[1:3]
        k = (kh, kw)
        calls = {"fft_fwd": lambda: image._launch_fft(patches, psfs, k, False),
                 "fft_dpsf": lambda: image._launch_fft(patches, cot, k, True),
                 "torch_fft_fwd": lambda: fft_conv(torch, patches, psfs),
                 "torch_fft_dpsf": lambda: fft_dpsf(torch, patches, cot, k)}
        if max(k) <= lib.p2_max_kw():
            calls["direct_fwd"] = lambda: image._launch_p2(patches, psfs)
        if max(k) <= lib.p2_dpsf_max_kw():
            calls["direct_dpsf"] = lambda: image._launch_p2_dpsf(patches, cot, k)
        ms = {}
        with torch.no_grad():
            for key, fn in calls.items():
                ms[key] = auto_ms(torch, fn)
                ms[f"{key}_queued"] = auto_ms(torch, fn, queue_ahead=True)
        label = f"{name} {px}^2 K={kh}"
        out[label] = ms
        print(f"time P2 routes at {label}, patches {tuple(patches.shape)}: " + ", ".join(
            f"{key} {v:.4f} ms" for key, v in ms.items()) + f"; card: {card}", flush=True)
    return out


def phase_fft_timing(torch, image, wide, card):
    """CUDA events (``auto_ms``): the FFT route's kernels, forward and
    d/dpsf, their plain versions and the torch.fft product and correlation
    at the default configuration's 1448^2, 2048^2 and 4096^2 shapes (K =
    33, 47, 95; ``wide`` maps K to (patches, psfs, cot)), with the route's
    bound at the fast lengths, the power-of-two lengths' beside it, and the
    direct sum's. Returns {key: ms}, {key: bound tuple}."""
    ms, bounds = {}, {}
    for k in (33, 47, 95):
        patches, psfs, cot = wide[k]
        kh, kw = psfs.shape[1:3]
        calls = {f"fft_p2_k{k}": lambda: image._launch_fft(patches, psfs, (kh, kw), False),
                 f"plain_fft_p2_k{k}": lambda: image.svola_patch_conv_fft_reference(patches, psfs),
                 f"torch_fft_p2_k{k}": lambda: fft_conv(torch, patches, psfs),
                 f"fft_dpsf_k{k}": lambda: image._launch_fft(patches, cot, (kh, kw), True),
                 f"plain_fft_dpsf_k{k}": lambda: image.svola_patch_conv_dpsf_fft_reference(
                     patches, cot, (kh, kw)),
                 f"torch_fft_dpsf_k{k}": lambda: fft_dpsf(torch, patches, cot, (kh, kw))}
        with torch.no_grad():
            for key, fn in calls.items():
                ms[key] = auto_ms(torch, fn, budget_ms=300.0 if "plain" in key else 600.0)
        for what, adjoint in (("p2", False), ("dpsf", True)):
            bounds[f"fft_{what}_k{k}"] = fft_route_bound(patches, (kh, kw), adjoint)
            bounds[f"fft_{what}_k{k}_pow2"] = fft_route_bound(patches, (kh, kw), adjoint, "pow2")
        bounds[f"direct_p2_k{k}"] = p2_bound(patches, psfs)
        bounds[f"direct_dpsf_k{k}"] = dpsf_bound(patches, (kh, kw))
        for what in ("p2", "dpsf"):
            b = bounds[f"fft_{what}_k{k}"]
            t = ms[f"fft_{what}_k{k}"]
            print(f"time P2's FFT route, {'forward' if what == 'p2' else 'd/dpsf'}, at "
                  f"{tuple(patches.shape)}, K = {k}: {t:.4f} ms (plain "
                  f"{ms[f'plain_fft_{what}_k{k}']:.3f} ms, torch.fft "
                  f"{ms[f'torch_fft_{what}_k{k}']:.4f} ms); the route's bound at the fast "
                  f"lengths {b[0]:.4f} ms by {b[1]} ({b[2]:.3e} operations, {b[3] / 1e6:.1f} MB), "
                  f"{b[0] / t:.3f} of it reached (at powers of two: "
                  f"{bounds[f'fft_{what}_k{k}_pow2'][0]:.4f} ms); the direct sum's bound "
                  f"{bounds[f'direct_{what}_k{k}'][0]:.4f} ms; card: {card}", flush=True)
    return ms, bounds


# The image-loss steps of the default configuration: its renders from 1448^2
# take the FFT route both ways. The card-vs-CPU gradient check runs at the
# smallest of them (1448^2, K = 33) with config 5's PSF bundle (9 fields x
# 24 circular rings) in place of the default's 21 fields of a jittered
# 32 x 32 pupil: that pupil draws from each device's own generator, so card
# and CPU would trace different rays.
DEFAULT_TRAIN_PX = 2048
DEFAULT_GRAD_PX = 1448
DEFAULT_GRAD_BUNDLE = dict(n_sampled_fields=9, n_pupil_rings=24, pupil_sampling="circular")


def phase_default_image_training(torch, zoo, simulator, imaging, image, fused_trace,
                                 LensOptimizer, card, n_steps=3, psf_shape=(65, 65)):
    """This slice's main path: ``n_steps`` Adam steps of ``LensOptimizer``
    with ``make_image_loss_fn`` at the default configuration at 2048^2 (K =
    47; at psf_shape (257, 257) K = 187 and S1's 257 x 129 half grid), the
    counts set to 0 before each step and read after: K1 forward and
    backward once each, P2 on the FFT route once (three launches, no direct
    one) and d/dpsf on the FFT route once (three); every loss and gradient
    finite, every step accepted; the host wall of each step. Then, at the
    default psf_shape, the first step's d/d(c, t) on the card against the
    port's CPU at ``DEFAULT_GRAD_PX`` with ``DEFAULT_GRAD_BUNDLE`` within
    ``IMAGE_GRAD_BAR`` (None at another psf_shape). S1 (the PSF splat)
    forward and adjoint once each a step. Returns the launches summed over
    the run (K1f, K1b, P2 direct, P2 FFT, d/dpsf direct, d/dpsf FFT, S1f,
    S1b), the walls and the gradient's (relative deviation, cosine)."""
    from torchoptics_tpu_torch.ops import psf
    names = ("K1_FWD_LAUNCHES", "K1_BWD_LAUNCHES")
    counters = ("P2_LAUNCHES", "P2_FFT_LAUNCHES", "P2_DPSF_LAUNCHES", "P2_DPSF_FFT_LAUNCHES")
    splats = ("SPLAT_LAUNCHES", "SPLAT_BWD_LAUNCHES")

    def reset():
        for c in names:
            setattr(fused_trace, c, 0)
        for c in counters:
            setattr(image, c, 0)
        for c in splats:
            setattr(psf, c, 0)
    read = lambda: (tuple(getattr(fused_trace, c) for c in names)
                    + tuple(getattr(image, c) for c in counters)
                    + tuple(getattr(psf, c) for c in splats))
    cfg = default_imaging_config(simulator, psf_shape=psf_shape)
    opt, state = image_optimizer(torch, zoo, simulator, imaging, LensOptimizer, "cuda",
                                 DEFAULT_TRAIN_PX, cfg)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    per_step, totals, psnrs, walls, finite = [], [], [], [], []
    grads = lambda: [v["exp_avg"] for v in state.opt_state.state.values()]
    for _ in range(n_steps):
        reset()
        t0 = time.perf_counter()
        state, total, terms = opt.step(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read())
        totals.append(float(total))
        psnrs.append(float(terms["psnr"]))
        finite.append(all(bool(torch.isfinite(g).all()) for g in grads()))
    adam_steps = [int(v["step"]) for v in state.opt_state.state.values()]
    moved = max(float((state.params[k].detach() - start[k]).abs().max()) for k in start)
    k = imaging.psf_kernel_shape((DEFAULT_TRAIN_PX,) * 2, cfg)
    check(all(c == (1, 1, 0, 3, 0, 3, 1, 1) for c in per_step)
          and all(map(math.isfinite, totals)) and all(finite)
          and adam_steps == [n_steps] * len(adam_steps) and moved > 0,
          f"image training at the default configuration at {DEFAULT_TRAIN_PX}^2, psf_shape "
          f"{psf_shape} (K = {k[0]}, double-Gauss defocused 0.3 mm): {n_steps} LensOptimizer "
          f"steps, Adam's first moments finite {finite}, launches per step "
          f"(K1 forward, K1 backward, P2 direct, P2 FFT, d/dpsf direct, d/dpsf FFT, S1 forward, "
          f"S1 adjoint) {per_step} (expected (1, 1, 0, 3, 0, 3, 1, 1) each); every step "
          f"accepted (Adam step counts "
          f"{adam_steps}); losses {['%.5f' % v for v in totals]}; PSNR "
          f"{['%.4f' % v for v in psnrs]} dB; parameters moved by up to {moved:.3e}")
    print(f"time image-loss LensOptimizer.step at the default configuration at "
          f"{DEFAULT_TRAIN_PX}^2, psf_shape {psf_shape}: {', '.join('%.2f' % w for w in walls)} "
          f"ms (host clock, each step; median {statistics.median(walls):.2f} ms); card: {card}",
          flush=True)
    launches = tuple(sum(c[i] for c in per_step) for i in range(8))
    if tuple(psf_shape) != (65, 65):
        return launches, walls, None
    kg = imaging.psf_kernel_shape((DEFAULT_GRAD_PX,) * 2, cfg)
    check(image.p2_takes_fft(kg) and image.p2_takes_fft(kg, adjoint=True),
          f"the default configuration's render at {DEFAULT_GRAD_PX}^2 (K = {kg[0]}) takes the "
          f"FFT route both ways")
    grad = gradient_card_vs_cpu(
        torch, zoo, simulator, imaging, LensOptimizer, DEFAULT_GRAD_PX,
        default_imaging_config(simulator, **DEFAULT_GRAD_BUNDLE),
        f"the default configuration's imaging at {DEFAULT_GRAD_PX}^2 (K = {kg[0]}; PSF bundle "
        f"{DEFAULT_GRAD_BUNDLE})")
    return launches, walls, grad


#: The render whose patches pass P2's FFT route's longest transform: the
#: default configuration at 4096^2 with one PSF (psf_grid_shape (1, 1), K =
#: 95), patches of 6,238 pixels a side, cut into 2 x 2 sub-patches
#: (``image.fft_tiles``); its check's lowered cut (4 x 4).
FFT_CUT_PX = 4096
FFT_CUT_LOWERED = 2048


def fft_cut_check(torch, image, label, patches, psfs, cot):
    """P2's FFT route as the port calls it (``image._p2``,
    ``image._p2_dpsf``: cut by ``image.fft_tiles``) on (patches, psfs, cot):
    bit for bit with the plain versions (which cut alike), within
    ``FFT_BAR`` of the float64 torch.fft product and correlation of the
    whole patch (a share of the largest entry), three launches a piece each
    way. Returns ({"fwd": (max deviation from the plain version, share),
    "dpsf": ...}, pieces)."""
    kh, kw = psfs.shape[1:3]
    pieces = len(image.fft_tiles(patches.shape[1], kh)) * len(image.fft_tiles(patches.shape[2],
                                                                              kw))
    image.P2_FFT_LAUNCHES = image.P2_DPSF_FFT_LAUNCHES = 0
    errs, same = {}, {}
    with torch.no_grad():
        got = {"fwd": image._p2(patches, psfs), "dpsf": image._p2_dpsf(patches, cot, (kh, kw))}
        torch.cuda.synchronize()
        launches = (image.P2_FFT_LAUNCHES, image.P2_DPSF_FFT_LAUNCHES)
        plain = {"fwd": lambda: image.svola_patch_conv_fft_reference(patches, psfs),
                 "dpsf": lambda: image.svola_patch_conv_dpsf_fft_reference(patches, cot,
                                                                           (kh, kw))}
        yardstick = {"fwd": lambda: fft_conv(torch, patches.double(), psfs.double()),
                     "dpsf": lambda: fft_dpsf(torch, patches.double(), cot.double(), (kh, kw))}
        for key in ("fwd", "dpsf"):
            want = plain[key]()
            same[key] = torch.equal(got[key], want)
            dev = float((got[key] - want).abs().max())
            del want
            ref = yardstick[key]()
            errs[key] = (dev, float((got[key].double() - ref).abs().max()) / float(ref.abs().max()))
            del ref
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    check(all(same.values()) and finite and launches == (3 * pieces,) * 2
          and all(errs[k][1] <= FFT_BAR[k] for k in errs),
          f"P2's FFT route cut into {pieces} sub-patches, {label}: patches "
          f"{tuple(patches.shape)}, PSFs {tuple(psfs.shape)}, cut at {image.P2_FFT_TILE} "
          f"(pieces of rows {image.fft_tiles(patches.shape[1], kh)}); forward bit-identical to "
          f"its plain version={same['fwd']} (max deviation {errs['fwd'][0]:.3e}), within "
          f"{errs['fwd'][1]:.2e} of the float64 torch.fft product's largest entry (bar "
          f"{FFT_BAR['fwd']:.0e}); d/dpsf bit-identical={same['dpsf']} ({errs['dpsf'][0]:.3e}), "
          f"within {errs['dpsf'][1]:.2e} of the float64 correlation (bar "
          f"{FFT_BAR['dpsf']:.0e}); launches {launches} (3 a piece each way)")
    return errs, pieces


def phase_fft_cut(torch, zoo, simulator, imaging, image, fused_trace, card):
    """Phase 44: P2's FFT route past its longest transform, at the default
    configuration's 4096^2 render with one PSF (``FFT_CUT_PX``): the
    render's patches (6,238 pixels a side, K = 95) and a seeded cotangent
    through the route with its cut lowered to ``FFT_CUT_LOWERED``, then at
    the real cut (``fft_cut_check``: bit for bit with the plain versions,
    within ``FFT_BAR`` of float64 torch.fft); the route's times there (CUDA
    events; the plain versions one host-clock run each; the torch.fft
    product and correlation of the whole patch); then the render itself,
    its launches counted from 0 (K1 forward once, S1 forward once, the FFT
    route three a piece, no direct P2), finite, and its host wall. Returns
    the numbers for the FFT route's entries."""
    from torchoptics_tpu_torch.ops import psf
    cfg = default_imaging_config(simulator, psf_grid_shape=(1, 1))
    specs, lens = zoo.build("double_gauss", device="cuda")
    rad = torch.tensor(photograph(FFT_CUT_PX)[None], device="cuda")
    with torch.no_grad():
        model = imaging.sample_optics_model(specs, lens, cfg)
        patches, psfs = p2_inputs(torch, imaging, image, model, rad, cfg)
    del model
    P, ph, pw, C = patches.shape
    kh, kw = psfs.shape[1:3]
    check(image.p2_takes_fft((kh, kw)) and image.p2_takes_fft((kh, kw), adjoint=True)
          and min(ph, pw) > image.P2_FFT_MAX_LEN,
          f"the default configuration's {FFT_CUT_PX}^2 render with one PSF: patches "
          f"{tuple(patches.shape)} longer than the route's longest transform "
          f"({image.P2_FFT_MAX_LEN}), PSFs {tuple(psfs.shape)} on the FFT route both ways")
    gen = torch.Generator(device="cuda").manual_seed(44)
    cot = torch.randn((P, ph - kh + 1, pw - kw + 1, C), generator=gen, device="cuda")
    cut = image.P2_FFT_TILE
    image.P2_FFT_TILE = FFT_CUT_LOWERED
    try:
        lowered, lowered_pieces = fft_cut_check(torch, image, "a lowered cut", patches, psfs, cot)
    finally:
        image.P2_FFT_TILE = cut
    errs, pieces = fft_cut_check(torch, image, "the route's cut", patches, psfs, cot)
    with torch.no_grad():
        ms = {"fft_p2": auto_ms(torch, lambda: image._p2(patches, psfs)),
              "fft_dpsf": auto_ms(torch, lambda: image._p2_dpsf(patches, cot, (kh, kw))),
              "torch_fft_p2": auto_ms(torch, lambda: fft_conv(torch, patches, psfs)),
              "torch_fft_dpsf": auto_ms(torch, lambda: fft_dpsf(torch, patches, cot, (kh, kw))),
              "plain_fft_p2": host_ms(torch, lambda: image.svola_patch_conv_fft_reference(
                  patches, psfs), runs=1, warmup=0),
              "plain_fft_dpsf": host_ms(torch, lambda: image.svola_patch_conv_dpsf_fft_reference(
                  patches, cot, (kh, kw)), runs=1, warmup=0)}
    bounds = {"p2": fft_route_bound(patches, (kh, kw), False),
              "dpsf": fft_route_bound(patches, (kh, kw), True)}
    del patches, psfs, cot
    torch.cuda.empty_cache()
    counters = ("P2_LAUNCHES", "P2_FFT_LAUNCHES")
    for c in counters:
        setattr(image, c, 0)
    fused_trace.K1_FWD_LAUNCHES = psf.SPLAT_LAUNCHES = 0
    irr, psnr, ssim = render(torch, imaging, specs, lens, rad, cfg)
    torch.cuda.synchronize()
    launches = (fused_trace.K1_FWD_LAUNCHES, psf.SPLAT_LAUNCHES,
                *(getattr(image, c) for c in counters))
    ok = bool(torch.isfinite(irr).all()) and math.isfinite(float(psnr[0]))
    del irr
    wall = host_ms(torch, lambda: render(torch, imaging, specs, lens, rad, cfg), runs=3, warmup=0)
    check(ok and launches == (1, 1, 0, 3 * pieces),
          f"the default configuration's {FFT_CUT_PX}^2 render with one PSF: launches (K1 "
          f"forward, S1 forward, P2 direct, P2 FFT) {launches} (expected (1, 1, 0, "
          f"{3 * pieces})), irradiance finite={ok}, PSNR {float(psnr[0]):.3f} dB, SSIM "
          f"{float(ssim[0]):.5f}")
    for what in ("p2", "dpsf"):
        b, t = bounds[what], ms[f"fft_{what}"]
        print(f"time P2's FFT route {'forward' if what == 'p2' else 'd/dpsf'} cut into {pieces} "
              f"sub-patches at the {FFT_CUT_PX}^2 one-PSF render ({ph}^2 patches, K = {kh}): "
              f"{t:.3f} ms (plain {ms[f'plain_fft_{what}']:.1f} ms, one run; torch.fft of the "
              f"whole patch {ms[f'torch_fft_{what}']:.3f} ms); bound {b[0]:.4f} ms by {b[1]}, "
              f"{b[0] / t:.3f} of it reached; card: {card}", flush=True)
    print(f"time the default configuration's {FFT_CUT_PX}^2 render with one PSF: {wall:.1f} ms "
          f"(host clock, median of 3); card: {card}", flush=True)
    return {"pieces": pieces, "lowered_pieces": lowered_pieces, "launches": launches[3],
            "errs": errs, "lowered_errs": lowered, "ms": ms, "bounds": bounds,
            "render_wall_ms": wall, "patch": [ph, pw], "k": kh}


def fft_entries(wide_errs, wide_launches, train, ms, bounds, crossover, rates, cut=None):
    """The FFT route's entries of the kernels line: forward (``p2_fft``) and
    d/dpsf (``p2_dpsf_fft``), their times at the default configuration's
    2048^2 shape (K = 47, the main path's) with K = 95 beside, ``launches``
    counting the main path's run (the default configuration's image-loss
    steps), the route's bound and the direct sum's beside it, the route's
    operations at P1's FP32 issue rate (``bound_ms_issue``: no FMA
    contraction, an instruction an operation), the deviations from the
    plain versions and from float64 torch.fft, and the crossover timings of
    both routes; with ``cut`` (phase 44), ``cut_4096_one_psf``: the route
    cut into sub-patches at the 4096^2 render with one PSF."""
    launches, walls, grad = train
    errs47 = wide_errs["default config at 2048^2"]
    errs95 = wide_errs["default config at 4096^2"]

    def entry(what, key, launched, extra):
        b, b95, b33 = (bounds[f"fft_{what}_k{k}"] for k in (47, 95, 33))
        return {"name": f"p2_{'fft' if what == 'p2' else 'dpsf_fft'}", "route": "cuda",
                "source": P2_FFT_SOURCE, "replaces": TPU_P2_FFT if what == "p2" else TPU_P2_DPSF,
                "launches": launched, "max_abs_err": errs47[key][0],
                "ms": ms[f"fft_{what}_k47"], "plain_ms": ms[f"plain_fft_{what}_k47"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": ms[f"torch_fft_{what}_k47"],
                "bound_share": b[0] / ms[f"fft_{what}_k47"],
                "bound_ms_issue": b[2] / rates["fma_ops_per_s"] * 1e3,
                "bound_ms_issue_k95": b95[2] / rates["fma_ops_per_s"] * 1e3,
                "direct_bound_ms": bounds[f"direct_{what}_k47"][0],
                "float64_share": errs47[key][1], "cufft_float64_share": errs47[key][2],
                "bound_ms_pow2": bounds[f"fft_{what}_k47_pow2"][0],
                "ms_k95": ms[f"fft_{what}_k95"], "plain_ms_k95": ms[f"plain_fft_{what}_k95"],
                "bound_ms_k95": b95[0], "bound_by_k95": b95[1],
                "library_ms_k95": ms[f"torch_fft_{what}_k95"],
                "ms_k33": ms[f"fft_{what}_k33"], "plain_ms_k33": ms[f"plain_fft_{what}_k33"],
                "bound_ms_k33": b33[0], "bound_by_k33": b33[1],
                "library_ms_k33": ms[f"torch_fft_{what}_k33"],
                "direct_bound_ms_k95": bounds[f"direct_{what}_k95"][0],
                "max_abs_err_k95": errs95[key][0], "float64_share_k95": errs95[key][1],
                "max_float64_share": max(e[key][1] for e in wide_errs.values()),
                **({"cut_4096_one_psf": {
                    "pieces": cut["pieces"], "launches_render": cut["launches"],
                    "patch": cut["patch"], "k": cut["k"], "ms": cut["ms"][f"fft_{what}"],
                    "plain_ms": cut["ms"][f"plain_fft_{what}"],
                    "library_ms": cut["ms"][f"torch_fft_{what}"],
                    "bound_ms": cut["bounds"][what][0], "bound_by": cut["bounds"][what][1],
                    "max_abs_err": cut["errs"][key][0], "float64_share": cut["errs"][key][1],
                    "lowered_cut_max_abs_err": cut["lowered_errs"][key][0],
                    "render_wall_ms": cut["render_wall_ms"]}} if cut else {}), **extra}
    return [
        entry("p2", "fwd", launches[3], {"render_2048_launches": wide_launches,
                                         "crossover_ms": crossover}),
        entry("dpsf", "dpsf", launches[5], {
            "image_training_default_2048_launches": dict(zip(
                ("k1_fwd", "k1_bwd", "p2", "p2_fft", "p2_dpsf", "p2_dpsf_fft", "s1_fwd",
                 "s1_bwd"), launches)),
            "image_training_default_2048_step_ms": walls,
            "image_grad_1448_rel_err": grad[0], "image_grad_1448_cosine": grad[1]}),
    ]


def imaging_entries(p2_err, p2_launches, ms, p2_b, walls, p1, rates):
    """The P2 and P1 entries of the kernels line. P2's ``launches`` counts the
    1024^2 render of the serving phase (its main path), its times are at that
    render's shape; P1's ``launches`` counts the rate protocol's run, its
    ``ms``, ``plain_ms`` and bound are for the check's work (the fma chain at
    64 iterations on the probe's grid), and the rates stand beside them."""
    p1_rates, p1_launches, p1_err, p1_ms, p1_plain_ms, n = p1
    p1_ops = 2 * n * 8 * 64
    p1_bound = max(p1_ops / PEAK_FLOPS, 8 * n / PEAK_BYTES) * 1e3
    return [
        {"name": "p2_svola", "route": "cuda", "source": P2_SOURCE, "replaces": TPU_P2,
         "launches": p2_launches, "max_abs_err": p2_err, "ms": ms["p2"],
         "plain_ms": ms["plain_p2"], "bound_ms": p2_b[0], "bound_by": p2_b[1],
         "library_ms": ms["fft_p2"],
         "bound_ms_issue": p2_b[2] / rates["fma_ops_per_s"] * 1e3,
         **{f"render_{px}_sample_ms": w[0] for px, w in walls.items()},
         **{f"render_{px}_apply_ms": w[1] for px, w in walls.items()}},
        {"name": "p1_probe", "route": "cuda", "source": P1_SOURCE, "replaces": TPU_P1,
         "launches": p1_launches, "max_abs_err": p1_err, "ms": p1_ms, "plain_ms": p1_plain_ms,
         "bound_ms": p1_bound, "bound_by": "operations", "library_ms": None,
         **{k: v for k, v in p1_rates.items() if k.endswith(("_ops_per_s", "_weight"))}},
    ]


def add_issue_bounds(entries, rates, shapes):
    """Each trace kernel entry's ``bound_ms_issue``: its operations at the
    card's measured FP32 issue rate (P1's fma rate, one instruction per add
    or multiply: the kernels are built without FMA contraction), each sqrt,
    division and acosf weighted by P1's measured sqrt and div weights
    (acosf at the sqrt weight: no instruction count of it was made), K1's and
    K2's exact shortcuts at their instruction counts (``FAST_SQRT_ISSUES``,
    ``FAST_DIV_ISSUES``), for the entry's main mode at its timed shape. ``shapes`` maps a family (k1-k4,
    and 'opl_k1'..'opl_k4') to its timed shape. An entry that also carries
    the plain or full mode's time (``ms_plain``, ``ms_full``) gets that
    mode's bound beside it (``bound_ms_issue_plain``, ``_full``)."""
    w_s, w_d, rate = rates["sqrt_weight"], rates["div_weight"], rates["fma_ops_per_s"]
    for e in entries:
        name = e["name"]
        if not name.startswith(("k1", "k2", "k3", "k4")):
            continue
        family, backward, opl = name[:2], name[3:6] == "bwd", name.endswith("_opl")
        shape = shapes[("opl_" if opl else "") + family]
        n_surf = shape["n_surf"]
        n_sides = sum(math.isfinite(v) for gap in shape.get("bounds", ()) for v in gap)
        main = False if opl else ("full" if name.endswith("_full") else True)
        for suffix, penalties in (("", main), ("_plain", False), ("_full", "full")):
            if suffix and f"ms{suffix}" not in e:
                continue
            if family in ("k1", "k2"):
                n = k1_ops(penalties, n_surf, n_sides, backward)
            else:
                n = k3_ops(penalties, n_surf, shape["n_asph"], shape["newton_steps"], backward,
                           n_sides, shape["newton_no_period"])
            ops = n.total + ((4 if backward else 2) * (n_surf + 1) if opl else 0)
            weighted = (ops + (w_s - 1) * (n.sqrt + n.acos) + (w_d - 1) * n.div
                        + (FAST_SQRT_ISSUES - 1) * n.fast_sqrt + (FAST_DIV_ISSUES - 1) * n.fast_div)
            e[f"bound_ms_issue{suffix}"] = shape["n_rays"] * weighted / rate * 1e3


def ptxas_summary(path):
    """One line per kernel from the build's -Xptxas -v report."""
    lines, name, frame = [], None, ""
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            raw = line.split("'")[1]
            for short in ("k1_fwd_kernel", "k1_bwd_kernel", "k2_fwd_kernel", "k2_bwd_kernel",
                          "k3_fwd_kernel", "k3_bwd_kernel", "k4_fwd_kernel", "k4_bwd_kernel",
                          "partials_reduce", "p2_svola_kernel", "p2_dpsf_kernel",
                          "p2_dpsf_reduce", "fft_rows_fwd", "fft_cols", "fft_rows_inv",
                          "p1_chain_kernel", "s1_fwd_kernel", "s1_fwd_window_kernel",
                          "s1_fwd_band_kernel", "s1_fwd_reduce", "s1_bwd_window_kernel",
                          "s1_bwd_bins"):
                if short in raw:
                    # The template arguments of the mangled name: I L<type><value>E ... E,
                    # or a type and perhaps bools (S1's IfE, IdLb1EE, IfLb0ELb1EE).
                    tail = raw[raw.index(short) + len(short):]
                    args = re.match(r"I((?:L[a-z]n?\d+E)+)E", tail)
                    typed = re.match(r"I([fd])((?:Lb[01]E)*)E", tail)
                    kind = ("<" + ",".join([{"f": "float", "d": "double"}[typed.group(1)]] + [
                        "true" if b == "1" else "false"
                        for b in re.findall(r"Lb([01])E", typed.group(2))]) + ">"
                            if typed else "")
                    name = short + ("<" + ",".join(
                        ("-" if neg else "") + v
                        for neg, v in re.findall(r"L[a-z](n?)(\d+)E", args.group(1)))
                                    + ">" if args else kind)
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split('info    :')[-1].strip()}; {frame}")
            name = None
    return lines


def k2_splits(torch, zoo, simulator, fused_batch, gen):
    """K2b in plain and Lu mode (backward rays allowed, no bounds) split three
    ways: one Cooke system of 393,216 rays (8 fields x 128^2 x 3,
    ``k2_b1_bwd_*``) against 256 Cooke systems of 1,536 (``k2_cooke_bwd_*``),
    the population layout's cost and its rays'; a 256-system double-Gauss population
    (11 surfaces, ``k2_dg_bwd_*``) against the Cooke one (7), per-ray against
    per-surface cost; and each backward's main kernel and second pass apart
    (``_main``, ``_reduce``: ``reduce_split_ms``), with ``_gap``, the whole
    time (CUDA events) less the two, the gap between them and the launch.
    Two more cases trade the rays of the first two, to part the layout from
    the rays: the population's rays as one system with the first system's
    tables (``k2_poprays_b1_bwd_*``), and the single system's rays cut into
    256 systems of 1,536, each with its tables (``k2_b1rays_pop_bwd_*``)."""
    def inputs_of(name, n_sys, width):
        specs, lens = zoo.population(name, n_sys, device="cuda")
        with torch.no_grad():
            xp, yp, cyb, z0, mu, (_, F, P, _) = fused_batch.prepare_fused_inputs_batch(
                specs, lens, simulator.SimulatorConfig(**width).trace_config())
        return (xp, yp, cyb, z0, lens.c, lens.t, mu), F * P

    cases = {"b1": inputs_of("cooke", 1, dict(GEN_WIDTH, n_pupil_rings=128)),
             "cooke": inputs_of("cooke", N_SYSTEMS, GEN_WIDTH),
             "dg": inputs_of("double_gauss", N_SYSTEMS, GEN_WIDTH)}
    (b1, n1), (pop, n_pop) = cases["b1"], cases["cooke"]
    one = lambda a: a.reshape(1, -1)
    cases["poprays_b1"] = ((one(pop[0]), one(pop[1]), one(pop[2]), b1[3], b1[4], b1[5],
                            b1[6]), n1)
    cut = lambda a: a.reshape(N_SYSTEMS, -1).contiguous()
    rep = lambda a: a.expand((N_SYSTEMS,) + a.shape[1:]).contiguous()
    cases["b1rays_pop"] = ((cut(b1[0]), cut(b1[1]), cut(b1[2]), rep(b1[3]), rep(b1[4]),
                            rep(b1[5]), rep(b1[6])), n_pop)
    ms = {}
    for label, (inputs, n_per_w) in cases.items():
        for penalties in (False, True):
            cot = [torch.randn(inputs[0].shape, device="cuda", generator=gen)
                   for _ in range(7 if penalties else 4)]
            key = f"k2_{label}_bwd_{MODE_NAME[penalties]}"
            with torch.no_grad():
                bwd = lambda: fused_batch._launch_k2_bwd(inputs, cot, penalties, True, n_per_w,
                                                         None, (), 0.25)
                ms[key] = time_ms(torch, bwd, queue_ahead=True)
                ms[f"{key}_reduce"], ms[f"{key}_main"] = reduce_split_ms(torch, bwd)
            ms[f"{key}_gap"] = ms[key] - ms[f"{key}_reduce"] - ms[f"{key}_main"]
    return ms


def p2_times(torch, zoo, simulator, imaging, image):
    """P2 (CUDA events) on the photograph's patches at config 5's 256^2,
    512^2, 1024^2 and 2048^2 renders' shapes (K = 3, 5, 11 and 23, by the
    route the tree takes: the direct kernel's unrolled kw, or from the FFT
    route's threshold the FFT route), queued behind a sleep kernel (at 256^2 and 512^2
    the kernel is shorter than its wrapper): ``p2_256`` ... ``p2_2048``.
    Then the wide renders, by ``auto_ms``: ``svola_patch_conv`` (the route
    the tree takes) at the default configuration's 1024^2-4096^2 (K = 23,
    33, 47, 95) and config 5's 4096^2 (K = 47), ``p2_default_{px}`` and
    ``p2_c5_4096``; and d/dpsf by the tree's route (its ``_p2_dpsf``, or a
    tree without an FFT route its direct kernel) there and at config 5's
    1024^2 and 2048^2, ``dpsf_default_{px}``, ``dpsf_c5_{px}``, back to back,
    and queued behind a sleep kernel (the device's time alone) as
    ``..._queued``."""
    cfg = imaging_config(simulator)
    specs, lens = zoo.build("double_gauss", device="cuda")
    ms = {}
    with torch.no_grad():
        model = imaging.sample_optics_model(specs, lens, cfg)
        for px in (256, 512, 1024, 2048):
            rad = torch.tensor(photograph(px)[None], device="cuda")
            patches, psfs = p2_inputs(torch, imaging, image, model, rad, cfg)
            ms[f"p2_{px}"] = time_ms(torch, lambda: image.svola_patch_conv(patches, psfs),
                                     queue_ahead=True)
    renders = [("config 5", 1024), ("config 5", 2048), ("config 5", 4096)] + [
        ("default", px) for px in (1024, 1448, 2048, 4096)]
    dpsf = getattr(image, "_p2_dpsf", None) or image._launch_p2_dpsf
    for (name, px), (patches, psfs, cot) in render_inputs(torch, zoo, simulator, imaging, image,
                                                          renders).items():
        tag = "c5" if name == "config 5" else "default"
        k = tuple(psfs.shape[1:3])
        with torch.no_grad():
            if name == "default" or px == 4096:
                ms[f"p2_{tag}_{px}"] = auto_ms(torch, lambda: image.svola_patch_conv(patches,
                                                                                      psfs))
            ms[f"dpsf_{tag}_{px}"] = auto_ms(torch, lambda: dpsf(patches, cot, k))
            ms[f"dpsf_{tag}_{px}_queued"] = auto_ms(torch, lambda: dpsf(patches, cot, k),
                                                     queue_ahead=True)
    return ms


KERNEL_FAMILIES = ("k1", "k2", "k3", "k4", "p2", "s1")


def kernel_times(torch, root, card, families=KERNEL_FAMILIES):
    """K1 to K4 forward and backward per mode (plain, Lu, full, opl;
    backward rays allowed), with the timing code of the timing phases
    (``mode_times``, ``opl_times``): K1 and K3 at 2,457,600 rays of the
    double-Gauss and its aspherized form, K2 and K4 at 256 x 1,536 rays of
    the Cooke and aspheric Cooke populations; then K2b's splits
    (``k2_splits``), P2 at four render shapes (``p2_times``) and S1 forward
    and adjoint at the default configuration's splat with its PyTorch
    contractions (``s1_times``; at psf 65, and at psf 257, keys
    ``*_257``) and the adjoint's instantiations (``s1_bwd_variants``); of
    these, the ``families`` named
    (``KERNEL_FAMILIES``). The port is imported from
    the tree at ``root`` and its kernels built there (the build's seconds
    reported where it compiled)."""
    sys.path.insert(0, root)
    from torchoptics_tpu_torch import imaging, simulator, zoo
    from torchoptics_tpu_torch.ops import (_kernels, fused_asphere, fused_batch, fused_trace,
                                           image)
    modules = (fused_trace, fused_batch, fused_asphere)
    built = not _kernels.library_path().exists()
    start = time.perf_counter()
    _kernels.load()
    out = {"root": root, "package": fused_asphere.__file__, "card": card,
           "build_s": time.perf_counter() - start if built else None, "ms": {}}
    gen = torch.Generator(device="cuda").manual_seed(23)
    for kernel in OPL_KERNELS:
        if kernel not in families:
            continue
        out["ms"].update(mode_times(torch, zoo, simulator, modules, kernel, False, gen,
                                    split=True)[0])
        opl = opl_times(torch, zoo, simulator, modules, kernel, False, gen, split=True)[0]
        out["ms"].update({key.replace("_bwd", "_bwd_opl") if "_bwd_" in key else f"{key}_opl":
                          value for key, value in opl.items()})
    if "k2" in families:
        out["ms"].update(k2_splits(torch, zoo, simulator, fused_batch, gen))
    if "p2" in families:
        out["ms"].update(p2_times(torch, zoo, simulator, imaging, image))
    if "s1" in families:
        from torchoptics_tpu_torch.ops import psf
        args = default_splat_args(torch, zoo, simulator, imaging, psf)
        out["ms"].update(s1_times(torch, psf, args))
        out["ms"].update(s1_fwd_split(torch, psf, args))
        out["ms"].update(s1_bwd_variants(torch, zoo, simulator, imaging, psf))
        args = default_splat_args(torch, zoo, simulator, imaging, psf, (257, 257))
        at_257 = s1_times(torch, psf, args)
        out["ms"].update({f"{k}_257": v for k, v in at_257.items()})
        out["ms"].update({f"{k}_257": v for k, v in s1_fwd_split(torch, psf, args).items()})
    return out


# The kernels whose SASS ``kernel_turns`` counts: K1 forward, K2 forward and
# d/dpsf (every instantiation), K4 forward at the populations' two asphere
# terms (the SASS text only of its unmasked instantiations that allow
# backward rays).
SASS_KERNELS = ("k1_fwd_kernel", "k2_fwd_kernel", "p2_dpsf_kernel", "k4_fwd_kernel")
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_summary(lib_path, out_dir=None):
    """Instruction counts of ``SASS_KERNELS``'s instantiations in the library
    at ``lib_path`` (``cuobjdump -sass``): per function (its name with the
    template arguments, as ``ptxas_summary`` gives them), the instructions
    up to its last EXIT (``main``; what follows are the out-of-line slow
    paths of the IEEE square root and division), its longest loop (the
    instructions from a backward branch's target to the branch: the
    runtime-S surface loop), and of ``main`` the MUFU, FP32 (FFMA, FMUL,
    FADD, FMNMX), FSEL/SEL, FSETP/ISETP, shared-memory load, branch (BRA,
    BSSY, BSYNC, CALL) and DFMA counts. With ``out_dir`` the functions' SASS
    goes to ``<out_dir>/sass_<library>.txt``."""
    cuobjdump = str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=600, check=True).stdout
    groups = {"mufu": ("MUFU",), "fp32": ("FFMA", "FMUL", "FADD", "FMNMX"),
              "select": ("FSEL", "SEL"), "compare": ("FSETP", "ISETP"), "lds": ("LDS",),
              "branch": ("BRA", "BSSY", "BSYNC", "CALL"), "dfma": ("DFMA",)}
    out, kept = {}, []
    for chunk in text.split("Function : ")[1:]:
        raw = chunk.split()[0]
        short = next((k for k in SASS_KERNELS if k in raw), None)
        if not short:
            continue
        args = re.match(r"I((?:L[a-z]+\d+E)+)E", raw[raw.index(short) + len(short):])
        targs = re.findall(r"L[a-z]+(\d+)E", args.group(1)) if args else []
        if short == "k4_fwd_kernel" and targs[3] != "2":
            continue
        name = short + ("<" + ",".join(targs) + ">" if args else "")
        # Instructions (address, opcode, words) and the labels' addresses
        # (a branch names its target as an address or as a label).
        ops, labels, pending = [], {}, []
        for line in chunk.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
                continue
            m = SASS_LINE.search(line)
            if not m or not m.group(2).split():
                continue
            addr, words = int(m.group(1), 16), m.group(2).split()
            labels.update({name: addr for name in pending})
            pending = []
            op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
            if op != "NOP":
                ops.append((addr, op, words))
        exits = [addr for addr, op, _ in ops if op == "EXIT"]
        main = [o for o in ops if not exits or o[0] <= exits[-1]]
        loop = 0
        for addr, op, words in main:
            target = None
            for w in words[1:]:
                w = w.strip("`(),")
                if re.fullmatch(r"0x[0-9a-f]+", w):
                    target = int(w, 16)
                elif w in labels:
                    target = labels[w]
            if op == "BRA" and target is not None and target < addr:
                loop = max(loop, sum(1 for a, _, _ in main if target <= a <= addr))
        counts = {"main": len(main), "all": len(ops), "longest_loop": loop}
        for key, names in groups.items():
            counts[key] = sum(1 for _, op, _ in main if op.split(".")[0] in names)
        out[name] = counts
        if short != "k4_fwd_kernel" or targs[1:3] == ["1", "0"]:
            kept.append(f"Function : {name}\n{chunk}")
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        Path(out_dir, f"sass_{Path(lib_path).stem}.txt").write_text("".join(kept))
    return out


def kernel_turns(trees, card, families=KERNEL_FAMILIES):
    """``kernel_times`` of the trees given and of this checkout in turns, one
    process each: the trees, this checkout twice, the trees in reverse (old,
    new, new, old for one tree). The kernels of every tree are built first,
    all trees at once (``build_s``: the seconds that took), and each tree's
    SASS counted (``sass_summary``). Returns each key's times per tree in run
    order, their medians and this checkout's median over each tree's."""
    here = str(Path(__file__).resolve().parent)
    roots = [str(Path(t).resolve()) for t in trees] + [here]
    start = time.perf_counter()
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from torchoptics_tpu_torch.ops import _kernels; print(_kernels.build())")
    builds = [subprocess.Popen([sys.executable, "-c", build, root], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True) for root in roots]
    sass = {}
    for root, proc in zip(roots, builds):
        text = proc.communicate()[0]
        check(proc.returncode == 0, f"kernel build of {root}: exit {proc.returncode}\n"
              + text[-4000:])
        sass[root] = sass_summary(text.strip().splitlines()[-1], Path(here) / "chiprun_out")
    build_s = time.perf_counter() - start
    print(json.dumps({"sass": sass}), flush=True)
    order = roots[:-1] + [here, here] + roots[-2::-1]
    runs = []
    for root in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--kernel-times",
                               root, "--families", ",".join(families)], capture_output=True,
                              text=True, timeout=900)
        check(proc.returncode == 0, f"kernel times of {root}: exit {proc.returncode}\n"
              + proc.stdout[-2000:] + proc.stderr[-4000:])
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    table = {}
    for key in dict.fromkeys(k for run in runs for k in run["ms"]):
        # A key some trees lack (a kernel only their route launches) is
        # kept for the trees that time it.
        per_tree = collections.defaultdict(list)
        for run in runs:
            if key in run["ms"]:
                per_tree[run["root"]].append(run["ms"][key])
        med = {root: statistics.median(v) for root, v in per_tree.items()}
        table[key] = {"runs": dict(per_tree), "median": med,
                      "ratio_to": {root: med[here] / m if m and here in med else None
                                   for root, m in med.items() if root != here}}
    return {"card": card, "this": here, "build_s": build_s, "sass": sass, "kernels": table}


def build_times(trees):
    """The seconds ``_kernels.build()`` takes for each tree given and for
    this checkout, one after another (each build alone on the machine, its
    nvcc processes in parallel as always), in a process each; None where
    the tree's library was built already."""
    here = str(Path(__file__).resolve().parent)
    script = ("import sys, time; sys.path.insert(0, sys.argv[1]); "
              "from torchoptics_tpu_torch.ops import _kernels; "
              "fresh = not _kernels.library_path().exists(); start = time.perf_counter(); "
              "_kernels.build(); print(time.perf_counter() - start if fresh else None)")
    out = {}
    for root in [str(Path(t).resolve()) for t in trees] + [here]:
        proc = subprocess.run([sys.executable, "-c", script, root], capture_output=True,
                              text=True, timeout=900)
        check(proc.returncode == 0, f"kernel build of {root}: exit {proc.returncode}\n"
              + proc.stdout[-2000:] + proc.stderr[-4000:])
        out[root] = json.loads(proc.stdout.strip().splitlines()[-1].replace("None", "null"))
        print(f"build of {root}: {out[root]} s", flush=True)
    return out


def add_resources(entries, summary, n_asph, surf):
    """Each trace kernel entry's registers, stack frame and spills (bytes)
    from the build's ``-Xptxas -v`` report (``ptxas_summary``'s lines), for
    the instantiation its main numbers time: its mode, backward rays
    allowed, K2 and K4 unmasked, K3 and K4 at the timed asphere term count
    (``n_asph``: {"k3": K, "k4": K}), and the kernels with kernels of their
    own per surface count at the timed one (``surf``: {"k1_fwd": S,
    "k2_fwd": S, "k2_bwd": S}, 0 where the timed count takes the runtime-S
    kernel); P2's and d/dpsf's at kw = 11, their timed shape's."""
    found = {}
    for line in summary:
        name, rest = line.split(": ", 1)
        nums = {key: int(m.group(1)) for key, pattern in (
            ("registers", r"(\d+) registers"), ("stack_frame_bytes", r"(\d+) bytes stack frame"),
            ("spill_store_bytes", r"(\d+) bytes spill stores"),
            ("spill_load_bytes", r"(\d+) bytes spill loads"))
            for m in [re.search(pattern, rest)] if m}
        found[name] = nums
    for e in entries:
        name = e["name"]
        family = name[:2]
        if name == "p2_svola":  # the 1024^2 render's kw
            e.update(found.get("p2_svola_kernel<11>", {}))
        if name == "p2_dpsf":  # its kernel at kw = 11, config 5's 1024^2 render
            e.update(found.get("p2_dpsf_kernel<11>", {}))
        if name in ("p2_fft", "p2_dpsf_fft"):  # the same three kernels, at 400 points
            e["passes"] = {k: found.get(f"{k}<{FFT_400_BLOCKS}>", {})
                           for k in ("fft_rows_fwd", "fft_cols", "fft_rows_inv")}
        if family not in ("k1", "k2", "k3", "k4"):
            continue
        mode = 3 if name.endswith("_opl") else 2 if name.endswith("_full") else 1
        rest = {"k1": "", "k2": ",0", "k3": f",{n_asph['k3']}", "k4": f",0,{n_asph['k4']}"}
        ns = f",{surf[name[:6]]}" if name[:6] in surf else ""
        e.update(found.get(f"{name[:6]}_kernel<{mode},1{rest[family]}{ns}>", {}))


# ---------------------------------------------------------------------------
# The analysis layer (analysis.py, ops/metrics.py, ops/vignetting.py).
# ---------------------------------------------------------------------------

#: The README's tolerance run (examples/tolerance_analysis.py): 4096 perturbed
#: double-Gauss designs x 5 fields x 64 pupil points x 3 wavelengths =
#: 3,932,160 rays in one K2 launch.
ANALYSIS_CONFIG = dict(n_sampled_fields=5, n_pupil_rings=8, pupil_sampling="circular",
                       n_ray_aiming_iter=1, wavelengths=(459.0, 520.0, 640.0),
                       psf_shape=(33, 33), psf_abs_pixel_size=4e-3)
ANALYSIS_SAMPLES = 4096
ANALYSIS_TOL = dict(c=1e-4, t=0.01, nd=5e-4, v=0.1)
ANALYSIS_TOL_ASPH = dict(ANALYSIS_TOL, kappa=0.01, asph_rel=0.05)
ANALYSIS_THRESHOLD = 0.01
ANALYSIS_FIELDS = (0.0, 0.5, 0.7, 1.0)
#: The sensitivity tables' bar between the fused and the unroll engine, each
#: entry's deviation over the largest of its table: 1e-2, JAX's own bar between
#: its Pallas and XLA population gradients (tests/test_pallas_batch.py:96) and
#: the float32 floor of these tables: on the CPU port the double-Gauss's
#: float32 and float64 tables differ by 1.1e-2 to 1.4e-2 of their largest
#: entries at this width (its spot RMS is a sum over rays 3 um from a
#: centroid 18 mm off axis).
SENS_BAR = 1e-2
#: The geometric MTFs, card vs CPU: the modulation that the trace's
#: coordinate bar (5e-6 mm) moves at the PSF grid's Nyquist frequency
#: (1 / (2 x 4 um)), 2 pi f dx = 3.9e-3. The splat is smooth, so a ray's
#: shift moves a cut at f by at most 2 pi f times it.
MTF_BAR = 2 * math.pi * 0.5 / ANALYSIS_CONFIG["psf_abs_pixel_size"] * 5e-6


def float64_cuts(opd_map, wavelengths_mm, n, pad):
    """``diffraction_mtf``'s tangential and sagittal cuts in float64 numpy
    from an OPD map (numpy arrays): (F, W, K) each."""
    g = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    X, Y = np.meshgrid(g, g, indexing="xy")
    ok = opd_map["ok"][0] & ((X ** 2 + Y ** 2) <= 1.0).ravel()[None, :, None]
    cuts = {"mtf_t": [], "mtf_s": []}
    for wi, lam in enumerate(wavelengths_mm):
        o = opd_map["opd"][0][:, :, wi].reshape(-1, n, n).astype(np.float64)
        pupil = ok[:, :, wi].reshape(-1, n, n) * np.exp(2j * np.pi * o / lam)
        psf = np.abs(np.fft.fft2(pupil, s=(pad * n, pad * n))) ** 2
        for axis, key in ((-1, "mtf_t"), (-2, "mtf_s")):
            m = np.abs(np.fft.rfft(psf.sum(axis), axis=-1))
            cuts[key].append(m / m[..., :1])
    return {k: np.stack(v, axis=1) for k, v in cuts.items()}


def to_cpu(tree):
    """A nested dict / tuple of tensors moved to the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.detach().cpu() if hasattr(tree, "detach") else tree


def rel_gap(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def allclose_gap(got, want, rtol, atol):
    """The largest of |got - want| / (atol + rtol |want|): <= 1 passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def tolerance_check(torch, analysis, label, specs, lens, tol, card_out, seed, compensator):
    """Hold a 4096-sample tolerance run on the fused engine against the
    unroll engine on the card, on the same perturbed population (drawn again
    from the same seed): per-sample RMS and the statistics at rtol 2e-4,
    atol 1e-6 (JAX's bar between its Pallas and XLA runs), the refocus
    shifts within 5e-5 mm; the yield within the samples that sit that close
    to the threshold."""
    specs_n, lens_n = analysis.tile_population(specs, lens, ANALYSIS_SAMPLES)
    lens_p = analysis.perturb_lens(lens_n, torch.Generator(device="cuda").manual_seed(seed), tol)
    cfg = simulator_config(trace_engine="unroll")
    with torch.no_grad():
        want = to_cpu(analysis._score_population(specs_n, lens_p, cfg, compensator,
                                                  (50.0, 90.0, 99.0), ANALYSIS_THRESHOLD))
    got = to_cpu(card_out)
    gaps = {k: allclose_gap(got[k], want[k], 2e-4, 1e-6)
            for k in ("rms", "nominal_rms", "mean", "std", "p50", "p90", "p99")}
    if compensator is not None:
        # A closed-form focus from nearby float32 rays: within 5e-5 mm (JAX's own
        # engines give such focus shifts 2.3e-5 mm apart, ROADMAP §3).
        gaps["refocus_delta"] = allclose_gap(got["refocus_delta"], want["refocus_delta"], 0.0,
                                             5e-5)
    near = int(((want["rms"][1:] - ANALYSIS_THRESHOLD).abs()
                <= 2e-4 * ANALYSIS_THRESHOLD + 1e-6).sum())
    flips = abs(float(got["yield_fraction"]) - float(want["yield_fraction"])) * (
        ANALYSIS_SAMPLES - 1)
    finite = bool(torch.isfinite(got["rms"]).all())
    check(max(gaps.values()) <= 1.0 and flips <= near + 0.5 and finite and float(got["std"]) > 0,
          f"analysis: {label} tolerance_analysis ({ANALYSIS_SAMPLES} samples, compensator "
          f"{compensator}) on the fused engine vs the unroll engine on the card, the same "
          f"population: worst gap {max(gaps.values()):.3f} of rtol 2e-4 + atol 1e-6 "
          f"({max(gaps, key=gaps.get)}); yield {float(got['yield_fraction']):.4f} vs "
          f"{float(want['yield_fraction']):.4f} ({flips:.0f} samples apart, {near} within the "
          f"bar of the threshold); nominal RMS {float(got['nominal_rms']):.5f} mm, mean "
          f"{float(got['mean']):.5f}, p99 {float(got['p99']):.5f}")
    return max(gaps.values())


def simulator_config(**kw):
    from torchoptics_tpu_torch import simulator
    return simulator.SimulatorConfig(**dict(ANALYSIS_CONFIG, **kw))


def sensitivity_check(torch, analysis, label, specs, lens, card_sens):
    """The fused engine's sensitivity table against the unroll engine's
    autograd on the card, each entry within ``SENS_BAR`` of its table's
    largest, and both against the unroll engine's float64 table: the fused
    one no farther from it than twice the float32 unroll one plus 1e-3 of
    the largest. Then, with ray aiming off (aiming enters the objective as a
    constant, so a finite difference through it differs), the fused table's
    most sensitive curvature against a central difference of the fused
    objective at rtol 1e-2 (JAX's own test)."""
    unroll = to_cpu(analysis.sensitivities(specs, lens, simulator_config(trace_engine="unroll")))
    f64 = to_cpu(analysis.sensitivities(specs, lens, simulator_config(
        trace_engine="unroll", double_precision=True)))
    got = to_cpu(card_sens)
    gaps = {k: rel_gap(got[k], unroll[k]) for k in unroll}
    floor = {k: rel_gap(unroll[k], f64[k]) for k in unroll}
    acc = {k: rel_gap(got[k], f64[k]) for k in unroll}
    check(max(gaps.values()) <= SENS_BAR and all(acc[k] <= 2 * floor[k] + 1e-3 for k in acc)
          and all(bool(torch.isfinite(v).all()) for v in got.values()),
          f"analysis: {label} sensitivities ({', '.join(got)}) on the fused engine vs the unroll "
          f"engine's autograd on the card: worst {max(gaps.values()):.2e} of a table's largest "
          f"({max(gaps, key=gaps.get)}; limit {SENS_BAR:g}); from the float64 table: fused "
          f"{max(acc.values()):.2e}, unroll {max(floor.values()):.2e} (limit twice the unroll "
          f"one's + 1e-3)")
    return max(gaps.values())


def sensitivity_difference_check(torch, zoo, analysis):
    """JAX's own check of the sensitivity table (tests/test_analysis.py:
    189-211) on the card's kernels: the Cooke at 3 fields x a 4-ring
    circular pupil x 3 wavelengths on the fused engine, its most sensitive
    curvature against a central difference of the same objective (eps 1e-5)
    at rtol 1e-2."""
    specs, lens = zoo.build("cooke", device="cuda")
    cfg = simulator_config(n_sampled_fields=3, n_pupil_rings=4, trace_engine="fused")
    g = analysis.sensitivities(specs, lens, cfg)["c"][0].cpu()
    j = int(g.abs().argmax())
    eps = 1e-5

    def rms_at(dc):
        c = lens.c.clone()
        c[0, j] += dc
        with torch.no_grad():
            return float(analysis._per_sample_rms(specs, lens.replace(c=c), cfg)[0])

    fd = (rms_at(eps) - rms_at(-eps)) / (2 * eps)
    gap = abs(float(g[j]) - fd) / abs(fd)
    check(gap <= 1e-2, f"analysis: the Cooke's d(rms)/dc[{j}] on K2's adjoint {float(g[j]):.4f} "
                       f"vs a central difference {fd:.4f}: {gap:.2e} (limit 1e-2)")


def phase_analysis(torch, zoo, modules, card):
    """The analysis layer at the README's tolerance width, each call's
    launches counted from 0 and read after it:

    - ``tolerance_analysis`` of the double-Gauss, 4096 samples, compensator
      None (one K2 Lu launch) and "refocus" (one K2 plain launch for the
      focus, one Lu); ``sensitivities`` (one K2 Lu forward, one backward);
      the same on the aspherized double-Gauss with kappa and asphere
      tolerances on K4; each held against the unroll engine on the card;
    - ``through_focus_mtf`` (9 shifts: one K2 plain launch), ``field_mtf``
      (one K1 plain launch), ``diffraction_mtf`` (grid 32, pad 4: two K1
      opl launches), ``solve_vignetting`` of the Tessar and the
      double-Gauss (n_scan 129), the Seidel sums and focal shifts, the ray
      fans, the field curves, the longitudinal aberration and the five
      metrics (all on the unroll engine), each held against the same call
      on the CPU.

    Then each call's host wall (median of 5 around
    ``torch.cuda.synchronize()``). Returns ({call: {kernel entry:
    launches}}, {call: ms})."""
    from torchoptics_tpu_torch import analysis, trace
    from torchoptics_tpu_torch.ops import metrics, psf, vignetting
    counters = opl_counters(*modules)
    launches, walls, calls, splats = {}, {}, {}, {}

    def counted(name, fn):
        reset_launches(counters)
        psf.SPLAT_LAUNCHES = psf.SPLAT_BWD_LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_launches(counters)
        splats[name] = (psf.SPLAT_LAUNCHES, psf.SPLAT_BWD_LAUNCHES)
        calls[name] = fn
        return out

    fused = simulator_config(trace_engine="fused")
    gap = {}
    for label, tol_kw, kernel in (("double_gauss", ANALYSIS_TOL, "k2"),
                                  ("double_gauss_asph", ANALYSIS_TOL_ASPH, "k4")):
        specs, lens = zoo.build(label, device="cuda")
        tol = analysis.Tolerances(**tol_kw)
        for compensator, mode in ((None, "lu"), ("refocus", "plain + lu")):
            name = f"tolerance_analysis {label}{' refocus' if compensator else ''}"

            def run(compensator=compensator, specs=specs, lens=lens, tol=tol):
                with torch.no_grad():
                    return analysis.tolerance_analysis(
                        specs, lens, fused, tol, ANALYSIS_SAMPLES,
                        torch.Generator(device="cuda").manual_seed(7),
                        rms_threshold=ANALYSIS_THRESHOLD, compensator=compensator)

            out = counted(name, run)
            n_fwd = 2 if compensator else 1
            check(launches[name][kernel] == (n_fwd, 0)
                  and all(v == (0, 0) for k, v in launches[name].items() if k != kernel),
                  f"analysis: {name}: {kernel.upper()} forward launched "
                  f"{launches[name][kernel][0]} times ({mode}; expected {n_fwd}), backward "
                  f"{launches[name][kernel][1]}, other kernels "
                  f"{ {k: v for k, v in launches[name].items() if k != kernel} }")
            gap[name] = tolerance_check(torch, analysis, label, specs, lens, tol, out, 7,
                                        compensator)
        name = f"sensitivities {label}"
        sens = counted(name, lambda specs=specs, lens=lens: analysis.sensitivities(specs, lens,
                                                                                  fused))
        check(launches[name][kernel] == (1, 1)
              and all(v == (0, 0) for k, v in launches[name].items() if k != kernel),
              f"analysis: {name}: {kernel.upper()} forward {launches[name][kernel][0]}, backward "
              f"{launches[name][kernel][1]} (expected 1 and 1), other kernels none")
        gap[name] = sensitivity_check(torch, analysis, label, specs, lens, sens)
    sensitivity_difference_check(torch, zoo, analysis)

    specs, lens = zoo.build("double_gauss", device="cuda")
    specs_h, lens_h = zoo.build("double_gauss", device="cpu")
    deltas = np.linspace(-0.2, 0.2, 9)
    # And at a 257 x 257 PSF grid (S1 over a 257 x 129 half grid).
    wide = simulator_config(trace_engine="fused", psf_shape=(257, 257))
    for name, fn, kernel, expect in (
            ("through_focus_mtf", lambda s, l: analysis.through_focus_mtf(s, l, fused, deltas),
             "k2", (1, 0)),
            ("field_mtf", lambda s, l: analysis.field_mtf(s, l, fused), "k1", (1, 0)),
            ("through_focus_mtf at psf 257",
             lambda s, l: analysis.through_focus_mtf(s, l, wide, deltas), "k2", (1, 0)),
            ("field_mtf at psf 257", lambda s, l: analysis.field_mtf(s, l, wide), "k1", (1, 0))):
        with torch.no_grad():
            out = to_cpu(counted(name, lambda fn=fn: fn(specs, lens)))
            want = fn(specs_h, lens_h)
        mtf_gap = max(float((out[k] - want[k]).abs().max()) for k in want)
        check(launches[name][kernel] == expect
              and all(v == (0, 0) for k, v in launches[name].items() if k != kernel)
              and mtf_gap <= MTF_BAR and bool(torch.isfinite(out["mtf_t"]).all()),
              f"analysis: {name} of the double-Gauss: {kernel.upper()} forward launched "
              f"{launches[name][kernel][0]} times (expected {expect[0]}); card vs CPU within "
              f"{mtf_gap:.2e} (limit {MTF_BAR:.2e}, the coordinate bar's move at Nyquist); "
              f"mtf_t {tuple(out['mtf_t'].shape)}")
        gap[name] = mtf_gap

    name = "diffraction_mtf"
    dcfg = trace.TraceConfig(mode="circular", n_rays=(2, 2), rel_fields=(0.0, 0.7, 1.0),
                             wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1,
                             engine="fused")
    check(not torch.backends.cuda.matmul.allow_tf32, "analysis: TF32 is off")
    with torch.no_grad():
        out = to_cpu(counted(name, lambda: analysis.diffraction_mtf(specs, lens, dcfg,
                                                                    grid_n=32, pad=4)))
        want = analysis.diffraction_mtf(specs_h, lens_h, dcfg, grid_n=32, pad=4)
        g = (np.arange(32) + 0.5) / 32 * 2.0 - 1.0
        X, Y = np.meshgrid(g, g, indexing="xy")
        xy = tuple(torch.tensor(a.ravel()[None, None, :, None], dtype=torch.float32,
                                device="cuda") for a in (X, Y))
        opd = {k: v.numpy() for k, v in to_cpu(analysis.wf.opd_map(specs, lens, dcfg,
                                                                   xy=xy)).items()}
    ref = float64_cuts(opd, [w * 1e-6 for w in dcfg.wavelengths], 32, 4)
    cut_gap = max(float(np.abs(out[k].numpy() - ref[k]).max()) for k in ref)
    cutoff_gap = rel_gap(out["cutoff_cyc_mm"], want["cutoff_cyc_mm"])
    check(launches[name]["k1"] == (2, 0)
          and all(v == (0, 0) for k, v in launches[name].items() if k != "k1")
          and cut_gap <= 1e-4 and cutoff_gap <= 5e-6,
          f"analysis: diffraction_mtf of the double-Gauss (32^2 pupil, pad 4): K1 opl forward "
          f"launched {launches[name]['k1'][0]} times (the bundle and the chief ray; expected 2); "
          f"its cuts within {cut_gap:.2e} of float64 cuts of the card's own OPD (limit 1e-4), "
          f"cutoffs within {cutoff_gap:.2e} of the CPU's (limit 5e-6); card vs CPU cuts "
          f"{max(float((out[k] - want[k]).abs().max()) for k in ('mtf_t', 'mtf_s')):.2e} "
          f"(the OPD's float32 floor)")
    gap[name] = cut_gap

    for label in ("tessar", "double_gauss"):
        name = f"solve_vignetting {label}"
        s, l = zoo.build(label, device="cuda")
        s_h, l_h = zoo.build(label, device="cpu")
        with torch.no_grad():
            out = to_cpu(counted(name, lambda s=s, l=l: vignetting.solve_vignetting(
                s, l, ANALYSIS_FIELDS, n_scan=129)))
            want = vignetting.solve_vignetting(s_h, l_h, ANALYSIS_FIELDS, n_scan=129)
            vcfg = trace.TraceConfig(mode="tee", rel_fields=ANALYSIS_FIELDS, wavelengths=("d",),
                                     n_ray_aiming_iter=1)
            p = np.linspace(-1.0, 1.0, 129).astype(np.float32)
            masks = []
            for dev, ss, ll, sa in (("cuda", s, l, out["semi_apertures"].cuda()),
                                    ("cpu", s_h, l_h, want["semi_apertures"])):
                pp = torch.tensor(p, device=dev).reshape(1, 1, -1, 1)
                z = torch.zeros_like(pp)
                masks.append([vignetting._fan_margins(ss, ll, vcfg, *xy, sa * (1 + 1e-6)).cpu()
                              > 1.0 for xy in ((z, pp), (pp, z))])
        agree = all(bool(torch.equal(a, b)) for a, b in zip(*masks))
        tab_gap = max(float((out[k] - want[k]).abs().max()) for k in want)
        check(agree and tab_gap <= 1e-4 and launches[name] == {k: (0, 0) for k in counters},
              f"analysis: {name} (fields {ANALYSIS_FIELDS}, n_scan 129, unroll engine): the "
              f"blocked masks of both fans agree card vs CPU: {agree}; tables within "
              f"{tab_gap:.2e} (limit 1e-4); vig_up {out['vig_up'][0].numpy().round(4).tolist()}")
        gap[name] = tab_gap

    fcfg = trace.TraceConfig(mode="circular", n_rays=(8, 8), rel_fields=ANALYSIS_FIELDS,
                             wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1)
    host_calls = {
        "seidel_coefficients": lambda s, l: analysis.seidel_coefficients(s, l),
        "ray_fans": lambda s, l: analysis.ray_fans(s, l, fcfg),
        "field_curvature": lambda s, l: analysis.field_curvature(s, l, fcfg),
        "longitudinal_aberration": lambda s, l: analysis.longitudinal_aberration(s, l, fcfg),
        "compute_distortion": lambda s, l: metrics.compute_distortion(s, l, ANALYSIS_FIELDS[1:]),
        "compute_semi_apertures": lambda s, l: metrics.compute_semi_apertures(s, l),
        "compute_ray_aiming_error": lambda s, l: metrics.compute_ray_aiming_error(
            s, l, ANALYSIS_FIELDS),
        "compute_axial_color": lambda s, l: metrics.compute_axial_color(l),
        "compute_lateral_color": lambda s, l: metrics.compute_lateral_color(s, l),
    }
    # The fans' deviations and the lateral colour are differences of two image
    # points at up to the full-field height (~17 mm): the coordinate bar
    # (5e-6 mm or relative) on each, 2 (5e-6 + 5e-6 y_max).
    y_max = float(lens_h.efl[0] * torch.tan(specs_h.hfov[0]))
    diff_atol = 2 * (5e-6 + 5e-6 * y_max)
    for name, fn in host_calls.items():
        with torch.no_grad():
            out = to_cpu(counted(name, lambda fn=fn: fn(specs, lens)))
            want = fn(specs_h, lens_h)
        if name == "seidel_coefficients":
            per = want["per_surface"]
            worst = max(max(float((out["per_surface"][k] - per[k]).abs().max()),
                            float((out[k] - want[k]).abs().max())) / float(per[k].abs().max())
                        for k in per)
            ok, bar = worst <= 1e-5, "1e-5 of the largest per-surface term"
        elif isinstance(want, dict):
            bools = [k for k, v in want.items() if v.dtype == torch.bool]
            rtol, atol = {"field_curvature": (0.0, 5e-5),
                          "ray_fans": (0.0, diff_atol)}.get(name, (5e-6, 5e-6))
            worst = max(allclose_gap(out[k], want[k], rtol, atol)
                        for k in want if k not in bools)
            ok = worst <= 1.0 and all(torch.equal(out[k], want[k]) for k in bools)
            bar = f"{atol:.3g} mm" + (" or relative" if rtol else "") + ", masks equal"
        else:
            rtol, atol = (0.0, diff_atol) if name == "compute_lateral_color" else (5e-6, 5e-6)
            worst = allclose_gap(out, want, rtol, atol)
            ok, bar = worst <= 1.0, f"{atol:.3g} mm" + (" or relative" if rtol else "")
        check(ok and launches[name] == {k: (0, 0) for k in counters},
              f"analysis: {name} of the double-Gauss, card vs CPU: {worst:.3g} (limit: {bar}); "
              f"no kernel launched")
        gap[name] = worst

    with torch.no_grad():
        for name, fn in calls.items():
            walls[name] = host_ms(torch, fn, runs=5, warmup=1)
    per_entry = {}
    entry_of = {("k1", 0): "k1_fwd", ("k2", 0): "k2_fwd", ("k2", 1): "k2_bwd",
                ("k4", 0): "k4_fwd", ("k4", 1): "k4_bwd"}
    for name, runs in launches.items():
        for kernel, counts in runs.items():
            for direction, n in enumerate(counts):
                if n:
                    entry = entry_of[(kernel, direction)]
                    if name == "diffraction_mtf":
                        entry += "_opl"
                    per_entry.setdefault(entry, {})[name] = n
    # S1 (the PSF splat) under each call that splats PSFs.
    for name, counts in splats.items():
        for entry, n in zip(("s1_fwd", "s1_bwd"), counts):
            if n:
                per_entry.setdefault(entry, {})[name] = n
    print(json.dumps({"analysis_walls_ms": {k: round(v, 3) for k, v in walls.items()},
                      "launches": per_entry, "gaps": gap, "card": card}), flush=True)
    return per_entry, walls


def profile_analysis(torch, zoo, card):
    """torch.profiler breakdowns of the 4096-sample tolerance runs (plain and
    refocused, spherical and aspherized) and of the sensitivity tables."""
    from torchoptics_tpu_torch import analysis
    fused = simulator_config(trace_engine="fused")
    for label, tol_kw in (("double_gauss", ANALYSIS_TOL), ("double_gauss_asph", ANALYSIS_TOL_ASPH)):
        specs, lens = zoo.build(label, device="cuda")
        tol = analysis.Tolerances(**tol_kw)
        for compensator in (None, "refocus"):
            def run(compensator=compensator):
                with torch.no_grad():
                    analysis.tolerance_analysis(specs, lens, fused, tol, ANALYSIS_SAMPLES,
                                                torch.Generator(device="cuda").manual_seed(7),
                                                rms_threshold=ANALYSIS_THRESHOLD,
                                                compensator=compensator)
            profile_steps(torch, f"tolerance_analysis {label}, {ANALYSIS_SAMPLES} samples, "
                                 f"compensator {compensator}", run, card)
        profile_steps(torch, f"sensitivities {label}",
                      lambda: analysis.sensitivities(specs, lens, fused), card)


# ---------------------------------------------------------------------------
# Phase 41: parallel/ on torch.distributed, rank groups sharing the one card.
# ---------------------------------------------------------------------------

#: (ranks, lens_parallel, the backend ``init_distributed``'s rule picks):
#: one rank has the card to itself (NCCL); two and four share it (gloo).
PARALLEL_GROUPS = ((1, 1, "nccl"), (2, 1, "gloo"), (4, 2, "gloo"))
PARALLEL_STEPS = 3
#: The sharded-against-single-process bars (tests/test_sharding.py's and
#: tests/test_distributed.py's).
PARALLEL_VALUE_RTOL, PARALLEL_GRAD_RTOL, PARALLEL_GRAD_ATOL = 2e-5, 1e-3, 1e-6


def parallel_cases(torch, zoo, simulator, device):
    """The phase's inputs, the same on every rank: the flagship at
    2,457,600 rays, the 256-system double-Gauss population (glasses 2e-3
    off the catalog) and aspheric Cooke population at the generator width,
    and the train step's optimizer settings."""
    trace_cfg = simulator.SimulatorConfig(pupil_sampling="circular", n_ray_aiming_iter=1,
                                          trace_engine="fused", **BENCH_WIDTH).trace_config()
    pop_cfg = simulator.SimulatorConfig(trace_engine="fused", **GEN_WIDTH)
    specs, lens = zoo.population("double_gauss", N_SYSTEMS, device=device)
    lens = lens.replace(nd=lens.nd + 2e-3)
    pops = {"k2": (specs, lens), "k4": zoo.aspheric_population(N_SYSTEMS, device=device)}
    train_kw = dict(learning_rate=1e-4, use_full_loss=True)
    return trace_cfg, pop_cfg, pops, train_kw


def parallel_loss(torch, fused_batch, shard, specs, lens, cfg, full, mesh=None):
    """(value, gradients w.r.t. c, t[, kappa, asph]) of the population loss:
    sharded over ``mesh`` (this rank's share of the gradients), or the
    single-process fused loss."""
    names = [k for k in ("c", "t", "kappa", "asph") if getattr(lens, k) is not None]
    leaves = {k: getattr(lens, k).detach().clone().requires_grad_(True) for k in names}
    lens = lens.replace(**leaves)
    if mesh is not None:
        value, _ = shard.sharded_fused_losses(specs, lens, cfg, mesh, full=full)
    elif full:
        value, _ = fused_batch.batched_compute_losses_fused(specs, lens, cfg)
    else:
        value, _ = fused_batch.batched_unsupervised_loss(specs, lens, cfg)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(names, grads))


def parallel_train(torch, LensOptimizer, shard, specs, lens, cfg, train_kw, mesh=None):
    """PARALLEL_STEPS steps (sharded over ``mesh``, or single-process
    LensOptimizer steps): (params, last total, each step's host wall ms)."""
    train_kw = dict(train_kw, efl_target=float(lens.efl[0]))
    if mesh is None:
        opt = LensOptimizer(specs, cfg, **train_kw)
        state = opt.init(lens)
        step = opt.step
    else:
        _, init_fn, step = shard.make_sharded_train_step(specs, cfg, mesh, **train_kw)
        state = init_fn(lens)
    walls = []
    for _ in range(PARALLEL_STEPS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, total, _ = step(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - start) * 1e3)
    return {k: v.detach() for k, v in state.params.items()}, total, walls


def parallel_generator(torch, OpticalLoss, mesh=None):
    """One generator step at B = N_SYSTEMS from seeded weights and specs
    (sharded over ``mesh``: the world-sum of the ranks' shares): (loss, the
    MLP's gradients, the MLP after the Adam step)."""
    ol = OpticalLoss("GAGA", spot_metric="xy")
    net = Generator(torch, ol, 0, "cuda")
    inputs = sample_specs(torch, torch.Generator(device="cuda").manual_seed(3), N_SYSTEMS, "cuda")
    loss = ol.unsupervised(inputs, net(inputs), stop_idx=1, engine="fused", mesh=mesh)[0]
    for p, g in zip(net.params, torch.autograd.grad(loss, net.params)):
        p.grad = g
    if mesh is not None:
        mesh.sum_gradients(net.params)
    grads = [p.grad.clone() for p in net.params]
    torch.optim.Adam(net.params, lr=1e-3).step()
    return loss.detach(), grads, [p.detach() for p in net.params]


def parallel_references(torch, path):
    """The single-process results on the card, saved to ``path`` for the
    ranks, and the single-process walls (ms)."""
    from torchoptics_tpu_torch import LensOptimizer, OpticalLoss, simulator, zoo
    from torchoptics_tpu_torch.ops import fused_batch, fused_trace
    trace_cfg, pop_cfg, pops, train_kw = parallel_cases(torch, zoo, simulator, "cuda")
    specs, lens = zoo.build("double_gauss", device="cuda")
    with torch.no_grad():
        res = fused_trace.trace_rays_fused(specs, lens, trace_cfg)
    refs = {"trace": (res.x, res.y, res.ray_ok), "loss": {}}
    for kernel, (specs, lens) in pops.items():
        for full in (True, False):
            refs["loss"][(kernel, full)] = parallel_loss(torch, fused_batch, None, specs, lens,
                                                         pop_cfg, full)
    params, total, walls = parallel_train(torch, LensOptimizer, None, *pops["k2"], pop_cfg,
                                          train_kw)
    refs["train"] = (params, total)
    refs["generator"] = parallel_generator(torch, OpticalLoss)
    specs, lens = zoo.build("double_gauss", device="cuda")
    with torch.no_grad():
        trace_ms = host_ms(torch, lambda: fused_trace.trace_rays_fused(specs, lens, trace_cfg),
                           runs=5, warmup=1)
    torch.save(refs, path)
    return {"step_ms": walls, "trace_ms": trace_ms}


def parallel_rank(device, lens_parallel, backend, ref_path, out_path):
    """One rank of a phase-41 group: every check on the mesh of the group's
    layout, against the single-process results; the launches of this rank
    counted from 0 around each call; its walls written to ``out_path``. A
    failed check raises, which ends the group and the run."""
    import torch
    import torch.distributed as dist
    from torchoptics_tpu_torch import LensOptimizer, OpticalLoss, simulator, zoo
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, fused_trace
    from torchoptics_tpu_torch.parallel import mesh as mesh_mod
    from torchoptics_tpu_torch.parallel import shard

    rank_start = time.perf_counter()
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = mesh_mod.make_mesh(lens_parallel)
    label = f"{n} rank{'s' if n > 1 else ''} ({dist.get_backend()}, lens {mesh.shape['lens']} x " \
            f"rays {mesh.shape['rays']})"

    def rank_check(ok, message):
        if rank == 0 or not ok:
            print(("ok   " if ok else "FAIL ") + f"parallel, {label}, rank {rank}: {message}",
                  flush=True)
        if not ok:
            raise RuntimeError(f"phase 41 check failed on rank {rank}: {message}")

    counters = opl_counters(fused_trace, fused_batch, fused_asphere)
    launches = {}

    def counted(name, fn):
        reset_launches(counters)
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_launches(counters)
        return out

    # The backend init_distributed's rule picked, on CUDA tensors: a sum
    # and a broadcast over the world.
    x = torch.full((3,), rank + 1.0, device=device)
    dist.all_reduce(x)
    y = torch.full((3,), float(rank), device=device)
    dist.broadcast(y, src=n - 1)
    rank_check(dist.get_backend() == backend and bool((x == n * (n + 1) / 2).all())
               and bool((y == n - 1).all()),
               f"backend {dist.get_backend()} (expected {backend}); all_reduce and broadcast "
               f"of CUDA tensors on {device}")
    refs = torch.load(ref_path, map_location=device)
    trace_cfg, pop_cfg, pops, train_kw = parallel_cases(torch, zoo, simulator, device)

    specs, lens = zoo.build("double_gauss", device=device)
    with torch.no_grad():
        res = counted("sharded_trace_rays", lambda: shard.sharded_trace_rays(
            specs, lens, trace_cfg, mesh))
        # The wall of a second call (the first one warmed it up).
        start = time.perf_counter()
        shard.sharded_trace_rays(specs, lens, trace_cfg, mesh)
        torch.cuda.synchronize()
        trace_ms = (time.perf_counter() - start) * 1e3
    x_ref, y_ref, ok_ref = refs["trace"]
    gap = max(float((res.x - x_ref).abs().max()), float((res.y - y_ref).abs().max()))
    rank_check(launches["sharded_trace_rays"]["k1"] == (1, 0) and gap <= 5e-6
               and torch.equal(res.ray_ok, ok_ref),
               f"sharded_trace_rays of the double-Gauss at {res.y.numel():,} rays: K1 forward "
               f"launched {launches['sharded_trace_rays']['k1'][0]} time(s) on this rank "
               f"(expected 1); x and y within {gap:.2e} mm of the single-process trace "
               f"(limit 5e-6), ray_ok bit-identical")
    del res

    for (kernel, full), (want, want_grads) in refs["loss"].items():
        specs, lens = pops[kernel]
        name = f"sharded_fused_losses {kernel} {'full' if full else 'lu'}"
        value, grads = counted(name, lambda: parallel_loss(torch, fused_batch, shard, specs,
                                                           lens, pop_cfg, full, mesh))
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        if n > 1:
            dist.all_reduce(flat)
        summed = torch.split(flat, [g.numel() for g in grads.values()])
        rel = abs(float(value) - float(want)) / abs(float(want))
        worst = max(float(((s.view_as(w) - w).abs() / (PARALLEL_GRAD_ATOL
                                                       + PARALLEL_GRAD_RTOL * w.abs())).max())
                    for s, w in zip(summed, want_grads.values()))
        rank_check(launches[name][kernel] == (1, 1)
                   and all(v == (0, 0) for k, v in launches[name].items() if k != kernel)
                   and rel <= PARALLEL_VALUE_RTOL and worst <= 1.0,
                   f"{name} on {N_SYSTEMS} systems x 1,536 rays: {kernel.upper()} forward and "
                   f"backward {launches[name][kernel]} on this rank (expected (1, 1)); value "
                   f"{float(value):.7f} vs {float(want):.7f} (relative {rel:.2e}, limit "
                   f"{PARALLEL_VALUE_RTOL:g}); world-summed d/d({', '.join(grads)}) at "
                   f"{worst:.3f} of the bar (rtol {PARALLEL_GRAD_RTOL:g}, atol "
                   f"{PARALLEL_GRAD_ATOL:g})")

    name = f"sharded train step x {PARALLEL_STEPS}"
    params, total, step_ms = counted(name, lambda: parallel_train(
        torch, LensOptimizer, shard, *pops["k2"], pop_cfg, train_kw, mesh))
    want_params, want_total = refs["train"]
    rel = abs(float(total) - float(want_total)) / abs(float(want_total))
    worst = max(float(((params[k] - w).abs() / (1e-6 + 1e-4 * w.abs())).max())
                for k, w in want_params.items())
    same = True
    for v in params.values():
        v0 = v.clone()
        if n > 1:
            dist.broadcast(v0, src=0)
        same = same and torch.equal(v, v0)
    rank_check(launches[name]["k2"] == (PARALLEL_STEPS, PARALLEL_STEPS) and rel <= 1e-5
               and worst <= 1.0 and same,
               f"{PARALLEL_STEPS} make_sharded_train_step steps (full loss) on the "
               f"{N_SYSTEMS}-system double-Gauss population: K2 forward and backward "
               f"{launches[name]['k2']} on this rank (expected ({PARALLEL_STEPS}, "
               f"{PARALLEL_STEPS})); total {float(total):.7f} vs {float(want_total):.7f} "
               f"(relative {rel:.2e}, limit 1e-5); params at {worst:.3f} of the bar (rtol 1e-4, "
               f"atol 1e-6); every rank's params bit-identical to rank 0's: {same}")

    name = "generator step"
    loss, grads, after = counted(name, lambda: parallel_generator(torch, OpticalLoss, mesh))
    want_loss, want_grads, want_after = refs["generator"]
    rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    worst = max(float(((g - w).abs() / (PARALLEL_GRAD_ATOL + PARALLEL_GRAD_RTOL * w.abs())).max())
                for g, w in zip(grads, want_grads))
    rank_check(launches[name]["k2"] == (1, 1) and rel <= PARALLEL_VALUE_RTOL and worst <= 1.0
               and all(bool(torch.isfinite(p).all()) for p in after),
               f"one OpticalLoss.unsupervised(mesh=...) generator step at B = {N_SYSTEMS}: K2 "
               f"forward and backward {launches[name]['k2']} on this rank (expected (1, 1)); "
               f"loss {float(loss):.7f} vs {float(want_loss):.7f} (relative {rel:.2e}); "
               f"world-summed MLP gradients at {worst:.3f} of the bar")
    with open(f"{out_path}_{rank}.json", "w") as f:
        json.dump({"launches": launches, "step_ms": step_ms, "trace_ms": trace_ms,
                   "rank_s": time.perf_counter() - rank_start}, f)


def phase_parallel(torch, card):
    """Phase 41: ``parallel/`` on rank groups that share the one card. The
    kernel library is built (by ``main``) before any rank starts; the
    single-process results come first, then each group of PARALLEL_GROUPS
    runs ``parallel_rank`` on every rank. Prints each group's step walls per
    rank beside the single-process step's, with the card; returns
    {kernel entry: {call: launches per rank}}."""
    import tempfile
    from torchoptics_tpu_torch.parallel import mesh as mesh_mod
    start = time.perf_counter()
    entry_of = {("k1", 0): "k1_fwd", ("k2", 0): "k2_fwd", ("k2", 1): "k2_bwd",
                ("k4", 0): "k4_fwd", ("k4", 1): "k4_bwd"}
    per_entry, walls = {}, {}
    torch.cuda.empty_cache()         # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "references.pt")
        walls["single process"] = parallel_references(torch, ref_path)
        for n, lens_parallel, backend in PARALLEL_GROUPS:
            out = os.path.join(tmp, f"group{n}")
            group_start = time.perf_counter()
            mesh_mod.spawn(parallel_rank, n, args=(lens_parallel, backend, ref_path, out),
                           device="cuda")
            group_s = time.perf_counter() - group_start
            ranks = []
            for r in range(n):
                with open(f"{out}_{r}.json") as f:
                    ranks.append(json.load(f))
            label = f"{n} rank{'s' if n > 1 else ''} ({backend})"
            walls[label] = {"step_ms": [r["step_ms"] for r in ranks],
                            "trace_ms": [r["trace_ms"] for r in ranks], "group_s": group_s,
                            "rank_s": [r["rank_s"] for r in ranks]}
            for name, runs in ranks[0]["launches"].items():
                for kernel, counts in runs.items():
                    for direction, count in enumerate(counts):
                        if count:
                            entry = entry_of[(kernel, direction)]
                            if "full" in name or "train" in name:
                                entry = entry.replace("_fwd", "_fwd_full")
                            per_entry.setdefault(entry, {})[name] = count
    single = walls["single process"]
    print(f"parallel walls (host clock, ms; {card}): single-process step "
          f"{[round(v, 3) for v in single['step_ms']]}, trace {single['trace_ms']:.3f}", flush=True)
    for label, w in walls.items():
        if label != "single process":
            print(f"parallel walls (host clock, ms; {card}): {label}, each rank's "
                  f"{PARALLEL_STEPS} steps {[[round(v, 3) for v in r] for r in w['step_ms']]}, "
                  f"sharded trace {[round(v, 3) for v in w['trace_ms']]}; the group "
                  f"{w['group_s']:.1f} s, of it the ranks' checks "
                  f"{max(w['rank_s']):.1f} s (the rest their start and end)", flush=True)
    print(json.dumps({"parallel_walls_ms": walls, "launches_per_rank": per_entry, "card": card}),
          flush=True)
    print(f"phase 41 (parallel) took {time.perf_counter() - start:.1f} s", flush=True)
    return per_entry


#: Phase 42: the examples. The wavefront bar (waves): the OPD held at the
#: coordinate bar (5e-6 mm) at 520 nm; the through-focus MTF's: the
#: coordinate bar's move at the 2 um PSF grid's Nyquist frequency
#: (``MTF_BAR``'s argument). The Strehl ratios' bar follows from the OPD gap
#: measured in the run (``strehl_bar``).
EXAMPLE_LAM = 520e-6
EXAMPLE_WAVES_BAR = 5e-6 / EXAMPLE_LAM
EXAMPLE_MTF_BAR = 2 * math.pi * 0.5 / 2e-3 * 5e-6
#: A line's numbers that are not results: host walls and run labels.
EXAMPLE_SKIP = ("steps in", "engine=", "wrote ", "saved ")


def strehl_bar(gap):
    """The largest move of a Strehl ratio S = |A|^2, A = <exp(i k OPD)>
    over the valid points (k = 2 pi / lambda), when its OPD moves by a gap
    of rms ``gap`` mm over them: |dA| <= k gap, so |dS| <= 2 sqrt(S) k gap
    + (k gap)^2 (piston and tilt removal, a least-squares projection over
    the same points, does not grow the gap's rms; the mean of a row of
    ratios obeys the bound at the mean, sqrt being concave), plus 1e-5 for
    the float32 sums."""
    kg = 2 * math.pi / EXAMPLE_LAM * gap
    return lambda s: 2 * math.sqrt(max(s, 0.0)) * kg + kg * kg + 1e-5


def _default_bar(line, k, w, strehl):
    """The allowed gap of a printed number whose unroll value is ``w``:
    1e-5 relative on Lu and loss values, 5e-6 on coordinates in mm."""
    return max(1e-5 * abs(w), 5e-6)


def _wavefront_bar(line, k, w, strehl):
    return strehl(w) if "Strehl" in line[:k] else EXAMPLE_WAVES_BAR


def _flagship_bar(line, k, w, strehl):
    """Columns: field, rms_y and rms_xy (mm), wfe (waves), Strehl, then the
    solved vignetting and relative illumination (the unroll engine in both
    runs)."""
    col = len(EXAMPLE_NUMBER.findall(line[:k]))
    if line.lstrip().startswith("mean"):
        col += 1
    if col == 3:
        return EXAMPLE_WAVES_BAR
    return strehl(w) if col == 4 else _default_bar(line, k, w, strehl)


def _aberration_bar(line, k, w, strehl):
    if re.match(r"\s+[-+]\d\.\d{3}\s", line):
        return EXAMPLE_MTF_BAR
    return _default_bar(line, k, w, strehl)


EXAMPLE_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
#: (label, module, argv, {kernel entry: predicted launches of the fused run,
#: and of them per step of ``--steps``}, bar). The argv keep each example's
#: default widths and cut only its step counts. A trace kernel's launches
#: go to the entry of the mode each ran (``read_example_counters``); the
#: launches per step are the counts of a run at ``--steps`` + 1 less those
#: of the run.
EXAMPLE_RUNS = (
    ("optimize_lens --steps 3", "optimize_lens", ["--steps", "3"],
     {"k1_fwd": (3, 1), "k1_bwd": (3, 1)}, _default_bar),
    ("optimize_lens --full-loss --freeze-glass --steps 2", "optimize_lens",
     ["--full-loss", "--freeze-glass", "--steps", "2"],
     {"k1_fwd_full": (2, 1), "k1_bwd": (2, 1)}, _default_bar),
    ("refine_flagship --steps 3 --polish-steps 2", "refine_flagship",
     ["--steps", "3", "--polish-steps", "2"],
     # 24 members (K2 Lu) and the polish (a population of one, K2 Lu); two
     # population evaluations (K2 plain) and three of the polished lens (K1).
     {"k2_fwd": (7, 1), "k2_bwd": (5, 1), "k1_fwd": (3, 0)}, _default_bar),
    ("refine_flagship --aspherize --steps 3 --polish-steps 2", "refine_flagship",
     ["--aspherize", "--steps", "3", "--polish-steps", "2"],
     {"k4_fwd": (5, 1), "k4_bwd": (5, 1), "k3_fwd": (5, 0)}, _default_bar),
    ("train_generator --steps 3 --eval-designs 64", "train_generator",
     ["--steps", "3", "--eval-designs", "64"],
     # The two scored distributions (snapped and raw glass): K2 plain.
     {"k2_fwd": (5, 1), "k2_bwd": (3, 1)}, _default_bar),
    ("optimize_through_image --steps 2", "optimize_through_image", ["--steps", "2"],
     # The start and final renders: K1 plain and P2 once each.
     {"k1_fwd": (4, 1), "k1_bwd": (2, 1), "p2_svola": (4, 1), "p2_dpsf": (2, 1)},
     _default_bar),
    ("optimize_wavefront --steps 3", "optimize_wavefront", ["--steps", "3"],
     # opd_map is two opl launches (the grid, the chief rays): the initial
     # and final loss and Strehl report, and each step.
     {"k1_fwd_opl": (14, 2), "k1_bwd_opl": (6, 2)}, _wavefront_bar),
    ("simulate_aberrations", "simulate_aberrations", [],
     {"k1_fwd": (1, 0), "p2_svola": (1, 0)}, _default_bar),
    # A 257 x 257 PSF: S1 over its 257 x 129 half grid (S1's launches are
    # not among the counted entries), 11-tap patch PSFs on P2's direct route.
    ("simulate_aberrations --psf-size 257", "simulate_aberrations", ["--psf-size", "257"],
     {"k1_fwd": (1, 0), "p2_svola": (1, 0)}, _default_bar),
    ("simulate_aberrations --psf-source diffraction", "simulate_aberrations",
     ["--psf-source", "diffraction"],
     # opd_map for the sampling report and for the render.
     {"k1_fwd_opl": (4, 0), "p2_svola": (1, 0)}, _default_bar),
    ("flagship_report", "flagship_report", [],
     # The report's trace and the vignetted trace; opd_map on the grid.
     {"k1_fwd": (2, 0), "k1_fwd_opl": (2, 0)}, _flagship_bar),
    ("aberration_report", "aberration_report", [],
     {"k2_fwd": (1, 0)}, _aberration_bar),
)
#: Kernel family -> (module, counter prefix). Each counter's launches by
#: template mode go to the kernel entries: forward modes 0 and 1 (plain,
#: Lu) to 'kN_fwd', 2 to 'kN_fwd_full', 3 to 'kN_fwd_opl'; backward modes
#: 0-2 to 'kN_bwd', 3 to 'kN_bwd_opl'.
EXAMPLE_MODE_COUNTERS = {"k1": ("fused_trace", "K1"), "k2": ("fused_batch", "K2"),
                         "k3": ("fused_asphere", "K3"), "k4": ("fused_asphere", "K4")}
EXAMPLE_MODE_ENTRY = {"fwd": ("", "", "_full", "_opl"), "bwd": ("", "", "", "_opl")}
EXAMPLE_P2_COUNTERS = {"p2_svola": "P2_LAUNCHES", "p2_dpsf": "P2_DPSF_LAUNCHES",
                       "p2_fft": "P2_FFT_LAUNCHES", "p2_dpsf_fft": "P2_DPSF_FFT_LAUNCHES"}


def reset_example_counters(modules):
    for module, prefix in EXAMPLE_MODE_COUNTERS.values():
        for d in ("FWD", "BWD"):
            setattr(modules[module], f"{prefix}_{d}_LAUNCHES", 0)
            setattr(modules[module], f"{prefix}_{d}_MODE_LAUNCHES", [0] * 4)
    for counter in EXAMPLE_P2_COUNTERS.values():
        setattr(modules["image"], counter, 0)


def read_example_counters(modules):
    """({kernel entry: launches since the reset}, {kernel: [plain, Lu,
    full, opl] launches} of the trace kernels that launched): the trace
    kernels' entries by the template mode each launch ran (their sums must
    be the totals), P2's by its counters."""
    out, modes = {}, {}
    for family, (module, prefix) in EXAMPLE_MODE_COUNTERS.items():
        for d, suffixes in EXAMPLE_MODE_ENTRY.items():
            by_mode = getattr(modules[module], f"{prefix}_{d.upper()}_MODE_LAUNCHES")
            total = getattr(modules[module], f"{prefix}_{d.upper()}_LAUNCHES")
            if sum(by_mode) != total:
                check(False, f"examples: {prefix} {d} launches by mode {by_mode} sum to the "
                      f"total {total}")
            for mode, n in enumerate(by_mode):
                entry = f"{family}_{d}{suffixes[mode]}"
                out[entry] = out.get(entry, 0) + n
            if total:
                modes[f"{family}_{d}"] = list(by_mode)
    for entry, counter in EXAMPLE_P2_COUNTERS.items():
        out[entry] = getattr(modules["image"], counter)
    return out, modes


def example_opd_gap(torch, name, argv):
    """The rms OPD gap (mm) behind the Strehl ratios that example ``name``
    prints when run with ``argv``: ``opd_map`` on the fused engine against
    the unroll engine, on the lens, grid and points that its Strehl ratios
    use (``optimize_wavefront``: the defocused lens it starts from, its
    grid, the valid rays; ``flagship_report``: the lens it reports, its
    24 x 24 grid, the valid rays inside the unit circle), the largest over
    the fields. The masks must be equal and the largest gap within
    ``phase_wavefront_serve``'s OPD bar, 5e-5 mm (an OPD is a difference of
    float32 path lengths of 100-300 mm, whose last bit is 0.8-3e-5 mm)."""
    from torchoptics_tpu_torch.examples import flagship_report as fr
    from torchoptics_tpu_torch.examples import optimize_wavefront as ow
    from torchoptics_tpu_torch.ops import wavefront as wf

    def opd(engine):
        if name == "optimize_wavefront":
            specs, lens, _, cfg, xy = ow.setup(ow.parse_args(argv), engine)
            return wf.opd_map(specs, lens, cfg, xy=xy), None
        args = fr.parse_args(argv)
        specs, lens, fields = fr.load_design(args, args.device)
        xy, inside = fr.pupil_grid(device=args.device)
        return wf.opd_map(specs, lens, fr.wavefront_config(fields, engine), xy=xy), inside

    with torch.no_grad():
        (fused, inside), (unroll, _) = opd("fused"), opd("unroll")
    ok = fused["ok"][0, :, :, 0]                                             # (F, P)
    same = torch.equal(ok, unroll["ok"][0, :, :, 0])
    w = (ok if inside is None else ok & inside).to(torch.float64)
    d = (fused["opd"] - unroll["opd"])[0, :, :, 0].to(torch.float64)
    rms = torch.sqrt(torch.sum(w * d * d, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0))
    gap, largest = float(torch.max(rms)), float(torch.max(w * d.abs()))
    check(same and largest <= 5e-5,
          f"examples: {name}'s OPD, fused against unroll on its lens and grid: the same valid "
          f"rays ({same}), the largest gap {largest:.3g} mm (limit 5e-5), the rms gap per field "
          f"{[float(v) for v in rms]} mm; its Strehl bar 2 sqrt(S) k g + (k g)^2 + 1e-5 is "
          f"{strehl_bar(gap)(1.0):.3g} at S = 1, {strehl_bar(gap)(0.1):.3g} at S = 0.1")
    return gap


#: The examples that print Strehl ratios.
STREHL_EXAMPLES = ("optimize_wavefront", "flagship_report")


def example_numbers(text):
    """[(line, [(offset, token)])] of an example's printout, the lines
    that print no result left out."""
    out = []
    for line in text.splitlines():
        if any(s in line for s in EXAMPLE_SKIP):
            continue
        line = re.sub(r"\[\d+s\]", "", line)
        toks = [(m.start(), m.group()) for m in EXAMPLE_NUMBER.finditer(line)]
        if toks:
            out.append((line, toks))
    return out


def printed_resolution(token):
    """The step of the last printed digit of a number token."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def compare_printouts(fused, unroll, bar):
    """The largest (gap - allowed) over the two runs' printed numbers,
    token by token (the printouts must have the same lines and numbers),
    with the worst gap and its line. ``allowed`` is ``bar(line, offset,
    unroll value)`` plus the printed resolution (two runs within the bar
    can print numbers one last digit apart)."""
    a, b = example_numbers(fused), example_numbers(unroll)
    if len(a) != len(b) or any(len(x[1]) != len(y[1]) for x, y in zip(a, b)):
        return math.inf, math.inf, "the printouts differ in their lines or numbers"
    worst, worst_gap, where = -math.inf, 0.0, ""
    for (line, toks), (_, toks_u) in zip(a, b):
        for (k, t), (_, u) in zip(toks, toks_u):
            v, w = float(t), float(u)
            gap = abs(v - w)
            allowed = bar(line, k, w) + printed_resolution(t)
            if gap - allowed > worst:
                worst, worst_gap, where = gap - allowed, gap, f"{line.strip()} ({t} vs {u})"
    return worst, worst_gap, where


def phase_examples(torch, card, verbose=False):
    """Phase 42: the nine examples' eight newcomers, each ``main(argv)`` on
    the card at its default widths (only the step counts cut, as
    EXAMPLE_RUNS lists), on the fused engine and on the unroll engine: each
    run's launches counted from 0 by kernel entry (the fused run's must be
    EXAMPLE_RUNS's, the unroll run's those of P2 alone), the launches per
    step measured as a fused run at ``--steps`` + 1 less the run at
    ``--steps`` (they must be EXAMPLE_RUNS's), each run's host wall, and the
    printed numbers of the two runs held within each number's bar plus its
    printed resolution. Returns {kernel entry: {example: {"run": launches,
    "steps": n[, "per_step": launches]}}}, all measured."""
    import contextlib
    import importlib
    import io
    import tempfile
    from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, fused_trace, image
    modules = {"fused_trace": fused_trace, "fused_batch": fused_batch,
               "fused_asphere": fused_asphere, "image": image}
    start = time.perf_counter()
    strehl = {name: strehl_bar(example_opd_gap(torch, name, argv))
              for _, name, argv, _, _ in EXAMPLE_RUNS if name in STREHL_EXAMPLES}
    per_entry, walls, modes = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, name, argv, expect, bar in EXAMPLE_RUNS:
            example = importlib.import_module(f"torchoptics_tpu_torch.examples.{name}")
            extra = ["--output", os.path.join(tmp, "out.png")] if name == "simulate_aberrations" \
                else []

            def run(args, engine):
                reset_example_counters(modules)
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    example.main(args + extra + ["--engine", engine])
                torch.cuda.synchronize()
                return buf.getvalue(), *read_example_counters(modules), time.perf_counter() - t0

            printed, counts = {}, {}
            for engine in ("fused", "unroll"):
                printed[engine], counts[engine], by_mode, walls[f"{label} ({engine})"] = run(
                    argv, engine)
                if engine == "fused":
                    modes[label] = by_mode
            want = {e: expect.get(e, (0, 0))[0] for e in counts["fused"]}
            # The unroll engine launches no trace kernel, and renders on P2
            # alike.
            want_unroll = {e: n if e.startswith("p2") else 0 for e, n in want.items()}
            for engine, wanted in (("fused", want), ("unroll", want_unroll)):
                check(counts[engine] == wanted,
                      f"examples: {label} on the {engine} engine launched "
                      f"{ {e: n for e, n in counts[engine].items() if n} } (expected "
                      f"{ {e: n for e, n in wanted.items() if n} })")
            steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 0
            per_step = {}
            if steps:
                more = list(argv)
                more[argv.index("--steps") + 1] = str(steps + 1)
                _, counts_more, _, _ = run(more, "fused")
                per_step = {e: counts_more[e] - n for e, n in counts["fused"].items()}
                wanted = {e: expect.get(e, (0, 0))[1] for e in per_step}
                check(per_step == wanted,
                      f"examples: {label}: the fused run at --steps {steps + 1} less the run "
                      f"at --steps {steps} launched { {e: n for e, n in per_step.items() if n} }"
                      f" a step (expected { {e: n for e, n in wanted.items() if n} })")
            for e, n in counts["fused"].items():
                if n or per_step.get(e):
                    per_entry.setdefault(e, {})[label] = dict(
                        {"run": n, "steps": steps}, **({"per_step": per_step[e]} if steps else {}))
            if verbose:
                for engine, text in printed.items():
                    print(f"--- {label} --engine {engine}", flush=True)
                    print(text, end="", flush=True)
            worst, gap, where = compare_printouts(
                printed["fused"], printed["unroll"],
                lambda line, k, w: bar(line, k, w, strehl.get(name)))
            check(worst <= 0.0,
                  f"examples: {label}: fused and unroll print the same numbers within their "
                  f"bars plus the printed resolution; the largest gap {gap:.3g} at: {where}")
            print(f"examples: {label}: host wall {walls[f'{label} (fused)']:.2f} s fused, "
                  f"{walls[f'{label} (unroll)']:.2f} s unroll ({card}); fused launches "
                  f"{ {e: n for e, n in counts['fused'].items() if n} } ({steps} steps; "
                  f"measured per step { {e: n for e, n in per_step.items() if n} }; the trace "
                  f"kernels' by template mode [plain, Lu, full, opl] {modes[label]})",
                  flush=True)
    print(json.dumps({"example_walls_s": {k: round(v, 3) for k, v in walls.items()},
                      "launches_examples": per_entry, "launches_by_mode": modes, "card": card}),
          flush=True)
    print(f"phase 42 (examples) took {time.perf_counter() - start:.1f} s", flush=True)
    return per_entry


# Kernel S1, the PSF splat (csrc/psf_splat_fwd.cu, csrc/psf_splat_bwd.cu).
S1_FWD_SOURCE = "torchoptics_tpu_torch/csrc/psf_splat_fwd.cu"
S1_BWD_SOURCE = "torchoptics_tpu_torch/csrc/psf_splat_bwd.cu"
TPU_S1 = ("torchoptics_tpu/ops/psf.py:75 (the splat's broadcast, which XLA fuses into its sum "
          "over rays; no Pallas kernel)")
#: Half grids above S1's former ceiling (129 x 65), and both forward routes
#: on one grid: {label: (g, C, R, n_y, n_x/2, float64, weights, per-bin
#: sums, d/dw, the forward's route (None: ``psf.splat_fwd_windowed``'s;
#: True: the windowed kernels forced; False: the dense kernel)[, the
#: inputs' variant])}; seeded spots
#: spread over the grid (``splat_wide_args``, which also makes the
#: variants: rays at the windows' edges, an inf and a NaN ray, rays off the
#: grid, an inf weight, sigma of 3 bins, descending centres, a hot spot,
#: windows ending at the forward's tiles' edges, sigma of the grid; the
#: cotangent's NaN and inf: ``SPLAT_COT_POKES``). 66 pairs cut into 4 spans
#: of 192, 192, 192 and 124 rays. The last three grids are past what the
#: adjoint can stage in shared memory: centres read from global
#: memory, and the per-bin sums' term tile in chunks of bins.
SPLAT_WIDE = {
    "130 x 65": (2, 1, 1000, 130, 65, False, False, False, False, None),
    "129 x 66, weights, d/dw": (2, 1, 1000, 129, 66, False, True, False, True, None),
    "257 x 129, 66 pairs": (22, 3, 700, 257, 129, False, False, False, False, None),
    "257 x 129, float64, weights, per-bin sums, d/dw": (2, 2, 1000, 257, 129, True, True, True,
                                                         True, None),
    "513 x 257, per-bin sums": (1, 2, 2000, 513, 257, False, False, True, False, None),
    "300 x 7, float64": (2, 3, 700, 300, 7, True, False, False, False, None),
    "7 x 300, weights, per-bin sums, d/dw": (22, 3, 700, 7, 300, False, True, True, True, None),
    "65 x 33 on the windowed forward, weights, per-bin sums, d/dw": (
        2, 3, 700, 65, 33, False, True, True, True, True),
    "65 x 33 on the windowed forward, float64": (2, 2, 1000, 65, 33, True, False, False, False,
                                                 True),
    "257 x 129 on the dense forward, weights, an inf ray and a NaN ray": (
        2, 3, 700, 257, 129, False, True, False, False, False, "inf and NaN rays"),
    "257 x 129, rays at the windows' edges": (2, 3, 1000, 257, 129, False, False, False, False,
                                              None, "edges"),
    "257 x 129, float64, rays at the windows' edges, per-bin sums, d/dw": (
        2, 2, 1000, 257, 129, True, True, True, True, None, "edges"),
    "257 x 129, an inf ray and a NaN ray": (2, 3, 700, 257, 129, False, False, False, False, None,
                                            "inf and NaN rays"),
    "257 x 129, a NaN and an inf in a cotangent": (2, 2, 256, 257, 129, False, False, False,
                                                   False, None),
    "257 x 129, an inf weight, d/dw": (2, 2, 700, 257, 129, False, True, False, True, None,
                                       "inf weight"),
    "257 x 129, rays off the grid, per-bin sums": (2, 3, 700, 257, 129, False, False, True,
                                                   False, None, "off the grid"),
    "257 x 129, sigma of 3 bins, weights, d/dw": (2, 2, 700, 257, 129, False, True, False, True,
                                                  None, "sigma of 3 bins"),
    "257 x 129, descending centres": (2, 2, 256, 257, 129, False, False, False, False, None,
                                      "descending centres"),
    "7 x 60000, the centres beyond shared memory": (1, 1, 100, 7, 60000, False, False, False,
                                                    False, None),
    "257 x 129, a hot spot (each pair's rays in one bin), weights": (
        2, 3, 2000, 257, 129, False, True, False, False, None, "hot spot"),
    "257 x 129, windows ending at the forward's tiles' edges": (
        2, 3, 1000, 257, 129, False, False, False, False, None, "tile edges"),
    "257 x 129, float64, windows ending at the forward's tiles' edges, weights": (
        2, 2, 1000, 257, 129, True, True, False, False, None, "tile edges"),
    "257 x 129, sigma of the grid (every window the whole grid), d/dw": (
        2, 2, 500, 257, 129, False, True, False, True, None, "sigma of the grid"),
    "9000 x 7, per-bin sums in chunks, d/dw, an inf ray and a NaN ray": (
        2, 3, 300, 9000, 7, False, True, True, True, None, "inf and NaN rays"),
    "7 x 30000, float64, per-bin sums in chunks, the centres beyond shared memory": (
        1, 1, 100, 7, 30000, True, False, True, False, None),
}
#: Entries a case's cotangent gets before the adjoint runs: {case label:
#: ((index, value), ...)}: one pair's cotangent with a NaN and an inf, so
#: that its rays take the whole grid.
SPLAT_COT_POKES = {"half grid 257 x 129, a NaN and an inf in a cotangent": (
    ((0, 1, 40, 20), float("nan")), ((0, 1, 200, 100), float("inf")))}
#: The default configuration's splat at psf_shape (257, 257), the timed one.
SPLAT_257 = "default config at psf 257 (21 x 3 pairs, 257 x 129, 65,536 rays)"
# Phase 43's cases (``splat_cases``), in order.
SPLAT_CASES = (("default config (21 x 3 pairs, 65 x 33, 65,536 rays)", "W = 4, one-hot weights",
                "W = 4, one-hot weights, 257 x 129", "even grid 48 x 64", "non-square grid 33 x 65",
                "auto extent (increment=None)", "a NaN ray", "an inf ray", "float64", "1,037 rays (no multiple of the chunk)")
               + tuple(f"half grid {k}" for k in SPLAT_WIDE) + (SPLAT_257,))


def capture_splat(torch, psf, call):
    """Run ``call`` with ``psf.splat`` recording a copy of the arguments of
    its first call. Returns (call's result, the arguments)."""
    record, splat = [], psf.splat

    def spy(*args):
        if not record:
            record.append(tuple(None if a is None else a.detach().clone() for a in args))
        return splat(*args)
    psf.splat = spy
    try:
        out = call()
    finally:
        psf.splat = splat
    return out, record[0]


def seeded_spots(torch, shape, seed, dtype=None, scale=0.02):
    """Seeded spot coordinates (x, y) on the card, from numpy: y about 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, scale, shape)
    y = rng.normal(0.0, scale, shape) + 0.5
    dtype = dtype or torch.float32
    return (torch.tensor(x, dtype=dtype, device="cuda"),
            torch.tensor(y, dtype=dtype, device="cuda"))


def splat_wide_args(torch, g, C, R, ny, nx, f64, weights, seed, variant=None):
    """S1's arguments on an ny x nx half grid at a 4 um pitch: seeded spots
    (x about 0 with a third of the half grid's width, y about the grid's
    centre with a quarter of its height) and, with ``weights``, uniform
    weights in [0, 1); float32, or float64 with ``f64``. ``variant``:
    "edges" puts each ray a window's reach (``psf.SPLAT_Q_MAX``) from a
    random bin each way, moved by -3 to 3 of the type's steps, so that bins
    fall just inside and just outside the windows; "inf and NaN rays" an
    inf x and a NaN y; "off the grid" a third of the rays 1 mm right and a
    third 1 mm down (empty windows); "inf weight" one weight inf; "sigma of
    3 bins" sigma at 3 bins (wide windows); "descending centres" x's
    centres reversed; "hot spot" each pair's rays within one bin (a third
    of the weights 0); "tile edges" each ray's windows ending at a multiple
    of 8 bins each way (``psf.SPLAT_Q_MAX``'s reach from it, moved by -3 to
    3 of the type's steps: the forward's bands of 16 rows and tiles of 16
    columns, and their halves); "sigma of the grid" sigma at the grid's
    height (every window the whole grid)."""
    rng = np.random.default_rng(seed)
    inc = 4e-3
    dtype = torch.float64 if f64 else torch.float32
    t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")
    sigma = t(np.full(g, {"sigma of 3 bins": 3 * inc, "sigma of the grid": ny * inc}.get(
        variant, inc / 2)))
    x = rng.normal(0.0, nx * inc / 3, (g, C, R))
    y = rng.normal(0.0, ny * inc / 4, (g, C, R))
    gx = np.tile(np.arange(nx) * inc, (g, 1))
    gy = np.tile((np.arange(ny) + 0.5 - ny / 2) * inc, (g, 1))
    w = rng.uniform(0.0, 1.0, (g, C, R)) if weights else None
    if variant == "edges":
        eps = float(torch.finfo(dtype).eps)
        for v, c in ((x, gx), (y, gy)):
            reach = np.sqrt(psf_q_max(f64) * (inc / 2) ** 2)
            b = rng.integers(0, c.shape[1], v.shape)
            sign = rng.choice([-1.0, 1.0], v.shape)
            steps = rng.integers(-3, 4, v.shape)
            v[...] = c[0][b] + sign * reach * (1.0 + steps * eps)
    elif variant == "hot spot":
        x[...] = gx[0][nx // 3] + rng.uniform(-0.4, 0.4, (g, C, R)) * inc
        y[...] = gy[0][ny // 2] + rng.uniform(-0.4, 0.4, (g, C, R)) * inc
        w[..., ::3] = 0.0
    elif variant == "tile edges":
        eps = float(torch.finfo(dtype).eps)
        reach = np.sqrt(psf_q_max(f64) * (inc / 2) ** 2)
        for v, c in ((x, gx), (y, gy)):
            # A window's first bin at 8 k (a reach above it) or its last at
            # 8 k - 1 (a reach below).
            sign = rng.choice([-1.0, 1.0], v.shape)
            edge = 8 * rng.integers(0, c.shape[1] // 8 + 1, v.shape) - (sign < 0)
            v[...] = c[0][0] + edge * inc + sign * reach * (
                1.0 + rng.integers(-3, 4, v.shape) * eps)
    elif variant == "inf and NaN rays":
        x[0, 0, 5] = np.inf
        y[1, 2, 9] = np.nan
    elif variant == "off the grid":
        x[..., ::3] += 1.0
        y[..., 1::3] -= 1.0
    elif variant == "inf weight":
        w[0, 1, 3] = np.inf
    elif variant == "descending centres":
        gx = gx[:, ::-1].copy()
    return (t(x), t(y), t(gx), t(gy), sigma, sigma.clone(), None if w is None else t(w))


def psf_q_max(f64):
    """S1's windows' threshold (``psf.SPLAT_Q_MAX``) of the type."""
    from torchoptics_tpu_torch.ops import psf
    import torch
    return psf.SPLAT_Q_MAX[torch.float64 if f64 else torch.float32]


def splat_cases(torch, zoo, simulator, imaging, psf):
    """S1's inputs, {label: (args, bins, weights_grad, windowed)}: the default
    configuration's own splat (the double-Gauss traced on K1: 21 fields x 3
    channels, 65 x 33 half grid, 65,536 rays), and seeded ones: W = 4 (one-hot
    weights, d/dw too; also at psf 257, where two thirds of the pair-rays
    weigh 0), an even and a non-square grid, the auto extent
    (increment=None: d/dgx, d/dgy, d/dsigma), a NaN ray, an inf ray,
    float64, rays no multiple of the chunk, the grids of ``SPLAT_WIDE``, and
    the default configuration's splat at psf_shape (257, 257). ``windowed``:
    the forward's route (None: ``psf.splat_fwd_windowed``'s)."""
    cases = {"default config (21 x 3 pairs, 65 x 33, 65,536 rays)": (
        default_splat_args(torch, zoo, simulator, imaging, psf), False, False)}
    x, y = seeded_spots(torch, (1, 9, 2048, 4), 1)
    yc = torch.linspace(0.45, 0.55, 9, device="cuda")
    _, args = capture_splat(torch, psf, lambda: psf.sample_psfs(x, y, yc, (65, 65), 4e-3))
    cases["W = 4, one-hot weights"] = (args, False, True)
    _, args = capture_splat(torch, psf, lambda: psf.sample_psfs(x, y, yc, (257, 257), 1e-3))
    cases["W = 4, one-hot weights, 257 x 129"] = (args, False, True)
    for label, n_bins, seed in (("even grid 48 x 64", (48, 64), 2),
                                ("non-square grid 33 x 65", (33, 65), 3)):
        x, y = seeded_spots(torch, (2, 5, 3, 3000), seed)
        _, args = capture_splat(torch, psf, lambda: psf.compute_psf(x, y, n_bins, 3e-3))
        cases[label] = (args, False, False)
    x, y = seeded_spots(torch, (2, 4, 3, 2500), 4)
    _, args = capture_splat(torch, psf, lambda: psf.compute_psf(x, y, (21, 21), None))
    cases["auto extent (increment=None)"] = (args, True, False)
    for label, seed in (("a NaN ray", 5), ("an inf ray", 6)):
        x, y = seeded_spots(torch, (1, 4, 3, 2000), seed)
        if label == "a NaN ray":
            x[0, 1, 2, 7] = float("nan")
        else:
            y[0, 2, 0, 11] = float("inf")
        _, args = capture_splat(torch, psf, lambda: psf.compute_psf(x, y, (33, 33), 4e-3))
        cases[label] = (args, False, False)
    x, y = seeded_spots(torch, (1, 6, 3, 5000), 7, torch.float64)
    _, args = capture_splat(torch, psf, lambda: psf.compute_psf(x, y, (65, 65), 4e-3))
    cases["float64"] = (args, False, False)
    x, y = seeded_spots(torch, (2, 3, 3, 1037), 8)
    _, args = capture_splat(torch, psf, lambda: psf.compute_psf(x, y, (17, 17), 5e-3))
    cases["1,037 rays (no multiple of the chunk)"] = (args, False, False)
    cases = {k: v + (None,) for k, v in cases.items()}
    for n, (label, (g, C, R, ny, nx, f64, weights, bins, dw, windowed, *variant)) in enumerate(
            SPLAT_WIDE.items()):
        cases[f"half grid {label}"] = (splat_wide_args(torch, g, C, R, ny, nx, f64, weights,
                                                       200 + n, *variant), bins, dw, windowed)
    cases[SPLAT_257] = (default_splat_args(torch, zoo, simulator, imaging, psf, (257, 257)),
                        False, False, None)
    check(tuple(cases) == SPLAT_CASES, f"phase 43's cases are SPLAT_CASES: {tuple(cases)}")
    return cases


def bits_gap(torch, got, want):
    """(bit-identical, NaN where the other is NaN; largest |got - want| over
    the finite entries; entries that differ)."""
    nan = torch.isnan(want)
    diff = (got != want) & ~(nan & torch.isnan(got))
    fin = torch.isfinite(want) & torch.isfinite(got)
    gap = float((got[fin].double() - want[fin].double()).abs().max()) if bool(fin.any()) else 0.0
    return same_bits(got, want), gap, int(diff.sum())


def splat_compare(torch, psf, label, args, bins, weights_grad, seed, windowed=None):
    """S1 forward (on the route ``windowed`` names, None: the rule's) and
    adjoint against their plain versions on the card, the counts set to 0
    before and read after; the cotangent seeded, with the case's
    ``SPLAT_COT_POKES``. Returns {output: (same, gap, n_diff)} and the
    launches (forward, adjoint)."""
    psf.SPLAT_LAUNCHES = psf.SPLAT_BWD_LAUNCHES = 0
    got = psf._launch_splat(*args, windowed=windowed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = torch.randn(got.shape, generator=gen, device="cuda", dtype=got.dtype)
    for index, value in SPLAT_COT_POKES.get(label, ()):
        cot[index] = value
    got_b = psf._launch_splat_bwd(*args, cot, bins, weights_grad)
    torch.cuda.synchronize()
    launches = (psf.SPLAT_LAUNCHES, psf.SPLAT_BWD_LAUNCHES)
    want = psf.splat_reference(*args)
    want_b = psf.splat_backward_reference(*args, cot, bins, weights_grad)
    out = {"half": bits_gap(torch, got, want)}
    for name, a, b in zip(("dx", "dy", "dgx", "dgy", "dsigma_x", "dsigma_y", "dweights"),
                          got_b, want_b):
        if b is not None:
            out[name] = bits_gap(torch, a, b)
    x = args[0]
    ny, nx = args[3].shape[1], args[2].shape[1]
    if windowed is None:
        windowed = psf.splat_fwd_windowed(ny, nx)
    forward = "windowed" if windowed else "dense"
    print(f"S1 {label}: rays {tuple(x.shape)} {str(x.dtype)[6:]}, half grid {ny} x {nx}, "
          f"weights {args[6] is not None}, {forward} forward: "
          + "; ".join(f"{k} bit-identical={v[0]} (max |diff| {v[1]:.3e}, {v[2]} differ)"
                      for k, v in out.items())
          + f"; launches (forward, adjoint) {launches}", flush=True)
    return out, launches


def s1_bound(args, backward, bins=False):
    """(bound_ms, bound_by, operations, bytes) of S1 forward or its adjoint on
    ``args``: a product and a sum per ray and bin (the adjoint's A and B: two
    each; with bins, two more), 6 operations a factor (a difference, a
    square, a division, a negation, a halving, an exp), the weight's product
    a ray and row; the adjoint's terms 6 a ray and bin of either axis; the
    bytes of the inputs read once and the outputs written once."""
    x, y, gx, gy, sx, sy, w = args
    g, C, R = x.shape
    ny, nx = gy.shape[1], gx.shape[1]
    pairs, b = g * C, x.element_size()
    products = pairs * R * ny * nx
    factors = pairs * R * (nx + ny)
    rays_in = pairs * R * (2 + (w is not None))
    grids = g * (nx + ny + 2)
    if backward:
        ops = (4 + (2 if bins else 0)) * products + 6 * factors + 6 * factors
        nbytes = b * (rays_in + pairs * ny * nx + grids + 2 * pairs * R + (grids if bins else 0))
    else:
        ops = 2 * products + 6 * factors + (pairs * R * ny if w is not None else 0)
        nbytes = b * (rays_in + grids + pairs * ny * nx)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops,
            nbytes)


def splat_windows(torch, psf, args):
    """S1's windows on ``args`` (``psf.splat_window``, the
    kernel's rule, pair by pair on the card): the mean |Wx|, |Wy| and |Wx| x
    |Wy| over the rays, their sums and the share of empty windows."""
    x, y, gx, gy, sx, sy, w = args
    g, C, R = x.shape
    tot = {"wx": 0.0, "wy": 0.0, "wxy": 0.0, "empty": 0.0}
    for i in range(g):
        for c in range(C):
            lx, hx = psf.splat_window(x[i, c], gx[i], sx[i] * sx[i])
            ly, hy = psf.splat_window(y[i, c], gy[i], sy[i] * sy[i])
            nwx, nwy = (hx - lx + 1).clamp(min=0).double(), (hy - ly + 1).clamp(min=0).double()
            tot["wx"] += float(nwx.sum())
            tot["wy"] += float(nwy.sum())
            tot["wxy"] += float((nwx * nwy).sum())
            tot["empty"] += float(((nwx * nwy) == 0).sum())
    n = g * C * R
    return {"rays": n, "sum_wx": tot["wx"], "sum_wy": tot["wy"], "sum_wxy": tot["wxy"],
            "mean_wx": tot["wx"] / n, "mean_wy": tot["wy"] / n, "mean_wxy": tot["wxy"] / n,
            "empty_share": tot["empty"] / n}


def s1_window_bound(args, windows, backward=True):
    """(bound_ms, bound_by, operations, bytes) of S1 forward or its adjoint
    (no d/dw, no bins) on ``args``, summed over each ray's windows alone
    (``splat_windows``), since every factor outside them is 0 and no
    function needs its products: the adjoint's A and B two products and two
    sums a window bin, each factor 6 operations and each term 6, a ray's
    windows' bins of either axis; the forward's product and sum a window
    bin, 6 operations a factor, the weight's product a ray and row of its
    window; the bytes as ``s1_bound``'s (every input read once, the outputs
    written once). This is the kernels line's bound; ``s1_bound``'s, every
    bin of every ray, stands beside it as the dense bound."""
    x, y, gx, gy, sx, sy, w = args
    if backward:
        ops = 4 * windows["sum_wxy"] + 12 * (windows["sum_wx"] + windows["sum_wy"])
    else:
        ops = (2 * windows["sum_wxy"] + 6 * (windows["sum_wx"] + windows["sum_wy"])
               + (windows["sum_wy"] if w is not None else 0))
    nbytes = s1_bound(args, backward)[3]
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops,
            nbytes)


def splat_library(torch, args, cot):
    """The separable product as PyTorch calls on the same inputs, TF32 off:
    the forward as one ``torch.einsum`` of the factors (materialised
    beforehand, 1.6 GB at the default configuration), and the adjoint's two
    contractions A and B. Returns {key: ms}."""
    x, y, gx, gy, sx, sy, w = args
    ex = torch.exp(-(((x[:, :, None, :] - gx[:, None, :, None]) ** 2)
                     / (sx * sx)[:, None, None, None]) / 2)
    ey = torch.exp(-(((y[:, :, None, :] - gy[:, None, :, None]) ** 2)
                     / (sy * sy)[:, None, None, None]) / 2)
    exw = ex if w is None else ex * w[:, :, None, :]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return {"fwd": auto_ms(torch, lambda: torch.einsum("gcyr,gcxr->gcyx", ey, exw)),
                "bwd": auto_ms(torch, lambda: (torch.einsum("gcyx,gcyr->gcxr", cot, ey),
                                               torch.einsum("gcyx,gcxr->gcyr", cot, ex)))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


#: The renders whose memory ``splat_memory`` reads: (label, px, psf_shape,
#: with the image-loss step). At psf 257 the patch PSFs are 187 taps at
#: 2048^2; at 4096^2 and psf 129, 187 too (the resize's largest products
#: before it became two matrix products: 3.03 and 4.39 GB).
SPLAT_MEMORY_RUNS = (("2048^2 at psf 65", 2048, (65, 65), True),
                     ("2048^2 at psf 257", 2048, (257, 257), True),
                     ("4096^2 at psf 129", 4096, (129, 129), False))
#: The psf-257 step's limits: peak device memory and the largest allocation.
PSF257_PEAK_BYTES, PSF257_LARGEST_BYTES = 12e9, 1.5e9


def splat_memory(torch, card, profiled=True, px=DEFAULT_TRAIN_PX, psf_shape=(65, 65),
                 step=True):
    """The default configuration's px^2 render at ``psf_shape`` and, with
    ``step``, one image-loss ``LensOptimizer.step`` (the double-Gauss
    defocused 0.3 mm): each call's ``torch.cuda.max_memory_allocated``
    (after ``reset_peak_memory_stats``, beside what was allocated before it)
    and host wall (median of 5 after one warm-up); the largest single
    allocations of the last of them (the step, else the render), with the
    port's innermost line that asked for each (``torch.cuda.memory`` history
    of one call), and the largest made in ``image.resize_bilinear`` beside
    twice the largest of its input, its intermediate and its output
    (``resize_bytes``); with ``profiled``, that call's torch.profiler split
    (``profile_steps``: wall and busy time). Imports the port from
    ``sys.path`` (any tree)."""
    from torchoptics_tpu_torch import LensOptimizer, imaging, simulator, zoo
    cfg = default_imaging_config(simulator, psf_shape=psf_shape)
    specs, lens = zoo.build("double_gauss", device="cuda")
    rad = torch.tensor(photograph(px)[None], device="cuda")
    calls = {"render": lambda: render(torch, imaging, specs, lens, rad, cfg)}
    if step:
        opt, state = image_optimizer(torch, zoo, simulator, imaging, LensOptimizer, "cuda", px,
                                     cfg)
        box = [state]

        def one_step():
            box[0] = opt.step(box[0])[0]
        calls["step"] = one_step
    last = "step" if step else "render"
    out = {"card": card, "px": px, "psf_shape": list(psf_shape)}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated()
        out[f"{name}_before_bytes"] = before
        out[f"{name}_wall_ms"] = host_ms(torch, fn, runs=5, warmup=1)
    torch.cuda.memory._record_memory_history(max_entries=200_000, stacks="python")
    calls[last]()
    torch.cuda.synchronize()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    allocs = [t for trace in snapshot["device_traces"] for t in trace if t["action"] == "alloc"]
    largest, resize = [], 0
    where = lambda f: (f"{f['filename'].split('torchoptics_tpu_torch/')[-1]}:{f['line']} "
                       f"{f['name']}")
    for t in allocs:
        if any(f["name"] == "resize_bilinear" for f in t.get("frames", [])):
            resize = max(resize, t["size"])
    for t in sorted(allocs, key=lambda t: -t["size"])[:8]:
        frames = [f for f in t.get("frames", []) if "torchoptics_tpu_torch" in f["filename"]]
        largest.append([t["size"], where(frames[0]) if frames else "outside the port"])
    out[f"{last}_largest_allocations"] = largest
    gh, gw = cfg.psf_grid_shape
    k = imaging.psf_kernel_shape((px, px), cfg)
    out["resize_largest_bytes"] = resize
    out["resize_bytes"] = 2 * 4 * gh * gw * 3 * max(psf_shape[0] * psf_shape[1],
                                                    k[0] * psf_shape[1], k[0] * k[1])
    gb = lambda v: v / 1e9
    if profiled:
        wall, busy, groups = profile_steps(
            torch, f"{'image-loss LensOptimizer.step' if step else 'render'}, default "
            f"configuration at {px}^2, psf_shape {tuple(psf_shape)}", calls[last], card, n_steps=3)
        out.update({f"{last}_profile_wall_ms": wall, f"{last}_busy_ms": busy,
                    f"{last}_busy_share": busy / wall, f"{last}_groups_ms": groups})
    print(f"memory: default configuration at {px}^2, psf_shape {tuple(psf_shape)} (K = {k[0]}): "
          f"render peak {gb(out['render_peak_bytes']):.3f} GB (allocated before "
          f"{gb(out['render_before_bytes']):.3f}), wall {out['render_wall_ms']:.2f} ms"
          + (f"; image-loss step peak {gb(out['step_peak_bytes']):.3f} GB (before "
             f"{gb(out['step_before_bytes']):.3f}), wall {out['step_wall_ms']:.2f} ms"
             if step else "")
          + f"; the {last}'s largest allocations (GB, the port's line): "
          f"{[(round(gb(m), 3), w) for m, w in largest]}; resize_bilinear's largest "
          f"{gb(resize):.4f} GB (twice its largest operand {gb(out['resize_bytes']):.4f}); "
          f"card: {card}", flush=True)
    return out


def splat_memory_turns(trees, card):
    """``splat_memory`` of each run of ``SPLAT_MEMORY_RUNS``, profiled, in
    turns: the trees given, this checkout twice, the trees again in reverse
    order, one process each; every tree's kernels built first, all at once.
    A run that a tree refuses (an older tree's S1 takes no 257 x 129 half
    grid) is recorded as its error."""
    here = str(Path(__file__).resolve().parent)
    roots = [str(Path(t).resolve()) for t in trees] + [here]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from torchoptics_tpu_torch.ops import _kernels; print(_kernels.build())")
    builds = [subprocess.Popen([sys.executable, "-c", build, root], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True) for root in roots]
    for root, proc in zip(roots, builds):
        text = proc.communicate()[0]
        check(proc.returncode == 0, f"kernel build of {root}: exit {proc.returncode}\n"
              + text[-4000:])
    order = roots[:-1] + [here, here] + roots[-2::-1]
    out = {}
    for label, px, psf_shape, step in SPLAT_MEMORY_RUNS:
        for turn, root in enumerate(order):
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                   "--splat-memory-of", root, str(px), str(psf_shape[0]),
                                   str(int(step))], capture_output=True, text=True, timeout=900)
            print(proc.stdout[-6000:], flush=True)
            check(proc.returncode == 0, f"splat memory of {root}, {label}: exit "
                  f"{proc.returncode}\n" + proc.stderr[-4000:])
            out.setdefault(label, []).append(
                {"tree": root, "turn": turn, **json.loads(proc.stdout.strip().splitlines()[-1])})
    return out


def s1_fwd_workspace(psf, args):
    """The bytes of S1 forward's scratch on ``args`` on its route: a double
    for each (pair, span, bin), and on the windowed route the windows'
    int32s (``s1_fwd_window_ints``: 16 bytes a ray and a flag a pair, span
    and band of rows)."""
    from torchoptics_tpu_torch.ops import _kernels
    g, C, R = args[0].shape
    ny, nx = args[3].shape[1], args[2].shape[1]
    n_spans = -(-R // psf.splat_span(R, g * C))
    ints = (_kernels.load().s1_fwd_window_ints(g * C, R, n_spans, ny)
            if psf.splat_fwd_windowed(ny, nx) else 0)
    return g * C * n_spans * ny * nx * 8 + 4 * ints


def default_splat_args(torch, zoo, simulator, imaging, psf, psf_shape=(65, 65)):
    """The default configuration's own splat: the arguments of ``psf.splat``
    in a render of the double-Gauss traced on K1 (21 fields x 3 channels, a
    65 x 33 half grid at the default psf_shape, 65,536 rays)."""
    cfg = default_imaging_config(simulator, psf_shape=psf_shape)
    specs, lens = zoo.build("double_gauss", device="cuda")
    with torch.no_grad():
        return capture_splat(torch, psf, lambda: imaging.sample_optics_model(specs, lens, cfg))[1]


def s1_times(torch, psf, args, plain=False):
    """S1 forward and adjoint (as the main path calls it: no d/dw, no per-bin
    sums) on ``args``, CUDA events (``auto_ms``), with the PyTorch
    contractions of ``splat_library`` timed in the same process, and with
    ``plain`` the plain versions. Returns {key: ms}."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    half = psf._launch_splat(*args)
    cot = torch.randn(half.shape, generator=gen, device="cuda", dtype=half.dtype)
    ms = {"s1_fwd": auto_ms(torch, lambda: psf._launch_splat(*args)),
          "s1_bwd": auto_ms(torch, lambda: psf._launch_splat_bwd(*args, cot, False, False))}
    library = splat_library(torch, args, cot)
    ms.update(s1_fwd_einsum=library["fwd"], s1_bwd_contractions=library["bwd"])
    if plain:
        ms["plain_fwd"] = auto_ms(torch, lambda: psf.splat_reference(*args), budget_ms=300.0)
        ms["plain_bwd"] = auto_ms(torch, lambda: psf.splat_backward_reference(*args, cot),
                                  budget_ms=300.0)
    return ms


#: The kernels of S1's forward launch that ``s1_fwd_split`` reads, each a key
#: of its own (a call launches those of its route: the dense kernel, or the
#: window and band kernels; then the second pass).
S1_FWD_KERNELS = ("s1_fwd_window_kernel", "s1_fwd_band_kernel", "s1_fwd_kernel",
                  "s1_fwd_reduce")


def s1_fwd_split(torch, psf, args, calls=10):
    """Each kernel of S1 forward's launch on ``args``: its device time
    (torch.profiler) a call, over ``calls`` calls after one. Returns
    {kernel: ms}."""
    from torch.profiler import ProfilerActivity, profile
    psf._launch_splat(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            psf._launch_splat(*args)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        name = next((k for k in S1_FWD_KERNELS if f"{k}<" in ev.key or f"{k}I" in ev.key), None)
        if name and dev_us:
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / calls
    return out


#: S1's adjoint's instantiations that ``s1_bwd_variants`` times: {name:
#: (float64, weights with d/dw and per-bin sums)}: the main path's
#: (float32, neither), ``full`` (the kernels' FULL instantiation) and
#: float64.
S1_BWD_VARIANTS = {"main": (False, False), "full": (False, True), "f64": (True, False)}


def s1_bwd_variants(torch, zoo, simulator, imaging, psf, sizes=(65, 129)):
    """S1's adjoint at the default configuration's splat at each psf size of
    ``sizes`` (half grids 65 x 33 and 129 x 65) in each instantiation of
    ``S1_BWD_VARIANTS`` (``full``: seeded uniform weights), on the tree's
    route, CUDA events (``auto_ms``), keys ``s1_bwd_<size>_<variant>``.
    Returns {key: ms}."""
    gen = torch.Generator(device="cuda").manual_seed(47)
    ms = {}
    for size in sizes:
        base = default_splat_args(torch, zoo, simulator, imaging, psf, (size, size))
        for name, (f64, full) in S1_BWD_VARIANTS.items():
            args = [None if a is None else (a.double() if f64 else a) for a in base]
            if full:
                args[6] = torch.rand(args[0].shape, generator=gen, device="cuda",
                                     dtype=args[0].dtype)
            half = psf._launch_splat(*args)
            cot = torch.randn(half.shape, generator=gen, device="cuda", dtype=half.dtype)
            ms[f"s1_bwd_{size}_{name}"] = auto_ms(
                torch, lambda: psf._launch_splat_bwd(*args, cot, full, full))
            del half, cot
    return ms


#: The psf sizes (half grids n x (n + 1) / 2) at which ``s1_crossover``
#: times S1 forward's two routes.
S1_CROSSOVER_SIZES = (65, 73, 81, 89, 97, 129, 257)


def s1_crossover(torch, zoo, simulator, imaging, psf, card, turns=4):
    """S1 forward's dense kernel and windowed kernels, each forced, at the
    default configuration's splat at each psf size of ``S1_CROSSOVER_SIZES``:
    CUDA events (``auto_ms``), dense and windowed alternating ``turns``
    times each (dense first on even turns), both bit for bit with each
    other. Returns {size: {"bins", "rule", "dense", "windowed"}} (the times
    of each turn, ms) with the card."""
    out = {"card": card, "dense_bins": psf.SPLAT_DENSE_BINS}
    for size in S1_CROSSOVER_SIZES:
        args = default_splat_args(torch, zoo, simulator, imaging, psf, (size, size))
        ny, nx = args[3].shape[1], args[2].shape[1]
        runs = {True: lambda: psf._launch_splat(*args, windowed=True),
                False: lambda: psf._launch_splat(*args, windowed=False)}
        same = same_bits(runs[True](), runs[False]())
        times = {"dense": [], "windowed": []}
        for turn in range(turns):
            for windowed in ((False, True) if turn % 2 == 0 else (True, False)):
                times["windowed" if windowed else "dense"].append(auto_ms(torch, runs[windowed]))
        row = {"half_grid": [ny, nx], "bins": ny * nx,
               "rule": "windowed" if psf.splat_fwd_windowed(ny, nx) else "dense",
               "bit_identical": same, **times}
        out[str(size)] = row
        print(f"S1 forward at psf {size} (half grid {ny} x {nx}, {ny * nx} bins): dense "
              f"{[round(t, 4) for t in times['dense']]} ms, windowed "
              f"{[round(t, 4) for t in times['windowed']]} ms, the rule's route {row['rule']}, "
              f"bit-identical {same}; card: {card}", flush=True)
        check(same, f"S1 forward's two routes bit for bit at psf {size}")
        del args
    return out


#: The FP64 rate kernel's kinds (csrc/psf_splat_probe.cu) and the
#: multiply-adds a thread does per chain and step of each.
FP64_RATE_KINDS = {"dfma": (0, 2), "mma_m8n8k4": (1, 8), "mma_m16n8k4": (2, 16)}


def fp64_rates(torch, lib, iters=1024, blocks=132 * 8):
    """The card's FP64 rates, TFLOP/s (a multiply-add two operations): the
    rate kernel of ``psf_splat_probe.cu`` (8 independent chains a thread,
    ``blocks`` blocks of 256 threads) timed by CUDA events over 5 launches
    after one, for DFMA and mma.sync m8n8k4 and m16n8k4 .f64."""
    out = torch.empty(blocks * 256, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, (kind, fmas) in FP64_RATE_KINDS.items():
        def launch():
            err = lib.s1_fp64_rate(iters, blocks, kind, out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"the FP64 rate kernel failed: "
                                   f"{lib.k1_error_string(err).decode()}")
        launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            launch()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 5 / 1e3
        rates[name] = 2 * blocks * 256 * iters * 8 * fmas / seconds / 1e12
    return rates


def phase_splat(torch, zoo, simulator, imaging, psf, card, profiled=True):
    """Phase 43: kernel S1 (the PSF splat), forward and adjoint, against its
    plain versions on the card (``splat_cases``), bit for bit, one launch of
    each a call; a CUDA-tensor ``compute_psf`` under grad launches S1 both
    ways and never a plain version; timings at the default configuration's
    splat (CUDA events: S1, its plain versions, the PyTorch contractions);
    the default configuration's 2048^2 render and image-loss step's memory,
    walls and largest allocations, and with ``profiled`` its profile
    (``splat_memory``). First S1's tensor-core probe (``psf.dmma_probe``:
    mma.sync m8n8k4 and m16n8k4 .f64 bit for bit with the fma chain in k
    order, which S1's float32 route relies on), the card's FP64 rates and
    S1's registers and spills. Returns the numbers for the kernels line."""
    from torchoptics_tpu_torch.ops import _kernels
    probe = psf.dmma_probe()
    for shape, labels in probe.items():
        print(f"S1 tensor-core probe, mma.sync {shape} .f64 against the fma chain in k order: "
              + "; ".join(f"{label}: {v['differ']} of {v['entries']} differ, matches "
                          f"{v['models']}" for label, v in labels.items()), flush=True)
    check(all(v["differ"] == 0 and v["fma_chain_ok"] for labels in probe.values()
              for v in labels.values()),
          "S1's tensor-core probe: every mma.sync .f64 result bit for bit the fma chain in k "
          "order (the route S1's float32 products take)")
    zeros = psf.exp_zero_probe()
    print("S1 window threshold probe (exp(-q / 2) == 0 for every q above q_max): "
          + "; ".join(f"{k}: q_max {v['q_max']}, {v['checked']} q's checked, {v['nonzero']} not 0"
                      + (f" (least {v['least']!r})" if v["nonzero"] else "")
                      for k, v in zeros.items()), flush=True)
    check(all(v["nonzero"] == 0 and v["q_max"] == psf.SPLAT_Q_MAX[
        torch.float64 if k.startswith("float64") else torch.float32] for k, v in zeros.items()),
          "S1's windows: every factor above q_max is 0 on the card (every float32 q; "
          "of float64 q every double in (q_max, q_max + 1], 2^26 spread, the binades' end "
          "points), q_max as psf.SPLAT_Q_MAX")
    rates = fp64_rates(torch, _kernels.load())
    print("FP64 rates (TFLOP/s, psf_splat_probe.cu): "
          + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()) + f"; card: {card}", flush=True)
    for line in ptxas_summary(_kernels.library_path()):
        if line.startswith("s1_"):
            print(f"S1 ptxas: {line}", flush=True)
    cases = splat_cases(torch, zoo, simulator, imaging, psf)
    results, worst = {}, {"fwd": 0.0, "bwd": 0.0}
    for n, (label, (args, bins, weights_grad, windowed)) in enumerate(cases.items()):
        out, launches = splat_compare(torch, psf, label, args, bins, weights_grad, 100 + n,
                                      windowed)
        results[label] = (out, launches)
        worst["fwd"] = max(worst["fwd"], out["half"][1])
        worst["bwd"] = max([worst["bwd"]] + [v[1] for k, v in out.items() if k != "half"])
    bad = {label: [k for k, v in out.items() if not v[0]] for label, (out, launches)
           in results.items() if not all(v[0] for v in out.values()) or launches != (1, 1)}
    check(not bad, f"S1 forward and adjoint bit for bit with their plain versions, one launch "
          f"each, on {len(cases)} cases; differing: {bad}")
    reference, backward_reference = psf.splat_reference, psf.splat_backward_reference

    def refuse(*_):
        raise AssertionError("a plain version ran on CUDA tensors")
    psf.splat_reference = psf.splat_backward_reference = refuse
    try:
        psf.SPLAT_LAUNCHES = psf.SPLAT_BWD_LAUNCHES = 0
        xs, ys = seeded_spots(torch, (2, 4, 3, 2500), 4)
        xs, ys = xs.requires_grad_(), ys.requires_grad_()
        kernels = psf.compute_psf(xs, ys, (21, 21), None)[3]
        grads = torch.autograd.grad((kernels * kernels).sum(), (xs, ys))
        torch.cuda.synchronize()
        launches = (psf.SPLAT_LAUNCHES, psf.SPLAT_BWD_LAUNCHES)
    finally:
        psf.splat_reference, psf.splat_backward_reference = reference, backward_reference
    check(launches == (1, 1) and all(bool(torch.isfinite(g).all()) for g in grads),
          f"compute_psf on CUDA tensors under grad (increment=None): S1 launches (forward, "
          f"adjoint) {launches} (expected (1, 1)), no plain version ran, gradients finite")

    args = cases["default config (21 x 3 pairs, 65 x 33, 65,536 rays)"][0]
    ms = s1_times(torch, psf, args, plain=True)
    splits = {"65": s1_fwd_split(torch, psf, args)}
    library = {"fwd": ms["s1_fwd_einsum"], "bwd": ms["s1_bwd_contractions"]}
    windows = {"65": splat_windows(torch, psf, args)}
    bounds = {"fwd": s1_window_bound(args, windows["65"], False),
              "bwd": s1_window_bound(args, windows["65"]),
              "fwd_dense": s1_bound(args, False), "bwd_dense": s1_bound(args, True)}
    workspace = s1_fwd_workspace(psf, args)
    for what in ("fwd", "bwd"):
        b, d, t = bounds[what], bounds[f"{what}_dense"], ms[f"s1_{what}"]
        print(f"time S1 {'forward' if what == 'fwd' else 'adjoint'} at the default "
              f"configuration's splat {tuple(args[0].shape)} on 65 x 33: {t:.4f} ms (plain "
              f"{ms[f'plain_{what}']:.2f} ms; PyTorch contractions {library[what]:.4f} ms, TF32 "
              f"off); window bound {b[0]:.4f} ms by {b[1]} ({b[2]:.3e} operations, "
              f"{b[3] / 1e6:.2f} MB), {b[0] / t:.4f} of it reached; dense bound {d[0]:.4f} ms "
              f"({d[2]:.3e} operations), {d[0] / t:.3f} of it reached; forward workspace "
              f"{workspace / 1e6:.1f} MB; card: {card}", flush=True)
    print(f"S1's windows at the default configuration's splat on 65 x 33: mean |Wx| "
          f"{windows['65']['mean_wx']:.3f}, |Wy| {windows['65']['mean_wy']:.3f}, |Wx| x |Wy| "
          f"{windows['65']['mean_wxy']:.3f} bins a ray, {windows['65']['empty_share']:.4f} of the "
          f"rays empty; card: {card}", flush=True)
    # The default configuration's splat at psf_shape (257, 257): the forward's
    # tiles; S1 and the PyTorch contractions by CUDA events, the plain
    # versions one host-clock run each; the windows' sizes and the window
    # bound.
    args = cases[SPLAT_257][0]
    tiles = (ctypes.c_int * 4)()
    _kernels.load().s1_fwd_tiles(args[3].shape[1], args[2].shape[1],
                                 int(psf.splat_fwd_windowed(args[3].shape[1], args[2].shape[1])),
                                 tiles)
    ms257 = s1_times(torch, psf, args)
    splits["257"] = s1_fwd_split(torch, psf, args)
    print(f"S1 forward's kernels (torch.profiler, ms a call): at 65 x 33 {splits['65']}, at "
          f"257 x 129 {splits['257']}; card: {card}", flush=True)
    half = psf._launch_splat(*args)
    cot = torch.randn(half.shape, generator=torch.Generator(device="cuda").manual_seed(257),
                      device="cuda")
    ms257["plain_fwd"] = host_ms(torch, lambda: psf.splat_reference(*args), runs=1, warmup=0)
    ms257["plain_bwd"] = host_ms(torch, lambda: psf.splat_backward_reference(*args, cot),
                                 runs=1, warmup=0)
    del half, cot
    windows["257"] = splat_windows(torch, psf, args)
    bounds257 = {"fwd": s1_window_bound(args, windows["257"], False),
                 "bwd": s1_window_bound(args, windows["257"]),
                 "fwd_dense": s1_bound(args, False), "bwd_dense": s1_bound(args, True)}
    for what in ("fwd", "bwd"):
        b, d, t = bounds257[what], bounds257[f"{what}_dense"], ms257[f"s1_{what}"]
        lib_ms = ms257["s1_fwd_einsum" if what == "fwd" else "s1_bwd_contractions"]
        print(f"time S1 {'forward' if what == 'fwd' else 'adjoint'} at the "
              f"default configuration's splat at psf 257 {tuple(args[0].shape)} on 257 x 129 "
              f"(forward tiles {list(tiles)}: rows, columns, down, across; forward workspace "
              f"{s1_fwd_workspace(psf, args) / 1e6:.1f} MB): {t:.4f} ms (plain "
              f"{ms257[f'plain_{what}']:.1f} ms, one run; PyTorch contractions {lib_ms:.4f} ms, "
              f"TF32 off); window bound {b[0]:.4f} ms by {b[1]} ({b[2]:.3e} operations, "
              f"{b[3] / 1e6:.2f} MB), {b[0] / t:.4f} of it reached; dense bound {d[0]:.4f} ms "
              f"({d[2]:.3e} operations), {d[0] / t:.3f} of it reached; card: {card}", flush=True)
    w257 = windows["257"]
    print(f"S1's windows at psf 257: mean |Wx| {w257['mean_wx']:.3f}, |Wy| "
          f"{w257['mean_wy']:.3f}, |Wx| x |Wy| {w257['mean_wxy']:.3f} bins a ray, "
          f"{w257['empty_share']:.4f} of the rays empty; card: {card}", flush=True)
    memory = {label: splat_memory(torch, card, profiled, px, psf_shape, step)
              for label, px, psf_shape, step in SPLAT_MEMORY_RUNS}
    wide = memory["2048^2 at psf 257"]
    check(wide["step_peak_bytes"] <= PSF257_PEAK_BYTES
          and wide["step_largest_allocations"][0][0] <= PSF257_LARGEST_BYTES
          and all(m["resize_largest_bytes"] <= m["resize_bytes"] for m in memory.values()),
          f"the default configuration's 2048^2 image-loss step at psf 257: peak "
          f"{wide['step_peak_bytes'] / 1e9:.3f} GB (limit {PSF257_PEAK_BYTES / 1e9:.0f}), "
          f"largest allocation {wide['step_largest_allocations'][0][0] / 1e9:.3f} GB (limit "
          f"{PSF257_LARGEST_BYTES / 1e9:.1f}); resize_bilinear's largest allocation within "
          f"twice its largest operand in every run: "
          f"{ {k: (m['resize_largest_bytes'], m['resize_bytes']) for k, m in memory.items()} }")
    return {"results": results, "worst": worst, "ms": ms, "library": library,
            "bounds": bounds, "workspace_bytes": workspace, "memory": memory, "probe": probe,
            "fp64_tflops": rates, "ms_257": ms257, "bounds_257": bounds257,
            "windows": windows, "exp_zero_probe": zeros,
            "tiles_257": list(tiles), "workspace_bytes_257": s1_fwd_workspace(psf, args),
            "fwd_kernel_ms": splits}


def s1_entries(splat, train_launches, resources=(), train_launches_257=(None, None)):
    """S1's entries of the kernels line: forward (``s1_fwd``) and adjoint
    (``s1_bwd``) at the default configuration's splat, ``launches`` counting
    the main path's run (phase 39's image-loss steps at the default
    configuration), ``bound_ms`` the work of the rays' windows
    (``s1_window_bound``) and ``bound_ms_dense`` that of every bin
    (``s1_bound``); ``half_grid_257``: the same numbers at psf_shape (257,
    257), its launches those of phase 39's steps there."""
    out = []

    def bound_keys(bounds, what, t):
        b, d = bounds[what], bounds[f"{what}_dense"]
        return {"bound_ms": b[0], "bound_by": b[1], "bound_share": b[0] / t,
                "bound_ms_dense": d[0], "bound_by_dense": d[1], "bound_share_dense": d[0] / t}

    for what, source in (("fwd", S1_FWD_SOURCE), ("bwd", S1_BWD_SOURCE)):
        ms, ms257 = splat["ms"][f"s1_{what}"], splat["ms_257"][f"s1_{what}"]
        out.append({
            "name": f"s1_{what}", "route": "cuda", "source": source, "replaces": TPU_S1,
            "launches": train_launches[0 if what == "fwd" else 1],
            "max_abs_err": splat["worst"][what], "ms": ms,
            "plain_ms": splat["ms"][f"plain_{what}"], **bound_keys(splat["bounds"], what, ms),
            "library_ms": splat["library"]["fwd"] if what == "fwd" else None,
            "library_ms_contractions": splat["library"][what],
            "windows": splat["windows"]["65"],
            "products": "float32: FP64 tensor cores (mma.sync m16n8k4); float64: separate "
                        "double multiplies and adds",
            "tensor_core_probe_differ": {shape: sum(v["differ"] for v in labels.values())
                                         for shape, labels in splat["probe"].items()},
            "fp64_tflops": splat["fp64_tflops"],
            "workspace_bytes": splat["workspace_bytes"] if what == "fwd" else 0,
            **({"kernel_ms": splat["fwd_kernel_ms"]["65"]} if what == "fwd" else {}),
            "cases_bit_identical": {label: all(v[0] for v in out_.values())
                                    for label, (out_, _) in splat["results"].items()},
            "default_2048_memory": {k: v for k, v in splat["memory"]["2048^2 at psf 65"].items()
                                    if not k.endswith("_groups_ms")},
            "memory_runs": {label: {k: v for k, v in m.items() if not k.endswith("_groups_ms")}
                            for label, m in splat["memory"].items()},
            "half_grid_257": {
                "launches": train_launches_257[0 if what == "fwd" else 1],
                "ms": ms257, "plain_ms": splat["ms_257"][f"plain_{what}"],
                **bound_keys(splat["bounds_257"], what, ms257),
                "library_ms": splat["ms_257"]["s1_fwd_einsum" if what == "fwd"
                                              else "s1_bwd_contractions"],
                "windows": splat["windows"]["257"],
                **({"tiles": splat["tiles_257"],
                    "workspace_bytes": splat["workspace_bytes_257"],
                    "kernel_ms": splat["fwd_kernel_ms"]["257"]} if what == "fwd" else {
                    "exp_zero_probe": splat["exp_zero_probe"]})}})
        # The main path's kernels' registers, stack and spills (float32; the
        # forward's dense kernel, which the default grid runs, and its
        # windowed route's window and band kernels; the adjoint without d/dw
        # and the per-bin sums, its centres in shared memory), from -Xptxas
        # -v.
        names = ({"kernel": "s1_fwd_kernel<float>", "window_kernel": "s1_fwd_window_kernel<float>",
                  "band_kernel": "s1_fwd_band_kernel<float>"}
                 if what == "fwd" else {"kernel": "s1_bwd_window_kernel<float,false,true>"})
        for line in resources:
            for key, name in names.items():
                if line.startswith(name):
                    out[-1][f"{key}_resources"] = {
                        "registers": int(re.search(r"Used (\d+) registers", line).group(1)),
                        "stack_bytes": int(re.search(r"(\d+) bytes stack frame", line).group(1))
                        if "stack frame" in line else 0,
                        "spill_bytes": [int(v) for v in re.findall(
                            r"(\d+) bytes spill (?:stores|loads)", line)]}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    families = KERNEL_FAMILIES
    if "--families" in args:
        families = tuple(args[args.index("--families") + 1].split(","))
        check(set(families) <= set(KERNEL_FAMILIES),
              f"--families takes some of {','.join(KERNEL_FAMILIES)}, got {','.join(families)}")
        del args[args.index("--families"):args.index("--families") + 2]
    if "--build-times" in args:
        print(json.dumps({"build_s": build_times(args[args.index("--build-times") + 1:]),
                          "card": card_line()}))
        return 0
    if "--kernel-turns" in args:
        print(json.dumps({"kernel_turns": kernel_turns(args[args.index("--kernel-turns") + 1:],
                                                       card_line(), families)}))
        return 0
    if "--splat-memory-of" in args:
        root, px, psf, step = args[args.index("--splat-memory-of") + 1:][:4]
        sys.path.insert(0, root)
        from torchoptics_tpu_torch.ops import _kernels
        _kernels.load()
        try:
            out = splat_memory(torch, card_line(), True, int(px), (int(psf),) * 2, step == "1")
        except ValueError as e:
            out = {"refused": str(e)}
        print(json.dumps(out))
        return 0
    if "--splat-memory" in args:
        print(json.dumps({"splat_memory": splat_memory_turns(
            args[args.index("--splat-memory") + 1:], card_line())}))
        return 0
    if "--kernel-times" in args:
        print(json.dumps(kernel_times(torch, args[args.index("--kernel-times") + 1],
                                      card_line(), families)))
        return 0
    from torchoptics_tpu_torch import LensOptimizer, OpticalLoss, entry, imaging, simulator, zoo
    from torchoptics_tpu_torch.benchmarks import issue_peak
    from torchoptics_tpu_torch.ops import (_kernels, fused_asphere, fused_batch, fused_trace, image,
                                           psf)

    card = card_line()
    print(f"card: {card} (nvidia-smi name, power.limit); "
          f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    start = time.perf_counter()
    path = _kernels.build()
    _kernels.load()
    print(f"build: {path.name} in {time.perf_counter() - start:.2f} s", flush=True)
    resources = ptxas_summary(path)
    for line in resources:
        print(f"ptxas: {line}", flush=True)

    if "--profile" in sys.argv[1:]:
        phase_profile(torch, zoo, simulator, fused_trace, LensOptimizer, OpticalLoss, card)
        return 0
    if "--render-walls" in sys.argv[1:]:
        print(json.dumps({"render_walls": render_walls(torch, zoo, simulator, imaging, card)}))
        return 0
    if "--ragged" in sys.argv[1:]:
        phase_ragged(torch, zoo, simulator, (fused_trace, fused_batch, fused_asphere))
        return 0
    if "--population-routes" in sys.argv[1:]:
        phase_population_routes(torch, zoo, simulator, (fused_trace, fused_batch, fused_asphere))
        return 0
    if "--p2-fft" in sys.argv[1:]:
        inputs = render_inputs(torch, zoo, simulator, imaging, image, CROSSOVER_RENDERS)
        cases = {f"{name} {px}^2": args for (name, px), args in inputs.items()}
        for label, args in dict(cases, **seeded_fft_cases(torch)).items():
            fft_route_check(torch, image, label, *args)
        print(json.dumps({"p2_crossover": phase_p2_crossover(torch, image, inputs, card)}))
        for px in (2048, 4096):
            patches, psfs, cot = inputs[("default", px)]
            k = tuple(psfs.shape[1:3])
            with torch.no_grad():
                for adjoint, second in ((False, psfs), (True, cot)):
                    profile_steps(torch, f"P2's FFT route, {'d/dpsf' if adjoint else 'forward'}, "
                                  f"default config at {px}^2 (K = {k[0]})",
                                  lambda: image._launch_fft(patches, second, k, adjoint), card,
                                  n_steps=5)
        return 0
    if "--analysis" in sys.argv[1:]:
        phase_analysis(torch, zoo, (fused_trace, fused_batch, fused_asphere), card)
        profile_analysis(torch, zoo, card)
        return 0
    if "--parallel" in sys.argv[1:]:
        phase_parallel(torch, card)
        return 0
    if "--examples" in sys.argv[1:]:
        phase_examples(torch, card, verbose=True)
        return 0
    if "--s1-crossover" in sys.argv[1:]:
        print(json.dumps({"s1_crossover": s1_crossover(torch, zoo, simulator, imaging, psf,
                                                       card)}))
        return 0
    if "--splat" in sys.argv[1:]:
        splat = phase_splat(torch, zoo, simulator, imaging, psf, card)
        print(json.dumps({"kernels": s1_entries(splat, (None, None), resources)}))
        return 0
    if "--default-image-training" in sys.argv[1:]:
        print(json.dumps({"default_image_training": [phase_default_image_training(
            torch, zoo, simulator, imaging, image, fused_trace, LensOptimizer, card,
            psf_shape=shape) for shape in ((65, 65), (257, 257))]}))
        return 0
    if "--fft-cut" in sys.argv[1:]:
        cut = phase_fft_cut(torch, zoo, simulator, imaging, image, fused_trace, card)
        print(json.dumps({"fft_cut": {k: v for k, v in cut.items()}}))
        return 0

    with torch.no_grad():
        fwd_err = phase_forward(torch, zoo, simulator, fused_trace)
    route_err = phase_k1_routes(torch, zoo, simulator, fused_trace, fused_batch)
    fwd_err = {key: max(err, route_err[key]) for key, err in fwd_err.items()}
    pop_route_err, occupancy = phase_population_routes(
        torch, zoo, simulator, (fused_trace, fused_batch, fused_asphere))
    bwd_err = phase_backward(torch, zoo, simulator, fused_trace)
    serve_launches = phase_serve(torch, zoo, simulator, fused_trace, entry)
    train_launches = phase_train(torch, zoo, simulator, fused_trace, LensOptimizer)
    k2_err = phase_k2_kernels(torch, zoo, simulator, fused_batch, fused_trace)
    phase_k2_is_k1(torch, zoo, simulator, fused_trace, fused_batch)
    pop_serve_launches = phase_population_serve(torch, zoo, simulator, fused_trace, fused_batch)
    gen_launches = phase_generator(torch, fused_batch, OpticalLoss)
    mixed_launches = phase_mixed_full_loss(torch, zoo, simulator, fused_trace, fused_batch)
    ms, errs, shape = phase_timing(torch, zoo, simulator, fused_trace, LensOptimizer, card)
    k2_ms, k2_shape = phase_k2_timing(torch, zoo, simulator, fused_trace, fused_batch,
                                      OpticalLoss, card)
    with torch.no_grad():
        k3_fwd_err = phase_k3_forward(torch, zoo, simulator, fused_trace, fused_asphere)
    k3_bwd_err = phase_k3_backward(torch, zoo, simulator, fused_trace, fused_asphere)
    phase_k3_is_k1(torch, zoo, simulator, fused_trace, fused_asphere)
    k3_serve_launches = phase_k3_serve(torch, zoo, simulator, fused_trace, fused_asphere)
    k3_train_launches = phase_k3_train(torch, zoo, simulator, fused_trace, fused_asphere,
                                       LensOptimizer)
    newton = phase_newton_statistics(torch, zoo, simulator, fused_trace, fused_asphere)
    k3_ms, k3_fwd_err_bench, k3_bwd_err_bench, k3_shape = phase_k3_timing(
        torch, zoo, simulator, fused_trace, fused_asphere, LensOptimizer, card,
        newton["double_gauss_asph"])
    k4_err = phase_k4_kernels(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere)
    phase_k4_is_k3(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere)
    k4_serve_launches = phase_k4_serve(torch, zoo, simulator, fused_trace, fused_batch,
                                       fused_asphere)
    k4_launches = phase_k4_train(torch, zoo, simulator, fused_trace, fused_batch, fused_asphere)
    k4_ms, k4_shape = phase_k4_timing(torch, zoo, simulator, fused_trace, fused_batch,
                                      fused_asphere, card)
    modules = (fused_trace, fused_batch, fused_asphere)
    opl_worst = phase_opl_kernels(torch, zoo, simulator, modules)
    phase_opl_population_of_one(torch, zoo, simulator, modules)
    opl_serve = phase_wavefront_serve(torch, zoo, modules)
    opl_pop = phase_population_wavefront(torch, zoo, simulator, modules)
    phase_diffraction(torch, zoo, modules)
    opl_train, step_ms = phase_wavefront_train(torch, zoo, modules)
    fwd_bwd_ms, fwd_bwd_launches = phase_opl_fwd_bwd(torch, zoo, modules, card)
    opl_ms, opl_shapes = phase_opl_timing(torch, zoo, simulator, modules, card)
    ragged = phase_ragged(torch, zoo, simulator, modules)
    entries = kernel_entries(ms, errs, shape, fwd_err, bwd_err, serve_launches, train_launches)
    k2_err = dict(k2_err, fwd=max(k2_err["fwd"], pop_route_err["k2_fwd"]),
                  fwd_full=max(k2_err["fwd_full"], pop_route_err["k2_fwd_full"]))
    k4_err = dict(k4_err, fwd=max(k4_err["fwd"], pop_route_err["k4_fwd"]),
                  fwd_full=max(k4_err["fwd_full"], pop_route_err["k4_fwd_full"]))
    entries += k2_entries(k2_ms, k2_shape, k2_err, pop_serve_launches, gen_launches,
                          mixed_launches)
    entries += k3_entries(k3_ms, k3_shape, (k3_fwd_err, k3_fwd_err_bench),
                          (k3_bwd_err, k3_bwd_err_bench), k3_serve_launches, k3_train_launches)
    entries += k4_entries(k4_ms, k4_shape, k4_err, k4_serve_launches, *k4_launches)
    entries += opl_entries(opl_ms, opl_shapes, opl_worst, opl_serve, opl_pop, opl_train,
                           fwd_bwd_launches, fwd_bwd_ms, step_ms)
    p2_err, p2_timing_inputs = phase_p2_kernel(torch, zoo, simulator, imaging, image)
    p2_launches = phase_imaging_serve(torch, zoo, simulator, imaging, image, fused_trace)
    p1 = phase_p1_probe(torch, issue_peak)
    img_ms, p2_b, walls = phase_imaging_timing(torch, zoo, simulator, imaging, image,
                                               p2_timing_inputs, card)
    entries += imaging_entries(p2_err, p2_launches[1], img_ms, p2_b, walls, p1, p1[0])
    # Phase 37's timings of the route and of the adjoint run right after
    # phases 33 and 34, so that their inputs are freed before the default
    # configuration's training.
    wide_errs, wide_inputs, wide_launches = phase_p2_wide(torch, zoo, simulator, imaging, image,
                                                          fused_trace)
    fft_ms, fft_bounds = phase_fft_timing(torch, image, wide_inputs, card)
    del wide_inputs
    adjoint = phase_p2_adjoint(torch, zoo, simulator, imaging, image)
    adj_ms, adj_bound = phase_adjoint_timing(torch, image, adjoint, card)
    adjoint = {"config 5 at 1024^2": (None,) * 3 + adjoint["config 5 at 1024^2"][3:]}
    torch.cuda.empty_cache()
    train_launches, _, bundle = phase_image_training(torch, zoo, simulator, imaging, image,
                                                     fused_trace, LensOptimizer, card)
    default_train = phase_default_image_training(torch, zoo, simulator, imaging, image,
                                                 fused_trace, LensOptimizer, card)
    torch.cuda.empty_cache()
    default_train_257 = phase_default_image_training(
        torch, zoo, simulator, imaging, image, fused_trace, LensOptimizer, card, n_steps=2,
        psf_shape=(257, 257))
    torch.cuda.empty_cache()
    phase_raytraced_optics(torch, zoo, simulator, fused_trace)
    analysis_launches, _ = phase_analysis(torch, zoo, (fused_trace, fused_batch, fused_asphere),
                                          card)
    parallel_launches = phase_parallel(torch, card)
    example_launches = phase_examples(torch, card)
    torch.cuda.empty_cache()
    splat = phase_splat(torch, zoo, simulator, imaging, psf, card, profiled=False)
    torch.cuda.empty_cache()
    cut = phase_fft_cut(torch, zoo, simulator, imaging, image, fused_trace, card)
    torch.cuda.empty_cache()
    entries.append(adjoint_entry(adjoint, train_launches, adj_ms, adj_bound))
    crossover = phase_p2_crossover(torch, image, render_inputs(
        torch, zoo, simulator, imaging, image, CROSSOVER_RENDERS), card)
    entries += fft_entries(wide_errs, wide_launches, default_train, fft_ms, fft_bounds,
                           crossover, p1[0], cut)
    entries += s1_entries(splat, default_train[0][6:8], resources, default_train_257[0][6:8])
    add_issue_bounds(entries, p1[0], {"k1": shape, "k2": k2_shape, "k3": k3_shape,
                                      "k4": k4_shape,
                                      **{f"opl_{k}": v for k, v in opl_shapes.items()}})
    lib = _kernels.load()
    k2_surf = k2_shape["n_surf"]
    add_resources(entries, resources, {"k3": k3_shape["n_asph"], "k4": k4_shape["n_asph"]},
                  {"k1_fwd": shape["n_surf"] if lib.k1_fwd_specialized(shape["n_surf"]) else 0,
                   "k2_fwd": k2_surf if lib.k2_fwd_specialized(k2_surf) else 0,
                   "k2_bwd": k2_surf if lib.k2_bwd_specialized(k2_surf) else 0})
    for e in entries:
        # The population forwards' block, resident blocks per SM and waves
        # at the timed width, on the timed population's kernel.
        family = e["name"][:2]
        if e["name"][:6] in ("k2_fwd", "k4_fwd"):
            mode = ("opl" if e["name"].endswith("_opl") else
                    "full" if e["name"].endswith("_full") else "lu")
            key = f"{mode} {k2_surf} unmasked" if family == "k2" else f"{mode} unmasked"
            if key in occupancy[family]:
                e["block"], e["blocks_per_sm"], e["waves"] = occupancy[family][key]
        if e["name"][:6] in ("k1_bwd", "k2_bwd", "k3_bwd", "k4_bwd"):
            e["ragged_param_max_rel_err"] = ragged[e["name"][:2]]
        # K1 at the image loss's PSF bundle (plain mode), the slice's main path.
        if e["name"] == "k1_fwd":
            e["image_bundle_max_abs_err"] = bundle[0]
            e["launches_image_training"] = train_launches[0]
        # Launches per analysis call (phase 40), by the entry of the mode each runs.
        e["launches_analysis"] = analysis_launches.get(e["name"], {})
        # Launches per rank of each phase-41 call, by the entry of the mode it runs.
        e["launches_parallel"] = parallel_launches.get(e["name"], {})
        # Launches of each example's fused run (phase 42), and per step, measured.
        e["launches_examples"] = example_launches.get(e["name"], {})
        if e["name"] == "k1_bwd":
            e["image_bundle_max_abs_err"] = bundle[1][0]
            e["image_bundle_param_max_rel_err"] = bundle[1][2]
            e["launches_image_training"] = train_launches[1]
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
