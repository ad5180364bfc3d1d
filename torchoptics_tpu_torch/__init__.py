"""torchoptics_tpu_torch: the PyTorch / CUDA port of torchoptics_tpu.

The JAX package ``torchoptics_tpu`` stays the reference; this package
evaluates and optimizes the same lenses with PyTorch, and its hot kernels
(K1 and K2, the fused spherical trace of one system and of a population;
K3 and K4, the fused conic/asphere trace of one system and of a
population; each forward and backward, with an opl mode for the
wavefront; P2, the patch convolution of image formation, and its
adjoint; P1, the card's
issue-rate probe) are hand-written CUDA for Hopper
(``csrc/``), built with ``nvcc`` on first use. It imports neither JAX nor Triton, and builds
nothing at import time. Its entry points put tensors on the GPU unless the
caller asks for the CPU.

Quick start::

    import torch
    from torchoptics_tpu_torch import LensOptimizer, SimulatorConfig, zoo

    specs, lens = zoo.build("double_gauss")          # on "cuda"
    cfg = SimulatorConfig(n_sampled_fields=5, n_pupil_rings=16,
                          pupil_sampling="circular", trace_engine="fused")
    opt = LensOptimizer(specs=specs, config=cfg, learning_rate=1e-4)
    state = opt.init(lens)
    state, loss, loss_dict = opt.step(state)      # one K1 fwd + one K1 bwd

A population of designs, e.g. a generator's batch, traces in one launch of
kernel K2: ``OpticalLoss("GAGA").unsupervised(inputs, outputs, stop_idx=1,
engine="fused")``; a population of conic/asphere designs
(``zoo.aspheric_population``) in one launch of K4:
``fused_batch.batched_unsupervised_loss(specs, lens, cfg)``.

The wavefront (``ops.wavefront``: OPD, Zernike, Strehl, the diffraction
PSFs) and its objective ``analysis.wavefront_rms`` run on the same kernels'
opl mode with ``TraceConfig(engine="fused")``.

Imaging (``imaging.simulate``: PSFs, the SVOLA patch convolution on kernel
P2, the distortion warp) renders a sensor image of a lens; serve it under
``torch.no_grad()``::

    from torchoptics_tpu_torch.utils import images
    cfg = SimulatorConfig(n_sampled_fields=9, n_pupil_rings=24, pupil_sampling="circular",
                          psf_shape=(33, 33), psf_abs_pixel_size=4e-3,
                          psf_grid_shape=(5, 5), trace_engine="fused")
    radiance = torch.tensor(images.load_test_image((1024, 1024))[None], device="cuda")
    with torch.no_grad():
        irradiance, psnr, ssim = imaging.simulate(specs, lens, radiance, cfg)

Rendering is differentiable (P2's adjoint: ``csrc/svola_conv_bwd.cu``), so
a lens trains on rendered image quality, -PSNR + w·(1 - SSIM)::

    opt = LensOptimizer(specs=specs, config=cfg, trainable=("c", "t"),
                        efl_target=float(lens.efl[0]),
                        loss_fn=imaging.make_image_loss_fn(radiance, ssim_weight=10.0))
    state = opt.init(lens)
    state, loss, loss_dict = opt.step(state)   # K1 fwd + bwd, P2, P2's d/dpsf

The analysis layer (``analysis``: Monte-Carlo tolerancing in one population
launch of K2 or K4, the sensitivity table, MTFs, fans, Seidel sums;
``ops.metrics``; ``ops.vignetting``) takes a ``torch.Generator`` where the
JAX package takes a key::

    tol = analysis.Tolerances(c=1e-4, t=0.01, nd=5e-4, v=0.1)
    out = analysis.tolerance_analysis(specs, lens, cfg, tol, 4096,
                                      torch.Generator("cuda").manual_seed(0))

Prescriptions load and save through ``models.io`` (``load_lens``,
``save_lens``); ``RaytracedOptics`` is the stateful simulator over them.
Training state checkpoints through ``utils.checkpoint`` (the JAX package's
layout), metrics through ``utils.logging``.

Several GPUs (or processes sharing one) split a population's systems and a
trace's pupil over a ('lens', 'rays') mesh of ranks, ``parallel.mesh`` and
``parallel.shard`` on ``torch.distributed``: each rank launches K1, K2 or
K4 on its block, and the loss moments and gradients are summed over ranks
(``shard.make_sharded_train_step``, ``OpticalLoss.unsupervised(...,
mesh=...)``, ``mesh.spawn`` to start the ranks on one host).

On a machine without a GPU, pass ``device="cpu"`` to ``zoo.build``: the
wrappers then run the kernels' plain PyTorch versions.
"""

from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure  # noqa: F401
from torchoptics_tpu_torch.models import catalog, convert, glass, io, zoo  # noqa: F401
from torchoptics_tpu_torch.ops import (  # noqa: F401
    abcd, aiming, fused_asphere, fused_batch, fused_trace, image, metrics, psf, pupil, surfaces,
    trace, wavefront)
from torchoptics_tpu_torch.ops.trace import TraceConfig, TraceResult, trace_rays  # noqa: F401
from torchoptics_tpu_torch import analysis, imaging, loss, optimize, simulator  # noqa: F401
from torchoptics_tpu_torch.loss import OpticalLoss  # noqa: F401
from torchoptics_tpu_torch.optimize import LensOptimizer  # noqa: F401
from torchoptics_tpu_torch.simulator import RaytracedOptics, SimulatorConfig  # noqa: F401

__version__ = "0.1.0"
