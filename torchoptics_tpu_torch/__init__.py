"""torchoptics_tpu_torch: the PyTorch / CUDA port of torchoptics_tpu.

The JAX package ``torchoptics_tpu`` stays the reference; this package
evaluates the same lenses with PyTorch, and its hot kernel (K1 forward, the
fused spherical trace) is hand-written CUDA for Hopper (``csrc/``), built
with ``nvcc`` on first use. It imports neither JAX nor Triton, and builds
nothing at import time.

Quick start::

    import torch
    from torchoptics_tpu_torch import zoo, trace, metrics

    specs, lens = zoo.build("cooke", device="cpu")
    cfg = trace.TraceConfig(mode="circular", n_rays=(8, 8),
                            rel_fields=(0.0, 0.707, 1.0),
                            wavelengths=("C", "d", "F"),
                            n_ray_aiming_iter=1)
    res = trace.trace_rays(specs, lens, cfg)
    rms = metrics.compute_rms2d(res.x, res.y, res.ray_ok)
"""

from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure  # noqa: F401
from torchoptics_tpu_torch.models import convert, glass, zoo  # noqa: F401
from torchoptics_tpu_torch.ops import (  # noqa: F401
    abcd, aiming, fused_trace, metrics, pupil, surfaces, trace)
from torchoptics_tpu_torch.ops.trace import TraceConfig, TraceResult, trace_rays  # noqa: F401
from torchoptics_tpu_torch import simulator  # noqa: F401
from torchoptics_tpu_torch.simulator import SimulatorConfig  # noqa: F401

__version__ = "0.1.0"
