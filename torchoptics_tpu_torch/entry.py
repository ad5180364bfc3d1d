"""The port's main entry point: the flagship lens-design objective.

Twin of ``__graft_entry__.entry()``: the unsupervised lens-design loss of
the 6-element double-Gauss (trace through 11 surfaces + spot RMS +
penalties), here on the fused engine (kernels K1 forward and backward on a
GPU).
"""

from __future__ import annotations

from torchoptics_tpu_torch import simulator as sim_mod
from torchoptics_tpu_torch.models import zoo

CONFIG = sim_mod.SimulatorConfig(
    n_sampled_fields=5,
    n_pupil_rings=16,
    pupil_sampling="circular",
    n_ray_aiming_iter=1,
    trace_engine="fused",
)


def entry(device="cuda"):
    """Return ``(fn, (c, t))`` on ``device`` with ``fn(c, t) -> loss_unsup``,
    differentiable in ``c`` and ``t``."""
    specs, lens = zoo.build("double_gauss", device=device)

    def fn(c, t):
        _, loss_dict = sim_mod.do_ray_tracing(specs, lens.replace(c=c, t=t), CONFIG)
        return loss_dict["loss_unsup"]

    return fn, (lens.c, lens.t)
