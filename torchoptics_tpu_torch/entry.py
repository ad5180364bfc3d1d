"""The port's main entry points: the flagship lens-design objective and the
multi-GPU dry run.

Twins of ``__graft_entry__.entry()`` and ``dryrun_multichip``: the
unsupervised lens-design loss of the 6-element double-Gauss (trace through
11 surfaces + spot RMS + penalties), here on the fused engine (kernels K1
forward and backward on a GPU), and one sharded training step of a
double-Gauss population over a mesh of ranks.
"""

from __future__ import annotations

import dataclasses

import torch

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


def _dryrun_rank(device):
    """One rank of ``dryrun_multichip``: the sharded full-loss step on both
    engines and a sharded trace."""
    import torch.distributed as dist
    from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure
    from torchoptics_tpu_torch.parallel import mesh as mesh_mod
    from torchoptics_tpu_torch.parallel import shard as shard_mod

    n = dist.get_world_size()
    lens_parallel = 2 if n % 2 == 0 and n > 1 else 1
    mesh = mesh_mod.make_mesh(lens_parallel)
    # A tiled population of double-Gauss systems (two per 'lens' block),
    # its glasses moved off the catalog points, where the full loss's glass
    # penalty has a NaN gradient.
    p = zoo.get_prescription("double_gauss")
    n_pop = lens_parallel * 2
    st = Structure(tuple(p["stop_idx"]) * n_pop, tuple(p["sequence"]) * n_pop)
    base_specs, base = zoo.build(p, device=device)
    tile = lambda a: a.repeat(n_pop, 1)
    lens = Lens(st, tile(base.c), tile(base.t), tile(base.nd) + 2e-3, tile(base.v))
    specs = Specs(st, base_specs.epd.repeat(n_pop), base_specs.hfov.repeat(n_pop))
    config = sim_mod.SimulatorConfig(n_sampled_fields=3, n_pupil_rings=4,
                                     pupil_sampling="circular", n_ray_aiming_iter=1,
                                     wavelengths=(459.0, 520.0, 640.0), trace_engine="unroll")

    # Both engines shard over both axes. The full weighted loss in both, so
    # the two losses are one objective.
    losses = {}
    for engine in ("unroll", "fused"):
        cfg = dataclasses.replace(config, trace_engine=engine)
        _, init_fn, step_fn = shard_mod.make_sharded_train_step(
            specs, cfg, mesh, learning_rate=1e-4, use_full_loss=True)
        _, loss, _ = step_fn(init_fn(lens))
        losses[engine] = float(loss)
        if not torch.isfinite(loss):
            raise FloatingPointError(f"dryrun_multichip: the {engine} step's loss is {loss}")
    res = shard_mod.sharded_trace_rays(base_specs, base, config.trace_config(engine="fused"),
                                       mesh)
    if not bool(torch.isfinite(res.y).all()):
        raise FloatingPointError("dryrun_multichip: the sharded trace is not finite")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok: {n} ranks ({dist.get_backend()} on {device}), mesh "
              f"{mesh.shape}; full weighted loss (same objective both engines): "
              f"unroll={losses['unroll']:.6f}, fused_sharded={losses['fused']:.6f}", flush=True)


def dryrun_multichip(n_ranks: int, device="cuda") -> None:
    """Spawn ``n_ranks`` ranks on this host (``parallel.mesh.spawn``: NCCL
    when each has a GPU of its own, gloo when they share one or run on the
    CPU), build a ('lens', 'rays') mesh with ``lens_parallel = 2`` when
    ``n_ranks`` is even, and run one sharded full-loss training step of a
    tiled double-Gauss population on the unroll engine and on the fused one
    (K2 on each rank's block), both over the mesh, and one sharded trace; rank 0
    prints both losses. A rank that fails raises here."""
    from torchoptics_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.spawn(_dryrun_rank, n_ranks, device=device)
