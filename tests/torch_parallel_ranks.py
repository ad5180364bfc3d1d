"""Rank programs and cases for the port's distributed tests.

Imported by ``test_torch_parallel.py`` (CPU ranks, gloo) and
``test_torch_kernels_cuda.py`` (ranks sharing one GPU, gloo); it imports
neither JAX nor the JAX package, so the spawned ranks start without it.
Each rank program writes its results to ``<prefix>_<rank>.npz``.
"""

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from torchoptics_tpu_torch import LensOptimizer, OpticalLoss, simulator, zoo
from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure
from torchoptics_tpu_torch.ops import fused_asphere, fused_batch, trace
from torchoptics_tpu_torch.parallel import mesh as mesh_mod
from torchoptics_tpu_torch.parallel import shard

#: The loss configuration of the population cases: 2 fields x 3 rings (9
#: pupil rays, padded on a 2-wide 'rays' axis) x 3 wavelengths.
POP_KW = dict(n_sampled_fields=2, n_pupil_rings=3, pupil_sampling="circular",
              n_ray_aiming_iter=1, wavelengths=(459.0, 520.0, 640.0), trace_engine="fused")
#: The generator case: OpticalLoss("GAGA") at 3 fields x 4x4 rings.
GEN_KW = dict(n_sampled_fields=3, n_pupil_rings=4)
#: The mesh layouts each group runs: lens_parallel values.
LAYOUTS = {2: (1, 2), 4: (2,)}
N_STEPS = 3


def tiled_population(name, n_pop, perturb=0.0, seed=0, device="cpu"):
    """``n_pop`` copies of a zoo lens, c, t, nd and v each times (1 + perturb
    N(0, 1)) from ``np.random.default_rng(seed)`` in that order: the JAX
    package's ``tests/test_sharding.py`` population, the same numbers."""
    p = zoo.get_prescription(name)
    base_specs, base = zoo.build(name, device="cpu")
    st = Structure(tuple(p["stop_idx"]) * n_pop, tuple(p["sequence"]) * n_pop)
    rng = np.random.default_rng(seed)

    def tile(v):
        a = np.tile(v.numpy()[None, 0], (n_pop, 1))
        if perturb:
            a = a * (1.0 + perturb * rng.standard_normal(a.shape)).astype(np.float32)
        return torch.tensor(a, device=device)

    lens = Lens(st, tile(base.c), tile(base.t), tile(base.nd), tile(base.v))
    specs = Specs(st, base_specs.epd.repeat(n_pop).to(device),
                  base_specs.hfov.repeat(n_pop).to(device))
    return specs, lens


def aspheric_population(n_pop, device="cpu"):
    """The perturbed Cooke population with seeded conics and r^4, r^6
    terms (``zoo.aspheric_population``'s draws)."""
    specs, lens = tiled_population("cooke", n_pop, perturb=0.02, device=device)
    rng = np.random.default_rng(1)
    kappa = rng.uniform(-0.3, 0.1, lens.c.shape)
    asph = rng.uniform(-1, 1, lens.c.shape + (2,)) * np.asarray([1e-5, 1e-8])
    as_tensor = lambda a: torch.tensor(a.astype(np.float32), device=device)
    return specs, lens.replace(kappa=as_tensor(kappa), asph=as_tensor(asph))


def designs(ol, n=3, seed=0):
    """Seeded generator (inputs, outputs) for ``ol``: specs in the
    generator's ranges, outputs at its base design plus noise."""
    rng = np.random.default_rng(seed)
    G, S = ol.numglass, ol.numsurf
    inputs = np.zeros((n, ol.numin), np.float32)
    inputs[:, 0] = rng.uniform(0.15, 0.35, n)
    inputs[:, 1] = rng.uniform(0.2, 0.45, n)
    inputs[:, -3] = 1
    base = np.zeros(ol.numout, np.float32)
    base[2 * G: 2 * G + S - 1] = 0.3
    base[2 * G + S - 1:] = 0.2
    outputs = (base + 0.01 * rng.standard_normal((n, ol.numout))).astype(np.float32)
    return inputs, outputs


def trace_cases(device="cpu"):
    """(label, specs, lens, TraceConfig) of the sharded traces: the 13-ray
    singlet fan (padded on 2 and 4 rays) on both engines, the Cooke."""
    out = []
    for name, cfg in (("singlet", trace.TraceConfig(mode="meridional_uniform", n_rays=(13,),
                                                      rel_fields=(0.0,), wavelengths=("d",))),
                      ("cooke", trace.TraceConfig(mode="circular", n_rays=(4, 6),
                                                    rel_fields=(0.0, 1.0),
                                                    wavelengths=("d",)))):
        specs, lens = zoo.build(name, device=device)
        for engine in ("unroll", "fused"):
            out.append((f"{name}_{engine}", specs, lens, dataclasses.replace(cfg, engine=engine)))
    return out


def loss_cases(device="cpu"):
    """(label, specs, lens, config, full, with_glass) of the sharded
    losses: B = 3 spherical (padded on a 2-wide 'lens' axis), full without
    and with the glass penalty, Lu, Lu on the 'xy' metric; B = 3 aspheric,
    full and Lu."""
    cfg = simulator.SimulatorConfig(**POP_KW)
    cfg_xy = simulator.SimulatorConfig(**dict(POP_KW, spot_metric="xy"))
    sph = tiled_population("cooke", 3, perturb=0.02, device=device)
    asph = aspheric_population(3, device=device)
    return [("sph_full", *sph, cfg, True, False), ("sph_full_glass", *sph, cfg, True, True),
            ("sph_lu", *sph, cfg, False, False),
            ("sph_lu_xy", *sph, cfg_xy, False, False), ("asph_full", *asph, cfg, True, False),
            ("asph_lu", *asph, cfg, False, False)]


def loss_and_grads(specs, lens, config, full, with_glass, mesh=None):
    """(value, {name: gradient}) of the sharded loss on ``mesh`` (the
    single-process fused loss without one); the gradients w.r.t. c, t
    (and kappa, asph on an aspheric lens; g with the glass penalty)."""
    names = [k for k in ("c", "t", "kappa", "asph") if getattr(lens, k) is not None]
    leaves = {k: getattr(lens, k).detach().clone().requires_grad_(True) for k in names}
    lens = lens.replace(**leaves)
    g = catalog = None
    if with_glass:
        from torchoptics_tpu_torch.models import glass
        g = glass.g_from_n_v(lens.flat_nd, lens.flat_v).detach().requires_grad_(True)
        catalog = glass.default_catalog_g(device=lens.device)
        leaves["g"] = g
    if mesh is not None:
        value, _ = shard.sharded_fused_losses(specs, lens, config, mesh, g=g, catalog_g=catalog,
                                              full=full)
    elif full:
        value, _ = fused_batch.batched_compute_losses_fused(specs, lens, config, g=g,
                                                            catalog_g=catalog)
    else:
        value, _ = fused_batch.batched_unsupervised_loss(specs, lens, config)
    # A rank's share of the glass term's gradient may be none.
    grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    return float(value.detach()), {k: (torch.zeros_like(leaf) if gr is None else gr).cpu().numpy()
                          for (k, leaf), gr in zip(leaves.items(), grads)}


def train_population(device="cpu"):
    return tiled_population("cooke", 4, perturb=0.02, device=device)


def mixed_train_population(device="cpu"):
    """A Cooke, a double-Gauss and a Tessar (``zoo.mixed_population``),
    padded to the widest sequence, their glass moved off the catalog (where
    the glass penalty's gradient is NaN): nd x 1.01, v x 0.99."""
    specs, lens = zoo.mixed_population(3, names=("cooke", "double_gauss", "tessar"),
                                       device=device)
    return specs, lens.replace(nd=lens.nd * 1.01, v=lens.v * 0.99)


#: The unroll engine's full-loss steps on the layouts with a 'rays' axis:
#: case -> (population, SimulatorConfig.double_precision).
UNROLL_CASES = {"mixed": (mixed_train_population, False), "f64": (train_population, True)}
#: The unroll engine's (lens_parallel, full loss) runs of each group: the
#: full loss over 'lens' alone, the full loss and Lu with a 'rays' axis.
UNROLL_LAYOUTS = {2: ((2, True), (1, True), (1, False)), 4: ((4, True), (2, True), (2, False))}


def train_steps(config, mesh=None, device="cpu", use_full_loss=True,
                population=train_population):
    """(params after N_STEPS steps, last total) of the sharded train step on
    ``mesh`` (single-process ``LensOptimizer`` steps without one)."""
    specs, lens = population(device)
    if mesh is None:
        opt = LensOptimizer(specs, config, learning_rate=1e-3, use_full_loss=use_full_loss)
        state, step = opt.init(lens), opt.step
    else:
        _, init_fn, step = shard.make_sharded_train_step(specs, config, mesh, learning_rate=1e-3,
                                                         use_full_loss=use_full_loss)
        state = init_fn(lens)
    for _ in range(N_STEPS):
        state, total, _ = step(state)
    return {k: v.detach().cpu().numpy() for k, v in state.params.items()}, float(total)


def generator_loss(mesh=None, device="cpu"):
    """(mean Lu, rms, penalty, d Lu/d outputs) of OpticalLoss('GAGA', 'xy')
    on the fused engine, sharded over ``mesh`` when given."""
    ol = OpticalLoss("GAGA", spot_metric="xy", **GEN_KW)
    inputs, outputs = designs(ol)
    outputs = torch.tensor(outputs, device=device).requires_grad_(True)
    lu, rms, pen = ol.unsupervised(torch.tensor(inputs, device=device), outputs, stop_idx=1,
                                   engine="fused", mesh=mesh)
    (grad,) = torch.autograd.grad(lu, outputs)
    return np.asarray([float(v.detach()) for v in (lu, rms, pen)]), grad.cpu().numpy()


def _tag(n, lp):
    return f"{lp}x{n // lp}"


def cpu_rank(device, prefix):
    """Every CPU case on each of this group's layouts."""
    n = dist.get_world_size()
    out = {}
    # The collective's backward: the replicated cotangent passes through.
    x = torch.ones(3, requires_grad=True)
    torch.sum(mesh_mod.all_reduce_sum(x)).backward()
    out["all_reduce_grad"] = x.grad.numpy()
    out["all_reduce_value"] = mesh_mod.all_reduce_sum(torch.full((2,), dist.get_rank() + 1.0)
                                                      ).numpy()
    for lp in LAYOUTS[n]:
        mesh = mesh_mod.make_mesh(lp)
        tag = _tag(n, lp)
        out[f"{tag}/coords"] = np.asarray([mesh.coords["lens"], mesh.coords["rays"]])
        out[f"{tag}/shape"] = np.asarray([mesh.shape["lens"], mesh.shape["rays"]])
        blocks = mesh_mod.ray_sharding(mesh, 4, 10)
        out[f"{tag}/blocks"] = np.asarray([blocks[0].start, blocks[0].stop, blocks[2].start,
                                           blocks[2].stop])
        assert blocks[1] == blocks[3] == mesh_mod.replicated(mesh) == slice(None)
        for label, specs, lens, cfg in trace_cases():
            res = shard.sharded_trace_rays(specs, lens, cfg, mesh)
            for field in ("x", "y", "ray_ok", "ray_backward"):
                out[f"{tag}/trace/{label}/{field}"] = getattr(res, field).numpy()
        specs, lens = zoo.build("cooke", device="cpu")
        res = trace.trace_rays(specs, lens, trace.TraceConfig(
            mode="circular", n_rays=(4, 4), rel_fields=(0.0, 1.0), wavelengths=("d",)))
        p = res.y.shape[2]
        p_pad = mesh_mod.pad_to_multiple(p, mesh.shape["rays"])
        pad = lambda a: torch.cat((a, torch.zeros_like(a[:, :, :p_pad - p])), dim=2)
        block = mesh_mod.axis_block(mesh, "rays", p_pad)
        out[f"{tag}/mean_rms"] = shard.shard_map_mean_rms(
            *(pad(a)[:, :, block] for a in (res.x, res.y, res.ray_ok)), mesh, p).numpy()
        for label, specs, lens, cfg, full, glass in loss_cases():
            value, grads = loss_and_grads(specs, lens, cfg, full, glass, mesh)
            out[f"{tag}/loss/{label}/value"] = np.asarray(value)
            for k, gr in grads.items():
                out[f"{tag}/loss/{label}/d{k}"] = gr
        params, total = train_steps(simulator.SimulatorConfig(**POP_KW), mesh)
        out[f"{tag}/train/fused/total"] = np.asarray(total)
        for k, v in params.items():
            out[f"{tag}/train/fused/{k}"] = v
        lu, grad = generator_loss(mesh)
        out[f"{tag}/generator/loss"], out[f"{tag}/generator/grad"] = lu, grad
    # The unroll engine: UNROLL_LAYOUTS on the Cooke population, and the
    # UNROLL_CASES on the layout with a 'rays' axis and the most ranks on it.
    unroll = simulator.SimulatorConfig(**dict(POP_KW, trace_engine="unroll"))
    runs = [(f"{_tag(n, lp)}/{'full' if full else 'lu'}", lp, full, unroll, train_population)
            for lp, full in UNROLL_LAYOUTS[n]]
    runs += [(f"{_tag(n, n // 2)}/full/{case}", n // 2, True,
              dataclasses.replace(unroll, double_precision=f64), population)
             for case, (population, f64) in UNROLL_CASES.items()]
    for key, lp, full, cfg, population in runs:
        params, total = train_steps(cfg, mesh_mod.make_mesh(lp), use_full_loss=full,
                                    population=population)
        out[f"unroll/{key}/total"] = np.asarray(total)
        for k, v in params.items():
            out[f"unroll/{key}/{k}"] = v
    np.savez(f"{prefix}_{dist.get_rank()}.npz", **out)


def cuda_rank(device, prefix, n_systems):
    """Sharded K2 and K4 losses (values and per-rank gradients) of
    ``n_systems``-system populations at 2 fields x 3 rings x 3 wavelengths
    on this rank's GPU, on the (1 x n) and (n x 1) layouts, with this rank's
    launches of each kernel."""
    cfg = simulator.SimulatorConfig(**POP_KW)
    cases = (("k2", tiled_population("cooke", n_systems, 0.02, 0, device)),
             ("k4", aspheric_population(n_systems, device)))
    out = {}
    for (label, (specs, lens)), lp, full in itertools.product(
            cases, (1, dist.get_world_size()), (True, False)):
        mesh = mesh_mod.make_mesh(lp)
        fused_batch.K2_FWD_LAUNCHES = fused_batch.K2_BWD_LAUNCHES = 0
        fused_asphere.K4_FWD_LAUNCHES = fused_asphere.K4_BWD_LAUNCHES = 0
        value, grads = loss_and_grads(specs, lens, cfg, full, False, mesh)
        tag = f"{label}/{lp}/{'full' if full else 'lu'}"
        out[f"{tag}/value"] = np.asarray(value)
        out[f"{tag}/launches"] = np.asarray(
            [fused_batch.K2_FWD_LAUNCHES, fused_batch.K2_BWD_LAUNCHES,
             fused_asphere.K4_FWD_LAUNCHES, fused_asphere.K4_BWD_LAUNCHES])
        for k, gr in grads.items():
            out[f"{tag}/d{k}"] = gr
    np.savez(f"{prefix}_{dist.get_rank()}.npz", **out)
