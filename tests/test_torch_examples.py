"""Port parity for the examples (``torchoptics_tpu_torch/examples/``): each
example's ``main`` on the CPU at tiny flags prints the JAX example's lines
and refuses to run without a GPU unless asked for the CPU; the pieces of
``refine_flagship``, ``train_generator``, ``flagship_report`` and
``optimize_lens`` that compute held against the JAX package on the same
numbers; no example imports JAX.

The JAX sides run eagerly on its unroll engine (``refine_flagship``,
``flagship_report``) or jitted with a fast compile (``train_generator``'s
value and gradient, as ``test_torch_loss.py`` runs it).

Bars: ``refine_flagship``'s loss 1e-5 relative and d/d(params) within 2e-4
of each leaf's largest magnitude; the generator network's forward 1e-6, its
batch Lu 1e-5 relative and d/d(weights) within 1e-4 of each leaf's largest
magnitude (``test_torch_loss.py``'s); ``flagship_report``'s per-field spot
RMS within the coordinate bar 5e-6 mm, the OPD within JAX's own 5e-5 mm and
the Strehl ratios within that OPD gap's bound 2 (2 pi / lambda) gap + 1e-5;
the saved prescription's c and t 1e-6.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu_torch import zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import trace as trace_mod
from torchoptics_tpu_torch.ops import wavefront as wf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
EXAMPLES = ("optimize_lens", "refine_flagship", "train_generator", "optimize_through_image",
            "optimize_wavefront", "simulate_aberrations", "flagship_report", "aberration_report")


def _example(name):
    return importlib.import_module(f"torchoptics_tpu_torch.examples.{name}")


def _jax_example(name):
    """The JAX package's example module ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(name, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example(name).main(argv)
    return buf.getvalue()


def _cases(tmp):
    """{example: (tiny flags, the JAX example's line labels it must print)}."""
    design = os.path.join(tmp, "design.json")
    p = zoo.get_prescription("cooke")
    with open(design, "w") as f:
        json.dump({k: p[k] for k in ("c", "t", "nd", "v")}, f)
    return {
        "optimize_lens": (["--steps", "2", "--fields", "2", "--rings", "3", "--log-every", "1"],
                          ["step     0: total=", "step     1: total=", "loss_unsup=",
                           "2 steps in"]),
        "refine_flagship": (["--lens", "cooke", "--pop", "2", "--steps", "1", "--polish-steps",
                             "1", "--save", os.path.join(tmp, "out.json")],
                            ["  step 0: loss=", "best member", "(member 0 = unperturbed:",
                             "FINAL rms(y)=", "FINAL metrics: rms_y=", "rms_xy_edge=",
                             "saved"]),
        "train_generator": (["--steps", "2", "--batch", "4", "--eval-designs", "4"],
                            ["training GA generator: batch=4, metric=y", "step     0: loss=",
                             "final loss", "design-quality distribution (4 specs, "
                             "catalog-snapped glass", "raw (unsnapped) glass", "rms_y  p10",
                             "rms_xy  p10"]),
        "optimize_through_image": (["--steps", "1", "--image-size", "32", "--psf", "9",
                                    "--fields", "3", "--rings", "4"],
                                   ["start: psnr=", "step    0: psnr=", "1 steps in",
                                    "final: psnr=", "recovered"]),
        "optimize_wavefront": (["--steps", "2", "--grid", "5"],
                               ["cooke +0.4mm defocus: initial wavefront RMS", "Strehl [",
                                "  step    2: wavefront RMS", "final: wavefront RMS"]),
        "simulate_aberrations": (["--image-size", "32", "--fields", "3", "--rings", "4",
                                  "--psf-source", "diffraction", "--diffraction-grid", "16",
                                  "--output", os.path.join(tmp, "out.png")],
                                 ["diffraction sampling: P-V", "rendered 32x32 image: PSNR=",
                                  "wrote"]),
        "flagship_report": (["--lens", "cooke", "--fields", "0,1.0", "--design", design],
                            [f"lens=cooke design={design} efl=", "(solved vignetting)",
                             "rms_y mm", "strehl(d)", "rel_illum", "  mean",
                             "(wfe/strehl at d-line"]),
        "aberration_report": (["--fields", "0,1.0"],
                              ["== Seidel per-surface contributions (cooke) ==", " sum  ",
                               "== Field curves", "Seidel full-field prediction",
                               "LSA marginal (real rays)", "== Ray-fan extrema",
                               "== Through-focus MTF"]),
    }


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_jax_labels(name, tmp_path):
    """``main([..., "--device", "cpu"])`` prints the JAX example's lines;
    without ``--device cpu`` it raises on a machine without a GPU."""
    argv, labels = _cases(str(tmp_path))[name]
    text = _run(name, argv + ["--device", "cpu"])
    for label in labels:
        assert label in text, (label, text)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            _example(name).main(argv)


REFINE_CFG = dict(mode="circular", n_rays=(3, 3), rel_fields=(0.0, 0.45, 0.707, 0.88, 1.0),
                  wavelengths=(459.0, 520.0, 640.0), n_ray_aiming_iter=1)
REFINE_HINGES = dict(min_t=0.8, min_image=12.0, max_track=110.0)


@pytest.fixture(scope="module")
def refine_population():
    """The example's starting population of 2 Cooke designs, its
    normalized parameters and EFL target; JAX's loss (the example's
    ``loss_fn`` on JAX's unroll engine) and d/d(params), eagerly."""
    from torchoptics_tpu import metrics as jmetrics
    from torchoptics_tpu import optimize as jopt
    from torchoptics_tpu import trace as jtrace
    from torchoptics_tpu.models import glass as jglass
    from torchoptics_tpu.models.structure import Lens as JLens, Specs as JSpecs
    from torchoptics_tpu.models.structure import Structure as JStructure

    rf = _example("refine_flagship")
    specs, lens = rf.starting_population("cooke", 2, False, device="cpu")
    st = JStructure(lens.structure.stop_idx, lens.structure.sequence)
    jlens = JLens(st, *(getattr(lens, k).numpy() for k in ("c", "t", "nd", "v")))
    jspecs = JSpecs(st, specs.epd.numpy(), specs.hfov.numpy())
    efl_target = float(zoo.build("cooke", device="cpu")[1].efl[0])
    cfg = jtrace.TraceConfig(**REFINE_CFG)
    catalog_g = jglass.default_catalog_g()
    h = REFINE_HINGES

    def loss_fn(params):
        l = jopt.lens_from_normalized(st, params, catalog_g, add_bfl=True, qc_variables=True)
        l = l.scale(efl_target / l.efl)
        res = jtrace.trace_rays(jspecs, l, cfg, aggregate=jtrace.AGG_TORCH)
        rms = jmetrics.compute_spot_rms(res.x, res.y, res.ray_ok, "y")
        nseq = jnp.asarray(st.n_surfaces, rms.dtype)
        Q = (jnp.sum(res.stacks["theta_norm"], 0) + jnp.sum(res.stacks["theta_prime_norm"], 0)
             + jnp.sum(res.stacks["z_RELU"], 0))
        sumQ = jnp.sum(Q, axis=(1, 2, 3)) / nseq
        tmin_pen = jnp.sum(jnp.maximum(h["min_t"] - l.t, 0.0) ** 2, axis=1)
        bfl_pen = jnp.maximum(h["min_image"] - l.t[:, -1], 0.0) ** 2
        track_pen = jnp.maximum(jnp.sum(l.t, axis=1) - h["max_track"], 0.0) ** 2
        return jnp.mean(rms + 1e-4 * sumQ + tmin_pen + 0.1 * bfl_pen + 0.01 * track_pen)

    params = jopt.get_normalized_lens_variables(jlens, add_bfl=True)
    value, grads = jax.value_and_grad(loss_fn)(params)
    return dict(specs=specs, structure=lens.structure, efl_target=efl_target,
                params={k: np.asarray(v) for k, v in params.items()}, value=float(value),
                grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("engine", ["unroll", "fused"])
def test_refine_flagship_loss_matches_jax(refine_population, engine):
    """``refine_flagship``'s objective and d/d(c, t, g) on a population of 2
    at 3 x 3 rings, on JAX's parameters: the unroll engine's stacks and the
    fused engine's per-system rms and ΣQ (K2's plain version here)."""
    from torchoptics_tpu_torch.models import glass
    rf = _example("refine_flagship")
    r = refine_population
    params = {k: torch.tensor(v, requires_grad=True) for k, v in r["params"].items()}
    lens = rf.build_lens(r["structure"], params, glass.default_catalog_g(device="cpu"),
                         r["efl_target"])
    cfg = trace_mod.TraceConfig(**REFINE_CFG, engine=engine)
    value = rf.population_loss(r["specs"], lens, cfg, "y", **REFINE_HINGES)
    grads = torch.autograd.grad(value, list(params.values()))
    np.testing.assert_allclose(float(value.detach()), r["value"], rtol=1e-5)
    for k, got in zip(params, grads):
        want = r["grads"][k]
        assert np.abs(got.numpy() - want).max() <= 2e-4 * np.abs(want).max(), k


def test_train_generator_matches_jax():
    """JAX's ``init_mlp`` parameters and spec draws carried across: the
    network's forward pass, and the batch Lu with d/d(weights) against
    JAX's ``batch_loss`` on its xla engine."""
    from torchoptics_tpu import loss as jloss
    from torchoptics_tpu_torch import OpticalLoss
    from torchoptics_tpu_torch.models import generator
    jtg = _jax_example("train_generator")
    kw = dict(n_sampled_fields=4, n_pupil_rings=6, spot_metric="y", penalty_rate=0.2)
    jol, ol = jloss.OpticalLoss("GA", **kw), OpticalLoss("GA", **kw)
    key = jax.random.PRNGKey(0)
    key, knet, kspec = jax.random.split(key, 3)
    jnet = jtg.init_mlp(knet, (2, 64, 64, jol.numout))
    kepd, khfov = jax.random.split(kspec)
    inputs = jnp.stack([jax.random.uniform(kepd, (8,), minval=0.15, maxval=0.35),
                        jax.random.uniform(khfov, (8,), minval=0.2, maxval=0.45)], axis=1)
    base = generator.base_design(ol, device="cpu")

    def batch_loss(net_params):
        outputs = jtg.mlp(net_params, inputs) * 0.1 + jnp.asarray(base.numpy())
        return jol.unsupervised(inputs, outputs, stop_idx=1, engine="xla")[0]

    lowered = jax.jit(jax.value_and_grad(batch_loss)).lower(jnet)
    value, jgrads = lowered.compile(compiler_options=FAST_COMPILE)(jnet)

    net = convert.mlp_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnet), device="cpu")
    x = torch.tensor(np.asarray(inputs))
    np.testing.assert_allclose(net(x).detach().numpy(), np.asarray(jtg.mlp(jnet, inputs)),
                               rtol=0, atol=1e-6)
    loss = generator.batch_loss(ol, net, x, base, "unroll")
    grads = torch.autograd.grad(loss, list(net.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-5)
    want = [np.asarray(layer["w"]) for layer in jgrads] + [np.asarray(layer["b"])
                                                          for layer in jgrads]
    for i, (got, w) in enumerate(zip(grads, want)):
        assert np.abs(got.numpy() - w).max() <= 1e-4 * np.abs(w).max(), i


def test_flagship_report_per_field_metrics_match_jax():
    """``rms_y_per_field`` and the per-field Strehl ratios on the Cooke at a
    6 x 6 pupil (the trace's rings and the wavefront's grid) against the
    JAX example's expressions."""
    from torchoptics_tpu import trace as jtrace
    from torchoptics_tpu import zoo as jzoo
    from torchoptics_tpu.ops import wavefront as jwf
    fr = _example("flagship_report")
    fields = (0.0, 0.707, 1.0)
    kw = dict(mode="circular", n_rays=(6, 6), rel_fields=fields, n_ray_aiming_iter=1)
    specs, lens = zoo.build("cooke", device="cpu")
    jspecs, jlens = jzoo.build("cooke")
    cfg = dict(kw, wavelengths=(459.0, 520.0, 640.0))
    wcfg = dict(kw, wavelengths=(520.0,))
    xy, in_pupil = fr.pupil_grid(6, device="cpu")
    with torch.no_grad():
        res = trace_mod.trace_rays(specs, lens, trace_mod.TraceConfig(**cfg))
        rms = fr.rms_y_per_field(res.y, res.ray_ok).numpy()
        opd_out = wf.opd_map(specs, lens, trace_mod.TraceConfig(**wcfg), xy=xy)
        strehl, _ = fr.strehl_per_field(opd_out, xy, in_pupil)

    jres = jtrace.trace_rays(jspecs, jlens, jtrace.TraceConfig(**cfg))
    B, F, P, W = jres.ray_ok.shape
    y = jnp.broadcast_to(jres.y, (B, F, P, W))
    ymean = jnp.mean(jnp.mean(y, axis=2), axis=-1)
    ss = jnp.sum(jnp.where(jres.ray_ok, (y - ymean[:, :, None, None]) ** 2, 0.0), axis=(2, 3))
    jrms = np.asarray(jnp.where(ss > 0, jnp.sqrt(jnp.where(ss > 0, ss, 1.0) / (P * W)), 0.0))
    np.testing.assert_allclose(rms, jrms, rtol=0, atol=5e-6)

    jxy = tuple(jnp.asarray(a.numpy()) for a in xy)
    m = jwf.opd_map(jspecs, jlens, jtrace.TraceConfig(**wcfg), xy=jxy)
    xg, yg = jxy[0][0, 0, :, 0], jxy[1][0, 0, :, 0]
    lam = 520e-6
    opd_gap = 0.0
    for fi in range(len(fields)):
        opd = m["opd"][0, fi, :, 0]
        okw = m["ok"][0, fi, :, 0] & jnp.asarray(in_pupil.numpy())
        np.testing.assert_array_equal(np.asarray(okw),
                                      (opd_out["ok"][0, fi, :, 0] & in_pupil).numpy())
        opd_gap = max(opd_gap, float(np.abs(np.where(okw, np.asarray(opd)
                                                     - opd_out["opd"][0, fi, :, 0].numpy(),
                                                     0.0)).max()))
        cz = jwf.zernike_fit(opd, xg, yg, okw, j_max=3)
        resid = jnp.where(okw, opd - jwf.zernike_basis(3, xg, yg) @ cz, 0.0)
        want = float(jwf.strehl_ratio(resid, okw, lam))
        assert abs(float(strehl[fi]) - want) <= 2 * 2 * np.pi / lam * opd_gap + 1e-5, fi
    assert opd_gap <= 5e-5


def test_optimize_lens_yaml_loads_in_jax(tmp_path):
    """``optimize_lens --save-yaml`` writes a prescription that the JAX
    package's ``models/io.load_lens`` reads to the same c and t;
    ``--checkpoint`` writes the JAX package's checkpoint layout."""
    from torchoptics_tpu.models import io as jio
    from torchoptics_tpu.utils import checkpoint as jckpt
    from torchoptics_tpu_torch.models import io as tio
    path, ckpt = str(tmp_path / "out.yml"), str(tmp_path / "opt.npz")
    _run("optimize_lens", ["--device", "cpu", "--steps", "1", "--fields", "2", "--rings", "3",
                           "--save-yaml", path, "--checkpoint", ckpt])
    _, lens = tio.load_lens(path, device="cpu")
    _, jlens = jio.load_lens(path)
    for k in ("c", "t"):
        np.testing.assert_allclose(np.asarray(getattr(jlens, k)), getattr(lens, k).numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert jckpt.load_metadata(ckpt) == {"steps": 1, "lr": 3e-4}


def test_examples_import_without_jax():
    """Every example module imports, and its ``--help`` runs, with ``jax``,
    ``optax`` and ``torchoptics_tpu`` blocked; none of them is imported."""
    names = ",".join(repr(n) for n in EXAMPLES + ("tolerance_analysis",))
    script = (
        "import sys, importlib, contextlib, io\n"
        "for m in ('jax', 'optax', 'torchoptics_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for name in ({names}):\n"
        "    mod = importlib.import_module('torchoptics_tpu_torch.examples.' + name)\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(io.StringIO()):\n"
        "            mod.main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, name\n"
        "assert all(sys.modules[m] is None for m in ('jax', 'optax', 'torchoptics_tpu'))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
