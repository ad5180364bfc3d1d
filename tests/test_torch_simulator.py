"""Port parity for the whole slice: the unsupervised lens-design loss Lu of
the double-Gauss through the port's ``do_ray_tracing`` (fused and unroll
engines) and ``spot_rms_fused``, against the JAX package's ``do_ray_tracing``
(unroll, and pallas in interpret mode) and ``spot_rms_fused``.

Tolerances: ``loss_unsup`` and ``penalty`` rtol 1e-5; the spot RMS rtol 2e-4.
The RMS is a difference of image heights of ~7 mm (float32 ulp ~5e-7 mm)
about a 3.4e-3 mm spot, so its cancellation leaves ~1e-4 relative between
any two float32 engines (JAX's own unroll and pallas engines differ by 4e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.ops import pallas_trace as jpt
from torchoptics_tpu_torch import simulator, zoo
from torchoptics_tpu_torch.models import convert
from torchoptics_tpu_torch.ops import fused_trace

CONFIG = dict(n_sampled_fields=3, n_pupil_rings=8, pupil_sampling="circular",
              n_ray_aiming_iter=1)
RTOL = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's loss dicts (unroll engine, pallas engine in interpret mode) and
    its fused spot RMS, as floats."""
    jspecs, jlens = jzoo.build("double_gauss")
    cfg = jsim.SimulatorConfig(**CONFIG)
    as_float = lambda d: {k: float(v) for k, v in d.items()}
    out = dict(specs=jspecs, lens=jlens)
    out["unroll"] = as_float(jsim.do_ray_tracing(jspecs, jlens, cfg)[1])
    with pltpu.force_tpu_interpret_mode():
        out["pallas"] = as_float(jsim.do_ray_tracing(
            jspecs, jlens, dataclasses.replace(cfg, trace_engine="pallas"))[1])
        out["spot_rms"] = float(jpt.spot_rms_fused(jspecs, jlens, cfg.trace_config()))
    return out


@pytest.fixture(scope="module")
def port_lens(jax_side):
    jspecs, jlens = jax_side["specs"], jax_side["lens"]
    st = jlens.structure
    specs = convert.specs_from_numpy(st.stop_idx, st.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    lens = convert.lens_from_numpy(st.stop_idx, st.sequence, np.asarray(jlens.c),
                                   np.asarray(jlens.t), np.asarray(jlens.nd),
                                   np.asarray(jlens.v), device="cpu")
    return specs, lens


def _assert_loss_close(got, want):
    for key, rtol in RTOL.items():
        np.testing.assert_allclose(float(got[key]), want[key], rtol=rtol, err_msg=key)


@pytest.mark.parametrize("engine", ["fused", "unroll"])
@pytest.mark.parametrize("jax_engine", ["unroll", "pallas"])
def test_do_ray_tracing_matches_jax(engine, jax_engine, jax_side, port_lens):
    specs, lens = port_lens
    cfg = simulator.SimulatorConfig(**CONFIG, trace_engine=engine)
    res, loss = simulator.do_ray_tracing(specs, lens, cfg)
    _assert_loss_close(loss, jax_side[jax_engine])
    assert res.x.shape == (1, 3, 64, 3)
    assert (res.stacks is None) == (engine == "fused")


def test_spot_rms_fused_matches_jax(jax_side, port_lens):
    specs, lens = port_lens
    cfg = simulator.SimulatorConfig(**CONFIG).trace_config()
    rms = fused_trace.spot_rms_fused(specs, lens, cfg)
    np.testing.assert_allclose(float(rms), jax_side["spot_rms"], rtol=RTOL["rms"])
    np.testing.assert_allclose(float(rms), jax_side["unroll"]["rms"], rtol=RTOL["rms"])


def test_unsupervised_loss_fused_matches_do_ray_tracing(port_lens):
    specs, lens = port_lens
    cfg = simulator.SimulatorConfig(**CONFIG, trace_engine="fused")
    lu, loss = fused_trace.unsupervised_loss_fused(specs, lens, cfg)
    _, want = simulator.do_ray_tracing(specs, lens, cfg)
    for key in RTOL:
        np.testing.assert_allclose(float(loss[key]), float(want[key]), rtol=1e-6, err_msg=key)
    assert float(simulator.unsupervised_loss(specs, lens, cfg)) == float(want["loss_unsup"])
    assert float(lu) == float(loss["loss_unsup"])


def test_fused_loss_gradient_on_cpu_matches_unroll(port_lens):
    """On CPU tensors the fused path runs the plain versions of K1 forward
    and backward (the hand adjoint); its d Lu/d(c, t) equals the unroll
    engine's autograd gradient."""
    specs, lens = port_lens

    def grads(engine):
        c = lens.c.clone().requires_grad_(True)
        t = lens.t.clone().requires_grad_(True)
        cfg = simulator.SimulatorConfig(**CONFIG, trace_engine=engine)
        loss = simulator.unsupervised_loss(specs, lens.replace(c=c, t=t), cfg)
        return torch.autograd.grad(loss, (c, t))

    for g_f, g_u in zip(grads("fused"), grads("unroll")):
        assert bool(torch.isfinite(g_f).all())
        scale = float(g_u.abs().max())
        np.testing.assert_allclose(g_f.numpy() / scale, g_u.numpy() / scale, atol=1e-5)


def test_entry_evaluates_the_flagship():
    from torchoptics_tpu_torch.entry import CONFIG as ENTRY_CONFIG, entry
    assert ENTRY_CONFIG.trace_engine == "fused" and ENTRY_CONFIG.n_pupil_rings == 16
    fn, (c, t) = entry("cpu")
    with torch.no_grad():
        lu = fn(c, t)
        specs, lens = zoo.build("double_gauss", device="cpu")
        want = simulator.unsupervised_loss(
            specs, lens, dataclasses.replace(ENTRY_CONFIG, trace_engine="unroll"))
    assert lu.shape == () and bool(torch.isfinite(lu))
    np.testing.assert_allclose(float(lu), float(want), rtol=1e-5)


def test_fused_engine_refuses_batches_and_aspheres(port_lens):
    """Custom aggregates still raise on the fused engine; one aspheric system
    runs (on kernel K3) and gives the pure-torch engine's loss; a population
    runs (on kernel K2): two copies of the flagship give the flagship's
    loss; a population of aspheres runs (on kernel K4; it raised before K4
    was ported): two copies of the aspherized flagship give K3's loss and
    outputs."""
    specs, lens = port_lens
    cfg = simulator.SimulatorConfig(**CONFIG, trace_engine="fused")
    pair = np.array([0, 0])
    res, loss = simulator.do_ray_tracing(specs[pair], lens[pair], cfg)
    _, want = simulator.do_ray_tracing(specs, lens, cfg)
    assert res.x.shape == (2, 3, 64, 3) and torch.equal(res.x[0], res.x[1])
    for key in RTOL:
        np.testing.assert_allclose(float(loss[key]), float(want[key]), rtol=1e-6, err_msg=key)
    asph_specs, asph_lens = zoo.build("double_gauss_asph", device="cpu")
    _, asph_loss = simulator.do_ray_tracing(asph_specs, asph_lens, cfg)
    _, asph_want = simulator.do_ray_tracing(asph_specs, asph_lens,
                                            dataclasses.replace(cfg, trace_engine="unroll"))
    for key in RTOL:
        np.testing.assert_allclose(float(asph_loss[key]), float(asph_want[key]), rtol=RTOL[key],
                                   err_msg=key)
    asph_res, asph_pair = simulator.do_ray_tracing(asph_specs[pair], asph_lens[pair], cfg)
    asph_one, _ = simulator.do_ray_tracing(asph_specs, asph_lens, cfg)
    assert asph_res.x.shape == (2, 3, 64, 3)
    for a, b in zip(asph_res[:6], asph_one[:6]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[0])
    for key in RTOL:
        np.testing.assert_allclose(float(asph_pair[key]), float(asph_loss[key]), rtol=1e-6,
                                   err_msg=key)
    with pytest.raises(NotImplementedError, match="aggregate"):
        simulator.do_ray_tracing(specs, lens, cfg, aggregate=("z",))


def test_simulator_config_matches_jax_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(simulator.SimulatorConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jsim.SimulatorConfig)}
    assert ours == theirs
    cfg = simulator.SimulatorConfig(n_sampled_fields=5)
    assert cfg.rel_fields() == jsim.SimulatorConfig(n_sampled_fields=5).rel_fields()
    assert cfg.loss_weights == jsim.SimulatorConfig().loss_weights
