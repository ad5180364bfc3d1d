"""Port parity for the generator-training loss bridge (``loss.py``):
the sequence codec, ``t_converter``, ``OpticalLoss.build_batch``,
``unsupervised`` on both engines and ``supervised``, against
``torchoptics_tpu.loss`` on the same numbers.

Designs are generator outputs as ``examples/train_generator.py`` starts
them (the base offsets plus seeded noise), for the lens type GAGA at 3
fields x 4x4 circular pupil x 3 wavelengths, ray aiming on. The JAX side is
jitted (eager JAX compiles every primitive, eager Pallas every call) and
compiled on threads; its Pallas engine runs in interpret mode.

Bars: decoded lenses 1e-5 relative; loss values 1e-5 relative (rms 2e-4, as
``test_torch_simulator``); d/d(outputs) within 1e-4 of its largest magnitude
plus JAX's own xla-vs-Pallas distance (at the theta clip edge ``jnp.clip``
passes half the gradient, the hand adjoints and the port's engines none).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torchoptics_tpu import loss as jloss
from torchoptics_tpu_torch import OpticalLoss
from torchoptics_tpu_torch import loss as loss_mod

KW = dict(n_sampled_fields=3, n_pupil_rings=4)
B = 3
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
GRAD_BAR = 1e-4


def _designs(ol, has_stop_vars=False, seed=0):
    """Seeded (inputs, outputs): specs in the generator's ranges, outputs at
    the generator's base design plus noise."""
    rng = np.random.default_rng(seed)
    G, S = ol.numglass, ol.numsurf
    inputs = np.zeros((B, ol.numin), np.float32)
    inputs[:, 0] = rng.uniform(0.15, 0.35, B)
    inputs[:, 1] = rng.uniform(0.2, 0.45, B)
    inputs[:, -3] = 1
    if has_stop_vars:
        inputs[:, -3] = 2
        inputs[:, -2] = rng.uniform(-0.05, 0.05, B)
        inputs[:, -1] = rng.uniform(0.05, 0.1, B)
    base = np.zeros(ol.numout, np.float32)
    base[2 * G: 2 * G + S - 1] = 0.3
    base[2 * G + S - 1:] = 0.2
    outputs = (base + 0.01 * rng.standard_normal((B, ol.numout))).astype(np.float32)
    return inputs, outputs


@pytest.fixture(scope="module")
def jax_side():
    """JAX's unsupervised loss (mean Lu, rms, penalty) and d Lu/d(outputs),
    on its xla and Pallas engines."""
    jol = jloss.OpticalLoss("GAGA", spot_metric="xy", **KW)
    inputs, outputs = _designs(jol)

    def program(engine):
        def run(o):
            (lu, (rms, pen)), grad = jax.value_and_grad(
                lambda o: (lambda r: (r[0], r[1:]))(jol.unsupervised(
                    jnp.asarray(inputs), o, stop_idx=1, engine=engine)), has_aux=True)(o)
            return lu, rms, pen, grad
        return run
    lowered = {}
    lowered["xla"] = jax.jit(program("xla")).lower(outputs)
    with pltpu.force_tpu_interpret_mode():
        lowered["pallas"] = jax.jit(program("pallas")).lower(outputs)
    with ThreadPoolExecutor(2) as pool:
        compiled = {k: pool.submit(low.compile, compiler_options=FAST_COMPILE)
                    for k, low in lowered.items()}
        compiled = {k: c.result() for k, c in compiled.items()}
    out = dict(inputs=inputs, outputs=outputs)
    for engine, fn in compiled.items():
        lu, rms, pen, grad = fn(outputs)
        out[engine] = dict(loss=(float(lu), float(rms), float(pen)), grad=np.asarray(grad))
    return out


def test_sequence_codec_and_t_converter_match_jax():
    for seq in ("GA", "GGA", "GAGA", "GAGGAAGGAGA"):
        assert loss_mod.sequence_encoder(seq) == jloss.sequence_encoder(seq)
        assert loss_mod.sequence_decoder(loss_mod.sequence_encoder(seq)) == seq
    with pytest.raises(ValueError, match="start with 'G'"):
        loss_mod.sequence_encoder("AGA")
    t = np.arange(1.0, 5.0, dtype=np.float32)
    for stop, seq in ((2, "GAGA"), (1, "GAGA"), (3, "GGAA")):
        got = loss_mod.t_converter(stop, seq, torch.tensor(t), torch.tensor(9.0))
        np.testing.assert_array_equal(got.numpy(), jloss.t_converter(stop, seq, jnp.asarray(t),
                                                                     9.0))
    # A batch splices each row's own stop value.
    rows = np.stack([t, t + 10])
    got = loss_mod.t_converter(2, "GAGA", torch.tensor(rows), torch.tensor([7.0, 8.0]))
    np.testing.assert_array_equal(got.numpy()[:, 1], [7.0, 8.0])
    x = torch.tensor(t)
    assert loss_mod.t_converter(2, "GAGA", x) is x


@pytest.mark.parametrize("has_stop_vars", [False, True])
def test_build_batch_matches_jax(has_stop_vars):
    """The decoded population: curvatures after the last-curvature solve,
    thicknesses, glasses and specs; EFL = 1 for every system."""
    ol = OpticalLoss("GAGA", **KW)
    jol = jloss.OpticalLoss("GAGA", **KW)
    inputs, outputs = _designs(ol, has_stop_vars)
    stop = int(inputs[0, -3])
    specs, lens = ol.build_batch(torch.tensor(inputs), torch.tensor(outputs), stop,
                                 has_stop_vars)
    jspecs, jlens = jol.build_batch(jnp.asarray(inputs), jnp.asarray(outputs), stop,
                                    has_stop_vars)
    assert lens.structure.sequence == jlens.structure.sequence
    assert lens.structure.stop_idx == jlens.structure.stop_idx
    assert lens.structure.sequence[0] == ("GAAGA" if has_stop_vars else "GAGA")
    for attr in ("c", "t", "nd", "v"):
        np.testing.assert_allclose(getattr(lens, attr).numpy(), getattr(jlens, attr),
                                   rtol=1e-5, atol=1e-7, err_msg=attr)
    np.testing.assert_allclose(specs.epd.numpy(), jspecs.epd, rtol=0)
    np.testing.assert_allclose(specs.hfov.numpy(), jspecs.hfov, rtol=0)
    np.testing.assert_allclose(lens.efl.numpy(), np.ones(B), rtol=1e-5)


@pytest.mark.parametrize("engine", ["unroll", "fused"])
@pytest.mark.parametrize("jax_engine", ["xla", "pallas"])
def test_unsupervised_matches_jax(engine, jax_engine, jax_side):
    """Mean Lu, rms and penalty, and d Lu/d(outputs), which reaches the
    kernels' mu and z0 cotangents through the glass decode and the pupil
    position."""
    ol = OpticalLoss("GAGA", spot_metric="xy", **KW)
    outputs = torch.tensor(jax_side["outputs"]).requires_grad_(True)
    lu, rms, pen = ol.unsupervised(torch.tensor(jax_side["inputs"]), outputs, stop_idx=1,
                                   engine=engine)
    want = jax_side[jax_engine]
    for got, w, rtol in zip((lu, rms, pen), want["loss"], (1e-5, 2e-4, 1e-5)):
        np.testing.assert_allclose(float(got.detach()), w, rtol=rtol)
    (grad,) = torch.autograd.grad(lu, outputs)
    other = jax_side["pallas" if jax_engine == "xla" else "xla"]["grad"]
    w = want["grad"].astype(np.float64)
    excess = np.abs(grad.numpy() - w) - np.abs(other - w)
    assert np.isfinite(grad.numpy()).all()
    assert excess.max() <= GRAD_BAR * np.abs(w).max(), excess.max() / np.abs(w).max()


def test_unsupervised_is_the_mean_of_single_designs(jax_side):
    """``build_batch`` keeps per-design semantics: the population's mean Lu,
    rms and penalty are the means of ``unsupervised_single`` over designs,
    and the stop index defaults to input slot -3."""
    ol = OpticalLoss("GAGA", **KW)
    inputs, outputs = (torch.tensor(jax_side[k]) for k in ("inputs", "outputs"))
    singles = np.array([[float(v) for v in ol.unsupervised_single(inputs[i], outputs[i], 1)]
                        for i in range(B)])
    for engine in ("unroll", "fused"):
        got = [float(v) for v in ol.unsupervised(inputs, outputs, engine=engine)]
        np.testing.assert_allclose(got, singles.mean(0), rtol=1e-5)
    with pytest.raises(ValueError, match="engine"):
        ol.unsupervised(inputs, outputs, engine="xla")


def test_supervised_matches_jax():
    ol = OpticalLoss("GGA")
    jol = jloss.OpticalLoss("GGA")
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((4, ol.numout)).astype(np.float32) for _ in range(2))
    assert (ol.numin, ol.numout, ol.code_lenstype) == (jol.numin, jol.numout, 110)
    np.testing.assert_allclose(float(ol.supervised(torch.tensor(a), torch.tensor(b))),
                               float(jol.supervised(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
