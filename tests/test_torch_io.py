"""Port parity for ``models.io`` and the stateful simulator
(``OpticsSimulator``, ``RaytracedOptics``).

Prescriptions round-trip exactly: the port's ``prescription_from_lens``
equals JAX's on every zoo lens (the same float32 values, converted to Python
floats), and loading it back gives the same lens parameters, bit for bit
(the field angle, kept in degrees, within a float32 rounding, as in JAX).
``RaytracedOptics`` runs from the JAX package's own test cases
(``tests/test_simulator.py``: the constructor's defaults and the Cooke
prescription dict) with a circular pupil, whose rays are fixed (a
``torch.Generator`` cannot reproduce JAX's random draws): image coordinates
within 1e-5 mm and the same masks; the loss terms within
``test_torch_simulator.py``'s bars (``loss_unsup`` and ``penalty`` rtol
1e-5, the spot RMS rtol 2e-4, where the difference of ~mm image heights
about a ~10 um spot leaves ~1e-4 between two float32 engines).
"""

import numpy as np
import pytest
import torch

from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu.models import io as jio
from torchoptics_tpu_torch import simulator, zoo
from torchoptics_tpu_torch.models import io

RTOL = {"loss_unsup": 1e-5, "penalty": 1e-5, "rms": 2e-4}
WRAPPER_CASES = {
    "defaults": dict(initial_lens_path="", stop_index=np.array([0]), sequence=np.array(["AGA"]),
                     hfov=np.array([0.0, 17.5, 25.0]), epd=np.array([0.7]),
                     curvature=(0.0, -0.242432341, -0.424975232),
                     thickness=(1.21071062, 0.25, 9.86362667),
                     n_refractive=(1.5224147149313454,), abbe_number=(59.450346241693694,)),
    "cooke": dict(initial_lens_path=zoo.get_prescription("cooke")),
}
SIZE = dict(n_sampled_fields=3, n_pupil_rings=4, pupil_sampling="circular")


@pytest.mark.parametrize("name", sorted(zoo.ZOO))
def test_prescription_round_trip(name):
    """Lens to prescription to lens: every parameter bit for bit. The field
    angle goes through radians and back in float32, which is no exact
    inverse (25 degrees comes back 2e-6 low, in JAX too): a second round
    equals JAX's second round."""
    specs, lens = io.load_lens(zoo.get_prescription(name), device="cpu")
    got = io.prescription_from_lens(specs, lens, f_number=2.0)
    want = jio.prescription_from_lens(*jzoo.build(name), f_number=2.0)
    assert got == want
    specs2, lens2 = io.load_lens(got, device="cpu")
    for a, b in ((lens.c, lens2.c), (lens.t, lens2.t), (lens.nd, lens2.nd),
                 (lens.v, lens2.v), (specs.epd, specs2.epd), (lens.kappa, lens2.kappa),
                 (lens.asph, lens2.asph)):
        assert (a is None and b is None) or torch.equal(a, b)
    np.testing.assert_allclose(specs2.hfov.numpy(), specs.hfov.numpy(), rtol=2.4e-7)
    assert io.prescription_from_lens(specs2, lens2) == jio.prescription_from_lens(
        *jio.load_lens(want))


def test_save_lens_writes_yaml(tmp_path):
    specs, lens = zoo.build("double_gauss_asph", device="cpu")
    path = tmp_path / "lens.yml"
    io.save_lens(str(path), specs, lens, f_number=2.0)
    assert io.load_prescription(str(path)) == io.prescription_from_lens(specs, lens,
                                                                         f_number=2.0)
    specs2, lens2 = io.load_lens(str(path), device="cpu")
    assert torch.equal(lens2.asph, lens.asph) and torch.equal(lens2.c, lens.c)
    np.testing.assert_allclose(specs2.hfov.numpy(), specs.hfov.numpy(), rtol=2.4e-7)


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_raytraced_optics_matches_jax(case):
    kw = dict(WRAPPER_CASES[case], **SIZE)
    ro = simulator.RaytracedOptics(device="cpu", **kw)
    jro = jsim.RaytracedOptics(**kw)
    x, y, ok = ro.do_ray_tracing()
    jx, jy, jok = (np.asarray(v) for v in jro.do_ray_tracing())
    assert x.shape == jx.shape and x.shape[1] == 3
    assert np.array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(x.numpy()[jok], jx[jok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(y.numpy()[jok], jy[jok], rtol=0, atol=1e-5)
    assert set(ro.loss_dict) == set(jro.loss_dict)
    for key, rtol in RTOL.items():
        np.testing.assert_allclose(float(ro.loss_dict[key]), float(jro.loss_dict[key]),
                                   rtol=rtol)
    assert set(ro.logged_metrics) == set(jro.logged_metrics)
    for key in ("ray_tracing/ray_failures", "ray_tracing/backward_rays"):
        assert int(ro.logged_metrics[key]) == int(jro.logged_metrics[key])
    got, want = ro.get_vars(), jro.get_vars()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], dtype=np.float64),
                                   np.asarray(want[key], dtype=np.float64), rtol=1e-6)
    g = torch.tensor(np.asarray(want["g"], dtype=np.float32))
    assert np.array_equal(ro.get_catalog_glass_indices(g).numpy(),
                          np.asarray(jro.get_catalog_glass_indices(np.asarray(want["g"]))))
    # The spot diagram (Agg backend): the same points, one line a wavelength.
    import matplotlib.pyplot as plt
    fig = ro.ShowTraceResult(x, y, ok, ro.loss_dict["loss_unsup"], show=False)
    jfig = jro.ShowTraceResult(jx, jy, jok, jro.loss_dict["loss_unsup"], show=False)
    lines, jlines = fig.axes[0].get_lines(), jfig.axes[0].get_lines()
    assert len(lines) == len(jlines) == len(ro.config.wavelengths)
    for line, jline in zip(lines, jlines):
        assert line.get_color() == jline.get_color()
        np.testing.assert_allclose(line.get_xydata(), jline.get_xydata(), rtol=0, atol=1e-5)
    plt.close(fig)
    plt.close(jfig)


@pytest.mark.parametrize("case", sorted(WRAPPER_CASES))
def test_optics_simulator_initialize(case):
    sim = simulator.OpticsSimulator(device="cpu",
                                    **dict(WRAPPER_CASES[case], n_sampled_fields=3))
    jsim_ = jsim.OpticsSimulator(**dict(WRAPPER_CASES[case], n_sampled_fields=3))
    sim.initialize()
    jsim_.initialize()
    assert sim.structure.sequence == tuple(jsim_.structure.sequence)
    np.testing.assert_allclose(sim.efl.numpy(), np.asarray(jsim_.efl), rtol=1e-6)
    np.testing.assert_allclose(sim.lensR.efl.numpy(), np.asarray(jsim_.lensR.efl), rtol=1e-6)
    assert sim.lensR.device.type == "cpu"
