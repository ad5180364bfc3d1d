"""Port parity for the training utilities (``torchoptics_tpu_torch.utils``):
checkpoints, the metrics log, NaN checks and trace health, the wavelength
colours and the plots, against ``torchoptics_tpu.utils`` on the same
numbers.

Checkpoints keep the JAX package's layout (``leaf_i`` arrays beside a
``.meta.json`` of tree paths), so a parameter dict saved by either package
restores in the other bit for bit, and the port's optimizer state has the
JAX package's paths. Trace health counts are equal on the same lens (the
two engines' masks agree); colours equal; plotted points within 1e-5 of
JAX's (float32 traces of the same rays).
"""

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from torchoptics_tpu import optimize as jopt  # noqa: E402
from torchoptics_tpu import simulator as jsim  # noqa: E402
from torchoptics_tpu import trace as jtrace  # noqa: E402
from torchoptics_tpu import zoo as jzoo  # noqa: E402
from torchoptics_tpu.utils import checkpoint as jckpt  # noqa: E402
from torchoptics_tpu.utils import debugging as jdebugging  # noqa: E402
from torchoptics_tpu.utils import logging as jlogging  # noqa: E402
from torchoptics_tpu.utils import plotting as jplotting  # noqa: E402
from torchoptics_tpu.utils import wavelength as jwavelength  # noqa: E402
from torchoptics_tpu_torch import LensOptimizer, simulator, trace, zoo  # noqa: E402
from torchoptics_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from torchoptics_tpu_torch.utils import debugging, plotting, wavelength  # noqa: E402
from torchoptics_tpu_torch.utils import logging as mlogging  # noqa: E402

PARAMS = {"c": np.arange(5.0, dtype=np.float32), "t": np.ones((2, 3), np.float32),
          "nested": {"g": np.asarray([[1.0, 2.0]], np.float32)},
          "seq": [np.float32(3.0), np.asarray([4.0, 5.0], np.float32)]}
SINGLET_CFG = dict(n_sampled_fields=2, n_pupil_rings=3, pupil_sampling="circular",
                   n_ray_aiming_iter=0)
HEALTH_CFG = dict(mode="circular", n_rays=(4, 4), rel_fields=(0.0, 1.0), wavelengths=("d",))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.tensor(tree)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_checkpoint_roundtrip_params(tmp_path):
    params = _torch_tree(PARAMS)
    path = str(tmp_path / "state.npz")
    ckpt.save(path, params, metadata={"step": 7})
    restored = ckpt.restore(path, params)
    _assert_tree_equal(restored, PARAMS)
    assert isinstance(restored["nested"]["g"], torch.Tensor)
    assert ckpt.load_metadata(path)["step"] == 7


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_params_cross_the_packages(tmp_path, direction):
    """A parameter dict saved by either package restores in the other, with
    the same paths in the sidecar."""
    path = str(tmp_path / "params.npz")
    jparams = {k: (jnp.asarray(v) if not isinstance(v, (dict, list)) else v)
               for k, v in PARAMS.items()}
    jparams["nested"] = {"g": jnp.asarray(PARAMS["nested"]["g"])}
    jparams["seq"] = [jnp.asarray(v) for v in PARAMS["seq"]]
    if direction == "jax_to_port":
        jckpt.save(path, jparams)
        restored = ckpt.restore(path, _torch_tree(PARAMS))
    else:
        ckpt.save(path, _torch_tree(PARAMS))
        restored = jckpt.restore(path, jparams)
    _assert_tree_equal(restored, PARAMS)
    assert jckpt._flatten_with_paths(jparams)[0] == [p for p, _ in ckpt._flatten(
        _torch_tree(PARAMS))]


def test_checkpoint_roundtrip_lens(tmp_path):
    specs, lens = zoo.build("cooke", device="cpu")
    lens = lens.replace(kappa=torch.full_like(lens.c, -0.1))
    path = str(tmp_path / "lens.npz")
    ckpt.save(path, (specs, lens))
    r_specs, r_lens = ckpt.restore(path, (specs, lens))
    for k in ("c", "t", "nd", "v", "kappa"):
        assert torch.equal(getattr(r_lens, k), getattr(lens, k)), k
    assert r_lens.asph is None and r_lens.structure == lens.structure
    assert torch.equal(r_specs.epd, specs.epd) and r_specs.structure == specs.structure
    # A spherical lens has the JAX package's four paths.
    _, jlens = jzoo.build("cooke")
    assert [p for p, _ in ckpt._flatten(lens.replace(kappa=None))] == \
        jckpt._flatten_with_paths(jlens)[0]


def test_checkpoint_optimizer_resume(tmp_path):
    """Save mid-optimization, restore, and continue identically; the state
    has the JAX package's paths (params, Adam's count and moments, step)."""
    specs, lens = zoo.build("singlet", device="cpu")
    cfg = simulator.SimulatorConfig(**SINGLET_CFG)
    opt = LensOptimizer(specs=specs, config=cfg, qc_variables=False, add_bfl=False,
                        efl_target=float(lens.efl[0]))
    state = opt.init(lens)
    for _ in range(2):
        state, *_ = opt.step(state)
    path = str(tmp_path / "opt.npz")
    ckpt.save(path, state)
    restored = ckpt.restore(path, state)
    assert restored.step == 2
    next_a, loss_a, _ = opt.step(state)
    next_b, loss_b, _ = opt.step(restored)
    assert float(loss_a) == float(loss_b)
    for k in next_a.params:
        assert torch.equal(next_a.params[k], next_b.params[k]), k

    jspecs, jlens = jzoo.build("singlet")
    jo = jopt.LensOptimizer(specs=jspecs, config=jsim.SimulatorConfig(**SINGLET_CFG),
                            qc_variables=False, add_bfl=False, efl_target=float(jlens.efl[0]))
    jstate = jo.init(jlens)
    assert [p for p, _ in ckpt._flatten(state)] == jckpt._flatten_with_paths(jstate)[0]


def test_checkpoint_jax_optimizer_state_restores_in_the_port(tmp_path):
    """JAX's (params, Adam moments, count, step) after two steps become the
    port's OptState: the same numbers in the port's Adam."""
    jspecs, jlens = jzoo.build("singlet")
    jo = jopt.LensOptimizer(specs=jspecs, config=jsim.SimulatorConfig(**SINGLET_CFG),
                            qc_variables=False, add_bfl=False, efl_target=float(jlens.efl[0]))
    jstate = jo.init(jlens)
    for _ in range(2):
        jstate, *_ = jo.step(jstate)
    path = str(tmp_path / "jax_opt.npz")
    jckpt.save(path, jstate)
    specs, lens = zoo.build("singlet", device="cpu")
    opt = LensOptimizer(specs=specs, config=simulator.SimulatorConfig(**SINGLET_CFG),
                        qc_variables=False, add_bfl=False, efl_target=float(lens.efl[0]))
    state = ckpt.restore(path, opt.init(lens))
    assert state.step == 2
    adam = jstate.opt_state[0]
    for k, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jstate.params[k]))
        moments = state.opt_state.state[p]
        assert float(moments["step"]) == int(adam.count)
        np.testing.assert_array_equal(moments["exp_avg"].numpy(), np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(moments["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]))
    opt.step(state)


def test_checkpoint_restore_names_the_first_differing_path(tmp_path):
    path = str(tmp_path / "state.npz")
    ckpt.save(path, {"c": torch.ones(2), "t": torch.ones(3)})
    with pytest.raises(ValueError, match=r"\"\['t'\]\" \(saved\) vs \"\['x'\]\" \(template\)"):
        ckpt.restore(path, {"c": torch.ones(2), "x": torch.ones(3)})
    with pytest.raises(ValueError, match="has 2 leaves, but the template has 1"):
        ckpt.restore(path, {"c": torch.ones(2)})


def test_metrics_logger_round_trip(tmp_path):
    """Tensors (a 0-d one with a gradient among them) are written as floats,
    other values as strings, as JAX's logger writes its arrays."""
    metrics = {"loss": torch.tensor(1.5, requires_grad=True) * 2, "rms": np.float32(0.25),
               "n": 3, "label": "cooke"}
    with mlogging.MetricsLogger(str(tmp_path / "port")) as log:
        for step in range(3):
            log.log(step, metrics)
    with jlogging.MetricsLogger(str(tmp_path / "jax")) as jlog:
        for step in range(3):
            jlog.log(step, {"loss": jnp.asarray(3.0), "rms": 0.25, "n": 3, "label": "cooke"})
    got = mlogging.read_metrics(log.path)
    want = jlogging.read_metrics(jlog.path)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.pop("wall_s") >= 0 and w.pop("wall_s") >= 0
        assert g == w


def test_checked_passes_clean_functions_and_raises_on_nan():
    f = debugging.checked(lambda x: torch.sum(x * 2))
    assert float(f(torch.ones(4))) == 8.0
    with pytest.raises(FloatingPointError, match="aten.log"):
        debugging.checked(lambda x: torch.sum(torch.log(x)))(torch.tensor([-1.0, 2.0]))
    with pytest.raises(ZeroDivisionError, match="aten.div"):
        debugging.checked(lambda x: x / torch.zeros(2))(torch.ones(2))
    # A clean loss, its backward included, passes (the trace's masks keep
    # failed rays finite); without the division check a 1/0 passes.
    specs, lens = zoo.build("cooke", device="cpu")
    cfg = simulator.SimulatorConfig(**dict(SINGLET_CFG, trace_engine="fused"))
    c = lens.c.clone().requires_grad_(True)
    grad = debugging.checked(lambda c: torch.autograd.grad(
        simulator.unsupervised_loss(specs, lens.replace(c=c), cfg), c)[0])(c)
    assert bool(torch.isfinite(grad).all())
    assert float(debugging.checked(lambda x: 1.0 / x, div=False)(torch.zeros(1))) == np.inf


@pytest.mark.parametrize("c_scale", [1.0, 3.0])
def test_trace_health_matches_jax(c_scale):
    specs, lens = zoo.build("cooke", device="cpu")
    jspecs, jlens = jzoo.build("cooke")
    res = trace.trace_rays(specs, lens.replace(c=lens.c * c_scale),
                           trace.TraceConfig(**HEALTH_CFG))
    jres = jtrace.trace_rays(jspecs, jlens.replace(c=jlens.c * c_scale),
                             jtrace.TraceConfig(**HEALTH_CFG))
    got, want = debugging.trace_health(res), jdebugging.trace_health(jres)
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert (float(got["ray_failure_fraction"]) > 0) == (c_scale == 3.0)
    assert int(got["nonfinite_coords"]) == 0


def test_wavelength_to_rgb_matches_jax():
    for w in np.arange(370.0, 790.0, 0.25):
        assert wavelength.wavelength_to_rgb(w) == jwavelength.wavelength_to_rgb(w), w
    assert wavelength.wavelength_to_rgb(600.0, gamma=1.0) == \
        jwavelength.wavelength_to_rgb(600.0, gamma=1.0)
    for name, w in (("C", 656.3), ("d", 587.6), ("F", 486.1)):
        assert wavelength.wavelength_to_rgb(name) == jwavelength.wavelength_to_rgb(w)


def _lines(fig):
    return [(line.get_color(), line.get_xydata()) for ax in fig.axes for line in ax.get_lines()]


def test_plots_draw_what_jax_draws():
    """show_trace_result and plot_lens_layout under the Agg backend: the
    same lines, colours and points as the JAX package's."""
    import matplotlib.pyplot as plt
    specs, lens = zoo.build("cooke", device="cpu")
    jspecs, jlens = jzoo.build("cooke")
    cfg = dict(mode="circular", n_rays=(4, 4), rel_fields=(0.0, 1.0),
               wavelengths=(486.1, 587.6, 656.3))
    res = trace.trace_rays(specs, lens, trace.TraceConfig(**cfg))
    jres = jtrace.trace_rays(jspecs, jlens, jtrace.TraceConfig(**cfg))
    figs = [(plotting.show_trace_result(res.x, res.y, res.ray_ok, 0.5, cfg["wavelengths"],
                                        show=False),
             jplotting.show_trace_result(jres.x, jres.y, jres.ray_ok, 0.5, cfg["wavelengths"],
                                         show=False)),
            (plotting.plot_lens_layout(specs, lens, n_rays=5, show=False),
             jplotting.plot_lens_layout(jspecs, jlens, n_rays=5, show=False))]
    for fig, jfig in figs:
        lines, jlines = _lines(fig), _lines(jfig)
        assert len(lines) == len(jlines) >= 3
        for (color, xy), (jcolor, jxy) in zip(lines, jlines):
            assert np.allclose(matplotlib.colors.to_rgba(color), matplotlib.colors.to_rgba(jcolor))
            np.testing.assert_allclose(xy, jxy, rtol=0, atol=1e-5)
        plt.close(fig)
        plt.close(jfig)


def test_encode_png_reads_back(tmp_path):
    """``images.encode_png`` (the writer of ``simulate_aberrations``): the
    file holds each value rounded to 8 bits, read back by the port's
    decoder and by matplotlib's reader alike."""
    import matplotlib.image as mpimg
    from torchoptics_tpu_torch.utils import images
    rgb = np.random.default_rng(0).uniform(-0.1, 1.1, (7, 5, 3))
    path = str(tmp_path / "out.png")
    images.encode_png(path, rgb)
    want = np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(images.decode_png(path), want)
    np.testing.assert_array_equal(np.round(mpimg.imread(path) * 255.0).astype(np.uint8), want)
