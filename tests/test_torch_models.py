"""Port parity: lens models, glass and first-order optics against the JAX
package, on the same parameters (carried across with ``models.convert``)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu.models import zoo as jzoo
from torchoptics_tpu.models.structure import Structure as JStructure
from torchoptics_tpu.ops import abcd as jabcd
from torchoptics_tpu_torch.models import convert, glass, zoo
from torchoptics_tpu_torch.models.structure import Lens, Specs, Structure, mask_scatter
from torchoptics_tpu_torch.ops import abcd

SPHERICAL = [name for name, p in jzoo.ZOO.items() if "kappa" not in p and "asph" not in p]
WAVELENGTH_SETS = [(459.0, 520.0, 640.0), ("C", "d", "F")]


def _port_lens(jlens):
    st = jlens.structure
    return convert.lens_from_numpy(st.stop_idx, st.sequence, np.asarray(jlens.c),
                                   np.asarray(jlens.t), np.asarray(jlens.nd),
                                   np.asarray(jlens.v), device="cpu")


@pytest.fixture(scope="module")
def jax_first_order():
    """EFL, BFL, pupil position, EPD and index tables of every spherical zoo
    lens from the JAX package, as numpy."""
    out = {}
    for name in SPHERICAL:
        jspecs, jlens = jzoo.build(name)
        efl, bfl = jabcd.get_first_order(jlens)
        out[name] = dict(
            lens=jlens, efl=np.asarray(efl), bfl=np.asarray(bfl),
            pupil=np.asarray(jabcd.compute_pupil_position(jlens)),
            mag=np.asarray(jabcd.compute_magnification(jlens)),
            epd=np.asarray(jspecs.epd), hfov=np.asarray(jspecs.hfov),
            n=[np.asarray(jlens.get_refractive_indices(w)) for w in WAVELENGTH_SETS])
    return out


def test_zoo_prescriptions_match_jax():
    assert zoo.ZOO == jzoo.ZOO
    assert zoo.get_prescription("cooke") is not zoo.ZOO["cooke"]


@pytest.mark.parametrize("name", SPHERICAL)
def test_first_order_matches_jax(name, jax_first_order):
    ref = jax_first_order[name]
    lens = _port_lens(ref["lens"])
    efl, bfl = abcd.get_first_order(lens)
    np.testing.assert_allclose(efl.numpy(), ref["efl"], rtol=1e-6)
    np.testing.assert_allclose(bfl.numpy(), ref["bfl"], rtol=1e-6)
    np.testing.assert_allclose(abcd.compute_pupil_position(lens).numpy(),
                               ref["pupil"], rtol=1e-6)
    np.testing.assert_allclose(abcd.compute_magnification(lens).numpy(),
                               ref["mag"], rtol=1e-6)
    for wavelengths, n_ref in zip(WAVELENGTH_SETS, ref["n"]):
        np.testing.assert_allclose(lens.get_refractive_indices(wavelengths).numpy(),
                                   n_ref, rtol=1e-6)


@pytest.mark.parametrize("name", SPHERICAL)
def test_zoo_build_matches_jax(name, jax_first_order):
    ref = jax_first_order[name]
    specs, lens = zoo.build(name, device="cpu")
    assert lens.device.type == "cpu" and lens.dtype == torch.float32
    np.testing.assert_array_equal(lens.c.numpy(), np.asarray(ref["lens"].c))
    np.testing.assert_array_equal(lens.nd.numpy(), np.asarray(ref["lens"].nd))
    np.testing.assert_allclose(specs.epd.numpy(), ref["epd"], rtol=1e-6)
    np.testing.assert_allclose(specs.hfov.numpy(), ref["hfov"], rtol=1e-6)
    np.testing.assert_array_equal(specs.vig_up.numpy(), np.zeros(1, np.float32))


def test_asphere_prescription_builds_as_data():
    specs, lens = zoo.build("double_gauss_asph", device="cpu")
    assert not lens.is_spherical
    assert tuple(lens.asph.shape) == (1, 11, 2)
    assert tuple(lens.kappa.shape) == (1, 11)


@pytest.mark.parametrize("sequence,stop", [(("GAGGAAGGAGA",), (5,)),
                                           (("GAGAAGA", "GAAGA"), (4, 2)),
                                           (("AGA", "GAGAAGGA"), (0, 4))])
def test_structure_masks_match_jax(sequence, stop):
    st, jst = Structure(stop, sequence), JStructure(stop, sequence)
    for attr in ("mask", "mask_G", "n_surfaces", "last_g_idx", "mask_except_last"):
        np.testing.assert_array_equal(getattr(st, attr), getattr(jst, attr), err_msg=attr)
    up, jup = st.up_to_stop(), jst.up_to_stop()
    assert (up.sequence, up.pad_to) == (jup.sequence, jup.pad_to)
    assert hash(st) == hash(Structure(stop, sequence))


def test_flat_parameters_pad_and_gather():
    st = Structure((4, 2), ("GAGAAGA", "GAAGA"))
    n_valid, n_glass = int(st.mask.sum()), int(st.mask_G.sum())
    c = torch.arange(1, n_valid + 1, dtype=torch.float32)
    lens = Lens(st, c, c, torch.full((n_glass,), 1.5), torch.full((n_glass,), 50.0))
    np.testing.assert_array_equal(lens.c[1, 5:].numpy(), [0.0, 0.0])
    np.testing.assert_array_equal(lens.nd[~torch.as_tensor(st.mask_G)].numpy(), 1.0)
    np.testing.assert_array_equal(lens.v[~torch.as_tensor(st.mask_G)].numpy(), 1.0)
    np.testing.assert_array_equal(lens.c[torch.as_tensor(st.mask)].numpy(), c.numpy())
    np.testing.assert_array_equal(mask_scatter(st.mask, c, 0.0).numpy(), lens.c.numpy())
    with pytest.raises(ValueError):
        Lens(st, torch.zeros(2, 3), c, lens.nd, lens.v)


def test_lens_up_to_stop_detach_and_to():
    _, jlens = jzoo.build("double_gauss")
    lens = _port_lens(jlens)
    up, jup = lens.up_to_stop(), jlens.up_to_stop()
    for attr in ("c", "t", "nd", "v"):
        np.testing.assert_array_equal(getattr(up, attr).numpy(),
                                      np.asarray(getattr(jup, attr)), err_msg=attr)
    c = lens.c.clone().requires_grad_(True)
    lens_g = lens.replace(c=c)
    assert lens_g.c.requires_grad and not lens_g.detach().c.requires_grad
    assert len(lens_g) == 1 and lens_g.is_spherical
    assert lens.to(dtype=torch.float64).c.dtype == torch.float64


def test_specs_replace_and_up_to_stop():
    specs, _ = zoo.build("cooke", device="cpu")
    up = specs.up_to_stop()
    assert up.structure.sequence == ("GAGA",)
    assert torch.equal(up.epd, specs.epd)
    assert isinstance(specs.replace(epd=specs.epd + 1.0), Specs)


def test_glass_whitening_matches_jax():
    from torchoptics_tpu.models import glass as jglass
    rng = np.random.default_rng(0)
    n = rng.uniform(1.45, 1.95, 16).astype(np.float32)
    v = rng.uniform(20.0, 80.0, 16).astype(np.float32)
    np.testing.assert_allclose(glass.g_from_n_v(torch.tensor(n), torch.tensor(v)).numpy(),
                               np.asarray(jglass.g_from_n_v(jnp.asarray(n), jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(glass.compute_n(torch.tensor(n), torch.tensor(v)).numpy(),
                               np.asarray(jglass.compute_n(jnp.asarray(n), jnp.asarray(v))),
                               rtol=1e-6)
    assert glass.resolve_wavelengths(("C", 500)) == (656.3, 500.0)


def test_import_is_jax_and_triton_free():
    """Importing the port pulls in neither JAX nor Triton, and a trace and
    its gradient on CPU tensors neither build nor launch a kernel."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch, torchoptics_tpu_torch as tt\n"
        "from torchoptics_tpu_torch.ops import _kernels, fused_trace\n"
        "specs, lens = tt.zoo.build('cooke', device='cpu')\n"
        "cfg = tt.SimulatorConfig(n_sampled_fields=2, n_pupil_rings=4,\n"
        "    pupil_sampling='circular', trace_engine='fused')\n"
        "c = lens.c.clone().requires_grad_(True)\n"
        "_, loss = tt.simulator.do_ray_tracing(specs, lens.replace(c=c), cfg)\n"
        "torch.autograd.grad(loss['loss_unsup'], c)\n"
        "assert 'jax' not in sys.modules and 'triton' not in [\n"
        "    m for m in sys.modules if sys.modules[m] is not None]\n"
        "pop_specs, pop = tt.zoo.mixed_population(2, device='cpu')\n"
        "_, loss = tt.simulator.do_ray_tracing(pop_specs, pop, cfg)\n"
        "assert fused_trace.K1_FWD_LAUNCHES == 0\n"
        "assert fused_trace.K1_BWD_LAUNCHES == 0\n"
        "assert tt.fused_batch.K2_FWD_LAUNCHES == 0\n"
        "assert _kernels.load.cache_info().currsize == 0\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("form", ["padded", "flat"])
def test_mixed_padded_population_converts(form):
    """A JAX population of mixed lens types, padded to its widest sequence,
    carries across from its padded (B, S) arrays or its flat ones; selecting
    systems by index (``__getitem__``) cuts each part to its own width, as
    in JAX."""
    from torchoptics_tpu.models.structure import Lens as JLens
    from torchoptics_tpu.models.structure import Specs as JSpecs
    rng = np.random.default_rng(0)
    names = ("cooke", "double_gauss", "cooke")
    ps = [jzoo.get_prescription(n) for n in names]
    jst = JStructure(tuple(p["stop_idx"][0] for p in ps), tuple(p["sequence"][0] for p in ps))
    flat = {k: np.concatenate([np.asarray(p[k], np.float32) for p in ps])
            for k in ("c", "t", "nd", "v")}
    flat["c"] = flat["c"] * (1 + 0.02 * rng.standard_normal(flat["c"].shape)).astype(np.float32)
    jlens = JLens(jst, *(jnp.asarray(flat[k]) for k in ("c", "t", "nd", "v")))
    jspecs = JSpecs(jst, jnp.asarray([2.0, 3.0, 4.0]), jnp.asarray([0.3, 0.2, 0.1]))
    arrays = ({k: np.asarray(getattr(jlens, k)) for k in ("c", "t", "nd", "v")}
              if form == "padded" else flat)
    lens = convert.lens_from_numpy(jst.stop_idx, jst.sequence, arrays["c"], arrays["t"],
                                   arrays["nd"], arrays["v"], device="cpu")
    specs = convert.specs_from_numpy(jst.stop_idx, jst.sequence, np.asarray(jspecs.epd),
                                     np.asarray(jspecs.hfov), device="cpu")
    np.testing.assert_array_equal(lens.structure.mask, jst.mask)
    for k in ("c", "t", "nd", "v"):
        np.testing.assert_array_equal(getattr(lens, k).numpy(), np.asarray(getattr(jlens, k)))
    np.testing.assert_allclose(lens.efl.numpy(), np.asarray(jabcd.get_first_order(jlens)[0]),
                               rtol=1e-5)
    for index in (np.array([0, 2]), np.array([1]), 1, slice(0, 2)):
        sub, jsub = lens[index], jlens[index]
        assert sub.structure == Structure(jsub.structure.stop_idx, jsub.structure.sequence)
        for k in ("c", "t", "nd", "v"):
            np.testing.assert_array_equal(getattr(sub, k).numpy(), np.asarray(getattr(jsub, k)))
        np.testing.assert_array_equal(specs[index].epd.numpy(), np.asarray(jspecs[index].epd))
    assert lens[np.array([0, 2])].c.shape == (2, 7)
