"""Port parity for training through the rendered image: P2's adjoint (the
plain versions the kernels are held to), the gradients of a render with
respect to its PSFs and its radiance, ``image_quality_loss`` with its
d/d(c, t), and ``LensOptimizer`` on ``make_image_loss_fn``.

The Cooke triplet at a small size (5 fields, 8 pupil rings, circular pupil,
one ray-aiming iteration, a 9 x 9 PSF at 8 um, a 3 x 3 patch grid, a 48^2
crop of the sample photograph, K = 3 on the render) goes through the JAX
package and the port. On the JAX side the scan engine runs, jitted with a
fast compile, each program once for the module, on threads; on the port's
side the fused engine on CPU tensors (K1's plain versions, P2 and its
adjoint's plain versions).

Bars, with their reasons:

- P2's adjoint, plain: d/dpsf sums float32 products exactly in float64 and
  rounds once, so it is within one float32 rounding of the float64 adjoint
  (plus 1e-12 of the sum of |terms| for the float64 sum's own rounding).
  Against ``torch.autograd`` of the float32 plain forward and ``jax.vjp`` of
  ``jax.scipy.signal.convolve2d`` (float32 sums in their own orders, over up
  to ~1,300 terms): within 1e-5 of the largest gradient; d/dpatch (9 to 81
  terms a pixel) within 2e-6 of its largest.
- One optics model, JAX's, handed to both: the port convolves tap by tap
  where JAX transforms by FFT (~1e-3 grey levels in the forward), and warps
  by gathers where JAX sums taps. d(loss)/d(PSFs) is within 1e-5 of its
  largest (measured 5.8e-7). d(loss)/d(radiance) also runs through the
  warp's and the SSIM filter's adjoints at every pixel, and the radiance
  enters PSNR and SSIM as the reference too: within 2e-4 of its largest
  (measured 7.8e-5).
- End to end, each package its own trace: the two engines' traces differ by
  float32 rounding (~2e-6 mm at the image), which moves a geometric PSF
  pixel by ~1e-3 of its value, and d/d(c, t) differentiates the splat's
  Gaussians: the loss within 5e-4 dB, the gradients within 5e-4 of the
  largest (measured 7.6e-5 dB and 3.5e-5). The diffraction PSFs are the
  transform of exp(2 pi i OPD / lambda) on a 16^2 pupil grid, and the two
  engines' OPDs differ by float32's floor (up to 1e-5 mm, a tenth of a
  radian; ``test_torch_imaging.py`` holds the PSFs 13 % of their peak
  apart): the loss within 1e-2 dB, the gradients within 0.1 of the largest
  and pointing the same way, cosine above 0.999 (measured 9e-4 dB, 3.5e-2,
  0.99988).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import jax.scipy.signal as jsignal
import numpy as np
import pytest
import torch

from torchoptics_tpu import imaging as jimaging
from torchoptics_tpu import simulator as jsim
from torchoptics_tpu import zoo as jzoo
from torchoptics_tpu_torch import LensOptimizer, imaging, simulator, zoo
from torchoptics_tpu_torch.ops import image
from torchoptics_tpu_torch.utils import images

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SIZE = dict(n_sampled_fields=5, n_pupil_rings=8, pupil_sampling="circular",
            n_ray_aiming_iter=1, psf_shape=(9, 9), psf_abs_pixel_size=8e-3,
            psf_grid_shape=(3, 3), diffraction_grid_n=16, diffraction_oversample=2)
PX = 48
SSIM_WEIGHT = 10.0
MODEL_FIELDS = ("sampled_psfs", "sampled_distortion_shifts", "sampled_relative_illumination",
                "y_center", "accounted")
# (P, ph, pw, C, kh, kw): multiple output tiles with tails, non-square K.
ADJOINT_SHAPES = [(4, 30, 34, 3, 5, 5), (3, 41, 37, 2, 7, 3), (2, 45, 45, 1, 9, 9),
                  (2, 50, 36, 3, 3, 9)]


def _jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _jcfg(**kw):
    return jsim.SimulatorConfig(**SIZE, trace_engine="scan", **kw)


def _cfg(**kw):
    return simulator.SimulatorConfig(**SIZE, trace_engine="fused", **kw)


def _radiance():
    return images.load_test_image((PX, PX))[None]


def _loss_of(psnr, ssim):
    return -psnr.mean() + SSIM_WEIGHT * (1.0 - ssim.mean())


@pytest.fixture(scope="module")
def jax_side():
    """JAX's geometric optics model of the Cooke; the gradients of the loss
    on that model with respect to its PSFs and the radiance; the value and
    d/d(c, t) of ``image_quality_loss`` on both PSF sources: programs
    compiled on threads."""
    jspecs, jlens = jzoo.build("cooke")
    radiance = jnp.asarray(_radiance())
    field_lim = jimaging.sample_field_lim(PX, PX)

    def model():
        return _jitted(lambda c: jimaging.sample_optics_model(
            jspecs, jlens.replace(c=c), _jcfg()), jlens.c)

    def render_grads(m):
        # The whole model is an argument, as a render's is under jit.
        def loss(mm, rad):
            _, p, s = jimaging.apply_optics_model(mm, rad, field_lim, _jcfg())
            return _loss_of(p, s)
        d_model, d_rad = _jitted(jax.grad(loss, argnums=(0, 1)), m, radiance)
        return d_model.sampled_psfs, d_rad

    def lens_grads(source):
        def loss(c, t):
            return jimaging.image_quality_loss(jspecs, jlens.replace(c=c, t=t), radiance,
                                               _jcfg(psf_source=source),
                                               ssim_weight=SSIM_WEIGHT)[0]
        return _jitted(jax.value_and_grad(loss, argnums=(0, 1)), jlens.c, jlens.t)

    with ThreadPoolExecutor(3) as pool:
        lens_runs = {s: pool.submit(lens_grads, s) for s in ("geometric", "diffraction")}
        m = pool.submit(model).result()
        psf_grads = pool.submit(render_grads, m).result()
        lens_out = {s: f.result() for s, f in lens_runs.items()}
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return {"model": {k: np.asarray(getattr(m, k)) for k in MODEL_FIELDS},
            "render_grads": as_np(psf_grads), "lens": as_np(lens_out)}


def _adjoint_inputs(shape):
    P, ph, pw, C, kh, kw = shape
    rng = np.random.default_rng(sum(shape))
    patches = rng.random((P, ph, pw, C), dtype=np.float32) * 255.0
    psfs = rng.random((P, kh, kw, C), dtype=np.float32)
    psfs /= psfs.sum(axis=(1, 2), keepdims=True)
    cot = rng.standard_normal((P, ph - kh + 1, pw - kw + 1, C)).astype(np.float32)
    return patches, psfs, cot


def _jax_vjp(patches, psfs, cot):
    conv = jax.vmap(jax.vmap(lambda x, k: jsignal.convolve2d(x, k, mode="valid"),
                             in_axes=(2, 2), out_axes=2))
    out, vjp = jax.vjp(conv, jnp.asarray(patches), jnp.asarray(psfs))
    return (np.asarray(out),) + tuple(np.asarray(v) for v in vjp(jnp.asarray(cot)))


@pytest.mark.parametrize("shape", ADJOINT_SHAPES)
def test_p2_adjoint_plain_versions(shape):
    """d/dpsf and d/dpatch of ``svola_patch_conv`` on CPU tensors (the plain
    adjoints) against the float64 adjoint, ``torch.autograd`` of the plain
    forward and ``jax.vjp`` of ``convolve2d``."""
    patches, psfs, cot = _adjoint_inputs(shape)
    kh, kw = shape[4:]
    t_patches = torch.tensor(patches, requires_grad=True)
    t_psfs = torch.tensor(psfs, requires_grad=True)
    out = image.svola_patch_conv(t_patches, t_psfs)
    d_patch, d_psf = torch.autograd.grad(out, (t_patches, t_psfs), torch.tensor(cot))
    assert torch.equal(d_psf, image.svola_patch_conv_dpsf_reference(
        t_patches.detach(), torch.tensor(cot), (kh, kw)))
    assert torch.equal(d_patch, image.svola_patch_conv_dpatch_reference(
        torch.tensor(cot), t_psfs.detach()))

    # The float64 adjoint, and the scale of d/dpsf's terms.
    p64 = torch.tensor(patches, dtype=torch.float64, requires_grad=True)
    k64 = torch.tensor(psfs, dtype=torch.float64, requires_grad=True)
    e_patch, e_psf = torch.autograd.grad(image.svola_patch_conv_reference(p64, k64),
                                         (p64, k64), torch.tensor(cot, dtype=torch.float64))
    terms = torch.autograd.grad(image.svola_patch_conv_reference(p64, k64), k64,
                                torch.tensor(np.abs(cot), dtype=torch.float64))[0]
    dev = (d_psf.double() - e_psf).abs()
    assert bool((dev <= 2.0 ** -24 * e_psf.abs() + 1e-12 * terms).all())

    # torch.autograd of the float32 plain forward, and JAX's vjp.
    r_patches = torch.tensor(patches, requires_grad=True)
    r_psfs = torch.tensor(psfs, requires_grad=True)
    a_patch, a_psf = torch.autograd.grad(image.svola_patch_conv_reference(r_patches, r_psfs),
                                         (r_patches, r_psfs), torch.tensor(cot))
    j_out, j_patch, j_psf = _jax_vjp(patches, psfs, cot)
    np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=0,
                               atol=1e-5 * np.abs(j_out).max())
    for got, want in ((d_psf, a_psf.numpy()), (d_psf, j_psf)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for got, want in ((d_patch, a_patch.numpy()), (d_patch, j_patch)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    np.testing.assert_allclose(d_patch.numpy(), e_patch.numpy(), rtol=0,
                               atol=2e-6 * e_patch.abs().max().item())


def _port_model(m, psfs):
    return imaging.OpticsModel(psfs, *[torch.tensor(m[k]) for k in MODEL_FIELDS[1:]])


def test_render_gradients_on_one_model(jax_side):
    """d(loss)/d(PSFs) and d(loss)/d(radiance) of a render of JAX's model,
    against ``jax.grad``: the radiance's gradient is the one that reaches
    d/dpatch."""
    m = jax_side["model"]
    psfs = torch.tensor(m["sampled_psfs"], requires_grad=True)
    radiance = torch.tensor(_radiance(), requires_grad=True)
    _, p, s = imaging.apply_optics_model(_port_model(m, psfs), radiance,
                                         imaging.sample_field_lim(PX, PX), _cfg())
    got = torch.autograd.grad(_loss_of(p, s), (psfs, radiance))
    for g, want, bar in zip(got, jax_side["render_grads"], (1e-5, 2e-4)):
        assert g.shape == want.shape and bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=bar * np.abs(want).max())


@pytest.mark.parametrize("source,loss_bar,grad_bar", [("geometric", 5e-4, 5e-4),
                                                      ("diffraction", 1e-2, 1e-1)])
def test_image_quality_loss_and_lens_gradients(jax_side, source, loss_bar, grad_bar):
    """``image_quality_loss`` and its d/d(c, t) on the Cooke, each package
    its own trace, against ``jax.value_and_grad``."""
    specs, lens = zoo.build("cooke", device="cpu")
    c = lens.c.clone().requires_grad_(True)
    t = lens.t.clone().requires_grad_(True)
    total, terms = imaging.image_quality_loss(specs, lens.replace(c=c, t=t),
                                              torch.tensor(_radiance()),
                                              _cfg(psf_source=source), ssim_weight=SSIM_WEIGHT)
    assert set(terms) == {"psnr", "ssim", "image_loss", "psf_accounted"}
    assert float(terms["image_loss"]) == float(total.detach())
    got = torch.autograd.grad(total, (c, t))
    want_total, want = jax_side["lens"][source]
    assert abs(float(total.detach()) - float(want_total)) <= loss_bar
    mask = lens.structure.mask
    for g, w in zip(got, want):
        g, w = g.numpy()[mask], w[mask]
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=grad_bar * np.abs(w).max())
    flat = lambda gs: np.concatenate([np.asarray(v)[mask] for v in gs])
    g, w = flat([v.numpy() for v in got]), flat(want)
    assert float(g @ w / np.linalg.norm(g) / np.linalg.norm(w)) > 0.999


def test_lens_optimizer_trains_on_the_image():
    """Three Adam steps of ``LensOptimizer(loss_fn=make_image_loss_fn(...))``
    on the Cooke defocused by 1 mm (as the JAX package's image-training
    test): every loss and gradient finite, every step accepted, the loss
    after the third step below the first step's."""
    specs, lens = zoo.build("cooke", device="cpu")
    t = lens.t.clone()
    t[0, -1] += 1.0
    cfg = simulator.SimulatorConfig(n_sampled_fields=5, n_pupil_rings=6,
                                    pupil_sampling="circular", psf_shape=(17, 17),
                                    psf_abs_pixel_size=8e-3, psf_grid_shape=(3, 3),
                                    trace_engine="fused")
    opt = LensOptimizer(specs=specs, config=cfg, learning_rate=2e-3, trainable=("c", "t"),
                        qc_variables=False, efl_target=float(lens.efl[0]),
                        loss_fn=imaging.make_image_loss_fn(torch.tensor(_radiance()),
                                                           ssim_weight=SSIM_WEIGHT))
    state = opt.init(lens.replace(t=t))
    losses = []
    for _ in range(3):
        before = {k: v.detach().clone() for k, v in state.params.items()}
        state, total, terms = opt.step(state)
        losses.append(float(total))
        assert np.isfinite(losses[-1]) and set(terms) >= {"psnr", "ssim", "psf_accounted"}
        assert any(not torch.equal(before[k], state.params[k]) for k in ("c", "t"))
    after = float(opt.loss(state.params)[0].detach())
    assert np.isfinite(after) and after < losses[0], (losses, after)
