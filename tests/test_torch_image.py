"""Port parity for ``ops.image``: SVOLA, the warps, resizing and rotation,
PSNR / SSIM and the PSF-grid and map interpolations.

The same numpy inputs, made from a seed, go through the JAX package
(eagerly, on the CPU) and the port (CPU tensors, so kernel P2's plain
version). Bars:

- SVOLA: the port sums the valid convolution tap by tap, JAX by FFT; the
  FFT's rounding on a [0, 255] image is ~1e-3 grey levels, bar 5e-3.
- The warps and interpolations: the port gathers the 4 (or 16) Keys
  neighbours where JAX sums shifted slices over a static band, in the same
  order of nonzero terms, so they agree to float32 rounding: rtol 1e-5 and
  atol 1e-4 grey levels.
- ``resize_bilinear``: the weight matrices equal JAX's ``compute_weight_mat``
  to 1e-6; the products (two matrix products here, an einsum there) to
  rtol 1e-5, their gradients within 1e-5 of the largest entry.
- PSNR, SSIM: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from torchoptics_tpu.ops import image as jimage
from torchoptics_tpu_torch.ops import image

SEED = 7


def _rng(k=0):
    return np.random.default_rng(SEED + k)


def _img(shape, k=0):
    return _rng(k).uniform(0.0, 255.0, shape).astype(np.float32)


def _psfs(shape, k=1):
    q = _rng(k).uniform(0.0, 1.0, shape).astype(np.float32)
    return q / q.sum(axis=(-3, -2), keepdims=True)


@pytest.mark.parametrize("pad_h,pad_w", [((3, 12), (0, 4)), ((1, 1), (7, 2))])
def test_pad_symmetric(pad_h, pad_w):
    """numpy's symmetric mode, the edge sample mirrored, also for pads
    longer than the axis."""
    x = _img((2, 5, 7, 3))
    got = image.pad_symmetric(torch.tensor(x), pad_h, pad_w).numpy()
    np.testing.assert_array_equal(got, np.pad(x, ((0, 0), pad_h, pad_w, (0, 0)),
                                              mode="symmetric"))


@pytest.mark.parametrize("window,k,grid,batch", [
    ("boxcar", 3, (2, 2), 1), ("hann", 5, (2, 3), 2), ("hann", 3, (3, 2), 1),
    ("boxcar", 5, (3, 3), 2)])
def test_svola_convolution(window, k, grid, batch):
    """Boxcar and hann, K = 3 and 5, square and non-square grids, B = 1 and
    2, against JAX's FFT path."""
    x = _img((batch, 36, 40, 3))
    n = grid[0] * grid[1]
    psfs = _psfs((batch, n, k, k, 3))
    want = np.asarray(jimage.svola_convolution(jnp.asarray(x), 4, jnp.asarray(psfs), grid,
                                               window))
    got = image.svola_convolution(torch.tensor(x), 4, torch.tensor(psfs), grid, window).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def test_svola_non_square_kernel_and_overlap():
    x = _img((1, 30, 33, 3))
    psfs = _psfs((1, 4, 3, 5, 3))
    want = np.asarray(jimage.svola_convolution(jnp.asarray(x), (3, 5), jnp.asarray(psfs),
                                               (2, 2), "hann", fft_fast_sizes=True))
    got = image.svola_convolution(torch.tensor(x), (3, 5), torch.tensor(psfs), (2, 2), "hann",
                                  fft_fast_sizes=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def test_patch_conv_is_the_valid_convolution():
    """The plain version of P2 computes the convolution, flipped taps: a
    point PSF off centre moves the content the other way than a
    correlation would."""
    x = _img((2, 12, 14, 1))
    psf = np.zeros((2, 3, 3, 1), np.float32)
    psf[:, 0, 2, 0] = 1.0          # one tap, up and to the right
    got = image.svola_patch_conv_reference(torch.tensor(x), torch.tensor(psf)).numpy()
    # out[i, j] = psf[0, 2] · x[i + 2, j + 0]
    np.testing.assert_array_equal(got, x[:, 2:12, 0:12])


def test_interpolate_bicubic_and_gather_warp():
    x = _img((2, 17, 19, 3))
    rng = _rng(3)
    n = 2 * 11 * 13
    cx = rng.uniform(-1.1, 1.1, n).astype(np.float32)
    cy = rng.uniform(-1.1, 1.1, n).astype(np.float32)
    want = np.asarray(jimage.interpolate_bicubic(jnp.asarray(x), jnp.asarray(cx),
                                                 jnp.asarray(cy), (11, 13)))
    got = image.interpolate_bicubic(torch.tensor(x), torch.tensor(cx), torch.tensor(cy),
                                    (11, 13)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    dx = rng.uniform(-1, 1, 17 * 19).astype(np.float32)
    dy = rng.uniform(-1, 1, 17 * 19).astype(np.float32)
    want = np.asarray(jimage.apply_distortion_by_warping(jnp.asarray(x), jnp.asarray(dx),
                                                         jnp.asarray(dy)))
    got = image.apply_distortion_by_warping(torch.tensor(x), torch.tensor(dx),
                                            torch.tensor(dy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _shift_fields(h, w):
    ii, jj = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = 3.5 * np.sin(ii / 5.0) + 0.7 * (jj / w)
    sy = -2.8 * np.cos(jj / 4.0) + 0.3
    return sx.astype(np.float32), sy.astype(np.float32)


def test_warp_bicubic_shifts():
    """The dense-tap warp with shifts beyond the band (clamped), against
    JAX's tap sum."""
    x = _img((2, 20, 23, 3))
    sx, sy = _shift_fields(20, 23)
    want = np.asarray(jimage.warp_bicubic_shifts(jnp.asarray(x), jnp.asarray(sx),
                                                 jnp.asarray(sy), 3))
    got = image.warp_bicubic_shifts(torch.tensor(x), torch.tensor(sx), torch.tensor(sy),
                                    3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("axis", [1, 2])
def test_tap1d(axis):
    x = _img((2, 21, 18, 3))
    sx, sy = _shift_fields(21, 18)
    ii, jj = np.mgrid[0:21, 0:18].astype(np.float32)
    coord = (ii - sy) if axis == 1 else (jj - sx)
    want = np.asarray(jimage._tap1d(jnp.asarray(x), jnp.asarray(coord), axis, 3))
    got = image._tap1d(torch.tensor(x), torch.tensor(coord), axis, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_warp_bicubic_separable():
    x = _img((1, 24, 26, 3))
    # Smooth shift fields in pixels, written once for both array types.
    sx = lambda ii, jj: 0.004 * (jj - 13.0) * (1.0 + 0.01 * ii)
    sy = lambda ii, jj: -0.003 * (ii - 12.0) * (1.0 + 0.02 * jj)
    want = np.asarray(jimage.warp_bicubic_separable(jnp.asarray(x), sx, sy, 8))
    got = image.warp_bicubic_separable(torch.tensor(x), sx, sy, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_in,n_out", [(33, 11), (33, 3), (5, 9), (33, 33)])
def test_resize_weights_and_resize(n_in, n_out):
    """``resize_bilinear`` is ``jax.image.resize(method="linear")``:
    antialiased when downscaling (33 -> 11 and 33 -> 3, the PSF resize at
    1024^2 and 256^2), plain linear when upscaling."""
    w = jscale.compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0.0),
                                  jscale._fill_triangle_kernel, True)
    np.testing.assert_allclose(image._resize_weights(n_in, n_out), np.asarray(w), rtol=0,
                               atol=1e-6)
    x = _psfs((4, n_in, 29, 3))
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), (n_out, 7)))
    got = image.resize_bilinear(torch.tensor(x), (n_out, 7)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("n_in,n_out", [(257, 187), (47, 95)])
def test_resize_and_its_gradient_at_psf_sizes(n_in, n_out):
    """``resize_bilinear`` as two matrix products, on 3 patches' PSFs: a large
    downscale (257 -> 187, the resize at psf_shape 257) and an upscale
    (47 -> 95), its output against ``jax.image.resize`` at the bars above
    and its gradient for a seeded cotangent against ``jax.grad``, within
    1e-5 of the largest entry."""
    x = _psfs((3, n_in, n_in, 3), 9)
    cot = _rng(10).normal(size=(3, n_out, n_out, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jimage.resize_bilinear(a, (n_out, n_out)), jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = image.resize_bilinear(t, (n_out, n_out))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)
    g = torch.autograd.grad(got, t, torch.tensor(cot))[0].numpy()
    want_g = np.asarray(vjp(jnp.asarray(cot))[0])
    assert np.abs(g - want_g).max() <= 1e-5 * np.abs(want_g).max()


def test_rotation_and_psf_resize():
    psfs = _psfs((6, 33, 33, 3), 4)
    angles = np.linspace(-2.5, 2.0, 6).astype(np.float32)
    want = np.asarray(jimage.rotate_image_bilinear(jnp.asarray(psfs), jnp.asarray(angles)))
    got = image.rotate_image_bilinear(torch.tensor(psfs), torch.tensor(angles)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    x_map = np.linspace(-0.8, 0.8, 40, dtype=np.float32)
    y_map = np.linspace(0.6, -0.6, 30, dtype=np.float32)
    want = np.asarray(jimage.rotate_and_resize_psfs(jnp.asarray(psfs), x_map, y_map, (2, 3),
                                                    (11, 9)))
    got = image.rotate_and_resize_psfs(torch.tensor(psfs), x_map, y_map, (2, 3),
                                       (11, 9)).numpy()
    assert got.shape == want.shape == (1, 6, 11, 9, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_psnr_ssim():
    a = _img((2, 30, 31, 3), 5)
    b = np.clip(a + _rng(6).normal(0, 12.0, a.shape), 0, 255).astype(np.float32)
    for fn in ("psnr", "ssim"):
        want = np.asarray(getattr(jimage, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(image, fn)(torch.tensor(a), torch.tensor(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(image._ssim_window(11, 1.5), jimage._ssim_window(11, 1.5))


def test_interpolations_and_maps():
    rng = _rng(8)
    soft = rng.uniform(-1.0, 9.5, (13, 11)).astype(np.float32)
    for k in (9, 70):
        values = rng.normal(size=k).astype(np.float32)
        want = np.asarray(jimage.linear_interpolation(jnp.asarray(soft), jnp.asarray(values)))
        got = image.linear_interpolation(torch.tensor(soft), torch.tensor(values)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    x_map = np.linspace(-0.8, 0.8, 40, dtype=np.float32)
    y_map = np.linspace(0.6, -0.6, 30, dtype=np.float32)
    field_map = np.sqrt(x_map[None, :] ** 2 + y_map[:, None] ** 2)
    np.testing.assert_array_equal(image.get_psf_weights(2, 3, field_map, 5),
                                  np.asarray(jimage.get_psf_weights(2, 3, field_map, 5)))
    psfs = _psfs((5, 9, 9, 3))
    want = np.asarray(jimage.interpolate_psfs(jnp.asarray(psfs), field_map, (2, 3)))
    got = image.interpolate_psfs(torch.tensor(psfs), field_map, (2, 3)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    shifts = np.asarray([0.0, 0.002, 0.009, 0.02, 0.035], np.float32)
    xs, ys = np.meshgrid(x_map, y_map)
    want = jimage.interpolate_distortion_shifts(jnp.asarray(shifts), jnp.asarray(xs),
                                                jnp.asarray(ys))
    got = image.interpolate_distortion_shifts(torch.tensor(shifts), torch.tensor(xs),
                                              torch.tensor(ys))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-8)
    ri = np.asarray([1.0, 0.98, 0.93, 0.85, 0.74], np.float32)
    want = np.asarray(jimage.interpolate_relative_illumination(jnp.asarray(ri), field_map))
    got = image.interpolate_relative_illumination(torch.tensor(ri),
                                                  torch.tensor(field_map)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    bad = np.asarray([1.0, np.nan, np.inf, -np.inf, 2.0], np.float32)
    np.testing.assert_array_equal(image.ensure_finite(torch.tensor(bad), 0.5).numpy(),
                                  np.asarray(jimage.ensure_finite(jnp.asarray(bad), 0.5)))
