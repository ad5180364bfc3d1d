"""Port parity for ``ops.psf``: the soft-histogram PSF, the per-field PSF
sampling (even and uneven wavelength-to-channel grouping) and the MTF.

The same seeded spot coordinates go through the JAX package (eagerly, on
the CPU) and the port. The splat is a sum of Gaussians over rays whose
``exp`` rounds differently in the two libraries: bar rtol 1e-5 and 1e-6 of
the kernels' unit sum; the accounted ray fractions are counts, compared
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu.ops import psf as jpsf
from torchoptics_tpu_torch.ops import psf


def _spots(shape, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, scale, shape).astype(np.float32)
    y = (rng.normal(0.0, scale, shape) + 0.5).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n_bins,increment", [((9, 9), 8e-3), ((8, 11), 6e-3),
                                              ((9, 7), None)])
def test_compute_psf(n_bins, increment):
    """Odd and even grids, square and not, a fixed pitch and the auto extent;
    y_target from the centroid."""
    x, y = _spots((2, 3, 3, 40))
    want = jpsf.compute_psf(jnp.asarray(x), jnp.asarray(y), n_bins=n_bins, increment=increment)
    got = psf.compute_psf(torch.tensor(x), torch.tensor(y), n_bins=n_bins, increment=increment)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert got[3].shape == (6, 3, n_bins[1], n_bins[0])


@pytest.mark.parametrize("n_w", [3, 4])
def test_sample_psfs(n_w):
    """W = 3 splats each wavelength into its own channel; W = 4 groups
    [0, 0, 1, 2] (``channel_assignment``) through one-hot splat weights."""
    x, y = _spots((1, 5, 30, n_w), seed=n_w)
    y_center = np.linspace(0.45, 0.55, 5).astype(np.float32)
    want = jpsf.sample_psfs(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y_center), (9, 9), 8e-3)
    got = psf.sample_psfs(torch.tensor(x), torch.tensor(y), torch.tensor(y_center), (9, 9), 8e-3)
    assert got[0].shape == (5, 9, 9, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    assert psf.channel_assignment(n_w) == jpsf.channel_assignment(n_w)


def test_compute_mtf():
    x, y = _spots((1, 2, 3, 50), seed=3)
    kernels = np.asarray(jpsf.compute_psf(jnp.asarray(x), jnp.asarray(y), n_bins=(16, 12),
                                          increment=5e-3)[3])
    want = jpsf.compute_mtf(jnp.asarray(kernels), 5e-3)
    got = psf.compute_mtf(torch.tensor(kernels), 5e-3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
