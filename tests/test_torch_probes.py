"""The two probe kernels against the JAX package's Pallas originals, run in
interpret mode on the CPU (the probes under ``benchmarks/`` are imported as
they are; only their ``pl.pallas_call`` is rebuilt with plain block specs
and ``interpret=True``, since they target a TPU's memory spaces).

- P2, ``probe_svola_direct._k_acc``: the direct K²-tap filter of SVOLA
  patches. It computes a correlation, sum psf[a, b] · x[i+a, j+b]; the port's
  P2 computes SVOLA's convolution. So ``_k_acc`` on a PSF equals the port's
  plain version on the flipped PSF (within float32 rounding: the Pallas
  kernel sums each row offset's taps first, bar 1e-5 relative), and on an
  asymmetric PSF the two orientations differ by tens of grey levels:
  the orientation fault of the probe's "identical valid convolution".
- P1, ``vpu_peak._chain_kernel``: the three issue-rate chains at 16
  iterations equal the port's plain chains; the div chain bit for bit, the
  sqrt chain within one float32 rounding (the CPU's vectorized ``torch.sqrt``
  misrounds a few inputs), the fma chain bit for bit against the plain
  version's once-rounded ``fmaf`` (XLA on the CPU contracts ``a * k1 + k2``
  into one fused multiply-add), and that chain differs from the twice-rounded
  one, so the check tells a fused step from a multiply and an add.
"""

import functools
import os
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmarks"))

import probe_svola_direct  # noqa: E402
import vpu_peak  # noqa: E402

from torchoptics_tpu_torch.benchmarks import issue_peak  # noqa: E402
from torchoptics_tpu_torch.ops import image  # noqa: E402


def _k_acc_interpret(patches, psfs):
    """``acc_grid_conv`` of the probe with interpret-mode block specs."""
    n, hpad, wpad = patches.shape
    k = psfs.shape[-1]
    hp, wp = hpad - k + 1, wpad - k + 1
    rows = jnp.stack([patches[:, a:a + hp, :] for a in range(k)], axis=1)
    return pl.pallas_call(
        functools.partial(probe_svola_direct._k_acc, k), grid=(n, k),
        in_specs=[pl.BlockSpec((1, 1, hp, wpad), lambda i, a: (i, a, 0, 0)),
                  pl.BlockSpec((1, k, k), lambda i, a: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, hp, wp), lambda i, a: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, hp, wp), jnp.float32), interpret=True)(
            rows, psfs)


@pytest.mark.parametrize("k", [3, 5])
def test_p2_is_k_acc_on_the_flipped_psf(k):
    rng = np.random.default_rng(k)
    patches = rng.uniform(0.0, 255.0, (3, 16 + k - 1, 16 + k - 1)).astype(np.float32)
    psfs = rng.uniform(0.0, 1.0, (3, k, k)).astype(np.float32)
    psfs /= psfs.sum(axis=(1, 2), keepdims=True)
    want = np.asarray(_k_acc_interpret(jnp.asarray(patches), jnp.asarray(psfs)))
    flipped = np.ascontiguousarray(psfs[:, ::-1, ::-1])
    got = image.svola_patch_conv(torch.tensor(patches)[..., None],
                                 torch.tensor(flipped)[..., None])[..., 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Unflipped, the port's convolution and the probe's correlation part.
    unflipped = image.svola_patch_conv(torch.tensor(patches)[..., None],
                                       torch.tensor(psfs)[..., None])[..., 0].numpy()
    assert np.abs(unflipped - want).max() > 10.0


@pytest.mark.parametrize("op", issue_peak.OPS)
def test_p1_chains_equal_chain_kernel(op):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.9, 1.1, (32, 128)).astype(np.float32)
    call = pl.pallas_call(
        functools.partial(vpu_peak._chain_kernel, iters=16, op=op, nacc=issue_peak.NACC),
        out_shape=jax.ShapeDtypeStruct((32, 128), jnp.float32), interpret=True)
    want = np.asarray(call(jnp.asarray(x))).reshape(-1)
    got = issue_peak.chains(torch.tensor(x.reshape(-1)), op, 16).numpy()
    if op == "div":
        np.testing.assert_array_equal(got, want)
    elif op == "sqrt":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
        unfused = issue_peak.chains_reference(torch.tensor(x.reshape(-1)), op, 16, fused=False)
        assert (unfused.numpy() != want).mean() > 0.01
    assert vpu_peak.NACC == issue_peak.NACC


@pytest.mark.parametrize("k1,k2", [(issue_peak.K1, issue_peak.K2), (1.5, -0.3), (3.1e-3, 7.7)])
def test_fmaf_reference_rounds_once(k1, k2):
    """The plain fma step is a * k1 + k2 rounded once to the nearest float32
    (ties to even), checked against the exact rational sum."""
    k1, k2 = np.float32(k1), np.float32(k2)
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.uniform(0.5, 2.0, 300), rng.uniform(-3.0, 3.0, 100),
                        10.0 ** rng.uniform(-20, 20, 100)]).astype(np.float32)
    got = issue_peak.fmaf_reference(torch.tensor(a), k1, k2).numpy()
    for ai, gi in zip(a, got):
        exact = Fraction(float(ai)) * Fraction(float(k1)) + Fraction(float(k2))
        err = abs(Fraction(float(gi)) - exact)
        for nb in (np.nextafter(gi, np.float32(-np.inf)), np.nextafter(gi, np.float32(np.inf))):
            nb_err = abs(Fraction(float(nb)) - exact)
            assert err < nb_err or (err == nb_err and int(gi.view(np.int32)) % 2 == 0)
    # A sum exactly halfway between two float32 values rounds to the even one.
    one = torch.ones(1)
    assert issue_peak.fmaf_reference(one, 1.0, 2.0 ** -24).item() == 1.0
    assert issue_peak.fmaf_reference(one, 1.0, 3 * 2.0 ** -24).item() == 1.0 + 2.0 ** -22
