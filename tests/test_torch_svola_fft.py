"""Port parity for P2's FFT route (wide PSFs): SVOLA through the route's
plain versions against the JAX package, and the plain versions against
float64 direct sums.

The same numpy inputs, made from a seed, go through JAX's
``svola_convolution`` (its rfftn product at the patch's length, eagerly on
the CPU; its gradient by ``jax.grad``) and the port's (CPU tensors, so the
FFT route's plain versions, ``svola_patch_conv_fft_reference`` and
``svola_patch_conv_dpsf_fft_reference``, which the kernels of
``csrc/svola_fft.cu`` equal bit for bit on the card). A float32 FFT's error
is relative to a plane's norm, not to each entry, so every bar is a share of
the largest entry: 1e-5 for the forward and for d/dpatch, 1e-4 for d/dpsf
(whose small edge taps carry the absolute error of the whole correlation).
The JAX side runs once per module.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu.ops import image as jimage
from torchoptics_tpu_torch.ops import image

FWD_BAR, DPSF_BAR = 1e-5, 1e-4
# (image side, grid, overlap, kh, kw): 2 x 2 patches on a 96^2 image, K = 33,
# and a non-square PSF.
SVOLA_CASES = [(96, (2, 2), 4, 33, 33), (80, (2, 2), 6, 37, 45)]


def _rng(k):
    return np.random.default_rng(1200 + k)


def _svola_inputs(case, k):
    side, grid, _, kh, kw = case
    rng = _rng(k)
    x = rng.uniform(0.0, 255.0, (1, side, side, 3)).astype(np.float32)
    psfs = rng.uniform(0.0, 1.0, (1, grid[0] * grid[1], kh, kw, 3)).astype(np.float32)
    psfs /= psfs.sum(axis=(2, 3), keepdims=True)
    cot = rng.standard_normal((1, side, side, 3)).astype(np.float32)
    return x, psfs, cot


@pytest.fixture(scope="module")
def jax_side():
    """JAX's SVOLA, and its gradients of <out, cot> with respect to the image
    and the PSFs, for every case."""
    out = {}
    for k, case in enumerate(SVOLA_CASES):
        x, psfs, cot = _svola_inputs(case, k)
        _, grid, overlap, _, _ = case

        def loss(img, p):
            y = jimage.svola_convolution(img, overlap, p, grid, "hann")
            return jnp.sum(y * cot), y
        (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jnp.asarray(psfs))
        out[k] = (np.asarray(y), np.asarray(grads[0]), np.asarray(grads[1]))
    return out


def _close(got, want, bar):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape
    dev = np.abs(got - want).max() / np.abs(want).max()
    assert dev <= bar, (dev, bar)


@pytest.mark.parametrize("k", range(len(SVOLA_CASES)))
def test_svola_fft_route_matches_jax(jax_side, k):
    """Forward, d/dimage (d/dpatch on the padded cotangent) and d/dpsf of
    SVOLA on the FFT route against JAX's FFT SVOLA and ``jax.grad``."""
    case = SVOLA_CASES[k]
    _, grid, overlap, kh, kw = case
    assert image.p2_takes_fft((kh, kw)) and image.p2_takes_fft((kh, kw), adjoint=True)
    x, psfs, cot = _svola_inputs(case, k)
    t_x = torch.tensor(x, requires_grad=True)
    t_psfs = torch.tensor(psfs, requires_grad=True)
    y = image.svola_convolution(t_x, overlap, t_psfs, grid, "hann")
    d_x, d_psfs = torch.autograd.grad(y, (t_x, t_psfs), torch.tensor(cot))
    want_y, want_dx, want_dpsfs = jax_side[k]
    _close(y.detach().numpy(), want_y, FWD_BAR)
    _close(d_x.numpy(), want_dx, FWD_BAR)
    _close(d_psfs.numpy(), want_dpsfs, DPSF_BAR)


def test_fft_tiles_cut_an_axis_into_overlapping_runs(monkeypatch):
    """``fft_tiles``: a side up to ``P2_FFT_TILE`` (or a PSF longer than it)
    is one piece; a longer one the fewest equal runs of outputs, the last
    shorter, each sub-patch (its run and the k - 1 pixels after it) at most
    ``P2_FFT_TILE`` long, covering every output once."""
    assert image.P2_FFT_TILE == image.P2_FFT_MAX_LEN
    assert image.fft_tiles(4096, 47) == ((0, 4050),)
    assert len(image.fft_tiles(6240, 95)) == 2
    monkeypatch.setattr(image, "P2_FFT_TILE", 64)
    assert image.fft_tiles(120, 33) == ((0, 30), (30, 30), (60, 28))
    assert image.fft_tiles(64, 33) == ((0, 32),) and image.fft_tiles(90, 65) == ((0, 26),)
    for n, k in ((65, 1), (200, 23), (151, 64), (97, 2)):
        runs = image.fft_tiles(n, k)
        assert [o for o, _ in runs] == list(np.cumsum([0] + [m for _, m in runs[:-1]]))
        assert sum(m for _, m in runs) == n - k + 1 and len({m for _, m in runs[:-1]}) <= 1
        assert all(m + k - 1 <= 64 for _, m in runs) and runs[-1][1] <= runs[0][1]


#: A patch that the lowered cut (``P2_FFT_TILE`` = 64) takes in 3 x 3
#: pieces: an 80^2 image with one PSF of 33 taps (120-pixel patches).
CUT_CASE = (80, (1, 1), 4, 33, 33)


def test_fft_route_cut_matches_jax_and_the_uncut_route(monkeypatch):
    """SVOLA on the FFT route with ``P2_FFT_TILE`` lowered to 64: the patch
    (120 pixels a side, 3 x 3 pieces) and d/dpatch's padded cotangent (152,
    4 x 4) are cut into sub-patches (``fft_tiles``), each through the route's plain versions,
    d/dpsf the pieces' correlations summed in order. Forward, d/dimage and
    d/dpsf against JAX's FFT SVOLA and ``jax.grad`` and against the uncut
    route, at the bars above."""
    x, psfs, cot = _svola_inputs(CUT_CASE, 9)
    _, grid, overlap, kh, kw = CUT_CASE

    def loss(img, p):
        y = jimage.svola_convolution(img, overlap, p, grid, "hann")
        return jnp.sum(y * cot), y
    (_, want_y), want_g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(psfs))

    def port():
        t_x = torch.tensor(x, requires_grad=True)
        t_psfs = torch.tensor(psfs, requires_grad=True)
        y = image.svola_convolution(t_x, overlap, t_psfs, grid, "hann")
        return (y.detach(),) + torch.autograd.grad(y, (t_x, t_psfs), torch.tensor(cot))
    uncut = port()
    monkeypatch.setattr(image, "P2_FFT_TILE", 64)
    assert (len(image.fft_tiles(120, kh)), len(image.fft_tiles(152, kh))) == (3, 4)
    cut = port()
    for got, jax_want, whole, bar in zip(cut, (want_y,) + tuple(want_g), uncut,
                                         (FWD_BAR, FWD_BAR, DPSF_BAR)):
        _close(got.numpy(), np.asarray(jax_want), bar)
        _close(got.numpy(), whole.numpy(), bar)


# (P, ph, pw, C, kh, kw): transforms of 27 to 128 points (2^a 3^b 5^c: 60,
# 50, 64, 45, 100, 128, 72, 120, 90, and the odd 75, 81, 27), odd and even
# row counts, non-square patches and PSFs, a PSF as large as its patch, one
# to three channels.
PLAIN_SHAPES = [(2, 60, 50, 3, 33, 33), (1, 64, 41, 1, 35, 21), (2, 100, 128, 3, 47, 29),
                (1, 99, 70, 3, 99, 33), (2, 117, 90, 2, 21, 61), (1, 75, 81, 3, 33, 35),
                (2, 27, 40, 2, 23, 25)]


@pytest.mark.parametrize("shape", PLAIN_SHAPES)
def test_fft_plain_versions_match_float64_direct_sums(shape):
    """The FFT route's plain versions, forward, d/dpsf and d/dpatch, against
    the direct sums (``svola_patch_conv_reference`` and its adjoints) in
    float64, as shares of the largest entry."""
    P, ph, pw, C, kh, kw = shape
    assert all(image.fft_len(n) <= 128 for n in (ph, pw))
    rng = _rng(sum(shape))
    patches = rng.uniform(0.0, 255.0, (P, ph, pw, C)).astype(np.float32)
    psfs = rng.uniform(0.0, 1.0, (P, kh, kw, C)).astype(np.float32)
    psfs /= psfs.sum(axis=(1, 2), keepdims=True)
    cot = rng.standard_normal((P, ph - kh + 1, pw - kw + 1, C)).astype(np.float32)
    t = lambda a, dtype=torch.float32: torch.tensor(a, dtype=dtype)
    f64 = torch.float64
    _close(image.svola_patch_conv_fft_reference(t(patches), t(psfs)),
           image.svola_patch_conv_reference(t(patches, f64), t(psfs, f64)), FWD_BAR)
    _close(image.svola_patch_conv_dpsf_fft_reference(t(patches), t(cot), (kh, kw)),
           image.svola_patch_conv_dpsf_reference(t(patches, f64), t(cot, f64), (kh, kw)),
           DPSF_BAR)
    padded = torch.nn.functional.pad(t(cot, f64), (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
    want = image.svola_patch_conv_reference(padded, torch.flip(t(psfs, f64), dims=(1, 2)))
    _close(image.svola_patch_conv_dpatch_reference(t(cot), t(psfs)), want, FWD_BAR)


@pytest.mark.parametrize("L", [16, 64, 512, 4096, 48, 192, 288, 400, 800])
def test_stockham_is_the_dft(L):
    """The route's mixed-radix Stockham (the length's table, forward and
    inverse) against numpy's FFT in float64; the table is W_L rounded once."""
    tw = image.fft_twiddles(L, torch.device("cpu"))
    w = np.exp(-2j * np.pi * np.arange(L) / L)
    assert np.array_equal(tw.numpy(), np.stack([w.real, w.imag], -1).astype(np.float32))
    assert np.prod(image.fft_radices(L)) == L
    z = _rng(L).standard_normal((2, 3, L)) + 1j * _rng(L + 1).standard_normal((2, 3, L))
    z = z.astype(np.complex64)
    for inverse, want in ((False, np.fft.fft(z.astype(np.complex128))),
                          (True, np.fft.ifft(z.astype(np.complex128)) * L)):
        re, im = image._stockham(torch.tensor(z.real), torch.tensor(z.imag), tw, inverse)
        _close(re.numpy() + 1j * im.numpy(), want, 1e-6)


def test_next_fast_fft_len_matches_jax():
    """The port's copy of ``next_fast_fft_len`` is the JAX package's for
    every n from 1 to 4096; ``fft_len`` is it from 16 points, but for the
    two lengths the kernels do not plan (3125, 3750)."""
    for n in range(1, image.P2_FFT_MAX_LEN + 1):
        fast = image.next_fast_fft_len(n)
        assert fast == jimage.next_fast_fft_len(n), n
        want = 16 if n <= 16 else {3125: 3200, 3750: 3840}.get(fast, fast)
        assert image.fft_len(n) == want, n


# The register blocks that make_plan (csrc/svola_fft.cu) picks at these
# lengths: (R1, R2, R3) stages a thread runs on its M values in registers.
KERNEL_BLOCKS = {48: [(4,), (4, 3)], 288: [(4, 4), (2, 3, 3)], 400: [(4, 4), (5, 5)],
                 800: [(4, 4, 2), (5, 5)], 243: [(3, 3, 3), (3, 3)]}
CSRC = Path(image.__file__).resolve().parents[1] / "csrc" / "svola_fft.cu"


def test_special_plans_are_the_stages():
    """The lengths with kernels of their own (``SPECIAL`` in
    ``csrc/svola_fft.cu``) run the stages of ``fft_radices`` in order, in
    register blocks of ``BLOCK_TYPES``; those in ``KERNEL_BLOCKS`` as listed
    there."""
    text = CSRC.read_text()
    table = text[text.index("BLOCK_TYPES[][3] = {"):]
    types = [tuple(int(v) for v in m) for m in
             re.findall(r"\{(\d), (\d), (\d)\}", table[:table.index("};")])]
    special = text[text.index("SPECIAL[][4] = {"):]
    rows = re.findall(r"\{(\d+), (-?\d+), (-?\d+), (-?\d+)\}", special[:special.index("};")])
    assert {int(r[0]) for r in rows} == {192, 288, 400, 640, 800, 1280}
    for L, *blocks in ((int(v) for v in r) for r in rows):
        plan = [tuple(x for x in types[b] if x > 1) for b in blocks if b >= 0]
        assert tuple(x for blk in plan for x in blk) == image.fft_radices(L), L
        assert plan == KERNEL_BLOCKS.get(L, plan), L


def _blocks_stockham(re, im, tw, inverse, blocks):
    """The kernels' schedule of the same stages: in a block of M = R1 R2 R3
    values starting after Ns points, thread t < L/M holds x[t + m L/M] (m =
    (r1 R2 + r2) R3 + r3), runs the block's stages on them (stage 2's j mod
    Ns is r1 Ns + t mod Ns, stage 3's (r1 + R1 r2) Ns + t mod Ns) and writes
    value (r1, r2, r3) to (t // Ns) Ns M + Ns (r1 + R1 r2 + R1 R2 r3) + t mod
    Ns."""
    L = re.shape[-1]
    ns = 1
    for blk in blocks:
        R = tuple(blk) + (1,) * (3 - len(blk))
        M, T = int(np.prod(R)), L // int(np.prod(R))
        out_re, out_im = np.empty_like(re), np.empty_like(im)
        for t in range(T):
            v = {d: (re[..., t + ((d[0] * R[1] + d[1]) * R[2] + d[2]) * T],
                     im[..., t + ((d[0] * R[1] + d[1]) * R[2] + d[2]) * T])
                 for d in np.ndindex(*R)}
            for si in range(3):
                if R[si] == 1:
                    continue
                nss = ns * int(np.prod(R[:si]))
                for d0 in np.ndindex(*[1 if i == si else R[i] for i in range(3)]):
                    keys = [tuple(r if i == si else d0[i] for i in range(3)) for r in range(R[si])]
                    low = sum(d0[i] * int(np.prod(R[:i])) for i in range(si))
                    k = low * ns + t % ns
                    x = [v[key] for key in keys]
                    if nss > 1:
                        for r in range(1, R[si]):
                            w = tw[r * k * (L // (nss * R[si]))]
                            wi = -w[1] if inverse else w[1]
                            x[r] = (x[r][0] * w[0] - x[r][1] * wi, x[r][0] * wi + x[r][1] * w[0])
                    for key, y in zip(keys, image._butterfly(x, inverse)):
                        v[key] = y
            for d, (vr, vi) in v.items():
                at = (t // ns) * ns * M + ns * (d[0] + R[0] * d[1] + R[0] * R[1] * d[2]) + t % ns
                out_re[..., at], out_im[..., at] = vr, vi
        re, im = out_re, out_im
        ns *= M
    return re, im


@pytest.mark.parametrize("L", sorted(KERNEL_BLOCKS))
def test_register_blocks_equal_the_stages(L):
    """The kernels' register blocks (several stages a thread in registers,
    written back at the block's output positions) give the bits of the
    stage-by-stage plain Stockham, forward and inverse."""
    blocks = KERNEL_BLOCKS[L]
    assert tuple(r for blk in blocks for r in blk) == image.fft_radices(L)
    tw = image.fft_twiddles(L, torch.device("cpu")).numpy()
    rng = _rng(L)
    re, im = (rng.standard_normal((2, L)).astype(np.float32) for _ in range(2))
    for inverse in (False, True):
        got = _blocks_stockham(re, im, tw, inverse, blocks)
        want = image._stockham(torch.tensor(re), torch.tensor(im), torch.tensor(tw), inverse)
        assert np.array_equal(got[0], want[0].numpy()) and np.array_equal(got[1], want[1].numpy())


def test_route_threshold_on_both_devices(monkeypatch):
    """``p2_takes_fft`` splits at ``P2_FFT_MIN_KW`` (d/dpsf at
    ``P2_DPSF_FFT_MIN_KW``) on the larger side of the PSF. On CPU tensors
    ``svola_patch_conv`` and its backward take the plain version of the
    route; on a device tensor (the meta device stands in for the card here)
    the dispatch calls the route's launcher."""
    k_fft, k_dpsf = image.P2_FFT_MIN_KW, image.P2_DPSF_FFT_MIN_KW
    for adjoint, k in ((False, k_fft), (True, k_dpsf)):
        assert not image.p2_takes_fft((k - 2, k - 2), adjoint)
        assert image.p2_takes_fft((k, 3), adjoint) and image.p2_takes_fft((3, k), adjoint)

    rng = _rng(0)
    for kh, kw in ((k_fft - 2, k_fft - 2), (k_fft, 5), (5, k_fft + 2)):
        patches = torch.tensor(rng.uniform(0, 1, (2, kh + 9, kw + 12, 3)).astype(np.float32))
        psfs = torch.tensor(rng.uniform(0, 1, (2, kh, kw, 3)).astype(np.float32),
                            requires_grad=True)
        cot = torch.tensor(rng.standard_normal((2, 10, 13, 3)).astype(np.float32))
        out = image.svola_patch_conv(patches, psfs)
        fwd = (image.svola_patch_conv_fft_reference if image.p2_takes_fft((kh, kw))
               else image.svola_patch_conv_reference)
        assert torch.equal(out.detach(), fwd(patches, psfs.detach()))
        dpsf = (image.svola_patch_conv_dpsf_fft_reference
                if image.p2_takes_fft((kh, kw), adjoint=True)
                else image.svola_patch_conv_dpsf_reference)
        assert torch.equal(torch.autograd.grad(out, psfs, cot)[0],
                           dpsf(patches, cot, (kh, kw)))

    called = []
    record = lambda name: lambda *args: called.append(name) or torch.empty(0, device="meta")
    monkeypatch.setattr(image, "_launch_p2", record("direct"))
    monkeypatch.setattr(image, "_launch_p2_dpsf", record("direct d/dpsf"))
    monkeypatch.setattr(image, "_launch_fft",
                        lambda p, s, k, adjoint: called.append(("fft", adjoint)))
    meta = lambda *shape: torch.empty(shape, device="meta")
    for k in (k_fft - 2, k_fft):
        image._p2(meta(2, 80, 80, 3), meta(2, k, k, 3))
    for k in (k_dpsf - 2, k_dpsf):
        image._p2_dpsf(meta(2, 80, 80, 3), meta(2, 81 - k, 81 - k, 3), (k, k))
    assert called == ["direct", ("fft", False), "direct d/dpsf", ("fft", True)]
