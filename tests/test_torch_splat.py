"""Port parity for kernel S1's plain versions (``ops.psf``): the PSF splat
and its hand adjoint, which ``compute_psf`` runs on CPU tensors.

The same seeded spot coordinates go through the JAX package (eagerly, on
the CPU) and the port. Forward: ``compute_psf`` on odd and even, square and
non-square grids, a fixed pitch and the auto extent, with weights, with a
NaN ray, in float64 (JAX's x64 in a scoped context) and with rays across a
span boundary; bars rtol 1e-5 and atol 1e-6, as ``test_torch_psf.py``'s
(the splat's exp rounds differently in the two libraries; the port sums in
float64). Adjoint: the gradients of a seeded weighting of the kernels with
respect to x, y and y_target (and, with the auto extent, through the grid's
centres and widths) against ``jax.grad``, within 1e-4 of each gradient's
largest magnitude in float32 and 1e-12 in float64 (measured: 3.8e-7 at a
fixed pitch, 1.5e-5 with the auto extent; 1.2e-14 in float64);
``_Splat`` under ``torch.autograd.gradcheck`` in float64, every input.
The kernels' windows against the plain versions, bit for bit: the
adjoint's and the forward's arithmetic summed over each ray's windows
alone (``splat_window``, ``splat_over_windows``), the forward's route, and
the forward's branch-free float32 quotient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchoptics_tpu.ops import psf as jpsf
from torchoptics_tpu_torch.ops import psf


def _spots(shape, seed=0, scale=0.02, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, scale, shape).astype(dtype)
    y = (rng.normal(0.0, scale, shape) + 0.5).astype(dtype)
    return x, y


def _assert_close(got, want, rtol=1e-5, atol=1e-6):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_bins,increment", [((9, 9), 8e-3), ((8, 11), 6e-3),
                                              ((9, 7), None)])
def test_plain_splat_matches_jax(n_bins, increment):
    """Odd and even grids, square and not, a fixed pitch and the auto extent:
    ``compute_psf``'s outputs through the plain splat; its half kernels are
    those of the eager 5-D formula in float64 within one float32 rounding."""
    x, y = _spots((2, 3, 3, 40))
    want = jpsf.compute_psf(jnp.asarray(x), jnp.asarray(y), n_bins=n_bins, increment=increment)
    got = psf.compute_psf(torch.tensor(x), torch.tensor(y), n_bins=n_bins, increment=increment)
    _assert_close(got, want)
    assert got[3].shape == (6, 3, n_bins[1], n_bins[0])


@pytest.mark.parametrize("case", ["weights", "nan ray", "span boundary"])
def test_plain_splat_cases_match_jax(case):
    """Per-ray weights (random, not one-hot); a NaN ray (its grid and
    channel's kernel NaN in both); 5 x 3 grids of 1,100 rays, whose last
    span (``splat_span``: 96 rays) ends short."""
    shape = (1, 5, 3, 1100) if case == "span boundary" else (2, 3, 3, 40)
    x, y = _spots(shape, seed=7)
    kw = dict(n_bins=(9, 9), increment=8e-3)
    w = None
    if case == "weights":
        w = np.random.default_rng(8).uniform(0.0, 1.0, (6, 3, 40)).astype(np.float32)
    if case == "nan ray":
        x[0, 1, 2, 7] = np.nan
    if case == "span boundary":
        span = psf.splat_span(shape[-1], 15)
        assert shape[-1] % span and span % psf.SPLAT_CHUNK == 0
    want = jpsf.compute_psf(jnp.asarray(x), jnp.asarray(y), weights=w, **kw)
    got = psf.compute_psf(torch.tensor(x), torch.tensor(y),
                          weights=None if w is None else torch.tensor(w), **kw)
    if case == "nan ray":
        assert bool(torch.isnan(got[3][1, 2]).all()) and int(torch.isnan(got[3]).sum()) == 81
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6,
                                   equal_nan=True)


def test_plain_splat_matches_jax_in_float64():
    x, y = _spots((1, 4, 3, 300), seed=9, dtype=np.float64)
    with jax.enable_x64(True):
        want = jpsf.compute_psf(jnp.asarray(x), jnp.asarray(y), n_bins=(17, 13), increment=4e-3)
        want = [np.asarray(w) for w in want]
    got = psf.compute_psf(torch.tensor(x), torch.tensor(y), n_bins=(17, 13), increment=4e-3)
    assert got[3].dtype == torch.float64
    _assert_close(got, want, rtol=1e-12, atol=1e-14)


def _grads_jax(x, y, yt, weight, n_bins, increment):
    def loss(x, y, yt):
        return jnp.sum(jpsf.compute_psf(x, y, n_bins=n_bins, increment=increment,
                                        y_target=yt)[3] * weight)
    argnums = (0, 1) if yt is None else (0, 1, 2)
    return [np.asarray(g) for g in jax.grad(loss, argnums=argnums)(x, y, yt)]


def _grads_port(x, y, yt, weight, n_bins, increment):
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, y, yt) if a is not None]
    ytt = leaves[2] if yt is not None else None
    k = psf.compute_psf(leaves[0], leaves[1], n_bins=n_bins, increment=increment, y_target=ytt)[3]
    return [g.numpy() for g in torch.autograd.grad((k * torch.tensor(weight)).sum(), leaves)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_bins,increment,y_target", [((9, 9), 8e-3, True),
                                                       ((8, 11), None, False)])
def test_splat_adjoint_matches_jax_grad(n_bins, increment, y_target, dtype):
    """The hand adjoint (``splat_backward_reference``, through ``_Splat``)
    against ``jax.grad`` of JAX's ``compute_psf``: d/dx, d/dy and d/dy_target
    at a fixed pitch; d/dx and d/dy with the auto extent, whose grid centres
    and widths follow the data (the adjoint's per-bin sums)."""
    x, y = _spots((2, 3, 3, 64), seed=11, dtype=dtype)
    yt = np.linspace(0.48, 0.52, 6).astype(dtype) if y_target else None
    weight = np.random.default_rng(12).normal(size=(6, 3, n_bins[1], n_bins[0])).astype(dtype)
    if dtype == np.float64:
        with jax.enable_x64(True):
            want = _grads_jax(jnp.asarray(x), jnp.asarray(y),
                              None if yt is None else jnp.asarray(yt), weight, n_bins, increment)
        bar = 1e-12
    else:
        want = _grads_jax(jnp.asarray(x), jnp.asarray(y), None if yt is None else jnp.asarray(yt),
                          weight, n_bins, increment)
        bar = 1e-4
    got = _grads_port(x, y, yt, weight, n_bins, increment)
    assert len(got) == len(want) == (3 if y_target else 2)
    for g, w in zip(got, want):
        assert g.dtype == dtype and np.all(np.isfinite(g))
        assert np.abs(g - w).max() <= bar * np.abs(w).max()


@pytest.mark.parametrize("n_bins,weighted", [((257, 257), False), ((131, 260), True)])
def test_splat_above_the_resident_grid_matches_jax(n_bins, weighted):
    """PSF grids whose half grids (257 x 129, 260 x 66) are above S1's
    former ceiling (129 x 65) and its forward's dense grids, on 2 grids
    x 3 channels x 80 rays, one case with random weights: ``compute_psf``'s
    outputs and the gradients of a seeded weighting of the kernels with
    respect to x, y and y_target, through the plain splat and its adjoint,
    against JAX's ``compute_psf`` and ``jax.grad`` at the bars above."""
    x, y = _spots((1, 2, 3, 80), seed=31)
    yt = np.asarray([0.49, 0.51], np.float32)
    w = np.random.default_rng(32).uniform(0.0, 1.0, (2, 3, 80)).astype(np.float32) \
        if weighted else None
    weight = np.random.default_rng(33).normal(size=(2, 3, n_bins[1], n_bins[0])).astype(
        np.float32)
    kw = dict(n_bins=n_bins, increment=6e-4)

    def loss(x, y, yt):
        return jnp.sum(jpsf.compute_psf(x, y, y_target=yt, weights=w, **kw)[3] * weight)
    want = jpsf.compute_psf(jnp.asarray(x), jnp.asarray(y), y_target=jnp.asarray(yt), weights=w,
                            **kw)
    want_g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yt))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, y, yt)]
    got = psf.compute_psf(*leaves[:2], y_target=leaves[2],
                          weights=None if w is None else torch.tensor(w), **kw)
    assert got[3].shape == (2, 3, n_bins[1], n_bins[0])
    assert psf.splat_fwd_windowed(n_bins[1], n_bins[0] // 2 + 1)
    _assert_close(got, want)
    got_g = torch.autograd.grad((got[3] * torch.tensor(weight)).sum(), leaves)
    for g, wg in zip(got_g, want_g):
        g, wg = g.numpy(), np.asarray(wg)
        assert np.all(np.isfinite(g)) and np.abs(g - wg).max() <= 1e-4 * np.abs(wg).max()


@pytest.mark.parametrize("weights", [False, True])
def test_splat_function_gradcheck(weights):
    """``_Splat`` on CPU tensors in float64: the hand adjoint against finite
    differences of the plain forward, in every input (the grid's centres and
    widths, and the weights, included); 2 x 37 rays, two spans each."""
    rng = np.random.default_rng(13)
    g, C, R, ny, nx = 2, 1, 37, 4, 3
    t = lambda a: torch.tensor(a, dtype=torch.float64, requires_grad=True)
    x = t(rng.normal(0.0, 0.01, (g, C, R)))
    y = t(rng.normal(0.0, 0.01, (g, C, R)))
    gx = t(np.tile(np.arange(nx) * 0.008, (g, 1)))
    gy = t(np.tile((np.arange(ny) - 2) * 0.008, (g, 1)))
    sx, sy = t(np.full(g, 0.004)), t(np.full(g, 0.005))
    w = t(rng.uniform(0.0, 1.0, (g, C, R))) if weights else None
    assert psf.splat_span(R, g * C) < R
    assert torch.autograd.gradcheck(psf._Splat.apply, (x, y, gx, gy, sx, sy, w))


def test_splat_refuses_other_devices_and_grids():
    x = torch.zeros((1, 1, 4))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        psf.splat(x.to("meta"), x.to("meta"), torch.zeros((1, 2), device="meta"),
                  torch.zeros((1, 3), device="meta"), torch.ones(1, device="meta"),
                  torch.ones(1, device="meta"))
    assert psf.splat_argument_error((1, 1, 4), (1, 0), (1, 3))
    assert psf.splat_argument_error((1, 1, 4), (2, 2), (1, 3))
    # No ceiling on the grid: a 513 x 513 PSF's half grid is taken, and its
    # forward runs the windowed kernels; the default 65 x 33 the dense one.
    assert psf.splat_argument_error((1, 1, 4), (1, 257), (1, 513)) is None
    assert psf.splat_fwd_windowed(513, 257) and psf.splat_fwd_windowed(130, 65)
    assert not psf.splat_fwd_windowed(65, 33)


def test_plain_splat_order_is_the_documented_one():
    """The plain forward and adjoint against explicit float64 loops in the
    documented order, bit for bit, on a half grid of 45 x 41 (two groups of
    bins each way) and 2 pairs of 150 rays (spans of 32, the last 22 rays
    long), with weights: the forward sums each span's rays in order from 0.0
    and the spans in order (``splat_span``); the adjoint's A and B run in
    index order and a ray's d/dx, d/dy and d/dw are ``grouped_sum``s (groups
    (j, t) of bins 40 j + 8 k + 2 t + e, summed in index order, then the
    groups in order). In float64, whose results keep the order's last bits
    (float32 outputs round most of them away); the factors are the port's
    own (``psf._gauss``)."""
    rng = np.random.default_rng(21)
    g, C, R, ny, nx = 1, 2, 150, 45, 41
    f64 = lambda a: torch.tensor(np.asarray(a, dtype=np.float64))
    x, y = f64(rng.normal(0.0, 0.02, (g, C, R))), f64(rng.normal(0.0, 0.02, (g, C, R)))
    gx, gy = f64(np.arange(nx)[None] * 1e-3), f64((np.arange(ny)[None] - ny / 2) * 1e-3)
    sx, sy = f64([7e-4]), f64([6e-4])
    w = f64(rng.uniform(0.0, 1.0, (g, C, R)))
    cot = f64(rng.normal(size=(g, C, ny, nx)))
    span = psf.splat_span(R, g * C)
    assert (span, R % span) == (32, 22)
    ex = psf._gauss(x[..., None], gx[:, None, None], (sx * sx)[:, None, None, None]).double()
    ey = psf._gauss(y[..., None], gy[:, None, None], (sy * sy)[:, None, None, None])
    eyw = (ey * w[..., None]).double().numpy()
    ex, ey = ex.numpy(), ey.double().numpy()

    half = np.zeros((g, C, ny, nx))
    for c in range(C):
        for r0 in range(0, R, span):
            acc = np.zeros((ny, nx))
            for r in range(r0, min(R, r0 + span)):
                acc = acc + eyw[0, c, r][:, None] * ex[0, c, r][None, :]
            half[0, c] = half[0, c] + acc
    got = psf.splat_reference(x, y, gx, gy, sx, sy, w)
    assert np.array_equal(got.numpy().view(np.int64), half.view(np.int64))

    def grouped(t):
        total = 0.0
        for j in range(-(-len(t) // 40)):
            for q in range(4):
                s = 0.0
                for k in range(5):
                    for e in range(2):
                        b = 40 * j + 8 * k + 2 * q + e
                        if b < len(t):
                            s = s + t[b]
                total = total + s
        return total

    G = cot.double().numpy()[0]
    xd, yd, wd = (a.double().numpy()[0] for a in (x, y, w))
    qx0 = 1.0 / (float(sx[0]) * float(sx[0]))
    qy0 = 1.0 / (float(sy[0]) * float(sy[0]))
    want = np.zeros((3, C, R))
    for c in range(C):
        A = np.zeros((R, nx))
        for iy in range(ny):
            A = A + ey[0, c, :, iy, None] * G[c, iy][None, :]
        B = np.zeros((R, ny))
        for ix in range(nx):
            B = B + ex[0, c, :, ix, None] * G[c, :, ix][None, :]
        tx = ((A * ex[0, c]) * ((xd[c][:, None] - gx.double().numpy()[0]) * qx0)) * wd[c][:, None]
        be = B * ey[0, c]
        ty = (be * ((yd[c][:, None] - gy.double().numpy()[0]) * qy0)) * wd[c][:, None]
        for r in range(R):
            want[:, c, r] = -grouped(tx[r]), -grouped(ty[r]), grouped(be[r])
    dx, dy, *_, dw = psf.splat_backward_reference(x, y, gx, gy, sx, sy, w, cot,
                                                  weights_grad=True)
    for a, b in zip((dx, dy, dw), want):
        assert np.array_equal(a[0].numpy().view(np.int64), b.view(np.int64))


def test_dmma_probe_cases_tell_the_roundings_apart():
    """S1's tensor-core probe (``psf.dmma_probe``, run on the card) can tell
    the fma chain in k order from the other orders and roundings: on every
    case some entry of each other model differs from the chain, and the
    chain is the float64 sum of the exact products in k order."""
    cases = psf.dmma_probe_inputs()
    assert set(cases) == {"ties", "cancellation", "order", "random",
                          "random, exponents -30 to 30", "float32 subnormals"}
    for label, (A, B, C) in cases.items():
        assert A.shape[1:] == (16, 4) and B.shape[1:] == (4, 8) and C.shape[1:] == (16, 8)
        assert np.array_equal(A.astype(np.float32).astype(np.float64), A)
        assert np.array_equal(B.astype(np.float32).astype(np.float64), B)
        models = psf._dmma_models(A, B, C)
        chain = models.pop("fma chain in k order")
        want = C.copy()
        for k in range(4):
            want = want + A[:, :, k, None] * B[:, None, k, :]
        assert np.array_equal(chain.view(np.int64), want.view(np.int64)), label
        for name, v in models.items():
            assert (v.view(np.int64) != chain.view(np.int64)).any(), (label, name)


def _window_axis(n, pitch, dtype, centred):
    """Centres of one axis of a half grid at ``pitch`` (compute_psf's
    aranges) and sigma^2 at half a bin, in ``dtype``."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    c = (t(np.arange(n)) + 0.5 - n / 2) * pitch if centred else t(np.arange(n)) * pitch
    sigma = t(pitch) / 2
    return c, sigma * sigma


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_splat_window_holds_every_nonzero_factor(dtype):
    """The windowed adjoint's rule (``psf.splat_window``, the kernel's in
    ``csrc/psf_splat_bwd.cu``): on a 65-bin axis at sigma half a bin, for
    seeded rays over and beyond the grid and rays placed at the threshold
    (q just below, at and above ``SPLAT_Q_MAX`` from a bin, in the type's
    steps), ``_gauss`` is exactly 0 outside each ray's window and every
    window is an interval of q <= q_max: at most 15 bins in float32, 39 in
    float64; non-finite rays and descending centres take the whole axis."""
    c, s2 = _window_axis(65, 4e-3, dtype, True)
    rng = np.random.default_rng(41)
    edge = torch.sqrt(torch.tensor(psf.SPLAT_Q_MAX[dtype], dtype=dtype) * s2)
    near = torch.stack([c[b] + sign * edge for b in (0, 5, 32, 64) for sign in (-1.0, 1.0)])
    steps = torch.tensor(np.arange(-3, 4), dtype=dtype) * (torch.finfo(dtype).eps * edge)
    v = torch.cat([torch.tensor(rng.uniform(-0.09, 0.09, 200), dtype=dtype),
                   (near[:, None] + steps[None, :]).reshape(-1),
                   torch.tensor([0.5, -0.5, float("nan"), float("inf")], dtype=dtype)])
    lo, hi = psf.splat_window(v, c, s2)
    e = psf._gauss(v[:, None], c[None, :], s2)
    b = torch.arange(65)[None, :]
    outside = (b < lo[:, None]) | (b > hi[:, None])
    finite = torch.isfinite(v)
    assert bool((e[finite][outside[finite]] == 0).all())
    d = v[:, None] - c[None, :]
    q = (d * d) / s2
    assert bool((q[finite][~outside[finite]] <= psf.SPLAT_Q_MAX[dtype]).all())
    widest = int((hi - lo + 1)[finite].max())
    assert widest == (15 if dtype == torch.float32 else 39)
    assert (lo[~finite] == 0).all() and (hi[~finite] == 64).all()
    assert int((hi - lo + 1)[-4:-2].max()) == 0          # off the grid: empty windows
    # At the threshold some windows end exactly one bin short of a factor's
    # q above q_max, whose factor is 0 nonetheless.
    assert bool(((q > psf.SPLAT_Q_MAX[dtype]) & (q < psf.SPLAT_Q_MAX[dtype] * 1.001)).any())
    lo_d, hi_d = psf.splat_window(v[:5], c.flip(0), s2)
    assert (lo_d == 0).all() and (hi_d == 64).all()


def _grouped_over(terms):
    """grouped_sum's order over a ray's terms {bin: term} at the window's
    bins alone: groups (b // 40, (b // 2) % 4) in order, each from 0.0."""
    total = 0.0
    for group in sorted({(b // 40, (b // 2) % 4) for b in terms}):
        s = 0.0
        for b in sorted(terms):
            if (b // 40, (b // 2) % 4) == group:
                s = s + terms[b]
        total = total + s
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_splat_adjoint_over_windows_is_the_plain_version(dtype):
    """The windowed kernel's arithmetic in numpy: each ray's A, B and terms
    summed over its windows alone (``splat_window``), in the documented
    order, give ``splat_backward_reference``'s d/dx, d/dy and d/dw bit for
    bit on a 33 x 17 half grid at sigma half a bin, with weights: 2 pairs of
    70 rays, some off the grid (empty windows: d/dx -0.0)."""
    rng = np.random.default_rng(43)
    ny, nx, pitch = 33, 17, 4e-3
    cy, s2y = _window_axis(ny, pitch, dtype, True)
    cx, s2x = _window_axis(nx, pitch, dtype, False)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    x = t(rng.normal(0.0, nx * pitch / 3, (1, 2, 70)))
    y = t(rng.normal(0.0, ny * pitch / 4, (1, 2, 70)))
    x[0, 0, :3] = t([0.3, -0.3, 0.2])
    w = t(rng.uniform(0.0, 1.0, (1, 2, 70)))
    cot = t(rng.normal(size=(1, 2, ny, nx)))
    sigma_x, sigma_y = torch.sqrt(s2x)[None], torch.sqrt(s2y)[None]
    s2x, s2y = sigma_x * sigma_x, sigma_y * sigma_y
    dx, dy, *_, dw = psf.splat_backward_reference(x, y, cx[None], cy[None], sigma_x, sigma_y, w,
                                                  cot, weights_grad=True)
    inv2x = 1.0 / (float(sigma_x[0]) * float(sigma_x[0]))
    inv2y = 1.0 / (float(sigma_y[0]) * float(sigma_y[0]))
    G = cot.double().numpy()[0]
    empty = 0
    for ch in range(2):
        xlo, xhi = psf.splat_window(x[0, ch], cx, s2x[0])
        ylo, yhi = psf.splat_window(y[0, ch], cy, s2y[0])
        ex = psf._gauss(x[0, ch][:, None], cx[None], s2x[0]).double().numpy()
        ey = psf._gauss(y[0, ch][:, None], cy[None], s2y[0]).double().numpy()
        for r in range(70):
            wx, wy = range(int(xlo[r]), int(xhi[r]) + 1), range(int(ylo[r]), int(yhi[r]) + 1)
            xd, yd, wd = (float(a[0, ch, r]) for a in (x, y, w))
            tx, ty, be = {}, {}, {}
            for ix in wx:
                a = 0.0
                for iy in wy:
                    a = a + ey[r, iy] * G[ch, iy, ix]
                tx[ix] = ((a * ex[r, ix]) * ((xd - float(cx[ix])) * inv2x)) * wd
            for iy in wy:
                b = 0.0
                for ix in wx:
                    b = b + ex[r, ix] * G[ch, iy, ix]
                be[iy] = b * ey[r, iy]
                ty[iy] = (be[iy] * ((yd - float(cy[iy])) * inv2y)) * wd
            empty += not tx
            want = [-_grouped_over(tx), -_grouped_over(ty), _grouped_over(be)]
            got = [float(a[0, ch, r]) for a in (dx, dy, dw)]
            want = [float(torch.tensor(v, dtype=torch.float64).to(dtype)) for v in want]
            assert np.array_equal(np.array(got).view(np.int64), np.array(want).view(np.int64))
    assert empty >= 3 and np.signbit(float(dx[0, 0, 0]))


@pytest.mark.parametrize("ny,nx,windowed", [
    (65, 33, False), (5, 3, False), (33, 65, False), (1, psf.SPLAT_DENSE_BINS, False),
    (psf.SPLAT_DENSE_BINS, 1, False), (1, psf.SPLAT_DENSE_BINS + 1, True), (129, 65, True),
    (257, 129, True), (7, 60000, True)])
def test_splat_forward_route(ny, nx, windowed):
    """S1's forward's route (``splat_fwd_windowed``): the dense kernel on
    half grids of at most ``SPLAT_DENSE_BINS`` bins (the default 65 x 33
    among them), the windowed kernels above, whatever the grid's aspect."""
    assert psf.splat_fwd_windowed(ny, nx) == windowed


def _fwd_window_case(case, dtype):
    """S1's inputs for the windowed forward's twin: 2 grids x 2 channels x 70
    rays on a 33 x 17 half grid at a 4e-3 pitch, sigma half a bin, seeded
    rays over the grid, with weights. ``case``: "edges" puts every ray a
    window's reach from a random bin each way, moved by -3 to 3 of the
    type's steps; "non-finite" a NaN x, an inf y and an inf weight (each in
    its own pair); "zero weights" a third of the weights 0 (the W = 4
    one-hot case) and a third of the rays off the grid; "descending" the
    second grid's x centres reversed; "sigma 3 bins" sigma at 3 bins."""
    rng = np.random.default_rng(47)
    g, C, R, ny, nx, pitch = 2, 2, 70, 33, 17, 4e-3
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    gx = np.tile(np.arange(nx) * pitch, (g, 1))
    gy = np.tile((np.arange(ny) + 0.5 - ny / 2) * pitch, (g, 1))
    x = rng.normal(0.0, nx * pitch / 3, (g, C, R))
    y = rng.normal(0.0, ny * pitch / 4, (g, C, R))
    w = rng.uniform(0.0, 1.0, (g, C, R))
    sigma = np.full(g, 3 * pitch if case == "sigma 3 bins" else pitch / 2)
    if case == "edges":
        reach = np.sqrt(psf.SPLAT_Q_MAX[dtype] * (pitch / 2) ** 2)
        eps = float(torch.finfo(dtype).eps)
        for v, c in ((x, gx), (y, gy)):
            b = rng.integers(0, c.shape[1], v.shape)
            v[...] = c[0][b] + rng.choice([-1.0, 1.0], v.shape) * reach * (
                1.0 + rng.integers(-3, 4, v.shape) * eps)
    elif case == "non-finite":
        x[0, 0, 5], y[0, 1, 9], w[1, 0, 3] = np.nan, np.inf, np.inf
    elif case == "zero weights":
        w[..., ::3] = 0.0
        x[..., 1::3] += 1.0
    elif case == "descending":
        gx[1] = gx[1, ::-1]
    return t(x), t(y), t(gx), t(gy), t(sigma), t(sigma), t(w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["edges", "non-finite", "zero weights", "descending",
                                  "sigma 3 bins"])
def test_splat_over_windows_is_the_plain_version(case, dtype):
    """The windowed forward's arithmetic (``splat_over_windows``: each bin
    summed only over the rays whose windows hold it, span by span in ray
    order; non-finite rays, weights and unruled grids over the whole grid;
    zero weights and empty windows nowhere) gives ``splat_reference``'s bits
    on rays at the windows' edges, NaN and inf rays and an inf weight, zero
    weights with rays off the grid, descending centres and sigma of 3 bins;
    spans of 32 rays (the last 6 long)."""
    args = _fwd_window_case(case, dtype)
    assert psf.splat_span(70, 4) == 32
    got = psf.splat_over_windows(*args)
    want = psf.splat_reference(*args)
    assert got.dtype == dtype and bool(torch.isfinite(want).any())
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), int((~same).sum())
    if case == "non-finite":
        # The NaN ray's pair is NaN everywhere, the inf weight's where a
        # factor is 0; the inf ray's factors are 0.
        assert bool(torch.isnan(want[0, 0]).all()) and bool(torch.isnan(want[1, 0]).any())
        assert not bool(torch.isnan(want[0, 1]).any())
    if case == "edges":
        # Some bins sit just outside a window (q just above q_max), their
        # factor 0 nonetheless.
        x, gx, s2 = args[0], args[2], args[4] * args[4]
        d = x[..., None] - gx[:, None, None, :]
        q = (d * d) / s2[:, None, None, None]
        assert bool(((q > psf.SPLAT_Q_MAX[dtype]) & (q < psf.SPLAT_Q_MAX[dtype] * 1.001)).any())


@pytest.mark.parametrize("spread", ["the splat's range", "every exponent"])
def test_float32_quotient_from_a_double_reciprocal(spread):
    """S1 forward's float32 factor takes q = (d * d) / s2 as
    RN_float((double)(d * d) * RN_double(1 / (double)s2)) (``csrc/
    psf_splat.cuh`` ``factor_rcp``, free of the IEEE division's branch): the
    same float as the IEEE float32 division, bit for bit, on 2^21 seeded
    pairs (d and sigma near the splat's scales, or any exponent from
    subnormal to huge) and on 0, subnormals, inf and NaN in either place."""
    rng = np.random.default_rng(53)
    n = 1 << 21
    if spread == "every exponent":
        a = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-149, 128, n)).astype(np.float32)
        b = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-149, 128, n)).astype(np.float32)
    else:
        d = rng.normal(0.0, 0.05, n).astype(np.float32)
        a = d * d
        b = np.square(rng.uniform(1e-4, 1e-2, n).astype(np.float32))
    special = np.array([0.0, 1e-45, 3e-39, 1.0, 3e38, np.inf, np.nan], dtype=np.float32)
    a = np.concatenate([a, np.repeat(special, special.size)])
    b = np.concatenate([b, np.tile(special, special.size)])
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        want = a / b
        got = (a.astype(np.float64) * (1.0 / b.astype(np.float64))).astype(np.float32)
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert bool(same.all()), int((~same).sum())
