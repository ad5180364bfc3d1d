"""Point-spread functions from traced spot coordinates.

PyTorch counterpart of ``torchoptics_tpu.ops.psf``: the soft-histogram PSF.
Rays are splatted onto a pixel grid with a Gaussian of sigma = pixel / 2,
the x half is mirrored (lens systems are meridionally symmetric), and each
kernel is normalized to unit area. Differentiable.

The splat itself, the sum over rays of a separable Gaussian on the half grid,
is kernel S1, hand-written in CUDA C++ (``csrc/psf_splat_fwd.cu``, its
adjoint ``csrc/psf_splat_bwd.cu``), reached through :func:`splat`. The JAX
package writes it as a (grids, channels, n_y, n_x/2, rays) broadcast that XLA
fuses into the sum, so the Gaussian never exists in memory; run eagerly, the
same lines would hold it (8.86e9 values at the default ``SimulatorConfig``,
twice with autograd). On CPU
tensors :func:`splat` runs the plain versions, :func:`splat_reference` and
:func:`splat_backward_reference`, which sum in the kernels' order and hold
no more than a few ray positions' terms at a time; on the GPU they are what
the kernels are checked against.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

#: Launches of S1's forward kernel in this process: one a splat (the second
#: pass that sums the spans' partials is not counted). Reset it to 0 to count
#: the launches of one run.
SPLAT_LAUNCHES = 0
#: Launches of S1's adjoint kernel: one a backward (the second pass of the
#: per-bin sums, launched only when the grid's centres or widths need a
#: gradient, is not counted).
SPLAT_BWD_LAUNCHES = 0

#: Rays a stage of S1's dense forward holds; a span is a multiple of it.
SPLAT_CHUNK = 32
#: The blocks of S1's dense forward an H100 holds at once: 132 SMs, two
#: blocks each (at the default configuration's grid). :func:`splat_span`
#: sizes the spans to fill them.
SPLAT_SLOTS = 132 * 2
#: The groups of :func:`grouped_sum`: column tiles of 8 bins, this many a
#: group (S1's adjoint sums a ray's terms by them).
SPLAT_GROUP_TILES = 5
#: The most bins (n_y x n_x/2) of a half grid on which S1's forward runs its
#: dense kernel (every ray's term at every bin); larger grids take its
#: windowed kernels (:func:`splat_fwd_windowed`). Both give the plain
#: version's bits; the crossover was measured on an H100 (PERF.md,
#: ``chip_smoke.py --s1-crossover``).
SPLAT_DENSE_BINS = 3000
#: The windows' threshold (``csrc/psf_splat.cuh`` ``q_max``): a factor
#: exp(-q / 2) of q = ((v - c)^2) / sigma^2 above it is exactly 0
#: (``exp_zero_probe`` checks the card's exp; 210 is 14.5 sigma, 7.2 bins at
#: compute_psf's sigma of half a bin; 1500, 19.4 bins, is past the card's
#: exp's cut-off of -745 to +0, ``csrc/psf_splat.cuh``). S1's adjoint and
#: its windowed forward sum each ray only over the bins of its windows.
SPLAT_Q_MAX = {torch.float32: 210.0, torch.float64: 1500.0}


def splat_span(n_rays: int, n_pairs: int) -> int:
    """Rays a span, S1's grid rule and the order of its sums: each (grid,
    channel) pair's rays are cut into ``SPLAT_SLOTS // n_pairs`` spans (at
    least one) of equal length, rounded up to a multiple of ``SPLAT_CHUNK``,
    so that pairs x spans fills the forward's resident blocks in one wave
    where the pairs allow it (the default configuration: 63 pairs x 4 spans
    of 16,384 rays, 252 blocks on 264 slots) and the last span is all but
    full. A span's rays are summed in order (one block of S1), then the
    spans' sums in order; the plain versions cut the rays alike. A function
    of the shape alone, not of the card."""
    n_spans = max(1, SPLAT_SLOTS // max(1, int(n_pairs)))
    per = -(-int(n_rays) // n_spans)
    return max(1, -(-per // SPLAT_CHUNK)) * SPLAT_CHUNK


def splat_fwd_windowed(ny: int, nx: int) -> bool:
    """Whether S1's forward runs its windowed kernels on an ny x nx half
    grid: above ``SPLAT_DENSE_BINS`` bins; else its dense kernel. The two
    give the same bits; a function of the shape alone."""
    return ny * nx > SPLAT_DENSE_BINS


def _ruled(centres: torch.Tensor, s2: torch.Tensor) -> bool:
    """Whether S1 takes windows on an axis: its centres finite and ascending
    and s2 = sigma * sigma finite and positive."""
    return (bool(torch.isfinite(centres).all()) and bool((centres[1:] >= centres[:-1]).all())
            and bool(torch.isfinite(s2)) and float(s2) > 0)


def splat_window(v: torch.Tensor, centres: torch.Tensor, s2: torch.Tensor):
    """The window rule of S1's windowed forward and adjoint on one axis, for
    the tests (nothing on the main path calls it): v (R,) the rays'
    coordinates, centres (n,), s2 = sigma * sigma, all of one type. A ray's
    window is the bins [lo, hi] whose q = ((v - c)^2) / s2 (in that type, as
    :func:`_gauss` takes it) is at most ``SPLAT_Q_MAX``, an interval when
    the centres ascend; outside it every factor is exactly 0. The whole axis
    where the centres are not finite and ascending, s2 is not finite and
    positive, or v is not finite (the kernels then take the whole grid, and
    also for the other cases their headers name). Returns (lo, hi), int64
    (R,); an empty window has hi = lo - 1."""
    n = centres.shape[-1]
    d = v[:, None] - centres[None, :]
    inside = (d * d) / s2 <= SPLAT_Q_MAX[v.dtype]
    first = inside.to(torch.int64).argmax(dim=1)
    last = n - 1 - inside.flip(1).to(torch.int64).argmax(dim=1)
    some = inside.any(dim=1)
    lo = torch.where(some, first, torch.zeros_like(first))
    hi = torch.where(some, last, torch.full_like(last, -1))
    whole = ~torch.isfinite(v) | (not _ruled(centres, s2))
    return (torch.where(whole, torch.zeros_like(lo), lo),
            torch.where(whole, torch.full_like(hi, n - 1), hi))


def splat_over_windows(x: torch.Tensor, y: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                       sigma_x: torch.Tensor, sigma_y: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain twin of S1's windowed forward, for the tests (nothing on the
    main path calls it): each bin's span sum taken only over the rays whose
    windows (:func:`splat_window`, each axis) hold it, in ray order from 0.0
    in float64, then the spans in order, rounded once. A ray whose x, y or
    weight is not finite, and every ray of a grid whose centres or sigma^2
    are not ruled on either axis, takes the whole grid; a ray of zero weight
    or an empty window none. Arguments as :func:`splat_reference`'s, whose
    bits it gives: the terms it leaves out are +-0."""
    g, C, R = x.shape
    ny, nx = gy.shape[1], gx.shape[1]
    span = splat_span(R, g * C)
    out = torch.zeros((g, C, ny, nx), dtype=torch.float64)
    for i in range(g):
        s2x, s2y = sigma_x[i] * sigma_x[i], sigma_y[i] * sigma_y[i]
        ruled = _ruled(gx[i], s2x) and _ruled(gy[i], s2y)
        for c in range(C):
            xs, ys = x[i, c], y[i, c]
            w = torch.ones_like(xs) if weights is None else weights[i, c]
            xlo, xhi = splat_window(xs, gx[i], s2x)
            ylo, yhi = splat_window(ys, gy[i], s2y)
            whole = ~(torch.isfinite(xs) & torch.isfinite(ys) & torch.isfinite(w)) | (not ruled)
            xlo, ylo = (torch.where(whole, 0, a) for a in (xlo, ylo))
            xhi, yhi = torch.where(whole, nx - 1, xhi), torch.where(whole, ny - 1, yhi)
            none = ~whole & ((w == 0) | (xlo > xhi) | (ylo > yhi))
            for r0 in range(0, R, span):
                acc = torch.zeros((ny, nx), dtype=torch.float64)
                for r in range(r0, min(R, r0 + span)):
                    if none[r]:
                        continue
                    rows = slice(int(ylo[r]), int(yhi[r]) + 1)
                    cols = slice(int(xlo[r]), int(xhi[r]) + 1)
                    ex = _gauss(xs[r], gx[i, cols], s2x)
                    eyw = _gauss(ys[r], gy[i, rows], s2y)
                    if weights is not None:
                        eyw = eyw * w[r]
                    acc[rows, cols] += eyw.double()[:, None] * ex.double()[None, :]
                out[i, c] += acc
    return out.to(x.dtype)


def _gauss(v: torch.Tensor, centres: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """exp(-(((v - c)^2) / s2) / 2), each operation rounded in v's type, in the
    JAX formula's order: v (..., 1) against the centres (..., n)."""
    d = v - centres
    return torch.exp(-((d * d) / s2) / 2)


def _spans(a: torch.Tensor, span: int, n_spans: int) -> torch.Tensor:
    """(g, C, R) -> (g, C, n_spans, span), the tail padded with zeros."""
    pad = n_spans * span - a.shape[-1]
    return torch.nn.functional.pad(a, (0, pad)).reshape(*a.shape[:2], n_spans, span)


def splat_reference(x: torch.Tensor, y: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                    sigma_x: torch.Tensor, sigma_y: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel S1: half[g, c, iy, ix] = sum_r ex[r, ix] ·
    eyw[r, iy], with ex = exp(-(((x - gx)^2) / sigma_x^2) / 2) and eyw the
    same in y times the ray's weight, each factor in the inputs' type.

    x, y (g, C, R) (y already shifted to the grid's centre), gx (g, n_x/2),
    gy (g, n_y), sigma_x, sigma_y (g,), weights (g, C, R) or None; returns
    (g, C, n_y, n_x/2) in the inputs' type. The kernel's order: the rays of
    each pair are cut into spans (:func:`splat_span`); each span's sum runs
    over its rays in order from 0.0 in float64 (a product of two float32
    factors is exact there), a loop over the ray positions vectorised across
    spans and bins; then each bin's span sums are added in span order from
    0.0 and rounded once. Past R the factors are zero."""
    g, C, R = x.shape
    span = splat_span(R, g * C)
    n_spans = -(-R // span)
    f64 = dict(dtype=torch.float64, device=x.device)
    xs, ys = _spans(x, span, n_spans), _spans(y, span, n_spans)
    ws = None if weights is None else _spans(weights, span, n_spans)
    valid = (torch.arange(n_spans * span, device=x.device) < R).reshape(n_spans, span)
    gx4, gy4 = gx[:, None, None, :], gy[:, None, None, :]
    s2x = (sigma_x * sigma_x)[:, None, None, None]
    s2y = (sigma_y * sigma_y)[:, None, None, None]
    acc = torch.zeros((g, C, n_spans, gy.shape[1], gx.shape[1]), **f64)
    term = torch.empty_like(acc)
    for r in range(span):
        ex = _gauss(xs[..., r, None], gx4, s2x)                # (g, C, spans, n_x/2)
        eyw = _gauss(ys[..., r, None], gy4, s2y)               # (g, C, spans, n_y)
        if ws is not None:
            eyw = eyw * ws[..., r, None]
        eyw = torch.where(valid[:, r, None], eyw, torch.zeros((), dtype=eyw.dtype,
                                                              device=eyw.device))
        torch.mul(eyw.double()[..., :, None], ex.double()[..., None, :], out=term)
        acc += term
    total = torch.zeros((g, C) + acc.shape[3:], **f64)
    for s in range(n_spans):
        total += acc[:, :, s]
    return total.to(x.dtype)


def _ordered_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order from 0.0."""
    s = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for i in range(a.shape[-1]):
        s = s + a[..., i]
    return s


def grouped_sum(a: torch.Tensor) -> torch.Tensor:
    """S1's adjoint's sum of a ray's terms over its n bins (the last axis),
    in two levels as the kernel's threads hold them: the bins fall into 4 J
    groups (j, t), J = ceil(n / 40), group (j, t) holding the bins 40 j + 8 k
    + 2 t + e (k < ``SPLAT_GROUP_TILES``, e < 2) that are below n; each
    group's bins are summed in index order from 0.0, then the group sums in
    order (j, then t) from 0.0."""
    n = a.shape[-1]
    tiles = SPLAT_GROUP_TILES
    groups = np.arange(-(-n // (8 * tiles)) * 8 * tiles).reshape(-1, tiles, 4, 2)
    total = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for bins in groups.transpose(0, 2, 1, 3).reshape(-1, 2 * tiles):
        s = torch.zeros_like(total)
        for b in bins[bins < n]:
            s = s + a[..., b]
        total = total + s
    return total


def splat_backward_reference(x: torch.Tensor, y: torch.Tensor, gx: torch.Tensor,
                             gy: torch.Tensor, sigma_x: torch.Tensor, sigma_y: torch.Tensor,
                             weights: Optional[torch.Tensor], cotangent: torch.Tensor,
                             bins: bool = False, weights_grad: bool = False):
    """Plain version of S1's adjoint: the gradients of :func:`splat_reference`
    for the cotangent G (g, C, n_y, n_x/2), in float64 and the kernel's order.

    Per ray, with the factors ex, ey recomputed as the forward takes them (ey
    without the weight w), in float64: A[ix] = sum_iy G[iy, ix] ey[iy] and
    B[iy] = sum_ix G[iy, ix] ex[ix] in index order from 0.0; tx[ix] = ((A ·
    ex) · qx) · w with qx = (x - gx) · (1 / sigma_x^2), ty[iy] = ((B · ey) ·
    qy) · w; d/dx = -sum_ix tx, d/dy = -sum_iy ty, d/dw = sum_iy B · ey, each
    a :func:`grouped_sum` rounded once. With ``bins``, the grid's
    gradients: d/dgx[ix] = sum tx and d/dsigma_x = sum tx · (x - gx) ·
    (1 / sigma_x) (y alike): each span's rays summed in order per bin, then
    per grid over (channel, span) in order; d/dsigma_x sums the bins' totals
    in order last. Returns (dx, dy, dgx, dgy, dsigma_x, dsigma_y, dweights),
    None where not asked for; the per-ray parts a loop over the ray
    positions' blocks, vectorised across spans and rays."""
    g, C, R = x.shape
    ny, nx = gy.shape[1], gx.shape[1]
    span = splat_span(R, g * C)
    n_spans = -(-R // span)
    dt, dev = x.dtype, x.device
    xs, ys = _spans(x, span, n_spans), _spans(y, span, n_spans)
    ws = None if weights is None else _spans(weights, span, n_spans)
    valid = (torch.arange(n_spans * span, device=dev) < R).reshape(n_spans, span)
    s2x = (sigma_x * sigma_x)[:, None, None, None, None]
    s2y = (sigma_y * sigma_y)[:, None, None, None, None]
    sxd, syd = sigma_x.double(), sigma_y.double()
    inv2 = [(1.0 / (s * s))[:, None, None, None, None] for s in (sxd, syd)]
    inv1 = [(1.0 / s)[:, None, None, None, None] for s in (sxd, syd)]
    gxd, gyd = gx.double()[:, None, None, None, :], gy.double()[:, None, None, None, :]
    G = cotangent.double()[:, :, None, None]                    # (g, C, 1, 1, n_y, n_x/2)
    per_ray = {k: torch.zeros((g, C, n_spans, span), dtype=torch.float64, device=dev)
               for k in ("dx", "dy", "dw")}
    part = {k: torch.zeros((g, C, n_spans, n), dtype=torch.float64, device=dev)
            for k, n in (("gx", nx), ("sx", nx), ("gy", ny), ("sy", ny))}
    block = max(1, min(span, 4_000_000 // max(1, g * C * n_spans * (nx + ny))))
    for r0 in range(0, span, block):
        sl = slice(r0, min(span, r0 + block))
        xb, yb = xs[..., sl, None], ys[..., sl, None]           # (g, C, spans, b, 1)
        ex = _gauss(xb, gx[:, None, None, None, :], s2x).double()
        ey = _gauss(yb, gy[:, None, None, None, :], s2y).double()
        A = torch.zeros(ex.shape, dtype=torch.float64, device=dev)
        for iy in range(ny):
            A = A + ey[..., iy, None] * G[..., iy, :]
        B = torch.zeros(ey.shape, dtype=torch.float64, device=dev)
        for ix in range(nx):
            B = B + ex[..., ix, None] * G[..., :, ix]
        dxv, dyv = xb.double() - gxd, yb.double() - gyd
        tx = (A * ex) * (dxv * inv2[0])
        be = B * ey
        ty = be * (dyv * inv2[1])
        if ws is not None:
            w = ws[..., sl, None].double()
            tx, ty = tx * w, ty * w
        per_ray["dx"][..., sl] = -grouped_sum(tx)
        per_ray["dy"][..., sl] = -grouped_sum(ty)
        if weights_grad:
            per_ray["dw"][..., sl] = grouped_sum(be)
        if bins:
            # Past R a term is zero (the kernel skips those rays).
            ok = valid[:, sl, None]
            zero = torch.zeros((), dtype=torch.float64, device=dev)
            vx, vy = tx * (dxv * inv1[0]), ty * (dyv * inv1[1])
            tx, ty, vx, vy = (torch.where(ok, a, zero) for a in (tx, ty, vx, vy))
            for j in range(tx.shape[3]):
                part["gx"] += tx[:, :, :, j]
                part["sx"] += vx[:, :, :, j]
                part["gy"] += ty[:, :, :, j]
                part["sy"] += vy[:, :, :, j]
    dx, dy, dw = (per_ray[k].reshape(g, C, -1)[..., :R].to(dt) for k in ("dx", "dy", "dw"))
    dgx = dgy = dsx = dsy = None
    if bins:
        tot = {k: torch.zeros((g, v.shape[-1]), dtype=torch.float64, device=dev)
               for k, v in part.items()}
        for c in range(C):
            for s in range(n_spans):
                for k in tot:
                    tot[k] += part[k][:, c, s]
        dgx, dgy = tot["gx"].to(dt), tot["gy"].to(dt)
        dsx, dsy = _ordered_sum(tot["sx"]).to(dt), _ordered_sum(tot["sy"]).to(dt)
    return dx, dy, dgx, dgy, dsx, dsy, (dw if weights_grad else None)


def dmma_probe_inputs(seed: int = 0, n_random: int = 128) -> dict:
    """The cases of S1's tensor-core probe (``csrc/psf_splat_probe.cu``),
    {label: (A (n, 16, 4), B (n, 4, 8), C (n, 16, 8))} in float64, A and B
    float32 values (their products exact in double): ties (every product
    2^-53 against accumulators 1 + j 2^-52, either sign), cancellation
    (2^60 - 2^60 beside 1 and 2^-30, in 16 orders), the terms' order (1,
    2^-53, 2^-53, 2^-54 in every order from 0), random products of normal
    values and of exponents from -30 to 30, and products of float32
    subnormals (normal in double)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, dtype=np.float32).astype(np.float64)
    perms = np.array(list(itertools.permutations(range(4))))     # 24 orders
    cases = {}
    j = np.arange(128, dtype=np.float64).reshape(16, 8)
    B = np.full((2, 4, 8), 2.0 ** -26)
    B[1, 1::2] = -B[1, 1::2]
    cases["ties"] = (np.full((2, 16, 4), 2.0 ** -27), B,
                     np.stack([1.0 + j * 2.0 ** -52, -(1.0 + j * 2.0 ** -52)]))
    big = np.array([2.0 ** 60, -2.0 ** 60, 1.0, 2.0 ** -30])
    cases["cancellation"] = (big[perms[:16]][None], np.ones((1, 4, 8)), np.ones((1, 16, 8)))
    terms = np.array([1.0, 2.0 ** -53, 2.0 ** -53, 2.0 ** -54])
    order = terms[np.concatenate([perms, perms[:8]])].reshape(2, 16, 4)
    cases["order"] = (order, np.ones((2, 4, 8)), np.zeros((2, 16, 8)))
    shape = lambda *s: (n_random,) + s
    cases["random"] = (f32(rng.normal(size=shape(16, 4))), f32(rng.normal(size=shape(4, 8))),
                       rng.normal(size=shape(16, 8)))
    wide = lambda s: f32(rng.choice([-1.0, 1.0], s) * rng.uniform(1.0, 2.0, s)
                         * 2.0 ** rng.integers(-30, 31, s))
    cases["random, exponents -30 to 30"] = (wide(shape(16, 4)), wide(shape(4, 8)),
                                            wide(shape(16, 8)))
    tiny = lambda s: f32(rng.uniform(1.0, 2.0, s) * 2.0 ** rng.integers(-149, -126, s))
    cases["float32 subnormals"] = (tiny(shape(16, 4)), f32(rng.normal(size=shape(4, 8))),
                                   tiny(shape(16, 8)) * 1e-3)
    return cases


def _dmma_models(A, B, C) -> dict:
    """What D = C + A B would be under each order and rounding, in float64
    (every product exact): the chain in k order (fused multiply-adds), the
    chain in reverse order, C + ((p0 + p1) + (p2 + p3)), and one rounding of
    the exact sum."""
    p = A[:, :, :, None] * B[:, None, :, :]                        # (n, 16, k, 8)
    chain, reverse = C.copy(), C.copy()
    for k in range(4):
        chain = chain + p[:, :, k]
        reverse = reverse + p[:, :, 3 - k]
    pairwise = C + ((p[:, :, 0] + p[:, :, 1]) + (p[:, :, 2] + p[:, :, 3]))
    terms = np.concatenate([C[:, :, None], p], axis=2).transpose(0, 1, 3, 2).reshape(-1, 5)
    once = np.array([math.fsum(t) for t in terms]).reshape(C.shape)
    return {"fma chain in k order": chain, "chain in reverse order": reverse,
            "pairwise": pairwise, "one rounding of the exact sum": once}


#: The shapes S1's probe runs: {name: (mma.sync shape, rows of D it computes)}.
DMMA_SHAPES = {"m8n8k4": (0, 8), "m16n8k4": (1, 16)}


def dmma_probe(seed: int = 0) -> dict:
    """Run S1's tensor-core probe on the card: one ``mma.sync ... .f64`` a
    case, m8n8k4 and m16n8k4 (``DMMA_SHAPES``), against the chain of fma()
    in k order on the same lanes (``csrc/psf_splat_probe.cu``), on
    :func:`dmma_probe_inputs`. Returns {shape: {label: {"entries": n,
    "differ": entries whose bits differ from the chain, "fma_chain_ok": the
    device chain equals the float64 chain, "models": the orders and
    roundings (``_dmma_models``) whose bits the instruction gave on every
    entry}}}; every "differ" is 0 when S1's float32 route may take its
    products on the tensor cores (it runs m16n8k4)."""
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    bits = lambda a: a.view(np.int64)
    out = {}
    for shape, (m16, rows) in DMMA_SHAPES.items():
        out[shape] = {}
        for label, (A, B, C) in dmma_probe_inputs(seed).items():
            dev = [torch.tensor(np.ascontiguousarray(a), dtype=torch.float64, device="cuda")
                   for a in (A, B, C)]
            d_mma, d_fma = torch.empty_like(dev[2]), torch.empty_like(dev[2])
            err = lib.s1_dmma_probe(*[a.data_ptr() for a in dev], d_mma.data_ptr(),
                                    d_fma.data_ptr(), A.shape[0], m16,
                                    torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"S1's tensor-core probe failed: "
                                   f"{lib.k1_error_string(err).decode()}")
            torch.cuda.synchronize()
            mma, fma = d_mma.cpu().numpy()[:, :rows], d_fma.cpu().numpy()
            models = _dmma_models(A, B, C)
            out[shape][label] = {
                "entries": int(mma.size), "differ": int((bits(mma) != bits(fma[:, :rows])).sum()),
                "fma_chain_ok": bool((bits(fma) == bits(models["fma chain in k order"])).all()),
                "models": [k for k, v in models.items()
                           if (bits(v[:, :rows]) == bits(mma)).all()]}
    return out


def exp_zero_probe() -> dict:
    """Run S1's windows' threshold probe on the card
    (``csrc/psf_splat_probe.cu``): the factor exp(-q / 2) of every float32
    q above ``SPLAT_Q_MAX`` (and +inf); of float64 q, every double in
    (q_max, q_max + 1], 2^26 spread up to +inf, and the binades' end points
    up to the last finite double (and +inf). Returns {"float32" | "float64
    band" | "float64 spread" | "float64 binade ends": {"q_max": the
    library's, "checked": q's, "nonzero": factors that are not 0, "least":
    the least such q or None}}; every "nonzero" is 0 when the windows are
    exact."""
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    out = {}
    for label, dbl, kind in (("float32", 0, 0), ("float64 band", 1, 0), ("float64 spread", 1, 1),
                             ("float64 binade ends", 1, 2)):
        res = torch.tensor([0, -1], dtype=torch.int64, device="cuda")
        err = lib.s1_exp_zero_probe(dbl, kind, res.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"S1's window threshold probe failed: "
                               f"{lib.k1_error_string(err).decode()}")
        bad, least = (int(v) for v in res.cpu().numpy().view(np.uint64))
        q = None
        if bad:
            q = float(np.array([least], np.uint64).view(np.float64)[0] if dbl
                      else np.array([least], np.uint32).view(np.float32)[0])
        out[label] = {"q_max": lib.s1_q_max(dbl), "checked": int(lib.s1_exp_zero_samples(
            dbl, kind)), "nonzero": bad, "least": q}
    return out


def splat_argument_error(x_shape, gx_shape, gy_shape):
    """Why S1 would refuse rays of ``x_shape`` (g, C, R) on a half grid of
    gx (g, n_x/2) and gy (g, n_y), or None: the launchers' checks in
    ``csrc/psf_splat_*.cu``, with no library needed. Any grid of at least
    one bin each way is taken."""
    if len(x_shape) != 3 or len(gx_shape) != 2 or len(gy_shape) != 2 or not (
            gx_shape[0] == gy_shape[0] == x_shape[0]):
        return (f"S1 takes rays (g, C, R) and grids (g, n_x/2), (g, n_y); got {tuple(x_shape)}, "
                f"{tuple(gx_shape)}, {tuple(gy_shape)}")
    ny, nx = gy_shape[1], gx_shape[1]
    if ny < 1 or nx < 1:
        return f"S1 takes half grids of at least one row and one column; got {ny} x {nx}"
    return None


def _check_splat_inputs(tensors: dict):
    """Raise unless ``tensors`` are contiguous, of x's type (float32 or
    float64) and on x's device, and the launcher takes their shapes."""
    device, dtype = tensors["x"].device, tensors["x"].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"S1 takes float32 or float64, got {dtype}")
    for name, a in tensors.items():
        if a is None:
            continue
        if a.dtype != dtype or a.device != device or not a.is_contiguous():
            raise ValueError(f"S1 takes contiguous {dtype} {name} on one device, got "
                             f"{a.dtype} on {a.device}")
    g, C, R = tensors["x"].shape
    for name in ("y", "weights"):
        if tensors.get(name) is not None and tuple(tensors[name].shape) != (g, C, R):
            raise ValueError(f"{name} {tuple(tensors[name].shape)} must be x's {(g, C, R)}")
    for name in ("sigma_x", "sigma_y"):
        if tuple(tensors[name].shape) != (g,):
            raise ValueError(f"{name} {tuple(tensors[name].shape)} must be ({g},)")
    error = splat_argument_error((g, C, R), tensors["gx"].shape, tensors["gy"].shape)
    if error:
        raise ValueError(error)


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


def _launch_splat(x, y, gx, gy, sigma_x, sigma_y, weights, windowed: Optional[bool] = None):
    """S1's forward on CUDA tensors, by the route :func:`splat_fwd_windowed`
    picks (``windowed`` forces one)."""
    global SPLAT_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    _check_splat_inputs(dict(x=x, y=y, gx=gx, gy=gy, sigma_x=sigma_x, sigma_y=sigma_y,
                             weights=weights))
    g, C, R = x.shape
    ny, nx = gy.shape[1], gx.shape[1]
    span = splat_span(R, g * C)
    n_spans = -(-R // span)
    if windowed is None:
        windowed = splat_fwd_windowed(ny, nx)
    # Scratch: each (pair, span, bin)'s sum, and on the windowed route each
    # ray's windows (rows and columns, [lo, hi] each) with each (pair, span,
    # band of rows)'s flag.
    partials = torch.empty(g * C * n_spans * ny * nx, dtype=torch.float64, device=x.device)
    windows = (torch.empty(lib.s1_fwd_window_ints(g * C, R, n_spans, ny), dtype=torch.int32,
                           device=x.device) if windowed else None)
    out = torch.empty((g, C, ny, nx), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.s1_fwd_launch(x.data_ptr(), y.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                                sigma_x.data_ptr(), sigma_y.data_ptr(), _ptr(weights),
                                partials.data_ptr(), _ptr(windows), out.data_ptr(), g, C, R,
                                ny, nx, span, int(x.dtype == torch.float64), int(windowed),
                                stream)
    if err != 0:
        raise RuntimeError(f"S1 (PSF splat) launch failed: {lib.k1_error_string(err).decode()}")
    SPLAT_LAUNCHES += 1 if g * C * R else 0
    return out


def _launch_splat_bwd(x, y, gx, gy, sigma_x, sigma_y, weights, cotangent, bins, weights_grad):
    """S1's adjoint on CUDA tensors (its windowed kernel, on every grid)."""
    global SPLAT_BWD_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    g, C, R = x.shape
    ny, nx = gy.shape[1], gx.shape[1]
    _check_splat_inputs(dict(x=x, y=y, gx=gx, gy=gy, sigma_x=sigma_x, sigma_y=sigma_y,
                             weights=weights))
    if tuple(cotangent.shape) != (g, C, ny, nx) or cotangent.dtype != x.dtype:
        raise ValueError(f"the cotangent {tuple(cotangent.shape)} {cotangent.dtype} must be "
                         f"{(g, C, ny, nx)} {x.dtype}")
    span = splat_span(R, g * C)
    n_spans = -(-R // span)
    new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    dx, dy = new(g, C, R), new(g, C, R)
    dw = new(g, C, R) if weights_grad else None
    dgx, dgy, dsx, dsy = (new(g, nx), new(g, ny), new(g), new(g)) if bins else (None,) * 4
    partials = (torch.empty(g * (C * n_spans * 2 + 1) * (nx + ny), dtype=torch.float64,
                            device=x.device) if bins else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.s1_bwd_launch(
            x.data_ptr(), y.data_ptr(), gx.data_ptr(), gy.data_ptr(), sigma_x.data_ptr(),
            sigma_y.data_ptr(), _ptr(weights), cotangent.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), _ptr(dw), _ptr(partials), _ptr(dgx), _ptr(dgy), _ptr(dsx), _ptr(dsy),
            g, C, R, ny, nx, span, int(x.dtype == torch.float64), int(bins), stream)
    if err != 0:
        raise RuntimeError(f"S1's adjoint launch failed: {lib.k1_error_string(err).decode()}")
    SPLAT_BWD_LAUNCHES += 1 if g * C * R else 0
    return dx, dy, dgx, dgy, dsx, dsy, dw


def _splat(x, y, gx, gy, sigma_x, sigma_y, weights):
    if x.device.type == "cpu":
        return splat_reference(x, y, gx, gy, sigma_x, sigma_y, weights)
    return _launch_splat(x, y, gx, gy, sigma_x, sigma_y, weights)


class _Splat(torch.autograd.Function):
    """Kernel S1 with its hand adjoint: on CUDA tensors ``csrc/psf_splat_fwd.cu``
    and ``csrc/psf_splat_bwd.cu`` (its per-bin sums only when the grid's
    centres or widths need a gradient), on CPU tensors their plain versions."""

    @staticmethod
    def forward(ctx, x, y, gx, gy, sigma_x, sigma_y, weights):
        ctx.save_for_backward(x, y, gx, gy, sigma_x, sigma_y, weights)
        return _splat(x, y, gx, gy, sigma_x, sigma_y, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, cotangent):
        x, y, gx, gy, sigma_x, sigma_y, weights = ctx.saved_tensors
        need = ctx.needs_input_grad
        bins = any(need[2:6])
        weights_grad = weights is not None and need[6]
        args = (x, y, gx, gy, sigma_x, sigma_y, weights, cotangent.contiguous(), bins,
                weights_grad)
        grads = (splat_backward_reference(*args) if x.device.type == "cpu"
                 else _launch_splat_bwd(*args))
        return tuple(d if n else None for d, n in zip(grads, need))


def splat(x: torch.Tensor, y: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
          sigma_x: torch.Tensor, sigma_y: torch.Tensor,
          weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The half-grid splat of :func:`compute_psf`: kernel S1 on CUDA tensors,
    :func:`splat_reference` on CPU tensors; differentiable in every input
    (``_Splat``). Arguments as :func:`splat_reference`'s."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"S1 runs on CUDA or CPU tensors, got {x.device}")
    args = [x, y, gx, gy, sigma_x, sigma_y, weights]
    if x.device.type == "cuda":
        args = [None if a is None else a.contiguous() for a in args]
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return _Splat.apply(*args)
    return _splat(*args)


def compute_psf(x: torch.Tensor, y: torch.Tensor, n_bins: Tuple[int, int] = (21, 21),
                increment: Optional[float] = None, y_target: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None):
    """Soft-histogram PSF per (system, field) grid.

    Args:
      x, y: spot coordinates, (n_lens, n_fields, n_channels, n_rays)
        (channels before rays).
      n_bins: (n_x_bins, n_y_bins) PSF grid size.
      increment: pixel pitch; None sizes the grid from the data extents.
      y_target: (n_lens * n_fields,) grid centres; None uses the y centroid.
      weights: optional per-ray splat weights, broadcastable to
        (n_lens * n_fields, n_channels, n_rays): they assign wavelengths to
        colour channels (zero weight = the ray is invisible to the channel);
        the accounted fraction is weighted alike.

    Returns:
      (x_size, y_size, y_target, kernels, accounted_ray_proportion), kernels
      (n_grids, n_channels, n_y_bins, n_x_bins).
    """
    nw = x.shape[-2]
    n_grids = x.shape[0] * x.shape[1]
    n_x_bins, n_y_bins = n_bins
    dtype, device = x.dtype, x.device

    if y_target is None:
        y_target = torch.mean(y.reshape(n_grids, -1), dim=1)
    y = y.reshape(n_grids, nw, -1) - y_target[:, None, None]
    x = x.reshape(n_grids, nw, -1)

    if increment is not None:
        x_incr = y_incr = torch.full((n_grids,), increment, dtype=dtype, device=device)
        x_size = torch.full((n_grids,), increment * n_x_bins, dtype=dtype, device=device)
        y_size = torch.full((n_grids,), increment * n_y_bins, dtype=dtype, device=device)
    else:
        y_min = torch.amin(y.reshape(n_grids, -1), dim=1)
        y_max = torch.amax(y.reshape(n_grids, -1), dim=1)
        x_size = torch.amax(x.reshape(n_grids, -1), dim=1)
        y_size = 2 * torch.maximum(y_max, -y_min)
        x_incr = x_size / n_x_bins
        y_incr = y_size / n_y_bins

    # Half-grid pixel centres in x (the meridional symmetry fold).
    if n_x_bins % 2 == 1:
        gx = torch.arange(n_x_bins // 2 + 1, dtype=dtype, device=device)[None, :] * x_incr[:, None]
    else:
        gx = ((torch.arange(n_x_bins // 2, dtype=dtype, device=device) + 0.5)[None, :]
              * x_incr[:, None])
    gy = ((torch.arange(n_y_bins, dtype=dtype, device=device) + 0.5 - n_y_bins / 2)[None, :]
          * y_incr[:, None])

    sigma_x = x_incr / 2
    sigma_y = y_incr / 2
    if weights is not None:
        weights = torch.broadcast_to(torch.as_tensor(weights, dtype=dtype, device=device),
                                     x.shape)                    # (g, nw, n_rays)
    kernels = splat(x, y, gx, gy, sigma_x, sigma_y, weights)     # (g, nw, n_y, n_x_half)

    if n_x_bins % 2 == 1:
        kernels = torch.cat((torch.flip(kernels[..., 1:], dims=(-1,)), kernels), dim=-1)
    else:
        kernels = torch.cat((torch.flip(kernels, dims=(-1,)), kernels), dim=-1)

    # The floor guards channels with no assigned wavelength (W < channels); a
    # real channel's Gaussian sum is strictly positive, so it is exact there.
    kernels = kernels / torch.clamp(torch.sum(kernels, dim=(-1, -2), keepdim=True), min=1e-20)

    accounted = ((torch.abs(y) < y_size[:, None, None] / 2)
                 & (torch.abs(x) < x_size[:, None, None] / 2)).to(dtype)
    if weights is None:
        accounted_ray_proportion = torch.mean(accounted, dim=(-1, -2))
    else:
        wsum = torch.clamp(torch.sum(weights, dim=(-1, -2)), min=1e-20)
        accounted_ray_proportion = torch.sum(accounted * weights, dim=(-1, -2)) / wsum
    return x_size, y_size, y_target, kernels, accounted_ray_proportion


def compute_mtf(psf: torch.Tensor, pixel_size: float):
    """Geometric MTF from a sampled PSF: the magnitude of the 1-D transforms
    of its line-spread functions, each normalized by its DC term.

    Args:
      psf: (..., n_y, n_x) sampled PSF (any non-negative normalization).
      pixel_size: PSF grid pitch in mm.

    Returns:
      dict with ``freqs_t`` / ``mtf_t``, the tangential cut (modulation
      along y; (n_y//2+1,) and (..., n_y//2+1)), and ``freqs_s`` / ``mtf_s``,
      the sagittal cut (along x). Frequencies in cycles / mm.
    """
    n_y, n_x = psf.shape[-2], psf.shape[-1]
    lsf_y = torch.sum(psf, dim=-1)
    lsf_x = torch.sum(psf, dim=-2)
    mtf_t = torch.abs(torch.fft.rfft(lsf_y, dim=-1))
    mtf_s = torch.abs(torch.fft.rfft(lsf_x, dim=-1))
    mtf_t = mtf_t / torch.clamp(mtf_t[..., :1], min=1e-20)
    mtf_s = mtf_s / torch.clamp(mtf_s[..., :1], min=1e-20)
    as_t = lambda a: torch.as_tensor(a, dtype=psf.dtype, device=psf.device)
    return {"freqs_t": as_t(np.fft.rfftfreq(n_y, d=pixel_size)), "mtf_t": mtf_t,
            "freqs_s": as_t(np.fft.rfftfreq(n_x, d=pixel_size)), "mtf_s": mtf_s}


def channel_assignment(n_wavelengths: int, n_channels: int = 3):
    """Static wavelength -> colour-channel map: consecutive groups, sized as
    evenly as possible (``channel_of[i] = i * C // W``)."""
    return [i * n_channels // n_wavelengths for i in range(n_wavelengths)]


def sample_psfs(x: torch.Tensor, y: torch.Tensor, y_center: torch.Tensor,
                psf_size: Tuple[int, int], psf_increment: float, n_channels: int = 3):
    """Sample per-field PSFs from trace outputs.

    Args:
      x, y: (1, n_fields, n_pupil, n_wavelengths) spot coordinates.
      y_center: (n_fields,) PSF grid centres on the image plane.
      n_channels: colour channels of the rendered image. Wavelengths are
        grouped into channels by :func:`channel_assignment`.

    Returns:
      (psfs, accounted_energy): psfs (n_fields, n_y, n_x, n_channels),
      flipped vertically to image orientation.
    """
    W = x.shape[-1]
    x = x.permute(0, 1, 3, 2)                                  # (1, F, W, P)
    y = y.permute(0, 1, 3, 2)
    weights = None
    if W % n_channels == 0:
        # Even grouping: an exact reshape, no redundant splats.
        x = x.reshape(*x.shape[:2], n_channels, -1)
        y = y.reshape(*y.shape[:2], n_channels, -1)
    else:
        # Uneven W: every ray splats into every channel with a static one-hot
        # weight selecting its assigned channel.
        ch = np.asarray(channel_assignment(W, n_channels))
        onehot = ch[None, :] == np.arange(n_channels)[:, None]
        P = x.shape[-1]
        weights = torch.as_tensor(np.repeat(onehot, P, axis=1)[None], dtype=x.dtype,
                                  device=x.device)            # (1, C, W*P)
        x = torch.broadcast_to(x.reshape(*x.shape[:2], 1, -1),
                               x.shape[:2] + (n_channels, W * P))
        y = torch.broadcast_to(y.reshape(*y.shape[:2], 1, -1),
                               y.shape[:2] + (n_channels, W * P))

    # Mirror every ray in x (meridional symmetry).
    x = torch.cat((x, -x), dim=3)
    y = torch.cat((y, y), dim=3)
    if weights is not None:
        weights = torch.cat((weights, weights), dim=2)

    *_, psfs, accounted = compute_psf(x, y, n_bins=psf_size, increment=psf_increment,
                                      y_target=y_center, weights=weights)
    psfs = psfs.permute(0, 2, 3, 1)                            # (F, n_y, n_x, C)
    return torch.flip(psfs, dims=(1,)), accounted
