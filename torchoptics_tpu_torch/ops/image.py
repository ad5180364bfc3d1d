"""Image formation: spatially-varying convolution, warping, image quality.

PyTorch counterpart of ``torchoptics_tpu.ops.image``:

* :func:`svola_convolution`: Spatially-Varying OverLap-Add convolution.
  Overlapping patches of the symmetric-padded image, each convolved with its
  local PSF by kernel P2 (:func:`svola_patch_conv`), then a windowed
  recomposition. P2 has two routes, chosen by the PSF's width on both
  devices: below ``P2_FFT_MIN_KW`` taps the direct kh x kw tap sum of the
  valid convolution (``csrc/svola_conv.cu``), from there a hand-written FFT
  convolution at the reference's fast lengths, 2^a 3^b 5^c
  (``csrc/svola_fft.cu``), the JAX package's own algorithm. It is
  differentiable: d/dpsf has kernels of its
  own (``csrc/svola_conv_bwd.cu``, or the FFT route's correlation from
  ``P2_DPSF_FFT_MIN_KW`` taps), d/dpatch is P2 on the padded cotangent with
  the flipped PSFs.
* :func:`interpolate_bicubic`: the Keys bicubic (alpha = -0.75) gather
  resampler, and the distortion warps built on the same weights
  (:func:`warp_bicubic_shifts`, :func:`warp_bicubic_separable`, the default).
  The JAX package writes the two shift warps as tap sums over a static band
  of 2M + 5 shifted slices, because gathers are slow on a TPU; here each is
  a 4-neighbour gather with the same coordinate and band clamps and the
  same Keys weights, summed in the order of the tap sums' nonzero terms.
* PSF grid interpolation, rotation and resizing, and the distortion and
  relative-illumination maps.
* :func:`psnr` and :func:`ssim` (SSIM's Gaussian filter as separable slice
  sums, so no convolution reaches cuDNN and its TF32 default).

Static geometry (the field map, the per-patch PSF weights, the overlap-add
weights, the rotation angles and the resize weights) and the FFT route's
twiddle table are numpy. Nothing here runs a matrix product, an FFT or a
convolution library call, so
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.allow_tf32``
do not reach it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

#: Launches of kernel P2's direct route in this process (the forward, and
#: d/dpatch in a backward): one a call. Reset it to 0 to count the launches
#: of one run.
P2_LAUNCHES = 0
#: Launches of P2's d/dpsf kernel: one per group of patch-channels (one at
#: config 5's 1024^2 render, whose partials fit one group); the second pass
#: that follows each is not counted.
P2_DPSF_LAUNCHES = 0
#: Launches of P2's FFT route (``csrc/svola_fft.cu``; the forward, and
#: d/dpatch in a backward): three kernels a call, each counted; a patch
#: longer than ``P2_FFT_TILE`` takes a call per sub-patch (``fft_tiles``).
P2_FFT_LAUNCHES = 0
#: Launches of the FFT route's d/dpsf: the same three kernels a call.
P2_DPSF_FFT_LAUNCHES = 0

#: PSFs whose larger side has at least this many taps take P2's FFT route
#: (``csrc/svola_fft.cu``; on CPU tensors its plain version), forward and
#: d/dpatch; narrower ones the direct kernel (``csrc/svola_conv.cu``). Set
#: from the two routes' times on an H100 at the renders' shapes (PERF.md):
#: at K = 11 (config 5 at 1024^2) the direct forward was faster; at K = 23
#: (config 5 at 2048^2, the default configuration at 1024^2) the FFT route
#: at its fast lengths (at powers of two it had lost there, and the
#: threshold was 33).
P2_FFT_MIN_KW = 23
#: The same for d/dpsf (``csrc/svola_fft.cu`` or ``csrc/svola_conv_bwd.cu``):
#: the FFT route's correlation was faster from K = 23, the direct kernel at
#: K = 11 (config 5 at 1024^2), before and after the direct kernel's redesign.
P2_DPSF_FFT_MIN_KW = 23
#: The FFT route's transform lengths (``fft_len``): 2^a 3^b 5^c, 16 to 4096
#: points.
P2_FFT_MIN_LEN, P2_FFT_MAX_LEN = 16, 4096
#: The longest patch side one call of the FFT route takes: a longer patch is
#: cut into overlapping sub-patches no longer than this (``fft_tiles``), each
#: through the route's kernels (or plain versions) on its own. At most
#: ``P2_FFT_MAX_LEN``; the tests lower it.
P2_FFT_TILE = P2_FFT_MAX_LEN


def _window(kind: str, n: int) -> np.ndarray:
    xs = np.linspace(0, 1, n + 2)[1:-1]
    if kind == "boxcar":
        return np.ones(n, dtype=np.float32)
    if kind == "hann":
        return (np.sin(np.pi * xs) ** 2).astype(np.float32)
    raise ValueError(f"window_type must be 'boxcar' or 'hann', got {kind!r}")


def pad_symmetric(img: torch.Tensor, pad_h: Tuple[int, int],
                  pad_w: Tuple[int, int]) -> torch.Tensor:
    """numpy's ``mode="symmetric"`` padding (the edge sample mirrored too,
    which ``F.pad``'s ``reflect`` drops) of the H and W axes of a (B, H, W,
    C) tensor, by index gathers that keep the channels-last layout."""
    def index(n, before, after):
        m = np.mod(np.arange(-before, n + after), 2 * n)
        return torch.as_tensor(np.where(m >= n, 2 * n - 1 - m, m), device=img.device)
    _, h, w, _ = img.shape
    return img.index_select(1, index(h, *pad_h)).index_select(2, index(w, *pad_w))


# ---------------------------------------------------------------------------
# Kernel P2: the patch convolution.
# ---------------------------------------------------------------------------


def svola_patch_conv_reference(patches: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel P2: the valid convolution of each patch with
    its PSF, (P, ph, pw, C) and (P, kh, kw, C) -> (P, ph - kh + 1,
    pw - kw + 1, C), out[i, j] = sum_{a, b} psf[kh-1-a, kw-1-b] ·
    patch[i+a, j+b], as kh·kw shifted-slice multiply-adds, a outer, b inner,
    in the order the kernel accumulates."""
    P, ph, pw, C = patches.shape
    kh, kw = psfs.shape[1:3]
    hp, wp = ph - kh + 1, pw - kw + 1
    taps = torch.flip(psfs, dims=(1, 2))
    acc = torch.zeros((P, hp, wp, C), dtype=patches.dtype, device=patches.device)
    for a in range(kh):
        for b in range(kw):
            acc = acc + taps[:, a:a + 1, b:b + 1, :] * patches[:, a:a + hp, b:b + wp, :]
    return acc


def svola_patch_conv_dpatch_reference(cotangent: torch.Tensor, psfs: torch.Tensor
                                      ) -> torch.Tensor:
    """Plain version of P2's adjoint with respect to the patches: the full
    correlation of the cotangent (P, hp, wp, C) with the unflipped taps,
    which is P2 on the cotangent zero-padded by (kh - 1, kw - 1) on each side
    with the flipped PSFs: d[y, x] = sum_{a, b} psf[a, b] · g[y+a-kh+1,
    x+b-kw+1]; by the route the PSFs' width takes, the direct sum or the
    FFT route's plain version."""
    kh, kw = psfs.shape[1:3]
    padded = torch.nn.functional.pad(cotangent, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
    conv = svola_patch_conv_fft_reference if p2_takes_fft((kh, kw)) else svola_patch_conv_reference
    return conv(padded, torch.flip(psfs, dims=(1, 2)))


#: The side of the output tiles over which d/dpsf takes its partial sums.
DPSF_TILE = 32


def svola_patch_conv_dpsf_reference(patches: torch.Tensor, cotangent: torch.Tensor,
                                    kernel_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of P2's d/dpsf kernel: dpsf[p, u, v, c] = sum_{i, j}
    g[p, i, j, c] · patch[p, i+kh-1-u, j+kw-1-v, c], in the kernel's order.
    The outputs are cut into ``DPSF_TILE``² tiles (the tails padded with zero
    cotangents); each tile's partial sum of a tap runs over its positions in
    row-major order from 0, in float64 (each float32 product is exact there),
    a loop over the positions vectorised across tiles and taps; then each
    tap's partials are summed over the tiles in index order from 0 and
    rounded once to the input's type."""
    P, ph, pw, C = patches.shape
    kh, kw = kernel_hw
    hp, wp = ph - kh + 1, pw - kw + 1
    T = DPSF_TILE
    nty, ntx = -(-hp // T), -(-wp // T)
    f64 = dict(dtype=torch.float64, device=patches.device)
    g = torch.zeros((P, nty * T, ntx * T, C), **f64)
    g[:, :hp, :wp] = cotangent
    win = torch.zeros((P, nty * T + kh - 1, ntx * T + kw - 1, C), **f64)
    win[:, :ph, :pw] = patches
    sp, sy, sx, sc = win.stride()
    acc = torch.zeros((P, nty, ntx, kh, kw, C), **f64)
    term = torch.empty_like(acc)
    for ti in range(T):
        for tj in range(T):
            # view[p, ty, tx, a, b, c] = win[p, ty T + ti + a, tx T + tj + b, c]:
            # tap (u, v) = (kh-1-a, kw-1-b) of tile (ty, tx) at (ti, tj).
            view = win.as_strided((P, nty, ntx, kh, kw, C), (sp, T * sy, T * sx, sy, sx, sc),
                                  ti * sy + tj * sx)
            torch.mul(g[:, ti::T, tj::T, None, None, :], view, out=term)
            acc += term
    total = torch.zeros((P, kh, kw, C), **f64)
    for t in range(nty * ntx):
        total += acc[:, t // ntx, t % ntx]
    return torch.flip(total, dims=(1, 2)).to(patches.dtype)


# ---------------------------------------------------------------------------
# P2's FFT route: the plain versions of csrc/svola_fft.cu's three passes.
# ---------------------------------------------------------------------------


def p2_takes_fft(kernel_hw, adjoint: bool = False) -> bool:
    """Whether PSFs of ``kernel_hw`` = (kh, kw) take the FFT route: the
    forward and d/dpatch (or, with ``adjoint``, d/dpsf), on either device."""
    return max(kernel_hw) >= (P2_DPSF_FFT_MIN_KW if adjoint else P2_FFT_MIN_KW)


def next_fast_fft_len(n: int) -> int:
    """The smallest 2^a 3^b 5^c >= n: the reference's fast FFT length
    (``torchoptics_tpu.ops.image.next_fast_fft_len``, copied here)."""
    best = 1
    while best < n:
        best *= 2
    m = best
    p3 = 1
    while p3 <= best:
        p5 = 1
        while p3 * p5 <= best:
            p2 = 1
            while p2 * p3 * p5 < n:
                p2 *= 2
            m = min(m, p2 * p3 * p5)
            p5 *= 5
        p3 *= 3
    return m


def fft_len(n: int) -> int:
    """The route's transform length for n points: ``next_fast_fft_len``, at
    least ``P2_FFT_MIN_LEN`` (the reference's ``fft_fast_sizes=True``). Past
    3125 and 3750, whose last register block would need more than the
    kernels' 512 threads a sequence, it takes the next fast length (3200,
    3840); the C launchers' ``fft_len`` (``lib.p2_fft_len``) is the same."""
    L = next_fast_fft_len(max(int(n), P2_FFT_MIN_LEN))
    while L in (3125, 3750):
        L = next_fast_fft_len(L + 1)
    return L


def fft_radices(L: int) -> Tuple[int, ...]:
    """The Stockham stages of an L-point transform, in order: radix 4 while
    two factors 2 remain, then radix 2, radix 3 and radix 5 (the kernels
    run the same stages, several at a time in registers)."""
    out, n = [], int(L)
    for r in (4, 2, 3, 5):
        while n % r == 0 and (r != 2 or n % 4 != 0):
            out.append(r)
            n //= r
    if n != 1:
        raise ValueError(f"{L} is not a product of 2, 3 and 5")
    return tuple(out)


@functools.lru_cache(maxsize=32)
def fft_twiddles(L: int, device: torch.device) -> torch.Tensor:
    """The twiddle table of an L-point transform, (L, 2) float32: W_L^i =
    exp(-2 pi i i / L) for i < L, computed in float64 and rounded once. The
    kernels and the plain versions read the same table."""
    i = np.arange(L)
    w = np.exp(-2j * np.pi * i / L)
    return torch.as_tensor(np.stack([w.real, w.imag], -1).astype(np.float32), device=device)


# The butterflies' real constants, each rounded once from float64: sin(2 pi / 3)
# and cos, sin of 2 pi / 5 and 4 pi / 5.
_S3 = float(np.float32(np.sin(2 * np.pi / 3)))
_C51, _C52 = float(np.float32(np.cos(2 * np.pi / 5))), float(np.float32(np.cos(4 * np.pi / 5)))
_S51, _S52 = float(np.float32(np.sin(2 * np.pi / 5))), float(np.float32(np.sin(4 * np.pi / 5)))


def _minus_i(x, inverse: bool):
    """x times -i (forward) or +i (inverse), exact: (re, im) swapped."""
    re, im = x
    return (-im, re) if inverse else (im, -re)


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _scale(a, c: float):
    return a[0] * c, a[1] * c


def _butterfly(x, inverse: bool):
    """The DFT of the R = len(x) values x (each (re, im)), in the kernels'
    order of operations (``bfly`` in ``csrc/svola_fft.cu``): radix 2, 4 (its
    -i exact), 3 and 5 (their constants rounded once, each product rounded
    before its sum)."""
    R = len(x)
    if R == 2:
        return [_add(x[0], x[1]), _sub(x[0], x[1])]
    if R == 4:
        s0, d0 = _add(x[0], x[2]), _sub(x[0], x[2])
        s1, d1 = _add(x[1], x[3]), _sub(x[1], x[3])
        u = _minus_i(d1, inverse)
        return [_add(s0, s1), _add(d0, u), _sub(s0, s1), _sub(d0, u)]
    if R == 3:
        s, d = _add(x[1], x[2]), _sub(x[1], x[2])
        t = _sub(x[0], _scale(s, 0.5))
        u = _minus_i(_scale(d, _S3), inverse)
        return [_add(x[0], s), _add(t, u), _sub(t, u)]
    if R == 5:
        a1, b1 = _add(x[1], x[4]), _sub(x[1], x[4])
        a2, b2 = _add(x[2], x[3]), _sub(x[2], x[3])
        t1 = _add(_add(x[0], _scale(a1, _C51)), _scale(a2, _C52))
        t2 = _add(_add(x[0], _scale(a1, _C52)), _scale(a2, _C51))
        u1 = _minus_i(_add(_scale(b1, _S51), _scale(b2, _S52)), inverse)
        u2 = _minus_i(_sub(_scale(b1, _S52), _scale(b2, _S51)), inverse)
        return [_add(_add(x[0], a1), a2), _add(t1, u1), _add(t2, u2), _sub(t2, u2),
                _sub(t1, u1)]
    raise ValueError(f"no radix-{R} butterfly")


def _stockham(re: torch.Tensor, im: torch.Tensor, tw: torch.Tensor, inverse: bool):
    """The unscaled mixed-radix Stockham FFT along the last axis (L points,
    ``fft_radices(L)``) of a complex float32 tensor held as (re, im). A stage
    of radix R after Ns points of earlier stages: for j < L/R, x_r = x[j + r
    L/R], each x_r (r >= 1) times w = W_L^(r (j mod Ns) L / (Ns R)) from the
    table (conjugated for the inverse; no product in the first stage, Ns =
    1), (ac - bd, ad + bc) with the products rounded before their sums; the
    radix-R butterfly; y[(j // Ns) Ns R + r Ns + j mod Ns] = its output r.
    The kernels run the same stages, two or three at a time in registers."""
    L = re.shape[-1]
    ns = 1
    for R in fft_radices(L):
        m = L // R
        x = [(re[..., r * m:(r + 1) * m], im[..., r * m:(r + 1) * m]) for r in range(R)]
        if ns > 1:
            k = torch.arange(m, device=re.device) % ns
            for r in range(1, R):
                idx = r * k * (L // (ns * R))
                wr, wi = tw[idx, 0], tw[idx, 1]
                if inverse:
                    wi = -wi
                br, bi = x[r]
                x[r] = (br * wr - bi * wi, br * wi + bi * wr)
        y = _butterfly(x, inverse)
        shape = re.shape[:-1] + (m // ns, 1, ns)
        re = torch.cat([v[0].reshape(shape) for v in y], -2).reshape(re.shape[:-1] + (L,))
        im = torch.cat([v[1].reshape(shape) for v in y], -2).reshape(re.shape)
        ns *= R
    return re, im


def _fft_rows_fwd(x: torch.Tensor, L: int, tw: torch.Tensor):
    """Pass 1: the half spectra (L // 2 + 1 points) of the rows of x (P, R,
    W, C), as (re, im) of shape (P, C, R, L // 2 + 1): rows 2q and 2q + 1
    packed as one complex row zero to L, transformed and separated, A_k =
    (Z_k + conj Z_{L-k}) / 2 and B_k = (Z_k - conj Z_{L-k}) / 2i."""
    P, R, W, C = x.shape
    nc = L // 2 + 1
    n2 = R + (R & 1)
    z = x.new_zeros((P, C, n2, L))
    z[:, :, :R, :W] = x.permute(0, 3, 1, 2)
    fr, fi = _stockham(z[:, :, 0::2], z[:, :, 1::2], tw, False)
    k = torch.arange(nc, device=x.device)
    m = (L - k) % L
    zr, zi, mr, mi = fr[..., k], fi[..., k], fr[..., m], fi[..., m]
    pairs = lambda a, b: torch.stack((a, b), 3).reshape(P, C, n2, nc)[:, :, :R]
    return (pairs((zr + mr) * 0.5, (zi + mi) * 0.5),
            pairs((zi - mi) * 0.5, (mr - zr) * 0.5))


def _fft_cols(a, b, L: int, tw: torch.Tensor, conj_b: bool, row0: int, n_out: int):
    """Pass 2: each column of the half spectra a and b ((re, im), (P, C,
    rows, NC)) zero to L, the forward FFT of both, a b (a conj(b) with
    ``conj_b``: (ac + bd, bc - ad)), the inverse; rows [row0, row0 + n_out)."""
    def columns(s):
        re, im = s
        zr = re.new_zeros(re.shape[:2] + (re.shape[3], L))
        zi = torch.zeros_like(zr)
        zr[..., :re.shape[2]] = re.transpose(2, 3)
        zi[..., :re.shape[2]] = im.transpose(2, 3)
        return _stockham(zr, zi, tw, False)
    (xr, xi), (yr, yi) = columns(a), columns(b)
    if conj_b:
        pr, pi = xr * yr + xi * yi, xi * yr - xr * yi
    else:
        pr, pi = xr * yr - xi * yi, xr * yi + xi * yr
    pr, pi = _stockham(pr, pi, tw, True)
    return (pr[..., row0:row0 + n_out].transpose(2, 3),
            pi[..., row0:row0 + n_out].transpose(2, 3))


def _fft_rows_inv(s, L: int, tw: torch.Tensor, scale: float, t0: int, nt: int,
                  flip: bool) -> torch.Tensor:
    """Pass 3: rows 2q and 2q + 1 of the half spectra s ((re, im), (P, C, n,
    L // 2 + 1)) packed as Z = X + iY over all L points by Hermitian symmetry
    (the imaginary parts at 0 and, for even L, L/2 dropped), the inverse
    FFT, times ``scale``; columns [t0, t0 + nt) as (P, n, nt, C), flipped in
    both axes with ``flip``."""
    re, im = s
    P, C, n, _ = re.shape
    n2 = n + (n & 1)
    if n2 != n:
        re = torch.cat((re, re.new_zeros((P, C, 1, re.shape[3]))), 2)
        im = torch.cat((im, im.new_zeros((P, C, 1, im.shape[3]))), 2)
    k = torch.arange(L, device=re.device)
    kk = torch.where(2 * k <= L, k, L - k)
    xr, xi = re[:, :, 0::2][..., kk], im[:, :, 0::2][..., kk]
    yr, yi = re[:, :, 1::2][..., kk], im[:, :, 1::2][..., kk]
    low, high = (k > 0) & (2 * k < L), 2 * k > L
    zr = torch.where(low, xr - yi, torch.where(high, xr + yi, xr))
    zi = torch.where(low, xi + yr, torch.where(high, yr - xi, yr))
    zr, zi = _stockham(zr, zi, tw, True)
    rows = torch.stack((zr * scale, zi * scale), 3).reshape(P, C, n2, L)[:, :, :n, t0:t0 + nt]
    if flip:
        rows = torch.flip(rows, dims=(2, 3))
    return rows.permute(0, 2, 3, 1).contiguous()


def fft_scale(lh: int, lw: int) -> float:
    """The inverse's scale 1 / (Lh Lw), rounded once to float32 (the C
    launcher rounds the same double)."""
    return float(np.float32(1.0 / (lh * lw)))


def _fft_route(patches, second, conj_b: bool, row0: int, n_out: int, t0: int, nt: int,
               flip: bool) -> torch.Tensor:
    """The three passes of ``csrc/svola_fft.cu`` at Lh = fft_len(ph), Lw =
    fft_len(pw), with each length's twiddle table."""
    _, ph, pw, _ = patches.shape
    lh, lw = fft_len(ph), fft_len(pw)
    tw_h, tw_w = fft_twiddles(lh, patches.device), fft_twiddles(lw, patches.device)
    spec = _fft_cols(_fft_rows_fwd(patches, lw, tw_w), _fft_rows_fwd(second, lw, tw_w), lh,
                     tw_h, conj_b, row0, n_out)
    return _fft_rows_inv(spec, lw, tw_w, fft_scale(lh, lw), t0, nt, flip)


def _fft_conv_one(patches: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """One call of the FFT route's forward, plain: see
    :func:`svola_patch_conv_fft_reference`."""
    _, ph, pw, _ = patches.shape
    kh, kw = psfs.shape[1:3]
    return _fft_route(patches, psfs, False, kh - 1, ph - kh + 1, kw - 1, pw - kw + 1, False)


def _fft_dpsf_one(patches: torch.Tensor, cotangent: torch.Tensor,
                  kernel_hw: Tuple[int, int]) -> torch.Tensor:
    """One call of the FFT route's d/dpsf, plain: see
    :func:`svola_patch_conv_dpsf_fft_reference`."""
    kh, kw = kernel_hw
    return _fft_route(patches, cotangent, True, 0, kh, 0, kw, True)


def svola_patch_conv_fft_reference(patches: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """Plain version of P2's FFT route (``csrc/svola_fft.cu``): the valid
    convolution of each patch with its PSF, (P, ph, pw, C) and (P, kh, kw,
    C) -> (P, ph - kh + 1, pw - kw + 1, C), as the circular convolution at
    lengths Lh = fft_len(ph), Lw = fft_len(pw) (the wrap never reaches rows
    [kh-1, ph) and columns [kw-1, pw), which are kept), scaled by 1/(Lh Lw);
    the kernels' three passes in their arithmetic. A patch longer than
    ``P2_FFT_TILE`` is cut as the kernels' calls are (``fft_tiles``), each
    sub-patch's valid region written in place."""
    return _fft_conv_tiled(_fft_conv_one, patches, psfs)


def svola_patch_conv_dpsf_fft_reference(patches: torch.Tensor, cotangent: torch.Tensor,
                                        kernel_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of the FFT route's d/dpsf: the circular correlation
    corr[s, t] = sum_ij g[i, j] patch[i+s, j+t] of each patch with the
    cotangent at the forward's lengths (lags s < kh, t < kw do not wrap),
    dpsf[u, v] = corr[kh-1-u, kw-1-v]; the kernels' passes in their
    arithmetic. A patch longer than ``P2_FFT_TILE`` is cut as the forward's
    (``fft_tiles``), the sub-patches' results added in float32 in row-major
    order of the pieces."""
    return _fft_dpsf_tiled(_fft_dpsf_one, patches, cotangent, kernel_hw)


#: The widest PSF, in either axis, that the direct kernels take (``MAX_K``
#: of ``csrc/svola_conv.cu`` and ``csrc/svola_conv_bwd.cu``): at least one
#: tap narrower than the FFT route's thresholds, so that every PSF has a
#: route.
P2_DIRECT_MAX_KW, P2_DPSF_DIRECT_MAX_KW = 32, 22


def fft_tiles(n: int, k: int) -> Tuple[Tuple[int, int], ...]:
    """The FFT route's cut of one patch axis of n pixels for a PSF of k taps
    (overlap-save): ((first output pixel, output pixels), ...). A patch no
    longer than ``P2_FFT_TILE``, or a PSF longer than it, is one piece;
    otherwise the n - k + 1 outputs fall into the fewest equal runs (the
    last shorter) whose sub-patches, the run and the k - 1 pixels after it,
    are at most ``P2_FFT_TILE`` long. Sub-patch i starts at its first output
    pixel, so neighbours overlap by k - 1 pixels."""
    n_out = n - k + 1
    if n <= P2_FFT_TILE or k > P2_FFT_TILE:
        return ((0, n_out),)
    size = -(-n_out // -(-n_out // (P2_FFT_TILE - k + 1)))
    return tuple((o, min(size, n_out - o)) for o in range(0, n_out, size))


def _fft_pieces(patches: torch.Tensor, kernel_hw: Tuple[int, int]):
    """The sub-patches of ``fft_tiles`` in row-major order: ((rows of output,
    columns of output), the contiguous sub-patch)."""
    kh, kw = kernel_hw
    for r0, nr in fft_tiles(patches.shape[1], kh):
        for c0, nc in fft_tiles(patches.shape[2], kw):
            sub = patches[:, r0:r0 + nr + kh - 1, c0:c0 + nc + kw - 1]
            yield (slice(r0, r0 + nr), slice(c0, c0 + nc)), sub.contiguous()


def _fft_conv_tiled(conv, patches: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """P2's FFT route (``conv``: the kernels or the plain version) on patches
    cut by ``fft_tiles``: each sub-patch's valid convolution written in
    place."""
    P, ph, pw, C = patches.shape
    kh, kw = psfs.shape[1:3]
    if len(fft_tiles(ph, kh)) == len(fft_tiles(pw, kw)) == 1:
        return conv(patches, psfs)
    out = patches.new_empty((P, ph - kh + 1, pw - kw + 1, C))
    for (rows, cols), sub in _fft_pieces(patches, (kh, kw)):
        out[:, rows, cols] = conv(sub, psfs)
    return out


def _fft_dpsf_tiled(corr, patches: torch.Tensor, cotangent: torch.Tensor,
                    kernel_hw: Tuple[int, int]) -> torch.Tensor:
    """The FFT route's d/dpsf (``corr``: the kernels or the plain version) on
    patches cut by ``fft_tiles``: the sub-patches' correlations with their
    parts of the cotangent, added in row-major order of the pieces."""
    kh, kw = kernel_hw
    if len(fft_tiles(patches.shape[1], kh)) == len(fft_tiles(patches.shape[2], kw)) == 1:
        return corr(patches, cotangent, kernel_hw)
    total = None
    for (rows, cols), sub in _fft_pieces(patches, kernel_hw):
        d = corr(sub, cotangent[:, rows, cols].contiguous(), kernel_hw)
        total = d if total is None else total + d
    return total


def p2_max_kw(adjoint: bool = False) -> int:
    """The widest PSF, in either axis, that the direct kernels take (the C
    functions ``p2_max_kw`` and ``p2_dpsf_max_kw`` return the same)."""
    return P2_DPSF_DIRECT_MAX_KW if adjoint else P2_DIRECT_MAX_KW


def p2_argument_error(patches_shape, psfs_shape, adjoint: bool = False):
    """Why one launch of P2 (or, with ``adjoint``, its d/dpsf) would refuse
    patches and PSFs of these shapes, or None: the checks of the launchers
    in ``csrc/svola_*.cu`` of the route the shapes take, with no library
    needed. The direct kernels take every PSF narrower than the FFT route's
    threshold; one launch of the FFT route any wider PSF up to the patch, on
    patches up to ``P2_FFT_MAX_LEN`` pixels a side (``svola_patch_conv``
    cuts longer patches first, ``fft_tiles``)."""
    P, ph, pw, C = patches_shape
    if tuple(psfs_shape[:1]) + tuple(psfs_shape[3:]) != (P, C) or len(psfs_shape) != 4:
        return (f"psfs {tuple(psfs_shape)} must be (P, kh, kw, C) with (P, C) = {(P, C)} of "
                f"patches {tuple(patches_shape)}")
    kh, kw = psfs_shape[1:3]
    what = "d/dpsf" if adjoint else "P2"
    if C < 1 or kh < 1 or kw < 1 or ph < kh or pw < kw or P * C > 65535:
        return (f"{what} takes kernels no larger than the patch, and at most 65535 "
                f"patch-channels; got psfs {tuple(psfs_shape)}, patches {tuple(patches_shape)}")
    if p2_takes_fft((kh, kw), adjoint) and max(ph, pw) > P2_FFT_MAX_LEN:
        return (f"{what}'s FFT route takes patches up to {P2_FFT_MAX_LEN} pixels a side; "
                f"got patches {tuple(patches_shape)}")
    return None


def _check_p2_inputs(tensors: dict, psfs_shape, adjoint: bool = False):
    """Raise unless ``tensors`` (the first is the patches) are float32 on one
    device and the launcher takes the shapes."""
    device = next(iter(tensors.values())).device
    for name, a in tensors.items():
        if a.dtype != torch.float32 or a.device != device:
            raise ValueError(f"P2 takes float32 {name} on one device, got {a.dtype} on "
                             f"{a.device}")
    error = p2_argument_error(next(iter(tensors.values())).shape, psfs_shape, adjoint)
    if error:
        raise ValueError(error)


def _launch_p2(patches: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    global P2_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    _check_p2_inputs({"patches": patches, "psfs": psfs}, psfs.shape)
    P, ph, pw, C = patches.shape
    kh, kw = psfs.shape[1:3]
    out = torch.empty((P, ph - kh + 1, pw - kw + 1, C), dtype=torch.float32,
                      device=patches.device)
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream(patches.device).cuda_stream
        err = lib.p2_svola_launch(patches.data_ptr(), psfs.data_ptr(), out.data_ptr(), P, C,
                                  ph, pw, kh, kw, stream)
    if err != 0:
        raise RuntimeError(f"P2 (SVOLA patch convolution) launch failed: "
                           f"{lib.k1_error_string(err).decode()}")
    P2_LAUNCHES += 1 if P else 0
    return out


def _launch_p2_dpsf(patches: torch.Tensor, cotangent: torch.Tensor,
                    kernel_hw: Tuple[int, int]) -> torch.Tensor:
    global P2_DPSF_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    P, ph, pw, C = patches.shape
    kh, kw = kernel_hw
    _check_p2_inputs({"patches": patches, "cotangent": cotangent}, (P, kh, kw, C), True)
    if cotangent.shape != (P, ph - kh + 1, pw - kw + 1, C):
        raise ValueError(f"the cotangent {tuple(cotangent.shape)} must have P2's output shape "
                         f"{(P, ph - kh + 1, pw - kw + 1, C)}")
    partials = torch.empty(lib.p2_dpsf_partials(P, C, ph, pw, kh, kw), dtype=torch.float64,
                           device=patches.device)
    dpsf = torch.empty((P, kh, kw, C), dtype=torch.float32, device=patches.device)
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream(patches.device).cuda_stream
        err = lib.p2_dpsf_launch(patches.data_ptr(), cotangent.data_ptr(), partials.data_ptr(),
                                 dpsf.data_ptr(), P, C, ph, pw, kh, kw, stream)
    if err != 0:
        raise RuntimeError(f"P2's d/dpsf kernel launch failed: "
                           f"{lib.k1_error_string(err).decode()}")
    P2_DPSF_LAUNCHES += lib.p2_dpsf_launches(P, C, ph, pw, kh, kw) if P else 0
    return dpsf


def _launch_fft(patches: torch.Tensor, second: torch.Tensor, kernel_hw: Tuple[int, int],
                adjoint: bool) -> torch.Tensor:
    """The FFT route's three launches (``csrc/svola_fft.cu``): P2, or with
    ``adjoint`` its d/dpsf (``second`` is then the cotangent)."""
    global P2_FFT_LAUNCHES, P2_DPSF_FFT_LAUNCHES
    from torchoptics_tpu_torch.ops import _kernels
    lib = _kernels.load()
    P, ph, pw, C = patches.shape
    kh, kw = kernel_hw
    name = "cotangent" if adjoint else "psfs"
    _check_p2_inputs({"patches": patches, name: second}, (P, kh, kw, C), adjoint)
    want = (P, ph - kh + 1, pw - kw + 1, C) if adjoint else (P, kh, kw, C)
    if tuple(second.shape) != want:
        raise ValueError(f"the {name} {tuple(second.shape)} must be {want}")
    shape = (P, kh, kw, C) if adjoint else (P, ph - kh + 1, pw - kw + 1, C)
    out = torch.empty(shape, dtype=torch.float32, device=patches.device)
    scratch = torch.empty(lib.p2_fft_scratch(P, C, ph, pw, kh, int(adjoint)),
                          dtype=torch.float32, device=patches.device)
    tw_h = fft_twiddles(fft_len(ph), patches.device)
    tw_w = fft_twiddles(fft_len(pw), patches.device)
    launch = lib.p2_dpsf_fft_launch if adjoint else lib.p2_fft_launch
    with torch.cuda.device(patches.device):
        stream = torch.cuda.current_stream(patches.device).cuda_stream
        err = launch(patches.data_ptr(), second.data_ptr(), out.data_ptr(), tw_h.data_ptr(),
                     tw_w.data_ptr(), scratch.data_ptr(), P, C, ph, pw, kh, kw, stream)
    if err != 0:
        raise RuntimeError(f"P2's FFT route{' (d/dpsf)' if adjoint else ''} launch failed: "
                           f"{lib.k1_error_string(err).decode()}")
    if P:
        if adjoint:
            P2_DPSF_FFT_LAUNCHES += lib.p2_fft_launches()
        else:
            P2_FFT_LAUNCHES += lib.p2_fft_launches()
    return out


def _p2(patches: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """P2 by the route the PSFs' width takes: on a CUDA tensor the FFT
    kernels or the direct one, on a CPU tensor their plain versions."""
    fft = p2_takes_fft(psfs.shape[1:3])
    if patches.device.type == "cpu":
        return (svola_patch_conv_fft_reference if fft else svola_patch_conv_reference)(
            patches, psfs)
    if not fft:
        return _launch_p2(patches, psfs)
    return _fft_conv_tiled(lambda p, k: _launch_fft(p, k, k.shape[1:3], False), patches, psfs)


def _p2_dpsf(patches: torch.Tensor, cotangent: torch.Tensor,
             kernel_hw: Tuple[int, int]) -> torch.Tensor:
    """P2's d/dpsf by the route ``kernel_hw`` takes, on either device."""
    fft = p2_takes_fft(kernel_hw, adjoint=True)
    if patches.device.type == "cpu":
        return (svola_patch_conv_dpsf_fft_reference if fft else svola_patch_conv_dpsf_reference)(
            patches, cotangent, kernel_hw)
    if not fft:
        return _launch_p2_dpsf(patches, cotangent, kernel_hw)
    return _fft_dpsf_tiled(lambda p, g, k: _launch_fft(p, g, k, True), patches, cotangent,
                           kernel_hw)


class _P2(torch.autograd.Function):
    """Kernel P2 with its adjoint, each by the route the PSFs' width takes
    (``p2_takes_fft``): on CUDA tensors the forward is P2 (direct or FFT),
    d/dpsf its own kernels and d/dpatch P2 on the padded cotangent with the
    flipped PSFs (launched only when the patches need a gradient); on CPU
    tensors each is its plain version."""

    @staticmethod
    def forward(ctx, patches, psfs):
        ctx.save_for_backward(patches, psfs)
        return _p2(patches, psfs)

    @staticmethod
    @once_differentiable
    def backward(ctx, cotangent):
        patches, psfs = ctx.saved_tensors
        cotangent = cotangent.contiguous()
        kh, kw = psfs.shape[1:3]
        d_patches = d_psfs = None
        if ctx.needs_input_grad[0]:
            padded = torch.nn.functional.pad(cotangent, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
            d_patches = _p2(padded, torch.flip(psfs, dims=(1, 2)).contiguous())
        if ctx.needs_input_grad[1]:
            d_psfs = _p2_dpsf(patches, cotangent, (kh, kw))
        return d_patches, d_psfs


def svola_patch_conv(patches: torch.Tensor, psfs: torch.Tensor) -> torch.Tensor:
    """Kernel P2 on a CUDA tensor, its plain version on a CPU tensor, by the
    route the PSFs' width takes: below ``P2_FFT_MIN_KW`` taps the direct sum
    (``csrc/svola_conv.cu``, :func:`svola_patch_conv_reference`), from there
    the FFT convolution (``csrc/svola_fft.cu``,
    :func:`svola_patch_conv_fft_reference`). Differentiable in both inputs
    (``_P2``: d/dpsf is ``csrc/svola_conv_bwd.cu`` or the FFT route's, by
    ``P2_DPSF_FFT_MIN_KW``, d/dpatch one more P2 call; on the CPU their plain
    versions)."""
    if patches.device.type not in ("cpu", "cuda"):
        raise ValueError(f"P2 runs on CUDA or CPU tensors, got {patches.device}")
    if patches.device.type == "cuda":
        patches, psfs = patches.contiguous(), psfs.contiguous()
    if torch.is_grad_enabled() and (patches.requires_grad or psfs.requires_grad):
        return _P2.apply(patches, psfs)
    # No gradient wanted: the forward alone, without the Function's host
    # cost (a 1024^2 render's P2 launch is ~0.1 ms).
    return _p2(patches, psfs)


def svola_patches(image: torch.Tensor, overlap_size, kernel_hw: Tuple[int, int],
                  psfs_grid_shape: Tuple[int, int]):
    """SVOLA's patch extraction: the image padded symmetrically by the
    overlap plus half the kernel, cut into the static grid of overlapping
    patches. Returns (patches (B, N, ph, pw, C), corners, patch_size)."""
    if isinstance(overlap_size, int):
        overlap_size = (overlap_size, overlap_size)
    _, im_h_orig, im_w_orig, _ = image.shape
    kh, kw = kernel_hw
    gh, gw = psfs_grid_shape
    im_h = im_h_orig + 2 * overlap_size[0]
    im_w = im_w_orig + 2 * overlap_size[1]
    pad_h, pad_w = kh // 2, kw // 2
    tp_h = overlap_size[0] + pad_h
    tp_w = overlap_size[1] + pad_w
    image = pad_symmetric(image, (tp_h, tp_h), (tp_w, tp_w))
    patch_size = (im_h_orig // gh + overlap_size[0] * 2,
                  im_w_orig // gw + overlap_size[1] * 2)
    rows_0 = np.round(np.linspace(0, 1, gh) * (im_h - patch_size[0])).astype(int)
    cols_0 = np.round(np.linspace(0, 1, gw) * (im_w - patch_size[1])).astype(int)
    corners = [(r0, r0 + patch_size[0], c0, c0 + patch_size[1])
               for r0 in rows_0 for c0 in cols_0]
    patches = torch.stack([image[:, r0:r1 + 2 * pad_h, c0:c1 + 2 * pad_w, :]
                           for (r0, r1, c0, c1) in corners], dim=1)
    return patches, corners, patch_size


@functools.lru_cache(maxsize=16)
def _overlap_weights(padded_hw: Tuple[int, int], corners, window_type: str,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    """SVOLA's overlap-add weights, one (ph, pw, 1) tensor per patch: the
    window over the patch divided by the sum of every patch's window at
    each pixel. They depend on the geometry alone, so each geometry's are
    made once and kept on its device."""
    r0, r1, c0, c1 = corners[0]
    window = _window(window_type, r1 - r0)[:, None] * _window(window_type, c1 - c0)[None, :]
    total = np.zeros(padded_hw, dtype=np.float32)
    for r0, r1, c0, c1 in corners:
        total[r0:r1, c0:c1] += window
    return tuple(torch.as_tensor((window / total[r0:r1, c0:c1])[..., None], device=device)
                 for r0, r1, c0, c1 in corners)


def svola_convolution(image: torch.Tensor, overlap_size, psfs: torch.Tensor,
                      psfs_grid_shape: Tuple[int, int], window_type: str = "boxcar",
                      fft_fast_sizes: bool = False) -> torch.Tensor:
    """Spatially-Varying OverLap-Add convolution.

    Args:
      image: (B, H, W, C).
      overlap_size: int or (oh, ow) half-overlap between patches.
      psfs: (B, N, kh, kw, C) with N == grid_h * grid_w local kernels (odd
        kh, kw).
      psfs_grid_shape: (grid_h, grid_w).
      window_type: recomposition window, 'boxcar' or 'hann'.
      fft_fast_sizes: accepted for the JAX package's signature and ignored:
        P2's FFT route always transforms at the fast lengths (``fft_len``),
        which is the JAX package's ``fft_fast_sizes=True``.

    Returns:
      (B, H, W, C) convolved image. Every patch-channel of the batch goes
      through one P2 call on the card: one launch of the direct kernel, or
      the FFT route's three.
    """
    del fft_fast_sizes
    if isinstance(overlap_size, int):
        overlap_size = (overlap_size, overlap_size)
    n_img, im_h_orig, im_w_orig, n_channels = image.shape
    n_patches, kh, kw = psfs.shape[1:4]
    assert kh % 2 == 1 and kw % 2 == 1, "PSF kernels must be odd-sized"
    gh, gw = psfs_grid_shape
    assert n_patches == gh * gw
    im_h = im_h_orig + 2 * overlap_size[0]
    im_w = im_w_orig + 2 * overlap_size[1]

    patches, corners, patch_size = svola_patches(image, overlap_size, (kh, kw),
                                                 psfs_grid_shape)
    ph, pw = patches.shape[2:4]
    conv = svola_patch_conv(patches.reshape(n_img * n_patches, ph, pw, n_channels),
                            psfs.reshape(n_img * n_patches, kh, kw, n_channels))
    conv = conv.reshape(n_img, n_patches, patch_size[0], patch_size[1], n_channels)

    # Windowed recomposition with normalized weights.
    weights = _overlap_weights((im_h, im_w), tuple(corners), window_type, conv.device)
    out = torch.zeros((n_img, im_h, im_w, n_channels), dtype=conv.dtype, device=conv.device)
    for i, (r0, r1, c0, c1) in enumerate(corners):
        out[:, r0:r1, c0:c1, :] += conv[:, i] * weights[i]
    return out[:, overlap_size[0]: overlap_size[0] + im_h_orig,
               overlap_size[1]: overlap_size[1] + im_w_orig]


# ---------------------------------------------------------------------------
# Keys bicubic resampling and the distortion warps.
# ---------------------------------------------------------------------------

# Keys bicubic (alpha = -0.75) coefficients: row k dotted with (1, t, t², t³)
# is the weight of neighbour k in the order [v0, v0-1, v0+1, v0+2].
_KEYS_ALPHA = -0.75
_KEYS_COEFFS = np.asarray([
    [1, 0, -(_KEYS_ALPHA + 3), (_KEYS_ALPHA + 2)],
    [0, _KEYS_ALPHA, -2 * _KEYS_ALPHA, _KEYS_ALPHA],
    [0, -_KEYS_ALPHA, 2 * _KEYS_ALPHA + 3, -_KEYS_ALPHA - 2],
    [0, 0, _KEYS_ALPHA, -_KEYS_ALPHA]], dtype=np.float64)
# Neighbour offsets of the Keys rows, and the rows in increasing offset (the
# order in which the JAX package's tap sums meet their nonzero terms).
_KEYS_OFFSETS = (0, -1, 1, 2)
_ROWS_BY_OFFSET = (1, 0, 2, 3)


def _keys_weights(v: torch.Tensor, v0: torch.Tensor):
    """Keys weights [w(0), w(-1), w(+1), w(+2)] at fraction t = v - v0."""
    tv = v - v0
    powers = (torch.ones_like(tv), tv, tv * tv, tv * tv * tv)
    return [sum(float(_KEYS_COEFFS[i, j]) * powers[j] for j in range(4)) for i in range(4)]


def interpolate_bicubic(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        out_size: Tuple[int, int]) -> torch.Tensor:
    """Keys bicubic (alpha = -0.75) gather resampler.

    Args:
      im: (B, H, W, C); x, y: flat sample coordinates in [-1, 1] of length
        B * out_h * out_w (image-major).

    Returns (B, out_h, out_w, C): the 16 neighbours at clamped indices,
    summed in the JAX package's order (rows [v0, v0-1, v0+1, v0+2], inner
    sum over x first).
    """
    batch, height, width, channels = im.shape
    out_h, out_w = out_size
    x = torch.clamp(torch.as_tensor(x, dtype=im.dtype, device=im.device), -1, 1)
    y = torch.clamp(torch.as_tensor(y, dtype=im.dtype, device=im.device), -1, 1)
    x = (x + 1.0) / 2.0 * (width - 1.0)
    y = (y + 1.0) / 2.0 * (height - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = _keys_weights(x, x0)
    wy = _keys_weights(y, y0)

    npix = x.shape[0]
    b_idx = torch.arange(batch, device=im.device).repeat_interleave(out_h * out_w)
    xi, yi = x0.long(), y0.long()
    flat = im.reshape(batch * height * width, channels)
    base = b_idx * (height * width)

    def tap(oy, ox):
        r = torch.clamp(yi + oy, 0, height - 1)
        c = torch.clamp(xi + ox, 0, width - 1)
        return flat[base + r * width + c]                 # (npix, C)

    out = torch.zeros((npix, channels), dtype=im.dtype, device=im.device)
    for i, oy in enumerate(_KEYS_OFFSETS):
        x_interp = torch.zeros((npix, channels), dtype=im.dtype, device=im.device)
        for j, ox in enumerate(_KEYS_OFFSETS):
            x_interp = x_interp + wx[j][:, None] * tap(oy, ox)
        out = out + wy[i][:, None] * x_interp
    return out.reshape(batch, out_h, out_w, channels)


def apply_distortion_by_warping(img: torch.Tensor, dist_x: torch.Tensor,
                                dist_y: torch.Tensor) -> torch.Tensor:
    """Warp an image through distorted sampling coordinates.

    img: (B, H, W, C); dist_x / dist_y: (H*W,) coordinates in [-1, 1].
    """
    b, h, w, c = img.shape
    # The batch merged into the channels, so one gather serves it all.
    merged = img.permute(1, 2, 0, 3).reshape(1, h, w, b * c)
    warped = interpolate_bicubic(merged, dist_x, dist_y, (h, w))
    return warped.reshape(h, w, b, c).permute(2, 0, 1, 3)


def warp_bicubic_shifts(img: torch.Tensor, sx_px: torch.Tensor, sy_px: torch.Tensor,
                        max_shift_px: int) -> torch.Tensor:
    """Keys-bicubic warp for per-pixel shift maps with a static bound.

    The source of output pixel (i, j) is (i - sy, j - sx), shifts clamped to
    ±``max_shift_px``, coordinates to the image; its 4 x 4 neighbours at
    clamped indices are gathered and summed rows outer in increasing offset,
    columns inner, the order in which the JAX package's dense tap sum over
    the band [-M-2, M+2]² meets its nonzero taps.

    Args:
      img: (B, H, W, C); sx_px / sy_px: (H, W) shifts in pixels (positive =
        sample from the smaller coordinate: content moves +x / +y).
      max_shift_px: the clamp M.
    """
    B, H, W, C = img.shape
    M = int(max_shift_px)
    dtype, device = img.dtype, img.device
    jj = torch.arange(W, dtype=dtype, device=device)[None, :]
    ii = torch.arange(H, dtype=dtype, device=device)[:, None]
    xs = torch.clamp(jj - torch.clamp(sx_px.to(dtype), -M, M), 0, W - 1)
    ys = torch.clamp(ii - torch.clamp(sy_px.to(dtype), -M, M), 0, H - 1)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wxk = _keys_weights(xs, x0)
    wyk = _keys_weights(ys, y0)
    xi, yi = x0.long(), y0.long()
    flat = img.reshape(B, H * W, C)

    def tap(oy, ox):
        idx = (torch.clamp(yi + oy, 0, H - 1) * W + torch.clamp(xi + ox, 0, W - 1))
        return torch.gather(flat, 1, idx.reshape(1, H * W, 1).expand(B, H * W, C))

    out = torch.zeros_like(flat)
    for ry in _ROWS_BY_OFFSET:
        row_acc = torch.zeros_like(flat)
        for rx in _ROWS_BY_OFFSET:
            row_acc = row_acc + wxk[rx].reshape(1, H * W, 1) * tap(_KEYS_OFFSETS[ry],
                                                                   _KEYS_OFFSETS[rx])
        out = out + wyk[ry].reshape(1, H * W, 1) * row_acc
    return out.reshape(B, H, W, C)


def _tap1d(img: torch.Tensor, coord: torch.Tensor, axis: int,
           max_shift_px: int) -> torch.Tensor:
    """1-D Keys-bicubic resample of (B, H, W, C) along H (axis=1) or W
    (axis=2) at per-pixel source ``coord`` (H, W): the coordinate clamped to
    the image and to ±``max_shift_px`` of the pixel, its 4 neighbours at
    clamped indices gathered and summed in increasing offset."""
    B, H, W, C = img.shape
    N = H if axis == 1 else W
    M = int(max_shift_px)
    dtype, device = img.dtype, img.device
    base = (torch.arange(H, dtype=dtype, device=device)[:, None] if axis == 1
            else torch.arange(W, dtype=dtype, device=device)[None, :])
    v = torch.clamp(coord.to(dtype), 0, N - 1)
    v = torch.minimum(torch.maximum(v, base - M), base + M)
    v0 = torch.floor(v)
    wk = _keys_weights(v, v0)
    vi = torch.broadcast_to(v0, (H, W)).long()
    out = torch.zeros_like(img)
    for r in _ROWS_BY_OFFSET:
        idx = torch.clamp(vi + _KEYS_OFFSETS[r], 0, N - 1)
        sl = torch.gather(img, axis, idx[None, :, :, None].expand(B, H, W, C))
        out = out + torch.broadcast_to(wk[r], (H, W))[None, :, :, None] * sl
    return out


def warp_bicubic_separable(img: torch.Tensor, sx_fn, sy_fn, max_shift_px: int,
                           n_solve_iters: int = 4) -> torch.Tensor:
    """Two-pass (Catmull-Smith) bicubic warp for smooth per-pixel shift
    fields: an x pass at each intermediate row's preimage (found by
    ``n_solve_iters`` fixed-point steps of p = i' + sy(p, j)), then a y pass.

    Args:
      img: (B, H, W, C).
      sx_fn / sy_fn: callables (ii, jj) -> shift in pixels at float pixel
        coordinates (broadcastable (H, W) tensors); the source of output pixel
        (i, j) is (i - sy(i, j), j - sx(i, j)), as in
        :func:`warp_bicubic_shifts`.
      max_shift_px: per-axis bound M (coordinates clamp into it).
    """
    B, H, W, C = img.shape
    dtype, device = img.dtype, img.device
    ii = torch.arange(H, dtype=dtype, device=device)[:, None]
    jj = torch.arange(W, dtype=dtype, device=device)[None, :]
    p = ii
    for _ in range(n_solve_iters):
        p = ii + sy_fn(p, jj)
    xs2 = jj - sx_fn(p, jj)
    tmp = _tap1d(img, xs2, axis=2, max_shift_px=max_shift_px)
    ysrc = ii - sy_fn(ii, jj)
    return _tap1d(tmp, ysrc, axis=1, max_shift_px=max_shift_px)


# ---------------------------------------------------------------------------
# Image quality.
# ---------------------------------------------------------------------------


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over (H, W, C), per batch element."""
    mse = torch.mean((a - b) ** 2, dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-20))


def _ssim_window(filter_size: int, filter_sigma: float) -> np.ndarray:
    """Normalized Gaussian SSIM window (the ``tf.image.ssim`` default:
    11 x 11, sigma = 1.5)."""
    offsets = np.arange(filter_size, dtype=np.float64) - (filter_size - 1) / 2
    g = np.exp(-0.5 * (offsets / filter_sigma) ** 2)
    w2d = g[:, None] * g[None, :]
    return (w2d / w2d.sum()).astype(np.float32)


def _ssim_filter(x: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Per-channel VALID Gaussian filter over (B, H, W, C), as two 1-D
    static-slice weighted sums (the window is an outer product; its row sums
    are the normalized 1-D factor)."""
    k = window.shape[0]
    g1 = window.sum(axis=1)
    h = x.shape[1] - k + 1
    w_out = x.shape[2] - k + 1
    acc = None
    for i in range(k):
        term = float(g1[i]) * x[:, i:i + h, :, :]
        acc = term if acc is None else acc + term
    out = None
    for j in range(k):
        term = float(g1[j]) * acc[:, :, j:j + w_out, :]
        out = term if out is None else out + term
    return out


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity per batch element, as ``tf.image.ssim``:
    Gaussian 11 x 11 window with sigma = 1.5, VALID padding, per-channel
    filtering, mean over space and channels."""
    window = _ssim_window(filter_size, filter_sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _ssim_filter(a, window)
    mu_b = _ssim_filter(b, window)
    var_a = _ssim_filter(a * a, window) - mu_a ** 2
    var_b = _ssim_filter(b * b, window) - mu_b ** 2
    cov = _ssim_filter(a * b, window) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return torch.mean(s, dim=(-3, -2, -1))


# ---------------------------------------------------------------------------
# PSF grids, distortion and relative illumination.
# ---------------------------------------------------------------------------


def ensure_finite(tensor: torch.Tensor, replace_val: float = 0.0) -> torch.Tensor:
    """NaN / Inf -> replace_val."""
    return torch.where(torch.isfinite(tensor), tensor, replace_val)


def linear_interpolation(soft_indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``values`` along axis 0 at fractional indices
    (clamped to the table). For a 1-D table of at most 64 entries (the
    per-field samples) it is the hat-function sum
    Σ_k values[k]·max(0, 1 - |soft - k|), as the JAX package writes it;
    otherwise a two-point gather."""
    K = values.shape[0]
    soft = torch.clamp(soft_indices, 0, K - 1)
    if values.ndim == 1 and K <= 64:
        out = torch.zeros(soft.shape, dtype=values.dtype, device=soft.device)
        for k in range(K):
            out = out + values[k] * torch.clamp(1.0 - torch.abs(soft - k), min=0.0)
        return out
    upper = torch.ceil(soft).long()
    lower = torch.floor(soft).long()
    frac = torch.remainder(soft, 1)
    return values[lower] * (1 - frac) + values[upper] * frac


def get_psf_weights(grid_h: int, grid_w: int, field_map: np.ndarray,
                    n_fields: int) -> np.ndarray:
    """Per-patch PSF interpolation weights, (n_patches, n_fields): the
    fraction of each patch's pixels nearest to each sampled field. Static
    geometry, computed in numpy from the (H, W) normalized-radius map."""
    field_map = np.asarray(field_map)
    img_h, img_w = field_map.shape
    ph = int(round(img_h / grid_h))
    pw = int(round(img_w / grid_w))
    rows_0 = np.round(np.linspace(0, 1, grid_h) * (img_h - ph)).astype(int)
    cols_0 = np.round(np.linspace(0, 1, grid_w) * (img_w - pw)).astype(int)
    discrete = np.round(field_map * (n_fields - 1)).astype(np.int32)
    patches = np.stack([discrete[r0:r0 + ph, c0:c0 + pw] for r0 in rows_0 for c0 in cols_0])
    fields = np.arange(n_fields)
    return np.mean((patches[..., None] == fields).astype(np.float32), axis=(1, 2))


def interpolate_psfs(sampled_psfs: torch.Tensor, field_map: np.ndarray,
                     psf_grid_shape: Tuple[int, int]) -> torch.Tensor:
    """Blend per-field PSFs (F, ph, pw, C) into per-patch PSFs (N, ph, pw, C):
    one matrix product of the (N, F) weights and the fields' PSFs as (F, ph
    pw C) rows, so that neither it nor its gradient holds the (N, F, ph, pw,
    C) broadcast. On CUDA tensors the product must run in full float32: with
    ``torch.backends.cuda.matmul.allow_tf32`` set this raises."""
    if sampled_psfs.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("interpolate_psfs needs full float32 matrix products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    gh, gw = psf_grid_shape
    n_fields = sampled_psfs.shape[0]
    w = torch.as_tensor(get_psf_weights(gh, gw, field_map, n_fields),
                        dtype=sampled_psfs.dtype, device=sampled_psfs.device)
    out = torch.matmul(w, sampled_psfs.reshape(n_fields, -1))
    return out.reshape((w.shape[0],) + tuple(sampled_psfs.shape[1:]))


def rotate_image_bilinear(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate (N, H, W, C) images about their centres by ``angle`` (radians,
    one per image), bilinear sampling, zero fill."""
    n, h, w, c = img.shape
    dtype, device = img.dtype, img.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    cy, cxx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = yy - cy
    xx = xx - cxx
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    src_x = cos * xx[None] - sin * yy[None] + cxx
    src_y = sin * xx[None] + cos * yy[None] + cy
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = src_x - x0
    fy = src_y - y0
    flat = img.reshape(n, h * w, c)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yi = torch.clamp(yi, 0, h - 1).long()
        xi = torch.clamp(xi, 0, w - 1).long()
        idx = (yi * w + xi).reshape(n, -1, 1).expand(n, h * w, c)
        vals = torch.gather(flat, 1, idx).reshape(n, h, w, c)
        return vals * valid[..., None]

    return (gather(y0, x0) * ((1 - fy) * (1 - fx))[..., None]
            + gather(y0, x0 + 1) * ((1 - fy) * fx)[..., None]
            + gather(y0 + 1, x0) * (fy * (1 - fx))[..., None]
            + gather(y0 + 1, x0 + 1) * (fy * fx)[..., None])


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of ``jax.image.resize(...,
    method="linear")`` along one axis: a triangle kernel on half-pixel
    centres, widened by 1/scale when downscaling (antialiased), each column
    normalized to unit sum, samples outside the input zeroed
    (``jax._src.image.scale.compute_weight_mat``)."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (N, H, W, C) as ``jax.image.resize(method="linear")`` does
    (antialiased when downscaling): the per-axis weight matrices of
    :func:`_resize_weights`, each contracted over its axis by one matrix
    product, (out, in) times the image's (in, rest) rows, so that neither
    the product nor its gradient holds more than the image and the result
    (an axis whose size does not change is left as it is). On CUDA tensors
    the products must run in full float32: with
    ``torch.backends.cuda.matmul.allow_tf32`` set this raises."""
    n, h, w, c = img.shape
    out_h, out_w = (int(v) for v in out_hw)
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32 and (out_h, out_w) != (h, w):
        raise RuntimeError("resize_bilinear needs full float32 matrix products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    if out_h != h:
        wh = torch.as_tensor(_resize_weights(h, out_h).T, dtype=img.dtype, device=img.device)
        img = torch.matmul(wh, img.reshape(n, h, w * c)).reshape(n, out_h, w, c)
    if out_w != w:
        ww = torch.as_tensor(_resize_weights(w, out_w).T, dtype=img.dtype, device=img.device)
        img = torch.matmul(ww, img.reshape(n * out_h, w, c)).reshape(n, out_h, out_w, c)
    return img


def rotate_and_resize_psfs(interpolated_psfs: torch.Tensor, x_map, y_map,
                           psf_grid_shape: Tuple[int, int],
                           resized_psf_shape: Tuple[int, int]) -> torch.Tensor:
    """Rotate each patch PSF to its azimuth and resize it to the simulated
    resolution; each renormalized to unit sum. Returns (1, N, kh, kw, C)."""
    gh, gw = psf_grid_shape
    x_map = np.asarray(x_map)
    y_map = np.asarray(y_map)
    x_center = (np.arange(gw) + 0.5) / gw * (x_map[-1] - x_map[0]) + x_map[0]
    y_center = (np.arange(gh) + 0.5) / gh * (y_map[-1] - y_map[0]) + y_map[0]
    angles = torch.as_tensor(np.arctan2(x_center[None, :], y_center[:, None]).reshape(-1),
                             dtype=interpolated_psfs.dtype, device=interpolated_psfs.device)
    rotated = rotate_image_bilinear(interpolated_psfs, -angles)
    resized = resize_bilinear(rotated, tuple(int(v) for v in resized_psf_shape))
    resized = resized / torch.sum(resized, dim=(1, 2), keepdim=True)
    return resized[None, ...]


def sample_distortion_shifts(specs, lens, y_centroid: torch.Tensor) -> torch.Tensor:
    """Relative distortion shifts at equidistant fields: the traced image
    heights against the paraxial ones, over the paraxial full-field height."""
    from torchoptics_tpu_torch.ops import abcd as abcd_mod
    n_fields = y_centroid.shape[0]
    fields = np.linspace(0, 1, n_fields)
    y_ref = abcd_mod.get_paraxial_heights_at_image_plane(specs, lens, fields)[0]
    return (y_centroid - y_ref) / y_ref[-1]


def interpolate_distortion_shifts(sampled_shifts: torch.Tensor, x: torch.Tensor,
                                  y: torch.Tensor):
    """Radial interpolation of the distortion shifts into x / y shift maps."""
    n_fields = sampled_shifts.shape[0]
    r = torch.sqrt(x ** 2 + y ** 2)
    angle = torch.atan2(y, x)
    shift = linear_interpolation(r * (n_fields - 1), sampled_shifts)
    return shift * torch.cos(angle), shift * torch.sin(angle)


def interpolate_relative_illumination(sampled: torch.Tensor,
                                      field_map: torch.Tensor) -> torch.Tensor:
    """Relative-illumination map from per-field samples."""
    n_fields = sampled.shape[0]
    return linear_interpolation(field_map * (n_fields - 1), sampled)
