// Kernel S1, adjoint: the gradients of the PSF splat (psf_splat_fwd.cu) for
// a cotangent G of its half kernels, for training through the rendered image
// (torchoptics_tpu_torch/ops/psf.py: _Splat.backward).
//
// No Pallas kernel is replaced: XLA differentiates the JAX package's fused
// broadcast (torchoptics_tpu/ops/psf.py:75-86). The forward sums ex[r, ix] *
// ey[r, iy] * w[r] over the rays r of each (grid, channel) pair. Per ray, in
// double, with ex and ey recomputed as the forward takes them (s1::factor;
// ey without the weight):
//
//   A[ix] = sum_iy G[iy, ix] ey[iy],   B[iy] = sum_ix G[iy, ix] ex[ix]
//   tx[ix] = ((A ex) qx) w,  qx = (x - gx) (1 / sigma_x^2);  ty alike with B
//   d/dx = -sum_ix tx,  d/dy = -sum_iy ty,  d/dw = sum_iy B ey,
//
// A and B in index order from 0.0. The sums over a ray's bins run in two
// levels (ops/psf.py:grouped_sum): the bins fall into groups (j, t), bins
// 40 j + 8 n + 2 t + e (n < 5, e < 2), each group summed in index order from
// 0.0, then the groups' sums in order (j, then t) from 0.0, each result
// rounded once. With `bins` (the grid's centres and widths need a gradient:
// compute_psf sized the grid from the data), also d/dgx[ix] = sum tx and
// d/dsigma_x = sum tx (x - gx) (1 / sigma_x) (y alike): a block sums its
// span's rays in order for each bin; the second kernel sums them per grid
// over (channel, span) in order, and d/dsigma over the bins last. The plain
// PyTorch version is ops/psf.py:splat_backward_reference; the two agree bit
// for bit.
//
// One kernel gives those bits on every grid and call (s1_bwd_window_kernel,
// below): it sums each ray only over the bins its factors reach. A kernel
// holding the whole cotangent and every bin's factors in shared memory is
// 2.5x slower on the main path's call at the default 65 x 33 grid and
// faster only on calls no step makes there (d/dw or the per-bin sums, 4 %;
// float64, 14 %; PERF.md), so there is no second kernel.
//
// Why a window is exact. compute_psf sets sigma to half a bin, and a factor
// exp_t(-q / 2), q = ((v - c)^2) / sigma^2, is exactly +0 once q > q_max
// (psf_splat.cuh: 210 for float32, 14.5 sigma or 7.2 bins, so at most 15
// bins an axis; 1500 for float64, 19.4 bins). The plain version adds the
// other bins' terms as they are: A's G ey and B's G ex are +-0 there, as
// are the terms ((A ex) q) w, B ey and, with bins, t (v - c) / sigma,
// provided G, A, B, q and w are finite; a sum that starts at +0.0 is never
// -0.0, and adding +-0 to it changes nothing. So the window's sums are the
// plain version's bits when all of these hold, each checked:
// - q_max: exp_t(-q / 2) == 0 for every q > q_max on the card. float32:
//   every float above it is probed (psf_splat_probe.cu). float64: nvcc's
//   exp returns +0 by a branch for every argument a <= -745 (psf_splat.cuh),
//   and -q / 2 < -750; the probe checks every double in (1500, 1501], the
//   binades' end points and 2^26 q spread up to +inf.
// - A window [lo, hi] holds every bin with q <= q_max: q is monotone in a
//   bin's distance when the centres ascend (each operation rounds
//   monotonically), so the bins with q <= q_max are one interval. It is
//   guessed from the ends' spacing and confirmed at the bins just outside:
//   c[lo - 1] <= v with q > q_max puts every bin left of it out too, and
//   the right alike; a side whose guess fails is found by bisection. The
//   window may be wider than needed; a wider window changes no bit.
// - The whole grid (no window) for every ray of a block whose grid has a
//   non-finite or descending centre, or a sigma whose sigma^2 (in the
//   inputs' type) is not finite and positive or whose 1 / sigma^2 or 1 /
//   sigma (double) is not finite; or whose pair's cotangent has an entry
//   that is not finite (or, for float64, not below 2^960, so that A and B
//   cannot overflow); and for a ray whose x, y or w is not finite, or
//   whose (v - c) / sigma^2 is not finite at an end of either axis (then
//   at no bin between, by monotony). Those rays sum over every bin in the
//   same order, so NaN and inf come out as the plain version's.
// - Order: A and B in index order from 0.0 over the window (float32: the
//   products exact in double, one fused multiply-add; float64: separate
//   multiplies and adds); d/dx, d/dy and d/dw by grouped_sum's groups (j,
//   t) in that order (Grouped); an empty window gives -(+0.0) = -0.0 for
//   d/dx and d/dy, as the plain version does.
//
// Design: one thread a ray, 512 a block; a block is a part of a span (a
// whole span with bins, whose per-bin sums run in ray order), the parts cut
// so that the card gets ~8 waves. The block stages the centres and, where
// it fits (float32 up to ~220 KB: 257 x 129 is 133 KB), the pair's
// cotangent in shared memory; else it reads them through L1/L2, so no grid
// is refused. Where a ray's x window fits one frame of 16 bins (always at
// sigma = half a bin in float32), both sides run in one sweep: the frame's
// ex and A in registers, each row of the y window read once, B summed
// across the frame and its term added straight away. Other rays run the
// two sides apart in frames of 16 out bins (side), the other axis's factors
// recomputed per frame. With bins, each step's terms go to a zeroed tile in
// shared memory, which one thread a bin sums in ray order onto the span's
// sums in its scratch row; where a tile of every bin does not fit at 32
// rays a step, the bins (x's, then y's) are taken in chunks of a tile's
// width, a pass over the span's rays each: a later pass runs only the rays
// whose windows reach its bins, and only the first writes d/dx, d/dy, d/dw.
//
// What bounds it at psf 257 (63 pairs, 257 x 129, 65,536 rays, at most 15
// x 15 bins a ray): ~480 FP64 multiply-adds and 240 cotangent reads (each a
// float-to-double conversion) a ray, ~2e9 multiply-adds in all: 0.12 ms at
// the DFMA rate; the conversions (16 an SM a clock) 0.27 ms; the bytes
// (x, y, the cotangent once, d/dx, d/dy) 0.03 ms. Measured on an H100 80GB
// HBM3 at 700 W: 0.89 ms, against 18.0 ms for its two contractions by
// torch.einsum; latency holds it: 256 threads a block (no spills at 255
// registers, half the warps) took 1.29x as long, the cotangent read through
// L1 instead of staged 1.18x, the two sides apart for every ray 1.53x. At
// the default 65 x 33 grid it takes 0.81-0.83 ms, and 0.86 at 129 x 65.

#include <cuda_runtime.h>

#include <algorithm>

#include "psf_splat.cuh"

namespace {

using s1::Axis;
using s1::factor;
using s1::window;

// The windowed kernel's shape: one ray a thread, W_THREADS threads a block
// (at least W_MIN_THREADS with bins); a frame is WF consecutive bins of one
// axis, held in registers.
constexpr int WF = 16;
constexpr int W_THREADS = 512;
constexpr int W_MIN_THREADS = 32;
// Blocks the launcher aims for where rays may be cut finer than spans (no
// per-bin sums): eight waves of one block an SM on an H100.
constexpr int W_TARGET_BLOCKS = 132 * 8;

// acc + a * b as the plain version takes it: for float32 inputs the product
// is exact in double, so one fused multiply-add rounds alike; for float64
// the product and the sum apart.
template <typename T>
__device__ inline double prod_add(double acc, double a, double b) {
  if constexpr (sizeof(T) == 4)
    return fma(a, b, acc);
  else
    return s1::madd(a, b, acc);
}

// grouped_sum's two levels (ops/psf.py) for terms that arrive in ascending
// bin order: group (j, t) of bin b is j = b / 40, t = (b / 2) % 4; each
// group's running sum from 0.0, the groups of j added onto the total in t
// order once a bin of a later j arrives, and at the end. A group no term
// reached sums to +0.0, which changes no total (a sum from 0.0 is never
// -0.0), so only the groups of the bins added need to be visited.
struct Grouped {
  double g0 = 0.0, g1 = 0.0, g2 = 0.0, g3 = 0.0, total = 0.0;
  int j = 0;

  __device__ void flush() {
    total = (((total + g0) + g1) + g2) + g3;
    g0 = g1 = g2 = g3 = 0.0;
  }
  __device__ void add(int b, double v) {
    const int jb = b / 40;
    if (jb != j) {
      flush();
      j = jb;
    }
    const int t = (b >> 1) & 3;
    g0 = t == 0 ? g0 + v : g0;
    g1 = t == 1 ? g1 + v : g1;
    g2 = t == 2 ? g2 + v : g2;
    g3 = t == 3 ? g3 + v : g3;
  }
  __device__ double finish() {
    flush();
    return total;
  }
};

// A ray's row of the bins' term tile: bins [lo, hi) of one axis, bin b at
// row[b - lo]; row null: no bins.
struct TermRow {
  double* row = nullptr;
  int lo = 0, hi = 0;

  __device__ void put(int b, double v) const {
    if (row && b >= lo && b < hi) row[b - lo] = v;
  }
};

// One side of a ray's adjoint over its windows: the "out" axis ao in frames
// of WF bins over [olo, ohi], each frame's sums acc[b] = sum over the k
// bins [klo, khi] of G(b, k) f_k, G(b, k) = G[b so + k sk] (the out index
// clamped into the grid; a slot outside the window is never used). Side x:
// acc = A, the terms tx = ((A ex) qx) w into `out`; side y: acc = B, ty =
// ((B ey) qy) w into `out`, B ey into `outw` (FULL). Each term is also
// put into `terms` (the per-bin sums' tile row).
template <typename T, bool FULL>
__device__ void side(const T* G, int so, int sk, const Axis<T>& ao, const Axis<T>& ak, T vo,
                     T vk, double vod, double wd, int olo, int ohi, int klo, int khi,
                     Grouped& out, Grouped& outw, const TermRow& terms) {
  for (int f0 = olo & ~1; f0 <= ohi; f0 += WF) {
    double fo[WF], acc[WF];
#pragma unroll
    for (int k = 0; k < WF; ++k) {
      const int b = f0 + k;
      fo[k] = b >= olo && b <= ohi ? factor(vo, ao.c[b], ao.s2) : 0.0;
      acc[k] = 0.0;
    }
    for (int kk = klo; kk <= khi; ++kk) {
      const double fk = factor(vk, ak.c[kk], ak.s2);
      const T* row = G + (size_t)kk * sk;
#pragma unroll
      for (int k = 0; k < WF; ++k)
        acc[k] = prod_add<T>(acc[k], (double)row[(size_t)min(f0 + k, ao.n - 1) * so], fk);
    }
#pragma unroll
    for (int k = 0; k < WF; ++k) {
      const int b = f0 + k;
      const bool in = b >= olo && b <= ohi;
      const double prod = acc[k] * fo[k];
      const double t = (prod * ((vod - (double)ao.c[in ? b : 0]) * ao.inv2)) * wd;
      out.add(b, in ? t : 0.0);
      if constexpr (FULL) {
        outw.add(b, in ? prod : 0.0);
        if (in) terms.put(b, t);
      }
    }
  }
}

// The shared memory of a windowed block, in bytes from its start: with
// bins, the step's terms (kr rows of tb bins, doubles, zeroed) and its
// rays' x and y (doubles); with cen_shared, the centres (ny of y's, nx of
// x's, in the inputs' type); with g_shared, the pair's cotangent (ny x nx,
// the inputs' type).
struct WinLayout {
  size_t tile, rays, cen, g, total;

  __host__ __device__ WinLayout(int ny, int nx, int kr, int tb, bool bins, bool cen_shared,
                                bool g_shared, int tsize) {
    tile = 0;
    rays = tile + (bins ? (size_t)kr * tb * 8 : 0);
    cen = rays + (bins ? 2 * (size_t)kr * 8 : 0);
    g = cen + (cen_shared ? (((size_t)(nx + ny) * tsize + 15) & ~(size_t)15) : 0);
    total = g + (g_shared ? (size_t)ny * nx * tsize : 0);
  }
};

// Block b = (pair * n_spans + span) * n_parts + part: a part of a span's
// rays (a whole span with bins), kr rays a step, one a thread. dw null: no
// d/dw; sums null: no bins (FULL: either is asked for); then the span's
// per-bin sums go to its row of `sums`, tb bins a pass. CEN: the centres
// staged in shared memory (a template argument, so that their loads are
// shared-memory loads), else read from global memory.
template <typename T, bool FULL, bool CEN>
__global__ void __launch_bounds__(W_THREADS, 1) s1_bwd_window_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, const T* __restrict__ cot, T* __restrict__ dx, T* __restrict__ dy,
    T* __restrict__ dw, double* __restrict__ sums, int n_ch, int n_rays, int ny, int nx,
    int span, int n_spans, int n_parts, int tb, int g_shared) {
  extern __shared__ double smem[];
  char* base_b = reinterpret_cast<char*>(smem);
  const bool with_dw = FULL && dw != nullptr;
  const bool bins = FULL && sums != nullptr;
  const int kr = blockDim.x, tid = threadIdx.x;
  const WinLayout L(ny, nx, kr, tb, bins, CEN, g_shared != 0, (int)sizeof(T));
  const int part = blockIdx.x % n_parts;
  const int block = blockIdx.x / n_parts;
  const int pair = block / n_spans;
  const int g = pair / n_ch;
  const int s0 = (block - pair * n_spans) * span;
  const int s_end = min(s0 + span, n_rays);
  const int per = s1::cdiv(s1::cdiv(s_end - s0, n_parts), kr) * kr;
  const int r0 = s0 + part * per;
  const int r_end = min(r0 + per, s_end);
  if (r0 >= r_end) return;  // the whole block: a part past its span's end
  const size_t base = (size_t)pair * n_rays;
  const T* cp = cot + (size_t)pair * ny * nx;

  const T* cy = gy + (size_t)g * ny;
  const T* cx = gx + (size_t)g * nx;
  if constexpr (CEN) {
    T* sc = reinterpret_cast<T*>(base_b + L.cen);
    for (int k = tid; k < ny + nx; k += kr) sc[k] = k < ny ? cy[k] : cx[k - ny];
    cy = sc;
    cx = sc + ny;
  }
  // The pair's cotangent: staged where it fits; either way every entry must
  // be finite (and, for float64, below 2^960, so that A and B stay finite)
  // for any window to be taken.
  const T* G = cp;
  bool fine = true;
  if (g_shared) {
    T* sG = reinterpret_cast<T*>(base_b + L.g);
    for (int k = tid; k < ny * nx; k += kr) {
      const T v = cp[k];
      sG[k] = v;
      fine = fine && fabs((double)v) < 0x1p960;
    }
    G = sG;
  } else {
    for (int k = tid; k < ny * nx; k += kr) fine = fine && fabs((double)cp[k]) < 0x1p960;
  }
  if (bins) {
    double* zero = reinterpret_cast<double*>(base_b + L.tile);
    const size_t n_zero = (size_t)kr * tb;
    for (size_t k = tid; k < n_zero; k += kr) zero[k] = 0.0;
  }
  __syncthreads();
  fine = __syncthreads_and(fine);
  // The centres finite and ascending, each axis.
  const bool asc =
      __syncthreads_and(s1::ascending(cy, ny, tid, kr) && s1::ascending(cx, nx, tid, kr));
  const Axis<T> ay = s1::make_axis(cy, ny, sy[g]);
  const Axis<T> ax = s1::make_axis(cx, nx, sx[g]);
  // Windows need a finite, positive sigma^2 and finite 1 / sigma^2, 1 / sigma
  // (so that q and the terms' factors are never NaN), ascending centres and
  // a fine cotangent; else every ray takes the whole grid.
  auto sig_ok = [](const Axis<T>& a) {
    return s1::sigma_ok(a) && isfinite(a.inv2) && isfinite(a.inv1);
  };
  const bool ruled = fine && asc && sig_ok(ay) && sig_ok(ax);
  double* tile = reinterpret_cast<double*>(base_b + L.tile);
  double* RX = reinterpret_cast<double*>(base_b + L.rays);
  double* RY = RX + kr;
  double* span_sums = bins ? sums + (size_t)block * 2 * (nx + ny) : nullptr;

  // Without bins one pass; with bins a pass a chunk [t0, t1) of the bins
  // x's then y's (t < nx: x bin t, else y bin t - nx).
  const int n_chunks = bins ? s1::cdiv(nx + ny, tb) : 1;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * tb, t1 = min(t0 + tb, nx + ny);
    for (int c0 = r0; c0 < r_end; c0 += kr) {
      const int r = c0 + tid;
      if (r < r_end) {
        const T xv = x[base + r], yv = y[base + r];
        const T wv = w ? w[base + r] : T(1);
        const double xd = (double)xv, yd = (double)yv, wd = (double)wv;
        // A ray takes windows only if x, y, w are finite and its terms'
        // factor (v - c) / sigma^2 is finite at both ends of each axis (then
        // at every bin between): then a bin outside a window adds only +-0
        // terms.
        bool nice = ruled && isfinite(xv) && isfinite(yv) && isfinite(wv);
        if (nice) {
          const double e[4] = {(xd - (double)cx[0]) * ax.inv2, (xd - (double)cx[nx - 1]) * ax.inv2,
                               (yd - (double)cy[0]) * ay.inv2, (yd - (double)cy[ny - 1]) * ay.inv2};
          nice = isfinite(e[0]) && isfinite(e[1]) && isfinite(e[2]) && isfinite(e[3]);
        }
        int xlo = 0, xhi = nx - 1, ylo = 0, yhi = ny - 1;
        if (nice) {
          window(ax, xv, xlo, xhi);
          window(ay, yv, ylo, yhi);
        }
        TermRow trx, try_;
        if (bins) {
          RX[tid] = xd;
          RY[tid] = yd;
          trx = {tile + (size_t)tid * tb, t0, min(t1, nx)};
          try_ = {tile + (size_t)tid * tb, t0 - nx, t1 - nx};
        }
        // A later chunk runs only the rays with a term among its bins.
        const bool some = xlo <= xhi && ylo <= yhi;
        const bool run = ch == 0 || (some && ((max(xlo, trx.lo) < min(xhi + 1, trx.hi)) ||
                                              (max(ylo, try_.lo) < min(yhi + 1, try_.hi))));
        Grouped gxs, gys, gws;
        const int f0 = xlo & ~1;
        if (!run || (nice && !some)) {
          // An empty window: every A and B is +0, every term +-0; the sums
          // stay +0.0 (d/dx and d/dy -0.0).
        } else if (nice && xhi - f0 < WF) {
          // Both sides in one sweep: the x window in one frame, A over its
          // slots and B summed across them (a slot outside the window has ex
          // = +0 and a finite G: +-0, no change), row by row of the y window.
          double ex[WF], A[WF];
#pragma unroll
          for (int k = 0; k < WF; ++k) {
            const int b = f0 + k;
            ex[k] = b >= xlo && b <= xhi ? factor(xv, cx[b], ax.s2) : 0.0;
            A[k] = 0.0;
          }
          for (int iy = ylo; iy <= yhi; ++iy) {
            const double ey = factor(yv, cy[iy], ay.s2);
            const T* row = G + (size_t)iy * nx;
            double B = 0.0;
#pragma unroll
            for (int k = 0; k < WF; ++k) {
              const double gv = (double)row[min(f0 + k, nx - 1)];
              A[k] = prod_add<T>(A[k], gv, ey);
              B = prod_add<T>(B, gv, ex[k]);
            }
            const double be = B * ey;
            const double t = (be * ((yd - (double)cy[iy]) * ay.inv2)) * wd;
            gys.add(iy, t);
            if constexpr (FULL) {
              gws.add(iy, be);
              try_.put(iy, t);
            }
          }
#pragma unroll
          for (int k = 0; k < WF; ++k) {
            const int b = f0 + k;
            const bool in = b >= xlo && b <= xhi;
            const double t = ((A[k] * ex[k]) * ((xd - (double)cx[in ? b : 0]) * ax.inv2)) * wd;
            gxs.add(b, in ? t : 0.0);
            if constexpr (FULL)
              if (in) trx.put(b, t);
          }
        } else {
          Grouped unused;
          side<T, FULL>(G, 1, nx, ax, ay, xv, yv, xd, wd, xlo, xhi, ylo, yhi, gxs, unused, trx);
          side<T, FULL>(G, nx, 1, ay, ax, yv, xv, yd, wd, ylo, yhi, xlo, xhi, gys, gws, try_);
        }
        if (ch == 0) {
          dx[base + r] = (T)(-gxs.finish());
          dy[base + r] = (T)(-gys.finish());
          if constexpr (FULL)
            if (with_dw) dw[base + r] = (T)gws.finish();
        }
      }
      if (bins) {
        // One thread a bin of the chunk: the step's terms in ray order onto
        // the span's sums (from 0.0 at its first step), the tile zeroed
        // behind.
        __syncthreads();
        const int n_valid = min(kr, r_end - c0);
        for (int t = t0 + tid; t < t1; t += kr) {
          const bool is_x = t < nx;
          const int b = is_x ? t : t - nx;
          const int n = is_x ? nx : ny;
          double* col = tile + (t - t0);
          const double* rv = is_x ? RX : RY;
          const double cb = (double)(is_x ? cx[b] : cy[b]);
          const double inv1 = is_x ? ax.inv1 : ay.inv1;
          double* s = span_sums + (is_x ? 0 : 2 * nx);
          double a = c0 == r0 ? 0.0 : s[b], v = c0 == r0 ? 0.0 : s[n + b];
          for (int rr = 0; rr < n_valid; ++rr) {
            const double tt = col[(size_t)rr * tb];
            a = a + tt;
            v = v + tt * ((rv[rr] - cb) * inv1);
            col[(size_t)rr * tb] = 0.0;
          }
          s[b] = a;
          s[n + b] = v;
        }
        __syncthreads();
      }
    }
  }
}

// The per-bin second pass, a block a grid: d/dgx, d/dgy summed over the
// grid's (channel, span) blocks in order; d/dsigma the same per bin (into
// cols, n_grids x (nx + ny) doubles of scratch), then over the bins in
// order; each rounded once.
template <typename T>
__global__ void s1_bwd_bins(const double* __restrict__ sums, double* __restrict__ cols,
                            T* __restrict__ dgx, T* __restrict__ dgy, T* __restrict__ dsx,
                            T* __restrict__ dsy, int n_ch, int n_spans, int ny, int nx) {
  const int g = blockIdx.x;
  const int stride = 2 * (nx + ny);
  const int n_blocks = n_ch * n_spans;
  const double* src = sums + (size_t)g * n_blocks * stride;
  double* col = cols + (size_t)g * (nx + ny);
  for (int t = threadIdx.x; t < nx + ny; t += blockDim.x) {
    const bool is_x = t < nx;
    const int b = is_x ? t : t - nx;
    const int off_g = is_x ? b : 2 * nx + b;
    const int off_s = is_x ? nx + b : 2 * nx + ny + b;
    double a = 0.0, s = 0.0;
    for (int k = 0; k < n_blocks; ++k) {
      a = a + src[(size_t)k * stride + off_g];
      s = s + src[(size_t)k * stride + off_s];
    }
    if (is_x)
      dgx[(size_t)g * nx + b] = (T)a;
    else
      dgy[(size_t)g * ny + b] = (T)a;
    col[t] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int ix = 0; ix < nx; ++ix) s = s + col[ix];
    dsx[g] = (T)s;
  } else if (threadIdx.x == 32) {
    double s = 0.0;
    for (int iy = 0; iy < ny; ++iy) s = s + col[nx + iy];
    dsy[g] = (T)s;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                   const void* sy, const void* w, const void* cot, void* dx, void* dy, void* dw,
                   double* sums, void* dgx, void* dgy, void* dsx, void* dsy, int n_grids,
                   int n_ch, int n_rays, int ny, int nx, int span, cudaStream_t stream) {
  const bool bins = sums != nullptr, full = dw != nullptr || bins;
  const int n_spans = (n_rays + span - 1) / span;
  const long long spans = (long long)n_grids * n_ch * n_spans;
  cudaError_t err = cudaSuccess;
  if (spans > 0) {
    // The most threads (rays a step) whose layout fits, the centres and then
    // the cotangent staged where they fit; with bins a tile of every bin,
    // down to W_MIN_THREADS, else W_MIN_THREADS and the widest tile that
    // fits. Without bins the layout does not depend on the threads, and
    // with nothing staged it is empty: every grid launches.
    const int n_bins = nx + ny, ts = (int)sizeof(T);
    int threads = 0, tb = bins ? n_bins : 0;
    bool cen_shared = false, g_shared = false;
    for (int t = W_THREADS; t >= W_MIN_THREADS && threads == 0; t /= 2)
      for (int o = 0; o < 3; ++o)
        if (WinLayout(ny, nx, t, tb, bins, o < 2, o == 0, ts).total <= s1::SMEM_MAX) {
          threads = t;
          cen_shared = o < 2;
          g_shared = o == 0;
          break;
        }
    if (threads == 0) {
      threads = W_MIN_THREADS;
      cen_shared = WinLayout(ny, nx, threads, 64, bins, true, false, ts).total <= s1::SMEM_MAX;
      const size_t rest = WinLayout(ny, nx, threads, 0, bins, cen_shared, false, ts).total;
      tb = (int)((s1::SMEM_MAX - rest) / ((size_t)threads * 8));
    }
    // Without bins a span's rays may be cut into parts of whole steps.
    const long long want = (W_TARGET_BLOCKS + spans - 1) / spans;
    const int n_parts = bins ? 1 : (int)std::min<long long>(want, (span + threads - 1) / threads);
    const long long blocks = spans * n_parts;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t smem = WinLayout(ny, nx, threads, tb, bins, cen_shared, g_shared, ts).total;
    auto kernel = full ? (cen_shared ? s1_bwd_window_kernel<T, true, true>
                                     : s1_bwd_window_kernel<T, true, false>)
                       : (cen_shared ? s1_bwd_window_kernel<T, false, true>
                                     : s1_bwd_window_kernel<T, false, false>);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(
        (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
        (const T*)w, (const T*)cot, (T*)dx, (T*)dy, (T*)dw, sums, n_ch, n_rays, ny, nx, span,
        n_spans, n_parts, tb, (int)g_shared);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if (sums && n_grids > 0) {
    double* cols = sums + (size_t)n_grids * n_ch * n_spans * 2 * (nx + ny);
    s1_bwd_bins<T><<<n_grids, 128, 0, stream>>>(sums, cols, (T*)dgx, (T*)dgy, (T*)dsx,
                                                 (T*)dsy, n_ch, n_spans, ny, nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches S1's adjoint on `stream` and returns cudaGetLastError() (0 on
// success). Inputs as s1_fwd_launch's, and the cotangent (n_grids, n_ch, ny,
// nx); dx, dy and dw (null: no d/dw) (n_grids, n_ch, n_rays). With `bins`:
// sums n_grids * (n_ch * ceil(n_rays / span) * 2 + 1) * (nx + ny) doubles of
// scratch, dgx (n_grids, nx), dgy (n_grids, ny), dsx, dsy (n_grids,), and a
// second launch; without, those are null. Of the inputs' type (float32, or
// float64 with `dbl`), contiguous.
int s1_bwd_launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                  const void* sy, const void* w, const void* cot, void* dx, void* dy, void* dw,
                  double* sums, void* dgx, void* dgy, void* dsx, void* dsy, int n_grids,
                  int n_ch, int n_rays, int ny, int nx, int span, int dbl, int bins, void* stream) {
  if (n_grids < 0 || n_ch < 0 || n_rays < 0 || ny < 1 || nx < 1 || span < s1::CHUNK ||
      span % s1::CHUNK != 0 || (bins && !(sums && dgx && dgy && dsx && dsy)))
    return (int)cudaErrorInvalidValue;
  if (!bins) sums = nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dbl ? launch<double>(x, y, gx, gy, sx, sy, w, cot, dx, dy, dw, sums, dgx, dgy,
                                    dsx, dsy, n_grids, n_ch, n_rays, ny, nx, span, s)
                   : launch<float>(x, y, gx, gy, sx, sy, w, cot, dx, dy, dw, sums, dgx, dgy,
                                   dsx, dsy, n_grids, n_ch, n_rays, ny, nx, span, s));
}

}  // extern "C"
