// Kernel S1, adjoint: the gradients of the PSF splat (psf_splat_fwd.cu) for
// a cotangent G of its half kernels, for training through the rendered image
// (torchoptics_tpu_torch/ops/psf.py: _Splat.backward).
//
// No Pallas kernel is replaced: XLA differentiates the JAX package's fused
// broadcast (torchoptics_tpu/ops/psf.py:75-86). The forward sums ex[r, ix] *
// ey[r, iy] * w[r] over the rays r of each (grid, channel) pair. Per ray, in
// double, with ex and ey recomputed as the forward takes them (ey without
// the weight):
//
//   A[ix] = sum_iy G[iy, ix] ey[iy],   B[iy] = sum_ix G[iy, ix] ex[ix]
//   tx[ix] = ((A ex) qx) w,  qx = (x - gx) (1 / sigma_x^2);  ty alike with B
//   d/dx = -sum_ix tx,  d/dy = -sum_iy ty,  d/dw = sum_iy B ey,
//
// each sum in index order from 0.0 and rounded once. With `bins` (the grid's
// centres and widths need a gradient: compute_psf sized the grid from the
// data), also d/dgx[ix] = sum tx and d/dsigma_x = sum tx (x - gx) (1 /
// sigma_x) (y alike): a block sums its span's rays in order for each bin;
// the second kernel sums them per grid over (channel, span) in order, and
// d/dsigma over the bins last. The plain PyTorch version is
// ops/psf.py:splat_backward_reference; the two agree bit for bit.
//
// What bounds it on an H100, at the default configuration (63 pairs, a 65 x
// 33 half grid, 65,536 rays): A and B are 2 x 8.86e9 products and sums,
// with the factors and the terms 4.03e10 operations, 0.60 ms at 67
// TFLOP/s; the bytes (x, y, the cotangent read once, d/dx and d/dy written
// once) take 0.02 ms. Operations bound it; this design's products are
// double FMAs outside the tensor cores (34 TFLOP/s: 1.06 ms).
//
// Design: a block per (pair, span), as the forward's. It stages the pair's
// cotangent once as doubles in both layouts (G[iy][ix] and its transpose,
// 37 KB at 65 x 33), then walks its span rc rays a step: the step's factors
// into shared memory (ey[iy][r], ex[ix][r]), A and B as 4 x 4 register tiles
// of (rays, bins) over the cotangent, each tile's terms tx, ty into shared
// memory, then one thread a ray sums d/dx or d/dy (and d/dw), and one thread
// a bin carries the span's per-bin sums. rc is 32, or fewer rays where a
// large grid's staged cotangent leaves less than 227 KB of shared memory.

#include <cuda_runtime.h>

#include "psf_splat.cuh"

namespace {

using s1::TILE;

constexpr int THREADS = 256;
constexpr int MAX_RC = 32;  // rays a step

// A block's shared memory, in doubles, for an ny x nx half grid at rc rays a
// step; `be` keeps B ey for d/dw.
struct Layout {
  int nyp, nxp;
  size_t g, gt, eyt, ext, tx, ty, be, xr, yr, wr, gxs, gys, sums, total;

  __host__ __device__ Layout(int ny, int nx, int rc, bool with_be) {
    nyp = s1::pad4(ny);
    nxp = s1::pad4(nx);
    g = 0;                                   // G[iy][ix], row pitch nxp
    gt = g + (size_t)ny * nxp;               // G[ix][iy], row pitch nyp
    eyt = gt + (size_t)nx * nyp;             // ey[iy][r], row pitch rc
    ext = eyt + (size_t)ny * rc;             // ex[ix][r]
    tx = ext + (size_t)nx * rc;              // tx[r][ix], row pitch nxp
    ty = tx + (size_t)rc * nxp;              // ty[r][iy], row pitch nyp
    be = ty + (size_t)rc * nyp;              // B ey [r][iy]
    xr = be + (with_be ? (size_t)rc * nyp : 0);  // the step's x, y, w in double
    yr = xr + rc;
    wr = yr + rc;
    gxs = wr + rc;                           // the grid's centres in double
    gys = gxs + nx;
    sums = gys + ny;                         // the span's bin sums: gx, sx, gy, sy
    total = sums + 2 * (size_t)(nx + ny);
  }

  size_t bytes() const { return sizeof(double) * total; }
};

// The most rays a step (a multiple of TILE, at most MAX_RC) whose layout fits
// a block's shared memory; 0 if none does.
int step_rays(int ny, int nx, bool with_be) {
  for (int rc = MAX_RC; rc >= TILE; rc -= TILE)
    if (Layout(ny, nx, rc, with_be).bytes() <= s1::SMEM_MAX) return rc;
  return 0;
}

// Block b = pair * n_spans + span. dw null: no d/dw; sums null: no bins.
template <typename T>
__global__ void __launch_bounds__(THREADS) s1_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, const T* __restrict__ cot, T* __restrict__ dx, T* __restrict__ dy,
    T* __restrict__ dw, double* __restrict__ sums, int n_ch, int n_rays, int ny, int nx,
    int span, int n_spans, int rc) {
  extern __shared__ double smem[];
  const bool with_be = dw != nullptr;
  const bool bins = sums != nullptr;
  const Layout L(ny, nx, rc, with_be);
  double* sG = smem + L.g;
  double* sGT = smem + L.gt;
  double* sEY = smem + L.eyt;
  double* sEX = smem + L.ext;
  double* sTX = smem + L.tx;
  double* sTY = smem + L.ty;
  double* sBE = smem + L.be;
  double* sXR = smem + L.xr;
  double* sYR = smem + L.yr;
  double* sWR = smem + L.wr;
  double* sGX = smem + L.gxs;
  double* sGY = smem + L.gys;
  double* sSum = smem + L.sums;
  const int pair = blockIdx.x / n_spans;
  const int g = pair / n_ch;
  const int r0 = (blockIdx.x - pair * n_spans) * span;
  const int r_end = min(r0 + span, n_rays);
  const T s2x = sx[g] * sx[g];
  const T s2y = sy[g] * sy[g];
  const double sxd = (double)sx[g], syd = (double)sy[g];
  const double inv2x = 1.0 / (sxd * sxd), inv2y = 1.0 / (syd * syd);
  const double inv1x = 1.0 / sxd, inv1y = 1.0 / syd;
  const size_t base = (size_t)pair * n_rays;
  const T* xp = x + base;
  const T* yp = y + base;
  const T* wp = w ? w + base : nullptr;
  const T* gxp = gx + (size_t)g * nx;
  const T* gyp = gy + (size_t)g * ny;
  const T* cp = cot + (size_t)pair * ny * nx;
  const int tid = threadIdx.x;

  for (int k = tid; k < ny * L.nxp; k += blockDim.x) {
    const int iy = k / L.nxp, ix = k - iy * L.nxp;
    sG[k] = ix < nx ? (double)cp[iy * nx + ix] : 0.0;
  }
  for (int k = tid; k < nx * L.nyp; k += blockDim.x) {
    const int ix = k / L.nyp, iy = k - ix * L.nyp;
    sGT[k] = iy < ny ? (double)cp[iy * nx + ix] : 0.0;
  }
  for (int k = tid; k < nx; k += blockDim.x) sGX[k] = (double)gxp[k];
  for (int k = tid; k < ny; k += blockDim.x) sGY[k] = (double)gyp[k];
  for (int k = tid; k < 2 * (nx + ny); k += blockDim.x) sSum[k] = 0.0;

  const int mt = rc / TILE;
  const int n_a = mt * (L.nxp / TILE);
  const int n_b = mt * (L.nyp / TILE);
  const int n_tasks = 2 * rc + (bins ? nx + ny : 0);
  for (int c0 = r0; c0 < r_end; c0 += rc) {
    const int n_valid = min(rc, r_end - c0);
    __syncthreads();  // the cotangent is staged, or the last step is read
    // The step's factors, bin-major so that neighbouring threads take
    // neighbouring rays; zero past the span's last ray.
    for (int k = tid; k < (ny + nx) * rc; k += blockDim.x) {
      const int b = k / rc, j = k - b * rc;
      double v = 0.0;
      if (b < ny) {
        if (j < n_valid) v = (double)s1::gauss(yp[c0 + j], gyp[b], s2y);
        sEY[b * rc + j] = v;
      } else {
        if (j < n_valid) v = (double)s1::gauss(xp[c0 + j], gxp[b - ny], s2x);
        sEX[(b - ny) * rc + j] = v;
      }
    }
    for (int j = tid; j < rc; j += blockDim.x) {
      const bool ok = j < n_valid;
      sXR[j] = ok ? (double)xp[c0 + j] : 0.0;
      sYR[j] = ok ? (double)yp[c0 + j] : 0.0;
      sWR[j] = ok && wp ? (double)wp[c0 + j] : 1.0;
    }
    __syncthreads();
    // A (tiles of rays x columns) and B (rays x rows), and their terms.
    for (int t = tid; t < n_a + n_b; t += blockDim.x) {
      const bool is_a = t < n_a;
      const int u = is_a ? t : t - n_a;
      const int mi = u % mt, ni = u / mt;
      double acc[TILE][TILE];
      s1::zero(acc);
      if (is_a)
        s1::tile_madd<T>(sEY + mi * TILE, rc, sG + ni * TILE, L.nxp, ny, acc);
      else
        s1::tile_madd<T>(sEX + mi * TILE, rc, sGT + ni * TILE, L.nyp, nx, acc);
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const int j = mi * TILE + i;
#pragma unroll
        for (int l = 0; l < TILE; ++l) {
          const int b = ni * TILE + l;
          if (is_a) {
            if (b < nx) {
              const double q = (sXR[j] - sGX[b]) * inv2x;
              sTX[j * L.nxp + b] = ((acc[i][l] * sEX[b * rc + j]) * q) * sWR[j];
            }
          } else if (b < ny) {
            const double be = acc[i][l] * sEY[b * rc + j];
            const double q = (sYR[j] - sGY[b]) * inv2y;
            sTY[j * L.nyp + b] = (be * q) * sWR[j];
            if (with_be) sBE[j * L.nyp + b] = be;
          }
        }
      }
    }
    __syncthreads();
    // One thread a ray: d/dx, or d/dy and d/dw; with bins, one thread a bin.
    for (int t = tid; t < n_tasks; t += blockDim.x) {
      if (t < rc) {
        if (t < n_valid) {
          double s = 0.0;
          for (int ix = 0; ix < nx; ++ix) s = s + sTX[t * L.nxp + ix];
          dx[base + c0 + t] = (T)(-s);
        }
      } else if (t < 2 * rc) {
        const int j = t - rc;
        if (j < n_valid) {
          double s = 0.0, sw = 0.0;
          for (int iy = 0; iy < ny; ++iy) {
            s = s + sTY[j * L.nyp + iy];
            if (with_be) sw = sw + sBE[j * L.nyp + iy];
          }
          dy[base + c0 + j] = (T)(-s);
          if (with_be) dw[base + c0 + j] = (T)sw;
        }
      } else if (t < 2 * rc + nx) {
        const int ix = t - 2 * rc;
        double a = sSum[ix], v = sSum[nx + ix];
        for (int j = 0; j < n_valid; ++j) {
          const double tt = sTX[j * L.nxp + ix];
          a = a + tt;
          v = v + tt * ((sXR[j] - sGX[ix]) * inv1x);
        }
        sSum[ix] = a;
        sSum[nx + ix] = v;
      } else {
        const int iy = t - 2 * rc - nx;
        double a = sSum[2 * nx + iy], v = sSum[2 * nx + ny + iy];
        for (int j = 0; j < n_valid; ++j) {
          const double tt = sTY[j * L.nyp + iy];
          a = a + tt;
          v = v + tt * ((sYR[j] - sGY[iy]) * inv1y);
        }
        sSum[2 * nx + iy] = a;
        sSum[2 * nx + ny + iy] = v;
      }
    }
  }
  if (bins) {
    __syncthreads();
    double* dst = sums + (size_t)blockIdx.x * 2 * (nx + ny);
    for (int k = tid; k < 2 * (nx + ny); k += blockDim.x) dst[k] = sSum[k];
  }
}

// The per-bin second pass, a block a grid: d/dgx, d/dgy summed over the
// grid's (channel, span) blocks in order; d/dsigma the same per bin, then
// over the bins in order; each rounded once.
template <typename T>
__global__ void s1_bwd_bins(const double* __restrict__ sums, T* __restrict__ dgx,
                            T* __restrict__ dgy, T* __restrict__ dsx, T* __restrict__ dsy,
                            int n_ch, int n_spans, int ny, int nx) {
  __shared__ double col[s1::MAX_NX + s1::MAX_NY];
  const int g = blockIdx.x;
  const int stride = 2 * (nx + ny);
  const int n_blocks = n_ch * n_spans;
  const double* src = sums + (size_t)g * n_blocks * stride;
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
  const int rc = step_rays(ny, nx, dw != nullptr);
  if (rc == 0) return cudaErrorInvalidValue;
  const size_t smem = Layout(ny, nx, rc, dw != nullptr).bytes();
  const int n_spans = (n_rays + span - 1) / span;
  const long long blocks = (long long)n_grids * n_ch * n_spans;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if (blocks > 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(s1_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    s1_bwd_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
        (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
        (const T*)w, (const T*)cot, (T*)dx, (T*)dy, (T*)dw, sums, n_ch, n_rays, ny, nx, span,
        n_spans, rc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (sums && n_grids > 0) {
    s1_bwd_bins<T><<<n_grids, 128, 0, stream>>>(sums, (T*)dgx, (T*)dgy, (T*)dsx, (T*)dsy, n_ch,
                                                 n_spans, ny, nx);
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
// sums n_grids * n_ch * ceil(n_rays / span) * 2 * (nx + ny) doubles of
// scratch, dgx (n_grids, nx), dgy (n_grids, ny), dsx, dsy (n_grids,), and a
// second launch; without, those are null. Of the inputs' type (float32, or
// float64 with `dbl`), contiguous.
int s1_bwd_launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                  const void* sy, const void* w, const void* cot, void* dx, void* dy, void* dw,
                  double* sums, void* dgx, void* dgy, void* dsx, void* dsy, int n_grids,
                  int n_ch, int n_rays, int ny, int nx, int span, int dbl, int bins,
                  void* stream) {
  if (n_grids < 0 || n_ch < 0 || n_rays < 0 || ny < 1 || ny > s1::MAX_NY || nx < 1 ||
      nx > s1::MAX_NX || span < s1::CHUNK || span % s1::CHUNK != 0 ||
      (bins && !(sums && dgx && dgy && dsx && dsy)))
    return (int)cudaErrorInvalidValue;
  if (!bins) sums = nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dbl ? launch<double>(x, y, gx, gy, sx, sy, w, cot, dx, dy, dw, sums, dgx, dgy,
                                    dsx, dsy, n_grids, n_ch, n_rays, ny, nx, span, s)
                   : launch<float>(x, y, gx, gy, sx, sy, w, cot, dx, dy, dw, sums, dgx, dgy,
                                   dsx, dsy, n_grids, n_ch, n_rays, ny, nx, span, s));
}

}  // extern "C"
