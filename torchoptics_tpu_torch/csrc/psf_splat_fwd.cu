// Kernel S1, forward: the soft-histogram splat of the geometric PSF
// (torchoptics_tpu_torch/ops/psf.py: compute_psf, through splat).
//
// No Pallas kernel is replaced: the JAX package writes the splat as a 5-D
// broadcast (torchoptics_tpu/ops/psf.py:75-86) that XLA fuses into its sum
// over rays, so the (grids, channels, n_y, n_x/2, rays) Gaussian never
// exists in memory. Run eagerly, the same lines hold it: 8.86e9 values,
// 35.4 GB, at the default SimulatorConfig (21 fields x 3 channels, a 65 x 33
// half grid, 65,536 rays). This kernel is that fusion. For each (grid g,
// channel c) pair
//
//   half[g, c, iy, ix] = sum_r ex[r, ix] * eyw[r, iy],
//   ex[r, ix]  = exp(-(((x[r] - gx[ix])^2) / sigma_x^2) / 2),
//   eyw[r, iy] = exp(-(((y[r] - gy[iy])^2) / sigma_y^2) / 2) * w[r],
//
// each factor in the inputs' type (float32 or float64) in the JAX formula's
// order (s1::gauss), w = 1 without weights. The plain PyTorch version is
// ops/psf.py:splat_reference; the two agree bit for bit.
//
// Sum order, fixed and free of atomics: each pair's rays are cut into spans
// of `span` rays (ops/psf.py:splat_span, a multiple of CHUNK chosen so that
// pairs x spans is about 1,024 blocks: the default configuration has only
// 63 pairs for 132 SMs). A block sums one span's rays in order, from 0.0, in
// double (a product of two float32 factors is exact there, so a fused
// multiply-add rounds as the plain version's product and sum do); a bin's
// span sums go to a workspace of doubles (18 MB at the default shape), and
// the second kernel adds them in span order from 0.0 and rounds once.
//
// What bounds it on an H100, at the default configuration: 8.86e9 products
// and as many sums, and 4.05e8 factors of 6 operations (one exp and one
// division among them), 2.01e10 operations, 0.30 ms at 67 TFLOP/s; the
// bytes (x, y and the weights read once, the half kernels written once)
// take 0.01 ms. Operations bound it. This design's products are double
// FMAs outside the tensor cores (34 TFLOP/s: 0.52 ms).
//
// Design, as a matrix product half = EYW^T EX over the rays: a block covers
// the whole half grid in 4 x 4 register tiles of bins, one a thread. A step
// stages CHUNK rays' factors into shared memory as doubles, each computed
// once per ray and bin (n_y + n_x/2 a ray, not n_y * n_x/2), then every
// thread runs the CHUNK ray positions, 8 doubles loaded for 16 FMAs a
// position. A simple kernel: tensor cores, TMA and a ring of stages are left
// to a later design.

#include <cuda_runtime.h>

#include "psf_splat.cuh"

namespace {

using s1::CHUNK;
using s1::TILE;

// Threads of the largest grid's tiles, rounded to whole warps.
constexpr int MAX_THREADS =
    ((s1::MAX_NY + TILE - 1) / TILE * ((s1::MAX_NX + TILE - 1) / TILE) + 31) / 32 * 32;

// Block b = pair * n_spans + span: its span's sums of every bin, into
// partials[b][iy][ix]. Shared memory: a step's eyw[CHUNK][nyp] and
// ex[CHUNK][nxp], zero past the span's last ray and in the padding bins.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) s1_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, double* __restrict__ partials, int n_ch, int n_rays, int ny,
    int nx, int span, int n_spans) {
  extern __shared__ double smem[];
  const int nyp = s1::pad4(ny), nxp = s1::pad4(nx);
  double* s_ey = smem;
  double* s_ex = smem + CHUNK * nyp;
  const int pair = blockIdx.x / n_spans;
  const int g = pair / n_ch;
  const int r0 = (blockIdx.x - pair * n_spans) * span;
  const int r_end = min(r0 + span, n_rays);
  const T s2x = sx[g] * sx[g];
  const T s2y = sy[g] * sy[g];
  const T* xp = x + (size_t)pair * n_rays;
  const T* yp = y + (size_t)pair * n_rays;
  const T* wp = w ? w + (size_t)pair * n_rays : nullptr;
  const T* gxp = gx + (size_t)g * nx;
  const T* gyp = gy + (size_t)g * ny;
  // This thread's tile: rows ty * TILE .., columns tx * TILE ...
  const int tx_n = nxp / TILE;
  const bool computes = threadIdx.x < tx_n * (nyp / TILE);
  const int ty = threadIdx.x / tx_n;
  const int tx = threadIdx.x - ty * tx_n;
  double acc[TILE][TILE];
  s1::zero(acc);
  const int per = nyp + nxp;
  for (int c0 = r0; c0 < r_end; c0 += CHUNK) {
    __syncthreads();  // the last step's factors are read
    for (int k = threadIdx.x; k < CHUNK * per; k += blockDim.x) {
      const int j = k / per;
      const int b = k - j * per;
      const int r = c0 + j;
      double v = 0.0;
      if (b < nyp) {
        if (r < r_end && b < ny) {
          T e = s1::gauss(yp[r], gyp[b], s2y);
          if (wp) e = e * wp[r];
          v = (double)e;
        }
        s_ey[j * nyp + b] = v;
      } else {
        const int ix = b - nyp;
        if (r < r_end && ix < nx) v = (double)s1::gauss(xp[r], gxp[ix], s2x);
        s_ex[j * nxp + ix] = v;
      }
    }
    __syncthreads();
    if (computes) s1::tile_madd<T>(s_ey + ty * TILE, nyp, s_ex + tx * TILE, nxp, CHUNK, acc);
  }
  if (computes) {
    double* dst = partials + (size_t)blockIdx.x * ny * nx;
#pragma unroll
    for (int i = 0; i < TILE; ++i)
#pragma unroll
      for (int l = 0; l < TILE; ++l) {
        const int iy = ty * TILE + i, ix = tx * TILE + l;
        if (iy < ny && ix < nx) dst[iy * nx + ix] = acc[i][l];
      }
  }
}

// Each bin's span sums added in span order from 0.0, rounded once, into the
// half kernels (pairs, ny, nx); zeros where a pair has no rays.
template <typename T>
__global__ void s1_fwd_reduce(const double* __restrict__ partials, T* __restrict__ out,
                              int n_spans, int bins, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long pair = idx / bins;
  const double* src = partials + pair * n_spans * bins + (idx - pair * bins);
  double s = 0.0;
  for (int sp = 0; sp < n_spans; ++sp) s = s + src[(size_t)sp * bins];
  out[idx] = (T)s;
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                   const void* sy, const void* w, double* partials, void* out, int n_grids,
                   int n_ch, int n_rays, int ny, int nx, int span, cudaStream_t stream) {
  const long long n_pairs = (long long)n_grids * n_ch;
  const int n_spans = (n_rays + span - 1) / span;
  const int nyp = s1::pad4(ny), nxp = s1::pad4(nx);
  const int tiles = (nyp / TILE) * (nxp / TILE);
  const int threads = tiles < 128 ? 128 : (tiles + 31) / 32 * 32;
  const size_t smem = sizeof(double) * CHUNK * (nyp + nxp);
  const long long blocks = n_pairs * n_spans;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if (blocks > 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(s1_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    s1_fwd_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
        (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
        (const T*)w, partials, n_ch, n_rays, ny, nx, span, n_spans);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long total = n_pairs * ny * nx;
  if (total > 0) {
    s1_fwd_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partials, (T*)out, n_spans, ny * nx, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The largest half grid S1 takes, and the rays a forward block stages a step.
int s1_max_ny() { return s1::MAX_NY; }
int s1_max_nx() { return s1::MAX_NX; }
int s1_chunk() { return CHUNK; }

// Launches S1's forward on `stream` (the main kernel and its second pass)
// and returns cudaGetLastError() (0 on success). x, y and w (or null)
// (n_grids, n_ch, n_rays); gx (n_grids, nx), gy (n_grids, ny); sx, sy
// (n_grids,): float32, or float64 with `dbl`; partials n_grids * n_ch *
// ceil(n_rays / span) * ny * nx doubles of scratch; out (n_grids, n_ch, ny,
// nx) of the inputs' type; all contiguous. span: ops/psf.py:splat_span.
int s1_fwd_launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                  const void* sy, const void* w, double* partials, void* out, int n_grids,
                  int n_ch, int n_rays, int ny, int nx, int span, int dbl, void* stream) {
  if (n_grids < 0 || n_ch < 0 || n_rays < 0 || ny < 1 || ny > s1::MAX_NY || nx < 1 ||
      nx > s1::MAX_NX || span < CHUNK || span % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dbl ? launch<double>(x, y, gx, gy, sx, sy, w, partials, out, n_grids, n_ch,
                                    n_rays, ny, nx, span, s)
                   : launch<float>(x, y, gx, gy, sx, sy, w, partials, out, n_grids, n_ch,
                                   n_rays, ny, nx, span, s));
}

}  // extern "C"
