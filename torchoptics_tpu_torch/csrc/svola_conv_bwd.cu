// P2's adjoint with respect to the PSFs (d/dpsf), for training through the
// rendered image.
//
// No TPU kernel is replaced: the JAX package computes the patch convolution
// by FFT (torchoptics_tpu/ops/image.py:svola_convolution) and XLA
// differentiates it. The forward kernel P2 (svola_conv.cu) computes
//
//   out[p, i, j, c] = sum_{a < kh, b < kw} psf[p, kh-1-a, kw-1-b, c]
//                                          * patch[p, i+a, j+b, c],
//
// so with the cotangent g of out,
//
//   dpsf[p, u, v, c] = sum_{i < hp, j < wp} g[p, i, j, c]
//                                           * patch[p, i+kh-1-u, j+kw-1-v, c]:
//
// kh * kw sums per patch-channel, each over the hp * wp outputs. (d/dpatch
// is P2 itself, on the cotangent zero-padded by (kh-1, kw-1) with the
// flipped PSF.) The plain PyTorch version is
// torchoptics_tpu_torch/ops/image.py:svola_patch_conv_dpsf_reference; the
// two agree bit for bit.
//
// Sum order, fixed and free of atomics, as the trace kernels sum their
// parameters: the outputs are cut into 32 x 32 tiles (the tail tiles padded
// with zero cotangents). Each tile's partial sum of a tap runs over the
// tile's positions in row-major order, from 0.0, in double; each product
// of two float32 values is exact in double, so a fused multiply-add rounds
// as the plain version's product and sum do. The partials go to a
// (patch-channels, tiles, kh*kw) buffer of doubles; the second kernel sums
// each tap's partials over the tiles in index order, from 0.0, and rounds
// once to float32. The patch-channels go in groups, one pair of launches a
// group, so that the buffer stays within PARTIALS_MAX (or one patch-channel's
// partials, where that is more): the default configuration's 4096^2 render
// would need 8.5 GB for all 243 at once. Each output's sums are the same
// whatever the grouping.
//
// What bounds it on an H100: kh*kw multiply-adds per output element, in
// double: at config 5's 1024^2 render (75 patch-channels, 306^2 outputs,
// K = 11) 8.5e8 multiply-adds, 1.7e9 operations, 25 us at 67 TFLOP/s (the
// card's rate for the inputs' float32, and its FP64 tensor-core rate); the
// bytes (the patches and the cotangent read once, the PSF gradient written
// once) take 17 us at 3.35 TB/s. Operations bound it. This design's double
// FMAs run outside the tensor cores, at 34 TFLOP/s: 50 us is its ceiling.
//
// Design (a simple kernel): one block per (tile, patch-channel). The block
// copies the tile's cotangent (32 x 32) and the patch window that the taps
// read ((32 + kh - 1) x (32 + kw - 1), three zero columns on the left) to
// shared memory as doubles, converted once. Each thread takes the taps (u,
// v0 .. v0 + 3) of one tap row: along a row of positions the four taps read
// a sliding window of the patch row, so a step loads one new patch value
// and one broadcast cotangent for four multiply-adds. Consecutive threads
// take consecutive tap rows, so their window rows lie an odd pitch of
// doubles apart (no bank conflicts in a half-warp).
//
// Wide PSFs: from P2_DPSF_FFT_MIN_KW = 23 taps on the larger side d/dpsf
// takes the FFT route's correlation (svola_fft.cu; ops/image.py routes the
// calls), which was faster there on an H100. So this kernel takes kh and kw
// up to MAX_K = 22 (p2_dpsf_max_kw()): kh x ceil(kw / 4) <= 132 threads, one
// block a tile.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;         // outputs a tile side
constexpr int QUAD = 4;          // taps a thread along v
constexpr int PADL = QUAD - 1;   // zero columns left of the window
constexpr int MAX_THREADS = 256;
constexpr int MAX_K = 22;        // kh and kw at most (wider PSFs take svola_fft.cu)
constexpr long long PARTIALS_MAX = 1LL << 23;  // doubles of partials a group, 64 MB

// Doubles a window row: 32 + kw - 1 columns and the left padding, odd.
__host__ __device__ constexpr int window_pitch(int kw) { return (TILE + kw - 1 + PADL) | 1; }

size_t smem_bytes(int rows, int kw) {
  return sizeof(double) * ((size_t)TILE * TILE + (size_t)(TILE + rows - 1) * window_pitch(kw));
}

__global__ void __launch_bounds__(MAX_THREADS) p2_dpsf_kernel(
    const float* __restrict__ patches, const float* __restrict__ cot,
    double* __restrict__ partials, int n_ch, int ph, int pw, int kh, int kw, int n_tx,
    int pc0) {
  extern __shared__ double smem[];
  const int pc = pc0 + blockIdx.z;
  const int p = pc / n_ch;
  const int c = pc - p * n_ch;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int i0 = (tile / n_tx) * TILE;
  const int j0 = (tile % n_tx) * TILE;
  const int hp = ph - kh + 1;
  const int wp = pw - kw + 1;
  const int pitch = window_pitch(kw);
  const int n_rows = TILE + kh - 1;
  double* gt = smem;
  double* win = smem + TILE * TILE;

  // The tile's cotangent, zero past the outputs.
  for (int k = threadIdx.x; k < TILE * TILE; k += blockDim.x) {
    const int i = i0 + k / TILE, j = j0 + k % TILE;
    gt[k] = i < hp && j < wp ? (double)cot[(((size_t)p * hp + i) * wp + j) * n_ch + c] : 0.0;
  }
  // Window row r is patch row i0 + r; window column q is patch column
  // j0 + q - PADL. Zero outside the patch (read only against zero
  // cotangents) and in the padding.
  for (int k = threadIdx.x; k < n_rows * pitch; k += blockDim.x) {
    const int r = k / pitch, q = k - r * pitch;
    const int y = i0 + r, x = j0 + q - PADL;
    win[k] = q >= PADL && y < ph && x < pw
                 ? (double)patches[(((size_t)p * ph + y) * pw + x) * n_ch + c]
                 : 0.0;
  }
  __syncthreads();

  const int n_quads = (kw + QUAD - 1) / QUAD;
  for (int item = threadIdx.x; item < kh * n_quads; item += blockDim.x) {
    const int u = item % kh;
    const int v0 = (item / kh) * QUAD;
    // Tap u at position (ti, tj) reads window row ti + kh - 1 - u; tap
    // v0 + k reads window column tj + base - k.
    const int base = kw - 1 - v0 + PADL;
    double s[QUAD] = {0.0, 0.0, 0.0, 0.0};
    for (int ti = 0; ti < TILE; ++ti) {
      const double* row = win + (ti + kh - 1 - u) * pitch + base;
      const double* grow = gt + ti * TILE;
      double w1 = row[-1], w2 = row[-2], w3 = row[-3];
      for (int tj = 0; tj < TILE; ++tj) {
        const double w0 = row[tj];
        const double gv = grow[tj];
        s[0] = fma(gv, w0, s[0]);
        s[1] = fma(gv, w1, s[1]);
        s[2] = fma(gv, w2, s[2]);
        s[3] = fma(gv, w3, s[3]);
        w3 = w2;
        w2 = w1;
        w1 = w0;
      }
    }
    double* dst = partials + ((size_t)blockIdx.z * n_tiles + tile) * kh * kw + (size_t)u * kw;
#pragma unroll
    for (int k = 0; k < QUAD; ++k)
      if (v0 + k < kw) dst[v0 + k] = s[k];
  }
}

// Each tap's partials summed over the tiles in index order, rounded once,
// written in the PSFs' (P, kh, kw, C) layout: the group of `total` / kk
// patch-channels from pc0.
__global__ void p2_dpsf_reduce(const double* __restrict__ partials, float* __restrict__ dpsf,
                               int n_ch, int n_tiles, int kk, long long total, int pc0) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long k = idx / kk;
  const int uv = (int)(idx - k * kk);
  const double* src = partials + k * n_tiles * kk + uv;
  double s = 0.0;
  for (int t = 0; t < n_tiles; ++t) s = s + src[(size_t)t * kk];
  const long long pc = pc0 + k;
  const long long p = pc / n_ch;
  const int c = (int)(pc - p * n_ch);
  dpsf[(p * kk + uv) * n_ch + c] = (float)s;
}

// The patch-channels a group: as many as keep their partials within
// PARTIALS_MAX, at least one.
int group_pcs(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  const long long per_pc = (long long)((ph - kh + 1 + TILE - 1) / TILE) *
                           ((pw - kw + 1 + TILE - 1) / TILE) * kh * kw;
  const long long n_pc = (long long)n_patch * n_ch;
  long long g = PARTIALS_MAX / per_pc;
  if (g < 1) g = 1;
  return (int)(g < n_pc ? g : n_pc < 1 ? 1 : n_pc);
}

}  // namespace

extern "C" {

// The widest PSF, in either axis, this kernel takes.
int p2_dpsf_max_kw() { return MAX_K; }

// The partials buffer's doubles: one group's patch-channels x tiles x kh x kw.
long long p2_dpsf_partials(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  const long long n_tiles = (long long)((ph - kh + 1 + TILE - 1) / TILE) *
                            ((pw - kw + 1 + TILE - 1) / TILE);
  return (long long)group_pcs(n_patch, n_ch, ph, pw, kh, kw) * n_tiles * kh * kw;
}

// The launches of the main kernel one d/dpsf call makes: its groups of
// patch-channels (each followed by one launch of the second pass).
int p2_dpsf_launches(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  const int g = group_pcs(n_patch, n_ch, ph, pw, kh, kw);
  return (n_patch * n_ch + g - 1) / g;
}

// Launches d/dpsf on `stream` (both kernels, p2_dpsf_launches(...) times
// each) and returns cudaGetLastError() (0 on success). patches (n_patch,
// ph, pw, n_ch) and the cotangent (n_patch, ph - kh + 1, pw - kw + 1, n_ch)
// float32; partials p2_dpsf_partials(...) doubles of scratch; dpsf
// (n_patch, kh, kw, n_ch) float32; all contiguous.
int p2_dpsf_launch(const float* patches, const float* cot, double* partials, float* dpsf,
                   int n_patch, int n_ch, int ph, int pw, int kh, int kw, void* stream) {
  if (n_patch < 0 || n_ch < 1 || kh < 1 || kw < 1 || kh > MAX_K || kw > MAX_K || ph < kh ||
      pw < kw || (long long)n_patch * n_ch > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tx = (pw - kw + 1 + TILE - 1) / TILE;
  const int n_ty = (ph - kh + 1 + TILE - 1) / TILE;
  const int threads = (kh * ((kw + QUAD - 1) / QUAD) + 31) / 32 * 32;
  const size_t smem = smem_bytes(kh, kw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        p2_dpsf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_pc = n_patch * n_ch;
  const int group = group_pcs(n_patch, n_ch, ph, pw, kh, kw);
  for (int pc0 = 0; pc0 < n_pc; pc0 += group) {
    const int n = n_pc - pc0 < group ? n_pc - pc0 : group;
    const dim3 grid(n_tx * n_ty, 1, n);
    p2_dpsf_kernel<<<grid, threads, smem, s>>>(patches, cot, partials, n_ch, ph, pw, kh, kw,
                                               n_tx, pc0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)n * kh * kw;
    p2_dpsf_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(partials, dpsf, n_ch,
                                                                    n_tx * n_ty, kh * kw, total,
                                                                    pc0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
