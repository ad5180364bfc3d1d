// P2: the patch convolution of SVOLA (spatially-varying overlap-add).
//
// Replaces the Pallas TPU kernel `_k_acc` of
// benchmarks/probe_svola_direct.py (the direct K^2-tap form of the patch
// convolution that torchoptics_tpu/ops/image.py:svola_convolution computes
// by FFT). The plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/image.py:svola_patch_conv_reference; the two
// agree bit for bit.
//
// What it computes, for every patch p of the batch (B x N patches) and every
// channel c, on the JAX layout (P, ph, pw, C) with channels innermost:
//
//   out[p, i, j, c] = sum_{a < kh, b < kw} psf[p, kh-1-a, kw-1-b, c]
//                                          * patch[p, i+a, j+b, c]
//
// for i < ph - kh + 1, j < pw - kw + 1: the valid part of the convolution of
// the patch with its local PSF, which is what svola_convolution's FFT path
// keeps (its circular index never wraps into that region). Note the flipped
// taps: `_k_acc` sums psf[a, b] * patch[i+a, j+b], a correlation, which
// differs from SVOLA for any PSF that is not point-symmetric (off-axis PSFs
// are not). The sum runs a outer, b inner, from 0, each product rounded
// before its sum (-fmad=false), in the plain version's order.
//
// What bounds it on an H100: kh*kw multiply-adds per output element. At the
// imaging path's 1024^2 render (5 x 5 patches of 306^2 px, 3 channels,
// K = 11) that is 8.50e8 multiply-adds, 1.70e9 FP32 operations, 25.4 us at
// 67 TFLOP/s, against 58.1 MB of traffic (the 316^2 input patches read once,
// the 306^2 outputs written once), 17.3 us at 3.35 TB/s: operations bound
// it. Without FMA contraction each multiply-add issues as two instructions,
// so the issue rate of the FP32 pipes (not the 67 TFLOP/s figure, which
// counts an FMA as two operations) is the real ceiling: about 2x that bound.
//
// Design: one block of 32 x 8 threads per (patch, channel, 32 x 32 output
// tile); the (32 + kh - 1) x (32 + kw - 1) input tile and the kh x kw
// flipped taps are staged in shared memory; each thread accumulates four
// output pixels of one column (rows ty, ty + 8, ty + 16, ty + 24), so each
// tap read from shared memory serves four multiply-adds. The kernel reads
// the (P, ph, pw, C) layout with a stride of C and writes the output in the
// same layout: no permute on either side. kh and kw are at most MAX_K = 31
// (K is 23 at a 2048^2 render); the launcher refuses larger kernels.
//
// Left for later work: a sliding window of input values in registers (each
// value is read kw times from shared memory), several channels per block,
// and the adjoint (d/dpatch is the same convolution transposed, d/dpsf a
// kh x kw reduction per patch) for training through the image.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS_PER_THREAD = 4;
constexpr int THREADS_Y = TILE / ROWS_PER_THREAD;
constexpr int MAX_K = 31;
constexpr int SPAN = TILE + MAX_K - 1;

__global__ void __launch_bounds__(TILE * THREADS_Y) p2_svola_kernel(
    const float* __restrict__ patches, const float* __restrict__ psfs,
    float* __restrict__ out, int n_ch, int ph, int pw, int kh, int kw) {
  __shared__ float tile[SPAN][SPAN];
  __shared__ float taps[MAX_K][MAX_K];

  const int hp = ph - kh + 1;
  const int wp = pw - kw + 1;
  const int pc = blockIdx.z;
  const int p = pc / n_ch;
  const int c = pc - p * n_ch;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int n_threads = TILE * THREADS_Y;

  const float* src = patches + (size_t)p * ph * pw * n_ch + c;
  const int span_y = TILE + kh - 1;
  const int span_x = TILE + kw - 1;
  for (int k = tid; k < span_y * span_x; k += n_threads) {
    const int y = k / span_x;
    const int x = k - y * span_x;
    const int gy = y0 + y;
    const int gx = x0 + x;
    tile[y][x] = (gy < ph && gx < pw) ? src[((size_t)gy * pw + gx) * n_ch] : 0.0f;
  }
  const float* kern = psfs + (size_t)p * kh * kw * n_ch + c;
  for (int k = tid; k < kh * kw; k += n_threads) {
    const int a = k / kw;
    const int b = k - a * kw;
    taps[a][b] = kern[((size_t)(kh - 1 - a) * kw + (kw - 1 - b)) * n_ch];
  }
  __syncthreads();

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0.0f;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int a = 0; a < kh; ++a) {
    for (int b = 0; b < kw; ++b) {
      const float w = taps[a][b];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
        acc[r] = acc[r] + w * tile[ty + r * THREADS_Y + a][tx + b];
    }
  }

  const int ox = x0 + tx;
  if (ox >= wp) return;
  float* dst = out + (size_t)p * hp * wp * n_ch + c;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int oy = y0 + ty + r * THREADS_Y;
    if (oy < hp) dst[((size_t)oy * wp + ox) * n_ch] = acc[r];
  }
}

}  // namespace

extern "C" {

int p2_max_k() { return MAX_K; }

// Launches P2 on `stream` and returns cudaGetLastError() (0 on success).
// patches (n_patch, ph, pw, n_ch), psfs (n_patch, kh, kw, n_ch) and out
// (n_patch, ph - kh + 1, pw - kw + 1, n_ch), float32, contiguous.
int p2_svola_launch(const float* patches, const float* psfs, float* out, int n_patch,
                    int n_ch, int ph, int pw, int kh, int kw, void* stream) {
  if (n_patch < 0 || n_ch < 1 || kh < 1 || kw < 1 || kh > MAX_K || kw > MAX_K ||
      ph < kh || pw < kw || (long long)n_patch * n_ch > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  const int hp = ph - kh + 1;
  const int wp = pw - kw + 1;
  const dim3 grid((wp + TILE - 1) / TILE, (hp + TILE - 1) / TILE, n_patch * n_ch);
  const dim3 block(TILE, THREADS_Y);
  p2_svola_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(patches, psfs, out, n_ch, ph,
                                                            pw, kh, kw);
  return (int)cudaGetLastError();
}

}  // extern "C"
