// Kernel S1's probe of the FP64 tensor cores' rounding, and the card's FP64
// rates (ops/psf.py: dmma_probe, fp64_rate).
//
// S1 (psf_splat_fwd.cu, psf_splat_bwd.cu) is bit-identical to its plain
// PyTorch version, which sums in float64 in a fixed order. Its float32
// route takes the products of its sums on the FP64 tensor cores
// (mma.sync.aligned.m16n8k4.row.col.f64: D = C + A B over k = 0..3), which
// is right only if the instruction rounds as the chain of fused
// multiply-adds in k order does: d = fma(a3, b3, fma(a2, b2, fma(a1, b1,
// fma(a0, b0, c)))). For float32 factors every product is exact in double,
// so that chain is also the plain version's product-then-sum. This probe
// runs one mma.sync per case (a warp a case: A 16 x 4, B 4 x 8, C 16 x 8;
// m8n8k4 on its first 8 rows, or m16n8k4) and, beside it on the same lanes,
// that chain of fma(); ops/psf.py compares the two bit for bit on cases
// built to tell orders and roundings apart (ties, cancellation, the order
// of the terms, random exact products, float32 subnormals), and S1's checks
// fail if a card rounds otherwise. Found on an H100: both shapes round as
// the chain, on every case.
//
// No Pallas kernel is replaced. What bounds it: nothing (a few thousand
// instructions). The rate kernel below measures the FP64 pipe's and the
// FP64 tensor cores' rates (an H100: DFMA and m8n8k4 33 TFLOP/s, m16n8k4
// 66, which is why S1 runs m16n8k4).

#include <cuda_runtime.h>

#include "psf_splat.cuh"

namespace {

// Case c (one warp): A row-major (16, 4), B row-major (4, 8), C and the two
// results row-major (16, 8). m16 = 0: one mma.m8n8k4 on rows 0-7 (rows 8-15
// of d_mma are left as they are); m16 = 1: one mma.m16n8k4 on all 16 rows.
// d_fma: the chain of fma() in k order on every row.
__global__ void s1_dmma_probe_kernel(const double* __restrict__ A, const double* __restrict__ B,
                                     const double* __restrict__ C, double* __restrict__ d_mma,
                                     double* __restrict__ d_fma, int n, int m16) {
  const int c = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  if (c >= n) return;  // whole warps leave together: blockDim.x is a multiple of 32
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const double* a = A + (size_t)c * 64;
  const double* b = B + (size_t)c * 32;
  const double* cc = C + (size_t)c * 128;
  double* dm = d_mma + (size_t)c * 128;
  double* df = d_fma + (size_t)c * 128;
  const int c0 = 2 * tig;
  if (m16) {
    double d[4] = {cc[gid * 8 + c0], cc[gid * 8 + c0 + 1], cc[(gid + 8) * 8 + c0],
                   cc[(gid + 8) * 8 + c0 + 1]};
    s1::dmma16(d, a[gid * 4 + tig], a[(gid + 8) * 4 + tig], b[tig * 8 + gid]);
    for (int v = 0; v < 4; ++v) dm[(gid + 8 * (v >> 1)) * 8 + c0 + (v & 1)] = d[v];
  } else {
    double d0 = cc[gid * 8 + c0], d1 = cc[gid * 8 + c0 + 1];
    s1::dmma(d0, d1, a[gid * 4 + tig], b[tig * 8 + gid]);
    dm[gid * 8 + c0] = d0;
    dm[gid * 8 + c0 + 1] = d1;
  }
  for (int v = 0; v < 4; ++v) {
    const int r = gid + 8 * (v >> 1), col = c0 + (v & 1);
    double f = cc[r * 8 + col];
#pragma unroll
    for (int k = 0; k < 4; ++k) f = fma(a[r * 4 + k], b[k * 8 + col], f);
    df[r * 8 + col] = f;
  }
}

// Eight independent chains a thread, `iters` steps each: kind 0 DFMAs (two
// a step), 1 mma.m8n8k4 (256 multiply-adds a warp), 2 mma.m16n8k4 (512).
__global__ void s1_fp64_rate_kernel(int iters, int kind, double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const double a = 1.0 + lane * 1e-3, b = 1e-9;
  double acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = t;
  if (kind == 2) {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) s1::dmma16(acc[t], a, b, b);
  } else if (kind == 1) {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) s1::dmma(acc[t][0], acc[t][1], a, b);
  } else {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t][0] = fma(a, b, acc[t][0]);
        acc[t][1] = fma(b, a, acc[t][1]);
      }
  }
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < 8; ++t) s += (acc[t][0] + acc[t][1]) + (acc[t][2] + acc[t][3]);
  out[blockIdx.x * (size_t)blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// n cases: A (n, 16, 4), B (n, 4, 8), C (n, 16, 8) doubles in; d_mma and
// d_fma (n, 16, 8) out; m16 picks the shape (s1_dmma_probe_kernel). Returns
// cudaGetLastError().
int s1_dmma_probe(const double* A, const double* B, const double* C, double* d_mma,
                  double* d_fma, int n, int m16, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (n * 32 + threads - 1) / threads;
  s1_dmma_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(A, B, C, d_mma, d_fma, n,
                                                                      m16);
  return (int)cudaGetLastError();
}

// `blocks` blocks of 256 threads, each running the rate kernel of `kind`
// for `iters` steps; out holds blocks * 256 doubles.
int s1_fp64_rate(int iters, int blocks, int kind, double* out, void* stream) {
  if (iters < 1 || blocks < 1 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  s1_fp64_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters, kind, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
