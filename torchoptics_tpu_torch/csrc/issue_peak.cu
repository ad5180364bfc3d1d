// P1: the issue-rate probe of the card's FP32 pipes.
//
// Replaces the Pallas TPU kernel `_chain_kernel` of benchmarks/vpu_peak.py,
// which measured the TPU's vector issue ceiling. The plain PyTorch version of
// the same function is torchoptics_tpu_torch/benchmarks/issue_peak.py:
// chains_reference.
//
// What it computes, per thread: NACC = 8 independent accumulators started at
// x * scale[k] (scale[k] = float32(1 + 1e-7 k)), each iterated `iters` times
// by one of three steps, then summed in order:
//
//   op 0, fma:  a = fmaf(a, k1, k2)      one FFMA
//   op 1, sqrt: a = sqrtf(a) + k2        IEEE square root, then an add
//   op 2, div:  a = k1 / a + k2          IEEE division, then an add
//
// The library is built with -fmad=false, so `a * k1 + k2` would issue as a
// multiply and an add and measure half the FMA rate: the fma step calls
// fmaf() explicitly. sqrtf and `/` are the correctly rounded sequences the
// trace kernels use (no --use_fast_math), so the sqrt and div chains measure
// what one sqrt or division costs there. Eight independent chains per thread
// hide the pipes' latency; the iteration loop is unrolled 16 times so its
// counter costs ~2 % of the fma chain's instructions.
//
// What bounds it: nothing but the issue rate it measures. It reads 4 B and
// writes 4 B per thread; each step is one FP32 operation (the fma chain: an
// FMA, two FLOPs). The grid fills the card: the launcher is given the
// thread count, a multiple of the SM count times 8 blocks of 256 threads,
// not the TPU probe's (32, 128) tile, which would leave most SMs idle.

#include <cuda_runtime.h>

namespace {

constexpr int NACC = 8;
constexpr int BLOCK = 256;

template <int OP>
__device__ __forceinline__ float step(float a, float k1, float k2) {
  if (OP == 0) return fmaf(a, k1, k2);
  if (OP == 1) return sqrtf(a) + k2;
  return k1 / a + k2;
}

template <int OP>
__global__ void __launch_bounds__(BLOCK) p1_chain_kernel(
    const float* __restrict__ x, const float* __restrict__ scale, float k1, float k2,
    int iters, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float a[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) a[k] = xi * scale[k];
#pragma unroll 16
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) a[k] = step<OP>(a[k], k1, k2);
  }
  float o = a[0];
#pragma unroll
  for (int k = 1; k < NACC; ++k) o = o + a[k];
  out[i] = o;
}

}  // namespace

extern "C" {

// Launches P1 on `stream` and returns cudaGetLastError() (0 on success).
// x and out hold n floats, scale NACC floats; op 0 fma, 1 sqrt, 2 div.
int p1_chain_launch(const float* x, const float* scale, float k1, float k2, int iters,
                    int n, int op, float* out, void* stream) {
  if (n < 0 || iters < 0 || op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0)
    p1_chain_kernel<0><<<grid, BLOCK, 0, s>>>(x, scale, k1, k2, iters, n, out);
  else if (op == 1)
    p1_chain_kernel<1><<<grid, BLOCK, 0, s>>>(x, scale, k1, k2, iters, n, out);
  else
    p1_chain_kernel<2><<<grid, BLOCK, 0, s>>>(x, scale, k1, k2, iters, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
