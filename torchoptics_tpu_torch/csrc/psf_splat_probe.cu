// Kernel S1's probe of the FP64 tensor cores' rounding, the card's FP64
// rates (ops/psf.py: dmma_probe, fp64_rate), and the probe of the adjoint's
// window threshold (ops/psf.py: exp_zero_probe).
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

#include <cstring>

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


// The window threshold's probe: counts the q above s1::q_max<T>() whose
// factor s1::factor_of_q(q) is not 0 into out[0], and keeps the least such
// q's bits in out[1]. Sample i < n is the q of bits first + i * stride, or
// with `edges` (float64) the binades' end points: the last 8 doubles of
// [2^10, 2^11), then the first 8 and the last 8 of each binade from 2^11 to
// the last finite double; sample n is +inf (inf_bits).
template <typename T, typename U>
__global__ void s1_exp_zero_kernel(U first, U stride, unsigned long long n, U inf_bits, int edges,
                                   unsigned long long* __restrict__ out) {
  unsigned long long bad = 0, least = ~0ull;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i <= n; i += step) {
    U bits = (U)(first + (U)i * stride);
    if (edges) {
      const unsigned long long e = (i + 8) / 16 + 1033, k = (i + 8) % 16;
      bits = (U)(k < 8 ? (e << 52) + k : ((e + 1) << 52) - 1 - (k - 8));
    }
    if (i == n) bits = inf_bits;
    T q;
    memcpy(&q, &bits, sizeof(T));
    if (s1::factor_of_q(q) != T(0)) {
      ++bad;
      least = (unsigned long long)bits < least ? (unsigned long long)bits : least;
    }
  }
  if (bad) {
    atomicAdd(out, bad);
    atomicMin(out + 1, least);
  }
}

// The float64 probe's kinds (s1_exp_zero_probe): every double in (q_max,
// q_max + 1], 2^26 spread evenly from q_max up to +inf, and the binades'
// end points from [2^10, 2^11)'s last 8 to the last finite double.
enum ExpZeroKind { BAND = 0, SPREAD = 1, EDGES = 2 };

void exp_zero_samples(int dbl, int kind, unsigned long long& first, unsigned long long& stride,
                      unsigned long long& n) {
  if (!dbl) {
    const float qm = s1::q_max<float>();
    unsigned int bits;
    memcpy(&bits, &qm, 4);
    first = bits + 1ull;
    stride = 1;
    n = 0x7f800000ull - first;
    return;
  }
  const double qm = s1::q_max<double>(), top = qm + 1.0;
  unsigned long long bits, top_bits;
  memcpy(&bits, &qm, 8);
  memcpy(&top_bits, &top, 8);
  first = bits + 1;
  stride = 1;
  if (kind == BAND) {
    n = top_bits - bits;
  } else if (kind == SPREAD) {
    n = 1ull << 26;
    stride = (0x7ff0000000000000ull - first) / n;
  } else {
    // The last 8 of [2^10, 2^11), then 16 end points of each binade 2^11 ..
    // 2^1023 (biased exponents 1034 .. 2046).
    n = 8 + (2046 - 1034 + 1) * 16;
  }
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

// The window threshold's probe (s1_exp_zero_kernel): float32 (dbl 0) every
// float above q_max and +inf; float64 (dbl 1) by `kind` (ExpZeroKind):
// every double in (q_max, q_max + 1] (2^42 of them), 2^26 spread evenly up
// to +inf, or the binades' end points, and +inf. out: 2 unsigned 64-bit
// values on the card, {0, ~0} before the call. Returns cudaGetLastError();
// s1_exp_zero_samples gives the q's checked.
unsigned long long s1_exp_zero_samples(int dbl, int kind) {
  unsigned long long first, stride, n;
  exp_zero_samples(dbl, kind, first, stride, n);
  return n + 1;
}

int s1_exp_zero_probe(int dbl, int kind, unsigned long long* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long first, stride, n;
  exp_zero_samples(dbl, kind, first, stride, n);
  if (dbl)
    s1_exp_zero_kernel<double, unsigned long long><<<132 * 16, 256, 0, s>>>(
        first, stride, n, 0x7ff0000000000000ull, kind == EDGES, out);
  else
    s1_exp_zero_kernel<float, unsigned int><<<132 * 16, 256, 0, s>>>(
        (unsigned int)first, 1u, n, 0x7f800000u, 0, out);
  return (int)cudaGetLastError();
}

// S1's window threshold q_max (psf_splat.cuh), float32 or float64.
double s1_q_max(int dbl) { return dbl ? s1::q_max<double>() : (double)s1::q_max<float>(); }

}  // extern "C"
