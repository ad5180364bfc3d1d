// K1 forward: fused spherical ray trace of one lens system on a flat ray block.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// torchoptics_tpu/ops/pallas_trace.py (plain and Lu modes). The plain
// PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_trace.py:trace_fused_reference; the two
// must agree bit for bit on the failure masks.
//
// Per ray: launch at the entrance pupil, then for each surface the sphere
// intersection, the miss mask (cos2 - EPS < 0), Snell's law with the TIR and
// cz^2 masks, zeroing of failed lanes, backward-ray bookkeeping (or removal
// when backward rays are not allowed), and in Lu mode the per-ray sums of
// theta_norm(cos2), theta_norm(cos2') and relu(z). Finally the transfer to
// the image plane and the last backward test.
//
// What bounds it on an H100: per ray it reads 12 B (xp, yp, cy) and writes
// 18 B (plain: x, y, cx, cy, ray_ok, ray_backward) or 30 B (Lu: plus three
// penalty sums), while it does about 11 x 70 FP32 operations, including per
// surface 3 IEEE square roots and 1 IEEE division (plus 2 acosf in Lu mode).
// At the flagship's 2.46M rays that is ~100 MB of traffic against ~2 GFLOP
// with multi-instruction sqrt/div sequences, so the kernel is bound by the
// ALU and SFU issue rate well before HBM bandwidth.
//
// Design: one thread per ray, a runtime loop over surfaces (at most
// MAX_SURF), the per-surface tables c, t and mu read once per block into
// shared memory, z0 read from device memory (the host never synchronizes),
// the mode and the backward-ray policy as template parameters, the ragged
// tail masked by i < n. Ray i has wavelength min(i / n_per_w, W - 1): the
// wavelength-outer flat order of the front-end.
//
// Left for later work: the backward (adjoint) kernel, the "full" and "opl"
// penalty modes, the population and asphere variants, and any tuning
// (several rays per thread, vectorized 16-byte loads, fast-math variants that
// keep the masks identical).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC. No --use_fast_math: the masks compare
// against EPS and approximate sqrt/division would move them. No FMA
// contraction either: the plain PyTorch version rounds every product and sum
// separately, and a contracted kernel flips masks on lanes at a threshold of
// the c x 3 double-Gauss; uncontracted, the two agree bit for bit in plain
// mode. 29-32 registers per thread, no spills, 8.7 KB of shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_SURF = 64;
constexpr int MAX_W = 32;
constexpr int BLOCK = 256;
constexpr float EPS = 1e-6f;
// The same float32 values the JAX and PyTorch versions get from their
// double constants: clip bounds 1 -/+ 1e-7 and pi / 2.
constexpr float CLIP_LO = (float)(-1.0 + 1e-7);
constexpr float CLIP_HI = (float)(1.0 - 1e-7);
constexpr float HALF_PI = (float)(0.5 * 3.14159265358979323846);

// Normalized incidence angle with failed lanes pinned to 1; the same guards
// as ops.trace._agg_entry.
__device__ __forceinline__ float theta_norm(float cos2, bool ok) {
  const bool pos = cos2 > 0.0f;
  const float safe = pos ? sqrtf(cos2) : 0.0f;
  const float u = fminf(fmaxf(safe, CLIP_LO), CLIP_HI);
  const float theta = acosf(u) / HALF_PI;
  return ok ? theta : 1.0f;
}

template <bool LU, bool ALLOW_BACKWARD>
__global__ void __launch_bounds__(BLOCK) k1_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ t,
    const float* __restrict__ mu, int n, int n_surf, int n_w, int n_per_w,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ cx_out, float* __restrict__ cy_out,
    bool* __restrict__ ok_out, bool* __restrict__ bw_out,
    float* __restrict__ pen_theta, float* __restrict__ pen_theta_p,
    float* __restrict__ pen_zrelu) {
  __shared__ float s_c[MAX_SURF];
  __shared__ float s_t[MAX_SURF];
  __shared__ float s_mu[MAX_SURF * MAX_W];
  for (int j = threadIdx.x; j < n_surf; j += blockDim.x) {
    s_c[j] = c[j];
    s_t[j] = t[j];
  }
  for (int j = threadIdx.x; j < n_surf * n_w; j += blockDim.x) s_mu[j] = mu[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = min(i / n_per_w, n_w - 1);

  float x = xp[i];
  float y = yp[i];
  float cy = cy_in[i];
  float z = *z0;
  float cx = 0.0f;
  float cz = sqrtf(1.0f - cy * cy);
  bool ok = true;
  bool bw = false;
  float pth = 0.0f, ptp = 0.0f, pz = 0.0f;

  for (int k = 0; k < n_surf; ++k) {
    const float ck = s_c[k];
    const float tk = s_t[k];
    const float muk = s_mu[k * n_w + w];

    // Sphere intersection in the vertex-local frame.
    const float e = -(x * cx + y * cy + z * cz);
    const float mz = z + e * cz;
    const float m2 = x * x + y * y + z * z - e * e;
    const float temp = ck * m2 - 2.0f * mz;
    const float cos2 = cz * cz - ck * temp;
    const bool fail1 = cos2 - EPS < 0.0f;
    const float cs = sqrtf(fail1 ? 1.0f : cos2);
    const float dist = e + temp / (cz + cs);
    const float delta_z = dist * cz;

    const bool ok1 = ok && !fail1;
    const float xB = ok1 ? x + dist * cx : 0.0f;
    const float yB = ok1 ? y + dist * cy : 0.0f;
    const float zB = ok1 ? z + delta_z : 0.0f;
    const float cxB = ok1 ? cx : 0.0f;
    const float cyB = ok1 ? cy : 0.0f;

    // Snell's law with the TIR and cz^2 masks.
    const float cos2p = 1.0f - muk * muk * (1.0f - cs * cs);
    const bool fail2a = cos2p - EPS < 0.0f;
    const float csp = sqrtf(fail2a ? 1.0f : cos2p);
    const float g = csp - muk * cs;
    const float cxC = muk * cxB - g * ck * xB;
    const float cyC = muk * cyB - g * ck * yB;
    const float cz2 = 1.0f - (cxC * cxC + cyC * cyC);
    const bool fail2 = fail2a || (cz2 - EPS < 0.0f);
    const float czC = sqrtf(fail2 ? 1.0f : cz2);

    bool ok2 = ok1 && !fail2;
    x = ok2 ? xB : 0.0f;
    y = ok2 ? yB : 0.0f;
    z = (ok2 ? zB : 0.0f) - tk;
    cx = ok2 ? cxC : 0.0f;
    cy = ok2 ? cyC : 0.0f;
    cz = ok2 ? czC : 1.0f;

    // Backward-ray bookkeeping, skipping the pupil -> first-surface leg.
    if (k > 0) {
      const bool went_bw = (delta_z < 0.0f) && ok1;
      if (ALLOW_BACKWARD) {
        bw = bw || went_bw;
      } else if (went_bw) {
        ok2 = false;
        x = 0.0f;
        y = 0.0f;
        z = -tk;
        cx = 0.0f;
        cy = 0.0f;
        cz = 1.0f;
      }
    }
    ok = ok2;
    if (LU) {
      pth = pth + theta_norm(cos2, ok);
      ptp = ptp + theta_norm(cos2p, ok);
      pz = pz + fmaxf(z, 0.0f);
    }
  }

  // Transfer to the image plane.
  const float delta_z = -z;
  const float dist = delta_z / cz;
  x = x + dist * cx;
  y = y + dist * cy;
  const bool went_bw = (delta_z < 0.0f) && ok;
  if (ALLOW_BACKWARD) {
    bw = bw || went_bw;
  } else {
    ok = ok && !went_bw;
  }

  x_out[i] = x;
  y_out[i] = y;
  cx_out[i] = cx;
  cy_out[i] = cy;
  ok_out[i] = ok;
  bw_out[i] = bw;
  if (LU) {
    pen_theta[i] = pth;
    pen_theta_p[i] = ptp;
    pen_zrelu[i] = pz;
  }
}

template <bool LU, bool ALLOW_BACKWARD>
void launch(const float* xp, const float* yp, const float* cy, const float* z0,
            const float* c, const float* t, const float* mu, int n, int n_surf,
            int n_w, int n_per_w, float* x_out, float* y_out, float* cx_out,
            float* cy_out, bool* ok_out, bool* bw_out, float* pen_theta,
            float* pen_theta_p, float* pen_zrelu, cudaStream_t stream) {
  const int grid = (n + BLOCK - 1) / BLOCK;
  k1_fwd_kernel<LU, ALLOW_BACKWARD><<<grid, BLOCK, 0, stream>>>(
      xp, yp, cy, z0, c, t, mu, n, n_surf, n_w, n_per_w, x_out, y_out, cx_out,
      cy_out, ok_out, bw_out, pen_theta, pen_theta_p, pen_zrelu);
}

}  // namespace

extern "C" {

int k1_fwd_max_surf() { return MAX_SURF; }

int k1_fwd_max_w() { return MAX_W; }

// Launches K1 forward on `stream` and returns cudaGetLastError() (0 on
// success). The penalty outputs are read only when `penalties` is nonzero.
int k1_fwd_launch(const float* xp, const float* yp, const float* cy,
                  const float* z0, const float* c, const float* t,
                  const float* mu, int n, int n_surf, int n_w, int n_per_w,
                  int penalties, int allow_backward, float* x_out,
                  float* y_out, float* cx_out, float* cy_out, bool* ok_out,
                  bool* bw_out, float* pen_theta, float* pen_theta_p,
                  float* pen_zrelu, void* stream) {
  if (n_surf < 1 || n_surf > MAX_SURF || n_w < 1 || n_w > MAX_W ||
      n_per_w < 1 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (penalties) {
    if (allow_backward)
      launch<true, true>(xp, yp, cy, z0, c, t, mu, n, n_surf, n_w, n_per_w,
                         x_out, y_out, cx_out, cy_out, ok_out, bw_out,
                         pen_theta, pen_theta_p, pen_zrelu, s);
    else
      launch<true, false>(xp, yp, cy, z0, c, t, mu, n, n_surf, n_w, n_per_w,
                          x_out, y_out, cx_out, cy_out, ok_out, bw_out,
                          pen_theta, pen_theta_p, pen_zrelu, s);
  } else {
    if (allow_backward)
      launch<false, true>(xp, yp, cy, z0, c, t, mu, n, n_surf, n_w, n_per_w,
                          x_out, y_out, cx_out, cy_out, ok_out, bw_out,
                          nullptr, nullptr, nullptr, s);
    else
      launch<false, false>(xp, yp, cy, z0, c, t, mu, n, n_surf, n_w, n_per_w,
                           x_out, y_out, cx_out, cy_out, ok_out, bw_out,
                           nullptr, nullptr, nullptr, s);
  }
  return (int)cudaGetLastError();
}

const char* k1_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
