// K1 forward: fused spherical ray trace of one lens system on a flat ray block.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// torchoptics_tpu/ops/pallas_trace.py (plain, Lu and full modes). The plain
// PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_trace.py:trace_fused_reference; the two
// must agree bit for bit on the failure masks.
//
// Per ray: launch at the entrance pupil, then for each surface the sphere
// intersection, the miss mask (cos2 - EPS < 0), Snell's law with the TIR and
// cz^2 masks, zeroing of failed lanes, backward-ray bookkeeping (or removal
// when backward rays are not allowed), and in Lu mode the per-ray sums of
// theta_norm(cos2), theta_norm(cos2') and relu(z). Full mode adds two
// per-ray sums: the angle hinge max(thr - cos2, 0) + max(thr - cos2', 0) on
// the raw cos2 of every surface, and the ray-path hinge of each gap's
// absolute z step, (z_k + ref_z[k]) - (z_{k-1} + ref_z[k-1]) on the post-kill
// z, against the gap's (lo, hi) bounds (+-inf switches a side off); the last
// gap runs to ref_z[S]. Finally the transfer to the image plane and the last
// backward test.
//
// What bounds it on an H100: per ray it reads 12 B (xp, yp, cy) and writes
// 18 B (plain: x, y, cx, cy, ray_ok, ray_backward), 30 B (Lu: plus three
// penalty sums) or 38 B (full: plus two more). Counting FP32 arithmetic only
// (adds, multiplies, min/max, each sqrt, division and acosf as one; compares
// and selects not counted), plain mode does 55 operations per ray-surface
// (3 of them square roots, 1 a division) and 8 per ray for the launch and
// the image transfer; Lu adds two theta_norm (sqrt, clip, acosf, division)
// and the three sums, 14 per surface; full adds the angle hinges (6 per
// surface), the path deltas and sum (4 per gap) and 3 per finite side of a
// path bound (18 sides on the flagship with the tight bounds). At the
// flagship's 2.46M rays x 11 surfaces that is 1.51 / 1.89 / 2.29 GFLOP,
// 22.5 / 28.1 / 34.1 us at the H100's 67 TFLOP/s FP32 peak, against
// 74 / 103 / 123 MB of traffic, 22.0 / 30.8 / 36.7 us at 3.35 TB/s:
// operations bound plain mode and bytes bound Lu and full mode, narrowly
// each time. The measured times (6-8x the bound) say the real limit is the
// issue rate of the multi-instruction IEEE sqrt, division and acosf
// sequences, which that count takes as one operation each.
//
// Design: one thread per ray, a runtime loop over surfaces (at most
// MAX_SURF), the per-surface tables c, t and mu read once per block into
// shared memory, z0 read from device memory (the host never synchronizes),
// the mode and the backward-ray policy as template parameters, the ragged
// tail masked by i < n. Ray i has wavelength min(i / n_per_w, W - 1): the
// wavelength-outer flat order of the front-end.
//
// Left for later work: the "opl" penalty mode, the population and asphere
// variants, and any tuning
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

// Path-bound hinge max(lo - d, 0) + max(d - hi, 0), a side switched off by
// an infinite bound; the same sums as the plain version.
__device__ __forceinline__ float hinge(float d, float lo, float hi) {
  float pen = 0.0f;
  if (lo != -INFINITY) pen = pen + fmaxf(lo - d, 0.0f);
  if (hi != INFINITY) pen = pen + fmaxf(d - hi, 0.0f);
  return pen;
}

// MODE: 0 plain, 1 Lu, 2 full.
template <int MODE, bool ALLOW_BACKWARD>
__global__ void __launch_bounds__(BLOCK) k1_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ t,
    const float* __restrict__ mu, const float* __restrict__ ref_z,
    const float* __restrict__ lo, const float* __restrict__ hi, float angle_thr,
    int n, int n_surf, int n_w, int n_per_w,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ cx_out, float* __restrict__ cy_out,
    bool* __restrict__ ok_out, bool* __restrict__ bw_out,
    float* __restrict__ pen_theta, float* __restrict__ pen_theta_p,
    float* __restrict__ pen_zrelu, float* __restrict__ pen_path_out,
    float* __restrict__ pen_ang_out) {
  constexpr bool LU = MODE >= 1;
  constexpr bool FULL = MODE == 2;
  __shared__ float s_c[MAX_SURF];
  __shared__ float s_t[MAX_SURF];
  __shared__ float s_mu[MAX_SURF * MAX_W];
  __shared__ float s_ref[FULL ? MAX_SURF + 1 : 1];
  __shared__ float s_lo[FULL ? MAX_SURF : 1];
  __shared__ float s_hi[FULL ? MAX_SURF : 1];
  for (int j = threadIdx.x; j < n_surf; j += blockDim.x) {
    s_c[j] = c[j];
    s_t[j] = t[j];
    if (FULL) {
      s_lo[j] = lo[j];
      s_hi[j] = hi[j];
    }
  }
  if (FULL)
    for (int j = threadIdx.x; j <= n_surf; j += blockDim.x) s_ref[j] = ref_z[j];
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
  float pth = 0.0f, ptp = 0.0f, pz = 0.0f, ppath = 0.0f, pang = 0.0f;
  float z_prev = 0.0f;

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
    if (FULL) {
      pang = pang + fmaxf(angle_thr - cos2, 0.0f) + fmaxf(angle_thr - cos2p, 0.0f);
      if (k > 0) {
        const float delta = (z + s_ref[k]) - (z_prev + s_ref[k - 1]);
        ppath = ppath + hinge(delta, s_lo[k - 1], s_hi[k - 1]);
      }
      z_prev = z;
    }
  }
  if (FULL) {
    // The image-plane entry: ref_z[S] repeats the last vertex.
    const float delta = s_ref[n_surf] - (z_prev + s_ref[n_surf - 1]);
    ppath = ppath + hinge(delta, s_lo[n_surf - 1], s_hi[n_surf - 1]);
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
  if (FULL) {
    pen_path_out[i] = ppath;
    pen_ang_out[i] = pang;
  }
}

template <int MODE, bool ALLOW_BACKWARD>
void launch(const float* xp, const float* yp, const float* cy, const float* z0,
            const float* c, const float* t, const float* mu, const float* ref_z,
            const float* lo, const float* hi, float angle_thr, int n, int n_surf,
            int n_w, int n_per_w, float* const* outs, bool* ok_out,
            bool* bw_out, float* const* pens, cudaStream_t stream) {
  const int grid = (n + BLOCK - 1) / BLOCK;
  k1_fwd_kernel<MODE, ALLOW_BACKWARD><<<grid, BLOCK, 0, stream>>>(
      xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, angle_thr, n, n_surf, n_w,
      n_per_w, outs[0], outs[1], outs[2], outs[3], ok_out, bw_out, pens[0],
      pens[1], pens[2], pens[3], pens[4]);
}

}  // namespace

extern "C" {

int k1_max_surf() { return MAX_SURF; }

int k1_max_w() { return MAX_W; }

// Launches K1 forward on `stream` and returns cudaGetLastError() (0 on
// success). mode: 0 plain, 1 Lu (pen_theta, pen_theta_p, pen_zrelu), 2 full
// (those plus pen_path, pen_ang; reads ref_z (S+1), lo, hi (S) and
// angle_thr). Pointers a mode does not use may be null.
int k1_fwd_launch(const float* xp, const float* yp, const float* cy,
                  const float* z0, const float* c, const float* t,
                  const float* mu, const float* ref_z, const float* lo,
                  const float* hi, float angle_thr, int n, int n_surf, int n_w,
                  int n_per_w, int mode, int allow_backward, float* x_out,
                  float* y_out, float* cx_out, float* cy_out, bool* ok_out,
                  bool* bw_out, float* pen_theta, float* pen_theta_p,
                  float* pen_zrelu, float* pen_path, float* pen_ang,
                  void* stream) {
  if (n_surf < 1 || n_surf > MAX_SURF || n_w < 1 || n_w > MAX_W ||
      n_per_w < 1 || n < 0 || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* const outs[4] = {x_out, y_out, cx_out, cy_out};
  float* const pens[5] = {pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang};
#define K1_FWD_LAUNCH(M, AB)                                                  \
  launch<M, AB>(xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, angle_thr, n, n_surf, \
                n_w, n_per_w, outs, ok_out, bw_out, pens, s)
  if (mode == 0) {
    if (allow_backward) K1_FWD_LAUNCH(0, true); else K1_FWD_LAUNCH(0, false);
  } else if (mode == 1) {
    if (allow_backward) K1_FWD_LAUNCH(1, true); else K1_FWD_LAUNCH(1, false);
  } else {
    if (allow_backward) K1_FWD_LAUNCH(2, true); else K1_FWD_LAUNCH(2, false);
  }
#undef K1_FWD_LAUNCH
  return (int)cudaGetLastError();
}

const char* k1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
