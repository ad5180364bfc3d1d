// K1 backward: the hand adjoint of the fused spherical trace (K1 forward).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` in
// torchoptics_tpu/ops/pallas_trace.py (plain, Lu and full modes, both
// backward-ray policies). The plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_trace.py:trace_fused_backward_reference;
// the per-ray cotangents of the two agree bit for bit.
//
// Per ray, one thread: recompute the forward surface by surface with the
// forward's own arithmetic, stashing the 6 pre-surface state values (x, y,
// z, cx, cy, cz) and one ok bit per surface; apply the image-transfer
// adjoint; then walk the surfaces in reverse, recompute each surface's
// locals from its stashed state (bit-identical, since nothing is
// contracted), inject the penalty cotangents (Lu: relu(z) into dz, the
// theta_norm adjoint into the raw cos2 locals; full: the path-hinge
// cotangent into dz and ref_z, the angle-hinge cotangent into the cos2
// locals), cut the killed lanes (allow_backward = false), and apply the
// surface adjoint. Outputs: the per-ray cotangents of xp, yp and cy, and
// the parameter cotangents dz0, dc, dt, dmu (per wavelength) and, in full
// mode, dref_z, which are sums over all rays.
//
// The parameter sums need no float atomics and no sequential grid: each
// warp reduces a surface's per-ray terms with shuffles and writes them to its
// own row of shared memory (a warp of wavelength-outer rays straddles at most
// a few wavelengths, so dmu goes wavelength by wavelength); each block adds
// its warps' rows in a fixed order and writes one column of a (n_params x
// blocks) scratch tensor; a second kernel sums each row of it in a fixed
// order. Two launches on the same inputs give bit-identical results.
//
// What bounds it on an H100: per ray it reads 12 B of inputs and 16 / 28 /
// 36 B of cotangents (plain / Lu / full) and writes 12 B of cotangents; the
// partials add 8 B per block and parameter (~4 % more). The operations are
// counted as for the forward (FP32 arithmetic only, each sqrt and division
// as one) and as the function needs them, not as this kernel spends them:
// per ray-surface the forward once (55), the surface adjoint (104, 5 of them
// divisions) and one add per ray for each of the sums dc, dt and dmu (3);
// per ray 19 for the launch, image-transfer and dz0 terms. Lu adds the relu
// term and the two theta_norm adjoints (20 per surface); full adds the
// hinge gradients (4 per gap, plus 1 per finite side of a path bound),
// their dz and dref_z terms (4) and the angle hinges (4). That is 1,801 /
// 2,021 / 2,169 operations per ray on the flagship (the tight bounds have 18
// finite sides): at 2.46M rays, 4.43 / 4.97 / 5.33 GFLOP, 66.1 / 74.1 /
// 79.6 us at the 67 TFLOP/s FP32 peak, against 103 / 132 / 153 MB, 30.6 /
// 39.4 / 45.6 us at 3.35 TB/s: operations bound it. What the kernel spends
// beyond that count: the forward a second time (the recompute of each
// surface's locals in the reverse loop, +55 per surface), five shuffle-adds
// per warp sum where one add per ray is needed, and the path hinges of each
// gap twice. The stash (6 floats a surface, 1,536 B of stack frame at
// MAX_SURF, 264 B used at 11 surfaces) lives in local memory, device memory
// behind L1 and L2; it is written once and read once per surface, ~1.3 GB of
// cached traffic at 2.46M rays that the bound does not count. Recomputing
// the locals instead of stashing them (the TPU kernel stashes 17 floats and
// 4 masks per surface) keeps the stash at 6 floats and one bit per surface.
// 48-64 registers per thread, no spills.
//
// Build: as the forward, -fmad=false and no fast-math, so that the
// recompute reproduces the forward and the adjoint the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_SURF = 64;
constexpr int MAX_W = 32;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int REDUCE_BLOCK = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float EPS = 1e-6f;
// The same float32 values the JAX and PyTorch versions get from their
// double constants: 1 - 1e-7 and pi / 2.
constexpr float CLIP_HI = (float)(1.0 - 1e-7);
constexpr float HALF_PI = (float)(0.5 * 3.14159265358979323846);

// The locals of one surface step that its adjoint reads.
struct Locals {
  float e, m2, temp, cos2, cs, denom, dist, delta_z;
  float xB, yB, cxB, cyB, cos2p, csp, g, cxC, cyC, czC;
  bool fail1, ok1, fail2a, fail2;
};

// One spherical surface step, the same operations in the same order as
// fused_trace_fwd.cu; advances the state in place.
__device__ __forceinline__ void surface_fwd(float ck, float tk, float muk,
                                            float& x, float& y, float& z,
                                            float& cx, float& cy, float& cz,
                                            bool& ok, Locals& L) {
  L.e = -(x * cx + y * cy + z * cz);
  const float mz = z + L.e * cz;
  L.m2 = x * x + y * y + z * z - L.e * L.e;
  L.temp = ck * L.m2 - 2.0f * mz;
  L.cos2 = cz * cz - ck * L.temp;
  L.fail1 = L.cos2 - EPS < 0.0f;
  L.cs = sqrtf(L.fail1 ? 1.0f : L.cos2);
  L.denom = cz + L.cs;
  L.dist = L.e + L.temp / L.denom;
  L.delta_z = L.dist * cz;

  L.ok1 = ok && !L.fail1;
  L.xB = L.ok1 ? x + L.dist * cx : 0.0f;
  L.yB = L.ok1 ? y + L.dist * cy : 0.0f;
  const float zB = L.ok1 ? z + L.delta_z : 0.0f;
  L.cxB = L.ok1 ? cx : 0.0f;
  L.cyB = L.ok1 ? cy : 0.0f;

  L.cos2p = 1.0f - muk * muk * (1.0f - L.cs * L.cs);
  L.fail2a = L.cos2p - EPS < 0.0f;
  L.csp = sqrtf(L.fail2a ? 1.0f : L.cos2p);
  L.g = L.csp - muk * L.cs;
  L.cxC = muk * L.cxB - L.g * ck * L.xB;
  L.cyC = muk * L.cyB - L.g * ck * L.yB;
  const float cz2 = 1.0f - (L.cxC * L.cxC + L.cyC * L.cyC);
  L.fail2 = L.fail2a || (cz2 - EPS < 0.0f);
  L.czC = sqrtf(L.fail2 ? 1.0f : cz2);

  const bool ok2 = L.ok1 && !L.fail2;
  x = ok2 ? L.xB : 0.0f;
  y = ok2 ? L.yB : 0.0f;
  z = (ok2 ? zB : 0.0f) - tk;
  cx = ok2 ? L.cxC : 0.0f;
  cy = ok2 ? L.cyC : 0.0f;
  cz = ok2 ? L.czC : 1.0f;
  ok = ok2;
}

// d(theta_norm)/d(cos2) * dpen, zero on pinned and clipped lanes.
__device__ __forceinline__ float theta_norm_adjoint(float cos2, bool ok_end,
                                                    float dpen) {
  const bool pos = cos2 > 0.0f;
  const float u = sqrtf(pos ? cos2 : 1.0f);
  const bool active = ok_end && pos && (u < CLIP_HI);
  const float denom = sqrtf(active ? 1.0f - u * u : 1.0f);
  const float d = -dpen / (HALF_PI * denom * 2.0f * u);
  return active ? d : 0.0f;
}

// d(hinge)/d(delta): -1 below lo, +1 above hi, 0 inside.
__device__ __forceinline__ float hinge_grad(float d, float lo, float hi) {
  float g = 0.0f;
  if (lo != -INFINITY) g = g - (d < lo ? 1.0f : 0.0f);
  if (hi != INFINITY) g = g + (d > hi ? 1.0f : 0.0f);
  return g;
}

// Sum over the warp; lane 0 holds the result. The order is fixed.
__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(FULL_MASK, v, offset);
  return v;
}

// MODE: 0 plain, 1 Lu, 2 full. Parameter layout of the partials and of the
// result: [dz0 | dc (S) | dt (S) | dmu (S x W, row-major) | dref_z (S+1,
// full mode only)].
template <int MODE, bool ALLOW_BACKWARD>
__global__ void __launch_bounds__(BLOCK) k1_bwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ t,
    const float* __restrict__ mu, const float* __restrict__ ref_z,
    const float* __restrict__ lo, const float* __restrict__ hi, float angle_thr,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dcx_in, const float* __restrict__ dcy_in,
    const float* __restrict__ dpth_in, const float* __restrict__ dptp_in,
    const float* __restrict__ dpz_in, const float* __restrict__ dppath_in,
    const float* __restrict__ dpang_in, int n, int n_surf, int n_w,
    int n_per_w, int n_params, float* __restrict__ dxp_out,
    float* __restrict__ dyp_out, float* __restrict__ dcy_out,
    float* __restrict__ partials) {
  constexpr bool LU = MODE >= 1;
  constexpr bool FULL = MODE == 2;
  __shared__ float s_c[MAX_SURF];
  __shared__ float s_t[MAX_SURF];
  __shared__ float s_mu[MAX_SURF * MAX_W];
  __shared__ float s_ref[FULL ? MAX_SURF + 1 : 1];
  __shared__ float s_lo[FULL ? MAX_SURF : 1];
  __shared__ float s_hi[FULL ? MAX_SURF : 1];
  extern __shared__ float s_part[];  // [WARPS][n_params]
  for (int j = threadIdx.x; j < n_surf; j += BLOCK) {
    s_c[j] = c[j];
    s_t[j] = t[j];
    if (FULL) {
      s_lo[j] = lo[j];
      s_hi[j] = hi[j];
    }
  }
  if (FULL)
    for (int j = threadIdx.x; j <= n_surf; j += BLOCK) s_ref[j] = ref_z[j];
  for (int j = threadIdx.x; j < n_surf * n_w; j += BLOCK) s_mu[j] = mu[j];
  for (int j = threadIdx.x; j < WARPS * n_params; j += BLOCK) s_part[j] = 0.0f;
  __syncthreads();

  // Threads past the end trace a copy of the last ray and contribute zero,
  // so that every lane takes part in the shuffles.
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = i < n;
  const int ic = active ? i : n - 1;
  const int w = min(ic / n_per_w, n_w - 1);
  const int lane = threadIdx.x & 31;
  float* part = s_part + (threadIdx.x >> 5) * n_params;
  const int w_first = __shfl_sync(FULL_MASK, w, 0);
  const int w_last = __shfl_sync(FULL_MASK, w, 31);
  const int off_c = 1, off_t = 1 + n_surf, off_mu = 1 + 2 * n_surf;
  const int off_ref = off_mu + n_surf * n_w;
  const float* mu_w = s_mu + w;

  // ---- forward recompute, stashing the pre-surface states ----
  float st[MAX_SURF][6];
  uint64_t ok_bits = 0;
  const float cy0 = cy_in[ic];
  float x = xp[ic], y = yp[ic], z = *z0, cx = 0.0f, cy = cy0;
  const float cz0 = sqrtf(1.0f - cy0 * cy0);
  float cz = cz0;
  bool ok = true;
  for (int k = 0; k < n_surf; ++k) {
    st[k][0] = x;
    st[k][1] = y;
    st[k][2] = z;
    st[k][3] = cx;
    st[k][4] = cy;
    st[k][5] = cz;
    if (ok) ok_bits |= 1ull << k;
    Locals L;
    surface_fwd(s_c[k], s_t[k], mu_w[k * n_w], x, y, z, cx, cy, cz, ok, L);
    if (!ALLOW_BACKWARD && k > 0 && L.delta_z < 0.0f && L.ok1) {
      ok = false;
      x = 0.0f;
      y = 0.0f;
      z = -s_t[k];
      cx = 0.0f;
      cy = 0.0f;
      cz = 1.0f;
    }
  }
  const float z_end = z;

  // ---- image-transfer adjoint ----
  const float dx_img = active ? dx_in[i] : 0.0f;
  const float dy_img = active ? dy_in[i] : 0.0f;
  float dpth = 0.0f, dptp = 0.0f, dpz = 0.0f, dppath = 0.0f, dpang = 0.0f;
  if (LU) {
    dpth = active ? dpth_in[i] : 0.0f;
    dptp = active ? dptp_in[i] : 0.0f;
    dpz = active ? dpz_in[i] : 0.0f;
  }
  if (FULL) {
    dppath = active ? dppath_in[i] : 0.0f;
    dpang = active ? dpang_in[i] : 0.0f;
  }
  const float dist_f = -z / cz;
  float dcx = (active ? dcx_in[i] : 0.0f) + dx_img * dist_f;
  float dcy = (active ? dcy_in[i] : 0.0f) + dy_img * dist_f;
  const float ddist_f = dx_img * cx + dy_img * cy;
  float dz = -ddist_f / cz;
  float dcz = ddist_f * (z / (cz * cz));
  float dx = dx_img;
  float dy = dy_img;

  // z after surface m (the stash holds pre-surface states).
  auto zpost = [&](int m) { return m + 1 < n_surf ? st[m + 1][2] : z_end; };
  // dppath * d(hinge_j)/d(delta_j) for path gap j.
  auto hinge_cot = [&](int j) {
    const float delta =
        j == n_surf - 1
            ? s_ref[n_surf] - (zpost(n_surf - 1) + s_ref[n_surf - 1])
            : (zpost(j + 1) + s_ref[j + 1]) - (zpost(j) + s_ref[j]);
    return dppath * hinge_grad(delta, s_lo[j], s_hi[j]);
  };

  // ---- reverse surface loop ----
  for (int k = n_surf - 1; k >= 0; --k) {
    const float ck = s_c[k];
    const float muk = mu_w[k * n_w];
    const float px = st[k][0], py = st[k][1], pz = st[k][2];
    const float pcx = st[k][3], pcy = st[k][4], pcz = st[k][5];
    Locals L;
    {
      float x1 = px, y1 = py, z1 = pz, cx1 = pcx, cy1 = pcy, cz1 = pcz;
      bool ok1 = (ok_bits >> k) & 1ull;
      surface_fwd(ck, s_t[k], muk, x1, y1, z1, cx1, cy1, cz1, ok1, L);
    }
    const bool kill = !ALLOW_BACKWARD && k > 0 && L.delta_z < 0.0f && L.ok1;
    const bool ok2 = L.ok1 && !L.fail2;

    float dcos2_extra = 0.0f, dcos2p_extra = 0.0f, hp = 0.0f;
    if (LU) {
      const bool ok_end = ok2 && !kill;
      // pen_z += relu(z after surface k): into the incoming z adjoint.
      dz = dz + dpz * (zpost(k) > 0.0f ? 1.0f : 0.0f);
      dcos2_extra = theta_norm_adjoint(L.cos2, ok_end, dpth);
      dcos2p_extra = theta_norm_adjoint(L.cos2p, ok_end, dptp);
    }
    if (FULL) {
      // z after surface k enters gap k-1 (+) and gap k (-).
      hp = hinge_cot(k);
      dz = dz - hp;
      if (k > 0) dz = dz + hinge_cot(k - 1);
      dcos2_extra = dcos2_extra - dpang * (L.cos2 < angle_thr ? 1.0f : 0.0f);
      dcos2p_extra = dcos2p_extra - dpang * (L.cos2p < angle_thr ? 1.0f : 0.0f);
    }
    float dt_kill = 0.0f;
    if (kill) {
      // Killed lanes got z = -t (dz flows to dt) and a zeroed state.
      dt_kill = -dz;
      dx = 0.0f;
      dy = 0.0f;
      dz = 0.0f;
      dcx = 0.0f;
      dcy = 0.0f;
      dcz = 0.0f;
    }

    // ---- surface adjoint (pallas_trace._bwd_surface) ----
    const float dt_ray = -dz;
    const float dczC = ok2 ? dcz : 0.0f;
    const float dcz2 = L.fail2 ? 0.0f : dczC / (2.0f * L.czC);
    const float dcxC = (ok2 ? dcx : 0.0f) - 2.0f * L.cxC * dcz2;
    const float dcyC = (ok2 ? dcy : 0.0f) - 2.0f * L.cyC * dcz2;
    const float dxB = (ok2 ? dx : 0.0f) - dcxC * L.g * ck;
    const float dyB = (ok2 ? dy : 0.0f) - dcyC * L.g * ck;
    const float dzB = ok2 ? dz : 0.0f;
    const float dcxB = muk * dcxC;
    const float dcyB = muk * dcyC;
    const float dg = -(dcxC * ck * L.xB + dcyC * ck * L.yB);
    float dc_ray = -(dcxC * L.g * L.xB + dcyC * L.g * L.yB);
    float dmu_ray = dcxC * L.cxB + dcyC * L.cyB;
    const float dcosp = dg;
    dmu_ray = dmu_ray - dg * L.cs;
    float dcos = -dg * muk;
    float dcos2p = L.fail2a ? 0.0f : dcosp / (2.0f * L.csp);
    if (LU) dcos2p = dcos2p + dcos2p_extra;
    dmu_ray = dmu_ray + dcos2p * (-2.0f * muk * (1.0f - L.cs * L.cs));
    dcos = dcos + dcos2p * (2.0f * muk * muk * L.cs);

    const float dxA = L.ok1 ? dxB : 0.0f;
    const float dyA = L.ok1 ? dyB : 0.0f;
    const float dzA = L.ok1 ? dzB : 0.0f;
    dcx = L.ok1 ? dcxB : 0.0f;
    dcy = L.ok1 ? dcyB : 0.0f;
    const float ddist = dxA * pcx + dyA * pcy + dzA * pcz;
    dx = dxA;
    dy = dyA;
    dz = dzA;
    dcx = dcx + dxA * L.dist;
    dcy = dcy + dyA * L.dist;
    dcz = dzA * L.dist;
    float de = ddist;
    float dtemp = ddist / L.denom;
    const float ddenom = -ddist * L.temp / (L.denom * L.denom);
    dcz = dcz + ddenom;
    dcos = dcos + ddenom;
    float dcos2 = L.fail1 ? 0.0f : dcos / (2.0f * L.cs);
    if (LU) dcos2 = dcos2 + dcos2_extra;
    dcz = dcz + 2.0f * pcz * dcos2;
    dc_ray = dc_ray - dcos2 * L.temp;
    dtemp = dtemp - ck * dcos2;
    dc_ray = dc_ray + dtemp * L.m2;
    const float dm2 = ck * dtemp;
    const float dmz = -2.0f * dtemp;
    dx = dx + 2.0f * px * dm2;
    dy = dy + 2.0f * py * dm2;
    dz = dz + 2.0f * pz * dm2;
    de = de - 2.0f * L.e * dm2;
    dz = dz + dmz;
    de = de + dmz * pcz;
    dcz = dcz + dmz * L.e;
    dx = dx - de * pcx;
    dy = dy - de * pcy;
    dz = dz - de * pcz;
    dcx = dcx - de * px;
    dcy = dcy - de * py;
    dcz = dcz - de * pz;

    // ---- this surface's parameter terms, reduced over the warp ----
    const float r_c = warp_sum(active ? dc_ray : 0.0f);
    const float r_t = warp_sum(active ? dt_ray + dt_kill : 0.0f);
    if (lane == 0) {
      part[off_c + k] = r_c;
      part[off_t + k] = r_t;
    }
    for (int wv = w_first; wv <= w_last; ++wv) {
      const float r_mu = warp_sum(active && w == wv ? dmu_ray : 0.0f);
      if (lane == 0) part[off_mu + k * n_w + wv] = r_mu;
    }
    if (FULL) {
      const float r_ref = warp_sum(active ? hp : 0.0f);
      if (lane == 0) {
        part[off_ref + k + 1] += r_ref;
        part[off_ref + k] -= r_ref;
      }
    }
  }

  // ---- launch adjoint: cz0 = sqrt(1 - cy^2), cx0 = 0 (a constant) ----
  dcy = dcy + dcz * (-cy0 / cz0);
  const float r_z0 = warp_sum(active ? dz : 0.0f);
  if (lane == 0) part[0] = r_z0;
  if (active) {
    dxp_out[i] = dx;
    dyp_out[i] = dy;
    dcy_out[i] = dcy;
  }

  // ---- this block's column of the partials: its warps, in order ----
  __syncthreads();
  for (int p = threadIdx.x; p < n_params; p += BLOCK) {
    float sum = 0.0f;
    for (int wp = 0; wp < WARPS; ++wp) sum += s_part[wp * n_params + p];
    partials[(size_t)p * gridDim.x + blockIdx.x] = sum;
  }
}

// Row p of the (n_params x n_blocks) partials, summed in a fixed order.
__global__ void __launch_bounds__(REDUCE_BLOCK) k1_bwd_reduce(
    const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  __shared__ float s_sum[REDUCE_BLOCK];
  const float* row = partials + (size_t)blockIdx.x * n_blocks;
  float sum = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += REDUCE_BLOCK) sum += row[b];
  s_sum[threadIdx.x] = sum;
  __syncthreads();
  for (int stride = REDUCE_BLOCK / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s_sum[threadIdx.x] += s_sum[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s_sum[0];
}

template <int MODE, bool ALLOW_BACKWARD>
cudaError_t launch(int grid, size_t smem, cudaStream_t stream,
                   const float* const* in, float angle_thr,
                   const float* const* cot, int n, int n_surf, int n_w,
                   int n_per_w, int n_params, float* const* out) {
  auto kernel = k1_bwd_kernel<MODE, ALLOW_BACKWARD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, BLOCK, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      angle_thr, cot[0], cot[1], cot[2], cot[3], cot[4], cot[5], cot[6],
      cot[7], cot[8], n, n_surf, n_w, n_per_w, n_params, out[0], out[1],
      out[2], out[3]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int k1_bwd_block() { return BLOCK; }

// Launches K1 backward and the reduction of its partials on `stream`;
// returns the first CUDA error (0 on success). mode: 0 plain (cotangents dx,
// dy, dcx, dcy), 1 Lu (plus dpth, dptp, dpz), 2 full (plus dppath, dpang;
// reads ref_z, lo, hi, angle_thr). `partials` holds n_params x
// ceil(n / k1_bwd_block()) floats and `params` n_params, with n_params =
// 1 + 2 S + S W (+ S + 1 in full mode). Pointers a mode does not use may be
// null.
int k1_bwd_launch(const float* xp, const float* yp, const float* cy,
                  const float* z0, const float* c, const float* t,
                  const float* mu, const float* ref_z, const float* lo,
                  const float* hi, float angle_thr, const float* dx,
                  const float* dy, const float* dcx, const float* dcy,
                  const float* dpth, const float* dptp, const float* dpz,
                  const float* dppath, const float* dpang, int n, int n_surf,
                  int n_w, int n_per_w, int mode, int allow_backward,
                  float* dxp, float* dyp, float* dcy_out, float* partials,
                  float* params, void* stream) {
  if (n_surf < 1 || n_surf > MAX_SURF || n_w < 1 || n_w > MAX_W ||
      n_per_w < 1 || n < 0 || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int n_params =
      1 + 2 * n_surf + n_surf * n_w + (mode == 2 ? n_surf + 1 : 0);
  const int grid = (n + BLOCK - 1) / BLOCK;
  const size_t smem = (size_t)WARPS * n_params * sizeof(float);
  const float* const in[10] = {xp, yp, cy, z0, c, t, mu, ref_z, lo, hi};
  const float* const cot[9] = {dx, dy, dcx, dcy, dpth, dptp, dpz, dppath, dpang};
  float* const out[4] = {dxp, dyp, dcy_out, partials};
  if (grid > 0) {
    cudaError_t err;
#define K1_BWD_LAUNCH(M, AB)                                                 \
  launch<M, AB>(grid, smem, s, in, angle_thr, cot, n, n_surf, n_w, n_per_w, \
                n_params, out)
    if (mode == 0)
      err = allow_backward ? K1_BWD_LAUNCH(0, true) : K1_BWD_LAUNCH(0, false);
    else if (mode == 1)
      err = allow_backward ? K1_BWD_LAUNCH(1, true) : K1_BWD_LAUNCH(1, false);
    else
      err = allow_backward ? K1_BWD_LAUNCH(2, true) : K1_BWD_LAUNCH(2, false);
#undef K1_BWD_LAUNCH
    if (err != cudaSuccess) return (int)err;
  }
  k1_bwd_reduce<<<n_params, REDUCE_BLOCK, 0, s>>>(partials, grid, params);
  return (int)cudaGetLastError();
}

}  // extern "C"
