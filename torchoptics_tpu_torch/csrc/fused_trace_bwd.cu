// K1 backward: the hand adjoint of the fused spherical trace (K1 forward).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` in
// torchoptics_tpu/ops/pallas_trace.py (plain, Lu, full and opl modes, both
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
// locals; opl: the OPL cotangent times each leg's index into that leg's
// distance adjoint, including the final leg's, uncut by a kill), cut the
// killed lanes (allow_backward = false), and apply the surface adjoint.
// Outputs: the per-ray cotangents of xp, yp and cy, and the parameter
// cotangents dz0, dc, dt, dmu (per wavelength) and, in full mode, dref_z, in
// opl mode dn_legs (per leg and wavelength: dopl times the leg's distance),
// which are sums over all rays.
//
// The parameter sums need no float atomics and no sequential grid. Each
// thread writes its float32 term of each surface parameter into shared
// memory, a row of 256 a parameter (BlockSums, trace_common.cuh); every
// two surfaces (TERM_BYTES) the block reduces each row in double in a fixed
// order, wavelength by wavelength for dmu and dn_legs (a block of
// wavelength-outer rays may hold several), and at the end writes its column
// of a (n_params x blocks) scratch tensor; a second kernel sums each row of
// it in a fixed order, rounded to float32 once, so the sums match the plain
// version's float64 sums to float32 rounding. Two launches on the same
// inputs give bit-identical results.
//
// What bounds it on an H100: per ray it reads 12 B of inputs and 16 / 28 /
// 36 B of cotangents (plain / Lu / full) and writes 12 B of cotangents; the
// partials add 16 B per block and parameter (~8 % more). The operations are
// counted as for the forward (FP32 arithmetic only, each sqrt and division
// as one) and as the function needs them, not as this kernel spends them:
// per ray-surface the forward once (55), the surface adjoint (104, 5 of them
// divisions) and one add per ray for each of the sums dc, dt and dmu (3);
// per ray 19 for the launch, image-transfer and dz0 terms. Lu adds the relu
// term and the two theta_norm adjoints (20 per surface); full adds the
// hinge gradients (4 per gap, plus 1 per finite side of a path bound),
// their dz and dref_z terms (4) and the angle hinges (4); opl adds, per leg,
// the product and sum into the distance adjoint (2) and the dn_legs term and
// its sum (2), and reads 4 B more of cotangent per ray. That is 1,801 /
// 2,021 / 2,169 operations per ray on the flagship (the tight bounds have 18
// finite sides): at 2.46M rays, 4.43 / 4.97 / 5.33 GFLOP, 66.1 / 74.1 /
// 79.6 us at the 67 TFLOP/s FP32 peak, against 103 / 132 / 153 MB, 30.6 /
// 39.4 / 45.6 us at 3.35 TB/s: operations bound it; at P1's measured issue
// rates (each sqrt and division at its real cost) 0.26-0.42 ms.
//
// What the design does about it (measured on an H100; PERF.md, section 6):
// a row of 256 terms is reduced once per block, by one warp, and each
// thread spends one shared-memory store a term and two barriers a flush;
// a warp shuffle tree in double per sum after every surface (5 levels of
// two 32-bit shuffles and a double add) took 5-12 % more time in every
// mode (opl the most: one sum more per leg). What the kernel still spends
// beyond the count: the forward a second time (the recompute of each
// surface's locals in the reverse loop, +55 per surface) and the path
// hinges of each gap twice; and the stash (6 floats a surface, 1,536 B of
// stack frame at MAX_SURF, 264 B used at 11 surfaces) in local memory,
// ~1.3 GB of cached traffic at 2.46M rays that the bound does not count.
// Measured, not kept: the stash in shared memory (66 KB a block at 11
// surfaces, 2 blocks an SM) is 25-27 % slower; a 40 % shared-memory
// carveout (more L1 for the stash) moves plain, Lu and full by under 1 %.
// Recomputing the locals instead of stashing them (the TPU kernel stashes
// 17 floats and 4 masks per surface) keeps the stash at 6 floats and one
// bit per surface. 48-62 registers per thread, 4-5 blocks an SM.
//
// The per-ray pass (bwd_ray), the surface math and the reduction of the
// partials live in trace_common.cuh, shared with the population kernel K2
// (fused_batch_bwd.cu); this file holds K1's indexing and launcher.
//
// Build: as the forward, -fmad=false and no fast-math, so that the
// recompute reproduces the forward and the adjoint the plain version.

#include "trace_common.cuh"

namespace {

// MODE: 0 plain, 1 Lu, 2 full, 3 opl. The partials are (n_params x blocks),
// one column per block, in the parameter layout of bwd_ray.
template <int MODE, bool ALLOW_BACKWARD>
__global__ void __launch_bounds__(BLOCK) k1_bwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ t,
    const float* __restrict__ mu, const float* __restrict__ ref_z,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ n_legs, float angle_thr,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dcx_in, const float* __restrict__ dcy_in,
    const float* __restrict__ dpth_in, const float* __restrict__ dptp_in,
    const float* __restrict__ dpz_in, const float* __restrict__ dppath_in,
    const float* __restrict__ dpang_in, const float* __restrict__ dopl_in, int n,
    int n_surf, int n_w, int n_per_w, int n_params, int group, float* __restrict__ dxp_out,
    float* __restrict__ dyp_out, float* __restrict__ dcy_out,
    double* __restrict__ partials) {
  constexpr bool LU = lu_mode(MODE);
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  __shared__ Tables<MODE> tab;
  extern __shared__ double s_sums[];  // the column, then the rows of terms
  tab.load(c, t, mu, ref_z, lo, hi, n_legs, nullptr, n_surf, n_w);
  const BlockSums bs =
      block_sums(s_sums, n_params + (FULL ? n_surf : 0), group, n, n_per_w, n_w);
  __syncthreads();

  // Threads past the end trace a copy of the last ray and put zero terms,
  // so that every thread reaches every flush of the block's sums.
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = i < n;
  const int ic = active ? i : n - 1;
  const int w = min(ic / n_per_w, n_w - 1);
  auto read = [&](const float* a) { return active ? a[i] : 0.0f; };
  const RayCot cot{read(dx_in), read(dy_in), read(dcx_in), read(dcy_in),
                   LU ? read(dpth_in) : 0.0f, LU ? read(dptp_in) : 0.0f,
                   LU ? read(dpz_in) : 0.0f, FULL ? read(dppath_in) : 0.0f,
                   FULL ? read(dpang_in) : 0.0f, OPL ? read(dopl_in) : 0.0f};
  float dxp, dyp, dcyp;
  bwd_ray<MODE, ALLOW_BACKWARD, false>(tab, n_surf, n_w, angle_thr, active, w, xp[ic],
                                       yp[ic], cy_in[ic], *z0, cot, bs, dxp, dyp, dcyp);
  if (active) {
    dxp_out[i] = dxp;
    dyp_out[i] = dyp;
    dcy_out[i] = dcyp;
  }
  write_column(s_sums, n_params, FULL ? s_sums + n_params : nullptr, n_surf,
               partials + blockIdx.x, gridDim.x);
}

template <int MODE, bool ALLOW_BACKWARD>
cudaError_t launch(int grid, cudaStream_t stream, const float* const* in, float angle_thr,
                   const float* const* cot, int n, int n_surf, int n_w, int n_per_w,
                   int n_params, float* const* out, double* partials) {
  auto kernel = k1_bwd_kernel<MODE, ALLOW_BACKWARD>;
  constexpr int slots = term_slots(MODE);
  const int n_col = n_params + (MODE == 2 ? n_surf : 0);
  const size_t smem = block_sums_bytes(n_col, slots, n_surf);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BLOCK, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
      angle_thr, cot[0], cot[1], cot[2], cot[3], cot[4], cot[5], cot[6], cot[7],
      cot[8], cot[9], n, n_surf, n_w, n_per_w, n_params, term_group(slots, n_surf), out[0],
      out[1], out[2], partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int k1_bwd_block() { return BLOCK; }

// Launches K1 backward and the reduction of its partials on `stream`;
// returns the first CUDA error (0 on success). mode: 0 plain (cotangents dx,
// dy, dcx, dcy), 1 Lu (plus dpth, dptp, dpz), 2 full (plus dppath, dpang;
// reads ref_z, lo, hi, angle_thr), 3 opl (plus dopl; reads n_legs).
// `partials` holds n_params x ceil(n / k1_bwd_block()) doubles and `params`
// n_params, with n_params = 1 + 2 S + S W (+ S + 1 in full mode, + (S + 1) W
// in opl mode). Pointers a mode does not use may be null.
int k1_bwd_launch(const float* xp, const float* yp, const float* cy,
                  const float* z0, const float* c, const float* t,
                  const float* mu, const float* ref_z, const float* lo,
                  const float* hi, const float* n_legs, float angle_thr,
                  const float* dx, const float* dy, const float* dcx,
                  const float* dcy, const float* dpth, const float* dptp,
                  const float* dpz, const float* dppath, const float* dpang,
                  const float* dopl, int n, int n_surf, int n_w, int n_per_w,
                  int mode, int allow_backward, float* dxp, float* dyp,
                  float* dcy_out, double* partials, float* params, void* stream) {
  if (bad_shape(n_surf, n_w, n_per_w, n, mode)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_params = n_params_of(mode, n_surf, n_w);
  const int grid = (n + BLOCK - 1) / BLOCK;
  const float* const in[11] = {xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs};
  const float* const cot[10] = {dx, dy, dcx, dcy, dpth, dptp, dpz, dppath, dpang, dopl};
  float* const out[3] = {dxp, dyp, dcy_out};
  if (grid > 0) {
    cudaError_t err;
#define K1_BWD_LAUNCH(M, AB) \
  launch<M, AB>(grid, s, in, angle_thr, cot, n, n_surf, n_w, n_per_w, n_params, out, partials)
    if (mode == 0)
      err = allow_backward ? K1_BWD_LAUNCH(0, true) : K1_BWD_LAUNCH(0, false);
    else if (mode == 1)
      err = allow_backward ? K1_BWD_LAUNCH(1, true) : K1_BWD_LAUNCH(1, false);
    else if (mode == 2)
      err = allow_backward ? K1_BWD_LAUNCH(2, true) : K1_BWD_LAUNCH(2, false);
    else
      err = allow_backward ? K1_BWD_LAUNCH(3, true) : K1_BWD_LAUNCH(3, false);
#undef K1_BWD_LAUNCH
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials(partials, n_params, grid, params, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
