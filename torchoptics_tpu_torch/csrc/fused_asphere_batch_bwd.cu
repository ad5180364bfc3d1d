// K4 backward: the hand adjoint of the population conic/asphere trace (K4
// forward).
//
// Replaces the Pallas TPU kernel `_bwd_kernel_ab` in
// torchoptics_tpu/ops/pallas_asphere.py (plain, Lu, full and opl modes, both
// backward-ray policies). The plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_asphere.py:
// trace_fused_asphere_batch_backward_reference; the per-ray cotangents of
// the two agree bit for bit.
//
// K3 backward (fused_asphere_bwd.cu) over a grid of (ray blocks x systems),
// as K4 forward lays it out: each block reads its system's tables into
// shared memory and runs bwd_ray_a of asphere_common.cuh on its rays (the
// forward with K3's stash: the 6 pre-surface floats, the pre-polish Newton
// point and an ok bit per surface; the reverse adjoint through the polish
// step with the Newton point held constant; the penalty cotangents gated by
// the surface mask where MASKED is on). The parameter cotangents are per
// system: dz0 (B,), dc, dkappa, dt (B, S), dmu (B, S, W), dasph (B, S, K)
// and, in full mode, dref_z (B, S+1), in opl mode dn_legs (B, S+1, W). They
// are summed as K1 backward sums its own, without atomics: each block's
// terms reduced once per block in double (BlockSums, trace_common.cuh), one
// column per block of a (B, n_params, blocks per system) scratch tensor,
// then reduce_partials sums each (system, parameter) row in a fixed order
// (one warp a row where a system has few blocks), rounded to float32 once.
// Two launches on the same inputs give bit-identical results, and each
// system's sums equal the plain version's float64 sums rounded once.
//
// What bounds it on an H100: per ray the bytes and operations of K3
// backward (see fused_asphere_bwd.cu: 12 B of inputs, 16 / 28 / 36 B of
// cotangents in plain / Lu / full mode, 12 B written; per ray-surface the
// forward once, the backward's surface constants 3 + K, the adjoint chain
// 163, the sag partials 40 + 3 (2 K - 1), the asphere cotangents 10 K and
// 4 + K parameter sums; 19 a ray for the launch, image-transfer and dz0
// terms), at the population's padded surface count, plus each system's
// tables read once per block and its partials, 16 B per block and
// parameter (a double written and read). n_params = 1 + 3 S + S W + S K
// (+ S + 1 in full mode). At the generator width (256 systems x 1,536 rays
// x 7 surfaces, K = 2, N = 10: 5,283 operations a ray in plain mode) that
// is 2.08 GFLOP, 0.031 ms at the 67 TFLOP/s FP32 peak, against 16 MB, 0.005
// ms at 3.35 TB/s: operations bound it (chip_smoke.py's k3_ops and
// k4_bound); at P1's measured issue rates ~0.09-0.11 ms.
//
// Design beyond K3's indexing (measured on an H100; PERF.md, section 6):
// - the parameter sums, 4 + K a surface (6 at K = 2), reduced once per
//   block from shared memory rather than by a warp shuffle tree in double
//   per sum after every surface;
// - the second pass: a system has 6 blocks, so each (system, parameter)
//   row holds 6 partials; one warp sums a row, 8 rows a block (1,824
//   blocks at 256 systems, 7 surfaces, K = 2, 3 wavelengths), where a
//   block of 256 threads a row (14,592 blocks) took 18-25 us of the
//   kernel's ~0.2 ms;
// - 4 blocks of 256 threads an SM (K4B_MIN_BLOCKS): 64 registers where
//   the compiler takes 77-80, with 48-92 B of spills.
// K4 runs K3's device code, so it leaves the Newton loop as K3 does, once
// a lane's steps repeat (bit-identical to all n_iter steps; N above is then
// what the inputs need, ~2.2 steps a lane-surface on the aspheric Cooke
// population), reads the shared per-surface constants from its tables and,
// as K3, is instantiated per asphere term count, the loops over the terms
// unrolled. What it still spends beyond the count: K3b's recompute, and
// the warp's Newton steps beyond its lanes'.
//
// Build: as K3, -fmad=false and no fast-math, so that the recompute
// reproduces the forward and the adjoint the plain version.

#include "asphere_common.cuh"

namespace {

constexpr int MAX_GRID_Y = 65535;
// At least 4 blocks of 256 threads an SM, as K3b: at most 64 registers a
// thread where the compiler takes 77-80 (3 blocks), with 48-92 B of spills;
// 4-5 % faster in every mode on an H100 (PERF.md, section 6).
constexpr int K4B_MIN_BLOCKS = 4;

// MODE: 0 plain, 1 Lu, 2 full, 3 opl; NA asphere terms. The partials are
// (n_sys, n_params, blocks), one column per block, in the parameter layout
// of n_params_a.
template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NA>
__global__ void __launch_bounds__(BLOCK, K4B_MIN_BLOCKS) k4_bwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ kappa,
    const float* __restrict__ t, const float* __restrict__ mu,
    const float* __restrict__ asph, const bool* __restrict__ mask,
    const float* __restrict__ ref_z, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ n_legs, float angle_thr,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dcx_in, const float* __restrict__ dcy_in,
    const float* __restrict__ dpth_in, const float* __restrict__ dptp_in,
    const float* __restrict__ dpz_in, const float* __restrict__ dppath_in,
    const float* __restrict__ dpang_in, const float* __restrict__ dopl_in, int n_sys, int n,
    int n_surf, int n_w, int n_asph, int n_per_w, int n_iter, int n_params, int group,
    float* __restrict__ dxp_out, float* __restrict__ dyp_out, float* __restrict__ dcy_out,
    double* __restrict__ partials) {
  constexpr bool LU = lu_mode(MODE);
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  const int b = blockIdx.z * gridDim.y + blockIdx.y;
  if (b >= n_sys) return;  // the whole block
  const size_t bs = (size_t)b * n_surf;
  __shared__ AsphTables<MODE> tab;
  extern __shared__ double s_sums[];  // the column, then the rows of terms
  tab.load(c + bs, kappa + bs, t + bs, mu + bs * n_w, asph + bs * n_asph,
           FULL ? ref_z + (size_t)b * (n_surf + 1) : nullptr, lo, hi,
           OPL ? n_legs + (size_t)b * (n_surf + 1) * n_w : nullptr,
           MASKED ? mask + bs : nullptr, n_surf, n_w, n_asph);
  const BlockSums sums =
      block_sums(s_sums, n_params + (FULL ? n_surf : 0), group, n, n_per_w, n_w);
  __syncthreads();

  // Threads past the end trace a copy of the system's last ray and put zero
  // terms, so that every thread reaches every flush of the block's sums.
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = i < n;
  const int ic = active ? i : n - 1;
  const size_t r = (size_t)b * n + i;
  const size_t rc = (size_t)b * n + ic;
  const int w = min(ic / n_per_w, n_w - 1);
  auto read = [&](const float* a) { return active ? a[r] : 0.0f; };
  const RayCot cot{read(dx_in), read(dy_in), read(dcx_in), read(dcy_in),
                   LU ? read(dpth_in) : 0.0f, LU ? read(dptp_in) : 0.0f,
                   LU ? read(dpz_in) : 0.0f, FULL ? read(dppath_in) : 0.0f,
                   FULL ? read(dpang_in) : 0.0f, OPL ? read(dopl_in) : 0.0f};
  float dxp, dyp, dcyp;
  bwd_ray_a<MODE, ALLOW_BACKWARD, MASKED, NA>(tab, n_surf, n_w, n_asph, n_iter, angle_thr,
                                             active, w, xp[rc], yp[rc], cy_in[rc], z0[b], cot,
                                             sums, dxp, dyp, dcyp);
  if (active) {
    dxp_out[r] = dxp;
    dyp_out[r] = dyp;
    dcy_out[r] = dcyp;
  }
  write_column(s_sums, n_params, FULL ? s_sums + n_params : nullptr, n_surf,
               partials + (size_t)b * n_params * gridDim.x + blockIdx.x, gridDim.x);
}

template <int MODE, bool ALLOW_BACKWARD, bool MASKED>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* const* in,
                   const bool* mask, float angle_thr, const float* const* cot, int n_sys,
                   int n, int n_surf, int n_w, int n_asph, int n_per_w, int n_iter,
                   int n_params, float* const* out, double* partials) {
  cudaError_t err = cudaSuccess;
  with_terms(n_asph, [&](auto na) {
    auto kernel = k4_bwd_kernel<MODE, ALLOW_BACKWARD, MASKED, decltype(na)::value>;
    constexpr int slots = term_slots_a(MODE, decltype(na)::value);
    const size_t smem =
        block_sums_bytes(n_params + (MODE == 2 ? n_surf : 0), slots, n_surf);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return;
    kernel<<<grid, BLOCK, smem, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], mask, in[9], in[10],
        in[11], in[12], angle_thr, cot[0], cot[1], cot[2], cot[3], cot[4], cot[5], cot[6],
        cot[7], cot[8], cot[9], n_sys, n, n_surf, n_w, n_asph, n_per_w, n_iter, n_params,
        term_group(slots, n_surf), out[0], out[1], out[2], partials);
    err = cudaGetLastError();
  });
  return err;
}

template <int MODE, bool ALLOW_BACKWARD>
cudaError_t launch_masked(bool masked, dim3 grid, cudaStream_t stream,
                          const float* const* in, const bool* mask, float angle_thr,
                          const float* const* cot, int n_sys, int n, int n_surf, int n_w,
                          int n_asph, int n_per_w, int n_iter, int n_params,
                          float* const* out, double* partials) {
  if (masked)
    return launch<MODE, ALLOW_BACKWARD, true>(grid, stream, in, mask, angle_thr, cot,
                                              n_sys, n, n_surf, n_w, n_asph, n_per_w, n_iter,
                                              n_params, out, partials);
  return launch<MODE, ALLOW_BACKWARD, false>(grid, stream, in, mask, angle_thr, cot,
                                             n_sys, n, n_surf, n_w, n_asph, n_per_w, n_iter,
                                             n_params, out, partials);
}

}  // namespace

extern "C" {

// Launches K4 backward and the reduction of its partials on `stream`;
// returns the first CUDA error (0 on success). Inputs as k4_fwd_launch;
// cotangents (n_sys, n) as in k3_bwd_launch, per mode. `partials` holds
// n_sys x n_params x ceil(n / k1_bwd_block()) doubles and `params`
// n_sys x n_params, row-major, with n_params = 1 + 3 S + S W + S K (+ S + 1
// in full mode, + (S + 1) W in opl mode) laid out [dz0 | dc | dkappa | dt |
// dmu (S x W) | da (S x K) | dref_z or dn_legs]. Pointers a mode does not
// use may be null.
int k4_bwd_launch(const float* xp, const float* yp, const float* cy, const float* z0,
                  const float* c, const float* kappa, const float* t, const float* mu,
                  const float* asph, const bool* mask, const float* ref_z, const float* lo,
                  const float* hi, const float* n_legs, float angle_thr, const float* dx,
                  const float* dy, const float* dcx, const float* dcy, const float* dpth,
                  const float* dptp, const float* dpz, const float* dppath, const float* dpang,
                  const float* dopl, int n_sys, int n,
                  int n_surf, int n_w, int n_asph, int n_per_w, int n_iter, int mode,
                  int allow_backward, float* dxp, float* dyp, float* dcy_out,
                  double* partials, float* params, void* stream) {
  if (bad_shape_a(n_surf, n_w, n_asph, n_per_w, n, n_iter, mode) || n_sys < 0)
    return (int)cudaErrorInvalidValue;
  if (n_sys == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_params = n_params_a(mode, n_surf, n_w, n_asph);
  const int blocks = (n + BLOCK - 1) / BLOCK;
  const int gy = n_sys < MAX_GRID_Y ? n_sys : MAX_GRID_Y;
  const dim3 grid(blocks, gy, (n_sys + gy - 1) / gy);
  const float* const in[13] = {xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs};
  const float* const cot[10] = {dx, dy, dcx, dcy, dpth, dptp, dpz, dppath, dpang, dopl};
  float* const out[3] = {dxp, dyp, dcy_out};
  const bool masked = mask != nullptr;
  if (blocks > 0) {
    cudaError_t err;
#define K4_BWD_LAUNCH(M, AB)                                                            \
  launch_masked<M, AB>(masked, grid, s, in, mask, angle_thr, cot, n_sys, n, n_surf,         \
                       n_w, n_asph, n_per_w, n_iter, n_params, out, partials)
    if (mode == 0)
      err = allow_backward ? K4_BWD_LAUNCH(0, true) : K4_BWD_LAUNCH(0, false);
    else if (mode == 1)
      err = allow_backward ? K4_BWD_LAUNCH(1, true) : K4_BWD_LAUNCH(1, false);
    else if (mode == 2)
      err = allow_backward ? K4_BWD_LAUNCH(2, true) : K4_BWD_LAUNCH(2, false);
    else
      err = allow_backward ? K4_BWD_LAUNCH(3, true) : K4_BWD_LAUNCH(3, false);
#undef K4_BWD_LAUNCH
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials(partials, n_sys * n_params, blocks, params, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
