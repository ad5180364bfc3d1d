// K3 backward: the hand adjoint of the fused conic/asphere trace (K3
// forward).
//
// Replaces the Pallas TPU kernel `_bwd_kernel_a` in
// torchoptics_tpu/ops/pallas_asphere.py (plain, Lu, full and opl modes, both
// backward-ray policies). The plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_asphere.py:
// trace_fused_asphere_backward_reference; the per-ray cotangents of the two
// agree bit for bit.
//
// The derivative is that of the polish step (implicit differentiation): the
// n_iter Newton steps are constants, and the sag's closed-form partials in
// c, kappa and a_j at the Newton point, the hit point and the Snell point
// carry the sensitivity. Per ray, one thread: the forward surface by
// surface with its own arithmetic, stashing the 6 pre-surface state values,
// the pre-polish Newton point s_pre and one ok bit per surface; the
// image-transfer adjoint; then the surfaces in reverse, each one's locals
// recomputed from its stash from s_pre on (the polish evaluation, the hit
// point, Snell's law: bit-identical, since nothing is contracted, and
// without the Newton steps), the penalty cotangents injected as in K1, the
// killed lanes cut, and the surface adjoint applied. Outputs: the per-ray
// cotangents of xp, yp and cy, and the parameter cotangents dz0, dc,
// dkappa, dt, dmu (per wavelength), da (S x K) and, in full mode, dref_z, in
// opl mode dn_legs (per leg and wavelength), which are sums over all rays.
//
// The parameter sums are K1's (fused_trace_bwd.cu): each block's terms
// reduced once per block in double from shared memory (BlockSums), each
// block's column of a (n_params x blocks) scratch tensor in a fixed order,
// and a second kernel that sums each row in a fixed order, rounded to
// float32 once. No atomics: two launches on the same inputs give
// bit-identical results.
//
// What bounds it on an H100: per ray it reads 12 B of inputs and 16 / 28 /
// 36 B of cotangents (plain / Lu / full) and writes 12 B, as K1; the
// partials add 16 B per block and parameter. The operations are counted as
// for the forward, each value once, and as the function needs them
// (chip_smoke.py's k3_ops): per ray-surface the forward once
// (125 + 12 K + N (26 + 5 K), N the Newton steps a lane evaluates, less
// (1 - Q)(24 + 5 K) where a share Q of lane-surfaces finds no repeat: the
// polish's F and F' are the last Newton step's elsewhere); the
// backward's surface constants c (1+kappa)c^2, c^3 and a_j (j+2)(j+1),
// 3 + K; the adjoint chain through Snell's law, the hit point and the polish
// step, 163 (the Newton point's coordinates, dot product and sag terms are
// the forward's, not counted again); the sag partials, 20 at the Newton
// point and 10 at each of the hit and Snell points (where the sag's
// partials are read by nothing), plus 2 K - 1 for the asphere terms of
// dg/dr^2 at each; the asphere cotangents, 10 K on the forward's powers of
// r^2; and one add per ray for each of the 4 + K parameter sums. Per ray 19
// for the launch, image-transfer and dz0 terms; Lu, full and opl add what
// they add to K1b. At K = 2 and N = 10 that is 752 a surface, 8,291 a ray
// on the 11-surface flagship in plain mode: 20.4 GFLOP at 2.46M rays,
// 0.304 ms at the 67 TFLOP/s FP32 peak; at the ~2.4 steps the flagship's
// lanes need, 5,285 a ray, 0.194 ms; against ~103 MB, 0.031 ms at
// 3.35 TB/s: operations bound it.
//
// Design: the forward as K3 forward's (the Newton exit, the constants
// formed once per block, the kernel instantiated per asphere term count K
// with the terms' loops unrolled, its shortcuts: the stash pass takes the
// forward surface step, surface_finish<false>; the reverse loop's recompute
// forms every local the adjoint reads, surface_finish<true>). The adjoint shares reciprocals where it
// divided by one denominator more than once: the sag partials take one
// reciprocal of w and one of 1 + w (2 divisions at the Newton point where
// the quotients took 7, and 1 at each of the hit and Snell points), the
// polish step one of F'; 10 divisions a surface where there were 28. The
// plain version (ops/fused_asphere.py: _g_partials, _bwd_surface_a) has the
// same form, so the per-ray cotangents stay bit-identical; it stays within
// a few float32 roundings of the quotients (tests/test_torch_newton_exit.py).
// What the kernel spends beyond the count: the rest of each surface step a
// second time (the recompute from s_pre in the reverse loop) and the path
// hinges of each gap twice. The stash (7 floats a surface, 1,792 B of stack
// frame at MAX_SURF, 308 B used at 11 surfaces) lives in local memory,
// which the L1 and L2 caches hold; the TPU kernel stashes 32 floats and 6
// masks a surface instead. The kernel asks for 4 blocks of 256 an SM
// (K3B_MIN_BLOCKS): 64 registers where it would take 80, with 48-92 B of
// spills, and 1,024 threads in flight where 768 fit.
//
// Build: as the forward, -fmad=false and no fast-math, so that the
// recompute reproduces the forward and the adjoint the plain version.

#include "asphere_common.cuh"

namespace {

// At least 4 blocks of 256 threads an SM: at most 64 registers a thread
// where the compiler would take 80 (3 blocks), with a few spills, for a
// third more warps in flight over the divisions and the stash's local
// memory; faster in every mode on an H100 (PERF.md, section 6).
constexpr int K3B_MIN_BLOCKS = 4;

// MODE: 0 plain, 1 Lu, 2 full, 3 opl; NA asphere terms. The partials are
// (n_params x blocks), one column per block, in the parameter layout of
// n_params_a.
template <int MODE, bool ALLOW_BACKWARD, int NA>
__global__ void __launch_bounds__(BLOCK, K3B_MIN_BLOCKS) k3_bwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ kappa,
    const float* __restrict__ t, const float* __restrict__ mu,
    const float* __restrict__ asph, const float* __restrict__ ref_z,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ n_legs, float angle_thr,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dcx_in, const float* __restrict__ dcy_in,
    const float* __restrict__ dpth_in, const float* __restrict__ dptp_in,
    const float* __restrict__ dpz_in, const float* __restrict__ dppath_in,
    const float* __restrict__ dpang_in, const float* __restrict__ dopl_in, int n,
    int n_surf, int n_w, int n_asph, int n_per_w, int n_iter, int n_params, int group,
    float* __restrict__ dxp_out, float* __restrict__ dyp_out, float* __restrict__ dcy_out,
    double* __restrict__ partials) {
  constexpr bool LU = lu_mode(MODE);
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  __shared__ AsphTables<MODE> tab;
  extern __shared__ double s_sums[];  // the column, then the rows of terms
  tab.load(c, kappa, t, mu, asph, ref_z, lo, hi, n_legs, nullptr, n_surf, n_w, n_asph);
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
  bwd_ray_a<MODE, ALLOW_BACKWARD, false, NA>(tab, n_surf, n_w, n_asph, n_iter, angle_thr,
                                             active, w, xp[ic], yp[ic], cy_in[ic], *z0, cot,
                                             bs, dxp, dyp, dcyp);
  if (active) {
    dxp_out[i] = dxp;
    dyp_out[i] = dyp;
    dcy_out[i] = dcyp;
  }
  write_column(s_sums, n_params, FULL ? s_sums + n_params : nullptr, n_surf,
               partials + blockIdx.x, gridDim.x);
}

template <int MODE, bool ALLOW_BACKWARD>
cudaError_t launch(int grid, cudaStream_t stream, const float* const* in,
                   float angle_thr, const float* const* cot, int n, int n_surf, int n_w,
                   int n_asph, int n_per_w, int n_iter, int n_params, float* const* out,
                   double* partials) {
  cudaError_t err = cudaSuccess;
  with_terms(n_asph, [&](auto na) {
    auto kernel = k3_bwd_kernel<MODE, ALLOW_BACKWARD, decltype(na)::value>;
    constexpr int slots = term_slots_a(MODE, decltype(na)::value);
    const size_t smem =
        block_sums_bytes(n_params + (MODE == 2 ? n_surf : 0), slots, n_surf);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return;
    kernel<<<grid, BLOCK, smem, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10], in[11],
        in[12], angle_thr, cot[0], cot[1], cot[2], cot[3], cot[4], cot[5], cot[6], cot[7],
        cot[8], cot[9], n, n_surf, n_w, n_asph, n_per_w, n_iter, n_params,
        term_group(slots, n_surf), out[0], out[1], out[2], partials);
    err = cudaGetLastError();
  });
  return err;
}

}  // namespace

extern "C" {

// Launches K3 backward and the reduction of its partials on `stream`;
// returns the first CUDA error (0 on success). mode: 0 plain (cotangents dx,
// dy, dcx, dcy), 1 Lu (plus dpth, dptp, dpz), 2 full (plus dppath, dpang;
// reads ref_z, lo, hi, angle_thr), 3 opl (plus dopl; reads n_legs).
// `partials` holds n_params x ceil(n / k1_bwd_block()) doubles and `params`
// n_params, with n_params = 1 + 3 S + S W + S K (+ S + 1 in full mode,
// + (S + 1) W in opl mode), laid out [dz0 | dc | dkappa | dt | dmu (S x W) |
// da (S x K) | dref_z or dn_legs]. Pointers a mode does not use may be null.
int k3_bwd_launch(const float* xp, const float* yp, const float* cy,
                  const float* z0, const float* c, const float* kappa,
                  const float* t, const float* mu, const float* asph,
                  const float* ref_z, const float* lo, const float* hi,
                  const float* n_legs, float angle_thr, const float* dx, const float* dy,
                  const float* dcx, const float* dcy, const float* dpth,
                  const float* dptp, const float* dpz, const float* dppath,
                  const float* dpang, const float* dopl, int n, int n_surf, int n_w, int n_asph,
                  int n_per_w, int n_iter, int mode, int allow_backward,
                  float* dxp, float* dyp, float* dcy_out, double* partials,
                  float* params, void* stream) {
  if (bad_shape_a(n_surf, n_w, n_asph, n_per_w, n, n_iter, mode))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_params = n_params_a(mode, n_surf, n_w, n_asph);
  const int grid = (n + BLOCK - 1) / BLOCK;
  const float* const in[13] = {xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs};
  const float* const cot[10] = {dx, dy, dcx, dcy, dpth, dptp, dpz, dppath, dpang, dopl};
  float* const out[3] = {dxp, dyp, dcy_out};
  if (grid > 0) {
    cudaError_t err;
#define K3_BWD_LAUNCH(M, AB)                                                      \
  launch<M, AB>(grid, s, in, angle_thr, cot, n, n_surf, n_w, n_asph, n_per_w,       \
                n_iter, n_params, out, partials)
    if (mode == 0)
      err = allow_backward ? K3_BWD_LAUNCH(0, true) : K3_BWD_LAUNCH(0, false);
    else if (mode == 1)
      err = allow_backward ? K3_BWD_LAUNCH(1, true) : K3_BWD_LAUNCH(1, false);
    else if (mode == 2)
      err = allow_backward ? K3_BWD_LAUNCH(2, true) : K3_BWD_LAUNCH(2, false);
    else
      err = allow_backward ? K3_BWD_LAUNCH(3, true) : K3_BWD_LAUNCH(3, false);
#undef K3_BWD_LAUNCH
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials(partials, n_params, grid, params, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
