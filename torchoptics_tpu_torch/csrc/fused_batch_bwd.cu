// K2 backward: the hand adjoint of the population trace (K2 forward).
//
// Replaces the Pallas TPU kernel `_bwd_kernel_b` in
// torchoptics_tpu/ops/pallas_batch.py (plain, Lu, full and opl modes, both
// backward-ray policies). The plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_batch.py:
// trace_fused_batch_backward_reference; the per-ray cotangents of the two
// agree bit for bit.
//
// K1 backward over a grid of (ray blocks x systems), as K2 forward lays it
// out: each block reads its system's tables into shared memory and runs
// bwd_ray of trace_common.cuh on its rays (forward recompute with a 6-float
// stash per surface, reverse adjoint, the penalty cotangents gated by the
// surface mask where MASKED is on). The parameter cotangents are per system:
// dz0 (B,), dc, dt (B, S), dmu (B, S, W) and, in full mode, dref_z (B, S+1),
// in opl mode dn_legs (B, S+1, W).
// They are summed without atomics, as in K1: the block's terms reduced once
// per block in double (BlockSums, trace_common.cuh), then one column per
// block of a (B, n_params, blocks per system) scratch tensor, then
// reduce_partials sums each (system, parameter) row in a fixed order (one
// warp a row where a system has few blocks), all in double and rounded to
// float32 once. Two launches on the same inputs give bit-identical results.
//
// What bounds it on an H100: per ray the bytes and operations of K1 backward
// (see fused_trace_bwd.cu) at the padded surface count, plus the partials,
// 16 B per block and parameter (a double written and read), and each system's tables read once per block.
// At the generator width (1,536 rays a system) a system has 6 blocks, so a
// (system, parameter) row holds 6 partials: one warp sums it, 8 rows a
// block, where a block of 256 threads a row took 12-20 us of the ~0.1 ms
// (measured on an H100; PERF.md, section 6).
//
// Design for the short systems of populations: the surface counts in
// SHORT_SURF (7, the Cooke triplet's; 11, the double-Gauss's and the mixed
// populations' padded width) are instantiated with the count fixed at
// compile time (bwd_ray's NS). Its loops unroll, so the 6-float stash a
// surface stays in registers (80 of them, 3 blocks an SM, a few spilled),
// where the runtime-S kernel keeps it in a 1,536-byte local-memory frame;
// and its divisions skip zero dividends (quot), which a population's failed
// rays divide on every surface and which IEEE division sends down its slow
// path. The unrolled kernel without quot was slower than the runtime-S one
// on a population; with it, 9-15 % faster (measured on an H100, PERF.md
// section 6). Any other count runs the runtime-S kernel. Each thread reads
// its ray and cotangents before the tables' barrier, so that the two reads'
// latencies overlap.
//
// Build: as K1, -fmad=false and no fast-math.

#include "trace_common.cuh"

namespace {

constexpr int MAX_GRID_Y = 65535;
// The surface counts with a kernel of their own (NS), and the blocks an SM
// their kernels ask for: 80 registers a thread, which spills a little of the
// stash (measured on an H100: 2 blocks of ~120 registers without spills are
// slower, PERF.md section 6).
constexpr int SHORT_SURF[] = {7, 11};
constexpr int SHORT_BLOCKS_PER_SM = 3;

// MODE: 0 plain, 1 Lu, 2 full, 3 opl. NS: the surface count, or 0 for any.
template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NS>
__global__ void __launch_bounds__(BLOCK, NS > 0 ? SHORT_BLOCKS_PER_SM : 1) k2_bwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ t,
    const float* __restrict__ mu, const bool* __restrict__ mask,
    const float* __restrict__ ref_z, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ n_legs, float angle_thr,
    const float* __restrict__ dx_in, const float* __restrict__ dy_in,
    const float* __restrict__ dcx_in, const float* __restrict__ dcy_in,
    const float* __restrict__ dpth_in, const float* __restrict__ dptp_in,
    const float* __restrict__ dpz_in, const float* __restrict__ dppath_in,
    const float* __restrict__ dpang_in, const float* __restrict__ dopl_in, int n_sys,
    int n, int n_surf, int n_w, int n_per_w, int n_params, int group,
    float* __restrict__ dxp_out,
    float* __restrict__ dyp_out, float* __restrict__ dcy_out,
    double* __restrict__ partials) {
  constexpr bool LU = lu_mode(MODE);
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  const int b = blockIdx.z * gridDim.y + blockIdx.y;
  if (b >= n_sys) return;  // the whole block
  // Threads past the end trace a copy of the system's last ray and put zero
  // terms, so that every thread reaches every flush of the block's sums. The
  // rays are read before the tables' barrier, so that the two reads' latencies
  // overlap.
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
  const float x0 = xp[rc], y0 = yp[rc], cy0 = cy_in[rc], zb = z0[b];
  __shared__ Tables<MODE> tab;
  extern __shared__ double s_sums[];  // the column, then the rows of terms
  tab.load(c + (size_t)b * n_surf, t + (size_t)b * n_surf, mu + (size_t)b * n_surf * n_w,
           FULL ? ref_z + (size_t)b * (n_surf + 1) : nullptr, lo, hi,
           OPL ? n_legs + (size_t)b * (n_surf + 1) * n_w : nullptr,
           MASKED ? mask + (size_t)b * n_surf : nullptr, n_surf, n_w);
  const BlockSums bs =
      block_sums(s_sums, n_params + (FULL ? n_surf : 0), group, n, n_per_w, n_w);
  __syncthreads();

  float dxp, dyp, dcyp;
  bwd_ray<MODE, ALLOW_BACKWARD, MASKED, NS>(tab, n_surf, n_w, angle_thr, active, w, x0, y0,
                                            cy0, zb, cot, bs, dxp, dyp, dcyp);
  if (active) {
    dxp_out[r] = dxp;
    dyp_out[r] = dyp;
    dcy_out[r] = dcyp;
  }
  write_column(s_sums, n_params, FULL ? s_sums + n_params : nullptr, n_surf,
               partials + (size_t)b * n_params * gridDim.x + blockIdx.x, gridDim.x);
}

// The launch arguments every instantiation takes.
struct Args {
  dim3 grid;
  cudaStream_t stream;
  const float* const* in;
  const bool* mask;
  float angle_thr;
  const float* const* cot;
  int n_sys, n, n_surf, n_w, n_per_w, n_params;
  float* const* out;
  double* partials;
};

template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NS>
cudaError_t launch(const Args& a) {
  auto kernel = k2_bwd_kernel<MODE, ALLOW_BACKWARD, MASKED, NS>;
  constexpr int slots = term_slots(MODE);
  const size_t smem =
      block_sums_bytes(a.n_params + (MODE == 2 ? a.n_surf : 0), slots, a.n_surf);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float* const* in = a.in;
  const float* const* cot = a.cot;
  kernel<<<a.grid, BLOCK, smem, a.stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], a.mask, in[7], in[8], in[9], in[10],
      a.angle_thr, cot[0], cot[1], cot[2], cot[3], cot[4], cot[5], cot[6], cot[7], cot[8],
      cot[9], a.n_sys, a.n, a.n_surf, a.n_w, a.n_per_w, a.n_params,
      term_group(slots, a.n_surf), a.out[0], a.out[1], a.out[2], a.partials);
  return cudaGetLastError();
}

template <int MODE, bool ALLOW_BACKWARD, bool MASKED>
cudaError_t launch_surf(const Args& a) {
  switch (a.n_surf) {
    case 7:
      return launch<MODE, ALLOW_BACKWARD, MASKED, 7>(a);
    case 11:
      return launch<MODE, ALLOW_BACKWARD, MASKED, 11>(a);
    default:
      return launch<MODE, ALLOW_BACKWARD, MASKED, 0>(a);
  }
}

template <int MODE, bool ALLOW_BACKWARD>
cudaError_t launch_masked(const Args& a) {
  return a.mask ? launch_surf<MODE, ALLOW_BACKWARD, true>(a)
                : launch_surf<MODE, ALLOW_BACKWARD, false>(a);
}

}  // namespace

extern "C" {

// 1 where n_surf has a kernel of its own, 0 where it takes the runtime-S one.
int k2_bwd_specialized(int n_surf) {
  for (int k : SHORT_SURF)
    if (k == n_surf) return 1;
  return 0;
}

// Launches K2 backward and the reduction of its partials on `stream`;
// returns the first CUDA error (0 on success). Inputs as k2_fwd_launch;
// cotangents (n_sys, n) as in k1_bwd_launch, per mode. `partials` holds
// n_sys x n_params x ceil(n / k1_bwd_block()) doubles and `params`
// n_sys x n_params, row-major, with n_params = 1 + 2 S + S W (+ S + 1 in full
// mode, + (S + 1) W in opl mode) laid out [dz0 | dc | dt | dmu | dref_z or
// dn_legs]. Pointers a mode does not use may be null.
int k2_bwd_launch(const float* xp, const float* yp, const float* cy, const float* z0,
                  const float* c, const float* t, const float* mu, const bool* mask,
                  const float* ref_z, const float* lo, const float* hi,
                  const float* n_legs, float angle_thr, const float* dx, const float* dy,
                  const float* dcx, const float* dcy, const float* dpth, const float* dptp,
                  const float* dpz, const float* dppath, const float* dpang,
                  const float* dopl, int n_sys, int n, int n_surf, int n_w, int n_per_w,
                  int mode, int allow_backward, float* dxp, float* dyp, float* dcy_out,
                  double* partials, float* params, void* stream) {
  if (bad_shape(n_surf, n_w, n_per_w, n, mode) || n_sys < 0)
    return (int)cudaErrorInvalidValue;
  if (n_sys == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_params = n_params_of(mode, n_surf, n_w);
  const int blocks = (n + BLOCK - 1) / BLOCK;
  const int gy = n_sys < MAX_GRID_Y ? n_sys : MAX_GRID_Y;
  const dim3 grid(blocks, gy, (n_sys + gy - 1) / gy);
  const float* const in[11] = {xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs};
  const float* const cot[10] = {dx, dy, dcx, dcy, dpth, dptp, dpz, dppath, dpang, dopl};
  float* const out[3] = {dxp, dyp, dcy_out};
  const Args args{grid, s, in, mask, angle_thr, cot, n_sys, n, n_surf, n_w, n_per_w,
                  n_params, out, partials};
  if (blocks > 0) {
    cudaError_t err;
#define K2_BWD_LAUNCH(M, AB) launch_masked<M, AB>(args)
    if (mode == 0)
      err = allow_backward ? K2_BWD_LAUNCH(0, true) : K2_BWD_LAUNCH(0, false);
    else if (mode == 1)
      err = allow_backward ? K2_BWD_LAUNCH(1, true) : K2_BWD_LAUNCH(1, false);
    else if (mode == 2)
      err = allow_backward ? K2_BWD_LAUNCH(2, true) : K2_BWD_LAUNCH(2, false);
    else
      err = allow_backward ? K2_BWD_LAUNCH(3, true) : K2_BWD_LAUNCH(3, false);
#undef K2_BWD_LAUNCH
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials(partials, n_sys * n_params, blocks, params, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
