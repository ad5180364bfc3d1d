// K2 forward: the fused spherical ray trace of a population of lens systems.
//
// Replaces the Pallas TPU kernel `_fwd_kernel_b` in
// torchoptics_tpu/ops/pallas_batch.py (plain, Lu, full and opl modes). The plain
// PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_batch.py:trace_fused_batch_reference; the
// two agree bit for bit on the failure masks and, in plain mode, on every
// output.
//
// K2 is K1 over a grid of (ray blocks x systems): each block belongs to one
// system, which it finds on blockIdx.y (and blockIdx.z past 65,535 systems),
// and reads that system's z0, c, t, mu, ref_z (full mode), n_legs (opl mode)
// and surface mask into shared memory. Ray i of system b sits at b * N + i of the (B, N) ray block and has
// wavelength min(i / n_per_w, W - 1), i system-local: the wavelength-outer
// order of the front-end. The per-ray trace is trace_ray of trace_common.cuh,
// K1's own; MASKED (a template flag) switches on the surface mask of padded
// populations (see trace_common.cuh). Without a mask, K2 at B = 1 computes
// K1's outputs bit for bit.
//
// What bounds it on an H100: per ray the bytes and operations of K1 (see
// fused_trace_fwd.cu), at the padded surface count, plus each system's
// tables read once per block: (2 S + S W + 1, + S + 1 in full mode,
// + (S + 1) W in opl mode) floats and S mask bytes. At the generator width (256 systems x 1,536 rays x 7
// surfaces) the tables add < 1 % of the bytes.
//
// Design: K1 forward's (fused_trace_fwd.cu), one thread per ray. The
// populations' surface counts have kernels of their own, the count fixed at
// compile time (trace_ray's NS: the surface loop unrolled, the tables read
// at immediate offsets): SHORT_SURF, 7 (the Cooke triplets of the
// generator) and 11 (the double-Gauss, and the padded mixed populations,
// masked), every mode, policy and mask flag; any other count takes the
// runtime-S kernel. The Lu sums and the surface step take trace_ray's exact
// shortcuts (theta_norm_root, div_half_pi, sqrt_from_eps). Blocks of
// FWD_BLOCK = 128 rays: a 256-system population of 1,536 rays a system
// launches 3,072 blocks, 23.3 an SM, so that each SM's last blocks, which
// run with the SM part empty, are a smaller share of its work than with
// blocks of 256 (11.6 an SM); measured on an H100, 0.97x and 0.96x the
// time of blocks of 256 in plain and opl mode, within 1 % in Lu and full
// mode, where blocks of 64 ran 1.00-1.03x (PERF.md, section 6).
//
// Build: as K1, -fmad=false and no fast-math.

#include "trace_common.cuh"

namespace {

constexpr int MAX_GRID_Y = 65535;

// The surface counts with a kernel of their own (NS).
constexpr int SHORT_SURF[] = {7, 11};
// Rays (threads) a block.
constexpr int FWD_BLOCK = 128;

// MODE: 0 plain, 1 Lu, 2 full, 3 opl. NS: the surface count, or 0 for any.
template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NS>
__global__ void __launch_bounds__(FWD_BLOCK) k2_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ t,
    const float* __restrict__ mu, const bool* __restrict__ mask,
    const float* __restrict__ ref_z, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ n_legs, float angle_thr,
    int n_sys, int n, int n_surf_arg, int n_w, int n_per_w, float* __restrict__ x_out,
    float* __restrict__ y_out, float* __restrict__ cx_out, float* __restrict__ cy_out,
    bool* __restrict__ ok_out, bool* __restrict__ bw_out,
    float* __restrict__ pen_theta, float* __restrict__ pen_theta_p,
    float* __restrict__ pen_zrelu, float* __restrict__ pen_path_out,
    float* __restrict__ pen_ang_out, float* __restrict__ opl_out) {
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  const int n_surf = NS > 0 ? NS : n_surf_arg;
  const int b = blockIdx.z * gridDim.y + blockIdx.y;
  if (b >= n_sys) return;  // the whole block
  __shared__ Tables<MODE> tab;
  tab.load(c + (size_t)b * n_surf, t + (size_t)b * n_surf, mu + (size_t)b * n_surf * n_w,
           FULL ? ref_z + (size_t)b * (n_surf + 1) : nullptr, lo, hi,
           OPL ? n_legs + (size_t)b * (n_surf + 1) * n_w : nullptr,
           MASKED ? mask + (size_t)b * n_surf : nullptr, n_surf, n_w);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t r = (size_t)b * n + i;
  const int w = min(i / n_per_w, n_w - 1);
  const RayOut o = trace_ray<MODE, ALLOW_BACKWARD, MASKED, NS>(tab, n_surf, n_w, w, angle_thr,
                                                               xp[r], yp[r], cy_in[r], z0[b]);
  x_out[r] = o.x;
  y_out[r] = o.y;
  cx_out[r] = o.cx;
  cy_out[r] = o.cy;
  ok_out[r] = o.ok;
  bw_out[r] = o.bw;
  if (lu_mode(MODE)) {
    pen_theta[r] = o.pth;
    pen_theta_p[r] = o.ptp;
    pen_zrelu[r] = o.pz;
  }
  if (FULL) {
    pen_path_out[r] = o.ppath;
    pen_ang_out[r] = o.pang;
  }
  if (OPL) opl_out[r] = o.opl;
}

// One launch's arguments. Where blocks_per_sm is set, the launchers write
// the kernel's resident blocks per SM there (the occupancy calculator's)
// instead of launching it.
struct Args {
  const float* const* in;  // xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs
  const bool* mask;
  float angle_thr;
  int n_sys, n, n_surf, n_w, n_per_w;
  float* const* outs;      // x, y, cx, cy
  bool* ok_out;
  bool* bw_out;
  float* const* pens;      // pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NS>
void launch(const Args& a) {
  const auto kernel = k2_fwd_kernel<MODE, ALLOW_BACKWARD, MASKED, NS>;
  if (a.blocks_per_sm) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_per_sm, kernel, FWD_BLOCK, 0);
    return;
  }
  const int gy = a.n_sys < MAX_GRID_Y ? a.n_sys : MAX_GRID_Y;
  const dim3 grid((a.n + FWD_BLOCK - 1) / FWD_BLOCK, gy, (a.n_sys + gy - 1) / gy);
  const float* const* in = a.in;
  kernel<<<grid, FWD_BLOCK, 0, a.stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], a.mask, in[7], in[8], in[9], in[10],
      a.angle_thr, a.n_sys, a.n, a.n_surf, a.n_w, a.n_per_w, a.outs[0], a.outs[1], a.outs[2],
      a.outs[3], a.ok_out, a.bw_out, a.pens[0], a.pens[1], a.pens[2], a.pens[3], a.pens[4],
      a.pens[5]);
}

template <int MODE, bool ALLOW_BACKWARD, bool MASKED>
void launch_surf(const Args& a) {
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
void launch_masked(const Args& a) {
  if (a.mask)
    launch_surf<MODE, ALLOW_BACKWARD, true>(a);
  else
    launch_surf<MODE, ALLOW_BACKWARD, false>(a);
}

void dispatch(int mode, int allow_backward, const Args& a) {
  if (mode == 0) {
    if (allow_backward) launch_masked<0, true>(a); else launch_masked<0, false>(a);
  } else if (mode == 1) {
    if (allow_backward) launch_masked<1, true>(a); else launch_masked<1, false>(a);
  } else if (mode == 2) {
    if (allow_backward) launch_masked<2, true>(a); else launch_masked<2, false>(a);
  } else {
    if (allow_backward) launch_masked<3, true>(a); else launch_masked<3, false>(a);
  }
}

}  // namespace

extern "C" {

// 1 where n_surf has a forward kernel of its own, 0 where it takes the
// runtime-S one.
int k2_fwd_specialized(int n_surf) {
  for (int k : SHORT_SURF)
    if (k == n_surf) return 1;
  return 0;
}

// The resident blocks per SM of the forward kernel that k2_fwd_launch takes
// for these sizes and flags (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// on the current device), its threads a block in *block; -1 where the sizes
// are refused.
int k2_fwd_blocks_per_sm(int mode, int allow_backward, int masked, int n_surf, int* block) {
  if (bad_shape(n_surf, 1, 1, 0, mode)) return -1;
  int blocks = 0;
  static const bool some_mask = true;
  const Args a{nullptr, masked ? &some_mask : nullptr, 0.0f, 1, 0, n_surf, 1, 1,
               nullptr, nullptr, nullptr, nullptr, nullptr, &blocks};
  dispatch(mode, allow_backward, a);
  *block = FWD_BLOCK;
  return blocks;
}

// Launches K2 forward on `stream` and returns cudaGetLastError() (0 on
// success). Rays and outputs are (n_sys, n) row-major; z0 is (n_sys,), c and
// t (n_sys, S), mu (n_sys, S, W), ref_z (n_sys, S+1) in full mode, n_legs
// (n_sys, S+1, W) in opl mode, the shared per-gap bounds lo, hi (S,). `mask`
// (n_sys, S) bytes, 1 for a real surface, or null when no surface is padded.
// mode: 0 plain, 1 Lu (pen_theta, pen_theta_p, pen_zrelu), 2 full (those
// plus pen_path, pen_ang), 3 opl (opl_out). Pointers a mode does not use may
// be null.
int k2_fwd_launch(const float* xp, const float* yp, const float* cy, const float* z0,
                  const float* c, const float* t, const float* mu, const bool* mask,
                  const float* ref_z, const float* lo, const float* hi,
                  const float* n_legs, float angle_thr, int n_sys, int n, int n_surf,
                  int n_w, int n_per_w, int mode, int allow_backward, float* x_out,
                  float* y_out, float* cx_out, float* cy_out, bool* ok_out, bool* bw_out,
                  float* pen_theta, float* pen_theta_p, float* pen_zrelu, float* pen_path,
                  float* pen_ang, float* opl_out, void* stream) {
  if (bad_shape(n_surf, n_w, n_per_w, n, mode) || n_sys < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || n_sys == 0) return 0;
  const float* const in[11] = {xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs};
  float* const outs[4] = {x_out, y_out, cx_out, cy_out};
  float* const pens[6] = {pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl_out};
  const Args a{in, mask, angle_thr, n_sys, n, n_surf, n_w, n_per_w, outs, ok_out, bw_out,
               pens, (cudaStream_t)stream, nullptr};
  dispatch(mode, allow_backward, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
