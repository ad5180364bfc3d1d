// K4 forward: the fused conic/even-asphere ray trace of a population of lens
// systems.
//
// Replaces the Pallas TPU kernel `_fwd_kernel_ab` in
// torchoptics_tpu/ops/pallas_asphere.py (plain, Lu, full and opl modes). The
// plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_asphere.py:
// trace_fused_asphere_batch_reference; the two agree bit for bit on the
// failure masks and, in plain mode, on every output.
//
// K4 is K3 (fused_asphere_fwd.cu) over a grid of (ray blocks x systems), as
// K2 is K1: each block belongs to one system, which it finds on blockIdx.y
// (and blockIdx.z past 65,535 systems), and reads that system's c, kappa, t
// (S), mu (S x W), asphere coefficients (S x K, K <= MAX_ASPH), ref_z (S+1,
// full mode), n_legs ((S+1) x W, opl mode) and surface mask into shared
// memory; z0 comes from device
// memory. Ray i of system b sits at b * N + i of the (B, N) ray block and
// has wavelength min(i / n_per_w, W - 1), i system-local: the
// wavelength-outer order of the front-end. The per-ray trace is
// trace_ray_a of asphere_common.cuh, K3's own; MASKED (a template flag)
// switches on the surface mask of padded populations with K2's semantics
// (the backward-ray test at surface k gated by mask[k-1] and the last one by
// mask[S-1], the Lu sums and the angle hinge by mask[k]; padded surfaces are
// traced with whatever conic and coefficients they carry). Without a mask,
// K4 at B = 1 computes K3's outputs bit for bit.
//
// What bounds it on an H100: per ray the bytes and operations of K3 forward
// (see fused_asphere_fwd.cu: 12 B read, 18 / 30 / 38 B written in plain /
// Lu / full mode; 125 + 12 K + N (26 + 5 K) operations a surface with K
// asphere terms and N Newton steps a lane evaluates, the surface constants
// counted once per ray and surface), at the population's padded surface
// count, plus each system's tables read once per block: 3 S + S W + S K + 1
// floats (+ S + 1 in full mode) and S mask bytes (chip_smoke.py's k3_ops
// and k4_bound). At the generator width (256 systems x 1,536 rays x 7 surfaces,
// K = 2, N = 10: 3,459 operations a ray in plain mode) that is 1.36 GFLOP,
// 0.020 ms at the 67 TFLOP/s FP32 peak, against 11.8 MB, 0.0035 ms at
// 3.35 TB/s: operations bound it, by 6x; the tables add < 1 % of the
// bytes. What binds on the card is the FP32 issue rate: its square roots
// and divisions issue as many instructions each (PERF.md, P1). One thread
// per ray; a system's 1,536 rays fill 6 blocks of 256, so a 256-system
// population launches 1,536 blocks, each loading a ~17 KB shared table for
// 256 rays.
//
// Design. K4 runs K3's device code: it leaves the Newton loop as K3 does,
// once a lane's steps repeat (bit-identical to all n_iter steps; N above is
// then what the inputs need, 2.24 steps a lane-surface on the aspheric
// Cooke population, 3.04 for its warp: measured on an H100, PERF.md section 6),
// reads the shared per-surface constants from its tables and is
// instantiated per asphere term count, the loops over the terms unrolled.
// Its exact shortcuts (asphere_common.cuh, shared with K3): the surface
// step's seven roots by sqrt_from_eps, the Lu sums' theta_norm from two of
// them; the polish step's F and F' handed on from the Newton loop where a
// lane leaves it on a repeat; the Snell point's slope and normal taken
// from the hit point's (on a live ray the two points are one, on a dead
// one the forward reads neither); the vertex plane's division only where
// the sphere is missed. What was measured on the card and left out
// (PERF.md, section 6): kernels of their own at the populations' 7 and 11
// surfaces (at 2 asphere terms). Unrolled, the 7-surface kernel was 3,549
// to 4,255 instructions where the loop body is 478 to 586, and ran 1.05 to
// 1.10x the parent's time: a surface is too long to unroll. With the loop
// kept, the fixed count changed nothing but the registers (full mode 49,
// 4 blocks an SM) and ran 1.00-1.02x the runtime-S kernel. Neither blocks
// of 128, nor 6 blocks an SM forced by launch bounds (40 registers, a few
// bytes spilled in full and opl mode), nor a block walking two of its
// system's ray blocks (its table built once for both) ran faster.
//
// Build: as K3, -fmad=false and no fast-math: the masks compare against EPS
// and NEWTON_TOL, and one ulp moved by a contraction flips lanes there.

#include "asphere_common.cuh"

namespace {

constexpr int MAX_GRID_Y = 65535;

// MODE: 0 plain, 1 Lu, 2 full, 3 opl; NA asphere terms.
template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NA>
__global__ void __launch_bounds__(BLOCK) k4_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ kappa,
    const float* __restrict__ t, const float* __restrict__ mu,
    const float* __restrict__ asph, const bool* __restrict__ mask,
    const float* __restrict__ ref_z, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ n_legs, float angle_thr,
    int n_sys, int n, int n_surf, int n_w, int n_asph, int n_per_w, int n_iter,
    float* __restrict__ x_out, float* __restrict__ y_out, float* __restrict__ cx_out,
    float* __restrict__ cy_out, bool* __restrict__ ok_out,
    bool* __restrict__ bw_out, float* __restrict__ pen_theta,
    float* __restrict__ pen_theta_p, float* __restrict__ pen_zrelu,
    float* __restrict__ pen_path_out, float* __restrict__ pen_ang_out,
    float* __restrict__ opl_out) {
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  const int b = blockIdx.z * gridDim.y + blockIdx.y;
  if (b >= n_sys) return;  // the whole block
  const size_t bs = (size_t)b * n_surf;
  __shared__ AsphTables<MODE> tab;
  tab.load(c + bs, kappa + bs, t + bs, mu + bs * n_w, asph + bs * n_asph,
           FULL ? ref_z + (size_t)b * (n_surf + 1) : nullptr, lo, hi,
           OPL ? n_legs + (size_t)b * (n_surf + 1) * n_w : nullptr,
           MASKED ? mask + bs : nullptr, n_surf, n_w, n_asph);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t r = (size_t)b * n + i;
  const int w = min(i / n_per_w, n_w - 1);
  const RayOut o = trace_ray_a<MODE, ALLOW_BACKWARD, MASKED, NA>(
      tab, n_surf, n_w, n_asph, n_iter, w, angle_thr, xp[r], yp[r], cy_in[r], z0[b]);
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
  const float* const* in;  // xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs
  const bool* mask;
  float angle_thr;
  int n_sys, n, n_surf, n_w, n_asph, n_per_w, n_iter;
  float* const* outs;      // x, y, cx, cy
  bool* ok_out;
  bool* bw_out;
  float* const* pens;      // pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NA>
void launch(const Args& a) {
  const auto kernel = k4_fwd_kernel<MODE, ALLOW_BACKWARD, MASKED, NA>;
  if (a.blocks_per_sm) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_per_sm, kernel, BLOCK, 0);
    return;
  }
  const int gy = a.n_sys < MAX_GRID_Y ? a.n_sys : MAX_GRID_Y;
  const dim3 grid((a.n + BLOCK - 1) / BLOCK, gy, (a.n_sys + gy - 1) / gy);
  const float* const* in = a.in;
  kernel<<<grid, BLOCK, 0, a.stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], a.mask, in[9], in[10],
      in[11], in[12], a.angle_thr, a.n_sys, a.n, a.n_surf, a.n_w, a.n_asph, a.n_per_w,
      a.n_iter, a.outs[0], a.outs[1], a.outs[2], a.outs[3], a.ok_out, a.bw_out, a.pens[0],
      a.pens[1], a.pens[2], a.pens[3], a.pens[4], a.pens[5]);
}

template <int MODE, bool ALLOW_BACKWARD, bool MASKED>
void launch_terms(const Args& a) {
  with_terms(a.n_asph,
             [&](auto na) { launch<MODE, ALLOW_BACKWARD, MASKED, decltype(na)::value>(a); });
}

template <int MODE, bool ALLOW_BACKWARD>
void launch_masked(const Args& a) {
  if (a.mask)
    launch_terms<MODE, ALLOW_BACKWARD, true>(a);
  else
    launch_terms<MODE, ALLOW_BACKWARD, false>(a);
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

// The resident blocks per SM of the forward kernel that k4_fwd_launch takes
// for this mode, policy, mask flag and term count
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device),
// its threads a block in *block; -1 where the sizes are refused.
int k4_fwd_blocks_per_sm(int mode, int allow_backward, int masked, int n_asph, int* block) {
  if (bad_shape_a(1, 1, n_asph, 1, 0, 0, mode)) return -1;
  int blocks = 0;
  static const bool some_mask = true;
  const Args a{nullptr, masked ? &some_mask : nullptr, 0.0f, 1, 0, 1, 1, n_asph, 1, 0,
               nullptr, nullptr, nullptr, nullptr, nullptr, &blocks};
  dispatch(mode, allow_backward, a);
  *block = BLOCK;
  return blocks;
}

// Launches K4 forward on `stream` and returns cudaGetLastError() (0 on
// success). Rays and outputs are (n_sys, n) row-major; z0 is (n_sys,), c,
// kappa and t (n_sys, S), mu (n_sys, S, W), asph (n_sys, S, n_asph), ref_z
// (n_sys, S+1) in full mode, n_legs (n_sys, S+1, W) in opl mode, the shared
// per-gap bounds lo, hi (S,). `mask` (n_sys, S) bytes, 1 for a real surface,
// or null when no surface is padded. mode: 0 plain, 1 Lu (pen_theta,
// pen_theta_p, pen_zrelu), 2 full (those plus pen_path, pen_ang), 3 opl
// (opl_out). Pointers a mode does not use may be null.
int k4_fwd_launch(const float* xp, const float* yp, const float* cy, const float* z0,
                  const float* c, const float* kappa, const float* t, const float* mu,
                  const float* asph, const bool* mask, const float* ref_z, const float* lo,
                  const float* hi, const float* n_legs, float angle_thr, int n_sys, int n,
                  int n_surf, int n_w, int n_asph, int n_per_w, int n_iter, int mode,
                  int allow_backward, float* x_out, float* y_out, float* cx_out,
                  float* cy_out, bool* ok_out, bool* bw_out, float* pen_theta,
                  float* pen_theta_p, float* pen_zrelu, float* pen_path, float* pen_ang,
                  float* opl_out, void* stream) {
  if (bad_shape_a(n_surf, n_w, n_asph, n_per_w, n, n_iter, mode) || n_sys < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || n_sys == 0) return 0;
  const float* const in[13] = {xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs};
  float* const outs[4] = {x_out, y_out, cx_out, cy_out};
  float* const pens[6] = {pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl_out};
  const Args a{in, mask, angle_thr, n_sys, n, n_surf, n_w, n_asph, n_per_w, n_iter, outs,
               ok_out, bw_out, pens, (cudaStream_t)stream, nullptr};
  dispatch(mode, allow_backward, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
