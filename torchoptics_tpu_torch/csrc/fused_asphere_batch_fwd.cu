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
// K = 2, N = 10: 3,571 operations a ray in plain mode) that is 1.41 GFLOP,
// 0.021 ms at the 67 TFLOP/s FP32 peak, against 11.8 MB, 0.0035 ms at
// 3.35 TB/s: operations bound it, by 6x; the tables add < 1 % of the
// bytes. One thread per ray; a system's 1,536 rays fill 6 blocks of 256, so
// a 256-system population launches 1,536 blocks, ~12 per SM, each loading a
// ~17 KB shared table for 256 rays.
//
// Design beyond K3's indexing: none. K4 runs K3's device code, so it leaves
// the Newton loop as K3 does, once a lane's steps repeat (bit-identical to
// all n_iter steps; N above is then what the inputs need, ~2.2 steps a
// lane-surface on the aspheric Cooke population), reads the shared
// per-surface constants from its tables and, as K3, is instantiated per
// asphere term count, the loops over the terms unrolled.
// Left for later work: any tuning.
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

template <int MODE, bool ALLOW_BACKWARD, bool MASKED>
void launch(const float* const* in, const bool* mask, float angle_thr, int n_sys, int n,
            int n_surf, int n_w, int n_asph, int n_per_w, int n_iter, float* const* outs,
            bool* ok_out, bool* bw_out, float* const* pens, cudaStream_t stream) {
  const int gy = n_sys < MAX_GRID_Y ? n_sys : MAX_GRID_Y;
  const dim3 grid((n + BLOCK - 1) / BLOCK, gy, (n_sys + gy - 1) / gy);
  with_terms(n_asph, [&](auto na) {
    constexpr int NA = decltype(na)::value;
    k4_fwd_kernel<MODE, ALLOW_BACKWARD, MASKED, NA><<<grid, BLOCK, 0, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], mask, in[9], in[10],
        in[11], in[12], angle_thr, n_sys, n, n_surf, n_w, n_asph, n_per_w, n_iter, outs[0],
        outs[1], outs[2], outs[3], ok_out, bw_out, pens[0], pens[1], pens[2], pens[3],
        pens[4], pens[5]);
  });
}

template <int MODE, bool ALLOW_BACKWARD>
void launch_masked(bool masked, const float* const* in, const bool* mask, float angle_thr,
                   int n_sys, int n, int n_surf, int n_w, int n_asph, int n_per_w, int n_iter,
                   float* const* outs, bool* ok_out, bool* bw_out, float* const* pens,
                   cudaStream_t stream) {
  if (masked)
    launch<MODE, ALLOW_BACKWARD, true>(in, mask, angle_thr, n_sys, n, n_surf, n_w, n_asph,
                                       n_per_w, n_iter, outs, ok_out, bw_out, pens, stream);
  else
    launch<MODE, ALLOW_BACKWARD, false>(in, mask, angle_thr, n_sys, n, n_surf, n_w, n_asph,
                                        n_per_w, n_iter, outs, ok_out, bw_out, pens, stream);
}

}  // namespace

extern "C" {

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
  cudaStream_t s = (cudaStream_t)stream;
  const float* const in[13] = {xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs};
  float* const outs[4] = {x_out, y_out, cx_out, cy_out};
  float* const pens[6] = {pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl_out};
  const bool masked = mask != nullptr;
#define K4_FWD_LAUNCH(M, AB)                                                             \
  launch_masked<M, AB>(masked, in, mask, angle_thr, n_sys, n, n_surf, n_w, n_asph, n_per_w, \
                       n_iter, outs, ok_out, bw_out, pens, s)
  if (mode == 0) {
    if (allow_backward) K4_FWD_LAUNCH(0, true); else K4_FWD_LAUNCH(0, false);
  } else if (mode == 1) {
    if (allow_backward) K4_FWD_LAUNCH(1, true); else K4_FWD_LAUNCH(1, false);
  } else if (mode == 2) {
    if (allow_backward) K4_FWD_LAUNCH(2, true); else K4_FWD_LAUNCH(2, false);
  } else {
    if (allow_backward) K4_FWD_LAUNCH(3, true); else K4_FWD_LAUNCH(3, false);
  }
#undef K4_FWD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
