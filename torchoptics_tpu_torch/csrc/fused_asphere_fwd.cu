// K3 forward: fused conic/even-asphere ray trace of one lens system on a
// flat ray block.
//
// Replaces the Pallas TPU kernel `_fwd_kernel_a` in
// torchoptics_tpu/ops/pallas_asphere.py (plain, Lu, full and opl modes). The
// plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/fused_asphere.py:trace_fused_asphere_reference;
// the two agree bit for bit on the failure masks and, in plain mode, on the
// coordinates.
//
// Per ray: launch at the entrance pupil; for each surface the closed-form
// sphere guess (the vertex plane where it misses), n_iter Newton steps on
// F(s) = z(s) - sag(r^2(s)), one polish step, the failure masks (the
// sag-domain guard at the Newton point and at the hit point, a stationary
// F', non-convergence |F| > 1e-5, cos^2 < EPS), Snell's law with the true
// normal (TIR and cz^2 masks), zeroing of failed lanes, backward-ray
// bookkeeping (or removal), and the sums of the mode, as K1 forward's
// (fused_trace_fwd.cu: the penalty sums, or in opl mode the optical path
// length); finally the transfer to the image plane.
//
// What bounds it on an H100: per ray it reads 12 B (xp, yp, cy) and writes
// 18 B (plain), 30 B (Lu) or 38 B (full), as K1. Counting FP32 arithmetic
// only (adds, multiplies, min/max, each sqrt and division as one; negations,
// fabsf, compares and selects not counted), each value once, with K asphere
// terms and N Newton steps: the surface constants (1+kappa)c^2 and
// a_j (j+2), 3 + K; a Newton step, 26 + 5 K (F, F' and the step 18, the
// sag and its slope 8 + 5 K); the polish step, 2, its F and F' the last
// Newton step's where a lane leaves on a repeat and 24 + 5 K more on the
// share Q of lane-surfaces that find none; the sphere guess and the plane
// fallback 26; the hit point 29 + 3 K (its slope 4 + 3 K: the sag there is
// computed but read by nothing; then the normal and cos^2) and Snell's law
// 31 (the Snell point's slope and normal are the hit point's on a live ray,
// and read by nothing the forward writes on a dead one): 91 + 4 K +
// N (26 + 5 K) + Q (24 + 5 K) a surface, 493 at N = 10, Q = 1 and K = 2,
// ~9x K1's 55. Lu adds 14 a surface and full 10 a
// surface and 3 per finite side of a path bound, opl 2 a leg and 4 B written
// a ray, as in K1; the launch and the image transfer add 8 a ray
// (chip_smoke.py's k3_ops). N is what the inputs need: a lane leaves the
// Newton loop once its steps repeat (below), on the flagship after ~2.4
// steps on average where the loop ran 10. Operations bound it, ~9x above
// the bytes at N = 10 and still ~3x at N = 2.4.
//
// Design: one thread per ray, as K1. The Newton loop (newton_point in
// asphere_common.cuh) leaves a lane as soon as its steps repeat, a fixed
// point or a 2-cycle between two floats, and reads the n_iter-th step off
// the cycle: a step is a function of s alone, every operation correctly
// rounded, so the exit returns the bits of all n_iter steps (the plain
// version runs them all, and the two are held bit for bit). A warp runs
// until its last lane leaves. The per-surface tables c, t, mu and the
// asphere coefficients (S x K, K <= MAX_ASPH) are read once per block into
// shared memory, with the constants every sag evaluation shares ((1+kappa)
// c^2 and the products a_j (j+2), formed there once), which a thread copies
// into registers once a surface. The kernel is instantiated per
// asphere term count K (1 to MAX_ASPH = 8), so the loops over the terms are
// unrolled; z0 is read from device memory; the mode and the backward-ray
// policy are template parameters; the ragged tail is masked by i < n. Ray i
// has wavelength min(i / n_per_w, W - 1). The per-ray trace (trace_ray_a)
// and the surface math live in asphere_common.cuh, with the MASKED switch
// for the population kernel K4; so do the exact shortcuts it shares with
// K4 forward: the surface step's roots by sqrt_from_eps, the Lu sums'
// theta_norm from those roots, the polish step's F and F' from the Newton
// loop, the Snell point's slope and normal from the hit point's, the vertex
// plane only where the sphere is missed.
//
// Build: as K1, nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false, no fast-math: the masks compare against EPS and NEWTON_TOL,
// and one ulp moved by a contraction or an approximate sqrt or division
// flips lanes at those thresholds.

#include "asphere_common.cuh"

namespace {

// MODE: 0 plain, 1 Lu, 2 full, 3 opl; NA asphere terms.
template <int MODE, bool ALLOW_BACKWARD, int NA>
__global__ void __launch_bounds__(BLOCK) k3_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ kappa,
    const float* __restrict__ t, const float* __restrict__ mu,
    const float* __restrict__ asph, const float* __restrict__ ref_z,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ n_legs, float angle_thr,
    int n, int n_surf, int n_w, int n_asph, int n_per_w, int n_iter,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ cx_out, float* __restrict__ cy_out,
    bool* __restrict__ ok_out, bool* __restrict__ bw_out,
    float* __restrict__ pen_theta, float* __restrict__ pen_theta_p,
    float* __restrict__ pen_zrelu, float* __restrict__ pen_path_out,
    float* __restrict__ pen_ang_out, float* __restrict__ opl_out) {
  __shared__ AsphTables<MODE> tab;
  tab.load(c, kappa, t, mu, asph, ref_z, lo, hi, n_legs, nullptr, n_surf, n_w, n_asph);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = min(i / n_per_w, n_w - 1);
  const RayOut r = trace_ray_a<MODE, ALLOW_BACKWARD, false, NA>(
      tab, n_surf, n_w, n_asph, n_iter, w, angle_thr, xp[i], yp[i], cy_in[i], *z0);
  x_out[i] = r.x;
  y_out[i] = r.y;
  cx_out[i] = r.cx;
  cy_out[i] = r.cy;
  ok_out[i] = r.ok;
  bw_out[i] = r.bw;
  if (lu_mode(MODE)) {
    pen_theta[i] = r.pth;
    pen_theta_p[i] = r.ptp;
    pen_zrelu[i] = r.pz;
  }
  if (MODE == 2) {
    pen_path_out[i] = r.ppath;
    pen_ang_out[i] = r.pang;
  }
  if (MODE == 3) opl_out[i] = r.opl;
}

template <int MODE, bool ALLOW_BACKWARD>
void launch(const float* const* in, float angle_thr, int n, int n_surf, int n_w,
            int n_asph, int n_per_w, int n_iter, float* const* outs, bool* ok_out,
            bool* bw_out, float* const* pens, cudaStream_t stream) {
  const int grid = (n + BLOCK - 1) / BLOCK;
  with_terms(n_asph, [&](auto na) {
    k3_fwd_kernel<MODE, ALLOW_BACKWARD, decltype(na)::value><<<grid, BLOCK, 0, stream>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
        in[11], in[12], angle_thr, n, n_surf, n_w, n_asph, n_per_w, n_iter, outs[0], outs[1],
        outs[2], outs[3], ok_out, bw_out, pens[0], pens[1], pens[2], pens[3], pens[4],
        pens[5]);
  });
}

}  // namespace

extern "C" {

int k3_max_asph() { return MAX_ASPH; }

// Launches K3 forward on `stream` and returns cudaGetLastError() (0 on
// success). asph is (S, n_asph) row-major. mode: 0 plain, 1 Lu (pen_theta,
// pen_theta_p, pen_zrelu), 2 full (those plus pen_path, pen_ang; reads
// ref_z (S+1), lo, hi (S) and angle_thr), 3 opl (opl_out; reads n_legs
// ((S+1) x W)). Pointers a mode does not use may be null.
int k3_fwd_launch(const float* xp, const float* yp, const float* cy,
                  const float* z0, const float* c, const float* kappa,
                  const float* t, const float* mu, const float* asph,
                  const float* ref_z, const float* lo, const float* hi,
                  const float* n_legs, float angle_thr, int n, int n_surf, int n_w,
                  int n_asph, int n_per_w, int n_iter, int mode, int allow_backward,
                  float* x_out, float* y_out, float* cx_out, float* cy_out,
                  bool* ok_out, bool* bw_out, float* pen_theta,
                  float* pen_theta_p, float* pen_zrelu, float* pen_path,
                  float* pen_ang, float* opl_out, void* stream) {
  if (bad_shape_a(n_surf, n_w, n_asph, n_per_w, n, n_iter, mode))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* const in[13] = {xp, yp, cy, z0, c, kappa, t, mu, asph, ref_z, lo, hi, n_legs};
  float* const outs[4] = {x_out, y_out, cx_out, cy_out};
  float* const pens[6] = {pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl_out};
#define K3_FWD_LAUNCH(M, AB)                                                     \
  launch<M, AB>(in, angle_thr, n, n_surf, n_w, n_asph, n_per_w, n_iter, outs, \
                ok_out, bw_out, pens, s)
  if (mode == 0) {
    if (allow_backward) K3_FWD_LAUNCH(0, true); else K3_FWD_LAUNCH(0, false);
  } else if (mode == 1) {
    if (allow_backward) K3_FWD_LAUNCH(1, true); else K3_FWD_LAUNCH(1, false);
  } else if (mode == 2) {
    if (allow_backward) K3_FWD_LAUNCH(2, true); else K3_FWD_LAUNCH(2, false);
  } else {
    if (allow_backward) K3_FWD_LAUNCH(3, true); else K3_FWD_LAUNCH(3, false);
  }
#undef K3_FWD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
