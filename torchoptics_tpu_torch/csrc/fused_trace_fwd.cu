// K1 forward: fused spherical ray trace of one lens system on a flat ray block.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// torchoptics_tpu/ops/pallas_trace.py (plain, Lu, full and opl modes). The plain
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
// gap runs to ref_z[S]. Opl mode adds one per-ray sum, the optical path
// length: each leg's marching distance times the index of its medium, read
// from an (S+1) x W table (air first), the leg of surface k counted before a
// backward ray is removed and the final leg to the image plane last
// (pallas_trace.py trace_fused_opl). Finally the transfer to the image plane
// and the last backward test.
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
// sequences, which that count takes as one operation each. Opl mode adds 2
// operations per leg (a product and a sum) and writes 22 B per ray; its table
// is (S+1) W floats, read once per block.
//
// Design: one thread per ray, the per-surface tables c, t and mu read once
// per block into shared memory, z0 read from device memory (the host never
// synchronizes), the mode and the backward-ray policy as template
// parameters, the ragged tail masked by i < n. Ray i has wavelength
// min(i / n_per_w, W - 1): the wavelength-outer flat order of the
// front-end. The per-ray trace itself (trace_ray) and the surface math live
// in trace_common.cuh, shared with the population kernel K2
// (fused_batch_fwd.cu). The surface counts of the port's single-system
// paths (SHORT_SURF: 7, the Cooke triplet's; 11, the double-Gauss's) have
// kernels of their own, the count fixed at compile time (trace_ray's NS):
// the surface loop unrolls, the tables are read at immediate offsets and the
// loop's own instructions go. Any other count (up to MAX_SURF) runs the
// runtime-S kernel. In Lu and full mode the two theta_norm a surface take
// the square roots of cos2 and cos2' that the surface step took
// (theta_norm_root): two IEEE square roots a surface fewer, bit for bit;
// and their divisions by pi / 2 are a product and two FMAs (div_half_pi),
// equal to the IEEE division on every float32 that acosf can return. The
// surface step's three roots take the IEEE square root's fast path without
// its range check and branch (sqrt_from_eps), which the masks make exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC. No --use_fast_math: the masks compare
// against EPS and approximate sqrt/division would move them. No FMA
// contraction either: the plain PyTorch version rounds every product and sum
// separately, and a contracted kernel flips masks on lanes at a threshold of
// the c x 3 double-Gauss; uncontracted, the two agree bit for bit in plain
// mode. The registers, stack and spills of each instantiation are in the
// build's -Xptxas -v report (PERF.md, section 6).

#include "trace_common.cuh"

namespace {

// The surface counts with a kernel of their own (NS).
constexpr int SHORT_SURF[] = {7, 11};

// MODE: 0 plain, 1 Lu, 2 full, 3 opl. NS: the surface count, or 0 for any.
template <int MODE, bool ALLOW_BACKWARD, int NS>
__global__ void __launch_bounds__(BLOCK) k1_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ yp,
    const float* __restrict__ cy_in, const float* __restrict__ z0,
    const float* __restrict__ c, const float* __restrict__ t,
    const float* __restrict__ mu, const float* __restrict__ ref_z,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ n_legs, float angle_thr,
    int n, int n_surf, int n_w, int n_per_w,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ cx_out, float* __restrict__ cy_out,
    bool* __restrict__ ok_out, bool* __restrict__ bw_out,
    float* __restrict__ pen_theta, float* __restrict__ pen_theta_p,
    float* __restrict__ pen_zrelu, float* __restrict__ pen_path_out,
    float* __restrict__ pen_ang_out, float* __restrict__ opl_out) {
  __shared__ Tables<MODE> tab;
  tab.load(c, t, mu, ref_z, lo, hi, n_legs, nullptr, n_surf, n_w);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int w = min(i / n_per_w, n_w - 1);
  const RayOut r = trace_ray<MODE, ALLOW_BACKWARD, false, NS>(tab, n_surf, n_w, w, angle_thr,
                                                              xp[i], yp[i], cy_in[i], *z0);
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

// One launch's arguments, as k1_fwd_launch takes them.
struct Args {
  const float* const* in;  // xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs
  float angle_thr;
  int n, n_surf, n_w, n_per_w;
  float* const* outs;      // x, y, cx, cy
  bool* ok_out;
  bool* bw_out;
  float* const* pens;      // pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl
  cudaStream_t stream;
};

template <int MODE, bool ALLOW_BACKWARD, int NS>
void launch(const Args& a) {
  const int grid = (a.n + BLOCK - 1) / BLOCK;
  const float* const* in = a.in;
  k1_fwd_kernel<MODE, ALLOW_BACKWARD, NS><<<grid, BLOCK, 0, a.stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
      a.angle_thr, a.n, a.n_surf, a.n_w, a.n_per_w, a.outs[0], a.outs[1], a.outs[2],
      a.outs[3], a.ok_out, a.bw_out, a.pens[0], a.pens[1], a.pens[2], a.pens[3], a.pens[4],
      a.pens[5]);
}

template <int MODE, bool ALLOW_BACKWARD>
void launch_surf(const Args& a) {
  switch (a.n_surf) {
    case 7:
      return launch<MODE, ALLOW_BACKWARD, 7>(a);
    case 11:
      return launch<MODE, ALLOW_BACKWARD, 11>(a);
    default:
      return launch<MODE, ALLOW_BACKWARD, 0>(a);
  }
}

// The exhaustive checks of div_half_pi and sqrt_from_eps against the IEEE
// division and square root: mismatches[0] counts the float32 x in
// [2^-100, 4) (bit patterns 0x0d800000 .. 0x407fffff) where div_half_pi(x)
// and x / HALF_PI differ in any bit; mismatches[1] those from 2^-100 to +inf
// (0x0d800000 .. 0x7f800000) where sqrt_from_eps(x) and sqrtf(x) differ in
// any bit, and the NaN (0x7f800001 .. 0x7fffffff) where either is no NaN.
__global__ void exact_checks_kernel(unsigned long long* mismatches) {
  constexpr unsigned START = 0x0d800000u, DIV_END = 0x40800000u, INF = 0x7f800000u;
  unsigned long long bad_div = 0, bad_sqrt = 0;
  for (unsigned b = START + blockIdx.x * blockDim.x + threadIdx.x; b <= 0x7fffffffu;
       b += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(b);
    if (b < DIV_END) bad_div += __float_as_uint(div_half_pi(x)) != __float_as_uint(x / HALF_PI);
    const float r = sqrt_from_eps(x), want = sqrtf(x);
    bad_sqrt += b <= INF ? __float_as_uint(r) != __float_as_uint(want) : !(r != r && want != want);
  }
  if (bad_div) atomicAdd(mismatches, bad_div);
  if (bad_sqrt) atomicAdd(mismatches + 1, bad_sqrt);
}

}  // namespace

extern "C" {

int k1_max_surf() { return MAX_SURF; }

int k1_max_w() { return MAX_W; }

// 1 where n_surf has a forward kernel of its own, 0 where it takes the
// runtime-S one.
int k1_fwd_specialized(int n_surf) {
  for (int k : SHORT_SURF)
    if (k == n_surf) return 1;
  return 0;
}

// The exhaustive checks of div_half_pi and sqrt_from_eps (exact_checks_kernel):
// adds their mismatch counts to mismatches[0] and mismatches[1] (device
// memory, zeroed by the caller).
int k1_exact_checks(unsigned long long* mismatches, void* stream) {
  exact_checks_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(mismatches);
  return (int)cudaGetLastError();
}

// Launches K1 forward on `stream` and returns cudaGetLastError() (0 on
// success). mode: 0 plain, 1 Lu (pen_theta, pen_theta_p, pen_zrelu), 2 full
// (those plus pen_path, pen_ang; reads ref_z (S+1), lo, hi (S) and
// angle_thr), 3 opl (opl_out; reads n_legs ((S+1) x W)). Pointers a mode
// does not use may be null.
int k1_fwd_launch(const float* xp, const float* yp, const float* cy,
                  const float* z0, const float* c, const float* t,
                  const float* mu, const float* ref_z, const float* lo,
                  const float* hi, const float* n_legs, float angle_thr, int n,
                  int n_surf, int n_w, int n_per_w, int mode, int allow_backward,
                  float* x_out, float* y_out, float* cx_out, float* cy_out,
                  bool* ok_out, bool* bw_out, float* pen_theta, float* pen_theta_p,
                  float* pen_zrelu, float* pen_path, float* pen_ang, float* opl_out,
                  void* stream) {
  if (bad_shape(n_surf, n_w, n_per_w, n, mode)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* const in[11] = {xp, yp, cy, z0, c, t, mu, ref_z, lo, hi, n_legs};
  float* const outs[4] = {x_out, y_out, cx_out, cy_out};
  float* const pens[6] = {pen_theta, pen_theta_p, pen_zrelu, pen_path, pen_ang, opl_out};
  const Args a{in, angle_thr, n, n_surf, n_w, n_per_w, outs, ok_out, bw_out, pens,
               (cudaStream_t)stream};
  if (mode == 0) {
    if (allow_backward) launch_surf<0, true>(a); else launch_surf<0, false>(a);
  } else if (mode == 1) {
    if (allow_backward) launch_surf<1, true>(a); else launch_surf<1, false>(a);
  } else if (mode == 2) {
    if (allow_backward) launch_surf<2, true>(a); else launch_surf<2, false>(a);
  } else {
    if (allow_backward) launch_surf<3, true>(a); else launch_surf<3, false>(a);
  }
  return (int)cudaGetLastError();
}

const char* k1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
