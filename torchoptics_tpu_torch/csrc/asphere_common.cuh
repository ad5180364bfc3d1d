// Device math of the fused conic/asphere trace: K3 (one system,
// fused_asphere_fwd.cu / fused_asphere_bwd.cu) and K4 (a population of
// systems, fused_asphere_batch_fwd.cu / fused_asphere_batch_bwd.cu), which
// supplies only its indexing, as K2 does over trace_common.cuh.
//
// One copy of: the asphere tables in shared memory (with the constants that
// every sag evaluation of a surface shares, formed once per block), the sag
// and its slope, their closed-form partials (with shared reciprocals), the
// Newton solve (the sphere guess, then up to n_iter steps: a lane leaves
// once its steps repeat, with the bits of all n_iter), the rest of a surface
// step from the pre-polish Newton point (the polish step, the failure masks,
// Snell's law with the true normal) and its adjoint, the per-ray forward
// trace and the per-ray backward pass. From
// trace_common.cuh it takes theta_norm (theta_norm_root) and its adjoint,
// the path hinge and its gradient, the block's parameter sums (BlockSums),
// the block's column of the partial sums and their fixed-order reductions,
// and the exact shortcuts sqrt_from_eps and div_half_pi.
//
// The surface math is pallas_asphere.py's (_sag_terms, _g_partials,
// _newton_dist, _fwd_surface_a, _bwd_surface_a), with u = (1+k)c^2 r^2 and
// w = sqrt(1 - u):
//   sag = c r^2/(1+w) + sum_j a_j (r^2)^(j+2),  g = dsag/dr^2 = c/(2w) + ...
// Integer powers of r^2 are chains of products, p_{j+1} = p_j r^2, and
// rsqrt is 1/sqrtf, the same as in the plain PyTorch versions
// (ops/fused_asphere.py); every product and sum is written out in their
// order, and the kernels are built with -fmad=false and no fast-math, so the
// masks (the sag-domain guard 1 - u < EPS, the convergence test
// |F| > NEWTON_TOL among them), the coordinates and the per-ray cotangents
// agree with them bit for bit.
//
// What bounds K3 and K4 on an H100 is the FP32 issue rate: the sag's square
// root and divisions at every Newton step (a sqrt issues as ~13 FMAs, a
// division as ~17.5: PERF.md, P1). So the design takes out what repeats:
// Newton steps past the point where they repeat, the surface constants at
// every evaluation, runtime loops over the asphere terms (Surf<NA>: K3 and
// K4 are instantiated per term count, the terms in registers) and, in the
// adjoint, divisions by one denominator. The surface step's seven square
// roots (the sag's w at every evaluation, the sphere guess, the two
// normals, Snell's three) take sqrtf's fast path without its range check
// (sqrt_from_eps), each argued beside it to lie in the domain where the two
// are equal; the forward's Lu sums reuse the roots of cos2 and cos2'
// (theta_norm_root). The launch's sqrtf(1 - cy^2) stays IEEE: its argument
// has no such bound. Values the plain version forms twice are formed once,
// with the same bits: the polish step's F and F' (newton_point hands them
// on) and, in the forward, the Snell point's slope and normal
// (surface_finish<false>).
//
// MASKED switches on the surface mask of padded populations, with the
// semantics of trace_common.cuh: the backward-ray test at surface k gated by
// mask[k-1] and the last one by mask[S-1], the Lu sums and the angle hinge
// and their cotangents by mask[k]; padded surfaces are traced. With MASKED
// false the arithmetic is K3's.

#pragma once

#include <type_traits>

#include "trace_common.cuh"

namespace {

constexpr int MAX_ASPH = 8;
constexpr float NEWTON_TOL = 1e-5f;

// One system's surface tables, read once per block into shared memory, with
// the constants that every sag evaluation of a surface shares, built there
// once: beta = (1+kappa) c^2, c beta, c^3 and, per asphere term, a_j (j+2)
// and a_j (j+2)(j+1). Each is the product that the plain version forms
// first, left to right, at each evaluation, so it has the same bits.
template <int MODE>
struct AsphTables {
  static constexpr bool FULL = MODE == 2;
  static constexpr bool OPL = MODE == 3;
  float c[MAX_SURF];
  float beta[MAX_SURF];
  float cbeta[MAX_SURF];
  float c3[MAX_SURF];
  float t[MAX_SURF];
  float mu[MAX_SURF * MAX_W];
  float a[MAX_SURF * MAX_ASPH];    // surface k's coefficients at a + k * n_asph
  float a2[MAX_SURF * MAX_ASPH];   // a_j (j+2), the same layout
  float a21[MAX_SURF * MAX_ASPH];  // a_j (j+2)(j+1)
  float ref[FULL ? MAX_SURF + 1 : 1];
  float lo[FULL ? MAX_SURF : 1];
  float hi[FULL ? MAX_SURF : 1];
  float nl[OPL ? (MAX_SURF + 1) * MAX_W : 1];  // n_legs, (S+1) x W row-major
  bool mask[MAX_SURF];

  // All threads of the block call it; the caller synchronizes after it.
  // ref_z (S+1), the bounds lo, hi (S), n_legs ((S+1) x W) and the mask (S)
  // may be null where the mode or the population does not use them.
  __device__ void load(const float* c_, const float* kappa_, const float* t_,
                       const float* mu_, const float* a_, const float* ref_,
                       const float* lo_, const float* hi_, const float* nl_,
                       const bool* mask_, int n_surf, int n_w, int n_asph) {
    for (int j = threadIdx.x; j < n_surf; j += blockDim.x) {
      const float ck = c_[j];
      c[j] = ck;
      beta[j] = (1.0f + kappa_[j]) * ck * ck;
      cbeta[j] = ck * beta[j];
      c3[j] = ck * ck * ck;
      t[j] = t_[j];
      if (mask_) mask[j] = mask_[j];
      if (FULL) {
        lo[j] = lo_[j];
        hi[j] = hi_[j];
      }
    }
    if (FULL)
      for (int j = threadIdx.x; j <= n_surf; j += blockDim.x) ref[j] = ref_[j];
    if (OPL)
      for (int j = threadIdx.x; j < (n_surf + 1) * n_w; j += blockDim.x) nl[j] = nl_[j];
    for (int j = threadIdx.x; j < n_surf * n_w; j += blockDim.x) mu[j] = mu_[j];
    for (int j = threadIdx.x; j < n_surf * n_asph; j += blockDim.x) {
      const int term = j % n_asph;
      a[j] = a_[j];
      a2[j] = a_[j] * (float)(term + 2);
      a21[j] = a2[j] * (float)(term + 1);
    }
  }
};

// One surface's parameters and constants as a thread holds them, with its
// NA asphere terms copied into registers once a surface; the loops over
// them are unrolled.
template <int NA>
struct Surf {
  float c, beta, cbeta, c3, t, mu;
  float a[NA], a2[NA], a21[NA];
};

// sag, g = dsag/dr^2, w, u and the domain guard at r^2.
struct Sag {
  float sag, g, w, u;
  bool guard;
};

template <int NA>
__device__ __forceinline__ Sag sag_terms(const Surf<NA>& p, float r2) {
  Sag q;
  q.u = p.beta * r2;
  q.guard = 1.0f - q.u < EPS;
  // sqrt_from_eps's domain: where the guard holds the argument is 1; where it
  // does not, the same float32 1 - u is no less than EPS (a difference that
  // rounds below EPS was below it) or is +inf or NaN.
  q.w = sqrt_from_eps(q.guard ? 1.0f : 1.0f - q.u);
  q.sag = p.c * r2 / (1.0f + q.w);
  q.g = p.c / (2.0f * q.w);
  float pw = r2;  // (r^2)^(j+1)
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const float pw2 = pw * r2;  // (r^2)^(j+2)
    q.sag = q.sag + p.a[j] * pw2;
    q.g = q.g + p.a2[j] * pw;
    pw = pw2;
  }
  return q;
}

// h = dg/dr^2 and the partials of g and the sag in c and kappa at r^2; the
// partials in a_j are powers of r^2. The terms that divide by powers of w
// and of 1 + w share one reciprocal of each (two divisions where the
// quotients took seven; at the hit and Snell points, where the sag's
// partials are read by nothing, one).
struct GPart {
  float h, g_c, g_kap, sag_c, sag_kap;
};

template <int NA>
__device__ __forceinline__ GPart g_partials(const Surf<NA>& p, float r2, float w, float u) {
  GPart q;
  const float iw = 1.0f / w;
  const float iw3 = iw * iw * iw;
  const float q4 = 0.25f * iw3;  // 1/(4 w^3)
  q.h = p.cbeta * q4;
  q.g_c = 0.5f * iw + u * (0.5f * iw3);
  q.g_kap = p.c3 * r2 * q4;
  const float iopw = 1.0f / (1.0f + w);
  const float iw_opw2 = iw * iopw * iopw;  // 1/(w (1+w)^2)
  q.sag_c = r2 * iopw + u * r2 * iw_opw2;
  q.sag_kap = p.c3 * r2 * r2 * (0.5f * iw_opw2);
  float pw = r2;  // (r^2)^j for j >= 1
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    if (j == 0) {
      q.h = q.h + p.a21[j];
    } else {
      q.h = q.h + p.a21[j] * pw;
      pw = pw * r2;
    }
  }
  return q;
}

// F(s) = z(s) - sag(r^2(s)), F'(s) and the domain guard at s.
template <int NA>
__device__ __forceinline__ void f_fp(const Surf<NA>& p, float x, float y, float z, float cx,
                                     float cy, float cz, float s, float& f, float& fp,
                                     bool& guard) {
  const float xs = x + s * cx;
  const float ys = y + s * cy;
  const float r2 = xs * xs + ys * ys;
  const Sag q = sag_terms(p, r2);
  f = (z + s * cz) - q.sag;
  fp = cz - 2.0f * q.g * (xs * cx + ys * cy);
  guard = q.guard;
}

// The pre-polish Newton point: the closed-form sphere guess (the vertex
// plane where it misses), then n_iter Newton steps, left as soon as the
// steps repeat. A step is a function of s alone (the ray and the surface
// fixed, every operation correctly rounded: no contraction, no fast-math),
// so once s_{i+1} equals s_i bit for bit every later step returns s_i, and
// once it equals s_{i-1} the steps alternate between s_i and s_{i+1}: the
// n_iter-th is s_{i+1} when n_iter - i - 1 is even, else s_i. Either exit
// returns the bits of all n_iter steps (the plain version runs them all).
// A lane leaves on its own; its warp runs until its last lane has left.
// Where a lane leaves, the loop has evaluated F, F' and the guard at the
// point it returns (s_i, or s_{i+1} = s_{i-1} on a 2-cycle: the step
// before's), and the polish step that follows (surface_finish) takes them
// instead of evaluating them again: the same function of the same bits, so
// the same bits. Only a lane that runs all n_iter steps without a repeat
// leaves them to surface_finish.
struct NewtonPoint {
  float s, f, fp;
  bool guard, have;  // have: f, fp and guard are those at s
};

template <int NA>
__device__ __forceinline__ NewtonPoint newton_point(const Surf<NA>& p, float x, float y,
                                                    float z, float cx, float cy, float cz,
                                                    int n_iter) {
  const float e = -(x * cx + y * cy + z * cz);
  const float mz = z + e * cz;
  const float m2 = x * x + y * y + z * z - e * e;
  const float temp = p.c * m2 - 2.0f * mz;
  const float cos2_s = cz * cz - p.c * temp;
  const bool fail_s = cos2_s - EPS < 0.0f;
  // The sphere's near root, or where the sphere is missed the vertex plane
  // (0 where cz is below EPS): a branch, so that a warp none of whose lanes
  // misses skips the plane's division, and one all of whose lanes miss the
  // root's square root and division.
  NewtonPoint np{0.0f, 0.0f, 0.0f, false, false};
  if (fail_s) {
    np.s = fabsf(cz) > EPS ? -z / cz : 0.0f;
  } else {
    // sqrt_from_eps's domain: cos2_s >= EPS (cos2_s - EPS rounds to a
    // negative number wherever cos2_s < EPS), +inf or NaN.
    np.s = e + temp / (cz + sqrt_from_eps(cos2_s));
  }
  float s_prev = np.s, f_prev = 0.0f, fp_prev = 0.0f;  // and F, F', the guard there
  bool guard_prev = false;
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
    float f, fp;
    bool guard;
    f_fp(p, x, y, z, cx, cy, cz, np.s, f, fp, guard);
    const float fp_s = fabsf(fp) > EPS ? fp : (fp >= 0.0f ? EPS : -EPS);
    const float s_next = np.s - f / fp_s;
    const unsigned bits = __float_as_uint(s_next);
    if (bits == __float_as_uint(np.s)) {
      np = NewtonPoint{np.s, f, fp, guard, true};
      break;
    }
    if (i > 0 && bits == __float_as_uint(s_prev)) {
      np = (n_iter - i) & 1 ? NewtonPoint{s_next, f_prev, fp_prev, guard_prev, true}
                            : NewtonPoint{np.s, f, fp, guard, true};
      break;
    }
    s_prev = np.s;
    f_prev = f;
    fp_prev = fp;
    guard_prev = guard;
    np.s = s_next;
  }
  return np;
}

// The locals of one surface step that its adjoint reads.
struct LocalsA {
  float f, fp_safe, dist, delta_z, xs, ys, r2, g, w, u, inv_norm, dots, cosr, cos2, cs;
  float xB, yB, cxB, cyB, r2B, gB, wB, uB, inv_normB, cos2p, csp, gsn, nx, ny;
  float cxC, cyC, czC;
  bool stationary, fail1, ok1, fail2a, fail2;
};

// The rest of one surface step from the pre-polish point np.s
// (pallas_asphere._fwd_surface_a): the polish step, the failure masks, the
// hit point, Snell's law with the true normal and the zeroing of failed
// lanes; advances the state in place. F, F' and the guard at np.s are
// np's where it has them (np.have), else evaluated here.
//
// ADJOINT: every local as the plain version forms it, for the adjoint
// (surface_adjoint) to read. Without it, the Snell point's slope, w, u and
// normal are the hit point's: on a live lane (ok1) the Snell point is the
// hit point (xB = xs, yB = ys, so r2B has r2's bits and so has every value
// formed from it), and on a dead one they feed only nx, ny, cxC, cyC, czC
// and fail2, which the zeroed state and ok2 = false then discard. So the
// advanced state, ok and the locals the forward trace reads (dist,
// delta_z, ok1, cos2, cs, cos2p, csp) keep their bits, one sag evaluation
// and one normal a surface fewer.
template <bool ADJOINT, int NA>
__device__ __forceinline__ void surface_finish(const Surf<NA>& p, const NewtonPoint& np,
                                               float& x, float& y, float& z, float& cx,
                                               float& cy, float& cz, bool& ok, LocalsA& L) {
  const float s_pre = np.s;
  float fp = np.fp;
  bool guard_pre = np.guard;
  L.f = np.f;
  if (!np.have) f_fp(p, x, y, z, cx, cy, cz, s_pre, L.f, fp, guard_pre);
  L.stationary = fabsf(fp) < EPS;
  L.fp_safe = L.stationary ? 1.0f : fp;
  L.dist = s_pre - L.f / L.fp_safe;
  const bool not_conv = fabsf(L.f) > NEWTON_TOL;

  L.xs = x + L.dist * cx;
  L.ys = y + L.dist * cy;
  L.delta_z = L.dist * cz;
  const float zA = z + L.delta_z;
  L.r2 = L.xs * L.xs + L.ys * L.ys;
  const Sag hit = sag_terms(p, L.r2);
  L.g = hit.g;
  L.w = hit.w;
  L.u = hit.u;
  // sqrt_from_eps's domain: r2 = xs^2 + ys^2 and ((4 r2) g) g are zero or
  // positive (a product's sign is exact), so 1 + 4 r2 g^2 is at least 1, or
  // +inf or NaN.
  L.inv_norm = 1.0f / sqrt_from_eps(1.0f + 4.0f * L.r2 * L.g * L.g);
  L.dots = L.xs * cx + L.ys * cy;
  L.cosr = (cz - 2.0f * L.g * L.dots) * L.inv_norm;
  L.cos2 = L.cosr * L.cosr;
  L.fail1 = guard_pre || hit.guard || L.stationary || not_conv || (L.cos2 - EPS < 0.0f);
  // sqrt_from_eps's domain: 1 where fail1 holds, else cos2 >= EPS (as
  // newton_point's cos2_s), +inf or NaN; so cs is sqrtf(cos2) wherever fail1
  // does not hold, which theta_norm_root reads.
  L.cs = sqrt_from_eps(L.fail1 ? 1.0f : L.cos2);

  L.ok1 = ok && !L.fail1;
  L.xB = L.ok1 ? L.xs : 0.0f;
  L.yB = L.ok1 ? L.ys : 0.0f;
  const float zB = L.ok1 ? zA : 0.0f;
  L.cxB = L.ok1 ? cx : 0.0f;
  L.cyB = L.ok1 ? cy : 0.0f;

  if (ADJOINT) {
    L.r2B = L.xB * L.xB + L.yB * L.yB;
    const Sag snell = sag_terms(p, L.r2B);
    L.gB = snell.g;
    L.wB = snell.w;
    L.uB = snell.u;
    // At least 1, +inf or NaN, as inv_norm's argument.
    L.inv_normB = 1.0f / sqrt_from_eps(1.0f + 4.0f * L.r2B * L.gB * L.gB);
  } else {
    L.r2B = L.r2;
    L.gB = L.g;
    L.wB = L.w;
    L.uB = L.u;
    L.inv_normB = L.inv_norm;
  }
  const float muk = p.mu;
  L.cos2p = 1.0f - muk * muk * (1.0f - L.cs * L.cs);
  L.fail2a = L.cos2p - EPS < 0.0f;
  // 1 where fail2a holds, else cos2p >= EPS, +inf or NaN, as cs's argument.
  L.csp = sqrt_from_eps(L.fail2a ? 1.0f : L.cos2p);
  L.gsn = L.csp - muk * L.cs;
  L.nx = 2.0f * L.xB * L.gB * L.inv_normB;
  L.ny = 2.0f * L.yB * L.gB * L.inv_normB;
  L.cxC = muk * L.cxB - L.gsn * L.nx;
  L.cyC = muk * L.cyB - L.gsn * L.ny;
  const float cz2 = 1.0f - (L.cxC * L.cxC + L.cyC * L.cyC);
  L.fail2 = L.fail2a || (cz2 - EPS < 0.0f);
  // 1 where fail2 holds, else cz2 >= EPS, +inf or NaN, as cs's argument.
  L.czC = sqrt_from_eps(L.fail2 ? 1.0f : cz2);

  const bool ok2 = L.ok1 && !L.fail2;
  x = ok2 ? L.xB : 0.0f;
  y = ok2 ? L.yB : 0.0f;
  z = (ok2 ? zB : 0.0f) - p.t;
  cx = ok2 ? L.cxC : 0.0f;
  cy = ok2 ? L.cyC : 0.0f;
  cz = ok2 ? L.czC : 1.0f;
  ok = ok2;
}

// The parameter terms of one ray at one surface; the a_j terms are built
// from dgB, dg, dsag, dgp and the three radii by the caller.
struct SurfGrad {
  float dc, dkap, dt, dmu;
  float dgB, dg, dsag, dgp, r2p;
};

// The adjoint of one surface step (pallas_asphere._bwd_surface_a) through
// the polish step, with the Newton point s_pre held constant. (px .. pcz) is
// the pre-surface state; (dx .. dcz) the post-surface cotangents on entry
// and the pre-surface ones on return. dcos2_extra and dcos2p_extra inject
// the penalty cotangents on the raw cos^2 locals where LU is set, and
// ddist_extra the OPL cotangent on the marching distance where OPL is set.
template <bool LU, bool OPL, int NA>
__device__ __forceinline__ SurfGrad surface_adjoint(const Surf<NA>& p, float s_pre, float px,
                                                    float py, float pcx, float pcy, float pcz,
                                                    const LocalsA& L, float dcos2_extra,
                                                    float dcos2p_extra, float ddist_extra,
                                                    float& dx, float& dy, float& dz,
                                                    float& dcx, float& dcy, float& dcz) {
  SurfGrad r;
  const float muk = p.mu;
  const bool ok2 = L.ok1 && !L.fail2;
  r.dt = -dz;
  // reset2 and the cz renormalization
  const float dczC = ok2 ? dcz : 0.0f;
  const float dcz2 = L.fail2 ? 0.0f : dczC / (2.0f * L.czC);
  const float dcxC = (ok2 ? dcx : 0.0f) - 2.0f * L.cxC * dcz2;
  const float dcyC = (ok2 ? dcy : 0.0f) - 2.0f * L.cyC * dcz2;
  // Snell: cxC = mu cxB - gsn nx
  float dxB = ok2 ? dx : 0.0f;
  float dyB = ok2 ? dy : 0.0f;
  const float dzB = ok2 ? dz : 0.0f;
  const float dcxB = muk * dcxC;
  const float dcyB = muk * dcyC;
  r.dmu = dcxC * L.cxB + dcyC * L.cyB;
  const float dgsn = -(dcxC * L.nx + dcyC * L.ny);
  const float dnx = -dcxC * L.gsn;
  const float dny = -dcyC * L.gsn;
  // nx = 2 xB gB inv_normB, inv_normB = 1/sqrt(1 + 4 r2B gB^2)
  dxB = dxB + dnx * 2.0f * L.gB * L.inv_normB;
  dyB = dyB + dny * 2.0f * L.gB * L.inv_normB;
  r.dgB = (dnx * L.xB + dny * L.yB) * 2.0f * L.inv_normB;
  const float dinv_normB = (dnx * L.xB + dny * L.yB) * 2.0f * L.gB;
  const float dnorm2B = dinv_normB * (-0.5f) * (L.inv_normB * L.inv_normB * L.inv_normB);
  float dr2B = dnorm2B * 4.0f * L.gB * L.gB;
  r.dgB = r.dgB + dnorm2B * 8.0f * L.r2B * L.gB;
  // gsn = cosp - mu cos
  const float dcosp = dgsn;
  r.dmu = r.dmu - dgsn * L.cs;
  float dcos = -dgsn * muk;
  float dcos2p = L.fail2a ? 0.0f : dcosp / (2.0f * L.csp);
  if (LU) dcos2p = dcos2p + dcos2p_extra;
  r.dmu = r.dmu + dcos2p * (-2.0f * muk * (1.0f - L.cs * L.cs));
  dcos = dcos + dcos2p * (2.0f * muk * muk * L.cs);
  // gB(r2B; c, kappa, a)
  const GPart qB = g_partials(p, L.r2B, L.wB, L.uB);
  r.dc = r.dgB * qB.g_c;
  r.dkap = r.dgB * qB.g_kap;
  dr2B = dr2B + r.dgB * qB.h;
  dxB = dxB + 2.0f * L.xB * dr2B;
  dyB = dyB + 2.0f * L.yB * dr2B;

  // reset1 (czB is dead: Snell renormalizes cz)
  float dxs = L.ok1 ? dxB : 0.0f;
  float dys = L.ok1 ? dyB : 0.0f;
  const float dzA = L.ok1 ? dzB : 0.0f;
  dcx = L.ok1 ? dcxB : 0.0f;
  dcy = L.ok1 ? dcyB : 0.0f;

  // cos = sqrt(cos2), cos2 = cosr^2, cosr = (cz - 2 g dots) inv_norm
  float dcos2 = L.fail1 ? 0.0f : dcos / (2.0f * L.cs);
  if (LU) dcos2 = dcos2 + dcos2_extra;
  const float dcosr = 2.0f * L.cosr * dcos2;
  const float dFsv = dcosr * L.inv_norm;
  const float dinv_norm = dcosr * (pcz - 2.0f * L.g * L.dots);
  const float dnorm2 = dinv_norm * (-0.5f) * (L.inv_norm * L.inv_norm * L.inv_norm);
  float dr2 = dnorm2 * 4.0f * L.g * L.g;
  r.dg = dnorm2 * 8.0f * L.r2 * L.g;
  dcz = dFsv;
  r.dg = r.dg - dFsv * 2.0f * L.dots;
  const float ddots = -dFsv * 2.0f * L.g;
  dxs = dxs + ddots * pcx;
  dcx = dcx + ddots * L.xs;
  dys = dys + ddots * pcy;
  dcy = dcy + ddots * L.ys;
  // g(r2; c, kappa, a) at the hit point
  const GPart qh = g_partials(p, L.r2, L.w, L.u);
  r.dc = r.dc + r.dg * qh.g_c;
  r.dkap = r.dkap + r.dg * qh.g_kap;
  dr2 = dr2 + r.dg * qh.h;
  dxs = dxs + 2.0f * L.xs * dr2;
  dys = dys + 2.0f * L.ys * dr2;

  // xs = x + dist cx, zA = z + dist cz
  float ddist = dxs * pcx + dys * pcy + dzA * pcz;
  if (OPL) ddist = ddist + ddist_extra;
  dx = dxs;
  dy = dys;
  dz = dzA;
  dcx = dcx + dxs * L.dist;
  dcy = dcy + dys * L.dist;
  dcz = dcz + dzA * L.dist;

  // polish: dist = s_pre - f/fp_safe, s_pre constant
  const float ifp = 1.0f / L.fp_safe;
  const float df = -ddist * ifp;
  const float dfp = L.stationary ? 0.0f : ddist * L.f * (ifp * ifp);
  // f and fp were evaluated at s_pre: that point's locals.
  const float xsp = px + s_pre * pcx;
  const float ysp = py + s_pre * pcy;
  r.r2p = xsp * xsp + ysp * ysp;
  const Sag qp = sag_terms(p, r.r2p);
  const GPart gp = g_partials(p, r.r2p, qp.w, qp.u);
  const float dotsp = xsp * pcx + ysp * pcy;
  // f = (z + s_pre cz) - sag(r2p)
  dz = dz + df;
  dcz = dcz + df * s_pre;
  r.dsag = -df;
  r.dc = r.dc + r.dsag * gp.sag_c;
  r.dkap = r.dkap + r.dsag * gp.sag_kap;
  float dr2p = r.dsag * qp.g;
  // fp = cz - 2 g_p dotsp
  dcz = dcz + dfp;
  r.dgp = -dfp * 2.0f * dotsp;
  const float ddotsp = -dfp * 2.0f * qp.g;
  r.dc = r.dc + r.dgp * gp.g_c;
  r.dkap = r.dkap + r.dgp * gp.g_kap;
  dr2p = dr2p + r.dgp * gp.h;
  const float dxsp = 2.0f * xsp * dr2p + ddotsp * pcx;
  const float dysp = 2.0f * ysp * dr2p + ddotsp * pcy;
  dcx = dcx + ddotsp * xsp;
  dcy = dcy + ddotsp * ysp;
  dx = dx + dxsp;
  dy = dy + dysp;
  dcx = dcx + dxsp * s_pre;
  dcy = dcy + dysp * s_pre;
  return r;
}

// Surface k's parameters and constants for wavelength column w, read once a
// surface from the block's tables.
template <int NA, int MODE>
__device__ __forceinline__ Surf<NA> surf_of(const AsphTables<MODE>& s, int k, int n_w, int w,
                                            int n_asph) {
  Surf<NA> p;
  p.c = s.c[k];
  p.beta = s.beta[k];
  p.cbeta = s.cbeta[k];
  p.c3 = s.c3[k];
  p.t = s.t[k];
  p.mu = s.mu[k * n_w + w];
  const int base = k * n_asph;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    p.a[j] = s.a[base + j];
    p.a2[j] = s.a2[base + j];
    p.a21[j] = s.a21[base + j];
  }
  return p;
}

// The forward trace of one ray of wavelength column w: launch at the
// entrance pupil (xp, yp, cy, z0), every surface with its backward-ray
// bookkeeping (or removal) and the sums of the mode (MODE: 0 plain, 1 Lu,
// 2 full, 3 opl), then the transfer to the image plane
// (pallas_asphere._fwd_kernel_a). NA as Surf's. The Lu sums take
// theta_norm from the roots that surface_finish took (theta_norm_root).
template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NA>
__device__ __forceinline__ RayOut trace_ray_a(const AsphTables<MODE>& s, int n_surf,
                                              int n_w, int n_asph, int n_iter, int w,
                                              float angle_thr, float x, float y, float cy,
                                              float z) {
  constexpr bool LU = lu_mode(MODE);
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  float cx = 0.0f;
  float cz = sqrtf(1.0f - cy * cy);
  bool ok = true;
  bool bw = false;
  float pth = 0.0f, ptp = 0.0f, pz = 0.0f, ppath = 0.0f, pang = 0.0f, opl = 0.0f;
  float z_prev = 0.0f;

  for (int k = 0; k < n_surf; ++k) {
    const Surf<NA> p = surf_of<NA>(s, k, n_w, w, n_asph);
    LocalsA L;
    surface_finish<false>(p, newton_point(p, x, y, z, cx, cy, cz, n_iter), x, y, z, cx, cy, cz,
                          ok, L);
    // Leg k travels in the medium before surface k; it counts before a
    // backward ray is removed.
    if (OPL) opl = opl + L.dist * s.nl[k * n_w + w];

    // Backward-ray bookkeeping, skipping the pupil -> first-surface leg and
    // the legs that leave a padded surface.
    if (k > 0 && (!MASKED || s.mask[k - 1])) {
      const bool went_bw = (L.delta_z < 0.0f) && L.ok1;
      if (ALLOW_BACKWARD) {
        bw = bw || went_bw;
      } else if (went_bw) {
        ok = false;
        x = 0.0f;
        y = 0.0f;
        z = -p.t;
        cx = 0.0f;
        cy = 0.0f;
        cz = 1.0f;
      }
    }
    const bool valid = !MASKED || s.mask[k];
    if (LU && valid) {
      // Where ok holds after the surface, neither fail1 nor fail2a fired, so
      // L.cs and L.csp are sqrtf of cos2 and cos2p (surface_finish).
      pth = pth + theta_norm_root(L.cos2, L.cs, ok);
      ptp = ptp + theta_norm_root(L.cos2p, L.csp, ok);
      pz = pz + fmaxf(z, 0.0f);
    }
    if (FULL) {
      if (valid)
        pang = pang + fmaxf(angle_thr - L.cos2, 0.0f) + fmaxf(angle_thr - L.cos2p, 0.0f);
      if (k > 0) {
        const float delta = (z + s.ref[k]) - (z_prev + s.ref[k - 1]);
        ppath = ppath + hinge(delta, s.lo[k - 1], s.hi[k - 1]);
      }
      z_prev = z;
    }
  }
  if (FULL) {
    // The image-plane entry: ref_z[S] repeats the last vertex.
    const float delta = s.ref[n_surf] - (z_prev + s.ref[n_surf - 1]);
    ppath = ppath + hinge(delta, s.lo[n_surf - 1], s.hi[n_surf - 1]);
  }

  // Transfer to the image plane.
  const float delta_z = -z;
  const float dist = delta_z / cz;
  x = x + dist * cx;
  y = y + dist * cy;
  // The final leg, in the image-space medium.
  if (OPL) opl = opl + dist * s.nl[n_surf * n_w + w];
  const bool went_bw = (delta_z < 0.0f) && ok && (!MASKED || s.mask[n_surf - 1]);
  if (ALLOW_BACKWARD) {
    bw = bw || went_bw;
  } else {
    ok = ok && !went_bw;
  }
  return RayOut{x, y, cx, cy, ok, bw, pth, ptp, pz, ppath, pang, opl};
}

// Rows of terms a surface puts into the block's sums in bwd_ray_a: dc,
// dkappa, dt, dmu, the NA asphere terms, and the path hinge (full mode) or
// the leg's dn_legs (opl mode).
__host__ __device__ constexpr int term_slots_a(int mode, int na) {
  return 4 + na + (mode >= 2 ? 1 : 0);
}

// Parameters of one system in the partials and the result:
// [dz0 | dc (S) | dkappa (S) | dt (S) | dmu (S x W) | da (S x K) | dref_z (S+1,
// full mode) or dn_legs ((S+1) x W, opl mode)].
__host__ __device__ __forceinline__ int n_params_a(int mode, int n_surf, int n_w, int n_asph) {
  return 1 + 3 * n_surf + n_surf * n_w + n_surf * n_asph + n_extra_params(mode, n_surf, n_w);
}

// The backward pass of one ray (pallas_asphere._bwd_kernel_a): the forward
// surface by surface, stashing the 6 pre-surface state values, the
// pre-polish Newton point s_pre and one ok bit per surface; the
// image-transfer adjoint; then the surfaces in reverse, each one's locals
// recomputed from its stash by surface_finish (the Newton steps do not run
// again: s_pre is a constant of the adjoint), the penalty cotangents
// injected (in opl mode dopl into each leg's distance adjoint, uncut by a
// kill), the killed lanes cut, and surface_adjoint applied. The per-ray
// cotangents of xp, yp, cy come back in dxp, dyp, dcyp. The parameter terms
// go to the block's sums `bs` as in bwd_ray (trace_common.cuh),
// term_slots_a(MODE, NA) rows a surface, in the layout of n_params_a (and in
// full mode the S path-hinge sums after it). `active` is false on threads
// past the end, which trace a copy of a real ray and put zero terms, so
// that every thread reaches every flush.
template <int MODE, bool ALLOW_BACKWARD, bool MASKED, int NA>
__device__ __forceinline__ void bwd_ray_a(const AsphTables<MODE>& s, int n_surf, int n_w,
                                          int n_asph, int n_iter, float angle_thr, bool active,
                                          int w, float xp, float yp, float cy0, float z0,
                                          const RayCot& in, const BlockSums& bs, float& dxp,
                                          float& dyp, float& dcyp) {
  constexpr bool LU = lu_mode(MODE);
  constexpr bool FULL = MODE == 2;
  constexpr bool OPL = MODE == 3;
  constexpr int SLOTS = term_slots_a(MODE, NA);
  const int off_c = 1, off_kap = 1 + n_surf, off_t = 1 + 2 * n_surf;
  const int off_mu = 1 + 3 * n_surf, off_a = off_mu + n_surf * n_w;
  const int off_ref = off_a + n_surf * n_asph;  // dref_z or dn_legs
  const int off_hinge = off_ref + n_surf + 1;   // full mode: the hinge sums
  auto kills = [&](int k) { return !ALLOW_BACKWARD && k > 0 && (!MASKED || s.mask[k - 1]); };

  // ---- forward, stashing the pre-surface states and Newton points ----
  float st[MAX_SURF][7];
  uint64_t ok_bits = 0;
  float x = xp, y = yp, z = z0, cx = 0.0f, cy = cy0;
  const float cz0 = sqrtf(1.0f - cy0 * cy0);
  float cz = cz0;
  bool ok = true;
  for (int k = 0; k < n_surf; ++k) {
    const Surf<NA> p = surf_of<NA>(s, k, n_w, w, n_asph);
    st[k][0] = x;
    st[k][1] = y;
    st[k][2] = z;
    st[k][3] = cx;
    st[k][4] = cy;
    st[k][5] = cz;
    if (ok) ok_bits |= 1ull << k;
    const NewtonPoint np = newton_point(p, x, y, z, cx, cy, cz, n_iter);
    st[k][6] = np.s;
    LocalsA L;
    surface_finish<false>(p, np, x, y, z, cx, cy, cz, ok, L);
    if (kills(k) && L.delta_z < 0.0f && L.ok1) {
      ok = false;
      x = 0.0f;
      y = 0.0f;
      z = -p.t;
      cx = 0.0f;
      cy = 0.0f;
      cz = 1.0f;
    }
  }
  const float z_end = z;

  // ---- image-transfer adjoint ----
  const float dist_f = -z / cz;
  float dcx = in.dcx + in.dx * dist_f;
  float dcy = in.dcy + in.dy * dist_f;
  float ddist_f = in.dx * cx + in.dy * cy;
  if (OPL) {
    // opl += dist_f * n_S: into the final leg's distance adjoint.
    ddist_f = ddist_f + in.dopl * s.nl[n_surf * n_w + w];
  }
  const float dn_last = OPL ? in.dopl * dist_f : 0.0f;
  float dz = -ddist_f / cz;
  float dcz = ddist_f * (z / (cz * cz));
  float dx = in.dx;
  float dy = in.dy;

  // z after surface m (the stash holds pre-surface states).
  auto zpost = [&](int m) { return m + 1 < n_surf ? st[m + 1][2] : z_end; };
  // dppath * d(hinge_j)/d(delta_j) for path gap j.
  auto hinge_cot = [&](int j) {
    const float delta =
        j == n_surf - 1
            ? s.ref[n_surf] - (zpost(n_surf - 1) + s.ref[n_surf - 1])
            : (zpost(j + 1) + s.ref[j + 1]) - (zpost(j) + s.ref[j]);
    return in.dppath * hinge_grad(delta, s.lo[j], s.hi[j]);
  };

  // ---- reverse surface loop ----
  int pos = 0;  // the surface's place in the current flush group
  for (int k = n_surf - 1; k >= 0; --k) {
    const Surf<NA> p = surf_of<NA>(s, k, n_w, w, n_asph);
    const float px = st[k][0], py = st[k][1];
    const float pcx = st[k][3], pcy = st[k][4], pcz = st[k][5];
    const float s_pre = st[k][6];
    LocalsA L;
    {
      float x1 = px, y1 = py, z1 = st[k][2], cx1 = pcx, cy1 = pcy, cz1 = pcz;
      bool ok1 = (ok_bits >> k) & 1ull;
      surface_finish<true>(p, NewtonPoint{s_pre, 0.0f, 0.0f, false, false}, x1, y1, z1, cx1,
                           cy1, cz1, ok1, L);
    }
    const bool kill = kills(k) && L.delta_z < 0.0f && L.ok1;
    const bool ok2 = L.ok1 && !L.fail2;
    const bool valid = !MASKED || s.mask[k];

    float dcos2_extra = 0.0f, dcos2p_extra = 0.0f, hp = 0.0f;
    if (LU) {
      const bool ok_end = ok2 && !kill;
      // pen_z += relu(z after surface k): into the incoming z adjoint.
      dz = dz + in.dpz * ((zpost(k) > 0.0f && valid) ? 1.0f : 0.0f);
      dcos2_extra = valid ? theta_norm_adjoint(L.cos2, ok_end, in.dpth) : 0.0f;
      dcos2p_extra = valid ? theta_norm_adjoint(L.cos2p, ok_end, in.dptp) : 0.0f;
    }
    if (FULL) {
      // z after surface k enters gap k-1 (+) and gap k (-).
      hp = hinge_cot(k);
      dz = dz - hp;
      if (k > 0) dz = dz + hinge_cot(k - 1);
      dcos2_extra = dcos2_extra - (valid ? in.dpang * (L.cos2 < angle_thr ? 1.0f : 0.0f) : 0.0f);
      dcos2p_extra =
          dcos2p_extra - (valid ? in.dpang * (L.cos2p < angle_thr ? 1.0f : 0.0f) : 0.0f);
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

    // opl += dist_k * n_k, before the kill: not cut by it.
    const float ddist_extra = OPL ? in.dopl * s.nl[k * n_w + w] : 0.0f;
    const SurfGrad r = surface_adjoint<LU, OPL>(p, s_pre, px, py, pcx, pcy, pcz, L, dcos2_extra,
                                                dcos2p_extra, ddist_extra, dx, dy, dz, dcx,
                                                dcy, dcz);

    // ---- this surface's parameter terms, into the block's sums ----
    const int row = pos * SLOTS;
    bs.put(row, active ? r.dc : 0.0f);
    bs.put(row + 1, active ? r.dkap : 0.0f);
    bs.put(row + 2, active ? r.dt + dt_kill : 0.0f);
    bs.put(row + 3, active ? r.dmu : 0.0f);
    // dsag/da_j = (r^2)^(j+2), dg/da_j = (j+2) (r^2)^(j+1), at the Snell
    // point, the hit point and the Newton point, in that order.
    float pB = L.r2B, ph = L.r2, pp = r.r2p;  // (r^2)^(j+1)
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const float f2 = (float)(j + 2);
      const float pp2 = pp * r.r2p;
      const float da = r.dgB * f2 * pB + r.dg * f2 * ph + r.dsag * pp2 + r.dgp * f2 * pp;
      bs.put(row + 4 + j, active ? da : 0.0f);
      pB = pB * L.r2B;
      ph = ph * L.r2;
      pp = pp2;
    }
    if (FULL) bs.put(row + 4 + NA, active ? hp : 0.0f);
    if (OPL) bs.put(row + 4 + NA, active ? in.dopl * L.dist : 0.0f);
    if (pos + 1 == bs.group || k == 0) {
      const int k_top = k + pos;  // the group's first surface
      bs.flush((pos + 1) * SLOTS, [&](int rw, int& base, bool& split) {
        const int slot = rw % SLOTS, kr = k_top - rw / SLOTS;
        split = slot == 3 || (OPL && slot == 4 + NA);
        base = slot == 0        ? off_c + kr
               : slot == 1      ? off_kap + kr
               : slot == 2      ? off_t + kr
               : slot == 3      ? off_mu + kr * n_w
               : slot < 4 + NA  ? off_a + kr * n_asph + (slot - 4)
               : FULL           ? off_hinge + kr
                                : off_ref + kr * n_w;
      });
      pos = 0;
    } else {
      ++pos;
    }
  }

  // ---- launch adjoint: cz0 = sqrt(1 - cy^2), cx0 = 0 (a constant) ----
  dcy = dcy + dcz * (-cy0 / cz0);
  bs.put(0, active ? dz : 0.0f);
  if (OPL) bs.put(1, active ? dn_last : 0.0f);
  bs.flush(OPL ? 2 : 1, [&](int rw, int& base, bool& split) {
    split = rw == 1;
    base = rw == 0 ? 0 : off_ref + n_surf * n_w;
  });
  dxp = dx;
  dyp = dy;
  dcyp = dcy;
}

// Calls f(std::integral_constant<int, n_asph>{}) for 1 <= n_asph <=
// MAX_ASPH (the launchers admit no other count): K3 and K4 are
// instantiated once per asphere term count.
template <int K = 1, typename F>
inline void with_terms(int n_asph, F&& f) {
  if constexpr (K == MAX_ASPH) {
    f(std::integral_constant<int, K>{});
  } else if (n_asph == K) {
    f(std::integral_constant<int, K>{});
  } else {
    with_terms<K + 1>(n_asph, f);
  }
}

// The bounds every K3 and K4 launcher checks.
inline bool bad_shape_a(int n_surf, int n_w, int n_asph, int n_per_w, int n, int n_iter,
                        int mode) {
  return bad_shape(n_surf, n_w, n_per_w, n, mode) || n_asph < 1 || n_asph > MAX_ASPH ||
         n_iter < 0;
}

}  // namespace
