// Kernel S1, adjoint: the gradients of the PSF splat (psf_splat_fwd.cu) for
// a cotangent G of its half kernels, for training through the rendered image
// (torchoptics_tpu_torch/ops/psf.py: _Splat.backward).
//
// No Pallas kernel is replaced: XLA differentiates the JAX package's fused
// broadcast (torchoptics_tpu/ops/psf.py:75-86). The forward sums ex[r, ix] *
// ey[r, iy] * w[r] over the rays r of each (grid, channel) pair. Per ray, in
// double, with ex and ey recomputed as the forward takes them (s1::gauss4;
// ey without the weight):
//
//   A[ix] = sum_iy G[iy, ix] ey[iy],   B[iy] = sum_ix G[iy, ix] ex[ix]
//   tx[ix] = ((A ex) qx) w,  qx = (x - gx) (1 / sigma_x^2);  ty alike with B
//   d/dx = -sum_ix tx,  d/dy = -sum_iy ty,  d/dw = sum_iy B ey,
//
// A and B in index order from 0.0. The sums over a ray's bins run in two
// levels (ops/psf.py:grouped_sum): the bins fall into groups (j, t), bins
// 40 j + 8 n + 2 t + e (n < 5, e < 2), each group summed in index order from
// 0.0, then the groups' sums in order (j, then t) from 0.0, each result
// rounded once. With `bins` (the grid's centres and widths need a gradient:
// compute_psf sized the grid from the data), also d/dgx[ix] = sum tx and
// d/dsigma_x = sum tx (x - gx) (1 / sigma_x) (y alike): a block sums its
// span's rays in order for each bin; the second kernel sums them per grid
// over (channel, span) in order, and d/dsigma over the bins last. The plain
// PyTorch version is ops/psf.py:splat_backward_reference; the two agree bit
// for bit.
//
// What bounds it on an H100, at the default configuration (63 pairs, a 65 x
// 33 half grid, 65,536 rays): A and B are 2 x 8.86e9 products and sums,
// with the factors and the terms 4.03e10 operations, 0.60 ms at 67
// TFLOP/s; the bytes (x, y, the cotangent read once, d/dx and d/dy written
// once) take 0.02 ms. Operations bound it; here the products outweigh the
// factors (5,600 multiply-adds a ray after padding, against the same 98
// factors as the forward's), and the fragments they read from shared
// memory come close to its bandwidth.
//
// Design, per (pair, span) block, a step of `kr` rays (64 where the layout
// fits), warp-specialised as the forward:
// - The cotangent staged once as doubles, in one layout (G[iy][ix], zero
//   padded to whole k-steps and whole groups of tiles, 28 KB at 65 x 33): A
//   reads it as B-fragments G[k][n], B as G^T, both free of bank conflicts
//   at an odd-multiple-of-4 pitch. One block an SM (~210 KB with a ring of
//   3 stages), 12 consumer and 8 producer warps.
// - Products on the FP64 tensor cores for float32 inputs (mma.sync m16n8k4,
//   s1::mma_chain; M = 16 rays, N = 8 bins, K = the other axis's bins in
//   index order, zero padding past n_y and n_x changing no sum), separate
//   double multiplies and adds for float64. A task is one product's 16 rays
//   by NW column tiles: per 16 rays one A task (5 tiles x 17 k-steps) and
//   two B tasks (5 tiles x 9 k-steps each, the last tile zero) at the
//   default grid, dealt so that each SM sub-partition gets one of each kind.
// - Fused epilogue: each thread forms its tiles' terms tx (or ty and B ey)
//   in registers and sums its own bins in index order, branch-free; the
//   partials go to shared memory, one per (ray, group). After one consumer
//   barrier a ray's d/dx adds 4 group partials, d/dy 8 (at most 8 and 16),
//   one thread a ray; with `bins`, one thread a bin carries the span's
//   per-bin sums. d/dw and the per-bin sums live in their own instantiation
//   (FULL), so the main path's kernel carries none of their code.
// - Producer warps compute the next stage's factors (s1::stage_factors)
//   while the consumers run this one; named barriers: two a step for the
//   consumers (the stage's FULL, their own), none for the whole block.
//
// That resident kernel holds the whole cotangent and a ray's factors of
// every bin in shared memory, which caps its grid (ops/psf.py
// splat_bwd_tiled: half grids up to 129 x 65 take it). Larger grids take
// the tiled kernel (s1_bwd_tiled_kernel), the same sums in the same order
// with shared memory of a fixed size:
// - A block is one side of one (pair, span): side 0 the A products and
//   d/dx (the "out" bins are x's, k runs over y's), side 1 the B products,
//   d/dy and d/dw (out over y, k over x, G read transposed).
// - Per step of TKR rays, the side's out bins go in sets of TNJ groups of
//   40 (TKR / 16 x TNJ tasks, one a consumer warp), and for each set k runs
//   over chunks of TKC bins: a stage is one chunk's factors fk[ray][k], its
//   rows of the cotangent (doubles), and on the set's last chunk the out
//   bins' factors fo and the rays. The products chain over the chunks in k
//   order in the warps' registers, so A and B round as in the resident
//   kernel; factors are recomputed for every set.
// - A ray's group sums of a set go to shared memory; one thread a ray adds
//   them, in (j, t) order, to the ray's running sum, which after the last
//   set is d/dx (or d/dy, d/dw): the sums of grouped_sum in its order.
//   With bins, one thread a bin adds the step's terms to its span sum, kept
//   in the scratch row the second pass reads.

#include <cuda_runtime.h>

#include "psf_splat.cuh"

namespace {

using s1::NW;

constexpr int PRODUCER_WARPS = 8;
constexpr int MAX_CONSUMERS = 12;
constexpr int MAX_THREADS = (MAX_CONSUMERS + PRODUCER_WARPS) * 32;

// A block's shared memory, in doubles, for an ny x nx half grid at kr rays
// a step and `stages` stages.
struct BwdLayout {
  int ka, kb, ja, jb, gxn, gyn, ppx, ppy, pg, g_rows, pe, px, tasks, consumers;
  size_t gxs, gys, tcen, sums, part, part_size, tx, ty, stage0, stage, total;

  __host__ __device__ BwdLayout(int ny, int nx, int kr, int stages, bool with_dw, bool bins) {
    ka = s1::cdiv(ny, 4);           // A's k-steps (over iy)
    kb = s1::cdiv(nx, 4);           // B's k-steps (over ix)
    ja = s1::cdiv(nx, 8 * NW);      // A's groups of NW column tiles (ix)
    jb = s1::cdiv(ny, 8 * NW);      // B's (iy)
    gxn = 4 * ja;  // a ray's groups of x bins, and of y bins
    gyn = 4 * jb;
    ppx = gxn | 1;
    ppy = gyn | 1;
    // G padded with zeros to whole groups of tiles and whole k-steps.
    pg = s1::pitch(4 * kb > 8 * NW * ja ? 4 * kb : 8 * NW * ja);
    g_rows = 4 * ka > 8 * NW * jb ? 4 * ka : 8 * NW * jb;
    pe = s1::pitch(4 * ka);
    px = s1::pitch(4 * kb);
    tasks = (kr / 16) * (ja + jb);
    consumers = tasks < MAX_CONSUMERS ? tasks : MAX_CONSUMERS;
    gys = (size_t)g_rows * pg;                    // the grid's centres in double, gy's
    gxs = gys + ny;                               // first, and in the inputs' type
    tcen = gxs + nx;
    sums = tcen + ny + nx;                        // the span's bin sums: gx, sx, gy, sy
    part = sums + (bins ? 2 * (size_t)(nx + ny) : 0);
    part_size = (size_t)kr * (ppx + ppy + (with_dw ? ppy : 0));  // a step's partials
    tx = part + 2 * part_size;                    // bins: tx[2][kr][nx], ty[2][kr][ny]
    ty = tx + (bins ? 2 * (size_t)kr * nx : 0);
    stage0 = ty + (bins ? 2 * (size_t)kr * ny : 0);
    stage = (size_t)kr * (pe + px + 3);           // ey[kr][pe], ex[kr][px], x, y, w
    total = stage0 + stages * stage;
  }

  size_t bytes() const { return sizeof(double) * total; }
};

// The most rays a step (64, 32 or 16) and then the most stages whose layout
// fits a block's shared memory; {0, 0} if none does.
void step_plan(int ny, int nx, bool with_dw, bool bins, int& kr, int& stages) {
  for (kr = 64; kr >= 16; kr /= 2)
    for (stages = s1::MAX_STAGES; stages >= 1; --stages)
      if (BwdLayout(ny, nx, kr, stages, with_dw, bins).bytes() <= s1::SMEM_MAX) return;
  kr = stages = 0;
}

// Block b = pair * n_spans + span. dw null: no d/dw; sums null: no bins.
// FULL: either is asked for (the main path asks for neither).
template <typename T, bool FULL>
__global__ void __launch_bounds__(MAX_THREADS, 1) s1_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, const T* __restrict__ cot, T* __restrict__ dx, T* __restrict__ dy,
    T* __restrict__ dw, double* __restrict__ sums, int n_ch, int n_rays, int ny, int nx,
    int span, int n_spans, int kr, int n_stages) {
  extern __shared__ double smem[];
  const bool with_dw = FULL && dw != nullptr;
  const bool bins = FULL && sums != nullptr;
  const BwdLayout L(ny, nx, kr, n_stages, with_dw, bins);
  double* sG = smem;
  double* sGX = smem + L.gxs;
  double* sGY = smem + L.gys;
  double* sSum = smem + L.sums;
  const int pair = blockIdx.x / n_spans;
  const int g = pair / n_ch;
  const int r0 = (blockIdx.x - pair * n_spans) * span;
  const int r_end = min(r0 + span, n_rays);
  const int n_steps = s1::cdiv(r_end - r0, kr);
  const size_t base = (size_t)pair * n_rays;
  const T* gxp = gx + (size_t)g * nx;
  const T* gyp = gy + (size_t)g * ny;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;

  const T* cp = cot + (size_t)pair * ny * nx;
  for (int k = tid; k < L.g_rows * L.pg; k += threads) {
    const int iy = k / L.pg, ix = k - iy * L.pg;
    sG[k] = iy < ny && ix < nx ? (double)cp[iy * nx + ix] : 0.0;
  }
  T* tcen = reinterpret_cast<T*>(smem + L.tcen);
  for (int k = tid; k < ny + nx; k += threads) {
    tcen[k] = k < ny ? gyp[k] : gxp[k - ny];
    sGY[k] = (double)tcen[k];  // sGX = sGY + ny
  }
  if (bins)
    for (int k = tid; k < 2 * (nx + ny); k += threads) sSum[k] = 0.0;
  // The stages zeroed once: their padding columns stay zero.
  for (size_t k = L.stage0 + tid; k < L.total; k += threads) smem[k] = 0.0;
  __syncthreads();

  const int warp = tid >> 5;
  if (warp >= L.consumers) {
    const T s2x = sx[g] * sx[g];
    const T s2y = sy[g] * sy[g];
    const s1::ProducerMap map(tid - 32 * L.consumers, threads - 32 * L.consumers, kr);
    const T* xp = x + base;
    const T* yp = y + base;
    const T* wp = w ? w + base : nullptr;
    s1::Quad<T> quad, next;
    quad.load(xp, yp, wp, r0 + 4 * map.rg, r_end);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % n_stages;
      if (i + 1 < n_steps) next.load(xp, yp, wp, r0 + (i + 1) * kr + 4 * map.rg, r_end);
      if (i >= n_stages) s1::bar_sync(s1::BAR_EMPTY + s, threads);
      double* E = smem + L.stage0 + s * L.stage;
      double* X = E + (size_t)kr * L.pe;
      double* XR = X + (size_t)kr * L.px;
      s1::stage_factors<T>(map, quad, tcen, tcen + ny, s2x, s2y, ny, nx, false, E, L.pe, X,
                           L.px);
      if (map.q == 0) {
        // The group's rays in double for the terms: x, y, w (1 without weights).
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = j < quad.n_valid;
          XR[4 * map.rg + j] = ok ? (double)quad.x[j] : 0.0;
          XR[kr + 4 * map.rg + j] = ok ? (double)quad.y[j] : 0.0;
          XR[2 * kr + 4 * map.rg + j] = ok ? (double)quad.w[j] : 1.0;
        }
      }
      s1::bar_arrive(s1::BAR_FULL + s, threads);
      quad = next;
    }
    return;
  }

  const double sxd = (double)sx[g], syd = (double)sy[g];
  const double inv2x = 1.0 / (sxd * sxd), inv2y = 1.0 / (syd * syd);
  const double inv1x = 1.0 / sxd, inv1y = 1.0 / syd;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n_cons = 32 * L.consumers;
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % n_stages, par = i & 1;
    const int c0 = r0 + i * kr;
    const int n_valid = min(kr, r_end - c0);
    s1::bar_sync(s1::BAR_FULL + s, threads);
    const double* E = smem + L.stage0 + s * L.stage;
    const double* X = E + (size_t)kr * L.pe;
    const double* XR = X + (size_t)kr * L.px;
    const double* YR = XR + kr;
    const double* WR = YR + kr;
    double* PX = smem + L.part + par * L.part_size;
    double* PY = PX + (size_t)kr * L.ppx;
    double* PW = PY + (size_t)kr * L.ppy;
    double* TX = smem + L.tx + (size_t)par * kr * nx;
    double* TY = smem + L.ty + (size_t)par * kr * ny;
    for (int task = warp; task < L.tasks; task += L.consumers) {
      const int mg = task / (L.ja + L.jb), kind = task - mg * (L.ja + L.jb);
      const bool is_a = kind < L.ja;
      const int j = is_a ? kind : kind - L.ja;
      const int ray0 = 16 * mg;
      // acc[n] = rays ray0 + gid (+ 8) by bins 8 (NW j + n) + 2 tig (+ 1).
      double acc[NW][4];
#pragma unroll
      for (int n = 0; n < NW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
      if (is_a)  // A(m, k) = ey[ray m][iy k], B(k, n) = G[iy k][ix n]
        s1::mma_chain<T>(acc, E + ray0 * L.pe, L.pe, 1, sG + 8 * NW * j, L.pg, 1,
                         sizeof(T) == 4 ? 4 * L.ka : ny, lane);
      else       // A(m, k) = ex[ray m][ix k], B(k, n) = G[iy n][ix k]
        s1::mma_chain<T>(acc, X + ray0 * L.px, L.px, 1, sG + 8 * NW * j * L.pg, 1, L.pg,
                         sizeof(T) == 4 ? 4 * L.kb : nx, lane);
      // The terms, ((acc f) q) w, f the factor and q = (v - centre) / sigma^2
      // (w = 1 without weights: exact), and this thread's group sums over its
      // bins in index order. A bin past the grid adds 0.0, which changes no
      // sum (a sum from 0.0 is never -0.0).
      const int nb = is_a ? nx : ny;
      const double* cen = is_a ? sGX : sGY;
      const double inv2 = is_a ? inv2x : inv2y;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ray = ray0 + 8 * h + gid;
        const double wd = WR[ray];
        const double vd = (is_a ? XR : YR)[ray];
        const double* f = is_a ? X + ray * L.px : E + ray * L.pe;
        double sum = 0.0, sum_w = 0.0;
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = 8 * (NW * j + n) + 2 * tig + e;
            const bool ok = b < nb;
            const int bc = ok ? b : 0;
            const double prod = acc[n][2 * h + e] * f[bc];
            const double t = (prod * ((vd - cen[bc]) * inv2)) * wd;
            sum = sum + (ok ? t : 0.0);
            if constexpr (FULL) {
              sum_w = sum_w + (ok ? prod : 0.0);
              if (bins && ok) (is_a ? TX + ray * nx : TY + ray * ny)[b] = t;
            }
          }
        (is_a ? PX + ray * L.ppx : PY + ray * L.ppy)[4 * j + tig] = sum;
        if constexpr (FULL)
          if (with_dw && !is_a) PW[ray * L.ppy + 4 * j + tig] = sum_w;
      }
    }
    s1::bar_sync(s1::BAR_CONSUMERS, n_cons);
    // One thread a ray: d/dx, or d/dy and d/dw, from the group partials in
    // order; with bins, one thread a bin.
    const int n_fin = 2 * kr + (bins ? nx + ny : 0);
    for (int t = tid; t < n_fin; t += n_cons) {
      if (t < 2 * kr) {
        const bool is_x = t < kr;
        const int r = is_x ? t : t - kr;
        if (r < n_valid) {
          const int n_g = is_x ? L.gxn : L.gyn;
          const double* src = is_x ? PX + r * L.ppx : PY + r * L.ppy;
          double s_ = 0.0;
          for (int q = 0; q < n_g; ++q) s_ = s_ + src[q];
          (is_x ? dx : dy)[base + c0 + r] = (T)(-s_);
          if constexpr (FULL)
            if (with_dw && !is_x) {
              double sw = 0.0;
              for (int q = 0; q < n_g; ++q) sw = sw + PW[r * L.ppy + q];
              dw[base + c0 + r] = (T)sw;
            }
        }
      } else if (!FULL) {
      } else if (t < 2 * kr + nx) {
        const int ix = t - 2 * kr;
        double a = sSum[ix], v = sSum[nx + ix];
        for (int r = 0; r < n_valid; ++r) {
          const double tt = TX[r * nx + ix];
          a = a + tt;
          v = v + tt * ((XR[r] - sGX[ix]) * inv1x);
        }
        sSum[ix] = a;
        sSum[nx + ix] = v;
      } else {
        const int iy = t - 2 * kr - nx;
        double a = sSum[2 * nx + iy], v = sSum[2 * nx + ny + iy];
        for (int r = 0; r < n_valid; ++r) {
          const double tt = TY[r * ny + iy];
          a = a + tt;
          v = v + tt * ((YR[r] - sGY[iy]) * inv1y);
        }
        sSum[2 * nx + iy] = a;
        sSum[2 * nx + ny + iy] = v;
      }
    }
    if (i + n_stages < n_steps) s1::bar_arrive(s1::BAR_EMPTY + s, threads);
  }
  if (FULL && bins) {
    s1::bar_sync(s1::BAR_CONSUMERS, n_cons);
    double* dst = sums + (size_t)blockIdx.x * 2 * (nx + ny);
    for (int k = tid; k < 2 * (nx + ny); k += n_cons) dst[k] = sSum[k];
  }
}

// The tiled kernel's shape: TKR rays a step, out bins in sets of TNJ groups
// of 40, k in chunks of TKC bins; one consumer warp a task.
constexpr int TKR = 64;
constexpr int TKC = 32;
constexpr int TNJ = 2;
constexpr int T_CONSUMERS = TKR / 16 * TNJ;
constexpr int T_PRODUCERS = PRODUCER_WARPS * 32;
constexpr int T_THREADS = 32 * T_CONSUMERS + T_PRODUCERS;
// A producer thread's values of a stage's cotangent chunk.
constexpr int G_PER = TKC * 8 * NW * TNJ / T_PRODUCERS;
static_assert(G_PER * T_PRODUCERS == TKC * 8 * NW * TNJ, "the chunk splits evenly");

// The tiled kernel's shared memory, in doubles: the ring of stages (fk
// [TKR][pk], fo [TKR][po], the cotangent's chunk [TKC][po], the rays' x, y,
// w), the sets' group sums (two buffers), the running sums, and with bins
// the terms of a set (two buffers).
struct TiledLayout {
  int pk, po, pp;
  size_t fo, gc, rays, stage, part, part_size, run, terms, total;

  __host__ __device__ TiledLayout(int stages, bool with_dw, bool bins) {
    pk = s1::pitch(TKC);
    po = s1::pitch(8 * NW * TNJ);
    pp = 4 * TNJ + 1;
    fo = (size_t)TKR * pk;
    gc = fo + (size_t)TKR * po;
    rays = gc + (size_t)TKC * po;
    stage = rays + 3 * TKR;
    part = stage * stages;
    part_size = (size_t)TKR * pp * (with_dw ? 2 : 1);
    run = part + 2 * part_size;
    terms = run + 2 * TKR;
    total = terms + (bins ? 2 * (size_t)TKR * 8 * NW * TNJ : 0);
  }

  size_t bytes() const { return sizeof(double) * total; }
};

int tiled_stages(bool with_dw, bool bins) {
  for (int s = s1::MAX_STAGES; s >= 1; --s)
    if (TiledLayout(s, with_dw, bins).bytes() <= s1::SMEM_MAX) return s;
  return 0;
}

// Block b = (pair * n_spans + span) * 2 + side. dw null: no d/dw; sums
// null: no bins (then FULL is false, as in the resident kernel).
template <typename T, bool FULL>
__global__ void __launch_bounds__(T_THREADS, 1) s1_bwd_tiled_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, const T* __restrict__ cot, T* __restrict__ dx, T* __restrict__ dy,
    T* __restrict__ dw, double* __restrict__ sums, int n_ch, int n_rays, int ny, int nx,
    int span, int n_spans, int n_stages) {
  extern __shared__ double smem[];
  const bool is_a = (blockIdx.x & 1) == 0;
  const bool with_dw = FULL && !is_a && dw != nullptr;
  const bool bins = FULL && sums != nullptr;
  const TiledLayout L(n_stages, FULL && dw != nullptr, bins);
  const int block = blockIdx.x >> 1;
  const int pair = block / n_spans;
  const int g = pair / n_ch;
  const int r0 = (block - pair * n_spans) * span;
  const int r_end = min(r0 + span, n_rays);
  const int n_steps = s1::cdiv(r_end - r0, TKR);
  const int n_out = is_a ? nx : ny, n_k = is_a ? ny : nx;
  const int n_sets = s1::cdiv(n_out, 8 * NW * TNJ);
  const int n_chunks = s1::cdiv(n_k, TKC);
  const int per_step = n_sets * n_chunks;
  const int total = n_steps * per_step;
  const size_t base = (size_t)pair * n_rays;
  const T* gxp = gx + (size_t)g * nx;
  const T* gyp = gy + (size_t)g * ny;
  const T* cp = cot + (size_t)pair * ny * nx;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = tid >> 5;

  if (warp >= T_CONSUMERS) {
    const T s2x = sx[g] * sx[g];
    const T s2y = sy[g] * sy[g];
    const int pt = tid - 32 * T_CONSUMERS, n_prod = threads - 32 * T_CONSUMERS;
    const s1::ProducerMap map(pt, n_prod, TKR);
    const T* xp = x + base;
    const T* yp = y + base;
    const T* wp = w ? w + base : nullptr;
    s1::Quad<T> quad, next;
    quad.load(xp, yp, wp, r0 + 4 * map.rg, r_end);
    // This thread's values of a stage's cotangent chunk: gc[k][o] = G[k][o]
    // (A) or G[o][k] (B), zero past the grid; consecutive threads read
    // consecutive columns of G. Loaded a stage ahead, so that their latency
    // hides behind a stage's factors.
    T g_now[G_PER], g_next[G_PER];
    auto load_g = [&](int idx, T (&g)[G_PER]) {
      const int set = idx / n_chunks % n_sets, c = idx % n_chunks;
      const int k0 = c * TKC, klen = min(TKC, n_k - k0);
      const int o0 = set * 8 * NW * TNJ, olen = min(8 * NW * TNJ, n_out - o0);
#pragma unroll
      for (int j = 0; j < G_PER; ++j) {
        const int e = pt + j * T_PRODUCERS;
        const int kk = is_a ? e / (8 * NW * TNJ) : e % TKC;
        const int oo = is_a ? e % (8 * NW * TNJ) : e / TKC;
        const size_t at = is_a ? (size_t)(k0 + kk) * nx + o0 + oo
                               : (size_t)(o0 + oo) * nx + k0 + kk;
        g[j] = kk < klen && oo < olen ? cp[at] : T(0);
      }
    };
    load_g(0, g_now);
    for (int idx = 0; idx < total; ++idx) {
      const int i = idx / per_step, set = idx / n_chunks - i * n_sets;
      const int c = idx - (idx / n_chunks) * n_chunks;
      const int s = idx % n_stages;
      if (idx > 0 && idx % per_step == 0) quad = next;
      if (idx % per_step == 0 && i + 1 < n_steps)
        next.load(xp, yp, wp, r0 + (i + 1) * TKR + 4 * map.rg, r_end);
      if (idx + 1 < total) load_g(idx + 1, g_next);
      const int k0 = c * TKC, klen = min(TKC, n_k - k0);
      const int o0 = set * 8 * NW * TNJ, olen = min(8 * NW * TNJ, n_out - o0);
      const bool last = c == n_chunks - 1;
      if (idx >= n_stages) s1::bar_sync(s1::BAR_EMPTY + s, threads);
      double* st = smem + s * L.stage;
      double* fk = st;
      double* fo = st + L.fo;
      double* gc = st + L.gc;
      // This chunk's factors (and on the set's last chunk the out bins'):
      // y's bins first, then x's.
      if (is_a)
        s1::stage_factors<T>(map, quad, gyp + k0, gxp + o0, s2x, s2y, klen, last ? olen : 0,
                             false, fk, L.pk, fo, L.po);
      else
        s1::stage_factors<T>(map, quad, gyp + o0, gxp + k0, s2x, s2y, last ? olen : 0, klen,
                             false, fo, L.po, fk, L.pk);
      // Zero factors past the chunk's bins (a stage keeps an earlier
      // chunk's): the products read them up to a whole k-step.
      for (int e = pt; e < TKR * (TKC - klen); e += n_prod) {
        const int r = e / (TKC - klen);
        fk[r * L.pk + klen + (e - r * (TKC - klen))] = 0.0;
      }
#pragma unroll
      for (int j = 0; j < G_PER; ++j) {
        const int e = pt + j * T_PRODUCERS;
        const int kk = is_a ? e / (8 * NW * TNJ) : e % TKC;
        const int oo = is_a ? e % (8 * NW * TNJ) : e / TKC;
        gc[kk * L.po + oo] = (double)g_now[j];
        g_now[j] = g_next[j];
      }
      if (last && map.q == 0) {
        double* rays = st + L.rays;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = j < quad.n_valid;
          rays[4 * map.rg + j] = ok ? (double)quad.x[j] : 0.0;
          rays[TKR + 4 * map.rg + j] = ok ? (double)quad.y[j] : 0.0;
          rays[2 * TKR + 4 * map.rg + j] = ok ? (double)quad.w[j] : 1.0;
        }
      }
      s1::bar_arrive(s1::BAR_FULL + s, threads);
    }
    return;
  }

  const double sd = (double)(is_a ? sx[g] : sy[g]);
  const double inv2 = 1.0 / (sd * sd), inv1 = 1.0 / sd;
  const T* cen = is_a ? gxp : gyp;
  T* out = is_a ? dx : dy;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n_cons = 32 * T_CONSUMERS;
  const int mg = warp / TNJ, jj = warp - mg * TNJ;
  const int ray0 = 16 * mg;
  double* run = smem + L.run;
  // The per-bin span sums' rows: gx and sx (A), or gy and sy (B).
  double* bsum = bins ? sums + (size_t)block * 2 * (nx + ny) + (is_a ? 0 : 2 * nx) : nullptr;
  // Thread t < TKR keeps ray t's running sums (as in the finalisation).
  for (int r = tid; r < TKR; r += n_cons) run[r] = run[TKR + r] = 0.0;
  int idx = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int c0 = r0 + i * TKR;
    const int n_valid = min(TKR, r_end - c0);
    for (int set = 0; set < n_sets; ++set) {
      const int o0 = set * 8 * NW * TNJ;
      const bool live = o0 + 8 * NW * jj < n_out;
      double acc[NW][4];
#pragma unroll
      for (int n = 0; n < NW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
      int s = 0;
      for (int c = 0; c < n_chunks; ++c, ++idx) {
        s = idx % n_stages;
        s1::bar_sync(s1::BAR_FULL + s, threads);
        const double* st = smem + s * L.stage;
        const int klen = min(TKC, n_k - c * TKC);
        // A(m, k) = fk[ray m][k], B(k, n) = gc[k][n].
        if (live)
          s1::mma_chain<T>(acc, st + ray0 * L.pk, L.pk, 1, st + L.gc + 8 * NW * jj, L.po, 1,
                           sizeof(T) == 4 ? 4 * s1::cdiv(klen, 4) : klen, lane);
        if (c + 1 < n_chunks && idx + n_stages < total) s1::bar_arrive(s1::BAR_EMPTY + s, threads);
      }
      const double* st = smem + s * L.stage;
      const double* fo = st + L.fo;
      const double* rays = st + L.rays;
      const int par = (i * n_sets + set) & 1;
      double* P = smem + L.part + par * L.part_size;
      double* PW = P + (size_t)TKR * L.pp;
      double* TB = smem + L.terms + (size_t)par * TKR * 8 * NW * TNJ;
      // The terms and this thread's group sums, as in the resident kernel.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ray = ray0 + 8 * h + gid;
        const double wd = rays[2 * TKR + ray];
        const double vd = rays[(is_a ? 0 : TKR) + ray];
        double sum = 0.0, sum_w = 0.0;
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int bl = 8 * (NW * jj + n) + 2 * tig + e;
            const bool ok = o0 + bl < n_out;
            const int bc = ok ? bl : 0;
            const double prod = acc[n][2 * h + e] * fo[ray * L.po + bc];
            const double t = (prod * ((vd - (double)cen[o0 + bc]) * inv2)) * wd;
            sum = sum + (ok ? t : 0.0);
            if constexpr (FULL) {
              sum_w = sum_w + (ok ? prod : 0.0);
              if (bins && ok) TB[ray * 8 * NW * TNJ + bl] = t;
            }
          }
        P[ray * L.pp + 4 * jj + tig] = sum;
        if constexpr (FULL)
          if (with_dw) PW[ray * L.pp + 4 * jj + tig] = sum_w;
      }
      s1::bar_sync(s1::BAR_CONSUMERS, n_cons);
      // One thread a ray: the set's group sums in order onto the running
      // sums, the outputs after the last set; with bins, one thread a bin.
      const int n_q = 4 * min(TNJ, s1::cdiv(n_out - o0, 8 * NW));
      const int olen = min(8 * NW * TNJ, n_out - o0);
      const int n_fin = TKR + (bins ? olen : 0);
      for (int t = tid; t < n_fin; t += n_cons) {
        if (t < TKR) {
          if (t < n_valid) {
            double a = run[t];
            for (int q = 0; q < n_q; ++q) a = a + P[t * L.pp + q];
            double b = 0.0;
            if constexpr (FULL)
              if (with_dw) {
                b = run[TKR + t];
                for (int q = 0; q < n_q; ++q) b = b + PW[t * L.pp + q];
              }
            if (set + 1 < n_sets) {
              run[t] = a;
              if (with_dw) run[TKR + t] = b;
            } else {
              out[base + c0 + t] = (T)(-a);
              if constexpr (FULL)
                if (with_dw) dw[base + c0 + t] = (T)b;
              run[t] = run[TKR + t] = 0.0;
            }
          }
        } else if constexpr (FULL) {
          const int bl = t - TKR, b = o0 + bl;
          const double cb = (double)cen[b];
          double a = i == 0 ? 0.0 : bsum[b], v = i == 0 ? 0.0 : bsum[n_out + b];
          for (int r = 0; r < n_valid; ++r) {
            const double tt = TB[r * 8 * NW * TNJ + bl];
            a = a + tt;
            v = v + tt * ((rays[(is_a ? 0 : TKR) + r] - cb) * inv1);
          }
          bsum[b] = a;
          bsum[n_out + b] = v;
        }
      }
      if (idx - 1 + n_stages < total) s1::bar_arrive(s1::BAR_EMPTY + s, threads);
    }
  }
}

// The per-bin second pass, a block a grid: d/dgx, d/dgy summed over the
// grid's (channel, span) blocks in order; d/dsigma the same per bin (into
// cols, n_grids x (nx + ny) doubles of scratch), then over the bins in
// order; each rounded once.
template <typename T>
__global__ void s1_bwd_bins(const double* __restrict__ sums, double* __restrict__ cols,
                            T* __restrict__ dgx, T* __restrict__ dgy, T* __restrict__ dsx,
                            T* __restrict__ dsy, int n_ch, int n_spans, int ny, int nx) {
  const int g = blockIdx.x;
  const int stride = 2 * (nx + ny);
  const int n_blocks = n_ch * n_spans;
  const double* src = sums + (size_t)g * n_blocks * stride;
  double* col = cols + (size_t)g * (nx + ny);
  for (int t = threadIdx.x; t < nx + ny; t += blockDim.x) {
    const bool is_x = t < nx;
    const int b = is_x ? t : t - nx;
    const int off_g = is_x ? b : 2 * nx + b;
    const int off_s = is_x ? nx + b : 2 * nx + ny + b;
    double a = 0.0, s = 0.0;
    for (int k = 0; k < n_blocks; ++k) {
      a = a + src[(size_t)k * stride + off_g];
      s = s + src[(size_t)k * stride + off_s];
    }
    if (is_x)
      dgx[(size_t)g * nx + b] = (T)a;
    else
      dgy[(size_t)g * ny + b] = (T)a;
    col[t] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int ix = 0; ix < nx; ++ix) s = s + col[ix];
    dsx[g] = (T)s;
  } else if (threadIdx.x == 32) {
    double s = 0.0;
    for (int iy = 0; iy < ny; ++iy) s = s + col[nx + iy];
    dsy[g] = (T)s;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                   const void* sy, const void* w, const void* cot, void* dx, void* dy, void* dw,
                   double* sums, void* dgx, void* dgy, void* dsx, void* dsy, int n_grids,
                   int n_ch, int n_rays, int ny, int nx, int span, bool tiled,
                   cudaStream_t stream) {
  const bool with_dw = dw != nullptr, bins = sums != nullptr, full = with_dw || bins;
  int kr = 0, stages = 0;
  if (!tiled) step_plan(ny, nx, with_dw, bins, kr, stages);
  tiled = tiled || kr == 0;
  if (tiled) stages = tiled_stages(with_dw, bins);
  if (stages == 0) return cudaErrorInvalidValue;
  const int n_spans = (n_rays + span - 1) / span;
  const long long blocks = (long long)n_grids * n_ch * n_spans * (tiled ? 2 : 1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (blocks > 0 && tiled) {
    const size_t smem = TiledLayout(stages, with_dw, bins).bytes();
    auto kernel = full ? s1_bwd_tiled_kernel<T, true> : s1_bwd_tiled_kernel<T, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, T_THREADS, smem, stream>>>(
        (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
        (const T*)w, (const T*)cot, (T*)dx, (T*)dy, (T*)dw, sums, n_ch, n_rays, ny, nx, span,
        n_spans, stages);
    err = cudaGetLastError();
  } else if (blocks > 0) {
    const BwdLayout L(ny, nx, kr, stages, with_dw, bins);
    const size_t smem = L.bytes();
    auto kernel = full ? s1_bwd_kernel<T, true> : s1_bwd_kernel<T, false>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<(unsigned)blocks, (L.consumers + PRODUCER_WARPS) * 32, smem, stream>>>(
        (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
        (const T*)w, (const T*)cot, (T*)dx, (T*)dy, (T*)dw, sums, n_ch, n_rays, ny, nx, span,
        n_spans, kr, stages);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if (sums && n_grids > 0) {
    double* cols = sums + (size_t)n_grids * n_ch * n_spans * 2 * (nx + ny);
    s1_bwd_bins<T><<<n_grids, 128, 0, stream>>>(sums, cols, (T*)dgx, (T*)dgy, (T*)dsx,
                                                 (T*)dsy, n_ch, n_spans, ny, nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches S1's adjoint on `stream` and returns cudaGetLastError() (0 on
// success). Inputs as s1_fwd_launch's, and the cotangent (n_grids, n_ch, ny,
// nx); dx, dy and dw (null: no d/dw) (n_grids, n_ch, n_rays). With `bins`:
// sums n_grids * (n_ch * ceil(n_rays / span) * 2 + 1) * (nx + ny) doubles of
// scratch, dgx (n_grids, nx), dgy (n_grids, ny), dsx, dsy (n_grids,), and a
// second launch; without, those are null. Of the inputs' type (float32, or
// float64 with `dbl`), contiguous. `tiled`: the tiled kernel, which any grid
// takes (ops/psf.py splat_bwd_tiled); else the resident one, or the tiled
// where the resident layout does not fit.
int s1_bwd_launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                  const void* sy, const void* w, const void* cot, void* dx, void* dy, void* dw,
                  double* sums, void* dgx, void* dgy, void* dsx, void* dsy, int n_grids,
                  int n_ch, int n_rays, int ny, int nx, int span, int dbl, int bins, int tiled,
                  void* stream) {
  if (n_grids < 0 || n_ch < 0 || n_rays < 0 || ny < 1 || nx < 1 || span < s1::CHUNK ||
      span % s1::CHUNK != 0 || (bins && !(sums && dgx && dgy && dsx && dsy)))
    return (int)cudaErrorInvalidValue;
  if (!bins) sums = nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dbl ? launch<double>(x, y, gx, gy, sx, sy, w, cot, dx, dy, dw, sums, dgx, dgy,
                                    dsx, dsy, n_grids, n_ch, n_rays, ny, nx, span, tiled != 0, s)
                   : launch<float>(x, y, gx, gy, sx, sy, w, cot, dx, dy, dw, sums, dgx, dgy,
                                   dsx, dsy, n_grids, n_ch, n_rays, ny, nx, span, tiled != 0, s));
}

}  // extern "C"
