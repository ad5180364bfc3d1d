// Kernel S1, forward: the soft-histogram splat of the geometric PSF
// (torchoptics_tpu_torch/ops/psf.py: compute_psf, through splat).
//
// No Pallas kernel is replaced: the JAX package writes the splat as a 5-D
// broadcast (torchoptics_tpu/ops/psf.py:75-86) that XLA fuses into its sum
// over rays, so the (grids, channels, n_y, n_x/2, rays) Gaussian never
// exists in memory. Run eagerly, the same lines hold it: 8.86e9 values,
// 35.4 GB, at the default SimulatorConfig (21 fields x 3 channels, a 65 x 33
// half grid, 65,536 rays). This kernel is that fusion. For each (grid g,
// channel c) pair
//
//   half[g, c, iy, ix] = sum_r ex[r, ix] * eyw[r, iy],
//   ex[r, ix]  = exp(-(((x[r] - gx[ix])^2) / sigma_x^2) / 2),
//   eyw[r, iy] = exp(-(((y[r] - gy[iy])^2) / sigma_y^2) / 2) * w[r],
//
// each factor in the inputs' type (float32 or float64) in the JAX formula's
// order (s1::factor), w = 1 without weights. The plain PyTorch version is
// ops/psf.py:splat_reference; the two agree bit for bit.
//
// Sum order, fixed and free of atomics: each pair's rays are cut into spans
// (ops/psf.py:splat_span, a function of the shape alone). Each bin's span
// sum runs over the span's rays in order, from 0.0, in double (a product of
// two float32 factors is exact there); the span sums go to a workspace of
// doubles, and the last kernel adds them in span order from 0.0 and rounds
// once.
//
// Two routes give those bits, picked by the half grid's size alone
// (ops/psf.py splat_fwd_windowed): the dense kernel forms every ray's term
// at every bin, and runs on half grids of at most SPLAT_DENSE_BINS bins,
// the default configuration's 65 x 33 among them; the windowed kernels
// form only the terms inside each ray's windows, and take the larger
// grids, where the dense kernel's work grows with the bins and theirs does
// not (the crossover: chip_smoke.py --s1-crossover, PERF.md).
//
// The dense kernel (s1_fwd_kernel). What bounds it on an H100, at the
// default configuration: 8.86e9 products and as many sums, and 4.05e8
// factors of 6 operations (one exp and one division among them), 2.01e10
// operations, 0.30 ms at 67 TFLOP/s; the bytes (x, y and the weights read
// once, the half kernels written once) take 0.01 ms, so TMA would buy
// nothing: a stage's coordinates come in as 16-byte loads, issued a stage
// ahead. Operations bound it, and of them the factors weigh most: each
// one's IEEE division (a reciprocal, a check and a refinement, with its
// own slow-path branch) and expf run on the SM's quarter-rate units, 98
// factors a ray and pair against 3,200 multiply-adds a ray on the tensor
// cores.
//
// Design, as a matrix product half = EYW^T EX over the rays (M = n_y, N =
// n_x/2, K = the span's rays), warp-specialised:
// - Products on the FP64 tensor cores (float32 inputs): mma.sync m16n8k4,
//   which rounds as the chain of fused multiply-adds in k order (the probe,
//   psf_splat_probe.cu, checks it bit for bit on the card, and measures it
//   at twice the rate of m8n8k4 and of DFMA), so the k-steps in ray order
//   give the plain version's sum. A consumer warp holds one 16-row tile of
//   bins by NW 8-column tiles (65 x 33: 5 warps, 80 x 40 after padding) and
//   runs it over every ray of the span (dense::mma_chain, no predicates: the
//   padding is zero); float64 inputs keep the same tiles on separate double
//   multiplies and adds (s1::madd).
// - Factors overlapped with the products: producer warps fill a ring of
//   MAX_STAGES stages of CHUNK rays (eyw[ray][iy], ex[ray][ix] as doubles,
//   row pitches that keep the fragments' loads free of bank conflicts)
//   while the consumers read the previous one; named barriers (FULL,
//   EMPTY) hand a stage over, never a whole-block barrier. A producer
//   thread's 4 rays and bins are a fixed map (dense::ProducerMap), its four
//   divisions issued before its four exps (dense::gauss4).
// - Two blocks an SM (the grid's rule in splat_span), one wave at the
//   default shape: 63 pairs x 4 spans of 16,384 rays.
// - Any half grid: a block holds one tile of bins, at most MAX_MT 16-row
//   tiles by MAX_NG groups of NW 8-column tiles (144 x 80 bins); a grid
//   larger than that is cut into equal tiles (FwdTiles, the last of each
//   axis shorter), a block each per (pair, span). Each bin's sum runs over
//   the span's rays in order whatever tile holds it, so the tiles change no
//   bit; a grid of one tile (up to 144 x 80) runs as before. Each tile's
//   producers compute only its bins' factors.
//
// The windowed kernels. Each bin's span sum takes only the rays whose
// windows hold it. compute_psf sets sigma to half a bin, and a factor exp(-q / 2) is exactly
// +0 once q > q_max (psf_splat.cuh: 210 for float32, 7.2 bins either side
// at that sigma; 1500 for float64, 19.4 bins). Why that gives the plain
// version's bits:
// - outside a ray's window on either axis its factor there is +0, and the
//   other factor is finite, so the term is +-0;
// - a span sum starts at +0.0, so it is never -0.0, and adding +-0 to it
//   changes no bit: leaving the term out is exact;
// - a term kept is, for float32 inputs, the exact double product plus one
//   rounding, which is one mma.sync .f64 step (the fma chain in k order,
//   probed on the card by psf_splat_probe.cu), the plain version's acc +=
//   term; for float64 inputs a separate multiply and add (the library is
//   built with -fmad=false);
// - what would break the first point takes the whole grid, in the same
//   order: a ray whose x, y or w is not finite, and every ray of a grid
//   whose centres are not finite and ascending or whose sigma^2 (in the
//   inputs' type) is not finite and positive; a ray of zero weight with a
//   finite x and y on a ruled grid has only +-0 terms, and none is kept.
// The window rule (s1::window: a guess confirmed at the bins just outside,
// else bisection) is the adjoint's; ops/psf.py:splat_over_windows is its
// plain twin, held against splat_reference bit for bit in the tests.
//
// Design, three launches on the stream:
// 1. s1_fwd_window_kernel, one thread a ray: each ray's windows (rows, then
//    columns) into scratch, 16 bytes a ray, an empty row window where no
//    term is kept; and a flag for each (pair, span, band of 16 rows) that a
//    ray's row window reaches.
// 2. s1_fwd_band_kernel, a block per (pair, span, band, chunk of at most
//    MAX_CONSUMERS column tiles of 16), warp-specialised: PRODUCERS warps
//    walk the span's rays in order, BATCH at a time (one a thread), list
//    those whose windows reach the band and the chunk (a ballot a warp and
//    a prefix over the warps, so the list keeps ray order) and form their
//    factors into a ring of SLOTS in shared memory, one factor a lane: the
//    band's 16 rows and the first WX columns of each ray's window, 0.0
//    outside the windows, where the factor is +0. A consumer warp a column
//    tile holds its 16 x 16 sums in registers as the D fragments of
//    mma.sync m16n8k4 (M = rows, N = columns, K = rays), queues the slot's
//    rays whose column window reaches its tile, in order, and runs one
//    k-step a column tile for every 4 of them, U k-steps' fragments read
//    before their products: float32 products on the FP64 tensor cores,
//    float64 by shuffles and separate multiplies and adds. A window wider
//    than WX columns has its factors formed by the consumer (+inf centres
//    past the grid, whose sums are never written); a slot's last k-step is
//    padded with zero slots. Named barriers hand a slot over (FULL, EMPTY),
//    so the producers run up to SLOTS batches ahead. A band that no ray
//    reaches (by the window pass's flag) writes its zeros and stops.
// 3. s1_fwd_reduce: each bin's span sums in span order, rounded once.
// Bins no ray reaches keep their sums' +0.0; every bin is written.
//
// What bounds them on an H100 (63 pairs, 65,536 rays; a ray's windows are 6.4
// x 14.5 bins on the default 65 x 33 half grid, 7.5 x 14.5 at psf 257, and
// 24-30 % of the rays reach no bin): the windows' work, a product and a sum
// a window bin and 6 operations a factor, 1.3e9-1.4e9 operations (0.02 ms
// at 67 TFLOP/s); the bytes (rays read once, the kernels written once)
// 0.01 ms. What holds it: a PSF's core puts most of a span's rays into two
// bands and one column tile, so one consumer warp a band runs ~2,900
// dependent k-steps (a bin's sum is one chain in ray order), and its
// producers form ~20 factors a ray meanwhile.
//
// The workspace: the span sums, n_pairs x n_spans x n_y x n_x/2 doubles,
// on both routes (4.3 MB at the default grid, 66.8 MB at psf 257); on the
// windowed route also the windows, 16 bytes a ray (66.1 MB at 63 x 65,536
// rays) and 4 a (pair, span, band)'s flag.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "psf_splat.cuh"

namespace {

using s1::CHUNK;

__device__ inline void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ inline void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The dense kernel's sizes: n-tiles of 8 bins a consumer warp holds (40
// bins), the ring's stages, and its named barriers: FULL + s (the producers
// filled stage s), EMPTY + s (the consumers are done with it); barrier 0 is
// __syncthreads().
namespace dense {

constexpr int NW = 5;
constexpr int MAX_STAGES = 3;
constexpr int BAR_FULL = 1;
constexpr int BAR_EMPTY = BAR_FULL + MAX_STAGES;


// The row pitch, in doubles, of a shared array of n columns: n rounded up to
// an odd multiple of 4. The tensor-core fragments read 4 rows x 4 (or 8)
// columns a half warp; an odd multiple of 4 puts those 16 doubles on 16
// distinct pairs of banks, so no load conflicts.
__host__ __device__ inline int pitch(int n) {
  const int p = s1::cdiv(n, 4);
  return 4 * (p % 2 ? p : p + 1);
}

// A consumer warp's tile: acc[n] += A B over k < k_len, for the 16 rows of
// A from A(0, .) and the NW 8-column tiles of B from B(., 0), where A(m, k) =
// A[m am + k ak] and B(k, n) = B[k bk + n bn] in shared memory; acc[n] as
// dmma16's D: rows lane / 4 (+ 8), columns 8 n + 2 (lane % 4) (+ 1). For
// float32 inputs (T = float) k_len is a multiple of 4 and the k-steps run
// on the tensor cores; for float64, separate multiplies and adds in k order.
// No predicates: every tile of B is in the padded, zeroed layout.
template <typename T>
__device__ inline void mma_chain(double (&acc)[NW][4], const double* A, int am, int ak,
                                 const double* B, int bk, int bn, int k_len, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
    const double* a = A + g * am + t * ak;
    const double* b = B + t * bk + g * bn;
#pragma unroll 4
    for (int k0 = 0; k0 < k_len; k0 += 4) {
      const double a0 = a[k0 * ak], a1 = a[k0 * ak + 8 * am];
#pragma unroll
      for (int n = 0; n < NW; ++n) s1::dmma16(acc[n], a0, a1, b[k0 * bk + 8 * n * bn]);
    }
  } else {
    const double* a = A + g * am;
    const double* b = B + 2 * t * bn;
    for (int k = 0; k < k_len; ++k) {
      const double a0 = a[k * ak], a1 = a[k * ak + 8 * am];
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const double b0 = b[k * bk + 8 * n * bn], b1 = b[k * bk + (8 * n + 1) * bn];
        acc[n][0] = s1::madd(a0, b0, acc[n][0]);
        acc[n][1] = s1::madd(a0, b1, acc[n][1]);
        acc[n][2] = s1::madd(a1, b0, acc[n][2]);
        acc[n][3] = s1::madd(a1, b1, acc[n][3]);
      }
    }
  }
}

// Four consecutive values from p, zeros past n_valid: one 16-byte load (two
// for double) where p is 16-byte aligned and all four are there.
template <typename T>
__device__ inline void load4(const T* p, int n_valid, T (&v)[4]) {
  if (n_valid >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
    } else {
      const double2 a = *reinterpret_cast<const double2*>(p);
      const double2 b = *reinterpret_cast<const double2*>(p + 2);
      v[0] = a.x;
      v[1] = a.y;
      v[2] = b.x;
      v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n_valid ? p[j] : T(0);
  }
}

// The plain formula's factor (s1::factor) for four values v at once, the
// four divisions first and then the four exps, so that the exps overlap
// (each division keeps its own slow-path branch).
template <typename T>
__device__ inline void gauss4(const T (&v)[4], T c, T s2, T (&e)[4]) {
  T q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T d = v[j] - c;
    q[j] = (d * d) / s2;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = s1::exp_t(-q[j] / T(2));
}

// A producer thread's 4 rays: x, y and w (1 without weights), zeros past
// the span's end (n_valid of them are rays).
template <typename T>
struct Quad {
  T x[4], y[4], w[4];
  int n_valid;

  __device__ void load(const T* __restrict__ xp, const T* __restrict__ yp,
                       const T* __restrict__ wp, int r, int r_end) {
    n_valid = r_end - r;
    load4(xp + r, n_valid, x);
    load4(yp + r, n_valid, y);
    if (wp)
      load4(wp + r, n_valid, w);
    else
      w[0] = w[1] = w[2] = w[3] = T(1);
  }
};

// The producers' fixed map: of n_prod producer threads, `per` = n_prod /
// (rays / 4) share each group of 4 rays; thread pt takes group pt / per and
// the bins pt % per, + per, ... of the ny + nx factors (y's first, then x).
// A stage's coordinates come in as one 16-byte load a coordinate (two for
// double), for the next stage while this one is computed.
struct ProducerMap {
  int rg, q, per;

  __device__ ProducerMap(int pt, int n_prod, int rays) {
    per = n_prod / (rays / 4);
    rg = pt / per;
    q = pt - rg * per;
  }
};

// This thread's share of one stage's factors: for its 4 rays (quad), ey
// (times w with `weighted`) into E[ray][iy] (pitch pe) and ex into
// X[ray][ix] (pitch px), as doubles, zeros for the rays past the span's
// end; cy and cx hold the ny centres of y's bins and the nx of x's (in
// shared or global memory).
template <typename T>
__device__ inline void stage_factors(const ProducerMap& m, const Quad<T>& quad, const T* cy,
                                     const T* cx, T s2x, T s2y, int ny, int nx, bool weighted,
                                     double* E, int pe, double* X, int px) {
  for (int b = m.q; b < ny + nx; b += m.per) {
    const bool is_y = b < ny;
    const T c = is_y ? cy[b] : cx[b - ny];
    T v[4], e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = is_y ? quad.y[j] : quad.x[j];
    gauss4(v, c, is_y ? s2y : s2x, e);
    const int p = is_y ? pe : px;
    double* dst = (is_y ? E + b : X + (b - ny)) + (size_t)(4 * m.rg) * p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (weighted && is_y) e[j] = e[j] * quad.w[j];
      dst[j * p] = j < quad.n_valid ? (double)e[j] : 0.0;
    }
  }
}

// 288 producer threads: 36 a group of 4 rays, each at most 3 of the default
// grid's 98 factors a stage. With its 5 consumers a block has 14 warps, and
// two blocks of 72 registers a thread share an SM.
constexpr int PRODUCER_WARPS = 9;
// The largest tile: MAX_MT row tiles of 16 by MAX_NG column groups of NW
// tiles of 8 (144 x 80 bins), one consumer warp each; with the producers,
// a block's threads at most.
constexpr int MAX_MT = 9;
constexpr int MAX_NG = 2;
constexpr int MAX_THREADS = (MAX_MT * MAX_NG + PRODUCER_WARPS) * 32;
// The shared memory a block aims at, so that two fit an SM.
constexpr size_t SMEM_TWO = 113 * 1024;

// A forward block's shape: mt 16-row tiles of bins by ng groups of NW
// 8-column tiles (the last padded with zero columns); consumer warps mt x
// ng; a stage's rows of eyw (pitch pe) and of ex (pitch px), in doubles,
// after the grid's centres (ny + nx of the inputs' type, gy's first).
struct FwdLayout {
  int mt, ng, consumers, pe, px;
  size_t stage0, stage;

  __host__ __device__ FwdLayout(int ny, int nx) {
    mt = s1::cdiv(ny, 16);
    ng = s1::cdiv(nx, 8 * NW);
    consumers = mt * ng;
    pe = pitch(16 * mt);
    px = pitch(8 * NW * ng);
    stage0 = (size_t)ny + nx;
    stage = (size_t)CHUNK * (pe + px);
  }

  size_t bytes(int stages) const { return sizeof(double) * (stage0 + stage * stages); }
};

// A grid's tiles: n_ty x n_tx of tile_ny x tile_nx bins (the last row and
// column of tiles shorter), each at most MAX_MT x MAX_NG of the consumers'
// tiles; one tile, the whole grid, up to 144 x 80 bins.
struct FwdTiles {
  int tile_ny, tile_nx, n_ty, n_tx;

  FwdTiles(int ny, int nx) {
    const int mt = s1::cdiv(ny, 16), ng = s1::cdiv(nx, 8 * NW);
    tile_ny = mt <= MAX_MT ? ny : 16 * s1::cdiv(mt, s1::cdiv(mt, MAX_MT));
    tile_nx = ng <= MAX_NG ? nx : 8 * NW * s1::cdiv(ng, s1::cdiv(ng, MAX_NG));
    n_ty = s1::cdiv(ny, tile_ny);
    n_tx = s1::cdiv(nx, tile_nx);
  }
};

// The most stages (up to MAX_STAGES) that let two blocks share an SM, or
// else one block; 0 if not even one stage fits.
int fwd_stages(const FwdLayout& L) {
  const size_t caps[2] = {SMEM_TWO, s1::SMEM_MAX};
  for (size_t cap : caps)
    for (int s = MAX_STAGES; s >= 1; --s)
      if (L.bytes(s) <= cap) return s;
  return 0;
}

// Block b = (pair * n_spans + span) * n_tiles + tile: its span's sums of
// the tile's bins, into partials[pair * n_spans + span][iy][ix]. Warps [0,
// consumers) consume, the rest produce.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) s1_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, double* __restrict__ partials, int n_ch, int n_rays, int ny,
    int nx, int span, int n_spans, int n_stages, int tile_ny, int tile_nx, int n_tx,
    int n_tiles) {
  extern __shared__ double smem[];
  const int block = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - block * n_tiles;
  const int y0 = tile / n_tx * tile_ny, x0 = tile % n_tx * tile_nx;
  const int tny = min(tile_ny, ny - y0), tnx = min(tile_nx, nx - x0);
  const FwdLayout L(tny, tnx);
  const int pair = block / n_spans;
  const int g = pair / n_ch;
  const int r0 = (block - pair * n_spans) * span;
  const int r_end = min(r0 + span, n_rays);
  const int n_steps = s1::cdiv(r_end - r0, CHUNK);
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  // The tile's centres; every stage zeroed once (the padding stays zero).
  T* cen = reinterpret_cast<T*>(smem);
  for (int k = tid; k < tny + tnx; k += threads)
    cen[k] = k < tny ? gy[(size_t)g * ny + y0 + k] : gx[(size_t)g * nx + x0 + k - tny];
  for (size_t k = L.stage0 + tid; k < L.stage0 + L.stage * n_stages; k += threads) smem[k] = 0.0;
  __syncthreads();

  const int warp = tid >> 5;
  if (warp >= L.consumers) {
    const T s2x = sx[g] * sx[g];
    const T s2y = sy[g] * sy[g];
    const size_t base = (size_t)pair * n_rays;
    const T* xp = x + base;
    const T* yp = y + base;
    const T* wp = w ? w + base : nullptr;
    const ProducerMap map(tid - 32 * L.consumers, threads - 32 * L.consumers, CHUNK);
    Quad<T> quad, next;
    quad.load(xp, yp, wp, r0 + 4 * map.rg, r_end);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % n_stages;
      if (i + 1 < n_steps) next.load(xp, yp, wp, r0 + (i + 1) * CHUNK + 4 * map.rg, r_end);
      if (i >= n_stages) bar_sync(BAR_EMPTY + s, threads);
      double* E = smem + L.stage0 + s * L.stage;
      stage_factors<T>(map, quad, cen, cen + tny, s2x, s2y, tny, tnx, w != nullptr, E, L.pe,
                           E + CHUNK * L.pe, L.px);
      bar_arrive(BAR_FULL + s, threads);
      quad = next;
    }
    return;
  }

  // Consumer: row tile mi, column tiles NW * nj + n; D as the m16n8k4
  // fragment: acc[n] = rows 16 mi + gid (+ 8), columns 8 (NW nj + n) + 2 tig
  // (+ 1).
  const int mi = warp / L.ng, nj = warp - mi * L.ng;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  double acc[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % n_stages;
    bar_sync(BAR_FULL + s, threads);
    const double* E = smem + L.stage0 + s * L.stage;
    const double* X = E + CHUNK * L.pe;
    // A(m, k) = eyw[ray k][row tile + m], B(k, n) = ex[ray k][column group + n].
    mma_chain<T>(acc, E + 16 * mi, 1, L.pe, X + 8 * NW * nj, L.px, 1, CHUNK, lane);
    if (i + n_stages < n_steps) bar_arrive(BAR_EMPTY + s, threads);
  }
  double* dst = partials + (size_t)block * ny * nx + (size_t)y0 * nx + x0;
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int iy = 16 * mi + gid + 8 * (v >> 1), ix = 8 * (NW * nj + n) + 2 * tig + (v & 1);
      if (iy < tny && ix < tnx) dst[(size_t)iy * nx + ix] = acc[n][v];
    }
}

}  // namespace dense

// The windowed kernels' sizes.
constexpr int WIN_THREADS = 256;
// Rays a thread of the window kernel takes, about: the parts a pair's rays
// are cut into.
constexpr int WIN_RAYS = 4 * WIN_THREADS;
// A consumer warp's tile: BAND rows by NT column tiles of 8 (TILE_X
// columns).
constexpr int BAND = 16;
constexpr int NT = 2;
constexpr int TILE_X = 8 * NT;
// A block: PRODUCERS warps that list and form the factors of BATCH rays at
// a time (one a thread) into a ring of SLOTS, and a consumer warp for each
// column tile of its chunk of the band, at most MAX_CONSUMERS (a wider band
// is cut into chunks, a block each).
constexpr int PRODUCERS = 4;
constexpr int BATCH = 32 * PRODUCERS;
constexpr int SLOTS = 4;
constexpr int MAX_CONSUMERS = 8;
constexpr int MAX_THREADS = 32 * (PRODUCERS + MAX_CONSUMERS);
// The x factors a listed ray keeps: those of its window's first WX columns
// (every float32 window at compute_psf's sigma: at most 15 bins); a wider
// window's are formed by the consumer that uses them.
constexpr int WX = 16;
// Listed rays a producer warp forms the factors of at a time.
constexpr int FP = 4;
// A consumer's queue of listed rays: at most 3 left from the last pass and
// 32 added.
constexpr int QUEUE = 40;
// The most columns whose centres a block stages in shared memory (wider
// grids read them from global memory).
constexpr int CEN_MAX = 4096;
// Named barriers: the producers' own, then each slot's FULL (the producers
// filled it) and EMPTY (the consumers are done with it); 0 is
// __syncthreads().
constexpr int BAR_PRODUCERS = 1;
constexpr int BAR_FULL = 2;
constexpr int BAR_EMPTY = BAR_FULL + SLOTS;

// A slot of the ring, in shared memory, for each of BATCH listed rays: its
// factors of the band's rows (E) and of its window's first WX columns (X),
// its x, y and w, its windows; each array from `base`, one after another.
template <typename T>
struct Slot {
  T *E, *X, *x, *y, *w;
  int2 *yw, *xw;

  static constexpr size_t bytes = BATCH * ((BAND + WX + 3) * sizeof(T) + 2 * sizeof(int2));

  __device__ Slot(char* base) {
    E = reinterpret_cast<T*>(base);
    X = E + BATCH * BAND;
    x = X + BATCH * WX;
    y = x + BATCH;
    w = y + BATCH;
    yw = reinterpret_cast<int2*>(w + BATCH);
    xw = yw + BATCH;
  }
};

// A forward block's shared memory: the ring, then, with `cen`, the grid's
// nx column centres.
template <typename T>
size_t fwd_smem(int nx, bool cen) {
  return SLOTS * Slot<T>::bytes + (cen ? (size_t)nx * sizeof(T) : 0);
}

// Block b = pair * n_parts + part: the windows of the part's rays, rows into
// ywin and columns into xwin, [lo, hi] each; the whole grid where a ray's
// x, y or w is not finite or the grid is not ruled; rows [0, -1] (empty)
// where no term of the ray is kept. Each ray with a row window sets the
// flag of each band of BAND rows it reaches, band_hit[(pair * n_spans +
// span) * n_bands + band] (zeroed beforehand).
template <typename T>
__global__ void __launch_bounds__(WIN_THREADS) s1_fwd_window_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, int2* __restrict__ ywin, int2* __restrict__ xwin,
    int* __restrict__ band_hit, int n_ch, int n_rays, int ny, int nx, int n_parts, int span,
    int n_spans, int n_bands) {
  const int tid = threadIdx.x;
  const int pair = blockIdx.x / n_parts;
  const int part = blockIdx.x - pair * n_parts;
  const int g = pair / n_ch;
  const T* cy = gy + (size_t)g * ny;
  const T* cx = gx + (size_t)g * nx;
  const bool asc = __syncthreads_and(s1::ascending(cy, ny, tid, blockDim.x) &&
                                     s1::ascending(cx, nx, tid, blockDim.x));
  const s1::Axis<T> ay = s1::make_axis(cy, ny, sy[g]);
  const s1::Axis<T> ax = s1::make_axis(cx, nx, sx[g]);
  const bool ruled = asc && s1::sigma_ok(ay) && s1::sigma_ok(ax);
  const long long per = s1::cdiv(n_rays, n_parts);
  const int r_end = (int)min((long long)n_rays, (part + 1) * per);
  for (int r = (int)(part * per) + tid; r < r_end; r += blockDim.x) {
    const size_t i = (size_t)pair * n_rays + r;
    const T xv = x[i], yv = y[i];
    const T wv = w ? w[i] : T(1);
    int ylo = 0, yhi = ny - 1, xlo = 0, xhi = nx - 1;
    if (ruled && isfinite(xv) && isfinite(yv) && isfinite(wv)) {
      s1::window(ax, xv, xlo, xhi);
      s1::window(ay, yv, ylo, yhi);
      if (xlo > xhi || wv == T(0)) ylo = 0, yhi = -1;
    }
    ywin[i] = make_int2(ylo, yhi);
    xwin[i] = make_int2(xlo, xhi);
    // The flag of each band the row window reaches: one lane of those of a
    // warp that share a flag stores 1 where L2 still holds 0 (every store
    // writes the same value).
    const unsigned lanes = __activemask();
    const int b0 = ylo / BAND, nb = ylo <= yhi ? yhi / BAND - b0 + 1 : 0;
    const size_t first = ((size_t)pair * n_spans + r / span) * n_bands + b0;
    for (int k = 0; k < __reduce_max_sync(lanes, nb); ++k) {
      const unsigned long long key = k < nb ? first + k : ~0ull;
      const unsigned same = __match_any_sync(lanes, key);
      if (k < nb && (threadIdx.x & 31) == __ffs(same) - 1 && __ldcg(band_hit + key) == 0)
        band_hit[key] = 1;
    }
  }
}

// Block b = ((pair * n_spans + span) * n_bands + band) * n_chunks + chunk:
// the span's sums of the bins of rows [BAND band, BAND band + BAND) and of
// the chunk's column tiles (consumer k: columns from TILE_X (MAX_CONSUMERS
// chunk + k)), into partials[pair * n_spans + span][iy][ix]. Warps [0,
// PRODUCERS) produce, the rest consume.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) s1_fwd_band_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ sx, const T* __restrict__ sy,
    const T* __restrict__ w, const int2* __restrict__ ywin, const int2* __restrict__ xwin,
    const int* __restrict__ band_hit, double* __restrict__ partials, int n_ch, int n_rays,
    int ny, int nx, int span, int n_spans, int n_bands, int n_chunks, int cen) {
  // k-steps a consumer runs together: their fragments read before their
  // products.
  constexpr int U = 4;
  extern __shared__ double smem[];
  char* ring = reinterpret_cast<char*>(smem);
  __shared__ unsigned masks[PRODUCERS];
  __shared__ int listed_in[SLOTS];
  __shared__ int queues[MAX_CONSUMERS][QUEUE];
  const int threads = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const unsigned below = (1u << lane) - 1;
  int b = blockIdx.x;
  const int chunk = b % n_chunks;
  b /= n_chunks;
  const int band = b % n_bands;
  const int block = b / n_bands;  // pair * n_spans + span
  const int pair = block / n_spans;
  const int g = pair / n_ch;
  const int r0 = (block - pair * n_spans) * span;
  const int r_end = min(r0 + span, n_rays);
  const size_t base = (size_t)pair * n_rays;
  const int y0 = BAND * band;
  // The chunk's columns [cx0, cx1), and a consumer's [x0, x0 + TILE_X).
  const int cx0 = TILE_X * MAX_CONSUMERS * chunk;
  const int cx1 = min(nx, cx0 + TILE_X * (threads / 32 - PRODUCERS));
  const int x0 = cx0 + TILE_X * (warp - PRODUCERS);
  const T* cy = gy + (size_t)g * ny;
  const T* cx = gx + (size_t)g * nx;
  const T s2y = sy[g] * sy[g];
  const T s2x = sx[g] * sx[g];
  // A lane's factor of v at centre c on its axis (rows for lanes 0-15 in
  // the producers' factor pass, columns for the consumers and lanes 16-31):
  // for float32 by the branch-free s1::factor_rcp, so that a warp's
  // independent factors overlap.
  const bool row = lane < BAND && warp < PRODUCERS;
  const T s2 = row ? s2y : s2x;
  const double rcp2 = 1.0 / (double)s2;
  auto factor = [&](T v, T c) -> T {
    if constexpr (sizeof(T) == 4)
      return s1::factor_rcp(v, c, rcp2);
    else
      return s1::factor(v, c, s2);
  };
  // No ray of the span reaches the band: its sums stay 0.0. Else the batches
  // of the span's rays, every one through the ring.
  const int n_batches = band_hit[(size_t)block * n_bands + band] ? s1::cdiv(r_end - r0, BATCH)
                                                                   : 0;

  if (warp < PRODUCERS) {
    // The columns' centres of the factors: staged where they fit (the first
    // batch's producer barrier publishes them).
    const T* cxf = cx;
    if (cen) {
      T* staged = reinterpret_cast<T*>(ring + SLOTS * Slot<T>::bytes);
      for (int k = tid; k < nx; k += BATCH) staged[k] = cx[k];
      cxf = staged;
    }
    const T cy_lane = lane < BAND && y0 + lane < ny ? cy[y0 + lane] : T(0);
    for (int i = 0; i < n_batches; ++i) {
      const int s = i % SLOTS;
      const Slot<T> slot(ring + s * Slot<T>::bytes);
      // 1. The batch's rays whose windows reach the band and the chunk,
      // listed in ray order (a ballot a warp, then each thread's place after
      // the earlier warps'), with their x, y, w and windows.
      const int r = r0 + i * BATCH + tid;
      int2 yw = make_int2(0, -1), xw = make_int2(0, -1);
      if (r < r_end) yw = ywin[base + r];
      bool hit = yw.x <= yw.y && yw.x < y0 + BAND && yw.y >= y0;
      if (hit) {
        xw = xwin[base + r];
        hit = xw.x < cx1 && xw.y >= cx0;
      }
      T xv = T(0), yv = T(0), wv = T(1);
      if (hit) {
        xv = x[base + r];
        yv = y[base + r];
        if (w) wv = w[base + r];
      }
      const unsigned m = __ballot_sync(~0u, hit);
      if (lane == 0) masks[warp] = m;
      if (i >= SLOTS) bar_sync(BAR_EMPTY + s, threads);
      bar_sync(BAR_PRODUCERS, BATCH);
      int listed = 0, place = 0;
#pragma unroll
      for (int k = 0; k < PRODUCERS; ++k) {
        const int c = __popc(masks[k]);
        place += k < warp ? c : 0;
        listed += c;
      }
      if (hit) {
        const int l = place + __popc(m & below);
        slot.x[l] = xv;
        slot.y[l] = yv;
        slot.w[l] = wv;
        slot.yw[l] = yw;
        slot.xw[l] = xw;
      }
      if (tid == 0) listed_in[s] = listed;
      bar_sync(BAR_PRODUCERS, BATCH);
      // 2. Their factors, a warp a ray, FP rays at a time: lanes 0-15 the
      // band's rows (times w), 16-31 the window's first WX columns, each
      // lane one factor; 0 outside the windows (the factor there is +0) and
      // past the grid.
      for (int l0 = warp; l0 < listed; l0 += FP * PRODUCERS) {
        T v[FP], c[FP], wf[FP], e[FP];
        bool in[FP];
#pragma unroll
        for (int j = 0; j < FP; ++j) {
          const int l = min(l0 + j * PRODUCERS, listed - 1);
          const int2 win = row ? slot.yw[l] : slot.xw[l];
          const int k = row ? y0 + lane : win.x + lane - BAND;
          in[j] = k >= win.x && k <= win.y;
          v[j] = row ? slot.y[l] : slot.x[l];
          c[j] = row ? cy_lane : (in[j] ? cxf[k] : T(0));
          wf[j] = row && w ? slot.w[l] : T(1);
        }
#pragma unroll
        for (int j = 0; j < FP; ++j) e[j] = factor(v[j], c[j]);
#pragma unroll
        for (int j = 0; j < FP; ++j) {
          const int l = l0 + j * PRODUCERS;
          if (w && row) e[j] = (in[j] ? e[j] : T(0)) * wf[j];
          else if (!in[j]) e[j] = T(0);
          if (l < listed)
            (row ? slot.E + l * BAND + lane : slot.X + l * WX + lane - BAND)[0] = e[j];
        }
      }
      bar_arrive(BAR_FULL + s, threads);
    }
    return;
  }

  // Consumer: the tile's sums as the m16n8k4 D fragments, acc[n] = rows y0 +
  // gid (+ 8), columns x0 + 8 n + 2 tig (+ 1).
  const bool active = x0 < nx;
  int* queue = queues[warp - PRODUCERS];
  // The lane's columns x0 + 8 n + gid, for a window wider than WX: +inf past
  // the grid (a factor of 0 there, or NaN for an infinite ray, whose sums
  // there are never written).
  T cxn[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    cxn[n] = x0 + 8 * n + gid < nx ? cx[x0 + 8 * n + gid] : T(INFINITY);
  double acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0;

  for (int i = 0; i < n_batches; ++i) {
    const int s = i % SLOTS;
    const Slot<T> slot(ring + s * Slot<T>::bytes);
    bar_sync(BAR_FULL + s, threads);
    const int listed = listed_in[s];
    // K k-steps of 4 queued rays each from queue slot h, in order: their
    // fragments first (E's rows gid and gid + 8; the columns from X, or
    // formed for a window wider than WX), then the products; slots of a
    // step from `valid` on are zero.
    auto steps = [&](int h, auto n_steps, int valid) {
      constexpr int K = decltype(n_steps)::value;
      double a0[K], a1[K], bx[K][NT];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool ok = tig < valid;
        const int l = ok ? queue[h + 4 * k + tig] : 0;
        const int2 xw = slot.xw[l];
        a0[k] = ok ? (double)slot.E[l * BAND + gid] : 0.0;
        a1[k] = ok ? (double)slot.E[l * BAND + gid + 8] : 0.0;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = x0 + 8 * n + gid;
          // X is 0 past a narrow window's end; a wide window's columns past
          // its first WX are formed here.
          T f;
          if (xw.y - xw.x < WX)
            f = c >= xw.x && c <= xw.y ? slot.X[l * WX + c - xw.x] : T(0);
          else
            f = factor(slot.x[l], cxn[n]);
          bx[k][n] = ok ? (double)f : 0.0;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int n = 0; n < NT; ++n) s1::dmma16(acc[n], a0[k], a1[k], bx[k][n]);
        } else {
          // The fragments' values gathered per ray j: rows gid (+ 8) from
          // lane 4 gid + j, columns 8 n + 2 tig (+ 1) from lanes 8 tig + j
          // (+ 4).
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double e0 = __shfl_sync(~0u, a0[k], 4 * gid + j);
            const double e1 = __shfl_sync(~0u, a1[k], 4 * gid + j);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const double f0 = __shfl_sync(~0u, bx[k][n], 8 * tig + j);
              const double f1 = __shfl_sync(~0u, bx[k][n], 8 * tig + 4 + j);
              acc[n][0] = s1::madd(e0, f0, acc[n][0]);
              acc[n][1] = s1::madd(e0, f1, acc[n][1]);
              acc[n][2] = s1::madd(e1, f0, acc[n][2]);
              acc[n][3] = s1::madd(e1, f1, acc[n][3]);
            }
          }
        }
      }
    };
    // The listed rays whose column window reaches the tile, queued in
    // order, run 4 a k-step; the batch's last k-step padded.
    if (active) {
      int queued = 0;
      for (int l0 = 0; l0 < listed; l0 += 32) {
        const int l = l0 + lane;
        bool keep = false;
        if (l < listed) {
          const int2 cw = slot.xw[l];
          keep = cw.x < x0 + TILE_X && cw.y >= x0;
        }
        const unsigned kept = __ballot_sync(~0u, keep);
        if (keep) queue[queued + __popc(kept & below)] = l;
        queued += __popc(kept);
        __syncwarp();
        int h = 0;
        for (; h + 4 * U <= queued; h += 4 * U) steps(h, std::integral_constant<int, U>(), 4);
        for (; h + 4 <= queued; h += 4) steps(h, std::integral_constant<int, 1>(), 4);
        const int rest = queued - h;
        const int moved = lane < rest ? queue[h + lane] : 0;
        __syncwarp();
        if (lane < rest) queue[lane] = moved;
        __syncwarp();
        queued = rest;
      }
      if (queued > 0) steps(0, std::integral_constant<int, 1>(), queued);
    }
    if (i + SLOTS < n_batches) bar_arrive(BAR_EMPTY + s, threads);
  }
  if (!active) return;
  double* dst = partials + (size_t)block * ny * nx;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int iy = y0 + gid + 8 * (v >> 1), ix = x0 + 8 * n + 2 * tig + (v & 1);
      if (iy < ny && ix < nx) dst[(size_t)iy * nx + ix] = acc[n][v];
    }
}

// Each bin's span sums added in span order from 0.0, rounded once, into the
// half kernels (pairs, ny, nx); zeros where a pair has no rays.
template <typename T>
__global__ void s1_fwd_reduce(const double* __restrict__ partials, T* __restrict__ out,
                              int n_spans, int bins, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long pair = idx / bins;
  const double* src = partials + pair * n_spans * bins + (idx - pair * bins);
  double s = 0.0;
  for (int sp = 0; sp < n_spans; ++sp) s = s + src[(size_t)sp * bins];
  out[idx] = (T)s;
}

// A half grid's blocks: bands of BAND rows, column tiles of TILE_X, the
// chunks of at most MAX_CONSUMERS tiles a band is cut into, and a block's
// consumers.
struct FwdGrid {
  int n_bands, n_tiles, n_chunks, consumers;

  FwdGrid(int ny, int nx) {
    n_bands = s1::cdiv(ny, BAND);
    n_tiles = s1::cdiv(nx, TILE_X);
    n_chunks = s1::cdiv(n_tiles, MAX_CONSUMERS);
    consumers = n_tiles < MAX_CONSUMERS ? n_tiles : MAX_CONSUMERS;
  }
};

// The ints of the forward's window scratch: each ray's windows (two int2)
// and each (pair, span, band)'s flag.
long long fwd_window_ints(long long n_pairs, int n_rays, int n_spans, int ny) {
  return n_pairs * (4LL * n_rays + (long long)n_spans * s1::cdiv(ny, BAND));
}

// The dense kernel's blocks (pairs x spans x tiles of the grid) on `stream`.
template <typename T>
cudaError_t launch_dense(const void* x, const void* y, const void* gx, const void* gy,
                         const void* sx, const void* sy, const void* w, double* partials,
                         long long n_pairs, int n_ch, int n_rays, int ny, int nx, int span,
                         int n_spans, cudaStream_t stream) {
  // The first tile is the largest: its layout sizes every block.
  const dense::FwdTiles tiles(ny, nx);
  const dense::FwdLayout L(tiles.tile_ny, tiles.tile_nx);
  const int stages = dense::fwd_stages(L);
  if (stages == 0) return cudaErrorInvalidValue;
  const int threads = (L.consumers + dense::PRODUCER_WARPS) * 32;
  const size_t smem = L.bytes(stages);
  const int n_tiles = tiles.n_ty * tiles.n_tx;
  const long long blocks = n_pairs * n_spans * n_tiles;
  if (blocks > 0x7fffffffLL || threads > dense::MAX_THREADS) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense::s1_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dense::s1_fwd_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
      (const T*)w, partials, n_ch, n_rays, ny, nx, span, n_spans, stages, tiles.tile_ny,
      tiles.tile_nx, tiles.n_tx, n_tiles);
  return cudaGetLastError();
}

// The windowed kernels (the windows, then a block per pair, span, band and
// chunk) on `stream`.
template <typename T>
cudaError_t launch_windowed(const void* x, const void* y, const void* gx, const void* gy,
                            const void* sx, const void* sy, const void* w, double* partials,
                            int* windows, long long n_pairs, int n_ch, int n_rays, int ny, int nx,
                            int span, int n_spans, cudaStream_t stream) {
  const FwdGrid grid(ny, nx);
  const int n_parts = s1::cdiv(n_rays, WIN_RAYS);
  const long long win_blocks = n_pairs * n_parts;
  const long long blocks = n_pairs * n_spans * grid.n_bands * grid.n_chunks;
  if (win_blocks > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  if (!windows) return cudaErrorInvalidValue;
  int2* ywin = reinterpret_cast<int2*>(windows);
  int2* xwin = ywin + n_pairs * n_rays;
  int* band_hit = reinterpret_cast<int*>(xwin + n_pairs * n_rays);
  cudaError_t err =
      cudaMemsetAsync(band_hit, 0, sizeof(int) * n_pairs * n_spans * grid.n_bands, stream);
  if (err != cudaSuccess) return err;
  s1_fwd_window_kernel<T><<<(unsigned)win_blocks, WIN_THREADS, 0, stream>>>(
      (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
      (const T*)w, ywin, xwin, band_hit, n_ch, n_rays, ny, nx, n_parts, span, n_spans,
      grid.n_bands);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool cen = nx <= CEN_MAX;
  const size_t smem = fwd_smem<T>(nx, cen);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(s1_fwd_band_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  s1_fwd_band_kernel<T><<<(unsigned)blocks, 32 * (PRODUCERS + grid.consumers), smem, stream>>>(
      (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
      (const T*)w, ywin, xwin, band_hit, partials, n_ch, n_rays, ny, nx, span, n_spans,
      grid.n_bands, grid.n_chunks, (int)cen);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                   const void* sy, const void* w, double* partials, int* windows, void* out,
                   int n_grids, int n_ch, int n_rays, int ny, int nx, int span, bool windowed,
                   cudaStream_t stream) {
  const long long n_pairs = (long long)n_grids * n_ch;
  const int n_spans = (n_rays + span - 1) / span;
  cudaError_t err =
      windowed ? launch_windowed<T>(x, y, gx, gy, sx, sy, w, partials, windows, n_pairs, n_ch,
                                    n_rays, ny, nx, span, n_spans, stream)
               : launch_dense<T>(x, y, gx, gy, sx, sy, w, partials, n_pairs, n_ch, n_rays, ny,
                                 nx, span, n_spans, stream);
  if (err != cudaSuccess) return err;
  const long long total = n_pairs * ny * nx;
  if (total > 0) {
    s1_fwd_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partials, (T*)out, n_spans, ny * nx, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The span's multiple (ops/psf.py SPLAT_CHUNK).
int s1_chunk() { return CHUNK; }

// The forward's tiles of an ny x nx half grid on its route (`windowed`:
// the windowed kernels', else the dense kernel's): tile rows and columns,
// and tiles along each axis, into out[4].
void s1_fwd_tiles(int ny, int nx, int windowed, int* out) {
  if (windowed) {
    const FwdGrid t(ny, nx);
    out[0] = BAND;
    out[1] = TILE_X;
    out[2] = t.n_bands;
    out[3] = t.n_tiles;
  } else {
    const dense::FwdTiles t(ny, nx);
    out[0] = t.tile_ny;
    out[1] = t.tile_nx;
    out[2] = t.n_ty;
    out[3] = t.n_tx;
  }
}

// The int32s of the windowed route's window scratch for n_pairs pairs of
// n_rays rays in n_spans spans on a half grid of ny rows.
long long s1_fwd_window_ints(long long n_pairs, int n_rays, int n_spans, int ny) {
  return fwd_window_ints(n_pairs, n_rays, n_spans, ny);
}

// Launches S1's forward on `stream` and returns cudaGetLastError() (0 on
// success): with `windowed` the windowed kernels (the windows, the band
// kernel), else the dense kernel; then the second pass. x, y and w (or
// null) (n_grids, n_ch, n_rays); gx (n_grids, nx), gy (n_grids, ny); sx, sy
// (n_grids,): float32, or float64 with `dbl`; of scratch, partials n_grids *
// n_ch * ceil(n_rays / span) * ny * nx doubles and, with `windowed`,
// windows of s1_fwd_window_ints int32s (else null); out (n_grids, n_ch, ny,
// nx) of the inputs' type; all contiguous. span: ops/psf.py:splat_span.
int s1_fwd_launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                  const void* sy, const void* w, double* partials, void* windows, void* out,
                  int n_grids, int n_ch, int n_rays, int ny, int nx, int span, int dbl,
                  int windowed, void* stream) {
  if (n_grids < 0 || n_ch < 0 || n_rays < 0 || ny < 1 || nx < 1 || span < CHUNK ||
      span % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* win = (int*)windows;
  const bool wd = windowed != 0;
  return (int)(dbl ? launch<double>(x, y, gx, gy, sx, sy, w, partials, win, out, n_grids, n_ch,
                                    n_rays, ny, nx, span, wd, s)
                   : launch<float>(x, y, gx, gy, sx, sy, w, partials, win, out, n_grids, n_ch,
                                   n_rays, ny, nx, span, wd, s));
}

}  // extern "C"
