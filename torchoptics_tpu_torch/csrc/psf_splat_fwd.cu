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
// order (s1::gauss4), w = 1 without weights. The plain PyTorch version is
// ops/psf.py:splat_reference; the two agree bit for bit.
//
// Sum order, fixed and free of atomics: each pair's rays are cut into spans
// (ops/psf.py:splat_span, a function of the shape alone: as many spans a
// pair as fill SPLAT_SLOTS = 132 SMs x 2 blocks, of equal length rounded up
// to CHUNK). A block sums one span's rays in order, from 0.0, in double (a
// product of two float32 factors is exact there); a bin's span sums go to a
// workspace of doubles (4.3 MB at the default shape), and the second kernel
// adds them in span order from 0.0 and rounds once.
//
// What bounds it on an H100, at the default configuration: 8.86e9 products
// and as many sums, and 4.05e8 factors of 6 operations (one exp and one
// division among them), 2.01e10 operations, 0.30 ms at 67 TFLOP/s; the
// bytes (x, y and the weights read once, the half kernels written once)
// take 0.01 ms, so TMA would buy nothing: a stage's coordinates come in as
// 16-byte loads, issued a stage ahead. Operations bound it, and of them
// the factors weigh most: each one's IEEE division (a reciprocal, a check
// and a refinement, with its own slow-path branch) and expf run on the
// SM's quarter-rate units, 98 factors a ray and pair against 3,200
// multiply-adds a ray on the tensor cores.
//
// Design, as a matrix product half = EYW^T EX over the rays (M = n_y, N =
// n_x/2, K = the span's rays), warp-specialised:
// - Products on the FP64 tensor cores (float32 inputs): mma.sync m16n8k4,
//   which rounds as the chain of fused multiply-adds in k order (the probe,
//   psf_splat_probe.cu, checks it bit for bit on the card, and measures it
//   at twice the rate of m8n8k4 and of DFMA), so the k-steps in ray order
//   give the plain version's sum. A consumer warp holds one 16-row tile of
//   bins by NW 8-column tiles (65 x 33: 5 warps, 80 x 40 after padding) and
//   runs it over every ray of the span (s1::mma_chain, no predicates: the
//   padding is zero); float64 inputs keep the same tiles on separate double
//   multiplies and adds (s1::madd).
// - Factors overlapped with the products: producer warps fill a ring of
//   MAX_STAGES stages of CHUNK rays (eyw[ray][iy], ex[ray][ix] as doubles,
//   row pitches that keep the fragments' loads free of bank conflicts)
//   while the consumers read the previous one; named barriers (FULL,
//   EMPTY) hand a stage over, never a whole-block barrier. A producer
//   thread's 4 rays and bins are a fixed map (s1::ProducerMap), its four
//   divisions issued before its four exps (s1::gauss4).
// - Two blocks an SM (the grid's rule in splat_span), one wave at the
//   default shape: 63 pairs x 4 spans of 16,384 rays.
// - Any half grid: a block holds one tile of bins, at most MAX_MT 16-row
//   tiles by MAX_NG groups of NW 8-column tiles (144 x 80 bins); a grid
//   larger than that is cut into equal tiles (FwdTiles, the last of each
//   axis shorter), a block each per (pair, span). Each bin's sum runs over
//   the span's rays in order whatever tile holds it, so the tiles change no
//   bit; a grid of one tile (up to 144 x 80) runs as before. Each tile's
//   producers compute only its bins' factors.

#include <cuda_runtime.h>

#include "psf_splat.cuh"

namespace {

using s1::CHUNK;
using s1::NW;

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
    pe = s1::pitch(16 * mt);
    px = s1::pitch(8 * NW * ng);
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
    for (int s = s1::MAX_STAGES; s >= 1; --s)
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
    const s1::ProducerMap map(tid - 32 * L.consumers, threads - 32 * L.consumers, CHUNK);
    s1::Quad<T> quad, next;
    quad.load(xp, yp, wp, r0 + 4 * map.rg, r_end);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % n_stages;
      if (i + 1 < n_steps) next.load(xp, yp, wp, r0 + (i + 1) * CHUNK + 4 * map.rg, r_end);
      if (i >= n_stages) s1::bar_sync(s1::BAR_EMPTY + s, threads);
      double* E = smem + L.stage0 + s * L.stage;
      s1::stage_factors<T>(map, quad, cen, cen + tny, s2x, s2y, tny, tnx, w != nullptr, E, L.pe,
                           E + CHUNK * L.pe, L.px);
      s1::bar_arrive(s1::BAR_FULL + s, threads);
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
    s1::bar_sync(s1::BAR_FULL + s, threads);
    const double* E = smem + L.stage0 + s * L.stage;
    const double* X = E + CHUNK * L.pe;
    // A(m, k) = eyw[ray k][row tile + m], B(k, n) = ex[ray k][column group + n].
    s1::mma_chain<T>(acc, E + 16 * mi, 1, L.pe, X + 8 * NW * nj, L.px, 1, CHUNK, lane);
    if (i + n_stages < n_steps) s1::bar_arrive(s1::BAR_EMPTY + s, threads);
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

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                   const void* sy, const void* w, double* partials, void* out, int n_grids,
                   int n_ch, int n_rays, int ny, int nx, int span, cudaStream_t stream) {
  const long long n_pairs = (long long)n_grids * n_ch;
  const int n_spans = (n_rays + span - 1) / span;
  // The first tile is the largest: its layout sizes every block.
  const FwdTiles tiles(ny, nx);
  const FwdLayout L(tiles.tile_ny, tiles.tile_nx);
  const int stages = fwd_stages(L);
  if (stages == 0) return cudaErrorInvalidValue;
  const int threads = (L.consumers + PRODUCER_WARPS) * 32;
  const size_t smem = L.bytes(stages);
  const int n_tiles = tiles.n_ty * tiles.n_tx;
  const long long blocks = n_pairs * n_spans * n_tiles;
  if (blocks > 0x7fffffffLL || threads > MAX_THREADS) return cudaErrorInvalidValue;
  cudaError_t err;
  if (blocks > 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(s1_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    s1_fwd_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
        (const T*)x, (const T*)y, (const T*)gx, (const T*)gy, (const T*)sx, (const T*)sy,
        (const T*)w, partials, n_ch, n_rays, ny, nx, span, n_spans, stages, tiles.tile_ny,
        tiles.tile_nx, tiles.n_tx, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
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

// The rays a forward stage holds.
int s1_chunk() { return CHUNK; }

// The forward's tiles of an ny x nx half grid: tile rows and columns, and
// tiles along each axis, into out[4].
void s1_fwd_tiles(int ny, int nx, int* out) {
  const FwdTiles t(ny, nx);
  out[0] = t.tile_ny;
  out[1] = t.tile_nx;
  out[2] = t.n_ty;
  out[3] = t.n_tx;
}

// Launches S1's forward on `stream` (the main kernel and its second pass)
// and returns cudaGetLastError() (0 on success). x, y and w (or null)
// (n_grids, n_ch, n_rays); gx (n_grids, nx), gy (n_grids, ny); sx, sy
// (n_grids,): float32, or float64 with `dbl`; partials n_grids * n_ch *
// ceil(n_rays / span) * ny * nx doubles of scratch; out (n_grids, n_ch, ny,
// nx) of the inputs' type; all contiguous. span: ops/psf.py:splat_span.
int s1_fwd_launch(const void* x, const void* y, const void* gx, const void* gy, const void* sx,
                  const void* sy, const void* w, double* partials, void* out, int n_grids,
                  int n_ch, int n_rays, int ny, int nx, int span, int dbl, void* stream) {
  if (n_grids < 0 || n_ch < 0 || n_rays < 0 || ny < 1 || nx < 1 || span < CHUNK ||
      span % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dbl ? launch<double>(x, y, gx, gy, sx, sy, w, partials, out, n_grids, n_ch,
                                    n_rays, ny, nx, span, s)
                   : launch<float>(x, y, gx, gy, sx, sy, w, partials, out, n_grids, n_ch,
                                   n_rays, ny, nx, span, s));
}

}  // extern "C"
