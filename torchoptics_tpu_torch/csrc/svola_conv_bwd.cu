// P2's adjoint with respect to the PSFs (d/dpsf), for training through the
// rendered image.
//
// No TPU kernel is replaced: the JAX package computes the patch convolution
// by FFT (torchoptics_tpu/ops/image.py:svola_convolution) and XLA
// differentiates it. The forward kernel P2 (svola_conv.cu) computes
//
//   out[p, i, j, c] = sum_{a < kh, b < kw} psf[p, kh-1-a, kw-1-b, c]
//                                          * patch[p, i+a, j+b, c],
//
// so with the cotangent g of out,
//
//   dpsf[p, u, v, c] = sum_{i < hp, j < wp} g[p, i, j, c]
//                                           * patch[p, i+kh-1-u, j+kw-1-v, c]:
//
// kh * kw sums per patch-channel, each over the hp * wp outputs. (d/dpatch
// is P2 itself, on the cotangent zero-padded by (kh-1, kw-1) with the
// flipped PSF.) The plain PyTorch version is
// torchoptics_tpu_torch/ops/image.py:svola_patch_conv_dpsf_reference; the
// two agree bit for bit.
//
// Sum order, fixed and free of atomics, as the trace kernels sum their
// parameters: the outputs are cut into 32 x 32 tiles (the tail tiles padded
// with zero cotangents). Each tile's partial sum of a tap runs over the
// tile's positions in row-major order, from 0.0, in double; each product
// of two float32 values is exact in double, so a fused multiply-add rounds
// as the plain version's product and sum do. The partials go to a
// (patch-channels, tiles, kh*kw) buffer of doubles; the second kernel sums
// each tap's partials over the tiles in index order, from 0.0, and rounds
// once to float32. The patch-channels go in groups, one pair of launches a
// group, so that the buffer stays within PARTIALS_MAX (or one patch-channel's
// partials, where that is more): the default configuration's 4096^2 render
// would need 8.5 GB for all 243 at once. Each output's sums are the same
// whatever the grouping.
//
// What bounds it on an H100: kh*kw multiply-adds per output element, in
// double: at config 5's 1024^2 render (75 patch-channels, 306^2 outputs,
// K = 11) 8.5e8 multiply-adds, 1.7e9 operations, 25 us at 67 TFLOP/s (the
// card's rate for the inputs' float32, and its FP64 tensor-core rate); the
// bytes (the patches and the cotangent read once, the PSF gradient written
// once) take 17 us at 3.35 TB/s. Operations bound it. This design's double
// FMAs run outside the tensor cores, at 34 TFLOP/s: 50 us is its ceiling,
// two DFMA warp-instructions an SM a clock. An SM's shared memory serves
// 128 bytes a clock: a warp's load of 32 distinct doubles takes two clocks,
// so a thread must issue well under one distinct load per 4 DFMAs.
//
// Design: register blocking, as P2's forward (svola_conv.cu). A thread
// holds one tap row u and a chunk of CV consecutive tap columns, CV double
// accumulators. Along a row of positions the chunk's taps read a sliding
// window of one window row: with the position loop unrolled, a position
// loads one new window value and one cotangent (the same for every thread
// of an item: a broadcast) for CV multiply-adds, and the window values
// shift through registers by renaming. Square PSFs of kw = 3, 5 and 11
// (config 5's renders at 256^2 to 1024^2) have kernels of their own (CV =
// kw, every size of the index math a compile-time constant); any other PSF
// runs the same kernel in chunks of 8 columns (GENERIC_CV). A block takes
// several (tile, patch-channel) items, as many as the occupancy calculator
// says keep the most lanes of an SM busy (kh x chunks threads an item); an
// item's neighbours are the next channels of the same tile. The tile is
// walked STAGE rows a step: the step's window and cotangent rows are copied
// as float32 (cp.async, zero-filled outside the data) while the last step
// computes, then converted to double into the item's ring of window rows
// and its cotangent rows. Each tap's sum keeps the tile's row-major order
// from 0.0: register blocking changes no tap's order, so the result is bit
// for bit the plain version's. Its times on an H100, against the design it
// replaced (a thread a tap row and 4 columns, the whole tile resident), are
// in PERF.md, section 6: at K = 11 an item's copies and conversions cost
// about as many issue slots as its multiply-adds, so it stays well above
// its 0.05 ms FP64 ceiling at config 5's 1024^2.
//
// Wide PSFs: from P2_DPSF_FFT_MIN_KW taps on the larger side d/dpsf takes
// the FFT route's correlation (svola_fft.cu; ops/image.py routes the calls)
// where that was faster on an H100. This kernel takes kh and kw up to MAX_K
// (p2_dpsf_max_kw()), one tap below that threshold.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <array>
#include <map>
#include <mutex>

namespace {

constexpr int TILE = 32;         // outputs a tile side (ops/image.py DPSF_TILE)
constexpr int STAGE = 4;         // tile rows a step
constexpr int GENERIC_CV = 8;    // tap columns a thread, runtime kw
constexpr int MAX_THREADS = 512;
constexpr int MAX_ITEMS = 32;    // items a block, at most
constexpr size_t SMEM_MAX = 227 * 1024;  // a block's shared memory on an H100, at most
constexpr int MAX_K = 22;        // kh and kw at most (wider PSFs take svola_fft.cu)
constexpr long long PARTIALS_MAX = 1LL << 23;  // doubles of partials a group, 64 MB
// The kw with a kernel of their own (CV = kw).
constexpr int SPECIALIZED_KW[] = {3, 5, 11};

// Tap columns a thread for the kernel of kw KW (0: any kw).
__host__ __device__ constexpr int chunk_cols(int KW) { return KW == 0 ? GENERIC_CV : KW; }

// An item's layout in shared memory, for kh x kw taps at CV columns a thread.
// The tile is walked in steps of STAGE rows: the first `lead` steps bring
// window rows only (the kh - 1 rows above the first outputs' last tap), each
// later step STAGE window rows and the STAGE cotangent rows whose outputs it
// computes.
struct Layout {
  int chunks;  // column chunks: threads an item = kh * chunks
  int padl;    // zero columns left of the window: chunks * CV - kw
  int width;   // window columns: TILE + kw - 1 + padl
  int pitch;   // doubles a window row: width, odd
  int lead;    // steps before the first outputs: ceil((kh - 1) / STAGE)
  int ring;    // window rows held: (lead + 1) * STAGE
  int elems;   // float32 values a step brings: STAGE window rows, STAGE cotangent rows
  int stride;  // doubles an item: STAGE * TILE cotangents, then the ring; odd

  __host__ __device__ Layout(int kh, int kw, int cv) {
    chunks = (kw + cv - 1) / cv;
    padl = chunks * cv - kw;
    width = TILE + kw - 1 + padl;
    pitch = width | 1;
    lead = (kh - 1 + STAGE - 1) / STAGE;
    ring = (lead + 1) * STAGE;
    elems = STAGE * (width + TILE);
    stride = (STAGE * TILE + ring * pitch) | 1;
  }

  // An item's shared memory: its doubles, and the float32 landing area of
  // a step's copies.
  __host__ __device__ size_t bytes() const {
    return sizeof(double) * (size_t)stride + sizeof(float) * (size_t)elems;
  }
};

// One block: items b * m .. b * m + m - 1 of the group's (tile, patch-
// channel) items, item L being tile L / n_pcg of patch-channel
// pc0 + L % n_pcg. Shared memory: each item's doubles (a step's cotangent
// rows, then the ring of window rows), then each item's float32 landing
// area for the next step's copies.
template <int KW>
__global__ void __launch_bounds__(MAX_THREADS) p2_dpsf_kernel(
    const float* __restrict__ patches, const float* __restrict__ cot,
    double* __restrict__ partials, int n_ch, int ph, int pw, int kh_arg, int kw_arg, int n_tx,
    int n_tiles, int n_pcg, int pc0, int m) {
  constexpr int CV = chunk_cols(KW);
  // The kernel of a kw of its own takes square PSFs: its layout is then
  // known at compile time, and with it every division of the index math.
  const int kh = KW > 0 ? KW : kh_arg;
  const int kw = KW > 0 ? KW : kw_arg;
  const Layout lay(kh, kw, CV);
  extern __shared__ double smem[];
  float* landing = reinterpret_cast<float*>(smem + (size_t)m * lay.stride);
  __shared__ int4 s_item[MAX_ITEMS];  // (patch, channel, first row, first column)
  __shared__ int s_tile[MAX_ITEMS];
  const int hp = ph - kh + 1;
  const int wp = pw - kw + 1;
  const int n_items = n_tiles * n_pcg;
  const int first = blockIdx.x * m;
  const int m_here = min(m, n_items - first);
  if (threadIdx.x < m_here) {
    const int item = first + threadIdx.x;
    const int tile = item / n_pcg;
    const int pc = pc0 + (item - tile * n_pcg);
    const int p = pc / n_ch;
    s_item[threadIdx.x] = make_int4(p, pc - p * n_ch, (tile / n_tx) * TILE,
                                    (tile % n_tx) * TILE);
    s_tile[threadIdx.x] = tile;
  }
  __syncthreads();

  // Step st brings window rows st * STAGE .. + STAGE - 1 (patch rows
  // i0 + row, columns j0 + q - padl) and, from step lead on, the cotangent
  // rows (st - lead) * STAGE .. + STAGE - 1; zero outside the patch (read
  // only against zero cotangents), past the outputs and in the padding.
  // Value e of an item's step: window row e / width, column e % width, then
  // cotangent row (e - STAGE width) / TILE, column ... % TILE.
  const int n_elems = m_here * lay.elems;
  const int win_elems = STAGE * lay.width;
  auto copy_step = [&](int st) {
    for (int k = threadIdx.x; k < n_elems; k += blockDim.x) {
      const int it = k / lay.elems;
      const int e = k - it * lay.elems;
      const int4 id = s_item[it];
      const float* src = patches;
      bool in;
      if (e < win_elems) {
        const int r = e / lay.width, q = e - r * lay.width;
        const int y = id.z + st * STAGE + r, x = id.w + q - lay.padl;
        in = q >= lay.padl && y < ph && x < pw;
        if (in) src = patches + (((size_t)id.x * ph + y) * pw + x) * n_ch + id.y;
      } else {
        const int f = e - win_elems;
        const int r = f / TILE, j = id.w + f - r * TILE;
        const int i = id.z + (st - lay.lead) * STAGE + r;
        in = st >= lay.lead && i < hp && j < wp;
        if (in) src = cot + (((size_t)id.x * hp + i) * wp + j) * n_ch + id.y;
      }
      __pipeline_memcpy_async(landing + k, src, 4, in ? 0 : 4);
    }
    __pipeline_commit();
  };
  // The landed values of step st into the items' doubles: window row rho
  // into ring slot rho % ring, the cotangent rows over the last step's.
  auto convert_step = [&](int st) {
    for (int k = threadIdx.x; k < n_elems; k += blockDim.x) {
      const int it = k / lay.elems;
      const int e = k - it * lay.elems;
      double* item = smem + (size_t)it * lay.stride;
      const double v = (double)landing[k];
      if (e < win_elems) {
        const int r = e / lay.width, q = e - r * lay.width;
        item[STAGE * TILE + ((st * STAGE + r) % lay.ring) * lay.pitch + q] = v;
      } else {
        item[e - win_elems] = v;
      }
    }
  };

  // This thread's taps: item li, tap row u, columns v0 .. v0 + CV - 1.
  const int per_item = kh * lay.chunks;
  const int li = threadIdx.x / per_item;
  const int rr = threadIdx.x - li * per_item;
  const int u = rr % kh;
  const int v0 = (rr / kh) * CV;
  const bool computes = li < m_here;
  // Tap v0 + j at tile position (ti, tj) reads window row ti + kh - 1 - u,
  // column tj + base + CV - 1 - j.
  const int base = kw - v0 - CV + lay.padl;
  const double* my_cot = smem + (size_t)li * lay.stride;
  const double* my_win = my_cot + STAGE * TILE + base;
  double s[CV];
#pragma unroll
  for (int j = 0; j < CV; ++j) s[j] = 0.0;

  const int n_steps = lay.lead + TILE / STAGE;
  copy_step(0);
  for (int st = 0; st < n_steps; ++st) {
    __pipeline_wait_prior(0);
    __syncthreads();  // the step has landed, and the last step's rows are read
    convert_step(st);
    __syncthreads();
    if (st + 1 < n_steps) copy_step(st + 1);  // lands while this step computes
    if (computes && st >= lay.lead) {
      int slot = ((st - lay.lead) * STAGE + kh - 1 - u) % lay.ring;
#pragma unroll 1
      for (int tr = 0; tr < STAGE; ++tr) {
        const double* row = my_win + slot * lay.pitch;
        const double* g = my_cot + tr * TILE;
        // w[j] holds the window value of tap v0 + j at the current position.
        double w[CV];
#pragma unroll
        for (int j = 0; j + 1 < CV; ++j) w[j] = row[CV - 2 - j];
#pragma unroll
        for (int tj = 0; tj < TILE; ++tj) {
#pragma unroll
          for (int j = CV - 1; j > 0; --j) w[j] = w[j - 1];
          w[0] = row[tj + CV - 1];
          const double gv = g[tj];
#pragma unroll
          for (int j = 0; j < CV; ++j) s[j] = fma(gv, w[j], s[j]);
        }
        slot = slot + 1 == lay.ring ? 0 : slot + 1;
      }
    }
  }

  if (computes) {
    const int pcl = first + li - s_tile[li] * n_pcg;
    double* dst = partials + ((size_t)pcl * n_tiles + s_tile[li]) * kh * kw + (size_t)u * kw;
#pragma unroll
    for (int j = 0; j < CV; ++j)
      if (v0 + j < kw) dst[v0 + j] = s[j];
  }
}

// Each tap's partials summed over the tiles in index order, rounded once,
// written in the PSFs' (P, kh, kw, C) layout: the group of `total` / kk
// patch-channels from pc0.
__global__ void p2_dpsf_reduce(const double* __restrict__ partials, float* __restrict__ dpsf,
                               int n_ch, int n_tiles, int kk, long long total, int pc0) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long k = idx / kk;
  const int uv = (int)(idx - k * kk);
  const double* src = partials + k * n_tiles * kk + uv;
  double s = 0.0;
  for (int t = 0; t < n_tiles; ++t) s = s + src[(size_t)t * kk];
  const long long pc = pc0 + k;
  const long long p = pc / n_ch;
  const int c = (int)(pc - p * n_ch);
  dpsf[(p * kk + uv) * n_ch + c] = (float)s;
}

// The patch-channels a group: as many as keep their partials within
// PARTIALS_MAX, at least one.
int group_pcs(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  const long long per_pc = (long long)((ph - kh + 1 + TILE - 1) / TILE) *
                           ((pw - kw + 1 + TILE - 1) / TILE) * kh * kw;
  const long long n_pc = (long long)n_patch * n_ch;
  long long g = PARTIALS_MAX / per_pc;
  if (g < 1) g = 1;
  return (int)(g < n_pc ? g : n_pc < 1 ? 1 : n_pc);
}

// One d/dpsf call's arguments, as p2_dpsf_launch takes them.
struct Args {
  const float* patches;
  const float* cot;
  double* partials;
  float* dpsf;
  int n_patch, n_ch, ph, pw, kh, kw;
  cudaStream_t stream;
};

// A launch's shape for the kernel of kw KW: items a block, threads, dynamic
// shared memory.
struct Plan {
  int m, threads;
  size_t smem;
};

// The plan for kh x kw taps on the current device: the item count that keeps
// the most lanes of an SM busy (blocks an SM, from the occupancy calculator,
// x items x threads an item), the fewest of equals. The calculator's queries
// cost more host time than a launch, so each (device, kh, kw) is planned once
// and kept; the cache is shared by the host threads that launch (autograd's
// and the caller's), under a lock.
template <int KW>
cudaError_t block_plan(int kh, int kw, Plan& plan) {
  static std::mutex lock;
  static std::map<std::array<int, 3>, Plan> plans;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::array<int, 3> key{device, kh, kw};
  const std::lock_guard<std::mutex> guard(lock);
  const auto found = plans.find(key);
  if (found != plans.end()) {
    plan = found->second;
    return cudaSuccess;
  }
  // The dynamic shared memory a block may ask for, opted into on this device.
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, p2_dpsf_kernel<KW>);
  if (err != cudaSuccess) return err;
  const size_t dyn_max = SMEM_MAX - attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(p2_dpsf_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn_max);
  if (err != cudaSuccess) return err;
  const Layout lay(kh, kw, chunk_cols(KW));
  const int per_item = kh * lay.chunks;
  long long best = -1;
  for (int c = 1; c <= MAX_ITEMS; ++c) {
    const int t = (c * per_item + 31) / 32 * 32;
    const size_t bytes = c * lay.bytes();
    if (c > 1 && (t > MAX_THREADS || bytes > dyn_max)) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p2_dpsf_kernel<KW>, t, bytes);
    if (err != cudaSuccess) return err;
    const long long lanes = (long long)blocks * c * per_item;
    if (lanes > best) {
      best = lanes;
      plan = Plan{c, t, bytes};
    }
  }
  plans.emplace(key, plan);
  return cudaSuccess;
}

// Both kernels for each group of patch-channels, the main one by the kernel
// of kw KW (0: any kw).
template <int KW>
cudaError_t launch(const Args& a) {
  if (KW > 0 && a.kh != KW) return launch<0>(a);
  const int n_tx = (a.pw - a.kw + 1 + TILE - 1) / TILE;
  const int n_ty = (a.ph - a.kh + 1 + TILE - 1) / TILE;
  const int n_tiles = n_tx * n_ty;
  Plan plan;
  const cudaError_t err0 = block_plan<KW>(a.kh, a.kw, plan);
  if (err0 != cudaSuccess) return err0;
  const int n_pc = a.n_patch * a.n_ch;
  const int group = group_pcs(a.n_patch, a.n_ch, a.ph, a.pw, a.kh, a.kw);
  for (int pc0 = 0; pc0 < n_pc; pc0 += group) {
    const int n = n_pc - pc0 < group ? n_pc - pc0 : group;
    const int blocks = (n_tiles * n + plan.m - 1) / plan.m;
    p2_dpsf_kernel<KW><<<blocks, plan.threads, plan.smem, a.stream>>>(
        a.patches, a.cot, a.partials, a.n_ch, a.ph, a.pw, a.kh, a.kw, n_tx, n_tiles, n, pc0,
        plan.m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long total = (long long)n * a.kh * a.kw;
    p2_dpsf_reduce<<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
        a.partials, a.dpsf, a.n_ch, n_tiles, a.kh * a.kw, total, pc0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The widest PSF, in either axis, this kernel takes.
int p2_dpsf_max_kw() { return MAX_K; }

// The partials buffer's doubles: one group's patch-channels x tiles x kh x kw.
long long p2_dpsf_partials(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  const long long n_tiles = (long long)((ph - kh + 1 + TILE - 1) / TILE) *
                            ((pw - kw + 1 + TILE - 1) / TILE);
  return (long long)group_pcs(n_patch, n_ch, ph, pw, kh, kw) * n_tiles * kh * kw;
}

// The launches of the main kernel one d/dpsf call makes: its groups of
// patch-channels (each followed by one launch of the second pass).
int p2_dpsf_launches(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  const int g = group_pcs(n_patch, n_ch, ph, pw, kh, kw);
  return (n_patch * n_ch + g - 1) / g;
}

// 1 where kw has a d/dpsf kernel of its own, 0 where it takes the runtime-kw
// one.
int p2_dpsf_specialized_kw(int kw) {
  for (int k : SPECIALIZED_KW)
    if (k == kw) return 1;
  return 0;
}

// Launches d/dpsf on `stream` (both kernels, p2_dpsf_launches(...) times
// each) and returns cudaGetLastError() (0 on success). patches (n_patch,
// ph, pw, n_ch) and the cotangent (n_patch, ph - kh + 1, pw - kw + 1, n_ch)
// float32; partials p2_dpsf_partials(...) doubles of scratch; dpsf
// (n_patch, kh, kw, n_ch) float32; all contiguous.
int p2_dpsf_launch(const float* patches, const float* cot, double* partials, float* dpsf,
                   int n_patch, int n_ch, int ph, int pw, int kh, int kw, void* stream) {
  if (n_patch < 0 || n_ch < 1 || kh < 1 || kw < 1 || kh > MAX_K || kw > MAX_K || ph < kh ||
      pw < kw || (long long)n_patch * n_ch > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  const Args a{patches, cot, partials, dpsf, n_patch, n_ch, ph, pw, kh, kw,
               (cudaStream_t)stream};
  switch (kw) {
    case 3:
      return (int)launch<3>(a);
    case 5:
      return (int)launch<5>(a);
    case 11:
      return (int)launch<11>(a);
    default:
      return (int)launch<0>(a);
  }
}

}  // extern "C"
