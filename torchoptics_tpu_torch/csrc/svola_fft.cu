// P2's FFT route: SVOLA's patch convolution (and its d/dpsf correlation) for
// wide PSFs, as a hand-written 2D FFT convolution.
//
// Replaces, for PSFs of P2_FFT_MIN_KW taps and more (ops/image.py), the
// direct K^2-tap sum of svola_conv.cu, the port of the Pallas TPU kernel
// `_k_acc` of benchmarks/probe_svola_direct.py, and the direct d/dpsf kernel
// of svola_conv_bwd.cu. It follows the reference's own algorithm:
// torchoptics_tpu/ops/image.py:svola_convolution convolves each patch by an
// rfftn product, with fft_fast_sizes at next_fast_fft_len of the patch, and
// keeps the valid region; XLA differentiates that. The plain PyTorch
// versions are torchoptics_tpu_torch/ops/image.py:svola_patch_conv_fft_reference
// and svola_patch_conv_dpsf_fft_reference; kernels and plain versions agree
// bit for bit.
//
// What it computes, on the JAX layout with channels innermost: for every
// patch-channel plane, the circular convolution at lengths Lh = fft_len(ph),
// Lw = fft_len(pw) (the smallest 2^a 3^b 5^c >= the side, 16 to 4096) of the
// (ph, pw) patch with the (kh, kw) PSF, keeping rows [kh-1, ph) and columns
// [kw-1, pw): the wrap never reaches them, so that is the valid convolution
// that svola_conv.cu computes. d/dpsf is the circular correlation of the
// patch with the (hp, wp) cotangent g, corr[s, t] = sum_ij g[i, j]
// patch[i+s, j+t], whose lags s < kh, t < kw do not wrap either; dpsf[u, v]
// = corr[kh-1-u, kw-1-v].
//
// Three launches, the same three kernels for both functions, each a grid of
// resident blocks that walk their work items with the next item's inputs
// loaded by cp.async into a second buffer while the current one is
// transformed:
//   1. fft_rows_fwd: the rows of both inputs (the patches, and the PSFs or
//      the cotangent), two real rows packed into one complex row of Lw
//      points, transformed in shared memory and separated by conjugate
//      symmetry into the two rows' half spectra (Lw/2 + 1 values), stored
//      to a scratch buffer. The copies de-interleave the channels and fill
//      the zeros past the row (cp.async's zero fill).
//   2. fft_cols: an item is a few columns of one plane's half spectra: the
//      forward column FFT of both inputs (zero past their rows), the
//      pointwise product (the second factor conjugated for d/dpsf), the
//      inverse column FFT; only the rows that a kept output needs are
//      stored, over the patch's spectra in place. The planes are walked in
//      the reverse of pass 1's order, so the first items find pass 1's last
//      spectra in the L2 cache.
//   3. fft_rows_inv: two rows' half spectra copied as they lie, packed into
//      one complex row by Hermitian symmetry as the first stages read them
//      (the imaginary parts at 0 and, for even Lw, Lw/2 dropped, as an
//      inverse real FFT does), the inverse transform, the scale 1/(Lh Lw)
//      rounded once to float32, and only the kept columns written, in the
//      (P, hp, wp, C) layout of P2's output or, flipped, the (P, kh, kw, C)
//      layout of the PSF gradient.
//
// Every transform is the mixed-radix Stockham FFT of image._stockham: the
// stages of fft_radices(L) (radix 4 while two factors 2 remain, then 2, 3,
// 5); a stage of radix R after Ns points: x_r = x[j + r L/R] times W_L^(r (j
// mod Ns) L / (Ns R)) (conjugated for the inverse; no product at Ns = 1),
// the radix-R butterfly `bfly` (its constants rounded once, products rounded
// before their sums: -fmad=false), output r to y[(j / Ns) Ns R + r Ns + j mod
// Ns]. The host's planner (`make_plan`) groups the stages into register blocks of
// up to three stages and M <= 27 values (the fewest blocks, then the smallest
// largest M; `BLOCK_TYPES`): 288 = (4 4)(2 3 3), 400 = (4 4)(5 5), 192 =
// (4 4)(4 3), 640 = (4 4)(4 2)(5), 1280 = (4 4)(4 4)(5), 4096 = (4 4)^3;
// 800 takes (4 4 2)(5 5), two blocks where the rule would give three (with
// three the default configuration's 4096^2 ran slower than at 1024 points
// on the H100). A thread holds M values x[t +
// m L/M] of one sequence, L/M threads a sequence, and runs the block's
// stages on them in registers between one read and one write of shared
// memory: after a block starting at Ns, value (r1, r2, r3) lies at (t / Ns)
// Ns M + Ns (r1 + R1 r2 + R1 R2 r3) + t mod Ns.
//
// The lengths of the main path's patches (SPECIAL: 192, 288, 400, 640,
// 800, 1280) have kernels of their own, the blocks fixed at compile time;
// every other length runs the same kernels with the plan's blocks behind a
// switch, bit for bit the same but slower: inlined together, the switch's
// blocks share one register allocation and spill (2-3 KB of stack a
// kernel). A block aims at BLOCK_THREADS = 128 threads (a few
// sequences an item, more rounds where a block type's L/M threads exceed
// it): at 128 registers a thread, 4-5 such blocks share an SM. Measured on
// the H100 and dropped: blocks of 192-512 threads; 64 or 40 registers a
// thread (spills); register blocks of at most 16 values (more round trips);
// each block type a function of its own (__noinline__); a warp transforming
// sequences of its own with no block barrier between its blocks (1.3-2x
// slower); walks of 1 or 16 items a block.
//
// The twiddles are one table per length, W_L^i for i < L, computed in
// float64 and rounded once (image.fft_twiddles), handed to the kernels and
// the plain version alike; each block copies its length's into shared
// memory. Two lengths, 3125 and 3750, would need a block of more than
// MAX_THREADS threads a sequence; fft_len takes the next length there.
//
// What bounds it on an H100: 5 L log2 L operations a complex transform. At
// the default configuration's 2048^2 render (243 planes of 385^2, K = 47,
// L = 400) the transforms are ~4.3e9 operations, 0.064 ms at 67 TFLOP/s;
// the patches and PSFs read once and the outputs written once, 258 MB,
// 0.077 ms at 3.35 TB/s; the scratch spectra between the passes (~0.6 GB)
// 0.18 ms more. A value costs one shared-memory read and one write a
// register block (two blocks at 288, 400 and 800, three at 512), and up to
// (R - 1)/R twiddle reads a stage. Indices are padded by one slot every 16
// (padi) so that the strided writes and the twiddle reads spread over the
// banks. The first ceiling of this design is the latency of its barriers and
// shared-memory round trips at the few warps an SM its registers allow.

#include <cuda_runtime.h>

namespace {

constexpr int LMAX = 4096;                   // the longest transform
constexpr int LMIN = 16;                     // the shortest
constexpr int MAX_THREADS = 512;
constexpr int BLOCK_THREADS = 128;           // threads a block aims at (more rounds past it)
constexpr int MAX_M = 27;                    // values a thread holds in a register block
constexpr int MAX_BLOCKS = 8;                // register blocks a plan may have
constexpr size_t SMEM_MAX = 232448;          // 227 KB
constexpr size_t SMEM_ROWS = 96 * 1024;      // a row block's slots at most
constexpr size_t SMEM_COLS = 110 * 1024;     // a column block's slots

// The register blocks a plan may use, (R1, R2, R3), 1 for a missing stage.
constexpr int BLOCK_TYPES[][3] = {
    {4, 1, 1}, {2, 1, 1}, {3, 1, 1}, {5, 1, 1}, {4, 4, 1}, {4, 2, 1}, {4, 3, 1}, {4, 5, 1},
    {2, 3, 1}, {2, 5, 1}, {3, 3, 1}, {3, 5, 1}, {5, 5, 1}, {4, 2, 3}, {2, 3, 3}, {3, 3, 3},
    {4, 4, 2}};
constexpr int N_BLOCK_TYPES = sizeof(BLOCK_TYPES) / sizeof(BLOCK_TYPES[0]);

// The butterflies' constants, float32 of sin(2 pi/3), cos and sin of 2 pi/5
// and 4 pi/5 (image._S3, _C51, _C52, _S51, _S52).
constexpr float S3 = 0x1.bb67aep-1f;
constexpr float C51 = 0x1.3c6ef4p-2f;
constexpr float C52 = -0x1.9e377ap-1f;
constexpr float S51 = 0x1.e6f0e2p-1f;
constexpr float S52 = 0x1.2cf230p-1f;

__host__ __device__ constexpr int padi(int i) { return i + (i >> 4); }

// An L-point transform: its register blocks (indices into BLOCK_TYPES) in
// order.
struct Plan {
  int L;
  int n;
  int type[MAX_BLOCKS];
};

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mulc(float2 a, float c) { return make_float2(a.x * c, a.y * c); }
// a times -i (forward) or +i (inverse): exact.
__device__ __forceinline__ float2 mi(float2 a, bool inv) {
  return inv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 cmul(float2 b, float2 w) {
  return make_float2(b.x * w.x - b.y * w.y, b.x * w.y + b.y * w.x);
}

// The radix-R DFT of x in place, in image._butterfly's order of operations.
template <int R>
__device__ __forceinline__ void bfly(float2* x, bool inv);
template <>
__device__ __forceinline__ void bfly<1>(float2*, bool) {}
template <>
__device__ __forceinline__ void bfly<2>(float2* x, bool) {
  const float2 a = x[0], b = x[1];
  x[0] = add(a, b);
  x[1] = sub(a, b);
}
template <>
__device__ __forceinline__ void bfly<4>(float2* x, bool inv) {
  const float2 s0 = add(x[0], x[2]), d0 = sub(x[0], x[2]);
  const float2 s1 = add(x[1], x[3]), d1 = sub(x[1], x[3]);
  const float2 u = mi(d1, inv);
  x[0] = add(s0, s1);
  x[1] = add(d0, u);
  x[2] = sub(s0, s1);
  x[3] = sub(d0, u);
}
template <>
__device__ __forceinline__ void bfly<3>(float2* x, bool inv) {
  const float2 s = add(x[1], x[2]), d = sub(x[1], x[2]);
  const float2 t = sub(x[0], mulc(s, 0.5f));
  const float2 u = mi(mulc(d, S3), inv);
  x[0] = add(x[0], s);
  x[1] = add(t, u);
  x[2] = sub(t, u);
}
template <>
__device__ __forceinline__ void bfly<5>(float2* x, bool inv) {
  const float2 a1 = add(x[1], x[4]), b1 = sub(x[1], x[4]);
  const float2 a2 = add(x[2], x[3]), b2 = sub(x[2], x[3]);
  const float2 t1 = add(add(x[0], mulc(a1, C51)), mulc(a2, C52));
  const float2 t2 = add(add(x[0], mulc(a1, C52)), mulc(a2, C51));
  const float2 u1 = mi(add(mulc(b1, S51), mulc(b2, S52)), inv);
  const float2 u2 = mi(sub(mulc(b1, S52), mulc(b2, S51)), inv);
  x[0] = add(add(x[0], a1), a2);
  x[1] = add(t1, u1);
  x[2] = add(t2, u2);
  x[3] = sub(t2, u2);
  x[4] = sub(t1, u1);
}

// One stage of a register block, on the thread's R1 R2 R3 values v: the
// butterflies over digit D (0, 1 or 2) of the value index (r1, r2, r3)
// (value (r1 R2 + r2) R3 + r3). k0 is the butterfly's j mod Ns before the
// block; the stage's j mod Ns is k0 plus Ns times the lower digits' number
// (r1 for stage 2, r1 + R1 r2 for stage 3). S = L / (Ns_stage R).
template <int R1, int R2, int R3, int D>
__device__ __forceinline__ void stage(float2* v, int k0, int ns, int S, bool twiddle,
                                      const float2* tws, bool inv) {
  constexpr int R = D == 0 ? R1 : D == 1 ? R2 : R3;
  if (R == 1) return;
#pragma unroll
  for (int a = 0; a < (D == 0 ? R2 : R1); ++a) {
#pragma unroll
    for (int b = 0; b < (D == 2 ? R2 : R3); ++b) {
      float2 u[R];
      int at[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int r1 = D == 0 ? r : a, r2 = D == 1 ? r : D == 0 ? a : b,
                  r3 = D == 2 ? r : b;
        at[r] = (r1 * R2 + r2) * R3 + r3;
        u[r] = v[at[r]];
      }
      if (twiddle) {
        const int k = k0 + ns * (D == 0 ? 0 : D == 1 ? a : a + R1 * b);
#pragma unroll
        for (int r = 1; r < R; ++r) {
          float2 w = tws[padi(r * k * S)];
          if (inv) w.y = -w.y;
          u[r] = cmul(u[r], w);
        }
      }
      bfly<R>(u, inv);
#pragma unroll
      for (int r = 0; r < R; ++r) v[at[r]] = u[r];
    }
  }
}

// One register block in place on nseq sequences in shared memory (sequence
// s at seqs + s * pitch, point i at padi(i)), Ns points of earlier stages:
// L/M threads a sequence, blockDim.x / (L/M) sequences a round; every
// thread of the block calls it. With hnc > 0 the block's reads pack two
// rows' half spectra (hnc values each, the first at point 0, the second at
// point hnc) into Z = X + iY by Hermitian symmetry (pass 3).
template <int R1, int R2, int R3>
__device__ __forceinline__ void fft_block(float2* seqs, int pitch, int nseq, int L, int ns,
                                          const float2* tws, bool inv, int hnc) {
  constexpr int M = R1 * R2 * R3;
  const int T = L / M;
  const int per_round = blockDim.x / T;
  const int slot = threadIdx.x / T;
  const int t = threadIdx.x - slot * T;
  const int tl = t % ns, th = t / ns;
  const int S1 = L / (ns * R1), S2 = S1 / R2, S3s = S2 / R3;
  for (int s0 = 0; s0 < nseq; s0 += per_round) {
    const bool active = slot < per_round && s0 + slot < nseq;
    float2* x = seqs + (size_t)(s0 + slot) * pitch;
    float2 v[M];
    if (active) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = t + m * T;
        if (hnc) {
          const int kk = 2 * i <= L ? i : L - i;
          const float2 X = x[padi(kk)], Y = x[padi(hnc + kk)];
          if (i == 0 || 2 * i == L)
            v[m] = make_float2(X.x, Y.x);
          else if (2 * i < L)
            v[m] = make_float2(X.x - Y.y, X.y + Y.x);
          else  // X_i = conj X_{L-i}, Y_i = conj Y_{L-i}
            v[m] = make_float2(X.x + Y.y, Y.x - X.y);
        } else {
          v[m] = x[padi(i)];
        }
      }
    }
    __syncthreads();
    if (active) {
      stage<R1, R2, R3, 0>(v, tl, ns, S1, ns > 1, tws, inv);
      stage<R1, R2, R3, 1>(v, tl, ns, S2, true, tws, inv);
      stage<R1, R2, R3, 2>(v, tl, ns, S3s, true, tws, inv);
#pragma unroll
      for (int r3 = 0; r3 < R3; ++r3)
#pragma unroll
        for (int r2 = 0; r2 < R2; ++r2)
#pragma unroll
          for (int r1 = 0; r1 < R1; ++r1)
            x[padi(th * ns * M + ns * (r1 + R1 * r2 + R1 * R2 * r3) + tl)] =
                v[(r1 * R2 + r2) * R3 + r3];
    }
    __syncthreads();
  }
}

// Register block B of BLOCK_TYPES on the sequences; ns grows by its M.
template <int B>
__device__ __forceinline__ void run_block(float2* seqs, int pitch, int nseq, int L, int& ns,
                                          const float2* tws, bool inv, int hnc) {
  constexpr int R1 = BLOCK_TYPES[B][0], R2 = BLOCK_TYPES[B][1], R3 = BLOCK_TYPES[B][2];
  fft_block<R1, R2, R3>(seqs, pitch, nseq, L, ns, tws, inv, hnc);
  ns *= R1 * R2 * R3;
}

// The unscaled forward (or, with inv, inverse) transform of nseq sequences
// in place, the plan's register blocks one after another: with B0 >= 0 the
// blocks B0, B1, B2 (-1: none) of a kernel specialised to one length
// (SPECIAL), else the plan's blocks through a switch.
template <int B0, int B1, int B2>
__device__ __forceinline__ void fft_smem(float2* seqs, int pitch, int nseq, const Plan& pl,
                                         const float2* tws, bool inv, int hnc = 0) {
  int ns = 1;
  if constexpr (B0 >= 0) {
    run_block<B0>(seqs, pitch, nseq, pl.L, ns, tws, inv, hnc);
    if constexpr (B1 >= 0) run_block<B1>(seqs, pitch, nseq, pl.L, ns, tws, inv, 0);
    if constexpr (B2 >= 0) run_block<B2>(seqs, pitch, nseq, pl.L, ns, tws, inv, 0);
  } else {
    for (int b = 0; b < pl.n; ++b) {
      const int h = b == 0 ? hnc : 0;
      switch (pl.type[b]) {
#define BLOCK_CASE(i) \
  case i: run_block<i>(seqs, pitch, nseq, pl.L, ns, tws, inv, h); break;
        BLOCK_CASE(0) BLOCK_CASE(1) BLOCK_CASE(2) BLOCK_CASE(3) BLOCK_CASE(4) BLOCK_CASE(5)
        BLOCK_CASE(6) BLOCK_CASE(7) BLOCK_CASE(8) BLOCK_CASE(9) BLOCK_CASE(10) BLOCK_CASE(11)
        BLOCK_CASE(12) BLOCK_CASE(13) BLOCK_CASE(14) BLOCK_CASE(15) BLOCK_CASE(16)
#undef BLOCK_CASE
      }
    }
  }
}

// cp.async of 4 or 8 bytes from global to shared memory; with `valid`
// false nothing is read and the bytes are zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ void load_twiddles(float2* tws, const float2* __restrict__ tw, int L) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) tws[padi(i)] = tw[i];
}

// The (row, column) pairs of rows x cols, thread by thread in steps of
// blockDim.x, row-major: the division once a thread, then carried.
struct Walk {
  int r, x, dr, dx;
  __device__ Walk(int cols) {
    r = threadIdx.x / cols;
    x = threadIdx.x - r * cols;
    dr = blockDim.x / cols;
    dx = blockDim.x - dr * cols;
  }
  __device__ void next(int cols) {
    r += dr;
    x += dx;
    if (x >= cols) {
      x -= cols;
      ++r;
    }
  }
};

// One input of pass 1: rows x cols x n_ch floats a patch, its half
// spectra (n_patch n_ch, rows, L/2 + 1), and its items: `groups` groups of
// spb sequences (row pair q, channel c; numbered q n_ch + c) a patch.
struct RowsIn {
  const float* src;
  float2* spec;
  int rows;
  int cols;
  int groups;
};

// Pass 1. Item it (of a.groups n_patch + b.groups n_patch): group it %
// groups of patch it / groups of input a, then of b.
template <int B0, int B1, int B2>
__global__ void __launch_bounds__(MAX_THREADS, 1) fft_rows_fwd(RowsIn a, RowsIn b, int n_patch,
                                                             int n_ch, Plan pl, int spb, int pitch,
                                                             const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  const int L = pl.L;
  const int nc = L / 2 + 1;
  float2* tws = sm;
  float2* const slot0 = sm + padi(L);
  const size_t slot_len = (size_t)spb * pitch;
  const int total = (a.groups + b.groups) * n_patch;
  // Item it's input, patch, first sequence and sequences.
  auto item = [&](int it, RowsIn& in, int& p, int& s0, int& ns) {
    const bool first = it < a.groups * n_patch;
    in = first ? a : b;
    const int j = first ? it : it - a.groups * n_patch;
    p = j / in.groups;
    s0 = (j - p * in.groups) * spb;
    ns = min(spb, (in.rows + 1) / 2 * n_ch - s0);
  };
  // Row 2q (real parts) and 2q + 1 (imaginary parts) of each sequence, zero
  // past the row and past the last row.
  auto prefetch = [&](int it, float2* slot) {
    RowsIn in;
    int p, s0, ns;
    item(it, in, p, s0, ns);
    for (int s = 0; s < ns; ++s) {
      const int q = (s0 + s) / n_ch, c = s0 + s - q * n_ch;
      for (int part = 0; part < 2; ++part) {
        const int r = 2 * q + part;
        const bool row_ok = r < in.rows;
        const float* row = in.src + ((size_t)p * in.rows + (row_ok ? r : 0)) * in.cols * n_ch + c;
        float* dst = reinterpret_cast<float*>(slot + (size_t)s * pitch) + part;
        for (int i = threadIdx.x; i < L; i += blockDim.x)
          cp_async4(dst + 2 * padi(i), row + (size_t)(i < in.cols ? i : 0) * n_ch,
                    row_ok && i < in.cols);
      }
    }
  };
  load_twiddles(tws, tw, L);
  int buf = 0;
  if (blockIdx.x < total) prefetch(blockIdx.x, slot0);
  cp_async_commit();
  for (int it = blockIdx.x; it < total; it += gridDim.x, buf ^= 1) {
    if (it + gridDim.x < total) prefetch(it + gridDim.x, slot0 + (buf ^ 1) * slot_len);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    RowsIn in;
    int p, s0, ns;
    item(it, in, p, s0, ns);
    float2* seqs = slot0 + buf * slot_len;
    fft_smem<B0, B1, B2>(seqs, pitch, ns, pl, tws, false);
    // Z = A + iB: A_k = (Z_k + conj Z_{L-k}) / 2, B_k = (Z_k - conj Z_{L-k}) / 2i.
    for (int s = 0; s < ns; ++s) {
      const int q = (s0 + s) / n_ch, c = s0 + s - q * n_ch;
      const float2* z_s = seqs + (size_t)s * pitch;
      float2* row = in.spec + (((size_t)p * n_ch + c) * in.rows + 2 * q) * nc;
      const bool pair = 2 * q + 1 < in.rows;
      for (int k = threadIdx.x; k < nc; k += blockDim.x) {
        const float2 z = z_s[padi(k)];
        const float2 zm = z_s[padi(k == 0 ? 0 : L - k)];
        row[k] = make_float2((z.x + zm.x) * 0.5f, (z.y - zm.y) * 0.5f);
        if (pair) row[nc + k] = make_float2((z.y + zm.y) * 0.5f, (zm.x - z.x) * 0.5f);
      }
    }
    __syncthreads();
  }
}

// Pass 2. Item it: columns [g0, g0 + group) (g0 = (it % ngroups) group) of
// plane n_pc - 1 - it / ngroups of the half spectra (nc columns): a's a_rows
// rows and b's b_rows rows, each zero to L; the forward column FFTs, a b (or
// a conj(b)), the inverse; rows [row0, row0 + n_out) stored over a's rows
// [0, n_out).
template <int B0, int B1, int B2>
__global__ void __launch_bounds__(MAX_THREADS, 1) fft_cols(float2* a_spec, int a_rows,
                                                         const float2* __restrict__ b_spec,
                                                         int b_rows, int nc, int n_pc, Plan pl,
                                                         int group, int lg_group, int pitch,
                                                         int conj_b, int row0, int n_out,
                                                         const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  const int L = pl.L;
  float2* tws = sm;
  float2* const slot0 = sm + padi(L);
  const size_t slot_len = (size_t)2 * group * pitch;
  const int ngroups = (nc + group - 1) >> lg_group;
  const int total = n_pc * ngroups;
  auto prefetch = [&](int it, float2* slot) {
    const int plane = n_pc - 1 - it / ngroups;
    const int k0 = (it % ngroups) << lg_group;
    const float2* a_src = a_spec + (size_t)plane * a_rows * nc + k0;
    const float2* b_src = b_spec + (size_t)plane * b_rows * nc + k0;
    float2* sb = slot + (size_t)group * pitch;
    for (int e = threadIdx.x; e < a_rows << lg_group; e += blockDim.x) {
      const int r = e >> lg_group, g = e & (group - 1);
      const bool ok = k0 + g < nc;
      cp_async8(slot + g * pitch + padi(r), a_src + (ok ? (size_t)r * nc + g : 0), ok);
    }
    for (int e = threadIdx.x; e < b_rows << lg_group; e += blockDim.x) {
      const int r = e >> lg_group, g = e & (group - 1);
      const bool ok = k0 + g < nc;
      cp_async8(sb + g * pitch + padi(r), b_src + (ok ? (size_t)r * nc + g : 0), ok);
    }
    for (int e = threadIdx.x; e < (L - a_rows) << lg_group; e += blockDim.x)
      slot[(e & (group - 1)) * pitch + padi(a_rows + (e >> lg_group))] = make_float2(0.f, 0.f);
    for (int e = threadIdx.x; e < (L - b_rows) << lg_group; e += blockDim.x)
      sb[(e & (group - 1)) * pitch + padi(b_rows + (e >> lg_group))] = make_float2(0.f, 0.f);
  };
  load_twiddles(tws, tw, L);
  int buf = 0;
  if (blockIdx.x < total) prefetch(blockIdx.x, slot0);
  cp_async_commit();
  for (int it = blockIdx.x; it < total; it += gridDim.x, buf ^= 1) {
    if (it + gridDim.x < total) prefetch(it + gridDim.x, slot0 + (buf ^ 1) * slot_len);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    float2* sa = slot0 + buf * slot_len;
    const float2* sb = sa + (size_t)group * pitch;
    fft_smem<B0, B1, B2>(sa, pitch, 2 * group, pl, tws, false);
    for (int g = 0; g < group; ++g) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const int at = g * pitch + padi(i);
        const float2 x = sa[at];
        const float2 y = sb[at];
        sa[at] = conj_b ? make_float2(x.x * y.x + x.y * y.y, x.y * y.x - x.x * y.y)
                        : make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
      }
    }
    __syncthreads();
    fft_smem<B0, B1, B2>(sa, pitch, group, pl, tws, true);
    const int plane = n_pc - 1 - it / ngroups;
    const int k0 = (it % ngroups) << lg_group;
    float2* a_out = a_spec + (size_t)plane * a_rows * nc + k0;
    for (int e = threadIdx.x; e < n_out << lg_group; e += blockDim.x) {
      const int r = e >> lg_group, g = e & (group - 1);
      if (k0 + g < nc) a_out[(size_t)r * nc + g] = sa[g * pitch + padi(row0 + r)];
    }
    __syncthreads();
  }
}

// Pass 3. Item it: group it % groups (spb sequences, row pair q and channel
// c) of patch it / groups: rows 2q and 2q + 1 of the n_rows rows of plane
// (p, c) (a plane's rows spec_rows apart) copied as they lie, X + iY packed
// as the first register block reads them, the inverse FFT, times `scale`;
// columns [t0, t0 + nt) written to dst (n_patch, n_rows, nt, n_ch), flipped
// in both axes with flip.
template <int B0, int B1, int B2>
__global__ void __launch_bounds__(MAX_THREADS, 1) fft_rows_inv(const float2* __restrict__ spec,
                                                             int spec_rows, int n_rows, int groups,
                                                             int n_patch, float* __restrict__ dst,
                                                             int n_ch, Plan pl, int spb, int pitch,
                                                             float scale, int t0, int nt, int flip,
                                                             const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  const int L = pl.L;
  const int nc = L / 2 + 1;
  float2* tws = sm;
  float2* const slot0 = sm + padi(L);
  const size_t slot_len = (size_t)spb * pitch;
  const int total = groups * n_patch;
  const int seqs_all = (n_rows + 1) / 2 * n_ch;
  auto prefetch = [&](int it, float2* slot) {
    const int p = it / groups;
    const int s0 = (it - p * groups) * spb;
    const int ns = min(spb, seqs_all - s0);
    for (int s = 0; s < ns; ++s) {
      const int q = (s0 + s) / n_ch, c = s0 + s - q * n_ch;
      const float2* row = spec + (((size_t)p * n_ch + c) * spec_rows + 2 * q) * nc;
      const int n = 2 * q + 1 < n_rows ? 2 * nc : nc;
      for (int k = threadIdx.x; k < 2 * nc; k += blockDim.x)
        cp_async8(slot + (size_t)s * pitch + padi(k), row + (k < n ? k : 0), k < n);
    }
  };
  load_twiddles(tws, tw, L);
  int buf = 0;
  if (blockIdx.x < total) prefetch(blockIdx.x, slot0);
  cp_async_commit();
  for (int it = blockIdx.x; it < total; it += gridDim.x, buf ^= 1) {
    if (it + gridDim.x < total) prefetch(it + gridDim.x, slot0 + (buf ^ 1) * slot_len);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const int p = it / groups;
    const int s0 = (it - p * groups) * spb;
    const int ns = min(spb, seqs_all - s0);
    float2* seqs = slot0 + buf * slot_len;
    fft_smem<B0, B1, B2>(seqs, pitch, ns, pl, tws, true, nc);
    const int r0 = s0 / n_ch * 2;
    const int r1 = min(n_rows, (s0 + ns - 1) / n_ch * 2 + 2);
    for (Walk w(nt); w.r < r1 - r0; w.next(nt)) {
      const int r = r0 + w.r;
      const int sr = (r >> 1) * n_ch - s0;
      float* px = dst + (((size_t)p * n_rows + (flip ? n_rows - 1 - r : r)) * nt +
                         (flip ? nt - 1 - w.x : w.x)) * n_ch;
      for (int c = 0; c < n_ch; ++c) {
        const int s = sr + c;
        if (s < 0 || s >= ns) continue;
        const float2 z = seqs[(size_t)s * pitch + padi(t0 + w.x)];
        px[c] = ((r & 1) ? z.y : z.x) * scale;
      }
    }
    __syncthreads();
  }
}

__host__ int next_fast_len(int n) {
  int best = 1;
  while (best < n) best *= 2;
  int m = best;
  for (int p3 = 1; p3 <= best; p3 *= 3)
    for (int p5 = 1; p3 * p5 <= best; p5 *= 5) {
      int p2 = 1;
      while (p2 * p3 * p5 < n) p2 *= 2;
      if (p2 * p3 * p5 < m) m = p2 * p3 * p5;
    }
  return m;
}

// image.fft_len: next_fast_len of max(n, LMIN), past 3125 and 3750.
__host__ int fft_len(int n) {
  int L = next_fast_len(n < LMIN ? LMIN : n);
  while (L == 3125 || L == 3750) L = next_fast_len(L + 1);
  return L;
}

// The lengths with kernels of their own: the default configuration's
// patches at 1024^2 to 4096^2 (191, 272, 385, 775 px) and config 5's at
// 2048^2 and 4096^2 (635 px, d/dpsf; 1273 px), and their plans' block types
// (-1 for none):
// make_plan's, but for 800, whose (4 4 2)(5 5) is past MAX_M.
constexpr int SPECIAL[][4] = {{192, 4, 6, -1}, {288, 4, 14, -1}, {400, 4, 12, -1},
                              {800, 16, 12, -1}, {640, 4, 5, 3}, {1280, 4, 4, 3}};

// The stages of image.fft_radices(L), grouped into register blocks of
// BLOCK_TYPES with M <= MAX_M and L / M <= MAX_THREADS: the fewest blocks,
// then the smallest largest M (a dynamic programme over the stages); a
// SPECIAL length's own plan.
__host__ bool make_plan(int L, Plan* pl) {
  for (const auto& sp : SPECIAL)
    if (sp[0] == L) {
      pl->L = L;
      pl->n = 0;
      for (int b = 1; b < 4 && sp[b] >= 0; ++b) pl->type[pl->n++] = sp[b];
      return true;
    }
  const int radices[4] = {4, 2, 3, 5};
  int st[16], n = 0, rest = L;
  for (int r : radices)
    while (rest % r == 0 && (r != 2 || rest % 4 != 0) && n < 16) {
      st[n++] = r;
      rest /= r;
    }
  if (rest != 1) return false;
  int cnt[17], big[17], from[17], kind[17];
  cnt[0] = 0;
  big[0] = 0;
  for (int i = 1; i <= n; ++i) {
    cnt[i] = -1;
    for (int j = i - 1; j >= 0 && j >= i - 3; --j) {
      if (cnt[j] < 0) continue;
      int r[3] = {1, 1, 1};
      for (int u = j; u < i; ++u) r[u - j] = st[u];
      const int M = r[0] * r[1] * r[2];
      if (M > MAX_M || L / M > MAX_THREADS) continue;
      int type = -1;
      for (int k = 0; k < N_BLOCK_TYPES; ++k)
        if (BLOCK_TYPES[k][0] == r[0] && BLOCK_TYPES[k][1] == r[1] && BLOCK_TYPES[k][2] == r[2])
          type = k;
      if (type < 0) continue;
      const int c = cnt[j] + 1, b = big[j] > M ? big[j] : M;
      if (cnt[i] < 0 || c < cnt[i] || (c == cnt[i] && b < big[i])) {
        cnt[i] = c;
        big[i] = b;
        from[i] = j;
        kind[i] = type;
      }
    }
  }
  if (cnt[n] < 0 || cnt[n] > MAX_BLOCKS) return false;
  pl->L = L;
  pl->n = cnt[n];
  for (int i = n, b = cnt[n] - 1; i > 0; i = from[i], --b) pl->type[b] = kind[i];
  return true;
}

// The most threads one sequence of the plan takes (L / M of its smallest M).
__host__ int plan_threads(const Plan& pl) {
  int t = 0;
  for (int b = 0; b < pl.n; ++b) {
    const int M = BLOCK_TYPES[pl.type[b]][0] * BLOCK_TYPES[pl.type[b]][1] *
                  BLOCK_TYPES[pl.type[b]][2];
    if (pl.L / M > t) t = pl.L / M;
  }
  return t;
}

__host__ int round32(int n) { return (n + 31) / 32 * 32; }
__host__ int imin(int a, int b) { return a < b ? a : b; }

// A row pass's sequences a block (two buffers of spb sequences of `pitch`
// points within SMEM_ROWS and BLOCK_THREADS / (L/M) of its largest L/M,
// whole row pairs where they fit) and threads.
__host__ void rows_shape(const Plan& pl, int pitch, int n_ch, int* spb, int* threads) {
  const size_t per_seq = 2 * sizeof(float2) * (size_t)pitch;
  const size_t room = SMEM_ROWS - sizeof(float2) * padi(pl.L);
  int s = (int)(room / per_seq);
  if (s > BLOCK_THREADS / plan_threads(pl)) s = BLOCK_THREADS / plan_threads(pl);
  if (s < 1) s = 1;
  if (s >= n_ch) s = s / n_ch * n_ch;
  *spb = s;
  *threads = imin(MAX_THREADS, round32(s * plan_threads(pl)));
}

// The instantiation of kernel K for plan pl: its length's own, or the
// runtime plan's (B0 = -1).
#define SELECT(K, pl)                                                            \
  [&]() {                                                                        \
    const int sp = special_index(pl);                                            \
    return sp == 0 ? K<SPECIAL[0][1], SPECIAL[0][2], SPECIAL[0][3]>              \
           : sp == 1 ? K<SPECIAL[1][1], SPECIAL[1][2], SPECIAL[1][3]>            \
           : sp == 2 ? K<SPECIAL[2][1], SPECIAL[2][2], SPECIAL[2][3]>            \
           : sp == 3 ? K<SPECIAL[3][1], SPECIAL[3][2], SPECIAL[3][3]>            \
           : sp == 4 ? K<SPECIAL[4][1], SPECIAL[4][2], SPECIAL[4][3]>            \
           : sp == 5 ? K<SPECIAL[5][1], SPECIAL[5][2], SPECIAL[5][3]>            \
                     : K<-1, -1, -1>;                                            \
  }()

// Which SPECIAL row plan pl's length is (make_plan took its plan), or -1.
__host__ int special_index(const Plan& pl) {
  for (int i = 0; i < (int)(sizeof(SPECIAL) / sizeof(SPECIAL[0])); ++i)
    if (SPECIAL[i][0] == pl.L) return i;
  return -1;
}

// Items a block walks at most (the next one's inputs loading while one is
// transformed); more blocks than fit at once where the items allow.
constexpr int WALK = 4;

template <typename K>
cudaError_t launch_shape(K kernel, int threads, size_t smem, int items, int* grid) {
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int walked = (items + WALK - 1) / WALK;
  const int g = walked > per_sm * sms ? walked : per_sm * sms;
  *grid = items < g ? items : g;
  return cudaSuccess;
}

// The three launches. The patches (ph, pw) are input a, `b` (b_rows, b_cols)
// the PSFs or the cotangent; pass 2 keeps rows [row0, row0 + n_out) of the
// product (conj_b: of the correlation), pass 3 its columns [t0, t0 + nt)
// into dst (n_patch, n_out, nt, n_ch), flipped with flip.
cudaError_t fft_route(const float* a, const float* b, int b_rows, int b_cols, const float2* tw_h,
                      const float2* tw_w, float2* spec, int n_patch, int n_ch, int ph, int pw,
                      int conj_b, int row0, int n_out, float* dst, int t0, int nt, int flip,
                      cudaStream_t stream) {
  Plan ph_plan, pw_plan;
  const int lh = fft_len(ph), lw = fft_len(pw);
  if (!make_plan(lh, &ph_plan) || !make_plan(lw, &pw_plan)) return cudaErrorInvalidValue;
  const int nc = lw / 2 + 1;
  const int n_pc = n_patch * n_ch;
  float2* a_spec = spec;
  float2* b_spec = spec + (size_t)n_pc * ph * nc;
  cudaError_t err;
  int spb, threads, grid;

  int pitch = padi(lw) + 1;
  rows_shape(pw_plan, pitch, n_ch, &spb, &threads);
  size_t smem = sizeof(float2) * (padi(lw) + 2 * (size_t)spb * pitch);
  const RowsIn ra{a, a_spec, ph, pw, ((ph + 1) / 2 * n_ch + spb - 1) / spb};
  const RowsIn rb{b, b_spec, b_rows, b_cols, ((b_rows + 1) / 2 * n_ch + spb - 1) / spb};
  auto rows_fwd = SELECT(fft_rows_fwd, pw_plan);
  if ((err = launch_shape(rows_fwd, threads, smem, (ra.groups + rb.groups) * n_patch, &grid)) !=
      cudaSuccess)
    return err;
  rows_fwd<<<grid, threads, smem, stream>>>(ra, rb, n_patch, n_ch, pw_plan, spb, pitch, tw_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // Columns: up to 8 an item, a power of two, both buffers within SMEM_COLS
  // and 2 group L/M within BLOCK_THREADS.
  pitch = padi(lh) + 1;
  int lg = 3;
  while (lg > 0 && (4 * (sizeof(float2) << lg) * pitch > SMEM_COLS ||
                    (2 << lg) * plan_threads(ph_plan) > BLOCK_THREADS))
    --lg;
  const int group = 1 << lg;
  threads = imin(MAX_THREADS, round32(2 * group * plan_threads(ph_plan)));
  smem = sizeof(float2) * (padi(lh) + 4 * (size_t)group * pitch);
  auto cols = SELECT(fft_cols, ph_plan);
  if ((err = launch_shape(cols, threads, smem, n_pc * ((nc + group - 1) / group), &grid)) !=
      cudaSuccess)
    return err;
  cols<<<grid, threads, smem, stream>>>(a_spec, ph, b_spec, b_rows, nc, n_pc, ph_plan, group, lg,
                                       pitch, conj_b, row0, n_out, tw_h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  pitch = padi(lw + 2) + 1;
  rows_shape(pw_plan, pitch, n_ch, &spb, &threads);
  smem = sizeof(float2) * (padi(lw) + 2 * (size_t)spb * pitch);
  const int groups = ((n_out + 1) / 2 * n_ch + spb - 1) / spb;
  auto rows_inv = SELECT(fft_rows_inv, pw_plan);
  if ((err = launch_shape(rows_inv, threads, smem, groups * n_patch, &grid)) != cudaSuccess)
    return err;
  const float scale = (float)(1.0 / ((double)lh * lw));
  rows_inv<<<grid, threads, smem, stream>>>(a_spec, ph, n_out, groups, n_patch, dst, n_ch,
                                           pw_plan, spb, pitch, scale, t0, nt, flip, tw_w);
  return cudaGetLastError();
}

bool bad_shape(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  return n_patch < 0 || n_ch < 1 || kh < 1 || kw < 1 || ph < kh || pw < kw || ph > LMAX ||
         pw > LMAX || (long long)n_patch * n_ch > 65535;
}

}  // namespace

extern "C" {

// The longest transform, so the largest patch side, the route takes.
int p2_fft_max_len() { return LMAX; }

// The route's transform length for a side of n points (image.fft_len).
int p2_fft_len(int n) { return fft_len(n); }

// Kernel launches a call of either function makes.
int p2_fft_launches() { return 3; }

// Floats of scratch a call needs: the half spectra of the patches' ph rows
// and of the second input's rows (the PSFs' kh, or with `adjoint` the
// cotangent's ph - kh + 1), complex.
long long p2_fft_scratch(int n_patch, int n_ch, int ph, int pw, int kh, int adjoint) {
  const long long nc = fft_len(pw) / 2 + 1;
  const long long b_rows = adjoint ? ph - kh + 1 : kh;
  return 2LL * n_patch * n_ch * (ph + b_rows) * nc;
}

// P2 by FFT on `stream`, p2_fft_launches() kernel launches; returns
// cudaGetLastError() (0 on success). patches (n_patch, ph, pw, n_ch), psfs
// (n_patch, kh, kw, n_ch), out (n_patch, ph - kh + 1, pw - kw + 1, n_ch),
// twiddles (fft_len(ph), 2) and (fft_len(pw), 2) (W_L^i), scratch
// p2_fft_scratch(.., 0) floats; all float32, contiguous.
int p2_fft_launch(const float* patches, const float* psfs, float* out, const float* tw_h,
                  const float* tw_w, float* scratch, int n_patch, int n_ch, int ph, int pw, int kh,
                  int kw, void* stream) {
  if (bad_shape(n_patch, n_ch, ph, pw, kh, kw)) return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  return (int)fft_route(patches, psfs, kh, kw, reinterpret_cast<const float2*>(tw_h),
                        reinterpret_cast<const float2*>(tw_w), reinterpret_cast<float2*>(scratch),
                        n_patch, n_ch, ph, pw, 0, kh - 1, ph - kh + 1, out, kw - 1, pw - kw + 1,
                        0, (cudaStream_t)stream);
}

// P2's d/dpsf by FFT: the same launches; cot (n_patch, ph - kh + 1,
// pw - kw + 1, n_ch) in, dpsf (n_patch, kh, kw, n_ch) out, scratch
// p2_fft_scratch(.., 1) floats.
int p2_dpsf_fft_launch(const float* patches, const float* cot, float* dpsf, const float* tw_h,
                       const float* tw_w, float* scratch, int n_patch, int n_ch, int ph, int pw,
                       int kh, int kw, void* stream) {
  if (bad_shape(n_patch, n_ch, ph, pw, kh, kw)) return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  return (int)fft_route(patches, cot, ph - kh + 1, pw - kw + 1,
                        reinterpret_cast<const float2*>(tw_h),
                        reinterpret_cast<const float2*>(tw_w), reinterpret_cast<float2*>(scratch),
                        n_patch, n_ch, ph, pw, 1, 0, kh, dpsf, 0, kw, 1, (cudaStream_t)stream);
}

}  // extern "C"
