// P2's FFT route: SVOLA's patch convolution (and its d/dpsf correlation) for
// wide PSFs, as a hand-written 2D FFT convolution.
//
// Replaces, for PSFs of P2_FFT_MIN_KW taps and more (ops/image.py), the
// direct K^2-tap sum of svola_conv.cu, the port of the Pallas TPU kernel
// `_k_acc` of benchmarks/probe_svola_direct.py, and the direct d/dpsf kernel
// of svola_conv_bwd.cu. It follows the reference's own algorithm:
// torchoptics_tpu/ops/image.py:svola_convolution convolves each patch by an
// rfftn product at the patch's length and keeps the valid region, and XLA
// differentiates that. The plain PyTorch versions are
// torchoptics_tpu_torch/ops/image.py:svola_patch_conv_fft_reference and
// svola_patch_conv_dpsf_fft_reference; kernels and plain versions agree bit
// for bit.
//
// What it computes, on the JAX layout with channels innermost: for every
// patch-channel plane, the circular convolution at lengths Lh >= ph and
// Lw >= pw (powers of two, 16 to 4096) of the (ph, pw) patch with the
// (kh, kw) PSF, keeping rows [kh-1, ph) and columns [kw-1, pw): the wrap
// never reaches them, so that is the valid convolution that
// svola_conv.cu computes. d/dpsf is the circular correlation of the patch
// with the (hp, wp) cotangent g, corr[s, t] = sum_ij g[i, j] patch[i+s, j+t],
// whose lags s < kh, t < kw do not wrap either; dpsf[u, v] =
// corr[kh-1-u, kw-1-v].
//
// Three launches, the same three kernels for both functions:
//   1. fft_rows_fwd: the rows of both inputs (the patches, and the PSFs or
//      the cotangent), two real rows packed into one complex row of Lw
//      points, transformed in shared memory and separated by conjugate
//      symmetry into the two rows' half spectra (Lw/2 + 1 values), stored
//      to a scratch buffer. Rows past the data are never transformed.
//   2. fft_cols: a block takes a few columns of one plane's half spectra:
//      the forward column FFT of both inputs (zero past their rows), the
//      pointwise product (the second factor conjugated for d/dpsf), the
//      inverse column FFT, all in shared memory; only the rows that a kept
//      output needs are stored, over the patch's spectra in place (the
//      block has read all of its columns first).
//   3. fft_rows_inv: two rows' half spectra packed into one complex row by
//      Hermitian symmetry (the imaginary parts at 0 and Lw/2 dropped, as an
//      inverse real FFT does), the inverse transform, the exact scale
//      1/(Lh Lw), and only the kept columns written, in the (P, hp, wp, C)
//      layout of P2's output or, flipped, the (P, kh, kw, C) layout of the
//      PSF gradient.
//
// Every transform is the radix-2 Stockham FFT: for Ns = 1, 2, .., L/2,
// a = x[j], b = x[j + L/2], t = w b with w = W_L^((j mod Ns) L / (2 Ns))
// (conjugated for the inverse), y[(j / Ns) 2 Ns + j mod Ns] = a + t and
// y[.. + Ns] = a - t; each complex product (ac - bd, ad + bc) with its
// products rounded before their sums (-fmad=false). A thread holds the 8
// values x[t + m L/8] and runs 3 of those stages on them in registers before
// the values go back to shared memory: the same butterflies, in the same
// arithmetic, as one stage at a time, so the plain version is the radix-2
// Stockham written out. The twiddles W_4096^i (i < 2048) are one table,
// computed in float64 and rounded to float32, that the wrapper hands to the
// kernels and the plain version alike; each block copies the entries of its
// length into shared memory.
//
// What bounds it on an H100: 5 L log2 L operations a complex transform. At
// the default configuration's 2048^2 render (243 planes of 385^2, K = 47,
// L = 512) the three passes run ~2.8e5 transforms, ~6.5e9 operations, 0.1 ms
// at 67 TFLOP/s; the patches and PSFs read once and the outputs written
// once take 0.08 ms at 3.35 TB/s; the scratch spectra between the passes
// (~0.8 GB) 0.2 ms more. A thread's 8 values take 16 shared-memory accesses
// and 12 twiddle loads a pass for ~120 operations, so shared memory, not the
// arithmetic, is the first ceiling of this design. Its indices are padded
// by one slot every 16 (padi) so that the strided writes of the first
// stages and the twiddle loads spread over the banks.

#include <cuda_runtime.h>

namespace {

constexpr int LMAX_LOG2 = 12;                // the table's length: W_4096
constexpr int LMIN_LOG2 = 4;                 // the shortest transform, 16 points
constexpr int MAX_THREADS = 512;
constexpr int COLS_FLOATS = 4096;            // a column block's columns x Lh
constexpr size_t SMEM_MAX = 232448;          // 227 KB

__host__ __device__ constexpr int padi(int i) { return i + (i >> 4); }

// Shared-memory pitch of one sequence of 2^log2L points (odd, so that the
// sequences of a block start on different banks).
__host__ __device__ constexpr int seq_pitch(int log2L) { return padi(1 << log2L) + 1; }

__device__ __forceinline__ float2 cmul(float2 b, float2 w) {
  return make_float2(b.x * w.x - b.y * w.y, b.x * w.y + b.y * w.x);
}

// The twiddles of a 2^log2L-point transform, W_L^i for i < L/2, from the
// W_4096 table into shared memory.
__device__ void load_twiddles(float2* tws, const float2* __restrict__ tw, int log2L) {
  const int half = 1 << (log2L - 1);
  const int shift = LMAX_LOG2 - log2L;
  for (int i = threadIdx.x; i < half; i += blockDim.x) tws[padi(i)] = tw[i << shift];
}

// In place, the unscaled forward (or, with inv, inverse) transform of nseq
// sequences of L = 2^log2L points in shared memory, sequence s at
// seqs + s * pitch, point i at padi(i). T = L/8 threads a sequence,
// blockDim.x / T sequences a round; every thread of the block calls it.
__device__ void fft_smem(float2* seqs, int pitch, int nseq, int log2L, const float2* tws,
                         bool inv) {
  const int T = 1 << (log2L - 3);
  const int per_round = blockDim.x >> (log2L - 3);
  const int t = threadIdx.x & (T - 1);
  const int slot = threadIdx.x >> (log2L - 3);
  for (int stage = 0; stage < log2L; stage += 3) {
    for (int s0 = 0; s0 < nseq; s0 += per_round) {
      const bool active = slot < per_round && s0 + slot < nseq;
      float2* x = seqs + (size_t)(s0 + slot) * pitch;
      float2 v[8];
      int idx[8];
      if (active) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          idx[m] = t + m * T;
          v[m] = x[padi(idx[m])];
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int st = stage + u;
          if (st >= log2L) break;
          const int ns = 1 << st;
          const int half = 4 >> u;
          const int tshift = log2L - 1 - st;
#pragma unroll
          for (int b = 0; b < 8; b += 2 * half) {
#pragma unroll
            for (int r = b; r < b + half; ++r) {
              // idx[r + half] is idx[r] + L/2: the radix-2 pair of stage st.
              const int j = idx[r];
              const int k = j & (ns - 1);
              float2 w = tws[padi(k << tshift)];
              if (inv) w.y = -w.y;
              const float2 tt = cmul(v[r + half], w);
              const float2 a = v[r];
              v[r] = make_float2(a.x + tt.x, a.y + tt.y);
              v[r + half] = make_float2(a.x - tt.x, a.y - tt.y);
              idx[r] = ((j >> st) << (st + 1)) + k;
              idx[r + half] = idx[r] + ns;
            }
          }
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) x[padi(idx[m])] = v[m];
      }
      __syncthreads();
    }
  }
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
// spectra (n_patch n_ch, rows, L/2 + 1), and the blocks that take it.
struct RowsIn {
  const float* src;
  float2* spec;
  int rows;
  int cols;
  int blocks;
};

// Pass 1. Block (x, p): `spb` consecutive sequences (row pair q, channel c),
// numbered q n_ch + c, of patch p of input a (x < a.blocks) or b.
__global__ void __launch_bounds__(MAX_THREADS) fft_rows_fwd(RowsIn a, RowsIn b, int n_ch,
                                                             int log2L, int spb,
                                                             const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  const int L = 1 << log2L;
  const int pitch = seq_pitch(log2L);
  float2* tws = sm;
  float2* seqs = sm + padi(L / 2);
  const bool first = blockIdx.x < (unsigned)a.blocks;
  const RowsIn in = first ? a : b;
  const int p = blockIdx.y;
  const int s0 = (first ? blockIdx.x : blockIdx.x - a.blocks) * spb;
  const int ns = min(spb, (in.rows + 1) / 2 * n_ch - s0);
  load_twiddles(tws, tw, log2L);
  for (int e = threadIdx.x; e < ns * pitch; e += blockDim.x) seqs[e] = make_float2(0.0f, 0.0f);
  __syncthreads();
  // The block's rows, read whole (all channels, coalesced); row 2q goes to
  // the real part of sequence (q, c), row 2q + 1 to its imaginary part.
  const int r0 = s0 / n_ch * 2;
  const int r1 = min(in.rows, (s0 + ns - 1) / n_ch * 2 + 2);
  const float* src = in.src + ((size_t)p * in.rows + r0) * in.cols * n_ch;
  for (Walk w(in.cols); w.r < r1 - r0; w.next(in.cols)) {
    const int r = r0 + w.r;
    const int sr = (r >> 1) * n_ch - s0;
    const float* px = src + ((size_t)w.r * in.cols + w.x) * n_ch;
    for (int c = 0; c < n_ch; ++c) {
      const int s = sr + c;
      if (s >= 0 && s < ns)
        reinterpret_cast<float*>(seqs + s * pitch + padi(w.x))[r & 1] = px[c];
    }
  }
  __syncthreads();
  fft_smem(seqs, pitch, ns, log2L, tws, false);
  // Z = A + iB: A_k = (Z_k + conj Z_{L-k}) / 2, B_k = (Z_k - conj Z_{L-k}) / 2i.
  // The threads of a sequence's transform store its two rows.
  const int nc = L / 2 + 1;
  const int sl = threadIdx.x >> (log2L - 3);
  if (sl < ns) {
    const int q = (s0 + sl) / n_ch;
    const int c = s0 + sl - q * n_ch;
    const float2* z_s = seqs + sl * pitch;
    float2* row = in.spec + (((size_t)p * n_ch + c) * in.rows + 2 * q) * nc;
    const bool pair = 2 * q + 1 < in.rows;
    for (int k = threadIdx.x & ((L >> 3) - 1); k < nc; k += L >> 3) {
      const float2 z = z_s[padi(k)];
      const float2 zm = z_s[padi((L - k) & (L - 1))];
      row[k] = make_float2((z.x + zm.x) * 0.5f, (z.y - zm.y) * 0.5f);
      if (pair) row[nc + k] = make_float2((z.y + zm.y) * 0.5f, (zm.x - z.x) * 0.5f);
    }
  }
}

// Pass 2. Block (x, plane): columns [x group, x group + group) of one plane's
// half spectra (nc columns): a's a_rows rows and b's b_rows rows, each zero
// to Lh; the forward column FFTs, a b (or a conj(b)), the inverse; rows
// [row0, row0 + n_out) stored over a's rows [0, n_out).
__global__ void __launch_bounds__(MAX_THREADS) fft_cols(float2* a_spec, int a_rows,
                                                         const float2* __restrict__ b_spec,
                                                         int b_rows, int nc, int log2L, int group,
                                                         int conj_b, int row0, int n_out,
                                                         const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  const int L = 1 << log2L;
  const int pitch = seq_pitch(log2L);
  float2* tws = sm;
  float2* sa = sm + padi(L / 2);
  float2* sb = sa + group * pitch;
  const int k0 = blockIdx.x * group;
  const int ng = min(group, nc - k0);
  load_twiddles(tws, tw, log2L);
  // Zeros past each column's rows (and in the columns past nc).
  for (int e = threadIdx.x; e < group * L; e += blockDim.x) {
    const int g = e >> log2L;
    const int i = e & (L - 1);
    if (g >= ng || i >= a_rows) sa[g * pitch + padi(i)] = make_float2(0.0f, 0.0f);
    if (g >= ng || i >= b_rows) sb[g * pitch + padi(i)] = make_float2(0.0f, 0.0f);
  }
  // A thread takes column g of rows r0, r0 + step, ..
  float2* a_src = a_spec + (size_t)blockIdx.y * a_rows * nc + k0;
  const float2* b_src = b_spec + (size_t)blockIdx.y * b_rows * nc + k0;
  const int g = threadIdx.x % group;
  const int r0 = threadIdx.x / group;
  const int step = blockDim.x / group;
  const bool mine = g < ng && r0 < step;
  if (mine) {
    for (int r = r0; r < a_rows; r += step) sa[g * pitch + padi(r)] = a_src[(size_t)r * nc + g];
    for (int r = r0; r < b_rows; r += step) sb[g * pitch + padi(r)] = b_src[(size_t)r * nc + g];
  }
  __syncthreads();
  fft_smem(sa, pitch, 2 * group, log2L, tws, false);
  for (int e = threadIdx.x; e < ng * L; e += blockDim.x) {
    const int at = (e >> log2L) * pitch + padi(e & (L - 1));
    const float2 x = sa[at];
    const float2 y = sb[at];
    sa[at] = conj_b ? make_float2(x.x * y.x + x.y * y.y, x.y * y.x - x.x * y.y)
                    : make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
  }
  __syncthreads();
  fft_smem(sa, pitch, ng, log2L, tws, true);
  if (mine)
    for (int r = r0; r < n_out; r += step)
      a_src[(size_t)r * nc + g] = sa[g * pitch + padi(row0 + r)];
}

// Pass 3. Block (x, p): `spb` sequences (row pair q, channel c) of the
// n_rows rows of plane (p, c) (a plane's rows spec_rows apart): X + iY from
// rows 2q and 2q + 1, the inverse FFT, times `scale`; columns [t0, t0 + nt)
// written to dst (n_patch, n_rows, nt, n_ch), flipped in both axes with flip.
__global__ void __launch_bounds__(MAX_THREADS) fft_rows_inv(const float2* __restrict__ spec,
                                                             int spec_rows, int n_rows,
                                                             float* __restrict__ dst, int n_ch,
                                                             int log2L, int spb, float scale,
                                                             int t0, int nt, int flip,
                                                             const float2* __restrict__ tw) {
  extern __shared__ float2 sm[];
  const int L = 1 << log2L;
  const int pitch = seq_pitch(log2L);
  float2* tws = sm;
  float2* seqs = sm + padi(L / 2);
  const int p = blockIdx.y;
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, (n_rows + 1) / 2 * n_ch - s0);
  const int nc = L / 2 + 1;
  load_twiddles(tws, tw, log2L);
  // The threads of a sequence's transform gather its points.
  const int sl = threadIdx.x >> (log2L - 3);
  if (sl < ns) {
    const int q = (s0 + sl) / n_ch;
    const int c = s0 + sl - q * n_ch;
    const float2* row = spec + (((size_t)p * n_ch + c) * spec_rows + 2 * q) * nc;
    const bool pair = 2 * q + 1 < n_rows;
    for (int k = threadIdx.x & ((L >> 3) - 1); k < L; k += L >> 3) {
      const int kk = k <= L / 2 ? k : L - k;
      const float2 X = row[kk];
      const float2 Y = pair ? row[nc + kk] : make_float2(0.0f, 0.0f);
      float2 z;
      if (k == 0 || k == L / 2)
        z = make_float2(X.x, Y.x);
      else if (k < L / 2)
        z = make_float2(X.x - Y.y, X.y + Y.x);
      else  // X_k = conj X_{L-k}, Y_k = conj Y_{L-k}
        z = make_float2(X.x + Y.y, Y.x - X.y);
      seqs[sl * pitch + padi(k)] = z;
    }
  }
  __syncthreads();
  fft_smem(seqs, pitch, ns, log2L, tws, true);
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
      const float2 z = seqs[s * pitch + padi(t0 + w.x)];
      px[c] = ((r & 1) ? z.y : z.x) * scale;
    }
  }
}

__host__ int fft_log2(int n) {
  int l = LMIN_LOG2;
  while ((1 << l) < n) ++l;
  return l;
}

// Sequences a block of pass 1 or 3 (whole row pairs where the threads allow).
__host__ int rows_spb(int n_ch, int log2L) {
  int spb = MAX_THREADS >> (log2L - 3);
  if (spb >= n_ch) spb = spb / n_ch * n_ch;
  return spb;
}

__host__ size_t rows_smem(int log2L, int spb) {
  return sizeof(float2) * ((size_t)padi(1 << (log2L - 1)) + (size_t)spb * seq_pitch(log2L));
}

// Columns a block of pass 2: COLS_FLOATS / Lh (8 at Lh = 512), at most nc.
__host__ int cols_group(int log2L, int nc) {
  const int g = COLS_FLOATS >> log2L;
  return g < 1 ? 1 : g < nc ? g : nc;
}

__host__ size_t cols_smem(int log2L, int group) {
  return sizeof(float2) * ((size_t)padi(1 << (log2L - 1)) + 2 * (size_t)group * seq_pitch(log2L));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The three launches. The patches (ph, pw) are input a, `b` (b_rows, b_cols)
// the PSFs or the cotangent; pass 2 keeps rows [row0, row0 + n_out) of the
// product (conj_b: of the correlation), pass 3 its columns [t0, t0 + nt)
// into dst (n_patch, n_out, nt, n_ch), flipped with flip.
cudaError_t fft_route(const float* a, const float* b, int b_rows, int b_cols, const float2* tw,
                      float2* spec, int n_patch, int n_ch, int ph, int pw, int conj_b, int row0,
                      int n_out, float* dst, int t0, int nt, int flip, cudaStream_t stream) {
  const int lh = fft_log2(ph);
  const int lw = fft_log2(pw);
  const int nc = (1 << (lw - 1)) + 1;
  const int n_pc = n_patch * n_ch;
  float2* a_spec = spec;
  float2* b_spec = spec + (size_t)n_pc * ph * nc;
  cudaError_t err;

  const int spb = rows_spb(n_ch, lw);
  const int tw_threads = spb << (lw - 3);
  const RowsIn ra{a, a_spec, ph, pw, ((ph + 1) / 2 * n_ch + spb - 1) / spb};
  const RowsIn rb{b, b_spec, b_rows, b_cols, ((b_rows + 1) / 2 * n_ch + spb - 1) / spb};
  size_t smem = rows_smem(lw, spb);
  if ((err = allow_smem(fft_rows_fwd, smem)) != cudaSuccess) return err;
  fft_rows_fwd<<<dim3(ra.blocks + rb.blocks, n_patch), tw_threads, smem, stream>>>(
      ra, rb, n_ch, lw, spb, tw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int group = cols_group(lh, nc);
  const int col_threads = (2 * group) << (lh - 3) < MAX_THREADS ? (2 * group) << (lh - 3)
                                                                : MAX_THREADS;
  smem = cols_smem(lh, group);
  if ((err = allow_smem(fft_cols, smem)) != cudaSuccess) return err;
  fft_cols<<<dim3((nc + group - 1) / group, n_pc), col_threads, smem, stream>>>(
      a_spec, ph, b_spec, b_rows, nc, lh, group, conj_b, row0, n_out, tw);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = rows_smem(lw, spb);
  if ((err = allow_smem(fft_rows_inv, smem)) != cudaSuccess) return err;
  const float scale = 1.0f / (float)((1LL << lh) * (1LL << lw));
  fft_rows_inv<<<dim3(((n_out + 1) / 2 * n_ch + spb - 1) / spb, n_patch), tw_threads, smem,
                 stream>>>(a_spec, ph, n_out, dst, n_ch, lw, spb, scale, t0, nt, flip, tw);
  return cudaGetLastError();
}

bool bad_shape(int n_patch, int n_ch, int ph, int pw, int kh, int kw) {
  return n_patch < 0 || n_ch < 1 || kh < 1 || kw < 1 || ph < kh || pw < kw ||
         ph > (1 << LMAX_LOG2) || pw > (1 << LMAX_LOG2) || (long long)n_patch * n_ch > 65535;
}

}  // namespace

extern "C" {

// The longest transform, so the largest patch side, the route takes.
int p2_fft_max_len() { return 1 << LMAX_LOG2; }

// Kernel launches a call of either function makes.
int p2_fft_launches() { return 3; }

// Floats of scratch a call needs: the half spectra of the patches' ph rows
// and of the second input's rows (the PSFs' kh, or with `adjoint` the
// cotangent's ph - kh + 1), complex.
long long p2_fft_scratch(int n_patch, int n_ch, int ph, int pw, int kh, int adjoint) {
  const long long nc = (1LL << (fft_log2(pw) - 1)) + 1;
  const long long b_rows = adjoint ? ph - kh + 1 : kh;
  return 2LL * n_patch * n_ch * (ph + b_rows) * nc;
}

// P2 by FFT on `stream`, p2_fft_launches() kernel launches; returns
// cudaGetLastError() (0 on success). patches (n_patch, ph, pw, n_ch), psfs
// (n_patch, kh, kw, n_ch), out (n_patch, ph - kh + 1, pw - kw + 1, n_ch),
// twiddles (2048, 2) (W_4096^i), scratch p2_fft_scratch(.., 0) floats; all
// float32, contiguous.
int p2_fft_launch(const float* patches, const float* psfs, float* out, const float* twiddles,
                  float* scratch, int n_patch, int n_ch, int ph, int pw, int kh, int kw,
                  void* stream) {
  if (bad_shape(n_patch, n_ch, ph, pw, kh, kw)) return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  return (int)fft_route(patches, psfs, kh, kw, reinterpret_cast<const float2*>(twiddles),
                        reinterpret_cast<float2*>(scratch), n_patch, n_ch, ph, pw, 0, kh - 1,
                        ph - kh + 1, out, kw - 1, pw - kw + 1, 0, (cudaStream_t)stream);
}

// P2's d/dpsf by FFT: the same launches; cot (n_patch, ph - kh + 1,
// pw - kw + 1, n_ch) in, dpsf (n_patch, kh, kw, n_ch) out, scratch
// p2_fft_scratch(.., 1) floats.
int p2_dpsf_fft_launch(const float* patches, const float* cot, float* dpsf,
                       const float* twiddles, float* scratch, int n_patch, int n_ch, int ph,
                       int pw, int kh, int kw, void* stream) {
  if (bad_shape(n_patch, n_ch, ph, pw, kh, kw)) return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  return (int)fft_route(patches, cot, ph - kh + 1, pw - kw + 1,
                        reinterpret_cast<const float2*>(twiddles),
                        reinterpret_cast<float2*>(scratch), n_patch, n_ch, ph, pw, 1, 0, kh, dpsf,
                        0, kw, 1, (cudaStream_t)stream);
}

}  // extern "C"
