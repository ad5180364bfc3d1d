// P2: the patch convolution of SVOLA (spatially-varying overlap-add).
//
// Replaces the Pallas TPU kernel `_k_acc` of
// benchmarks/probe_svola_direct.py (the direct K^2-tap form of the patch
// convolution that torchoptics_tpu/ops/image.py:svola_convolution computes
// by FFT). The plain PyTorch version of the same function is
// torchoptics_tpu_torch/ops/image.py:svola_patch_conv_reference; the two
// agree bit for bit.
//
// What it computes, for every patch p of the batch (B x N patches) and every
// channel c, on the JAX layout (P, ph, pw, C) with channels innermost:
//
//   out[p, i, j, c] = sum_{a < kh, b < kw} psf[p, kh-1-a, kw-1-b, c]
//                                          * patch[p, i+a, j+b, c]
//
// for i < ph - kh + 1, j < pw - kw + 1: the valid part of the convolution of
// the patch with its local PSF, which is what svola_convolution's FFT path
// keeps (its circular index never wraps into that region). Note the flipped
// taps: `_k_acc` sums psf[a, b] * patch[i+a, j+b], a correlation, which
// differs from SVOLA for any PSF that is not point-symmetric (off-axis PSFs
// are not). Each output's sum runs a outer, b inner, from 0, each product
// rounded before its sum (-fmad=false), in the plain version's order.
//
// What bounds it on an H100: kh*kw multiply-adds per output element. At the
// imaging path's 1024^2 render (5 x 5 patches of 306^2 px, 3 channels,
// K = 11) that is 8.50e8 multiply-adds, 1.70e9 FP32 operations, 25.4 us at
// 67 TFLOP/s, against 58.1 MB of traffic (the 316^2 input patches read once,
// the 306^2 outputs written once), 17.3 us at 3.35 TB/s: operations bound
// it. Without FMA contraction each multiply-add issues as two instructions,
// so the issue rate of the FP32 pipes (not the 67 TFLOP/s figure, which
// counts an FMA as two operations) is the real ceiling: about 2x that bound.
// An SM's shared memory serves one 32-lane 32-bit load a clock against four
// FP32 warp-instructions, so a kernel that loads an operand from shared
// memory for every multiply-add is bound by the loads, not the arithmetic.
//
// Design: register blocking. A block of 64 threads a channel, up to
// GROUP = 4 channels, takes a 32 x 32 output tile of all its channels: the
// (32 + kh - 1) x (32 + kw - 1) input tile of each channel, read from the
// (P, ph, pw, C) layout with the channels innermost (a warp reads whole
// rows) by cp.async, every copy in flight at once, and the flipped taps,
// zero-padded to rows of a multiple of 4, go to shared memory. Each thread
// computes a 4 x 4 block of outputs of one channel. It walks the input rows
// its block needs; each row's window of 4 + kw - 1 values is read once, in
// 16-byte loads, into registers, and serves every output row r of the block
// whose tap row a = y - r exists there, with the taps of that row read in
// 16-byte broadcast loads. Each output still gets its products in the order
// a, b ascending. A thread issues about one shared-memory load per 16
// multiply-adds, where a load per multiply-add bounded the one-output-a-
// load design by the loads. kw = 3, 5, 11 and 23 (the renders at 256^2,
// 512^2, 1024^2 and 2048^2 of config 5) are instantiated with the tap loop
// unrolled and the whole window in registers; any other kw runs the same
// kernel with a runtime tap loop in chunks of 4. The finished tile goes
// through shared memory so that the block writes whole output rows.
// Measured on an H100 and not kept (PERF.md section 6): a ring of 4 tap rows
// in registers (97 registers, fewer blocks an SM), the input rows walked 4
// at a time (a 4,184-instruction body at kw = 23), 8 x 4 outputs a thread.
//
// Wide PSFs: from P2_FFT_MIN_KW = 33 taps on the larger side (the default
// configuration's renders from 1448^2 up) P2 takes its FFT route,
// svola_fft.cu (ops/image.py routes the calls), which was faster there in
// both directions on an H100. So this kernel takes kh and kw up to MAX_K =
// 32 (p2_max_kw()), where one pass of a block's channels always fits in
// shared memory (80,896 bytes at 32 x 32 and four channels).
//
// The adjoint is in svola_conv_bwd.cu: d/dpsf has a kernel of its own;
// d/dpatch is this kernel on the zero-padded cotangent with the flipped PSF.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int RX = 4;               // outputs a thread along x
constexpr int RY = 4;               // outputs a thread along y
constexpr int TX = 8;               // threads a channel along x
constexpr int TY = 8;               // threads a channel along y
constexpr int TILE_X = TX * RX;     // 32
constexpr int TILE_Y = TY * RY;     // 32
constexpr int PER_CH = TX * TY;     // 64 threads a channel
constexpr int GROUP = 4;            // channels a block, at most
constexpr int MAX_K = 32;           // kh and kw at most (wider PSFs take svola_fft.cu)
// The kw values with an unrolled kernel: the PSFs of the renders at 256^2,
// 512^2, 1024^2 and 2048^2 (imaging.psf_kernel_shape). Others take the
// runtime-kw kernel.
constexpr int SPECIALIZED_KW[] = {3, 5, 11, 23};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// A tile row holds the 32 + kw - 1 columns a tile needs and the padding that
// the 16-byte window loads read past them (zeros).
__host__ __device__ constexpr int tile_pitch(int kw) { return TILE_X + round4(kw); }

// One input row's contribution to a thread's RY x RX outputs: the row is y rows
// below the thread's first output row; output row r takes tap row a = y - r.
// `row` is the thread's window start in the tile, `taps` the channel's
// flipped taps, rows of `tpitch` floats. KW > 0: the whole window (RX + KW - 1
// values) in registers, the tap loop unrolled; KW = 0: a runtime loop over
// kw in chunks of 4 taps (a window of RX + 3 values).
template <int KW>
__device__ __forceinline__ void row_taps(const float* __restrict__ row,
                                         const float* __restrict__ taps, int y, int kh, int kw,
                                         int tpitch, float (&acc)[RY][RX]) {
  if constexpr (KW > 0) {
    constexpr int NWIN = round4(RX + KW - 1) / 4;
    constexpr int NTAP = round4(KW) / 4;
    float win[4 * NWIN];
#pragma unroll
    for (int q = 0; q < NWIN; ++q) {
      const float4 v = reinterpret_cast<const float4*>(row)[q];
      win[4 * q] = v.x;
      win[4 * q + 1] = v.y;
      win[4 * q + 2] = v.z;
      win[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int a = y - r;
      if (a < 0 || a >= kh) continue;
      float w[4 * NTAP];
#pragma unroll
      for (int q = 0; q < NTAP; ++q) {
        const float4 v = reinterpret_cast<const float4*>(taps + a * tpitch)[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int b = 0; b < KW; ++b)
#pragma unroll
        for (int j = 0; j < RX; ++j) acc[r][j] = acc[r][j] + w[b] * win[j + b];
    }
  } else {
    for (int b0 = 0; b0 < kw; b0 += 4) {
      constexpr int NWIN = round4(RX + 3) / 4;
      float win[4 * NWIN];
#pragma unroll
      for (int q = 0; q < NWIN; ++q) {
        const float4 v = reinterpret_cast<const float4*>(row + b0)[q];
        win[4 * q] = v.x;
        win[4 * q + 1] = v.y;
        win[4 * q + 2] = v.z;
        win[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int a = y - r;
        if (a < 0 || a >= kh) continue;
        const float4 t = *reinterpret_cast<const float4*>(taps + a * tpitch + b0);
        const float w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          if (b0 + bb >= kw) break;
#pragma unroll
          for (int j = 0; j < RX; ++j) acc[r][j] = acc[r][j] + w[bb] * win[j + bb];
        }
      }
    }
  }
}

// Shared memory of a block: per channel the input tile, then the taps.
__host__ __device__ constexpr int plane_floats(int kh, int kw) {
  return (TILE_Y + kh - 1) * tile_pitch(kw) + kh * round4(kw);
}

template <int KW>
__global__ void __launch_bounds__(PER_CH * GROUP) p2_svola_kernel(
    const float* __restrict__ patches, const float* __restrict__ psfs,
    float* __restrict__ out, int n_ch, int group, int ph, int pw, int kh, int kw) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (KW > 0) kw = KW;
  const int hp = ph - kh + 1;
  const int wp = pw - kw + 1;
  const int n_groups = (n_ch + group - 1) / group;
  const int p = blockIdx.z / n_groups;
  const int c0 = (blockIdx.z - p * n_groups) * group;
  const int gc = min(group, n_ch - c0);  // the block's channels
  const int y0 = blockIdx.y * TILE_Y;
  const int x0 = blockIdx.x * TILE_X;
  const int pitch = tile_pitch(kw);
  const int tpitch = round4(kw);
  const int span_y = TILE_Y + kh - 1;
  const int plane = plane_floats(kh, kw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // The input tile, a warp a row: its gc channels of each pixel are
  // consecutive in memory, so the warp's loads cover whole sectors. The
  // copies are asynchronous (cp.async), all in flight at once, instead of a
  // load and a store in turn; what lies outside the patch is zero.
  const float* src = patches + (size_t)p * ph * pw * n_ch + c0;
  for (int y = warp; y < span_y; y += n_warps) {
    const int gy = y0 + y;
    for (int x = lane; x < pitch; x += 32) {
      const int gx = x0 + x;
      float* dst = smem + y * pitch + x;
      if (gy < ph && gx < pw) {
        const float* s = src + ((size_t)gy * pw + gx) * n_ch;
        for (int g = 0; g < gc; ++g) __pipeline_memcpy_async(dst + g * plane, s + g, 4);
      } else {
        for (int g = 0; g < gc; ++g) dst[g * plane] = 0.0f;
      }
    }
  }
  const float* kern = psfs + (size_t)p * kh * kw * n_ch + c0;
  for (int k = threadIdx.x; k < gc * kh * tpitch; k += blockDim.x) {
    const int g = k / (kh * tpitch);
    const int ab = k - g * kh * tpitch;
    const int a = ab / tpitch;
    const int b = ab - a * tpitch;
    float* dst = smem + g * plane + span_y * pitch + ab;
    if (b < kw)
      __pipeline_memcpy_async(
          dst, kern + ((size_t)(kh - 1 - a) * kw + (kw - 1 - b)) * n_ch + g, 4);
    else
      *dst = 0.0f;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int g = threadIdx.x / PER_CH;
  const int tx = threadIdx.x % TX;
  const int ty = (threadIdx.x % PER_CH) / TX;
  float acc[RY][RX];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int j = 0; j < RX; ++j) acc[r][j] = 0.0f;
  if (g < gc) {
    const float* tile = smem + g * plane + ty * RY * pitch + tx * RX;
    const float* taps = smem + g * plane + span_y * pitch;
    for (int y = 0; y < RY + kh - 1; ++y)
      row_taps<KW>(tile + y * pitch, taps, y, kh, kw, tpitch, acc);
  }
  __syncthreads();

  // The tile's outputs, [y][x][channel], over the input tile's space; then
  // written a warp a row.
  if (g < gc) {
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int j = 0; j < RX; ++j)
        smem[((ty * RY + r) * TILE_X + tx * RX + j) * gc + g] = acc[r][j];
  }
  __syncthreads();
  const int nx = min(TILE_X, wp - x0);
  for (int y = warp; y < TILE_Y; y += n_warps) {
    const int oy = y0 + y;
    if (oy >= hp) break;
    float* dst = out + (((size_t)p * hp + oy) * wp + x0) * n_ch + c0;
    const float* s = smem + y * TILE_X * gc;
    if (gc == n_ch) {
      for (int e = lane; e < nx * gc; e += 32) dst[e] = s[e];
    } else {
      for (int e = lane; e < nx * gc; e += 32) {
        const int x = e / gc;
        dst[x * n_ch + e - x * gc] = s[e];
      }
    }
  }
}

// A block's shared memory: `group` channels of kh tap rows.
size_t block_bytes(int group, int kh, int kw) {
  return (size_t)group * plane_floats(kh, kw) * sizeof(float);
}

// One launch: a block takes up to GROUP channels of a 32 x 32 output tile.
template <int KW>
cudaError_t launch(const float* patches, const float* psfs, float* out, int n_patch, int n_ch,
                   int ph, int pw, int kh, int kw, cudaStream_t stream) {
  const int group = n_ch < GROUP ? n_ch : GROUP;
  const int n_groups = (n_ch + group - 1) / group;
  const int hp = ph - kh + 1;
  const int wp = pw - kw + 1;
  const dim3 grid((wp + TILE_X - 1) / TILE_X, (hp + TILE_Y - 1) / TILE_Y, n_patch * n_groups);
  const size_t smem = block_bytes(group, kh, kw);
  auto kernel = p2_svola_kernel<KW>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, PER_CH * group, smem, stream>>>(patches, psfs, out, n_ch, group, ph, pw, kh,
                                                 kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest PSF, in either axis, this kernel takes.
int p2_max_kw() { return MAX_K; }

// 1 where kw has an unrolled kernel, 0 where it takes the runtime-kw one.
int p2_specialized_kw(int kw) {
  for (int k : SPECIALIZED_KW)
    if (k == kw) return 1;
  return 0;
}

// Launches P2 on `stream` (one kernel launch) and returns cudaGetLastError()
// (0 on success). patches (n_patch, ph, pw, n_ch), psfs (n_patch, kh, kw,
// n_ch) and out (n_patch, ph - kh + 1, pw - kw + 1, n_ch), float32,
// contiguous; kh and kw up to MAX_K.
int p2_svola_launch(const float* patches, const float* psfs, float* out, int n_patch,
                    int n_ch, int ph, int pw, int kh, int kw, void* stream) {
  if (n_patch < 0 || n_ch < 1 || kh < 1 || kw < 1 || kh > MAX_K || kw > MAX_K || ph < kh ||
      pw < kw || (long long)n_patch * n_ch > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_patch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kw) {
    case 3:
      return (int)launch<3>(patches, psfs, out, n_patch, n_ch, ph, pw, kh, kw, s);
    case 5:
      return (int)launch<5>(patches, psfs, out, n_patch, n_ch, ph, pw, kh, kw, s);
    case 11:
      return (int)launch<11>(patches, psfs, out, n_patch, n_ch, ph, pw, kh, kw, s);
    case 23:
      return (int)launch<23>(patches, psfs, out, n_patch, n_ch, ph, pw, kh, kw, s);
    default:
      return (int)launch<0>(patches, psfs, out, n_patch, n_ch, ph, pw, kh, kw, s);
  }
}

}  // extern "C"
