// Fused 3x3 convolution + bias + leaky ReLU (K6) on the FMA units, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_conv3x3_kernel` (via `conv3x3_bias_lrelu`)
// in rgbd_gan_tpu/ops/conv_pallas.py. That kernel takes nine statically
// shifted (TILE_H*W, Cin) x (Cin, Cout) MXU products per block of 8 output
// rows, from three row-shifted padded copies of the input that its caller
// materialises because Pallas block windows cannot overlap. Here a block
// reads its input halo straight from x and treats rows and columns outside
// the image as zero, so nothing is copied or padded in device memory.
// This file takes float32 (TF32 would change its numbers) and the bfloat16
// calls the tensor-core kernel (conv3x3_tc.cu) cannot address.
//
// Semantics (those of `conv3x3_bias_lrelu`): x (B, H, W, Cin) NHWC, kernel
// (3, 3, Cin, Cout) HWIO, bias (Cout,), all float32 or all bfloat16 ->
// out (B, H, W, Cout) in the same type. SAME padding, stride 1. The nine
// taps are summed in float32 (a bf16 operand is widened first, so each
// product is exact), the bias is added in float32, then
// out = acc >= 0 ? acc : slope * acc, cast once to the output type.
//
// Bound: operations. 2*B*H*W*Cin*Cout*9 FLOP against one read of x and one
// write of out: at the benchmark's shapes (Cin, Cout >= 64) that is over 100
// FLOP per byte, beyond the f32 ridge of the card (67 TFLOP/s over 3.35 TB/s,
// 20 FLOP/byte). So the FMA pipe has to be kept busy: few instruction slots
// spent on shared-memory loads, no wait for the next chunk of operands, and
// enough registers that the compiler can load ahead.
//
// Design: an implicit GEMM, M = output pixels, N = Cout, K = 9 taps x Cin.
// A block takes 128 output pixels (8 rows x 16 columns) and BN = 128 output
// channels (64 where Cout <= 64), with 2 * BN threads; each thread holds an
// 8 x 8 tile of f32 accumulators: 8 neighbouring columns of one row, and
// channels 4t..4t+3 and BN/2+4t..BN/2+4t+3. Per tap and 4 input channels a
// thread reads 8 float4 of the halo (one per pixel: 4 channels) and 8 float4
// of weights (2 per channel) and does 256 FMAs, 16 FMAs per shared load.
// Shared memory holds, per chunk of 8 input channels, the (8+2) x (16+2)
// halo as [row][col][channel] and the 3 x 3 x 8 x BN weights as
// [tap][channel][co]: the per-k reads are broadcast (the halo) or 8
// neighbouring float4 per quarter warp (the weights), free of bank
// conflicts. A ring of two stages with one barrier a chunk: while a chunk is
// multiplied, the next one is on its way with cp.async (16-byte copies where
// Cin, Cout % 4 == 0 and the operand is 16-byte aligned, else 4-byte
// copies), the zero fill outside the image and past Cin or Cout given by a
// source size of 0. 42.6 KB a stage at BN = 128. The registers are not
// capped (one 256-thread block an SM, up to 255 registers): held to 128 for
// two blocks an SM, the 8 x 8 tile spills, and held to 168 for three
// 128-thread blocks the compiler cannot load far enough ahead; both ran
// slower on the card. The chunk's 9 taps are unrolled into one body of
// about 90 KB of code; a body twice that size ran far slower (instruction
// cache).
// bfloat16 operands are widened to float32 on their way to shared memory,
// with plain loads (cp.async copies bytes and cannot widen). Ragged edges
// (W, Cout not multiples of the tile, Cin not a multiple of the chunk, any
// H) are zero-filled on load and masked on store; offsets into x, kernel
// and out are 64-bit.
//
// Plain C interface (bound with ctypes). The entry point launches on the
// given stream and returns a CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileH = 8;   // output rows per block (TILE_H of the Pallas kernel)
constexpr int kTileW = 16;  // output columns per block
constexpr int kChunk = 8;   // input channels per stage
constexpr int kPx = 8;      // output pixels per thread: neighbouring columns of one row
constexpr int kCo = 8;      // output channels per thread: two groups of 4, BN/2 apart
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloFloats = kHaloH * kHaloW * kChunk;  // [row][col][c]
constexpr int kStages = 2;
static_assert(kTileW == 2 * kPx, "a row of the tile is two threads' columns");
static_assert(kHaloFloats % 4 == 0, "the weights must start 16-byte aligned");

template <int BN>
struct Tile {
  static constexpr int kThreadsN = BN / kCo;                           // threads along Cout
  static constexpr int kThreads = (kTileH * kTileW / kPx) * kThreadsN;  // 256 or 128
  static constexpr int kWFloats = 9 * kChunk * BN;                     // [tap][c][co]
  static constexpr int kStageFloats = kHaloFloats + kWFloats;
  static constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(float* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Block {
  int64_t b;
  int h0, w0, co0;
};

// Stage input channels c0 .. c0+kChunk-1: the halo and this channel tile's
// weights, zero outside the image and past Cin or Cout. float32 goes by
// cp.async (vec: 16-byte copies), bfloat16 by plain loads, widened.
template <typename T, int BN>
__device__ __forceinline__ void load_stage(float* stage, const T* __restrict__ x, const T* __restrict__ k,
                                           const Block& blk, int H, int W, int Cin, int Cout, int c0,
                                           bool halo_vec, bool w_vec) {
  constexpr int kThreads = Tile<BN>::kThreads;
  float* in_s = stage;
  float* w_s = stage + kHaloFloats;
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    if (halo_vec) {  // kChunk / 4 16-byte copies a halo pixel
      for (int e = tid; e < kHaloFloats / 4; e += kThreads) {
        const int p = e / (kChunk / 4), ci = c0 + 4 * (e % (kChunk / 4));
        const int row = p / kHaloW, col = p - row * kHaloW;
        const int hh = blk.h0 - 1 + row, ww = blk.w0 - 1 + col;
        const bool inside = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin;
        const float* src = inside ? x + ((blk.b * H + hh) * W + ww) * Cin + ci : x;
        cp_async16(in_s + 4 * e, src, inside ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kHaloFloats; e += kThreads) {
        const int p = e / kChunk, ci = c0 + e % kChunk;
        const int row = p / kHaloW, col = p - row * kHaloW;
        const int hh = blk.h0 - 1 + row, ww = blk.w0 - 1 + col;
        const bool inside = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin;
        const float* src = inside ? x + ((blk.b * H + hh) * W + ww) * Cin + ci : x;
        cp_async4(in_s + e, src, inside ? 4 : 0);
      }
    }
    if (w_vec) {  // BN/4 16-byte copies a (tap, channel) row
      for (int e = tid; e < Tile<BN>::kWFloats / 4; e += kThreads) {
        const int v = e % (BN / 4), t = e / (BN / 4);
        const int ci = c0 + t % kChunk, tap = t / kChunk, cc = blk.co0 + 4 * v;
        const bool inside = ci < Cin && cc < Cout;
        const float* src = inside ? k + ((int64_t)tap * Cin + ci) * Cout + cc : k;
        cp_async16(w_s + 4 * e, src, inside ? 16 : 0);
      }
    } else {
      for (int e = tid; e < Tile<BN>::kWFloats; e += kThreads) {
        const int co = e % BN, t = e / BN;
        const int ci = c0 + t % kChunk, tap = t / kChunk, cc = blk.co0 + co;
        const bool inside = ci < Cin && cc < Cout;
        const float* src = inside ? k + ((int64_t)tap * Cin + ci) * Cout + cc : k;
        cp_async4(w_s + e, src, inside ? 4 : 0);
      }
    }
  } else {
    for (int e = tid; e < kHaloFloats; e += kThreads) {
      const int p = e / kChunk, ci = c0 + e % kChunk;
      const int row = p / kHaloW, col = p - row * kHaloW;
      const int hh = blk.h0 - 1 + row, ww = blk.w0 - 1 + col;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin) v = widen(x[((blk.b * H + hh) * W + ww) * Cin + ci]);
      in_s[e] = v;
    }
    for (int e = tid; e < Tile<BN>::kWFloats; e += kThreads) {
      const int co = e % BN, t = e / BN;
      const int ci = c0 + t % kChunk, tap = t / kChunk, cc = blk.co0 + co;
      float v = 0.f;
      if (ci < Cin && cc < Cout) v = widen(k[((int64_t)tap * Cin + ci) * Cout + cc]);
      w_s[e] = v;
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<const unsigned*>(&lo);
  packed.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <typename T, int BN>
__global__ void __launch_bounds__(Tile<BN>::kThreads, 1)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ bias, T* __restrict__ out,
               int H, int W, int Cin, int Cout, int w_tiles, float slope, int halo_vec, int w_vec) {
  using Cfg = Tile<BN>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int tn = tid % Cfg::kThreadsN;  // channels co0 + 4*tn .. +3 and co0 + BN/2 + 4*tn .. +3
  const int tm = tid / Cfg::kThreadsN;  // 0..15
  const int r = tm >> 1;                // output row in the tile
  const int cg = tm & 1;                // columns kPx*cg .. kPx*cg + kPx-1
  Block blk;
  blk.b = blockIdx.z;
  blk.h0 = blockIdx.y * kTileH;
  blk.w0 = (blockIdx.x % w_tiles) * kTileW;
  blk.co0 = (blockIdx.x / w_tiles) * BN;

  float acc[kPx][kCo];
#pragma unroll
  for (int j = 0; j < kPx; ++j)
#pragma unroll
    for (int q = 0; q < kCo; ++q) acc[j][q] = 0.f;

  // A ring of kStages chunks: chunk i lands in stage i % kStages. One
  // barrier a chunk: after it, chunk i is in shared memory for every thread,
  // and every thread is done with chunk i-1, whose stage the copies of chunk
  // i + kStages - 1 then fill while chunk i is multiplied. Every thread
  // commits one group a chunk, empty or not, so that the wait counts match.
  const int chunks = (Cin + kChunk - 1) / kChunk;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < chunks)
      load_stage<T, BN>(smem + i * Cfg::kStageFloats, x, k, blk, H, W, Cin, Cout, i * kChunk, halo_vec, w_vec);
    cp_async_commit();
  }
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < chunks)
      load_stage<T, BN>(smem + (next % kStages) * Cfg::kStageFloats, x, k, blk, H, W, Cin, Cout, next * kChunk,
                        halo_vec, w_vec);
    cp_async_commit();
    const float* in_s = smem + (i % kStages) * Cfg::kStageFloats;
    const float* w_s = in_s + kHaloFloats;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* a_src = in_s + ((r + dy) * kHaloW + cg * kPx + dx) * kChunk;
#pragma unroll
      for (int c4 = 0; c4 < kChunk; c4 += 4) {
        float4 a[kPx];  // pixel j's input channels c4 .. c4+3
#pragma unroll
        for (int j = 0; j < kPx; ++j) a[j] = *reinterpret_cast<const float4*>(a_src + j * kChunk + c4);
        const float* w_row = w_s + (tap * kChunk + c4) * BN + 4 * tn;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 b0 = *reinterpret_cast<const float4*>(w_row + c * BN);
          const float4 b1 = *reinterpret_cast<const float4*>(w_row + c * BN + BN / 2);
#pragma unroll
          for (int j = 0; j < kPx; ++j) {
            const float av = lane(a[j], c);
            acc[j][0] = fmaf(av, b0.x, acc[j][0]);
            acc[j][1] = fmaf(av, b0.y, acc[j][1]);
            acc[j][2] = fmaf(av, b0.z, acc[j][2]);
            acc[j][3] = fmaf(av, b0.w, acc[j][3]);
            acc[j][4] = fmaf(av, b1.x, acc[j][4]);
            acc[j][5] = fmaf(av, b1.y, acc[j][5]);
            acc[j][6] = fmaf(av, b1.z, acc[j][6]);
            acc[j][7] = fmaf(av, b1.w, acc[j][7]);
          }
        }
      }
    }
  }

  // epilogue: + bias in f32, leaky ReLU, one cast, masked store
  const int hh = blk.h0 + r;
  if (hh >= H) return;
  const bool vec_out = Cout % 4 == 0;  // out is a fresh allocation, so 4 channels are 16/8-byte aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int cc0 = blk.co0 + half * (BN / 2) + 4 * tn;
    float bq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bq[q] = cc0 + q < Cout ? widen(bias[cc0 + q]) : 0.f;
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int ww = blk.w0 + cg * kPx + j;
      if (ww >= W) break;
      T* dst = out + ((blk.b * H + hh) * W + ww) * Cout + cc0;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s = acc[j][half * 4 + q] + bq[q];
        v[q] = s >= 0.f ? s : slope * s;
      }
      if (vec_out && cc0 + 3 < Cout) {
        store4<T>(dst, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (cc0 + q < Cout) dst[q] = narrow<T>(v[q]);
      }
    }
  }
}

template <typename T, int BN>
int launch(const void* x, const void* k, const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
           float slope, cudaStream_t stream) {
  using Cfg = Tile<BN>;
  const int w_tiles = (W + kTileW - 1) / kTileW;
  const int64_t blocks_x = (int64_t)w_tiles * ((Cout + BN - 1) / BN);
  const int h_tiles = (H + kTileH - 1) / kTileH;
  if (blocks_x > 0x7fffffff || h_tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need every 4-channel group of a pixel (weight row) to start 16-byte aligned
  const bool halo_vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const dim3 grid((unsigned)blocks_x, h_tiles, B);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(bias), static_cast<T*>(out), H, W,
      Cin, Cout, w_tiles, slope, halo_vec, w_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tiled(const void* x, const void* k, const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
                 float slope, cudaStream_t stream) {
  return Cout <= 64 ? launch<T, 64>(x, k, bias, out, B, H, W, Cin, Cout, slope, stream)
                    : launch<T, 128>(x, k, bias, out, B, H, W, Cin, Cout, slope, stream);
}

}  // namespace

// x, kernel, bias and out all float32 (bf16 == 0) or all bfloat16 (bf16 == 1),
// contiguous, in the layouts above; out 16-byte aligned.
extern "C" int conv3x3_bias_lrelu(const void* x, const void* kernel, const void* bias, void* out, int B,
                                  int H, int W, int Cin, int Cout, int bf16, float slope,
                                  cudaStream_t stream) {
  if ((int64_t)B * H * W * Cout == 0) return 0;
  if (Cin <= 0) return (int)cudaErrorInvalidValue;
  return bf16 ? launch_tiled<__nv_bfloat16>(x, kernel, bias, out, B, H, W, Cin, Cout, slope, stream)
              : launch_tiled<float>(x, kernel, bias, out, B, H, W, Cin, Cout, slope, stream);
}
