// Fused 3x3 convolution + bias + leaky ReLU (K6), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_conv3x3_kernel` (via `conv3x3_bias_lrelu`)
// in rgbd_gan_tpu/ops/conv_pallas.py. That kernel takes nine statically
// shifted (TILE_H*W, Cin) x (Cin, Cout) MXU products per block of 8 output
// rows, from three row-shifted padded copies of the input that its caller
// materialises because Pallas block windows cannot overlap. Here a block
// reads its input halo straight from x and treats rows and columns outside
// the image as zero, so nothing is copied or padded in device memory.
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
// 20 FLOP/byte). This kernel runs on the FMA units in f32; bf16 changes only
// the loads and stores (the tensor cores are a later kernel's work).
//
// Design: an implicit GEMM with the reduction (Cin x 9 taps) in chunks.
// One block per (b, 8 output rows, 16 output columns, 64 output channels),
// 256 threads. Per chunk of 16 input channels the block stages the
// (8+2) x (16+2) x 16 input halo and the 3 x 3 x 16 x 64 weights in shared
// memory as float32. Each thread owns 8 neighbouring columns of one row and
// 4 neighbouring channels (32 f32 accumulators): per (channel, kernel row)
// it reads 10 halo values once and reuses them for the three kernel columns,
// with one 16-byte weight read per kernel column, 96 FMAs for 13 shared
// loads. Ragged edges (W or Cout not a multiple of the tile, Cin not a
// multiple of the chunk) are zero-filled on load and masked on store;
// offsets into x and out are 64-bit.
//
// Plain C interface (bound with ctypes). The entry point launches on the
// given stream and returns a CUDA error code (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;          // output rows per block (TILE_H of the Pallas kernel)
constexpr int kTileW = 16;         // output columns per block
constexpr int kTileCo = 64;        // output channels per block
constexpr int kChunk = 16;         // input channels staged per pass
constexpr int kCols = 8;           // columns per thread
constexpr int kCo = 4;             // output channels per thread
constexpr int kCoThreads = kTileCo / kCo;                              // 16
constexpr int kThreads = kCoThreads * kTileH * (kTileW / kCols);       // 256
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kInFloats = kChunk * kHaloH * kHaloW;                    // [c][row][col]
constexpr int kWFloats = 9 * kChunk * kTileCo;                         // [tap][c][co]
constexpr int kSmemBytes = (kInFloats + kWFloats) * (int)sizeof(float);
static_assert(kInFloats % 4 == 0, "the weights must start 16-byte aligned");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ bias,
               T* __restrict__ out, int H, int W, int Cin, int Cout, int w_tiles, float slope) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);  // [kChunk][kHaloH][kHaloW]
  float* w_s = in_s + kInFloats;                  // [9][kChunk][kTileCo]

  const int tid = threadIdx.x;
  const int tx = tid % kCoThreads;       // output channels co0 + 4*tx .. +3
  const int ty = tid / kCoThreads;       // 0..15
  const int r = ty / (kTileW / kCols);   // output row in the tile
  const int cg = ty % (kTileW / kCols);  // column group: columns 8*cg .. 8*cg+7

  const int wt = blockIdx.x % w_tiles;
  const int co0 = (blockIdx.x / w_tiles) * kTileCo;
  const int h0 = blockIdx.y * kTileH;
  const int w0 = wt * kTileW;
  const int64_t b = blockIdx.z;

  float acc[kCols][kCo];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int q = 0; q < kCo; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    __syncthreads();  // the previous chunk has been read
    // the input halo, channel fastest so that neighbouring threads read
    // neighbouring addresses; outside the image (SAME padding) or past Cin: 0
    for (int e = tid; e < kInFloats; e += kThreads) {
      const int c = e % kChunk;
      const int p = e / kChunk;
      const int col = p % kHaloW;
      const int row = p / kHaloW;
      const int hh = h0 - 1 + row, ww = w0 - 1 + col, ci = c0 + c;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin)
        v = widen(x[((b * H + hh) * W + ww) * Cin + ci]);
      in_s[(c * kHaloH + row) * kHaloW + col] = v;
    }
    // the weights of this chunk and channel tile; past Cin or Cout: 0
    for (int e = tid; e < kWFloats; e += kThreads) {
      const int co = e % kTileCo;
      const int t = e / kTileCo;
      const int c = t % kChunk;
      const int tap = t / kChunk;
      const int ci = c0 + c, cc = co0 + co;
      float v = 0.f;
      if (ci < Cin && cc < Cout) v = widen(k[((int64_t)tap * Cin + ci) * Cout + cc]);
      w_s[e] = v;
    }
    __syncthreads();

    const int cn = min(kChunk, Cin - c0);
    for (int c = 0; c < cn; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* src = in_s + (c * kHaloH + r + dy) * kHaloW + cg * kCols;
        float a[kCols + 2];
#pragma unroll
        for (int j = 0; j < kCols + 2; ++j) a[j] = src[j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(w_s + ((dy * 3 + dx) * kChunk + c) * kTileCo + kCo * tx);
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc[j][0] = fmaf(a[j + dx], wv.x, acc[j][0]);
            acc[j][1] = fmaf(a[j + dx], wv.y, acc[j][1]);
            acc[j][2] = fmaf(a[j + dx], wv.z, acc[j][2]);
            acc[j][3] = fmaf(a[j + dx], wv.w, acc[j][3]);
          }
        }
      }
    }
  }

  // epilogue: + bias in f32, leaky ReLU, one cast, masked store
  const int hh = h0 + r;
  if (hh >= H) return;
  float bq[kCo];
#pragma unroll
  for (int q = 0; q < kCo; ++q) {
    const int cc = co0 + kCo * tx + q;
    bq[q] = cc < Cout ? widen(bias[cc]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int ww = w0 + cg * kCols + j;
    if (ww >= W) break;
    T* dst = out + ((b * H + hh) * W + ww) * Cout;
#pragma unroll
    for (int q = 0; q < kCo; ++q) {
      const int cc = co0 + kCo * tx + q;
      if (cc < Cout) {
        const float v = acc[j][q] + bq[q];
        dst[cc] = narrow<T>(v >= 0.f ? v : slope * v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* k, const void* bias, void* out, int B, int H, int W, int Cin,
           int Cout, float slope, cudaStream_t stream) {
  const int w_tiles = (W + kTileW - 1) / kTileW;
  const int64_t blocks_x = (int64_t)w_tiles * ((Cout + kTileCo - 1) / kTileCo);
  const int h_tiles = (H + kTileH - 1) / kTileH;
  if (blocks_x > 0x7fffffff || h_tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_x, h_tiles, B);
  conv3x3_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(bias), static_cast<T*>(out),
      H, W, Cin, Cout, w_tiles, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// x, kernel, bias and out all float32 (bf16 == 0) or all bfloat16 (bf16 == 1),
// contiguous, in the layouts above.
extern "C" int conv3x3_bias_lrelu(const void* x, const void* kernel, const void* bias, void* out, int B,
                                  int H, int W, int Cin, int Cout, int bf16, float slope,
                                  cudaStream_t stream) {
  if ((int64_t)B * H * W * Cout == 0) return 0;
  if (Cin <= 0) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(x, kernel, bias, out, B, H, W, Cin, Cout, slope, stream)
              : launch<float>(x, kernel, bias, out, B, H, W, Cin, Cout, slope, stream);
}
