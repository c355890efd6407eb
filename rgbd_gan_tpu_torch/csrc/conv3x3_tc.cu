// Fused 3x3 convolution + bias + leaky ReLU (K6), bfloat16 on Hopper's tensor
// cores (sm_90a): an implicit GEMM on `wgmma`, fed by TMA.
//
// Replaces the Pallas TPU kernel `_conv3x3_kernel` (via `conv3x3_bias_lrelu`)
// in rgbd_gan_tpu/ops/conv_pallas.py for bfloat16 operands; conv3x3.cu keeps
// the float32 instance (TF32 would change its numbers) and the shapes this
// kernel does not take (below).
//
// Semantics (those of `conv3x3_bias_lrelu`): x (B, H, W, Cin) NHWC, the
// weights as (9, Cout, Cin) (HWIO with the last two axes swapped, so that
// every tap is a K-major (Cout, Cin) matrix), bias (Cout,), all bfloat16 ->
// out (B, H, W, Cout) bfloat16. SAME padding, stride 1. Every bf16 product is
// exact in the tensor cores and summed in float32; the bias is added in
// float32, then out = acc >= 0 ? acc : slope * acc, rounded once to bf16.
//
// The GEMM: M = B*H*W output pixels, N = Cout, K = 9 taps x Cin. A block
// computes 128 pixels (a BH x BW rectangle of one image, BW = 2^bw_log2,
// BH = 128 / BW) by BN output channels (BN = 64 or 128). Its K loop walks
// over Cin in chunks of 64 channels and, inside each chunk, the nine taps:
//   - A for tap (dy, dx) and chunk c0 is a plain box of x, (64 channels,
//     BW columns, BH rows, 1 image) at (c0, w0+dx-1, h0+dy-1, b), loaded by
//     one TMA copy. TMA's out-of-bounds zero fill *is* the SAME padding, the
//     ragged right and bottom edge and the Cin tail: nothing is padded or
//     copied in device memory.
//   - B is the (64 Cin, BN Cout) box of that tap's weights, by TMA as well.
//   - Both land in shared memory with the 128-byte swizzle (a box row is 64
//     bf16 = 128 bytes), which the `wgmma` descriptors name.
// A ring of 3 stages behind full/empty `mbarrier`s; one producer warp
// issues the copies, two consumer warpgroups (64 pixels each) issue
// m64nBNk16 `wgmma`s with float32 accumulators in registers and release a
// stage once the products that read it are done. Two blocks (BN = 128) or
// three (BN = 64) share an SM, so that one block's first loads and its
// epilogue overlap the others' products. The epilogue adds the bias,
// applies the leaky ReLU, rounds once and stores bf16 pairs, masked to the
// image and to Cout.
//
// Bound: at the benchmark's shapes the work is 2*B*H*W*Cin*Cout*9 FLOP, at
// 989 TFLOP/s (dense bf16) 0.039-0.078 ms, against 134-268 MB of x, out and
// weights at 3.35 TB/s, 0.040-0.080 ms: both about equal. This design
// copies far more than that from L2: every tap reads its box of x again (9
// reads of x per output-channel tile) and every block its weights, 24-32 KB
// per stage for 1-2 MFLOP. That L2 binds it is an inference from these
// copy volumes, counted from the tiling, against the measured times
// (PERF.md); no counter has measured L2 traffic on the card.
//
// Requirements, checked by the caller (ops/conv.py routes other shapes to
// conv3x3.cu): Cin and Cout multiples of 8 and 16-byte-aligned pointers
// (TMA's global strides and addresses), contiguous tensors.
//
// Plain C interface (bound with ctypes). `cuTensorMapEncodeTiled` is a
// driver function: it is reached through the runtime's
// `cudaGetDriverEntryPoint`, so the library does not link libcuda. The entry
// point builds the two tensor maps, launches on the given stream and returns
// a CUDA error code (0 on success), or -1 when the driver has no
// `cuTensorMapEncodeTiled`, -2 / -3 when it refuses the map of x / of the
// weights.

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kBM = 128;                       // output pixels per block
constexpr int kBK = 64;                        // input channels per chunk: one 128-byte row
constexpr int kStages = 3;                     // ring depth
constexpr int kConsumers = 2;                  // warpgroups, 64 pixels each
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kATileBytes = kBM * kBK * 2;     // 16 KB

// Blocks that share an SM (3 x 73 KB or 2 x 97 KB of shared memory), so
// that one block's first loads and its epilogue overlap the others' products.
template <int BN>
struct Tiles {
  static constexpr int kBTileBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;  // a multiple of 1024
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
  static constexpr int kBlocksPerSM = BN == 64 ? 3 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed. A copy that
// never lands (a fault in a tensor map) traps after about 2^36 cycles
// (half a minute), so that the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 36)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `wgmma` shared-memory descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle: start address, stride 1024 bytes between groups of
// 8 rows (the leading offset is unused for this layout), swizzle mode 1.
// The tile starts on a 1024-byte boundary, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, registers) += A (64 x 16, smem) * B (16 x N, smem), both K-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads, Tiles<BN>::kBlocksPerSM)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                  const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H, int W,
                  int Cin, int Cout, int bw_log2, int w_tiles, int hw_tiles, int n_tiles, float slope) {
  using T = Tiles<BN>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the shared address: tiles start on 1024 bytes
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;

  // output-channel tile fastest, so that the blocks sharing a box of x run together
  int blk = blockIdx.x;
  const int nt = blk % n_tiles;
  blk /= n_tiles;
  const int pt = blk % hw_tiles;
  const int b = blk / hw_tiles;
  const int bw = 1 << bw_log2;
  const int h0 = (pt / w_tiles) * (kBM >> bw_log2);
  const int w0 = (pt % w_tiles) * bw;
  const int n0 = nt * BN;
  const int iters = 9 * ((Cin + kBK - 1) / kBK);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers * 128) {  // the producer warp: one thread issues every copy
    if (tid == kConsumers * 128) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        const int tap = it % 9;
        const int c0 = (it / 9) * kBK;
        uint8_t* a = smem + s * T::kStageBytes;
        mbar_arrive_expect_tx(&full[s], T::kStageBytes);
        tma_load_4d(a, &x_map, &full[s], c0, w0 + tap % 3 - 1, h0 + tap / 3 - 1, b);
        tma_load_3d(a + kATileBytes, &w_map, &full[s], c0, n0, tap);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64*wg .. 64*wg+63 of the block's 128 pixels
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* a = smem + s * T::kStageBytes;
    const uint64_t da = smem_desc(a + wg * 64 * 128);
    const uint64_t db = smem_desc(a + kATileBytes);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) Wgmma<BN>::mma(acc, da + 2 * k, db + 2 * k);  // +32 bytes per k step
    wgmma_commit();
    fence_operands(acc);
    // the products of the previous stage are done: hand it back to the producer
    wgmma_wait<1>();
    fence_operands(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // epilogue. Accumulator layout of m64nNk16: warp w holds rows 16w..16w+15;
  // acc[4j + 2h + e] is row 16w + lane/4 + 8h, column 8j + 2*(lane%4) + e.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = wg * 64 + warp * 16 + lane / 4 + 8 * hf;
    const int h = h0 + (m >> bw_log2);
    const int w = w0 + (m & (bw - 1));
    if (h >= H || w >= W) continue;
    __nv_bfloat16* dst = out + ((static_cast<int64_t>(b) * H + h) * W + w) * Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n < Cout) {  // Cout % 8 == 0: a pair is inside or outside as a whole
        float v0 = acc[4 * j + 2 * hf] + __bfloat162float(bias[n]);
        float v1 = acc[4 * j + 2 * hf + 1] + __bfloat162float(bias[n + 1]);
        v0 = v0 >= 0.f ? v0 : slope * v0;
        v1 = v1 >= 0.f ? v1 : slope * v1;
        *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle and zero fill outside the tensor.
// dims and box innermost first; strides in bytes of dims 1.. .
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* x, const void* wt, const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
           int bw_log2, float slope, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const int bw = 1 << bw_log2, bh = kBM >> bw_log2;
  CUtensorMap x_map, w_map;
  const cuuint64_t e = 2;  // bytes per element
  const cuuint64_t x_dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {Cin * e, (cuuint64_t)W * Cin * e, (cuuint64_t)H * W * Cin * e};
  const cuuint32_t x_box[4] = {kBK, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  if (!encode(fn, &x_map, x, 4, x_dims, x_strides, x_box)) return -2;
  const cuuint64_t w_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
  const cuuint64_t w_strides[2] = {Cin * e, (cuuint64_t)Cout * Cin * e};
  const cuuint32_t w_box[3] = {kBK, BN, 1};
  if (!encode(fn, &w_map, wt, 3, w_dims, w_strides, w_box)) return -3;

  const int w_tiles = (W + bw - 1) / bw;
  const int64_t hw_tiles = (int64_t)((H + bh - 1) / bh) * w_tiles;
  const int n_tiles = (Cout + BN - 1) / BN;
  const int64_t blocks = B * hw_tiles * n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_tc_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tiles<BN>::kSmemBytes);
  if (err == cudaSuccess)  // all of L1 as shared memory, so that kBlocksPerSM blocks fit
    err = cudaFuncSetAttribute(conv3x3_tc_kernel<BN>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  conv3x3_tc_kernel<BN><<<(unsigned)blocks, kThreads, Tiles<BN>::kSmemBytes, stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout,
      bw_log2, w_tiles, (int)hw_tiles, n_tiles, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), wt (9, Cout, Cin), bias (Cout,), out (B, H, W, Cout), all
// bfloat16 and contiguous; Cin % 8 == Cout % 8 == 0; x, wt and out 16-byte
// aligned. The block is BW = 2^bw_log2 columns (the least power of two >= W,
// at most 128) by 128 / BW rows of pixels, and BN = 64 output channels for
// Cout <= 64, else 128.
extern "C" int conv3x3_bias_lrelu_tc(const void* x, const void* wt, const void* bias, void* out, int B, int H,
                                     int W, int Cin, int Cout, float slope, cudaStream_t stream) {
  if ((int64_t)B * H * W * Cout == 0) return 0;
  if (Cin <= 0 || Cin % 8 || Cout % 8) return (int)cudaErrorInvalidValue;
  int bw_log2 = 0;
  while (bw_log2 < 7 && (1 << bw_log2) < W) ++bw_log2;
  if (Cout <= 64) return launch<64>(x, wt, bias, out, B, H, W, Cin, Cout, bw_log2, slope, stream);
  return launch<128>(x, wt, bias, out, B, H, W, Cin, Cout, bw_log2, slope, stream);
}
