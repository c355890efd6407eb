// Trilinear frustum lift of the DeepVoxels generator, forward (K3), backward
// (K4) and their windowed pair (K5), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_lift_fwd_kernel`, `_lift_bwd_kernel`,
// `_lift_fwd_kernel_win` and `_lift_bwd_kernel_win` in
// rgbd_gan_tpu/ops/trilinear_pallas.py. Those keep the 32^3 grid resident in
// fast memory and contract weighted one-hot matrices on the MXU, because a
// TPU gathers badly. On this card a gather is a load, so the kernels here
// read the eight corners of each frustum cell directly.
//
// Semantics (those of `trilinear_lift_pallas` and `_trilinear_dv_pallas`):
//   voxel (B, G, G, G, C) f32, coords (B, 3, N) f32, mask (B, N) bytes
//   -> out (B, N, C) f32;  gbar (B, N, C) -> dV (B, G, G, G, C) f32.
//   coords row 2 indexes grid dim0, row 1 dim1, row 0 dim2. Per axis
//   i0 = clamp(int(idx), 0, G-1), i1 = min(i0+1, G-1), frac = idx - i0; where
//   i1 == i0 the two weights are added into one. A cell whose mask is 0
//   writes C zeros (adds nothing to dV) and reads neither the grid nor the
//   cotangent: its coordinates may hold any value, so the mask is tested
//   before any index is made from them. No gradient goes to the coordinates.
//
//   bf16 mode (operands bf16, f32 accumulation) rounds where the Pallas
//   kernels round: the grid values, the fused (dim0, dim1) weight, the dim2
//   weight, the (dim0, dim1)-collapsed partial sum, and its product with the
//   dim2 weight; in the backward the cotangent and its product with the dim2
//   weight. All sums are f32.
//
//   Windowed mode: per tile of 1024 consecutive cells (depth-major order),
//   s = clamp(min over the tile's valid cells of the dim1 index i0, 0, G-w),
//   and every corner whose dim1 index lies outside [s, s+w) is dropped. A
//   tile without a valid cell gives zeros. Equal to the full kernels when
//   each tile's valid cells span at most w dim1-planes.
//
// Bound: memory traffic, by the bytes the functions must move. At the
// training shapes (B=10, G=32, C=32, N=229,376) the forward writes 294 MB and reads 42 MB of grid and 37 MB of
// coordinates and mask; the backward reads the valid cells' 161 MB of
// cotangent rows and their coordinates and writes the 42 MB dV. The window
// saves no work here: a corner outside it is simply not read. One block per
// tile of 1024 cells. The 4 MB grid of a batch item stays in L2.
//
// Forward, C % 4 == 0 (`lift_fwd_vec4_kernel`, C = 32 on every path): a cell
// is taken by 2^q threads (8 for C = 32), each with 4 neighbouring channels,
// so the mask test, the coordinate loads, the three axis terms and the bf16
// roundings are done 8 times per cell instead of 32, with no integer
// division. Each corner is one float4 load per thread (a 128-byte corner row
// per cell), the output one float4 store. Each thread walks over
// neighbouring cells, which are neighbouring pixels at one depth and share
// most corners, so the caches absorb much of the 8 x 128 bytes a cell
// gathers.
//
// Backward, C % 4 == 0 (`lift_bwd_vec4_kernel`): the scalar kernel issues
// one f32 atomic per (valid cell, channel, corner), about 321 M a call at
// the training shapes. Here the thread layout and the walk are the
// forward's: 2^q threads a cell, 4 channels each, the cell terms computed
// once per 4 channels, the cotangent read as one float4, and a masked cell
// reads neither its coordinates nor its cotangent. Each thread keeps the 8
// corner sums of its run of neighbouring cells in registers (Run) while the
// next valid cell has the same corner base (the dim0, dim1, dim2 index i0;
// the i1 follow from it), and reduces them into dV when the base changes
// and at the end of the run: neighbouring pixels at one depth often fall
// into one voxel (`chip_smoke.py` prints the cells a run on the training
// frustum). A reduction is
// one `red.global.add.v4.f32` of 4 floats per thread (sm_90, global memory
// only), so a corner row costs 8 vector reductions for C = 32 instead of 32
// scalar atomics. A corner no cell gave a nonzero weight is not reduced, as
// the scalar kernel skips it. What binds it then is the latency of each
// thread's walk over its 32 cells more than the reductions (on the card, a
// version without them was not much faster): the run's mask bits are read
// up front by its 2^q threads together, so that no load waits for a mask
// byte, the walk is unrolled by 2 so that the next cell's loads are in
// flight, and the registers are held to 85 for 3 blocks (24 warps) an SM.
// Rounding points are the Pallas kernels' (the cotangent, its product with
// the dim2 weight, and the product of that with the fused weight, each
// rounded before any sum); only the order of the f32 sums differs, and with
// atomics it differs from run to run.
// Forward and backward for other C (`lift_fwd_kernel`, `lift_bwd_kernel`,
// the generic route): a thread takes one (cell, channel) pair at a time, so
// for C = 32 a warp is one cell, each corner is one coalesced 128-byte read
// (or one line of scalar atomics), and the output row one coalesced write.
// The backward accumulates with atomics into a zeroed buffer, so its
// summation order changes from run to run.
//
// Plain C interface (bound with ctypes). Each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // cells per tile, as TILE_N of the Pallas kernels

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

struct Axis {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Axis axis_terms(float idx, int G) {
  Axis a;
  a.i0 = min(max((int)idx, 0), G - 1);  // the cast truncates toward zero
  a.i1 = min(a.i0 + 1, G - 1);
  const float f = idx - (float)a.i0;
  a.w0 = 1.f - f;
  a.w1 = f;
  if (a.i1 == a.i0) {  // last plane: one corner with both weights
    a.w0 = a.w0 + a.w1;
    a.w1 = 0.f;
  }
  return a;
}

// Start of the tile's dim1 window, or -1 when the tile has no valid cell.
// Every thread of the block must call it.
__device__ __forceinline__ int window_start(const float* __restrict__ cy,
                                            const uint8_t* __restrict__ m,
                                            int ncell, int G, int window) {
  __shared__ int s_min;
  if (threadIdx.x == 0) s_min = G;
  __syncthreads();
  int local = G;  // sentinel for masked cells
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    if (m[i]) local = min(local, min(max((int)cy[i], 0), G - 1));
  }
  for (int o = 16; o > 0; o >>= 1)
    local = min(local, __shfl_xor_sync(0xffffffffu, local, o));
  if ((threadIdx.x & 31) == 0) atomicMin(&s_min, local);
  __syncthreads();
  const int s = s_min;
  if (s >= G) return -1;
  return min(max(s, 0), G - window);
}

struct Cell {
  Axis x, y, z;        // grid dim0, dim1, dim2
  float a[2][2];       // fused (dim0, dim1) weights, rounded
  float wz[2];         // dim2 weights, rounded
};

template <bool BF16, bool WIN>
__device__ __forceinline__ Cell cell_terms(float cx, float cy, float cz, int G,
                                           int s, int window) {
  Cell c;
  c.x = axis_terms(cx, G);
  c.y = axis_terms(cy, G);
  c.z = axis_terms(cz, G);
  if (WIN) {  // i0 >= s always holds for a valid cell
    if (c.y.i0 >= s + window) c.y.w0 = 0.f;
    if (c.y.i1 >= s + window) c.y.w1 = 0.f;
  }
  c.a[0][0] = rnd<BF16>(c.x.w0 * c.y.w0);
  c.a[0][1] = rnd<BF16>(c.x.w0 * c.y.w1);
  c.a[1][0] = rnd<BF16>(c.x.w1 * c.y.w0);
  c.a[1][1] = rnd<BF16>(c.x.w1 * c.y.w1);
  c.wz[0] = rnd<BF16>(c.z.w0);
  c.wz[1] = rnd<BF16>(c.z.w1);
  return c;
}

// ---------------------------------------------------------------- K3, K5

template <bool BF16, bool WIN>
__global__ void lift_fwd_kernel(const float* __restrict__ voxel,
                                const float* __restrict__ coords,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out, int G, int C, int N,
                                int window) {
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * kTile;
  const int ncell = min(kTile, N - cell0);
  const float* cz = coords + ((int64_t)b * 3 + 0) * N + cell0;  // grid dim2
  const float* cy = coords + ((int64_t)b * 3 + 1) * N + cell0;  // grid dim1
  const float* cx = coords + ((int64_t)b * 3 + 2) * N + cell0;  // grid dim0
  const uint8_t* m = mask + (int64_t)b * N + cell0;
  float* o = out + ((int64_t)b * N + cell0) * C;
  const float* vb = voxel + (int64_t)b * G * G * G * C;
  const int total = ncell * C;

  int s = 0;
  if (WIN) {
    s = window_start(cy, m, ncell, G, window);
    if (s < 0) {
      for (int e = threadIdx.x; e < total; e += blockDim.x) o[e] = 0.f;
      return;
    }
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int cell = e / C;
    const int ch = e - cell * C;
    float acc = 0.f;
    if (m[cell]) {
      const Cell c = cell_terms<BF16, WIN>(cx[cell], cy[cell], cz[cell], G, s, window);
      const float* v = vb + ch;
      const int64_t r00 = ((int64_t)c.x.i0 * G + c.y.i0) * G;
      const int64_t r01 = ((int64_t)c.x.i0 * G + c.y.i1) * G;
      const int64_t r10 = ((int64_t)c.x.i1 * G + c.y.i0) * G;
      const int64_t r11 = ((int64_t)c.x.i1 * G + c.y.i1) * G;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int zi = d == 0 ? c.z.i0 : c.z.i1;
        float t = c.a[0][0] * rnd<BF16>(v[(r00 + zi) * C]);
        t += c.a[0][1] * rnd<BF16>(v[(r01 + zi) * C]);
        t += c.a[1][0] * rnd<BF16>(v[(r10 + zi) * C]);
        t += c.a[1][1] * rnd<BF16>(v[(r11 + zi) * C]);
        acc += rnd<BF16>(rnd<BF16>(t) * c.wz[d]);
      }
    }
    o[e] = acc;
  }
}

// One channel of a cell: the (dim0, dim1)-collapsed sum of the four corners
// of a dim2 plane, rounded where the Pallas kernels round.
template <bool BF16>
__device__ __forceinline__ float plane_sum(const Cell& c, float v00, float v01, float v10, float v11) {
  float t = c.a[0][0] * rnd<BF16>(v00);
  t += c.a[0][1] * rnd<BF16>(v01);
  t += c.a[1][0] * rnd<BF16>(v10);
  t += c.a[1][1] * rnd<BF16>(v11);
  return rnd<BF16>(t);
}

template <bool BF16>
__device__ __forceinline__ float channel(const Cell& c, float p00, float p01, float p10, float p11, float q00,
                                         float q01, float q10, float q11) {
  float acc = 0.f;
  acc += rnd<BF16>(plane_sum<BF16>(c, p00, p01, p10, p11) * c.wz[0]);
  acc += rnd<BF16>(plane_sum<BF16>(c, q00, q01, q10, q11) * c.wz[1]);
  return acc;
}

// K3 / K5 forward for C % 4 == 0: 2^q_log2 threads per cell, 4 channels a
// thread (channel groups g = sub, sub + 2^q_log2, ... < C/4). The cells a
// block takes together in one pass lie `passes` apart (32 for C = 32), so
// that each thread walks over neighbouring cells from one pass to the next.
// The order moves only the gathers' reuse in the caches, not the result:
// against neighbouring cells in one pass it measured 12 % faster in f32 and
// even in bf16 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
template <bool BF16, bool WIN>
__global__ void __launch_bounds__(kThreads)
lift_fwd_vec4_kernel(const float* __restrict__ voxel, const float* __restrict__ coords,
                     const uint8_t* __restrict__ mask, float* __restrict__ out, int G, int C, int N,
                     int window, int q_log2) {
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * kTile;
  const int ncell = min(kTile, N - cell0);
  const float* cz = coords + ((int64_t)b * 3 + 0) * N + cell0;  // grid dim2
  const float* cy = coords + ((int64_t)b * 3 + 1) * N + cell0;  // grid dim1
  const float* cx = coords + ((int64_t)b * 3 + 2) * N + cell0;  // grid dim0
  const uint8_t* m = mask + (int64_t)b * N + cell0;
  const int c4 = C >> 2;
  float4* o = reinterpret_cast<float4*>(out + ((int64_t)b * N + cell0) * C);
  const float4* vb = reinterpret_cast<const float4*>(voxel + (int64_t)b * G * G * G * C);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  int s = 0;
  if (WIN) {
    s = window_start(cy, m, ncell, G, window);
    if (s < 0) {
      for (int e = threadIdx.x; e < ncell * c4; e += kThreads) o[e] = zero;
      return;
    }
  }
  const int q = 1 << q_log2;
  const int sub = threadIdx.x & (q - 1);
  const int slot = threadIdx.x >> q_log2;
  const int passes = (kTile / kThreads) << q_log2;  // a pass takes kThreads >> q_log2 cells
  for (int p = 0; p < passes; ++p) {
    const int cell = slot * passes + p;
    if (cell >= ncell) continue;
    float4* dst = o + (int64_t)cell * c4;
    if (!m[cell]) {  // reads no coordinate
      for (int g = sub; g < c4; g += q) dst[g] = zero;
      continue;
    }
    const Cell c = cell_terms<BF16, WIN>(cx[cell], cy[cell], cz[cell], G, s, window);
    const int64_t r00 = ((int64_t)c.x.i0 * G + c.y.i0) * G;
    const int64_t r01 = ((int64_t)c.x.i0 * G + c.y.i1) * G;
    const int64_t r10 = ((int64_t)c.x.i1 * G + c.y.i0) * G;
    const int64_t r11 = ((int64_t)c.x.i1 * G + c.y.i1) * G;
    for (int g = sub; g < c4; g += q) {
      // all eight corners in flight before any arithmetic
      const float4 p00 = vb[(r00 + c.z.i0) * c4 + g], p01 = vb[(r01 + c.z.i0) * c4 + g];
      const float4 p10 = vb[(r10 + c.z.i0) * c4 + g], p11 = vb[(r11 + c.z.i0) * c4 + g];
      const float4 q00 = vb[(r00 + c.z.i1) * c4 + g], q01 = vb[(r01 + c.z.i1) * c4 + g];
      const float4 q10 = vb[(r10 + c.z.i1) * c4 + g], q11 = vb[(r11 + c.z.i1) * c4 + g];
      float4 r;
      r.x = channel<BF16>(c, p00.x, p01.x, p10.x, p11.x, q00.x, q01.x, q10.x, q11.x);
      r.y = channel<BF16>(c, p00.y, p01.y, p10.y, p11.y, q00.y, q01.y, q10.y, q11.y);
      r.z = channel<BF16>(c, p00.z, p01.z, p10.z, p11.z, q00.z, q01.z, q10.z, q11.z);
      r.w = channel<BF16>(c, p00.w, p01.w, p10.w, p11.w, q00.w, q01.w, q10.w, q11.w);
      dst[g] = r;
    }
  }
}

// ---------------------------------------------------------------- K4, K5

template <bool BF16, bool WIN>
__global__ void lift_bwd_kernel(const float* __restrict__ coords,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ gbar,
                                float* __restrict__ dv, int G, int C, int N,
                                int window) {
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * kTile;
  const int ncell = min(kTile, N - cell0);
  const float* cz = coords + ((int64_t)b * 3 + 0) * N + cell0;
  const float* cy = coords + ((int64_t)b * 3 + 1) * N + cell0;
  const float* cx = coords + ((int64_t)b * 3 + 2) * N + cell0;
  const uint8_t* m = mask + (int64_t)b * N + cell0;
  const float* g = gbar + ((int64_t)b * N + cell0) * C;
  float* db = dv + (int64_t)b * G * G * G * C;
  const int total = ncell * C;

  int s = 0;
  if (WIN) {
    s = window_start(cy, m, ncell, G, window);
    if (s < 0) return;
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int cell = e / C;
    if (!m[cell]) continue;
    const int ch = e - cell * C;
    const Cell c = cell_terms<BF16, WIN>(cx[cell], cy[cell], cz[cell], G, s, window);
    const float gb = rnd<BF16>(g[e]);
    float* d = db + ch;
    const int xi[2] = {c.x.i0, c.x.i1};
    const int yi[2] = {c.y.i0, c.y.i1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int zi = k == 0 ? c.z.i0 : c.z.i1;
      if (c.wz[k] == 0.f) continue;
      const float ek = rnd<BF16>(c.wz[k] * gb);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float w = c.a[i][j];
          if (w != 0.f)
            atomicAdd(d + (((int64_t)xi[i] * G + yi[j]) * G + zi) * C, w * ek);
        }
      }
    }
  }
}

// One vector reduction of 4 floats into global memory (sm_90).
__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  // no "memory" clobber: the kernel never reads dV, so loads may move past it
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w));
}

__device__ __forceinline__ float4 add_product(float4 acc, float w, float4 e) {
  // the product rounded before the sum, as the Pallas kernel's dot products and
  // the scalar kernel's atomics take it
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, e.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, e.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, e.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, e.w));
  return acc;
}

// The corner sums of a run of cells with one corner base, 4 channels of
// each: sum t = k * 4 + i * 2 + j is dim2 plane k, dim0 plane i, dim1 plane j
// of the base, whose plane indices are zi, xi, yi. A sum whose bit in
// `touched` is clear holds zeros.
struct Run {
  float4 acc[8];
  unsigned touched;
  int xi[2], yi[2], zi[2];
};

// Reduce corner t of the run into dV (4 channels from channel 4g) and clear it.
__device__ __forceinline__ void reduce_corner(Run& r, int t, float* db, int G, int C, int g) {
  const int k = t >> 2, i = (t >> 1) & 1, j = t & 1;
  red_add_v4(db + (((int64_t)r.xi[i] * G + r.yi[j]) * G + r.zi[k]) * C + 4 * g, r.acc[t]);
  r.acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// K4 / K5 backward for C % 4 == 0: the forward's threads and walk (see
// lift_fwd_vec4_kernel); the corner sums of the thread's run of cells with
// one corner base kept in registers (Run) and reduced into dV, 4 channels at
// a time, when the base changes and at the end. dv must be zero-filled and
// gbar 16-byte aligned.
template <bool BF16, bool WIN>
__global__ void __launch_bounds__(kThreads, 3)  // at most 85 registers: 24 warps an SM
lift_bwd_vec4_kernel(const float* __restrict__ coords, const uint8_t* __restrict__ mask,
                     const float* __restrict__ gbar, float* __restrict__ dv, int G, int C, int N,
                     int window, int q_log2) {
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * kTile;
  const int ncell = min(kTile, N - cell0);
  const float* cz = coords + ((int64_t)b * 3 + 0) * N + cell0;
  const float* cy = coords + ((int64_t)b * 3 + 1) * N + cell0;
  const float* cx = coords + ((int64_t)b * 3 + 2) * N + cell0;
  const uint8_t* m = mask + (int64_t)b * N + cell0;
  const int c4 = C >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(gbar + ((int64_t)b * N + cell0) * C);
  float* db = dv + (int64_t)b * G * G * G * C;

  int s = 0;
  if (WIN) {
    s = window_start(cy, m, ncell, G, window);
    if (s < 0) return;
  }
  const int q = 1 << q_log2;
  const int sub = threadIdx.x & (q - 1);
  const int slot = threadIdx.x >> q_log2;
  const int passes = (kTile / kThreads) << q_log2;  // at most 32
  // The valid cells of the run as bits, read once by the cell's 2^q threads
  // together, so that no load of the walk waits for a mask byte.
  unsigned valid = 0;
  for (int p = sub; p < passes; p += q) {
    const int cell = slot * passes + p;
    if (cell < ncell && m[cell]) valid |= 1u << p;
  }
  for (int o = 1; o < q; o <<= 1) valid |= __shfl_xor_sync(0xffffffffu, valid, o);
  for (int g = sub; g < c4; g += q) {
    Run run;
#pragma unroll
    for (int t = 0; t < 8; ++t) run.acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    run.touched = 0;
    run.xi[0] = run.xi[1] = run.yi[0] = run.yi[1] = run.zi[0] = run.zi[1] = -1;  // no base yet
#pragma unroll 2
    for (int p = 0; p < passes; ++p) {
      if (!((valid >> p) & 1)) continue;  // reads no coordinate and no cotangent
      const int cell = slot * passes + p;
      const Cell c = cell_terms<BF16, WIN>(cx[cell], cy[cell], cz[cell], G, s, window);
      if (c.x.i0 != run.xi[0] || c.y.i0 != run.yi[0] || c.z.i0 != run.zi[0]) {  // a new corner base
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if ((run.touched >> t) & 1) reduce_corner(run, t, db, G, C, g);
        run.touched = 0;
        run.xi[0] = c.x.i0, run.xi[1] = c.x.i1, run.yi[0] = c.y.i0, run.yi[1] = c.y.i1;
        run.zi[0] = c.z.i0, run.zi[1] = c.z.i1;
      }
      float4 gb = g4[(int64_t)cell * c4 + g];
      gb = make_float4(rnd<BF16>(gb.x), rnd<BF16>(gb.y), rnd<BF16>(gb.z), rnd<BF16>(gb.w));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float wz = c.wz[k];
        if (wz == 0.f) continue;
        const float4 e = make_float4(rnd<BF16>(wz * gb.x), rnd<BF16>(wz * gb.y), rnd<BF16>(wz * gb.z),
                                     rnd<BF16>(wz * gb.w));
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float w = c.a[i][j];
            if (w != 0.f) {
              const int t = k * 4 + i * 2 + j;
              run.acc[t] = add_product(run.acc[t], w, e);
              run.touched |= 1u << t;
            }
          }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if ((run.touched >> t) & 1) reduce_corner(run, t, db, G, C, g);
  }
}

// Launch KERNEL<BF16, WIN> for the run-time (bf16, window) pair.
#define LIFT_DISPATCH(KERNEL, ...)                                                  \
  do {                                                                              \
    if (bf16 && window > 0) KERNEL<true, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);        \
    else if (bf16) KERNEL<true, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);                \
    else if (window > 0) KERNEL<false, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);          \
    else KERNEL<false, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);                         \
  } while (0)

// log2 of the threads a cell takes in the vectorised kernels: the largest
// power of two <= min(C/4, 8).
int threads_per_cell_log2(int C) {
  int q_log2 = 0;
  while (q_log2 < 3 && (2 << q_log2) <= C / 4) ++q_log2;
  return q_log2;
}

}  // namespace

extern "C" int trilinear_lift_fwd(const float* voxel, const float* coords,
                                  const uint8_t* mask, float* out, int B, int G,
                                  int C, int N, int bf16, int window,
                                  cudaStream_t stream) {
  if ((int64_t)B * N * C == 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, B);
  LIFT_DISPATCH(lift_fwd_kernel, voxel, coords, mask, out, G, C, N, window);
  return (int)cudaGetLastError();
}

// The same for C % 4 == 0 with voxel and out 16-byte aligned.
extern "C" int trilinear_lift_fwd_vec4(const float* voxel, const float* coords,
                                       const uint8_t* mask, float* out, int B, int G,
                                       int C, int N, int bf16, int window,
                                       cudaStream_t stream) {
  if ((int64_t)B * N * C == 0) return 0;
  if (C % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, B);
  LIFT_DISPATCH(lift_fwd_vec4_kernel, voxel, coords, mask, out, G, C, N, window, threads_per_cell_log2(C));
  return (int)cudaGetLastError();
}

// dv must be zero-filled by the caller.
extern "C" int trilinear_lift_bwd(const float* coords, const uint8_t* mask,
                                  const float* gbar, float* dv, int B, int G,
                                  int C, int N, int bf16, int window,
                                  cudaStream_t stream) {
  if ((int64_t)B * N * C == 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, B);
  LIFT_DISPATCH(lift_bwd_kernel, coords, mask, gbar, dv, G, C, N, window);
  return (int)cudaGetLastError();
}

// The same for C % 4 == 0 with gbar and dv 16-byte aligned; dv zero-filled.
extern "C" int trilinear_lift_bwd_vec4(const float* coords, const uint8_t* mask,
                                       const float* gbar, float* dv, int B, int G,
                                       int C, int N, int bf16, int window,
                                       cudaStream_t stream) {
  if ((int64_t)B * N * C == 0) return 0;
  if (C % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTile - 1) / kTile, B);
  LIFT_DISPATCH(lift_bwd_vec4_kernel, coords, mask, gbar, dv, G, C, N, window, threads_per_cell_log2(C));
  return (int)cudaGetLastError();
}
