// Masked bilinear gather for the 3D-consistency loss, forward (K1) and
// backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` in
// rgbd_gan_tpu/ops/bilinear_pallas.py. Those contract separable one-hot
// matrices on the MXU because gathers are slow on a TPU; on this card a
// gather is a plain load, so both kernels here read the four corners
// directly.
//
// Semantics (identical to `bilinear_gather_pallas`):
//   img (B, H, W, C) f32, u and v (B, N) f32 -> out (B, N, C) f32.
//   u indexes rows, v columns. A point is in bounds iff
//   0 <= u < H-1 and 0 <= v < W-1 (false for NaN). u0 = trunc(u),
//   v0 = trunc(v), v1 = v0 + 1, u1 = u0 + 1, or u1 = u0 in exact mode
//   while the weights keep u0 + 1 (the reference's quirk).
//   An out-of-bounds point writes an exact 0 and reads no image memory:
//   its corner indices would come from u and v, which may be NaN or inf.
//
// Bound: memory traffic. At the training shapes (B=32, H=W=128, C=4,
// N=16384) one call touches about 8 MB of image and 0.5 M points, with
// 4 random 16-byte corner reads per point. K2 adds into a zeroed d img with
// f32 reductions, so its summation order changes from run to run; du and
// dv are closed-form per point.
//
// Kernels by channel count (ops/bilinear.py: fwd_route, bwd_route):
//   C == 4: K1 bilinear_fwd_kernel<EXACT, true>, a thread per point, each
//     corner one aligned float4 load and the output one float4 store; K2
//     bilinear_bwd_vec4_kernel (img, g and d img 16-byte aligned): float4
//     cotangent and corner reads and one 4-float vector reduction per
//     corner, where a corner column that the next point shares is handed
//     to its lane in registers first.
//   any other C: bilinear_fwd_lanes_kernel and bilinear_bwd_lanes_kernel, a
//     group of lanes per point over the channels (the feature
//     3D-consistency loss gathers at C = 257).
//   The thread-per-point kernels of any C, bilinear_fwd_kernel<EXACT, false>
//   and bilinear_bwd_kernel, stay as the measurements' old route only.
//
// Plain C interface (bound with ctypes). Each entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
  bool in_bounds;
  int64_t o00, o01, o10, o11;  // element offsets of the four corners
  float wu0, wu1, wv0, wv1;    // bilinear weights
};

__device__ __forceinline__ Corners corners(float uu, float vv, int H, int W,
                                           int C, int64_t base, bool exact) {
  Corners k;
  k.in_bounds = (uu >= 0.f) && (uu < (float)(H - 1)) && (vv >= 0.f) &&
                (vv < (float)(W - 1));
  if (!k.in_bounds) return k;
  const int u0 = (int)uu;  // uu >= 0: truncation == floor
  const int v0 = (int)vv;
  const int u1 = exact ? u0 : u0 + 1;
  const int v1 = v0 + 1;
  const float u0f = (float)u0;
  const float v0f = (float)v0;
  k.wu0 = u0f + 1.f - uu;
  k.wu1 = uu - u0f;
  k.wv0 = v0f + 1.f - vv;
  k.wv1 = vv - v0f;
  k.o00 = base + ((int64_t)u0 * W + v0) * C;
  k.o01 = base + ((int64_t)u0 * W + v1) * C;
  k.o10 = base + ((int64_t)u1 * W + v0) * C;
  k.o11 = base + ((int64_t)u1 * W + v1) * C;
  return k;
}

// ---------------------------------------------------------------- K1

template <bool EXACT, bool VEC4>
__global__ void bilinear_fwd_kernel(const float* __restrict__ img,
                                    const float* __restrict__ u,
                                    const float* __restrict__ v,
                                    float* __restrict__ out, int N, int H,
                                    int W, int C, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / N;
  const Corners k = corners(u[i], v[i], H, W, C, b * H * W * C, EXACT);
  float* o = out + i * C;
  if (!k.in_bounds) {
    if (VEC4) {
      *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int c = 0; c < C; ++c) o[c] = 0.f;
    }
    return;
  }
  if (EXACT) {
    // u1 == u0: both u weights land on the same row
    const float wu = k.wu0 + k.wu1;
    const float a = wu * k.wv0, d = wu * k.wv1;
    if (VEC4) {
      const float4 p0 = *reinterpret_cast<const float4*>(img + k.o00);
      const float4 p1 = *reinterpret_cast<const float4*>(img + k.o01);
      *reinterpret_cast<float4*>(o) =
          make_float4(a * p0.x + d * p1.x, a * p0.y + d * p1.y,
                      a * p0.z + d * p1.z, a * p0.w + d * p1.w);
    } else {
      for (int c = 0; c < C; ++c) o[c] = a * img[k.o00 + c] + d * img[k.o01 + c];
    }
  } else {
    const float w00 = k.wu0 * k.wv0, w10 = k.wu1 * k.wv0;
    const float w01 = k.wu0 * k.wv1, w11 = k.wu1 * k.wv1;
    if (VEC4) {
      const float4 p00 = *reinterpret_cast<const float4*>(img + k.o00);
      const float4 p01 = *reinterpret_cast<const float4*>(img + k.o01);
      const float4 p10 = *reinterpret_cast<const float4*>(img + k.o10);
      const float4 p11 = *reinterpret_cast<const float4*>(img + k.o11);
      *reinterpret_cast<float4*>(o) = make_float4(
          w00 * p00.x + w10 * p10.x + w01 * p01.x + w11 * p11.x,
          w00 * p00.y + w10 * p10.y + w01 * p01.y + w11 * p11.y,
          w00 * p00.z + w10 * p10.z + w01 * p01.z + w11 * p11.z,
          w00 * p00.w + w10 * p10.w + w01 * p01.w + w11 * p11.w);
    } else {
      for (int c = 0; c < C; ++c)
        o[c] = w00 * img[k.o00 + c] + w10 * img[k.o10 + c] +
               w01 * img[k.o01 + c] + w11 * img[k.o11 + c];
    }
  }
}

// ---------------------------------------------------------------- K2

template <bool EXACT>
__global__ void bilinear_bwd_kernel(const float* __restrict__ img,
                                    const float* __restrict__ u,
                                    const float* __restrict__ v,
                                    const float* __restrict__ g,
                                    float* __restrict__ dimg,
                                    float* __restrict__ du,
                                    float* __restrict__ dv, int N, int H,
                                    int W, int C, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / N;
  const Corners k = corners(u[i], v[i], H, W, C, b * H * W * C, EXACT);
  if (!k.in_bounds) {
    du[i] = 0.f;
    dv[i] = 0.f;
    return;
  }
  const float* gi = g + i * C;
  float acc_u = 0.f, acc_v = 0.f;
  if (EXACT) {
    // d u is identically 0: the two u corners coincide
    const float wu = k.wu0 + k.wu1;
    for (int c = 0; c < C; ++c) {
      const float gc = gi[c];
      acc_v += gc * (wu * img[k.o01 + c] - wu * img[k.o00 + c]);
      atomicAdd(dimg + k.o00 + c, wu * k.wv0 * gc);
      atomicAdd(dimg + k.o01 + c, wu * k.wv1 * gc);
    }
  } else {
    for (int c = 0; c < C; ++c) {
      const float gc = gi[c];
      const float p00 = img[k.o00 + c], p01 = img[k.o01 + c];
      const float p10 = img[k.o10 + c], p11 = img[k.o11 + c];
      acc_u += gc * (k.wv0 * (p10 - p00) + k.wv1 * (p11 - p01));
      acc_v += gc * ((k.wu0 * p01 + k.wu1 * p11) - (k.wu0 * p00 + k.wu1 * p10));
      atomicAdd(dimg + k.o00 + c, k.wu0 * k.wv0 * gc);
      atomicAdd(dimg + k.o10 + c, k.wu1 * k.wv0 * gc);
      atomicAdd(dimg + k.o01 + c, k.wu0 * k.wv1 * gc);
      atomicAdd(dimg + k.o11 + c, k.wu1 * k.wv1 * gc);
    }
  }
  du[i] = acc_u;
  dv[i] = acc_v;
}

// ---------------------------------------------------------------- K2, C = 4

// One vector reduction of 4 floats into global memory (sm_90).
__device__ __forceinline__ void red_add_v4(float* dst, float4 v) {
  // no "memory" clobber: the kernel never reads d img, so loads may move past it
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w));
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 scale(float w, float4 e) {
  return make_float4(__fmul_rn(w, e.x), __fmul_rn(w, e.y), __fmul_rn(w, e.z), __fmul_rn(w, e.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

constexpr unsigned kAll = 0xffffffffu;  // every lane of a warp

__device__ __forceinline__ float4 shfl_up4(float4 a) {
  return make_float4(__shfl_up_sync(kAll, a.x, 1), __shfl_up_sync(kAll, a.y, 1), __shfl_up_sync(kAll, a.z, 1),
                     __shfl_up_sync(kAll, a.w, 1));
}

// K2 for C == 4 with img, g and dimg 16-byte aligned; dimg zero-filled.
// A thread per point, all loads float4 and coalesced. A point's addition to
// each corner is wu * (wv * g), the Pallas kernel's rounding points (Av (x)
// g, then Au^T times that), each product rounded before any sum. The 3D
// loss gathers one point per source pixel in row-major order under a
// camera warp close to the identity, so a point's right corner column
// (v0 + 1, in each of its corner rows) is most often the next point's left
// one. There the lane hands that column's sums to the next lane by a
// shuffle, which adds them to its own before one vector reduction per
// corner: along a row most corners are reduced once, not twice. The test
// compares element offsets, batch base included, so 32 lanes that span two
// images merge nothing wrongly. An out-of-bounds point reads no image or
// cotangent memory, adds nothing and takes nothing.
template <bool EXACT>
__global__ void bilinear_bwd_vec4_kernel(const float* __restrict__ img, const float* __restrict__ u,
                                         const float* __restrict__ v, const float* __restrict__ g,
                                         float* __restrict__ dimg, float* __restrict__ du,
                                         float* __restrict__ dv, int N, int H, int W, int total) {
  constexpr int kRows = EXACT ? 1 : 2;  // corner rows of a point: u1 == u0 in exact mode
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < total;  // every lane takes part in the shuffles: none returns early
  const Corners k = corners(live ? u[i] : -1.f, live ? v[i] : -1.f, H, W, 4,
                            (int64_t)(live ? i / N : 0) * H * W * 4, EXACT);
  const int row = 4 * W;  // elements from one image row to the next
  int key = -1;           // element offset of the (u0, v0) corner; -1: out of bounds
  float4 s[kRows][2];     // the point's additions: s[r][j] at key + r * row + 4 * j
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k.in_bounds) {
    key = (int)k.o00;
    const float4 gi = load4(g + 4 * (int64_t)i);
    const float4 p00 = load4(img + k.o00), p01 = load4(img + k.o01);
    if (EXACT) {
      // d u is identically 0: the two u corners coincide
      const float wu = k.wu0 + k.wu1;
      du[i] = 0.f;
      dv[i] = gi.x * (wu * p01.x - wu * p00.x) + gi.y * (wu * p01.y - wu * p00.y) +
              gi.z * (wu * p01.z - wu * p00.z) + gi.w * (wu * p01.w - wu * p00.w);
    } else {
      const float4 p10 = load4(img + k.o10), p11 = load4(img + k.o11);
      du[i] = gi.x * (k.wv0 * (p10.x - p00.x) + k.wv1 * (p11.x - p01.x)) +
              gi.y * (k.wv0 * (p10.y - p00.y) + k.wv1 * (p11.y - p01.y)) +
              gi.z * (k.wv0 * (p10.z - p00.z) + k.wv1 * (p11.z - p01.z)) +
              gi.w * (k.wv0 * (p10.w - p00.w) + k.wv1 * (p11.w - p01.w));
      dv[i] = gi.x * ((k.wu0 * p01.x + k.wu1 * p11.x) - (k.wu0 * p00.x + k.wu1 * p10.x)) +
              gi.y * ((k.wu0 * p01.y + k.wu1 * p11.y) - (k.wu0 * p00.y + k.wu1 * p10.y)) +
              gi.z * ((k.wu0 * p01.z + k.wu1 * p11.z) - (k.wu0 * p00.z + k.wu1 * p10.z)) +
              gi.w * ((k.wu0 * p01.w + k.wu1 * p11.w) - (k.wu0 * p00.w + k.wu1 * p10.w));
    }
    const float4 e0 = scale(k.wv0, gi), e1 = scale(k.wv1, gi);
    const float wu[2] = {EXACT ? k.wu0 + k.wu1 : k.wu0, k.wu1};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r][0] = scale(wu[r], e0);
      s[r][1] = scale(wu[r], e1);
    }
  } else if (live) {
    du[i] = 0.f;
    dv[i] = 0.f;
  }
  // the previous lane's right column, where it is this lane's left one
  const int prev_key = __shfl_up_sync(kAll, key, 1);
  const int next_key = __shfl_down_sync(kAll, key, 1);
  const bool take = lane > 0 && key >= 0 && prev_key >= 0 && prev_key + 4 == key;
  const bool give = lane < 31 && key >= 0 && next_key == key + 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 from_prev = shfl_up4(s[r][1]);
    if (take) s[r][0] = add4(s[r][0], from_prev);
  }
  if (key < 0) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red_add_v4(dimg + key + r * row, s[r][0]);
    if (!give) red_add_v4(dimg + key + r * row + 4, s[r][1]);
  }
}

// ---------------------------------------------------------------- K1, K2 for C != 4

// A group of L lanes per point, L = min(32, the power of two >= C): a warp
// at C >= 17, so that no C leaves most of a group idle (C = 257: a warp; C =
// 3: 4 lanes). Lane j takes channels j, j + L, j + 2L, ...: at C = 257 a
// thread walking its point's channels would put the 32 lanes of a warp 1028
// bytes apart on every access; here each corner row is read, and the output
// row written, by consecutive lanes on consecutive addresses. A row starts
// at any 4-byte phase (C = 257 is odd), so the accesses are scalar. Every
// lane computes the corner offsets and weights of its point once, from one
// broadcast read of u and v, and holds U of its channels in registers at
// once: all of a chunk's corner loads are issued before its first multiply.
// A warp group holds kWideRegs = 9 slots, one chunk at C = 257 (the feature
// loss's ch + 1 in every shipped config), and loops over chunks of 288
// channels above that; a slot past C is predicated off. 16 slots held K2
// at 92 registers, two blocks of 256 threads an SM, where 9 leave room for
// four. Bound: memory traffic, as above; K2 also adds into d img through L2.
constexpr int kWideRegs = 9;

// One scalar reduction into global memory, no value returned.
__device__ __forceinline__ void red_add(float* dst, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(dst), "f"(v));
}

template <bool EXACT, int L, int U>
__global__ void __launch_bounds__(kThreads)
    bilinear_fwd_lanes_kernel(const float* __restrict__ img, const float* __restrict__ u,
                              const float* __restrict__ v, float* __restrict__ out, int N, int H, int W,
                              int C, int64_t total) {
  constexpr int kRows = EXACT ? 2 : 4;  // corners read: u1 == u0 in exact mode
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / L;  // the group's point
  const int lane = threadIdx.x % L;
  if (i >= total) return;  // a whole group at once; no lane waits on another
  const int64_t b = i / N;
  const Corners k = corners(u[i], v[i], H, W, C, b * H * W * C, EXACT);
  float* o = out + i * C;
  if (!k.in_bounds) {
    for (int c = lane; c < C; c += L) o[c] = 0.f;
    return;
  }
  // the rows in the order of the weights below; in exact mode both u
  // weights land on the u0 row, as in bilinear_fwd_kernel
  const int64_t row[4] = {k.o00, k.o01, k.o10, k.o11};
  float w[4];
  if constexpr (EXACT) {
    const float wu = k.wu0 + k.wu1;
    w[0] = wu * k.wv0;
    w[1] = wu * k.wv1;
  } else {
    w[0] = k.wu0 * k.wv0;
    w[1] = k.wu0 * k.wv1;
    w[2] = k.wu1 * k.wv0;
    w[3] = k.wu1 * k.wv1;
  }
  for (int c0 = lane; c0 < C; c0 += L * U) {
    float p[kRows][U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int c = c0 + j * L;
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r][j] = c < C ? img[row[r] + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int c = c0 + j * L;
      if (c >= C) break;
      // the sums of bilinear_fwd_kernel<EXACT, false>, in its order
      if constexpr (EXACT)
        o[c] = w[0] * p[0][j] + w[1] * p[1][j];
      else
        o[c] = w[0] * p[0][j] + w[2] * p[2][j] + w[1] * p[1][j] + w[3] * p[3][j];
    }
  }
}

// d img must be zeroed by the caller. Each lane adds its channels' shares
// to each corner with red.global.add.f32: the group's reductions into one
// corner row fall on consecutive addresses. du and dv are summed per lane,
// then across the group with __shfl_xor_sync; lane 0 writes them. An
// out-of-bounds point reads no image or cotangent memory and adds nothing.
template <bool EXACT, int L, int U>
__global__ void __launch_bounds__(kThreads)
    bilinear_bwd_lanes_kernel(const float* __restrict__ img, const float* __restrict__ u,
                              const float* __restrict__ v, const float* __restrict__ g,
                              float* __restrict__ dimg, float* __restrict__ du, float* __restrict__ dv, int N,
                              int H, int W, int C, int64_t total) {
  constexpr int kRows = EXACT ? 2 : 4;
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  const bool live = i < total;  // every lane takes part in the shuffles: none returns early
  const Corners k = corners(live ? u[i] : -1.f, live ? v[i] : -1.f, H, W, C,
                            (live ? i / N : 0) * H * W * C, EXACT);
  float acc_u = 0.f, acc_v = 0.f;
  if (k.in_bounds) {
    const float* gi = g + i * C;
    const int64_t row[4] = {k.o00, k.o01, k.o10, k.o11};
    // additions to the corners: wu * wv * g, rounded as bilinear_bwd_kernel rounds them
    const float wu0 = EXACT ? k.wu0 + k.wu1 : k.wu0;
    const float w[4] = {wu0 * k.wv0, wu0 * k.wv1, k.wu1 * k.wv0, k.wu1 * k.wv1};
    for (int c0 = lane; c0 < C; c0 += L * U) {
      float gc[U], p[kRows][U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int c = c0 + j * L;
        gc[j] = c < C ? gi[c] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) p[r][j] = c < C ? img[row[r] + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int c = c0 + j * L;
        if (c >= C) break;
        const float gj = gc[j];
        if constexpr (EXACT) {
          // d u is identically 0: the two u corners coincide
          acc_v += gj * (wu0 * p[1][j] - wu0 * p[0][j]);
        } else {
          const float p00 = p[0][j], p01 = p[1][j], p10 = p[2][j], p11 = p[3][j];
          acc_u += gj * (k.wv0 * (p10 - p00) + k.wv1 * (p11 - p01));
          acc_v += gj * ((k.wu0 * p01 + k.wu1 * p11) - (k.wu0 * p00 + k.wu1 * p10));
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) red_add(dimg + row[r] + c, w[r] * gj);
      }
    }
  }
#pragma unroll
  for (int s = L / 2; s > 0; s >>= 1) {
    acc_u += __shfl_xor_sync(kAll, acc_u, s, L);
    acc_v += __shfl_xor_sync(kAll, acc_v, s, L);
  }
  if (live && lane == 0) {
    du[i] = acc_u;
    dv[i] = acc_v;
  }
}

inline unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

struct LanesArgs {
  bool bwd;  // K2, else K1
  const float *img, *u, *v, *g;
  float *out, *du, *dv;  // out: K1's output, or K2's d img
  int N, H, W, C;
  int64_t total;
};

// K1 or K2 with L lanes a point and U channels a lane in registers
template <int L, int U>
void launch_lanes(const LanesArgs& a, bool exact, cudaStream_t s) {
  const unsigned int grid = blocks_for(a.total * L);
  if (!a.bwd) {
    if (exact)
      bilinear_fwd_lanes_kernel<true, L, U><<<grid, kThreads, 0, s>>>(a.img, a.u, a.v, a.out, a.N, a.H, a.W, a.C,
                                                                      a.total);
    else
      bilinear_fwd_lanes_kernel<false, L, U><<<grid, kThreads, 0, s>>>(a.img, a.u, a.v, a.out, a.N, a.H, a.W, a.C,
                                                                       a.total);
  } else {
    if (exact)
      bilinear_bwd_lanes_kernel<true, L, U><<<grid, kThreads, 0, s>>>(a.img, a.u, a.v, a.g, a.out, a.du, a.dv, a.N,
                                                                      a.H, a.W, a.C, a.total);
    else
      bilinear_bwd_lanes_kernel<false, L, U><<<grid, kThreads, 0, s>>>(a.img, a.u, a.v, a.g, a.out, a.du, a.dv,
                                                                       a.N, a.H, a.W, a.C, a.total);
  }
}

// L = min(32, the power of two >= C), one slot a lane below a warp
void dispatch_lanes(const LanesArgs& a, bool exact, cudaStream_t s) {
  const int C = a.C;
  if (C <= 1) return launch_lanes<1, 1>(a, exact, s);
  if (C <= 2) return launch_lanes<2, 1>(a, exact, s);
  if (C <= 4) return launch_lanes<4, 1>(a, exact, s);
  if (C <= 8) return launch_lanes<8, 1>(a, exact, s);
  if (C <= 16) return launch_lanes<16, 1>(a, exact, s);
  return launch_lanes<32, kWideRegs>(a, exact, s);
}

}  // namespace

extern "C" int bilinear_gather_fwd(const float* img, const float* u,
                                   const float* v, float* out, int B, int H,
                                   int W, int C, int N, int exact,
                                   void* stream) {
  const int64_t total = (int64_t)B * N;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = blocks_for(total);
  if (C == 4) {
    if (exact)
      bilinear_fwd_kernel<true, true><<<grid, kThreads, 0, s>>>(img, u, v, out, N, H, W, C, total);
    else
      bilinear_fwd_kernel<false, true><<<grid, kThreads, 0, s>>>(img, u, v, out, N, H, W, C, total);
  } else {
    if (exact)
      bilinear_fwd_kernel<true, false><<<grid, kThreads, 0, s>>>(img, u, v, out, N, H, W, C, total);
    else
      bilinear_fwd_kernel<false, false><<<grid, kThreads, 0, s>>>(img, u, v, out, N, H, W, C, total);
  }
  return (int)cudaGetLastError();
}

// dimg must be zeroed by the caller; du and dv are fully written.
extern "C" int bilinear_gather_bwd(const float* img, const float* u,
                                   const float* v, const float* g,
                                   float* dimg, float* du, float* dv, int B,
                                   int H, int W, int C, int N, int exact,
                                   void* stream) {
  const int64_t total = (int64_t)B * N;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = blocks_for(total);
  if (exact)
    bilinear_bwd_kernel<true><<<grid, kThreads, 0, s>>>(img, u, v, g, dimg, du, dv, N, H, W, C, total);
  else
    bilinear_bwd_kernel<false><<<grid, kThreads, 0, s>>>(img, u, v, g, dimg, du, dv, N, H, W, C, total);
  return (int)cudaGetLastError();
}

// The same for C == 4 with img, g and dimg 16-byte aligned (the vectorised
// kernel); dimg must be zeroed by the caller.
extern "C" int bilinear_gather_bwd_vec4(const float* img, const float* u,
                                        const float* v, const float* g,
                                        float* dimg, float* du, float* dv, int B,
                                        int H, int W, int C, int N, int exact,
                                        void* stream) {
  const int64_t total = (int64_t)B * N;
  if (total == 0) return (int)cudaGetLastError();
  if (C != 4 || ((uintptr_t)img | (uintptr_t)g | (uintptr_t)dimg) % 16 || total > (1LL << 31) - kThreads ||
      (int64_t)B * H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = blocks_for(total);
  if (exact)
    bilinear_bwd_vec4_kernel<true><<<grid, kThreads, 0, s>>>(img, u, v, g, dimg, du, dv, N, H, W, (int)total);
  else
    bilinear_bwd_vec4_kernel<false><<<grid, kThreads, 0, s>>>(img, u, v, g, dimg, du, dv, N, H, W, (int)total);
  return (int)cudaGetLastError();
}

// K1 with a group of lanes per point (any C; the route of every C != 4).
extern "C" int bilinear_gather_fwd_lanes(const float* img, const float* u, const float* v, float* out, int B,
                                         int H, int W, int C, int N, int exact, void* stream) {
  const int64_t total = (int64_t)B * N;
  if (total == 0 || C == 0) return (int)cudaGetLastError();
  dispatch_lanes({false, img, u, v, nullptr, out, nullptr, nullptr, N, H, W, C, total}, exact, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K2 with a group of lanes per point (any C; the route of every C != 4);
// dimg must be zeroed by the caller.
extern "C" int bilinear_gather_bwd_lanes(const float* img, const float* u, const float* v, const float* g,
                                         float* dimg, float* du, float* dv, int B, int H, int W, int C, int N,
                                         int exact, void* stream) {
  const int64_t total = (int64_t)B * N;
  if (total == 0) return (int)cudaGetLastError();
  dispatch_lanes({true, img, u, v, g, dimg, du, dv, N, H, W, C, total}, exact, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

