// Shared by the port's CUDA sources (l1.cu, mma.cu, i8.cu, l7.cu, ...):
// storage-type stores, LeakyReLU, the YUV -> BGR map, the int8 layer 6's
// tiles and scale, layer 5's tile maxima, the SM count of the current
// device, and w2x_error_string, the one C entry every library built from a
// source that includes this file exports. All but that entry live in an
// anonymous namespace: each source gets its own copy and instantiates only
// what it launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// what the last layer writes
enum { OUT_S2D = 0, OUT_DENSE = 1, OUT_U8 = 2, OUT_TAPS = 3, OUT_PTAPS = 4 };

// YUV -> BGR: bgr[c] = ((y*inv[c][0] + u*inv[c][1]) + v*inv[c][2]) + off[c]
struct ColorMap {
  float inv[3][3];
  float off[3];
};

// Where the last layer's input lies. tr == 0: one plane
// [N, 2hl+2, 2wl+2, CI]. tr > 0: tile-major, [N, ny, nx, 2tr+2, 2tc+2, CI],
// tile (ti, tj) holding the activation of s2d cells [ti*tr, (ti+1)*tr] x
// [tj*tc, (tj+1)*tc] with its own one-pixel halo (the int8 layer 6 gives
// each tile its own quantisation scale, so neighbouring tiles hold
// different values for the pixels they share). csrc/l7.cu's fold reads it as
// N*ny*nx planes of tr x tc cells.
struct Tiles {
  int tr, tc, ny, nx;
};

inline bool tiles_ok(const Tiles& qt) {
  return qt.tr > 0 && qt.tc > 0 && qt.ny > 0 && qt.nx > 0;
}

// The int8 layer 6's activation scale of a tile from its max |x5|.
__device__ __forceinline__ float i8_scale(float m) {
  return __fmul_rn(fmaxf(m, 1e-8f), (float)(1.0 / 127.0));
}

// Where layer 5's tile-maxima epilogue (mma.cu, mma_tf32.cu) writes:
// m [N, ny, nx], max |x5| of each tile window as the float's bits, zeros on
// entry; x5 is the plane [N, 2 ny tr + 4, 2 nx tc + 4, 128].
struct TileMax {
  unsigned* m;
  Tiles qt;
};

// B4's tile maxima from one 16 x 16 output block of layer 5: px holds the
// max |x5| of each of the block's pixels, row-major; the block starts at
// pixel (oy0, ox0) of the hout x wout plane and may run past its edge.
// Window (ti, tj) covers rows [2 ti tr, 2 ti tr + 2 tr + 4) and columns
// [2 tj tc, 2 tj tc + 2 tc + 4): windows overlap by 4 pixels, every pixel of
// the plane lies in one to three windows a side, and the block meets the
// windows ti0..ti1 x tj0..tj1 (1-4 at the default tile, a hundred at tile
// (1, 1)). A unit is a window and 4 of the block's rows; one warp a unit,
// a lane a column and every other row of the block's part of the window
// (no pixel past the plane's edge is read), then one atomicMax on the
// float's bits (non-negative floats order as unsigned integers, so the
// result does not depend on the order; fmaxf drops a NaN). Needs every pixel of px written and a barrier before
// the call.
template <int B>
__device__ void tile_max_block(const float* px, const TileMax& tm, int n,
                               int oy0, int ox0, int hout, int wout) {
  static_assert(B == 16, "a lane a column, two rows a step");
  constexpr int GROUPS = B / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sy = 2 * tm.qt.tr, sx = 2 * tm.qt.tc;
  const int y1 = min(oy0 + B, hout) - 1, x1 = min(ox0 + B, wout) - 1;
  const int ti0 = max(oy0 - 4, 0) / sy, ti1 = min(y1 / sy, tm.qt.ny - 1);
  const int tj0 = max(ox0 - 4, 0) / sx, tj1 = min(x1 / sx, tm.qt.nx - 1);
  const int nj = tj1 - tj0 + 1, units = (ti1 - ti0 + 1) * nj * GROUPS;
  const int c = ox0 + (lane & 15);
  for (int u = warp; u < units; u += blockDim.x >> 5) {
    const int w = u / GROUPS, g = u % GROUPS;
    const int ti = ti0 + w / nj, tj = tj0 + w % nj;
    const int r0 = max(max(oy0 + 4 * g, oy0), ti * sy);
    const int r1 = min(min(oy0 + 4 * g + 3, y1), ti * sy + sy + 3);
    if (r0 > r1) continue;   // the window misses these rows
    float best = 0.0f;
    if (c >= max(ox0, tj * sx) && c <= min(x1, tj * sx + sx + 3))
      for (int r = r0 + (lane >> 4); r <= r1; r += 2)
        best = fmaxf(best, px[(r - oy0) * B + c - ox0]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0)
      atomicMax(tm.m + ((size_t)n * tm.qt.ny + ti) * tm.qt.nx + tj,
                __float_as_uint(best));
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 4 consecutive elements (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
}

// 2 consecutive elements (4-byte aligned for bf16, 8-byte for f32).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 consecutive elements (16-byte aligned for bf16, 32-byte for f32).
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float leaky(float x) {
  return fmaxf(x, 0.0f) + 0.1f * fminf(x, 0.0f);
}

// The host array cmap[12] (the 3 x 3 YUV -> BGR matrix row by row, then
// its 3 offsets) -> ColorMap.
inline ColorMap color_map(const float* cmap) {
  ColorMap cm;
  for (int k = 0; k < 9; ++k) cm.inv[k / 3][k % 3] = cmap[k];
  for (int k = 0; k < 3; ++k) cm.off[k] = cmap[9 + k];
  return cm;
}

// The number of SMs of the current device, asked at each call (a process
// may launch on several cards): the persistent grids' size.
inline cudaError_t sm_count(int& sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

extern "C" {

// The message of a cudaError_t that one of this library's entries returned.
const char* w2x_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
