// Shared by the conv stack's CUDA sources (stack.cu, l6.cu, i8.cu, ...):
// storage-type loads and stores, LeakyReLU, the YUV -> BGR map, the int8
// layer 6's tiles and scale, and the last layer with one thread per s2d cell
// (conv3x3_bias_leaky_cell) in all its output forms: the truncation's taps,
// and the FFMA yardstick of l7.cu's fold, which every stack's layer 7 runs.
// Everything lives in an anonymous namespace: each source that includes
// this file gets its own copy and instantiates only what it launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int CELL_THREADS = 128;  // s2d cells (of one row) per block

// what the last layer writes
enum { OUT_S2D = 0, OUT_DENSE = 1, OUT_U8 = 2, OUT_TAPS = 3, OUT_PTAPS = 4 };

// YUV -> BGR: bgr[c] = ((y*inv[c][0] + u*inv[c][1]) + v*inv[c][2]) + off[c]
struct ColorMap {
  float inv[3][3];
  float off[3];
};

// What the last layer writes (OUT_*), with what only some forms read.
struct LastOut {
  int mode;
  const float* uvp;  // OUT_U8: [N, hl, wl, 8] f32
  ColorMap cm;       // OUT_U8
  int tc;            // OUT_DENSE: chunk width, a multiple of 32
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
// result does not depend on the order; fmaxf drops a NaN, as csrc/l6.cu's
// tile_absmax does). Needs every pixel of px written and a barrier before
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
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[k];
    const float2 f = __bfloat1622float2(h);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
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

// The last layer (CI -> 1) + bias + LeakyReLU with one thread per s2d cell
// (i, j): the 4 x 4 window x[n, 2i..2i+3, 2j..2j+3, :] gives the cell's four
// phases q = A*2 + B, full-res pixel (2i+A, 2j+B).
//   x: a plane or tile-major (see Tiles), w: [CI][9][1], b: [1]
//   OUT_S2D:   y is T [N, hl, wl, 4]; `wcols` = wl
//   OUT_DENSE: y is T [N, hl, nx*4*tc], nx = ceil(wl / tc); `wcols` = nx*tc
//   OUT_U8:    y is u8 [N, hl, wl, 16], uvp f32 [N, hl, wl, 8]; `wcols` = wl
//   OUT_TAPS:  y is T [N, hl, wl, 4]; `wcols` = wl. No bias and no LeakyReLU:
//              y[n, i, j, A*2+B] is the part of phase (A, B)'s sum whose taps
//              lie in the cell's own 2 x 2 pixels (dy < 2-A, dx < 2-B).
//   OUT_PTAPS: y is T [N, hl, wl, 4]; `wcols` = wl. No bias and no LeakyReLU:
//              y[n, i, j, t] = sum over c of x[n, 2i, 2j, c] * w[c][t], the
//              unfolded partials of the cell's pixel (0, 0) for taps
//              t = dy*3 + dx = 0..3 (tools/fused_strip_probe.py:162 at
//              upto 6: lanes 0-3 of pack_l7's per-phase tap partials).
// Grid: one block per (image, cell row, CELL_THREADS-column chunk of
// `wcols`), flattened.
template <int CI, typename T, int OUT_MODE, bool TILED>
__global__ void __launch_bounds__(CELL_THREADS)
conv3x3_bias_leaky_cell(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ b, void* __restrict__ y,
                        const float* __restrict__ uvp, ColorMap cm, int hl,
                        int wl, int tc, int wcols, int ncx, Tiles qt) {
  static_assert(CI % 8 == 0, "8-wide loads");
  __shared__ __align__(16) float s_w[9][CI];
  for (int i = threadIdx.x; i < 9 * CI; i += CELL_THREADS)
    s_w[i % 9][i / 9] = to_f32(w[i]);
  __syncthreads();

  unsigned bid = blockIdx.x;
  const int cx = bid % ncx;  bid /= ncx;
  const int i = bid % hl;    bid /= hl;
  const int n = bid;
  const int j = cx * CELL_THREADS + threadIdx.x;
  if (j >= wcols) return;

  if constexpr (OUT_MODE == OUT_DENSE) {
    T* yd = static_cast<T*>(y) + ((size_t)n * hl + i) * wcols * 4
            + (size_t)(j / tc) * 4 * tc + j % tc;
    if (j >= wl) {  // the last chunk's pad columns read zero
#pragma unroll
      for (int q = 0; q < 4; ++q) store1(yd + (size_t)q * tc, 0.0f);
      return;
    }
  }

  // the window's first pixel and the row pitch, in pixels
  size_t base;
  int win;
  if constexpr (TILED) {
    const int ti = i / qt.tr, tj = j / qt.tc;
    win = 2 * qt.tc + 2;
    base = ((((size_t)n * qt.ny + ti) * qt.nx + tj) * (2 * qt.tr + 2)
            + 2 * (i - ti * qt.tr)) * win + 2 * (j - tj * qt.tc);
  } else {
    win = 2 * wl + 2;
    base = ((size_t)n * (2 * hl + 2) + 2 * i) * win + 2 * j;
  }

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (OUT_MODE == OUT_PTAPS) {
    const T* px = x + base * CI;
#pragma unroll 2
    for (int ch = 0; ch < CI; ch += 8) {
      float v[8];
      load8(px + ch, v);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[t] = fmaf(v[k], s_w[t][ch + k], acc[t]);
    }
  }
#pragma unroll
  for (int r = 0; r < (OUT_MODE == OUT_PTAPS ? 0 : 4); ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // the same-cell taps read the cell's own 2 x 2 pixels only
      if (OUT_MODE == OUT_TAPS && (r > 1 || c > 1)) continue;
      const T* px = x + (base + (size_t)r * win + c) * CI;
#pragma unroll 2
      for (int ch = 0; ch < CI; ch += 8) {
        float v[8];
        load8(px + ch, v);
#pragma unroll
        for (int A = 0; A < 2; ++A) {
#pragma unroll
          for (int B = 0; B < 2; ++B) {
            const int dy = r - A, dx = c - B;  // known at compile time
            if (dy < 0 || dy > 2 || dx < 0 || dx > 2) continue;
            const float* wt = s_w[dy * 3 + dx];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              acc[A * 2 + B] = fmaf(v[k], wt[ch + k], acc[A * 2 + B]);
          }
        }
      }
    }
  }
  const size_t cell = ((size_t)n * hl + i) * wl + j;
  if constexpr (OUT_MODE == OUT_TAPS || OUT_MODE == OUT_PTAPS) {
    store4(static_cast<T*>(y) + cell * 4, acc);
    return;
  }
  float yv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) yv[q] = leaky(acc[q] + b[0]);

  if constexpr (OUT_MODE == OUT_S2D) {
    store4(static_cast<T*>(y) + cell * 4, yv);
  } else if constexpr (OUT_MODE == OUT_DENSE) {
    T* yd = static_cast<T*>(y) + ((size_t)n * hl + i) * wcols * 4
            + (size_t)(j / tc) * 4 * tc + j % tc;
#pragma unroll
    for (int q = 0; q < 4; ++q) store1(yd + (size_t)q * tc, yv[q]);
  } else {
    const float4 u4 = reinterpret_cast<const float4*>(uvp)[cell * 2];
    const float4 v4 = reinterpret_cast<const float4*>(uvp)[cell * 2 + 1];
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    uint32_t word[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      word[c] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // no fmaf here: each product and sum is rounded on its own
        float val = __fadd_rn(__fmul_rn(yv[q], cm.inv[c][0]),
                              __fmul_rn(u[q], cm.inv[c][1]));
        val = __fadd_rn(val, __fmul_rn(v[q], cm.inv[c][2]));
        val = __fmul_rn(__fadd_rn(val, cm.off[c]), 255.0f);
        val = fminf(fmaxf(rintf(val), 0.0f), 255.0f);  // half to even
        word[c] |= static_cast<uint32_t>(val) << (8 * q);
      }
    }
    static_cast<uint4*>(y)[cell] = make_uint4(word[0], word[1], word[2], 0u);
  }
}

template <int CI, typename T, int OUT_MODE, bool TILED>
cudaError_t launch_last_cell(const void* x, const void* w, const void* b,
                             void* y, const LastOut& out, Tiles qt, int n,
                             int hl, int wl, cudaStream_t s) {
  const int tc = OUT_MODE == OUT_DENSE ? out.tc : 0;
  if (OUT_MODE == OUT_DENSE && (tc <= 0 || tc % 32))
    return cudaErrorInvalidValue;
  if (OUT_MODE == OUT_U8 && out.uvp == nullptr) return cudaErrorInvalidValue;
  if (TILED && (qt.tr <= 0 || qt.tc <= 0 || (long long)qt.ny * qt.tr < hl ||
                (long long)qt.nx * qt.tc < wl))
    return cudaErrorInvalidValue;
  const int wcols = OUT_MODE == OUT_DENSE ? (wl + tc - 1) / tc * tc : wl;
  const int ncx = (wcols + CELL_THREADS - 1) / CELL_THREADS;
  const long long blocks = (long long)ncx * hl * n;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  conv3x3_bias_leaky_cell<CI, T, OUT_MODE, TILED>
      <<<(unsigned)blocks, CELL_THREADS, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const float*>(b), y, out.uvp, out.cm, hl, wl, tc, wcols,
          ncx, qt);
  return cudaGetLastError();
}

// The host array cmap[12] (the 3 x 3 YUV -> BGR matrix row by row, then
// its 3 offsets) -> ColorMap.
inline ColorMap color_map(const float* cmap) {
  ColorMap cm;
  for (int k = 0; k < 9; ++k) cm.inv[k / 3][k % 3] = cmap[k];
  for (int k = 0; k < 3; ++k) cm.off[k] = cmap[9 + k];
  return cm;
}

}  // namespace
