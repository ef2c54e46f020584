// B7's gather on Hopper (sm_90a): the last launch of the truncated stack
// at upto 0..5. Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (waifu2x_torch/ops/_build.py); the Python
// wrapper is waifu2x_torch/ops/stack.py:stack_scale_upto. The stack's layers
// before it are l1.cu's and mma.cu's or mma_tf32.cu's; at upto 6 the
// truncation's tap forms are output forms of l7.cu's fold.
//
// Replaces: waifu2x_tpu/ops/pallas_stack.py:_run_stack / _stack_body with
// upto=k, k = 0..5 (B7: the body returns after layer k and stores 4 lanes
// of that stage).
//
// The activations are the stack's NHWC planes: layer k's output has
// 2hl + 14 - 2k rows and starts at image row -(7 - k).
//
// What it computes, by `mode`:
//   GATHER_ACT    out[n, i, j, c] = act_k[n, 2i, 2j, c], c = 0..3, k = 1..5;
//   GATHER_TAPS   (k = 0) the four low-res taps (0,0), (0,1), (0,2), (1,0) of
//                 the 3 x 3 window at cell (i, j) of the low-res plane
//                 edge-padded by 4, read through clamped indices;
//   GATHER_LANE0  (k = 0) tap (0,0) of that window in all 4 lanes (the
//                 counterpart of tools/fused_strip_probe.py:162 at upto 0);
//   GATHER_PAD    (k = 0) the window itself, the low-res plane edge-padded
//                 by 4 on every side, [n, hl+8, wl+8] (the counterpart of
//                 tools/k1_forensics.py:136 at upto 0).
//
// Design: a persistent grid over bands of GT_ROWS output rows x GT_COLS
// cells, a warp to a row, 16-byte vector stores, GT_UNROLL vectors to a
// lane at a time; GATHER_ACT reads each even pixel's 4 lanes as one 8- or
// 16-byte ld.global.nc, the low-res modes stage the band's rows with their
// clamped 4-pixel halo in shared memory once and build every tap and the
// padded window from there. It only moves bits. Bound by bytes: the
// low-res modes read the plane once and write y; GATHER_ACT writes y and
// reads one 32-byte sector an output cell (the 4 lanes of a pixel sit alone
// in theirs: pixels are C >= 32 values apart), 4x (bf16) or 2x (f32) the
// bytes it keeps.

#include "common.cuh"

namespace {

constexpr int GT_ROWS = 8;     // output rows of a band, a warp each
constexpr int GT_COLS = 256;   // output cells of a band's row
constexpr int GT_THREADS = 32 * GT_ROWS;
// (tools/gather_probe.py times builds with other values of these three)
#ifndef W2X_GT_UNROLL
#define W2X_GT_UNROLL 4
#endif
#ifndef W2X_GT_BLOCKS
#define W2X_GT_BLOCKS 8
#endif
#ifndef W2X_GT_ACT_BLOCKS
#define W2X_GT_ACT_BLOCKS 1
#endif
constexpr int GT_UNROLL = W2X_GT_UNROLL;   // vectors a lane builds, then stores
// the persistent grid's blocks an SM: the low-res modes' (staging and
// stores overlap across blocks), GATHER_ACT's (fewer reads in flight, each
// a lone sector, keep DRAM's pages better; measured, PERF.md)
constexpr int GT_BLOCKS_PER_SM = W2X_GT_BLOCKS;
constexpr int GT_ACT_BLOCKS_PER_SM = W2X_GT_ACT_BLOCKS;

enum { GATHER_ACT = 0, GATHER_TAPS = 1, GATHER_LANE0 = 2, GATHER_PAD = 3 };

// B7, k = 0..5 (w2x_upto_gather). E is the storage type's
// bits (uint16_t for bf16, uint32_t for f32): the gather moves values and
// converts none. The grid walks bands of GT_ROWS output rows x GT_COLS cells
// of one image, `nbr` bands down and `nbc` across; warp w owns band row w.
// Its row segment is a run of elements of y (4 a cell, 1 for GATHER_PAD):
// the 16-byte vectors wholly inside the run are built in registers, up to
// GT_UNROLL a lane before any is stored, so that their loads are in flight
// together; the elements before the first vector and after the last (a run
// need not start on 16 bytes: wl * 4 * 2 bytes is no multiple of 16 for odd
// wl) are stored one by one. Every element of y is written once. The low-res
// modes stage the band first: GT_ROWS + 1 rows (tap (1, 0) reads the next
// row) of GT_COLS + 2 columns (tap (0, 2) reads two on) of the plane, from
// row i0 - 4 and column j0 - 4 on, each index clamped into the plane.
template <typename E>
__global__ void __launch_bounds__(GT_THREADS)
upto_gather_tiled(const E* __restrict__ x, E* __restrict__ y, int n, int hl,
                  int wl, int oh, int ow, int H, int W, int C, int mode,
                  int nbr, int nbc) {
  constexpr int V = 16 / sizeof(E);   // elements of a 16-byte vector
  __shared__ E s[GT_ROWS + 1][GT_COLS + 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int epc = mode == GATHER_PAD ? 1 : 4;   // elements of y a cell
  const long long bands = (long long)n * nbr * nbc;
  for (long long band = blockIdx.x; band < bands; band += gridDim.x) {
    const int bc = (int)(band % nbc);
    const long long rest = band / nbc;
    const int br = (int)(rest % nbr), img = (int)(rest / nbr);
    const int i0 = br * GT_ROWS, j0 = bc * GT_COLS;
    if (mode != GATHER_ACT) {
      __syncthreads();   // the previous band's reads of s are done
      const E* p = x + (size_t)img * hl * wl;
      for (int k = threadIdx.x; k < (GT_ROWS + 1) * (GT_COLS + 2);
           k += GT_THREADS) {
        const int r = k / (GT_COLS + 2), q = k % (GT_COLS + 2);
        const int sy = min(max(i0 + r - 4, 0), hl - 1);
        const int sx = min(max(j0 + q - 4, 0), wl - 1);
        s[r][q] = p[(size_t)sy * wl + sx];
      }
      __syncthreads();
    }
    const int i = i0 + warp;
    if (i >= oh) continue;
    const E* act = x + ((size_t)img * H + 2 * i) * W * C;   // row 2i
    // cell j's lane t (the low-res modes from the staged band)
    auto cell = [&](int j, int t) -> E {
      if (mode == GATHER_ACT) return act[(size_t)2 * j * C + t];
      if (mode == GATHER_LANE0) return s[warp][j - j0];
      return t == 3 ? s[warp + 1][j - j0] : s[warp][j - j0 + t];
    };
    // element le of the row: cell le / epc, lane le % epc
    auto elem = [&](int le) -> E {
      return mode == GATHER_PAD ? s[warp][le - j0] : cell(le >> 2, le & 3);
    };
    // the vector from the row's element le on; le % 4 == 0 unless
    // GATHER_PAD, so a vector holds V / 4 whole cells
    auto vec = [&](int le) -> uint4 {
      if (mode == GATHER_ACT) {
        const E* p = act + (size_t)2 * (le >> 2) * C;
        if constexpr (V == 4) {
          return __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
          const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + 2 * C));
          return make_uint4(a.x, a.y, b.x, b.y);
        }
      }
      E e[V];
      if (mode == GATHER_PAD) {
#pragma unroll
        for (int q = 0; q < V; ++q) e[q] = s[warp][le - j0 + q];
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) e[q] = cell((le >> 2) + q / 4, q % 4);
      }
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (V == 4)
          w[k] = e[k];
        else
          w[k] = (uint32_t)e[2 * k] | ((uint32_t)e[2 * k + 1] << 16);
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    };
    const size_t base = ((size_t)img * oh + i) * ow * epc;  // the row in y
    const int e0 = j0 * epc, e1 = min(j0 + GT_COLS, ow) * epc;
    // the whole 16-byte vectors of y in [base + e0, base + e1)
    const size_t v0 = (base + e0 + V - 1) / V, v1 = (base + e1) / V;
    if (v0 >= v1) {
      for (int le = e0 + lane; le < e1; le += 32) y[base + le] = elem(le);
      continue;
    }
    const int a = (int)(v0 * V - base), b = (int)(v1 * V - base);
    if (e0 + lane < a) y[base + e0 + lane] = elem(e0 + lane);
    if (b + lane < e1) y[base + b + lane] = elem(b + lane);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (size_t v = v0 + lane; v < v1; v += 32 * GT_UNROLL) {
      uint4 r[GT_UNROLL];
#pragma unroll
      for (int u = 0; u < GT_UNROLL; ++u)
        if (v + 32 * u < v1) r[u] = vec((int)((v + 32 * u) * V - base));
#pragma unroll
      for (int u = 0; u < GT_UNROLL; ++u)
        if (v + 32 * u < v1) yv[v + 32 * u] = r[u];
    }
  }
}

template <typename E>
cudaError_t launch_gather_tiled(const void* x, void* y, int n, int hl, int wl,
                                int H, int W, int C, int mode,
                                cudaStream_t s) {
  // GATHER_ACT's vector loads need each pixel's lanes on 8 (bf16) or 16
  // (f32) bytes, and every store path y on 16
  if (mode < GATHER_ACT || mode > GATHER_PAD ||
      (mode == GATHER_ACT &&
       (H < 2 * hl || W < 2 * wl || C < 4 || C % 4 ||
        reinterpret_cast<uintptr_t>(x) % 16)) ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  const int pad = mode == GATHER_PAD ? 8 : 0;
  const int oh = hl + pad, ow = wl + pad;
  const int nbr = (oh + GT_ROWS - 1) / GT_ROWS;
  const int nbc = (ow + GT_COLS - 1) / GT_COLS;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const long long bands = (long long)n * nbr * nbc;
  const long long cap = (long long)sms * (mode == GATHER_ACT
                                              ? GT_ACT_BLOCKS_PER_SM
                                              : GT_BLOCKS_PER_SM);
  const long long grid = bands < cap ? bands : cap;
  if (grid <= 0) return cudaErrorInvalidValue;
  upto_gather_tiled<E><<<(unsigned)grid, GT_THREADS, 0, s>>>(
      static_cast<const E*>(x), static_cast<E*>(y), n, hl, wl, oh, ow, H, W,
      C, mode, nbr, nbc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B7, k = 0..5, on `stream`, bf16 != 0 for __nv_bfloat16 storage (else
// float): y [n, hl, wl, 4] from the activation x [n, H, W, C] (mode 0,
// GATHER_ACT; C a multiple of 4, x on 16 bytes) or from the low-res plane
// x [n, hl, wl] (H, W, C unused): its taps (mode 1), tap (0,0) in every lane
// (mode 2), or y [n, hl+8, wl+8], the plane edge-padded by 4 (mode 3); y on
// 16 bytes. Returns the cudaError_t of the launch (0 on success).
int w2x_upto_gather(int bf16, const void* x, void* y, int n, int hl, int wl,
                    int H, int W, int C, int mode, void* stream) {
  if (n <= 0 || hl <= 0 || wl <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_gather_tiled<uint16_t>(x, y, n, hl, wl, H, W, C,
                                                    mode, s)
                    : launch_gather_tiled<uint32_t>(x, y, n, hl, wl, H, W, C,
                                                    mode, s));
}

}  // extern "C"
