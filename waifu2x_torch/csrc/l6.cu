// Hand-written Hopper (sm_90a) kernels for the conv stack's three other
// configurations: the truncated stack (B7), layer 6 as int8 x int8 (B4)
// and layer 6 as Winograd F(2x2, 3x3) (B5). Built with nvcc into a shared
// library with a plain C interface and loaded with ctypes
// (waifu2x_torch/ops/_build.py); the Python wrappers are in
// waifu2x_torch/ops/stack.py: stack_scale_upto (B7) and the l6_i8= (B4)
// and l6_wino= (B5) arguments of every stack wrapper. Layers 1-5 and, in
// the plane forms, layer 7 are the launches of stack.cu.
//
// Replaces: waifu2x_tpu/ops/pallas_stack.py:_run_stack / _stack_body with
// upto=k (B7: the body returns after layer k and stores 4 lanes of that
// stage), with l6_i8=True (B4: layer 6 on the int8 matrix unit, with a
// per-tile activation scale) and with l6_wino=True (B5: layer 6 in the
// Winograd domain of s2d.py:pack_wino).
//
// The activations are the NHWC planes of stack.cu: layer k's output has
// 2hl + 14 - 2k rows and starts at image row -(7 - k).
//
// B7, upto_gather<T>, one thread per output cell, by `mode`:
//   GATHER_ACT    out[n, i, j, c] = act_k[n, 2i, 2j, c], c = 0..3, k = 1..5;
//   GATHER_TAPS   (k = 0) the four low-res taps (0,0), (0,1), (0,2), (1,0) of
//                 the 3 x 3 window at cell (i, j) of the low-res plane
//                 edge-padded by 4, read through clamped indices;
//   GATHER_LANE0  (k = 0) tap (0,0) of that window in all 4 lanes (the
//                 counterpart of tools/fused_strip_probe.py:162 at upto 0);
//   GATHER_PAD    (k = 0) the window itself, the low-res plane edge-padded
//                 by 4 on every side, [n, hl+8, wl+8] (the counterpart of
//                 tools/k1_forensics.py:136 at upto 0).
//   k = 6 is the OUT_TAPS or OUT_PTAPS form of conv3x3_bias_leaky_cell
//   (common.cuh). Bound by bytes: 4 values read and written per cell.
//
// B4, tile_absmax<T> and l6_i8_conv<T>. The stack runs on the plane
//   edge-extended to a grid of (tr, tc)-cell tiles. Tile (ti, tj) reads the
//   window of layer 5's output at rows [2 ti tr, 2 ti tr + 2tr + 4) and
//   columns [2 tj tc, 2 tj tc + 2tc + 4):
//     m  = max |x5| over the window (all 128 channels)
//     sx = max(m, 1e-8) * (1/127),  x5q = clip(rint(x5 * (1/sx)), +-127)
//     x6 = leaky(float(sum_int32(x5q * w6q)) * (sx * sw[co]) + b6[co])
//   over the window's (2tr+2) x (2tc+2) valid outputs, rounded to T and
//   stored tile-major (common.cuh: Tiles), because two tiles that share
//   pixels give them different values. tile_absmax reduces a few window
//   rows per block with warp shuffles and one atomicMax on the float's
//   bits per block (non-negative floats order as unsigned integers), so the
//   result does not depend on the order. l6_i8_conv has stack.cu's
//   blocking (an 8 x 32 output tile, 32 output channels, 4 rows x 8
//   channels per thread) with four input channels to a 32-bit word and
//   __dp4a into int32 sums: exact, whatever the order. It quantises the
//   window while staging it into shared memory, so no int8 copy of x5 is
//   ever stored. rint is round half to even; products and sums of the
//   dequantisation are written with __fmul_rn / __fadd_rn so that nvcc
//   contracts none into an fmaf and the plain PyTorch version
//   (ops/stack.py:l6_i8_layer_plain) computes the same f32 values.
//   Bound by operations: 1152 int8 multiply-adds per output value; as
//   __dp4a that is a quarter as many instructions as stack.cu's FFMA layer.
//   The int8 tensor cores (wgmma) are left to later work.
//
// B5, l6_wino<T>. Per 2 x 2 output block and input channel:
//     V = B^T d B  (d the block's 4 x 4 window of x5, formed in f32)
//     M[p] += V[p] * U[p][ci][co],  p = 0..15, f32 FFMA
//     Y = A^T M A, + bias, LeakyReLU, one rounding to T.
//   Layer 6's output plane has an even number of rows and columns, so the
//   blocks start at its first pixel and cover it exactly. A thread owns one
//   block and 8 output channels (128 f32 sums, about 225 registers); a
//   CUDA block of 128 threads covers 1 x 32 blocks and 32 output channels
//   and stages 8 input channels at a time, so that two CUDA blocks fit an
//   SM's registers and one computes while the other stages.
//   The window is staged with even and odd columns apart, so that a warp's
//   stride-2 reads hit 32 banks. 16 FFMA per block, input and output
//   channel where the direct form takes 36; the transforms add 32 adds
//   per block and input channel, shared by the thread's 8 channels.
//   Bound by operations.

#include "common.cuh"

namespace {

constexpr int TH = 8;          // i8: output tile rows
constexpr int TW = 32;         // i8: output tile columns, one lane each
constexpr int COB = 32;        // output channels per block
constexpr int NTHREADS = 256;  // 8 warps: 2 row halves x 4 groups of 8 ch
constexpr int C6 = 128;        // layer 6's input and output channels
constexpr int GATHER_THREADS = 256;
constexpr int ABSMAX_ROWS = 4;  // window rows per tile_absmax block

enum { GATHER_ACT = 0, GATHER_TAPS = 1, GATHER_LANE0 = 2, GATHER_PAD = 3 };

// B7, k = 0..5. GATHER_ACT: x is an activation [N, H, W, C] with H >= 2hl,
// W >= 2wl, C >= 4; else x is the low-res plane [N, hl, wl]. The output has
// `oh` x `ow` cells an image: hl x wl, or for GATHER_PAD hl+8 x wl+8.
template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
upto_gather(const T* __restrict__ x, T* __restrict__ y, long long cells,
            int hl, int wl, int oh, int ow, int H, int W, int C, int mode) {
  const long long idx = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (idx >= cells) return;
  const int j = idx % ow;
  const int i = (idx / ow) % oh;
  const long long n = idx / ((long long)ow * oh);
  if (mode == GATHER_PAD) {
    const int sy = min(max(i - 4, 0), hl - 1);
    const int sx = min(max(j - 4, 0), wl - 1);
    y[idx] = x[(n * hl + sy) * wl + sx];
    return;
  }
  T* out = y + idx * 4;
  if (mode != GATHER_ACT) {
    const T* p = x + n * hl * wl;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int dy = mode == GATHER_TAPS ? t / 3 : 0;
      const int dx = mode == GATHER_TAPS ? t % 3 : 0;
      const int sy = min(max(i + dy - 4, 0), hl - 1);
      const int sx = min(max(j + dx - 4, 0), wl - 1);
      out[t] = p[(long long)sy * wl + sx];
    }
  } else {
    const T* p = x + ((n * H + 2 * i) * W + 2 * j) * C;
#pragma unroll
    for (int t = 0; t < 4; ++t) out[t] = p[t];
  }
}

// B4: m[n, ti, tj] = max |x5| over the tile's window, as the float's bits
// (m must hold zeros before the launch).
//   x5: [N, H5, W5, 128] with H5 = 2 ny tr + 4, W5 = 2 nx tc + 4
// Grid: one block per (image, tile, chunk of ABSMAX_ROWS window rows).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
tile_absmax(const T* __restrict__ x5, unsigned* __restrict__ m, int H5,
            int W5, Tiles qt, int nchunks) {
  unsigned bid = blockIdx.x;
  const int chunk = bid % nchunks;  bid /= nchunks;
  const int tj = bid % qt.nx;       bid /= qt.nx;
  const int ti = bid % qt.ny;       bid /= qt.ny;
  const int n = bid;
  const int wrows = 2 * qt.tr + 4;
  const int run = (2 * qt.tc + 4) * C6 / 8;  // 8-element groups per row
  float best = 0.0f;
  for (int r = chunk * ABSMAX_ROWS;
       r < min(wrows, (chunk + 1) * ABSMAX_ROWS); ++r) {
    const T* row = x5 + (((size_t)n * H5 + 2 * ti * qt.tr + r) * W5
                         + 2 * tj * qt.tc) * C6;
    for (int g = threadIdx.x; g < run; g += NTHREADS) {
      float v[8];
      load8(row + (size_t)g * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) best = fmaxf(best, fabsf(v[k]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  __shared__ float s_best[NTHREADS / 32];
  if ((threadIdx.x & 31) == 0) s_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < NTHREADS / 32; ++k) best = fmaxf(best, s_best[k]);
    atomicMax(m + ((size_t)n * qt.ny + ti) * qt.nx + tj,
              __float_as_uint(best));
  }
}

// The activation scale of a tile from its max |x5|.
__device__ __forceinline__ float i8_scale(float m) {
  return __fmul_rn(fmaxf(m, 1e-8f), (float)(1.0 / 127.0));
}

// B4: layer 6 of one tile as int8 x int8 -> int32, dequantised, + bias,
// LeakyReLU, stored tile-major.
//   x5: [N, H5, W5, 128]; wq: [32][9][128] words, byte k of word
//   [c4][t][co] = w6q[4 c4 + k][t][co]; sw, b: [128] f32; m: [N, ny, nx];
//   x6: [N, ny, nx, 2tr+2, 2tc+2, 128]
// Grid: one block per (image, tile, 8 x 32 output sub-tile of the tile,
// 32-channel group), flattened with the channel group fastest.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
l6_i8_conv(const T* __restrict__ x5, const int* __restrict__ wq,
           const float* __restrict__ sw, const float* __restrict__ b,
           const float* __restrict__ m, T* __restrict__ x6, int H5, int W5,
           Tiles qt, int ntx, int nty) {
  constexpr int KW = 8;  // words (of 4 input channels) per stage
  constexpr int NCB = C6 / COB;
  __shared__ int s_x[KW][TH + 2][TW + 2];
  __shared__ __align__(16) int s_w[KW][9][COB];

  unsigned bid = blockIdx.x;
  const int cb = bid % NCB;   bid /= NCB;
  const int tx = bid % ntx;   bid /= ntx;
  const int ty = bid % nty;   bid /= nty;
  const int tj = bid % qt.nx; bid /= qt.nx;
  const int ti = bid % qt.ny; bid /= qt.ny;
  const int n = bid;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = warp & 3;      // channels g*8 .. g*8+7 of this block's 32
  const int half = warp >> 2;  // tile rows 4*half .. 4*half+3
  const int oy0 = ty * TH, ox0 = tx * TW;
  const int hout = 2 * qt.tr + 2, wout = 2 * qt.tc + 2;
  const size_t tile = ((size_t)n * qt.ny + ti) * qt.nx + tj;
  const float sx = i8_scale(m[tile]);
  const float inv = __fdiv_rn(1.0f, sx);
  const T* xw = x5 + (((size_t)n * H5 + 2 * ti * qt.tr) * W5
                      + 2 * tj * qt.tc) * C6;  // the window's first pixel

  int acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0;

  for (int w0 = 0; w0 < C6 / 4; w0 += KW) {
    __syncthreads();  // the previous stage's reads are done
    constexpr int G8 = KW / 2;  // 8-channel groups per stage
    for (int i = tid; i < G8 * (TH + 2) * (TW + 2); i += NTHREADS) {
      const int c8 = i % G8, p = i / G8;
      const int r = p / (TW + 2), col = p % (TW + 2);
      const int iy = oy0 + r, ix = ox0 + col;
      unsigned word[2] = {0u, 0u};
      if (iy < hout + 2 && ix < wout + 2) {
        float v[8];
        load8(xw + ((size_t)iy * W5 + ix) * C6 + w0 * 4 + c8 * 8, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int q =
              max(-127, min(127, __float2int_rn(__fmul_rn(v[k], inv))));
          word[k >> 2] |= (unsigned)(q & 0xff) << (8 * (k & 3));
        }
      }
      s_x[c8 * 2][r][col] = (int)word[0];
      s_x[c8 * 2 + 1][r][col] = (int)word[1];
    }
    for (int i = tid; i < KW * 9 * COB; i += NTHREADS) {
      const int j = i % COB, t = (i / COB) % 9, c = i / (9 * COB);
      s_w[c][t][j] = wq[((size_t)(w0 + c) * 9 + t) * C6 + cb * COB + j];
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < KW; ++c) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        int xin[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) xin[r] = s_x[c][4 * half + r][lane + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int4* wp =
              reinterpret_cast<const int4*>(&s_w[c][dy * 3 + dx][g * 8]);
          const int4 wa = wp[0], wb = wp[1];
          const int wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 8; ++k)
              acc[r][k] = __dp4a(xin[r + dy], wv[k], acc[r][k]);
        }
      }
    }
  }

  const int ox = ox0 + lane;
  if (ox >= wout) return;
  const int co0 = cb * COB + g * 8;
  float scale[8], bias[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    scale[k] = __fmul_rn(sx, sw[co0 + k]);
    bias[k] = b[co0 + k];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int oy = oy0 + 4 * half + r;
    if (oy >= hout) break;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = leaky(__fadd_rn(__fmul_rn((float)acc[r][k], scale[k]), bias[k]));
    store8(x6 + ((tile * hout + oy) * wout + ox) * C6 + co0, v);
  }
}

constexpr int WBR = 1;   // wino: block rows per CUDA block
constexpr int WTHREADS = 128 * WBR;  // 4 warps (groups of 8 ch) per block row
constexpr int WBC = 32;  // wino: block columns per CUDA block, one lane each
constexpr int WKC = 8;   // wino: input channels per stage

// B5: layer 6 as Winograd F(2x2, 3x3) + bias + LeakyReLU.
//   x5: [N, H5, W5, 128] (H5, W5 even); u: [16][128][128] (p = py*4 + px,
//   then input channel, then output channel); b: [128] f32;
//   y6: [N, H5-2, W5-2, 128]
// Grid: one block per (image, WBR block rows, 32 block columns, 32-channel
// group), flattened with the channel group fastest.
template <typename T>
__global__ void __launch_bounds__(WTHREADS)
l6_wino(const T* __restrict__ x5, const T* __restrict__ u,
        const float* __restrict__ b, T* __restrict__ y6, int H5, int W5,
        int nbx, int nby) {
  constexpr int NCB = C6 / COB;
  // the window, even columns and odd columns apart: [..][col & 1][col >> 1]
  __shared__ float s_d[WKC][2 * WBR + 2][2][WBC + 1];
  __shared__ __align__(16) float s_u[WKC][16][COB];

  unsigned bid = blockIdx.x;
  const int cb = bid % NCB;  bid /= NCB;
  const int bx = bid % nbx;  bid /= nbx;
  const int by = bid % nby;  bid /= nby;
  const int n = bid;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = warp & 3;      // channels g*8 .. g*8+7 of this block's 32
  const int half = warp >> 2;  // block row within this CUDA block
  const int y0 = 2 * WBR * by, x0 = 2 * WBC * bx;  // the window's origin
  const int H6 = H5 - 2, W6 = W5 - 2;

  float M[16][8];
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) M[p][k] = 0.0f;

  for (int c0 = 0; c0 < C6; c0 += WKC) {
    __syncthreads();  // the previous stage's reads are done
    for (int p = tid; p < (2 * WBR + 2) * (2 * WBC + 2); p += WTHREADS) {
      const int r = p / (2 * WBC + 2), col = p % (2 * WBC + 2);
      const int iy = y0 + r, ix = x0 + col;
      float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (iy < H5 && ix < W5)
        load8(x5 + (((size_t)n * H5 + iy) * W5 + ix) * C6 + c0, v);
#pragma unroll
      for (int k = 0; k < WKC; ++k) s_d[k][r][col & 1][col >> 1] = v[k];
    }
    for (int i = tid; i < WKC * 16 * COB; i += WTHREADS) {
      const int j = i % COB, p = (i / COB) % 16, c = i / (16 * COB);
      s_u[c][p][j] = to_f32(u[((size_t)p * C6 + c0 + c) * C6 + cb * COB + j]);
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < WKC; ++c) {
      // t = B^T d (rows), then V = t B (columns)
      float t[4][4];
#pragma unroll
      for (int col = 0; col < 4; ++col) {
        float d[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          d[r] = s_d[c][2 * half + r][col & 1][lane + (col >> 1)];
        t[0][col] = d[0] - d[2];
        t[1][col] = d[1] + d[2];
        t[2][col] = d[2] - d[1];
        t[3][col] = d[1] - d[3];
      }
#pragma unroll
      for (int py = 0; py < 4; ++py) {
        const float V[4] = {t[py][0] - t[py][2], t[py][1] + t[py][2],
                            t[py][2] - t[py][1], t[py][1] - t[py][3]};
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const float4* wp =
              reinterpret_cast<const float4*>(&s_u[c][py * 4 + px][g * 8]);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                               wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int k = 0; k < 8; ++k)
            M[py * 4 + px][k] = fmaf(V[px], wv[k], M[py * 4 + px][k]);
        }
      }
    }
  }

  const int brow = WBR * by + half, bcol = WBC * bx + lane;
  if (2 * brow >= H6 || 2 * bcol >= W6) return;
  const int co0 = cb * COB + g * 8;
  float out[2][2][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // R = A^T M (rows), then Y = R A (columns)
    float R[2][4];
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      R[0][px] = M[0 + px][k] + M[4 + px][k] + M[8 + px][k];
      R[1][px] = M[4 + px][k] - M[8 + px][k] - M[12 + px][k];
    }
    const float bias = b[co0 + k];
#pragma unroll
    for (int A = 0; A < 2; ++A) {
      out[A][0][k] = leaky(R[A][0] + R[A][1] + R[A][2] + bias);
      out[A][1][k] = leaky(R[A][1] - R[A][2] - R[A][3] + bias);
    }
  }
#pragma unroll
  for (int A = 0; A < 2; ++A)
#pragma unroll
    for (int B = 0; B < 2; ++B)
      store8(y6 + (((size_t)n * H6 + 2 * brow + A) * W6 + 2 * bcol + B) * C6
                 + co0, out[A][B]);
}

bool tiles_ok(const Tiles& qt) {
  return qt.tr > 0 && qt.tc > 0 && qt.ny > 0 && qt.nx > 0;
}

template <typename T>
cudaError_t launch_gather(const void* x, void* y, int n, int hl, int wl,
                          int H, int W, int C, int mode, cudaStream_t s) {
  if (mode < GATHER_ACT || mode > GATHER_PAD ||
      (mode == GATHER_ACT && (H < 2 * hl || W < 2 * wl || C < 4)))
    return cudaErrorInvalidValue;
  const int pad = mode == GATHER_PAD ? 8 : 0;
  const long long cells = (long long)n * (hl + pad) * (wl + pad);
  const long long blocks = (cells + GATHER_THREADS - 1) / GATHER_THREADS;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  upto_gather<T><<<(unsigned)blocks, GATHER_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), cells, hl, wl, hl + pad,
      wl + pad, H, W, C, mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_absmax(const void* x5, void* m, int n, Tiles qt,
                          cudaStream_t s) {
  const int H5 = 2 * qt.ny * qt.tr + 4, W5 = 2 * qt.nx * qt.tc + 4;
  const int nchunks = (2 * qt.tr + 4 + ABSMAX_ROWS - 1) / ABSMAX_ROWS;
  const long long blocks = (long long)n * qt.ny * qt.nx * nchunks;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  tile_absmax<T><<<(unsigned)blocks, NTHREADS, 0, s>>>(
      static_cast<const T*>(x5), static_cast<unsigned*>(m), H5, W5, qt,
      nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_i8(const void* x5, const void* wq, const void* sw,
                      const void* b, const void* m, void* x6, int n, Tiles qt,
                      cudaStream_t s) {
  const int H5 = 2 * qt.ny * qt.tr + 4, W5 = 2 * qt.nx * qt.tc + 4;
  const int ntx = (2 * qt.tc + 2 + TW - 1) / TW;
  const int nty = (2 * qt.tr + 2 + TH - 1) / TH;
  const long long blocks =
      (long long)n * qt.ny * qt.nx * nty * ntx * (C6 / COB);
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  l6_i8_conv<T><<<(unsigned)blocks, NTHREADS, 0, s>>>(
      static_cast<const T*>(x5), static_cast<const int*>(wq),
      static_cast<const float*>(sw), static_cast<const float*>(b),
      static_cast<const float*>(m), static_cast<T*>(x6), H5, W5, qt, ntx,
      nty);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wino(const void* x5, const void* u, const void* b,
                        void* y6, int n, int H5, int W5, cudaStream_t s) {
  if (H5 < 4 || W5 < 4 || H5 % 2 || W5 % 2) return cudaErrorInvalidValue;
  const int nby = ((H5 - 2) / 2 + WBR - 1) / WBR;
  const int nbx = ((W5 - 2) / 2 + WBC - 1) / WBC;
  const long long blocks = (long long)n * nby * nbx * (C6 / COB);
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  l6_wino<T><<<(unsigned)blocks, WTHREADS, 0, s>>>(
      static_cast<const T*>(x5), static_cast<const T*>(u),
      static_cast<const float*>(b), static_cast<T*>(y6), H5, W5, nbx, nby);
  return cudaGetLastError();
}

// Layer 7 from a tile-major layer 6, in every output form.
template <typename T>
cudaError_t launch_last(const void* x, const void* w, const void* b, void* y,
                        const LastOut& out, Tiles qt, int n, int hl, int wl,
                        cudaStream_t s) {
  switch (out.mode) {
    case OUT_S2D:
      return launch_last_cell<C6, T, OUT_S2D, true>(x, w, b, y, out, qt, n,
                                                    hl, wl, s);
    case OUT_DENSE:
      return launch_last_cell<C6, T, OUT_DENSE, true>(x, w, b, y, out, qt, n,
                                                      hl, wl, s);
    case OUT_U8:
      return launch_last_cell<C6, T, OUT_U8, true>(x, w, b, y, out, qt, n, hl,
                                                   wl, s);
    case OUT_TAPS:
      return launch_last_cell<C6, T, OUT_TAPS, true>(x, w, b, y, out, qt, n,
                                                     hl, wl, s);
    case OUT_PTAPS:
      return launch_last_cell<C6, T, OUT_PTAPS, true>(x, w, b, y, out, qt, n,
                                                      hl, wl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Every function launches on `stream`, takes bf16 != 0 for __nv_bfloat16
// storage (else float) and returns the cudaError_t of the launch.

// B7, k = 0..5: y [n, hl, wl, 4] from the activation x [n, H, W, C]
// (mode 0, GATHER_ACT) or from the low-res plane x [n, hl, wl] (H, W, C
// unused): its taps (mode 1), tap (0,0) in every lane (mode 2), or y
// [n, hl+8, wl+8], the plane edge-padded by 4 (mode 3).
int w2x_upto_gather(int bf16, const void* x, void* y, int n, int hl, int wl,
                    int H, int W, int C, int mode, void* stream) {
  if (n <= 0 || hl <= 0 || wl <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_gather<__nv_bfloat16>(x, y, n, hl, wl, H, W, C,
                                                   mode, s)
                    : launch_gather<float>(x, y, n, hl, wl, H, W, C, mode,
                                           s));
}

// B4: m [n, ny, nx] f32 (zeros on entry) = max |x5| per tile window of
// x5 [n, 2 ny tr + 4, 2 nx tc + 4, 128].
int w2x_tile_absmax(int bf16, const void* x5, void* m, int n, int tr, int tc,
                    int ny, int nx, void* stream) {
  const Tiles qt = {tr, tc, ny, nx};
  if (n <= 0 || !tiles_ok(qt)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_absmax<__nv_bfloat16>(x5, m, n, qt, s)
                    : launch_absmax<float>(x5, m, n, qt, s));
}

// B4: x6 [n, ny, nx, 2tr+2, 2tc+2, 128] from x5 (as above), the packed
// int8 weights wq [32][9][128] (int32 words), their scales sw [128] f32,
// the bias b [128] f32 and the tiles' max |x5| m [n, ny, nx] f32.
int w2x_l6_i8(int bf16, const void* x5, const void* wq, const void* sw,
              const void* b, const void* m, void* x6, int n, int tr, int tc,
              int ny, int nx, void* stream) {
  const Tiles qt = {tr, tc, ny, nx};
  if (n <= 0 || !tiles_ok(qt)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_i8<__nv_bfloat16>(x5, wq, sw, b, m, x6, n, qt, s)
                    : launch_i8<float>(x5, wq, sw, b, m, x6, n, qt, s));
}

// B5: y6 [n, H5-2, W5-2, 128] from x5 [n, H5, W5, 128], the transformed
// weights u [16][128][128] (storage type) and the bias b [128] f32.
int w2x_l6_wino(int bf16, const void* x5, const void* u, const void* b,
                void* y6, int n, int H5, int W5, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_wino<__nv_bfloat16>(x5, u, b, y6, n, H5, W5, s)
                    : launch_wino<float>(x5, u, b, y6, n, H5, W5, s));
}

// Layer 7 with one thread per s2d cell, from a tile-major layer-6
// activation [n, ny, nx, 2tr+2, 2tc+2, 128]: out_mode, uvp, cmap and
// dense_tc as in stack.cu's w2x_stack_layer, out_mode 3: the same-cell
// tap partials [n, hl, wl, 4] in the storage type (B7, k = 6), and out_mode
// 4: the unfolded tap partials of phase (0, 0), taps 0-3 (common.cuh,
// OUT_PTAPS). With tr == 0 the activation is one plane
// [n, 2hl+2, 2wl+2, 128] and out_mode must be 3 or 4.
int w2x_last_cell(int bf16, const void* x, const void* w, const void* b,
                  void* y, int n, int hl, int wl, int out_mode,
                  const void* uvp, const float* cmap, int dense_tc, int tr,
                  int tc, int ny, int nx, void* stream) {
  if (n <= 0 || hl <= 0 || wl <= 0) return (int)cudaErrorInvalidValue;
  LastOut out = {};
  out.mode = out_mode;
  out.uvp = static_cast<const float*>(uvp);
  out.tc = dense_tc;
  if (out_mode == OUT_U8) {
    if (cmap == nullptr) return (int)cudaErrorInvalidValue;
    out.cm = color_map(cmap);
  }
  const Tiles qt = {tr, tc, ny, nx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tr > 0)
    return (int)(bf16 ? launch_last<__nv_bfloat16>(x, w, b, y, out, qt, n, hl,
                                                   wl, s)
                      : launch_last<float>(x, w, b, y, out, qt, n, hl, wl, s));
  // from one plane, stack.cu's layer 7 writes every form but the taps
  if (out_mode == OUT_TAPS)
    return (int)(bf16 ? launch_last_cell<C6, __nv_bfloat16, OUT_TAPS, false>(
                            x, w, b, y, out, qt, n, hl, wl, s)
                      : launch_last_cell<C6, float, OUT_TAPS, false>(
                            x, w, b, y, out, qt, n, hl, wl, s));
  if (out_mode == OUT_PTAPS)
    return (int)(bf16 ? launch_last_cell<C6, __nv_bfloat16, OUT_PTAPS, false>(
                            x, w, b, y, out, qt, n, hl, wl, s)
                      : launch_last_cell<C6, float, OUT_PTAPS, false>(
                            x, w, b, y, out, qt, n, hl, wl, s));
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
