// The four-tap 128 -> 128 probe layer on Hopper's tensor cores (sm_90a), in
// two layouts: channels in the fast dimension (chlane) and positions in the
// fast dimension (poslane). Built with nvcc into a shared library with a
// plain C interface and loaded with ctypes (waifu2x_torch/ops/_build.py); the
// Python wrapper tap_mm, its plain version and the launch count are in
// waifu2x_torch/ops/probe.py, the entry point waifu2x_torch/tools/tmm_probe.py.
//
// Replaces: tools/tmm_probe.py:79 (cch, body_ch) and :122 (cpos, body_pos),
// the probe that asks what a 128-channel tap product costs with channels in
// the lanes against positions in the lanes.
//
// What it computes, on a grid of (ny, nx) cells of (tr, tc) outputs a
// batch image, each cell reading the disjoint (tr+8, tc+16) block of the
// input at row i(tr+8), column j(tc+16) (the JAX BlockSpecs):
//   out[n, i tr + y, j tc + x, co] = sum over t = 0..3 and ci of
//       in[n, i(tr+8) + y + t, j(tc+16) + x + t, ci] * w[t, ci, co]
// bf16 x bf16 products (exact in f32), f32 sums, one rounding to bf16.
//   chlane: in [B, R, C, 128], out [B, ny tr, nx tc, 128]
//   poslane: in [B, R, 128, C], out [B, ny tr, 128, nx tc]
// The JAX body computes tc + 8 columns and stores tc; this kernel computes
// what it stores.
//
// Design: a block computes 2 output rows x 128 positions x 128 channels
// with four warpgroups, one m64n128 accumulator each (64 f32 registers a
// thread), over K = 4 taps x 128 input channels in chunks of 32 channels
// through two shared-memory buffers: the next chunk is staged while the
// tensor cores multiply this one. The weights come packed as
// [ci/8][tap][co][8] (ops/probe.py:pack_tap_mm), a chunk one contiguous
// 32 KB run.
//   chlane  D[pos, co] = X[pos, ci] W[ci, co]: A is the activation, K-major,
//           staged once per chunk as [k8][window row][window col][8 ch]
//           (5 rows x 136 columns), so that tap t's operand is the staged
//           window moved by t rows and t columns, one descriptor offset (as
//           in mma.cu); B is the weights, K-major. Global -> shared with
//           cp.async.
//   poslane D[co, pos] = W^T[co, ci] X[ci, pos]: A is the weights, K-major
//           (the same packed run serves); B is the activation, MN-major:
//           its core matrices are 8 channels x 8 consecutive positions, read
//           with wgmma's transpose bit (mma.cuh: mma_k16<128, 1>). A tap
//           shifts the positions by t, which no descriptor can do inside a
//           16-byte row, so each tap's shifted rows are staged apart: two
//           aligned 16-byte loads and a funnel shift per 8 positions, 8
//           copies of a row where chlane stages 5 rows for all four taps.
//           The 8-position groups sit 144 bytes apart (SBO), not 128, so that
//           a quarter-warp's stores fall into 8 different bank groups.
//   The epilogue rounds the sums to bf16 into a padded shared tile and
//   stores 16-byte vectors along the output's fast dimension (channels for
//   chlane, positions for poslane).
//
// What bounds it on an H100: the bytes. At the JAX tool's grid (B = 16, 8 x 4
// cells of 64 x 128) the taps read 67 x 131 positions of each cell's block,
// 1.150 GB, and the output is 1.074 GB: 0.664 ms at 3.35 TB/s, against
// 0.550 TFLOP = 0.556 ms at the 989 TFLOP/s bf16 peak; the same for both
// layouts. A block reads its
// window's 5 rows for 2 output rows (2.5x the input it owns, mostly from L2)
// and its 128 KB of weights from L2. A persistent grid, weights resident and
// more rows a block are left to later work.

#include <limits.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TM_THREADS = 512;            // four warpgroups
constexpr int RB = 2;                      // output rows a block
constexpr int NP = 128;                    // output positions a row
constexpr int CH = 128;                    // channels in and out
constexpr int TAPS = 4;
constexpr int KC = 32;                     // input channels a chunk
constexpr int K8C = KC / 8;
constexpr int NCHUNK = CH / KC;
constexpr uint32_t W_BYTES = K8C * TAPS * CH * 16;   // a chunk's weights

// chlane: the window [k8][row][col][8], its k8 stride padded to 2 mod 8
// (16-byte units) so that the 8 cp.async pieces of a quarter-warp (4 k8 x 2
// pixels) fall into 8 bank groups
constexpr int CL_ROWS = RB + TAPS - 1;     // 5
constexpr int CL_COLS = NP + 8;            // 136 staged, NP + 3 read
constexpr int CL_S = CL_ROWS * CL_COLS + (2 - (CL_ROWS * CL_COLS) % 8 + 8) % 8;
constexpr uint32_t CL_WIN = K8C * CL_S * 16;

// poslane: per (tap, row) [k8][pos8 group][ch % 8][pos % 8], groups PL_G
// units apart
constexpr int PL_G = 9;
constexpr int PL_K8 = (NP / 8) * PL_G;     // 144 units
constexpr uint32_t PL_PIECE = K8C * PL_K8 * 16;
constexpr uint32_t PL_WIN = TAPS * RB * PL_PIECE;

constexpr int PITCH = CH * 2 + 16;         // epilogue tile row, bytes
constexpr uint32_t EPI_BYTES = RB * NP * PITCH;

template <int POSLANE>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (POSLANE ? PL_WIN : CL_WIN) + W_BYTES;
}
template <int POSLANE>
__host__ __device__ constexpr uint32_t smem_bytes() {
  return 2 * stage_bytes<POSLANE>() > EPI_BYTES ? 2 * stage_bytes<POSLANE>()
                                                : EPI_BYTES;
}

// 8 bf16 starting t elements into the 16 held by a (first 8) and b (next 8)
__device__ __forceinline__ uint4 shift_bf16x8(uint4 a, uint4 b, int t) {
  const uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t o[4];
  const int q = t >> 1;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = (t & 1) ? __funnelshift_r(u[k + q], u[k + q + 1], 16) : u[k + q];
  return make_uint4(o[0], o[1], o[2], o[3]);
}

struct Geo {
  int rows, cols;        // the input's rows and columns an image
  int ny, nx, tr, tc;    // the cell grid
  int nrp, nseg;         // row pairs and 128-position segments a cell
};

// Grid: one block per (image, cell row, cell column, row pair, segment).
template <int POSLANE>
__global__ void __launch_bounds__(TM_THREADS, 1)
tap_mm(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
       __nv_bfloat16* __restrict__ out, Geo g) {
  constexpr uint32_t STAGE = stage_bytes<POSLANE>();
  constexpr uint32_t WIN = POSLANE ? PL_WIN : CL_WIN;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);

  unsigned bid = blockIdx.x;
  const int seg = bid % g.nseg;  bid /= g.nseg;
  const int rp = bid % g.nrp;    bid /= g.nrp;
  const int j = bid % g.nx;      bid /= g.nx;
  const int i = bid % g.ny;      bid /= g.ny;
  const int n = bid;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int row0 = i * (g.tr + 8) + RB * rp;   // the block's first input row
  const int col0 = j * (g.tc + 16) + seg * NP;  // and column

  auto stage = [&](int c, int buf) {
    const uint32_t sw = sbase + buf * STAGE;
    const uint4* wsrc =
        reinterpret_cast<const uint4*>(wp) + (size_t)c * (W_BYTES / 16);
    for (int k = tid; k < (int)(W_BYTES / 16); k += TM_THREADS)
      cp_async16(sw + WIN + k * 16, wsrc + k, true);
    if constexpr (!POSLANE) {
      for (int k = tid; k < K8C * CL_ROWS * CL_COLS; k += TM_THREADS) {
        const int k8 = k % K8C, p = k / K8C;
        const int wr = p / CL_COLS, wc = p % CL_COLS;
        const __nv_bfloat16* src =
            x + (((size_t)n * g.rows + row0 + wr) * g.cols + col0 + wc) * CH +
            c * KC + k8 * 8;
        cp_async16(sw + (k8 * CL_S + wr * CL_COLS + wc) * 16, src, true);
      }
    } else {
      // tap t, output row r: input row row0 + r + t, positions shifted by t
#pragma unroll
      for (int it = 0; it < TAPS * RB; ++it) {
        const int t = it / RB, r = it % RB;
        for (int k = tid; k < KC * (NP / 8); k += TM_THREADS) {
          const int grp = k % (NP / 8), ch = k / (NP / 8);
          const uint4* src = reinterpret_cast<const uint4*>(
              x + (((size_t)n * g.rows + row0 + r + t) * CH + c * KC + ch) *
                      g.cols + col0 + 8 * grp);
          const uint4 v = shift_bf16x8(__ldg(src), __ldg(src + 1), t);
          *reinterpret_cast<uint4*>(
              smem + buf * STAGE + it * PL_PIECE +
              ((ch >> 3) * PL_K8 + grp * PL_G + (ch & 7)) * 16) = v;
        }
      }
    }
    cp_async_commit();
  };

  float acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.0f;

  // K-major weights (B of chlane, A of poslane): LBO 8 input channels on,
  // SBO 8 output channels on
  constexpr uint64_t w_str = desc_strides(TAPS * CH * 16, 128);
  // chlane A: LBO the window's k8 stride, SBO 8 positions of a row on.
  // poslane B (MN-major): LBO 8 channels on, SBO 8 positions on
  constexpr uint64_t x_str = POSLANE ? desc_strides(PL_K8 * 16, PL_G * 16)
                                     : desc_strides(CL_S * 16, 128);
  const int r = wg >> 1;     // the warpgroup's output row of the two
  const int half = wg & 1;   // its half: chlane positions, poslane co

  stage(0, 0);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  for (int c = 0; c < NCHUNK; ++c) {
    const uint32_t sw = sbase + (c & 1) * STAGE;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        const uint32_t wa = sw + WIN + ((2 * ks * TAPS + t) * CH) * 16;
        if constexpr (!POSLANE) {
          const uint32_t a = sw + (2 * ks * CL_S + (r + t) * CL_COLS +
                                   64 * half + t) * 16;
          mma_k16<128>(acc, x_str | desc_addr(a), w_str | desc_addr(wa));
        } else {
          const uint32_t b = sw + (t * RB + r) * PL_PIECE + 2 * ks * PL_K8 * 16;
          mma_k16<128, 1>(acc, w_str | desc_addr(wa + 64 * half * 16),
                          x_str | desc_addr(b));
        }
      }
    }
    wgmma_commit();
    if (c + 1 < NCHUNK) stage(c + 1, (c + 1) & 1);  // while the products run
    cp_async_wait<0>();
    wgmma_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }

  // epilogue: the sums rounded to bf16 into a padded tile, then 16-byte
  // stores along the output's fast dimension. Fragment of thread (warp w4,
  // lane l): rows 16 w4 + l/4 (+ 8), columns 8 jj + 2 (l % 4) + {0, 1}.
  {
    const int lane = tid & 31, w4 = (tid >> 5) & 3;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fr = 64 * half + 16 * w4 + (lane >> 2) + 8 * h;  // row
        const int fc = 8 * jj + 2 * (lane & 3);                    // column
        // chlane: tile [row r][position fr][co fc]; poslane: [r][co fr][pos fc]
        *reinterpret_cast<__nv_bfloat162*>(
            smem + (r * NP + fr) * PITCH + fc * 2) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const int oy0 = i * g.tr + RB * rp, ox0 = j * g.tc + seg * NP;
  const size_t ow = (size_t)g.nx * g.tc, oh = (size_t)g.ny * g.tr;
  for (int k = tid; k < RB * NP * 16; k += TM_THREADS) {
    const int v = k % 16, q = (k / 16) % NP, rr = k / (16 * NP);
    const uint4 val = *reinterpret_cast<const uint4*>(
        smem + (rr * NP + q) * PITCH + v * 16);
    size_t e;
    if constexpr (!POSLANE)   // q a position, v 8 channels
      e = (((size_t)n * oh + oy0 + rr) * ow + ox0 + q) * CH + v * 8;
    else                      // q a channel, v 8 positions
      e = (((size_t)n * oh + oy0 + rr) * CH + q) * ow + ox0 + v * 8;
    *reinterpret_cast<uint4*>(out + e) = val;
  }
}

template <int POSLANE>
cudaError_t launch(const void* x, const void* wp, void* out, int b,
                   const Geo& g, cudaStream_t s) {
  const long long blocks = (long long)b * g.ny * g.nx * g.nrp * g.nseg;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int need = (int)smem_bytes<POSLANE>();
  auto kernel = tap_mm<POSLANE>;
  // over 48 KB of dynamic shared memory is refused without this
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, TM_THREADS, need, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), static_cast<__nv_bfloat16*>(out),
      g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The four-tap layer on `stream`: layout 0 (chlane) or 1 (poslane); x the
// input of b images of `rows` x `cols` positions (chlane [b, rows, cols,
// 128], poslane [b, rows, 128, cols]), wp the packed weights
// [16][4][128][8] bf16, out as above for the (ny, nx) grid of (tr, tc)
// cells. tr must be even, tc a multiple of 128, cols a multiple of 8, the
// cells' blocks inside the input (ny (tr+8) <= rows, nx (tc+16) <= cols) and
// the pointers 16-byte aligned. Returns the cudaError_t of the launch.
int w2x_tap_mm(int layout, const void* x, const void* wp, void* out, int b,
               int rows, int cols, int ny, int nx, int tr, int tc,
               void* stream) {
  if ((layout != 0 && layout != 1) || b <= 0 || ny <= 0 || nx <= 0 ||
      tr <= 0 || tr % RB || tc <= 0 || tc % NP || cols % 8 ||
      (long long)ny * (tr + 8) > rows || (long long)nx * (tc + 16) > cols ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wp) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  const Geo g = {rows, cols, ny, nx, tr, tc, tr / RB, tc / NP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(layout ? launch<1>(x, wp, out, b, g, s)
                      : launch<0>(x, wp, out, b, g, s));
}

const char* w2x_tmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
