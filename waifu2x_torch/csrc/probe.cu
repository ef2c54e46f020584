// Hand-written Hopper (sm_90a) kernels for the data-movement probes: the
// counterparts of 15 pl.pallas_call sites under the root tools/ (PERF.md
// §6), as four kernels. Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (waifu2x_torch/ops/_build.py); the Python
// wrappers and their plain PyTorch versions are in waifu2x_torch/ops/probe.py,
// the entry points in waifu2x_torch/tools/{stage_time,grid_floor_probe,
// dma_probe,fused_strip_probe,l14_probe}.py.
//
// Replaces (15 sites, PERF.md §6):
//   probe_store         tools/stage_time.py:82 (c4), :95 (cd), :113 (mkout:
//                       out4f32, out16f32, out16u8); grid_floor_probe.py:100
//                       store-only; dma_probe2.py:50 out4, out128, out2d
//   probe_fetch_map     dma_probe.py:55 (lane16_x4, lane16_x1, lane128,
//                       lane128_x4), :157 (raw2d); dma_probe2.py:50
//                       (in16+o128, in128+o128, raw+o128, in16+o16c);
//                       dma_probe3.py:54 (y4, y512r, y512n, u8_16,
//                       u8_2048r); stage_time.py:203 (ccat);
//                       grid_floor_probe.py:100 1-fetch;
//                       fused_strip_probe.py:134 (oneblk); l14_probe.py:145
//                       (xonly)
//   probe_fetch_reduce  stage_time.py:172 (cin1), :187 (cin4), :220 (cin9);
//                       grid_floor_probe.py:100 4-fetch
//   probe_l1_mm         stage_time.py:241 (cin9mm)
//
// Every probe runs the JAX tool's grid of cells (n, i, j) and computes what
// its body computes. A probe's product is its traffic, so each block that a
// BlockSpec names is read from device memory whole, once per cell at least,
// even where the body uses a corner of it, and every output block is
// written whole. Blocks are [rows, cols, lanes] boxes of an NHWC array (a
// plane has one lane) whose origin in cell (n, i, j) is row i*ra + rb,
// column j*ca + cb (struct In); an output block is `rows` runs of `run`
// elements, one per row of a [b, ny*rows, nx*run] array (struct Out). The
// reads whose values are not used are folded (xor) into a word that each
// thread stores to `sink` where that is not null; the wrappers pass null,
// but the compiler cannot know it, so it cannot drop a load.
//
// Bound by bytes, but for probe_l1_mm: the others do a few operations per
// byte; probe_l1_mm does 18 f32 FLOP per output channel of a pixel, 0.14 ms
// of FFMA at 16 x 512^2 against its bytes' 0.03 ms. Design: 16-byte loads and
// stores, neighbouring threads on neighbouring addresses; probe_store as
// one store a thread over the whole output (see there); probe_fetch_map's
// hot forms (one block, no repeat) compiled for their lanes, type and map:
// lane-inner outputs with no shared memory (probe_map_direct), planar ones
// through a padded shared-memory transpose fed by cp.async
// (probe_map_planar); the others ROWS rows of a cell per CUDA block
// (several blocks per cell, so that a 128-cell grid still fills 132 SMs),
// the rows staged through shared memory where the output is a map of the
// input (a (64, 128, 16) bf16 block is 256 KB, over a block's 227 KB).
// probe_fetch_reduce's lane-0 sums (grid_floor's 4-fetch) need three whole
// blocks before the first output: one CUDA block per cell, summing in a
// fixed order, so the result does not vary from run to run. f32 maps use
// __fmul_rn / __fadd_rn, never fmaf, so the plain version computes the same
// values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma.cuh"   // cp.async

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;      // output rows per CUDA block (row-split kernels)

enum { DT_BF16 = 0, DT_F32 = 1, DT_U8 = 2 };
enum { FORM_LANES = 0, FORM_PLANAR = 1 };
enum {
  MAP_COPY = 0,     // x
  MAP_HALF = 1,     // x * 0.5
  MAP_AFFINE = 2,   // x * 0.5 + 1
  MAP_ZERO = 3,     // x * 0
  MAP_U8 = 4,       // u8(clip(rint(x * 255), 0, 255))
  MAP_U8_ZERO = 5,  // u8(int32(x * 0))
  MAP_CONST0 = 6,   // 0, the block fetched all the same
  MAP_LANE0 = 7,    // x at lane 0, whatever the output lane
};
enum { RED_CORNER_MAX = 0, RED_LANE0_SUM = 1 };

// One input block (bf16 elements) as a BlockSpec names it.
struct In {
  const uint4* p;
  long long h, w;   // the array's rows and columns
  int lanes, rows, cols, ra, rb, ca, cb;

  __device__ int row_vecs() const { return cols * lanes / 8; }
  __device__ const uint4* row(int n, int i, int j, int r) const {
    const long long e = ((n * h + (long long)i * ra + rb + r) * w +
                         (long long)j * ca + cb) * lanes;
    return p + e / 8;
  }
};

// One output block: `rows` runs of `run` elements per cell.
struct Out {
  uint4* p;
  int dtype, esize, rows;
  long long run, pitch, image;   // elements: a block row, an array row, an image
  int ny, nx;

  __device__ int row_vecs() const { return (int)(run * esize / 16); }
  __device__ uint4* row(int n, int i, int j, int r) const {
    const long long e = n * image + ((long long)i * rows + r) * pitch +
                        (long long)j * run;
    return p + e * esize / 16;
  }
};

__device__ __forceinline__ void cell_of(int c, const Out& o, int& n, int& i,
                                        int& j) {
  n = c / (o.ny * o.nx);
  i = (c / o.nx) % o.ny;
  j = c % o.nx;
}

// Rows [r0, r0 + nr) of block b in cell (n, i, j), whole, into s.
__device__ void stage(const In& b, int n, int i, int j, int r0, int nr,
                      uint4* s) {
  const int q = b.row_vecs();
  for (int t = threadIdx.x; t < nr * q; t += blockDim.x)
    s[t] = b.row(n, i, j, r0 + t / q)[t % q];
}

__device__ __forceinline__ uint32_t fold(uint4 v) {
  return v.x ^ v.y ^ v.z ^ v.w;
}

// The same rows read for their traffic alone (the fetch that the BlockSpec
// makes) -> their fold.
__device__ uint32_t touch(const In& b, int n, int i, int j, int r0, int nr) {
  const int q = b.row_vecs();
  uint32_t f = 0;
#pragma unroll 8
  for (int t = threadIdx.x; t < nr * q; t += blockDim.x)
    f ^= fold(b.row(n, i, j, r0 + t / q)[t % q]);
  return f;
}

// Rows [first, rows) of a short block (the 8-row lower stripes), shared
// out among the cell's `splits` CUDA blocks -> the fold of this one's share.
__device__ uint32_t touch_share(const In& b, int n, int i, int j, int first,
                                int part, int splits) {
  const int per = (b.rows - first + splits - 1) / splits;
  const int lo = first + part * per;
  const int nr = min(per, b.rows - lo);
  return nr > 0 ? touch(b, n, i, j, lo, nr) : 0u;
}

__device__ __forceinline__ void keep(uint32_t f, uint32_t* sink) {
  if (sink != nullptr) sink[blockIdx.x * blockDim.x + threadIdx.x] = f;
}

__device__ __forceinline__ float bf(const uint4* s, int idx) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(s)[idx]);
}

__device__ __forceinline__ uint32_t bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 16 bytes of output: element e of the chunk is f(e), a float that for u8
// output holds the byte's value (0..255).
template <typename F>
__device__ __forceinline__ uint4 pack(int dtype, F f) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (dtype == DT_BF16) {
      w[k] = bf_bits(f(2 * k)) | (bf_bits(f(2 * k + 1)) << 16);
    } else if (dtype == DT_F32) {
      w[k] = __float_as_uint(f(k));
    } else {
      w[k] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        w[k] |= ((uint32_t)(int)f(4 * k + b) & 0xffu) << (8 * b);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float apply(int op, float v) {
  switch (op) {
    case MAP_HALF: return __fmul_rn(v, 0.5f);
    case MAP_AFFINE: return __fadd_rn(__fmul_rn(v, 0.5f), 1.0f);
    case MAP_ZERO: return __fmul_rn(v, 0.0f);
    case MAP_U8:
      return fminf(fmaxf(rintf(__fmul_rn(v, 255.0f)), 0.0f), 255.0f);
    case MAP_U8_ZERO: return (float)((int)__fmul_rn(v, 0.0f) & 0xff);
    case MAP_CONST0: return 0.0f;
    default: return v;
  }
}

// The sum of v over the CUDA block, in a fixed order; every thread gets
// the result. red[] holds a float per warp.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, d));
  __syncthreads();   // red[] may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
    r = __fadd_rn(r, red[k]);
  return r;
}

// ---------------------------------------------------------------------------
// probe_store: a constant (value, or 0 + seed[0] where a seed block is
// given) written to every output block; the (1, 8, 128) f32 seed block is
// read whole once per cell. The output blocks tile the output array
// exactly, so writing every block whole is writing the array: thread k
// stores the array's 16-byte vector k, with no division per block, and the
// cells' seed reads (cells x seed_vecs vectors, the one seed block again
// for each cell) are shared out over the same threads. (On an H100 one
// store a thread over a grid as large as the output beat 2, 4 and 8 stores
// a thread from grids of a few waves, as fill_ does.)

struct StoreArgs {
  uint4* out;
  long long vecs;         // the output's 16-byte vectors
  const uint4* seed;
  int seed_vecs;          // a power of two
  long long seed_reads;   // cells * seed_vecs
  int dtype;
  float value;
  uint32_t* sink;
};

__global__ void __launch_bounds__(THREADS) probe_store(StoreArgs a) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  float v = a.value;
  if (a.seed != nullptr) {
    uint32_t f = 0;
    for (long long k = t0; k < a.seed_reads; k += stride)
      f ^= fold(a.seed[k & (a.seed_vecs - 1)]);
    keep(f, a.sink);
    v = __fadd_rn(0.0f, reinterpret_cast<const float*>(a.seed)[0]);
    if (a.dtype == DT_U8) v = (float)((int)v & 0xff);
  }
  const uint4 pat = pack(a.dtype, [&](int) { return v; });
  if (t0 < a.vecs) a.out[t0] = pat;
}

// ---------------------------------------------------------------------------
// probe_fetch_map: out[r, x, c] = map(t[r, x / rep, c]) with
//   t = a                          (one block), or
//   t = ((a + b[r, 0]) + c[0, x]) + d[0, 0]   (the tile and its right,
//                                  lower and diagonal stripes),
// the source lane c (0 for a plane and for MAP_LANE0); the output row holds
// (x, c) lane-inner (x * lg + c) or planar (c * xg + x).
struct MapArgs {
  In in[4];
  int nin;
  Out out;
  int form, op;
  int lg, xg, rep;   // as log2: all three are powers of two
  uint32_t* sink;
};

__global__ void __launch_bounds__(THREADS) probe_fetch_map(MapArgs a) {
  extern __shared__ uint4 smem[];
  const int splits = a.out.rows / ROWS;
  int n, i, j;
  cell_of(blockIdx.x / splits, a.out, n, i, j);
  const int r0 = (blockIdx.x % splits) * ROWS;
  const bool stripes = a.nin == 4;
  uint4* sa = smem;
  uint4* sb = sa + ROWS * a.in[0].row_vecs();
  uint4* sc = sb + (stripes ? ROWS * a.in[1].row_vecs() : 0);
  uint4* sd = sc + (stripes ? a.in[2].row_vecs() : 0);
  stage(a.in[0], n, i, j, r0, ROWS, sa);
  if (stripes) {
    stage(a.in[1], n, i, j, r0, ROWS, sb);   // rows align with the tile's
    stage(a.in[2], n, i, j, 0, 1, sc);       // the body reads row 0
    stage(a.in[3], n, i, j, 0, 1, sd);
    const int part = blockIdx.x % splits;    // the rest of the two blocks
    keep(touch_share(a.in[2], n, i, j, 1, part, splits) ^
             touch_share(a.in[3], n, i, j, 1, part, splits),
         a.sink);
  }
  __syncthreads();
  const int la = a.in[0].lanes, ca = a.in[0].cols;
  const int E = 16 / a.out.esize, q = a.out.row_vecs();
  for (int t = threadIdx.x; t < ROWS * q; t += blockDim.x) {
    const int r = t / q, k = t % q;
    const uint4 v = pack(a.out.dtype, [&](int e) {
      const int qq = k * E + e;
      int x, c;
      if (a.form == FORM_LANES) {
        x = qq >> a.lg;
        c = qq & ((1 << a.lg) - 1);
      } else {
        c = qq >> a.xg;
        x = qq & ((1 << a.xg) - 1);
      }
      if (a.op == MAP_CONST0) return 0.0f;
      const int xs = x >> a.rep;
      const int lane = la > 1 && a.op != MAP_LANE0 ? c : 0;
      float s = bf(sa, (r * ca + xs) * la + lane);
      if (stripes) {
        s = __fadd_rn(s, bf(sb, r * a.in[1].cols * la + lane));
        s = __fadd_rn(s, bf(sc, xs * la + lane));
        s = __fadd_rn(s, bf(sd, lane));
      }
      return apply(a.op, s);
    });
    a.out.row(n, i, j, r0 + r)[k] = v;
  }
}

// ---------------------------------------------------------------------------
// probe_fetch_map's hot forms, compiled for their lanes, type and map (the
// map's single-block, rep-1 forms whose output row holds every pixel of the
// block row; probe_fetch_map above takes the rest):
//
// probe_map_direct<LA, LG, DT, OP>, output lane-inner: output pixel x takes
// input pixel x, its lanes 0..LG-1 (lane 0 in all of them where LA is 1 or
// the map is MAP_LANE0). The output keeps the input's pixel order, so no
// shared memory: a thread loads the G pixels that make its whole 16-byte
// output vectors (NL 16-byte loads of 16-byte-aligned input) and stores
// them (NS stores), neighbouring threads on neighbouring addresses. Every
// loaded word is folded into the sink word, so no load can be dropped.
// One CUDA block is THREADS consecutive (row, pixel group) items of a cell.
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

template <int LA, int LG, int DT>
struct DirectGeo {
  static constexpr int ES = DT == DT_U8 ? 1 : 2;   // output element bytes
  static constexpr int IN_PX = 2 * LA, OUT_PX = LG * ES;
  static constexpr int G = imax(IN_PX >= 16 ? 1 : 16 / IN_PX,
                                OUT_PX >= 16 ? 1 : 16 / OUT_PX);
  static constexpr int NL = G * IN_PX / 16, NS = G * OUT_PX / 16;
};

template <int LA, int LG, int DT, int OP>
__global__ void __launch_bounds__(THREADS) probe_map_direct(MapArgs a) {
  using D = DirectGeo<LA, LG, DT>;
  static_assert(D::NL >= 1 && D::NS >= 1 && (LA == 1 || LG <= LA),
                "whole vectors in and out, lanes from the input's");
  const In& b = a.in[0];
  const int gpr = b.cols / D::G;                  // pixel groups a row
  const int per_cell = a.out.rows * gpr / THREADS;
  int n, i, j;
  cell_of(blockIdx.x / per_cell, a.out, n, i, j);
  const int item = (blockIdx.x % per_cell) * THREADS + threadIdx.x;
  const int r = item / gpr, g = item % gpr;
  const uint4* src = b.row(n, i, j, r) + g * D::NL;
  uint32_t w[4 * D::NL];
  uint32_t f = 0;
#pragma unroll
  for (int k = 0; k < D::NL; ++k) {
    const uint4 v = src[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
    f ^= fold(v);
  }
  keep(f, a.sink);
  uint32_t o[4 * D::NS];
#pragma unroll
  for (int k = 0; k < 4 * D::NS; ++k) o[k] = 0;
#pragma unroll
  for (int px = 0; px < D::G; ++px) {
#pragma unroll
    for (int c = 0; c < LG; ++c) {
      const int e = px * LA + (LA > 1 && OP != MAP_LANE0 ? c : 0);
      const uint32_t bits = (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
      const int oe = px * LG + c;
      if constexpr (DT == DT_BF16) {
        const uint32_t ob =
            OP == MAP_COPY || OP == MAP_LANE0
                ? bits : bf_bits(apply(OP, __uint_as_float(bits << 16)));
        o[oe >> 1] |= ob << (16 * (oe & 1));
      } else {
        const uint32_t ob =
            (uint32_t)(int)apply(OP, __uint_as_float(bits << 16)) & 0xffu;
        o[oe >> 2] |= ob << (8 * (oe & 3));
      }
    }
  }
  uint4* dst = a.out.row(n, i, j, r) + g * D::NS;
#pragma unroll
  for (int k = 0; k < D::NS; ++k)
    dst[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
}

// probe_map_planar<OP>, 16 input lanes, output planar (lanes 0-3, bf16):
// out[r, c * cols + x] = OP(t[r, x, c]). Lanes leave the pixel order, so a
// padded shared-memory transpose: PLANAR_ROWS rows of the block are staged
// whole by cp.async (every fetched byte lands in shared memory, so none can
// be dropped), each 8-pixel group 16 bytes past 256 so that the 8 16-byte
// reads of a quarter-warp fall into 8 bank groups; then a thread reads
// lanes 0-7 of 8 pixels and stores their lanes 0-3 as 4 vectors. Several
// blocks an SM, so one block's copies run while another maps.
constexpr int PLANAR_ROWS = 8;
constexpr int PLANAR_THREADS = 128;
constexpr int PLANAR_GROUP = 8 * 32 + 16;   // bytes of a staged pixel group

template <int OP>
__global__ void __launch_bounds__(PLANAR_THREADS)
probe_map_planar(MapArgs a) {
  extern __shared__ __align__(16) uint8_t sm[];
  const In& b = a.in[0];
  const int splits = a.out.rows / PLANAR_ROWS;
  int n, i, j;
  cell_of(blockIdx.x / splits, a.out, n, i, j);
  const int r0 = (blockIdx.x % splits) * PLANAR_ROWS;
  const int gpr = b.cols / 8, rowb = gpr * PLANAR_GROUP, q = 2 * b.cols;
  const uint32_t s0 = smem_addr(sm);
  for (int t = threadIdx.x; t < PLANAR_ROWS * q; t += PLANAR_THREADS) {
    const int r = t / q, v = t % q, p = v >> 1;
    cp_async16(s0 + r * rowb + (p >> 3) * PLANAR_GROUP + (p & 7) * 32 +
                   (v & 1) * 16,
               b.row(n, i, j, r0 + r) + v, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int t = threadIdx.x; t < PLANAR_ROWS * gpr; t += PLANAR_THREADS) {
    const int r = t / gpr, g = t % gpr;
    uint32_t o[4][4] = {};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          sm + r * rowb + g * PLANAR_GROUP + m * 32);
      const uint32_t lanes[4] = {v.x & 0xffffu, v.x >> 16, v.y & 0xffffu,
                                 v.y >> 16};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = __uint_as_float(lanes[c] << 16);
        const uint32_t ob = OP == MAP_COPY ? lanes[c] : bf_bits(apply(OP, x));
        o[c][m >> 1] |= ob << (16 * (m & 1));
      }
    }
    uint4* dst = a.out.row(n, i, j, r0 + r);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dst[c * gpr + g] = make_uint4(o[c][0], o[c][1], o[c][2], o[c][3]);
  }
}

// ---------------------------------------------------------------------------
// probe_fetch_reduce:
//   RED_CORNER_MAX: t = sum over the blocks (in order) of the max over the
//     block's [0:8, 0:8, :] corner; every output element = bf16(0 + t).
//   RED_LANE0_SUM: s = ((0 + S1) + S2) + S3, S_k the sum of lane 0 over all
//     of block k; out[r, x, c] = bf16(a[r, x, c] + s), c < lg. One CUDA
//     block per cell (splits 1).
struct RedArgs {
  In in[4];
  int nin;
  Out out;
  int op, lg;
  uint32_t* sink;
};

__global__ void __launch_bounds__(THREADS) probe_fetch_reduce(RedArgs a) {
  extern __shared__ uint4 smem[];
  __shared__ float red[THREADS / 32];
  const bool sum_op = a.op == RED_LANE0_SUM;
  const int splits = sum_op ? 1 : a.out.rows / ROWS;
  int n, i, j;
  cell_of(blockIdx.x / splits, a.out, n, i, j);
  const int r0 = (blockIdx.x % splits) * ROWS;
  const int q = a.out.row_vecs();

  if (!sum_op) {
    // each block whole: a full-height block by this CUDA block's rows, a
    // shorter one (the lower stripes) shared out among the cell's blocks
    // (their corner rows are read below)
    uint32_t f = 0;
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      m[k] = __int_as_float(0xff800000);   // -inf
      if (k >= a.nin) continue;
      const In& b = a.in[k];
      f ^= b.rows == a.out.rows
               ? touch(b, n, i, j, r0, ROWS)
               : touch_share(b, n, i, j, 0, blockIdx.x % splits, splits);
      const int per_row = 8 * b.lanes;
      for (int e = threadIdx.x; e < 8 * per_row; e += blockDim.x) {
        const __nv_bfloat16* row = reinterpret_cast<const __nv_bfloat16*>(
            b.row(n, i, j, e / per_row));
        m[k] = fmaxf(m[k], __bfloat162float(row[e % per_row]));
      }
    }
    keep(f, a.sink);
    // the corners' maxima, all in one pass over the warps
    __shared__ float red4[4][THREADS / 32];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], d));
      if ((threadIdx.x & 31) == 0) red4[k][threadIdx.x >> 5] = m[k];
    }
    __syncthreads();
    float t = 0.0f;
    for (int k = 0; k < a.nin; ++k) {
      float mk = red4[k][0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        mk = fmaxf(mk, red4[k][w]);
      t = k == 0 ? mk : __fadd_rn(t, mk);
    }
    const float v = __fadd_rn(0.0f, t);
    const uint4 pat = pack(a.out.dtype, [&](int) { return v; });
    for (int t2 = threadIdx.x; t2 < ROWS * q; t2 += blockDim.x)
      a.out.row(n, i, j, r0 + t2 / q)[t2 % q] = pat;
    return;
  }

  float s = 0.0f;
  for (int k = 1; k < a.nin; ++k) {
    const In& b = a.in[k];
    const int rq = b.row_vecs();
    float acc = 0.0f;
    const int lmask = b.lanes - 1;   // a power of two (checked)
    // a thread owns a column of 16-byte vectors (the same lanes in every
    // row) in one of `groups` interleaved sets of rows, and sums it down
    // the rows
    const int groups = max(1, (int)blockDim.x / rq);
    for (int t = threadIdx.x; t < rq * groups; t += blockDim.x) {
      const int col = t % rq;
#pragma unroll 8
      for (int r = t / rq; r < b.rows; r += groups) {
        const uint4 v = b.row(n, i, j, r)[col];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          if (((col * 8 + m) & lmask) == 0) {
            const uint32_t h = (w[m >> 1] >> (16 * (m & 1))) & 0xffffu;
            acc = __fadd_rn(acc, __uint_as_float(h << 16));
          }
        }
      }
    }
    s = __fadd_rn(s, block_sum(acc, red));
  }
  const In& A = a.in[0];
  const int la = A.lanes, ca = A.cols, E = 16 / a.out.esize;
  for (int rr = 0; rr < a.out.rows; rr += ROWS) {
    stage(A, n, i, j, rr, ROWS, smem);
    __syncthreads();
    for (int t = threadIdx.x; t < ROWS * q; t += blockDim.x) {
      const int r = t / q, k = t % q;
      a.out.row(n, i, j, rr + r)[k] = pack(a.out.dtype, [&](int e) {
        const int qq = k * E + e;
        return __fadd_rn(bf(smem, (r * ca + qq / a.lg) * la + qq % a.lg), s);
      });
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// probe_l1_mm: one row of a cell per CUDA block. The row's (tc, 9) bf16
// pixels times the (9, 128) bf16 weight, f32 sums, rounded to a bf16
// (tc, 128) scratch in shared memory; lanes 0-3 of the scratch written
// planar, out[r, c * tc + x] = scratch[x, c]. A warp owns a pixel at a time,
// a lane 4 of its 128 output channels, so the scratch stores are one
// contiguous 256-byte run a warp. K = 9 is no tensor-core product: FFMA (a
// bf16 x bf16 product is exact in f32, so fmaf rounds as a multiply and an
// add would).
__global__ void __launch_bounds__(THREADS) probe_l1_mm(In x, const uint4* w,
                                                      Out out) {
  extern __shared__ uint4 smem[];
  const int tr = out.rows, tc = x.cols;
  int n, i, j;
  cell_of(blockIdx.x / tr, out, n, i, j);
  const int r = blockIdx.x % tr;
  uint4* sx = smem;                            // tc * 9 bf16
  uint4* sw = sx + x.row_vecs();               // 9 * 128 bf16
  uint4* ss = sw + 9 * 128 / 8;                // tc * 128 bf16
  stage(x, n, i, j, r, 1, sx);
  for (int t = threadIdx.x; t < 9 * 128 / 8; t += blockDim.x)
    sw[t] = w[t];
  __syncthreads();
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(sx);
  const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(sw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float wr[9][4];   // this lane's 4 output channels of the weight
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      wr[k][m] = __bfloat162float(wb[k * 128 + 4 * lane + m]);
  for (int p = warp; p < tc; p += THREADS / 32) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float xv = __bfloat162float(xb[p * 9 + k]);
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = fmaf(xv, wr[k][m], acc[m]);
    }
    uint2 v;
    v.x = bf_bits(acc[0]) | (bf_bits(acc[1]) << 16);
    v.y = bf_bits(acc[2]) | (bf_bits(acc[3]) << 16);
    reinterpret_cast<uint2*>(ss)[p * 32 + lane] = v;
  }
  __syncthreads();
  const int q = out.row_vecs();
  for (int t = threadIdx.x; t < q; t += blockDim.x) {
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int qq = t * 8 + e;
      h[e] = reinterpret_cast<const uint16_t*>(ss)[(qq % tc) * 128 + qq / tc];
    }
    out.row(n, i, j, r)[t] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                                        h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
}

// ---------------------------------------------------------------------------
// Descriptors from the wrappers: an input block as 9 integers
// (h, w, lanes, rows, cols, ra, rb, ca, cb), an output block as 8
// (dtype, rows, run, pitch, image, batch, ny, nx).

// log2 of a power of two, else -1
int log2_of(int v) {
  if (v < 1 || (v & (v - 1))) return -1;
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

int esize_of(int dtype) {
  return dtype == DT_F32 ? 4 : dtype == DT_BF16 ? 2 : 1;
}

bool make_out(void* p, const long long* d, Out& o, int& cells) {
  o.p = static_cast<uint4*>(p);
  o.dtype = (int)d[0];
  o.esize = esize_of(o.dtype);
  o.rows = (int)d[1];
  o.run = d[2];
  o.pitch = d[3];
  o.image = d[4];
  o.ny = (int)d[6];
  o.nx = (int)d[7];
  cells = (int)(d[5] * d[6] * d[7]);
  return o.dtype >= 0 && o.dtype <= DT_U8 && o.rows % ROWS == 0 &&
         (o.run * o.esize) % 16 == 0 && (o.pitch * o.esize) % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(p) % 16) == 0 && cells > 0;
}

bool make_in(const void* p, const long long* d, In& b) {
  b.p = static_cast<const uint4*>(p);
  b.h = d[0];
  b.w = d[1];
  b.lanes = (int)d[2];
  b.rows = (int)d[3];
  b.cols = (int)d[4];
  b.ra = (int)d[5];
  b.rb = (int)d[6];
  b.ca = (int)d[7];
  b.cb = (int)d[8];
  // every block row starts on 16 bytes and is whole 16-byte vectors
  return (b.w * b.lanes) % 8 == 0 && ((long long)b.ca * b.lanes) % 8 == 0 &&
         ((long long)b.cb * b.lanes) % 8 == 0 && (b.cols * b.lanes) % 8 == 0 &&
         (reinterpret_cast<uintptr_t>(p) % 16) == 0 && b.rows >= 1;
}

cudaError_t launch_dyn(const void* fn, int blocks, size_t smem,
                       cudaStream_t s, void** args, int threads = THREADS) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, s);
}

// The compiled lane-inner map for (input lanes, output lanes, type, map),
// or null where probe_fetch_map takes the form.
const void* direct_map(int la, int lg, int dtype, int op) {
  if (la == 16 && lg == 4 && dtype == DT_BF16) {
    switch (op) {
      case MAP_COPY:
        return (const void*)probe_map_direct<16, 4, DT_BF16, MAP_COPY>;
      case MAP_HALF:
        return (const void*)probe_map_direct<16, 4, DT_BF16, MAP_HALF>;
      case MAP_AFFINE:
        return (const void*)probe_map_direct<16, 4, DT_BF16, MAP_AFFINE>;
      case MAP_LANE0:
        return (const void*)probe_map_direct<16, 4, DT_BF16, MAP_LANE0>;
      default: return nullptr;
    }
  }
  if (la == 1 && lg == 4 && dtype == DT_BF16 && op == MAP_COPY)
    return (const void*)probe_map_direct<1, 4, DT_BF16, MAP_COPY>;
  if (la == 16 && lg == 16 && dtype == DT_U8) {
    switch (op) {
      case MAP_U8:
        return (const void*)probe_map_direct<16, 16, DT_U8, MAP_U8>;
      case MAP_U8_ZERO:
        return (const void*)probe_map_direct<16, 16, DT_U8, MAP_U8_ZERO>;
      default: return nullptr;
    }
  }
  return nullptr;
}

// pixels a thread of probe_map_direct maps (DirectGeo::G)
int direct_group(int la, int lg, int dtype) {
  const int in_px = 2 * la, out_px = lg * esize_of(dtype);
  return imax(in_px >= 16 ? 1 : 16 / in_px, out_px >= 16 ? 1 : 16 / out_px);
}

}  // namespace

extern "C" {

// Every function launches on `stream` and returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a descriptor the kernel does not take).

int w2x_probe_store(void* out, const long long* od, const void* seed,
                    int seed_bytes, float value, void* stream) {
  Out o;
  int cells;
  StoreArgs a;
  a.seed_vecs = seed_bytes / 16;
  // the blocks must tile the array: rows of nx runs, images of ny * rows
  if (!make_out(out, od, o, cells) || o.pitch != o.nx * o.run ||
      o.image != o.ny * o.rows * o.pitch || seed_bytes % 16 != 0 ||
      (seed != nullptr && (reinterpret_cast<uintptr_t>(seed) % 16 != 0 ||
                           log2_of(a.seed_vecs) < 0)))
    return (int)cudaErrorInvalidValue;
  a.out = o.p;
  a.vecs = od[5] * o.image * o.esize / 16;
  a.seed = static_cast<const uint4*>(seed);
  a.seed_reads = seed == nullptr ? 0 : (long long)cells * a.seed_vecs;
  a.dtype = o.dtype;
  a.value = value;
  a.sink = nullptr;
  const long long blocks = (a.vecs + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  probe_store<<<(unsigned)blocks, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int w2x_probe_fetch_map(const void* const* ins, const long long* id, int nin,
                        void* out, const long long* od, int form, int lg,
                        int xg, int rep, int op, void* stream) {
  MapArgs a;
  int cells;
  if ((nin != 1 && nin != 4) || !make_out(out, od, a.out, cells) ||
      a.out.dtype == DT_F32 || log2_of(lg) < 0 || log2_of(xg) < 0 ||
      log2_of(rep) < 0 || (long long)lg * xg != a.out.run)
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  for (int k = 0; k < nin; ++k) {
    if (!make_in(ins[k], id + 9 * k, a.in[k]))
      return (int)cudaErrorInvalidValue;
    const size_t row = (size_t)a.in[k].cols * a.in[k].lanes * 2;
    smem += (k < 2 ? ROWS : 1) * row;
  }
  if (a.in[0].rows != a.out.rows || (nin == 4 && a.in[1].rows != a.out.rows))
    return (int)cudaErrorInvalidValue;
  a.nin = nin;
  a.form = form;
  a.lg = log2_of(lg);
  a.xg = log2_of(xg);
  a.rep = log2_of(rep);
  a.op = op;
  a.sink = nullptr;
  void* args[] = {&a};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the hot forms: one block, no repeat, every pixel of the block row out
  const In& b = a.in[0];
  if (nin == 1 && rep == 1 && xg == b.cols && op != MAP_CONST0) {
    const void* fn = form == FORM_LANES
        ? direct_map(b.lanes, lg, a.out.dtype, op) : nullptr;
    const int g = direct_group(b.lanes, lg, a.out.dtype);
    if (fn != nullptr && b.cols % g == 0 &&
        ((long long)a.out.rows * (b.cols / g)) % THREADS == 0)
      return (int)launch_dyn(fn, cells * (a.out.rows * (b.cols / g) /
                                          THREADS), 0, s, args);
    if (form == FORM_PLANAR && b.lanes == 16 && lg == 4 &&
        a.out.dtype == DT_BF16 && (op == MAP_COPY || op == MAP_HALF) &&
        a.out.rows % PLANAR_ROWS == 0 && b.cols % 8 == 0)
      return (int)launch_dyn(
          op == MAP_COPY ? (const void*)probe_map_planar<MAP_COPY>
                         : (const void*)probe_map_planar<MAP_HALF>,
          cells * (a.out.rows / PLANAR_ROWS),
          (size_t)PLANAR_ROWS * (b.cols / 8) * PLANAR_GROUP, s, args,
          PLANAR_THREADS);
  }
  return (int)launch_dyn(reinterpret_cast<const void*>(probe_fetch_map),
                         cells * (a.out.rows / ROWS), smem, s, args);
}

int w2x_probe_fetch_reduce(const void* const* ins, const long long* id,
                           int nin, void* out, const long long* od, int op,
                           int lg, void* stream) {
  RedArgs a;
  int cells;
  if (nin < 1 || nin > 4 || !make_out(out, od, a.out, cells) ||
      a.out.dtype != DT_BF16 || (op == RED_LANE0_SUM && nin != 4))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < nin; ++k)
    if (!make_in(ins[k], id + 9 * k, a.in[k]) || a.in[k].rows < 8 ||
        a.in[k].cols < 8)
      return (int)cudaErrorInvalidValue;
  if (op == RED_LANE0_SUM &&
      (a.in[0].rows != a.out.rows || a.out.run % lg != 0 ||
       log2_of(a.in[1].lanes) < 0 || log2_of(a.in[2].lanes) < 0 ||
       log2_of(a.in[3].lanes) < 0))
    return (int)cudaErrorInvalidValue;
  a.nin = nin;
  a.op = op;
  a.lg = lg;
  a.sink = nullptr;
  const size_t smem = op == RED_LANE0_SUM
      ? (size_t)ROWS * a.in[0].cols * a.in[0].lanes * 2 : 0;
  const int blocks = op == RED_LANE0_SUM ? cells
                                         : cells * (a.out.rows / ROWS);
  void* args[] = {&a};
  return (int)launch_dyn(reinterpret_cast<const void*>(probe_fetch_reduce),
                         blocks, smem, static_cast<cudaStream_t>(stream),
                         args);
}

int w2x_probe_l1_mm(const void* x, const long long* id, const void* w,
                    void* out, const long long* od, void* stream) {
  In b;
  Out o;
  int cells;
  if (!make_in(x, id, b) || !make_out(out, od, o, cells) ||
      o.dtype != DT_BF16 || b.lanes != 9 || o.run != 4LL * b.cols ||
      b.rows != o.rows || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)b.cols * 9 * 2 + 9 * 128 * 2 +
                      (size_t)b.cols * 128 * 2;
  const uint4* wv = static_cast<const uint4*>(w);
  void* args[] = {&b, (void*)&wv, &o};
  return (int)launch_dyn(reinterpret_cast<const void*>(probe_l1_mm),
                         cells * o.rows, smem,
                         static_cast<cudaStream_t>(stream), args);
}

const char* w2x_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
