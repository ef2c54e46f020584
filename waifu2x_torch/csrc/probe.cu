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
// store and map kernels fold (xor) the reads whose values are not used into
// a word that each thread stores to `sink` where that is not null; the
// wrappers pass null, but the compiler cannot know it, so it cannot drop a
// load. probe_fetch_reduce lands every block in shared memory and, where
// `sink` is given (ops/probe.py:traffic_sum), adds every word that landed
// into it (mod 2^32), which a plain sum over the blocks must equal.
//
// All are bound by bytes: the stores, maps and reductions do a few
// operations a byte, and probe_l1_mm's 2 x 9 x 128 FLOP a pixel take a third
// of its bytes' time on the tensor cores. Design: 16-byte loads and stores,
// neighbouring threads on neighbouring addresses; probe_store as one store
// a thread over the whole output (see there); probe_fetch_map's hot forms
// (one block, no repeat) compiled for their lanes, type and map: lane-inner
// outputs with no shared memory (probe_map_direct), planar ones through a
// padded shared-memory transpose fed by cp.async (probe_map_planar).
// probe_fetch_map's other forms (four blocks, a repeat, a constant output,
// a block wider than the output: probe_fetch_map below), probe_fetch_reduce
// and probe_l1_mm are persistent, one CUDA block an SM, a producer warp
// streaming block rows into a ring of shared memory by the TMA unit
// (cp.async.bulk) ahead of the consumer warps; probe_l1_mm's product is on
// the tensor cores (mma.sync, A formed in registers). Sums are taken in a
// fixed order, so no result varies from run to run. f32 maps use __fmul_rn
// / __fadd_rn, never fmaf, so the plain version computes the same values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"   // sm_count, w2x_error_string
#include "mma.cuh"     // cp.async

namespace {

constexpr int THREADS = 256;

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
enum { ROUTE_DIRECT = 0, ROUTE_PLANAR = 1, ROUTE_RING = 2 };

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

__device__ __forceinline__ uint32_t fold(uint4 v) {
  return v.x ^ v.y ^ v.z ^ v.w;
}

__device__ __forceinline__ void keep(uint32_t f, uint32_t* sink) {
  if (sink != nullptr) sink[blockIdx.x * blockDim.x + threadIdx.x] = f;
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
  // probe_fetch_map (the ring form, fm_geometry): block rows a ring slot
  // holds, the grid's cells, a slot's bytes, the ring's slots, and whether
  // the lower and diagonal stripes land whole in the head buffer
  int rpc, cells, sb, nslots, head;
};

// The map's persistent form, on a ring of TMA-staged rows (the Hopper
// design of dma_probe.py:55 lane16_x4, lane128 and lane128_x4,
// dma_probe2.py:50 in16+o128, in128+o128 and raw+o128, l14_probe.py:145
// xonly, and of every input the hot forms below do not take). Bound by
// bytes: a few adds a byte. One CUDA block an SM walks whole cells (cell
// blockIdx.x + k gridDim.x, so the cells in flight at one time are
// consecutive and share their neighbours' blocks through L2). The producer
// warp copies, a lane a block row, by the TMA unit (cp.async.bulk, each
// copy counted in bytes on its slot's mbarrier):
//   * with four blocks, first the lower and diagonal stripes whole into the
//     cell's half of a two-cell head buffer (the stripes are the first 8
//     rows of the tiles below and below-right, which the cells there read
//     as their own first rows at the same step of their walks, so one fetch
//     through L2 serves both);
//   * then the tile's rows, `rpc` a slot of FM_SLOT bytes, the right
//     stripe's rows landing in the same slot as their tile rows (the cell to
//     the right reads those rows at the same step too);
// ahead of the consumers by the ring's depth (FM_SLOTS_4 slots beside the
// head buffer, FM_SLOTS_1 with one block). Rows wider than a slot, or
// stripes wider than the head buffer, take the wide geometry instead
// (fm_geometry; no tool's grid reaches it): slots as wide as the widest
// row, as many as shared memory holds, and the lower and diagonal stripes'
// rows streamed through the ring after the tile's, each slot only landed
// and handed back, the consumers reading the stripes' row 0 from device
// memory (L2) instead. Eight consumer warps take each
// slot as it lands: every output vector of its rows, neighbouring threads
// on neighbouring 16-byte addresses, is built from 8- or 16-byte shared
// reads of the staged lanes (a repeated pixel's lanes read once and copied
// in registers; map_vec, compiled for the variant's shape and map, see
// ring_map), summed with __fadd_rn in the plain version's order and mapped,
// then the slot is handed back; after the cell's last slot the head buffer
// is. A constant output (MAP_CONST0) is stored before the cell's
// first slot lands and reads nothing staged; its blocks land all the same,
// each slot waited for and handed back. Forms and maps that map_vec is not
// compiled for (u8 output, planar, a plane, other lanes or maps) build each
// element from scalar shared reads (map_any). tools/probe_parts.py times
// builds that compile a part out: W2X_MAP_RING (the consumers only wait for
// each slot and hand it back), W2X_MAP_NO_OUT (no output stores) and
// W2X_MAP_OUT_ONLY (nothing is copied: the walk and the stores alone).
#ifdef W2X_MAP_RING
constexpr bool FM_WORK = false;
#else
constexpr bool FM_WORK = true;
#endif
#ifdef W2X_MAP_NO_OUT
constexpr bool FM_STORE = false;
#else
constexpr bool FM_STORE = true;
#endif
#ifdef W2X_MAP_OUT_ONLY
constexpr bool FM_LAND = false;
#else
constexpr bool FM_LAND = true;
#endif
constexpr int FM_WARPS = 8;                          // consumer warps
constexpr int FM_CONS = 32 * FM_WARPS;
constexpr int FM_THREADS = FM_CONS + 32;             // + the producer warp
constexpr int FM_SLOT = 16 * 1024;                   // bytes of a slot
constexpr int FM_HEAD = 36 * 1024;                   // a cell's two stripes
constexpr int FM_SLOTS_1 = 13, FM_SLOTS_4 = 9;       // ring slots
constexpr int FM_SMEM = 232448;                      // a block's at most
// shared memory: the ring, the head buffer of two cells, the slots' full
// and empty barriers and the head buffer's
__host__ __device__ constexpr int fm_smem(int sb, int nslots, bool head) {
  return nslots * sb + (head ? 2 * FM_HEAD : 0) + 8 * (2 * nslots + 4);
}
static_assert(fm_smem(FM_SLOT, FM_SLOTS_4, true) <= FM_SMEM &&
                  fm_smem(FM_SLOT, FM_SLOTS_1, false) <= FM_SMEM,
              "over a block's shared memory");

// Lane e of a staged row, as a float.
__device__ __forceinline__ float bf(const uint8_t* row, int e) {
  return __uint_as_float(
      (uint32_t)reinterpret_cast<const uint16_t*>(row)[e] << 16);
}

// N (4 or 8) bf16 lanes from lane c of pixel p of a staged row (la lanes a
// pixel), as floats, by one 8- or 16-byte read.
template <int N>
__device__ __forceinline__ void lanes_of(const uint8_t* row, int p, int la,
                                         int c, float* v) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 2 * (p * la + c));
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(row + 2 * (p * la + c));
    w[0] = u.x;
    w[1] = u.y;
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// The staged rows an output row reads: the tile's and, with four blocks,
// the right stripe's row r and the lower and diagonal stripes' row 0.
struct MapRows {
  const uint8_t *a, *b, *c, *d;
};

// N lanes of t = ((a + b) + c) + d (or a) at source pixel xs, lane c0.
template <int N, bool X4>
__device__ __forceinline__ void term(const MapRows& s, int xs, int la, int c0,
                                     float* v) {
  lanes_of<N>(s.a, xs, la, c0, v);
  if constexpr (X4) {
    float b[N], c[N], d[N];
    lanes_of<N>(s.b, 0, la, c0, b);
    lanes_of<N>(s.c, xs, la, c0, c);
    lanes_of<N>(s.d, 0, la, c0, d);
#pragma unroll
    for (int e = 0; e < N; ++e)
      v[e] = __fadd_rn(__fadd_rn(__fadd_rn(v[e], b[e]), c[e]), d[e]);
  }
}

// Output vector k of a row, bf16 lane-inner, the vector path compiled for
// its shape LG and map OP: LG = 4 (pixels 2k and 2k + 1, lanes 0-3) or LG = 8
// (lg >= 8: one pixel, lanes 8k mod lg on), each pixel's lanes read whole
// from the input's (lg <= la, not a plane or MAP_LANE0).
template <bool X4, int LG, int OP>
__device__ __forceinline__ uint4 map_vec(const MapArgs& a, const MapRows& s,
                                         int k) {
  const int la = a.in[0].lanes;
  float v[8];
  if constexpr (LG == 8) {
    const int e0 = 8 * k;
    term<8, X4>(s, (e0 >> a.lg) >> a.rep, la, e0 & ((1 << a.lg) - 1), v);
  } else {
    const int xs0 = (2 * k) >> a.rep, xs1 = (2 * k + 1) >> a.rep;
    term<4, X4>(s, xs0, la, 0, v);
    if (xs1 == xs0) {   // a repeated pixel: its lanes copied in registers
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 + e] = v[e];
    } else {
      term<4, X4>(s, xs1, la, 0, v + 4);
    }
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = bf_bits(apply(OP, v[2 * e])) |
           (bf_bits(apply(OP, v[2 * e + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The same element by element, for every form (u8 output, planar, any
// lanes), from scalar shared reads.
template <bool X4>
__device__ __forceinline__ uint4 map_any(const MapArgs& a, const MapRows& s,
                                         int k) {
  const int la = a.in[0].lanes, E = 16 / a.out.esize;
  return pack(a.out.dtype, [&](int e) {
    const int qq = k * E + e;
    int x, c;
    if (a.form == FORM_LANES) {
      x = qq >> a.lg;
      c = qq & ((1 << a.lg) - 1);
    } else {
      c = qq >> a.xg;
      x = qq & ((1 << a.xg) - 1);
    }
    const int xs = x >> a.rep;
    const int lane = la > 1 && a.op != MAP_LANE0 ? c : 0;
    float t = bf(s.a, xs * la + lane);
    if constexpr (X4) {
      t = __fadd_rn(t, bf(s.b, lane));
      t = __fadd_rn(t, bf(s.c, xs * la + lane));
      t = __fadd_rn(t, bf(s.d, lane));
    }
    return apply(a.op, t);
  });
}

// LG = 0: every output vector by map_any (every form, and the constant
// block, which forms nothing); LG = 4 or 8: by map_vec<X4, LG, OP>.
template <bool X4, int LG, int OP>
__global__ void __launch_bounds__(FM_THREADS, 1) probe_fetch_map(MapArgs a) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int slots = a.nslots, sb = a.sb;
  const bool hd = X4 && a.head;   // the stripes whole in the head buffer
  const uint32_t ring = smem_addr(sm);
  uint8_t* const head = sm + slots * sb;   // hd: cell k's at k & 1
  const uint32_t full = ring + slots * sb + (hd ? 2 * FM_HEAD : 0);
  const uint32_t empty = full + 8 * slots;
  const uint32_t hfull = empty + 8 * slots, hempty = hfull + 16;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, FM_WARPS);
    }
    if (hd) {
      for (int h = 0; h < 2; ++h) {
        mbar_init(hfull + 8 * h, 1);
        mbar_init(hempty + 8 * h, FM_WARPS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const In& A = a.in[0];
  const In& L = a.in[2];
  const In& D = a.in[3];
  const int rpc = a.rpc, rb0 = A.cols * A.lanes * 2;
  const int rb1 = X4 ? a.in[1].cols * a.in[1].lanes * 2 : 0;
  const int rbl = X4 ? L.cols * L.lanes * 2 : 0;
  const int rbd = X4 ? D.cols * D.lanes * 2 : 0;
  // the wide geometry's stripe rows a slot
  const int pl = X4 ? min(32, sb / rbl) : 1, pd = X4 ? min(32, sb / rbd) : 1;

  // the ring's position: the slot, its phase (the parity of its uses so
  // far), and whether every slot has been used once (no divisions: a
  // consumer takes a slot in a few dozen instructions)
  int slot = 0, ph = 0;
  bool wrapped = false;
  auto next = [&]() {
    if (++slot == slots) {
      slot = 0;
      ph ^= 1;
      wrapped = true;
    }
  };
  if (tid >= FM_CONS) {   // the producer warp: a lane a block row
    // rows [0, rows) of block B, `per` a slot, into the ring (wide: the
    // stripes after the tile)
    auto stream = [&](const In& B, int n, int i, int j, int rb, int per) {
      for (int r0 = 0; r0 < B.rows; r0 += per, next()) {
        const int nr = min(per, B.rows - r0);
        if (wrapped) mbar_wait(empty + 8 * slot, ph ^ 1);
        if (lane == 0) mbar_expect(full + 8 * slot, nr * rb);
        __syncwarp();
        if (lane < nr)
          bulk_load(ring + slot * sb + lane * rb, B.row(n, i, j, r0 + lane),
                    rb, full + 8 * slot);
      }
    };
    for (int k = 0, c = blockIdx.x; FM_LAND && c < a.cells;
         ++k, c += gridDim.x) {
      int n, i, j;
      cell_of(c, a.out, n, i, j);
      if (hd) {   // the lower and diagonal stripes, whole
        const int hb = k & 1;
        if (k >= 2)   // the buffer's last cell handed back
          mbar_wait(hempty + 8 * hb, ((k >> 1) - 1) & 1);
        if (lane == 0)
          mbar_expect(hfull + 8 * hb, L.rows * rbl + D.rows * rbd);
        __syncwarp();
        const uint32_t hs = smem_addr(head + hb * FM_HEAD);
        for (int r = lane; r < L.rows + D.rows; r += 32) {
          if (r < L.rows)
            bulk_load(hs + r * rbl, L.row(n, i, j, r), rbl, hfull + 8 * hb);
          else
            bulk_load(hs + L.rows * rbl + (r - L.rows) * rbd,
                      D.row(n, i, j, r - L.rows), rbd, hfull + 8 * hb);
        }
      }
      for (int r0 = 0; r0 < A.rows; r0 += rpc, next()) {
        const int nr = min(rpc, A.rows - r0);
        if (wrapped)   // the slot's last use handed back
          mbar_wait(empty + 8 * slot, ph ^ 1);
        if (lane == 0) mbar_expect(full + 8 * slot, nr * (rb0 + rb1));
        __syncwarp();
        if (lane < nr) {
          const uint32_t dst = ring + slot * sb;
          bulk_load(dst + lane * rb0, A.row(n, i, j, r0 + lane), rb0,
                    full + 8 * slot);
          if (X4)   // the right stripe's row beside its tile row
            bulk_load(dst + rpc * rb0 + lane * rb1,
                      a.in[1].row(n, i, j, r0 + lane), rb1, full + 8 * slot);
        }
      }
      if (X4 && !hd) {   // wide: the stripes through the ring
        stream(L, n, i, j, rbl, pl);
        stream(D, n, i, j, rbd, pd);
      }
    }
    return;
  }

  const int q = a.out.row_vecs();
  const long long pitch = a.out.pitch * a.out.esize / 16;   // vectors a row
  const bool zero = a.op == MAP_CONST0;
  // a slot that holds nothing the consumers read: landed, handed back
  auto pass = [&](int rows, int per) {
    for (int r0 = 0; r0 < rows; r0 += per, next()) {
      if (FM_LAND) mbar_wait(full + 8 * slot, ph);
      __syncwarp();
      if (lane == 0 && FM_LAND) mbar_arrive(empty + 8 * slot);
    }
  };
  for (int k = 0, c = blockIdx.x; c < a.cells; ++k, c += gridDim.x) {
    int n, i, j;
    cell_of(c, a.out, n, i, j);
    uint4* const out0 = a.out.row(n, i, j, 0);
    MapRows s;
    if (hd) {
      s.c = head + (k & 1) * FM_HEAD;   // the lower stripe's row 0
      s.d = s.c + L.rows * rbl;         // the diagonal stripe's row 0
    } else if (X4) {   // wide: row 0 of each from device memory
      s.c = reinterpret_cast<const uint8_t*>(L.row(n, i, j, 0));
      s.d = reinterpret_cast<const uint8_t*>(D.row(n, i, j, 0));
    }
    if (zero) {   // the constant block, before anything lands
      for (int e = tid; FM_WORK && FM_STORE && e < a.out.rows * q;
           e += FM_CONS)
        out0[(e / q) * pitch + e % q] = make_uint4(0u, 0u, 0u, 0u);
    } else if (hd && FM_LAND) {
      mbar_wait(hfull + 8 * (k & 1), (k >> 1) & 1);
    }
    for (int r0 = 0; r0 < A.rows; r0 += rpc, next()) {
      const int nr = min(rpc, A.rows - r0);
      if (FM_LAND) mbar_wait(full + 8 * slot, ph);
      if (!zero && FM_WORK) {
        const uint8_t* sv = sm + slot * sb;
        for (int e = tid; e < nr * q; e += FM_CONS) {
          const int r = e / q, kv = e % q;
          s.a = sv + r * rb0;
          s.b = sv + rpc * rb0 + r * rb1;
          uint4 v;
          if constexpr (LG == 0)
            v = map_any<X4>(a, s, kv);
          else
            v = map_vec<X4, LG, OP>(a, s, kv);
          if (FM_STORE || v.x == 0x7fc00001u)   // (keeps v live)
            out0[(r0 + r) * pitch + kv] = v;
        }
      }
      __syncwarp();
      if (lane == 0 && FM_LAND) mbar_arrive(empty + 8 * slot);
    }
    if (X4 && !hd) {   // wide: the stripes' slots
      pass(L.rows, pl);
      pass(D.rows, pd);
    } else if (hd && FM_LAND) {   // the stripes landed (a constant block
                                  // waits here) and read
      if (zero) mbar_wait(hfull + 8 * (k & 1), (k >> 1) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(hempty + 8 * (k & 1));
    }
  }
}

// ---------------------------------------------------------------------------
// probe_fetch_map's hot forms, compiled for their lanes, type and map (the
// map's single-block, rep-1 forms whose output row holds every pixel of the
// block row; probe_fetch_map above, the ring form, takes the rest):
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
// probe_fetch_reduce (tools/stage_time.py:172 cin1, :187 cin4, :220 cin9;
// tools/grid_floor_probe.py:100 4-fetch):
//   RED_CORNER_MAX: t = sum over the blocks (in order) of the max over the
//     block's [0:8, 0:8, :] corner; every output element = bf16(0 + t).
//   RED_LANE0_SUM: s = ((0 + S1) + S2) + S3, S_k the sum of lane 0 over all
//     of block k; out[r, x, c] = bf16(a[r, x, c] + s), c < 4.
//
// Bound by bytes (a few operations a byte). The design: a persistent grid,
// one CUDA block an SM walking whole cells (cell blockIdx.x + k * gridDim.x,
// so the cells in flight at a time are consecutive and share their
// neighbours' blocks through L2). The producer warp copies the cell's blocks
// row by row, a lane a row, into a ring of 16 KB slots by the TMA unit
// (cp.async.bulk, a slot's rows counted on its mbarrier), ahead of the
// consumers by the ring's depth (13 slots; 9 beside the lane-0 sums' stash);
// eight consumer warps take each slot as it lands and hand it back (a lane a
// row: one thread's address arithmetic for every row would hold the ring
// back). Corner maxima: the consumers read each block's 8 x 8 corner once
// per cell from device memory as 16-byte vectors (L2 hits: the ring fetches
// the same rows), reduce one max a block across the warps, and store the
// cell's constant block with 16-byte stores while the ring streams the
// cell's rows and the next cell's. Lane-0 sums: cell (n, i, j) reads its
// four tiles at the steps set by the tiles' own row and column parities
// (red_order), so that the four cells that read a tile all read it at the
// same step of their walk and it need stay in L2 for one step only; each
// thread sums lane 0 of the pixels it owns in a register a tile and keeps
// the tile's lanes 0-3 in a shared-memory stash; after the cell's last slot
// the three sums are reduced in a fixed order (the warp's lanes by an xor
// tree, then the warps in order), and each thread writes the stashed pixels
// it owns, + s, as 8-byte stores. The result does not vary from run to run.
// The kernel is compiled for each op, so that the ring's depth is a
// constant. Every 32-bit word that lands in a slot is added (mod 2^32) into
// the thread's sink word where `sink` is given: the traffic check
// (ops/probe.py:traffic_sum).
constexpr int RED_WARPS = 8;                           // consumer warps
constexpr int RED_CONS = 32 * RED_WARPS;
constexpr int RED_THREADS = RED_CONS + 32;             // + the producer warp
static_assert((RED_CONS & (RED_CONS - 1)) == 0, "a power of two");
constexpr int RED_SLOT = 16 * 1024;                    // bytes of a slot
constexpr int RED_STASH = 64 * 1024;                   // bytes of the stash
// slots of the ring: the corner maxima's, and the lane-0 sums' beside the
// stash; a slot and its two barriers
constexpr int RED_SLOTS_MAX = 13, RED_SLOTS_SUM = 9;
__host__ __device__ constexpr int red_ring(int slots) {
  return slots * (RED_SLOT + 16);
}
static_assert(red_ring(RED_SLOTS_MAX) <= 232448 - 256 &&
                  red_ring(RED_SLOTS_SUM) + RED_STASH <= 232448 - 256,
              "over a block's shared memory");

struct RedArgs {
  In in[4];
  int nin;
  Out out;
  int rpc[4];   // rows of block k in a slot
  int cells;
  uint32_t* sink;
};

// Step s of cell (i, j) reads block s ^ red_order(op, i, j): the corner
// maxima in order; the lane-0 sums' tiles (i + di, j + dj), block 2 di + dj,
// by the tile's row and column parity, 2 ((i + di) & 1) + ((j + dj) & 1).
__device__ __forceinline__ int red_order(int op, int i, int j) {
  return op == RED_LANE0_SUM ? ((i & 1) << 1) | (j & 1) : 0;
}

__device__ __forceinline__ uint32_t word_sum(uint4 v) {
  return v.x + v.y + v.z + v.w;
}

__device__ __forceinline__ float max8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float m = __uint_as_float(w[0] << 16);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m = fmaxf(m, __uint_as_float(w[k] << 16));
    m = fmaxf(m, __uint_as_float(w[k] & 0xffff0000u));
  }
  return m;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The consumers' corner maxima of cell (n, i, j), one a block, and the
// cell's constant output block.
__device__ __forceinline__ void corner_out(const RedArgs& a, int n, int i,
                                           int j, float (*red)[RED_WARPS]) {
  const int tid = threadIdx.x;
  float m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = __int_as_float(0xff800000);   // -inf
    if (k >= a.nin) continue;
    const In& b = a.in[k];
    // 8 rows of 8 pixels x lanes bf16: `lanes` 16-byte vectors a row
    for (int e = tid; e < 8 * b.lanes; e += RED_CONS)
      m[k] = fmaxf(m[k], max8(b.row(n, i, j, e / b.lanes)[e % b.lanes]));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], d));
    if ((tid & 31) == 0) red[k][tid >> 5] = m[k];
  }
  bar_sync(1, RED_CONS);
  float t = 0.0f;
  for (int k = 0; k < a.nin; ++k) {
    float mk = red[k][0];
    for (int w = 1; w < RED_WARPS; ++w) mk = fmaxf(mk, red[k][w]);
    t = k == 0 ? mk : __fadd_rn(t, mk);
  }
  const float v = __fadd_rn(0.0f, t);
  const uint4 pat = pack(a.out.dtype, [&](int) { return v; });
  const int q = a.out.row_vecs();
#ifndef W2X_RED_NO_OUT
  for (int e = tid; e < a.out.rows * q; e += RED_CONS)
    a.out.row(n, i, j, e / q)[e % q] = pat;
#else
  if (v == -1.0f) a.out.row(n, i, j, 0)[tid] = pat;   // keeps v live
#endif
}

template <int OP>
__global__ void __launch_bounds__(RED_THREADS, 1)
probe_fetch_reduce(RedArgs a) {
  constexpr bool SUM = OP == RED_LANE0_SUM;
  constexpr int SLOTS = SUM ? RED_SLOTS_SUM : RED_SLOTS_MAX;
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ float red[2][4][RED_WARPS];   // by cell parity
  const uint32_t ring = smem_addr(sm);
  const uint32_t full = ring + SLOTS * RED_SLOT;
  const uint32_t empty = full + 8 * SLOTS;
  uint2* stash = reinterpret_cast<uint2*>(sm + red_ring(SLOTS));
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, RED_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= RED_CONS) {   // the producer warp: a lane a block row
    int t = 0;
    for (int c = blockIdx.x; c < a.cells; c += gridDim.x) {
      int n, i, j;
      cell_of(c, a.out, n, i, j);
      const int order = red_order(OP, i, j);
      for (int s = 0; s < a.nin; ++s) {
        const In& b = a.in[s ^ order];
        const int rb = b.cols * b.lanes * 2, rpc = a.rpc[s ^ order];
        const uint4* base = b.row(n, i, j, 0);
        const long long pitch = b.w * b.lanes / 8;   // vectors an array row
        for (int r0 = 0; r0 < b.rows; r0 += rpc, ++t) {
          const int slot = t % SLOTS, nr = min(rpc, b.rows - r0);
          if (t >= SLOTS)   // the slot's last use handed back
            mbar_wait(empty + 8 * slot, (t / SLOTS - 1) & 1);
          if (lane == 0) mbar_expect(full + 8 * slot, nr * rb);
          __syncwarp();
          if (lane < nr)
            bulk_load(ring + slot * RED_SLOT + lane * rb,
                      base + (r0 + lane) * pitch, rb, full + 8 * slot);
        }
      }
    }
    if (a.sink != nullptr) a.sink[blockIdx.x * RED_THREADS + tid] = 0u;
    return;
  }

  uint32_t words = 0;
  int t = 0, cb = 0;
  for (int c = blockIdx.x; c < a.cells; c += gridDim.x, cb ^= 1) {
    int n, i, j;
    cell_of(c, a.out, n, i, j);
    const int order = red_order(OP, i, j);
#ifndef W2X_RED_RING
    if (!SUM) corner_out(a, n, i, j, red[cb]);
#endif
    float sk[3] = {0.0f, 0.0f, 0.0f};   // lane-0 sums of blocks 1-3
    for (int s = 0; s < a.nin; ++s) {
      const int k = s ^ order;
      const In& b = a.in[k];
      const int rb = b.cols * b.lanes * 2, rpc = a.rpc[k];
      const int vpp = b.lanes / 8;   // vectors a pixel (lane-0 sums)
      float part = 0.0f;
      for (int r0 = 0; r0 < b.rows; r0 += rpc, ++t) {
        const int slot = t % SLOTS, nr = min(rpc, b.rows - r0);
        mbar_wait(full + 8 * slot, (t / SLOTS) & 1);
        const uint4* sv =
            reinterpret_cast<const uint4*>(sm + slot * RED_SLOT);
#ifndef W2X_RED_RING
        if (SUM) {   // lane 0 (and 1-3) in a pixel's first vector
          // pixel r0 * cols + p of the block is thread (r0 * cols + p) %
          // RED_CONS's, the owner of that stash entry in the output below
          for (int p = (tid - r0 * b.cols) & (RED_CONS - 1); p < nr * b.cols;
               p += RED_CONS) {
            const uint4 v = sv[p * vpp];
            if (k == 0)
              stash[r0 * b.cols + p] = make_uint2(v.x, v.y);   // lanes 0-3
            else
              part = __fadd_rn(part, __uint_as_float(v.x << 16));
            if (a.sink != nullptr) {
              words += word_sum(v);
              for (int e = 1; e < vpp; ++e) words += word_sum(sv[p * vpp + e]);
            }
          }
        } else if (a.sink != nullptr) {
          for (int v = tid; v < nr * rb / 16; v += RED_CONS)
            words += word_sum(sv[v]);
        }
#endif
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * slot);
      }
      if (k == 1) sk[0] = part;
      if (k == 2) sk[1] = part;
      if (k == 3) sk[2] = part;
    }
#ifdef W2X_RED_RING
    continue;
#endif
    if (!SUM) continue;

    // s = ((0 + S1) + S2) + S3, each S_k over the warp's lanes by an xor
    // tree, then over the warps in order
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        sk[k] = __fadd_rn(sk[k], __shfl_xor_sync(0xffffffffu, sk[k], d));
      if (lane == 0) red[cb][k][tid >> 5] = sk[k];
    }
    bar_sync(1, RED_CONS);
    float sum = 0.0f;
    for (int k = 0; k < 3; ++k) {
      float tk = red[cb][k][0];
      for (int w = 1; w < RED_WARPS; ++w) tk = __fadd_rn(tk, red[cb][k][w]);
      sum = __fadd_rn(sum, tk);
    }
#ifdef W2X_RED_NO_OUT
    if (sum != -1.0f) continue;
#endif
    // the stashed pixels this thread wrote (pixel q = tid + RED_CONS m of
    // the tile: row r, column x), + s, as 8-byte stores; no other thread
    // reads them, so the next cell may stash before all threads are here
    const int cols = a.in[0].cols;
    uint2* const out0 = reinterpret_cast<uint2*>(a.out.row(n, i, j, 0));
    const long long pitch = a.out.pitch / 4;   // 4 bf16 a uint2
    int r = tid / cols, x = tid % cols;
    for (int q = tid; q < a.in[0].rows * cols; q += RED_CONS) {
      const uint2 v = stash[q];
      const uint32_t h[4] = {v.x << 16, v.x & 0xffff0000u, v.y << 16,
                             v.y & 0xffff0000u};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = bf_bits(__fadd_rn(__uint_as_float(h[e]), sum));
      out0[r * pitch + x] =
          make_uint2(o[0] | (o[1] << 16), o[2] | (o[3] << 16));
      for (x += RED_CONS; x >= cols; x -= cols) ++r;
    }
  }
  if (a.sink != nullptr) a.sink[blockIdx.x * RED_THREADS + tid] = words;
}

// ---------------------------------------------------------------------------
// probe_l1_mm (tools/stage_time.py:241, cin9mm): the JAX body's (tr, tc, 9) x
// (9, 128) product, f32 sums rounded to a bf16 (tc, 128) scratch, whose lanes
// 0-3 are written planar, out[r, c * tc + x] = scratch[x, c].
//
// Bound by bytes: on the tensor cores the products take about half the time
// of the bytes. The design: a persistent grid, one CUDA block an SM walking
// cell rows (row blockIdx.x + k * gridDim.x); the producer warp's lanes each
// copy one cell row (tc x 9 bf16, 16-byte aligned and contiguous) by one
// bulk copy (TMA) into a ring of MM_SLOTS rows, and put the row's output
// address beside it; four teams of four consumer warps take the rows in
// turn, a warp 16-pixel strips of the row. The 128-lane product is whole, on
// the tensor cores: for 16 pixels, 16 mma.sync m16n8k16, one an n-tile of 8
// channels, with K padded from 9 to 16 by zeros. A pixel is 18 bytes, which
// no K-major operand layout can name, so A is formed in registers from the
// staged row (two bf16 at a time by a funnel shift, the 9th alone); B, the
// weight packed by the wrapper as [k8][n][8] with k >= 9 zero
// (ops/probe.py:pack_l1_mm), sits in registers, 32 a thread. Only lanes 0-3
// of the products leave the registers (the 128-lane scratch is not written):
// rounded to bf16 once, as the scratch rounds them, into the warp's planar
// staging, then stored as four 32-byte runs; no barrier couples the warps
// (mma.sync rather than wgmma: a warpgroup's product ties its four warps to
// one wait before the epilogue). On k / 256 inputs every sum is exact, so
// the result equals the plain version bit for bit.
constexpr int MM_TEAMS = 4;                      // teams of 4 warps
constexpr int MM_THREADS = 128 * MM_TEAMS + 32;  // + the producer warp
constexpr int MM_SLOTS = 64;                     // ring of cell rows
constexpr int MM_W_BYTES = 2 * 128 * 8 * 2;      // B: [k8][n][8] bf16
constexpr int MM_STAGE = 4 * 16 * 2;             // a warp's 16 px x 4 lanes

// shared memory: the ring, B, the warps' staging, each slot's output row,
// the full and empty barriers
__host__ __device__ constexpr int mm_smem(int tc) {
  return MM_SLOTS * 18 * tc + MM_W_BYTES + 4 * MM_TEAMS * MM_STAGE +
         3 * MM_SLOTS * 8;
}

struct MmArgs {
  In x;
  const uint4* w;   // pack_l1_mm's [2][128][8] bf16
  Out out;
  int units;        // cell rows: cells * tr
};

// The two bf16 at `byte` (even) of a staged row, the lower address low.
__device__ __forceinline__ uint32_t bf_pair(const uint8_t* row, int byte) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (byte & ~3));
  return (byte & 2) ? __funnelshift_r(w[0], w[1], 16) : w[0];
}

__global__ void __launch_bounds__(MM_THREADS, 1) probe_l1_mm(MmArgs a) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int tc = a.x.cols, rb = 18 * tc;   // a cell row's bytes
  const uint32_t ring = smem_addr(sm);
  uint8_t* stage_all = sm + MM_SLOTS * rb + MM_W_BYTES;
  uint4** dsts =
      reinterpret_cast<uint4**>(stage_all + 4 * MM_TEAMS * MM_STAGE);
  const uint32_t full = smem_addr(dsts + MM_SLOTS);
  const uint32_t empty = full + 8 * MM_SLOTS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < MM_SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);   // the warps of a team
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < MM_W_BYTES / 16; e += MM_THREADS)
    reinterpret_cast<uint4*>(sm + MM_SLOTS * rb)[e] = a.w[e];
  __syncthreads();

  if (warp == 4 * MM_TEAMS) {   // the producer warp: a lane a row
    for (int t = lane;; t += 32) {
      const int u = blockIdx.x + t * gridDim.x;
      if (u >= a.units) break;
      const int slot = t % MM_SLOTS, r = u % a.out.rows;
      if (t >= MM_SLOTS)   // the slot's last use handed back
        mbar_wait(empty + 8 * slot, (t / MM_SLOTS - 1) & 1);
      int n, i, j;
      cell_of(u / a.out.rows, a.out, n, i, j);
      dsts[slot] = a.out.row(n, i, j, r);   // released by the arrival
      mbar_expect(full + 8 * slot, rb);
      bulk_load(ring + slot * rb, a.x.row(n, i, j, r), rb, full + 8 * slot);
    }
    return;
  }

  const int g = warp >> 2, wl = warp & 3;   // team, its warp
  const int q = lane & 3, pl = lane >> 2;   // k pair / column pair, pixel
  uint16_t* ws = reinterpret_cast<uint16_t*>(stage_all + warp * MM_STAGE);
  // B fragments of mma.m16n8k16 for the 16 n-tiles, resident in registers:
  // k = 2q, 2q + 1 (and + 8), n = 8 nt + pl
  uint32_t bfr[16][2];
  const uint32_t* wsm = reinterpret_cast<const uint32_t*>(sm + MM_SLOTS * rb);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    bfr[nt][0] = wsm[(8 * (8 * nt + pl) + 2 * q) / 2];
    bfr[nt][1] = wsm[(1024 + 8 * (8 * nt + pl) + 2 * q) / 2];
  }
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int u = blockIdx.x + g * gridDim.x, t = g; u < a.units;
       u += MM_TEAMS * gridDim.x, t += MM_TEAMS) {
    const int slot = t % MM_SLOTS;
    mbar_wait(full + 8 * slot, (t / MM_SLOTS) & 1);
    const uint8_t* row = sm + slot * rb;
    uint4* dst = dsts[slot];
    for (int xs = 16 * wl; xs < tc; xs += 64) {
      // A: pixels xs + pl and xs + pl + 8 of this warp's strip, k = 2q,
      // 2q + 1 (and + 8: only k = 8 is not zero)
      const int x = xs + pl;
      uint32_t af[4] = {0u, 0u, 0u, 0u};
#ifndef W2X_L1MM_NO_FORM
      af[0] = bf_pair(row, 18 * x + 4 * q);
      af[1] = bf_pair(row, 18 * (x + 8) + 4 * q);
      if (q == 0) {
        af[2] = *reinterpret_cast<const uint16_t*>(row + 18 * x + 16);
        af[3] = *reinterpret_cast<const uint16_t*>(row + 18 * (x + 8) + 16);
      }
#else
      af[0] = (uint32_t)(x * 0x00010001u);
#endif
#ifndef W2X_L1MM_NO_MMA
      // all 128 channels: 16 n-tiles, lanes 0-3 in the last one's d
#pragma unroll
      for (int nt = 15; nt >= 0; --nt)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%10, %10, %10, %10};\n"
            : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
            : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]),
              "r"(bfr[nt][0]), "r"(bfr[nt][1]), "f"(0.0f));
#else
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = __uint_as_float(af[k]);
#endif
#ifndef W2X_L1MM_NO_OUT
      // lanes 2q, 2q + 1 of pixels pl (d 0-1) and pl + 8 (d 2-3), rounded
      // once, into the warp's planar [4][16] staging; then eight lanes
      // store its four 32-byte runs
      __syncwarp();   // the warp's last reads of its staging are done
      if (q < 2) {
        ws[2 * q * 16 + pl] = (uint16_t)bf_bits(d[0]);
        ws[(2 * q + 1) * 16 + pl] = (uint16_t)bf_bits(d[1]);
        ws[2 * q * 16 + pl + 8] = (uint16_t)bf_bits(d[2]);
        ws[(2 * q + 1) * 16 + pl + 8] = (uint16_t)bf_bits(d[3]);
      }
      __syncwarp();
      if (lane < 8)
        dst[((lane >> 1) * tc + xs) / 8 + (lane & 1)] =
            reinterpret_cast<const uint4*>(ws)[lane];
#endif
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);   // the row is read
  }
#ifdef W2X_L1MM_NO_OUT
  if (d[0] == -1.0f) ws[lane] = (uint16_t)d[1];   // keeps d live
#endif
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
  return o.dtype >= 0 && o.dtype <= DT_U8 && o.rows > 0 &&
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

// A launch's error, else cudaGetLastError() (which it also clears).
int launched(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
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

// probe_fetch_map's ring form for (four blocks, input lanes, output lanes,
// map, type, form): the vector path where it is compiled for the variant's
// shape and map (the four-block copies of lane16_x4, lane128_x4 and
// xonly, lane128's repeated copy, in128+o128's zero map), else map_any.
const void* ring_map(bool x4, int la, int lg, int op, int dtype, int form) {
  const bool vec = dtype == DT_BF16 && form == FORM_LANES && la > 1 &&
                   op != MAP_LANE0 && lg <= la;
  if (vec && lg == 4 && la % 4 == 0 && op == MAP_COPY)
    return x4 ? (const void*)probe_fetch_map<true, 4, MAP_COPY>
              : (const void*)probe_fetch_map<false, 4, MAP_COPY>;
  if (vec && lg >= 8 && la % 8 == 0 && op == MAP_ZERO && !x4)
    return (const void*)probe_fetch_map<false, 8, MAP_ZERO>;
  return x4 ? (const void*)probe_fetch_map<true, 0, MAP_COPY>
            : (const void*)probe_fetch_map<false, 0, MAP_COPY>;
}

// pixels a thread of probe_map_direct maps (DirectGeo::G)
int direct_group(int la, int lg, int dtype) {
  const int in_px = 2 * la, out_px = lg * esize_of(dtype);
  return imax(in_px >= 16 ? 1 : 16 / in_px, out_px >= 16 ? 1 : 16 / out_px);
}

// The ring form's geometry for block rows of rb[k] bytes (a.in filled):
// FM_SLOT-byte slots, FM_SLOTS_1 or FM_SLOTS_4 of them, where a tile row
// and its right stripe's fit a slot and (four blocks) the lower and
// diagonal stripes a cell's half of the head buffer; else the wide
// geometry, slots as wide as the widest block row, as many as a block's
// shared memory holds, the stripes through the ring. False where no slot
// fits (a row over FM_SMEM) or a block row holds no bytes.
bool fm_geometry(MapArgs& a, const long long* rb) {
  const bool x4 = a.nin == 4;
  const long long row = rb[0] + rb[1];
  for (int k = 0; k < a.nin; ++k)
    if (rb[k] <= 0) return false;
  const long long stripes =
      x4 ? a.in[2].rows * rb[2] + a.in[3].rows * rb[3] : 0;
  if (row <= FM_SLOT && stripes <= FM_HEAD) {
    a.sb = FM_SLOT;
    a.nslots = x4 ? FM_SLOTS_4 : FM_SLOTS_1;
    a.head = x4;
  } else {
    long long sb = row > FM_SLOT ? row : FM_SLOT;
    for (int k = 2; k < a.nin; ++k) sb = rb[k] > sb ? rb[k] : sb;
    if (sb > FM_SMEM) return false;
    a.sb = (int)sb;
    a.nslots = (FM_SMEM - fm_smem(0, 0, false)) / (a.sb + 16);
    a.head = 0;
    if (a.nslots < 1) return false;
  }
  a.rpc = (int)(a.sb / row < 32 ? a.sb / row : 32);
  return true;
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

// `route`, where not null, is set to the kernel launched: ROUTE_DIRECT
// (probe_map_direct), ROUTE_PLANAR (probe_map_planar) or ROUTE_RING
// (probe_fetch_map).
int w2x_probe_fetch_map(const void* const* ins, const long long* id, int nin,
                        void* out, const long long* od, int form, int lg,
                        int xg, int rep, int op, int* route, void* stream) {
  MapArgs a;
  int cells;
  if ((nin != 1 && nin != 4) || !make_out(out, od, a.out, cells) ||
      a.out.dtype == DT_F32 || log2_of(lg) < 0 || log2_of(xg) < 0 ||
      log2_of(rep) < 0 || (long long)lg * xg != a.out.run)
    return (int)cudaErrorInvalidValue;
  long long rbytes[4] = {0, 0, 0, 0};   // a block row's bytes
  for (int k = 0; k < nin; ++k) {
    if (!make_in(ins[k], id + 9 * k, a.in[k]))
      return (int)cudaErrorInvalidValue;
    rbytes[k] = 2LL * a.in[k].cols * a.in[k].lanes;
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
        ((long long)a.out.rows * (b.cols / g)) % THREADS == 0) {
      if (route != nullptr) *route = ROUTE_DIRECT;
      return (int)launch_dyn(fn, cells * (a.out.rows * (b.cols / g) /
                                          THREADS), 0, s, args);
    }
    if (form == FORM_PLANAR && b.lanes == 16 && lg == 4 &&
        a.out.dtype == DT_BF16 && (op == MAP_COPY || op == MAP_HALF) &&
        a.out.rows % PLANAR_ROWS == 0 && b.cols % 8 == 0) {
      if (route != nullptr) *route = ROUTE_PLANAR;
      return (int)launch_dyn(
          op == MAP_COPY ? (const void*)probe_map_planar<MAP_COPY>
                         : (const void*)probe_map_planar<MAP_HALF>,
          cells * (a.out.rows / PLANAR_ROWS),
          (size_t)PLANAR_ROWS * (b.cols / 8) * PLANAR_GROUP, s, args,
          PLANAR_THREADS);
    }
  }
  // the rest on the ring form: four blocks, a repeat, a constant block, an
  // input row wider than the output's (dma_probe.py:55 lane16_x4, lane128,
  // lane128_x4; dma_probe2.py:50 in16+o128, in128+o128, raw+o128;
  // l14_probe.py:145 xonly)
  if (!fm_geometry(a, rbytes)) return (int)cudaErrorInvalidValue;
  a.cells = cells;
  int sms;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  const bool x4 = nin == 4;
  if (route != nullptr) *route = ROUTE_RING;
  return launched(launch_dyn(
      ring_map(x4, a.in[0].lanes, lg, op, a.out.dtype, form),
      cells < sms ? cells : sms, fm_smem(a.sb, a.nslots, a.head), s, args,
      FM_THREADS));
}

// `sink`, where not null, holds one word a thread of the grid (the grid is
// at most one CUDA block a cell): sink_words >= cells * RED_THREADS.
int w2x_probe_fetch_reduce(const void* const* ins, const long long* id,
                           int nin, void* out, const long long* od, int op,
                           int lg, void* sink, long long sink_words,
                           void* stream) {
  RedArgs a;
  int cells;
  if (nin < 1 || nin > 4 || !make_out(out, od, a.out, cells) ||
      a.out.dtype != DT_BF16 || (op != RED_CORNER_MAX && op != RED_LANE0_SUM) ||
      (op == RED_LANE0_SUM && (nin != 4 || lg != 4)) ||
      (sink != nullptr && (sink_words < (long long)cells * RED_THREADS ||
                           reinterpret_cast<uintptr_t>(sink) % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < nin; ++k) {
    In& b = a.in[k];
    if (!make_in(ins[k], id + 9 * k, b) || b.rows < 8 || b.cols < 8 ||
        2 * b.cols * b.lanes > RED_SLOT ||
        (op == RED_LANE0_SUM && b.lanes % 8 != 0))
      return (int)cudaErrorInvalidValue;
    // rows of a slot, one a lane of the producer warp
    a.rpc[k] = RED_SLOT / (2 * b.cols * b.lanes) < 32
                   ? RED_SLOT / (2 * b.cols * b.lanes) : 32;
  }
  const In& A = a.in[0];
  if (op == RED_LANE0_SUM &&
      (A.rows != a.out.rows || a.out.run != 4LL * A.cols ||
       (long long)A.rows * A.cols * 8 > RED_STASH))
    return (int)cudaErrorInvalidValue;
  int sms;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  a.nin = nin;
  a.cells = cells;
  a.sink = static_cast<uint32_t*>(sink);
  const bool sum = op == RED_LANE0_SUM;
  const size_t smem =
      sum ? red_ring(RED_SLOTS_SUM) + RED_STASH : red_ring(RED_SLOTS_MAX);
  void* args[] = {&a};
  const void* fn = sum ? (const void*)probe_fetch_reduce<RED_LANE0_SUM>
                       : (const void*)probe_fetch_reduce<RED_CORNER_MAX>;
  return launched(launch_dyn(fn, cells < sms ? cells : sms, smem,
                             static_cast<cudaStream_t>(stream), args,
                             RED_THREADS));
}

// w: pack_l1_mm's [2][128][8] bf16 (the (9, 128) weight, K padded to 16).
int w2x_probe_l1_mm(const void* x, const long long* id, const void* w,
                    void* out, const long long* od, void* stream) {
  MmArgs a;
  int cells;
  if (!make_in(x, id, a.x) || !make_out(out, od, a.out, cells) ||
      a.out.dtype != DT_BF16 || a.x.lanes != 9 || a.x.cols % 16 != 0 ||
      a.out.run != 4LL * a.x.cols || a.x.rows != a.out.rows ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      mm_smem(a.x.cols) > 232448 || (long long)cells * a.out.rows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  int sms;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  a.w = static_cast<const uint4*>(w);
  a.units = cells * a.out.rows;
  void* args[] = {&a};
  return launched(launch_dyn(reinterpret_cast<const void*>(probe_l1_mm),
                             a.units < sms ? a.units : sms,
                             mm_smem(a.x.cols),
                             static_cast<cudaStream_t>(stream), args,
                             MM_THREADS));
}

}  // extern "C"
