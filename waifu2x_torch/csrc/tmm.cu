// The four-tap 128 -> 128 probe layer on Hopper's tensor cores (sm_90a), in
// two layouts: channels in the fast dimension (chlane) and positions in the
// fast dimension (poslane). Built with nvcc into a shared library with a
// plain C interface and loaded with ctypes (waifu2x_torch/ops/_build.py); the
// Python wrapper tap_mm, its plain version, the weights' packing
// (pack_tap_mm), the walk (tmm_walk) and the launch count are in
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
// What bounds it on an H100: the bytes. At the JAX tool's grid (B = 16, 8 x 4
// cells of 64 x 128) the taps read 67 x 131 positions of each cell's block,
// 1.150 GB, and the output is 1.074 GB: 0.664 ms at 3.35 TB/s, against
// 0.550 TFLOP = 0.556 ms at the 989 TFLOP/s bf16 peak; the same for both
// layouts. So the copies and the products must both run near their peaks
// and overlap.
//
// Design (both layouts): a persistent grid, one CUDA block an SM. A row of
// work is 128 positions of one output row of one cell ("a segment row"); the
// rows of all cells, segment by segment, are one list cut evenly over the
// blocks (ops/probe.py:tmm_walk), and a block walks its rows in order, a run
// of consecutive rows of one segment being a work unit (a block's first and
// last units are usually partial). Each row is D[co, pos] = the sum over
// the 32 k16 steps of W^T[co, k] X[k, pos], K = 4 taps x 128 input
// channels:
//   * The weights stay in registers for the whole kernel, as wgmma's A
//     operand: two warpgroups split the output channels (64 each), each
//     thread holding its 32 steps' fragments (128 registers; packed by
//     ops/probe.py:pack_tap_mm in the order the threads load them). Shared
//     memory is then all ring: 131,072 bytes of weights would leave no room
//     for the four input rows an output row reads beside them.
//   * A ring of five slots, each one input row of the unit in the
//     interleaved K-major layout [k8][position][8], 131 positions (128 + 3
//     for the taps) a k8 plane, so that tap t's B operand is the same slot
//     moved by t positions: one descriptor offset. Each input row is
//     fetched once a unit and serves the four output rows that read it (a
//     unit reads three halo rows more than it writes); slot L % 5 holds the
//     unit's L-th row, four for this output row and the next one filling.
//     An output row's 32 products are one commit group.
//   * chlane: warp 0 copies each row by TMA (cp.async.bulk.tensor, one box
//     of 8 channels x 131 positions a lane) straight into its slot, on
//     mbarriers: a "full" one that counts the slot's bytes, an "empty" one
//     at which the eight warps arrive once their products have read the
//     slot. The epilogue rounds the f32 sums to bf16 into a swizzled output
//     tile of the warpgroup by stmatrix (transposed: the output has channels
//     fastest), then one thread stores it by TMA, which reads the tile while
//     the next row multiplies.
//   * poslane: a tap moves the positions by t inside each 16-byte row,
//     which no descriptor reaches, and a TMA box must start 16-byte aligned
//     in its innermost dimension (a box at column col0 + t stops the card
//     with an illegal instruction), so no copy can land a shifted row.
//     Instead warp 0 copies each row by TMA into one staging slot as it lies
//     ([8-position group][128 channels][8 positions], 17 boxes), and the two
//     warpgroups transpose it into its ring slot (ldmatrix, then stmatrix
//     with .trans: 8 x 8 blocks) while the tensor cores multiply the row
//     before; from there the products are chlane's. Two 256-thread barriers
//     a row bracket the transposition (the slot's last readers are done; the
//     slot is written and the staging slot free for the next copy). Its
//     output, positions fastest, goes out as chlane's does, by stmatrix
//     (not transposed) and TMA, through the ring slot of the row's tap 0,
//     which no later row reads: a third barrier waits for both warpgroups'
//     products, and a transposition into the slot waits for the store to
//     have read it. (Stored from the accumulators instead, 4 bytes a
//     thread and 8 rows a warp's store, the layout ran far behind chlane:
//     the stores held the tensor cores idle.)
//   The earlier kernel (one block per two output rows of a cell, the
//   128 KB of weights and five window rows staged by cp.async for each
//   block, one chunk in flight) moved about 5 GB through L2 and ran at 26-31%
//   of the bound (PERF.md).

#include <cuda.h>
#include <limits.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TM_THREADS = 256;     // two warpgroups: channels 0-63, 64-127
constexpr int NP = 128;             // positions a row of work
constexpr int CH = 128;             // channels in and out
constexpr int TAPS = 4;
constexpr int KSTEPS = TAPS * CH / 16;   // 32: k16 steps of a row
constexpr int STAGES = 5;           // ring slots

// a slot is an input row [k8][position][8] of ROW_POS positions, its k8
// planes PLANE bytes apart (TMA destinations 128-byte aligned)
constexpr int ROW_POS = NP + TAPS - 1;             // 131
constexpr uint32_t PLANE = 2176;                   // 131 x 16 -> 17 x 128
constexpr uint32_t SLOT = 16 * PLANE;
constexpr uint32_t CL_BYTES = 16 * ROW_POS * 16;   // the bytes that land
// poslane's staging slot: 17 groups of 8 positions, [128 ch][8 pos] each
constexpr int PL_GROUPS = (ROW_POS + 7) / 8;
constexpr uint32_t PL_GROUP = CH * 16;
constexpr uint32_t PL_BYTES = PL_GROUPS * PL_GROUP;
static_assert(PL_BYTES <= SLOT, "the staging slot is a ring slot's size");
constexpr uint32_t OUT_TILE = 64 * NP * 2;         // chlane: a warpgroup's

// after the 1024-byte alignment (the swizzle's period): the ring, then
// chlane's two output tiles or poslane's staging slot, then the barriers
template <int POSLANE>
__host__ __device__ constexpr uint32_t smem_bytes() {
  return 1024 + STAGES * SLOT + (POSLANE ? SLOT : 2 * OUT_TILE) +
         2 * STAGES * 8;
}
static_assert(smem_bytes<0>() <= 232448, "over the 227 KB a block may use");
static_assert(smem_bytes<1>() <= 232448, "over the 227 KB a block may use");

// B (K-major, no swizzle): LBO a k8 plane on, SBO 8 positions on
constexpr uint64_t B_DESC = desc_strides(PLANE, 128);

struct Geo {
  int rows, cols;        // the input's rows and columns an image
  int ny, nx, tr, tc;    // the cell grid
  int nseg;              // 128-position segments a cell row: tc / 128
  int total;             // rows of work in all: b ny nx nseg tr
};

// Where segment s's rows lie: its cell's first input row (in the input seen
// as b * rows rows), first input column, first output row (of b * ny tr)
// and first output column. s = ((n ny + i) nx + j) nseg + seg.
struct Seg {
  int in_row, col0, out_row, ox0;
};
__device__ __forceinline__ Seg seg_of(const Geo& g, int s) {
  const int seg = s % g.nseg;
  s /= g.nseg;
  const int j = s % g.nx;
  s /= g.nx;
  const int i = s % g.ny, n = s / g.ny;
  return {n * g.rows + i * (g.tr + 8), j * (g.tc + 16) + seg * NP,
          (n * g.ny + i) * g.tr, j * g.tc + seg * NP};
}

// this block's rows of work [u0, u1) of the list
__device__ __forceinline__ void block_rows(int total, int& u0, int& u1) {
  const int per = total / (int)gridDim.x, extra = total % (int)gridDim.x;
  const int bid = blockIdx.x;
  u0 = bid * per + min(bid, extra);
  u1 = u0 + per + (bid < extra ? 1 : 0);
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar) : "memory");
}
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// named barrier `id` (1 .. 3; 0 is __syncthreads) of `n` threads
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// four 8 x 8 bf16 matrices of shared memory into the mma fragment, lane l
// giving the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
// and back, each matrix transposed with TRANS
template <int TRANS>
__device__ __forceinline__ void stmatrix4(uint32_t addr, uint32_t r0,
                                          uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  if constexpr (TRANS)
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
        "{%1, %2, %3, %4};\n"
        :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
  else
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
        :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

template <int POSLANE>
__global__ void __launch_bounds__(TM_THREADS, 1)
tap_mm(const __grid_constant__ CUtensorMap xmap,
       const __grid_constant__ CUtensorMap ymap,
       const uint4* __restrict__ wf, Geo g) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = raw + (1024 - raw % 1024) % 1024;
  const uint32_t s_next = sbase + STAGES * SLOT;  // chlane tiles / staging
  const uint32_t s_full = s_next + (POSLANE ? SLOT : 2 * OUT_TILE);
  const uint32_t s_empty = s_full + 8 * STAGES;   // chlane
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(s_full + 8 * s, 1);
      mbar_init(s_empty + 8 * s, TM_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int u0, u1;
  block_rows(g.total, u0, u1);
  const int wg = tid >> 7, wtid = tid & 127, warp = tid >> 5;
  const int lane = tid & 31;

  // The block's loads, in the order the rows take them: for each unit
  // (rows oa .. ob - 1 of a segment) its cell rows oa .. ob + 2. Warp 0
  // sends them; Feed is the next one.
  struct Feed {
    int u, oa, ob, r;
    Seg sg;
  } f = {u0, 0, 0, 0, {}};
  int queued = 0;
  auto unit = [&]() {
    f.oa = f.u % g.tr;
    f.ob = min(g.tr, f.oa + (u1 - f.u));
    f.r = f.oa;
    f.sg = seg_of(g, f.u / g.tr);
  };
  auto advance = [&]() {
    ++queued;
    if (++f.r == f.ob + TAPS - 1) {
      f.u += f.ob - f.oa;
      if (f.u < u1) unit();
    }
  };
  if (u0 < u1) unit();
  // every thread's count of the block's loads: ob - oa + 3 a unit
  int nloads = 0;
  for (int u = u0; u < u1;) {
    const int oa = u % g.tr, ob = min(g.tr, oa + (u1 - u));
    nloads += ob - oa + TAPS - 1;
    u += ob - oa;
  }
  // chlane: loads [queued, n) straight into their slots, each once the
  // eight warps released the load STAGES before it (warp 0 only)
  auto load_until = [&](int n) {
    while (queued < n && f.u < u1) {
      const int slot = queued % STAGES;
      const uint32_t full = s_full + 8 * slot;
      if (lane == 0) {
        mbar_wait(s_empty + 8 * slot, ((queued / STAGES) & 1) ^ 1);
        mbar_expect(full, CL_BYTES);
      }
      __syncwarp();
      if (lane < 16)   // channels 8 lane .. 8 lane + 7
        tma_load3(sbase + slot * SLOT + lane * PLANE, &xmap, 8 * lane,
                  f.sg.col0, f.sg.in_row + f.r, full);
      advance();
    }
  };
  // poslane: the next load into the staging slot, as 17 groups of 8
  // positions (warp 0 only; the slot is free)
  auto stage_next = [&]() {
    if (f.u >= u1) return;
    if (lane == 0) mbar_expect(s_full, PL_BYTES);
    __syncwarp();
    if (lane < PL_GROUPS)
      tma_load3(s_next + lane * PL_GROUP, &xmap, f.sg.col0 + 8 * lane, 0,
                f.sg.in_row + f.r, s_full);
    advance();
  };
  // poslane: staged load `k` transposed into slot k % STAGES by both
  // warpgroups, 8 x 8 blocks (group g, channels 8 k8 ..) as 68 items of
  // four, then warp 0 stages load k + 1
  auto transpose = [&](int k) {
    mbar_wait(s_full, k & 1);            // load k has landed
    if (wtid == 0) bulk_wait_read();     // an output tile's store has read it
    named_sync(3, TM_THREADS);           // slot k % STAGES' readers are done
    const uint32_t dst = sbase + (k % STAGES) * SLOT;
    const int i = lane >> 3, p = lane & 7;
    for (int item = warp; item < PL_GROUPS * 4; item += TM_THREADS / 32) {
      const int grp = item >> 2, k8 = 4 * (item & 3) + i;
      uint32_t r[4];
      ldmatrix4(s_next + grp * PL_GROUP + k8 * 128 + p * 16, r);
      stmatrix4<1>(dst + k8 * PLANE + (8 * grp + p) * 16, r[0], r[1], r[2],
                   r[3]);
    }
    fence_proxy_async();                 // before the products read it
    named_sync(3, TM_THREADS);           // the slot is whole, staging free
    if (tid < 32) stage_next();
  };
  if (tid < 32) {
    if constexpr (POSLANE)
      stage_next();
    else
      load_until(STAGES);
  }

  // this warpgroup's weights: k16 step s's A fragment, 16 bytes a thread
  uint32_t wr[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const uint4 v = __ldg(wf + ((size_t)wg * KSTEPS + s) * 128 + wtid);
    wr[s][0] = v.x;
    wr[s][1] = v.y;
    wr[s][2] = v.z;
    wr[s][3] = v.w;
  }
  const uint32_t tile = s_next + wg * OUT_TILE;   // chlane
  float acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.0f;   // each row overwrites them
  int L = 0;    // the unit's first load
  int T = 0;    // poslane: loads transposed
  for (int u = u0; u < u1;) {
    const int oa = u % g.tr, ob = min(g.tr, oa + (u1 - u));
    const Seg sg = seg_of(g, u / g.tr);
    for (int o = oa; o < ob; ++o) {
      // taps t read the unit's rows o - oa + t, loads lr + t
      const int lr = L + (o - oa);
      if constexpr (POSLANE) {
        while (T <= lr + TAPS - 1) transpose(T++);
      } else {
#pragma unroll
        for (int t = 0; t < TAPS; ++t)
          mbar_wait(s_full + 8 * ((lr + t) % STAGES),
                    ((lr + t) / STAGES) & 1);
      }
      // the 32 products as one group
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        const uint32_t b0 = sbase + ((lr + t) % STAGES) * SLOT + 16 * t;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          mma_k16_rs128(acc, wr[8 * t + ks],
                        B_DESC | desc_addr(b0 + 2 * ks * PLANE),
                        (t | ks) != 0);
      }
      wgmma_commit();
      // poslane: the next row's load into the slot the last row freed,
      // while the products run
      if constexpr (POSLANE)
        if (T == lr + TAPS && T < nloads) transpose(T++);
      wgmma_wait<0>();
      fence_acc(acc);
      if constexpr (!POSLANE) {
        // load lr is read for the last time (and at the unit's end the
        // three after it); warp 0 refills the slot
        for (int k = 0; k < (o == ob - 1 ? TAPS : 1); ++k) {
          if (lane == 0) mbar_arrive(s_empty + 8 * ((lr + k) % STAGES));
          if (tid < 32) load_until(lr + k + 1 + STAGES);
        }
      }

      // epilogue. Fragment (warp w of the warpgroup, lane l): d[4j + 2h + e]
      // is channel 64 wg + 16w + l/4 + 8h, position 8j + 2(l % 4) + e.
      const int w4 = warp & 3;
      const int p = lane & 7, mh = (lane >> 3) & 1, mj = lane >> 4;
      if constexpr (POSLANE) {
        // into load lr's slot, which no row reads once both warpgroups are
        // done with this one: the warpgroup's two [64 channels][64
        // positions] tiles, 128-byte swizzle; stmatrix takes matrices (h, j)
        // four at a time, (0, j), (1, j), (0, j + 1), (1, j + 1), lane l
        // addressing row l % 8 of matrix l / 8
        named_sync(3, TM_THREADS);
        const uint32_t ptile = sbase + (lr % STAGES) * SLOT + wg * OUT_TILE;
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          const int j = 2 * jp + mj;
          stmatrix4<0>(ptile + (j >> 3) * 8192 + (16 * w4 + 8 * mh + p) * 128 +
                           (((j & 7) ^ p) << 4),
                       bf16x2(acc[8 * jp], acc[8 * jp + 1]),
                       bf16x2(acc[8 * jp + 2], acc[8 * jp + 3]),
                       bf16x2(acc[8 * jp + 4], acc[8 * jp + 5]),
                       bf16x2(acc[8 * jp + 6], acc[8 * jp + 7]));
        }
        fence_proxy_async();   // the tile's stores, before the TMA reads it
        named_sync(1 + wg, 128);
        if (wtid == 0) {   // [b oh][128 ch][ow], two boxes of 64 positions
          tma_store3(&ymap, ptile, sg.ox0, 64 * wg, sg.out_row + o);
          tma_store3(&ymap, ptile + 8192, sg.ox0 + 64, 64 * wg,
                     sg.out_row + o);
          bulk_commit();
        }
      } else {
        // the tile is free once the last row's store has read it
        if (wtid == 0) bulk_wait_read();
        named_sync(1 + wg, 128);
        // [position][64 channels], 128-byte swizzle; stmatrix transposes
        // the matrices, taken as above
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          const int j = 2 * jp + mj;
          stmatrix4<1>(tile + (8 * j + p) * 128 + (((2 * w4 + mh) ^ p) << 4),
                       bf16x2(acc[8 * jp], acc[8 * jp + 1]),
                       bf16x2(acc[8 * jp + 2], acc[8 * jp + 3]),
                       bf16x2(acc[8 * jp + 4], acc[8 * jp + 5]),
                       bf16x2(acc[8 * jp + 6], acc[8 * jp + 7]));
        }
        fence_proxy_async();   // the tile's stores, before the TMA reads it
        named_sync(1 + wg, 128);
        if (wtid == 0) {
          tma_store3(&ymap, tile, 64 * wg, sg.ox0, sg.out_row + o);
          bulk_commit();
        }
      }
    }
    L += (ob - oa) + TAPS - 1;
    u += ob - oa;
  }
  if (wtid == 0) bulk_wait_read();   // shared memory outlives the stores
}

// a bf16 tensor of dims (d0, d1, d2), innermost first, d1 and d2 s1 and s2
// bytes apart, in boxes of (b0, b1, 1), with the 128-byte swizzle or none
cudaError_t make_map(CUtensorMap* map, const void* base, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                     uint32_t b0, uint32_t b1, bool swizzle) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int POSLANE>
cudaError_t launch(const void* x, const void* wf, void* out, int b,
                   const Geo& g, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  constexpr int need = (int)smem_bytes<POSLANE>();
  auto kernel = tap_mm<POSLANE>;
  // over 48 KB of dynamic shared memory is refused without this
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             need);
  if (err != cudaSuccess) return err;
  const uint64_t rows = (uint64_t)b * g.rows, cols = g.cols;
  const uint64_t oh = (uint64_t)b * g.ny * g.tr, ow = (uint64_t)g.nx * g.tc;
  CUtensorMap xmap, ymap;
  if (!POSLANE) {   // [b rows][cols][128] in, [b oh][ow][128] out
    err = make_map(&xmap, x, CH, cols, rows, 2 * CH, 2 * CH * cols, 8,
                   ROW_POS, false);
    if (err == cudaSuccess)
      err = make_map(&ymap, out, CH, ow, oh, 2 * CH, 2 * CH * ow, 64, NP,
                     true);
  } else {          // [b rows][128][cols] in, [b oh][128][ow] out
    err = make_map(&xmap, x, cols, CH, rows, 2 * cols, 2 * CH * cols, 8, CH,
                   false);
    if (err == cudaSuccess)
      err = make_map(&ymap, out, ow, CH, oh, 2 * ow, 2 * CH * ow, 64, 64,
                     true);
  }
  if (err != cudaSuccess) return err;
  const int blocks = g.total < sms ? g.total : sms;
  kernel<<<(unsigned)blocks, TM_THREADS, need, s>>>(
      xmap, ymap, static_cast<const uint4*>(wf), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The four-tap layer on `stream`: layout 0 (chlane) or 1 (poslane); x the
// input of b images of `rows` x `cols` positions (chlane [b, rows, cols,
// 128], poslane [b, rows, 128, cols]), wf the weights in the kernel's
// register order [2][32][128][8] bf16 (ops/probe.py:pack_tap_mm), out as
// above for the (ny, nx) grid of (tr, tc) cells. tr >= 1, tc a multiple of
// 128, cols a multiple of 8, the cells' blocks inside the input (ny (tr+8)
// <= rows, nx (tc+16) <= cols) and the pointers 16-byte aligned. Returns the
// cudaError_t of the launch.
int w2x_tap_mm(int layout, const void* x, const void* wf, void* out, int b,
               int rows, int cols, int ny, int nx, int tr, int tc,
               void* stream) {
  if ((layout != 0 && layout != 1) || b <= 0 || ny <= 0 || nx <= 0 ||
      tr <= 0 || tc <= 0 || tc % NP || cols % 8 ||
      (long long)ny * (tr + 8) > rows || (long long)nx * (tc + 16) > cols ||
      (long long)b * rows > INT_MAX ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wf) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * ny * nx * (tc / NP) * tr;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  const Geo g = {rows, cols, ny, nx, tr, tc, tc / NP, (int)total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(layout ? launch<1>(x, wf, out, b, g, s)
                      : launch<0>(x, wf, out, b, g, s));
}

}  // extern "C"
