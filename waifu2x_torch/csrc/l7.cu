// Layer 7 (128 -> 1) of every stack call as the JAX body's folded tap
// product, on Hopper (sm_90a): in bf16 on the tensor cores (l7_fold), in f32
// with FFMA (l7_fold_f32), from one layer-6 plane an image or from the int8
// layer 6's tile-major planes. Built with nvcc into a shared library with a
// plain C interface and loaded with ctypes (waifu2x_torch/ops/_build.py); the
// Python side is ops/stack.py (_Launcher.l7_fold, last_layer,
// last_layer_tiles, l7_fold_plain, l7_tiles_plain).
//
// Replaces: waifu2x_tpu/ops/pallas_stack.py:_stack_body's layer 7 with
// l7_fold (the tap product of each layer-6 phase, :489-508, and the
// shift-sum and the three epilogues, :603-655), for configurations B1, B2,
// B3, B6, B5's stack and B4's (the int8 branch, :551-585, ends in the same
// l7_tap), in both storage types; and, under a zero-shift mask, the layer 7
// of tools/shift_cost_probe.py:156 (its shift-sum :136-141 reads the cell
// Dy*fy, Dx*fx: the same fold with a factor forced to 0); and the
// truncation's two tap forms (stack_scale_upto at upto 6, the JAX body's
// :600-601 with zt from l7_tap; tools/layer_time_probe.py:78,
// fused_strip_probe.py:162).
//
// What it computes, on x6 [P, 2hl+2, 2wl+2, 128] (NHWC, bf16 or f32) and
// the folded weights W [512, 16] (ops/s2d.py:pack_l7_fold) in x6's type:
//   the x6 cell (I, J), 0 <= I <= hl, 0 <= J <= wl, is pixels
//   2I..2I+1 x 2J..2J+1, its 512 values in lanes (a*2 + b)*128 + c;
//   Zt[I, J, s*4 + q] = sum over the 512 of cell[k] * W[k, s*4 + q]
//                       (exact products, f32 sums);
//   Y[i, j, q] = ((Zt[i, j, q] + Zt[i, j+1, 4+q]) + Zt[i+1, j, 8+q])
//                + Zt[i+1, j+1, 12+q]              (s = Dy*2 + Dx in order)
//   or, under the zero-shift mask ZS (s2d output on one plane an image
//   only; bit 0 sets fx = 0, bit 1 fy = 0, else fx = fy = 1), the same sum
//   of Zt[i + Dy*fy, j + Dx*fx, s*4 + q]: a zeroed axis reads the cell's
//   own row or column of Zt. ZS is a template parameter; ZS = 0 is the
//   code above.
//   then the bias and LeakyReLU in f32, and one of three epilogues on that
//   one f32 Y, at the image's cell; or one of the two tap forms:
//     OUT_TAPS   Zt[i, j, 0:4] (s = 0: the taps that lie in the cell's own
//                2 x 2 pixels), no shift-sum, no bias, no LeakyReLU, in x6's
//                type (bf16 rounded once), [N, oh, ow, 4];
//     OUT_PTAPS  the same from W = pack_l7_ptaps(w7) (bf16), whose rows
//                0-127 hold w7's taps 0-3 and the rest zeros, or in f32 from
//                w7's taps 0-3 directly: sum over c of x6[2i, 2j, c] *
//                w7[c, t], the unfolded partials of the cell's pixel (0, 0).
//                Only that pixel is read: the tile's boxes of pixel row 0 and
//                column parity 0, a quarter of x6, and the products over
//                its 128 inputs alone;
//     OUT_S2D    Y in x6's type (bf16 rounded once), [N, oh, ow, 4];
//     OUT_DENSE  the same phase-chunked, [N, oh, ceil(ow/tc)*4*tc], zeros in
//                the last chunk's columns past ow (common.cuh's layout; tc
//                the dense chunk);
//     OUT_U8     Y never rounded: the YUV -> BGR map of common.cuh with
//                __fmul_rn / __fadd_rn and the image cell's 8 U/V phases,
//                16 bytes a cell, lanes 12:16 zero.
//   One plane an image: P = N, hl x wl = oh x ow. The int8 layer 6's
//   tile-major x6t [N, ny, nx, 2tr+2, 2tc+2, 128] (common.cuh: Tiles) is,
//   byte for byte, P = N*ny*nx planes of hl x wl = tr x tc cells: plane
//   (b, ty, tx)'s cell (i, j) is the image's cell (ty*tr + i, tx*tc + j),
//   and cells past oh or ow (the stack ran on the plane edge-extended to the
//   tile grid) are not written: the crop. Only the output address differs;
//   the reading, the products and the walk below are the same.
//
// What bounds it on an H100: the bytes. x6 is read once (1 KB a cell in
// bf16: 4.31 GB at scale512, 1.29 ms at 3.35 TB/s; the int8 stack's
// tile-major planes at scale512, 16 x 8 x 4 tiles of 130 x 258 pixels, 4.40
// GB, 1.31 ms; 2 KB in f32: 4.26 GB at ns1080, 1.27 ms); Y is 1/128 of that.
// The products are 2 x 512 x 16 per cell, 0.07 ms of the bf16 peak; in f32
// only the 4 x 9 x 128 that W does not hold as zeros are issued, 0.29 ms of
// the 67 TFLOP/s FFMA peak at ns1080. The FFMA kernels they replace read
// each pixel in 16-32-byte pieces 512 bytes apart from their neighbours'
// and ran at about a tenth of the memory rate. OUT_TAPS reads all of x6 as
// the other forms do; OUT_PTAPS a quarter of it (pixel (0, 0) of each
// cell: 256 contiguous bytes of every 512 in the even pixel rows, 0.33 ms
// at scale512 in bf16), so its tiles are a quarter of the size and its ring
// four times as deep (12 tiles, the same bytes in flight).
//
// Design (both types):
//   * A tile is a run of consecutive cells of one cell row: the two pixel
//     rows' pixels, contiguous in x6. The Tensor Memory Accelerator copies
//     it into shared memory as boxes of 128-byte rows with the 128-byte
//     swizzle: x6 seen as the 4-d tensor (channel, column parity, cell
//     column, pixel row of all planes), one box for each pixel row a,
//     column parity b and 128 bytes of channels. One thread issues a
//     tile's copies on an mbarrier that counts its bytes; cells past the
//     plane's edge read zero.
//   * Zt of a tile, 64 B a cell, goes to one of two shared buffers: this
//     cell row's and the previous one's. Y of cell row i is formed from the
//     two.
//   * A strip is a tile's width less one cell (its last cell is the column
//     halo). The strips of all planes, cut into output rows, are one list
//     of rows shared out evenly over a persistent grid of one block an SM:
//     a block walks down its rows, each run of rows of one strip starting
//     with one halo tile row, so that every x6 byte is read once but for
//     the halo column and a row at each run's start. A ring of 3 tiles
//     keeps two tiles in flight while the third is multiplied. (Staged by
//     16-byte cp.async copies from the block's four warps instead, the bf16
//     tile ran at about half the memory rate, with or without the products:
//     the copies in flight bound that form.) On the int8 tile-major planes
//     a tile row of tc = 128 cells is 63 + 63 + 2 output cells (bf16) or
//     31 x 4 + 4 (f32): the last strip's tile reads a few cells and zero
//     fill, and costs a loop iteration (PERF.md has its price).
//   * The tensor map is made at each launch (cuTensorMapEncodeTiled, reached
//     through the runtime's driver entry point, so the library links no
//     libcuda) and passed as a __grid_constant__ parameter.
// bf16 (l7_fold): a tile is 64 cells, eight boxes of 64 cells x 64
//   channels, which as they land are a K-major wgmma operand (cells the M
//   rows, 64 inputs of K a box). One warpgroup multiplies the tile by W,
//   resident in shared memory, as 32 wgmma m64n16k16 (f32 sums in 8
//   registers a thread).
// f32 (l7_fold_f32): a tile of 64 f32 cells would be 128 KB, and a ring of
//   three would not fit the 227 KB a block may use, so a tile is 32 cells
//   (64 KB), 16 boxes of 32 cells x 32 channels. The tensor cores are not
//   needed (the FFMA floor is under the byte bound) and W is mostly zeros,
//   so the products are FFMA on the 9 taps of w7 that a pixel feeds: a
//   pixel (a, b) of the cell, through tap (dy, dx), feeds lane s*4 + q with
//   dy = 2Dy + a - A, dx = 2Dx + b - B (pack_l7_fold's rule), 36 FFMA a
//   channel, 4608 a cell. Eight warps split the 128 channels, 16 each; a
//   lane is a cell, so a warp's 16-byte reads of one channel chunk of 32
//   cells hit 32 different banks through the swizzle, and w7's taps are
//   read as broadcasts. Each warp's 16 partial sums a cell go to shared
//   memory and are added in warp order, then Y follows as in bf16. The
//   partial sums are the fold's, in another order than l7_fold_plain's
//   f32 product: within 3e-5 of it.

#include <cuda.h>
#include <limits.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int L7_STAGES = 3;
constexpr int L7_STAGES_PT = 12;             // OUT_PTAPS: quarter tiles
constexpr int L7_ZP = 20;                    // a cell's Zt row, floats
// bf16
constexpr int L7_THREADS = 128;              // one warpgroup
constexpr int L7_CELLS = 64;                 // cells a tile: one m64 block
constexpr int L7_K8 = 4 * 128 / 8;           // k8 groups of a cell: 64
constexpr uint32_t L7_BOX_BYTES = L7_CELLS * 128;   // 64 cells x 64 channels
constexpr uint32_t L7_TILE_BYTES = 8 * L7_BOX_BYTES;
constexpr uint32_t L7_W_BYTES = L7_K8 * 16 * 16;
// the ring's tiles start 1024-byte aligned (the 128-byte swizzle's period);
// the dynamic window is aligned up to that first
constexpr uint32_t L7_RING = L7_STAGES * L7_TILE_BYTES;
static_assert(L7_STAGES_PT * 2 * L7_BOX_BYTES == L7_RING, "one ring size");
constexpr uint32_t L7_SMEM = 1024 + L7_RING + L7_W_BYTES +
                             2 * L7_CELLS * L7_ZP * 4 + L7_STAGES_PT * 8;
static_assert(L7_SMEM <= 232448, "over the 227 KB a block may use");
// f32
constexpr int F7_THREADS = 256;              // eight warps, 16 channels each
constexpr int F7_CELLS = 32;                 // cells a tile: one a lane
constexpr uint32_t F7_BOX_BYTES = F7_CELLS * 128;   // 32 cells x 32 channels
constexpr uint32_t F7_TILE_BYTES = 16 * F7_BOX_BYTES;
constexpr uint32_t F7_W_BYTES = 32 * 9 * 16;        // w7 as [c4][tap][4]
constexpr uint32_t F7_PART_BYTES = 8 * F7_CELLS * L7_ZP * 4;
constexpr uint32_t F7_RING = L7_STAGES * F7_TILE_BYTES;
static_assert(L7_STAGES_PT * 4 * F7_BOX_BYTES == F7_RING, "one ring size");
constexpr uint32_t F7_SMEM = 1024 + F7_RING + F7_W_BYTES + F7_PART_BYTES +
                             2 * F7_CELLS * L7_ZP * 4 + L7_STAGES_PT * 8;
static_assert(F7_SMEM <= 232448, "over the 227 KB a block may use");

template <typename T>
struct L7Args {
  const T* w;               // bf16: W [512][16]; f32: w7 [128][9]
  const float* b;           // [1]
  void* y;
  const float* uvp;         // OUT_U8: [N, oh, ow, 8]
  ColorMap cm;              // OUT_U8
  int hl, wl;               // a plane's output cells: the image's, or a tile's
  int nstrips;              // strips a plane row
  int rows;                 // planes * nstrips * hl output rows in all
  int ny, nx;               // the tile grid of an image (1 x 1: one plane)
  int wlast;                // cells a strip walk of the last tile column
                            // writes (the dense pad columns included)
  int oh, ow;               // the image's cells
  int ocols;                // columns written a row: ow, or the dense
                            // chunks' nx_d * tc
  int tc;                   // OUT_DENSE: the chunk width
};

// A position in a block's list of tiles: output row u = ((n * nstrips +
// strip) * hl + row) of plane n, and whether this is the halo tile of a
// run's start (cell row `row`, no output) or the tile that completes output
// row `row` (cell row row + 1). Kept as its parts, so that walking the list
// takes no division.
struct Cursor {
  int u, row, strip, n;
  bool head;

  __device__ Cursor(int u0, int hl, int nstrips)
      : u(u0), row(u0 % hl), strip((u0 / hl) % nstrips),
        n(u0 / hl / nstrips), head(true) {}

  __device__ void advance(int hl, int nstrips) {
    if (head) {
      head = false;
      return;
    }
    ++u;
    if (++row == hl) {   // the next strip's run starts with its halo
      row = 0;
      head = true;
      if (++strip == nstrips) {
        strip = 0;
        ++n;
      }
    }
  }
  // the first pixel row of the tile's cell row, in x6 seen as one plane of
  // n * (2hl + 2) rows
  __device__ int pixel_row(int hl) const {
    return n * (2 * hl + 2) + 2 * (row + (head ? 0 : 1));
  }
};

// this block's output rows [u0, u1) of the list
__device__ __forceinline__ void block_rows(int rows, int& u0, int& u1) {
  const int per = rows / (int)gridDim.x, extra = rows % (int)gridDim.x;
  const int bid = blockIdx.x;
  u0 = bid * per + min(bid, extra);
  u1 = u0 + per + (bid < extra ? 1 : 0);
}

// Y of a plane's output cell from Zt of its cell row (zp) and the next
// (z), both at its column's cell, then the bias, LeakyReLU and the form, at
// the image's cell (i, j) of image n. Under the mask ZS a zeroed axis reads
// the cell's own column (zp, z in place of the next cell's) or row (zp in
// place of z).
template <int OUT_MODE, int ZS, typename T>
__device__ __forceinline__ void l7_out(const L7Args<T>& a, const float* zp,
                                       const float* z, int n, int i, int j,
                                       float bias) {
  if constexpr (OUT_MODE == OUT_TAPS || OUT_MODE == OUT_PTAPS) {
    // the tap forms: Zt's lanes 0-3 of the cell itself, rounded once
    const float4 zc = *reinterpret_cast<const float4*>(zp);
    const float yv[4] = {zc.x, zc.y, zc.z, zc.w};
    store4(static_cast<T*>(a.y) + (((size_t)n * a.oh + i) * a.ow + j) * 4,
           yv);
    return;
  }
  constexpr int DX = (ZS & 1) ? 0 : L7_ZP;   // the cell j + fx
  const float* zr = (ZS & 2) ? zp : z;       // the cell row i + fy
  const float4 z0 = *reinterpret_cast<const float4*>(zp);
  const float4 z1 = *reinterpret_cast<const float4*>(zp + DX + 4);
  const float4 z2 = *reinterpret_cast<const float4*>(zr + 8);
  const float4 z3 = *reinterpret_cast<const float4*>(zr + DX + 12);
  float yv[4] = {((z0.x + z1.x) + z2.x) + z3.x,
                 ((z0.y + z1.y) + z2.y) + z3.y,
                 ((z0.z + z1.z) + z2.z) + z3.z,
                 ((z0.w + z1.w) + z2.w) + z3.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) yv[q] = leaky(yv[q] + bias);
  const size_t cell = ((size_t)n * a.oh + i) * a.ow + j;
  if constexpr (OUT_MODE == OUT_S2D) {
    store4(static_cast<T*>(a.y) + cell * 4, yv);
  } else if constexpr (OUT_MODE == OUT_DENSE) {
    T* yd = static_cast<T*>(a.y) + ((size_t)n * a.oh + i) * a.ocols * 4 +
            (size_t)(j / a.tc) * 4 * a.tc + j % a.tc;
    const bool pad = j >= a.ow;   // the last chunk's pad columns
#pragma unroll
    for (int q = 0; q < 4; ++q)
      store1(yd + (size_t)q * a.tc, pad ? 0.0f : yv[q]);
  } else {
    const float4 u4 = reinterpret_cast<const float4*>(a.uvp)[cell * 2];
    const float4 v4 = reinterpret_cast<const float4*>(a.uvp)[cell * 2 + 1];
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    uint32_t word[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      word[c] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // no fmaf: each product and sum rounded on its own
        float val = __fadd_rn(__fmul_rn(yv[q], a.cm.inv[c][0]),
                              __fmul_rn(u[q], a.cm.inv[c][1]));
        val = __fadd_rn(val, __fmul_rn(v[q], a.cm.inv[c][2]));
        val = __fmul_rn(__fadd_rn(val, a.cm.off[c]), 255.0f);
        val = fminf(fmaxf(rintf(val), 0.0f), 255.0f);
        word[c] |= static_cast<uint32_t>(val) << (8 * q);
      }
    }
    static_cast<uint4*>(a.y)[cell] = make_uint4(word[0], word[1], word[2], 0u);
  }
}

// Output cell `col` (0 .. OUT-1) of strip cc's row, from Zt of the tile's
// cell row (z) and the one above (zp), written at its image cell unless it
// lies past the image (the crop) or, in a tile that is not its grid row's
// last, past the tile (the next tile's cell).
template <int OUT_MODE, int ZS, int OUT, typename T>
__device__ __forceinline__ void l7_cell(const L7Args<T>& a, const Cursor& cc,
                                        int col, const float* zp,
                                        const float* z, float bias) {
  const int j = cc.strip * OUT + col;
  const int tx = cc.n % a.nx, rest = cc.n / a.nx;
  const int ty = rest % a.ny, img = rest / a.ny;
  const int I = ty * a.hl + cc.row, J = tx * a.wl + j;
  if (j < (tx == a.nx - 1 ? a.wlast : a.wl) && I < a.oh && J < a.ocols)
    l7_out<OUT_MODE, ZS>(a, zp, z, img, I, J, bias);
}

template <int OUT_MODE, int ZS>
__global__ void __launch_bounds__(L7_THREADS, 1)
l7_fold(const __grid_constant__ CUtensorMap xmap, L7Args<__nv_bfloat16> a) {
  constexpr int OUT = L7_CELLS - 1;   // output cells of a strip
  // OUT_PTAPS: the two boxes of pixel (0, 0), its 128 inputs' 8 k16 steps
  constexpr bool PT = OUT_MODE == OUT_PTAPS;
  constexpr int BOXES = PT ? 2 : 8, STAGES = PT ? L7_STAGES_PT : L7_STAGES;
  constexpr uint32_t TILE = BOXES * L7_BOX_BYTES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t s_w = sbase + L7_RING;
  float* zt = reinterpret_cast<float*>(smem + L7_RING + L7_W_BYTES);
  const uint32_t s_bar = s_w + L7_W_BYTES + 2 * L7_CELLS * L7_ZP * 4;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(s_bar + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // W [512][16] -> [k8][n][8]: a K-major B operand, core matrices of 8
  // output lanes x 8 inputs
  {
    const uint16_t* wg = reinterpret_cast<const uint16_t*>(a.w);
    uint16_t* ws = reinterpret_cast<uint16_t*>(smem + L7_RING);
    for (int i = tid; i < 512 * 16; i += L7_THREADS)
      ws[((i >> 7) * 16 + (i & 15)) * 8 + ((i >> 4) & 7)] = wg[i];
  }

  int u0, u1;
  block_rows(a.rows, u0, u1);
  // the tile at c into ring stage st (nothing past the list's end): eight
  // boxes of 64 cells x 64 channels, one for each pixel row a, column
  // parity b and half of the channels, box (a*2 + b)*2 + h holding inputs
  // k = ((a*2 + b)*2 + h)*64 + c of the cells (OUT_PTAPS: boxes 0 and 1),
  // issued by one thread
  auto load = [&](const Cursor& c, int st) {
    if (tid == 0 && c.u < u1) {
      const uint32_t bar = s_bar + 8 * st;
      mbar_expect(bar, TILE);
      const int row = c.pixel_row(a.hl);
      for (int box = 0; box < BOXES; ++box)
        tma_load4(sbase + st * TILE + box * L7_BOX_BYTES, &xmap,
                 64 * (box & 1), (box >> 1) & 1, c.strip * OUT,
                 row + (box >> 2), bar);
    }
  };

  Cursor pc(u0, a.hl, a.nstrips);
  Cursor cc = pc;
  fence_proxy_async();   // W's stores, before the products read them
  __syncthreads();       // and the barriers' initialisation
  for (int s = 0; s < STAGES - 1; ++s) {
    load(pc, s);
    pc.advance(a.hl, a.nstrips);
  }
  // A: K-major, 128-byte swizzle (layout type 1), SBO 8 cells (1024 B) on;
  // B: no swizzle, LBO a k8 group (16 lanes x 16 B) on, SBO 8 lanes on
  constexpr uint64_t a_str = desc_strides(16, 1024) | (1ull << 62);
  constexpr uint64_t b_str = desc_strides(16 * 16, 128);
  const float bias = a.b[0];
  const int lane = tid & 31, w4 = tid >> 5;
  int t = 0, zb = 0;
  while (cc.u < u1) {
    const int st = t % STAGES;
    __syncthreads();   // every thread is done with stage t-1's tile
    load(pc, (t + STAGES - 1) % STAGES);
    pc.advance(a.hl, a.nstrips);
    mbar_wait(s_bar + 8 * st, (t / STAGES) & 1);   // tile t has landed

    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    const uint32_t ta = sbase + st * TILE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * BOXES; ++ks)   // box ks / 4, 32 bytes a step
      mma_k16<16>(acc, a_str | desc_addr(ta + (ks >> 2) * L7_BOX_BYTES +
                                         (ks & 3) * 32),
                  b_str | desc_addr(s_w + 2 * ks * 16 * 16));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    // Zt of this tile: thread (warp w4, lane l) holds cells 16 w4 + l/4
    // (+ 8), lanes 8j + 2(l % 4) + {0, 1}
    float* z = zt + zb * L7_CELLS * L7_ZP;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            z + (16 * w4 + (lane >> 2) + 8 * h) * L7_ZP + 8 * j +
            2 * (lane & 3)) = make_float2(acc[4 * j + 2 * h],
                                          acc[4 * j + 2 * h + 1]);
    __syncthreads();

    if (!cc.head && tid < OUT)
      l7_cell<OUT_MODE, ZS, OUT>(a, cc, tid,
                             zt + (zb ^ 1) * L7_CELLS * L7_ZP + tid * L7_ZP,
                             z + tid * L7_ZP, bias);
    zb ^= 1;
    ++t;
    cc.advance(a.hl, a.nstrips);
  }
}

// One lane of a float4 by a compile-time index.
__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int OUT_MODE, int ZS>
__global__ void __launch_bounds__(F7_THREADS, 1)
l7_fold_f32(const __grid_constant__ CUtensorMap xmap, L7Args<float> a) {
  constexpr int OUT = F7_CELLS - 1;   // output cells of a strip
  // OUT_TAPS: lanes s = 0 only; OUT_PTAPS: the four boxes of pixel (0, 0)
  // and its products with taps 0-3
  constexpr bool TAPS = OUT_MODE == OUT_TAPS, PT = OUT_MODE == OUT_PTAPS;
  constexpr int BOXES = PT ? 4 : 16, STAGES = PT ? L7_STAGES_PT : L7_STAGES;
  constexpr uint32_t TILE = BOXES * F7_BOX_BYTES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t sbase = smem_addr(smem);
  float4* s_w = reinterpret_cast<float4*>(smem + F7_RING);
  float* part = reinterpret_cast<float*>(smem + F7_RING + F7_W_BYTES);
  float* zt = part + F7_PART_BYTES / 4;
  const uint32_t s_bar = sbase + F7_RING + F7_W_BYTES + F7_PART_BYTES +
                         2 * F7_CELLS * L7_ZP * 4;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(s_bar + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // w7 [128][9] -> [c4][tap][4]: the taps of four channels in one float4
  for (int i = tid; i < 128 * 9; i += F7_THREADS)
    reinterpret_cast<float*>(s_w)[((i / 36) * 9 + i % 9) * 4 + (i / 9) % 4] =
        a.w[i];

  int u0, u1;
  block_rows(a.rows, u0, u1);
  // the tile at c into ring stage st: sixteen boxes of 32 cells x 32
  // channels, box (a*2 + b)*4 + h holding channels 32h .. 32h + 31 of pixel
  // (a, b) of the cells (OUT_PTAPS: boxes 0-3), issued by one thread
  auto load = [&](const Cursor& c, int st) {
    if (tid == 0 && c.u < u1) {
      const uint32_t bar = s_bar + 8 * st;
      mbar_expect(bar, TILE);
      const int row = c.pixel_row(a.hl);
      for (int box = 0; box < BOXES; ++box)
        tma_load4(sbase + st * TILE + box * F7_BOX_BYTES, &xmap,
                 32 * (box & 3), (box >> 2) & 1, c.strip * OUT,
                 row + (box >> 3), bar);
    }
  };

  Cursor pc(u0, a.hl, a.nstrips);
  Cursor cc = pc;
  __syncthreads();       // w7's stores and the barriers' initialisation
  for (int s = 0; s < STAGES - 1; ++s) {
    load(pc, s);
    pc.advance(a.hl, a.nstrips);
  }
  const float bias = a.b[0];
  const int lane = tid & 31, warp = tid >> 5;
  // warp w: channels 16w .. 16w + 15, the 16-byte chunks (w & 1) * 4 + jj
  // of the 128-byte rows of the boxes of channel quarter w / 2; lane: cell
  const uint32_t row_off = (warp >> 1) * F7_BOX_BYTES + lane * 128;
  int t = 0, zb = 0;
  while (cc.u < u1) {
    const int st = t % STAGES;
    __syncthreads();   // every thread is done with stage t-1's tile
    load(pc, (t + STAGES - 1) % STAGES);
    pc.advance(a.hl, a.nstrips);
    mbar_wait(s_bar + 8 * st, (t / STAGES) & 1);   // tile t has landed

    const uint8_t* tile = smem + st * TILE + row_off;
    float acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int chunk = ((warp & 1) * 4 + jj) ^ (lane & 7);   // swizzled
      constexpr int PX = PT ? 1 : 4;   // pixels read
      float4 xv[PX];
#pragma unroll
      for (int p = 0; p < PX; ++p)   // pixel (a, b) = (p / 2, p % 2)
        xv[p] = *reinterpret_cast<const float4*>(
            tile + p * 4 * F7_BOX_BYTES + chunk * 16);
      float4 wv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wv[k] = s_w[(4 * warp + jj) * 9 + k];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const float x = lane4(xv[p], e);
          if constexpr (PT) {   // lane t: pixel (0, 0) through tap t
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[q] = fmaf(x, lane4(wv[q], e), acc[q]);
            continue;
          }
#pragma unroll
          for (int s = 0; s < (TAPS ? 1 : 4); ++s)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              // known at compile time: the tap of pixel p into lane s*4+q
              const int dy = 2 * (s >> 1) + (p >> 1) - (q >> 1);
              const int dx = 2 * (s & 1) + (p & 1) - (q & 1);
              if (dy < 0 || dy > 2 || dx < 0 || dx > 2) continue;
              acc[s * 4 + q] =
                  fmaf(x, lane4(wv[dy * 3 + dx], e), acc[s * 4 + q]);
            }
        }
    }
    float* pw = part + (warp * F7_CELLS + lane) * L7_ZP;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(pw + 4 * k) =
          make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                      acc[4 * k + 3]);
    __syncthreads();

    // Zt of this tile: the eight warps' partial sums added in warp order,
    // two lanes of one cell a thread
    float* z = zt + zb * F7_CELLS * L7_ZP;
    {
      const int cell = tid >> 3, k = 2 * (tid & 7);
      float2 sum = *reinterpret_cast<const float2*>(part + cell * L7_ZP + k);
#pragma unroll
      for (int w = 1; w < 8; ++w) {
        const float2 v = *reinterpret_cast<const float2*>(
            part + (w * F7_CELLS + cell) * L7_ZP + k);
        sum.x += v.x;
        sum.y += v.y;
      }
      *reinterpret_cast<float2*>(z + cell * L7_ZP + k) = sum;
    }
    __syncthreads();

    if (!cc.head && tid < OUT)
      l7_cell<OUT_MODE, ZS, OUT>(a, cc, tid,
                             zt + (zb ^ 1) * F7_CELLS * L7_ZP + tid * L7_ZP,
                             z + tid * L7_ZP, bias);
    zb ^= 1;
    ++t;
    cc.advance(a.hl, a.nstrips);
  }
}

// x [n, 2hl+2, 2wl+2, 128] as the 4-d tensor (channel, column parity, cell
// column, pixel row of all n planes), boxes of 128 bytes of channels x 1 x
// `cells` cells x 1 row with the 128-byte swizzle (64 channels in bf16, 32
// in f32); cells past wl read zero
cudaError_t make_map(CUtensorMap* map, const void* x, int bf16, int n, int hl,
                     int wl, int cells) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const uint64_t size = bf16 ? 2 : 4, w6 = 2 * (uint64_t)wl + 2;
  const cuuint64_t dims[4] = {128, 2, (cuuint64_t)wl + 1,
                              (cuuint64_t)n * (2 * hl + 2)};
  const cuuint64_t strides[3] = {128 * size, 256 * size, w6 * 128 * size};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / size), 1, (cuuint32_t)cells,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(x), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch of `kernel` over a.rows output rows on a persistent grid (no
// more blocks than SMs), the tensor map of x's `planes` planes in tiles of
// `cells` cells.
template <typename T>
cudaError_t launch(void (*kernel)(const CUtensorMap, L7Args<T>),
                   uint32_t smem, int threads, int cells, const void* x,
                   int planes, const L7Args<T>& a, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  // over 48 KB of dynamic shared memory is refused without this
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = make_map(&map, x, sizeof(T) == 2, planes, a.hl, a.wl, cells);
  if (err != cudaSuccess) return err;
  const int blocks = a.rows < sms ? a.rows : sms;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(map, a);
  return cudaGetLastError();
}

// The checks and the launch arguments of both types -> the planes of x
// (0 on a bad argument); `cells` is the tile's width, one more than a
// strip's. qt.tr == 0: one plane an image.
template <typename T>
int fold_args(L7Args<T>& a, const void* w, const void* b, void* y, int n,
              int hl, int wl, int out_mode, const void* uvp,
              const float* cmap, int tc, const Tiles& qt, int cells) {
  a.w = static_cast<const T*>(w);
  a.b = static_cast<const float*>(b);
  a.y = y;
  a.uvp = static_cast<const float*>(uvp);
  a.oh = hl;
  a.ow = wl;
  a.tc = tc;
  a.ocols = wl;
  if (out_mode == OUT_DENSE) {
    if (tc <= 0 || tc % 32) return 0;
    a.ocols = (wl + tc - 1) / tc * tc;
  } else if (out_mode == OUT_U8) {
    if (uvp == nullptr || cmap == nullptr) return 0;
    a.cm = color_map(cmap);
  } else if (out_mode != OUT_S2D && out_mode != OUT_TAPS &&
             out_mode != OUT_PTAPS) {
    return 0;
  }
  if (qt.tr == 0) {
    a.ny = a.nx = 1;
    a.hl = hl;
    a.wl = wl;
  } else {
    if (!tiles_ok(qt) || (long long)qt.ny * qt.tr < hl ||
        (long long)qt.nx * qt.tc < wl)
      return 0;
    a.ny = qt.ny;
    a.nx = qt.nx;
    a.hl = qt.tr;
    a.wl = qt.tc;
  }
  // the last tile column also writes the dense pad columns past the grid
  const int last = a.ocols - (a.nx - 1) * a.wl;
  a.wlast = last > a.wl ? last : a.wl;
  a.nstrips = (a.wlast + cells - 2) / (cells - 1);
  const long long planes = (long long)n * a.ny * a.nx;
  const long long rows = planes * a.nstrips * a.hl;
  if (planes > INT_MAX || rows > INT_MAX) return 0;
  a.rows = (int)rows;
  return (int)planes;
}

}  // namespace

extern "C" {

// Layer 7 on `stream`: x [n, 2hl+2, 2wl+2, 128] (tr == 0), or the int8
// layer 6's tile-major x [n, ny, nx, 2tr+2, 2tc+2, 128] with ny*tr >= hl and
// nx*tc >= wl (tr > 0), in the storage type (bf16 != 0: bf16, else f32),
// for bf16 w the folded weights [512, 16] bf16, for f32 w the layer's
// weights [128, 9] f32 (StackParams' w7), b [1] f32, and out_mode 0 (y
// [n, hl, wl, 4] in the storage type), 1 (y [n, hl, ceil(wl/dense_tc)*4*
// dense_tc] in the storage type, dense_tc a multiple of 32) or 2 (y u8
// [n, hl, wl, 16] from the device array uvp [n, hl, wl, 8] f32 and the host
// array cmap[12]: the 3 x 3 YUV -> BGR matrix row by row, then its 3
// offsets), or the tap forms 3 (OUT_TAPS) and 4
// (OUT_PTAPS: for bf16 w pack_l7_ptaps' [512, 16]), y [n, hl, wl, 4] in the
// storage type; zs the zero-shift mask 0..3 (bit 0 columns, bit 1 rows),
// not 0 only with out_mode 0 and tr == 0. x, w, y and uvp 16-byte aligned.
// Returns the cudaError_t of the launch.
int w2x_l7_fold(int bf16, const void* x, const void* w, const void* b,
                void* y, int n, int hl, int wl, int out_mode,
                const void* uvp, const float* cmap, int dense_tc, int tr,
                int tc, int ny, int nx, int zs, void* stream) {
  if (n <= 0 || hl <= 0 || wl <= 0 || zs < 0 || zs > 3 ||
      (zs && (out_mode != OUT_S2D || tr != 0)) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(uvp)) %
          16)
    return (int)cudaErrorInvalidValue;
  const Tiles qt = {tr, tc, ny, nx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    L7Args<__nv_bfloat16> a = {};
    const int planes = fold_args(a, w, b, y, n, hl, wl, out_mode, uvp, cmap,
                                 dense_tc, qt, L7_CELLS);
    if (planes == 0) return (int)cudaErrorInvalidValue;
    auto kernel = out_mode == OUT_DENSE   ? l7_fold<OUT_DENSE, 0>
                  : out_mode == OUT_U8  ? l7_fold<OUT_U8, 0>
                  : out_mode == OUT_TAPS  ? l7_fold<OUT_TAPS, 0>
                  : out_mode == OUT_PTAPS ? l7_fold<OUT_PTAPS, 0>
                  : zs == 1             ? l7_fold<OUT_S2D, 1>
                  : zs == 2             ? l7_fold<OUT_S2D, 2>
                  : zs == 3             ? l7_fold<OUT_S2D, 3>
                                        : l7_fold<OUT_S2D, 0>;
    return (int)launch(kernel, L7_SMEM, L7_THREADS, L7_CELLS, x, planes, a,
                       s);
  }
  L7Args<float> a = {};
  const int planes = fold_args(a, w, b, y, n, hl, wl, out_mode, uvp, cmap,
                               dense_tc, qt, F7_CELLS);
  if (planes == 0) return (int)cudaErrorInvalidValue;
  auto kernel = out_mode == OUT_DENSE   ? l7_fold_f32<OUT_DENSE, 0>
                : out_mode == OUT_U8  ? l7_fold_f32<OUT_U8, 0>
                : out_mode == OUT_TAPS  ? l7_fold_f32<OUT_TAPS, 0>
                : out_mode == OUT_PTAPS ? l7_fold_f32<OUT_PTAPS, 0>
                : zs == 1             ? l7_fold_f32<OUT_S2D, 1>
                : zs == 2             ? l7_fold_f32<OUT_S2D, 2>
                : zs == 3             ? l7_fold_f32<OUT_S2D, 3>
                                      : l7_fold_f32<OUT_S2D, 0>;
  return (int)launch(kernel, F7_SMEM, F7_THREADS, F7_CELLS, x, planes, a, s);
}

}  // extern "C"
