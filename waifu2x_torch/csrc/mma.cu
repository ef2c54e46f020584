// Layers 2-6 of the waifu2x conv stack on Hopper's tensor cores (sm_90a),
// and the mma_chain probe of the same inner loop. Built with nvcc into a
// shared library with a plain C interface and loaded with ctypes
// (waifu2x_torch/ops/_build.py). The Python side is
// waifu2x_torch/ops/stack.py: _Launcher.layer sends layers 2-6 of every
// bf16 stack call here (stack_scale, stack_scale_dense,
// stack_scale_fused_u8, stack_noise_s2d, stack_noise, stack_scale_upto,
// layer5_plane, and layers 2-5 under l6_i8 / l6_wino) and conv3x3_mma
// sends UpCUNet's 3x3 layers of the widths below (ops/unet.py): one entry,
// w2x_mma_layer, keyed by (ci, co). mma_layer_plain is the plain version,
// mma_plan the plan of both kernels below, mma_walk the persistent
// kernel's tile walk, and ops/s2d.py:pack_mma the weight packer.
//
// Replaces: the mid layers of waifu2x_tpu/ops/pallas_stack.py:_stack_body
// (the one Pallas kernel behind every stack configuration), whose 128-lane
// quadrant packing (s2d.py:pack_mid_kernel, pack_pair_kernel) is shaped by
// that machine's matrix unit and is not carried over; and, for the probe,
// the back-to-back [M,128] x [128,128] product of
// tools/vmem_bound_probe.py:make. f32 storage runs these layers as 3xTF32
// (mma_tf32.cu).
//
// What it computes:
//   x [N, hin, win, CI] bf16 NHWC  ->  y [N, hin-2, win-2, CO] bf16,
// 3x3 VALID correlation + f32 bias + LeakyReLU(0.1), bf16 x bf16 products
// (exact in f32), f32 sums in the kernel's own order, one rounding to bf16
// when y is stored.
//
// Two kernels, one arithmetic. Both compute a 16 x 16 output tile for all
// CO channels as an implicit GEMM, D[256, CO] = sum over the 9 taps of
// A_tap[256, CI] * W_tap[CI, CO], four warpgroups each owning one 8 x 8
// quarter as one m64 accumulator, with wgmma.mma_async m64nNk16 (N = CO,
// or CO / 2 where the outputs are split) reading
// BOTH operands from shared memory through descriptors without swizzle
// (mma.cuh). The window of a chunk of KC input channels lies as
// [k8][window row][window col][8 channels]: 8 neighbouring pixels x 8
// channels are one 128-byte core matrix, so every shifted tap is one legal
// A descriptor (SBO the window's row pitch, LBO the k8 stride, start moved
// by (dy * 18 + dx) * 16 bytes) and no im2col or ldmatrix is needed. The
// weights arrive packed as [CI/8][9][CO][8] (pack_mma): a chunk is one
// contiguous run and W_tap of a k16 step a K-major B operand (SBO 128
// bytes, LBO 9 * CO * 16). For every output both kernels add the same
// k16 products of the same operands in the same order over (chunk, tap,
// k16), with the chunk depth KC of the W2X_MMA_CASE table, and apply the
// same epilogue arithmetic, so their outputs are equal bit for bit (an
// output's sum does not depend on how many outputs one instruction
// computes: the PP instance, n64 halves, is bit-equal to n128 too).
// Deterministic: no split-K, no atomics.
//
// conv3x3_bias_leaky_mma, the main path (w2x_mma_layer): persistent, one
// block an SM, each walking its units (tiles, or tile halves) in a fixed
// order: unit v, v + grid, ... over all images. 544 threads: four consumer
// warpgroups and one producer warp whose lane 0 issues every copy.
//   * The weights of the block's outputs are loaded once a block by bulk
//     copies and stay resident: all of layers 2-5's (18 / 37 / 74 / 147
//     KB); layer 6's 295 KB do not fit, so its output channels are cut in
//     two halves (route "split"), an even grid's block keeping one half
//     resident (147 KB) and computing that half of its tiles with
//     m64n64k16 products. Only the input windows stream: each chunk's
//     window by TMA (a 4-d tensor map over [N, H, W, CI], one (8, 18, 18,
//     1) box a k8 slab, zero fill past the plane) into a ring of 3-8 slots
//     with full / empty mbarrier pairs.
//   * Consumers keep one wgmma group in flight across chunks
//     (wgmma_wait<1>) and release a slot once the products that read it
//     are waited for; the epilogue (bias, LeakyReLU, one rounding to bf16)
//     runs from the accumulators while the producer fills the next tile's
//     window, and a quad of lanes transposes its bf16 pairs so that each
//     lane stores 16 bytes and a quad 64 of one pixel (no shared tile).
//   * Where a block computes at most 64 outputs (layers 2-4 and the split
//     layer 6), the warpgroups form two groups that take the block's units
//     in turn and issue their products in turn, each warpgroup 8 rows of
//     the tile as two m64 accumulators: one group's epilogue runs beside
//     the other's products. At 128 outputs (layer 5) two accumulators
//     would not fit, and one group of four takes every unit.
//   * The route follows from the widths alone: whether 9 * CI * CO * 2
//     bytes and a ring of 3 slots fit in 227 KB.
//   * Layer 6 on clusters of two CTAs that multicast each weight chunk
//     through the ring (.multicast::cluster) was tried, bit for bit equal,
//     and ran at 9.75-9.96 ms a scale512 call against the split's
//     8.80-9.17 (PERF.md): it halves the bytes read from L2, not the bytes
//     each SM takes in, which bound it.
//   * An n64 product reads 4 KB of operands from shared memory per 131 k
//     FLOP, an n128 one 6 KB per 262 k: the split layer 6 and layers 3-4
//     stay further from the peak than layer 5 for that reason.
//   * Registers: the producer warp puts a fifth warp on one of the SM's
//     four register files, so a thread has 96 (16384 / (5 x 32), rounded
//     down to 8): one n128 accumulator (layer 5), or two n64 ones.
//
// conv3x3_bias_leaky_mma_tile, the first design (the timing yardstick,
// and the probes' variants): one block a tile, 512 threads; each chunk
// stages the window and all 9 taps' weights with cp.async (src-size 0
// fills outside the plane) in a ring of STAGES buffers, one block barrier
// and wgmma_wait<0> a chunk, the epilogue through a padded shared tile.
// Its instances: ZS, the layer with its cell offsets on one or both axes
// forced to 0 (tools/shift_cost_probe.py:156, l4_shift_probe.py:130), PP,
// the outputs in two accumulators (tools/accpp_probe.py:127), AM, layer 5
// with B4's tile maxima (w2x_mma_layer_max); see the kernel's notes.
//
// What bounds it on an H100: layers 5 and 6 by operations (2.5 and 5.0 ms
// per 16 x 1024^2 output pixels at the 989 TFLOP/s bf16 peak), layers 2-4
// by the bytes of their activations (0.65, 0.98 and 1.30 ms at 3.35 TB/s):
// 10.5 ms for the five layers. The tile kernel re-read its weight chunks
// from L2 for every tile (64-78% of the 39-378 KB it staged a tile) and
// moved about 2.5 TB/s into the SMs whatever the layer's bound (PERF.md).
// The persistent kernel stages 21 / 21 / 41 / 41 / 166 KB a tile for
// layers 2-6 (the window; layer 6's twice, once a half; the weights once a
// block). What is still in the way of the peak: on the H100 at its 700 W
// limit the SM clock falls from 1980 to 1290-1380 MHz in layers 5 and 6
// (PERF.md), so the nominal peak is out of reach there; layer 5's
// epilogue runs with no products in flight; each window carries 27% more
// pixels than its tile; the n64 products' operand reads (above).

#include <limits.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int MT = 16;             // the block's output tile: MT x MT pixels
// AM's two parts, bit 0 the pixel maxima and bit 1 the windows' reduction
// (tools/l5max_probe.py times builds that compile one out)
#ifndef W2X_AM_PARTS
#define W2X_AM_PARTS 3
#endif

constexpr int WIN = MT + 2;        // window rows and columns
constexpr int MMA_THREADS = 512;   // four warpgroups, one 8 x 8 m64 tile each

// the staged window's k8 stride in 16-byte units (mma_plan's `win_stride`)
__host__ __device__ constexpr int win_stride(int k8c) {
  return WIN * WIN + ((8 / k8c) - (WIN * WIN) % 8 + 8) % 8;
}
// copies of the window a chunk stages under zero-shift mask zs: the window
// itself, and one with the pixel pairs of each zeroed axis (and of both)
// swapped
__host__ __device__ constexpr int zs_copies(int zs) {
  return zs == 0 ? 1 : zs == 3 ? 4 : 2;
}
// dynamic shared memory of one instantiation (mma_plan's `smem_bytes`):
// the ring and the epilogue's padded output tile, or under PP the ring (or
// the second half's tile) and the first half's tile beside it
__host__ __device__ constexpr int mma_smem_bytes(int co, int kc, int stages,
                                                 int zs, bool pp) {
  const int pipe = stages * (kc / 8) *
                   (zs_copies(zs) * win_stride(kc / 8) + 9 * co) * 16;
  if (pp) {
    const int half = MT * MT * (co + 16);
    return (pipe > half ? pipe : half) + half;
  }
  const int tile = MT * MT * (co * 2 + 16);
  return pipe > tile ? pipe : tile;
}

// The tile kernel: x [N, hin, win, CI], wp [CI/8][9][CO][8], b [CO] f32,
// y [N, hin-2, win-2, CO]. Grid: one block per (image, tile row, tile
// column), flattened.
//
// ZS (zero-shift mask; tools/shift_cost_probe.py, l4_shift_probe.py): bit 0
// zeroes the column shifts, bit 1 the row shifts. On a zeroed axis tap
// k = 0, 1, 2 of output position p reads r(p, k) = (p & ~1) | ((p + k) & 1),
// the other pixel of p's own s2d cell for k = 1 and p itself for k = 0, 2:
// the JAX stack with every cell offset D of that axis forced to 0. No
// descriptor reaches p ^ 1 (a core matrix is 8 pixels of both parities), so
// each chunk stages the window once more per zeroed axis (and once for both)
// with that axis' pixel pairs swapped, from the same global addresses: tile
// origins are even and the window 18 wide, so a pair never straddles it.
// Taps 0 and 2 then read the plain copy at offset 0 on that axis, tap 1 the
// swapped copy at offset 0.
//
// AM (B4's tile maxima, layer 5 under l6_i8 only; w2x_mma_layer_max): the
// epilogue also takes max |x| of each pixel of the tile over its CO
// channels from the f32 values it rounds to bf16 (a thread holds 2 pixels x
// CO/4 channels; the 4 lanes of a pixel meet by shuffles), rounds that max
// to bf16 once (rounding to nearest is monotonic and odd, so that is the
// max of the stored values' |x|), into a 16 x 16 f32 array past the output
// tile, and after the barrier, before the stores, reduces it per tile window
// that the block meets and adds it to `tm` by atomicMax (common.cuh:
// tile_max_block): tile_max_plain's m, bit for bit, without a second read
// of x5. The other instances take the
// argument and do not read it.
//
// PP (two accumulators; tools/accpp_probe.py): the CO outputs in two halves,
// each its own register accumulator and its own wgmma group, committed apart.
// After the last chunk the first half's epilogue (bias, LeakyReLU, bf16 into
// a tile region of its own, outside the ring) runs while the second half's
// products finish. Between chunks both halves are waited for: the next
// chunk's load refills the buffer that this chunk's products read. Each
// output keeps its sum order over (chunk, tap, k16), so PP equals the
// one-accumulator kernel bit for bit.
template <int CI, int CO, int KC, int STAGES, int ZS, int PP, int AM>
__global__ void __launch_bounds__(MMA_THREADS, (CO <= 64 ? 2 : 1))
conv3x3_bias_leaky_mma_tile(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ wp,
                            const float* __restrict__ b,
                            __nv_bfloat16* __restrict__ y, int hin, int win,
                            int ntx, int nty, TileMax tm) {
  constexpr int K8C = KC / 8, NCHUNK = CI / KC;
  constexpr int S = win_stride(K8C);
  constexpr int NCOPY = zs_copies(ZS);
  constexpr uint32_t COPY_BYTES = K8C * S * 16;
  constexpr uint32_t WIN_BYTES = NCOPY * COPY_BYTES;
  constexpr uint32_t W_BYTES = K8C * 9 * CO * 16;
  constexpr uint32_t STAGE_BYTES = WIN_BYTES + W_BYTES;
  constexpr int NH = PP ? CO / 2 : CO;     // outputs of one accumulator
  constexpr int NACC = PP ? 2 : 1;
  static_assert(CI % KC == 0 && KC % 16 == 0 && K8C <= 8, "chunk depth");
  static_assert(STAGES >= 1 && (STAGES == 1 || STAGES <= NCHUNK),
                "more stages than chunks");
  static_assert(ZS >= 0 && ZS <= 3 && !(ZS && PP) && !(AM && (ZS || PP)),
                "one variant at a time");

  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);

  unsigned bid = blockIdx.x;
  const int tx = bid % ntx;  bid /= ntx;
  const int ty = bid % nty;  bid /= nty;
  const int n = bid;
  const int oy0 = ty * MT, ox0 = tx * MT;
  const int hout = hin - 2, wout = win - 2;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                  // warpgroup: tile quarter
  const int ty8 = wg >> 1, tx8 = wg & 1;

  const __nv_bfloat16* xn = x + (size_t)n * hin * win * CI;
  auto load_chunk = [&](int c, int stage) {
    const uint32_t sw = sbase + stage * STAGE_BYTES;
    for (int i = tid; i < K8C * WIN * WIN; i += MMA_THREADS) {
      const int k8 = i % K8C, p = i / K8C;
      const int iy = oy0 + p / WIN, ix = ox0 + p % WIN;
      const bool ok = iy < hin && ix < win;
      const __nv_bfloat16* src =
          ok ? xn + ((size_t)iy * win + ix) * CI + c * KC + k8 * 8 : x;
      cp_async16(sw + (k8 * S + p) * 16, src, ok);
#pragma unroll
      for (int cp = 1; cp < NCOPY; ++cp) {
        // copy cp swaps the rows (sy) and / or the columns (sx) in pairs
        const int sx = (ZS & 1) ? (ZS == 3 ? cp & 1 : cp) : 0;
        const int sy = (ZS & 2) ? (ZS == 3 ? cp >> 1 : cp) : 0;
        const int q = ((p / WIN) ^ sy) * WIN + ((p % WIN) ^ sx);
        cp_async16(sw + cp * COPY_BYTES + (k8 * S + q) * 16, src, ok);
      }
    }
    const uint4* wsrc =
        reinterpret_cast<const uint4*>(wp) + (size_t)c * (W_BYTES / 16);
    for (int i = tid; i < (int)(W_BYTES / 16); i += MMA_THREADS)
      cp_async16(sw + WIN_BYTES + i * 16, wsrc + i, true);
  };

  float acc[NACC][NH / 2];
#pragma unroll
  for (int h = 0; h < NACC; ++h)
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) acc[h][i] = 0.0f;

  // (LBO: 8 channels on, SBO: 8 pixels = one output row on)
  constexpr uint64_t a_str = desc_strides(S * 16, WIN * 16);
  constexpr uint64_t b_str = desc_strides(9 * CO * 16, 128);
  const uint32_t a_off = ((8 * ty8) * WIN + 8 * tx8) * 16;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_chunk(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < NCHUNK; ++c) {
    if constexpr (STAGES == 1) {
      if (c > 0) __syncthreads();   // the one buffer's readers are done
      load_chunk(c, 0);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    } else {
      cp_async_wait<STAGES - 2>();  // this thread's pieces of chunk c
      fence_proxy_async();
      __syncthreads();              // everyone's; and chunk c-1 is read
      if (c + STAGES - 1 < NCHUNK)
        load_chunk(c + STAGES - 1, (c + STAGES - 1) % STAGES);
      cp_async_commit();
    }
    const uint32_t sw = sbase + (c % STAGES) * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < NACC; ++h) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        // a zeroed axis: offset 0, tap 1 from the copy with that axis swapped
        const int ry = (ZS & 2) ? 0 : dy, rx = (ZS & 1) ? 0 : dx;
        const int sy = (ZS & 2) ? dy == 1 : 0, sx = (ZS & 1) ? dx == 1 : 0;
        const int cp = ZS == 3 ? 2 * sy + sx : sy + sx;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          const uint32_t a = sw + cp * COPY_BYTES + a_off +
              (2 * ks * S + ry * WIN + rx) * 16;
          const uint32_t bw = sw + WIN_BYTES +
              ((2 * ks * 9 + tap) * CO + h * NH) * 16;
          mma_k16<NH>(acc[h], a_str | desc_addr(a), b_str | desc_addr(bw));
        }
      }
      wgmma_commit();
    }
    if (!PP || c + 1 < NCHUNK) wgmma_wait<0>();
  }

  // epilogue: bias, LeakyReLU, bf16 into a padded tile, 16-byte stores.
  // Under PP half 0 goes to its own region past the ring while half 1's
  // products may still run; half 1 then reuses the ring.
  constexpr int PITCH = NH * 2 + 16;
  constexpr uint32_t HALF0 =
      PP ? mma_smem_bytes(CO, KC, STAGES, ZS, PP) - MT * MT * PITCH : 0;
  constexpr uint32_t PIXMAX = MT * MT * PITCH;   // AM: the pixels' max |x|
  static_assert(!AM || PIXMAX + MT * MT * 4 <=
                           (uint32_t)mma_smem_bytes(CO, KC, STAGES, ZS, PP),
                "the pixel maxima fit past the output tile");
  const int lane = tid & 31, w4 = (tid >> 5) & 3;
  const int col = 8 * tx8 + (lane >> 2);
  float pmax[2] = {0.0f, 0.0f};   // AM: max |x| of this thread's 2 pixels
  auto epilogue = [&](const float (&d)[NH / 2], int h, uint32_t region) {
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
      const int ch = 8 * j + 2 * (lane & 3);
      const float2 bias = *reinterpret_cast<const float2*>(b + h * NH + ch);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pix = (8 * ty8 + 2 * w4 + hh) * MT + col;
        const float v0 = leaky(d[4 * j + 2 * hh] + bias.x);
        const float v1 = leaky(d[4 * j + 2 * hh + 1] + bias.y);
        *reinterpret_cast<__nv_bfloat162*>(smem + region + pix * PITCH +
                                           ch * 2) =
            __floats2bfloat162_rn(v0, v1);
        if constexpr (AM && (W2X_AM_PARTS & 1))
          pmax[hh] = fmaxf(pmax[hh], fmaxf(fabsf(v0), fabsf(v1)));
      }
    }
  };
  if constexpr (PP) {
    wgmma_wait<1>();                // half 0's group is done
    fence_acc(acc[0]);
    epilogue(acc[0], 0, HALF0);
    wgmma_wait<0>();
    fence_acc(acc[1]);
    __syncthreads();                // every warpgroup is done with the ring
    epilogue(acc[1], 1, 0);
  } else {
    __syncthreads();   // every warpgroup is done reading the stages
    epilogue(acc[0], 0, 0);
  }
  if constexpr (AM) {   // the 4 lanes of a pixel hold CO/4 channels each
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      pmax[hh] = fmaxf(pmax[hh], __shfl_xor_sync(0xffffffffu, pmax[hh], 1));
      pmax[hh] = fmaxf(pmax[hh], __shfl_xor_sync(0xffffffffu, pmax[hh], 2));
      if ((lane & 3) == 0)   // the max of the stored (bf16) values
        reinterpret_cast<float*>(smem + PIXMAX)[(8 * ty8 + 2 * w4 + hh) * MT +
                                                col] =
            __bfloat162float(__float2bfloat16_rn(pmax[hh]));
    }
  }
  __syncthreads();
  // AM: the windows' maxima before the stores (after them the block's
  // last warps wait on this reduction longer: tools/l5max_probe.py)
  if constexpr (AM && (W2X_AM_PARTS & 2))
    tile_max_block<MT>(reinterpret_cast<const float*>(smem + PIXMAX), tm, n,
                       oy0, ox0, hout, wout);
  constexpr int C8 = CO / 8, H8 = NH / 8;
  __nv_bfloat16* yn = y + (size_t)n * hout * wout * CO;
  for (int i = tid; i < MT * MT * C8; i += MMA_THREADS) {
    const int c8 = i % C8, pix = i / C8;
    const int oy = oy0 + pix / MT, ox = ox0 + pix % MT;
    const uint32_t region = (PP && c8 < H8) ? HALF0 : 0;
    if (oy < hout && ox < wout)
      *reinterpret_cast<uint4*>(yn + ((size_t)oy * wout + ox) * CO + c8 * 8) =
          *reinterpret_cast<const uint4*>(smem + region + pix * PITCH +
                                          (c8 % H8) * 16);
  }
}

// ---------------------------------------------------------------------------
// The persistent kernel
// ---------------------------------------------------------------------------

constexpr int RES_CONSUMERS = 512;                 // four warpgroups
constexpr int RES_THREADS = RES_CONSUMERS + 32;    // and the producer warp
constexpr int RS = 328;   // window k8 stride, 16-byte units: 18 x 18 pixels
                          // rounded up so that each slab is 128-byte aligned
constexpr uint32_t SLAB_BYTES = WIN * WIN * 16;    // a TMA box: 5184
constexpr uint32_t SMEM_MAX = 232448;              // what one block may use

// The persistent kernel's plan for a CI -> CO layer in chunks of KC input
// channels (ops/stack.py:mma_plan holds the same arithmetic)
template <int CI, int CO, int KC>
struct Res {
  static constexpr int K8C = KC / 8, NCHUNK = CI / KC;
  static constexpr uint32_t WIN_BYTES = K8C * RS * 16;   // a chunk's window
  // all the layer's weights resident beside a ring of 3 slots, or else
  // the output channels in two halves, a block keeping one half's
  static constexpr int HALVES =
      128 + 9 * CI * CO * 2 + 3 * (WIN_BYTES + 16) + 8 <= SMEM_MAX ? 1 : 2;
  static constexpr int NCO = CO / HALVES;                 // a block's outputs
  static constexpr uint32_t W_CHUNK = K8C * 9 * NCO * 16; // a chunk's weights
  static constexpr uint32_t W_ALL = NCHUNK * W_CHUNK;     // 9 CI NCO x 2 B
  // consumer groups taking the units in turn: two where a warpgroup's two
  // m64 accumulators fit its 96 registers
  static constexpr int GROUPS = NCO <= 64 ? 2 : 1;
  // 128 bytes to align the base, the resident weights, the slots and
  // their full / empty barriers, and the weights' barrier
  static constexpr uint32_t FIXED = 128 + W_ALL + 8;
  static constexpr int FIT = (int)((SMEM_MAX - FIXED) / (WIN_BYTES + 16));
  static constexpr int SLOTS = FIT < 8 ? FIT : 8;
  static constexpr uint32_t SMEM = FIXED + SLOTS * (WIN_BYTES + 16);
  static_assert(CI % KC == 0 && KC % 16 == 0 && SLOTS >= 3, "the plan");
  static_assert(WIN_BYTES % 128 == 0, "TMA boxes 128-byte aligned");
};

// the named barriers by which the two consumer groups take turns (0 is
// __syncthreads'): group g waits on TURN0 + g before its products
constexpr int TURN0 = 1;
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// xmap: x [N, hin, win, CI] bf16 as the tensor (CI, win, hin, N) in boxes of
// (8, 18, 18, 1); wp [CI/8][9][CO][8], b [CO] f32, y [N, hin-2, win-2, CO].
// tiles = N * nty * ntx, numbered column fastest, then row and image; a
// block's units are tiles (HALVES 1) or tile halves, unit v the output
// channels [NCO h, NCO h + NCO) of tile v / 2, h = v % 2 (the grid even,
// so that a block keeps one half); the block's i-th unit is v = blockIdx.x
// + i gridDim.x. Shared memory: the ring's SLOTS slots (a chunk's window,
// [k8][18 x 18][8] with k8 stride RS), the resident weights ([CI/8][9]
// [NCO][8]), then full[SLOTS], empty[SLOTS] and the weights' barrier.
// Step i of a block (its i-th chunk, over all its units) uses slot
// i % SLOTS in phase (i / SLOTS) & 1.
//
// GROUPS: where a block computes at most 64 outputs, two consumer groups of
// two warpgroups take the block's units in turn (group g the units i = g,
// g + 2, ...; warpgroup r of a group the tile's rows 8r .. 8r + 7, as two
// m64 accumulators), and issue their products in turn (the named barriers
// TURN0 + g), so that one group's epilogue runs beside the other's
// products. Where it computes 128, one group of four warpgroups (a quarter
// each) takes every unit: two accumulators would not fit the registers.
template <int CI, int CO, int KC>
__global__ void __launch_bounds__(RES_THREADS, 1)
conv3x3_bias_leaky_mma(const __grid_constant__ CUtensorMap xmap,
                       const __nv_bfloat16* __restrict__ wp,
                       const float* __restrict__ b,
                       __nv_bfloat16* __restrict__ y, int hin, int win,
                       int ntx, int nty, int tiles) {
  using P = Res<CI, CO, KC>;
  constexpr int K8C = P::K8C, NCHUNK = P::NCHUNK, R = P::SLOTS;
  constexpr int HALVES = P::HALVES, NCO = P::NCO, GROUPS = P::GROUPS;
  constexpr int MQ = GROUPS;         // m64 accumulators a warpgroup
  constexpr int GWG = 4 / GROUPS;    // warpgroups a group
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = (smem_addr(smem) + 127) & ~127u;
  const uint32_t s_w = sbase + R * P::WIN_BYTES;   // the resident weights
  const uint32_t s_bar = s_w + P::W_ALL;           // full[R], empty[R]
  const uint32_t w_bar = s_bar + 16 * R;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(s_bar + 8 * s, 1);           // the producer
      mbar_init(s_bar + 8 * (R + s), GWG);   // the group's warpgroups
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int units = tiles * HALVES;
  const int half = blockIdx.x % HALVES;
  const int hout = hin - 2, wout = win - 2;

  if (tid >= RES_CONSUMERS) {
    if (tid == RES_CONSUMERS) {   // the producer
      // the weights of this block's outputs: of each (k8, tap) NCO rows
      const uint8_t* wbytes = reinterpret_cast<const uint8_t*>(wp);
      mbar_expect(w_bar, P::W_ALL);
      for (int r = 0; r < CI / 8 * 9; ++r)
        bulk_load(s_w + r * NCO * 16, wbytes + (r * CO + half * NCO) * 16,
                  NCO * 16, w_bar);
      int step = 0;
      for (int v = blockIdx.x; v < units; v += gridDim.x) {
        int t = v / HALVES;
        const int tx = t % ntx;
        t /= ntx;
        const int ty = t % nty, n = t / nty;
        for (int c = 0; c < NCHUNK; ++c, ++step) {
          const int s = step % R;
          const uint32_t full = s_bar + 8 * s, slot = sbase + s * P::WIN_BYTES;
          if (step >= R)   // the slot's last readers are done
            mbar_wait(s_bar + 8 * (R + s), ((step / R) + 1) & 1);
          mbar_expect(full, K8C * SLAB_BYTES);
          for (int k8 = 0; k8 < K8C; ++k8)
            tma_load4(slot + k8 * RS * 16, &xmap, c * KC + 8 * k8, tx * MT,
                      ty * MT, n, full);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int group = wg / GWG;                  // consumer group
  const int ty8 = GROUPS == 2 ? wg & 1 : wg >> 1;   // the warpgroup's rows
  const int lane = tid & 31, w4 = (tid >> 5) & 3, quad = lane & 3;
  const bool leader = (tid & 127) == 0;
  // (LBO: 8 channels on, SBO: 8 pixels = one output row on); accumulator
  // q of the warpgroup: the 8 x 8 quarter (ty8, tx8 = GROUPS == 2 ? q : wg
  // & 1)
  constexpr uint64_t a_str = desc_strides(RS * 16, WIN * 16);
  constexpr uint64_t b_str = desc_strides(9 * NCO * 16, 128);
  auto tx8_of = [&](int q) { return GROUPS == 2 ? q : wg & 1; };
  const float* bh = b + half * NCO;
  // the block's units: count, and the ones this group takes
  const int mine = (units - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  mbar_wait(w_bar, 0);

  float acc[MQ][NCO / 2];
#pragma unroll
  for (int q = 0; q < MQ; ++q)
#pragma unroll
    for (int i = 0; i < NCO / 2; ++i) acc[q][i] = 0.0f;
  for (int i = group; i < mine; i += GROUPS) {
    const int v = blockIdx.x + i * gridDim.x;
    int t = v / HALVES;
    const int tx = t % ntx;
    t /= ntx;
    const int ty = t % nty, n = t / nty;
    // the other group has issued the products of the unit before
    if (GROUPS == 2 && i > 0) bar_sync(TURN0 + group, 512);
    for (int c = 0; c < NCHUNK; ++c) {
      const int step = i * NCHUNK + c, s = step % R;
      mbar_wait(s_bar + 8 * s, (step / R) & 1);
      const uint32_t slot = sbase + s * P::WIN_BYTES;
      const uint32_t wc = s_w + c * P::W_CHUNK;
      // the accumulators stay in their registers while products in flight
      // write them: pinned on both sides of the issue
#pragma unroll
      for (int q = 0; q < MQ; ++q) fence_acc(acc[q]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          const uint32_t bw = wc + ((2 * ks * 9 + tap) * NCO) * 16;
#pragma unroll
          for (int q = 0; q < MQ; ++q) {
            const uint32_t a = slot + ((8 * ty8) * WIN + 8 * tx8_of(q)) * 16 +
                               (2 * ks * RS + dy * WIN + dx) * 16;
            mma_k16<NCO>(acc[q], a_str | desc_addr(a),
                         b_str | desc_addr(bw));
          }
        }
      }
      wgmma_commit();
#pragma unroll
      for (int q = 0; q < MQ; ++q) fence_acc(acc[q]);
      if (c > 0) {   // the chunk before this one is done: free its slot
        wgmma_wait<1>();
        if (leader) mbar_arrive(s_bar + 8 * (R + (step + R - 1) % R));
      }
    }
    // the other group may issue the next unit's products
    if (GROUPS == 2 && i + 1 < mine) bar_arrive(TURN0 + 1 - group, 512);
    wgmma_wait<0>();
    if (leader)
      mbar_arrive(s_bar + 8 * (R + ((i + 1) * NCHUNK - 1) % R));
#pragma unroll
    for (int q = 0; q < MQ; ++q) fence_acc(acc[q]);

    // epilogue: bias, LeakyReLU, bf16; thread (w4, lane) holds pixels
    // (8 ty8 + 2 w4 + hh, 8 tx8 + lane / 4) of the tile, channels
    // NCO half + 8j + 2 quad + {0, 1}
#pragma unroll
    for (int q = 0; q < MQ; ++q) {
      const int ox = tx * MT + 8 * tx8_of(q) + (lane >> 2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int oy = ty * MT + 8 * ty8 + 2 * w4 + hh;
        const bool keep = oy < hout && ox < wout;
        __nv_bfloat16* out =
            y + (((size_t)n * hout + oy) * wout + ox) * CO + half * NCO;
#pragma unroll
        for (int g = 0; g < NCO / 32; ++g) {   // four j at a time
          uint32_t wd[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * g + jj;
            const float2 bias =
                *reinterpret_cast<const float2*>(bh + 8 * j + 2 * quad);
            const __nv_bfloat162 pr = __floats2bfloat162_rn(
                leaky(acc[q][4 * j + 2 * hh] + bias.x),
                leaky(acc[q][4 * j + 2 * hh + 1] + bias.y));
            wd[jj] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          // the quad's words transposed (two exchanges): lane q gets
          // channels 8(4g + q) .. + 7, 16 bytes
#pragma unroll
          for (int mk = 1; mk <= 2; mk <<= 1) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (jj & mk) continue;
              const uint32_t got = __shfl_xor_sync(
                  0xffffffffu, (quad & mk) ? wd[jj] : wd[jj | mk], mk);
              if (quad & mk)
                wd[jj] = got;
              else
                wd[jj | mk] = got;
            }
          }
          if (keep)
            *reinterpret_cast<uint4*>(out + 8 * (4 * g + quad)) =
                make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < NCO / 2; ++i2) acc[q][i2] = 0.0f;
    }
  }
}

// The probe: out[M, 128] f32 = sum over p of x[M, 128] * w_p[128, 128],
// P back-to-back products through the layer kernel's device functions,
// the sums in registers from the first product to the last.
//   x [M, 128] bf16 (M a multiple of 256), wp [P][16][128][8] bf16
//   (pack_mma of each w_p as a 1 x 1 kernel), out [M, 128] f32
// A block keeps its 256 rows of x in shared memory as [k8][row][8] and
// streams the w_p through two buffers.
constexpr int CH_ROWS = 256, CH_K = 128, CH_N = 128;
constexpr int CH_S = CH_ROWS + 1;                      // k8 stride, 16 B units
constexpr uint32_t CH_A_BYTES = (CH_K / 8) * CH_S * 16;
constexpr uint32_t CH_W_BYTES = (CH_K / 8) * CH_N * 16;
constexpr int CH_SMEM = CH_A_BYTES + 2 * CH_W_BYTES;

__global__ void __launch_bounds__(MMA_THREADS, 1)
mma_chain(const __nv_bfloat16* __restrict__ x,
          const __nv_bfloat16* __restrict__ wp, float* __restrict__ out,
          int p_count) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const size_t row0 = (size_t)blockIdx.x * CH_ROWS;

  auto load_w = [&](int p, int stage) {
    const uint4* wsrc =
        reinterpret_cast<const uint4*>(wp) + (size_t)p * (CH_W_BYTES / 16);
    const uint32_t sw = sbase + CH_A_BYTES + stage * CH_W_BYTES;
    for (int i = tid; i < (int)(CH_W_BYTES / 16); i += MMA_THREADS)
      cp_async16(sw + i * 16, wsrc + i, true);
  };
  for (int i = tid; i < (CH_K / 8) * CH_ROWS; i += MMA_THREADS) {
    const int k8 = i % (CH_K / 8), r = i / (CH_K / 8);
    cp_async16(sbase + (k8 * CH_S + r) * 16, x + (row0 + r) * CH_K + k8 * 8,
               true);
  }
  load_w(0, 0);
  cp_async_commit();

  float acc[CH_N / 2];
#pragma unroll
  for (int i = 0; i < CH_N / 2; ++i) acc[i] = 0.0f;
  constexpr uint64_t a_str = desc_strides(CH_S * 16, 128);
  constexpr uint64_t b_str = desc_strides(CH_N * 16, 128);

  for (int p = 0; p < p_count; ++p) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (p + 1 < p_count) load_w(p + 1, (p + 1) & 1);
    cp_async_commit();
    const uint32_t sw = sbase + CH_A_BYTES + (p & 1) * CH_W_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CH_K / 16; ++ks) {
      const uint32_t a = sbase + (2 * ks * CH_S + 64 * wg) * 16;
      const uint32_t bw = sw + (2 * ks * CH_N) * 16;
      mma_k16<CH_N>(acc, a_str | desc_addr(a), b_str | desc_addr(bw));
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  const int lane = tid & 31, w4 = (tid >> 5) & 3;
#pragma unroll
  for (int j = 0; j < CH_N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = row0 + 64 * wg + 16 * w4 + (lane >> 2) + 8 * h;
      *reinterpret_cast<float2*>(out + row * CH_N + 8 * j + 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int CI, int CO, int KC, int STAGES, int ZS = 0, int PP = 0,
          int AM = 0>
cudaError_t launch_mma_tile(const void* x, const void* wp, const void* b,
                            void* y, int n, int hin, int win, int smem_bytes,
                            cudaStream_t s, TileMax tm = {}) {
  constexpr int need = mma_smem_bytes(CO, KC, STAGES, ZS, PP);
  if (smem_bytes != need) return cudaErrorInvalidValue;
  const int ntx = (win - 2 + MT - 1) / MT, nty = (hin - 2 + MT - 1) / MT;
  const long long blocks = (long long)ntx * nty * n;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = conv3x3_bias_leaky_mma_tile<CI, CO, KC, STAGES, ZS, PP, AM>;
  // over 48 KB of dynamic shared memory is refused without this
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, MMA_THREADS, need, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y), hin, win, ntx, nty, tm);
  return cudaGetLastError();
}

// x [n, hin, win, ci] bf16 as the 4-d tensor (channel, column, row, image)
// in boxes of 8 channels x 18 x 18 pixels x 1 image, no swizzle: a box
// lands as [row][col][8]; boxes past the plane read zero
cudaError_t make_window_map(CUtensorMap* map, const void* x, int n, int hin,
                            int win, int ci) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)ci, (cuuint64_t)win,
                              (cuuint64_t)hin, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)ci * 2, (cuuint64_t)win * ci * 2,
                                 (cuuint64_t)hin * win * ci * 2};
  const cuuint32_t box[4] = {8, WIN, WIN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch of the persistent kernel: no more blocks than fit the card at
// once (an even count where a block keeps one half of the outputs), each
// walking its units. The count that fits is asked once a device and kept.
template <int CI, int CO, int KC>
cudaError_t launch_mma(const void* x, const void* wp, const void* b, void* y,
                       int n, int hin, int win, int smem_bytes,
                       cudaStream_t s) {
  using P = Res<CI, CO, KC>;
  if (smem_bytes != (int)P::SMEM ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wp) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorInvalidValue;
  const int ntx = (win - 2 + MT - 1) / MT, nty = (hin - 2 + MT - 1) / MT;
  const long long units = (long long)ntx * nty * n * P::HALVES;
  if (units <= 0 || units > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = conv3x3_bias_leaky_mma<CI, CO, KC>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  static int resident[64];   // blocks the card holds at once, by device
  if (resident[dev] == 0) {
    // over 48 KB of dynamic shared memory is refused without this
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = sm_count(sms);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, RES_THREADS, P::SMEM);
    if (err != cudaSuccess) return err;
    if (sms * per_sm < P::HALVES) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  int grid = (int)(units < resident[dev] ? units : resident[dev]);
  grid -= grid % P::HALVES;   // a block keeps one half of the outputs
  CUtensorMap map;
  err = make_window_map(&map, x, n, hin, win, CI);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, RES_THREADS, P::SMEM, s>>>(
      map, static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), hin, win,
      ntx, nty, (int)(units / P::HALVES));
  return cudaGetLastError();
}

}  // namespace

// a CI -> CO layer in chunks of KC input channels, on the persistent kernel
// or (tile) on the tile kernel with a ring of ST buffers (ops/stack.py:
// _MMA_CHUNK holds the same table)
#define W2X_MMA_CASE(CI, CO, KC, ST)                                       \
  if (ci == CI && co == CO)                                                \
    return (int)(tile ? launch_mma_tile<CI, CO, KC, ST>(                   \
                            x, wp, b, y, n, hin, win, smem_bytes, s)       \
                      : launch_mma<CI, CO, KC>(x, wp, b, y, n, hin, win,   \
                                               smem_bytes, s));
// a CI -> CO layer on the persistent kernel alone: no tile-kernel instance
// (ops/stack.py:_MMA_CHUNK holds it with no ring)
#define W2X_MMA_PERSISTENT(CI, CO, KC)                                     \
  if (ci == CI && co == CO && !tile)                                       \
    return (int)launch_mma<CI, CO, KC>(x, wp, b, y, n, hin, win,           \
                                       smem_bytes, s);
// the variants the probes run: layer L under zero-shift mask ZS or with two
// accumulators (ops/stack.py:_MMA_VARIANTS holds the same table)
#define W2X_MMA_VARIANT(L, CI, CO, KC, ST, ZS, PP)                         \
  if (layer == L && zs == ZS && pp == PP)                                  \
    return (int)launch_mma_tile<CI, CO, KC, ST, ZS, PP>(                   \
        x, wp, b, y, n, hin, win, smem_bytes, s);

namespace {

// vgg_7's layers 2-6 (`layer` 1..5 of the variant entry): (CI, CO)
constexpr int VGG7_MID[6][2] = {{0, 0},   {32, 32},  {32, 64},
                                {64, 64}, {64, 128}, {128, 128}};

int mma_conv(int tile, int ci, int co, const void* x, const void* wp,
             const void* b, void* y, int n, int hin, int win, int smem_bytes,
             cudaStream_t s) {
  W2X_MMA_CASE(32, 32, 32, 1)    // vgg_7 layer 2
  W2X_MMA_CASE(32, 64, 32, 1)    // vgg_7 layer 3; UpCUNet's UNetConv(3, 32, 64)
  W2X_MMA_CASE(64, 64, 16, 2)    // vgg_7 layer 4; UpCUNet's 64 -> 64 convs
  W2X_MMA_CASE(64, 128, 32, 2)   // vgg_7 layer 5; UpCUNet's 64 -> 128 convs
  W2X_MMA_CASE(128, 128, 16, 2)  // vgg_7 layer 6
  W2X_MMA_PERSISTENT(128, 64, 16)  // UpCUNet's 128 -> 64 convs
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch a ci -> co layer on `stream` on the persistent kernel: x [n, hin,
// win, ci] bf16 -> y [n, hin-2, win-2, co] bf16, with wp = pack_mma(w) and
// b [co] f32, x, wp and y 16-byte aligned. (ci, co) is one of the shapes of
// mma_conv's table (vgg_7's layers 2-6 and UpCUNet's 3x3 layers of those
// widths and 128 -> 64); any other gives cudaErrorInvalidValue. smem_bytes
// is mma_plan's count of the launch's shared memory; bytes that disagree
// with the kernel's own count give cudaErrorInvalidValue. bf16 must be
// non-zero: f32 storage takes mma_tf32.cu. Returns the cudaError_t of the
// launch (0 on success).
int w2x_mma_layer(int bf16, int ci, int co, const void* x, const void* wp,
                  const void* b, void* y, int n, int hin, int win,
                  int smem_bytes, void* stream) {
  if (!bf16 || n <= 0 || hin < 3 || win < 3)
    return (int)cudaErrorInvalidValue;
  return mma_conv(0, ci, co, x, wp, b, y, n, hin, win, smem_bytes,
                  static_cast<cudaStream_t>(stream));
}

// Layer `layer` (1..5) on the tile kernel: zs = pp = 0 is the same function
// as w2x_mma_layer (the timing yardstick); zs is a zero-shift mask (1:
// columns, 2: rows, 3: both; see conv3x3_bias_leaky_mma_tile) and pp != 0
// two accumulators, for the (layer, zs, pp) that the probes run; any other
// triple, zs and pp together, or bf16 == 0 gives cudaErrorInvalidValue.
// smem_bytes is mma_plan(ci, co, zs, pp, persistent=False)'s.
int w2x_mma_layer_variant(int bf16, int layer, int zs, int pp, const void* x,
                          const void* wp, const void* b, void* y, int n,
                          int hin, int win, int smem_bytes, void* stream) {
  if (!bf16 || n <= 0 || hin < 3 || win < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pp = pp != 0;
  if (zs == 0 && !pp)
    return layer >= 1 && layer <= 5
               ? mma_conv(1, VGG7_MID[layer][0], VGG7_MID[layer][1], x, wp, b,
                          y, n, hin, win, smem_bytes, s)
               : (int)cudaErrorInvalidValue;
  W2X_MMA_VARIANT(1, 32, 32, 32, 1, 1, 0)
  W2X_MMA_VARIANT(1, 32, 32, 32, 1, 2, 0)
  W2X_MMA_VARIANT(1, 32, 32, 32, 1, 3, 0)
  W2X_MMA_VARIANT(1, 32, 32, 32, 1, 0, 1)
  W2X_MMA_VARIANT(2, 32, 64, 32, 1, 1, 0)
  W2X_MMA_VARIANT(2, 32, 64, 32, 1, 2, 0)
  W2X_MMA_VARIANT(2, 32, 64, 32, 1, 3, 0)
  W2X_MMA_VARIANT(2, 32, 64, 32, 1, 0, 1)
  W2X_MMA_VARIANT(3, 64, 64, 16, 2, 1, 0)
  W2X_MMA_VARIANT(3, 64, 64, 16, 2, 2, 0)
  W2X_MMA_VARIANT(3, 64, 64, 16, 2, 3, 0)
  W2X_MMA_VARIANT(3, 64, 64, 16, 2, 0, 1)
  W2X_MMA_VARIANT(4, 64, 128, 32, 2, 1, 0)
  W2X_MMA_VARIANT(4, 64, 128, 32, 2, 2, 0)
  W2X_MMA_VARIANT(4, 64, 128, 16, 2, 3, 0)   // 32 x 2 would need 316 KB
  W2X_MMA_VARIANT(4, 64, 128, 32, 2, 0, 1)
  W2X_MMA_VARIANT(5, 128, 128, 16, 2, 1, 0)
  W2X_MMA_VARIANT(5, 128, 128, 16, 2, 2, 0)
  W2X_MMA_VARIANT(5, 128, 128, 16, 2, 3, 0)
  W2X_MMA_VARIANT(5, 128, 128, 16, 2, 0, 1)
  return (int)cudaErrorInvalidValue;
}

// Layer 5 (64 -> 128, `layer` 4 of the variant entry) with B4's tile maxima in
// its epilogue (AM), on the tile kernel, and m [n, ny, nx] f32
// (zeros on entry) gets max |x5| of each tile window of its output x5
// [n, 2 ny tr + 4, 2 nx tc + 4, 128], as stack.tile_max_plain computes
// it; x must be [n, 2 ny tr + 6, 2 nx tc + 6, 64]. smem_bytes is
// mma_plan(64, 128, persistent=False)'s.
int w2x_mma_layer_max(int bf16, const void* x, const void* wp, const void* b,
                      void* y, int n, int hin, int win, int smem_bytes,
                      void* m, int tr, int tc, int ny, int nx,
                      void* stream) {
  const Tiles qt = {tr, tc, ny, nx};
  if (!bf16 || n <= 0 || m == nullptr || !tiles_ok(qt) ||
      hin != 2 * ny * tr + 6 || win != 2 * nx * tc + 6)
    return (int)cudaErrorInvalidValue;
  return (int)launch_mma_tile<64, 128, 32, 2, 0, 0, 1>(
      x, wp, b, y, n, hin, win, smem_bytes, static_cast<cudaStream_t>(stream),
      {static_cast<unsigned*>(m), qt});
}

// Launch the mma_chain probe: out [m, 128] f32 = sum over p of x [m, 128]
// bf16 times w_p, wp = [p_count][16][128][8] bf16; m a multiple of 256.
int w2x_mma_chain(int bf16, const void* x, const void* wp, void* out, int m,
                  int p_count, void* stream) {
  if (!bf16 || m <= 0 || m % CH_ROWS || p_count <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      mma_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, CH_SMEM);
  if (err != cudaSuccess) return (int)err;
  mma_chain<<<m / CH_ROWS, MMA_THREADS, CH_SMEM,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), static_cast<float*>(out),
      p_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
