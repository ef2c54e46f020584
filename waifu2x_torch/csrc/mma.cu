// Layers 2-6 of the waifu2x conv stack on Hopper's tensor cores (sm_90a),
// and the mma_chain probe of the same inner loop. Built with nvcc into a
// shared library with a plain C interface and loaded with ctypes
// (waifu2x_torch/ops/_build.py). The Python side is
// waifu2x_torch/ops/stack.py: _Launcher.layer sends layers 2-6 of every
// bf16 stack call here (stack_scale, stack_scale_dense,
// stack_scale_fused_u8, stack_noise_s2d, stack_noise, stack_scale_upto,
// layer5_plane, and layers 2-5 under l6_i8 / l6_wino), mma_layer_plain is
// the plain version, mma_plan the tile and shared-memory plan, and
// ops/s2d.py:pack_mma the weight packer.
//
// Replaces: the mid layers of waifu2x_tpu/ops/pallas_stack.py:_stack_body
// (the one Pallas kernel behind every stack configuration), whose 128-lane
// quadrant packing (s2d.py:pack_mid_kernel, pack_pair_kernel) is shaped by
// that machine's matrix unit and is not carried over; and, for the probe,
// the back-to-back [M,128] x [128,128] product of
// tools/vmem_bound_probe.py:make. Until this kernel the port ran these
// layers as f32 FFMA (stack.cu:conv3x3_bias_leaky, which stays for f32
// storage, where tensor cores would mean TF32).
//
// The probes' variants (ops/probe.py; w2x_mma_layer_variant, never on a
// product path): ZS, the layer with its cell offsets on one or both axes
// forced to 0 (tools/shift_cost_probe.py:156, l4_shift_probe.py:130), and
// PP, the layer with its outputs in two accumulators
// (tools/accpp_probe.py:127); see the kernel's notes.
//
// What it computes: exactly conv3x3_bias_leaky<CI, CO, bf16, IN_ACT>:
//   x [N, hin, win, CI] bf16 NHWC  ->  y [N, hin-2, win-2, CO] bf16,
// 3x3 VALID correlation + f32 bias + LeakyReLU(0.1), bf16 x bf16 products
// (exact in f32), f32 sums, one rounding to bf16 when y is stored. Only
// the order of the f32 sums differs from the FFMA kernel.
//
// Which tensor-core route ships, and why: wgmma.mma_async m64nNk16 with
// BOTH operands read from shared memory through descriptors without
// swizzle (mma.cuh). The staged window's layout makes every shifted tap a
// legal A operand, so no im2col and no ldmatrix fragment shuffling is
// needed, and a core matrix is 128 contiguous bytes, which shared memory
// serves without bank conflicts at any tap shift. The register-A and
// mma.sync routes were not needed.
//
// Design:
//   * Implicit GEMM. A block computes a 16 x 16 pixel tile for all CO
//     channels: D[256, CO] = sum over the 9 taps of A_tap[256, CI] *
//     W_tap[CI, CO], K = 9 CI. Four warpgroups (512 threads) each own one
//     8 x 8 quarter of the tile as one m64 accumulator (CO / 2 f32
//     registers a thread).
//   * The 18 x 18 input window is staged once per input-channel chunk as
//     bf16, as [k8][window row][window col][8 channels]: 8 neighbouring
//     pixels x 8 channels are one core matrix. The m64 tile's A operand for
//     tap (dy, dx) is one descriptor: SBO = the window's row pitch (from
//     one output row to the next), LBO = the k8 stride, start address moved
//     by (dy * 18 + dx) * 16 bytes. The k8 stride is padded so that the 8
//     copies of a quarter-warp fall into 8 different 16-byte bank groups.
//   * The weights arrive packed on the host as [CI/8][9][CO][8] (pack_mma):
//     a chunk of KC input channels is one contiguous run, and W_tap for a
//     k16 step is a K-major B operand with SBO = 128 bytes (8 output
//     channels on) and LBO = 9 * CO * 16 bytes (8 input channels on).
//   * Global -> shared with cp.async.cg in 16-byte pieces, zero-filled
//     outside the plane (src-size 0), in a ring of STAGES chunk buffers:
//     chunk c + STAGES - 1 loads while chunk c multiplies. One barrier per
//     chunk. Where CO <= 64 two blocks share an SM and overlap each other's
//     prologue and epilogue.
//   * Deterministic: no split-K, no atomics; every output is one thread's
//     sum in a fixed order.
//   * Epilogue from the f32 accumulators: bias, LeakyReLU, one rounding to
//     bf16 into a padded shared tile, then 16-byte stores along channels
//     with the ragged edge masked.
//
// What bounds it on an H100: layers 5 and 6 by operations (2.5 and 5.0 ms
// per 16 x 1024^2 output pixels at the 989 TFLOP/s bf16 peak), layers 2-4
// by the bytes of their activations (0.65, 0.98 and 1.30 ms at 3.35 TB/s):
// 10.5 ms for the five layers, where the FFMA kernel's floor is 143 ms. An
// m64n128k16 step reads 6 KB of operands from shared memory per 64 clocks
// of the SM's tensor cores, under the 128 bytes per clock that shared
// memory serves, so the operands' route is not the limit. What is in the
// way of the peak (measured rates are in PERF.md): the wgmma queue drains
// at every chunk's barrier; where CO = 128 one block fills an SM, so each
// tile's first load and its epilogue are exposed; each block re-reads its
// weight chunks from L2 (295 KB for layer 6 per 256 pixels) and 27% more
// window than it has pixels. A persistent grid with the weights resident, a
// producer warp, wgmma kept in flight across chunks and layers fused on
// chip are left to later work.

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

// x [N, hin, win, CI], wp [CI/8][9][CO][8], b [CO] f32, y [N, hin-2, win-2, CO]
// Grid: one block per (image, tile row, tile column), flattened.
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
// tile_max_block). That is csrc/l6.cu's tile_absmax without its second
// read of x5: m is the same, bit for bit. The other instances take the
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
conv3x3_bias_leaky_mma(const __nv_bfloat16* __restrict__ x,
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
cudaError_t launch_mma(const void* x, const void* wp, const void* b, void* y,
                       int n, int hin, int win, int smem_bytes,
                       cudaStream_t s, TileMax tm = {}) {
  constexpr int need = mma_smem_bytes(CO, KC, STAGES, ZS, PP);
  if (smem_bytes != need) return cudaErrorInvalidValue;
  const int ntx = (win - 2 + MT - 1) / MT, nty = (hin - 2 + MT - 1) / MT;
  const long long blocks = (long long)ntx * nty * n;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = conv3x3_bias_leaky_mma<CI, CO, KC, STAGES, ZS, PP, AM>;
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

}  // namespace

// layer L as CI -> CO, staged in chunks of KC input channels in a ring of
// ST buffers (ops/stack.py:_MMA_CHUNK holds the same table)
#define W2X_MMA_CASE(L, CI, CO, KC, ST)                              \
  if (layer == L)                                                    \
    return (int)launch_mma<CI, CO, KC, ST>(x, wp, b, y, n, hin, win, \
                                           smem_bytes, s);
// the variants the probes run: layer L under zero-shift mask ZS or with two
// accumulators (ops/stack.py:_MMA_VARIANTS holds the same table)
#define W2X_MMA_VARIANT(L, CI, CO, KC, ST, ZS, PP)                         \
  if (layer == L && zs == ZS && pp == PP)                                  \
    return (int)launch_mma<CI, CO, KC, ST, ZS, PP>(x, wp, b, y, n, hin,    \
                                                   win, smem_bytes, s);

extern "C" {

// Launch layer `layer` (1..5: the stack's layers 2-6) on `stream`:
// x [n, hin, win, CI] bf16 -> y [n, hin-2, win-2, CO] bf16, with
// wp = pack_mma(w) and b [CO] f32. smem_bytes is mma_plan's count of the
// launch's shared memory; bytes that disagree with the kernel's own count
// give cudaErrorInvalidValue. bf16 must be non-zero: f32 storage stays on
// w2x_stack_layer. Returns the cudaError_t of the launch (0 on success).
int w2x_mma_layer(int bf16, int layer, const void* x, const void* wp,
                  const void* b, void* y, int n, int hin, int win,
                  int smem_bytes, void* stream) {
  if (!bf16 || n <= 0 || hin < 3 || win < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  W2X_MMA_CASE(1, 32, 32, 32, 1)
  W2X_MMA_CASE(2, 32, 64, 32, 1)
  W2X_MMA_CASE(3, 64, 64, 16, 2)
  W2X_MMA_CASE(4, 64, 128, 32, 2)
  W2X_MMA_CASE(5, 128, 128, 16, 2)
  return (int)cudaErrorInvalidValue;
}

// Layer `layer` (1..5) as w2x_mma_layer launches it, under zero-shift mask
// zs (1: columns, 2: rows, 3: both; see conv3x3_bias_leaky_mma) or with two
// accumulators (pp != 0), for the (layer, zs, pp) that the probes run; any
// other triple, zs and pp together, or bf16 == 0 (f32 layers 2-6 are FFMA)
// gives cudaErrorInvalidValue. smem_bytes is mma_plan(ci, co, zs, pp)'s.
int w2x_mma_layer_variant(int bf16, int layer, int zs, int pp, const void* x,
                          const void* wp, const void* b, void* y, int n,
                          int hin, int win, int smem_bytes, void* stream) {
  if (!bf16 || n <= 0 || hin < 3 || win < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pp = pp != 0;
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

// Layer 5 (64 -> 128, `layer` 4 of w2x_mma_layer) with B4's tile maxima in
// its epilogue (AM): as w2x_mma_layer launches it, and m [n, ny, nx] f32
// (zeros on entry) gets max |x5| of each tile window of its output x5
// [n, 2 ny tr + 4, 2 nx tc + 4, 128], as csrc/l6.cu's w2x_tile_absmax
// computes it; x must be [n, 2 ny tr + 6, 2 nx tc + 6, 64]. smem_bytes is
// mma_plan(64, 128)'s.
int w2x_mma_layer_max(int bf16, const void* x, const void* wp, const void* b,
                      void* y, int n, int hin, int win, int smem_bytes,
                      void* m, int tr, int tc, int ny, int nx,
                      void* stream) {
  const Tiles qt = {tr, tc, ny, nx};
  if (!bf16 || n <= 0 || m == nullptr || !tiles_ok(qt) ||
      hin != 2 * ny * tr + 6 || win != 2 * nx * tc + 6)
    return (int)cudaErrorInvalidValue;
  return (int)launch_mma<64, 128, 32, 2, 0, 0, 1>(
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
