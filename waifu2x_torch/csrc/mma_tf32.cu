// Layers 2-6 of the waifu2x conv stack in f32 on Hopper's tensor cores
// (sm_90a), as three TF32 products a term ("3xTF32"). Built with nvcc into
// a shared library with a plain C interface and loaded with ctypes
// (waifu2x_torch/ops/_build.py). The Python side is
// waifu2x_torch/ops/stack.py: _Launcher.layer sends layers 2-6 of every f32
// stack call here (stack_scale, stack_scale_dense, stack_scale_fused_u8,
// stack_noise_s2d, stack_noise, stack_scale_upto, layer5_plane, and layers
// 2-5 under l6_i8 / l6_wino), mma_layer runs one alone, tf32_plan is the
// shared-memory plan and ops/s2d.py:pack_mma_tf32 packs and splits the
// weights (StackParams.wt). With ops.stack.MID_MMA False the f32 calls go
// to stack.cu's FFMA conv3x3_bias_leaky<CI, CO, float, IN_ACT> instead.
//
// Replaces: the mid layers of waifu2x_tpu/ops/pallas_stack.py:_stack_body
// in f32 (prep_params(dtype=float32)), whose MXU passes run f32 at full
// precision; stack.cu's FFMA layers ran them on this card until now.
//
// What it computes: conv3x3_bias_leaky<CI, CO, float, IN_ACT>'s function,
//   x [N, hin, win, CI] f32 NHWC  ->  y [N, hin-2, win-2, CO] f32,
// 3x3 VALID correlation + bias + LeakyReLU(0.1), within 3e-5 of the f32
// plain version. The tensor cores read an f32 operand as TF32 (10 mantissa
// bits), one product of which misses that bar (5.4e-3 on the shipped
// models), so each product a*w is taken as
//   a*w ~= a_lo*w_hi + a_hi*w_lo + a_hi*w_hi        (a_lo*w_lo dropped)
// in one f32 accumulator, the two small terms of each k8 step issued first:
//   w_hi = rna(w), w_lo = rna(w - w_hi)  on the host (pack_mma_tf32);
//   a_hi = rna(a), a_lo = rna(a - a_hi)  in the kernel, each chunk's staged
//   window split in place,
// rna rounding to the nearest TF32 value, ties away from zero. All four
// halves are TF32 values, so the hardware's own cut of an f32 operand to
// TF32 changes none of them; what is left out (a_lo*w_lo and the two lo
// roundings) is about 2^-22 of each product and unbiased. Emulated on the
// shipped models at full width, the stack lands within 3e-5 of f32, and
// one TF32 product does not (tests/test_torch_tf32.py); the f32 sums'
// order differs from the FFMA kernel's.
//
// Design: csrc/mma.cu's implicit GEMM with TF32 operands.
//   * A block computes a 16 x 16 pixel tile for all CO channels: four
//     warpgroups (512 threads), each one 8 x 8 quarter as an m64 accumulator
//     (CO / 2 f32 registers a thread).
//   * TF32 wgmma takes both operands K-major, with 16-byte core-matrix rows
//     of 4 values. The 18 x 18 window of a chunk of 8 input channels is
//     staged by cp.async as [k4][window row][window column][4] f32, so the
//     A operand of tap (dy, dx) is one descriptor moved by (dy*18 + dx)*16
//     bytes (LBO the k4 stride, SBO the window's row pitch). The weights'
//     chunk arrives packed as [CI/4][9][CO][4] (pack_mma_tf32), hi and lo
//     each one contiguous run: LBO = 9*CO*16, SBO = 128.
//   * After a chunk lands and the barrier, one pass over the window rounds
//     each value to TF32 in place (a_hi) and writes the rounded rest to a
//     second window buffer (a_lo), then a proxy fence and a second barrier;
//     the 27 products of the chunk (9 taps x 3 terms, m64nNPk8, NP = 64
//     outputs a pass, two passes for CO = 128) follow.
//   * The tensor cores add each product into their f32 accumulator with
//     truncation, so a sum over 3 x 9 x CI / 8 instructions drifts toward
//     zero by up to an ulp an instruction: measured 5.6e-5 on outputs near
//     6 at CI = 128 with one accumulator for all chunks. Each chunk's 27
//     products therefore go into a fresh register partial (the first one
//     overwrites it), which is added to the running f32 sum with FADD, as
//     round to nearest.
//   * A ring of 2 chunk stages (window + w_hi + w_lo): chunk c + 1 loads
//     while chunk c splits and multiplies; 8 input channels a chunk keep the
//     ring and the a_lo buffer at 178.6 KB for CO = 128 (tf32_plan).
//   * Epilogue: bias, LeakyReLU into a padded f32 tile in the ring's shared
//     memory, then 16-byte stores along channels, the ragged edge masked.
//     Deterministic: every output is one thread's sum in a fixed order.
//
// What bounds it on an H100: operations. Three TF32 products a term at the
// 494.7 TFLOP/s dense TF32 peak are 3 x 2 x 9 x CI x CO FLOP a pixel: 28.7
// ms for the f32 noise stack's layers 2-6 at ns1080 (4 x 1080 x 1920),
// against 71 ms for one f32 product a term at the 67 TFLOP/s FFMA peak. Each
// block re-reads its weights (hi and lo) from L2 per 256 pixels, 1.18 MB
// for layer 6; the wgmma queue drains at each chunk's barriers.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TT = 16;            // the block's output tile: TT x TT pixels
constexpr int TWIN = TT + 2;      // window rows and columns
constexpr int TF_THREADS = 512;   // four warpgroups, one 8 x 8 m64 tile each
constexpr uint32_t TF_KEEP = 0xFFFFE000u;   // the mantissa bits TF32 keeps

// f32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32; the
// same integer form as ops/s2d.py:tf32_round)
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & TF_KEEP);
}

// the staged window's k4 stride in 16-byte units (tf32_plan's
// `win_stride`): the k4 slices of one pixel fall into different 16-byte
// bank groups
__host__ __device__ constexpr int tf_win_stride(int k4c) {
  return TWIN * TWIN + ((8 / k4c) - (TWIN * TWIN) % 8 + 8) % 8;
}
// dynamic shared memory of one instantiation (tf32_plan's `smem_bytes`):
// the ring of (window, w_hi, w_lo) stages and the a_lo window, or the
// epilogue's padded output tile where that is larger
__host__ __device__ constexpr int tf32_smem_bytes(int co, int kc,
                                                  int stages) {
  const int k4c = kc / 4, s = tf_win_stride(k4c);
  const int pipe = stages * k4c * (s + 2 * 9 * co) * 16 + k4c * s * 16;
  const int tile = TT * TT * (co * 4 + 16);
  return pipe > tile ? pipe : tile;
}

// x [N, hin, win, CI] f32, whi / wlo [CI/4][9][CO][4] f32, b [CO] f32,
// y [N, hin-2, win-2, CO] f32. Grid: one block per (image, tile row, tile
// column), flattened.
template <int CI, int CO, int KC, int STAGES>
__global__ void __launch_bounds__(TF_THREADS, (CO <= 32 ? 2 : 1))
conv3x3_bias_leaky_tf32(const float* __restrict__ x,
                        const float* __restrict__ whi,
                        const float* __restrict__ wlo,
                        const float* __restrict__ b, float* __restrict__ y,
                        int hin, int win, int ntx, int nty) {
  constexpr int K4C = KC / 4, NCHUNK = CI / KC, NPIX = TWIN * TWIN;
  constexpr int NP = CO < 64 ? CO : 64;   // outputs of one product pass
  constexpr int S = tf_win_stride(K4C);
  constexpr uint32_t WIN_BYTES = K4C * S * 16;
  constexpr uint32_t W_BYTES = K4C * 9 * CO * 16;   // w_hi or w_lo
  constexpr uint32_t STAGE_BYTES = WIN_BYTES + 2 * W_BYTES;
  constexpr uint32_t LO_OFF = STAGES * STAGE_BYTES;  // the a_lo window
  static_assert(CI % KC == 0 && KC % 8 == 0 && K4C <= 8, "chunk depth");
  static_assert(STAGES >= 2 && STAGES <= NCHUNK, "a ring of chunks");

  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);

  unsigned bid = blockIdx.x;
  const int tx = bid % ntx;  bid /= ntx;
  const int ty = bid % nty;  bid /= nty;
  const int n = bid;
  const int oy0 = ty * TT, ox0 = tx * TT;
  const int hout = hin - 2, wout = win - 2;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                  // warpgroup: tile quarter
  const int ty8 = wg >> 1, tx8 = wg & 1;

  const float* xn = x + (size_t)n * hin * win * CI;
  auto load_chunk = [&](int c, int stage) {
    const uint32_t sw = sbase + stage * STAGE_BYTES;
    for (int i = tid; i < K4C * NPIX; i += TF_THREADS) {
      const int k4 = i % K4C, p = i / K4C;
      const int iy = oy0 + p / TWIN, ix = ox0 + p % TWIN;
      const bool ok = iy < hin && ix < win;
      const float* src =
          ok ? xn + ((size_t)iy * win + ix) * CI + c * KC + k4 * 4 : x;
      cp_async16(sw + (k4 * S + p) * 16, src, ok);
    }
    // w_hi's chunk, then w_lo's, one contiguous run each
    const uint4* hsrc =
        reinterpret_cast<const uint4*>(whi) + (size_t)c * (W_BYTES / 16);
    const uint4* lsrc =
        reinterpret_cast<const uint4*>(wlo) + (size_t)c * (W_BYTES / 16);
    for (int i = tid; i < (int)(2 * W_BYTES / 16); i += TF_THREADS) {
      const bool lo = i >= (int)(W_BYTES / 16);
      const uint4* src = lo ? lsrc + (i - W_BYTES / 16) : hsrc + i;
      cp_async16(sw + WIN_BYTES + i * 16, src, true);
    }
  };
  // a ~= a_hi + a_lo: a_hi in place, a_lo into its own window
  auto split_chunk = [&](int stage) {
    float4* hi = reinterpret_cast<float4*>(smem + stage * STAGE_BYTES);
    float4* lo = reinterpret_cast<float4*>(smem + LO_OFF);
    for (int i = tid; i < K4C * NPIX; i += TF_THREADS) {
      const int at = (i / NPIX) * S + i % NPIX;
      const float4 v = hi[at];
      const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                   tf32_rna(v.z), tf32_rna(v.w));
      hi[at] = h;
      lo[at] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                           tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
    }
  };

  // the sum of the chunks so far, and one chunk's products for NP outputs
  float acc[CO / 2], part[NP / 2];
#pragma unroll
  for (int i = 0; i < CO / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) part[i] = 0.0f;

  // (A: LBO 4 channels on, SBO 8 pixels = one output row on; B: LBO 4
  // input channels on, SBO 8 output channels on.) A tap or a k8 step moves
  // a descriptor by its byte offset / 16, added to the address field.
  constexpr uint64_t a_str = desc_strides(S * 16, TWIN * 16);
  constexpr uint64_t b_str = desc_strides(9 * CO * 16, 128);
  const uint32_t a_off = ((8 * ty8) * TWIN + 8 * tx8) * 16;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_chunk(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < NCHUNK; ++c) {
    cp_async_wait<STAGES - 2>();    // this thread's pieces of chunk c
    __syncthreads();                // everyone's; chunk c-1's products done
    if (c + STAGES - 1 < NCHUNK)
      load_chunk(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    split_chunk(c % STAGES);
    fence_proxy_async();            // the window's values, as the split left
    __syncthreads();                // them, visible to the tensor cores
    const uint32_t sw = sbase + (c % STAGES) * STAGE_BYTES;
    const uint64_t a_hi = a_str | desc_addr(sw + a_off);
    const uint64_t a_lo = a_str | desc_addr(sbase + LO_OFF + a_off);
#pragma unroll
    for (int h = 0; h < CO / NP; ++h) {
      const uint64_t b_hi = b_str | desc_addr(sw + WIN_BYTES + h * NP * 16);
      const uint64_t b_lo = b_hi + W_BYTES / 16;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
          const uint32_t at = 2 * ks * S + dy * TWIN + dx;   // 16-byte units
          const uint32_t bt = (2 * ks * 9 + tap) * CO;
          mma_k8_tf32<NP>(part, a_lo + at, b_hi + bt, tap + ks > 0);
          mma_k8_tf32<NP>(part, a_hi + at, b_lo + bt);
          mma_k8_tf32<NP>(part, a_hi + at, b_hi + bt);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[h * NP / 2 + i] += part[i];
    }
  }

  // epilogue: bias, LeakyReLU into a padded f32 tile, 16-byte stores
  constexpr int PITCH = CO * 4 + 16;
  const int lane = tid & 31, w4 = (tid >> 5) & 3;
  const int col = 8 * tx8 + (lane >> 2);
  __syncthreads();   // every warpgroup is done reading the stages
#pragma unroll
  for (int j = 0; j < CO / 8; ++j) {
    const int ch = 8 * j + 2 * (lane & 3);
    const float2 bias = *reinterpret_cast<const float2*>(b + ch);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pix = (8 * ty8 + 2 * w4 + hh) * TT + col;
      *reinterpret_cast<float2*>(smem + pix * PITCH + ch * 4) =
          make_float2(leaky(acc[4 * j + 2 * hh] + bias.x),
                      leaky(acc[4 * j + 2 * hh + 1] + bias.y));
    }
  }
  __syncthreads();
  constexpr int C4 = CO / 4;
  float* yn = y + (size_t)n * hout * wout * CO;
  for (int i = tid; i < TT * TT * C4; i += TF_THREADS) {
    const int c4 = i % C4, pix = i / C4;
    const int oy = oy0 + pix / TT, ox = ox0 + pix % TT;
    if (oy < hout && ox < wout)
      *reinterpret_cast<uint4*>(yn + ((size_t)oy * wout + ox) * CO + c4 * 4) =
          *reinterpret_cast<const uint4*>(smem + pix * PITCH + c4 * 16);
  }
}

template <int CI, int CO, int KC, int STAGES>
cudaError_t launch_tf32(const void* x, const void* whi, const void* wlo,
                        const void* b, void* y, int n, int hin, int win,
                        int smem_bytes, cudaStream_t s) {
  constexpr int need = tf32_smem_bytes(CO, KC, STAGES);
  if (smem_bytes != need) return cudaErrorInvalidValue;
  const int ntx = (win - 2 + TT - 1) / TT, nty = (hin - 2 + TT - 1) / TT;
  const long long blocks = (long long)ntx * nty * n;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = conv3x3_bias_leaky_tf32<CI, CO, KC, STAGES>;
  // over 48 KB of dynamic shared memory is refused without this
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, TF_THREADS, need, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(whi),
      static_cast<const float*>(wlo), static_cast<const float*>(b),
      static_cast<float*>(y), hin, win, ntx, nty);
  return cudaGetLastError();
}

}  // namespace

// layer L as CI -> CO, staged in chunks of KC input channels in a ring of
// ST buffers (ops/stack.py:tf32_plan holds the same plan)
#define W2X_TF32_CASE(L, CI, CO, KC, ST)                                    \
  if (layer == L)                                                           \
    return (int)launch_tf32<CI, CO, KC, ST>(x, whi, wlo, b, y, n, hin, win, \
                                            smem_bytes, s);

extern "C" {

// Launch layer `layer` (1..5: the stack's layers 2-6) on `stream` in f32
// (bf16 must be 0): x [n, hin, win, CI] -> y [n, hin-2, win-2, CO], with
// (whi, wlo) = pack_mma_tf32(w) and b [CO], all f32. smem_bytes is
// tf32_plan's count of the launch's shared memory; bytes that disagree
// with the kernel's own count give cudaErrorInvalidValue. Returns the
// cudaError_t of the launch (0 on success).
int w2x_tf32_layer(int bf16, int layer, const void* x, const void* whi,
                   const void* wlo, const void* b, void* y, int n, int hin,
                   int win, int smem_bytes, void* stream) {
  if (bf16 || n <= 0 || hin < 3 || win < 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  W2X_TF32_CASE(1, 32, 32, 8, 2)
  W2X_TF32_CASE(2, 32, 64, 8, 2)
  W2X_TF32_CASE(3, 64, 64, 8, 2)
  W2X_TF32_CASE(4, 64, 128, 8, 2)
  W2X_TF32_CASE(5, 128, 128, 8, 2)
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
