// Layer 6 of the conv stack as Winograd F(2x2, 3x3) on Hopper's tensor
// cores (sm_90a), B5 in both storage types: bf16 products (l6_wino_mma) and
// f32 as three TF32 products a term (l6_wino_tf32, "3xTF32"). Built with
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (waifu2x_torch/ops/_build.py). The Python side is waifu2x_torch/
// ops/stack.py: _launch sends layer 6 of every stack call with
// l6_wino=True here, wino_layer runs it alone, wino_layer_plain is the
// plain version of this kernel's arithmetic, wino_plan the unit and chunk
// plan of each kernel (each owns its shared-memory count), StackParams.w6m
// the bf16 weights (ops/s2d.py:pack_mma of pack_wino's U as a 4 x 4 kernel,
// its input channels in the order WINO_CI_ORDER, see below) and
// StackParams.w6t the f32 ones (pack_mma_tf32 of the same U, its input
// channels in WINO_TF32_CI_ORDER: the hi and lo halves).
//
// Replaces: the Winograd branch of waifu2x_tpu/ops/pallas_stack.py:
// _stack_body (l6_wino=True, :509-550, the weights of s2d.py:pack_wino).
//
// What it computes, for x5 [N, H5, W5, 128] NHWC (H5, W5 even) ->
// y6 [N, H5-2, W5-2, 128] in x5's type, per 2 x 2 output block (its 4 x 4
// window d of x5 starts at the block's own top-left pixel):
//   V[p] = (B^T d B)[py, px]     formed in f32 (bf16: rounded to bf16 once)
//   R[A][px] = sum_py A^T[A][py] * sum_ci V[py, px][ci] * U[py, px][ci][co]
//   Y[A][0] = R[A][0] + R[A][1] + R[A][2]
//   Y[A][1] = R[A][1] - R[A][2] - R[A][3]
//   y6 = leaky(Y + b6), rounded once to x5's type
// bf16: bf16 x bf16 products (exact in f32) and f32 sums on the tensor
// cores. The JAX body forms V with bf16 adds (up to three roundings); this
// kernel rounds V once, a deliberate difference (ROADMAP.md).
// f32: V is never rounded; each product V*U is taken as v_lo*u_hi +
// v_hi*u_lo + v_hi*u_hi in TF32, v_hi = rna(V), v_lo = rna(V - v_hi) in
// registers, u_hi and u_lo packed once (prep_params), rna the nearest TF32
// value, ties away from zero: mma_tf32.cu's split, within 3e-5 of the f32
// plain version, as the JAX f32 kernel's exact f32 products are not (a
// deliberate difference, ROADMAP.md).
//
// Design:
//   * A unit is 8 x 8 output blocks (16 x 16 pixels) and one half of the
//     output channels (64): M = 64 blocks, N = 64, K = 128 input channels
//     in 8 chunks of 16. Two warpgroups (256 threads), one per output-
//     transform row A: A^T's row A is folded into the accumulation, so
//     warpgroup A keeps R[A][0..3] as four m64n64 accumulators (128 f32
//     registers a thread) and issues, per chunk, the 12 products V[py, px]
//     x U[py, px] for the three py with A^T[A][py] != 0. That is 24
//     products of N = 128 a block where 16 would do with one accumulator
//     per p, but 16 x 128 f32 accumulators a block do not fit a register
//     file; the epilogue Y = R A then runs in registers, since the four
//     accumulators share one fragment layout.
//   * V never goes to shared memory: each thread forms exactly the V
//     values of its own A fragment (two blocks, four input channels) from
//     the staged window, rounds them to bf16 in registers, negates them
//     where A^T[A][py] = -1, and the products read A from registers
//     (mma.cuh: mma_k16_rs64). Both warpgroups run one instruction stream;
//     only the window rows and the sign depend on A. Per chunk a thread
//     forms the fragments of py = A, A+1, A+2 in turn, two fragment buffers
//     deep, so that one py's products may run while the next py's are
//     formed. (A first version formed V cooperatively into shared memory
//     and read both operands from there: as fast on an H100, but bound by
//     shared memory, which its products alone nearly filled.)
//   * The fragment wants input channels 2j, 2j+1 and 2j+8, 2j+9 (j = lane
//     % 4) of the chunk's 16; the kernel reads physical channels 4j .. 4j+3
//     of a staged pixel in one 8-byte load instead, so the weights' input
//     channels are stored in that order: logical channel 8h + 2j + e of a
//     chunk holds physical channel 4j + 2h + e (WINO_CI_ORDER in
//     ops/stack.py). The window is staged [row][col & 1][col >> 1][16 ch],
//     even and odd columns apart, so the 8 blocks of a warp read 256
//     neighbouring bytes: no bank conflicts.
//   * The window and U's chunk for the unit's half ([k8][p][64 co][8],
//     a K-major B operand, LBO = the k8 stride, SBO = 128 B) load with
//     cp.async (the window zero-filled outside the plane) through a ring of
//     4 stages, two chunks ahead.
//   * Persistent: one block an SM walks over its share of the units and
//     runs their chunks as one sequence through the ring, so a unit's first
//     stages load while the last unit's products run; the epilogue (Y from
//     the four accumulators, bias, LeakyReLU, one rounding to bf16 into a
//     padded 16 x 16 x 64 tile of its own, then 16-byte stores along
//     channels with the ragged edge masked) stands between two units.
//   * Deterministic: every output is one thread's f32 sum in a fixed order.
//
// The f32 form (l6_wino_tf32) keeps the design and changes three things:
//   * Registers. The 3xTF32 products need register partial sums added to
//     the running sums with FADD (the tensor cores truncate each add into
//     their accumulator: one accumulator over all 128 input channels
//     drifts, mma_tf32.cu), and four m64n64 partials beside four m64n64
//     sums would take 256 registers a thread. So a unit is a quarter of the
//     output channels (N = 32): four m64n32 sums and four partials, 128
//     registers; each 2 x 2 block's V is formed four times, once a quarter.
//   * A chunk is 8 input channels, one k8 step: the A fragment of
//     m64n32k8.tf32 wants channels t and t + 4 of the chunk (t = lane % 4)
//     for two blocks; the thread reads physical channels 2t, 2t + 1 of a
//     staged pixel in one 8-byte load instead, so U's input channels are
//     stored in that order (WINO_TF32_CI_ORDER). Per chunk and py a thread
//     forms V in f32 for its two blocks and two channels (A^T's sign folded
//     into the row transform), splits it into TF32 halves in registers and
//     issues, per px, three products (v_lo * u_hi, v_hi * u_lo, v_hi *
//     u_hi) into the partial. Chunks run in pairs, like the bf16 form's: a
//     pair's 18 products a partial are waited for, then added.
//   * Shared memory: the f32 window (18 x 18 x 8 x 4 B) and U's chunk for
//     the quarter, hi and lo ([k4][p][32 co][4] each, a K-major TF32 B
//     operand, LBO the k4 stride, SBO 128 B), 43,136 B a stage, in a ring
//     of 4 stages two chunks ahead.
// Bound on an H100 by the products: the function's 16 a block as three TF32
// products at 494.7 TFLOP/s, 6.61 ms at ns1080 (4 x 541 x 961 blocks; the
// bytes 2.55 ms), 13.39 ms at scale512 f32 (bytes 5.16); the kernel issues
// 24 (A^T folded in), and re-reads U's quarter (512 KB, hi and lo) from L2
// per unit of 64 blocks. What is in the way (tools/wino_tf32_probe.py
// times builds with a part compiled out, W2X_WINO_NO_MMA and
// W2X_WINO_NO_FORM; PERF.md has the numbers): the products and the loads
// alone take 83% of the kernel's time, three times the 24 products' time
// at the TF32 peak (m64n32k8 with A from registers); the forming and the
// loads alone 57%. Partial sums a pair of px, added while the next pair's
// products ran, made ptxas serialise the wgmma (C7514) and were dropped.
//
// What bounds the function on an H100: bytes. At scale512 (16 x 1026^2
// outputs) reading x5 once and writing y6 once is 2.58 ms at 3.35 TB/s; its
// 16 products a block are 2.23 ms at the 989 TFLOP/s bf16 peak. This
// kernel computes 24 products a block (A^T folded in, above), which alone
// would take 3.35 ms: a floor of its design, not of the function.
// What is in the way of the peak (builds with parts compiled out, timed on
// an H100 at scale512, PERF.md): the products alone run at under half the
// peak (m64n64 steps on four accumulators), and the products, the forming
// and the loads take about as long together as one after the other: the
// two warpgroups do not overlap forming with products. Each thread forms its
// fragments alone, so both warpgroups form V[py] for py = 1, 2; one block
// fills an SM (registers); each unit re-reads U's half (256 KB) from L2.
// Warp specialisation (warpgroups that only form, with their registers
// moved by setmaxnreg to the ones that only multiply) is left to later
// work.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int WN = 64;                 // output channels per unit (a half)
constexpr int WT = 8;                  // output blocks per tile side
constexpr int WM = WT * WT;            // output blocks per tile: wgmma's M
constexpr int WWIN = 2 * WT + 2;       // window rows and columns (18)
constexpr int WHALF = WWIN / 2;        // window columns of one parity
constexpr int WKC = 16;                // input channels per chunk
constexpr int WNCH = 128 / WKC;        // chunks
constexpr int WTHREADS = 256;          // two warpgroups, one per A
constexpr int WSTAGES = 4;             // ring stages
constexpr int WAHEAD = WSTAGES - 2;    // chunks loaded ahead
constexpr uint32_t WIN_BYTES = WWIN * WWIN * WKC * 2;          // 10,368
constexpr uint32_t U_BYTES = (WKC / 8) * 16 * WN * 16;         // 32,768
constexpr uint32_t STAGE_BYTES = WIN_BYTES + U_BYTES;          // 43,136
constexpr int OUT_PITCH = WN * 2 + 16;  // bytes per pixel of the out tile
constexpr uint32_t OUT_BYTES = 2 * WT * 2 * WT * OUT_PITCH;    // 36,864
constexpr uint32_t WSMEM = WSTAGES * STAGE_BYTES + OUT_BYTES;  // 209,408
static_assert(WNCH % 2 == 0, "chunks run in pairs");
static_assert(WSMEM <= 232448, "over the 227 KB a block may use");
// f32 (3xTF32)
constexpr int QN = 32;                 // output channels per unit (a quarter)
constexpr int QKC = 8;                 // input channels per chunk: one k8
constexpr int QNCH = 128 / QKC;        // chunks
constexpr int QSTAGES = 4;             // ring stages
constexpr int QAHEAD = QSTAGES - 2;    // chunks loaded ahead
constexpr uint32_t QWIN_BYTES = WWIN * WWIN * QKC * 4;         // 10,368
constexpr uint32_t QU_BYTES = (QKC / 4) * 16 * QN * 16;        // 16,384
constexpr uint32_t QSTAGE_BYTES = QWIN_BYTES + 2 * QU_BYTES;   // 43,136
constexpr int QOUT_PITCH = QN * 4 + 16;  // bytes per pixel of the out tile
constexpr uint32_t QOUT_BYTES = 2 * WT * 2 * WT * QOUT_PITCH;  // 36,864
constexpr uint32_t QSMEM = QSTAGES * QSTAGE_BYTES + QOUT_BYTES;  // 209,408
static_assert(QSMEM <= 232448, "over the 227 KB a block may use");
static_assert(QNCH % 2 == 0, "chunks run in pairs");

// B^T's row p: y = s0 * d[r0] + s1 * d[r1] (ops/s2d.py: _WINO_BT_TAPS)
__device__ __forceinline__ float bt_row(int p, const float (&d)[4]) {
  switch (p) {
    case 0: return d[0] - d[2];
    case 1: return d[1] + d[2];
    case 2: return d[2] - d[1];
    default: return d[1] - d[3];
  }
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pr = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pr);
}

// The A fragments of B^T's row py (0..3) for one chunk: frag[px] for the
// thread's two blocks (pixel offsets p0, p1 of their window corners, in
// 32-byte pixels) and physical channels 4j .. 4j+3 (win already offset by
// 8j bytes); V in f32 in the order of ops/stack.py:wino_layer_plain,
// rounded to bf16 once, negated (sign bits flipped) where neg.
__device__ __forceinline__ void form_frag(uint32_t (&frag)[4][4],
                                          const uint8_t* win, int p0, int p1,
                                          int py, bool neg) {
  // the two window rows of B^T's row py and their signs: t = s0 a + s1 c
  const int r0 = py == 0 ? 0 : 1, r1 = py == 3 ? 3 : 2;
  const float s0 = py == 2 ? -1.0f : 1.0f;
  const float s1 = (py == 0 || py == 3) ? -1.0f : 1.0f;
  const uint32_t flip = neg ? 0x80008000u : 0u;
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    const int p = blk ? p1 : p0;
    float t[4][4];   // [window column][channel]
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const int cc = (col & 1) * WHALF + (col >> 1);
      const uint2 a = *reinterpret_cast<const uint2*>(
          win + (p + r0 * WWIN + cc) * 32);
      const uint2 c = *reinterpret_cast<const uint2*>(
          win + (p + r1 * WWIN + cc) * 32);
      const float av[4] = {bf_lo(a.x), bf_hi(a.x), bf_lo(a.y), bf_hi(a.y)};
      const float cv[4] = {bf_lo(c.x), bf_hi(c.x), bf_lo(c.y), bf_hi(c.y)};
#pragma unroll
      for (int e = 0; e < 4; ++e)   // one rounding: s1 * c and s0 * a exact
        t[col][e] = fmaf(s0, av[e], s1 * cv[e]);
    }
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d[4] = {t[0][e], t[1][e], t[2][e], t[3][e]};
        v[e] = bt_row(px, d);
      }
      // channels 4j, 4j+1 are k 2j, 2j+1 (registers 0, 1); 4j+2, 4j+3 are
      // k 2j+8, 2j+9 (registers 2, 3)
      frag[px][blk] = pack_bf16(v[0], v[1]) ^ flip;
      frag[px][2 + blk] = pack_bf16(v[2], v[3]) ^ flip;
    }
  }
}

// x5 [N, H5, W5, 128], um [16 c8][16 p][128 co][8] (pack_mma of U as a
// 4 x 4 kernel, input channels in WINO_CI_ORDER), b [128] f32,
// y6 [N, H5-2, W5-2, 128]. Persistent: block k takes the units k,
// k + gridDim.x, ... of the (image, tile row, tile column, channel half)
// grid, flattened with the half fastest.
__global__ void __launch_bounds__(WTHREADS, 1)
l6_wino_mma(const __nv_bfloat16* __restrict__ x5,
            const __nv_bfloat16* __restrict__ um,
            const float* __restrict__ b, __nv_bfloat16* __restrict__ y6,
            int H5, int W5, int ntx, int nty, int units) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;   // A: the output transform's row
  const int lane = tid & 31, w4 = (tid >> 5) & 3;
  const int H6 = H5 - 2, W6 = W5 - 2;
  // this block's units and their chunks g = unit * WNCH + c
  const int nunits = (units - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
  const int nchunks = nunits * WNCH;
  struct Unit { int n, ty, tx, h; };
  auto unit_of = [&](int g) {
    int u = (int)blockIdx.x + (g / WNCH) * (int)gridDim.x;
    Unit r;
    r.h = u % 2;     u /= 2;
    r.tx = u % ntx;  u /= ntx;
    r.ty = u % nty;  u /= nty;
    r.n = u;
    return r;
  };

  // chunk g into stage s: the window, [row][col & 1][col >> 1][16 ch], zero
  // outside the plane, then U's chunk for the unit's half, [k8][p][64 co]
  auto load = [&](int g, int s) {
    const Unit t = unit_of(g);
    const int c = g % WNCH;
    const int y0 = 2 * WT * t.ty, x0 = 2 * WT * t.tx;   // window origin
    const __nv_bfloat16* xn = x5 + (size_t)t.n * H5 * W5 * 128;
    const uint32_t ws = sbase + s * STAGE_BYTES;
    for (int i = tid; i < WWIN * WWIN * 2; i += WTHREADS) {
      const int k8 = i & 1, col = (i >> 1) % WWIN, r = (i >> 1) / WWIN;
      const int iy = y0 + r, ix = x0 + col;
      const bool ok = iy < H5 && ix < W5;
      const __nv_bfloat16* src =
          ok ? xn + ((size_t)iy * W5 + ix) * 128 + c * WKC + k8 * 8 : x5;
      cp_async16(ws + ((r * WWIN + (col & 1) * WHALF + (col >> 1)) * 2 + k8)
                          * 16,
                 src, ok);
    }
    const uint4* src = reinterpret_cast<const uint4*>(um);
    for (int i = tid; i < (WKC / 8) * 16 * WN; i += WTHREADS) {
      const int co = i % WN, kp = i / WN;   // kp = k8 * 16 + p
      cp_async16(ws + WIN_BYTES + i * 16,
                 src + ((size_t)(c * (WKC / 8) * 16 + kp) * 128 + t.h * WN +
                        co),
                 true);
    }
  };

  // the thread's fragment: blocks m and m + 8 of the tile (block rows 2 w4
  // and 2 w4 + 1, block column lane / 4), channels 4j .. 4j+3
  const int j = lane & 3;
  const int p0 = 4 * w4 * WWIN + (lane >> 2);   // window corner pixels
  const int p1 = p0 + 2 * WWIN;
  float acc[4][WN / 2];
#pragma unroll
  for (int px = 0; px < 4; ++px)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[px][i] = 0.0f;
  // two py's fragments, [buffer][px][register]: a chunk's three py groups
  // and the next chunk's alternate between them, so chunks run in pairs
  uint32_t frag[2][4][4];
  // U[k8][p][64 co]: LBO = the k8 stride, SBO = 8 channels on
  constexpr uint64_t b_str = desc_strides(16 * WN * 16, 128);

  // cp.async groups, one per chunk in order (empty past the last chunk)
#pragma unroll
  for (int g = 0; g < WAHEAD; ++g) {
    if (g < nchunks) load(g, g);
    cp_async_commit();
  }
  uint8_t* out = smem + WSTAGES * STAGE_BYTES;
  for (int g2 = 0; g2 < nchunks; g2 += 2) {
#pragma unroll
    for (int gg = 0; gg < 2; ++gg) {
      const int g = g2 + gg, s = g % WSTAGES;
      cp_async_wait<WAHEAD - 1>();   // chunk g (all but the later groups)
      fence_proxy_async();
      // everyone's pieces of chunk g; and every warpgroup is done with
      // chunk g - 2 (its last products were waited for in chunk g - 1),
      // whose stage (g + WAHEAD) % WSTAGES the next load refills
      __syncthreads();
      if (g + WAHEAD < nchunks) load(g + WAHEAD, (g + WAHEAD) % WSTAGES);
      cp_async_commit();
      const uint8_t* win = smem + s * STAGE_BYTES + j * 8;
      const uint32_t us = sbase + s * STAGE_BYTES + WIN_BYTES;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        // this buffer was read by the products two groups ago, which the
        // last wgmma_wait<1> saw done
        uint32_t (&f)[4][4] = frag[(3 * gg + q) & 1];
        const int py = wg + q;   // A = 0: py 0, 1, 2; A = 1: 1, then 2, 3 (-)
        form_frag(f, win, p0, p1, py, wg == 1 && q > 0);
        wgmma_fence();
#pragma unroll
        for (int px = 0; px < 4; ++px)
          mma_k16_rs64(acc[px], f[px],
                       b_str | desc_addr(us + (py * 4 + px) * WN * 16));
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
    const int g = g2 + 1;
    if (g % WNCH != WNCH - 1) continue;

    // the unit's epilogue: Y[A][B] in registers, bias, LeakyReLU, bf16
    // into the output tile, then 16-byte stores; the accumulators restart
    wgmma_wait<0>();
#pragma unroll
    for (int px = 0; px < 4; ++px) fence_acc(acc[px]);
    const Unit t = unit_of(g);
#pragma unroll
    for (int jj = 0; jj < WN / 8; ++jj) {
      const int ch = 8 * jj + 2 * (lane & 3);
      const float2 bias = *reinterpret_cast<const float2*>(b + t.h * WN + ch);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 16 * w4 + (lane >> 2) + 8 * hh;   // the block
        const int oy = 2 * (m / WT) + wg, ox = 2 * (m % WT);
        const int i = 4 * jj + 2 * hh;
        float y[2][2];   // [B][channel ch, ch + 1]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float r0 = acc[0][i + e], r1 = acc[1][i + e],
                      r2 = acc[2][i + e], r3 = acc[3][i + e];
          const float bb = e ? bias.y : bias.x;
          y[0][e] = leaky(((r0 + r1) + r2) + bb);
          y[1][e] = leaky(((r1 - r2) - r3) + bb);
        }
#pragma unroll
        for (int B = 0; B < 2; ++B)
          *reinterpret_cast<__nv_bfloat162*>(
              out + (oy * 2 * WT + ox + B) * OUT_PITCH + ch * 2) =
              __floats2bfloat162_rn(y[B][0], y[B][1]);
      }
    }
#pragma unroll
    for (int px = 0; px < 4; ++px)
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[px][i] = 0.0f;
    __syncthreads();
    __nv_bfloat16* yn = y6 + (size_t)t.n * H6 * W6 * 128;
    for (int i = tid; i < 4 * WM * (WN / 8); i += WTHREADS) {
      const int c8 = i % (WN / 8), pix = i / (WN / 8);
      const int oy = 2 * WT * t.ty + pix / (2 * WT);
      const int ox = 2 * WT * t.tx + pix % (2 * WT);
      if (oy < H6 && ox < W6)
        *reinterpret_cast<uint4*>(yn + ((size_t)oy * W6 + ox) * 128 +
                                  t.h * WN + c8 * 8) =
            *reinterpret_cast<const uint4*>(out + pix * OUT_PITCH + c8 * 16);
    }
    // the next epilogue's writes come after WNCH more barriers
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
}


// The A fragments of B^T's row py (0..3) for one f32 chunk: f[px][0] the hi
// halves, f[px][1] the lo halves, for the thread's two blocks (pixel
// offsets p0, p1 of their window corners, in 32-byte pixels) and physical
// channels 2t, 2t+1 (win already offset by 8t bytes; logical k = t and
// t + 4); V in f32 in form_frag's order, never rounded, split into TF32
// halves. `sign` -1 negates V (A^T's -1), folded into the row transform:
// rna is odd, so the halves of -V are the negated halves of V.
__device__ __forceinline__ void form_frag_tf32(uint32_t (&f)[4][2][4],
                                               const uint8_t* win, int p0,
                                               int p1, int py, float sign) {
  const int r0 = py == 0 ? 0 : 1, r1 = py == 3 ? 3 : 2;
  const float s0 = py == 2 ? -sign : sign;
  const float s1 = (py == 0 || py == 3) ? -sign : sign;
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    const int p = blk ? p1 : p0;
    float t[4][2];   // [window column][channel]
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const int cc = (col & 1) * WHALF + (col >> 1);
      const float2 a = *reinterpret_cast<const float2*>(
          win + (p + r0 * WWIN + cc) * 32);
      const float2 c = *reinterpret_cast<const float2*>(
          win + (p + r1 * WWIN + cc) * 32);
      t[col][0] = fmaf(s0, a.x, s1 * c.x);
      t[col][1] = fmaf(s0, a.y, s1 * c.y);
    }
#pragma unroll
    for (int px = 0; px < 4; ++px)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d[4] = {t[0][e], t[1][e], t[2][e], t[3][e]};
        const float v = bt_row(px, d);
        const float hi = tf32_rna(v);
        // registers 0, 1: k = t of blocks 0, 1; registers 2, 3: k = t + 4
        f[px][0][2 * e + blk] = __float_as_uint(hi);
        f[px][1][2 * e + blk] = __float_as_uint(tf32_rna(v - hi));
      }
  }
}

// x5 [N, H5, W5, 128] f32, uhi / ulo [32 k4][16 p][128 co][4] f32
// (pack_mma_tf32 of U as a 4 x 4 kernel, input channels in
// WINO_TF32_CI_ORDER), b [128] f32, y6 [N, H5-2, W5-2, 128] f32.
// Persistent: block k takes the units k, k + gridDim.x, ... of the (image,
// tile row, tile column, channel quarter) grid, flattened with the quarter
// fastest.
__global__ void __launch_bounds__(WTHREADS, 1)
l6_wino_tf32(const float* __restrict__ x5, const float* __restrict__ uhi,
             const float* __restrict__ ulo, const float* __restrict__ b,
             float* __restrict__ y6, int H5, int W5, int ntx, int nty,
             int units) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;   // A: the output transform's row
  const int lane = tid & 31, w4 = (tid >> 5) & 3;
  const int H6 = H5 - 2, W6 = W5 - 2;
  const int nunits = (units - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
  const int nchunks = nunits * QNCH;
  struct Unit { int n, ty, tx, h; };
  auto unit_of = [&](int g) {
    int u = (int)blockIdx.x + (g / QNCH) * (int)gridDim.x;
    Unit r;
    r.h = u % 4;     u /= 4;
    r.tx = u % ntx;  u /= ntx;
    r.ty = u % nty;  u /= nty;
    r.n = u;
    return r;
  };

  // chunk g into stage s: the window, [row][col & 1][col >> 1][8 ch] f32,
  // zero outside the plane, then U's chunk for the unit's quarter,
  // [k4][p][32 co][4], hi then lo
  auto load = [&](int g, int s) {
    const Unit t = unit_of(g);
    const int c = g % QNCH;
    const int y0 = 2 * WT * t.ty, x0 = 2 * WT * t.tx;   // window origin
    const float* xn = x5 + (size_t)t.n * H5 * W5 * 128;
    const uint32_t ws = sbase + s * QSTAGE_BYTES;
    for (int i = tid; i < WWIN * WWIN * 2; i += WTHREADS) {
      const int k4 = i & 1, col = (i >> 1) % WWIN, r = (i >> 1) / WWIN;
      const int iy = y0 + r, ix = x0 + col;
      const bool ok = iy < H5 && ix < W5;
      const float* src =
          ok ? xn + ((size_t)iy * W5 + ix) * 128 + c * QKC + k4 * 4 : x5;
      cp_async16(ws + ((r * WWIN + (col & 1) * WHALF + (col >> 1)) * 2 + k4)
                          * 16,
                 src, ok);
    }
    constexpr int HALF = (QKC / 4) * 16 * QN;   // 16-byte rows of u_hi
    for (int i = tid; i < 2 * HALF; i += WTHREADS) {
      const bool lo = i >= HALF;
      const int j = lo ? i - HALF : i;
      const int co = j % QN, kp = j / QN;   // kp = k4 * 16 + p
      const uint4* src = reinterpret_cast<const uint4*>(lo ? ulo : uhi) +
                         ((size_t)(c * (QKC / 4) * 16 + kp) * 128 +
                          t.h * QN + co);
      cp_async16(ws + QWIN_BYTES + i * 16, src, true);
    }
  };

  // the thread's fragment: blocks m and m + 8 of the tile (block rows 2 w4
  // and 2 w4 + 1, block column lane / 4), channels 2tq, 2tq + 1
  const int tq = lane & 3;
  const int p0 = 4 * w4 * WWIN + (lane >> 2);   // window corner pixels
  const int p1 = p0 + 2 * WWIN;
  float acc[4][QN / 2], part[4][QN / 2];
#pragma unroll
  for (int px = 0; px < 4; ++px)
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) acc[px][i] = part[px][i] = 0.0f;
  // two py's fragments, [buffer][px][hi, lo][register]: a pair of chunks'
  // six py groups alternate between them
  uint32_t frag[2][4][2][4];
  // U[k4][p][32 co][4]: LBO = the k4 stride, SBO = 8 channels on
  constexpr uint64_t b_str = desc_strides(16 * QN * 16, 128);

  // cp.async groups, one per chunk in order (empty past the last chunk)
#pragma unroll
  for (int g = 0; g < QAHEAD; ++g) {
    if (g < nchunks) load(g, g);
    cp_async_commit();
  }
  uint8_t* out = smem + QSTAGES * QSTAGE_BYTES;
  for (int g2 = 0; g2 < nchunks; g2 += 2) {
    // a pair of chunks into one set of partial sums: their 18 products a
    // sum, then one add to the running sums
#pragma unroll
    for (int gg = 0; gg < 2; ++gg) {
      const int g = g2 + gg, s = g % QSTAGES;
      cp_async_wait<QAHEAD - 1>();   // chunk g (all but the later group)
      fence_proxy_async();
      // everyone's pieces of chunk g; and every product of chunk g - 2,
      // whose stage (g + QAHEAD) % QSTAGES the next load refills, was
      // waited for at the end of the last pair
      __syncthreads();
      if (g + QAHEAD < nchunks) load(g + QAHEAD, (g + QAHEAD) % QSTAGES);
      cp_async_commit();
      const uint8_t* win = smem + s * QSTAGE_BYTES + tq * 8;
      const uint32_t us = sbase + s * QSTAGE_BYTES + QWIN_BYTES;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        // this buffer was read by the products two groups ago, which the
        // last wgmma_wait<1> saw done
        uint32_t (&f)[4][2][4] = frag[(3 * gg + q) & 1];
        const int py = wg + q;   // A = 0: py 0, 1, 2; A = 1: 1, then 2, 3 (-)
#ifndef W2X_WINO_NO_FORM
        form_frag_tf32(f, win, p0, p1, py,
                       (wg == 1 && q > 0) ? -1.0f : 1.0f);
#else   // tools/wino_tf32_probe.py: the products and loads alone
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 4; ++r) f[a][h][r] = 0x3f800000u + py + g;
#endif
        wgmma_fence();
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const uint64_t bh =
              b_str | desc_addr(us + (py * 4 + px) * QN * 16);
          const uint64_t bl = bh + QU_BYTES / 16;
#ifndef W2X_WINO_NO_MMA
          // the pair's first product into each partial overwrites it
          mma_k8_tf32_rs32(part[px], f[px][1], bh, gg + q > 0);
          mma_k8_tf32_rs32(part[px], f[px][0], bl);
          mma_k8_tf32_rs32(part[px], f[px][0], bh);
#else   // tools/wino_tf32_probe.py: the forming and loads alone (a use of
        // the fragments keeps their forming in the build)
          part[px][q] +=
              __uint_as_float(f[px][1][q] ^ f[px][0][px]) + (float)bh;
#endif
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
    // the pair's partial sums, added to the running sums with FADD
    wgmma_wait<0>();
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      fence_acc(part[px]);
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) acc[px][i] += part[px][i];
    }
    const int g = g2 + 1;
    if (g % QNCH != QNCH - 1) continue;

    // the unit's epilogue: Y[A][B] in registers, bias, LeakyReLU into the
    // f32 output tile, then 16-byte stores; the sums restart
    const Unit t = unit_of(g);
#pragma unroll
    for (int jj = 0; jj < QN / 8; ++jj) {
      const int ch = 8 * jj + 2 * tq;
      const float2 bias = *reinterpret_cast<const float2*>(b + t.h * QN + ch);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 16 * w4 + (lane >> 2) + 8 * hh;   // the block
        const int oy = 2 * (m / WT) + wg, ox = 2 * (m % WT);
        const int i = 4 * jj + 2 * hh;
        float y[2][2];   // [B][channel ch, ch + 1]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float r0 = acc[0][i + e], r1 = acc[1][i + e],
                      r2 = acc[2][i + e], r3 = acc[3][i + e];
          const float bb = e ? bias.y : bias.x;
          y[0][e] = leaky(((r0 + r1) + r2) + bb);
          y[1][e] = leaky(((r1 - r2) - r3) + bb);
        }
#pragma unroll
        for (int B = 0; B < 2; ++B)
          *reinterpret_cast<float2*>(
              out + (oy * 2 * WT + ox + B) * QOUT_PITCH + ch * 4) =
              make_float2(y[B][0], y[B][1]);
      }
    }
#pragma unroll
    for (int px = 0; px < 4; ++px)
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) acc[px][i] = 0.0f;
    __syncthreads();
    float* yn = y6 + (size_t)t.n * H6 * W6 * 128;
    for (int i = tid; i < 4 * WM * (QN / 4); i += WTHREADS) {
      const int c4 = i % (QN / 4), pix = i / (QN / 4);
      const int oy = 2 * WT * t.ty + pix / (2 * WT);
      const int ox = 2 * WT * t.tx + pix % (2 * WT);
      if (oy < H6 && ox < W6)
        *reinterpret_cast<uint4*>(yn + ((size_t)oy * W6 + ox) * 128 +
                                  t.h * QN + c4 * 4) =
            *reinterpret_cast<const uint4*>(out + pix * QOUT_PITCH + c4 * 16);
    }
    // the next epilogue's writes come after QNCH more barriers
  }
  cp_async_wait<0>();
}

// The grid of a persistent launch over `units` units: one block an SM, at
// most one a unit (0 with the error in *err).
int persistent_grid(long long units, cudaError_t* err) {
  int sms = 0;
  *err = sm_count(sms);
  if (*err != cudaSuccess) return 0;
  return units < sms ? (int)units : sms;
}

}  // namespace

extern "C" {

// B5 in bf16: y6 [n, H5-2, W5-2, 128] from x5 [n, H5, W5, 128] (H5, W5
// even, >= 4), um = StackParams.w6m [16][16][128][8] and b [128] f32, on
// `stream`. bf16 == 0 (f32 takes w2x_l6_wino_tf32) or a bad shape give
// cudaErrorInvalidValue. Returns the cudaError_t of the launch.
int w2x_l6_wino_mma(int bf16, const void* x5, const void* um, const void* b,
                    void* y6, int n, int H5, int W5, void* stream) {
  if (!bf16 || n <= 0 || H5 < 4 || W5 < 4 || H5 % 2 || W5 % 2)
    return (int)cudaErrorInvalidValue;
  const int nty = ((H5 - 2) / 2 + WT - 1) / WT;
  const int ntx = ((W5 - 2) / 2 + WT - 1) / WT;
  const long long units = (long long)n * nty * ntx * 2;
  if (units > INT_MAX / WNCH) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int grid = persistent_grid(units, &err);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      l6_wino_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err != cudaSuccess) return (int)err;
  l6_wino_mma<<<grid, WTHREADS, WSMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x5),
      static_cast<const __nv_bfloat16*>(um), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y6), H5, W5, ntx, nty, (int)units);
  return (int)cudaGetLastError();
}

// B5 in f32 as 3xTF32: y6 [n, H5-2, W5-2, 128] from x5 [n, H5, W5, 128]
// (H5, W5 even, >= 4), (uhi, ulo) = StackParams.w6t, each
// [32][16][128][4] f32, and b [128] f32, on `stream`. bf16 != 0 (bf16
// takes w2x_l6_wino_mma) or a bad shape give cudaErrorInvalidValue.
// Returns the cudaError_t of the launch.
int w2x_l6_wino_tf32(int bf16, const void* x5, const void* uhi,
                     const void* ulo, const void* b, void* y6, int n, int H5,
                     int W5, void* stream) {
  if (bf16 || n <= 0 || H5 < 4 || W5 < 4 || H5 % 2 || W5 % 2)
    return (int)cudaErrorInvalidValue;
  const int nty = ((H5 - 2) / 2 + WT - 1) / WT;
  const int ntx = ((W5 - 2) / 2 + WT - 1) / WT;
  const long long units = (long long)n * nty * ntx * 4;
  if (units > INT_MAX / QNCH) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const int grid = persistent_grid(units, &err);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      l6_wino_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, QSMEM);
  if (err != cudaSuccess) return (int)err;
  l6_wino_tf32<<<grid, WTHREADS, QSMEM,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x5), static_cast<const float*>(uhi),
      static_cast<const float*>(ulo), static_cast<const float*>(b),
      static_cast<float*>(y6), H5, W5, ntx, nty, (int)units);
  return (int)cudaGetLastError();
}

}  // extern "C"
