// Hand-written Hopper (sm_90a) kernels for the waifu2x 7-layer conv stack,
// scale and noise paths. Built with nvcc into a shared library with a plain
// C interface and loaded with ctypes (waifu2x_torch/ops/_build.py); the
// Python wrappers are waifu2x_torch/ops/stack.py:stack_scale (B1),
// stack_noise / stack_noise_s2d (B2), stack_scale_fused_u8 (B3) and
// stack_scale_dense (B6). The stack's three other configurations, the
// truncated stack (B7), int8 layer 6 (B4) and Winograd layer 6 (B5), are
// in l6.cu; they launch the layers 1-5 of the same stack and, where layer
// 6's output is one plane, this file's layer 7. common.cuh holds what the
// sources share, conv3x3_bias_leaky_cell among it.
//
// Replaces: waifu2x_tpu/ops/pallas_stack.py:_run_stack / _stack_body (the
// one Pallas kernel behind stack_scale, configuration B1, behind
// stack_noise / stack_noise_s2d, configuration B2, behind
// stack_scale_fused_u8, configuration B3 with its in-kernel u8 epilogue,
// and behind stack_scale_dense, configuration B6 with its phase-chunked
// dense output) together with the im2col builds _xcol_scale and
// _xcol_noise in front of it.
//
// What it computes (the contracts of pallas_stack.stack_scale and
// stack_noise_s2d):
//   scale: Y_s2d[n, i, j, A*2+B] = convert_plane(nearest2x(ylow))[n, 2i+A, 2j+B]
//   noise: Y_s2d[n, i, j, A*2+B] = convert_plane(edge_pad_even(y))[n, 2i+A, 2j+B]
// where convert_plane replicate-pads by 7 and runs 7 x (3x3 VALID
// correlation + bias + LeakyReLU(0.1)), widths 1-32-32-64-64-128-128-1, and
// edge_pad_even replicates the last row/column of an odd-sized plane once.
// Storage type T is float or bf16; every product and sum is f32 FFMA (no
// TF32, no tensor cores), bias and LeakyReLU are f32, and each layer's
// output is rounded to T once when stored. The last layer's sum stays f32
// until its single rounding to T.
//
// Design (right and simple first):
//   * One launch per layer. Activations live in device memory as NHWC,
//     ping-ponging between two scratch buffers the wrapper allocates.
//   * conv3x3_bias_leaky<CI, CO, T, IN_MODE>: a block computes an 8 x 32
//     output tile for 32 output channels. It stages the 10 x 34 input
//     window for 16 input channels at a time, and that slice of weights,
//     in shared memory as f32. Each thread owns one output column, 4 rows
//     and 8 channels (32 f32 accumulators); per input channel and tap
//     column it reads 6 window values and reuses them across the 3 tap
//     rows, and the 8 weights it needs are a warp-wide broadcast.
//   * Layer 1 reads its source plane through an index map, so neither the
//     upscale nor any pad is materialised. Every stack call's layer 1 now
//     runs on l1.cu; these two modes stay as its FFMA yardstick
//     (ops/stack.py:l1_layer(ffma=True)):
//       IN_LOWRES (scale) reads the low-res plane [N, hl, wl] through the
//         nearest-2x, replicate-pad-7 map
//           ylow[n, clamp(Y-7, 0, 2hl-1) >> 1, clamp(X-7, 0, 2wl-1) >> 1]
//         with each of w1's 9 taps rounded to T apart (l1.cu applies the
//         JAX body's phase sums of them, s2d.py:pack_l1_scale, instead);
//       IN_FULLRES (noise) reads the full-res plane [N, h, w] through
//           y[n, clamp(Y-7, 0, h-1), clamp(X-7, 0, w-1)]
//         over the even-rounded plane he = h + h%2, we = w + w%2: the
//         edge pad to even followed by the replicate pad of 7 (the
//         counterpart of _xcol_noise with s2d.py:pack_l1_noise). The clamp
//         takes the raw h-1 / w-1, so an odd plane's extra row and column
//         repeat its last ones.
//     Layers 2-7 are the same template instances for both: they see a
//     (2hl + 14 - 2k)-row plane, with hl = he/2 on the noise path.
//   * conv3x3_bias_leaky_s2d<CI, T> (layer 7, 128 -> 1) gives each thread
//     one output pixel and writes it straight into the s2d layout
//     [N, hl, wl, 4]. Every stack call's layer 7 runs folded in l7.cu, under
//     a zero-shift mask too; it and the cell kernel below stay the fold's
//     FFMA counterparts, the timing yardsticks
//     (ops/stack.py:last_layer(fold=False)).
//   * conv3x3_bias_leaky_cell<CI, T, OUT_MODE, TILED> (common.cuh) is layer
//     7 in its two other output forms, one thread per s2d cell: it reads the cell's 4 x 4
//     window of the layer-6 activation once (16 pixel loads for 4 output
//     pixels, where the per-pixel kernel makes 36) and keeps the four
//     phases' sums in four accumulators. Each phase's sum runs over
//     (dy, dx, channel) in the per-pixel kernel's order with the same
//     fmaf, so its Y equals that kernel's bit for bit.
//       OUT_DENSE (B6) stores Y phase-chunked, [N, hl, nx*4*tc]:
//         ydense[n, i, j*4tc + q*tc + c] = Y_s2d[n, i, j*tc + c, q]. tc is a
//         multiple of 32, so a warp's store per phase is one contiguous
//         run; columns past wl in the last chunk are written as zero here.
//       OUT_U8 (B3) keeps Y in f32 (it is never rounded to T), reads the
//         cell's 8 polyphase U/V values (uvp [N, hl, wl, 8] f32: u phases
//         0:4, v phases 4:8), applies the YUV -> BGR map
//           ((y*inv[c][0] + u*inv[c][1]) + v*inv[c][2]) + off[c]
//         then * 255, round half to even, clamp to 0..255, and stores the
//         cell's 16 bytes at once: lane c*4 + phase, lanes 12:16 zero. The
//         map is written with __fmul_rn / __fadd_rn, so nvcc contracts no
//         product and sum into an fmaf: for equal Y the bytes equal the
//         plain PyTorch version's (ops/stack.py:stack_scale_fused_u8_plain)
//         bit for bit, and the two differ only where the f32 summation
//         order of the convolutions moves a value across a rounding tie.
//
// What bounds it on an H100: operations. The stack needs 287,136 MAC per
// output pixel; as FFMA at the card's 67 TFLOP/s f32 rate that is about
// 144 ms per 16 x 1024^2 output pixels, against about 9.7 ms at the bf16
// tensor-core peak. Per-layer launches also move every activation through
// device memory: 448 channels written once and read once, about 30 GB per
// 16 x 1024^2 batch in bf16, about 9 ms at 3.35 TB/s. This file's layers
// keep the FFMA units fed (12 shared-memory loads feed 96 FMAs per input
// channel and tap column). They run layer 7 of the f32 calls; layers 2-6
// run on the tensor cores, a bf16 call's in mma.cu (conv3x3_bias_leaky_mma)
// and an f32 call's as 3xTF32 in mma_tf32.cu, and this file's
// instantiations of them stay as the kernels to hold those against
// (ops/stack.py:MID_MMA). A single fused launch with the activations kept
// on chip is left to later work.
//
// Memory: the peak is two activation buffers of
// N*(2hl+12)*(2wl+12)*128*sizeof(T) bytes each: about 8.8 GB together for
// 16 x 512^2 frames in bf16, and about 36 GB for a full 2*1152*3840-pixel
// band dispatch in f32. Both fit in the H100's 80 GB.

#include "common.cuh"

namespace {

constexpr int TH = 8;          // output tile rows
constexpr int TW = 32;         // output tile columns: one lane per column
constexpr int COB = 32;        // output channels per block
constexpr int NTHREADS = 256;  // 8 warps: 2 row halves x 4 groups of 8 ch
constexpr int S2D_THREADS = 256;

enum { IN_ACT = 0, IN_LOWRES = 1, IN_FULLRES = 2 };

// One 3x3 VALID conv layer + bias + LeakyReLU, NHWC in and out.
//   x: IN_ACT     -> [N, hin, win, CI] activations
//      IN_LOWRES  -> [N, ph, pw] low-res plane (CI == 1); the virtual input
//                    is its nearest-2x upscale padded by 7: hin = 2ph + 14
//      IN_FULLRES -> [N, ph, pw] full-res plane (CI == 1); the virtual input
//                    is it edge-padded to even, then by 7:
//                    hin = ph + ph%2 + 14
//   w: [CI][9][CO] (tap t = dy*3 + dx), b: [CO] f32
//   y: [N, hin-2, win-2, CO]
// Grid: one block per (image, tile row, tile col, 32-channel group),
// flattened into blockIdx.x with the channel group fastest.
template <int CI, int CO, typename T, int IN_MODE>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_bias_leaky(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ y,
                   int hin, int win, int ph, int pw, int ntx, int nty) {
  constexpr int KC = CI < 16 ? CI : 16;  // input channels per stage
  constexpr int NCB = CO / COB;
  static_assert(CO % COB == 0, "CO must be a multiple of 32");
  static_assert(CI % KC == 0, "CI must be a multiple of the stage depth");
  static_assert(IN_MODE == IN_ACT || CI == 1, "a plane input has 1 channel");
  static_assert(IN_MODE != IN_ACT || KC % 8 == 0, "8-wide staging loads");

  __shared__ float s_x[KC][TH + 2][TW + 2];
  __shared__ __align__(16) float s_w[KC][9][COB];

  unsigned bid = blockIdx.x;
  const int cb = bid % NCB;  bid /= NCB;
  const int tx = bid % ntx;  bid /= ntx;
  const int ty = bid % nty;  bid /= nty;
  const int n = bid;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = warp & 3;       // channels g*8 .. g*8+7 of this block's 32
  const int half = warp >> 2;   // tile rows 4*half .. 4*half+3
  const int oy0 = ty * TH, ox0 = tx * TW;
  const int hout = hin - 2, wout = win - 2;

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.0f;

  for (int c0 = 0; c0 < CI; c0 += KC) {
    __syncthreads();  // the previous stage's reads are done
    if constexpr (IN_MODE != IN_ACT) {
      for (int p = tid; p < (TH + 2) * (TW + 2); p += NTHREADS) {
        const int r = p / (TW + 2), col = p % (TW + 2);
        const int iy = oy0 + r, ix = ox0 + col;
        float v = 0.0f;
        if (iy < hin && ix < win) {
          int sy, sx;
          if constexpr (IN_MODE == IN_LOWRES) {
            sy = min(max(iy - 7, 0), 2 * ph - 1) >> 1;
            sx = min(max(ix - 7, 0), 2 * pw - 1) >> 1;
          } else {
            sy = min(max(iy - 7, 0), ph - 1);
            sx = min(max(ix - 7, 0), pw - 1);
          }
          v = to_f32(x[((size_t)n * ph + sy) * pw + sx]);
        }
        s_x[0][r][col] = v;
      }
    } else {
      constexpr int G8 = KC / 8;
      for (int i = tid; i < G8 * (TH + 2) * (TW + 2); i += NTHREADS) {
        const int c8 = i % G8, p = i / G8;
        const int r = p / (TW + 2), col = p % (TW + 2);
        const int iy = oy0 + r, ix = ox0 + col;
        float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (iy < hin && ix < win)
          load8(x + (((size_t)n * hin + iy) * win + ix) * CI + c0 + c8 * 8, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) s_x[c8 * 8 + k][r][col] = v[k];
      }
    }
    for (int i = tid; i < KC * 9 * COB; i += NTHREADS) {
      const int j = i % COB, t = (i / COB) % 9, c = i / (9 * COB);
      s_w[c][t][j] = to_f32(w[((size_t)(c0 + c) * 9 + t) * CO + cb * COB + j]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float xin[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) xin[r] = s_x[c][4 * half + r][lane + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4* wp =
              reinterpret_cast<const float4*>(&s_w[c][dy * 3 + dx][g * 8]);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 8; ++k)
              acc[r][k] = fmaf(xin[r + dy], wv[k], acc[r][k]);
        }
      }
    }
  }

  const int ox = ox0 + lane;
  if (ox >= wout) return;
  const int co0 = cb * COB + g * 8;
  float bias[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bias[k] = b[co0 + k];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int oy = oy0 + 4 * half + r;
    if (oy >= hout) break;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = leaky(acc[r][k] + bias[k]);
    store8(y + (((size_t)n * hout + oy) * wout + ox) * CO + co0, v);
  }
}

// The last layer (CI -> 1) + bias + LeakyReLU, written in s2d layout:
// full-res (oy, ox) -> y[n, oy/2, ox/2, (oy&1)*2 + (ox&1)].
//   x: [N, hin, win, CI], w: [CI][9][1], b: [1], y: [N, hl, wl, 4]
// ZS (zero-shift mask, mma.cu's): on a zeroed axis (bit 0 columns, bit 1
// rows) tap k of output position p reads r(p, k) = (p & ~1) | ((p + k) & 1)
// in place of p + k, the counterpart of tools/shift_cost_probe.py:139's
// shifted reads of the folded layer 7's partials with Dx, Dy forced to 0.
// Grid: one block per (image, output row, 256-column chunk), flattened.
template <int CI, typename T, int ZS = 0>
__global__ void __launch_bounds__(S2D_THREADS)
conv3x3_bias_leaky_s2d(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y,
                       int hin, int win, int ncx) {
  static_assert(CI % 8 == 0, "8-wide loads");
  __shared__ __align__(16) float s_w[9][CI];
  for (int i = threadIdx.x; i < 9 * CI; i += S2D_THREADS)
    s_w[i % 9][i / 9] = to_f32(w[i]);
  __syncthreads();

  const int hout = hin - 2, wout = win - 2;
  unsigned bid = blockIdx.x;
  const int cx = bid % ncx;  bid /= ncx;
  const int oy = bid % hout; bid /= hout;
  const int n = bid;
  const int ox = cx * S2D_THREADS + threadIdx.x;
  if (ox >= wout) return;

  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = (ZS & 2) ? (oy & ~1) | ((oy + dy) & 1) : oy + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = (ZS & 1) ? (ox & ~1) | ((ox + dx) & 1) : ox + dx;
      const T* px = x + (((size_t)n * hin + iy) * win + ix) * CI;
      const float* wt = s_w[dy * 3 + dx];
#pragma unroll 4
      for (int c = 0; c < CI; c += 8) {
        float v[8];
        load8(px + c, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = fmaf(v[k], wt[c + k], acc);
      }
    }
  }
  const int hl = hout / 2, wl = wout / 2;
  store1(y + (((size_t)n * hl + (oy >> 1)) * wl + (ox >> 1)) * 4
             + (oy & 1) * 2 + (ox & 1),
         leaky(acc + b[0]));
}

template <int CI, int CO, typename T, int IN_MODE>
cudaError_t launch_layer(const void* x, const void* w, const void* b, void* y,
                         int n, int hin, int win, int ph, int pw,
                         cudaStream_t s) {
  const int ntx = (win - 2 + TW - 1) / TW, nty = (hin - 2 + TH - 1) / TH;
  const long long blocks = (long long)ntx * nty * n * (CO / COB);
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  conv3x3_bias_leaky<CI, CO, T, IN_MODE><<<(unsigned)blocks, NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), hin, win, ph, pw,
      ntx, nty);
  return cudaGetLastError();
}

template <int CI, typename T, int ZS = 0>
cudaError_t launch_last(const void* x, const void* w, const void* b, void* y,
                        int n, int hin, int win, cudaStream_t s) {
  const int ncx = (win - 2 + S2D_THREADS - 1) / S2D_THREADS;
  const long long blocks = (long long)ncx * (hin - 2) * n;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  conv3x3_bias_leaky_s2d<CI, T, ZS><<<(unsigned)blocks, S2D_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), hin, win, ncx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_last_zs(int zs, const void* x, const void* w,
                           const void* b, void* y, int n, int hin, int win,
                           cudaStream_t s) {
  switch (zs) {
    case 0: return launch_last<128, T, 0>(x, w, b, y, n, hin, win, s);
    case 1: return launch_last<128, T, 1>(x, w, b, y, n, hin, win, s);
    case 2: return launch_last<128, T, 2>(x, w, b, y, n, hin, win, s);
    case 3: return launch_last<128, T, 3>(x, w, b, y, n, hin, win, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(int layer, int full_res, const void* x, const void* w,
                   const void* b, void* y, int n, int ph, int pw,
                   const LastOut& out, cudaStream_t s) {
  // the stack's output plane is 2hl x 2wl: the nearest-2x upscale of a
  // ph x pw low-res plane, or a ph x pw full-res plane rounded up to even
  const int hl = full_res ? (ph + 1) / 2 : ph;
  const int wl = full_res ? (pw + 1) / 2 : pw;
  // layer k reads a (2hl + 14 - 2k) x (2wl + 14 - 2k) plane
  const int hin = 2 * hl + 14 - 2 * layer, win = 2 * wl + 14 - 2 * layer;
  switch (layer) {
    case 0:
      return full_res
          ? launch_layer<1, 32, T, IN_FULLRES>(x, w, b, y, n, hin, win, ph, pw, s)
          : launch_layer<1, 32, T, IN_LOWRES>(x, w, b, y, n, hin, win, ph, pw, s);
    case 1: return launch_layer<32, 32, T, IN_ACT>(x, w, b, y, n, hin, win, ph, pw, s);
    case 2: return launch_layer<32, 64, T, IN_ACT>(x, w, b, y, n, hin, win, ph, pw, s);
    case 3: return launch_layer<64, 64, T, IN_ACT>(x, w, b, y, n, hin, win, ph, pw, s);
    case 4: return launch_layer<64, 128, T, IN_ACT>(x, w, b, y, n, hin, win, ph, pw, s);
    case 5: return launch_layer<128, 128, T, IN_ACT>(x, w, b, y, n, hin, win, ph, pw, s);
    case 6:
      switch (out.mode) {
        case OUT_S2D: return launch_last<128, T>(x, w, b, y, n, hin, win, s);
        case OUT_DENSE:
          return launch_last_cell<128, T, OUT_DENSE, false>(
              x, w, b, y, out, Tiles{}, n, hl, wl, s);
        case OUT_U8:
          return launch_last_cell<128, T, OUT_U8, false>(
              x, w, b, y, out, Tiles{}, n, hl, wl, s);
        default: return cudaErrorInvalidValue;
      }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch layer `layer` (0..6) of the flagship stack on `stream`.
// bf16 != 0 selects __nv_bfloat16 storage, else float. full_res == 0 is
// the scale stack (x of layer 0 is the low-res plane [n, ph, pw]);
// full_res != 0 is the noise stack (x of layer 0 is the full-res plane
// [n, ph, pw], any size). The last four arguments before the stream are
// read by layer 6 only and choose what it writes to y:
//   out_mode 0  Y in s2d layout [n, hl, wl, 4], storage type;
//   out_mode 1  Y phase-chunked dense [n, hl, ceil(wl/tc)*4*tc], storage
//               type, tc a multiple of 32;
//   out_mode 2  u8 BGR [n, hl, wl, 16] from f32 Y, the device array
//               uvp [n, hl, wl, 8] f32 and the host array cmap[12] (the
//               3 x 3 YUV -> BGR matrix row by row, then its 3 offsets).
// Returns the cudaError_t of the launch (0 on success).
int w2x_stack_layer(int bf16, int full_res, int layer, const void* x,
                    const void* w, const void* b, void* y, int n, int ph,
                    int pw, int out_mode, const void* uvp, const float* cmap,
                    int tc, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0) return (int)cudaErrorInvalidValue;
  LastOut out = {};
  out.mode = out_mode;
  out.uvp = static_cast<const float*>(uvp);
  out.tc = tc;
  if (layer == 6 && out_mode == OUT_U8) {
    if (cmap == nullptr) return (int)cudaErrorInvalidValue;
    out.cm = color_map(cmap);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(layer, full_res, x, w, b, y, n,
                                            ph, pw, out, s)
                    : launch<float>(layer, full_res, x, w, b, y, n, ph, pw,
                                    out, s));
}

// Layer 7 (128 -> 1) in s2d layout under zero-shift mask zs (0..3; bit 0
// columns, bit 1 rows; 0 is w2x_stack_layer's layer 6 with out_mode 0):
// x [n, 2hl+2, 2wl+2, 128] -> y [n, hl, wl, 4], bf16 != 0 selecting
// __nv_bfloat16 storage, else float. Returns the cudaError_t of the launch.
int w2x_stack_last_zs(int bf16, int zs, const void* x, const void* w,
                      const void* b, void* y, int n, int hl, int wl,
                      void* stream) {
  if (n <= 0 || hl <= 0 || wl <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hin = 2 * hl + 2, win = 2 * wl + 2;
  return (int)(bf16 ? launch_last_zs<__nv_bfloat16>(zs, x, w, b, y, n, hin,
                                                    win, s)
                    : launch_last_zs<float>(zs, x, w, b, y, n, hin, win, s));
}

const char* w2x_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
