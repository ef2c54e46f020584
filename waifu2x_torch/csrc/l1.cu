// Layer 1 (1 -> 32 + bias + LeakyReLU) of the waifu2x conv stack on Hopper
// (sm_90a), for the scale and the noise path. Built with nvcc into a shared
// library with a plain C interface and loaded with ctypes
// (waifu2x_torch/ops/_build.py). The Python side is
// waifu2x_torch/ops/stack.py: _Launcher.layer sends layer 1 of every stack
// call here (stack_scale, stack_scale_dense, stack_scale_fused_u8,
// stack_scale_upto, stack_noise_s2d, stack_noise, layer5_plane and the
// probes' stacks), l1_layer runs it alone, l1_plain is its plain version and
// ops/s2d.py:pack_l1_scale packs the scale path's weights.
//
// Replaces: layer 1 of waifu2x_tpu/ops/pallas_stack.py:_stack_body (the
// `l1q` products at :395-421 on the im2col of _xcol_scale / _xcol_noise).
//
// What it computes: x1 [N, 2hg+12, 2wg+12, 32] in the storage type T (f32
// or bf16), NHWC, the output of layer 1 over the stack's padded input plane:
//   scale (x = ylow [N, hl, wl], hg = hl): full-res pixel (Y, X) lies in s2d
//     cell (K, J) = (Y >> 1, X >> 1), phase (A, B) = (Y & 1, X & 1), and
//       x1[n, Y, X, c] = leaky(sum over r, s in {0, 1} of
//                              P[K + A + r, J + B + s] *
//                              w1s[(A + r)*3 + (B + s)][(A*2 + B)*32 + c]
//                              + b1[c])
//     with P[p, q] = ylow[n, clamp(p - 4, 0, hl-1), clamp(q - 4, 0, wl-1)]
//     (pad4 of the JAX package's _xcol_scale). w1s = pack_l1_scale(w1): per
//     phase the f32 sums of the 3 x 3 taps that land on one low-res pixel of
//     the nearest-2x upscale, rounded to T once, as the JAX body rounds them.
//     Each of the four pixels is read through its own clamp; two taps whose
//     clamped positions coincide at an edge keep their own weights.
//   noise (x = y [N, h, w], hg = ceil(h/2)): the 9 taps of w1 [9][32] over
//       V[Y, X] = y[n, clamp(Y - 7, 0, h-1), clamp(X - 7, 0, w-1)],
//     the plane edge-padded to even and then by 7 (pack_l1_noise's weights,
//     each one weight, so the same products).
// The sum runs from the bias in the order written (r, s) = (0,0), (0,1),
// (1,0), (1,1), or t = 0..8, as fmaf, then LeakyReLU and one rounding to T.
// For bf16 every product is exact in f32, so each fmaf equals the plain
// version's product-then-add and the two agree bit for bit.
//
// What bounds it on an H100: the bytes of x1. At scale512 (16 x 512^2 low-
// res) x1 is 16 x 1036^2 x 32 bf16 = 1.10 GB, 0.33 ms at 3.35 TB/s; the
// products are 4 (scale) or 9 (noise) multiply-adds per output, a few GFLOP.
//
// Design, for the store:
//   * A tile is 16 output rows x TW pixels, TW = 256 threads / (16-byte
//     vectors a pixel): 64 pixels in bf16, 32 in f32. Thread t owns the
//     vector t % VPP (V = 8 or 4 channels) of pixel t / VPP, so a warp's
//     store of one row is one contiguous 512-byte run and the block's one
//     4 KB run; each thread issues 16 stores a tile. (8-byte stores in bf16,
//     which halve the weights' registers, and one thread a vector over a
//     flat grid with the inputs from L1 were slower on an H100: PERF.md.)
//   * The tile's input (low-res or full-res, clamps applied) is staged in
//     shared memory as f32, two buffers: the next tile's loads are issued
//     before this tile's products and land in the other buffer after its
//     stores, one barrier a tile. The thread's weights (its column phase B,
//     both row phases: 2 x 4 x V values; or 9 x V for noise) and bias sit
//     in registers for the whole kernel.
//   * Persistent: as many blocks as the SMs hold walk over the tiles.

#include "common.cuh"

namespace {

constexpr int L1_THREADS = 256;
constexpr int L1_TH = 16;        // output rows of a tile (even)

// a thread's store is 16 bytes: V channels of one pixel; a tile row is TW
// pixels; the staged input of a tile is RH x RW values of the plane
template <typename T, int FULL_RES>
struct L1Shape {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int VPP = 32 / V;
  static constexpr int TW = L1_THREADS / VPP;
  static constexpr int RH = FULL_RES ? L1_TH + 2 : L1_TH / 2 + 2;
  static constexpr int RW = FULL_RES ? TW + 2 : TW / 2 + 2;
  static constexpr int NV = (RH * RW + L1_THREADS - 1) / L1_THREADS;
};

// LeakyReLU(0.1) as max(x, 0.1x): the value of common.cuh's leaky (and of
// the plain version's) in two instructions instead of three
__device__ __forceinline__ float leaky2(float x) {
  return fmaxf(x, 0.1f * x);
}

// x: ylow [N, ph, pw] (FULL_RES 0) or y [N, ph, pw] (FULL_RES 1); w: w1s
// [9][128] or w1 [9][32] in T; b [32] f32; y1 [N, h1, w1, 32].
template <typename T, int FULL_RES>
__global__ void __launch_bounds__(L1_THREADS)
l1_conv(const T* __restrict__ x, const T* __restrict__ w,
        const float* __restrict__ b, T* __restrict__ y1, int ph, int pw,
        int h1, int w1, int nty, int ntx, int ntiles) {
  using S = L1Shape<T, FULL_RES>;
  constexpr int V = S::V, VPP = S::VPP, TW = S::TW;
  constexpr int RH = S::RH, RW = S::RW, NV = S::NV;
  constexpr int NW = FULL_RES ? 9 : 8;     // weights per channel a thread
  __shared__ float s_in[2][RH * RW];

  const int tid = threadIdx.x;
  const int px = tid / VPP, c0 = (tid % VPP) * V;
  const int B = px & 1;                     // tiles start at even columns
  float wr[NW][V], br[V];
#pragma unroll
  for (int k = 0; k < V; ++k) br[k] = b[c0 + k];
  if constexpr (FULL_RES) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) wr[t][k] = to_f32(w[t * 32 + c0 + k]);
  } else {
#pragma unroll
    for (int A = 0; A < 2; ++A)
#pragma unroll
      for (int rs = 0; rs < 4; ++rs)
#pragma unroll
        for (int k = 0; k < V; ++k)
          wr[A * 4 + rs][k] = to_f32(
              w[((A + rs / 2) * 3 + B + rs % 2) * 128 + (A * 2 + B) * 32 +
                c0 + k]);
  }

  // a tile's (image, first output row, first output column)
  auto origin = [&](int tile, int& n, int& Y0, int& X0) {
    X0 = (tile % ntx) * TW;
    tile /= ntx;
    Y0 = (tile % nty) * L1_TH;
    n = tile / nty;
  };
  // this thread's values of a tile's staged input, clamps applied
  float v[NV];
  auto fetch = [&](int tile) {
    int n, Y0, X0;
    origin(tile, n, Y0, X0);
    const T* xn = x + (size_t)n * ph * pw;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * L1_THREADS;
      if (i < RH * RW) {
        const int r = i / RW, c = i % RW;
        const int sy = FULL_RES ? min(max(Y0 + r - 7, 0), ph - 1)
                                : min(max(Y0 / 2 + r - 4, 0), ph - 1);
        const int sx = FULL_RES ? min(max(X0 + c - 7, 0), pw - 1)
                                : min(max(X0 / 2 + c - 4, 0), pw - 1);
        v[j] = to_f32(xn[(size_t)sy * pw + sx]);
      }
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * L1_THREADS;
      if (i < RH * RW) s_in[buf][i] = v[j];
    }
  };

  int tile = blockIdx.x;
  if (tile >= ntiles) return;
  fetch(tile);
  put(0);
  __syncthreads();
  // the next tile's loads are in flight while this tile's stores go out
  for (int cur = 0; tile < ntiles; cur ^= 1) {
    const int next = tile + (int)gridDim.x;
    if (next < ntiles) fetch(next);
    int n, Y0, X0;
    origin(tile, n, Y0, X0);
    const int X = X0 + px;
    if (X < w1) {
      T* out = y1 + (((size_t)n * h1 + Y0) * w1 + X) * 32 + c0;
#pragma unroll
      for (int ry2 = 0; ry2 < L1_TH; ry2 += 2) {
#pragma unroll
        for (int A = 0; A < 2; ++A) {
          const int ry = ry2 + A;
          if (Y0 + ry < h1) {
            float acc[V];
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = br[k];
            if constexpr (FULL_RES) {
              const float* s = s_in[cur] + ry * RW + px;
#pragma unroll
              for (int t = 0; t < 9; ++t) {
                const float xv = s[(t / 3) * RW + t % 3];
#pragma unroll
                for (int k = 0; k < V; ++k)
                  acc[k] = fmaf(xv, wr[t][k], acc[k]);
              }
            } else {
              const float* s = s_in[cur] + (ry2 / 2 + A) * RW + px / 2 + B;
              const float xv[4] = {s[0], s[1], s[RW], s[RW + 1]};
#pragma unroll
              for (int rs = 0; rs < 4; ++rs)
#pragma unroll
                for (int k = 0; k < V; ++k)
                  acc[k] = fmaf(xv[rs], wr[A * 4 + rs][k], acc[k]);
            }
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = leaky2(acc[k]);
            if constexpr (V == 8) store8(out + (size_t)ry * w1 * 32, acc);
            else store4(out + (size_t)ry * w1 * 32, acc);
          }
        }
      }
    }
    if (next < ntiles) put(cur ^ 1);
    __syncthreads();   // the next tile staged; this tile's reads are done
    tile = next;
  }
}

template <typename T, int FULL_RES>
cudaError_t launch_l1(const void* x, const void* w, const void* b, void* y,
                      int n, int ph, int pw, cudaStream_t s) {
  const int hg = FULL_RES ? (ph + 1) / 2 : ph;
  const int wg = FULL_RES ? (pw + 1) / 2 : pw;
  const int h1 = 2 * hg + 12, w1 = 2 * wg + 12;
  constexpr int TW = L1Shape<T, FULL_RES>::TW;
  const int nty = (h1 + L1_TH - 1) / L1_TH, ntx = (w1 + TW - 1) / TW;
  const long long tiles = (long long)n * nty * ntx;
  if (tiles <= 0 || tiles > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = l1_conv<T, FULL_RES>;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        L1_THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < most ? tiles : most);
  kernel<<<(unsigned)blocks, L1_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), ph, pw, h1, w1, nty,
      ntx, (int)tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Layer 1 of the stack on `stream`. bf16 != 0 selects __nv_bfloat16
// storage, else float. full_res == 0: the scale stack, x = ylow [n, ph, pw]
// and w = pack_l1_scale(w1) [9][128] in the storage type; full_res != 0: the
// noise stack, x = y [n, ph, pw] (any size) and w = w1 [9][32]. b [32] f32,
// y [n, 2hg+12, 2wg+12, 32] with hg = ph (scale) or ceil(ph/2) (noise), wg
// likewise. Returns the cudaError_t of the launch (0 on success).
int w2x_l1(int bf16, int full_res, const void* x, const void* w,
           const void* b, void* y, int n, int ph, int pw, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)(full_res
        ? launch_l1<__nv_bfloat16, 1>(x, w, b, y, n, ph, pw, s)
        : launch_l1<__nv_bfloat16, 0>(x, w, b, y, n, ph, pw, s));
  return (int)(full_res ? launch_l1<float, 1>(x, w, b, y, n, ph, pw, s)
                        : launch_l1<float, 0>(x, w, b, y, n, ph, pw, s));
}

}  // extern "C"
