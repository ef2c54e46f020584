// Layer 6 of the conv stack as int8 x int8 (configuration B4) on Hopper's
// int8 tensor cores (sm_90a). Built with nvcc into a shared library with a
// plain C interface and loaded with ctypes (waifu2x_torch/ops/_build.py).
// The Python side is waifu2x_torch/ops/stack.py: _Launcher.l6_i8 runs
// this kernel for every stack call under l6_i8, from the tile maxima that
// layer 5 took in its epilogue (and l6_i8_layer alone, given them);
// l6_i8_layer_plain is the plain version, ops/s2d.py:pack_mma_i8 the weight
// packer.
//
// Replaces: waifu2x_tpu/ops/pallas_stack.py:_stack_body's layer 6 with
// l6_i8=True (the int8 matrix unit with a per-tile activation scale).
//
// What it computes: l6_i8_layer_plain's function. The stack runs on
// the plane edge-extended to a grid of (tr, tc)-cell tiles; tile (ti, tj)
// reads the window of layer 5's output x5 at rows [2 ti tr, 2 ti tr + 2tr
// + 4) and columns [2 tj tc, 2 tj tc + 2tc + 4):
//   sx = max(m, 1e-8) * (1/127)  (m = max |x5| over the window, from
//        layer 5's epilogue),  x5q = clip(rint(x5 * (1/sx)),
//        +-127)
//   x6 = leaky(float(sum_int32(x5q * w6q)) * (sx * sw[co]) + b6[co])
// over the window's (2tr+2) x (2tc+2) outputs, rounded to the storage type
// and stored tile-major, [N, ny, nx, 2tr+2, 2tc+2, 128]. rint is round half
// to even; the int32 sums are exact (1152 * 127^2 < 2^31), whatever their
// order; the dequantisation is written with __fmul_rn / __fadd_rn. So the
// output is bit for bit that of the plain version.
//
// What bounds it on an H100: the int8 multiply-adds of the tile windows
// (1152 a value; 2.53e12 at scale512's default tile, 2.56 ms at the 1,979
// TOPS int8 peak) and about as much for the bytes (x5 read and x6's
// tile-major plane written once, 8.7 GB in bf16 at scale512, 2.60 ms at
// 3.35 TB/s). The __dp4a kernel ran at some 20x that.
//
// Design:
//   * Implicit GEMM on wgmma m64n128k32 s8 x s8 -> s32, as csrc/mma.cu's
//     bf16 layers: a unit is a 16 x 16 output sub-tile of one tile, all 128
//     output channels, D[256, 128] = sum over the 9 taps of A_tap[256, 128]
//     * W_tap[128, 128]; four warpgroups each own one 8 x 8 quarter as one
//     m64 accumulator (64 int32 registers a thread). A unit never straddles
//     two tiles (their scales differ); (2tr+2) x (2tc+2) is not a multiple
//     of 16, so a tile's last row and column of units are partly outside
//     it and masked.
//   * The unit's 18 x 18 window of x5 is quantised while it is staged
//     (loaded to registers, scaled, rounded, clipped, packed four to a
//     word, stored to shared memory), so no int8 copy of x5 is ever stored.
//     Its layout is mma.cu's with int8 for bf16: [k16][window row][window
//     col][16 channels], 8 neighbouring pixels x 16 channels one 128-byte
//     core matrix; tap (dy, dx) of the m64 quarter's A operand is one
//     descriptor, SBO the window's row pitch, LBO the k16 stride, start
//     moved by (dy * 18 + dx) * 16 bytes. The k16 stride is 325 16-byte
//     units, odd, so that a half-warp's 8-byte stores of one pixel's 8 k16
//     groups fall into 16 different banks. Pixels outside the tile's window
//     are zero.
//   * The weights, packed on the host as [CI/16][9][CO][16] int8
//     (pack_mma_i8: 16 input channels of one output channel in 16 bytes,
//     8 output channels one core matrix of a K-major B operand, SBO 128
//     bytes, LBO 9 * 128 * 16), are loaded once per block and stay resident
//     (144 KB). Beside them two window buffers (2 x 40.6 KB) and the
//     channels' (sw, b) pairs: the grid is persistent (one block an SM
//     walking the units), and the next unit's window is quantised and
//     staged while the tensor cores multiply this one's. One barrier per
//     unit.
//   * A warpgroup's wgmma issue stalls while its queue is full, so staging
//     placed after the last tap ran after the products, not beside them
//     (the two added up). The staging is cut into one group of 8 channels
//     a thread per tap, issued between the taps' products, each group's
//     load two taps ahead of its quantisation and store (with the tile
//     maxima, at scale512 in bf16 on an H100 80GB HBM3 at 700 W: 10.26 ->
//     7.57 ms, chip_smoke.py phase 25).
//   * Epilogue straight from the accumulators: float(sum), the tile's
//     scale, bias, LeakyReLU. In f32 a quad of lanes writes 32 contiguous
//     bytes of a pixel a store; in bf16 the quad transposes its words
//     four at a time (four shuffles) so that each lane writes 16 bytes and
//     the quad 64.
//   * Deterministic: no split-K, no atomics.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int QT = 16;                  // a unit: QT x QT output pixels
constexpr int QWIN = QT + 2;            // window rows and columns
constexpr int Q_THREADS = 512;          // four warpgroups, an 8 x 8 each
constexpr int Q_C = 128;                // layer 6's channels
constexpr int QS = QWIN * QWIN + 1;     // k16 stride, 16-byte units (odd)
constexpr uint32_t Q_WIN_BYTES = (Q_C / 16) * QS * 16;
constexpr uint32_t Q_W_BYTES = (Q_C / 16) * 9 * Q_C * 16;
constexpr uint32_t Q_SMEM = Q_W_BYTES + 2 * Q_WIN_BYTES + Q_C * 8;
static_assert(Q_SMEM <= 232448, "over the 227 KB a block may use");
constexpr int Q_GROUPS = QWIN * QWIN * 16;   // 8-channel groups a window
constexpr int Q_PER = (Q_GROUPS + Q_THREADS - 1) / Q_THREADS;

// Where unit u lies: units are numbered sub-tile fastest, then tile column,
// tile row and image, so that neighbouring units share a tile.
struct Unit {
  size_t tile;   // (n * ny + ti) * nx + tj
  int ti, tj, n, oy0, ox0;

  __device__ Unit(int u, const Tiles& qt, int ntx, int nty) {
    ox0 = QT * (u % ntx);
    u /= ntx;
    oy0 = QT * (u % nty);
    u /= nty;
    tile = (size_t)u;
    tj = u % qt.nx;
    u /= qt.nx;
    ti = u % qt.ny;
    n = u / qt.ny;
  }
};

// One staging group's raw values, 8 channels of one pixel as stored (f32 or
// bf16): two or one 16-byte words, zero outside the tile's window.
template <typename T>
struct Raw {
  uint4 w[sizeof(T) / 2];
};

// x5 [N, H5, W5, 128]; wp [8][9][128][16] int8; sw, b [128] f32; m
// [N, ny, nx] (max |x5| of each tile's window); x6 [N, ny, nx, 2tr+2,
// 2tc+2, 128]. A persistent grid walks the `units` units.
template <typename T>
__global__ void __launch_bounds__(Q_THREADS, 1)
l6_i8_mma(const T* __restrict__ x5, const int8_t* __restrict__ wp,
          const float* __restrict__ sw, const float* __restrict__ b,
          const float* __restrict__ m, T* __restrict__ x6, int H5, int W5,
          Tiles qt, int ntx, int nty, int units) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = smem_addr(smem);
  float2* s_sb = reinterpret_cast<float2*>(smem + Q_W_BYTES +
                                           2 * Q_WIN_BYTES);   // (sw, b)
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                  // warpgroup: unit quarter
  const int ty8 = wg >> 1, tx8 = wg & 1;
  const int hout = 2 * qt.tr + 2, wout = 2 * qt.tc + 2;

  for (int i = tid; i < (int)(Q_W_BYTES / 16); i += Q_THREADS)
    cp_async16(sbase + i * 16, wp + (size_t)i * 16, true);
  cp_async_commit();
  if (tid < Q_C) s_sb[tid] = make_float2(sw[tid], b[tid]);

  // Staging: group g of a window is 8 channels, (pixel p, k16 group c16,
  // half h) = (g / 16, (g / 2) % 8, g % 2), so that 16 neighbouring
  // threads read one pixel's 128 channels; thread tid takes the groups
  // g = tid + k * Q_THREADS, k = 0 .. Q_PER - 1.
  struct Window {
    const T* xw;   // the tile's window's first pixel
    float inv;     // 1 / sx
    int oy0, ox0;
  };
  auto window = [&](int u) {
    const Unit at(u, qt, ntx, nty);
    Window w;
    w.inv = __fdiv_rn(1.0f, i8_scale(m[at.tile]));
    w.xw = x5 + (((size_t)at.n * H5 + 2 * at.ti * qt.tr) * W5 +
                 2 * at.tj * qt.tc) * Q_C;
    w.oy0 = at.oy0;
    w.ox0 = at.ox0;
    return w;
  };
  auto fetch = [&](const Window& w, int k, Raw<T>& r) {
    const int g = tid + k * Q_THREADS, p = g >> 4;
    const int iy = w.oy0 + p / QWIN, ix = w.ox0 + p % QWIN;
    if (g < Q_GROUPS && iy < hout + 2 && ix < wout + 2) {
      const uint4* src = reinterpret_cast<const uint4*>(
          w.xw + ((size_t)iy * W5 + ix) * Q_C + (g & 15) * 8);
#pragma unroll
      for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.w[i] = src[i];
    } else {
#pragma unroll
      for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
        r.w[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // zero words quantise to zero: the groups outside the tile's window
  auto put = [&](const Window& w, int k, const Raw<T>& r, int buf) {
    const int g = tid + k * Q_THREADS;
    if (g >= Q_GROUPS) return;
    float v[8];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        v[4 * i] = __uint_as_float(r.w[i].x);
        v[4 * i + 1] = __uint_as_float(r.w[i].y);
        v[4 * i + 2] = __uint_as_float(r.w[i].z);
        v[4 * i + 3] = __uint_as_float(r.w[i].w);
      }
    } else {
      const uint32_t h2[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 pair;
        *reinterpret_cast<uint32_t*>(&pair) = h2[i];
        const float2 f = __bfloat1622float2(pair);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int q =
          max(-127, min(127, __float2int_rn(__fmul_rn(v[e], w.inv))));
      word[e >> 2] |= (uint32_t)(q & 0xff) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(smem + Q_W_BYTES + buf * Q_WIN_BYTES +
                              (((g >> 1) & 7) * QS + (g >> 4)) * 16 +
                              (g & 1) * 8) = make_uint2(word[0], word[1]);
  };

  // A: LBO the k16 stride, SBO one window row; B: LBO 16 input channels
  // on (9 taps x 128 outputs), SBO 8 output channels on
  constexpr uint64_t a_str = desc_strides(QS * 16, QWIN * 16);
  constexpr uint64_t b_str = desc_strides(9 * Q_C * 16, 128);
  const uint32_t a_off = ((8 * ty8) * QWIN + 8 * tx8) * 16;
  const int lane = tid & 31, w4 = (tid >> 5) & 3, quad = lane & 3;

  int u = blockIdx.x, buf = 0;
  if (u < units) {
    const Window w = window(u);
#pragma unroll
    for (int k = 0; k < Q_PER; ++k) {
      Raw<T> r;
      fetch(w, k, r);
      put(w, k, r, 0);
    }
  }
  cp_async_wait<0>();    // the weights
  fence_proxy_async();   // this thread's stores, before wgmma reads them
  __syncthreads();
  for (; u < units; u += gridDim.x) {
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    const uint32_t win = sbase + Q_W_BYTES + buf * Q_WIN_BYTES + a_off;
    // The next unit's window goes into the other buffer between this
    // unit's taps: a warpgroup's wgmma issue waits while its queue is full,
    // so work placed after the last tap would not overlap the products.
    // Group k is fetched two taps before it is quantised and stored.
    const bool next = u + (int)gridDim.x < units;
    const Window nw = window(next ? u + gridDim.x : u);
    Raw<T> r[3];
    if (next) {
      fetch(nw, 0, r[0]);
      fetch(nw, 1, r[1]);
    }
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < Q_C / 32; ++ks)
        mma_k32_s8(acc,
                   a_str | desc_addr(win + (2 * ks * QS + dy * QWIN + dx) *
                                               16),
                   b_str | desc_addr(sbase + (2 * ks * 9 + tap) * Q_C * 16));
      if (next) {
        if (tap + 2 < Q_PER) fetch(nw, tap + 2, r[(tap + 2) % 3]);
        put(nw, tap, r[tap % 3], buf ^ 1);
        if (tap == 8) {   // the groups past the ninth tap
#pragma unroll
          for (int k = 9; k < Q_PER; ++k) {
            if (k + 2 < Q_PER) fetch(nw, k + 2, r[(k + 2) % 3]);
            put(nw, k, r[k % 3], buf ^ 1);
          }
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    // thread (warp w4, lane l) holds pixels (2 w4 + h, l / 4) of its
    // quarter, channels 8j + 2(l % 4) + {0, 1}
    const Unit at(u, qt, ntx, nty);
    const float sx = i8_scale(m[at.tile]);
    const int ox = at.ox0 + 8 * tx8 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oy = at.oy0 + 8 * ty8 + 2 * w4 + h;
      const bool keep = oy < hout && ox < wout;
      T* out = x6 + ((at.tile * hout + oy) * wout + ox) * Q_C;
      // four j at a time: 8 values, two channels each of 4 j
#pragma unroll
      for (int t = 0; t < Q_C / 32; ++t) {
        float y[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * t + jj;
            const float2 sb = s_sb[8 * j + 2 * quad + e];
            y[2 * jj + e] = leaky(__fadd_rn(
                __fmul_rn((float)acc[4 * j + 2 * h + e], __fmul_rn(sx, sb.x)),
                sb.y));
          }
        }
        if constexpr (sizeof(T) == 4) {
          // a quad writes 32 contiguous bytes of the pixel for each j
          if (keep) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              store2(out + 8 * (4 * t + jj) + 2 * quad, y[2 * jj],
                     y[2 * jj + 1]);
          }
        } else {
          // bf16 pairs transposed within the quad (two exchanges), so
          // that lane q writes 16 bytes, channels 8(4t + q) .. + 7, and a
          // quad 64 contiguous bytes of the pixel
          uint32_t wd[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(y[2 * jj], y[2 * jj + 1]);
            wd[jj] = *reinterpret_cast<const uint32_t*>(&v);
          }
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
            *reinterpret_cast<uint4*>(out + 8 * (4 * t + quad)) =
                make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
    }
    fence_proxy_async();   // the next window's stores, before its products
    __syncthreads();       // everyone's; and this unit's products are done
    buf ^= 1;
  }
}

template <typename T>
cudaError_t launch_i8_mma(const void* x5, const void* wp, const void* sw,
                          const void* b, const void* m, void* x6, int n,
                          Tiles qt, cudaStream_t s) {
  const int H5 = 2 * qt.ny * qt.tr + 4, W5 = 2 * qt.nx * qt.tc + 4;
  const int ntx = (2 * qt.tc + 2 + QT - 1) / QT;
  const int nty = (2 * qt.tr + 2 + QT - 1) / QT;
  const long long units = (long long)n * qt.ny * qt.nx * nty * ntx;
  if (units <= 0 || units > INT_MAX) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  auto kernel = l6_i8_mma<T>;
  // over 48 KB of dynamic shared memory is refused without this
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Q_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = units < sms ? (int)units : sms;
  kernel<<<(unsigned)blocks, Q_THREADS, Q_SMEM, s>>>(
      static_cast<const T*>(x5), static_cast<const int8_t*>(wp),
      static_cast<const float*>(sw), static_cast<const float*>(b),
      static_cast<const float*>(m), static_cast<T*>(x6), H5, W5, qt, ntx,
      nty, (int)units);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B4 on the tensor cores, on `stream`: x6 [n, ny, nx, 2tr+2, 2tc+2, 128]
// from x5 [n, 2 ny tr + 4, 2 nx tc + 4, 128] (bf16 != 0: bf16, else f32),
// the packed int8 weights wp [8][9][128][16] (pack_mma_i8), their scales
// sw [128] f32, the bias b [128] f32 and the tiles' max |x5| m [n, ny, nx]
// f32 (w2x_mma_layer_max / w2x_tf32_layer_max). The kernel owns its
// geometry (Q_SMEM
// bytes of shared memory, Q_THREADS threads a block). Returns the
// cudaError_t of the launch.
int w2x_l6_i8_mma(int bf16, const void* x5, const void* wp, const void* sw,
                  const void* b, const void* m, void* x6, int n, int tr,
                  int tc, int ny, int nx, void* stream) {
  const Tiles qt = {tr, tc, ny, nx};
  if (n <= 0 || !tiles_ok(qt) ||
      (reinterpret_cast<uintptr_t>(x5) | reinterpret_cast<uintptr_t>(wp) |
       reinterpret_cast<uintptr_t>(x6)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_i8_mma<__nv_bfloat16>(x5, wp, sw, b, m, x6, n,
                                                   qt, s)
                    : launch_i8_mma<float>(x5, wp, sw, b, m, x6, n, qt, s));
}

}  // extern "C"
