// Layer 7 (128 -> 1) of every bf16 stack call whose layer-6 output is one
// plane, as the JAX body's folded tap product on Hopper's tensor cores
// (sm_90a). Built with nvcc into a shared library with a plain C interface
// and loaded with ctypes (waifu2x_torch/ops/_build.py); the Python side is
// ops/stack.py (_Launcher.l7_fold, last_layer, l7_fold_plain).
//
// Replaces: waifu2x_tpu/ops/pallas_stack.py:_stack_body's layer 7 with
// l7_fold (the tap product of each layer-6 phase, :489-508, and the
// shift-sum and the three epilogues, :603-655), for configurations B1, B2,
// B3, B6 and B5's stack in bf16. f32 calls, the int8 layer 6's tile-major
// input, the truncation's tap forms and the zero-shift variant stay on
// stack.cu's and common.cuh's FFMA kernels.
//
// What it computes, on x6 [N, 2hl+2, 2wl+2, 128] (bf16, NHWC) and the
// folded weights W [512, 16] (ops/s2d.py:pack_l7_fold):
//   the x6 cell (I, J), 0 <= I <= hl, 0 <= J <= wl, is pixels
//   2I..2I+1 x 2J..2J+1, its 512 values in lanes (a*2 + b)*128 + c;
//   Zt[I, J, s*4 + q] = sum over the 512 of cell[k] * W[k, s*4 + q]
//                       (bf16 x bf16 products, f32 sums);
//   Y[i, j, q] = ((Zt[i, j, q] + Zt[i, j+1, 4+q]) + Zt[i+1, j, 8+q])
//                + Zt[i+1, j+1, 12+q]              (s = Dy*2 + Dx in order)
//   then the bias and LeakyReLU in f32, and one of three epilogues on that
//   one f32 Y:
//     OUT_S2D    Y rounded to bf16 once, [N, hl, wl, 4];
//     OUT_DENSE  the same phase-chunked, [N, hl, nx*4*tc], zeros in the
//                last chunk's columns past wl (common.cuh's layout);
//     OUT_U8     Y never rounded: the YUV -> BGR map of common.cuh with
//                __fmul_rn / __fadd_rn and the cell's 8 U/V phases,
//                16 bytes a cell, lanes 12:16 zero.
//
// What bounds it on an H100: the bytes. x6 is read once (1 KB a cell:
// 4.31 GB at scale512, 1.29 ms at 3.35 TB/s); Y is 1/128 of that. The
// products are 2 x 512 x 16 per cell, 0.07 ms of the bf16 peak. The FFMA
// kernels it replaces read each pixel in 16-byte pieces 256-512 bytes apart
// from their neighbours' and ran at about a tenth of the memory rate.
//
// Design:
//   * A tile is 64 consecutive cells of one cell row: the two pixel rows'
//     128 pixels, 64 KB, contiguous in x6. The Tensor Memory Accelerator
//     copies it into shared memory as eight boxes of 64 cells x 64
//     channels, one per pixel row a, column parity b and half of the
//     channels: x6 seen as the 4-d tensor (channel, parity, cell column,
//     pixel row) with the 128-byte swizzle, which is a K-major wgmma
//     operand as it lands (cells the M rows, 64 inputs of K a box). One
//     thread issues a tile's eight copies on an mbarrier that counts its
//     bytes; cells past the plane's edge read zero.
//   * One warpgroup multiplies the tile by W, resident in shared memory, as
//     32 wgmma m64n16k16 (f32 sums in 8 registers a thread) and writes Zt,
//     64 B a cell, to one of two shared buffers: this cell row's and the
//     previous one's. Y of cell row i is formed from the two.
//   * A strip is 63 output cells wide (the 64th tile cell is its column
//     halo). The strips of all images, cut into output rows, are one list
//     of rows shared out evenly over a persistent grid of one block an SM:
//     a block walks down its rows, each run of rows of one strip starting
//     with one halo tile row, so that every x6 byte is read once but for
//     the halo column and a row at each run's start. A ring of 3 tiles
//     keeps two tiles in flight while the third is multiplied. (Staged by
//     16-byte cp.async copies from the block's four warps instead, the tile
//     ran at about half the memory rate, with or without the products: the
//     copies in flight bound that form.)
//   * The tensor map is made at each launch (cuTensorMapEncodeTiled, reached
//     through the runtime's driver entry point, so the library links no
//     libcuda) and passed as a __grid_constant__ parameter.

#include <cuda.h>
#include <limits.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int L7_THREADS = 128;              // one warpgroup
constexpr int L7_CELLS = 64;                 // cells a tile: one m64 block
constexpr int L7_OUT = L7_CELLS - 1;         // output cells of a strip
constexpr int L7_K8 = 4 * 128 / 8;           // k8 groups of a cell: 64
constexpr int L7_STAGES = 3;
constexpr int L7_ZP = 20;                    // a cell's Zt row, floats
constexpr uint32_t L7_BOX_BYTES = L7_CELLS * 128;   // 64 cells x 64 channels
constexpr uint32_t L7_TILE_BYTES = 8 * L7_BOX_BYTES;
constexpr uint32_t L7_W_BYTES = L7_K8 * 16 * 16;
constexpr uint32_t L7_ZT_BYTES = L7_CELLS * L7_ZP * 4;
// the ring's tiles start 1024-byte aligned (the 128-byte swizzle's period);
// the dynamic window is aligned up to that first
constexpr uint32_t L7_SMEM = 1024 + L7_STAGES * L7_TILE_BYTES + L7_W_BYTES +
                             2 * L7_ZT_BYTES + L7_STAGES * 8;
static_assert(L7_SMEM <= 232448, "over the 227 KB a block may use");

struct L7Args {
  const __nv_bfloat16* w;   // [512][16]
  const float* b;           // [1]
  void* y;
  const float* uvp;         // OUT_U8: [n, hl, wl, 8]
  ColorMap cm;              // OUT_U8
  int hl, wl, tc, wcols, nstrips;
  int rows;                 // n * nstrips * hl output rows in all
};

// A position in a block's list of tiles: output row u = ((n * nstrips +
// strip) * hl + row), and whether this is the halo tile of a run's start
// (cell row `row`, no output) or the tile that completes output row `row`
// (cell row row + 1). Kept as its parts, so that walking the list takes no
// division.
struct Cursor {
  int u, row, strip, n;
  bool head;
};

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// One box of the tensor map (coordinates innermost first) into shared
// memory, its bytes counted on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
}

template <int OUT_MODE>
__global__ void __launch_bounds__(L7_THREADS, 1)
l7_fold(const __grid_constant__ CUtensorMap xmap, L7Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t s_w = sbase + L7_STAGES * L7_TILE_BYTES;
  float* zt = reinterpret_cast<float*>(smem + L7_STAGES * L7_TILE_BYTES +
                                       L7_W_BYTES);
  const uint32_t s_bar = s_w + L7_W_BYTES + 2 * L7_ZT_BYTES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L7_STAGES; ++s) mbar_init(s_bar + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // W [512][16] -> [k8][n][8]: a K-major B operand, core matrices of 8
  // output lanes x 8 inputs
  {
    const uint16_t* wg = reinterpret_cast<const uint16_t*>(a.w);
    uint16_t* ws = reinterpret_cast<uint16_t*>(smem + L7_STAGES *
                                               L7_TILE_BYTES);
    for (int i = tid; i < 512 * 16; i += L7_THREADS)
      ws[((i >> 7) * 16 + (i & 15)) * 8 + ((i >> 4) & 7)] = wg[i];
  }

  // this block's output rows [u0, u1) of the list
  const int per = a.rows / (int)gridDim.x, extra = a.rows % (int)gridDim.x;
  const int bid = blockIdx.x;
  const int u0 = bid * per + min(bid, extra);
  const int u1 = u0 + per + (bid < extra ? 1 : 0);
  const int h6 = 2 * a.hl + 2;

  auto advance = [&](Cursor& c) {
    if (c.head) {
      c.head = false;
      return;
    }
    ++c.u;
    if (++c.row == a.hl) {   // the next strip's run starts with its halo
      c.row = 0;
      c.head = true;
      if (++c.strip == a.nstrips) {
        c.strip = 0;
        ++c.n;
      }
    }
  };
  // the tile at c into ring stage st (nothing past the list's end): eight
  // boxes of 64 cells x 64 channels, one for each pixel row a, column
  // parity b and half of the channels, box (a*2 + b)*2 + h holding inputs
  // k = ((a*2 + b)*2 + h)*64 + c of the cells, issued by one thread
  auto load = [&](const Cursor& c, int st) {
    if (tid == 0 && c.u < u1) {
      const uint32_t bar = s_bar + 8 * st;
      mbar_expect(bar, L7_TILE_BYTES);
      const int row = c.n * h6 + 2 * (c.row + (c.head ? 0 : 1));
      for (int box = 0; box < 8; ++box)
        tma_load(sbase + st * L7_TILE_BYTES + box * L7_BOX_BYTES, &xmap,
                 64 * (box & 1), (box >> 1) & 1, c.strip * L7_OUT,
                 row + (box >> 2), bar);
    }
  };

  Cursor pc;
  pc.u = u0;
  pc.row = u0 % a.hl;
  pc.strip = (u0 / a.hl) % a.nstrips;
  pc.n = u0 / a.hl / a.nstrips;
  pc.head = true;
  Cursor cc = pc;
  fence_proxy_async();   // W's stores, before the products read them
  __syncthreads();       // and the barriers' initialisation
  for (int s = 0; s < L7_STAGES - 1; ++s) {
    load(pc, s);
    advance(pc);
  }
  // A: K-major, 128-byte swizzle (layout type 1), SBO 8 cells (1024 B) on;
  // B: no swizzle, LBO a k8 group (16 lanes x 16 B) on, SBO 8 lanes on
  constexpr uint64_t a_str = desc_strides(16, 1024) | (1ull << 62);
  constexpr uint64_t b_str = desc_strides(16 * 16, 128);
  const float bias = a.b[0];
  const int lane = tid & 31, w4 = tid >> 5;
  int t = 0, zb = 0;
  while (cc.u < u1) {
    const int st = t % L7_STAGES;
    __syncthreads();   // every thread is done with stage t-1's tile
    load(pc, (t + L7_STAGES - 1) % L7_STAGES);
    advance(pc);
    mbar_wait(s_bar + 8 * st, (t / L7_STAGES) & 1);   // tile t has landed

    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
    const uint32_t ta = sbase + st * L7_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L7_K8 / 2; ++ks)   // box ks / 4, 32 bytes a step
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

    if (!cc.head && tid < L7_OUT) {
      const int i = cc.row, n = cc.n;
      const int j = cc.strip * L7_OUT + tid;
      const float* zp = zt + (zb ^ 1) * L7_CELLS * L7_ZP;   // cell row i
      if (j < a.wcols) {
        const float4 z0 = *reinterpret_cast<const float4*>(zp + tid * L7_ZP);
        const float4 z1 = *reinterpret_cast<const float4*>(
            zp + (tid + 1) * L7_ZP + 4);
        const float4 z2 = *reinterpret_cast<const float4*>(
            z + tid * L7_ZP + 8);
        const float4 z3 = *reinterpret_cast<const float4*>(
            z + (tid + 1) * L7_ZP + 12);
        float yv[4] = {((z0.x + z1.x) + z2.x) + z3.x,
                       ((z0.y + z1.y) + z2.y) + z3.y,
                       ((z0.z + z1.z) + z2.z) + z3.z,
                       ((z0.w + z1.w) + z2.w) + z3.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) yv[q] = leaky(yv[q] + bias);
        const size_t cell = ((size_t)n * a.hl + i) * a.wl + j;
        if constexpr (OUT_MODE == OUT_S2D) {
          store4(static_cast<__nv_bfloat16*>(a.y) + cell * 4, yv);
        } else if constexpr (OUT_MODE == OUT_DENSE) {
          __nv_bfloat16* yd = static_cast<__nv_bfloat16*>(a.y) +
                              ((size_t)n * a.hl + i) * a.wcols * 4 +
                              (size_t)(j / a.tc) * 4 * a.tc + j % a.tc;
          const bool pad = j >= a.wl;   // the last chunk's pad columns
#pragma unroll
          for (int q = 0; q < 4; ++q)
            store1(yd + (size_t)q * a.tc, pad ? 0.0f : yv[q]);
        } else {
          const float4 u4 = reinterpret_cast<const float4*>(a.uvp)[cell * 2];
          const float4 v4 =
              reinterpret_cast<const float4*>(a.uvp)[cell * 2 + 1];
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
          static_cast<uint4*>(a.y)[cell] =
              make_uint4(word[0], word[1], word[2], 0u);
        }
      }
    }
    zb ^= 1;
    ++t;
    advance(cc);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// x [n, 2hl+2, 2wl+2, 128] as the 4-d tensor (channel, column parity, cell
// column, pixel row of all images), boxes of 64 channels x 1 x 64 cells x 1
// row with the 128-byte swizzle; cells past wl read zero
cudaError_t make_map(CUtensorMap* map, const void* x, int n, int hl,
                     int wl) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const uint64_t w6 = 2 * (uint64_t)wl + 2;
  const cuuint64_t dims[4] = {128, 2, (cuuint64_t)wl + 1,
                              (cuuint64_t)n * (2 * hl + 2)};
  const cuuint64_t strides[3] = {256, 512, w6 * 256};
  const cuuint32_t box[4] = {64, 1, L7_CELLS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int OUT_MODE>
cudaError_t launch(const void* x, int n, const L7Args& a, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto kernel = l7_fold<OUT_MODE>;
  // over 48 KB of dynamic shared memory is refused without this
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L7_SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = make_map(&map, x, n, a.hl, a.wl);
  if (err != cudaSuccess) return err;
  const int blocks = a.rows < sms ? a.rows : sms;
  kernel<<<(unsigned)blocks, L7_THREADS, L7_SMEM, s>>>(map, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Layer 7 of a bf16 stack (bf16 must be 1) on `stream`: x [n, 2hl+2,
// 2wl+2, 128], w the folded weights [512, 16], b [1] f32, and out_mode 0
// (y [n, hl, wl, 4] bf16), 1 (y [n, hl, ceil(wl/tc)*4*tc] bf16, tc a
// multiple of 32) or 2 (y u8 [n, hl, wl, 16] from the device array uvp
// [n, hl, wl, 8] f32 and the host array cmap[12], w2x_stack_layer's). x, w,
// y and uvp 16-byte aligned. Returns the cudaError_t of the launch.
int w2x_l7_fold(int bf16, const void* x, const void* w, const void* b,
                void* y, int n, int hl, int wl, int out_mode,
                const void* uvp, const float* cmap, int tc, void* stream) {
  if (!bf16 || n <= 0 || hl <= 0 || wl <= 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(uvp)) %
          16)
    return (int)cudaErrorInvalidValue;
  L7Args a = {};
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.b = static_cast<const float*>(b);
  a.y = y;
  a.uvp = static_cast<const float*>(uvp);
  a.hl = hl;
  a.wl = wl;
  a.tc = tc;
  a.wcols = wl;
  if (out_mode == OUT_DENSE) {
    if (tc <= 0 || tc % 32) return (int)cudaErrorInvalidValue;
    a.wcols = (wl + tc - 1) / tc * tc;
  } else if (out_mode == OUT_U8) {
    if (uvp == nullptr || cmap == nullptr) return (int)cudaErrorInvalidValue;
    a.cm = color_map(cmap);
  } else if (out_mode != OUT_S2D) {
    return (int)cudaErrorInvalidValue;
  }
  a.nstrips = (a.wcols + L7_OUT - 1) / L7_OUT;
  const long long rows = (long long)n * a.nstrips * hl;
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  a.rows = (int)rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_mode) {
    case OUT_S2D: return (int)launch<OUT_S2D>(x, n, a, s);
    case OUT_DENSE: return (int)launch<OUT_DENSE>(x, n, a, s);
    default: return (int)launch<OUT_U8>(x, n, a, s);
  }
}

}  // extern "C"
