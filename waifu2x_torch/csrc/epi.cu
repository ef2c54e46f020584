// UpCUNet's library-layer epilogue on Hopper (sm_90a): the bias, LeakyReLU
// and the cropped skip add of a cuDNN convolution's bf16 output, in one pass
// over it, in place. Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (waifu2x_torch/ops/_build.py). The Python
// side is waifu2x_torch/ops/unet.py: _library runs each of UpCUNet's twelve
// library convolutions (3 -> 32, the 2x2 stride-2 and transposed ones,
// 128 -> 256, 256 -> 128 and the two 64 -> 3) with no bias and hands its
// output here through cunet_epilogue; cunet_epilogue_plain is the plain
// version.
//
// Replaces: no TPU kernel (the JAX package has no UpCUNet). It replaces three
// PyTorch passes over each such output: the bias add that PyTorch's cuDNN
// route makes after the convolution (a broadcast, so TensorIterator's
// unvectorised path, 2-byte accesses), F.leaky_relu, and for the three
// transposed 2x2 layers the skip add of a strided crop (ops/unet.py:
// crop_add, the same unvectorised path).
//
// What it computes, on y [N, h, w, C] bf16 NHWC (contiguous), with the
// parent's three roundings, so the result is bit-equal to those passes:
//   t = bf16(f32(y) + f32(b[c]))                       b: the bf16 bias
//   u = t > 0 ? t : bf16(f32(t) * 0.1f)                where LEAKY
//   y = bf16(f32(skip[n, i + crop, j + crop, c]) + f32(u))   where SKIP
// skip [N, h + 2 crop, w + 2 crop, C] bf16 NHWC, contiguous.
//
// What bounds it on an H100: bytes. y read once and written once, the skip's
// cropped part read once: 4 (6 with a skip) bytes a value. At UpCUNet's
// 436-px tiles, 60 a 4 x 1080p dispatch, that is 43.0 GB, 12.8 ms at
// 3.35 TB/s. The arithmetic is a few instructions a value.
//
// Design, for the bytes:
//   * C % 8 == 0 (32, 64, 128, 256): a thread takes 16-byte vectors, 8
//     channels of one pixel. A block takes EPI_UNROLL x 256 consecutive
//     vectors, as many blocks as that needs: the block scheduler keeps every
//     SM full and each block's start overlaps another's end. (On an H100,
//     the twelve layers at 16 tiles: a persistent grid-stride walk of as
//     many blocks as the SMs hold read 82.8% of the bound, this grid 88.5%;
//     a 2 GB copy reads 90.5%: PERF.md.)
//     The vectors a thread takes lie 256 apart, a multiple of C / 8, so they
//     hold the same 8 channels: their bias sits in registers.
//   * The EPI_UNROLL vectors of a thread are loaded (y and the skip) before
//     any is computed and stored: 4 (8) 16-byte loads a lane in flight.
//     Loads and stores carry the streaming hint (about a point of the
//     bound): each byte is touched once and every plane of a chunk of tiles
//     is larger than the 50 MB L2.
//   * The skip is read at its crop offset: each row of y maps to one
//     contiguous row of the skip, so a warp's 32 vectors are one or two
//     contiguous runs of it.
//   * C = 3 (the two 64 -> 3 layers, 2.8% of the bytes): one 2-byte value a
//     thread and step, EPI_UNROLL_SCALAR of them in flight, the bias in
//     shared memory (62-66% of the bound; 16-byte vectors whose channels
//     rotate read 81-82%, worth 0.1% of a dispatch: not taken).

#include "common.cuh"   // w2x_error_string

namespace {

constexpr int EPI_THREADS = 256;
constexpr int EPI_UNROLL = 4;          // 16-byte vectors a thread
constexpr int EPI_UNROLL_SCALAR = 8;   // 2-byte values a thread
constexpr float EPI_SLOPE = 0.1f;      // LeakyReLU's, as PyTorch's opmath

enum { EPI_LEAKY = 1, EPI_SKIP = 2 };

// y's plane and where the skip's crop starts; count: y's 16-byte vectors
// (C % 8 == 0) or values (C = 3)
struct EpiShape {
  int h, w, crop;
  long long count;
};

__device__ __forceinline__ float bf16_bits_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One value: y's bits, its channel's bias, the skip's bits -> the bits out.
template <int MODE>
__device__ __forceinline__ uint32_t epi1(uint32_t yb, float b, uint32_t sb) {
  float t = round_bf16(__fadd_rn(bf16_bits_f32(yb), b));
  if (MODE & EPI_LEAKY) t = t > 0.0f ? t : round_bf16(__fmul_rn(t, EPI_SLOPE));
  if (MODE & EPI_SKIP) t = __fadd_rn(bf16_bits_f32(sb), t);
  return __bfloat16_as_ushort(__float2bfloat16_rn(t));
}

// Two values packed in a 32-bit word, the lower channel in the low half.
template <int MODE>
__device__ __forceinline__ uint32_t epi2(uint32_t y2, const float* b,
                                         uint32_t s2) {
  return epi1<MODE>(y2 & 0xffffu, b[0], s2 & 0xffffu) |
         (epi1<MODE>(y2 >> 16, b[1], s2 >> 16) << 16);
}

// The skip's index of y's index i, both counted in units of which PER make a
// pixel: y's pixel p is row q = p / w of the N * h rows, in tile q / h; the
// skip's row is that row shifted by the crop, in the same tile.
template <int PER>
__device__ __forceinline__ long long skip_index(long long i,
                                                const EpiShape& s) {
  const unsigned p = (unsigned)(i / PER);
  const unsigned q = p / (unsigned)s.w;
  const unsigned col = p - q * (unsigned)s.w;
  const unsigned tile = q / (unsigned)s.h;
  const long long row = (long long)q + 2LL * s.crop * tile + s.crop;
  return (row * (s.w + 2 * s.crop) + col + s.crop) * PER +
         (i - (long long)p * PER);
}

// Items (vectors or values) a block takes.
template <int C>
constexpr int EPI_BLOCK_ITEMS =
    EPI_THREADS * (C % 8 == 0 ? EPI_UNROLL : EPI_UNROLL_SCALAR);

template <int C, int MODE>
__global__ void __launch_bounds__(EPI_THREADS) cunet_epilogue(
    __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ b,
    const __nv_bfloat16* __restrict__ skip, EpiShape s) {
  // the thread's items: i0 + u * EPI_THREADS
  const long long i0 =
      (long long)blockIdx.x * EPI_BLOCK_ITEMS<C> + threadIdx.x;
  if constexpr (C % 8 == 0) {
    constexpr int CV = C / 8;
    static_assert(EPI_THREADS % CV == 0, "a thread's vectors share lanes");
    const int g = (int)(threadIdx.x % CV);
    float bias[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) bias[k] = __bfloat162float(b[8 * g + k]);
    uint4* yv = reinterpret_cast<uint4*>(y);
    const uint4* sv = reinterpret_cast<const uint4*>(skip);
    uint4 a[EPI_UNROLL], r[EPI_UNROLL];
#pragma unroll
    for (int u = 0; u < EPI_UNROLL; ++u) {
      const long long i = i0 + u * EPI_THREADS;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < s.count) {
        a[u] = __ldcs(yv + i);
        if constexpr ((MODE & EPI_SKIP) != 0)
          r[u] = __ldcs(sv + skip_index<CV>(i, s));
      }
    }
#pragma unroll
    for (int u = 0; u < EPI_UNROLL; ++u) {
      const long long i = i0 + u * EPI_THREADS;
      if (i < s.count) {
        uint4 o;
        o.x = epi2<MODE>(a[u].x, bias + 0, r[u].x);
        o.y = epi2<MODE>(a[u].y, bias + 2, r[u].y);
        o.z = epi2<MODE>(a[u].z, bias + 4, r[u].z);
        o.w = epi2<MODE>(a[u].w, bias + 6, r[u].w);
        __stcs(yv + i, o);
      }
    }
  } else {
    __shared__ float bias[C];
    for (int k = threadIdx.x; k < C; k += EPI_THREADS)
      bias[k] = __bfloat162float(b[k]);
    __syncthreads();
    unsigned short* yh = reinterpret_cast<unsigned short*>(y);
    const unsigned short* sh = reinterpret_cast<const unsigned short*>(skip);
    uint32_t a[EPI_UNROLL_SCALAR], r[EPI_UNROLL_SCALAR];
#pragma unroll
    for (int u = 0; u < EPI_UNROLL_SCALAR; ++u) {
      const long long i = i0 + u * EPI_THREADS;
      a[u] = r[u] = 0u;
      if (i < s.count) {
        a[u] = __ldcs(yh + i);
        if constexpr ((MODE & EPI_SKIP) != 0)
          r[u] = __ldcs(sh + skip_index<C>(i, s));
      }
    }
#pragma unroll
    for (int u = 0; u < EPI_UNROLL_SCALAR; ++u) {
      const long long i = i0 + u * EPI_THREADS;
      if (i < s.count)
        yh[i] = (unsigned short)epi1<MODE>(a[u], bias[(int)(i % C)], r[u]);
    }
  }
}

template <int C, int MODE>
cudaError_t launch_epi(void* y, const void* b, const void* skip,
                       const EpiShape& s, cudaStream_t st) {
  constexpr int per = EPI_BLOCK_ITEMS<C>;
  const long long blocks = (s.count + per - 1) / per;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cunet_epilogue<C, MODE><<<(unsigned)blocks, EPI_THREADS, 0, st>>>(
      static_cast<__nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(skip), s);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_epi_mode(int mode, void* y, const void* b,
                            const void* skip, const EpiShape& s,
                            cudaStream_t st) {
  switch (mode) {
    case 0: return launch_epi<C, 0>(y, b, skip, s, st);
    case EPI_LEAKY: return launch_epi<C, EPI_LEAKY>(y, b, skip, s, st);
    case EPI_SKIP: return launch_epi<C, EPI_SKIP>(y, b, skip, s, st);
    default:
      return launch_epi<C, EPI_LEAKY | EPI_SKIP>(y, b, skip, s, st);
  }
}

}  // namespace

extern "C" {

// The epilogue of one library convolution on `stream`, in place on y
// [n, h, w, c] bf16 NHWC: y = crop(skip) + leaky(y + b), each step rounded
// to bf16 as above. b [c] bf16; skip null (no skip add) or [n, h + 2 crop,
// w + 2 crop, c] bf16; leaky != 0 applies LeakyReLU(0.1). c is 3, 32, 64,
// 128 or 256; y and skip are 16-byte aligned where c % 8 == 0; the pixels of
// y and of the skip each number at most INT_MAX. bf16 must be 1 (the kernel
// has no f32 form). Returns the cudaError_t of the launch (0 on success).
int w2x_cunet_epilogue(int bf16, void* y, const void* b, const void* skip,
                       int n, int h, int w, int c, int crop, int leaky,
                       void* stream) {
  if (!bf16 || n <= 0 || h <= 0 || w <= 0 || crop < 0 || (!skip && crop))
    return (int)cudaErrorInvalidValue;
  const long long px = (long long)n * h * w;
  const long long skip_px = (long long)n * (h + 2LL * crop) * (w + 2LL * crop);
  if (px > INT_MAX || skip_px > INT_MAX) return (int)cudaErrorInvalidValue;
  if (c % 8 == 0 && (((uintptr_t)y | (uintptr_t)skip) & 15u))
    return (int)cudaErrorMisalignedAddress;
  const int mode = (leaky ? EPI_LEAKY : 0) | (skip ? EPI_SKIP : 0);
  EpiShape s{h, w, crop, c % 8 == 0 ? px * (c / 8) : px * c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 3: return (int)launch_epi_mode<3>(mode, y, b, skip, s, st);
    case 32: return (int)launch_epi_mode<32>(mode, y, b, skip, s, st);
    case 64: return (int)launch_epi_mode<64>(mode, y, b, skip, s, st);
    case 128: return (int)launch_epi_mode<128>(mode, y, b, skip, s, st);
    case 256: return (int)launch_epi_mode<256>(mode, y, b, skip, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
