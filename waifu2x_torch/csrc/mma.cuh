// Hopper (sm_90a) tensor-core building blocks for the conv stack's CUDA
// sources: asynchronous 16-byte copies into shared memory (cp.async), the
// proxy and warpgroup fences, shared-memory matrix descriptors without
// swizzle, and the warpgroup product
//   wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16   (N = 16 .. 128)
// with both operands read from shared memory (mma_k16), or for N = 64 and
// N = 128 with A from registers (mma_k16_rs64, mma_k16_rs128), and the f32
// sums kept in registers; and
//   wgmma.mma_async.sync.aligned.m64nNk8.f32.tf32.tf32    (N = 32 .. 128)
// (mma_k8_tf32, and for N = 32 with A from registers, mma_k8_tf32_rs32);
// and
//   wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8
// (mma_k32_s8, exact int32 sums). mma.cu builds the bf16 layers 2-6 kernel
// and the mma_chain probe from them, mma_tf32.cu the f32 layers 2-6 as
// 3xTF32, tmm.cu the four-tap probe layer (A from registers), wino.cu
// the Winograd layer 6 in both types (A from registers), i8.cu the int8
// layer 6. Also the mbarrier, bulk-copy and tensor-map (TMA) steps of
// l7.cu's, mma.cu's, probe.cu's and tmm.cu's rings.
//
// Operand layout without swizzle ("interleaved"): an operand is cut into
// core matrices of 8 rows x 16 bytes (8 bf16 along K), each stored as 128
// contiguous bytes, row after row. A descriptor names the first core
// matrix and two strides:
//   LBO  bytes from a core matrix to the next one along K (the second 8 of
//        an instruction's 16 K values);
//   SBO  bytes from a core matrix to the next one along M (for A) or N (for
//        B): from rows 0-7 to rows 8-15.
// (Settled on the card with the mma_chain probe: with the two exchanged the
// product is wrong.) mma_k16 reads A K-major, [M][K], and B K-major, [N][K].
//
// Accumulator fragment of m64nNk16, thread t of the warpgroup, warp
// w = t / 32, lane l = t % 32: d[4j + 0, 1] are row 16w + l/4, columns
// 8j + 2(l%4) + {0, 1}; d[4j + 2, 3] are row 16w + l/4 + 8, same columns;
// j = 0 .. N/8 - 1.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `valid` false writes 16 zero
// bytes and reads nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// mbarriers in shared memory (l7.cu's and probe.cu's TMA rings): init with
// the arrivals a phase takes, an arrival that also expects `bytes` of
// asynchronous copies, a plain arrival, and a wait for the phase of the
// given parity to complete.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
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
// `bytes` contiguous bytes global -> shared by the TMA unit (a bulk copy, no
// tensor map), counted on the barrier; both addresses and the size are
// multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory by the TMA unit, its bytes counted on the barrier (l7.cu's and
// mma.cu's rings).
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda),
// asked once a library: the host side of the tensor maps of l7.cu, mma.cu
// and tmm.cu.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline cudaError_t encode_tiled(EncodeTiled* out) {
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
  *out = encode;
  return cudaSuccess;
}

// Makes this thread's completed shared-memory writes (cp.async lands
// through the generic proxy) visible to the async proxy that wgmma reads
// through; a barrier between the writers and the readers follows it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING)
               : "memory");
}

// Pins the accumulator registers d at this point of the program: reads of
// them after a wgmma_wait cannot be hoisted above it (the compiler takes
// the registers as final once the last wgmma that writes them is issued).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero
// (cvt.rna.tf32.f32; the same integer form as ops/s2d.py:tf32_round): the
// split of an operand into two TF32 halves, hi = rna(v), lo = rna(v - hi),
// that the 3xTF32 kernels take (mma_tf32.cu, wino.cu).
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// The constant half of a descriptor without swizzle: strides in bytes,
// multiples of 16. Add desc_addr(first core matrix) to it.
__host__ __device__ constexpr uint64_t desc_strides(uint32_t lbo,
                                                    uint32_t sbo) {
  return (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ uint64_t desc_addr(uint32_t shared_addr) {
  return static_cast<uint64_t>((shared_addr & 0x3FFFF) >> 4);
}

#define W2X_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define W2X_ACC16(d, i) \
  W2X_ACC4(d, i), W2X_ACC4(d, i + 4), W2X_ACC4(d, i + 8), W2X_ACC4(d, i + 12)

// d[64 x N] += A[64 x 16] * B[N x 16]^T, one instruction; N / 2 sums a
// thread. The caller brackets a run of them with wgmma_fence() before and
// wgmma_commit(), wgmma_wait<0>() after. Both operands K-major.
template <int N>
__device__ __forceinline__ void mma_k16(float (&d)[N / 2], uint64_t a,
                                        uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "N is 16, 32, 64 or 128");
  if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n"
        "}\n"
        : W2X_ACC4(d, 0), W2X_ACC4(d, 4)
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : W2X_ACC16(d, 0)
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : W2X_ACC16(d, 0), W2X_ACC16(d, 16)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : W2X_ACC16(d, 0), W2X_ACC16(d, 16), W2X_ACC16(d, 32), W2X_ACC16(d, 48)
        : "l"(a), "l"(b), "r"(1));
  }
}

// d[64 x N] += A[64 x 8] * B[N x 8]^T in TF32, one instruction
// (wgmma.mma_async m64nNk8.f32.tf32.tf32); both operands K-major from shared
// memory, f32 values of which the tensor cores keep 10 mantissa bits. A core
// matrix is 8 rows x 16 bytes (4 values along K), so one instruction spans
// two core matrices along K, LBO apart; SBO steps along M or N as in
// mma_k16. TF32 has no transpose bit. The accumulator fragment is
// m64nNk16's. `add` 0 overwrites d with the product instead of adding to
// it. mma_tf32.cu's 3xTF32 layers issue it.
template <int N>
__device__ __forceinline__ void mma_k8_tf32(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int add = 1) {
  static_assert(N == 32 || N == 64 || N == 128, "N is 32, 64 or 128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n"
        "}\n"
        : W2X_ACC16(d, 0)
        : "l"(a), "l"(b), "r"(add));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n"
        "}\n"
        : W2X_ACC16(d, 0), W2X_ACC16(d, 16)
        : "l"(a), "l"(b), "r"(add));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n"
        "}\n"
        : W2X_ACC16(d, 0), W2X_ACC16(d, 16), W2X_ACC16(d, 32), W2X_ACC16(d, 48)
        : "l"(a), "l"(b), "r"(add));
  }
}

// d[64 x 64] += A[64 x 16] * B[64 x 16]^T with A from registers (wino.cu:
// the kernel forms its A operand itself). a holds the thread's fragment as
// bf16 pairs, lower k in the low half, warp w = t / 32 and lane l = t % 32
// of the warpgroup: a[0] row 16w + l/4, k = 2(l%4) + {0, 1}; a[1] row + 8;
// a[2] row 16w + l/4, k + 8; a[3] row + 8, k + 8 (the A fragment of
// mma.m16n8k16 for each warp's 16 rows). B K-major from shared memory as in
// mma_k16. The registers of a must not change until the wgmma that reads
// them is waited for; a wgmma_fence() orders the writes before it.
__device__ __forceinline__ void mma_k16_rs64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : W2X_ACC16(d, 0), W2X_ACC16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T with A from registers (tmm.cu:
// the weights, resident in registers), the fragment of a as in
// mma_k16_rs64; B K-major from shared memory as in mma_k16. `add` 0
// overwrites d with the product. The registers of a must not change until
// the wgmma that reads them is waited for.
__device__ __forceinline__ void mma_k16_rs128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : W2X_ACC16(d, 0), W2X_ACC16(d, 16), W2X_ACC16(d, 32), W2X_ACC16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// d[64 x 32] += A[64 x 8] * B[32 x 8]^T in TF32 with A from registers
// (wino.cu's f32 form: the kernel forms its A operand itself). a holds the
// thread's fragment as f32 values (TF32 values, whose low 13 mantissa bits
// the tensor cores drop), warp w = t / 32, lane l = t % 32 of the
// warpgroup: a[0] row 16w + l/4, k = l%4; a[1] row + 8; a[2] row 16w + l/4,
// k + 4; a[3] row + 8, k + 4 (the A fragment of mma.m16n8k8.tf32 for each
// warp's 16 rows). B K-major from shared memory as in mma_k8_tf32. `add` 0
// overwrites d. The registers of a must not change until the wgmma that
// reads them is waited for.
__device__ __forceinline__ void mma_k8_tf32_rs32(float (&d)[16],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int add = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : W2X_ACC16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

#define W2X_IACC4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define W2X_IACC16(d, i) \
  W2X_IACC4(d, i), W2X_IACC4(d, i + 4), W2X_IACC4(d, i + 8), W2X_IACC4(d, i + 12)

// d[64 x 128] += A[64 x 32] * B[128 x 32]^T in int8 with int32 sums, one
// instruction (wgmma.mma_async m64n128k32.s32.s8.s8); both operands K-major
// from shared memory (8-bit types have no transpose). A core matrix is 8
// rows x 16 bytes (16 int8 along K), so one instruction spans two core
// matrices along K, LBO apart, exactly as a bf16 k16 step does; SBO steps
// along M or N. The accumulator fragment is m64nNk16's, in int32.
__device__ __forceinline__ void mma_k32_s8(int (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : W2X_IACC16(d, 0), W2X_IACC16(d, 16), W2X_IACC16(d, 32),
        W2X_IACC16(d, 48)
      : "l"(a), "l"(b), "r"(1));
}

#undef W2X_IACC16
#undef W2X_IACC4
#undef W2X_ACC16
#undef W2X_ACC4

}  // namespace
