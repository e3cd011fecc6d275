// hopper.cuh: the Hopper pieces of the port's flash kernels (sm_90a):
// mbarriers, TMA tile loads, wgmma descriptors and products, register
// reallocation, and the host side's tensor maps.  Included by
// csrc/flash_fwd.cu (kernel 5) and csrc/flash_bwd.cu (kernels 6 and 7).
//
// Tiles in shared memory are what a TMA load with a 32, 64 or 128-byte
// swizzle leaves there: a (rows, D) tile of a 16-bit type is D / C boxes of
// (rows, C) columns, C = min(D, 64), each row of a box C * 2 bytes (the
// swizzle span), each box 1024-byte aligned.  One such tile serves wgmma
// two ways:
// - K-major (desc_k): the tile's rows are the product's M or N and its
//   columns the reduction, as Q, K and V in S = Q K^T;
// - MN-major (desc_mn, wgmma's transposed B): its rows are the reduction
//   and its columns the product's N, as V in O += P V.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// the inits visible to every thread and to the async proxy (TMA)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more to come from TMA before the phase completes
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the phase of this parity has completed: parity 0 for a barrier's
// first use, then 1, 0, ...; a producer waiting for a free slot passes its
// first wait with parity 1 (the phase before the first)
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one box of a 3-D map (column c, row r, batch row b) into shared memory;
// its bytes complete on `bar`, rows past the tensor's end read as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c, int r, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c), "r"(r), "r"(b)
      : "memory");
}

// ---------------------------------------------------------------------------
// register reallocation between warpgroups
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// the tile layout of a head size D: columns of a box, bytes of a box row
// (the swizzle span), boxes per row, and the descriptor's swizzle code
template <int D>
struct Span {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kBoxes = D / kCols;
  static constexpr uint64_t kCode =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static_assert(D % 16 == 0 && kRowBytes >= 32, "head sizes 16 to 128");
};

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t code) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | code << 62;
}

// K-major operand: rows row0 .. row0 + 63 (A) or all `rows` (B) of a tile
// of `rows` rows at shared address `tile`, reduction step ks (16 columns):
// within a box the step moves 32 bytes along the swizzled row, then to the
// next box; 8-row groups lie 8 row widths apart
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0,
                                           int ks) {
  using S = Span<D>;
  constexpr int kSteps = S::kRowBytes / 32;  // reduction steps per box
  const uint32_t at = tile + (ks / kSteps) * rows * S::kRowBytes +
                      row0 * S::kRowBytes + (ks % kSteps) * 32;
  return desc(at, 16, 8 * S::kRowBytes, S::kCode);
}

// MN-major operand: the tile's rows 16 kk .. 16 kk + 15 are the reduction,
// its D columns the product's N; the next box of columns lies a box
// (rows row widths) further, the next 8 rows 8 row widths further
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using S = Span<D>;
  return desc(tile + kk * 16 * S::kRowBytes, rows * S::kRowBytes,
              8 * S::kRowBytes, S::kCode);
}

// accumulators (f32) and A fragments (four packed pairs per reduction step)
// stay in their registers across an asynchronous product: their reads and
// writes are ordered after the wait that precedes the call
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Wgmma<T, N>: the m64nNk16 product of 16-bit T with f32 accumulators, N/2
// of them a thread.  ss: A and B K-major in shared memory, d = A B (acc 0)
// or d += A B.  rs: A's fragment in registers, B MN-major in shared memory,
// d += A B (ss for N = 64 and 128, the score products; rs for every head
// size).  An accumulator's register e of n-tile j (8 columns) holds row
// 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2, and
// the A fragment of a 16-wide reduction step is that of two n-tiles of an
// accumulator, rounded and packed in pairs.
template <typename T, int N>
struct Wgmma;

#define FLASH_WGMMA_SS_64(TY)                                                \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,      \
                                            uint64_t b, int acc) {           \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
        "%28, %29, %30, %31}"                                                \
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31])                                           \
        : "l"(a), "l"(b), "r"(acc));                                         \
  }

#define FLASH_WGMMA_SS_128(TY)                                               \
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,      \
                                            uint64_t b, int acc) {           \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "         \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"                  \
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),   \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),   \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),   \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),   \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                 \
        : "l"(a), "l"(b), "r"(acc));                                         \
  }

#define FLASH_WGMMA_RS_16(TY)                                          \
  static __device__ __forceinline__ void rs(float (&d)[8],             \
                                            const uint32_t (&a)[4],    \
                                            uint64_t b) {              \
    asm volatile(                                                      \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                   \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "    \
        "{%0, %1, %2, %3, %4, %5, %6, %7}"                             \
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                  \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),  \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)); \
  }

#define FLASH_WGMMA_RS_32(TY)                                                \
  static __device__ __forceinline__ void rs(float (&d)[16],                  \
                                            const uint32_t (&a)[4],          \
                                            uint64_t b) {                    \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "          \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15}"                                                               \
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15])                                                        \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));       \
  }

#define FLASH_WGMMA_RS_64(TY)                                                \
  static __device__ __forceinline__ void rs(float (&d)[32],                  \
                                            const uint32_t (&a)[4],          \
                                            uint64_t b) {                    \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
        "%28, %29, %30, %31}"                                                \
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31])                                           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));       \
  }

#define FLASH_WGMMA_RS_128(TY)                                               \
  static __device__ __forceinline__ void rs(float (&d)[64],                  \
                                            const uint32_t (&a)[4],          \
                                            uint64_t b) {                    \
    asm volatile(                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "         \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"                  \
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),        \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),   \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),   \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),   \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),   \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),   \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                 \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));       \
  }

// ss for the score products (N = 64 and 128), rs for every head size
#define FLASH_WGMMA_SS_RS(T, TY, N) \
  template <>                       \
  struct Wgmma<T, N> {              \
    FLASH_WGMMA_SS_##N(TY)          \
    FLASH_WGMMA_RS_##N(TY)          \
  };
#define FLASH_WGMMA_RS(T, TY, N) \
  template <>                    \
  struct Wgmma<T, N> {           \
    FLASH_WGMMA_RS_##N(TY)       \
  };

FLASH_WGMMA_RS(__nv_bfloat16, "bf16", 16)
FLASH_WGMMA_RS(__nv_bfloat16, "bf16", 32)
FLASH_WGMMA_SS_RS(__nv_bfloat16, "bf16", 64)
FLASH_WGMMA_SS_RS(__nv_bfloat16, "bf16", 128)
FLASH_WGMMA_RS(__half, "f16", 16)
FLASH_WGMMA_RS(__half, "f16", 32)
FLASH_WGMMA_SS_RS(__half, "f16", 64)
FLASH_WGMMA_SS_RS(__half, "f16", 128)

// two f32 values rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver function: reached through the
// runtime's entry-point query, so the libraries need no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The map of a contiguous (bh, t, d) tensor of a 16-bit type (kind 1 bf16,
// 2 fp16) at a 16-byte aligned address, read in boxes of `rows` rows and
// min(d, 64) columns with the swizzle of that width; rows past t read as
// zeros.  Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* map, const void* base, int kind, int d,
                    int t, int bh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int cols = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map, kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
