// quant_pack: the native int8 wire frame of an f32 vector (sm_90a).
//
// Replaces the TPU kernel mpi4jax_tpu/ops/pallas_collectives.py:
// _quant_pack_kernel (launched by quant_pack_pallas there), which is bit
// for bit mpi4jax_tpu/ops/quantized.py:quant_pack_wire_ref and the
// transport's own codec (native/tpucomm.cc: quant_pack_f32).  For each
// 256-element block of x (the last one padded with zeros):
//   amax  = max |x|                       (f32)
//   scale = amax > 0 ? amax / 127 : 1     (IEEE division)
//   inv   = 1 / scale                     (IEEE division)
//   code  = rint(clip(x * inv, -127, 127)), half to even, as int8.
// The frame is the ceil(n/256) scales as their bytes, then the n codes, in
// one int8 buffer of 4 ceil(n/256) + n bytes.
//
// Arithmetic.  Every step is IEEE f32 with round-to-nearest: __fdiv_rn for
// both divisions, __fmul_rn for the product (multiplied by the reciprocal,
// never divided by the scale), __float2int_rn for the rounding.  The source
// is built without fast math and without flush-to-zero, so subnormal
// elements of a block whose amax is normal give the reference's codes.
//
// Non-finite inputs (not compared with the reference: numpy's cast of NaN
// to int8 is undefined).  The absmax uses fmaxf, which ignores a NaN; a NaN
// element's code is -127 (fmaxf(NaN, -127) is -127).  An infinity makes
// amax and the scale infinite and inv 0: the infinity's code is then -127
// (inf * 0 is NaN) and every finite element of its block codes to 0.
//
// Bound: device memory.  The frame reads 4n bytes and writes n + 4 ceil(n/256)
// bytes, about 5n in all, and does some ten operations per element.
//
// Design.  One warp per 256-element block, 8 warps per block of 256 threads,
// a grid-stride loop over the blocks.  Lane l holds elements 4l..4l+3 and
// 128+4l..128+4l+3 of its block: two 16-byte loads, neighbouring lanes on
// neighbouring addresses.  The absmax is a shuffle reduction across the
// warp; every lane computes the same scale, lane 0 stores it, and each lane
// stores its codes as two 4-byte words (the codes start at 4 ceil(n/256),
// a multiple of 4).  The last, partial block and an input that is not 16-byte
// aligned take masked scalar loads and byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;       // elements per scale
constexpr int kWarps = 8;         // 256-element blocks per CTA pass
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ signed char code_of(float x, float inv) {
  float v = __fmul_rn(x, inv);
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return (signed char)__float2int_rn(v);
}

__global__ void __launch_bounds__(kThreads)
    quant_pack_kernel(const float* __restrict__ x, long long n,
                      int8_t* __restrict__ out, int vec) {
  const int lane = threadIdx.x & 31;
  const long long nb = (n + kBlock - 1) / kBlock;
  int8_t* codes = out + 4 * nb;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       b < nb; b += stride) {
    const long long base = b * kBlock;
    const bool full = vec && base + kBlock <= n;
    float v[8];
    if (full) {
      const float4* p = reinterpret_cast<const float4*>(x + base);
      const float4 a = __ldg(p + lane);
      const float4 c = __ldg(p + 32 + lane);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long i = base + (k < 4 ? 4 * lane + k : 128 + 4 * lane + k - 4);
        v[k] = i < n ? x[i] : 0.0f;
      }
    }
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
    const float inv = __fdiv_rn(1.0f, scale);
    if (lane == 0) reinterpret_cast<float*>(out)[b] = scale;
    signed char c[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = code_of(v[k], inv);
    if (full) {
      char4* q = reinterpret_cast<char4*>(codes + base);
      q[lane] = make_char4(c[0], c[1], c[2], c[3]);
      q[32 + lane] = make_char4(c[4], c[5], c[6], c[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long i = base + (k < 4 ? 4 * lane + k : 128 + 4 * lane + k - 4);
        if (i < n) codes[i] = c[k];
      }
    }
  }
}

}  // namespace

// The frame of the n f32 elements of x into out (4 ceil(n/256) + n bytes),
// on `stream`; 0 on success, else the CUDA error.  out must be 4-byte
// aligned; x may have any alignment (16-byte aligned takes vector loads).
extern "C" int quant_pack_launch(const void* x, long long n, void* out,
                                 void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long nb = (n + kBlock - 1) / kBlock;
  long long grid = (nb + kWarps - 1) / kWarps;
  const long long cap = 16LL * sms;  // a few waves; the loop takes the rest
  if (grid > cap) grid = cap;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  quant_pack_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), n, static_cast<int8_t*>(out), vec);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
