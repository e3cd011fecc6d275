// fused_ring: the whole ring allreduce (SUM) of n ranks in one launch (sm_90a).
//
// Replaces the TPU kernel mpi4jax_tpu/ops/pallas_collectives.py:
// _make_fused_ring_kernel (launched by _fused_ring_allreduce_impl there):
// n-1 reduce-scatter steps, in which each rank folds the chunk arriving from
// its left neighbour into its own copy (local + incoming, in ring arrival
// order), then n-1 all-gather steps that copy the finished chunks.  The
// chunks are the native ones (`_chunk_lo`: per = ceil(count / n)), so an
// f32 result is bit for bit topo/_simulate.py:simulate_ring_sum of the n
// rows.  The TPU's 128-lane padding of each chunk has no counterpart here:
// the kernel works on the flat per-rank payload.
//
// Layout.  x and out are (n, count) and contiguous: row r is rank r's
// payload, every rank on this card.  out doubles as the work buffer.
//
// Bound: device memory.  The least work reads the n rows once and writes
// them once, 2 n count elements.  This design moves (7n - 7) count: step 0
// reads and writes every row plus one chunk of the left row, each later
// step reads two chunks and writes one per rank, and the gather reads and
// writes n-1 chunks per rank.
//
// Design.  One cooperative launch: n rank groups (blockIdx.y) of G blocks
// each (blockIdx.x), all co-resident, which the C function checks against
// the card's occupancy before it launches.
// - Step 0 writes out[r] = x[r], with chunk (r-1) % n folded with the left
//   neighbour's x, reading only the input.
// - Step s = 1 .. n-2 folds chunk (r-1-s) % n of out[left] into out[r].
//   Within a step no chunk is both read and written, so one grid-wide
//   barrier between steps is enough.  After step n-2 rank r holds the
//   finished chunk (r+1) % n.
// - The gather copies chunk c from out[(c-1) % n] into every other row;
//   it writes only unfinished chunks and reads only finished ones.
// The barrier is written by hand (a counter and a generation word, release
// and acquire by fences), which is valid because the launch guarantees
// co-residency; a block that waits longer than kSpinLimit clock cycles
// traps, so a fault shows as a failed launch and not as a hang.  Data that
// other blocks wrote during the launch is read through L2 (__ldcg): L1 is
// not coherent across SMs.
//
// Arithmetic.  f32 folds with __fadd_rn and f64 with __dadd_rn (no fast
// math: the association is the contract); f16 and bf16 fold in f32 and
// round to the type; integers add modulo 2^bits, with signed types passed
// as the unsigned type of their width.  Complex travels as its float pair.
// Per-ring release/acquire flags in place of grid barriers (the TPU
// kernel's credit scheme) are left for later.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr long long kSpinLimit = 4000000000LL;  // about 2 s at 1.98 GHz

__device__ unsigned int g_bar_count = 0;
__device__ unsigned int g_bar_gen = 0;

__device__ __forceinline__ void grid_barrier(unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &g_bar_gen;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(&g_bar_count, 1u) == nblocks - 1) {
      atomicExch(&g_bar_count, 0u);
      __threadfence();
      atomicAdd(&g_bar_gen, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == seen) {
        if (clock64() - t0 > kSpinLimit) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float fold(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double fold(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ __half fold(__half a, __half b) {
  return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
}
__device__ __forceinline__ __nv_bfloat16 fold(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ unsigned char fold(unsigned char a,
                                              unsigned char b) {
  return (unsigned char)(a + b);
}
__device__ __forceinline__ unsigned short fold(unsigned short a,
                                               unsigned short b) {
  return (unsigned short)(a + b);
}
__device__ __forceinline__ unsigned int fold(unsigned int a, unsigned int b) {
  return a + b;
}
__device__ __forceinline__ unsigned long long fold(unsigned long long a,
                                                   unsigned long long b) {
  return a + b;
}

__device__ __forceinline__ long long chunk_lo(long long count, long long per,
                                              int c) {
  const long long lo = per * c;
  return lo < count ? lo : count;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_ring_kernel(const T* __restrict__ x, T* out, long long count,
                      int n) {
  const int r = blockIdx.y;
  const int left = (r + n - 1) % n;
  const long long per = (count + n - 1) / n;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned int nblocks = gridDim.x * gridDim.y;
  T* mine = out + (long long)r * count;
  const T* lrow = out + (long long)left * count;
  const T* xmine = x + (long long)r * count;
  const T* xleft = x + (long long)left * count;

  // step 0: copy the row, folding chunk (r-1) % n from the inputs
  {
    const int c = left;
    const long long lo = chunk_lo(count, per, c);
    const long long hi = chunk_lo(count, per, c + 1);
    for (long long i = tid; i < count; i += stride)
      mine[i] = (i >= lo && i < hi) ? fold(xmine[i], xleft[i]) : xmine[i];
  }
  grid_barrier(nblocks);

  // steps 1 .. n-2: fold chunk (r-1-s) % n of the left neighbour's row
  for (int s = 1; s < n - 1; ++s) {
    const int c = ((r - 1 - s) % n + n) % n;
    const long long lo = chunk_lo(count, per, c);
    const long long hi = chunk_lo(count, per, c + 1);
    for (long long i = lo + tid; i < hi; i += stride)
      mine[i] = fold(__ldcg(mine + i), __ldcg(lrow + i));
    grid_barrier(nblocks);
  }

  // gather: chunk c is finished in row (c-1) % n
  const int own = (r + 1) % n;
  for (int c = 0; c < n; ++c) {
    if (c == own) continue;
    const T* src = out + (long long)((c + n - 1) % n) * count;
    const long long lo = chunk_lo(count, per, c);
    const long long hi = chunk_lo(count, per, c + 1);
    for (long long i = lo + tid; i < hi; i += stride) mine[i] = __ldcg(src + i);
  }
}

template <typename T>
int launch(const void* x, void* out, long long count, int n,
           cudaStream_t stream) {
  // blocks that stay co-resident on each device, queried once per device
  // and element type (0: not queried yet)
  static long long resident_on[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident_on[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_ring_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident_on[dev] = (long long)per_sm * sms;
  }
  const long long resident = resident_on[dev];
  if (n > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  // G blocks per rank: enough for about 4 elements a thread, at most what
  // stays co-resident
  long long g = (count + 4LL * kThreads - 1) / (4LL * kThreads);
  if (g > resident / n) g = resident / n;
  if (g < 1) g = 1;
  const dim3 grid((unsigned)g, (unsigned)n);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  void* args[] = {(void*)&xp, (void*)&op, (void*)&count, (void*)&n};
  err = cudaLaunchCooperativeKernel((const void*)fused_ring_kernel<T>, grid,
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The ring allreduce (SUM) of the n rows of x (n, count) into every row of
// out (n, count) (0 on success).  kind: 0 f32, 1 f64, 2 f16, 3 bf16, and
// 4..7 integers of 1, 2, 4 and 8 bytes.  x and out must not overlap.
extern "C" int fused_ring_launch(const void* x, void* out, long long count,
                                 int n, int kind, void* stream) {
  if (n < 2 || count < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch<float>(x, out, count, n, s);
    case 1: return launch<double>(x, out, count, n, s);
    case 2: return launch<__half>(x, out, count, n, s);
    case 3: return launch<__nv_bfloat16>(x, out, count, n, s);
    case 4: return launch<unsigned char>(x, out, count, n, s);
    case 5: return launch<unsigned short>(x, out, count, n, s);
    case 6: return launch<unsigned int>(x, out, count, n, s);
    case 7: return launch<unsigned long long>(x, out, count, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
