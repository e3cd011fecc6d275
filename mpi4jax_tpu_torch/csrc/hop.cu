// hop: k payloads over n ranks, each rank's block copied to its own
// destination rank, in one launch (sm_90a).
//
// Replaces the TPU kernel mpi4jax_tpu/ops/pallas_collectives.py:
// _make_hop_kernel (launched by _hop_impl there): payload i of rank r goes
// to rank dst[r][i], every remote DMA in flight before any wait.  On the
// TPU it composes ring_shift, ring_shift2 (the halo), the butterfly
// allreduce and the hop all-gather / reduce-scatter; the port composes the
// same functions from this kernel (mpi4jax_tpu_torch/ops/_collectives.py).
//
// Layout.  All ranks live on one card: payload i is one contiguous tensor
// of n blocks of block[i] bytes, block r rank r's.  The wrapper makes a
// launch plan once per hop table and device (_collectives.py, `_hop_plan`):
// for every payload i and destination rank d, the source rank whose block
// lands in block d, or -1 where no rank sends there; a k x n int32 table in
// device memory.  A launch takes the plan's address and, by value, each
// payload's input and output base and block length (kMaxPayloads slots, 400
// bytes of parameters), so a hop of any number of ranks is one launch and
// the host builds no per-pair table.
//
// Bound: device memory, and at the halo's sizes launch latency.  The least
// work is one read of every payload byte that is sent and one write of
// every output byte; a 2x2 halo strip of the 1800x3600 solver moves about
// 0.5 MB per launch, 0.15 us at 3.35 TB/s, far below the few microseconds
// that a launch costs.
//
// Design.  A job is one output block: blockIdx.y strides over the k n jobs,
// blockIdx.x over the block's bytes.  A job with a source copies 16 bytes
// at a time when source and target are 16-byte aligned, else 4 bytes when
// both are 4-byte aligned, and the tail (and anything misaligned) a byte at
// a time.  A job without a source writes zeros in the same widths, so the
// output needs no memset beforehand.  Every output block is one job's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPayloads = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;   // blocks of all jobs together
constexpr int kMaxJobRows = 65535;  // gridDim.y

struct HopArgs {
  const unsigned char* src[kMaxPayloads];
  unsigned char* dst[kMaxPayloads];
  long long block[kMaxPayloads];
  const int* plan;  // k x n: the source rank of each output block, or -1
  int n;
  int jobs;  // k n
};

// d[0, nb) = s[0, nb), or zeros where s is null
__device__ __forceinline__ void copy_or_zero(const unsigned char* s,
                                             unsigned char* d, long long nb,
                                             long long tid, long long stride) {
  const uintptr_t align = (uintptr_t)s | (uintptr_t)d;
  long long done = 0;
  if ((align & 15) == 0) {
    const long long nv = nb >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (long long i = tid; i < nv; i += stride)
      d4[i] = s ? s4[i] : make_uint4(0, 0, 0, 0);
    done = nv << 4;
  } else if ((align & 3) == 0) {
    const long long nv = nb >> 2;
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(s);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(d);
    for (long long i = tid; i < nv; i += stride) d1[i] = s ? s1[i] : 0u;
    done = nv << 2;
  }
  for (long long i = done + tid; i < nb; i += stride) d[i] = s ? s[i] : 0;
}

__global__ void __launch_bounds__(kThreads)
    hop_kernel(const __grid_constant__ HopArgs a) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int job = blockIdx.y; job < a.jobs; job += gridDim.y) {
    const int i = job / a.n;
    const long long nb = a.block[i];
    const int s = __ldg(a.plan + job);
    unsigned char* to = a.dst[i] + (long long)(job - i * a.n) * nb;
    copy_or_zero(s >= 0 ? a.src[i] + (long long)s * nb : nullptr, to, nb,
                 tid, stride);
  }
}

}  // namespace

// One launch of the hop of k payloads over n ranks (0 on success).  plan:
// the device table of k x n source ranks (-1: zero the block).  args: a
// host array of 3k values, the k input bases, the k output bases and the k
// block lengths in bytes.
extern "C" int hop_launch(const int* plan, int n, int k, const long long* args,
                          void* stream) {
  if (plan == nullptr || n < 1 || k < 1 || k > kMaxPayloads ||
      (long long)n * k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  HopArgs a = {};
  long long most = 0;
  for (int i = 0; i < k; ++i) {
    const long long nb = args[2 * k + i];
    if (nb < 0) return (int)cudaErrorInvalidValue;
    a.src[i] = reinterpret_cast<const unsigned char*>(args[i]);
    a.dst[i] = reinterpret_cast<unsigned char*>(args[k + i]);
    a.block[i] = nb;
    if (nb > most) most = nb;
  }
  a.plan = plan;
  a.n = n;
  a.jobs = n * k;
  const int gy = a.jobs < kMaxJobRows ? a.jobs : kMaxJobRows;
  long long bx = (most + 16LL * kThreads - 1) / (16LL * kThreads);
  const long long cap = kMaxBlocks / gy > 0 ? kMaxBlocks / gy : 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  hop_kernel<<<dim3((unsigned)bx, (unsigned)gy), kThreads, 0,
               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
