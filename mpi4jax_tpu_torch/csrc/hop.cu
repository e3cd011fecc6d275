// hop: k payloads over n ranks, each copied to its own destination rank, in
// one launch (sm_90a).
//
// Replaces the TPU kernel mpi4jax_tpu/ops/pallas_collectives.py:
// _make_hop_kernel (launched by _hop_impl there): payload i of rank r goes
// to rank dst[r][i], every remote DMA in flight before any wait.  On the
// TPU it composes ring_shift, ring_shift2 (the halo), the butterfly
// allreduce and the hop all-gather / reduce-scatter; the port composes the
// same functions from this kernel (mpi4jax_tpu_torch/ops/_collectives.py).
//
// Layout.  All ranks live on one card: rank r's block of payload i is a
// contiguous byte range, and the wrapper hands over one (source, target,
// length) triple per (rank, payload) pair, with the target already offset
// to the destination rank's block.  The triples travel by value in the
// kernel's parameter struct (at most 64 pairs, 1.5 KB of the 4 KB that a
// launch's parameters may hold), so a launch needs no host-to-device copy;
// the wrapper splits a hop of more pairs into several launches.
// A table of pointers, not a base and a stride, is what lets a later
// version address blocks that live on other cards.
//
// Bound: device memory, and at the halo's sizes launch latency.  The least
// work is one read and one write of every payload byte; a 2x2 halo strip of
// the 1800x3600 solver moves about 0.5 MB per launch, 0.15 us at 3.35 TB/s,
// far below the few microseconds that a launch costs.
//
// Design.  blockIdx.y picks the pair, blockIdx.x strides over its bytes.
// A thread copies 16 bytes at a time when source and target are 16-byte
// aligned, else 4 bytes when both are 4-byte aligned, and the tail (and
// anything misaligned) a byte at a time.  Targets that no rank writes are
// zeroed by the wrapper beforehand.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;  // blocks of all pairs together

struct HopTable {
  const unsigned char* src[kMaxPairs];
  unsigned char* dst[kMaxPairs];
  long long bytes[kMaxPairs];
};

__global__ void __launch_bounds__(kThreads) hop_kernel(const HopTable t) {
  const int p = blockIdx.y;
  const unsigned char* s = t.src[p];
  unsigned char* d = t.dst[p];
  const long long n = t.bytes[p];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uintptr_t align = (uintptr_t)s | (uintptr_t)d;
  long long done = 0;
  if ((align & 15) == 0) {
    const long long nv = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (long long i = tid; i < nv; i += stride) d4[i] = s4[i];
    done = nv << 4;
  } else if ((align & 3) == 0) {
    const long long nv = n >> 2;
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(s);
    uint32_t* d1 = reinterpret_cast<uint32_t*>(d);
    for (long long i = tid; i < nv; i += stride) d1[i] = s1[i];
    done = nv << 2;
  }
  for (long long i = done + tid; i < n; i += stride) d[i] = s[i];
}

}  // namespace

// One launch copying bytes[p] bytes from src[p] to dst[p] for each of the
// npairs pairs (0 on success).  The three arrays are host arrays.
extern "C" int hop_launch(const unsigned long long* src,
                          const unsigned long long* dst,
                          const long long* bytes, int npairs, void* stream) {
  if (npairs < 1 || npairs > kMaxPairs) return (int)cudaErrorInvalidValue;
  HopTable t;
  long long most = 0;
  for (int p = 0; p < npairs; ++p) {
    if (bytes[p] < 0) return (int)cudaErrorInvalidValue;
    t.src[p] = reinterpret_cast<const unsigned char*>(src[p]);
    t.dst[p] = reinterpret_cast<unsigned char*>(dst[p]);
    t.bytes[p] = bytes[p];
    if (bytes[p] > most) most = bytes[p];
  }
  for (int p = npairs; p < kMaxPairs; ++p) {
    t.src[p] = nullptr;
    t.dst[p] = nullptr;
    t.bytes[p] = 0;
  }
  long long bx = (most + 16LL * kThreads - 1) / (16LL * kThreads);
  const long long cap = kMaxBlocks / npairs > 0 ? kMaxBlocks / npairs : 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  const dim3 grid((unsigned)bx, (unsigned)npairs);
  hop_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
