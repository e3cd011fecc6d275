// alltoall: every (mesh rank, row) pair's row copied to its destination, in
// one launch (sm_90a).
//
// Replaces the TPU kernel mpi4jax_tpu/ops/pallas_collectives.py:
// _make_alltoall_kernel (glue _alltoall_impl there): local row i of each
// rank lands in rank i's row `me`, n remote copies in flight per rank, the
// own row a loopback copy.  It carries the mesh alltoall, scatter and the
// spectral solver's two slab transposes per solve
// (mpi4jax_tpu_torch/ops/_collectives.py, models/spectral.py).
//
// Layout.  All ranks live on one card.  The input is (nranks * n) rows of
// row_bytes each: row (f, i) is mesh rank f's local row i.  Output row p =
// (f, j) is mesh rank f's row j, which holds the input row src_rows[p] =
// (peer(f, j), comm rank of f).  The wrapper computes that table once per
// communicator (single axis or a sub-communicator of a grid alike) and keeps
// it in device memory, so a launch passes one pointer for any number of
// pairs: a 64-rank mesh with n = 64 is 4096 pairs.
//
// Bound: device memory.  The least work is one read and one write of every
// byte; the spectral transpose at 256^3 complex64 moves 2 x 128 MiB per
// launch, 80.1 us at 3.35 TB/s.
//
// Design.  A byte-exact strided copy, so any element type (complex64, bf16,
// bool, int8) needs no special case.  blockIdx.y walks the pairs (striding
// past 65535), blockIdx.x picks an 8 KiB chunk of the row.  A thread copies
// 16 bytes at a time, two loads in flight before their stores, when source
// and target are 16-byte aligned; else 4 bytes when both are 4-byte aligned;
// the tail and anything misaligned a byte at a time.  Every output byte is
// written, so the wrapper allocates the output uninitialised.  Small chunks
// make many short blocks, so that the launch's last wave of blocks is a
// small share of it: of the designs timed (benchmarks/kernel_variants.py:
// chunks of 4 to 64 KiB, 128-thread blocks, evict-first cache hints, bulk
// asynchronous copies through shared memory), the fastest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8 * 1024;  // bytes of a row per block
constexpr int kUnroll = 2;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ void copy_chunk(const unsigned char* __restrict__ s,
                                           unsigned char* __restrict__ d,
                                           long long n) {
  const uintptr_t align = (uintptr_t)s | (uintptr_t)d;
  long long done = 0;
  if ((align & 15) == 0) {
    const long long nv = n >> 4;
    const uint4* __restrict__ s4 = reinterpret_cast<const uint4*>(s);
    uint4* __restrict__ d4 = reinterpret_cast<uint4*>(d);
    long long i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < nv; i += kUnroll * kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = s4[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d4[i + u * kThreads] = v[u];
    }
    for (; i < nv; i += kThreads) d4[i] = s4[i];
    done = nv << 4;
  } else if ((align & 3) == 0) {
    const long long nv = n >> 2;
    const uint32_t* __restrict__ s1 = reinterpret_cast<const uint32_t*>(s);
    uint32_t* __restrict__ d1 = reinterpret_cast<uint32_t*>(d);
    for (long long i = threadIdx.x; i < nv; i += kThreads) d1[i] = s1[i];
    done = nv << 2;
  }
  for (long long i = done + threadIdx.x; i < n; i += kThreads) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
    alltoall_kernel(const unsigned char* __restrict__ x,
                    unsigned char* __restrict__ out,
                    const int* __restrict__ src_rows, long long row_bytes,
                    int npairs) {
  const long long lo = (long long)blockIdx.x * kChunk;
  const long long left = row_bytes - lo;
  const long long n = left < kChunk ? left : kChunk;
  for (int p = blockIdx.y; p < npairs; p += gridDim.y) {
    copy_chunk(x + (long long)src_rows[p] * row_bytes + lo,
               out + (long long)p * row_bytes + lo, n);
  }
}

}  // namespace

// One launch: out row p (of npairs, row_bytes each) = x row src_rows[p].
// src_rows is a device array of npairs ints.  0 on success.
extern "C" int alltoall_launch(const void* x, void* out, const int* src_rows,
                               long long row_bytes, int npairs,
                               void* stream) {
  if (npairs < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  const long long bx = (row_bytes + kChunk - 1) / kChunk;
  if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int by = npairs < kMaxGridY ? npairs : kMaxGridY;
  const dim3 grid((unsigned)bx, (unsigned)by);
  alltoall_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      src_rows, row_bytes, npairs);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
