// fused_ring: the whole ring allreduce (SUM) of n ranks in one pass (sm_90a).
//
// Replaces the TPU kernel mpi4jax_tpu/ops/pallas_collectives.py:
// _make_fused_ring_kernel (launched by _fused_ring_allreduce_impl there):
// n-1 reduce-scatter steps, in which each rank folds the chunk arriving from
// its left neighbour into its own copy (local + incoming, in ring arrival
// order), then n-1 all-gather steps that copy the finished chunks.  The
// chunks are the native ones (`_chunk_lo`: per = ceil(count / n)).  The
// TPU's 128-lane padding of each chunk has no counterpart here: the kernel
// works on the flat per-rank payload.
//
// What the schedule computes is a closed form.  Chunk c starts at rank c
// and moves one rank right per step, each rank adding its own copy in
// front of the incoming partial, so after the reduce-scatter
//     acc = x[c];  for j = 1 .. n-1:  acc = fold(x[(c + j) % n], acc)
// and the gather copies acc into every row.  An f32 result is so bit for
// bit topo/_simulate.py:simulate_ring_sum of the n rows, and every output
// row is identical.
//
// Layout.  x and out are (n, count) and contiguous: row r is rank r's
// payload, every rank on this card.
//
// Bound: device memory.  The least work reads the n rows once and writes
// them once, 2 n count elements, and that is what this design moves: no
// element is read or written twice.
//
// Design.  One ordinary launch; no steps, no grid barrier, no state
// outside the launch's arguments, so launches on several streams do not
// meet.  Each thread takes items in a grid-stride loop.  An item is a
// 16-byte vector at one offset of every row when x, out and the row length
// are 16-byte aligned, else one element.  The thread works out the item's
// chunk, starts the n row loads in batches of kBatch (a batch is in flight
// together), folds them in the order above and stores the sum to all n
// rows.  A vector whose elements fall in two chunks folds element by
// element, since its elements fold the rows in different orders; a row
// length that is no multiple of 16 bytes misaligns the rows, so the launch
// takes the element items throughout.
//
// Arithmetic.  f32 folds with __fadd_rn and f64 with __dadd_rn (no fast
// math: the association is the contract); f16 and bf16 fold in f32 and
// round to the type after every fold, as the step-by-step schedule stores
// the type between steps; integers add modulo 2^bits, with signed types
// passed as the unsigned type of their width.  Complex travels as its float
// pair.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;               // row loads in flight per thread
constexpr long long kMaxBlocks = 1 << 20;  // more items: grid-stride

// Each element type by its storage type S and its fold(local, incoming).
struct F32 {
  using S = float;
  static __device__ __forceinline__ S fold(S a, S b) { return __fadd_rn(a, b); }
};
struct F64 {
  using S = double;
  static __device__ __forceinline__ S fold(S a, S b) { return __dadd_rn(a, b); }
};
struct F16 {
  using S = unsigned short;
  static __device__ __forceinline__ S fold(S a, S b) {
    return __half_as_ushort(__float2half_rn(__fadd_rn(
        __half2float(__ushort_as_half(a)), __half2float(__ushort_as_half(b)))));
  }
};
struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ S fold(S a, S b) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(
        __fadd_rn(__bfloat162float(__ushort_as_bfloat16(a)),
                  __bfloat162float(__ushort_as_bfloat16(b)))));
  }
};
template <typename U>
struct Int {
  using S = U;
  static __device__ __forceinline__ S fold(S a, S b) { return (S)(a + b); }
};

template <class F>
union Vec {
  uint4 u;
  typename F::S e[16 / sizeof(typename F::S)];
};

__device__ __forceinline__ int chunk_of(long long i, long long per,
                                        bool narrow) {
  return narrow ? (int)((unsigned)i / (unsigned)per) : (int)(i / per);
}

// The sum of element i of the n rows (row stride count), folded from row c.
template <class F>
__device__ __forceinline__ typename F::S fold_element(
    const typename F::S* __restrict__ x, long long count, int n, int c,
    long long i) {
  using S = typename F::S;
  S acc = S();
  int row = c;
  for (int j0 = 0; j0 < n; j0 += kBatch) {
    S v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < n) {
        v[b] = x[(long long)row * count + i];
        row = row + 1 == n ? 0 : row + 1;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < n) acc = j0 + b == 0 ? v[b] : F::fold(v[b], acc);
    }
  }
  return acc;
}

template <class F, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_ring_kernel(const typename F::S* __restrict__ x,
                      typename F::S* __restrict__ out, long long count, int n,
                      long long per, long long items, bool narrow) {
  using S = typename F::S;
  constexpr int V = 16 / sizeof(S);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < items; t += stride) {
    if constexpr (!kVec) {
      const S acc = fold_element<F>(x, count, n, chunk_of(t, per, narrow), t);
      for (int r = 0; r < n; ++r) out[(long long)r * count + t] = acc;
      continue;
    }
    const long long i0 = t * V;
    const long long rowv = count / V;  // a row's length in vectors
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    const int c = chunk_of(i0, per, narrow);
    Vec<F> acc;
    if (c == chunk_of(i0 + V - 1, per, narrow)) {
      int row = c;
      for (int j0 = 0; j0 < n; j0 += kBatch) {
        Vec<F> v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (j0 + b < n) {
            v[b].u = xv[(long long)row * rowv + t];
            row = row + 1 == n ? 0 : row + 1;
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (j0 + b == 0) {
            acc = v[b];
          } else if (j0 + b < n) {
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc.e[e] = F::fold(v[b].e[e], acc.e[e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc.e[e] = fold_element<F>(x, count, n,
                                   chunk_of(i0 + e, per, narrow), i0 + e);
    }
    for (int r = 0; r < n; ++r) ov[(long long)r * rowv + t] = acc.u;
  }
}

template <class F>
int launch(const void* x, void* out, long long count, int n,
           cudaStream_t stream) {
  using S = typename F::S;
  constexpr int V = 16 / sizeof(S);
  const S* xp = static_cast<const S*>(x);
  S* op = static_cast<S*>(out);
  const long long per = (count + n - 1) / n;
  const bool narrow = count <= 0xffffffffLL;
  const bool vec =
      (((uintptr_t)x | (uintptr_t)out) & 15) == 0 && count % V == 0;
  const long long items = vec ? count / V : count;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec)
    fused_ring_kernel<F, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, op, count, n, per, items, narrow);
  else
    fused_ring_kernel<F, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, op, count, n, per, items, narrow);
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
    case 0: return launch<F32>(x, out, count, n, s);
    case 1: return launch<F64>(x, out, count, n, s);
    case 2: return launch<F16>(x, out, count, n, s);
    case 3: return launch<BF16>(x, out, count, n, s);
    case 4: return launch<Int<unsigned char>>(x, out, count, n, s);
    case 5: return launch<Int<unsigned short>>(x, out, count, n, s);
    case 6: return launch<Int<unsigned int>>(x, out, count, n, s);
    case 7: return launch<Int<unsigned long long>>(x, out, count, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
