// flash_bwd: one ring step of flash attention's backward, every batch row of
// every rank in one launch each: dq (kernel 6) and dk, dv (kernel 7), sm_90a.
//
// Replaces the TPU kernels mpi4jax_tpu/ops/flash.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (launched by _flash_bwd_block there).  From the saved
// logsumexp lse and delta = rowsum(dO * out) of each query row, both
// recompute the probabilities of one q/k block pair and never store them:
//
//   s  = q k^T (times scale when scale != 1), summed in f32
//   p  = exp(s - lse) in f32 (expf, no fast math), 0 exactly where masked
//   dp = dO v^T, summed in f32
//   ds = p (dp - delta), times scale when scale != 1
//   dq += ds k      ds rounded to the input type   (kernel 6)
//   dv += p^T dO    p rounded to the input type    (kernel 7)
//   dk += ds^T q    ds rounded to the input type   (kernel 7)
//
// Causal masking is at global positions, key column c seen by query row r
// when c <= r; a key past Tk and a query past Tq are masked too.  These are
// the rounding points of the plain version, flash_bwd_block_plain.  As on
// the TPU the two kernels stay separate: dq needs a sum over keys, dk and dv
// a sum over queries, and each is one block's loop, so no atomics and the
// results are deterministic.
//
// Bound: tensor-core operations.  B4 T4096 H16 D128 bf16 causal: kernel 6
// does three products of 2 * B * H * T^2 * D * 0.5 = 1.374e11 flop (S, dP,
// dQ), 0.417 ms at 989 TFLOP/s; kernel 7 four (S, dP, dV, dK), 0.556 ms.
// The bytes (q, k, v, dO read, f32 outputs written) take about 0.16 ms.
//
// Design.  The frame of kernel 5 (csrc/flash_fwd.cu): 128 threads, 4 warps
// of 16 rows; an int32 (q_off, k_off) pair per batch row; tiles streamed
// through two cp.async stages of dynamic shared memory with rows padded by
// 8 elements; ldmatrix fragments and mma.sync m16n8k16 with f32
// accumulators; the accumulator of one product is, register for register,
// the A fragment of the next.
// - Kernel 6: a block takes 64 query rows of one batch row and keeps Q and
//   dO in shared memory; 64-key tiles of K and V stream through.  Per tile
//   a warp computes S = Q K^T and dP = dO V^T (K and V as B fragments),
//   turns them into dS in registers and adds dS K (K's fragments through
//   ldmatrix.trans) to its 16 x D dq accumulator.  The loop stops at the
//   last tile whose first key a row of the block sees, and the blocks with
//   the most tiles start first.
// - Kernel 7: a block takes 64 keys of one batch row and keeps K and V in
//   shared memory; 32-query tiles of Q, dO, lse and delta stream through.
//   Per tile a warp computes the transposed scores S^T = K Q^T and
//   dP^T = V dO^T with keys as rows, so that P^T and dS^T sit in
//   accumulator layout and become A fragments; dO and Q enter dV += P^T dO
//   and dK += dS^T Q as B fragments through ldmatrix.trans.  Two f32
//   accumulators of 16 x D a warp (dk, dv) are what press on registers at
//   D = 128, hence tiles of 32 queries.  The loop starts at the first tile
//   that sees a key of the block (the counterpart of _causal_q_index), and
//   the blocks of the earliest keys, which see the most queries, start
//   first.
// f32 inputs take two kernels in full f32 FMAs (no TF32): lane j of a warp
// scores key j (kernel 6) or query j (kernel 7) of a 32-wide tile, and each
// lane accumulates its own output columns.  Later work: wgmma, TMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kB = 64;         // rows of a block: queries (6) or keys (7)
constexpr int kT6 = 64;        // keys per tile of kernel 6
constexpr int kT7 = 32;        // queries per tile of kernel 7
constexpr int kBF = 16;        // rows of a block (f32)
constexpr int kTF = 32;        // tile width (f32)
constexpr int kMaxGridY = 65535;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // two f32 values rounded to the input type, the first in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// the A fragment of one 16-wide k step from two accumulator tiles (n tiles
// 2 kk and 2 kk + 1), rounded to the input type
template <typename T>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

// Number of k tiles of width bk that a block of bq query rows starting at
// local row q0 must visit: all of them, or causally up to the last one whose
// first key some row of the block sees.
__device__ __forceinline__ int tiles_to_visit(int tk, int bk, int bq,
                                              long long q_off, int q0,
                                              long long k_off, int causal) {
  int nk = (tk + bk - 1) / bk;
  if (causal) {
    const long long last = q_off + q0 + bq - 1 - k_off;  // last visible key
    if (last < 0) return 0;
    const long long lim = last / bk + 1;
    if (lim < nk) nk = (int)lim;
  }
  return nk;
}

// The first q tile of width bq that sees a key of a block whose first key
// is local key k0 (causal), or 0; nq when none does.
__device__ __forceinline__ int first_q_tile(int tq, int bq, long long q_off,
                                            int k0, long long k_off,
                                            int causal) {
  const int nq = (tq + bq - 1) / bq;
  if (!causal) return 0;
  const long long first = k_off + k0 - q_off;  // first query that sees k0
  if (first <= 0) return 0;
  if (first >= tq) return nq;
  return (int)(first / bq);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without a register round trip; zeros when
// !valid (src points at a valid row all the same)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 b16 matrices from shared memory, lane l naming row l % 8 of
// matrix l / 8; .trans hands each thread a column pair instead of a row pair
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// rows [r0, r0 + rows) of a (n, D) tensor into a shared tile of row stride
// D + 8, by 16-byte cp.async chunks; rows past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int rows, int n, int tid) {
  constexpr int CH = D / 8;
  for (int c = tid; c < rows * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * (D + 8) + cc,
               src + (long long)(in ? r0 + r : 0) * D + cc, in);
  }
}

// Lane roles of the ldmatrix groups: A fragments (two row halves, two k
// halves), B fragments from an (n, k) tile (two n tiles, two k halves) and,
// .trans, from a (k, n) tile (two k halves, two n tiles).
struct Lanes {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ explicit Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8), a_col((lane >> 4) * 8),
        b_row((lane >> 4) * 8 + (lane & 7)), b_col(((lane >> 3) & 1) * 8),
        t_row(((lane >> 3) & 1) * 8 + (lane & 7)), t_col((lane >> 4) * 8) {}
};

// Kernel 6, bf16 / fp16 inputs: tensor cores, f32 accumulation.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ offs, float* __restrict__ dq,
                     int bh, int tq, int tk, int causal, float scale) {
  constexpr int SQ = D + 8;    // row stride of every tile (elements)
  constexpr int KD = D / 16;   // k steps of Q K^T and dO V^T
  constexpr int NS = kT6 / 8;  // n tiles of S
  constexpr int ND = D / 8;    // n tiles of dQ
  constexpr int TILE = kT6 * SQ;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ds = Qs + kB * SQ;  // dO
  T* Ks = Ds + kB * SQ;  // two stages of K, then two of V
  T* Vs = Ks + 2 * TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Lanes ln(lane);
  // the blocks with the most causal work first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int wr = warp * 16;  // this warp's first row in the block

  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const int q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const long long qrow = (long long)b * tq;
    const T* kb = k + (long long)b * tk * D;
    const T* vb = v + (long long)b * tk * D;
    const int nk = tiles_to_visit(tk, kT6, kB, q_off, q0, k_off, causal);

    auto load_kv = [&](int kt) {
      load_rows<T, D>(Ks + (kt & 1) * TILE, kb, kt * kT6, kT6, tk, tid);
      load_rows<T, D>(Vs + (kt & 1) * TILE, vb, kt * kT6, kT6, tk, tid);
      cp_async_commit();
    };

    __syncthreads();  // the previous batch row's tiles are consumed
    load_rows<T, D>(Qs, q + qrow * D, q0, kB, tq, tid);
    load_rows<T, D>(Ds, dout + qrow * D, q0, kB, tq, tid);
    cp_async_commit();
    if (nk > 0) load_kv(0);

    // rows g and g + 8 of this warp: lse, delta and global position; a row
    // past Tq has zero q and dO and takes lse = delta = 0 (its dS is 0)
    float lse_r[2], dlt_r[2];
    int row_pos[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + wr + g + 8 * hr;
      lse_r[hr] = r < tq ? lse[qrow + r] : 0.f;
      dlt_r[hr] = r < tq ? delta[qrow + r] : 0.f;
      row_pos[hr] = q_off + r;
    }
    float acc[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kT6;
      // tile kt + 1 in flight while tile kt is consumed
      if (kt + 1 < nk) {
        load_kv(kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* kc = Ks + (kt & 1) * TILE;
      const T* vc = Vs + (kt & 1) * TILE;

      // S = Q K^T and dP = dO V^T for this warp's 16 rows, the tile's keys
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        uint32_t qa[4], da[4];
        ldmatrix_x4(qa, Qs + (wr + ln.a_row) * SQ + ks * 16 + ln.a_col);
        ldmatrix_x4(da, Ds + (wr + ln.a_row) * SQ + ks * 16 + ln.a_col);
#pragma unroll
        for (int nt = 0; nt < NS; nt += 2) {
          uint32_t bk[4], bv[4];
          const int at = (nt * 8 + ln.b_row) * SQ + ks * 16 + ln.b_col;
          ldmatrix_x4(bk, kc + at);
          Mma<T>::run(s[nt], qa, bk[0], bk[1]);
          Mma<T>::run(s[nt + 1], qa, bk[2], bk[3]);
          ldmatrix_x4(bv, vc + at);
          Mma<T>::run(dp[nt], da, bv[0], bv[1]);
          Mma<T>::run(dp[nt + 1], da, bv[2], bv[3]);
        }
      }

      // dS = p (dP - delta), p = exp(s - lse) and 0 where masked;
      // accumulator e of tile nt sits at row g + 8 (e >> 1), column
      // nt * 8 + 2 t4 + (e & 1).  A tile every row sees in full needs no
      // mask.
      const bool whole = k0 + kT6 <= tk &&
                         (!causal || k_off + k0 + kT6 - 1 <= q_off + q0);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float x = s[nt][e];
          if (scale != 1.f) x *= scale;
          bool ok = true;
          if (!whole) {
            const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
            ok = col < tk && (!causal || k_off + col <= row_pos[hr]);
          }
          const float p = ok ? expf(x - lse_r[hr]) : 0.f;
          float ds = p * (dp[nt][e] - dlt_r[hr]);
          if (scale != 1.f) ds *= scale;
          s[nt][e] = ds;
        }
      }

      // dQ += dS K, dS rounded to the input type; K's fragments come
      // transposed out of its row-major tile
#pragma unroll
      for (int kk = 0; kk < kT6 / 16; ++kk) {
        uint32_t sa[4];
        to_a<T>(sa, s[2 * kk], s[2 * kk + 1]);
        const T* kr = kc + (kk * 16 + ln.t_row) * SQ + ln.t_col;
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, kr + dn * 8);
          Mma<T>::run(acc[dn], sa, bk[0], bk[1]);
          Mma<T>::run(acc[dn + 1], sa, bk[2], bk[3]);
        }
      }
      __syncthreads();  // this stage is consumed before tile kt + 2 lands
    }
    cp_async_wait<0>();  // Q and dO landed even where no tile ran

    float* out = dq + qrow * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + wr + g + 8 * hr;
      if (r >= tq) continue;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn)
        *reinterpret_cast<float2*>(out + (long long)r * D + dn * 8 + t4 * 2) =
            make_float2(acc[dn][2 * hr], acc[dn][2 * hr + 1]);
    }
  }
}

// Kernel 7, bf16 / fp16 inputs: tensor cores, f32 accumulation.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ offs, float* __restrict__ dk,
                      float* __restrict__ dv, int bh, int tq, int tk,
                      int causal, float scale) {
  constexpr int SQ = D + 8;
  constexpr int KD = D / 16;   // k steps of K Q^T and V dO^T
  constexpr int NS = kT7 / 8;  // n tiles of S^T
  constexpr int ND = D / 8;    // n tiles of dK and dV
  constexpr int TILE = kT7 * SQ;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kB * SQ;
  T* Qs = Vs + kB * SQ;  // two stages of Q, then two of dO
  T* Ds = Qs + 2 * TILE;
  float* Ls = reinterpret_cast<float*>(Ds + 2 * TILE);  // two stages of lse
  float* Es = Ls + 2 * kT7;                             // and of delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Lanes ln(lane);
  // the blocks of the earliest keys see the most queries: first
  const int k0 = blockIdx.x * kB;
  const int wr = warp * 16;
  const int nq = (tq + kT7 - 1) / kT7;

  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const int q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const long long qrow = (long long)b * tq;
    const T* qb = q + qrow * D;
    const T* db = dout + qrow * D;
    const int t0 = first_q_tile(tq, kT7, q_off, k0, k_off, causal);

    // Q, dO, lse and delta of q tile qt into stage (qt - t0) & 1; a query
    // past Tq reads zeros
    auto load_q = [&](int qt) {
      const int st = (qt - t0) & 1, r0 = qt * kT7;
      load_rows<T, D>(Qs + st * TILE, qb, r0, kT7, tq, tid);
      load_rows<T, D>(Ds + st * TILE, db, r0, kT7, tq, tid);
      cp_async_commit();
      for (int i = tid; i < kT7; i += kThreads) {
        const int r = r0 + i;
        Ls[st * kT7 + i] = r < tq ? lse[qrow + r] : 0.f;
        Es[st * kT7 + i] = r < tq ? delta[qrow + r] : 0.f;
      }
    };

    __syncthreads();  // the previous batch row's tiles are consumed
    if (t0 < nq) {
      load_rows<T, D>(Ks, k + (long long)b * tk * D, k0, kB, tk, tid);
      load_rows<T, D>(Vs, v + (long long)b * tk * D, k0, kB, tk, tid);
      cp_async_commit();
      load_q(t0);
    }

    // keys g and g + 8 of this warp: global position, and whether in Tk
    int key_pos[2];
    bool key_in[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = k0 + wr + g + 8 * hr;
      key_pos[hr] = k_off + r;
      key_in[hr] = r < tk;
    }
    float adk[ND][4], adv[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[dn][e] = adv[dn][e] = 0.f;

    for (int qt = t0; qt < nq; ++qt) {
      const int q0t = qt * kT7, st = (qt - t0) & 1;
      if (qt + 1 < nq) {
        load_q(qt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* qc = Qs + st * TILE;
      const T* dc = Ds + st * TILE;
      const float* lc = Ls + st * kT7;
      const float* ec = Es + st * kT7;

      // S^T = K Q^T and dP^T = V dO^T, this warp's 16 keys as rows
      float sT[NS][4], dpT[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[nt][e] = dpT[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Ks + (wr + ln.a_row) * SQ + ks * 16 + ln.a_col);
        ldmatrix_x4(va, Vs + (wr + ln.a_row) * SQ + ks * 16 + ln.a_col);
#pragma unroll
        for (int nt = 0; nt < NS; nt += 2) {
          uint32_t bq[4], bd[4];
          const int at = (nt * 8 + ln.b_row) * SQ + ks * 16 + ln.b_col;
          ldmatrix_x4(bq, qc + at);
          Mma<T>::run(sT[nt], ka, bq[0], bq[1]);
          Mma<T>::run(sT[nt + 1], ka, bq[2], bq[3]);
          ldmatrix_x4(bd, dc + at);
          Mma<T>::run(dpT[nt], va, bd[0], bd[1]);
          Mma<T>::run(dpT[nt + 1], va, bd[2], bd[3]);
        }
      }

      // p^T and dS^T: accumulator e of tile nt sits at key g + 8 (e >> 1),
      // query nt * 8 + 2 t4 + (e & 1) of the tile
      const bool whole = q0t + kT7 <= tq && k0 + kB <= tk &&
                         (!causal || k_off + k0 + kB - 1 <= q_off + q0t);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, qi = nt * 8 + t4 * 2 + (e & 1);
          float x = sT[nt][e];
          if (scale != 1.f) x *= scale;
          bool ok = true;
          if (!whole)
            ok = key_in[hr] && q0t + qi < tq &&
                 (!causal || key_pos[hr] <= q_off + q0t + qi);
          const float p = ok ? expf(x - lc[qi]) : 0.f;
          float ds = p * (dpT[nt][e] - ec[qi]);
          if (scale != 1.f) ds *= scale;
          sT[nt][e] = p;
          dpT[nt][e] = ds;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to the input
      // type; dO's and Q's fragments come transposed out of their tiles
#pragma unroll
      for (int kk = 0; kk < kT7 / 16; ++kk) {
        uint32_t pa[4], sa[4];
        to_a<T>(pa, sT[2 * kk], sT[2 * kk + 1]);
        to_a<T>(sa, dpT[2 * kk], dpT[2 * kk + 1]);
        const int at = (kk * 16 + ln.t_row) * SQ + ln.t_col;
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t bd[4], bq[4];
          ldmatrix_x4_trans(bd, dc + at + dn * 8);
          Mma<T>::run(adv[dn], pa, bd[0], bd[1]);
          Mma<T>::run(adv[dn + 1], pa, bd[2], bd[3]);
          ldmatrix_x4_trans(bq, qc + at + dn * 8);
          Mma<T>::run(adk[dn], sa, bq[0], bq[1]);
          Mma<T>::run(adk[dn + 1], sa, bq[2], bq[3]);
        }
      }
      __syncthreads();  // this stage is consumed before tile qt + 2 lands
    }

    const long long krow = (long long)b * tk;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = k0 + wr + g + 8 * hr;
      if (r >= tk) continue;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const long long at = (krow + r) * D + dn * 8 + t4 * 2;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(adk[dn][2 * hr], adk[dn][2 * hr + 1]);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(adv[dn][2 * hr], adv[dn][2 * hr + 1]);
      }
    }
  }
}

// Kernel 6, f32 inputs: FMAs in f32 throughout.  Lane j scores key j of a
// 32-key tile against each of the warp's 4 rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ offs, float* __restrict__ dq,
                     int bh, int tq, int tk, int causal, float scale) {
  constexpr int SK = D + 1;          // padded: lane j reads row j
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  constexpr int RW = kBF / 4;        // rows per warp
  extern __shared__ float fsm[];
  float* Qs = fsm;               // kBF x D
  float* Ds = Qs + kBF * D;      // dO
  float* Ks = Ds + kBF * D;      // kTF x SK
  float* Vs = Ks + kTF * SK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBF;

  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const long long q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const long long qrow = (long long)b * tq;
    const float* kb = k + (long long)b * tk * D;
    const float* vb = v + (long long)b * tk * D;

    __syncthreads();
    for (int c = tid; c < kBF * D; c += kThreads) {
      const int r = c / D, d = c % D;
      const bool in = q0 + r < tq;
      Qs[c] = in ? q[(qrow + q0 + r) * D + d] : 0.f;
      Ds[c] = in ? dout[(qrow + q0 + r) * D + d] : 0.f;
    }
    float acc[RW][NC], lse_r[RW], dlt_r[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = q0 + warp * RW + i;
      lse_r[i] = r < tq ? lse[qrow + r] : 0.f;
      dlt_r[i] = r < tq ? delta[qrow + r] : 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    const int nk = tiles_to_visit(tk, kTF, kBF, q_off, q0, k_off, causal);
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kTF;
      __syncthreads();
      for (int c = tid; c < kTF * D; c += kThreads) {
        const int r = c / D, d = c % D;
        const bool in = k0 + r < tk;
        Ks[r * SK + d] = in ? kb[(long long)(k0 + r) * D + d] : 0.f;
        Vs[r * SK + d] = in ? vb[(long long)(k0 + r) * D + d] : 0.f;
      }
      __syncthreads();
      const int col = k0 + lane;  // this lane's key
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int rl = warp * RW + i;
        float x = 0.f, dpv = 0.f;
        for (int d = 0; d < D; ++d) {
          x = fmaf(Qs[rl * D + d], Ks[lane * SK + d], x);
          dpv = fmaf(Ds[rl * D + d], Vs[lane * SK + d], dpv);
        }
        if (scale != 1.f) x *= scale;
        const bool ok = col < tk &&
                        (!causal || k_off + col <= q_off + q0 + rl);
        const float p = ok ? expf(x - lse_r[i]) : 0.f;
        float ds = p * (dpv - dlt_r[i]);
        if (scale != 1.f) ds *= scale;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          float a = acc[i][c];
          for (int j = 0; j < kTF; ++j) {
            const float dsj = __shfl_sync(0xffffffffu, ds, j);
            if (d < D) a = fmaf(dsj, Ks[j * SK + d], a);
          }
          acc[i][c] = a;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = q0 + warp * RW + i;
      if (r >= tq) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) dq[(qrow + r) * D + d] = acc[i][c];
      }
    }
  }
}

// Kernel 7, f32 inputs: lane j scores query j of a 32-query tile against
// each of the warp's 4 keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ offs, float* __restrict__ dk,
                      float* __restrict__ dv, int bh, int tq, int tk,
                      int causal, float scale) {
  constexpr int SK = D + 1;
  constexpr int NC = (D + 31) / 32;
  constexpr int RW = kBF / 4;  // keys per warp
  extern __shared__ float fsm[];
  float* Ks = fsm;               // kBF x D
  float* Vs = Ks + kBF * D;
  float* Qs = Vs + kBF * D;      // kTF x SK
  float* Ds = Qs + kTF * SK;     // dO
  float* Ls = Ds + kTF * SK;     // lse of the tile's queries
  float* Es = Ls + kTF;          // delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kBF;
  const int nq = (tq + kTF - 1) / kTF;

  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const long long q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const long long qrow = (long long)b * tq, krow = (long long)b * tk;

    __syncthreads();
    for (int c = tid; c < kBF * D; c += kThreads) {
      const int r = c / D, d = c % D;
      const bool in = k0 + r < tk;
      Ks[c] = in ? k[(krow + k0 + r) * D + d] : 0.f;
      Vs[c] = in ? v[(krow + k0 + r) * D + d] : 0.f;
    }
    float ak[RW][NC], av[RW][NC];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) ak[i][c] = av[i][c] = 0.f;

    const int t0 = first_q_tile(tq, kTF, q_off, k0, k_off, causal);
    for (int qt = t0; qt < nq; ++qt) {
      const int q0t = qt * kTF;
      __syncthreads();
      for (int c = tid; c < kTF * D; c += kThreads) {
        const int r = c / D, d = c % D;
        const bool in = q0t + r < tq;
        Qs[r * SK + d] = in ? q[(qrow + q0t + r) * D + d] : 0.f;
        Ds[r * SK + d] = in ? dout[(qrow + q0t + r) * D + d] : 0.f;
      }
      for (int i = tid; i < kTF; i += kThreads) {
        const bool in = q0t + i < tq;
        Ls[i] = in ? lse[qrow + q0t + i] : 0.f;
        Es[i] = in ? delta[qrow + q0t + i] : 0.f;
      }
      __syncthreads();
      const int qi = q0t + lane;  // this lane's query
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int rl = warp * RW + i, key = k0 + rl;
        float x = 0.f, dpv = 0.f;
        for (int d = 0; d < D; ++d) {
          x = fmaf(Ks[rl * D + d], Qs[lane * SK + d], x);
          dpv = fmaf(Vs[rl * D + d], Ds[lane * SK + d], dpv);
        }
        if (scale != 1.f) x *= scale;
        const bool ok = key < tk && qi < tq &&
                        (!causal || k_off + key <= q_off + qi);
        const float p = ok ? expf(x - Ls[lane]) : 0.f;
        float ds = p * (dpv - Es[lane]);
        if (scale != 1.f) ds *= scale;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          float a = ak[i][c], w = av[i][c];
          for (int j = 0; j < kTF; ++j) {
            const float pj = __shfl_sync(0xffffffffu, p, j);
            const float dsj = __shfl_sync(0xffffffffu, ds, j);
            if (d < D) {
              w = fmaf(pj, Ds[j * SK + d], w);
              a = fmaf(dsj, Qs[j * SK + d], a);
            }
          }
          ak[i][c] = a;
          av[i][c] = w;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = k0 + warp * RW + i;
      if (r >= tk) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          dk[(krow + r) * D + d] = ak[i][c];
          dv[(krow + r) * D + d] = av[i][c];
        }
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* offs;
  float *out1, *out2;  // dq, or dk and dv
  int bh, tq, tk, causal;
  float scale;
  cudaStream_t stream;
};

// dynamic shared memory past 48 KB, and all of the SM's 228 KB to it
template <typename K>
int allow_smem(K kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

dim3 grid_of(int rows, int per_block, int bh) {
  return dim3((rows + per_block - 1) / per_block,
              bh < kMaxGridY ? bh : kMaxGridY);
}

template <typename T, int D>
int launch_dq_mma(const Args& a) {
  const int smem = (2 * kB + 4 * kT6) * (D + 8) * (int)sizeof(T);
  int err = allow_smem(flash_bwd_dq_mma<T, D>, smem);
  if (err) return err;
  flash_bwd_dq_mma<T, D><<<grid_of(a.tq, kB, a.bh), kThreads, smem,
                           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.offs, a.out1, a.bh, a.tq, a.tk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_mma(const Args& a) {
  const int smem = (2 * kB + 4 * kT7) * (D + 8) * (int)sizeof(T) +
                   4 * kT7 * (int)sizeof(float);
  int err = allow_smem(flash_bwd_dkv_mma<T, D>, smem);
  if (err) return err;
  flash_bwd_dkv_mma<T, D><<<grid_of(a.tk, kB, a.bh), kThreads, smem,
                            a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.offs, a.out1, a.out2, a.bh, a.tq, a.tk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_f32(const Args& a) {
  const int smem = (2 * kBF * D + 2 * kTF * (D + 1)) * (int)sizeof(float);
  int err = allow_smem(flash_bwd_dq_f32<D>, smem);
  if (err) return err;
  flash_bwd_dq_f32<D><<<grid_of(a.tq, kBF, a.bh), kThreads, smem,
                        a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.offs, a.out1, a.bh, a.tq, a.tk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const Args& a) {
  const int smem =
      (2 * kBF * D + 2 * kTF * (D + 1) + 2 * kTF) * (int)sizeof(float);
  int err = allow_smem(flash_bwd_dkv_f32<D>, smem);
  if (err) return err;
  flash_bwd_dkv_f32<D><<<grid_of(a.tk, kBF, a.bh), kThreads, smem,
                         a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.offs, a.out1, a.out2, a.bh, a.tq, a.tk, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_kind(const Args& a, int kind, bool dkv) {
  switch (kind) {
    case 0: return dkv ? launch_dkv_f32<D>(a) : launch_dq_f32<D>(a);
    case 1:
      return dkv ? launch_dkv_mma<__nv_bfloat16, D>(a)
                 : launch_dq_mma<__nv_bfloat16, D>(a);
    case 2:
      return dkv ? launch_dkv_mma<__half, D>(a) : launch_dq_mma<__half, D>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch(const Args& a, int d, int kind, bool dkv) {
  if (a.bh < 1 || a.tq < 1 || a.tk < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_kind<16>(a, kind, dkv);
    case 32: return launch_kind<32>(a, kind, dkv);
    case 64: return launch_kind<64>(a, kind, dkv);
    case 128: return launch_kind<128>(a, kind, dkv);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 6, one launch over bh batch rows: q and dout (bh, tq, d), k and v
// (bh, tk, d), all contiguous and 16-byte aligned, of type kind (0 f32, 1
// bf16, 2 fp16); lse and delta (bh, tq) f32; offs (bh, 2) int32; dq
// (bh, tq, d) f32.  Returns 0 or a CUDA error code.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* offs, void* dq, int bh, int tq,
                                   int tk, int d, int kind, int causal,
                                   float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(offs), static_cast<float*>(dq),
               nullptr, bh, tq, tk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(a, d, kind, false);
}

// Kernel 7, one launch: the same inputs; dk and dv (bh, tk, d) f32.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* offs, void* dk, void* dv,
                                    int bh, int tq, int tk, int d, int kind,
                                    int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(offs), static_cast<float*>(dk),
               static_cast<float*>(dv), bh, tq, tk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(a, d, kind, true);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
