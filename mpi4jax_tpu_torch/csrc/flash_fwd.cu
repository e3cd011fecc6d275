// flash_fwd: one ring step of flash attention's forward, every batch row of
// every rank in one launch (kernel 5, sm_90a).
//
// Replaces the TPU kernel mpi4jax_tpu/ops/flash.py:_fwd_kernel (launched by
// _flash_fwd_block there): the partial attention of the local q against one
// k/v block, as the unnormalized f32 triple (o, m, l) by online softmax over
// the k tiles.  The TPU's sequential k grid axis becomes a loop inside the
// thread block; its scalar-prefetched offsets become an int32 (q_off, k_off)
// pair per batch row, read by the block, so one launch serves every rank of
// a ring step (mpi4jax_tpu_torch/ops/flash.py).
//
// Semantics, shared with the plain version flash_fwd_block_plain: the
// scores s = q k^T (times scale when scale != 1) summed in f32; causal
// masking at global positions, key column c seen by query row r when
// c <= r; p = exp(s - m) with expf (no fast math), rounded to the input
// type before P V; a row that sees no key of the block gives m = -1e30,
// l = 0, o = 0.  Masked entries (and the ragged edge past Tk) give p = 0
// exactly, so no tile depends on another's masking.
//
// Bound: tensor-core operations.  B4 T4096 H16 D128 bf16 causal does
// 2.749e11 flop per full forward (2 * 2 * B * H * T^2 * D * 0.5), 0.278 ms
// at 989 TFLOP/s; one full 1024 x 1024 block pair of a 4-rank ring step
// (BH 64) is 0.0347 ms.  The bytes (q, k, v read, o, m, l written) are a
// few hundred MB at most: an order below.
//
// Design.  A block takes 64 query rows (4 warps of 16) of one batch row
// and keeps their Q fragments in registers; 64-key tiles of K and V stream
// through two stages of dynamic shared memory, 68 KB at D = 128
// (cudaFuncSetAttribute above 48 KB; Q passes through a K stage on its way
// to the registers), so that three blocks share an SM within 170
// registers a thread: cp.async brings tile kt + 1 while tile kt is
// consumed.  Rows are padded by 8 elements so that ldmatrix
// reads hit 32 banks; ldmatrix hands out the K fragments, and with .trans
// the V fragments from V's row-major tile.  Q K^T and P V run on the tensor
// cores through mma.sync m16n8k16 with f32 accumulators; the S accumulator
// of one tile is, register for register, the A fragment of P V, so P never
// leaves registers.  Causal skipping: the loop over k tiles stops at the
// last tile whose first key a row of the block can see (q_start + 63 >=
// k_start), the counterpart of both pl.when(should_run) and the index-map
// clamp, so masked tiles cost neither loads nor compute; a tile that every
// row sees in full skips the mask, and the blocks with the most tiles start
// first.  f32 inputs take a second kernel in full f32 FMAs (no TF32): lane
// j of a warp scores key j of a 32-key tile, and each lane accumulates its
// own output columns.  Later work: wgmma, TMA and a producer warp.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // query rows per block (half types)
constexpr int kBK = 64;        // keys per tile (half types)
constexpr int kBQF = 16;       // query rows per block (f32)
constexpr int kBKF = 32;       // keys per tile (f32)
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

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Number of k tiles of width bk that a block of bq rows starting at local
// row q0 must visit: all of them, or causally up to the last one whose
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

// bf16 / fp16 inputs: tensor cores, f32 accumulation.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
    flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ offs,
                  float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, int bh, int tq, int tk,
                  int causal, float scale) {
  constexpr int SQ = D + 8;    // row stride of every tile (elements)
  constexpr int KD = D / 16;   // k steps of Q K^T
  constexpr int NS = kBK / 8;  // n tiles of S (one uint32 of mask bits)
  constexpr int ND = D / 8;    // n tiles of O
  constexpr int CH = D / 8;    // 16-byte chunks of a row
  constexpr int TILE = kBK * SQ;
  static_assert(NS * 4 == 32, "one mask bit per S accumulator");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // two stages of K, then two of V
  T* Vs = Ks + 2 * TILE;
  T* Qs = Ks + TILE;  // Q passes through K's second stage into registers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // the blocks with the most causal work first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int wr = warp * 16;  // this warp's first row in the block
  // this lane's row in the ldmatrix groups: K (two key tiles, two column
  // halves) and V (two key halves, two column tiles)
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const int q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const T* qb = q + (long long)b * tq * D;
    const T* kb = k + (long long)b * tk * D;
    const T* vb = v + (long long)b * tk * D;
    const int nk = tiles_to_visit(tk, kBK, kBQ, q_off, q0, k_off, causal);

    auto load_kv = [&](int kt) {
      const int k0 = kt * kBK;
      T* kd = Ks + (kt & 1) * TILE;
      T* vd = Vs + (kt & 1) * TILE;
      for (int c = tid; c < kBK * CH; c += kThreads) {
        const int r = c / CH, cc = (c % CH) * 8;
        const bool in = k0 + r < tk;
        const long long at = (long long)(in ? k0 + r : 0) * D + cc;
        cp_async16(kd + r * SQ + cc, kb + at, in);
        cp_async16(vd + r * SQ + cc, vb + at, in);
      }
      cp_async_commit();
    };

    __syncthreads();  // the previous batch row's tiles are consumed
    for (int c = tid; c < kBQ * CH; c += kThreads) {
      const int r = c / CH, cc = (c % CH) * 8;
      const bool in = q0 + r < tq;
      cp_async16(Qs + r * SQ + cc, qb + (long long)(in ? q0 + r : 0) * D + cc,
                 in);
    }
    cp_async_commit();
    if (nk > 0) {
      load_kv(0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t qa[KD][4];
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      const T* base = Qs + (wr + g) * SQ + ks * 16 + t4 * 2;
      qa[ks][0] = ld32(base);               // row g, columns 2t, 2t+1
      qa[ks][1] = ld32(base + 8 * SQ);      // row g+8
      qa[ks][2] = ld32(base + 8);           // row g, columns 2t+8, 2t+9
      qa[ks][3] = ld32(base + 8 * SQ + 8);  // row g+8
    }
    __syncthreads();  // Q is in registers before tile 1 lands on it

    float acc[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    float m_r[2] = {kNegInf, kNegInf};  // rows g and g+8
    float l_r[2] = {0.f, 0.f};          // this thread's share of the sums
    const int row_pos[2] = {q_off + q0 + wr + g, q_off + q0 + wr + g + 8};

    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kBK;
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

      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      float s[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; nt += 2) {
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kc + (nt * 8 + k_row) * SQ + ks * 16 + k_col);
          Mma<T>::run(s[nt], qa[ks], bk[0], bk[1]);
          Mma<T>::run(s[nt + 1], qa[ks], bk[2], bk[3]);
        }
      }

      // scale, mask, row maxima; accumulator e of tile nt sits at row
      // g + 8 * (e >> 1), column nt * 8 + 2 * t4 + (e & 1).  A tile that
      // every row of the block sees in full needs no mask.
      const bool whole = k0 + kBK <= tk &&
                         (!causal || k_off + k0 + kBK - 1 <= q_off + q0);
      uint32_t seen = 0xffffffffu;
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float x = s[nt][e];
          if (scale != 1.f) x *= scale;
          if (!whole) {
            const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
            const bool ok =
                col < tk && (!causal || k_off + col <= row_pos[hr]);
            x = ok ? x : kNegInf;
            if (!ok) seen &= ~(1u << (nt * 4 + e));
          }
          s[nt][e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        alpha[hr] = expf(m_r[hr] - mx[hr]);
        m_r[hr] = mx[hr];
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const float p = (seen >> (nt * 4 + e)) & 1u
                              ? expf(s[nt][e] - mx[hr]) : 0.f;
          s[nt][e] = p;
          ls[hr] += p;
        }
      }
      l_r[0] = l_r[0] * alpha[0] + ls[0];
      l_r[1] = l_r[1] * alpha[1] + ls[1];
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }

      // O += P V, P rounded to the input type; V's fragments come
      // transposed out of its row-major tile
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const T* vr = vc + (kk * 16 + v_row) * SQ + v_col;
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vr + dn * 8);
          Mma<T>::run(acc[dn], pa, bv[0], bv[1]);
          Mma<T>::run(acc[dn + 1], pa, bv[2], bv[3]);
        }
      }
      __syncthreads();  // this stage is consumed before tile kt + 2 lands
    }

    // the four threads of a row hold parts of its sum
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 1);
      l_r[hr] += __shfl_xor_sync(0xffffffffu, l_r[hr], 2);
    }
    float* ob = o + (long long)b * tq * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = q0 + wr + g + 8 * hr;
      if (r >= tq) continue;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn)
        *reinterpret_cast<float2*>(ob + (long long)r * D + dn * 8 + t4 * 2) =
            make_float2(acc[dn][2 * hr], acc[dn][2 * hr + 1]);
      if (t4 == 0) {
        m_out[(long long)b * tq + r] = m_r[hr];
        l_out[(long long)b * tq + r] = l_r[hr];
      }
    }
  }
}

// f32 inputs: FMAs in f32 throughout.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ offs,
                  float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, int bh, int tq, int tk,
                  int causal, float scale) {
  constexpr int SK = D + 1;            // padded: lane j reads row j
  constexpr int NC = (D + 31) / 32;    // output columns per lane
  constexpr int RW = kBQF / 4;         // rows per warp
  __shared__ float Qs[kBQF][D];
  __shared__ float Ks[kBKF * SK];
  __shared__ float Vs[kBKF][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQF;

  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const long long q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const float* qb = q + (long long)b * tq * D;
    const float* kb = k + (long long)b * tk * D;
    const float* vb = v + (long long)b * tk * D;

    __syncthreads();
    for (int c = tid; c < kBQF * D; c += kThreads) {
      const int r = c / D, d = c % D;
      Qs[r][d] = q0 + r < tq ? qb[(long long)(q0 + r) * D + d] : 0.f;
    }
    float acc[RW][NC];
    float m_r[RW], l_r[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      m_r[i] = kNegInf;
      l_r[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    const int nk = tiles_to_visit(tk, kBKF, kBQF, q_off, q0, k_off, causal);
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kBKF;
      __syncthreads();
      for (int c = tid; c < kBKF * D; c += kThreads) {
        const int r = c / D, d = c % D;
        const bool in = k0 + r < tk;
        Ks[r * SK + d] = in ? kb[(long long)(k0 + r) * D + d] : 0.f;
        Vs[r][d] = in ? vb[(long long)(k0 + r) * D + d] : 0.f;
      }
      __syncthreads();
      const int col = k0 + lane;  // this lane's key
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int rl = warp * RW + i;
        float x = 0.f;
        for (int d = 0; d < D; ++d) x = fmaf(Qs[rl][d], Ks[lane * SK + d], x);
        if (scale != 1.f) x *= scale;
        const bool ok = col < tk &&
                        (!causal || k_off + col <= q_off + q0 + rl);
        x = ok ? x : kNegInf;
        float mx = fmaxf(m_r[i], x);
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float alpha = expf(m_r[i] - mx);
        m_r[i] = mx;
        const float p = ok ? expf(x - mx) : 0.f;
        float ps = p;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, w);
        l_r[i] = l_r[i] * alpha + ps;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          float a = acc[i][c] * alpha;
          for (int j = 0; j < kBKF; ++j) {
            const float pj = __shfl_sync(0xffffffffu, p, j);
            if (d < D) a = fmaf(pj, Vs[j][d], a);
          }
          acc[i][c] = a;
        }
      }
    }

    float* ob = o + (long long)b * tq * D;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = q0 + warp * RW + i;
      if (r >= tq) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) ob[(long long)r * D + d] = acc[i][c];
      }
      if (lane == 0) {
        m_out[(long long)b * tq + r] = m_r[i];
        l_out[(long long)b * tq + r] = l_r[i];
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int* offs;
  float *o, *m, *l;
  int bh, tq, tk, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_mma(const Args& a) {
  static_assert(kBQ <= kBK, "Q fits in a K stage");
  const int smem = 4 * kBK * (D + 8) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB to shared memory: three blocks of 68 KB fit
  err = cudaFuncSetAttribute(flash_fwd_mma<T, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.tq + kBQ - 1) / kBQ,
                  a.bh < kMaxGridY ? a.bh : kMaxGridY);
  flash_fwd_mma<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.offs, a.o, a.m, a.l, a.bh, a.tq, a.tk,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a) {
  const dim3 grid((a.tq + kBQF - 1) / kBQF,
                  a.bh < kMaxGridY ? a.bh : kMaxGridY);
  flash_fwd_f32<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.offs, a.o, a.m, a.l, a.bh, a.tq,
      a.tk, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_kind(const Args& a, int kind) {
  switch (kind) {
    case 0: return launch_f32<D>(a);
    case 1: return launch_mma<__nv_bfloat16, D>(a);
    case 2: return launch_mma<__half, D>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch over bh batch rows: q (bh, tq, d), k and v (bh, tk, d), all
// contiguous and 16-byte aligned, of type kind (0 f32, 1 bf16, 2 fp16);
// offs (bh, 2) int32; o (bh, tq, d), m and l (bh, tq) f32.  Returns 0 or a
// CUDA error code.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* offs, void* o, void* m, void* l,
                                int bh, int tq, int tk, int d, int kind,
                                int causal, float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(offs),
               static_cast<float*>(o), static_cast<float*>(m),
               static_cast<float*>(l), bh, tq, tk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return launch_kind<16>(a, kind);
    case 32: return launch_kind<32>(a, kind);
    case 64: return launch_kind<64>(a, kind);
    case 128: return launch_kind<128>(a, kind);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
