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
// few hundred MB at most: an order below.  GPT-2's B8 T1024 H12 D64 is
// bound by its bytes (0.019 ms).
//
// Design (bf16, fp16; flash_fwd_wgmma): only wgmma reaches the tensor
// cores' full rate on Hopper, so the products are wgmma's and the rest
// feeds them.  A block of 384 threads takes 128 query rows of one batch
// row: warpgroup 0 is the producer, whose one thread issues TMA loads and
// then gives its registers away (setmaxnreg 24); warpgroups 1 and 2 are
// consumers of 64 rows each (setmaxnreg 240).  Q comes once per batch row;
// 128-key tiles of K and V come through two stages of shared memory, each
// stage's K and V with their own full and free mbarriers, so the producer
// refills K while V is still in use.  Tiles are TMA's swizzled boxes
// (csrc/hopper.cuh): 160 KB at D = 128, one block per SM (the consumers'
// registers allow no second).  A consumer computes S = Q K^T as 64 x 128
// with Q and K from shared memory (wgmma m64n128k16, f32 accumulators),
// the online softmax in registers, and O += P V with P's fragments in
// registers (the S accumulator, rounded to the input type, is register for
// register the A operand) and V read MN-major from its row-major tile.  It
// issues tile kt's S with tile kt - 1's P V behind it and runs tile kt's
// softmax while that P V is on the tensor cores; the two consumers' turns
// interleave on their own.  Every mbarrier wait precedes the fence of the
// products it feeds: ptxas serializes all of a kernel's products if a wait
// falls between two of them.  A masked score is -inf, so that expf alone
// gives it p = 0 and no branch surrounds an expf (a select around each
// expf compiles to a branch per score, which cost more than the products).
// Causal skipping: a block visits k tiles up to the last one whose first
// key one of its rows within Tq sees (tiles_to_visit, csrc/flash_tiles.cuh),
// the counterpart of both pl.when(should_run) and the index-map clamp; a
// warpgroup none of whose rows sees a visited tile passes it by; a tile
// that every row of a warpgroup sees in full skips the mask; and the blocks
// with the most tiles start first.  Rows past Tq and keys past Tk read
// zeros (TMA's bounds), and the mask gives those keys p = 0 all the same.
// What holds it near a third of its bound (PERF.md): a consumer's softmax,
// 64 accurate expf a thread per tile, runs on one warp of each SM quarter
// while only the other consumer's products can overlap it.  f32 inputs
// take a second kernel in full f32 FMAs (no TF32): lane j of a warp scores
// key j of a 32-key tile, and each lane accumulates its own output
// columns.

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // f32: 4 warps
constexpr int kThreads5 = 384;  // bf16/fp16: a producer and two consumers
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kBQ = 128;       // query rows per block (half types)
constexpr int kBK = 128;       // keys per tile (half types)
constexpr int kStages = 2;     // stages of K and V tiles
constexpr int kBQF = 16;       // query rows per block (f32)
constexpr int kBKF = 32;       // keys per tile (f32)
constexpr int kMaxGridY = 65535;

// Dynamic shared memory of the wgmma kernel, in bytes from a 1024-byte
// aligned base: Q, then the stages of K, then those of V.
template <int D>
struct FwdSmem {
  static_assert(kBQ == kBK, "Q's tile is a K tile's size");
  static constexpr int kTile = kBK * D * 2;
  static constexpr int kK = kTile;
  static constexpr int kV = kTile * (1 + kStages);
  static constexpr int kBytes = kTile * (1 + 2 * kStages);
};

// S = Q K^T of one tile for a consumer's 64 rows (rows row0 .. row0 + 63 of
// the Q tile at q_tile), against the 128 keys of the K tile at k_tile:
// issued and committed as one group.
template <typename T, int D>
__device__ __forceinline__ void issue_scores(float (&sc)[kBK / 2],
                                             uint32_t q_tile, int row0,
                                             uint32_t k_tile) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    Wgmma<T, kBK>::ss(sc, desc_k<D>(q_tile, kBQ, row0, ks),
                      desc_k<D>(k_tile, kBK, 0, ks), ks > 0);
  wg_commit();
}

// O += P V of one tile, P's fragments in registers and V read MN-major
// from its row-major tile at v_tile: issued and committed as one group.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v_tile) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    Wgmma<T, D>::rs(acc, pa[kk], desc_mn<D>(v_tile, kBK, kk));
  wg_commit();
}

// The online softmax of scored tile kt, in place: sc holds the scores of a
// thread's rows g and g + 8 (accumulator e of n-tile nt at row
// g + 8 * (e >> 1), column nt * 8 + 2 * t4 + (e & 1)) and leaves with their
// p; m_r and l_r are the rows' running maxima and this thread's share of
// their sums, alpha what O is to be multiplied by.  A tile that every row of
// the warpgroup (first row q0) sees in full needs no mask.  A masked score
// is -inf: the maximum, which starts at -1e30, stays finite, and expf gives
// the score p = 0 exactly.
__device__ __forceinline__ void online_softmax(
    float (&sc)[kBK / 2], float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
    int kt, int tk, int q0, int q_off, int k_off, const int (&row_pos)[2],
    int t4, int causal, float scale) {
  constexpr int NS = kBK / 8;  // n tiles of S
  const int k0 = kt * kBK;
  const bool whole =
      k0 + kBK <= tk && (!causal || k_off + k0 + kBK - 1 <= q_off + q0);
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      float x = sc[nt * 4 + e];
      if (scale != 1.f) x *= scale;
      if (!whole) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const bool ok = col < tk && (!causal || k_off + col <= row_pos[hr]);
        x = ok ? x : -INFINITY;
      }
      sc[nt * 4 + e] = x;
      mx[hr] = fmaxf(mx[hr], x);
    }
  }
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
      const float p = expf(sc[nt * 4 + e] - mx[hr]);
      sc[nt * 4 + e] = p;
      ls[hr] += p;
    }
  }
  l_r[0] = l_r[0] * alpha[0] + ls[0];
  l_r[1] = l_r[1] * alpha[1] + ls[1];
}

// O rescaled by alpha, and P rounded to the input type: the A fragments of
// its P V (those of n-tiles 2j and 2j + 1 for reduction step j).
template <typename T, int D>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[D / 2],
                                                 uint32_t (&pa)[kBK / 16][4],
                                                 const float (&sc)[kBK / 2],
                                                 const float (&alpha)[2]) {
  using hopper::pack2;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    pa[j][0] = pack2<T>(sc[8 * j], sc[8 * j + 1]);
    pa[j][1] = pack2<T>(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack2<T>(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack2<T>(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

// bf16 / fp16 inputs: wgmma, f32 accumulation.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads5, 1)
    flash_fwd_wgmma(__grid_constant__ const CUtensorMap q_map,
                    __grid_constant__ const CUtensorMap k_map,
                    __grid_constant__ const CUtensorMap v_map,
                    const int* __restrict__ offs, float* __restrict__ o,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int bh, int tq, int tk, int causal, float scale) {
  using namespace hopper;
  using L = FwdSmem<D>;
  constexpr int NS = kBK / 8;  // n tiles of S
  constexpr int ND = D / 8;    // n tiles of O
  constexpr int BOX = kBK * Span<D>::kRowBytes;  // one box of a tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t q_full, q_free;
  __shared__ uint64_t k_full[kStages], k_free[kStages];
  __shared__ uint64_t v_full[kStages], v_free[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int wg = threadIdx.x / 128;
  // the blocks with the most causal work first
  const int blk_q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int rows = min(kBQ, tq - blk_q0);  // the block's rows within Tq

  if (threadIdx.x == 0) {
    bar_init(&q_full, 1);
    bar_init(&q_free, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&k_free[s], kConsumers);
      bar_init(&v_full[s], 1);
      bar_init(&v_free[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the stages filled
    regs_down<24>();
    if (threadIdx.x != 0) return;
    tma_prefetch(&q_map);
    tma_prefetch(&k_map);
    tma_prefetch(&v_map);
    int it = 0, qu = 0;  // tiles and Q loads so far
    for (int b = blockIdx.y; b < bh; b += gridDim.y) {
      const int nk = tiles_to_visit(tk, kBK, rows, offs[2 * b], blk_q0,
                                    offs[2 * b + 1], causal);
      if (nk == 0) continue;
      bar_wait(&q_free, (qu++ & 1) ^ 1);
      bar_arrive_tx(&q_full, L::kTile);
      for (int x = 0; x < Span<D>::kBoxes; ++x)
        tma_load(smem + x * BOX, &q_map, x * Span<D>::kCols, blk_q0, b,
                 &q_full);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        const uint32_t free_par = ((it / kStages) & 1) ^ 1;
        bar_wait(&k_free[s], free_par);
        bar_arrive_tx(&k_full[s], L::kTile);
        for (int x = 0; x < Span<D>::kBoxes; ++x)
          tma_load(smem + L::kK + s * L::kTile + x * BOX, &k_map,
                   x * Span<D>::kCols, kt * kBK, b, &k_full[s]);
        bar_wait(&v_free[s], free_par);
        bar_arrive_tx(&v_full[s], L::kTile);
        for (int x = 0; x < Span<D>::kBoxes; ++x)
          tma_load(smem + L::kV + s * L::kTile + x * BOX, &v_map,
                   x * Span<D>::kCols, kt * kBK, b, &v_full[s]);
      }
    }
    return;
  }

  // a consumer: 64 rows, 16 a warp
  regs_up<240>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blk_q0 + 64 * cw;  // this warpgroup's first row
  int it = 0, qu = 0;  // tiles and Q loads so far
  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const int q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const int nk = tiles_to_visit(tk, kBK, rows, q_off, blk_q0, k_off, causal);
    // the tiles from nkw on hold no key that a row of this warpgroup sees
    const int nkw = q0 < tq ? tiles_to_visit(tk, kBK, min(64, tq - q0), q_off,
                                             q0, k_off, causal)
                            : 0;
    float acc[ND * 4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf};  // rows g and g+8
    float l_r[2] = {0.f, 0.f};          // this thread's share of the sums
    const int row_pos[2] = {q_off + q0 + 16 * warp + g,
                            q_off + q0 + 16 * warp + g + 8};
    if (nk > 0) bar_wait(&q_full, qu & 1);

    // Tile kt's S = Q K^T is issued with, behind it, tile kt - 1's
    // O += P V, and tile kt's softmax runs while that P V is on the tensor
    // cores.  The warpgroup computes tiles 0 .. nc - 1 and passes by the
    // rest.
    const int nc = min(nk, nkw);
    float sc[NS * 4], alpha[2];
    uint32_t pa[kBK / 16][4];  // P of the tile before, the A of its P V
    if (nc > 0) {
      const int s = it % kStages;
      bar_wait(&k_full[s], (it / kStages) & 1);
      issue_scores<T, D>(sc, base, 64 * cw, base + L::kK + s * L::kTile);
      wg_wait<0>();
      hold(sc);
      bar_arrive(&k_free[s]);
      online_softmax(sc, m_r, l_r, alpha, 0, tk, q0, q_off, k_off, row_pos,
                     t4, causal, scale);
      rescale_and_pack<T, D>(acc, pa, sc, alpha);
    }
    for (int kt = 1; kt < nc; ++kt) {
      const int kp = kt - 1;
      const int s = (it + kt) % kStages, sp = (it + kp) % kStages;
      // both waits before the products: a wait between two products would
      // have ptxas serialize every product of the kernel
      bar_wait(&k_full[s], ((it + kt) / kStages) & 1);
      bar_wait(&v_full[sp], ((it + kp) / kStages) & 1);
      issue_scores<T, D>(sc, base, 64 * cw, base + L::kK + s * L::kTile);
      const uint32_t v_prev = base + L::kV + sp * L::kTile;
      issue_pv<T, D>(acc, pa, v_prev);
      wg_wait<1>();  // S is in; P V may still run
      hold(sc);
      bar_arrive(&k_free[s]);
      online_softmax(sc, m_r, l_r, alpha, kt, tk, q0, q_off, k_off, row_pos,
                     t4, causal, scale);
      wg_wait<0>();  // P V of tile kp is in
      hold(acc);
      hold(pa);
      bar_arrive(&v_free[sp]);
      rescale_and_pack<T, D>(acc, pa, sc, alpha);
    }
    if (nc > 0) {
      const int kp = nc - 1, sp = (it + kp) % kStages;
      bar_wait(&v_full[sp], ((it + kp) / kStages) & 1);
      const uint32_t v_last = base + L::kV + sp * L::kTile;
      wg_fence();
      issue_pv<T, D>(acc, pa, v_last);
      wg_wait<0>();
      hold(acc);
      hold(pa);
      bar_arrive(&v_free[sp]);
    }
    // the visited tiles that hold no key this warpgroup's rows see: their
    // stages are released all the same
    for (int kt = nc; kt < nk; ++kt) {
      const int s = (it + kt) % kStages;
      const uint32_t par = ((it + kt) / kStages) & 1;
      bar_wait(&k_full[s], par);
      bar_arrive(&k_free[s]);
      bar_wait(&v_full[s], par);
      bar_arrive(&v_free[s]);
    }
    it += nk;
    if (nk > 0) {
      bar_arrive(&q_free);
      ++qu;
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
      const int r = q0 + 16 * warp + g + 8 * hr;
      if (r >= tq) continue;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn)
        *reinterpret_cast<float2*>(ob + (long long)r * D + dn * 8 + t4 * 2) =
            make_float2(acc[dn * 4 + 2 * hr], acc[dn * 4 + 2 * hr + 1]);
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
int launch_wgmma(const Args& a, int kind) {
  // with no key (tk = 0) no block loads k or v, but their maps need a
  // tensor all the same: q's
  const bool keys = a.tk > 0;
  CUtensorMap qm, km, vm;
  int err = hopper::make_map(&qm, a.q, kind, D, a.tq, a.bh, kBQ);
  if (!err)
    err = hopper::make_map(&km, keys ? a.k : a.q, kind, D,
                           keys ? a.tk : a.tq, a.bh, kBK);
  if (!err)
    err = hopper::make_map(&vm, keys ? a.v : a.q, kind, D,
                           keys ? a.tk : a.tq, a.bh, kBK);
  if (err) return err;
  const int smem = FwdSmem<D>::kBytes + 1024;  // + the base's alignment
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.tq + kBQ - 1) / kBQ,
                  a.bh < kMaxGridY ? a.bh : kMaxGridY);
  flash_fwd_wgmma<T, D><<<grid, kThreads5, smem, a.stream>>>(
      qm, km, vm, a.offs, a.o, a.m, a.l, a.bh, a.tq, a.tk, a.causal,
      a.scale);
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
    case 1: return launch_wgmma<__nv_bfloat16, D>(a, kind);
    case 2: return launch_wgmma<__half, D>(a, kind);
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

// The dynamic shared memory a launch of kernel 5's wgmma kernel asks for at
// head size d, in bytes; -1 for a head size it is not built for.
extern "C" int flash_smem_bytes(int d) {
  switch (d) {
    case 16: return FwdSmem<16>::kBytes + 1024;
    case 32: return FwdSmem<32>::kBytes + 1024;
    case 64: return FwdSmem<64>::kBytes + 1024;
    case 128: return FwdSmem<128>::kBytes + 1024;
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
