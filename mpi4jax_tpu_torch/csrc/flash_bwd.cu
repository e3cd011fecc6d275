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
// Design of kernel 6 (bf16, fp16; flash_bwd_dq_wgmma): only wgmma reaches
// the tensor cores' full rate on Hopper.  A block of 384 threads takes 128
// query rows of one batch row: warpgroup 0 is the producer, one thread of
// which issues TMA loads (setmaxnreg 24), and warpgroups 1 and 2 are
// consumers of 64 rows each (setmaxnreg 240), each holding its 64 x D dQ in
// f32 registers and its rows' lse and delta.  Q and dO come once per batch
// row; 64-key tiles of K and V come through three stages of shared memory
// on full and free mbarriers (TMA's swizzled boxes, csrc/hopper.cuh; 160 KB
// at D = 128).  Per tile a consumer computes S = Q K^T and dP = dO V^T with
// both operands in shared memory (wgmma m64n64k16), turns them into dS in
// registers and, rounded to the input type, dS is register for register the
// A operand of dQ += dS K, whose B operand K is read MN-major from the tile
// that served S K-major.  Tile kt's S and dP are issued with tile kt - 1's
// dQ product behind them, and tile kt's dS is computed while that product
// runs: a stage is held across two steps, hence the third stage.  Every
// mbarrier wait precedes the fence of the products that read its tile
// (ptxas serializes all of a kernel's wgmma when a wait falls between two of
// them).  The mask picks expf's argument, not its result.  The block visits
// k tiles up to the last one whose first key one of its rows within Tq sees
// (tiles_to_visit, csrc/flash_tiles.cuh); a warpgroup passes by the visited
// tiles that hold no key its rows see, releasing their stages all the same;
// a tile that every row of a warp sees in full skips the mask; and the
// blocks with the most tiles start first.  dQ is summed only in the block's
// loop and written once.  What holds it near 0.39 of its bound (PERF.md):
// the overlap is worth a few percent (tile kt's dS computed after tile
// kt - 1's dQ is in measured 3% slower, benchmarks/kernel_variants.py), so
// each consumer's chain of products, waits and 64 expf a thread per tile
// sets the pace, with the other consumer's chain as the main overlap; S
// and dP read both operands from shared memory at 64 columns, about the
// shared memory's rate (reckoned, as for kernel 7).  Two stages, or
// 128-key tiles in two stages, leave a stage's load exposed and measured
// slower.
//
// Design of kernel 7 (bf16, fp16; flash_bwd_dkv_wgmma): only wgmma reaches
// the tensor cores' full rate on Hopper.  A block of 384 threads takes 128
// keys of one batch row: warpgroup 0 is the producer, one warp of which
// issues TMA loads and copies lse and delta (setmaxnreg 40), and
// warpgroups 1 and 2 are consumers of 64 keys each (setmaxnreg 232), each
// holding its 64 x D dK and dV in f32 registers.  K and V come once per
// batch row; 64-query tiles of Q and dO, with their lse and delta, come
// through two stages of shared memory on full and free mbarriers (Q, dO by
// TMA in swizzled boxes, csrc/hopper.cuh; 129 KB at D = 128).  Per tile a
// consumer computes the transposed scores S^T = K Q^T and dP^T = V dO^T,
// keys as rows, with both operands in shared memory (wgmma m64n64k16), so
// that P^T and dS^T sit in accumulator layout: rounded to the input type,
// they are register for register the A operands of dV += P^T dO and
// dK += dS^T Q, whose B operands dO and Q are read MN-major from the same
// tiles that served S^T and dP^T K-major.  The mask picks expf's argument,
// not its result: a select around each expf compiles to branches.  The
// loop starts at the first tile that sees a key of the block
// (first_q_tile, csrc/flash_tiles.cuh, the counterpart of
// _causal_q_index); a warpgroup passes by the tiles before the first that
// sees one of its keys, and all of them when its keys start past Tk; and
// the blocks of the earliest keys, which see the most queries, start
// first.  dK and dV are summed only in the block's loop, tile after tile,
// and written once.  What bounds it now: a consumer's tile is a chain, the
// two transposed products, their wait, the elementwise work, the two
// gradient products and their wait, with the other consumer's chain as the
// only overlap; S^T and dP^T read both operands from shared memory at 64
// columns, about the shared memory's bandwidth.  Issuing a tile's S^T and
// dP^T behind the previous tile's gradients would keep about 224 registers
// a thread live at D = 128, past the 232 a consumer has: it spilled.
//
// f32 inputs take two kernels in full f32 FMAs (no TF32): lane j of a warp
// scores key j (kernel 6) or query j (kernel 7) of a 32-wide tile, and each
// lane accumulates its own output columns.

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // the f32 kernels: 4 warps
constexpr int kThreadsW = 384;  // kernels 6 and 7: a producer, two consumers
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kB6 = 128;       // query rows of a block of kernel 6
constexpr int kT6 = 64;        // keys per tile of kernel 6
constexpr int kStages6 = 3;    // stages of K and V tiles
constexpr int kB7 = 128;       // keys of a block of kernel 7
constexpr int kT7 = 64;        // queries per tile of kernel 7
constexpr int kStages7 = 2;    // stages of Q, dO, lse and delta tiles
constexpr int kBF = 16;        // rows of a block (f32)
constexpr int kTF = 32;        // tile width (f32)
constexpr int kMaxGridY = 65535;

// Dynamic shared memory of kernel 6, in bytes from a 1024-byte aligned
// base: Q and dO of the block, then the stages of K, then those of V.
template <int D>
struct DqSmem {
  static constexpr int kRows = kB6 * D * 2;  // Q or dO
  static constexpr int kTile = kT6 * D * 2;  // a tile of K or V
  static constexpr int kQ = 0;
  static constexpr int kDo = kRows;
  static constexpr int kK = 2 * kRows;
  static constexpr int kV = kK + kStages6 * kTile;
  static constexpr int kBytes = kV + kStages6 * kTile;
};

// S = Q K^T and dP = dO V^T of one tile for a consumer's 64 rows (rows
// row0 .. row0 + 63 of the block's Q and dO tiles), against the kT6 keys of
// the K and V tiles: issued and committed as one group.
template <typename T, int D>
__device__ __forceinline__ void issue_s_dp(float (&s)[kT6 / 2],
                                           float (&dp)[kT6 / 2],
                                           uint32_t q_tile, uint32_t do_tile,
                                           int row0, uint32_t k_tile,
                                           uint32_t v_tile) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < kT6 / 2; ++i) s[i] = dp[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    Wgmma<T, kT6>::ss(s, desc_k<D>(q_tile, kB6, row0, ks),
                      desc_k<D>(k_tile, kT6, 0, ks), ks > 0);
    Wgmma<T, kT6>::ss(dp, desc_k<D>(do_tile, kB6, row0, ks),
                      desc_k<D>(v_tile, kT6, 0, ks), ks > 0);
  }
  wg_commit();
}

// dQ += dS K of one tile, dS's fragments in registers and K read MN-major
// from the tile that served S: issued and committed as one group.
template <typename T, int D>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 2],
                                         const uint32_t (&sa)[kT6 / 16][4],
                                         uint32_t k_tile) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kT6 / 16; ++kk)
    Wgmma<T, D>::rs(acc, sa[kk], desc_mn<D>(k_tile, kT6, kk));
  wg_commit();
}

// dS of scored tile kt in place of S: p = exp(s - lse), 0 where masked,
// and ds = p (dp - delta), times scale.  s holds the scores of a thread's
// rows g and g + 8 of its warp (accumulator e of n-tile nt at row
// g + 8 (e >> 1), key nt * 8 + 2 t4 + (e & 1) of the tile); a row past Tq
// has zero q and dO and lse = delta = 0, so its ds is 0.  A tile that every
// row of the warp (first row w0) sees in full needs no mask.  The mask
// picks expf's argument, not its result: a select around each expf
// compiles to a branch per score.
__device__ __forceinline__ void tile_ds(float (&s)[kT6 / 2],
                                        const float (&dp)[kT6 / 2], int kt,
                                        int tk, int w0, int q_off, int k_off,
                                        const int (&row_pos)[2],
                                        const float (&lse_r)[2],
                                        const float (&dlt_r)[2], int t4,
                                        int causal, float scale) {
  const int k0 = kt * kT6;
  const bool whole =
      k0 + kT6 <= tk && (!causal || k_off + k0 + kT6 - 1 <= q_off + w0);
#pragma unroll
  for (int nt = 0; nt < kT6 / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      float x = s[nt * 4 + e];
      if (scale != 1.f) x *= scale;
      bool ok = true;
      if (!whole) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        ok = col < tk && (!causal || k_off + col <= row_pos[hr]);
      }
      const float p = expf(ok ? x - lse_r[hr] : -INFINITY);
      float ds = p * (dp[nt * 4 + e] - dlt_r[hr]);
      if (scale != 1.f) ds *= scale;
      s[nt * 4 + e] = ds;
    }
  }
}

// dS rounded to the input type: the A fragments of dQ += dS K (those of
// n-tiles 2j and 2j + 1 for reduction step j).
template <typename T>
__device__ __forceinline__ void pack_ds(uint32_t (&sa)[kT6 / 16][4],
                                        const float (&s)[kT6 / 2]) {
#pragma unroll
  for (int j = 0; j < kT6 / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      sa[j][r] = hopper::pack2<T>(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
}

// Kernel 6, bf16 / fp16 inputs: wgmma, f32 accumulation.
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_bwd_dq_wgmma(__grid_constant__ const CUtensorMap q_map,
                       __grid_constant__ const CUtensorMap k_map,
                       __grid_constant__ const CUtensorMap v_map,
                       __grid_constant__ const CUtensorMap do_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ offs, float* __restrict__ dq,
                       int bh, int tq, int tk, int causal, float scale) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int ND = D / 8;  // n tiles of dQ
  constexpr int QBOX = kB6 * Span<D>::kRowBytes;  // a box of Q or dO
  constexpr int KBOX = kT6 * Span<D>::kRowBytes;  // a box of K or V
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qd_full, qd_free, full[kStages6], free_[kStages6];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int wg = threadIdx.x / 128;
  // the blocks with the most causal work first
  const int blk_q0 = (gridDim.x - 1 - blockIdx.x) * kB6;
  const int rows = min(kB6, tq - blk_q0);  // the block's rows within Tq

  if (threadIdx.x == 0) {
    bar_init(&qd_full, 1);
    bar_init(&qd_free, kConsumers);
    for (int s = 0; s < kStages6; ++s) {
      bar_init(&full[s], 1);
      bar_init(&free_[s], kConsumers);
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
    tma_prefetch(&do_map);
    int it = 0, qu = 0;  // tiles and Q/dO loads so far
    for (int b = blockIdx.y; b < bh; b += gridDim.y) {
      const int nk = tiles_to_visit(tk, kT6, rows, offs[2 * b], blk_q0,
                                    offs[2 * b + 1], causal);
      if (nk == 0) continue;
      bar_wait(&qd_free, (qu++ & 1) ^ 1);
      bar_arrive_tx(&qd_full, 2 * L::kRows);
      for (int x = 0; x < Span<D>::kBoxes; ++x) {
        tma_load(smem + L::kQ + x * QBOX, &q_map, x * Span<D>::kCols, blk_q0,
                 b, &qd_full);
        tma_load(smem + L::kDo + x * QBOX, &do_map, x * Span<D>::kCols,
                 blk_q0, b, &qd_full);
      }
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % kStages6;
        bar_wait(&free_[st], ((it / kStages6) & 1) ^ 1);
        bar_arrive_tx(&full[st], 2 * L::kTile);
        for (int x = 0; x < Span<D>::kBoxes; ++x) {
          tma_load(smem + L::kK + st * L::kTile + x * KBOX, &k_map,
                   x * Span<D>::kCols, kt * kT6, b, &full[st]);
          tma_load(smem + L::kV + st * L::kTile + x * KBOX, &v_map,
                   x * Span<D>::kCols, kt * kT6, b, &full[st]);
        }
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
  const int w0 = q0 + 16 * warp;    // this warp's
  int it = 0, qu = 0;  // tiles and Q/dO loads so far
  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const int q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const long long qrow = (long long)b * tq;
    const int nk = tiles_to_visit(tk, kT6, rows, q_off, blk_q0, k_off, causal);
    // the tiles from nc on hold no key that a row of this warpgroup within
    // Tq sees (none does when its rows start past Tq)
    const int nkw = q0 < tq ? tiles_to_visit(tk, kT6, min(64, tq - q0), q_off,
                                             q0, k_off, causal)
                            : 0;
    const int nc = min(nk, nkw);
    // rows g and g + 8 of this warp: lse, delta and global position; a row
    // past Tq takes lse = delta = 0
    float lse_r[2], dlt_r[2];
    int row_pos[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = w0 + g + 8 * hr;
      lse_r[hr] = r < tq ? lse[qrow + r] : 0.f;
      dlt_r[hr] = r < tq ? delta[qrow + r] : 0.f;
      row_pos[hr] = q_off + r;
    }
    float acc[ND * 4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;
    if (nk > 0) bar_wait(&qd_full, qu & 1);
    const uint32_t qs = base + L::kQ, dos = base + L::kDo;
    auto stage = [&](int kt) { return (it + kt) % kStages6; };
    auto parity = [&](int kt) {
      return (uint32_t)(((it + kt) / kStages6) & 1);
    };

    // Tile kt's S and dP are issued with, behind them, tile kt - 1's
    // dQ += dS K, and tile kt's dS is computed while that product is on the
    // tensor cores; tile kt - 1's stage is released once it is in.  The
    // warpgroup computes tiles 0 .. nc - 1 and passes by the rest.
    float s[kT6 / 2], dp[kT6 / 2];
    uint32_t sa[kT6 / 16][4];  // dS of the tile before, the A of its dQ
    if (nc > 0) {
      const int st = stage(0);
      bar_wait(&full[st], parity(0));
      issue_s_dp<T, D>(s, dp, qs, dos, 64 * cw, base + L::kK + st * L::kTile,
                       base + L::kV + st * L::kTile);
      wg_wait<0>();
      hold(s);
      hold(dp);
      tile_ds(s, dp, 0, tk, w0, q_off, k_off, row_pos, lse_r, dlt_r, t4,
              causal, scale);
      pack_ds<T>(sa, s);
    }
    for (int kt = 1; kt < nc; ++kt) {
      const int st = stage(kt), sp = stage(kt - 1);
      // the wait before the products: a wait between two products would
      // have ptxas serialize every product of the kernel
      bar_wait(&full[st], parity(kt));
      issue_s_dp<T, D>(s, dp, qs, dos, 64 * cw, base + L::kK + st * L::kTile,
                       base + L::kV + st * L::kTile);
      issue_dq<T, D>(acc, sa, base + L::kK + sp * L::kTile);
      wg_wait<1>();  // S and dP are in; dQ may still run
      hold(s);
      hold(dp);
      tile_ds(s, dp, kt, tk, w0, q_off, k_off, row_pos, lse_r, dlt_r, t4,
              causal, scale);
      wg_wait<0>();  // dQ of tile kt - 1 is in
      hold(acc);
      hold(sa);
      bar_arrive(&free_[sp]);
      pack_ds<T>(sa, s);
    }
    if (nc > 0) {
      const int sp = stage(nc - 1);
      wg_fence();
      issue_dq<T, D>(acc, sa, base + L::kK + sp * L::kTile);
      wg_wait<0>();
      hold(acc);
      hold(sa);
      bar_arrive(&free_[sp]);
    }
    // the visited tiles that hold no key this warpgroup's rows see: their
    // stages are released all the same
    for (int kt = nc; kt < nk; ++kt) {
      bar_wait(&full[stage(kt)], parity(kt));
      bar_arrive(&free_[stage(kt)]);
    }
    it += nk;
    if (nk > 0) {
      bar_arrive(&qd_free);
      ++qu;
    }

    float* out = dq + qrow * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = w0 + g + 8 * hr;
      if (r >= tq) continue;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn)
        *reinterpret_cast<float2*>(out + (long long)r * D + dn * 8 + t4 * 2) =
            make_float2(acc[dn * 4 + 2 * hr], acc[dn * 4 + 2 * hr + 1]);
    }
  }
}

// Dynamic shared memory of kernel 7, in bytes from a 1024-byte aligned
// base: K, V, then the stages of Q, of dO, of lse and of delta.
template <int D>
struct DkvSmem {
  static constexpr int kKV = kB7 * D * 2;    // K or V
  static constexpr int kTile = kT7 * D * 2;  // a tile of Q or dO
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;
  static constexpr int kDo = kQ + kStages7 * kTile;
  static constexpr int kLse = kDo + kStages7 * kTile;
  static constexpr int kDelta = kLse + kStages7 * kT7 * 4;
  static constexpr int kBytes = kDelta + kStages7 * kT7 * 4;
};

// Kernel 7, bf16 / fp16 inputs: wgmma, f32 accumulation.
template <typename T, int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_bwd_dkv_wgmma(__grid_constant__ const CUtensorMap q_map,
                        __grid_constant__ const CUtensorMap k_map,
                        __grid_constant__ const CUtensorMap v_map,
                        __grid_constant__ const CUtensorMap do_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ offs, float* __restrict__ dk,
                        float* __restrict__ dv, int bh, int tq, int tk,
                        int causal, float scale) {
  using namespace hopper;
  using L = DkvSmem<D>;
  constexpr int NS = kT7 / 8;  // n tiles of S^T
  constexpr int ND = D / 8;    // n tiles of dK and dV
  constexpr int KD = D / 16;   // reduction steps of K Q^T and V dO^T
  constexpr int KBOX = kB7 * Span<D>::kRowBytes;  // a box of K or V
  constexpr int QBOX = kT7 * Span<D>::kRowBytes;  // a box of Q or dO
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t kv_full, kv_free, full[kStages7], free_[kStages7];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  float* Ls = reinterpret_cast<float*>(smem + L::kLse);
  float* Es = reinterpret_cast<float*>(smem + L::kDelta);
  const int wg = threadIdx.x / 128;
  // the blocks of the earliest keys see the most queries: first
  const int blk_k0 = blockIdx.x * kB7;
  const int nq = (tq + kT7 - 1) / kT7;

  if (threadIdx.x == 0) {
    bar_init(&kv_full, 1);
    bar_init(&kv_free, kConsumers);
    for (int s = 0; s < kStages7; ++s) {
      bar_init(&full[s], 1 + 32);  // the TMA's bytes and the warp's copies
      bar_init(&free_[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one warp keeps the stages filled
    regs_down<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      tma_prefetch(&q_map);
      tma_prefetch(&k_map);
      tma_prefetch(&v_map);
      tma_prefetch(&do_map);
    }
    int it = 0, kvu = 0;  // q tiles and K/V loads so far
    for (int b = blockIdx.y; b < bh; b += gridDim.y) {
      const long long qrow = (long long)b * tq;
      const int t0 = first_q_tile(tq, kT7, offs[2 * b], blk_k0,
                                  offs[2 * b + 1], causal);
      if (t0 >= nq) continue;
      if (lane == 0) {
        bar_wait(&kv_free, (kvu & 1) ^ 1);
        bar_arrive_tx(&kv_full, 2 * L::kKV);
        for (int x = 0; x < Span<D>::kBoxes; ++x) {
          tma_load(smem + L::kK + x * KBOX, &k_map, x * Span<D>::kCols,
                   blk_k0, b, &kv_full);
          tma_load(smem + L::kV + x * KBOX, &v_map, x * Span<D>::kCols,
                   blk_k0, b, &kv_full);
        }
      }
      ++kvu;
      for (int qt = t0; qt < nq; ++qt, ++it) {
        const int st = it % kStages7;
        bar_wait(&free_[st], ((it / kStages7) & 1) ^ 1);
        if (lane == 0) {
          bar_arrive_tx(&full[st], 2 * L::kTile);
          for (int x = 0; x < Span<D>::kBoxes; ++x) {
            tma_load(smem + L::kQ + st * L::kTile + x * QBOX, &q_map,
                     x * Span<D>::kCols, qt * kT7, b, &full[st]);
            tma_load(smem + L::kDo + st * L::kTile + x * QBOX, &do_map,
                     x * Span<D>::kCols, qt * kT7, b, &full[st]);
          }
        }
        // lse and delta of the tile's queries; a query past Tq reads zeros
        for (int i = lane; i < kT7; i += 32) {
          const int r = qt * kT7 + i;
          Ls[st * kT7 + i] = r < tq ? lse[qrow + r] : 0.f;
          Es[st * kT7 + i] = r < tq ? delta[qrow + r] : 0.f;
        }
        bar_arrive(&full[st]);
      }
    }
    return;
  }

  // a consumer: 64 keys, 16 a warp
  regs_up<232>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blk_k0 + 64 * cw;  // this warpgroup's first key
  int it = 0, kvu = 0;
  for (int b = blockIdx.y; b < bh; b += gridDim.y) {
    const int q_off = offs[2 * b], k_off = offs[2 * b + 1];
    const int t0 = first_q_tile(tq, kT7, q_off, blk_k0, k_off, causal);
    // the q tiles before t0w hold no query that sees a key of this
    // warpgroup (none does when its keys start past Tk)
    const int t0w =
        k0 < tk ? first_q_tile(tq, kT7, q_off, k0, k_off, causal) : nq;
    // keys g and g + 8 of this warp: global position, and whether in Tk
    int key_pos[2];
    bool key_in[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = k0 + 16 * warp + g + 8 * hr;
      key_pos[hr] = k_off + r;
      key_in[hr] = r < tk;
    }
    float adk[ND * 4], adv[ND * 4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) adk[i] = adv[i] = 0.f;
    if (t0 < nq) bar_wait(&kv_full, kvu & 1);

    for (int qt = t0; qt < nq; ++qt, ++it) {
      const int q0t = qt * kT7, st = it % kStages7;
      const uint32_t qc = base + L::kQ + st * L::kTile;
      const uint32_t dc = base + L::kDo + st * L::kTile;
      const float* lc = Ls + st * kT7;
      const float* ec = Es + st * kT7;
      bar_wait(&full[st], (it / kStages7) & 1);
      if (qt >= t0w) {
        // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 keys as rows
        float sT[NS * 4], dpT[NS * 4];
#pragma unroll
        for (int i = 0; i < NS * 4; ++i) sT[i] = dpT[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
          Wgmma<T, kT7>::ss(sT, desc_k<D>(base + L::kK, kB7, 64 * cw, ks),
                            desc_k<D>(qc, kT7, 0, ks), ks > 0);
          Wgmma<T, kT7>::ss(dpT, desc_k<D>(base + L::kV, kB7, 64 * cw, ks),
                            desc_k<D>(dc, kT7, 0, ks), ks > 0);
        }
        wg_commit();
        wg_wait<0>();
        hold(sT);
        hold(dpT);

        // p^T and dS^T: accumulator e of n-tile nt sits at key
        // g + 8 (e >> 1) of the warp, query nt * 8 + 2 t4 + (e & 1) of the
        // tile
        const bool whole = q0t + kT7 <= tq && k0 + 64 <= tk &&
                           (!causal || k_off + k0 + 63 <= q_off + q0t);
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, qi = nt * 8 + t4 * 2 + (e & 1);
            float x = sT[nt * 4 + e];
            if (scale != 1.f) x *= scale;
            bool ok = true;
            if (!whole)
              ok = key_in[hr] && q0t + qi < tq &&
                   (!causal || key_pos[hr] <= q_off + q0t + qi);
            // the mask picks expf's argument, not its result, so that
            // every p is one expf and a masked p is 0 exactly
            const float p = expf(ok ? x - lc[qi] : -INFINITY);
            float ds = p * (dpT[nt * 4 + e] - ec[qi]);
            if (scale != 1.f) ds *= scale;
            sT[nt * 4 + e] = p;
            dpT[nt * 4 + e] = ds;
          }
        }

        // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to the input
        // type; dO and Q read MN-major from their tiles
        uint32_t pa[kT7 / 16][4], sa[kT7 / 16][4];
#pragma unroll
        for (int j = 0; j < kT7 / 16; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[j][r] = pack2<T>(sT[8 * j + 2 * r], sT[8 * j + 2 * r + 1]);
            sa[j][r] = pack2<T>(dpT[8 * j + 2 * r], dpT[8 * j + 2 * r + 1]);
          }
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kT7 / 16; ++kk) {
          Wgmma<T, D>::rs(adv, pa[kk], desc_mn<D>(dc, kT7, kk));
          Wgmma<T, D>::rs(adk, sa[kk], desc_mn<D>(qc, kT7, kk));
        }
        wg_commit();
        wg_wait<0>();
        hold(adv);
        hold(adk);
        hold(pa);
        hold(sa);
      }
      bar_arrive(&free_[st]);
    }
    if (t0 < nq) {
      bar_arrive(&kv_free);
      ++kvu;
    }

    const long long krow = (long long)b * tk;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = k0 + 16 * warp + g + 8 * hr;
      if (r >= tk) continue;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const long long at = (krow + r) * D + dn * 8 + t4 * 2;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(adk[dn * 4 + 2 * hr], adk[dn * 4 + 2 * hr + 1]);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(adv[dn * 4 + 2 * hr], adv[dn * 4 + 2 * hr + 1]);
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
  int kind;  // 0 f32, 1 bf16, 2 fp16
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
int launch_dq_wgmma(const Args& a) {
  CUtensorMap qm, km, vm, dm;
  int err = hopper::make_map(&qm, a.q, a.kind, D, a.tq, a.bh, kB6);
  if (!err) err = hopper::make_map(&dm, a.dout, a.kind, D, a.tq, a.bh, kB6);
  if (!err) err = hopper::make_map(&km, a.k, a.kind, D, a.tk, a.bh, kT6);
  if (!err) err = hopper::make_map(&vm, a.v, a.kind, D, a.tk, a.bh, kT6);
  if (err) return err;
  const int smem = DqSmem<D>::kBytes + 1024;  // + the base's alignment
  err = allow_smem(flash_bwd_dq_wgmma<T, D>, smem);
  if (err) return err;
  flash_bwd_dq_wgmma<T, D><<<grid_of(a.tq, kB6, a.bh), kThreadsW, smem,
                             a.stream>>>(
      qm, km, vm, dm, a.lse, a.delta, a.offs, a.out1, a.bh, a.tq, a.tk,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_wgmma(const Args& a) {
  CUtensorMap qm, km, vm, dm;
  int err = hopper::make_map(&qm, a.q, a.kind, D, a.tq, a.bh, kT7);
  if (!err) err = hopper::make_map(&dm, a.dout, a.kind, D, a.tq, a.bh, kT7);
  if (!err) err = hopper::make_map(&km, a.k, a.kind, D, a.tk, a.bh, kB7);
  if (!err) err = hopper::make_map(&vm, a.v, a.kind, D, a.tk, a.bh, kB7);
  if (err) return err;
  const int smem = DkvSmem<D>::kBytes + 1024;  // + the base's alignment
  err = allow_smem(flash_bwd_dkv_wgmma<T, D>, smem);
  if (err) return err;
  flash_bwd_dkv_wgmma<T, D><<<grid_of(a.tk, kB7, a.bh), kThreadsW, smem,
                              a.stream>>>(
      qm, km, vm, dm, a.lse, a.delta, a.offs, a.out1, a.out2, a.bh, a.tq,
      a.tk, a.causal, a.scale);
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
      return dkv ? launch_dkv_wgmma<__nv_bfloat16, D>(a)
                 : launch_dq_wgmma<__nv_bfloat16, D>(a);
    case 2:
      return dkv ? launch_dkv_wgmma<__half, D>(a)
                 : launch_dq_wgmma<__half, D>(a);
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
  const Args a{kind, q, k, v, dout, static_cast<const float*>(lse),
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
  const Args a{kind, q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(offs), static_cast<float*>(dk),
               static_cast<float*>(dv), bh, tq, tk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(a, d, kind, true);
}

// The dynamic shared memory a launch of kernel 7's wgmma kernel asks for at
// head size d, in bytes; -1 for a head size it is not built for.
extern "C" int flash_smem_bytes(int d) {
  switch (d) {
    case 16: return DkvSmem<16>::kBytes + 1024;
    case 32: return DkvSmem<32>::kBytes + 1024;
    case 64: return DkvSmem<64>::kBytes + 1024;
    case 128: return DkvSmem<128>::kBytes + 1024;
    default: return -1;
  }
}

// The same for kernel 6's wgmma kernel.
extern "C" int flash_dq_smem_bytes(int d) {
  switch (d) {
    case 16: return DqSmem<16>::kBytes + 1024;
    case 32: return DqSmem<32>::kBytes + 1024;
    case 64: return DqSmem<64>::kBytes + 1024;
    case 128: return DqSmem<128>::kBytes + 1024;
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
