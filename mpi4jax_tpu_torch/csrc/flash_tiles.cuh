// flash_tiles.cuh: the tile walks of the flash kernels (csrc/flash_fwd.cu,
// csrc/flash_bwd.cu), which tiles a block of rows visits under causal
// masking at global positions.  Plain C++ as well as CUDA, so that
// tests/test_torch_flash_tiles.py builds it with g++ and holds it to its
// Python model.

#pragma once

#ifdef __CUDACC__
#define FLASH_TILE_FN __host__ __device__ __forceinline__
#else
#define FLASH_TILE_FN inline
#endif

// Number of k tiles of width bk that a block of bq query rows starting at
// local row q0 must visit: all of them, or causally up to the last one whose
// first key some row of the block sees.
FLASH_TILE_FN int tiles_to_visit(int tk, int bk, int bq, long long q_off,
                                 int q0, long long k_off, int causal) {
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
FLASH_TILE_FN int first_q_tile(int tq, int bq, long long q_off, int k0,
                               long long k_off, int causal) {
  const int nq = (tq + bq - 1) / bq;
  if (!causal) return 0;
  const long long first = k_off + k0 - q_off;  // first query that sees k0
  if (first <= 0) return 0;
  if (first >= tq) return nq;
  return (int)(first / bq);
}
