// The running sum of the LogUp trace as the port computed it before the
// fused kernel (csrc/logup.cu): a separate, three-pass mod-p scan of column
// NB of an (N, NB+1, 4) trace whose column NB holds the row sums, in place.
// Kept only for zkvm_brainfuck_tpu_torch/probes/tree_logup_variants.py,
// which times it after the entries-only copy of csrc/logup.cu (FUSED_SCAN
// 0) beside the fused kernel; nothing on the main path builds it.
//
// Each thread carries the four components of its rows as one uint4 (a
// 16-byte load per row).  (1) Each block scans a tile of 1024 rows (4 per
// thread, then warp shuffles, then the 8 warp totals) and writes its total;
// (2) one block scans the tile totals; (3) every tile but the first adds the
// total of the tiles before it.  It moves 2 x 16 bytes a row; the rows of
// the column lie (NB+1) x 16 bytes apart, so every load is its own sector.
#include <cuda_runtime.h>

#include <cstdint>

#include "koalabear.cuh"

namespace {

constexpr int SCAN_THREADS = 256;  // 8 warps
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(kb::add(a.x, b.x), kb::add(a.y, b.y), kb::add(a.z, b.z), kb::add(a.w, b.w));
}

__device__ __forceinline__ uint4 sub4(uint4 a, uint4 b) {
  return make_uint4(kb::sub(a.x, b.x), kb::sub(a.y, b.y), kb::sub(a.z, b.z), kb::sub(a.w, b.w));
}

__device__ __forceinline__ uint4 shfl_up4(uint4 v, int off) {
  return make_uint4(__shfl_up_sync(0xffffffffu, v.x, off), __shfl_up_sync(0xffffffffu, v.y, off),
                    __shfl_up_sync(0xffffffffu, v.z, off), __shfl_up_sync(0xffffffffu, v.w, off));
}

// Inclusive scan (mod p, componentwise) of `count` <= SCAN_TILE EF4 values
// at data[i * stride], in place, plus `carry`; returns the sum of the values
// (without the carry).  Every thread of the block must call it.
__device__ uint4 block_scan(uint4* data, size_t stride, int count, uint4 carry, uint4* s_warp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 v[SCAN_ITEMS], run = zero;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int idx = t * SCAN_ITEMS + j;
    run = add4(run, idx < count ? data[idx * stride] : zero);
    v[j] = run;
  }
  uint4 incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint4 y = shfl_up4(incl, off);
    if (lane >= off) incl = add4(incl, y);
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint4 wv = lane < SCAN_THREADS / 32 ? s_warp[lane] : zero;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint4 y = shfl_up4(wv, off);
      if (lane >= off) wv = add4(wv, y);
    }
    if (lane < SCAN_THREADS / 32) s_warp[lane] = wv;
  }
  __syncthreads();
  const uint4 before = add4(add4(sub4(incl, run), warp > 0 ? s_warp[warp - 1] : zero), carry);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int idx = t * SCAN_ITEMS + j;
    if (idx < count) data[idx * stride] = add4(before, v[j]);
  }
  const uint4 total = s_warp[SCAN_THREADS / 32 - 1];
  __syncthreads();  // s_warp is reused by the next call
  return total;
}

// Pass 1: scan each tile of column nb; write the tile totals.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles_kernel(uint4* perm, int n, int nb, uint4* totals) {
  __shared__ uint4 s_warp[SCAN_THREADS / 32];
  const size_t stride = (size_t)nb + 1;
  const size_t row0 = (size_t)blockIdx.x * SCAN_TILE;
  const int count = (int)min((size_t)SCAN_TILE, (size_t)n - row0);
  const uint4 total = block_scan(perm + row0 * stride + nb, stride, count,
                                 make_uint4(0u, 0u, 0u, 0u), s_warp);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Pass 2: inclusive scan of the tile totals, in one block.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_totals_kernel(uint4* totals, int n_tiles) {
  __shared__ uint4 s_warp[SCAN_THREADS / 32];
  uint4 carry = make_uint4(0u, 0u, 0u, 0u);
  for (int c0 = 0; c0 < n_tiles; c0 += SCAN_TILE) {
    const int count = min(SCAN_TILE, n_tiles - c0);
    carry = add4(carry, block_scan(totals + c0, 1, count, carry, s_warp));
  }
}

// Pass 3: add the total of all earlier tiles to every row of tile >= 1.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_carry_kernel(uint4* perm, int n, int nb, const uint4* totals) {
  const int tile = blockIdx.x + 1;
  const uint4 carry = totals[tile - 1];
  const size_t stride = (size_t)nb + 1;
  const size_t row0 = (size_t)tile * SCAN_TILE;
  for (int j = threadIdx.x; j < SCAN_TILE; j += blockDim.x) {
    const size_t row = row0 + j;
    if (row < (size_t)n) perm[row * stride + nb] = add4(perm[row * stride + nb], carry);
  }
}


}  // namespace

// In-place inclusive scan of column nb of an (n, nb+1, 4) trace (each EF4
// value is 16 bytes, so the column is read as uint4).  totals: scratch of
// 4 * ceil(n / 1024) int32.
extern "C" int zkbf_logup_scan(void* perm, int n, int nb, void* totals, void* stream) {
  if (n < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  cudaStream_t s = (cudaStream_t)stream;
  uint4* p = static_cast<uint4*>(perm);
  uint4* t = static_cast<uint4*>(totals);
  scan_tiles_kernel<<<n_tiles, SCAN_THREADS, 0, s>>>(p, n, nb, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 1) return (int)err;
  scan_totals_kernel<<<1, SCAN_THREADS, 0, s>>>(t, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_carry_kernel<<<n_tiles - 1, SCAN_THREADS, 0, s>>>(p, n, nb, t);
  return (int)cudaGetLastError();
}
