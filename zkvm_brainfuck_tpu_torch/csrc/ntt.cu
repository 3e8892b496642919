// Radix-2 DIT NTT kernels over KoalaBear, on (n, W) row-major int32 matrices
// of canonical values whose rows are already in bit-reversed order.
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/):
//   - ops/ntt_pallas.py:50 _stage_kernel (pallas_call at :72, wrapper
//     ntt_first_stages at :115): stages 1..k in one pass over each 2^k-row
//     block -> zkbf_ntt_block_stages;
//   - the loop body of ops/ntt.py:128-135 (ntt_traced), one butterfly stage
//     s over the whole matrix -> zkbf_ntt_stage, run for every s > k.
//
// Twiddles come from the blob layout of ops/ntt.py:56 (stage s at offset
// 2^(s-1)-1, length 2^(s-1), canonical).  Stage s pairs rows (j, j+half)
// of each 2^s-row group with twiddle tw[half-1+j]: u + v*t, u - v*t.
//
// What bounds it on the H100: memory.  A butterfly is one modular multiply
// and two adds per 8 bytes in and 8 bytes out, far below the card's integer
// rate per byte of HBM bandwidth.  So the block kernel's job is to run k = 10
// stages for one read and one write of the matrix, as the Pallas kernel did
// in VMEM.
//
// Design of the block kernel: the TPU kernel held a whole (1024, W) block in
// VMEM; 1024 x 31 x 4 B = 127 KB is above the 48 KB of static shared memory
// a block gets on Hopper, so each block takes 2^k rows x COLS_PER_BLOCK (8)
// columns (32 KB) and the grid's second axis walks the column tiles.  The
// 2^k - 1 twiddles of stages 1..k are converted to Montgomery form once per
// block into shared memory (4 KB), so each butterfly costs one Montgomery
// product giving the canonical v*t.  Every stage is one pass of the block's
// threads over its 2^(k-1) x 8 butterflies, separated by __syncthreads().
// n < 1024 (the small FRI and quotient heights) is the case k = log n, one
// block of n rows.
//
// The global stage is one thread per butterfly and column: consecutive
// threads take consecutive columns of a row, so loads are coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "koalabear.cuh"

namespace {

constexpr int COLS_PER_BLOCK = 8;
constexpr int BLOCK_THREADS = 256;

__global__ void block_stages_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                                    const int32_t* __restrict__ tw, int w, int k) {
  extern __shared__ uint32_t smem[];
  const int bk = 1 << k;
  uint32_t* tws = smem;              // bk - 1 twiddles (Montgomery form)
  uint32_t* data = smem + bk;        // bk rows x COLS_PER_BLOCK
  const size_t row0 = (size_t)blockIdx.x * bk;
  const int c0 = blockIdx.y * COLS_PER_BLOCK;
  const int cw = min(COLS_PER_BLOCK, w - c0);

  for (int i = threadIdx.x; i < bk - 1; i += blockDim.x) tws[i] = kb::to_mont((uint32_t)tw[i]);
  for (int i = threadIdx.x; i < bk * COLS_PER_BLOCK; i += blockDim.x) {
    int r = i / COLS_PER_BLOCK, c = i % COLS_PER_BLOCK;
    data[i] = c < cw ? (uint32_t)x[(row0 + r) * w + c0 + c] : 0u;
  }
  __syncthreads();

  const int n_bf = (bk >> 1) * COLS_PER_BLOCK;
  for (int s = 1; s <= k; ++s) {
    const int half = 1 << (s - 1);
    for (int i = threadIdx.x; i < n_bf; i += blockDim.x) {
      int c = i % COLS_PER_BLOCK;
      int bf = i / COLS_PER_BLOCK;
      int j = bf & (half - 1);
      int r0 = ((bf >> (s - 1)) << s) + j;
      uint32_t* pu = data + r0 * COLS_PER_BLOCK + c;
      uint32_t* pv = pu + half * COLS_PER_BLOCK;
      uint32_t u = *pu;
      uint32_t v = kb::mont_mul(*pv, tws[half - 1 + j]);
      *pu = kb::add(u, v);
      *pv = kb::sub(u, v);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < bk * COLS_PER_BLOCK; i += blockDim.x) {
    int r = i / COLS_PER_BLOCK, c = i % COLS_PER_BLOCK;
    if (c < cw) out[(row0 + r) * w + c0 + c] = (int32_t)data[i];
  }
}

__global__ void stage_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                             const int32_t* __restrict__ tw, size_t total, int w, int s) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t half = (size_t)1 << (s - 1);
  size_t c = i % w;
  size_t bf = i / w;
  size_t j = bf & (half - 1);
  size_t r0 = ((bf >> (s - 1)) << s) + j;
  size_t a = r0 * w + c;
  size_t b = a + half * w;
  uint32_t t = kb::to_mont((uint32_t)tw[half - 1 + j]);
  uint32_t u = (uint32_t)x[a];
  uint32_t v = kb::mont_mul((uint32_t)x[b], t);
  out[a] = (int32_t)kb::add(u, v);
  out[b] = (int32_t)kb::sub(u, v);
}

}  // namespace

// Stages 1..k of every 2^k-row block; n must be a multiple of 2^k, k <= 10.
extern "C" int zkbf_ntt_block_stages(const void* x, void* out, const void* tw, int n, int w,
                                     int k, void* stream) {
  if (k < 1 || k > 10 || n % (1 << k) != 0 || w < 1) return (int)cudaErrorInvalidValue;
  const int bk = 1 << k;
  dim3 grid(n / bk, (w + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK);
  size_t smem = sizeof(uint32_t) * ((size_t)bk + (size_t)bk * COLS_PER_BLOCK);
  block_stages_kernel<<<grid, BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
      static_cast<const int32_t*>(tw), w, k);
  return (int)cudaGetLastError();
}

// One stage s over the whole (n, w) matrix, out of place.
extern "C" int zkbf_ntt_stage(const void* x, void* out, const void* tw, int n, int w, int s,
                              void* stream) {
  if (s < 1 || (1 << s) > n || w < 1) return (int)cudaErrorInvalidValue;
  size_t total = (size_t)(n / 2) * w;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  stage_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
      static_cast<const int32_t*>(tw), total, w, s);
  return (int)cudaGetLastError();
}
