// Poseidon2 (width 16, KoalaBear) kernels: the Merkle leaf sponge and the
// batched permutation.
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/):
//   - ops/poseidon2.py:333 hash_rows, ops/merkle.py:96 sponge_rows_traced and
//     ops/merkle.py:466 digest_layer_bitrev_scan (the XLA-fused sponge
//     over rate-8 column chunks, then a gather of the digest rows into
//     bit-reversed order) -> zkbf_p2_hash_rows;
//   - ops/poseidon2.py:279 permute / :350 compress, used by the tree walk
//     (ops/merkle.py:151) and the PoW grind (stark/challenger.py:136)
//     -> zkbf_p2_permute.
//
// What bounds it on the H100: arithmetic.  One permutation is ~490 modular
// multiplies (8 full rounds x 16 cubes, 13 partial rounds x (1 cube + 16
// diagonal products)) against 64 bytes of state, far above the card's
// ~5 integer multiplies per byte of memory traffic, so the leaf sponge at
// 2^21 x 31 (4 permutations per row) is bound by integer throughput, not
// by the 327 MB it moves.
//
// Design: one thread per row (or state); the 16-lane state stays in
// registers in Montgomery form (every loop over lanes is unrolled so no lane
// is indexed dynamically); round constants and the internal diagonal sit in
// __constant__ memory, which all threads of a warp read at the same address
// (a broadcast).  The S-box is x^3: two Montgomery products.  Inputs are
// converted to Montgomery form as they are absorbed and the outputs back to
// canonical form as they are stored.  With `bitrev`, thread i hashes row
// rev(i), so the digest layer comes out in committed order without a
// separate gather.  Rows are read by the thread that hashes them (a strided
// pattern across the warp); that is acceptable while the kernel is bound
// by arithmetic.
#include <cuda_runtime.h>

#include <cstdint>

#include "koalabear.cuh"

#define ZKBF_P2_MAX_MATS 8

namespace {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int ROUNDS_P = 13;

__constant__ uint32_t c_rc_ext[8][WIDTH];  // rounds 0..3 initial, 4..7 terminal
__constant__ uint32_t c_rc_int[ROUNDS_P];
__constant__ uint32_t c_diag[WIDTH];

struct Mats {
  const int32_t* ptr[ZKBF_P2_MAX_MATS];
  int width[ZKBF_P2_MAX_MATS];
  int count;
  int total_width;
};

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  return kb::mont_mul(kb::mont_mul(x, x), x);
}

__device__ __forceinline__ void external_linear(uint32_t s[WIDTH]) {
  uint32_t y[WIDTH];
#pragma unroll
  for (int b = 0; b < WIDTH; b += 4) {
    uint32_t a = s[b], bb = s[b + 1], c = s[b + 2], d = s[b + 3];
    uint32_t t_all = kb::add(kb::add(a, bb), kb::add(c, d));
    y[b] = kb::add(kb::add(t_all, a), kb::add(bb, bb));
    y[b + 1] = kb::add(kb::add(t_all, bb), kb::add(c, c));
    y[b + 2] = kb::add(kb::add(t_all, c), kb::add(d, d));
    y[b + 3] = kb::add(kb::add(t_all, d), kb::add(a, a));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t sum = kb::add(kb::add(y[j], y[4 + j]), kb::add(y[8 + j], y[12 + j]));
#pragma unroll
    for (int b = 0; b < WIDTH; b += 4) s[b + j] = kb::add(y[b + j], sum);
  }
}

__device__ __forceinline__ void external_round(uint32_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(kb::add(s[i], c_rc_ext[r][i]));
  external_linear(s);
}

// Montgomery-form state in, Montgomery-form state out.
__device__ __forceinline__ void permute_state(uint32_t s[WIDTH]) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_P; ++r) {
    s[0] = sbox(kb::add(s[0], c_rc_int[r]));
    uint32_t tot = s[0];
#pragma unroll
    for (int i = 1; i < WIDTH; ++i) tot = kb::add(tot, s[i]);
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = kb::add(kb::mont_mul(s[i], c_diag[i]), tot);
  }
#pragma unroll 1
  for (int r = 4; r < 8; ++r) external_round(s, r);
}

__device__ __forceinline__ uint32_t load_col(const Mats& m, size_t row, int col) {
  for (int k = 0; k < m.count; ++k) {
    if (col < m.width[k]) return (uint32_t)m.ptr[k][row * (size_t)m.width[k] + col];
    col -= m.width[k];
  }
  return 0;
}

__global__ void hash_rows_kernel(Mats mats, int32_t* __restrict__ out, int h, int log_h,
                                 int bitrev) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  size_t row = (bitrev && log_h > 0) ? (__brev((unsigned)i) >> (32 - log_h)) : (unsigned)i;
  uint32_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = 0;
  for (int start = 0; start < mats.total_width; start += RATE) {
#pragma unroll
    for (int j = 0; j < RATE; ++j) {
      if (start + j < mats.total_width) s[j] = kb::to_mont(load_col(mats, row, start + j));
    }
    permute_state(s);
  }
#pragma unroll
  for (int j = 0; j < RATE; ++j) out[(size_t)i * RATE + j] = (int32_t)kb::from_mont(s[j]);
}

__global__ void permute_kernel(const int32_t* __restrict__ states, int32_t* __restrict__ out,
                               int n, int out_cols) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = kb::to_mont((uint32_t)states[(size_t)i * WIDTH + j]);
  permute_state(s);
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    if (j < out_cols) out[(size_t)i * out_cols + j] = (int32_t)kb::from_mont(s[j]);
  }
}

}  // namespace

extern "C" int zkbf_p2_set_constants(const uint32_t* rc_ext, const uint32_t* rc_int,
                                     const uint32_t* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_rc_ext, rc_ext, sizeof(uint32_t) * 8 * WIDTH);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_rc_int, rc_int, sizeof(uint32_t) * ROUNDS_P);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_diag, diag, sizeof(uint32_t) * WIDTH);
  return (int)e;
}

extern "C" int zkbf_p2_hash_rows(const void* const* ptrs, const int* widths, int n_mats,
                                 void* out, int h, int log_h, int bitrev, void* stream) {
  if (n_mats < 1 || n_mats > ZKBF_P2_MAX_MATS) return (int)cudaErrorInvalidValue;
  Mats m;
  m.count = n_mats;
  m.total_width = 0;
  for (int k = 0; k < n_mats; ++k) {
    m.ptr[k] = static_cast<const int32_t*>(ptrs[k]);
    m.width[k] = widths[k];
    m.total_width += widths[k];
  }
  for (int k = n_mats; k < ZKBF_P2_MAX_MATS; ++k) {
    m.ptr[k] = nullptr;
    m.width[k] = 0;
  }
  const int threads = 128;
  hash_rows_kernel<<<(h + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      m, static_cast<int32_t*>(out), h, log_h, bitrev);
  return (int)cudaGetLastError();
}

extern "C" int zkbf_p2_permute(const void* states, void* out, int n, int out_cols,
                               void* stream) {
  const int threads = 128;
  permute_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(states), static_cast<int32_t*>(out), n, out_cols);
  return (int)cudaGetLastError();
}
