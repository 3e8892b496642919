// Poseidon2 (width 16, KoalaBear) kernels: the Merkle leaf sponge, the
// Merkle tree walk and the batched permutation.
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/):
//   - ops/poseidon2.py:333 hash_rows, ops/merkle.py:96 sponge_rows_traced and
//     ops/merkle.py:466 digest_layer_bitrev_scan (the XLA-fused sponge
//     over rate-8 column chunks, then a gather of the digest rows into
//     bit-reversed order) -> zkbf_p2_hash_rows;
//   - ops/merkle.py:151 build_tree_traced, over ops/poseidon2.py:279 permute
//     and :350 compress (one permutation batch per tree level, and one more
//     per compress-and-inject level) -> zkbf_p2_tree;
//   - ops/poseidon2.py:279 permute, used by the PoW grind
//     (stark/challenger.py:136) -> zkbf_p2_permute.
//
// What bounds them on the H100: integer operations.  One permutation is at
// least 4,561 integer instructions (373 Montgomery products, 1,348 modular
// additions; chip_smoke.py P2_INSTR_PER_PERM) against 64 bytes of state, far
// above the card's ~3 instructions per byte of memory traffic.  A prove's
// trees, though, are mostly small levels: a 2^L-leaf tree has L levels, and
// the FRI trees and the top of every large tree have too few nodes to fill
// 132 SMs.  Walked one launch per level, each such level costs a launch
// plus one thread's whole dependent chain, ~289 launches a prove.
// And a permutation needs every warp it can get: on an NVIDIA H100 80GB
// HBM3 at 700 W, permute_kernel (32 registers, 64 warps an SM) runs at 85 %
// of its bound, while the same permutations with fewer warps, or in blocks
// that wait for each other's levels, run slower (PERF.md).
//
// Design.
// - permute_state: one thread holds the 16 lanes of a state in registers in
//   Montgomery form (every loop over lanes unrolled, so no lane is indexed
//   dynamically); the external layers apply M4 as Plonky3's apply_mat4 (9
//   additions, 2 doublings) and the internal diagonal as doublings, halvings
//   and 7 products by +-2^-k: the least count above, 12 % fewer than
//   15-addition M4s and 16 diagonal products.  Round constants sit in __constant__ memory, which a
//   warp reads at one address (a broadcast).  The S-box x^3 is two products.
// - hash_rows_kernel: one thread per row.  With `bitrev`, thread i hashes row
//   rev(i), so the digest layer comes out in committed order.
// - The tree walk (zkbf_p2_tree), compress-and-inject included, in at most
//   two launches:
//   - bulk_kernel, for a tree whose level 1 has at least 2^17 nodes: thread
//     t walks the 4-leaf subtree t (levels 1 and 2, three quarters of the
//     tree's permutations; level 1 alone while level 2 has fewer than 2^17
//     nodes) on its own, reading its level-1 nodes back from the flat
//     buffer, with no barrier and no shared memory, capped at 32 registers
//     so that 64 warps share an SM as in permute_kernel;
//   - tree_kernel, the remaining levels in one launch: a block of 256
//     threads takes a subtree of 2^9 nodes and writes its 9 levels, keeping
//     each level in shared memory for the next; then it counts itself in at
//     its parent stage (an atomic per group of 2^5 subtrees), and the last
//     block of a group to arrive walks that group's next 5 levels, and so
//     on to the root.  No block waits, and the levels above the subtrees
//     need no launch of their own.  A level of n nodes within a block runs
//     one state per thread when n >= TREE_CROSSOVER, and otherwise
//     spreads each permutation over 16 lanes (permute_lanes): lane j holds
//     state[j], the S-boxes run in parallel, M4 runs within each group of 4
//     lanes, and the column sums and the internal round's sum are
//     __shfl_xor_sync butterflies.
//   The crossover (32 nodes), the bulk pass's two levels and the register
//   caps were chosen on an NVIDIA H100 80GB HBM3 at 700 W with
//   zkvm_brainfuck_tpu_torch/probes/tree_logup_variants.py (PERF.md), which
//   builds copies of this file with other values of these constants.
// - permute_kernel: one thread per state (the grind's candidates).
//
// Inputs are canonical; each kernel converts to Montgomery form as it loads
// and back as it stores.
#include <cuda_runtime.h>

#include <cstdint>

#include "koalabear.cuh"

#define ZKBF_P2_MAX_MATS 8
#define ZKBF_TREE_MAX_LEVELS 30
#define ZKBF_TREE_MAX_STAGES 8

namespace {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int ROUNDS_P = 13;
constexpr unsigned FULL = 0xffffffffu;

__constant__ uint32_t c_rc_ext[8][WIDTH];  // rounds 0..3 initial, 4..7 terminal
__constant__ uint32_t c_rc_int[ROUNDS_P];
__constant__ uint32_t c_diag[WIDTH];

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  return kb::mont_mul(kb::mont_mul(x, x), x);
}

__device__ __forceinline__ uint32_t dbl(uint32_t a) { return kb::add(a, a); }

// a / 2 mod p (also in Montgomery form: halving is linear).
__device__ __forceinline__ uint32_t halve(uint32_t a) { return (a & 1u) ? (a + kb::P) >> 1 : a >> 1; }

// The HorizenLabs M4 [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] as Plonky3's
// apply_mat4: 9 additions and 2 doublings.
__device__ __forceinline__ void mat4(uint32_t& x0, uint32_t& x1, uint32_t& x2, uint32_t& x3) {
  using kb::add;
  const uint32_t t01 = add(x0, x1), t23 = add(x2, x3), t0123 = add(t01, t23);
  const uint32_t t01123 = add(t0123, x1), t01233 = add(t0123, x3);
  const uint32_t y0 = add(t01123, t01);
  const uint32_t y1 = add(t01123, dbl(x2));
  const uint32_t y2 = add(t01233, t23);
  const uint32_t y3 = add(t01233, dbl(x0));
  x0 = y0;
  x1 = y1;
  x2 = y2;
  x3 = y3;
}

__device__ __forceinline__ void external_linear(uint32_t s[WIDTH]) {
#pragma unroll
  for (int b = 0; b < WIDTH; b += 4) mat4(s[b], s[b + 1], s[b + 2], s[b + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sum = kb::add(kb::add(s[j], s[4 + j]), kb::add(s[8 + j], s[12 + j]));
#pragma unroll
    for (int b = 0; b < WIDTH; b += 4) s[b + j] = kb::add(s[b + j], sum);
  }
}

__device__ __forceinline__ void external_round(uint32_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(kb::add(s[i], c_rc_ext[r][i]));
  external_linear(s);
}

// s_i <- sum + d_i s_i for the diagonal d = [-2, 1, 2, 1/2, 3, 4, -1/2, -3,
// -4, 2^-8, 2^-3, 2^-24, -2^-8, -2^-3, -2^-4, -2^-24]: doublings and
// halvings for the first nine, products by c_diag for the last seven.
__device__ __forceinline__ void internal_round(uint32_t s[WIDTH], int r) {
  using kb::add;
  using kb::sub;
  s[0] = sbox(add(s[0], c_rc_int[r]));
  const uint32_t tot =
      add(add(add(add(s[0], s[1]), add(s[2], s[3])), add(add(s[4], s[5]), add(s[6], s[7]))),
          add(add(add(s[8], s[9]), add(s[10], s[11])), add(add(s[12], s[13]), add(s[14], s[15]))));
  s[0] = sub(tot, dbl(s[0]));
  s[1] = add(tot, s[1]);
  s[2] = add(tot, dbl(s[2]));
  s[3] = add(tot, halve(s[3]));
  s[4] = add(tot, add(dbl(s[4]), s[4]));
  s[5] = add(tot, dbl(dbl(s[5])));
  s[6] = sub(tot, halve(s[6]));
  s[7] = sub(tot, add(dbl(s[7]), s[7]));
  s[8] = sub(tot, dbl(dbl(s[8])));
#pragma unroll
  for (int i = 9; i < WIDTH; ++i) s[i] = add(tot, kb::mont_mul(s[i], c_diag[i]));
}

// Montgomery-form state in, Montgomery-form state out.
__device__ __forceinline__ void permute_state(uint32_t s[WIDTH]) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_P; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = 4; r < 8; ++r) external_round(s, r);
}

// The external linear layer over a 16-lane group: lane j holds state[j].
// M4 row q of a group of 4 is sum4 + x_q + 2 x_(q+1); then each lane adds
// the sum of its column over the 4 groups.
__device__ __forceinline__ uint32_t external_linear_lanes(uint32_t x) {
  using kb::add;
  const int lane = threadIdx.x & 31;
  const uint32_t s2 = add(x, __shfl_xor_sync(FULL, x, 1));
  const uint32_t s4 = add(s2, __shfl_xor_sync(FULL, s2, 2));
  const uint32_t next = __shfl_sync(FULL, x, (lane & ~3) | ((lane + 1) & 3));
  const uint32_t y = add(add(s4, x), dbl(next));
  uint32_t c = add(y, __shfl_xor_sync(FULL, y, 4));
  c = add(c, __shfl_xor_sync(FULL, c, 8));
  return add(y, c);
}

// One permutation spread over the 16 lanes of a half warp; lane j = its
// index in the group holds state[j] (Montgomery form).  rc: the external
// round constants [8][16] in shared memory; dg: this lane's diagonal entry.
// Every lane of the warp must call it (the shuffles name all 32).
__device__ __forceinline__ uint32_t permute_lanes(uint32_t x, const uint32_t* rc, uint32_t dg, int j) {
  using kb::add;
  x = external_linear_lanes(x);
#pragma unroll
  for (int r = 0; r < 4; ++r) x = external_linear_lanes(sbox(add(x, rc[r * WIDTH + j])));
#pragma unroll
  for (int r = 0; r < ROUNDS_P; ++r) {
    const uint32_t t = sbox(add(x, c_rc_int[r]));
    x = j == 0 ? t : x;
    uint32_t tot = add(x, __shfl_xor_sync(FULL, x, 1));
    tot = add(tot, __shfl_xor_sync(FULL, tot, 2));
    tot = add(tot, __shfl_xor_sync(FULL, tot, 4));
    tot = add(tot, __shfl_xor_sync(FULL, tot, 8));
    x = add(kb::mont_mul(x, dg), tot);
  }
#pragma unroll
  for (int r = 4; r < 8; ++r) x = external_linear_lanes(sbox(add(x, rc[r * WIDTH + j])));
  return x;
}

struct Mats {
  const int32_t* ptr[ZKBF_P2_MAX_MATS];
  int width[ZKBF_P2_MAX_MATS];
  int count;
  int total_width;
};

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

// ---------------------------------------------------------------------------
// The tree walk
// ---------------------------------------------------------------------------

constexpr int TREE_THREADS = 256;
constexpr int TREE_MIN_BLOCKS = 4;  // blocks an SM (caps the registers)
constexpr int TREE_BLOCK_LEVELS = 9;  // a stage-0 block: 2^9 nodes -> 1
constexpr int TREE_STAGE_LEVELS = 5;  // a later stage: 2^5 nodes -> 1
constexpr int TREE_NODES = TREE_THREADS;  // widest level a block holds
constexpr int BULK_THREADS = 128;
constexpr int BULK_MIN_BLOCKS = 16;       // blocks an SM (caps the registers)
constexpr int BULK_LEVELS = 2;            // levels a bulk thread walks, at most
constexpr int BULK_MIN_LOG_THREADS = 17;  // the bulk pass runs while it has 2^17 threads
constexpr int TREE_CROSSOVER = 32;  // levels of fewer nodes take 16 lanes a state (1..TREE_NODES)
static_assert(TREE_CROSSOVER >= 1 && TREE_CROSSOVER <= TREE_NODES, "crossover");
// Shared memory: the external round constants and the diagonal (9 x 16
// words), two level buffers of TREE_NODES digests, and the block's flag.
constexpr int TREE_SMEM_WORDS = 9 * WIDTH + 2 * TREE_NODES * 8 + 4;

struct Tree {
  const int32_t* leaves;  // (max_h, 8): the digest layer
  int log_max;
  int base;               // levels 1..base are the bulk pass's
  int32_t* flat;          // (flat_len, 8): the digest layer, then levels 1..log_max
  int* counters;          // one per unit of stages 1.., zero at launch
  long long level_off[ZKBF_TREE_MAX_LEVELS + 1];
  const int32_t* inject[ZKBF_TREE_MAX_LEVELS + 1];  // (max_h >> i, 8) or null
  int top[ZKBF_TREE_MAX_STAGES];                    // highest level of each stage
  int counter_off[ZKBF_TREE_MAX_STAGES];
  int n_stages;
};

// s[8..15] <- row `row` of the (., 8) canonical digests `inj`, in Montgomery form.
__device__ __forceinline__ void inject_row(uint32_t s[WIDTH], const int32_t* inj, size_t row) {
  const uint4* ir = reinterpret_cast<const uint4*>(inj) + 2 * row;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 v = __ldg(ir + q);
    s[8 + 4 * q] = kb::to_mont(v.x);
    s[9 + 4 * q] = kb::to_mont(v.y);
    s[10 + 4 * q] = kb::to_mont(v.z);
    s[11 + 4 * q] = kb::to_mont(v.w);
  }
}

// Row `row` of the (., 8) int32 buffer `dst` <- s[0..7], canonical.
__device__ __forceinline__ void store_row(int32_t* dst, size_t row, const uint32_t s[WIDTH]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
    reinterpret_cast<uint4*>(dst)[2 * row + q] =
        make_uint4(kb::from_mont(s[4 * q]), kb::from_mont(s[4 * q + 1]),
                   kb::from_mont(s[4 * q + 2]), kb::from_mont(s[4 * q + 3]));
}

// s <- node t: the permutation of rows 2t and 2t+1 of `in` (canonical;
// global memory read through L2 when GLOBAL, else shared), compressed with
// row t of `inj` where it is set; Montgomery form, the digest in s[0..7].
template <bool GLOBAL>
__device__ __forceinline__ void hash_pair(uint32_t s[WIDTH], const uint32_t* in, size_t t,
                                          const int32_t* inj) {
  const uint4* src = reinterpret_cast<const uint4*>(in) + 4 * t;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = GLOBAL ? __ldcg(src + q) : src[q];
    s[4 * q] = kb::to_mont(v.x);
    s[4 * q + 1] = kb::to_mont(v.y);
    s[4 * q + 2] = kb::to_mont(v.z);
    s[4 * q + 3] = kb::to_mont(v.w);
  }
  permute_state(s);
  if (inj) {
    inject_row(s, inj, t);
    permute_state(s);
  }
}

// One level of n nodes: node t permutes rows 2t and 2t+1 of `in` (canonical;
// global memory written earlier in this launch when GLOBAL, read through L2,
// else shared) and, where `inj` is set, is compressed with row t of it; its
// canonical digest goes to row t of `out` (shared) and of `dst` (global).
// Every thread of the block must call it.
template <bool GLOBAL>
__device__ void tree_level(const uint32_t* in, uint32_t* out, int32_t* dst, const int32_t* inj,
                           int n, const uint32_t* s_rc) {
  if (n >= TREE_CROSSOVER) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      uint32_t s[WIDTH];
      hash_pair<GLOBAL>(s, in, t, inj);
      store_row(dst, t, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[8 * t + j] = kb::from_mont(s[j]);
    }
    return;
  }
  const int j = threadIdx.x & 15;
  const int group = threadIdx.x >> 4;
  const int warp_first = (threadIdx.x >> 5) * 2;  // first group of this warp
  const int groups = blockDim.x >> 4;
  const uint32_t dg = s_rc[8 * WIDTH + j];
  for (int t0 = 0; t0 + warp_first < n; t0 += groups) {  // uniform over the warp
    const bool live = t0 + group < n;
    const int t = live ? t0 + group : n - 1;
    const uint32_t* src = in + 16 * (size_t)t + j;
    uint32_t x = permute_lanes(kb::to_mont(GLOBAL ? __ldcg(src) : *src), s_rc, dg, j);
    if (inj) {
      const uint32_t y = j < 8 ? x : kb::to_mont((uint32_t)inj[8 * (size_t)t + j - 8]);
      x = permute_lanes(y, s_rc, dg, j);
    }
    if (live && j < 8) {
      const uint32_t v = kb::from_mont(x);
      out[8 * t + j] = v;
      dst[8 * (size_t)t + j] = (int32_t)v;
    }
  }
}

// Levels lo+1..hi of the subtree whose level-lo nodes are rows
// [node0 << (hi - lo), (node0 + 1) << (hi - lo)) of `in` (global).
// [node0 << (hi - lo), (node0 + 1) << (hi - lo)) of `in` (global).
__device__ void tree_levels(const Tree& tr, const uint32_t* in, int lo, int hi, size_t node0,
                            uint32_t* buf0, uint32_t* buf1, const uint32_t* s_rc) {
  const uint32_t* prev = in;
  for (int lv = lo + 1; lv <= hi; ++lv) {
    const int n = 1 << (hi - lv);
    const size_t first = node0 << (hi - lv);
    uint32_t* out = (lv & 1) ? buf0 : buf1;
    int32_t* dst = tr.flat + (tr.level_off[lv] + first) * 8;
    const int32_t* inj = tr.inject[lv] ? tr.inject[lv] + first * 8 : nullptr;
    if (prev == in) {
      tree_level<true>(prev, out, dst, inj, n, s_rc);
    } else {
      tree_level<false>(prev, out, dst, inj, n, s_rc);
    }
    __syncthreads();
    prev = out;
  }
}

// Node `idx` of level `lv`: the permutation of rows 2 idx and 2 idx + 1 of
// `in` (canonical), compressed with row idx of the level's injected digests
// if it has them, to row idx of level lv of the flat buffer.
__device__ __forceinline__ void hash_node(const Tree& tr, int lv, unsigned idx, const int32_t* in) {
  uint32_t s[WIDTH];
  hash_pair<true>(s, reinterpret_cast<const uint32_t*>(in), idx, tr.inject[lv]);
  store_row(tr.flat + tr.level_off[lv] * 8, idx, s);
}

// The bulk pass: the digest layer copied into the flat buffer, and levels
// 1..base, where thread t walks the 2^base-leaf subtree t on its own, in
// post-order, reading each node's children back from the flat buffer (its
// own writes).  No barrier, no shared memory: every warp runs as the
// batched permute_kernel does.
__global__ void __launch_bounds__(BULK_THREADS, BULK_MIN_BLOCKS) bulk_kernel(Tree tr) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;  // < 2^(30 - base)
  const uint4* leaves = reinterpret_cast<const uint4*>(tr.leaves);
  uint4* flat = reinterpret_cast<uint4*>(tr.flat);
  for (size_t i = t; i < ((size_t)2 << tr.log_max); i += (size_t)gridDim.x * blockDim.x)
    flat[i] = leaves[i];
  const int m = tr.base;
  if (t >= (1u << (tr.log_max - m))) return;
  for (int k = 0; k < (1 << (m - 1)); ++k) {
    unsigned idx = (t << (m - 1)) + k;
    hash_node(tr, 1, idx, tr.leaves);
    for (int lv = 2; lv <= m && (idx & 1); ++lv) {
      idx >>= 1;
      hash_node(tr, lv, idx, tr.flat + tr.level_off[lv - 1] * 8);
    }
  }
}

__global__ void __launch_bounds__(TREE_THREADS, TREE_MIN_BLOCKS) tree_kernel(Tree tr) {
  extern __shared__ uint4 tree_smem[];
  uint32_t* s_rc = reinterpret_cast<uint32_t*>(tree_smem);  // [8][16] rc, then [16] diagonal
  uint32_t* buf0 = s_rc + 9 * WIDTH;
  uint32_t* buf1 = buf0 + TREE_NODES * 8;
  int* s_last = reinterpret_cast<int*>(buf1 + TREE_NODES * 8);
  for (int i = threadIdx.x; i < 9 * WIDTH; i += blockDim.x)
    s_rc[i] = i < 8 * WIDTH ? c_rc_ext[i / WIDTH][i % WIDTH] : c_diag[i - 8 * WIDTH];

  // Stage 0: this block's 2^g level-`base` nodes, then the next g levels of
  // their subtree.  Without a bulk pass (base 0) the nodes are the digest
  // layer, which the block also copies into the flat buffer.
  const int b = tr.base, g = tr.top[0] - b;
  size_t unit = blockIdx.x;
  const uint32_t* first;
  if (b == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(tr.leaves) + (unit << g) * 2;
    uint4* dst = reinterpret_cast<uint4*>(tr.flat) + (unit << g) * 2;
    for (int i = threadIdx.x; i < (2 << g); i += blockDim.x) dst[i] = src[i];
    first = reinterpret_cast<const uint32_t*>(tr.leaves) + (unit << g) * 8;
  } else {
    first = reinterpret_cast<const uint32_t*>(tr.flat) + (tr.level_off[b] + (unit << g)) * 8;
  }
  __syncthreads();
  tree_levels(tr, first, b, tr.top[0], unit, buf0, buf1, s_rc);

  // Later stages: the last of a group's 2^g blocks to finish walks the
  // group's next g levels from the nodes the others wrote.
  for (int s = 1; s < tr.n_stages; ++s) {
    const int lo = tr.top[s - 1], hi = tr.top[s], g = hi - lo;
    const size_t parent = unit >> g;
    __threadfence();  // this block's level writes, before its arrival
    __syncthreads();
    if (threadIdx.x == 0)
      *s_last = atomicAdd(tr.counters + tr.counter_off[s] + parent, 1) == (1 << g) - 1;
    __syncthreads();
    if (!*s_last) return;
    __threadfence();  // the other blocks' writes, before this block reads them
    unit = parent;
    tree_levels(tr,
                reinterpret_cast<const uint32_t*>(tr.flat) + (tr.level_off[lo] + (unit << g)) * 8,
                lo, hi, unit, buf0, buf1, s_rc);
  }
}

}  // namespace

// The library links the CUDA runtime statically, so its current device is its
// own: the Python wrappers set it to the tensors' device before a launch.
extern "C" int zkbf_set_device(int device) { return (int)cudaSetDevice(device); }

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

// The flat level buffer of a 2^log_max-leaf tree in at most two launches.
// leaves: (2^log_max, 8) digests; flat: (flat_len, 8) output, level i at row
// level_off[i] (level_off[0] = 0); inject[i] (i = 1..log_max): the
// (2^(log_max - i), 8) digests compressed into level i, or null; counters:
// scratch of n_counters ints (the walk needs at most 2^(log_max - 13) + 8),
// zeroed here on the stream.  All digests canonical, 16-byte aligned.  A
// tree whose level 1 has at least 2^17 nodes first runs the bulk pass over
// its levels 1..2 (level 1 alone while level 2 has fewer than 2^17 nodes);
// tree_kernel walks the rest.
extern "C" int zkbf_p2_tree(const void* leaves, void* flat, void* counters, int n_counters,
                            const long long* level_off, const void* const* inject, int log_max,
                            void* stream) {
  if (log_max < 0 || log_max > ZKBF_TREE_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Tree tr;
  tr.leaves = static_cast<const int32_t*>(leaves);
  tr.flat = static_cast<int32_t*>(flat);
  tr.counters = static_cast<int*>(counters);
  tr.log_max = log_max;
  for (int i = 0; i <= ZKBF_TREE_MAX_LEVELS; ++i) {
    tr.level_off[i] = i <= log_max ? level_off[i] : 0;
    tr.inject[i] = (i >= 1 && i <= log_max) ? static_cast<const int32_t*>(inject[i]) : nullptr;
  }
  int m = log_max - BULK_MIN_LOG_THREADS;
  tr.base = m < 0 ? 0 : (m > BULK_LEVELS ? BULK_LEVELS : m);
  tr.n_stages = 1;
  tr.top[0] = log_max - tr.base < TREE_BLOCK_LEVELS ? log_max : tr.base + TREE_BLOCK_LEVELS;
  tr.counter_off[0] = 0;
  int need = 0;
  while (tr.top[tr.n_stages - 1] < log_max) {
    if (tr.n_stages == ZKBF_TREE_MAX_STAGES) return (int)cudaErrorInvalidValue;
    const int top = tr.top[tr.n_stages - 1] + TREE_STAGE_LEVELS;
    tr.top[tr.n_stages] = top < log_max ? top : log_max;
    tr.counter_off[tr.n_stages] = need;
    need += 1 << (log_max - tr.top[tr.n_stages]);
    ++tr.n_stages;
  }
  if (need > n_counters) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (need > 0) {
    const cudaError_t e = cudaMemsetAsync(counters, 0, sizeof(int) * (size_t)need, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (tr.base > 0) {
    const int threads = 1 << (log_max - tr.base);
    bulk_kernel<<<(threads + BULK_THREADS - 1) / BULK_THREADS, BULK_THREADS, 0, s>>>(tr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  tree_kernel<<<1 << (log_max - tr.top[0]), TREE_THREADS, sizeof(uint32_t) * TREE_SMEM_WORDS, s>>>(tr);
  return (int)cudaGetLastError();
}
