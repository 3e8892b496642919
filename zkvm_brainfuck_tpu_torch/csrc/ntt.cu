// Radix-2 DIT NTT over KoalaBear on (n, W) row-major int32 matrices of
// canonical values, n = 2^L, in two kinds of pass.
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/):
//   - ops/ntt_pallas.py:50 _stage_kernel (pallas_call at :72, wrapper
//     ntt_first_stages at :115): stages 1..k (k <= 10) inside every 2^k-row
//     block -> zkbf_ntt_block_stages, which also does the bit reversal of
//     ops/ntt.py:114 ntt_traced and the coefficient scale and zero padding
//     of ops/ntt.py:191 coset_lde and stark/pcs.py:154 _lde_traced;
//   - the stage loop of ntt_traced (ops/ntt.py:128-135), stages k+1..L
//     -> zkbf_ntt_stage, all of them in one pass (up to PASS_LOG_MAX).
//
// The transform: stage s pairs rows R and R + 2^(s-1) (bit s-1 of R clear)
// with twiddle tw_s[R mod 2^(s-1)], tw_s[j] = w_s^j: the blob of ops/ntt.py
// (stage s at offset 2^(s-1) - 1), here in Montgomery form (w * 2^32 mod p)
// so that one Montgomery product gives the canonical v * w.  Stage 1 reads
// the input in bit-reversed row order, so the output is in natural order.
//
// What bounds it on the H100.  Each pass reads and writes the matrix once,
// which at 2^21 x 31 is 0.155 ms of HBM time; the butterflies (one
// Montgomery product, about 5 integer instructions, and two modular
// additions, about 2 each) of 10 or 11 stages are 0.17-0.19 ms of integer
// instructions.  So both passes are near the line, and the design keeps all of a
// pass's stages on chip:
//   - A block takes 2^M rows of one 8-word tile and runs M stages on them:
//     each thread holds 2^M1 values of one lane in registers and runs M1
//     stages with no exchange (radix 2^M1), writes them to shared memory
//     once (value j at j + (j >> M1), a lane stride of 4 mod 32, so neither
//     side has bank conflicts), and after one __syncthreads() takes 2^M2
//     values at stride 2^M1 for the other M2 stages.  10 stages cost one
//     barrier, not 10.  2^11 rows x 8 words is 66 KB of dynamic shared
//     memory.  Index arithmetic is shifts and masks; bit reversal is __brev.
//   - Block pass: block g takes output rows (rev(g) << k) + j, read from
//     input rows (rev_k(j) << (L - k)) + g, so consecutive blocks read
//     adjacent rows; its 8-column tiles are consecutive blocks.  The reads
//     are 32-byte runs of rows far apart, one sector-aligned only when W is
//     a multiple of 8, so the pass is bound by its scattered reads more
//     than by the arithmetic.  The loads go straight to registers, where
//     the first M1 stages run: up to 2^M1 independent loads in flight per
//     thread do what cp.async staging into shared memory would, without
//     an extra round trip through it.  Its twiddles
//     are the first 2^k - 1 of the blob (L1-resident), the same for every
//     thread in the first M1 stages.  For an LDE's forward transform it
//     takes the n coefficients of the 2n-row input and a per-row factor
//     table (n^-1 * shift^i): rows >= n are never loaded, and each loaded
//     value is scaled as it arrives, so the inverse transform skips its
//     n^-1 and the LDE has no pass of its own for scale or padding.
//   - Stage pass: residue b < 2^k owns rows b + (j << k).  A block takes
//     g adjacent residues, g * W a multiple of 8 words, so each 8-word tile
//     is one aligned sector at every row it touches.  The twiddle of stage
//     s at row b + (m << k) is w_s^b * w_(s-k)^m: a per-residue factor
//     times an entry of the small tables (L1-resident) rather than a
//     scattered read of the 8 MB blob.  It runs in place.
// Values are kept canonical (2p < 2^32 leaves no room for a lazy sum).
// Tensor cores are not used: a radix-2 butterfly over a 31-bit prime field
// has no tensor-core form that pays at these widths.
#include <cuda_runtime.h>

#include <cstdint>

#include "koalabear.cuh"

namespace {

constexpr int COLS = 8;            // words of a tile: 32 bytes, one sector
constexpr int BLOCK_LOG_MAX = 10;  // stages of the block pass
constexpr int PASS_LOG_MAX = 12;   // stages of one stage pass (128 KB of shared memory)

// Shared-memory words per lane of a 2^M-row tile exchanged as M1 + M2:
// value j sits at j + (j >> M1); the stride is 4 mod 32 so that the 8 lanes
// and 4 row groups of a warp fall in different banks.
__host__ __device__ constexpr int col_stride(int m, int m1) {
  return ((((1 << m) + (1 << (m - m1))) + 31) & ~31) + 4;
}

// a, b <- a + b*t, a - b*t for t in Montgomery form (so b*t comes out
// canonical).  Each reduction is an unsigned min, one instruction where
// kb::add/sub take a compare and a select: for s < 2p, s - p wraps
// above s exactly when s < p, so min(s, s - p) = s mod p; for a, v < p,
// min(a - v, a - v + p) = (a - v) mod p likewise.
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b, uint32_t t) {
  const uint64_t prod = (uint64_t)b * t;
  const uint32_t m = (uint32_t)prod * kb::MU;
  uint32_t v = (uint32_t)((prod + (uint64_t)m * kb::P) >> 32);  // < 2p
  v = min(v, v - kb::P);
  const uint32_t s = a + v, d = a - v;
  a = min(s, s - kb::P);
  b = min(d, d + kb::P);
}

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// A lane of a tile: word v of the g*w words that a block's g adjacent
// residues occupy at each of its rows is column col of residue r0 + d.
struct Lane {
  bool live;
  int col;
  uint32_t r;
};

__device__ __forceinline__ Lane lane_of(int v, int w, int g, uint32_t r0) {
  Lane l;
  l.live = v < g * w;
  const int d = l.live ? v / w : 0;
  l.col = v - d * w;
  l.r = r0 + d;
  return l;
}

// Stages k0+1..k0+M of the rows of g adjacent residues, one 8-word tile of
// them.  Stage pass: residue r < 2^k0 owns rows hi + r + (j << k0), in and
// out.  Block pass (FIRST, k0 = 0): residue r < 2^(log_n - M) owns input
// rows (rev_M(j) << (log_n - M)) + r, of which those >= rows_in read as zero
// and the rest are scaled by `factors` if given, and output rows
// (rev(r) << M) + j.
template <int M1, int M2, bool FIRST>
__device__ __forceinline__ void run_pass(const int32_t* x, int32_t* out,
                                         const uint32_t* __restrict__ tw,
                                         const int32_t* __restrict__ factors, int rows_in,
                                         int w, int log_n, int k0, int g, int tiles) {
  constexpr int M = M1 + M2;
  constexpr int S = col_stride(M, M1);
  extern __shared__ uint32_t smem[];
  // Rows are below 2^30; only addresses are 64-bit.
  const unsigned tile = blockIdx.x % tiles;
  const uint32_t q = blockIdx.x / tiles;
  uint32_t r0, hi = 0;
  if constexpr (FIRST) {
    r0 = q * g;
  } else {
    const uint32_t groups = (1u << k0) / g;
    r0 = (q % groups) * g;
    hi = (q / groups) << (k0 + M);
  }
  auto in_row = [&](uint32_t r, uint32_t j) -> uint32_t {
    if constexpr (FIRST) return (rev_bits(j, M) << (log_n - M)) + r;
    return hi + r + (j << k0);
  };
  auto out_row = [&](uint32_t r, uint32_t j) -> uint32_t {
    if constexpr (FIRST) return (rev_bits(r, log_n - M) << M) + j;
    return hi + r + (j << k0);
  };
  auto at = [&](uint32_t row, int col) -> size_t { return (size_t)row * w + col; };
  // Stage k0 + t's twiddle at row r + (m << k0) is w_s^r * w_t^m: a
  // per-residue factor times an entry of the small stage-t table.
  auto twiddle = [&](int t, uint32_t r, uint32_t m) -> uint32_t {
    const uint32_t small = __ldg(tw + ((1u << (t - 1)) - 1) + m);
    if constexpr (FIRST) return small;
    return kb::mont_mul(__ldg(tw + ((1u << (k0 + t - 1)) - 1) + r), small);
  };

  // Phase A: rows j = jg * 2^M1 + i, i < 2^M1.
  const Lane a = lane_of(tile * COLS + threadIdx.x % COLS, w, g, r0);
  const unsigned jg = threadIdx.x / COLS;
  uint32_t v[1 << M1];
#pragma unroll
  for (int i = 0; i < (1 << M1); ++i) {
    const uint32_t row = in_row(a.r, (jg << M1) + i);
    bool take = a.live;
    if constexpr (FIRST) take = take && row < (uint32_t)rows_in;
    v[i] = take ? (uint32_t)x[at(row, a.col)] : 0u;
  }
  if constexpr (FIRST) {
    if (factors != nullptr) {
#pragma unroll
      for (int i = 0; i < (1 << M1); ++i) {
        const uint32_t row = in_row(a.r, (jg << M1) + i);
        if (row < (uint32_t)rows_in)
          v[i] = kb::mont_mul(kb::mont_mul(v[i], (uint32_t)__ldg(factors + row)), kb::R2);
      }
    }
  }
#pragma unroll
  for (int t = 1; t <= M1; ++t) {
    const int half = 1 << (t - 1);
#pragma unroll
    for (int jj = 0; jj < half; ++jj) {
      const uint32_t tv = twiddle(t, a.r, jj);
#pragma unroll
      for (int i = jj; i < (1 << M1); i += 2 * half) butterfly(v[i], v[i + half], tv);
    }
  }

  if constexpr (M2 == 0) {
    if (a.live) {
#pragma unroll
      for (int i = 0; i < (1 << M1); ++i)
        out[at(out_row(a.r, (jg << M1) + i), a.col)] = (int32_t)v[i];
    }
  } else {
    uint32_t* cs = smem + (threadIdx.x % COLS) * S;
#pragma unroll
    for (int i = 0; i < (1 << M1); ++i) {
      const unsigned j = (jg << M1) + i;
      cs[j + (j >> M1)] = v[i];
    }
    __syncthreads();

    // Phase B: rows j = jl + (i << M1), i < 2^M2.
    for (unsigned task = threadIdx.x; task < (unsigned)(COLS << M1); task += blockDim.x) {
      const Lane b = lane_of(tile * COLS + task % COLS, w, g, r0);
      const unsigned jl = task / COLS;
      const uint32_t* csb = smem + (task % COLS) * S;
      uint32_t y[1 << M2];
#pragma unroll
      for (int i = 0; i < (1 << M2); ++i) y[i] = csb[jl + (i << M1) + i];
#pragma unroll
      for (int u = 1; u <= M2; ++u) {
        const int half = 1 << (u - 1);
#pragma unroll
        for (int jj = 0; jj < half; ++jj) {
          const uint32_t tv = twiddle(M1 + u, b.r, jl + (jj << M1));
#pragma unroll
          for (int i = jj; i < (1 << M2); i += 2 * half) butterfly(y[i], y[i + half], tv);
        }
      }
      if (b.live) {
#pragma unroll
        for (int i = 0; i < (1 << M2); ++i)
          out[at(out_row(b.r, jl + (i << M1)), b.col)] = (int32_t)y[i];
      }
    }
  }
}

template <int M1, int M2>
__global__ void __launch_bounds__(COLS << M2)
    block_stages_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                        const uint32_t* __restrict__ tw, const int32_t* __restrict__ factors,
                        int rows_in, int w, int log_n, int g, int tiles) {
  run_pass<M1, M2, true>(x, out, tw, factors, rows_in, w, log_n, 0, g, tiles);
}

// Blocks per SM that the stage pass's register budget must allow (left
// alone, the compiler keeps whole twiddle sets live and fits fewer).  A
// 12-stage pass takes 133 KB of shared memory, so only one block fits.
template <int M1, int M2>
constexpr int min_blocks() {
  return M1 + M2 >= 12 ? 1 : M1 >= 6 ? 2 : 4;
}

// In place is allowed: a block reads all its values before it writes any,
// and the blocks' elements are disjoint (so x and out are not __restrict__).
template <int M1, int M2>
__global__ void __launch_bounds__(COLS << M2, min_blocks<M1, M2>())
    stage_kernel(const int32_t* x, int32_t* out, const uint32_t* __restrict__ tw, int w,
                 int log_n, int k0, int g, int tiles) {
  run_pass<M1, M2, false>(x, out, tw, nullptr, 0, w, log_n, k0, g, tiles);
}

template <int M>
constexpr int m1_of() {
  return (M + 1) / 2;
}

template <typename Kernel>
int prepare(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int M>
size_t smem_bytes() {
  constexpr int M1 = m1_of<M>();
  return M1 == M ? 0 : sizeof(uint32_t) * COLS * col_stride(M, M1);
}

// Residues per block: the least g with g * w a multiple of 8 words, so
// that every tile is one aligned sector (at most the 2^residues_log there are).
struct Grid {
  int g, tiles;
  size_t blocks;
};

Grid grid_of(int w, int log_n, int m, int residues_log) {
  Grid gr;
  const int low = w & -w;
  gr.g = low >= COLS ? 1 : COLS / low;
  if (residues_log < 3 && gr.g > (1 << residues_log)) gr.g = 1 << residues_log;
  gr.tiles = (gr.g * w + COLS - 1) / COLS;
  gr.blocks = (size_t)gr.tiles * ((size_t(1) << (log_n - m)) / gr.g);
  return gr;
}

template <int M>
int launch_block(const int32_t* x, int32_t* out, const uint32_t* tw, const int32_t* factors,
                 int rows_in, int w, int log_n, cudaStream_t st) {
  constexpr int M1 = m1_of<M>(), M2 = M - M1;
  const size_t smem = smem_bytes<M>();
  if (int err = prepare(block_stages_kernel<M1, M2>, smem)) return err;
  const Grid gr = grid_of(w, log_n, M, 0);  // one residue a block: its output rows are contiguous
  block_stages_kernel<M1, M2><<<(unsigned)gr.blocks, COLS << M2, smem, st>>>(
      x, out, tw, factors, rows_in, w, log_n, gr.g, gr.tiles);
  return (int)cudaGetLastError();
}

template <int M>
int launch_stage(const int32_t* x, int32_t* out, const uint32_t* tw, int w, int log_n, int k0,
                 cudaStream_t st) {
  constexpr int M1 = m1_of<M>(), M2 = M - M1;
  const size_t smem = smem_bytes<M>();
  if (int err = prepare(stage_kernel<M1, M2>, smem)) return err;
  const Grid gr = grid_of(w, log_n, M, k0);
  stage_kernel<M1, M2><<<(unsigned)gr.blocks, COLS << M2, smem, st>>>(x, out, tw, w, log_n, k0,
                                                                     gr.g, gr.tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The library links the CUDA runtime statically, so its current device is its
// own: the Python wrappers set it to the tensors' device before a launch.
extern "C" int zkbf_set_device(int device) { return (int)cudaSetDevice(device); }

// Stages 1..k (k <= 10) of every 2^k-row block of the 2^log_n-row input
// taken in bit-reversed row order.  x holds rows_in rows (rows >= rows_in
// read as zero); factors (rows_in canonical values, or null) scale the input
// rows.  tw: the Montgomery twiddle blob; out: (2^log_n, w), not x.
extern "C" int zkbf_ntt_block_stages(const void* x, void* out, const void* tw,
                                     const void* factors, int rows_in, int log_n, int w, int k,
                                     void* stream) {
  if (k < 1 || k > BLOCK_LOG_MAX || k > log_n || log_n > 30 || w < 1 || rows_in < 1 ||
      rows_in > (1 << log_n))
    return (int)cudaErrorInvalidValue;
  const auto* xi = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  const auto* t = static_cast<const uint32_t*>(tw);
  const auto* f = static_cast<const int32_t*>(factors);
  auto st = (cudaStream_t)stream;
  switch (k) {
#define ZKBF_BLOCK(M) \
  case M:             \
    return launch_block<M>(xi, o, t, f, rows_in, w, log_n, st);
    ZKBF_BLOCK(1) ZKBF_BLOCK(2) ZKBF_BLOCK(3) ZKBF_BLOCK(4) ZKBF_BLOCK(5)
    ZKBF_BLOCK(6) ZKBF_BLOCK(7) ZKBF_BLOCK(8) ZKBF_BLOCK(9) ZKBF_BLOCK(10)
#undef ZKBF_BLOCK
  }
  return (int)cudaErrorInvalidValue;
}

// Stages first..last (at most 12) over the whole (2^log_n, w) matrix, in one
// pass; out may be x.
extern "C" int zkbf_ntt_stage(const void* x, void* out, const void* tw, int log_n, int w,
                              int first, int last, void* stream) {
  const int m = last - first + 1;
  if (first < 1 || m < 1 || m > PASS_LOG_MAX || last > log_n || log_n > 30 || w < 1)
    return (int)cudaErrorInvalidValue;
  const auto* xi = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  const auto* t = static_cast<const uint32_t*>(tw);
  auto st = (cudaStream_t)stream;
  const int k0 = first - 1;
  switch (m) {
#define ZKBF_STAGE(M) \
  case M:             \
    return launch_stage<M>(xi, o, t, w, log_n, k0, st);
    ZKBF_STAGE(1) ZKBF_STAGE(2) ZKBF_STAGE(3) ZKBF_STAGE(4) ZKBF_STAGE(5) ZKBF_STAGE(6)
    ZKBF_STAGE(7) ZKBF_STAGE(8) ZKBF_STAGE(9) ZKBF_STAGE(10) ZKBF_STAGE(11) ZKBF_STAGE(12)
#undef ZKBF_STAGE
  }
  return (int)cudaErrorInvalidValue;
}
