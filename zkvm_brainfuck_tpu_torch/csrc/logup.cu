// The LogUp permutation trace over KoalaBear and its quartic extension
// EF4 = F_p[x] / (x^4 - 3), in one kernel: entries, row sums and the
// running sum.
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/):
//   - stark/permutation.py:77 _entries_chunk, run under the lax.scan of
//     :174 _perm_program;
//   - stark/permutation.py:215 _phi_program (jax.lax.associative_scan of
//     fadd over the row sums).
// Both are zkbf_logup_trace.
//
// For each row and each of the chip's I interactions (sends, then
// receives), the fingerprint
//     d_i = alpha + argument_index_i + sum_j beta^(j+1) * value_ij    (EF4)
// where every value and the multiplicity m_i are affine forms over the
// row's main and preprocessed columns; then the term +-m_i / d_i, the sum of
// each batch of B consecutive terms into NB = ceil(I/B) EF4 entry columns,
// the row sum, and the inclusive running sum phi of the row sums down the
// rows.  The chip's interactions come from a small int32 descriptor table
// that the wrapper builds once per chip (ops/logup.py
// `LogupTable.descriptor`); no code is generated per chip.  Layout, per
// interaction in order:
//     sign (1 send, 0 receive), argument_index, nv,
//     nv + 1 affine forms (the values, then the multiplicity), each
//         const, nterms, nterms x (source 0 main / 1 prep, column, weight * 2^32 mod p)
// The I denominators of a row are inverted with ONE Montgomery batch
// inversion: prefix products, one EF4 inverse through the norm
// N(a) = a * s(a) s^2(a) s^3(a) (s the Frobenius) and a base-field Fermat
// power, then an unwind that peels one inverse off per interaction.  An
// inverse is unique, so the bits equal the JAX package's per-element
// inverses.  A zero denominator (probability ~I/p^4) is inverted to 0, as
// the JAX package's Fermat inverse does: it enters the product as 1 and its
// term is set to 0.
//
// Output: the (N, NB+1, 4) permutation trace the perm commit reads, entry
// columns 0..NB-1 and phi in column NB, and the cumulative sum phi[N-1] as
// 4 words.
//
// What bounds it on the H100: integer operations.  Per row the Cpu chip
// (I = 16, 31 main columns, up to 7 values per interaction) reads 124 bytes
// and writes 144, and needs about 1,100 Montgomery products (the value
// products, the prefix and unwind EF4 products, one EF4 inverse, the terms;
// chip_smoke.py logup_mults_per_row) against those 268 bytes; the running
// sum adds 4 modular additions a row and no bytes.
//
// Design of the entry phase:
// - ENTRY_LANES (1, 2 or 4) adjacent threads share a row, each taking whole
//   batches of its interactions (at most 16 / ENTRY_LANES): each forms its
//   fingerprints and the prefix products of its share, a shuffle butterfly
//   gives every lane the row's product and the product of the other lanes'
//   shares, each lane inverts the row product (one EF4 inverse, repeated in
//   every lane of the row) and unwinds its own share; the row sum is a
//   shuffle sum.  Fewer interactions a thread, fewer registers, more warps.
//   Chosen on an NVIDIA H100 80GB HBM3 at 700 W
//   (zkvm_brainfuck_tpu_torch/probes/tree_logup_variants.py, PERF.md): 2
//   lanes a row with the registers capped for 8 blocks of 128 threads an SM
//   (64 registers and 156 bytes spilled, as ptxas reports, with or without
//   the running sum; 1 lane needs 197 uncapped, 4 lanes pay
//   a redundant inverse in every lane and the divergence of unequal
//   shares).  The probe builds copies of this file with other values of
//   ENTRY_LANES, ENTRY_MIN_BLOCKS and FUSED_SCAN.
// - The block's rows of main and prep are staged into shared memory with
//   coalesced 16-byte loads (64 rows x 31 words of the Cpu chip), and its
//   output rows are assembled in shared memory and stored as whole 16-byte
//   runs of the contiguous output block.
// - Fingerprints are formed in Montgomery form (alpha + argument index per
//   interaction, and beta^j * 2^64 mod p, prepared once a block), so no
//   denominator needs a conversion; the Frobenius constants are Montgomery
//   constants (c^2 = -1, c^3 = -c: two products form the three conjugates);
//   the Fermat power p - 2 = (2^6 - 1) 2^25 + 2^24 - 1 is an addition chain
//   of 48 squarings and 6 products whose two branches run side by side.
//
// The running sum: a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016).  The row sums are already in shared memory when the entry phase
// ends, so phi costs no second pass over the trace.
// - Each block takes an index from an atomic counter, not from blockIdx.x:
//   a block then waits only on tiles claimed before its own, whose blocks
//   are resident or done, so no wait can deadlock whatever order the card
//   schedules blocks in.  Index c < T (the tiles, ENTRY_ROWS rows each) is
//   tile c.
// - After the entry phase, a separate phase scans the tile's row sums in
//   shared memory (componentwise mod p, a warp of shuffles per 32 rows), so
//   none of its registers is live beside the entry phase's.  The tile is
//   stored with its own running sum, and its aggregate (the sum of its
//   rows) is published once the rows are in memory.
// - Values are canonical (< p < 2^31), so bit 31 of each word is its
//   "ready" mark: a 32-bit store is atomic, and a reader takes an EF4 value
//   only when all four of its words carry the mark.  Aggregates and
//   inclusive prefixes go into two scratch arrays of 16-byte values.
// - Tile r is resolved later, by the block that claims index r + L (L =
//   LAG_PERCENT of the blocks the card holds at once, at most T; the
//   launch has T + L blocks, and the last L only resolve).  Warp 0 of that
//   block, while the other warps store its own tile, looks back from r a
//   window of 32 tiles at a time, adding aggregates until it meets an
//   inclusive prefix, publishes r's inclusive prefix, and adds r's
//   exclusive prefix to the running sums of r's rows in place.  The
//   resolver of the last tile writes the cumulative sum.
// - Why the lag: resolving a tile at once (the textbook scheme) makes its
//   block wait for the slowest block claimed before it, and the entry
//   phase of this kernel is long and uneven, so blocks waited on each
//   other: 14-17 % over a copy without the running sum, against 4-8 % with
//   the lag (LAG_PERCENT 0 and 100 in
//   zkvm_brainfuck_tpu_torch/probes/tree_logup_variants.py; PERF.md, NVIDIA
//   H100 80GB HBM3, 700 W).
// - Mod-p addition is exact in any order, so phi has the same bits as a
//   sequential sum.
// - The counter and the two arrays (16 + 32 x T bytes: 512 KiB at 2^20
//   rows) are cleared by a cudaMemsetAsync on the caller's stream before
//   every launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "ef4.cuh"
#include "koalabear.cuh"

namespace {

using namespace ef4;  // E4, ONE_M, emul, einv, neg

constexpr int MAX_I = 16;          // interactions of the widest chip (Cpu)
constexpr int ENTRY_THREADS = 128;
constexpr int ENTRY_MIN_BLOCKS = 8;  // blocks an SM (caps the registers)
constexpr int ENTRY_LANES = 2;       // threads a row: 1, 2 or 4
static_assert(ENTRY_LANES == 1 || ENTRY_LANES == 2 || ENTRY_LANES == 4, "lanes");
constexpr int ENTRY_ROWS = ENTRY_THREADS / ENTRY_LANES;  // rows of a tile (one block)
// 1: column NB is the running sum (the scan phase and the look-back run).
// 0: column NB keeps the row sums, no cumulative sum is written, and the
// launch has T blocks; only the probe builds this copy, to time the running
// sum's share of the kernel.
constexpr int FUSED_SCAN = 1;
// The look-back lag, in percent of the blocks the card holds at once (see
// the header): tile r is resolved by the block that claims index r + lag.
// 0 (a copy the probe builds): every tile resolves itself before its store.
constexpr int LAG_PERCENT = 100;
constexpr uint32_t READY = 0x80000000u;  // set in each published word
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ E4 shfl_xor4(const E4& a, int m) {
  E4 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.c[k] = __shfl_xor_sync(FULL, a.c[k], m);
  return r;
}

// One affine form of the descriptor at `pos` (advanced past it), canonical.
__device__ __forceinline__ uint32_t affine(const uint32_t* s, int& pos, const uint32_t* mrow,
                                           const uint32_t* prow) {
  uint32_t acc = s[pos];
  const int nt = (int)s[pos + 1];
  pos += 2;
  for (int t = 0; t < nt; ++t) {
    const uint32_t col = s[pos + 1], wm = s[pos + 2];
    const uint32_t x = s[pos] ? prow[col] : mrow[col];
    acc = kb::add(acc, kb::mont_mul(x, wm));  // x * w, canonical
    pos += 3;
  }
  return acc;
}

// `count` words from global `src` to shared `dst` (16-byte aligned), with
// 16-byte loads where `src` is 16-byte aligned.
__device__ __forceinline__ void stage(uint32_t* dst, const int32_t* src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = count >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) d4[i] = __ldg(s4 + i);
    done = vecs << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = (uint32_t)__ldg(src + i);
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared memory of a block, in words: rows of main and prep, output rows,
// descriptor, challenges, per-interaction bases and descriptor offsets.
__host__ __device__ constexpr int entries_smem_words(int rows, int w, int pw, int nb, int desc_len,
                                                     int n_chal) {
  return round4(rows * w) + round4(rows * pw) + rows * (nb + 1) * 4 + round4(desc_len) +
         4 * n_chal + 4 * MAX_I + MAX_I;
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(kb::add(a.x, b.x), kb::add(a.y, b.y), kb::add(a.z, b.z), kb::add(a.w, b.w));
}

// Inclusive running sum (mod p, componentwise) down the lanes of a warp.
__device__ __forceinline__ uint4 warp_scan4(uint4 v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint4 y = make_uint4(__shfl_up_sync(FULL, v.x, off), __shfl_up_sync(FULL, v.y, off),
                               __shfl_up_sync(FULL, v.z, off), __shfl_up_sync(FULL, v.w, off));
    if (lane >= off) v = add4(v, y);
  }
  return v;
}

// Publish an EF4 value with the ready mark on each of its words.
__device__ __forceinline__ void publish(uint32_t* slot, uint4 v) {
  volatile uint32_t* s = slot;
  s[0] = v.x | READY;
  s[1] = v.y | READY;
  s[2] = v.z | READY;
  s[3] = v.w | READY;
}

// The value at `slot` if all four words carry the ready mark.
__device__ __forceinline__ bool peek(const uint32_t* slot, uint4& v) {
  const volatile uint32_t* s = slot;
  v = make_uint4(s[0], s[1], s[2], s[3]);
  if ((v.x & v.y & v.z & v.w & READY) == 0u) return false;
  v = make_uint4(v.x & ~READY, v.y & ~READY, v.z & ~READY, v.w & ~READY);
  return true;
}

__device__ __forceinline__ uint4 sub4(uint4 a, uint4 b) {
  return make_uint4(kb::sub(a.x, b.x), kb::sub(a.y, b.y), kb::sub(a.z, b.z), kb::sub(a.w, b.w));
}

__device__ __forceinline__ uint4 shfl4(uint4 v, int src) {
  return make_uint4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                    __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

// Called by the 32 lanes of one warp, once tile r has published its
// aggregate: the inclusive prefix of r (its rows and every earlier tile's),
// looking back a window of 32 tiles at a time (lane 0 on r itself, lane k
// on r - k) and adding aggregates until it meets an inclusive prefix; `own`
// receives r's aggregate.  Publishes r's inclusive prefix, and writes the
// cumulative sum if r is the last tile.
__device__ uint4 inclusive_prefix(const uint32_t* aggs, uint32_t* incls, int r, int n_tiles,
                                  int32_t* csum, int lane, uint4& own) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 incl = zero;
  for (int base = r; base >= 0; base -= 32) {
    const int j = base - lane;
    uint4 v = zero;
    bool done = true;  // before tile 0: nothing to add
    if (j >= 0) {
      while (true) {
        if (j < r && peek(incls + 4 * (size_t)j, v)) break;
        if (peek(aggs + 4 * (size_t)j, v)) {
          done = false;
          break;
        }
      }
    }
    if (base == r) own = shfl4(v, 0);
    const unsigned found = __ballot_sync(FULL, done);
    const int stop = found ? __ffs(found) - 1 : 32;  // the nearest inclusive prefix
    if (lane > stop) v = zero;
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      v = add4(v, make_uint4(__shfl_xor_sync(FULL, v.x, m), __shfl_xor_sync(FULL, v.y, m),
                             __shfl_xor_sync(FULL, v.z, m), __shfl_xor_sync(FULL, v.w, m)));
    incl = add4(incl, v);
    if (found) break;
  }
  if (lane == 0) {
    publish(incls + 4 * (size_t)r, incl);
    if (r == n_tiles - 1) {
      csum[0] = (int32_t)incl.x;
      csum[1] = (int32_t)incl.y;
      csum[2] = (int32_t)incl.z;
      csum[3] = (int32_t)incl.w;
    }
  }
  return incl;
}

// Warp 0 of the block that resolves tile r (see the header): r's inclusive
// prefix, then r's exclusive prefix added to the running sums of r's rows
// in place (ld.cg: another block wrote them).
__device__ void resolve(const uint32_t* aggs, uint32_t* incls, int r, int n_tiles, int n, int nb,
                        int32_t* out, int32_t* csum, int lane) {
  uint4 own;
  const uint4 incl = inclusive_prefix(aggs, incls, r, n_tiles, csum, lane, own);
  if (r == 0) return;
  __threadfence();  // lane 0 saw r's aggregate, published after r's rows were stored
  __syncwarp();
  const uint4 excl = sub4(incl, own);
  const int rows = min(ENTRY_ROWS, n - r * ENTRY_ROWS);
  uint4* col = reinterpret_cast<uint4*>(out) + (size_t)r * ENTRY_ROWS * (nb + 1) + nb;
  for (int i = lane; i < rows; i += 32) {
    uint4* p = col + (size_t)i * (nb + 1);
    *p = add4(__ldcg(p), excl);
  }
}

__global__ void __launch_bounds__(ENTRY_THREADS, ENTRY_MIN_BLOCKS)
entries_kernel(const int32_t* __restrict__ main, int w, const int32_t* __restrict__ prep, int pw,
               int n, const int32_t* __restrict__ desc, int desc_len,
               const int32_t* __restrict__ chal, int n_chal, int32_t* __restrict__ out,
               int32_t* __restrict__ csum, uint32_t* scratch, int n_tiles, int lag, int n_inter,
               int batch, int nb) {
  constexpr int LANES = ENTRY_LANES;
  constexpr int ROWS = ENTRY_ROWS;
  constexpr int KL = MAX_I / LANES;  // interactions a lane can hold
  extern __shared__ uint4 entries_smem[];
  __shared__ uint4 s_scan[ROWS / 32 + 1];  // the warps' totals of row sums
  __shared__ int s_tile;
  uint32_t* s_main = reinterpret_cast<uint32_t*>(entries_smem);
  uint32_t* s_prep = s_main + round4(ROWS * w);
  uint32_t* s_out = s_prep + round4(ROWS * pw);
  uint32_t* s_desc = s_out + ROWS * (nb + 1) * 4;
  uint32_t* s_beta = s_desc + round4(desc_len);  // alpha, then beta^j * 2^64 mod p
  uint32_t* s_base = s_beta + 4 * n_chal;        // alpha + argument index, Montgomery
  int* s_off = reinterpret_cast<int*>(s_base + 4 * MAX_I);

  uint32_t* aggs = scratch + 4;
  uint32_t* incls = aggs + 4 * (size_t)n_tiles;
  if (FUSED_SCAN) {
    if (threadIdx.x == 0) s_tile = atomicAdd(reinterpret_cast<int*>(scratch), 1);
    __syncthreads();
  }
  const int tile = FUSED_SCAN ? s_tile : (int)blockIdx.x;
  if (tile >= n_tiles) {  // a block that only resolves a tile of the last `lag`
    if (threadIdx.x < 32)
      resolve(aggs, incls, tile - lag, n_tiles, n, nb, out, csum, (int)threadIdx.x);
    return;
  }
  const size_t row0 = (size_t)tile * ROWS;
  const int nrows = (int)min((size_t)ROWS, (size_t)n - row0);
  stage(s_main, main + row0 * w, nrows * w);
  if (pw > 0) stage(s_prep, prep + row0 * pw, nrows * pw);
  for (int i = threadIdx.x; i < desc_len; i += blockDim.x) s_desc[i] = (uint32_t)desc[i];
  for (int i = threadIdx.x; i < 4 * n_chal; i += blockDim.x)
    s_beta[i] = i < 4 ? (uint32_t)chal[i] : kb::to_mont(kb::to_mont((uint32_t)chal[i]));
  if (threadIdx.x == 0) {
    int pos = 0;
    for (int i = 0; i < n_inter; ++i) {
      s_off[i] = pos;
      const uint32_t arg = (uint32_t)desc[pos + 1];
      const int nv = desc[pos + 2];
      pos += 3;
      for (int v = 0; v <= nv; ++v) pos += 2 + 3 * desc[pos + 1];
      for (int k = 0; k < 4; ++k)
        s_base[4 * i + k] = kb::to_mont(k == 0 ? kb::add((uint32_t)chal[0], arg) : (uint32_t)chal[k]);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % LANES;
  const int r = threadIdx.x / LANES;
  const int rr = r < nrows ? r : 0;  // a lane past the last row computes on row 0, stores nothing
  const uint32_t* mrow = s_main + rr * w;
  const uint32_t* prow = s_prep + rr * pw;
  const int nbl = (nb + LANES - 1) / LANES;  // batches a lane takes
  const int i0 = lane * nbl * batch;
  const int k = max(0, min(n_inter, i0 + nbl * batch) - i0);  // <= KL (checked by the launcher)

  E4 den[KL];         // denominators (Montgomery); later the terms (canonical)
  uint32_t mult[KL];  // +-m, canonical
  uint32_t zero_mask = 0;
#pragma unroll
  for (int kk = 0; kk < KL; ++kk) {
    if (kk < k) {
      const int i = i0 + kk;
      int pos = s_off[i];
      const uint32_t sign = s_desc[pos];
      const int nv = (int)s_desc[pos + 2];
      pos += 3;
      uint32_t d[4] = {s_base[4 * i], s_base[4 * i + 1], s_base[4 * i + 2], s_base[4 * i + 3]};
      for (int j = 0; j < nv; ++j) {
        const uint32_t v = affine(s_desc, pos, mrow, prow);
        const uint32_t* bp = s_beta + 4 * (j + 2);  // beta^(j+1) * 2^64
#pragma unroll
        for (int c = 0; c < 4; ++c) d[c] = kb::add(d[c], kb::mont_mul(v, bp[c]));
      }
      const uint32_t m = affine(s_desc, pos, mrow, prow);
      mult[kk] = sign ? m : neg(m);
      const bool zero = (d[0] | d[1] | d[2] | d[3]) == 0u;
      zero_mask |= (uint32_t)zero << kk;
#pragma unroll
      for (int c = 0; c < 4; ++c) den[kk].c[c] = d[c];
      if (zero) den[kk].c[0] = ONE_M;
    }
  }

  const E4 one = {{ONE_M, 0u, 0u, 0u}};
  E4 pref[KL], mine = one;  // mine: the product of this lane's share
#pragma unroll
  for (int kk = 0; kk < KL; ++kk) {
    if (kk < k) {
      pref[kk] = kk == 0 ? den[0] : emul(pref[kk > 0 ? kk - 1 : 0], den[kk]);
      mine = pref[kk];
    }
  }
  E4 inv;  // becomes the inverse of `mine`
  if (LANES == 1) {
    inv = einv(mine);
  } else {
    const E4 a = shfl_xor4(mine, 1);  // the other lane's share (LANES 2), or the pair's (LANES 4)
    if (LANES == 2) {
      inv = emul(einv(emul(mine, a)), a);
    } else {
      const E4 q = emul(mine, a);
      const E4 b = shfl_xor4(q, 2);  // the other pair's product
      inv = emul(einv(emul(q, b)), emul(a, b));
    }
  }
#pragma unroll
  for (int kk = KL - 1; kk >= 0; --kk) {
    if (kk < k) {
      const E4 inv_i = kk > 0 ? emul(inv, pref[kk > 0 ? kk - 1 : 0]) : inv;
      if (kk > 0) inv = emul(inv, den[kk]);
      const bool zero = (zero_mask >> kk) & 1u;
#pragma unroll
      for (int c = 0; c < 4; ++c) den[kk].c[c] = zero ? 0u : kb::mont_mul(inv_i.c[c], mult[kk]);
    }
  }

  uint32_t* orow = s_out + r * (nb + 1) * 4;
  const bool store = r < nrows;
  uint32_t bsum[4] = {0u, 0u, 0u, 0u}, rsum[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int kk = 0; kk < KL; ++kk) {
    if (kk < k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) bsum[c] = kb::add(bsum[c], den[kk].c[c]);
      if ((kk + 1) % batch == 0 || kk == k - 1) {
        const int b = (i0 + kk) / batch;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (store) orow[4 * b + c] = bsum[c];
          rsum[c] = kb::add(rsum[c], bsum[c]);
          bsum[c] = 0u;
        }
      }
    }
  }
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) rsum[c] = kb::add(rsum[c], __shfl_xor_sync(FULL, rsum[c], m));
  }
  if (store && lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) orow[4 * nb + c] = rsum[c];
  }
  __syncthreads();

  // The running sum, a phase of its own: rows t < ROWS scan their row sums
  // a warp at a time, and the tile is stored with its own running sum.
  // Warp 0 meanwhile resolves tile - lag; then the tile's aggregate is
  // published, once its rows are in memory.
  const int t = threadIdx.x, wl = t & 31, wp = t >> 5;
  const uint4* so = reinterpret_cast<const uint4*>(s_out);
  uint4* go = reinterpret_cast<uint4*>(out) + row0 * (nb + 1);
  if (!FUSED_SCAN) {
    for (int i = t; i < nrows * (nb + 1); i += blockDim.x) go[i] = so[i];
    return;
  }
  uint4* srow = reinterpret_cast<uint4*>(s_out) + (size_t)t * (nb + 1) + nb;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (t < ROWS) {
    if (t < nrows) v = *srow;
    v = warp_scan4(v, wl);
    if (wl == 31) s_scan[wp] = v;
  }
  __syncthreads();
  if (LAG_PERCENT == 0) {
    // The probe's copy: the tile resolves itself before its store.
    if (wp == 0) {
      uint4 agg = s_scan[0], own;
      for (int k = 1; k < ROWS / 32; ++k) agg = add4(agg, s_scan[k]);
      if (wl == 0) publish(aggs + 4 * (size_t)tile, agg);
      const uint4 incl = inclusive_prefix(aggs, incls, tile, n_tiles, csum, wl, own);
      if (wl == 0) s_scan[ROWS / 32] = sub4(incl, agg);
    }
    __syncthreads();
  }
  if (t < nrows) {
    uint4 before = LAG_PERCENT == 0 ? s_scan[ROWS / 32] : make_uint4(0u, 0u, 0u, 0u);
    for (int k = 0; k < wp; ++k) before = add4(before, s_scan[k]);
    *srow = add4(before, v);
  }
  __syncthreads();
  if (LAG_PERCENT == 0) {
    for (int i = t; i < nrows * (nb + 1); i += blockDim.x) go[i] = so[i];
    return;
  }
  if (wp == 0) {
    if (tile >= lag) resolve(aggs, incls, tile - lag, n_tiles, n, nb, out, csum, wl);
  } else {
    for (int i = t - 32; i < nrows * (nb + 1); i += blockDim.x - 32) go[i] = so[i];
  }
  __threadfence();
  __syncthreads();
  if (t == 0) {
    uint4 agg = s_scan[0];
    for (int k = 1; k < ROWS / 32; ++k) agg = add4(agg, s_scan[k]);
    publish(aggs + 4 * (size_t)tile, agg);
  }
}

}  // namespace

// The library links the CUDA runtime statically, so its current device is its
// own: the Python wrappers set it to the tensors' device before a launch.
extern "C" int zkbf_set_device(int device) { return (int)cudaSetDevice(device); }

// Scratch words of zkbf_logup_trace for n rows: the tile counter (padded
// to 16 bytes), then the aggregates and the inclusive prefixes of the
// tiles, 4 words each.
extern "C" long long zkbf_logup_scratch_words(int n) {
  const long long tiles = ((long long)n + ENTRY_ROWS - 1) / ENTRY_ROWS;
  return 4 + 8 * tiles;
}

// The (n, nb+1, 4) permutation trace (entries, then phi in column nb) and
// the cumulative sum csum (4 words).  prep may be null (pw = 0).  chal:
// (n_chal, 4) canonical, row 0 = alpha, row 1 + j = beta^j.  n_inter <= 16;
// ENTRY_LANES threads share a row, each taking ceil(nb / ENTRY_LANES)
// batches, which must hold at most 16 / ENTRY_LANES interactions.  out and
// scratch must be 16-byte aligned; scratch holds scratch_words words
// (zkbf_logup_scratch_words) and is cleared here on `stream` before the
// launch.
extern "C" int zkbf_logup_trace(const void* main, int w, const void* prep, int pw, int n,
                                const void* desc, int desc_len, const void* chal, int n_chal,
                                void* out, void* csum, void* scratch, long long scratch_words,
                                int n_inter, int batch, int nb, void* stream) {
  if (n < 1 || n_inter < 1 || n_inter > MAX_I || batch < 1 || nb != (n_inter + batch - 1) / batch ||
      (pw > 0 && prep == nullptr) || n_chal < 2 || (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 || scratch_words < zkbf_logup_scratch_words(n))
    return (int)cudaErrorInvalidValue;
  const int per_lane = (nb + ENTRY_LANES - 1) / ENTRY_LANES * batch;
  if ((per_lane < n_inter ? per_lane : n_inter) > MAX_I / ENTRY_LANES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * entries_smem_words(ENTRY_ROWS, w, pw, nb, desc_len, n_chal);
  if (smem > 227 * 1024 - 1024) return (int)cudaErrorInvalidValue;  // the static part is < 1 KB
  const int blocks = (int)(((size_t)n + ENTRY_ROWS - 1) / ENTRY_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * zkbf_logup_scratch_words(n), s);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(entries_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // The look-back lag: LAG_PERCENT of the blocks the card holds at once
  // (ENTRY_MIN_BLOCKS an SM), at most the tiles; as many blocks again
  // resolve the last `lag` tiles.
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int lag = FUSED_SCAN && LAG_PERCENT > 0
                      ? (int)max(1LL, min((long long)blocks,
                                          (long long)sms * ENTRY_MIN_BLOCKS * LAG_PERCENT / 100))
                      : 0;
  if (e == cudaSuccess)
    entries_kernel<<<blocks + lag, ENTRY_THREADS, smem, s>>>(
        static_cast<const int32_t*>(main), w, static_cast<const int32_t*>(prep), pw, n,
        static_cast<const int32_t*>(desc), desc_len, static_cast<const int32_t*>(chal), n_chal,
        static_cast<int32_t*>(out), static_cast<int32_t*>(csum), static_cast<uint32_t*>(scratch),
        blocks, lag, n_inter, batch, nb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
