// LogUp permutation-trace kernels over KoalaBear and its quartic extension
// EF4 = F_p[x] / (x^4 - 3).
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/):
//   - stark/permutation.py:77 _entries_chunk, run under the lax.scan of
//     :174 _perm_program -> zkbf_logup_entries;
//   - stark/permutation.py:215 _phi_program (jax.lax.associative_scan of
//     fadd over the row sums) -> zkbf_logup_scan.
//
// logup_entries.  For each row and each of the chip's I interactions
// (sends, then receives), the fingerprint
//     d_i = alpha + argument_index_i + sum_j beta^(j+1) * value_ij    (EF4)
// where every value and the multiplicity m_i are affine forms over the
// row's main and preprocessed columns; then the term +-m_i / d_i, the sum of
// each batch of B consecutive terms into NB = ceil(I/B) EF4 entry columns,
// and the row sum.  The chip's interactions come from a small int32
// descriptor table that the wrapper builds once per chip (ops/logup.py
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
// columns 0..NB-1, and the row sum in column NB (logup_scan then turns that
// column into the running sum phi in place).
//
// What bounds it on the H100: integer operations.  Per row the Cpu chip
// (I = 16, 31 main columns, up to 7 values per interaction) reads 124 bytes
// and writes 144, and needs about 1,100 Montgomery products (the value
// products, the prefix and unwind EF4 products, one EF4 inverse, the terms;
// chip_smoke.py logup_mults_per_row) against those 268 bytes.  A thread a
// row holds the row's 16 denominators and prefix products in registers
// (166 a thread, 12 warps an SM), and reading a 124-byte row column by
// column makes a warp's load touch 32 rows 124 bytes apart: that design,
// with 144-byte rows written 4 words at a time and the norm raised to p - 2
// in 61 dependent steps, took 3.2x this bound on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md).
//
// Design:
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
//   (64 registers and 156 bytes spilled, as ptxas reports; 1 lane needs 197
//   uncapped, 4 lanes pay a redundant inverse in every lane and the
//   divergence of unequal shares).  The probe builds copies of this file
//   with other values of ENTRY_LANES and ENTRY_MIN_BLOCKS.
// - The block's rows of main and prep are staged into shared memory with
//   coalesced 16-byte loads (128 rows x 31 words of the Cpu chip: 15.9 KB),
//   and its output rows are assembled in shared memory and stored as whole
//   16-byte runs of the contiguous output block.
// - Fingerprints are formed in Montgomery form (alpha + argument index per
//   interaction, and beta^j * 2^64 mod p, prepared once a block), so no
//   denominator needs a conversion; the Frobenius constants are Montgomery
//   constants (c^2 = -1, c^3 = -c: two products form the three conjugates);
//   the Fermat power p - 2 = (2^6 - 1) 2^25 + 2^24 - 1 is an addition chain
//   of 48 squarings and 6 products whose two branches run side by side.
//
// logup_scan.  The inclusive mod-p prefix sum of the (N, 4) row sums down
// the rows, in place in column NB: EF4 addition is componentwise, so each
// thread carries the four components of its rows as one uint4 (a 16-byte
// load per row).  Addition mod p is associative, so the result is exact
// whatever the order; the TPU's associative_scan becomes a three-pass scan,
// since nothing carries between blocks in order on this card: (1) each
// block scans a tile of 1024 rows (4 per thread, then warp shuffles, then
// the 8 warp totals) and writes its total; (2) one block scans the tile
// totals; (3) every tile but the first adds the total of the tiles before
// it.  It moves 2 x 16 bytes a row and is bound by memory; the rows of the
// column lie (NB+1) x 16 bytes apart, so every load is its own sector.
#include <cuda_runtime.h>

#include <cstdint>

#include "koalabear.cuh"

namespace {

constexpr int MAX_I = 16;          // interactions of the widest chip (Cpu)
constexpr int ENTRY_THREADS = 128;
constexpr int ENTRY_MIN_BLOCKS = 8;  // blocks an SM (caps the registers)
constexpr int ENTRY_LANES = 2;       // threads a row: 1, 2 or 4
static_assert(ENTRY_LANES == 1 || ENTRY_LANES == 2 || ENTRY_LANES == 4, "lanes");
constexpr int SCAN_THREADS = 256;  // 8 warps
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr uint32_t ONE_M = 33554430u;       // 1 in Montgomery form (2^32 mod p)
constexpr uint32_t FROB_C1_M = 2063729671u;  // c = 3^((p-1)/4), Montgomery form; c^2 = -1
constexpr unsigned FULL = 0xffffffffu;

struct E4 {
  uint32_t c[4];
};

__device__ __forceinline__ uint32_t x3(uint32_t a) { return kb::add(kb::add(a, a), a); }
__device__ __forceinline__ uint32_t neg(uint32_t a) { return kb::sub(0u, a); }

// Product in EF4 of two Montgomery-form values (x^4 = 3).
__device__ __forceinline__ E4 emul(const E4& a, const E4& b) {
  using kb::add;
  using kb::mont_mul;
  E4 r;
  r.c[0] = add(mont_mul(a.c[0], b.c[0]),
               x3(add(add(mont_mul(a.c[1], b.c[3]), mont_mul(a.c[2], b.c[2])),
                      mont_mul(a.c[3], b.c[1]))));
  r.c[1] = add(add(mont_mul(a.c[0], b.c[1]), mont_mul(a.c[1], b.c[0])),
               x3(add(mont_mul(a.c[2], b.c[3]), mont_mul(a.c[3], b.c[2]))));
  r.c[2] = add(add(add(mont_mul(a.c[0], b.c[2]), mont_mul(a.c[1], b.c[1])),
                   mont_mul(a.c[2], b.c[0])),
               x3(mont_mul(a.c[3], b.c[3])));
  r.c[3] = add(add(add(mont_mul(a.c[0], b.c[3]), mont_mul(a.c[1], b.c[2])),
                   mont_mul(a.c[2], b.c[1])),
               mont_mul(a.c[3], b.c[0]));
  return r;
}

__device__ __forceinline__ uint32_t sqn(uint32_t x, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) x = kb::mont_mul(x, x);
  return x;
}

// x^(p-2) (Montgomery form): p - 2 = (2^6 - 1) * 2^25 + 2^24 - 1.
__device__ __forceinline__ uint32_t fermat_inv(uint32_t x) {
  using kb::mont_mul;
  const uint32_t e3 = mont_mul(sqn(x, 1), x);      // 2^2 - 1
  const uint32_t e7 = mont_mul(sqn(e3, 1), x);     // 2^3 - 1
  const uint32_t e63 = mont_mul(sqn(e7, 3), e7);   // 2^6 - 1
  const uint32_t e12 = mont_mul(sqn(e63, 6), e63);  // 2^12 - 1
  const uint32_t e24 = mont_mul(sqn(e12, 12), e12);  // 2^24 - 1
  return mont_mul(sqn(e63, 25), e24);
}

// Inverse in EF4 of a nonzero Montgomery-form value: the product b of the
// three conjugates s(a) s^2(a) s^3(a), with s(a)_i = a_i c^i, over the norm
// a * b, which lies in the base field.
__device__ __forceinline__ E4 einv(const E4& a) {
  const uint32_t a1c = kb::mont_mul(a.c[1], FROB_C1_M), a3c = kb::mont_mul(a.c[3], FROB_C1_M);
  const E4 s1 = {{a.c[0], a1c, neg(a.c[2]), neg(a3c)}};
  const E4 s2 = {{a.c[0], neg(a.c[1]), a.c[2], neg(a.c[3])}};
  const E4 s3 = {{a.c[0], neg(a1c), neg(a.c[2]), a3c}};
  const E4 b = emul(emul(s1, s2), s3);
  const uint32_t norm =
      kb::add(kb::mont_mul(a.c[0], b.c[0]),
              x3(kb::add(kb::add(kb::mont_mul(a.c[1], b.c[3]), kb::mont_mul(a.c[2], b.c[2])),
                         kb::mont_mul(a.c[3], b.c[1]))));
  const uint32_t r = fermat_inv(norm);
  E4 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) out.c[k] = kb::mont_mul(b.c[k], r);
  return out;
}

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

__global__ void __launch_bounds__(ENTRY_THREADS, ENTRY_MIN_BLOCKS)
entries_kernel(const int32_t* __restrict__ main, int w, const int32_t* __restrict__ prep, int pw,
               int n, const int32_t* __restrict__ desc, int desc_len,
               const int32_t* __restrict__ chal, int n_chal, int32_t* __restrict__ out,
               int n_inter, int batch, int nb) {
  constexpr int LANES = ENTRY_LANES;
  constexpr int ROWS = ENTRY_THREADS / LANES;
  constexpr int KL = MAX_I / LANES;  // interactions a lane can hold
  extern __shared__ uint4 entries_smem[];
  uint32_t* s_main = reinterpret_cast<uint32_t*>(entries_smem);
  uint32_t* s_prep = s_main + round4(ROWS * w);
  uint32_t* s_out = s_prep + round4(ROWS * pw);
  uint32_t* s_desc = s_out + ROWS * (nb + 1) * 4;
  uint32_t* s_beta = s_desc + round4(desc_len);  // alpha, then beta^j * 2^64 mod p
  uint32_t* s_base = s_beta + 4 * n_chal;        // alpha + argument index, Montgomery
  int* s_off = reinterpret_cast<int*>(s_base + 4 * MAX_I);

  const size_t row0 = (size_t)blockIdx.x * ROWS;
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
  const uint4* so = reinterpret_cast<const uint4*>(s_out);
  uint4* go = reinterpret_cast<uint4*>(out) + row0 * (nb + 1);
  for (int i = threadIdx.x; i < nrows * (nb + 1); i += blockDim.x) go[i] = so[i];
}

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

// Entries and row sums of an (n, nb+1, 4) permutation trace.  prep may be
// null (pw = 0).  chal: (n_chal, 4) canonical, row 0 = alpha, row 1 + j =
// beta^j.  n_inter <= 16; ENTRY_LANES threads share a row, each taking
// ceil(nb / ENTRY_LANES) batches, which must hold at most 16 / ENTRY_LANES
// interactions.  out must be 16-byte aligned.
extern "C" int zkbf_logup_entries(const void* main, int w, const void* prep, int pw, int n,
                                  const void* desc, int desc_len, const void* chal, int n_chal,
                                  void* out, int n_inter, int batch, int nb, void* stream) {
  if (n < 1 || n_inter < 1 || n_inter > MAX_I || batch < 1 || nb != (n_inter + batch - 1) / batch ||
      (pw > 0 && prep == nullptr) || n_chal < 2 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int per_lane = (nb + ENTRY_LANES - 1) / ENTRY_LANES * batch;
  if ((per_lane < n_inter ? per_lane : n_inter) > MAX_I / ENTRY_LANES)
    return (int)cudaErrorInvalidValue;
  const int rows = ENTRY_THREADS / ENTRY_LANES;
  const size_t smem = sizeof(uint32_t) * entries_smem_words(rows, w, pw, nb, desc_len, n_chal);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((size_t)n + rows - 1) / rows);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* m = static_cast<const int32_t*>(main);
  const int32_t* p = static_cast<const int32_t*>(prep);
  const int32_t* d = static_cast<const int32_t*>(desc);
  const int32_t* c = static_cast<const int32_t*>(chal);
  int32_t* o = static_cast<int32_t*>(out);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(entries_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    entries_kernel<<<blocks, ENTRY_THREADS, smem, s>>>(m, w, p, pw, n, d, desc_len, c, n_chal, o,
                                                       n_inter, batch, nb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

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
