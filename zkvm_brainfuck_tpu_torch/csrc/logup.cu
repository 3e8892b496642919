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
// and writes 144, and does about 16 x 7 x 4 value products, 15 + 2 x 15 EF4
// products for the prefix and the unwind (16 Montgomery products each), the
// EF4 inverse (3 EF4 products and ~60 base products for the Fermat power)
// and 64 products for the terms: ~1,300 Montgomery products a row against
// 268 bytes.  One thread owns one row; the EF4 state of its 16 interactions
// (denominators and prefix products, 128 words) is indexed with compile-time
// indices (the interaction loop is unrolled to MAX_I) so that it can live in
// registers: `ptxas -v` for sm_90a reports 166 registers a thread and no
// spill (PERF.md), so few warps fit on an SM.  The descriptor and the
// challenges sit in shared memory, loaded once per block.
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
constexpr int SCAN_THREADS = 256;  // 8 warps
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr uint32_t FROB_C = 2113994754u;  // 3^((p-1)/4): the Frobenius scale

struct E4 {
  uint32_t c[4];
};

__device__ __forceinline__ uint32_t x3(uint32_t a) { return kb::add(kb::add(a, a), a); }

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

// Inverse in EF4 of a nonzero Montgomery-form value: the product b of the
// three conjugates s(a) s^2(a) s^3(a), with s(a)_i = a_i c^i, over the norm
// a * b, which lies in the base field; the norm is inverted by Fermat.
__device__ E4 einv(const E4& a) {
  const uint32_t c1 = kb::to_mont(FROB_C);
  const uint32_t c2 = kb::mont_mul(c1, c1);
  const uint32_t c3 = kb::mont_mul(c2, c1);
  E4 s1 = {{a.c[0], kb::mont_mul(a.c[1], c1), kb::mont_mul(a.c[2], c2), kb::mont_mul(a.c[3], c3)}};
  E4 s2 = {{a.c[0], kb::mont_mul(a.c[1], c2), a.c[2], kb::mont_mul(a.c[3], c2)}};
  E4 s3 = {{a.c[0], kb::mont_mul(a.c[1], c3), kb::mont_mul(a.c[2], c2), kb::mont_mul(a.c[3], c1)}};
  E4 b = emul(emul(s1, s2), s3);
  uint32_t norm = kb::add(kb::mont_mul(a.c[0], b.c[0]),
                          x3(kb::add(kb::add(kb::mont_mul(a.c[1], b.c[3]), kb::mont_mul(a.c[2], b.c[2])),
                                     kb::mont_mul(a.c[3], b.c[1]))));
  // norm^(p-2), Montgomery form throughout
  uint32_t r = kb::to_mont(1u), base = norm;
  for (uint32_t e = kb::P - 2; e; e >>= 1) {
    if (e & 1u) r = kb::mont_mul(r, base);
    base = kb::mont_mul(base, base);
  }
  E4 out;
  for (int k = 0; k < 4; ++k) out.c[k] = kb::mont_mul(b.c[k], r);
  return out;
}

// One affine form of the descriptor at `pos` (advanced past it), canonical.
__device__ __forceinline__ uint32_t affine(const uint32_t* s, int& pos, const int32_t* mrow,
                                           const int32_t* prow) {
  uint32_t acc = s[pos];
  const int nt = (int)s[pos + 1];
  pos += 2;
  for (int t = 0; t < nt; ++t) {
    const uint32_t col = s[pos + 1], wm = s[pos + 2];
    const uint32_t x = (uint32_t)(s[pos] ? prow[col] : mrow[col]);
    acc = kb::add(acc, kb::mont_mul(x, wm));  // x * w, canonical
    pos += 3;
  }
  return acc;
}

__global__ void __launch_bounds__(ENTRY_THREADS)
entries_kernel(const int32_t* __restrict__ main, int w, const int32_t* __restrict__ prep, int pw,
               int n, const int32_t* __restrict__ desc, int desc_len,
               const int32_t* __restrict__ chal, int n_chal, int32_t* __restrict__ out,
               int n_inter, int batch, int nb) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_desc = smem;               // desc_len words
  uint32_t* s_chal = smem + desc_len;    // alpha (canonical), then beta^0.. (Montgomery)
  for (int i = threadIdx.x; i < desc_len; i += blockDim.x) s_desc[i] = (uint32_t)desc[i];
  for (int i = threadIdx.x; i < 4 * n_chal; i += blockDim.x)
    s_chal[i] = i < 4 ? (uint32_t)chal[i] : kb::to_mont((uint32_t)chal[i]);
  __syncthreads();

  const size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (size_t)n) return;
  const int32_t* mrow = main + row * w;
  const int32_t* prow = prep ? prep + row * pw : nullptr;

  E4 den[MAX_I];       // denominators (Montgomery); later the terms (canonical)
  uint32_t mult[MAX_I];  // +-m, canonical
  uint32_t zero_mask = 0;
  const uint32_t one_m = kb::to_mont(1u);
  int pos = 0;
#pragma unroll
  for (int i = 0; i < MAX_I; ++i) {
    if (i < n_inter) {
      const uint32_t sign = s_desc[pos], arg = s_desc[pos + 1];
      const int nv = (int)s_desc[pos + 2];
      pos += 3;
      uint32_t d[4] = {kb::add(s_chal[0], arg), s_chal[1], s_chal[2], s_chal[3]};
      for (int j = 0; j < nv; ++j) {
        const uint32_t v = affine(s_desc, pos, mrow, prow);
        const uint32_t* bp = s_chal + 4 * (j + 2);  // beta^(j+1)
        for (int k = 0; k < 4; ++k) d[k] = kb::add(d[k], kb::mont_mul(v, bp[k]));
      }
      const uint32_t m = affine(s_desc, pos, mrow, prow);
      mult[i] = sign ? m : kb::sub(0u, m);
      const bool zero = (d[0] | d[1] | d[2] | d[3]) == 0u;
      zero_mask |= (uint32_t)zero << i;
      for (int k = 0; k < 4; ++k) den[i].c[k] = kb::to_mont(d[k]);
      if (zero) den[i].c[0] = one_m;
    }
  }

  E4 pref[MAX_I], total;
#pragma unroll
  for (int i = 0; i < MAX_I; ++i) {
    if (i < n_inter) {
      pref[i] = i == 0 ? den[0] : emul(pref[i > 0 ? i - 1 : 0], den[i]);
      total = pref[i];
    }
  }
  E4 inv = einv(total);
#pragma unroll
  for (int i = MAX_I - 1; i >= 0; --i) {
    if (i < n_inter) {
      E4 inv_i = i > 0 ? emul(inv, pref[i > 0 ? i - 1 : 0]) : inv;
      if (i > 0) inv = emul(inv, den[i]);
      const bool zero = (zero_mask >> i) & 1u;
      for (int k = 0; k < 4; ++k) den[i].c[k] = zero ? 0u : kb::mont_mul(inv_i.c[k], mult[i]);
    }
  }

  int32_t* orow = out + row * (size_t)(nb + 1) * 4;
  uint32_t bsum[4] = {0u, 0u, 0u, 0u}, rsum[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < MAX_I; ++i) {
    if (i < n_inter) {
      for (int k = 0; k < 4; ++k) bsum[k] = kb::add(bsum[k], den[i].c[k]);
      if ((i + 1) % batch == 0 || i == n_inter - 1) {
        const int b = i / batch;
        for (int k = 0; k < 4; ++k) {
          orow[4 * b + k] = (int32_t)bsum[k];
          rsum[k] = kb::add(rsum[k], bsum[k]);
          bsum[k] = 0u;
        }
      }
    }
  }
  for (int k = 0; k < 4; ++k) orow[4 * nb + k] = (int32_t)rsum[k];
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
// beta^j.  n_inter <= 16.
extern "C" int zkbf_logup_entries(const void* main, int w, const void* prep, int pw, int n,
                                  const void* desc, int desc_len, const void* chal, int n_chal,
                                  void* out, int n_inter, int batch, int nb, void* stream) {
  if (n < 1 || n_inter < 1 || n_inter > MAX_I || batch < 1 || nb != (n_inter + batch - 1) / batch ||
      (pw > 0 && prep == nullptr) || n_chal < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * ((size_t)desc_len + 4 * (size_t)n_chal);
  const int blocks = (n + ENTRY_THREADS - 1) / ENTRY_THREADS;
  entries_kernel<<<blocks, ENTRY_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(main), w, static_cast<const int32_t*>(prep), pw, n,
      static_cast<const int32_t*>(desc), desc_len, static_cast<const int32_t*>(chal), n_chal,
      static_cast<int32_t*>(out), n_inter, batch, nb);
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
