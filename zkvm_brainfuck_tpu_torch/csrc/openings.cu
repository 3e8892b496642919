// The PCS opening rounds over KoalaBear and EF4 = F_p[x] / (x^4 - 3): the
// opened values (barycentric raw sums) and the reduced openings.
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/):
//   - stark/pcs.py:467 _open_eval_group_program, with ops/field.py:191
//     fsum_rows and ops/ext.py:162 einv inside it -> zkbf_open_eval;
//   - stark/pcs.py:542 _ro_group_program over :923 _ro_accum_traced, and the
//     accumulation half of :565 _ro_src_group_program -> zkbf_ro_accum.
//
// Both work on one unit: M member matrices of h rows (canonical int32,
// row-major, widths w_k, W = sum w_k columns in all) evaluated on the points
// x_i = shift * g^(row0 + i), i < h, g the generator of the order-2^log_m
// subgroup (a mesh shard passes its first row as row0), and one EF4 point z
// outside the domain.
//   - open_eval_kernel: S[c] = sum_i f_c(x_i) * x_i * inv(x_i - z), for every
//     column c of every member: a (W, 4) canonical output.
//   - ro_accum_kernel: per row, (sum_c alpha_c f_c(x_i) - S) * inv(x_i - z),
//     with alpha_c the (W, 4) alpha powers of the columns and S one EF4
//     value, written into the (h, 4) reduced opening (`first`) or added to
//     it in place.
//
// What bounds them on the H100: the bytes.  Both read every member once (4
// bytes an element; ro_accum also reads and writes 16 bytes a row).  Their
// column products are products of the (h, W) member matrix with a small
// matrix (the rows' 4 EF4 weights, or the columns' 4 alpha powers), which
// the int8 tensor cores do exactly (below); what is left on the INT32 lanes
// is a row's EF4 inverse and its EF4 work, under a third of the bytes' time
// at 106 columns (chip_smoke.py launch_bounds).
//
// The products on the tensor cores.  A canonical value is 4 bytes, so a
// product a * f mod p is sum_j (a * 2^(8j) mod p) * byte_j(f), and a value
// below p is sum_b 2^(8b) byte_b: a sum of byte products, each at most
// 255^2, which mma.sync m16n8k32 (u8 x u8, 32-bit sums) adds exactly.  The
// byte shift of one factor is folded into the other factor's bytes, so a
// product costs 4 byte-planes (not 16) and one 64-bit recombination
// sum_b 2^(8b) D_b at the end, reduced mod p.
// - open_eval: A (16 x 32) = the weights w_e = x inv(x - z): row 4e + b,
//   column = one of 32 tile rows, byte b of w_e 2^(8j) mod p, for j = 0..3;
//   B (32 x 8) = byte j of 8 columns of those rows.  The four j's add into
//   one accumulator: 4 x 255^2 a row, so the 32-bit sums are moved out
//   (recombined mod p into the block's sums) every 8192 rows.
// - ro_accum: A (16 x 32) = 16 tile rows x the 4 bytes of 8 columns (a
//   register is one canonical word, no byte shuffling); B (32 x 16) = a
//   table built once a launch, byte b of alpha[c, e] 2^(8a) mod p at row
//   (c, a), column (e, b).  4 x 255^2 a column: the 32-bit sums go into 64
//   bits after each member (at most 4,096 columns).
//
// Design.
// - Staging: a block takes a contiguous range of tiles of `rows` rows (64,
//   or 32 for a unit too wide for two tiles of 64 in shared memory).  One
//   producer warp copies each tile into a ring of two buffers: a member's
//   rows of a tile are one contiguous run of memory, copied as it is by one
//   TMA bulk copy (cp.async.bulk, completing on the buffer's "full"
//   mbarrier), or, where the run is not 16-byte aligned or not a multiple
//   of 16 bytes, by the warp's 4-byte cp.async (arriving on the same
//   mbarrier).  The consumer warps wait on "full", compute, and arrive on
//   the buffer's "empty" mbarrier, which the producer waits on before it
//   copies into the buffer again.  So the copies stay in flight while the
//   consumers compute; a first design in which every thread issued 4-byte
//   copies, then computed, serialized the two (probes/openings_cp_async.cu,
//   timed by probes/openings_variants.py; PERF.md section 6).
// - Points: each thread that owns a row computes its x once, by a
//   square-and-multiply power of g, then steps it by a power of g as its
//   row moves on: no table of points is read.
// - Inverses: a row's EF4 inverse is a chain of about 100 dependent
//   products, so its latency sets its pace.  Threads of their own compute
//   them one ring slot ahead of the threads that use them (a ring of two
//   slots with its own "full" and "empty" mbarriers), so that the inverses
//   of the next rows are made while the products of these rows run; made
//   by the consumers themselves before each tile, they added about half of
//   the bytes' time.
// - open_eval: 4 product warps, 4 weight warps, 1 producer warp.  A weight
//   thread computes one row's weights w_e = x inv(x - z) of each batch of
//   128 rows into byte planes in shared memory (two batches in the ring);
//   the product warps take the unit's 8-column steps in turn over each
//   tile.  Each step keeps its 32-bit accumulators in shared memory across
//   tiles; at a flush the warp adds 2^(8b) times the 4 lanes' b-sums in 64
//   bits (below 2^56), reduces mod p and adds into the block's (W, 4) sums.
//   Each block adds its sums (mod p) to a 64-bit scratch with atomics once,
//   and the last block to arrive (a ticket in the scratch, as poseidon2.cu's
//   tree walk hands off) reduces the W x 4 sums mod p and writes them.  The
//   sums are exact integers, so the order of the atomics cannot change a
//   bit.  The launcher clears the scratch on the caller's stream first.
// - ro_accum: `rows` consumer threads, a thread a row, a warp 32 rows (two
//   m16 tiles), `rows` inverse threads (a tile's inv(x - z) into their
//   ring), and the producer warp.  The consumer warps run the products
//   member by member, add each member's sums into 64 bits, recombine
//   T[i, e] = sum_b 2^(8b) D[i, (e, b)] across a lane pair (below 2^59) and
//   reduce it mod p; each thread then subtracts S, makes one EF4 product and
//   writes (or adds into) its 16-byte reduced-opening row, copied in with
//   the tile.
// Inverses are unique, so the bits equal the JAX package's and the plain
// versions' (ops/openings.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "ef4.cuh"
#include "koalabear.cuh"

#define ZKBF_OPEN_MAX_MEMBERS 16

namespace {

using namespace ef4;

constexpr int STAGES = 2;  // tile buffers of the ring
// open_eval: 4 product warps, then 4 weight warps (a batch of WEIGHT_ROWS
// rows' weights, a thread a row), then the producer warp
constexpr int OPEN_WARPS = 4;
constexpr int WEIGHT_ROWS = 128;
constexpr int OPEN_THREADS = 32 * OPEN_WARPS + WEIGHT_ROWS + 32;
constexpr int RO_MAX_ROWS = 64;  // ro_accum: consumer threads = inverse threads = rows of its tile
constexpr int TILE_ROWS[2] = {64, 32};  // a launch takes the first whose buffers fit
// Bytes of one weight byte plane: WEIGHT_ROWS and 32 more, 40 words, so that
// the planes of g = 0..3 (a half-warp's 8-byte loads) start 40 words apart,
// in distinct 8-bank windows.
constexpr int PLANE = WEIGHT_ROWS + 32;
constexpr int SLACK = 8;  // words past a staged tile that an 8-column step may read
constexpr int FLUSH_ROWS = 8192;  // rows an open_eval accumulator takes: 8192 x 4 x 255^2 < 2^31
constexpr int SMEM_LIMIT = 227 * 1024 - 1024;  // dynamic shared memory a block may ask for
constexpr unsigned FULL = 0xffffffffu;

struct Members {
  const int32_t* ptr[ZKBF_OPEN_MAX_MEMBERS];
  int width[ZKBF_OPEN_MAX_MEMBERS];
  int off[ZKBF_OPEN_MAX_MEMBERS];   // first column of member k in the concatenation
  int soff[ZKBF_OPEN_MAX_MEMBERS];  // first word of member k in a staged tile
  int coff[ZKBF_OPEN_MAX_MEMBERS];  // ro_accum: first column of member k in the alpha table
  int count;
  int total;  // W
  int steps;  // 8-column steps: sum of ceil(w_k / 8)
  int cpad;   // columns of the alpha table: sum of w_k rounded up to 8
  int span;   // words of one staged tile
};

// b^e for b in Montgomery form (the result in Montgomery form).
__device__ __forceinline__ uint32_t mpow(uint32_t b, unsigned e) {
  uint32_t r = ONE_M;
  while (e) {
    if (e & 1u) r = kb::mont_mul(r, b);
    b = kb::mont_mul(b, b);
    e >>= 1;
  }
  return r;
}

// inv(x - z) in Montgomery form, for x and z in Montgomery form.
__device__ __forceinline__ E4 inv_x_minus_z(uint32_t x, const E4& z) {
  const E4 a = {{kb::sub(x, z.c[0]), neg(z.c[1]), neg(z.c[2]), neg(z.c[3])}};
  return einv(a);
}

// v mod p for any 64-bit v = hi 2^32 + lo: hi 2^32 as one Montgomery product
// by 2^64 mod p (a first factor below 2^32 keeps it below 2p), lo by two
// conditional subtractions.
__device__ __forceinline__ uint32_t mod_u64(unsigned long long v) {
  uint32_t lo = (uint32_t)v;
  lo = lo >= 2u * kb::P ? lo - 2u * kb::P : lo;
  lo = lo >= kb::P ? lo - kb::P : lo;
  return kb::add(kb::mont_mul((uint32_t)(v >> 32), kb::R2), lo);
}

// The 4 x 4 byte transpose: out[j] holds byte j of in[0], in[1], in[2],
// in[3], in that order.
__device__ __forceinline__ void transpose4(const uint32_t* in, uint32_t* out) {
  const uint32_t lo01 = __byte_perm(in[0], in[1], 0x5140), hi01 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t lo23 = __byte_perm(in[2], in[3], 0x5140), hi23 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// D += A B on the integer tensor cores: A (16 x 32) and B (32 x 8) unsigned
// bytes, D (16 x 8) 32-bit sums, in the m16n8k32 fragments (PTX ISA, the
// mma.m16n8k32 fragments for .u8): lane (g = lane / 4, t = lane % 4) holds
// A's rows g and g + 8 at K 4t..4t+3 (a0, a1) and at K 16+4t..19+4t (a2,
// a3), B's column g at K 4t..4t+3 (b0) and 16+4t..19+4t (b1), the lower K
// in the lower byte, and D's rows g (d.x, d.y) and g + 8 (d.z, d.w) at
// columns 2t and 2t + 1.
__device__ __forceinline__ void mma_u8(int4& d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d.x), "+r"(d.y), "+r"(d.z), "+r"(d.w)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The ring of tile buffers: mbarriers, TMA bulk copies, cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, counted on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrivals a "full" mbarrier takes each phase: the producer's lane 0 with the
// bulk bytes, and each of its 32 lanes once its cp.async copies have landed.
constexpr unsigned FULL_ARRIVALS = 1 + 32;

__device__ __forceinline__ bool bulk_ok(const void* src, unsigned bytes) {
  return ((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0;
}

// The producer warp's copy of rows [r0, r0 + nrows) of every member into the
// staged tile `buf` (member k's rows from word soff[k], as they lie in
// memory) and, when `ro` is given, of the reduced-opening rows into `rows16`;
// completion on `full`.
__device__ __forceinline__ void produce(const Members& m, uint32_t* buf, int r0, int nrows,
                                        const int32_t* ro, uint4* rows16, uint64_t* full,
                                        int lane) {
  if (lane == 0) {
    unsigned bytes = 0;
    for (int k = 0; k < m.count; ++k) {
      const unsigned n = 4u * (unsigned)(nrows * m.width[k]);
      if (bulk_ok(m.ptr[k] + (size_t)r0 * m.width[k], n)) bytes += n;
    }
    if (ro != nullptr) bytes += 16u * (unsigned)nrows;
    mbar_arrive_expect_tx(full, bytes);
    for (int k = 0; k < m.count; ++k) {
      const int32_t* src = m.ptr[k] + (size_t)r0 * m.width[k];
      const unsigned n = 4u * (unsigned)(nrows * m.width[k]);
      if (bulk_ok(src, n)) bulk_copy(buf + m.soff[k], src, n, full);
    }
    if (ro != nullptr) bulk_copy(rows16, ro + 4 * (size_t)r0, 16u * (unsigned)nrows, full);
  }
  for (int k = 0; k < m.count; ++k) {
    const int32_t* src = m.ptr[k] + (size_t)r0 * m.width[k];
    const int count = nrows * m.width[k];
    if (bulk_ok(src, 4u * (unsigned)count)) continue;
    for (int i = lane; i < count; i += 32) cp_async4(buf + m.soff[k] + i, src + i);
  }
  cp_async_arrive(full);
}

// Tiles [lo, hi) of n_tiles for this block: contiguous, as even as can be.
__device__ __forceinline__ void my_tiles(int n_tiles, int& lo, int& hi) {
  lo = (int)((long long)n_tiles * blockIdx.x / gridDim.x);
  hi = (int)((long long)n_tiles * (blockIdx.x + 1) / gridDim.x);
}

// ---------------------------------------------------------------------------
// open_eval
// ---------------------------------------------------------------------------

// Shared memory of open_eval: two batches of the weights' byte planes (2 x
// 64 x PLANE bytes),
// the steps' 32-bit accumulators (steps x 32 lanes x 16 bytes), the block's
// sums (W x 4 words, mod p), the steps' (member, first column), two staged
// tiles of `span` words.
__host__ __device__ constexpr size_t open_smem_bytes(int steps, int total, int span) {
  return 128 * (size_t)PLANE + 512 * (size_t)steps + 16 * (size_t)total +
         16 * (size_t)((steps + 1) / 2) + 4 * (size_t)STAGES * span;
}

// Row r's weights w_e = x inv(x - z), e < 4, from inv = inv(x - z), as
// byte planes: byte b of w_e 2^(8j) mod p at byte r of plane 16 j + 4 e + b;
// zeros for a row past the unit, so that its stale tile words add nothing.
__device__ __forceinline__ void put_weights(uint8_t* s_pl, int r, bool valid, uint32_t x,
                                            const E4& inv) {
  uint32_t wm[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) wm[e] = valid ? kb::mont_mul(inv.c[e], x) : 0u;  // Montgomery form
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t v = kb::mont_mul(wm[e], 1u << (8 * j));  // canonical w_e 2^(8j) mod p
#pragma unroll
      for (int b = 0; b < 4; ++b) s_pl[(16 * j + 4 * e + b) * PLANE + r] = (uint8_t)(v >> (8 * b));
    }
}

// The warp's 8-column steps over a staged tile, whose weights start at byte
// `wrow` of the planes.  K = 32 tile rows a k-step, permuted so that lane
// t's 8 B words are rows kb + 8t .. kb + 8t + 7 of its column, and its A
// words are the bytes of the same rows in the planes.
__device__ __forceinline__ void open_mma(const Members& m, const uint32_t* tile, const uint8_t* s_pl,
                                         int wrow, int4* s_acc, const int2* s_step, int nrows,
                                         int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int st = warp; st < m.steps; st += OPEN_WARPS) {
    const int2 d = s_step[st];
    const int w = m.width[d.x];
    const uint32_t* col = tile + m.soff[d.x] + d.y + g;
    int4 acc = s_acc[32 * st + lane];
    for (int kb = 0; kb < nrows; kb += 32) {
      const uint32_t* src = col + (kb + 8 * t) * w;
      uint32_t f[8], b0[4], b1[4];
#pragma unroll
      for (int q = 0; q < 8; ++q) f[q] = src[q * w];
      transpose4(f, b0);
      transpose4(f + 4, b1);
      const uint8_t* pa = s_pl + g * PLANE + wrow + kb + 8 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 lo = *reinterpret_cast<const uint2*>(pa + 16 * j * PLANE);       // e = g / 4
        const uint2 hi = *reinterpret_cast<const uint2*>(pa + (16 * j + 8) * PLANE);  // e = 2 + g / 4
        mma_u8(acc, lo.x, hi.x, lo.y, hi.y, b0[j], b1[j]);
      }
    }
    s_acc[32 * st + lane] = acc;
  }
}

// Each of the warp's steps: the 32-bit sums D[(e, b), c], lane g % 4 = b of
// a (g / 4, t) group, shifted by 2^(8b) and added over the group in 64 bits
// (below 2^56), reduced mod p and added into the block's sums; the
// accumulators cleared.
__device__ __forceinline__ void open_flush(const Members& m, int4* s_acc, uint32_t* s_res,
                                           const int2* s_step, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3, sh = 8 * (g & 3);
  for (int st = warp; st < m.steps; st += OPEN_WARPS) {
    const int4 a = s_acc[32 * st + lane];
    s_acc[32 * st + lane] = make_int4(0, 0, 0, 0);
    unsigned long long v[4] = {(unsigned long long)(uint32_t)a.x << sh,
                               (unsigned long long)(uint32_t)a.y << sh,
                               (unsigned long long)(uint32_t)a.z << sh,
                               (unsigned long long)(uint32_t)a.w << sh};
#pragma unroll
    for (int o = 4; o <= 8; o <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(FULL, v[i], o);
    if ((g & 3) == 0) {
      const int2 d = s_step[st];
      const int w = m.width[d.x];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = d.y + 2 * t + (i & 1);  // D rows g (i < 2) and g + 8: e = g / 4 and 2 + g / 4
        if (c < w) {
          uint32_t* dst = s_res + 4 * (m.off[d.x] + c) + (g >> 2) + 2 * (i >> 1);
          *dst = kb::add(*dst, mod_u64(v[i]));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(OPEN_THREADS, 2)
open_eval_kernel(const __grid_constant__ Members m, int h, int rows, uint32_t g_m, uint32_t shift_m,
                 int row0, E4 z_m, unsigned long long* scratch, int32_t* __restrict__ out) {
  extern __shared__ uint4 open_smem[];
  __shared__ uint64_t s_full[STAGES], s_empty[STAGES], s_w_full[2], s_w_empty[2];
  __shared__ bool s_last;
  uint8_t* s_pl = reinterpret_cast<uint8_t*>(open_smem);  // batch b's planes at b * 64 * PLANE
  int4* s_acc = reinterpret_cast<int4*>(s_pl + 128 * PLANE);
  uint32_t* s_res = reinterpret_cast<uint32_t*>(s_acc + 32 * (size_t)m.steps);
  int2* s_step = reinterpret_cast<int2*>(s_res + 4 * (size_t)m.total);
  uint32_t* s_f = reinterpret_cast<uint32_t*>(s_step + 2 * ((m.steps + 1) / 2));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 32 * m.steps; i += blockDim.x) s_acc[i] = make_int4(0, 0, 0, 0);
  for (int i = tid; i < 4 * m.total; i += blockDim.x) s_res[i] = 0u;
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < m.count; ++k)
      for (int c0 = 0; c0 < m.width[k]; c0 += 8) s_step[n++] = make_int2(k, c0);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&s_full[s], FULL_ARRIVALS);
      mbar_init(&s_empty[s], OPEN_WARPS);
      mbar_init(&s_w_full[s], WEIGHT_ROWS);
      mbar_init(&s_w_empty[s], OPEN_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int lo, hi;
  my_tiles((h + rows - 1) / rows, lo, hi);
  const int per_batch = WEIGHT_ROWS / rows;  // tiles a batch of weights covers
  if (warp == OPEN_THREADS / 32 - 1) {  // the producer
    for (int i = 0, tile = lo; tile < hi; ++i, ++tile) {
      const int s = i % STAGES;
      mbar_wait(&s_empty[s], ((i / STAGES) & 1) ^ 1);
      produce(m, s_f + s * m.span, tile * rows, min(rows, h - tile * rows), nullptr, nullptr,
              &s_full[s], lane);
    }
  } else if (warp >= OPEN_WARPS) {  // a weight thread: row r of each batch
    const int r = tid - 32 * OPEN_WARPS;
    uint32_t x = kb::mont_mul(shift_m, mpow(g_m, (unsigned)row0 + (unsigned)lo * rows + r));
    const uint32_t step = mpow(g_m, WEIGHT_ROWS);
    for (int b = 0, tile = lo; tile < hi; ++b, tile += per_batch) {
      const int q = b & 1;
      const E4 inv = inv_x_minus_z(x, z_m);
      mbar_wait(&s_w_empty[q], ((b >> 1) & 1) ^ 1);
      put_weights(s_pl + q * 64 * PLANE, r, tile * rows + r < h, x, inv);
      x = kb::mont_mul(x, step);
      mbar_arrive(&s_w_full[q]);
    }
  } else {  // a product warp
    int since_flush = 0;
    for (int i = 0, tile = lo; tile < hi; ++i, ++tile) {
      const int sub = i % per_batch, b = i / per_batch, s = i % STAGES;
      if (since_flush == FLUSH_ROWS / rows) {
        open_flush(m, s_acc, s_res, s_step, warp, lane);
        since_flush = 0;
      }
      if (sub == 0) mbar_wait(&s_w_full[b & 1], (b >> 1) & 1);
      mbar_wait(&s_full[s], (i / STAGES) & 1);
      open_mma(m, s_f + s * m.span, s_pl + (b & 1) * 64 * PLANE, sub * rows, s_acc, s_step,
               min(rows, h - tile * rows), warp, lane);
      ++since_flush;
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&s_empty[s]);
        if (sub == per_batch - 1) mbar_arrive(&s_w_empty[b & 1]);
      }
    }
    open_flush(m, s_acc, s_res, s_step, warp, lane);
  }
  __syncthreads();
  for (int i = tid; i < 4 * m.total; i += blockDim.x) atomicAdd(scratch + i, (unsigned long long)s_res[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + 4 * (size_t)m.total);
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < 4 * m.total; i += blockDim.x)
    out[i] = (int32_t)(__ldcg(scratch + i) % kb::P);
}

// ---------------------------------------------------------------------------
// ro_accum
// ---------------------------------------------------------------------------

// Shared memory of ro_accum at `rows` rows a tile: the reduced-opening rows
// and the rows' inverses (each STAGES x rows x 16 bytes), the rows' T (rows x
// 16 bytes), the alpha table (2 x cpad x 8 words), the staged tiles.
__host__ __device__ constexpr size_t ro_smem_bytes(int rows, int cpad, int span) {
  return 16 * (size_t)(2 * STAGES + 1) * rows + 64 * (size_t)cpad + 4 * (size_t)STAGES * span;
}

__global__ void __launch_bounds__(2 * RO_MAX_ROWS + 32, 3)
ro_accum_kernel(const __grid_constant__ Members m, int h, uint32_t g_m, uint32_t shift_m, int row0,
                E4 z_m, E4 s, const int32_t* __restrict__ alpha_pows, int32_t* ro, int first) {
  extern __shared__ uint4 ro_smem[];
  __shared__ uint64_t s_full[STAGES], s_empty[STAGES], s_inv_full[STAGES], s_inv_empty[STAGES];
  const int rows = (blockDim.x - 32) / 2, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint4* s_ro = ro_smem;
  uint4* s_inv = s_ro + STAGES * rows;  // inv(x - z) of each row, Montgomery form
  uint4* s_t = s_inv + STAGES * rows;
  // the alpha table: word (n * cpad + c) * 8 + 4 (e % 2) + b, n = e / 2, holds
  // byte b of alpha[c, e] 2^(8a) mod p at its byte a (zero past a member's
  // width): B's column 8n + 4 (e % 2) + b at K rows (c, a)
  uint32_t* s_b = reinterpret_cast<uint32_t*>(s_t + rows);
  uint32_t* s_f = s_b + 16 * (size_t)m.cpad;
  for (int i = tid; i < 4 * m.cpad; i += blockDim.x) {
    const int cp = i >> 2, e = i & 3;
    int k = 0;
    while (k + 1 < m.count && cp >= m.coff[k + 1]) ++k;
    const int c = cp - m.coff[k];
    const uint32_t a = c < m.width[k]
        ? kb::to_mont((uint32_t)__ldg(alpha_pows + 4 * (size_t)(m.off[k] + c) + e)) : 0u;
    uint32_t v[4], wd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = kb::mont_mul(a, 1u << (8 * j));  // canonical alpha 2^(8j)
    transpose4(v, wd);
    *reinterpret_cast<uint4*>(s_b + 8 * ((size_t)(e >> 1) * m.cpad + cp) + 4 * (e & 1)) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
  if (tid == 0) {
    for (int q = 0; q < STAGES; ++q) {
      mbar_init(&s_full[q], FULL_ARRIVALS);
      mbar_init(&s_empty[q], rows / 32);
      mbar_init(&s_inv_full[q], rows);
      mbar_init(&s_inv_empty[q], rows / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int lo, hi;
  my_tiles((h + rows - 1) / rows, lo, hi);
  if (tid >= 2 * rows) {  // the producer
    for (int i = 0, tile = lo; tile < hi; ++i, ++tile) {
      const int q = i % STAGES;
      mbar_wait(&s_empty[q], ((i / STAGES) & 1) ^ 1);
      produce(m, s_f + q * m.span, tile * rows, min(rows, h - tile * rows), first ? nullptr : ro,
              s_ro + q * rows, &s_full[q], lane);
    }
    return;
  }
  if (tid >= rows) {  // an inverse thread: row tid - rows of each tile
    const int r = tid - rows;
    uint32_t x = kb::mont_mul(shift_m, mpow(g_m, (unsigned)row0 + (unsigned)lo * rows + r));
    const uint32_t step = mpow(g_m, (unsigned)rows);
    for (int i = 0, tile = lo; tile < hi; ++i, ++tile) {
      const int q = i % STAGES;
      const E4 inv = inv_x_minus_z(x, z_m);
      x = kb::mont_mul(x, step);
      mbar_wait(&s_inv_empty[q], ((i / STAGES) & 1) ^ 1);
      s_inv[q * rows + r] = make_uint4(inv.c[0], inv.c[1], inv.c[2], inv.c[3]);
      mbar_arrive(&s_inv_full[q]);
    }
    return;
  }
  for (int i = 0, tile = lo; tile < hi; ++i, ++tile) {
    const int r0 = tile * rows, nrows = min(rows, h - r0), q = i % STAGES;
    mbar_wait(&s_full[q], (i / STAGES) & 1);

    // D[i, (e, b)] for the warp's rows 32 warp + 16 mt + (g, g + 8): K = 8
    // columns x 4 bytes a k-step, lane t's A words columns c0 + t and
    // c0 + 4 + t; each member's sums in 64 bits as D_b + 2^8 D_(b+1) of the
    // lane's pair b = 2 (t % 2), 2 (t % 2) + 1 of e = 2 n + t / 2
    const uint32_t* tl = s_f + q * m.span;
    unsigned long long acc[2][2][2] = {};  // [m-tile][n][row g, g + 8]
    for (int k = 0; k < m.count; ++k) {
      const int w = m.width[k];
      const uint32_t* fa = tl + m.soff[k] + (32 * warp + g) * w + t;
      const uint32_t* fb = s_b + 8 * (m.coff[k] + t) + g;
      int4 d[2][2] = {};
      for (int c0 = 0; c0 < w; c0 += 8) {
        uint32_t bq[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          bq[n][0] = fb[8 * (n * m.cpad + c0)];
          bq[n][1] = fb[8 * (n * m.cpad + c0 + 4)];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* r = fa + 16 * mt * w + c0;
          const uint32_t a0 = r[0], a1 = r[8 * w], a2 = r[4], a3 = r[8 * w + 4];
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_u8(d[mt][n], a0, a1, a2, a3, bq[n][0], bq[n][1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[mt][n][0] += (unsigned long long)(uint32_t)d[mt][n].x +
                           ((unsigned long long)(uint32_t)d[mt][n].y << 8);
          acc[mt][n][1] += (unsigned long long)(uint32_t)d[mt][n].z +
                           ((unsigned long long)(uint32_t)d[mt][n].w << 8);
        }
    }
    // T[i, e] = the pair b = 0, 1 + 2^16 the pair b = 2, 3 (lane t ^ 1)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const unsigned long long v = acc[mt][n][hf];
          const unsigned long long o = __shfl_xor_sync(FULL, v, 1);
          if ((t & 1) == 0)
            reinterpret_cast<uint32_t*>(s_t + 32 * warp + 16 * mt + 8 * hf + g)[2 * n + (t >> 1)] =
                mod_u64(v + (o << 16));
        }
    __syncwarp();
    mbar_wait(&s_inv_full[q], (i / STAGES) & 1);
    if (tid < nrows) {
      const uint4 tv = s_t[tid], iv = s_inv[q * rows + tid];
      const E4 inv = {{iv.x, iv.y, iv.z, iv.w}};
      const E4 diff = {{kb::sub(tv.x, s.c[0]), kb::sub(tv.y, s.c[1]), kb::sub(tv.z, s.c[2]),
                        kb::sub(tv.w, s.c[3])}};
      const E4 qv = emul(diff, inv);  // canonical times Montgomery: canonical
      uint4 v = make_uint4(qv.c[0], qv.c[1], qv.c[2], qv.c[3]);
      if (!first) {
        const uint4 old = s_ro[q * rows + tid];
        v = make_uint4(kb::add(old.x, v.x), kb::add(old.y, v.y), kb::add(old.z, v.z),
                       kb::add(old.w, v.w));
      }
      reinterpret_cast<uint4*>(ro)[r0 + tid] = v;
    }
    __syncwarp();  // the tile, the rows, their inverses and T are read
    if (lane == 0) {
      mbar_arrive(&s_empty[q]);
      mbar_arrive(&s_inv_empty[q]);
    }
  }
}

uint32_t to_mont_host(uint32_t a) { return (uint32_t)(((uint64_t)a << 32) % kb::P); }

E4 e4_host(const uint32_t* v, bool mont) {
  E4 e;
  for (int k = 0; k < 4; ++k) e.c[k] = mont ? to_mont_host(v[k]) : v[k];
  return e;
}

// The members from the caller's arrays; false if they do not fit a launch.
bool members(const void* const* ptrs, const int* widths, int n, Members& m) {
  if (n < 1 || n > ZKBF_OPEN_MAX_MEMBERS) return false;
  m.count = n;
  m.total = m.steps = m.cpad = 0;
  for (int k = 0; k < ZKBF_OPEN_MAX_MEMBERS; ++k) {
    const bool used = k < n;
    if (used && (ptrs[k] == nullptr || widths[k] < 1 || widths[k] > 4096)) return false;
    const int w = used ? widths[k] : 0;
    m.ptr[k] = used ? static_cast<const int32_t*>(ptrs[k]) : nullptr;
    m.width[k] = w;
    m.off[k] = m.total;
    m.coff[k] = m.cpad;
    m.total += w;
    m.steps += (w + 7) / 8;
    m.cpad += (w + 7) & ~7;
  }
  return true;
}

// The staged tile's offsets at `rows` rows a tile (a multiple of 4, so that
// every member's run starts 16-byte aligned).
void layout(Members& m, int rows) {
  int words = 0;
  for (int k = 0; k < ZKBF_OPEN_MAX_MEMBERS; ++k) {
    m.soff[k] = words;
    words += rows * m.width[k];
  }
  m.span = (words + SLACK + 3) & ~3;
}

// Blocks of `kernel` the card holds at once with `smem` bytes each, at most
// `tiles`.
template <typename K>
cudaError_t grid_for(K kernel, int threads, size_t smem, int tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  *blocks = (int)(most < tiles ? most : tiles);
  return cudaSuccess;
}

}  // namespace

// The library links the CUDA runtime statically, so its current device is its
// own: the Python wrappers set it to the tensors' device before a launch.
extern "C" int zkbf_set_device(int device) { return (int)cudaSetDevice(device); }

// Words (8 bytes) of zkbf_open_eval's scratch for W columns: the 4 W sums
// and the ticket.
extern "C" long long zkbf_open_eval_scratch_words(int total) { return 4LL * total + 1; }

// out (W, 4) = the raw sums S[c] of the n_mats members (pointers and widths
// in host arrays; each (h, w_k) int32, canonical, row-major) on the points
// shift * g^(row0 + i); g and shift canonical, z 4 canonical words in a
// host array.  scratch: zkbf_open_eval_scratch_words(W) words, cleared here
// on `stream` before the launch.  A unit whose two staged tiles of 32 rows
// do not fit a block's shared memory is refused.
extern "C" int zkbf_open_eval(const void* const* ptrs, const int* widths, int n_mats, int h,
                              unsigned g, unsigned shift, int row0, const unsigned* z, void* out,
                              void* scratch, void* stream) {
  Members m;
  if (!members(ptrs, widths, n_mats, m) || h < 1 || row0 < 0 || z == nullptr || g >= kb::P ||
      shift == 0u || shift >= kb::P)
    return (int)cudaErrorInvalidValue;
  int rows = 0;
  size_t smem = 0;
  for (int r : TILE_ROWS) {
    layout(m, r);
    smem = open_smem_bytes(m.steps, m.total, m.span);
    if (smem <= (size_t)SMEM_LIMIT) {
      rows = r;
      break;
    }
  }
  if (rows == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 8 * (size_t)zkbf_open_eval_scratch_words(m.total), s);
  int blocks = 0;
  if (e == cudaSuccess)
    e = grid_for(open_eval_kernel, OPEN_THREADS, smem, (h + rows - 1) / rows, &blocks);
  if (e != cudaSuccess) return (int)e;
  open_eval_kernel<<<blocks, OPEN_THREADS, smem, s>>>(
      m, h, rows, to_mont_host(g), to_mont_host(shift), row0, e4_host(z, true),
      static_cast<unsigned long long*>(scratch), static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// ro (h, 4) int32, 16-byte aligned: per row i, (sum_c alpha_c f_c(x_i) - s)
// * inv(x_i - z) written (first != 0) or added mod p in place, over the
// n_mats members (as zkbf_open_eval) on the points shift * g^(row0 + i).
// alpha_pows: (W, 4) canonical int32 on the device, 16-byte aligned; s and z
// 4 canonical words in host arrays.  A unit whose two staged tiles of 32
// rows and alpha table do not fit a block's shared memory is refused.
extern "C" int zkbf_ro_accum(const void* const* ptrs, const int* widths, int n_mats, int h,
                             unsigned g, unsigned shift, int row0, const unsigned* z,
                             const unsigned* s, const void* alpha_pows, void* ro, int first,
                             void* stream) {
  Members m;
  if (!members(ptrs, widths, n_mats, m) || h < 1 || row0 < 0 || z == nullptr || s == nullptr ||
      g >= kb::P || shift == 0u || shift >= kb::P ||
      (reinterpret_cast<uintptr_t>(ro) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(alpha_pows) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int rows = 0;
  size_t smem = 0;
  for (int r : TILE_ROWS) {
    layout(m, r);
    smem = ro_smem_bytes(r, m.cpad, m.span);
    if (smem <= (size_t)SMEM_LIMIT) {
      rows = r;
      break;
    }
  }
  if (rows == 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = grid_for(ro_accum_kernel, 2 * rows + 32, smem, (h + rows - 1) / rows, &blocks);
  if (e != cudaSuccess) return (int)e;
  ro_accum_kernel<<<blocks, 2 * rows + 32, smem, (cudaStream_t)stream>>>(
      m, h, to_mont_host(g), to_mont_host(shift), row0, e4_host(z, true), e4_host(s, false),
      static_cast<const int32_t*>(alpha_pows), static_cast<int32_t*>(ro), first);
  return (int)cudaGetLastError();
}
