// The first tensor-core design of the opening kernels: the same products
// on the int8 tensor cores as csrc/openings.cu, but every thread of a block
// issues 4-byte cp.async copies of the next tile into rows padded to a
// bank-friendly pitch, then computes, with two __syncthreads a tile (and
// open_eval's weights 64 rows at a time, by 64 threads).  A probe's copy,
// timed beside csrc/openings.cu by probes/openings_variants.py; nothing on
// the proving path builds or launches it.  Its C interface is the same.
//
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
// - Staging: a block loops over tiles of `rows` rows (64, or 32 for a unit
//   too wide for two tiles of 64 in shared memory), two tile buffers: the
//   next tile's copy (cp.async, 4 bytes a word, each member's run of rows
//   contiguous in memory so a warp reads 128 contiguous bytes) is in flight
//   while the block computes the current tile's inverses and products.  A
//   member's staged rows are padded to a pitch that makes the fragment
//   loads conflict-free: odd for open_eval (the lanes of a load read rows
//   8 apart), 4 mod 8 for ro_accum (rows 1 apart, 4 columns).
// - Points: each thread that owns a row computes its x once, by a
//   square-and-multiply power of g, then steps it by g^(rows x blocks) from
//   one tile to the block's next: no table of points is read.
// - open_eval: 256 threads; the first `rows` compute a row's weights (one EF4
//   inverse each) into byte planes in shared memory, the 8 warps then take
//   the unit's 8-column steps in turn.  Each step keeps its 32-bit
//   accumulators in shared memory across tiles; at a flush the warp adds
//   2^(8b) times the 4 lanes' b-sums in 64 bits (below 2^56), reduces mod p
//   and adds into the block's (W, 4) sums.  Each block adds its sums (mod p)
//   to a 64-bit scratch with atomics once, and the last block to arrive (a
//   ticket in the scratch, as poseidon2.cu's tree walk hands off) reduces
//   the W x 4 sums mod p and writes them.  The sums are exact integers, so
//   the order of the atomics cannot change a bit.  The launcher clears the
//   scratch on the caller's stream first.
// - ro_accum: a thread a row, `rows` threads, a warp 32 rows (two m16
//   tiles).  A thread computes its row's inverse while the tile lands; the
//   warp runs the products member by member, adds each member's sums into
//   64 bits, recombines T[i, e] = sum_b 2^(8b) D[i, (e, b)] across a lane
//   pair (below 2^59), reduces mod p, and each thread subtracts S, makes one
//   EF4 product and writes (or adds into) its 16-byte reduced-opening row,
//   prefetched with the tile.
// Inverses are unique, so the bits equal the JAX package's and the plain
// versions' (ops/openings.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "ef4.cuh"
#include "koalabear.cuh"

#define ZKBF_OPEN_MAX_MEMBERS 16

namespace {

using namespace ef4;

constexpr int OPEN_THREADS = 256;
constexpr int OPEN_WARPS = OPEN_THREADS / 32;
constexpr int RO_MAX_ROWS = 64;  // ro_accum: threads of a block = rows of its tile
constexpr int TILE_ROWS[2] = {64, 32};  // a launch takes the first whose staging fits
// Bytes of one weight byte plane: at least a tile's rows, and 24 words, so
// that the planes of g = 0..3 (a half-warp's 8-byte loads) start 24 words
// apart, in distinct 8-bank windows.
constexpr int PLANE = 96;
constexpr int SLACK = 8;  // words past a staged tile that an 8-column step may read
constexpr int FLUSH_ROWS = 8192;  // rows an open_eval accumulator takes: 8192 x 4 x 255^2 < 2^31
constexpr int SMEM_LIMIT = 227 * 1024 - 1024;  // dynamic shared memory a block may ask for
constexpr unsigned FULL = 0xffffffffu;

struct Members {
  const int32_t* ptr[ZKBF_OPEN_MAX_MEMBERS];
  int width[ZKBF_OPEN_MAX_MEMBERS];
  int off[ZKBF_OPEN_MAX_MEMBERS];    // first column of member k in the concatenation
  int pitch[ZKBF_OPEN_MAX_MEMBERS];  // words of a staged row of member k
  int soff[ZKBF_OPEN_MAX_MEMBERS];   // first word of member k in a staged tile
  int coff[ZKBF_OPEN_MAX_MEMBERS];   // ro_accum: first column of member k in the alpha table
  unsigned long long magic[ZKBF_OPEN_MAX_MEMBERS];  // ceil(2^32 / width), for row = i / width
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Every group but the last committed has landed (this thread's copies).
__device__ __forceinline__ void cp_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + nrows) of every member into a staged tile, member k's row
// r at word soff[k] + r * pitch[k]: one 4-byte asynchronous copy a word, the
// block's threads on consecutive words of each member's contiguous run;
// word i of the run is row i / w, a multiply-high by magic = ceil(2^32 /
// w), exact for i < 2^32 / w.
__device__ __forceinline__ void stage_tile(uint32_t* buf, const Members& m, int r0, int nrows) {
  const uint32_t base = smem_addr(buf);
  for (int k = 0; k < m.count; ++k) {
    const int w = m.width[k], pw = m.pitch[k], count = nrows * w;
    const int32_t* src = m.ptr[k] + (size_t)r0 * w;
    const uint32_t dst = base + 4u * (uint32_t)m.soff[k];
    const unsigned long long magic = m.magic[k];
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = (int)(((unsigned long long)(unsigned)i * magic) >> 32);
      cp_async4(dst + 4u * (uint32_t)(r * pw + (i - r * w)), src + i);
    }
  }
}

// ---------------------------------------------------------------------------
// open_eval
// ---------------------------------------------------------------------------

// Shared memory of open_eval: the weights' byte planes (64 x PLANE bytes),
// the steps' 32-bit accumulators (steps x 32 lanes x 16 bytes), the block's
// sums (W x 4 words, mod p), the steps' (member, first column), two staged
// tiles of `span` words.
__host__ __device__ constexpr size_t open_smem_bytes(int steps, int total, int span) {
  return 64 * (size_t)PLANE + 512 * (size_t)steps + 16 * (size_t)total +
         16 * (size_t)((steps + 1) / 2) + 8 * (size_t)span;
}

// Row r's weights w_e = x inv(x - z), e < 4, as byte planes: byte b of
// w_e 2^(8j) mod p at byte r of plane 16 j + 4 e + b; zeros for a row past
// the unit, so that its stale tile words add nothing.
__device__ __forceinline__ void put_weights(uint8_t* s_pl, int r, bool valid, uint32_t x,
                                            const E4& z) {
  uint32_t wm[4] = {0u, 0u, 0u, 0u};
  if (valid) {
    const E4 inv = inv_x_minus_z(x, z);
#pragma unroll
    for (int e = 0; e < 4; ++e) wm[e] = kb::mont_mul(inv.c[e], x);  // Montgomery form
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t v = kb::mont_mul(wm[e], 1u << (8 * j));  // canonical w_e 2^(8j) mod p
#pragma unroll
      for (int b = 0; b < 4; ++b) s_pl[(16 * j + 4 * e + b) * PLANE + r] = (uint8_t)(v >> (8 * b));
    }
}

// The warp's 8-column steps over a staged tile.  K = 32 tile rows a k-step,
// permuted so that lane t's 8 B words are rows kb + 8t .. kb + 8t + 7 of its
// column (rows 8 apart across the lanes of one load: distinct banks at an
// odd pitch), and its A words are the bytes of the same rows in the planes.
__device__ __forceinline__ void open_mma(const Members& m, const uint32_t* tile, const uint8_t* s_pl,
                                         int4* s_acc, const int2* s_step, int nrows, int warp,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int st = warp; st < m.steps; st += OPEN_WARPS) {
    const int2 d = s_step[st];
    const int pw = m.pitch[d.x];
    const uint32_t* col = tile + m.soff[d.x] + d.y + g;
    int4 acc = s_acc[32 * st + lane];
    for (int kb = 0; kb < nrows; kb += 32) {
      const uint32_t* src = col + (kb + 8 * t) * pw;
      uint32_t f[8], b0[4], b1[4];
#pragma unroll
      for (int q = 0; q < 8; ++q) f[q] = src[q * pw];
      transpose4(f, b0);
      transpose4(f + 4, b1);
      const uint8_t* pa = s_pl + g * PLANE + kb + 8 * t;
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

__global__ void __launch_bounds__(OPEN_THREADS, 3)
open_eval_kernel(const __grid_constant__ Members m, int h, int rows, uint32_t g_m, uint32_t shift_m, int row0, E4 z_m,
                 unsigned long long* scratch, int32_t* __restrict__ out) {
  extern __shared__ uint4 open_smem[];
  __shared__ bool s_last;
  uint8_t* s_pl = reinterpret_cast<uint8_t*>(open_smem);
  int4* s_acc = reinterpret_cast<int4*>(s_pl + 64 * PLANE);
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
  }

  const int n_tiles = (h + rows - 1) / rows;  // the grid has at most n_tiles blocks
  uint32_t x = 0u, step = 0u;  // this thread's point in the current tile
  if (tid < rows) {
    x = kb::mont_mul(shift_m, mpow(g_m, (unsigned)row0 + (unsigned)blockIdx.x * rows + tid));
    step = mpow(g_m, gridDim.x * (unsigned)rows);
  }
  int buf = 0, since_flush = 0;
  stage_tile(s_f, m, blockIdx.x * rows, min(rows, h - (int)blockIdx.x * rows));
  cp_commit();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int nrows = min(rows, h - tile * rows), next = tile + gridDim.x;
    if (next < n_tiles) stage_tile(s_f + (buf ^ 1) * m.span, m, next * rows, min(rows, h - next * rows));
    cp_commit();
    if (tid < rows) {
      put_weights(s_pl, tid, tid < nrows, x, z_m);
      x = kb::mont_mul(x, step);
    }
    cp_wait_all_but_last();
    __syncthreads();  // the tile and its weights are in shared memory
    if (since_flush == FLUSH_ROWS / rows) {
      open_flush(m, s_acc, s_res, s_step, warp, lane);
      since_flush = 0;
    }
    open_mma(m, s_f + buf * m.span, s_pl, s_acc, s_step, nrows, warp, lane);
    ++since_flush;
    __syncthreads();  // the tile and the weights are read
    buf ^= 1;
  }
  open_flush(m, s_acc, s_res, s_step, warp, lane);
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
// (2 x rows x 16 bytes, prefetched with the tile), the rows' T (rows x 16
// bytes), the alpha table (2 x cpad x 8 words), two staged tiles.
__host__ __device__ constexpr size_t ro_smem_bytes(int rows, int cpad, int span) {
  return 48 * (size_t)rows + 64 * (size_t)cpad + 8 * (size_t)span;
}

// The tile at row r0 and, when the reduced opening is added into, its rows.
__device__ __forceinline__ void ro_stage(uint32_t* buf, uint4* s_ro, const Members& m,
                                         const int32_t* ro, bool read_ro, int r0, int nrows) {
  stage_tile(buf, m, r0, nrows);
  if (read_ro && (int)threadIdx.x < nrows)
    cp_async16(smem_addr(s_ro + threadIdx.x), ro + 4 * (size_t)(r0 + threadIdx.x));
}

__global__ void __launch_bounds__(RO_MAX_ROWS)
ro_accum_kernel(const __grid_constant__ Members m, int h, uint32_t g_m, uint32_t shift_m, int row0, E4 z_m, E4 s,
                const int32_t* __restrict__ alpha_pows, int32_t* ro, int first) {
  extern __shared__ uint4 ro_smem[];
  const int rows = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint4* s_ro = ro_smem;
  uint4* s_t = s_ro + 2 * rows;
  // the alpha table: word (n * cpad + c) * 8 + 4 (e % 2) + b, n = e / 2, holds
  // byte b of alpha[c, e] 2^(8a) mod p at its byte a (zero past a member's
  // width): B's column 8n + 4 (e % 2) + b at K rows (c, a)
  uint32_t* s_b = reinterpret_cast<uint32_t*>(s_t + rows);
  uint32_t* s_f = s_b + 16 * (size_t)m.cpad;
  for (int i = tid; i < 4 * m.cpad; i += rows) {
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

  const int n_tiles = (h + rows - 1) / rows;  // the grid has at most n_tiles blocks
  uint32_t x = kb::mont_mul(shift_m, mpow(g_m, (unsigned)row0 + (unsigned)blockIdx.x * rows + tid));
  const uint32_t step = mpow(g_m, gridDim.x * (unsigned)rows);
  int buf = 0;
  ro_stage(s_f, s_ro, m, ro, !first, blockIdx.x * rows, min(rows, h - (int)blockIdx.x * rows));
  cp_commit();
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * rows, nrows = min(rows, h - r0), next = tile + gridDim.x;
    if (next < n_tiles)
      ro_stage(s_f + (buf ^ 1) * m.span, s_ro + (buf ^ 1) * rows, m, ro, !first, next * rows,
               min(rows, h - next * rows));
    cp_commit();
    const E4 inv = inv_x_minus_z(x, z_m);
    x = kb::mont_mul(x, step);
    cp_wait_all_but_last();
    __syncthreads();  // the tile (and the alpha table) are in shared memory

    // D[i, (e, b)] for the warp's rows 32 warp + 16 mt + (g, g + 8): K = 8
    // columns x 4 bytes a k-step, lane t's A words columns c0 + t and
    // c0 + 4 + t; each member's sums in 64 bits as D_b + 2^8 D_(b+1) of the
    // lane's pair b = 2 (t % 2), 2 (t % 2) + 1 of e = 2 n + t / 2
    const uint32_t* tl = s_f + buf * m.span;
    unsigned long long acc[2][2][2] = {};  // [m-tile][n][row g, g + 8]
    for (int k = 0; k < m.count; ++k) {
      const int w = m.width[k], pw = m.pitch[k];
      const uint32_t* fa = tl + m.soff[k] + (32 * warp + g) * pw + t;
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
          const uint32_t* r = fa + 16 * mt * pw + c0;
          const uint32_t a0 = r[0], a1 = r[8 * pw], a2 = r[4], a3 = r[8 * pw + 4];
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
    if (tid < nrows) {
      const uint4 tv = s_t[tid];
      const E4 diff = {{kb::sub(tv.x, s.c[0]), kb::sub(tv.y, s.c[1]), kb::sub(tv.z, s.c[2]),
                        kb::sub(tv.w, s.c[3])}};
      const E4 q = emul(diff, inv);  // canonical times Montgomery: canonical
      uint4 v = make_uint4(q.c[0], q.c[1], q.c[2], q.c[3]);
      if (!first) {
        const uint4 old = s_ro[buf * rows + tid];
        v = make_uint4(kb::add(old.x, v.x), kb::add(old.y, v.y), kb::add(old.z, v.z),
                       kb::add(old.w, v.w));
      }
      reinterpret_cast<uint4*>(ro)[r0 + tid] = v;
    }
    __syncthreads();  // the tile and the rows are read
    buf ^= 1;
  }
}

uint32_t to_mont_host(uint32_t a) { return (uint32_t)(((uint64_t)a << 32) % kb::P); }

E4 e4_host(const uint32_t* v, bool mont) {
  E4 e;
  for (int k = 0; k < 4; ++k) e.c[k] = mont ? to_mont_host(v[k]) : v[k];
  return e;
}

// The members from the caller's arrays, each staged row `pitch(w)` words;
// false if they do not fit a launch.
template <typename Pitch>
bool members(const void* const* ptrs, const int* widths, int n, Pitch pitch, Members& m) {
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
    m.pitch[k] = used ? pitch(w) : 0;
    m.magic[k] = used ? ((1ull << 32) + w - 1) / w : 0ull;
    m.total += w;
    m.steps += (w + 7) / 8;
    m.cpad += (w + 7) & ~7;
  }
  return true;
}

// The staged tile's offsets at `rows` rows a tile (each buffer 16-byte
// aligned).
void layout(Members& m, int rows) {
  int words = 0;
  for (int k = 0; k < ZKBF_OPEN_MAX_MEMBERS; ++k) {
    m.soff[k] = words;
    words += rows * m.pitch[k];
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
  if (!members(ptrs, widths, n_mats, [](int w) { return w | 1; }, m) || h < 1 || row0 < 0 ||
      z == nullptr || g >= kb::P || shift == 0u || shift >= kb::P)
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
  if (e == cudaSuccess) e = grid_for(open_eval_kernel, OPEN_THREADS, smem, (h + rows - 1) / rows, &blocks);
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
  if (!members(ptrs, widths, n_mats, [](int w) { return w + ((4 - w) & 7); }, m) || h < 1 ||
      row0 < 0 || z == nullptr || s == nullptr || g >= kb::P || shift == 0u || shift >= kb::P ||
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
  cudaError_t e = grid_for(ro_accum_kernel, rows, smem, (h + rows - 1) / rows, &blocks);
  if (e != cudaSuccess) return (int)e;
  ro_accum_kernel<<<blocks, rows, smem, (cudaStream_t)stream>>>(
      m, h, to_mont_host(g), to_mont_host(shift), row0, e4_host(z, true), e4_host(s, false),
      static_cast<const int32_t*>(alpha_pows), static_cast<int32_t*>(ro), first);
  return (int)cudaGetLastError();
}
