// The quotient of one chip on its coset: the skeleton of the port's
// generated quotient kernels.  stark/codegen.py renders each chip's
// constraints as the body zkbfq::body and pastes it after this header, with
// ZKBF_Q_NCOL (columns) and ZKBF_Q_NPRM (parameter words) defined first;
// build.py compiles one library a chip.
//
// Replaces, from the JAX package (zkvm_brainfuck_tpu/): stark/quotient.py:94
// _quotient_chunk under :186 _quotient_program (K11, one XLA program a
// chip), with the selectors of stark/domains.py:154 selectors_on_coset_dev
// read from the port's cached tensors.
//
// For each of `rows` quotient-coset rows r (canonical int32 LDE columns of
// the chip's main, preprocessed and permutation traces; an EF4 permutation
// column is 4 planes), the body evaluates every AIR and LogUp constraint
// from row r and the next row r + step and folds them as sum_j w_j c_j
// with the per-prove EF4 weights w_j = alpha^(K-1-j); the skeleton
// multiplies the fold by the inverse zeroifier and stores the (rows, 4)
// canonical result.
//
// Layout: the columns come in blocks, each a pointer to its first column
// at the first row, a row stride (elements), its first column in the
// kernel's order and its width, for the local rows and for the halo.  The
// next row of r is r + step; past the last row it is read from the halo at
// r + step - rows.  On one device the halo is the block itself (the coset
// wraps); on a mesh shard it is the step rows that the next shard holds.
// One compiled kernel so serves a whole row-major LDE, its column blocks
// (an EF4 column may straddle two) and a shard.
//
// Field form: every value in registers is in Montgomery form (x 2^32 mod
// p): columns are converted once, as they are staged, selectors at load,
// constants are emitted converted, the launcher converts the parameter
// words.  Additions, subtractions and negations do not care; each product
// is a mont_mul of two Montgomery values.  The last product, by the inverse
// zeroifier read canonical, gives the canonical result directly.
//
// What bounds it on the H100: the integer work.  A Cpu row takes about 740
// Montgomery products and 950 additions that the function needs
// (chip_smoke.py launch_bounds counts them from the generated program)
// against 67 columns and 4 selectors read and a 16-byte store: at 2^21
// rows about 0.7 ms of operations against 0.19 ms of bytes.
//
// Design: a block of TILE threads takes TILE (128) consecutive rows, a
// thread a row.  It first stages the tile's rows and the step rows
// after them, every column of every block, into one shared-memory tile of
// PITCH words a row (PITCH odd: a warp reading one column of 32 rows hits
// 32 banks), converting each word into Montgomery form once.  A block whose
// rows are one contiguous run (stride == width: a whole LDE, a contiguous
// column block, a halo) is copied with 16-byte loads, each thread storing
// its four words in a rotated order so that a warp's stores spread over
// the banks; a view with a larger row stride word by word, still coalesced
// along its rows.  The generated body then reads column c of its row at
// lp[c] and of its next row at np[c] = lp[step * PITCH + c]: a shared load
// at a compile-time offset from one of two base registers, emitted at each
// use (volatile, so that the compiler neither merges nor hoists them): a
// column costs no register between its uses (a thread a row that held each
// column from device memory from its first use to its last took 178
// registers for the Cpu chip).  __launch_bounds__ asks for MIN_BLOCKS (4)
// blocks an SM (at most 128 registers a thread).  The selectors are read
// once a row from device memory (a warp reads 32 consecutive words).
// The column table and the parameter words are the kernel's parameter block
// (__grid_constant__, read through the constant cache).  Every operation is
// exact mod p, so the order of the fold cannot change a bit: the output
// equals the plain version's (stark/quotient.py quotient_rows_plain).
//
// Compiled without __CUDACC__ (a host compiler), the same staging and body
// run tile by tile on the CPU in zkbf_quotient_host, through a host array of
// the same pitch: the tests' check of each generated body and of the tile
// layout against the plain version.
#pragma once

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#define __grid_constant__
#include <cstring>
#include <vector>
#endif

#include <cstdint>

#include "ef4.cuh"
#include "koalabear.cuh"

#if !defined(ZKBF_Q_NCOL) || !defined(ZKBF_Q_NPRM)
#error "define ZKBF_Q_NCOL and ZKBF_Q_NPRM before including quotient.cuh"
#endif

namespace zkbfq {

constexpr int TILE = 128;  // rows (and threads) a block
constexpr int MIN_BLOCKS = 4;  // blocks an SM that __launch_bounds__ asks for
constexpr int PITCH = ZKBF_Q_NCOL | 1;  // words a tile row, odd

struct Blk {
  const int32_t* local;  // its first column at the first row
  const int32_t* halo;   // its first column at the first row past the last
  int stride, halo_stride;  // row strides, elements
  int col0, width;          // its columns: col0 .. col0 + width - 1
  uint32_t magic;           // ceil(2^31 / width): i / width = umulhi(2 i, magic)
};

struct Args {
  Blk blk[ZKBF_Q_NCOL];
  int n_blk;
  const int32_t* sel[4];  // is_first_row, is_last_row, is_transition, inv_zeroifier
  uint32_t prm[ZKBF_Q_NPRM];  // Montgomery form
  int rows, step;
  int32_t* out;  // (rows, 4), 16-byte aligned
};

// The kernel's parameter block holds Args: at most 4 KB.
static_assert(sizeof(Args) <= 4096, "quotient: the column table and parameters exceed 4 KB");

__device__ __forceinline__ uint32_t umulhi(uint32_t a, uint32_t b) {
#ifdef __CUDACC__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// Word i of a run of rows `w` words wide lies at row i / w, column i % w:
// at tile word i + (i / w) (PITCH - w) from the run's first word there.
// Exact for i < 2^31 / w (i is below (TILE + step) w here).
__device__ __forceinline__ uint32_t tile_off(uint32_t i, const Blk& b) {
  return i + umulhi(i << 1, b.magic) * (uint32_t)(PITCH - b.width);
}

struct W4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ W4 ld4(const int32_t* p) {
#ifdef __CUDACC__
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  return {q.x, q.y, q.z, q.w};
#else
  W4 q;
  std::memcpy(&q, p, 16);
  return q;
#endif
}

// Rows [0, n) of a block segment (src, row stride s) into the tile from
// word `base` on (its first row and column there), as threads tid of nt.
__device__ __forceinline__ void stage_seg(uint32_t* tile, uint32_t base, const int32_t* src,
                                          int s, int n, const Blk& b, int tid, int nt) {
  const int total = n * b.width;
  if (s != b.width) {  // a view: word by word, coalesced along each row
    for (int i = tid; i < total; i += nt) {
      const uint32_t r = umulhi((uint32_t)i << 1, b.magic);
      const uint32_t c = (uint32_t)i - r * (uint32_t)b.width;
      tile[base + tile_off((uint32_t)i, b)] = kb::to_mont((uint32_t)src[(long long)r * s + c]);
    }
    return;
  }
  // One contiguous run of `total` words: words up to the first 16-byte
  // boundary, then 16-byte chunks, then the tail.
  int head = (int)((4u - (uint32_t)(reinterpret_cast<uintptr_t>(src) >> 2)) & 3u);
  head = head < total ? head : total;
  const int chunks = (total - head) >> 2;
  for (int i = tid; i < head; i += nt)
    tile[base + tile_off((uint32_t)i, b)] = kb::to_mont((uint32_t)src[i]);
  for (int k = tid; k < chunks; k += nt) {
    W4 q = ld4(src + head + 4 * k);
    // Lanes 8g .. 8g + 7 of a warp store word (j + g) % 4 of their chunk at
    // step j: the four groups' stores fall on different banks.
    const int g = (k >> 3) & 3;
    if (g & 1) q = {q.y, q.z, q.w, q.x};
    if (g & 2) q = {q.z, q.w, q.x, q.y};
    const uint32_t v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t i = (uint32_t)(head + 4 * k + ((j + g) & 3));
      tile[base + tile_off(i, b)] = kb::to_mont(v[j]);
    }
  }
  for (int i = head + 4 * chunks + tid; i < total; i += nt)
    tile[base + tile_off((uint32_t)i, b)] = kb::to_mont((uint32_t)src[i]);
}

// The tile of rows r0 .. r0 + nr - 1 (nr = min(TILE, rows - r0)) and the
// step rows after them: tile row t is row r0 + t, from the halo past the
// last row.
__device__ __forceinline__ void stage(const Args& a, uint32_t* tile, long long r0, int tid,
                                      int nt) {
  const int nr = (int)(a.rows - r0 < TILE ? a.rows - r0 : TILE);
  const int nl = (int)(a.rows - r0 < nr + a.step ? a.rows - r0 : nr + a.step);
  for (int k = 0; k < a.n_blk; ++k) {
    const Blk& b = a.blk[k];
    stage_seg(tile, (uint32_t)b.col0, b.local + r0 * b.stride, b.stride, nl, b, tid, nt);
    if (nl < nr + a.step)
      stage_seg(tile, (uint32_t)(nl * PITCH + b.col0), b.halo, b.halo_stride, nr + a.step - nl,
                b, tid, nt);
  }
}

// A column of the row (lp) or the next row (np), read at each use.
typedef const volatile uint32_t* TileRow;

__device__ __forceinline__ uint32_t sel(const Args& a, long long r, int s) {
  return kb::to_mont((uint32_t)a.sel[s][r]);
}

// The chip's generated body: acc = the fold of row r's constraints,
// Montgomery form, its columns at lp[c] and its next row's at np[c].
__device__ __forceinline__ void body(const Args& a, long long r, TileRow lp, TileRow np,
                                     uint32_t acc[4]);

__device__ __forceinline__ void row(const Args& a, const uint32_t* tile, long long r0, int t) {
  const long long r = r0 + t;
  const uint32_t* lp = tile + t * PITCH;
  uint32_t acc[4];
  body(a, r, lp, lp + a.step * PITCH, acc);
  const uint32_t z = (uint32_t)a.sel[3][r];
  int32_t* o = a.out + 4 * r;
#ifdef __CUDACC__
  *reinterpret_cast<int4*>(o) =
      make_int4((int)kb::mont_mul(acc[0], z), (int)kb::mont_mul(acc[1], z),
                (int)kb::mont_mul(acc[2], z), (int)kb::mont_mul(acc[3], z));
#else
  for (int k = 0; k < 4; ++k) o[k] = (int32_t)kb::mont_mul(acc[k], z);
#endif
}

// Shared-memory bytes of a block's tile.
inline long long tile_bytes(int step) { return 4LL * (TILE + step) * PITCH; }

inline uint32_t to_mont_host(uint32_t x) { return (uint32_t)(((uint64_t)x << 32) % kb::P); }

// Fill Args from the launcher's host arrays (a block each: local and halo
// pointers, row strides, widths; blocks in column order); false for what
// the kernel does not take.
inline bool pack(Args& a, const void* const* local, const void* const* halo, const int* strides,
                 const int* halo_strides, const int* widths, int n_blk, const void* const* sels,
                 const unsigned* prm, int n_prm, int rows, int step, void* out) {
  if (n_blk < 1 || n_blk > ZKBF_Q_NCOL || n_prm != ZKBF_Q_NPRM || rows < 1 || step < 1 ||
      step > rows || out == nullptr || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return false;
  int col = 0;
  for (int k = 0; k < n_blk; ++k) {
    const int w = widths[k];
    if (local[k] == nullptr || halo[k] == nullptr || w < 1 || strides[k] < w ||
        halo_strides[k] < w || col + w > ZKBF_Q_NCOL)
      return false;
    Blk& b = a.blk[k];
    b.local = static_cast<const int32_t*>(local[k]);
    b.halo = static_cast<const int32_t*>(halo[k]);
    b.stride = strides[k];
    b.halo_stride = halo_strides[k];
    b.col0 = col;
    b.width = w;
    b.magic = (uint32_t)(((1ull << 31) + (uint64_t)w - 1) / (uint64_t)w);
    col += w;
  }
  if (col != ZKBF_Q_NCOL) return false;
  a.n_blk = n_blk;
  for (int s = 0; s < 4; ++s) {
    if (sels[s] == nullptr) return false;
    a.sel[s] = static_cast<const int32_t*>(sels[s]);
  }
  for (int i = 0; i < ZKBF_Q_NPRM; ++i) {
    if (prm[i] >= kb::P) return false;
    a.prm[i] = to_mont_host(prm[i]);
  }
  a.rows = rows;
  a.step = step;
  a.out = static_cast<int32_t*>(out);
  return true;
}

}  // namespace zkbfq

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(zkbfq::TILE, zkbfq::MIN_BLOCKS)
    quotient_kernel(const __grid_constant__ zkbfq::Args a) {
  extern __shared__ uint32_t tile[];
  const long long r0 = (long long)blockIdx.x * zkbfq::TILE;
  zkbfq::stage(a, tile, r0, threadIdx.x, zkbfq::TILE);
  __syncthreads();
  if (r0 + threadIdx.x < a.rows) zkbfq::row(a, tile, r0, threadIdx.x);
}

// The largest tile this library has been set up for (dynamic shared
// memory above 48 KB needs the function's attribute raised first).
long long g_smem_ready = 48 * 1024;

}  // namespace

extern "C" int zkbf_set_device(int device) { return (int)cudaSetDevice(device); }

// out (rows, 4) int32, 16-byte aligned = the chip's quotient at `rows`
// coset rows.  Block k (of n_blk, in column order: main, preprocessed,
// permutation planes; widths[k] columns) is local[k] + row * strides[k],
// its rows past the last halo[k] + (row + step - rows) * halo_strides[k]
// (host arrays of device pointers and element strides); sels:
// is_first_row, is_last_row, is_transition and inv_zeroifier at those rows,
// (rows,) int32 each; prm: n_prm canonical words in a host array.
extern "C" int zkbf_quotient(const void* const* local, const void* const* halo,
                             const int* strides, const int* halo_strides, const int* widths,
                             int n_blk, const void* const* sels, const unsigned* prm, int n_prm,
                             int rows, int step, void* out, void* stream) {
  zkbfq::Args a;
  if (!zkbfq::pack(a, local, halo, strides, halo_strides, widths, n_blk, sels, prm, n_prm, rows,
                   step, out))
    return (int)cudaErrorInvalidValue;
  const long long smem = zkbfq::tile_bytes(step);
  if (smem > g_smem_ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        quotient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_ready = smem;
  }
  const int blocks = (rows + zkbfq::TILE - 1) / zkbfq::TILE;
  quotient_kernel<<<blocks, zkbfq::TILE, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel's resources: registers a thread, a tile's shared-memory bytes
// at `step`, and the blocks an SM holds at once.
extern "C" int zkbf_quotient_info(int step, int* regs, int* smem, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, quotient_kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *smem = (int)zkbfq::tile_bytes(step);
  if (*smem > g_smem_ready) {
    e = cudaFuncSetAttribute(quotient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_ready = *smem;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, quotient_kernel,
                                                            zkbfq::TILE, (size_t)*smem);
}

#else

// zkbf_quotient on host memory: each tile staged into a host array of the
// kernel's pitch by the kernel's staging code (thread by thread), then its
// rows through the body (the tests' check of the body and the tile layout).
extern "C" int zkbf_quotient_host(const void* const* local, const void* const* halo,
                                  const int* strides, const int* halo_strides, const int* widths,
                                  int n_blk, const void* const* sels, const unsigned* prm,
                                  int n_prm, int rows, int step, void* out) {
  zkbfq::Args a;
  if (!zkbfq::pack(a, local, halo, strides, halo_strides, widths, n_blk, sels, prm, n_prm, rows,
                   step, out))
    return 1;
  std::vector<uint32_t> tile((size_t)(zkbfq::tile_bytes(step) / 4), 0xffffffffu);
  for (long long r0 = 0; r0 < rows; r0 += zkbfq::TILE) {
    for (int t = 0; t < zkbfq::TILE; ++t) zkbfq::stage(a, tile.data(), r0, t, zkbfq::TILE);
    for (int t = 0; t < zkbfq::TILE && r0 + t < rows; ++t) zkbfq::row(a, tile.data(), r0, t);
  }
  return 0;
}

#endif
