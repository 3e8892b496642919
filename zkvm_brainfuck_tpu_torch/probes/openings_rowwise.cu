// The opening kernels before the tensor-core design: open_eval_kernel and
// ro_accum_kernel with every column product a Montgomery product on the
// INT32 lanes (4 a element), staging and compute taking turns.  A probe's
// copy, timed beside csrc/openings.cu by probes/openings_variants.py;
// nothing on the proving path builds or launches it.  Its C interface is
// the same as csrc/openings.cu's.
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
// What bounds them on the H100: both read every member once (4 bytes an
// element) and do 4 Montgomery products and 4 additions an element, plus
// one EF4 inverse a row (about 100 products); at about 110 columns the
// integer work and the bytes take about as long (chip_smoke.py
// launch_bounds).
//
// Design.
// - Points: each thread computes its row's x once, by a square-and-multiply
//   power of g, then steps it by g^(rows of a tile x blocks) from one tile
//   to the block's next: no table of points is read.
// - Coalescing: the members are row-major with odd widths (31, 45, 41...),
//   so a thread that read its own row would stride 124-180 bytes across a
//   warp.  A block stages each member's tile of rows, which is one
//   contiguous run of memory, into shared memory first, with 16-byte loads
//   where the run is 16-byte aligned: as it is (open_eval), or into rows
//   padded to an odd stride, so that threads reading their own rows hit
//   distinct banks (ro_accum).
// - open_eval: the tile's weights x_i * inv(x_i - z) go to shared memory in
//   Montgomery form (one EF4 inverse a row, a thread a row); then each
//   thread walks one column over the tile's rows, or over every G-th row
//   when the block has G >= 2 threads a column (G = threads / W).  A product
//   of a canonical value by a Montgomery weight is the canonical product,
//   below p < 2^31, so per-(column, component) sums are exact in 64 bits
//   for up to 2^33 rows.  Each block keeps its sums in shared memory over
//   all its tiles, adds them to a 64-bit scratch with atomics once, and the
//   last block to arrive (a ticket in the scratch, as poseidon2.cu's tree
//   walk hands off) reduces the W x 4 sums mod p and writes them.  The sums
//   are exact integers, so the order of the atomics cannot change a bit.
//   The launcher clears the scratch on the caller's stream first.
// - ro_accum: a thread a row.  The members are staged one at a time, so a
//   block holds one member's tile (128 rows of at most 37 words on the main
//   path: 19 KB, some 11 blocks an SM); the thread adds its row's products
//   by the alpha powers (in shared memory in Montgomery form, read by the
//   whole warp at one address) into 64-bit sums, then computes its inverse,
//   subtracts S, makes one EF4 product and reads and writes its 16-byte
//   reduced-opening row.  Staging every member at once (59 KB a block, 3
//   blocks an SM) with a warp a row and 4-byte loads left the loads'
//   latency exposed: several times slower (PERF.md).
// - Both loop over tiles (grid = the blocks the card holds at once), so a
//   block computes its powers of g once.
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
constexpr int OPEN_ROWS = 128;  // rows of an open_eval tile at most (<= OPEN_THREADS)
constexpr int RO_THREADS = 128;  // threads of ro_accum, one a row of its tile
constexpr int SMEM_LIMIT = 227 * 1024 - 1024;  // dynamic shared memory a block may ask for

struct Members {
  const int32_t* ptr[ZKBF_OPEN_MAX_MEMBERS];
  int width[ZKBF_OPEN_MAX_MEMBERS];
  int off[ZKBF_OPEN_MAX_MEMBERS];   // first column of member k in the concatenation
  unsigned long long magic[ZKBF_OPEN_MAX_MEMBERS];  // ceil(2^32 / width), for row = i / width
  int count;
  int total;      // W
  int max_width;  // the widest member, made odd (ro_accum's staged row stride)
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

__host__ __device__ constexpr size_t open_smem_bytes(int rows, int total, int groups) {
  return 16 * (size_t)rows + 32 * (size_t)total * groups + 4 * (size_t)rows * total;
}

__host__ __device__ constexpr size_t ro_smem_bytes(int total, int max_width) {
  return 16 * (size_t)total + 4 * (size_t)RO_THREADS * max_width;
}

__global__ void __launch_bounds__(OPEN_THREADS, 2)
open_eval_kernel(Members m, int h, int rows, int groups, uint32_t g_m, uint32_t shift_m, int row0,
                 E4 z_m, unsigned long long* scratch, int32_t* __restrict__ out) {
  extern __shared__ uint4 open_smem[];
  __shared__ bool s_last;
  uint4* s_wt = open_smem;  // the tile's weights x * inv(x - z), Montgomery
  unsigned long long* s_acc = reinterpret_cast<unsigned long long*>(s_wt + rows);
  const int slots = m.total * groups;  // slot s: column s % W, rows = s / W (mod G)
  uint32_t* s_f = reinterpret_cast<uint32_t*>(s_acc + 4 * (size_t)slots);
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * slots; i += blockDim.x) s_acc[i] = 0ull;

  const int n_tiles = (h + rows - 1) / rows;
  uint32_t x = 0u, step = 0u;  // this thread's point in the current tile
  if (tid < rows) {
    x = kb::mont_mul(shift_m, mpow(g_m, (unsigned)row0 + (unsigned)blockIdx.x * rows + tid));
    step = mpow(g_m, gridDim.x * (unsigned)rows);
  }
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * rows;
    const int nrows = min(rows, h - r0);
    __syncthreads();  // the previous tile is read
    for (int k = 0; k < m.count; ++k)
      stage(s_f + (size_t)rows * m.off[k], m.ptr[k] + (size_t)r0 * m.width[k], nrows * m.width[k]);
    if (tid < nrows) {
      const E4 inv = inv_x_minus_z(x, z_m);
      s_wt[tid] = make_uint4(kb::mont_mul(inv.c[0], x), kb::mont_mul(inv.c[1], x),
                             kb::mont_mul(inv.c[2], x), kb::mont_mul(inv.c[3], x));
    }
    if (tid < rows) x = kb::mont_mul(x, step);
    __syncthreads();
    for (int s = tid; s < slots; s += blockDim.x) {
      const int c = s % m.total, g = s / m.total;
      int k = 0;
      while (k + 1 < m.count && c >= m.off[k + 1]) ++k;
      const int w = m.width[k];
      const uint32_t* col = s_f + (size_t)rows * m.off[k] + (c - m.off[k]);
      unsigned long long a0 = 0ull, a1 = 0ull, a2 = 0ull, a3 = 0ull;
      for (int r = g; r < nrows; r += groups) {
        const uint32_t f = col[r * w];
        const uint4 wt = s_wt[r];
        a0 += kb::mont_mul(f, wt.x);
        a1 += kb::mont_mul(f, wt.y);
        a2 += kb::mont_mul(f, wt.z);
        a3 += kb::mont_mul(f, wt.w);
      }
      s_acc[4 * s] += a0;
      s_acc[4 * s + 1] += a1;
      s_acc[4 * s + 2] += a2;
      s_acc[4 * s + 3] += a3;
    }
  }
  __syncthreads();
  for (int i = tid; i < 4 * m.total; i += blockDim.x) {
    unsigned long long sum = 0ull;
    for (int g = 0; g < groups; ++g) sum += s_acc[(size_t)4 * m.total * g + i];
    atomicAdd(scratch + i, sum);
  }
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

// Rows [r0, r0 + count / w) of a (h, w) row-major member, `src` pointing at
// row r0, into shared rows of odd stride pw: 16-byte loads of the
// contiguous run where it is 16-byte aligned, and word i goes to row
// i / w, a multiply-high by magic = ceil(2^32 / w), exact for i < 2^32 / w.
__device__ __forceinline__ void stage_rows(uint32_t* dst, const int32_t* src, int count, int w,
                                           int pw, unsigned long long magic) {
  const auto put = [&](int i, uint32_t v) {
    const int r = (int)(((unsigned long long)i * magic) >> 32);
    dst[r * pw + (i - r * w)] = v;
  };
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = count >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (int j = threadIdx.x; j < vecs; j += blockDim.x) {
      const uint4 v = __ldg(s4 + j);
      put(4 * j, v.x);
      put(4 * j + 1, v.y);
      put(4 * j + 2, v.z);
      put(4 * j + 3, v.w);
    }
    done = vecs << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) put(i, (uint32_t)__ldg(src + i));
}

__global__ void __launch_bounds__(RO_THREADS)
ro_accum_kernel(Members m, int h, uint32_t g_m, uint32_t shift_m, int row0, E4 z_m, E4 s,
                const int32_t* __restrict__ alpha_pows, int32_t* ro, int first) {
  extern __shared__ uint4 ro_smem[];
  uint4* s_ap = ro_smem;  // the alpha powers, Montgomery
  uint32_t* s_f = reinterpret_cast<uint32_t*>(s_ap + m.total);  // one member's tile
  const int tid = threadIdx.x;
  for (int i = tid; i < m.total; i += blockDim.x) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(alpha_pows) + i);
    s_ap[i] = make_uint4(kb::to_mont((uint32_t)a.x), kb::to_mont((uint32_t)a.y),
                         kb::to_mont((uint32_t)a.z), kb::to_mont((uint32_t)a.w));
  }
  const int n_tiles = (h + RO_THREADS - 1) / RO_THREADS;
  uint32_t x = kb::mont_mul(shift_m, mpow(g_m, (unsigned)row0 + (unsigned)blockIdx.x * RO_THREADS + tid));
  const uint32_t step = mpow(g_m, gridDim.x * (unsigned)RO_THREADS);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * RO_THREADS;
    const int nrows = min(RO_THREADS, h - r0);
    // sum_c alpha_c f_c of this thread's row: products below p, so 64-bit
    // sums are exact for up to 2^32 columns
    unsigned long long a0 = 0ull, a1 = 0ull, a2 = 0ull, a3 = 0ull;
    for (int k = 0; k < m.count; ++k) {
      const int w = m.width[k], pw = w | 1;
      __syncthreads();  // the previous member's tile is read (and the alpha powers written)
      stage_rows(s_f, m.ptr[k] + (size_t)r0 * w, nrows * w, w, pw, m.magic[k]);
      __syncthreads();
      if (tid < nrows) {
        const uint32_t* row = s_f + tid * pw;
        const uint4* ap = s_ap + m.off[k];
        for (int c = 0; c < w; ++c) {
          const uint32_t f = row[c];
          const uint4 al = ap[c];
          a0 += kb::mont_mul(f, al.x);
          a1 += kb::mont_mul(f, al.y);
          a2 += kb::mont_mul(f, al.z);
          a3 += kb::mont_mul(f, al.w);
        }
      }
    }
    if (tid < nrows) {
      const E4 inv = inv_x_minus_z(x, z_m);
      const E4 diff = {{kb::sub((uint32_t)(a0 % kb::P), s.c[0]), kb::sub((uint32_t)(a1 % kb::P), s.c[1]),
                        kb::sub((uint32_t)(a2 % kb::P), s.c[2]), kb::sub((uint32_t)(a3 % kb::P), s.c[3])}};
      const E4 q = emul(diff, inv);  // canonical times Montgomery: canonical
      uint4* dst = reinterpret_cast<uint4*>(ro) + r0 + tid;
      uint4 v = make_uint4(q.c[0], q.c[1], q.c[2], q.c[3]);
      if (!first) {
        const uint4 old = *dst;
        v = make_uint4(kb::add(old.x, v.x), kb::add(old.y, v.y), kb::add(old.z, v.z),
                       kb::add(old.w, v.w));
      }
      *dst = v;
    }
    x = kb::mont_mul(x, step);
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
  m.total = m.max_width = 0;
  for (int k = 0; k < ZKBF_OPEN_MAX_MEMBERS; ++k) {
    const bool used = k < n;
    if (used && (ptrs[k] == nullptr || widths[k] < 1 || widths[k] > 4096)) return false;
    m.ptr[k] = used ? static_cast<const int32_t*>(ptrs[k]) : nullptr;
    m.width[k] = used ? widths[k] : 0;
    m.off[k] = m.total;
    m.magic[k] = used ? ((1ull << 32) + widths[k] - 1) / widths[k] : 0ull;
    m.total += m.width[k];
    if (used && (widths[k] | 1) > m.max_width) m.max_width = widths[k] | 1;
  }
  return true;
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
// on `stream` before the launch.
extern "C" int zkbf_open_eval(const void* const* ptrs, const int* widths, int n_mats, int h,
                              unsigned g, unsigned shift, int row0, const unsigned* z, void* out,
                              void* scratch, void* stream) {
  Members m;
  if (!members(ptrs, widths, n_mats, m) || h < 1 || row0 < 0 || z == nullptr ||
      g >= kb::P || shift == 0u || shift >= kb::P)
    return (int)cudaErrorInvalidValue;
  int rows = OPEN_ROWS, groups = 1;
  while (true) {
    groups = OPEN_THREADS / m.total;
    groups = groups < 1 ? 1 : (groups > rows ? rows : groups);
    if (open_smem_bytes(rows, m.total, groups) <= (size_t)SMEM_LIMIT || rows <= 4) break;
    rows /= 2;
  }
  const size_t smem = open_smem_bytes(rows, m.total, groups);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 8 * (size_t)zkbf_open_eval_scratch_words(m.total), s);
  int blocks = 0;
  if (e == cudaSuccess) e = grid_for(open_eval_kernel, OPEN_THREADS, smem, (h + rows - 1) / rows, &blocks);
  if (e != cudaSuccess) return (int)e;
  open_eval_kernel<<<blocks, OPEN_THREADS, smem, s>>>(
      m, h, rows, groups, to_mont_host(g), to_mont_host(shift), row0, e4_host(z, true),
      static_cast<unsigned long long*>(scratch), static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// ro (h, 4) int32, 16-byte aligned: per row i, (sum_c alpha_c f_c(x_i) - s)
// * inv(x_i - z) written (first != 0) or added mod p in place, over the
// n_mats members (as zkbf_open_eval) on the points shift * g^(row0 + i).
// alpha_pows: (W, 4) canonical int32 on the device, 16-byte aligned; s and z
// 4 canonical words in host arrays.
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
  const size_t smem = ro_smem_bytes(m.total, m.max_width);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = grid_for(ro_accum_kernel, RO_THREADS, smem, (h + RO_THREADS - 1) / RO_THREADS, &blocks);
  if (e != cudaSuccess) return (int)e;
  ro_accum_kernel<<<blocks, RO_THREADS, smem, (cudaStream_t)stream>>>(
      m, h, to_mont_host(g), to_mont_host(shift), row0, e4_host(z, true), e4_host(s, false),
      static_cast<const int32_t*>(alpha_pows), static_cast<int32_t*>(ro), first);
  return (int)cudaGetLastError();
}
