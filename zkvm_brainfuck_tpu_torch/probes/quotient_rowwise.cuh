// The quotient kernel's skeleton before tiles: a thread a coset row, each
// column read from device memory once (at its first use) into a register
// and converted into Montgomery form there.  A probe's copy, timed beside
// csrc/quotient.cuh by probes/quotient_variants.py; nothing on the proving
// path includes it.  The body it takes (quotient_variants.py rowwise_text)
// loads each (column, row) value once, v<i> = ld(a, w, c, next), at its
// node's place in stark/codegen.py's recording order, and uses v<i> where
// the tiled body reads lp[c] / np[c].
//
// Layout: each column comes through a table entry, a pointer to its value
// at the first row and a row stride (elements), for the local rows and for
// the halo.  The next row of r is r + step; past the last row it is read
// from the halo at r + step - rows.  Every value in registers is in
// Montgomery form; the last product, by the inverse zeroifier read
// canonical, gives the canonical result directly.
#pragma once

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#define __grid_constant__
#endif

#include <cstdint>

#include "ef4.cuh"
#include "koalabear.cuh"

#if !defined(ZKBF_Q_NCOL) || !defined(ZKBF_Q_NPRM)
#error "define ZKBF_Q_NCOL and ZKBF_Q_NPRM before including quotient.cuh"
#endif

namespace zkbfq {

struct Col {
  const int32_t* local;  // the column at the first row
  const int32_t* halo;   // the column at the first row past the last
  int stride, halo_stride;  // row strides, elements
};

struct Args {
  Col col[ZKBF_Q_NCOL];
  const int32_t* sel[4];  // is_first_row, is_last_row, is_transition, inv_zeroifier
  uint32_t prm[ZKBF_Q_NPRM];  // Montgomery form
  int rows, step;
  int32_t* out;  // (rows, 4), 16-byte aligned
};

// The kernel's parameter block holds Args: at most 4 KB.
static_assert(sizeof(Args) <= 4096, "quotient: the column table and parameters exceed 4 KB");

struct Row {
  long long r, n;  // the row; the next row, in the halo when wrap
  bool wrap;
};

__device__ __forceinline__ uint32_t ld(const Args& a, const Row& w, int c, bool nxt) {
  const Col& col = a.col[c];
  const int32_t* p = !nxt ? col.local + w.r * col.stride
                   : w.wrap ? col.halo + w.n * col.halo_stride
                            : col.local + w.n * col.stride;
  return kb::to_mont((uint32_t)*p);
}

__device__ __forceinline__ uint32_t sel(const Args& a, const Row& w, int s) {
  return kb::to_mont((uint32_t)a.sel[s][w.r]);
}

// The chip's generated body: acc = the fold of row w's constraints,
// Montgomery form.
__device__ __forceinline__ void body(const Args& a, const Row& w, uint32_t acc[4]);

__device__ __forceinline__ void row(const Args& a, long long r) {
  Row w;
  w.r = r;
  w.n = r + a.step;
  w.wrap = w.n >= a.rows;
  if (w.wrap) w.n -= a.rows;
  uint32_t acc[4];
  body(a, w, acc);
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

inline uint32_t to_mont_host(uint32_t x) { return (uint32_t)(((uint64_t)x << 32) % kb::P); }

// Fill Args from the launcher's host arrays; false for what the kernel
// does not take.
inline bool pack(Args& a, const void* const* local, const void* const* halo, const int* strides,
                 const int* halo_strides, int n_cols, const void* const* sels,
                 const unsigned* prm, int n_prm, int rows, int step, void* out) {
  if (n_cols != ZKBF_Q_NCOL || n_prm != ZKBF_Q_NPRM || rows < 1 || step < 1 || step > rows ||
      out == nullptr || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return false;
  for (int c = 0; c < ZKBF_Q_NCOL; ++c) {
    if (local[c] == nullptr || halo[c] == nullptr || strides[c] < 1 || halo_strides[c] < 1)
      return false;
    a.col[c].local = static_cast<const int32_t*>(local[c]);
    a.col[c].halo = static_cast<const int32_t*>(halo[c]);
    a.col[c].stride = strides[c];
    a.col[c].halo_stride = halo_strides[c];
  }
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

constexpr int QUOTIENT_THREADS = 128;

__global__ void __launch_bounds__(QUOTIENT_THREADS)
    quotient_kernel(const __grid_constant__ zkbfq::Args a) {
  const long long r = (long long)blockIdx.x * QUOTIENT_THREADS + threadIdx.x;
  if (r < a.rows) zkbfq::row(a, r);
}

}  // namespace

extern "C" int zkbf_set_device(int device) { return (int)cudaSetDevice(device); }

// out (rows, 4) int32, 16-byte aligned = the chip's quotient at `rows`
// coset rows.  Column c (of n_cols: main, preprocessed, permutation
// planes) is local[c] + row * strides[c], its rows past the last
// halo[c] + (row + step - rows) * halo_strides[c] (host arrays of device
// pointers and element strides); sels: is_first_row, is_last_row,
// is_transition and inv_zeroifier at those rows, (rows,) int32 each;
// prm: n_prm canonical words in a host array.
extern "C" int zkbf_quotient(const void* const* local, const void* const* halo,
                             const int* strides, const int* halo_strides, int n_cols,
                             const void* const* sels, const unsigned* prm, int n_prm, int rows,
                             int step, void* out, void* stream) {
  zkbfq::Args a;
  if (!zkbfq::pack(a, local, halo, strides, halo_strides, n_cols, sels, prm, n_prm, rows, step,
                   out))
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + QUOTIENT_THREADS - 1) / QUOTIENT_THREADS;
  quotient_kernel<<<blocks, QUOTIENT_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif
