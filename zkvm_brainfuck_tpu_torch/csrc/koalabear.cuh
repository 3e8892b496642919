// KoalaBear field arithmetic for the port's CUDA kernels.
//
// p = 2^31 - 2^24 + 1.  Canonical values are < p < 2^31, so they live in
// int32 tensors and in uint32 registers here.  Products use one 32x32->64
// multiply and a Montgomery reduction (R = 2^32): mont_mul(a, b) =
// a * b * 2^-32 mod p.  Multiplying a canonical value by a constant stored
// in Montgomery form (c * 2^32 mod p) therefore gives the canonical
// product in one reduction; kernels that chain many products (Poseidon2)
// convert their state to Montgomery form at load and back at store.
#pragma once

#include <cstdint>

namespace kb {

constexpr uint32_t P = 0x7f000001u;
constexpr uint32_t MU = 0x7effffffu;  // -p^-1 mod 2^32
constexpr uint32_t R2 = 0x17f7efe4u;  // 2^64 mod p (to_mont multiplier)

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2p < 2^32
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

// a * b * 2^-32 mod p for a, b < p.  t + m*p < 2^62 + 2^63 fits 64 bits and
// (t + m*p) / 2^32 < 2p, so one conditional subtraction makes it canonical.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  uint64_t t = (uint64_t)a * b;
  uint32_t m = (uint32_t)t * MU;
  uint32_t u = (uint32_t)((t + (uint64_t)m * P) >> 32);
  return u >= P ? u - P : u;
}

__device__ __forceinline__ uint32_t to_mont(uint32_t a) { return mont_mul(a, R2); }
__device__ __forceinline__ uint32_t from_mont(uint32_t a) { return mont_mul(a, 1u); }

}  // namespace kb
