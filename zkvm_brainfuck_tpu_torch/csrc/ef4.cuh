// The quartic extension EF4 = F_p[x] / (x^4 - 3) over KoalaBear, for the
// port's CUDA kernels (logup.cu, openings.cu).
//
// An E4 holds four coefficients.  emul takes both operands in Montgomery
// form and returns the product in Montgomery form; since every coefficient
// of the product is a sum of mont_mul terms, one canonical operand and one
// Montgomery operand give the canonical product.  einv inverts through the
// norm: a^-1 = s(a) s^2(a) s^3(a) / N(a), with s the Frobenius (coefficient
// i scaled by c^i, c = 3^((p-1)/4)) and N(a) = a * s(a) s^2(a) s^3(a) in the
// base field, inverted by a Fermat power.  A zero input gives zero, as the
// JAX package's Fermat inverse does.
#pragma once

#include <cstdint>

#include "koalabear.cuh"

namespace ef4 {

constexpr uint32_t ONE_M = 33554430u;        // 1 in Montgomery form (2^32 mod p)
constexpr uint32_t FROB_C1_M = 2063729671u;  // c = 3^((p-1)/4), Montgomery form; c^2 = -1

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

}  // namespace ef4
