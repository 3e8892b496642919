"""Quartic extension field EF4 = F_p[x]/(x^4 - 3) over KoalaBear, on torch.

An EF4 value is a TUPLE of 4 base-field planes (canonical int32 tensors of
identical shape, or Python ints for constants), as in the JAX package.
`to_array`/`from_array` convert to and from the packed (..., 4) layout.

The inverse uses the norm map: a^-1 = (s(a) s^2(a) s^3(a)) / N(a), with s
the Frobenius acting diagonally through powers of c = W^((p-1)/4); cost is
2 EF multiplies plus one base-field Fermat inversion.
"""

from __future__ import annotations

import torch

from . import field as f
from .field import I32, P

# c = W^((p-1)/4) mod p: the 4th root of unity scaling Frobenius.
FROB_C = 2113994754
_FROB_POWERS = [[pow(FROB_C, (i * k) % 4, P) for i in range(4)] for k in range(4)]


def ezeros(shape=(), device=None):
    z = torch.zeros(shape, dtype=I32, device=device)
    return (z, z, z, z)


def from_base(a):
    if not isinstance(a, torch.Tensor):
        return (int(a) % P, 0, 0, 0)
    z = torch.zeros_like(a, dtype=I32)
    return (a.to(I32), z, z, z)


def to_array(a) -> torch.Tensor:
    """Planes -> packed (..., 4) int32 tensor."""
    return torch.stack([x.to(I32) for x in a], dim=-1)


def from_array(arr: torch.Tensor):
    """Packed (..., 4) tensor -> planes."""
    return tuple(arr[..., i] for i in range(4))


def eadd(a, b):
    return tuple(f.fadd(x, y) for x, y in zip(a, b))


def esub(a, b):
    return tuple(f.fsub(x, y) for x, y in zip(a, b))


def eneg(a):
    return tuple(f.fneg(x) for x in a)


def _m(a, b):
    """Reduced int64 product (kept wide for the sums below)."""
    return (f._w(a) * f._w(b)) % P


def emul(a, b):
    """Full EF4 product mod (x^4 - 3), schoolbook: every product reduced,
    then at most 4 * 3 * p < 2^35 summed before the final reduction."""
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c0 = _m(a0, b0) + 3 * (_m(a1, b3) + _m(a2, b2) + _m(a3, b1))
    c1 = _m(a0, b1) + _m(a1, b0) + 3 * (_m(a2, b3) + _m(a3, b2))
    c2 = _m(a0, b2) + _m(a1, b1) + _m(a2, b0) + 3 * _m(a3, b3)
    c3 = _m(a0, b3) + _m(a1, b2) + _m(a2, b1) + _m(a3, b0)
    return tuple(f._out(c % P) for c in (c0, c1, c2, c3))


def emul_base(a, s):
    """EF4 * base scalar or tensor."""
    return tuple(f.fmul(x, s) for x in a)


def eadd_base(a, s):
    """EF4 + base: adds into coefficient 0."""
    return (f.fadd(a[0], s), a[1], a[2], a[3])


def _frobenius(a, k: int):
    """a^(p^k): coefficient i scaled by c^(i*k)."""
    return tuple(f.fmul(a[i], _FROB_POWERS[k % 4][i]) for i in range(4))


def einv(a):
    """EF4 inverse (a != 0). Vectorized; 0 maps to 0."""
    s1 = _frobenius(a, 1)
    s2 = _frobenius(a, 2)
    s3 = _frobenius(a, 3)
    b = emul(emul(s1, s2), s3)  # product of conjugates
    norm = emul(a, b)[0]  # N(a) lands in the base field (coeff 0)
    return emul_base(b, f.finv(norm))

