"""Exact host-side EF4 scalar arithmetic (4-tuples of canonical ints).

A frozen copy of the port's verifier arithmetic (x^4 = 3): scalars for
the transcript and the constraint check, whole query batches in numpy."""

from __future__ import annotations

import numpy as np

from .field import P

W = 3

ZERO = (0, 0, 0, 0)
ONE = (1, 0, 0, 0)


def from_base(c: int):
    return (c % P, 0, 0, 0)


def add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def neg(a):
    return tuple((-x) % P for x in a)


def mul(a, b):
    c = [0] * 7
    for i in range(4):
        ai = a[i]
        if ai:
            for j in range(4):
                c[i + j] += ai * b[j]
    for k in range(6, 3, -1):
        c[k - 4] += W * c[k]
    return tuple(x % P for x in c[:4])


def mul_base(a, s: int):
    return tuple(x * s % P for x in a)


def add_base(a, s: int):
    return ((a[0] + s) % P, a[1], a[2], a[3])


def epow(a, e: int):
    r = ONE
    while e:
        if e & 1:
            r = mul(r, a)
        a = mul(a, a)
        e >>= 1
    return r


def inv(a):
    # a^(p^4 - 2); fine at verifier scale
    assert a != ZERO
    return epow(a, P**4 - 2)


def monomial(k: int):
    t = [0, 0, 0, 0]
    t[k] = 1
    return tuple(t)


# ---------------------------------------------------------------------------
# Vectorized EF4 over numpy uint64 arrays shaped (..., 4), canonical values.
#
# The verifier's query phase does tens of thousands of EF multiplies (84
# queries x ~20 layers x opened columns); scalar-tuple arithmetic above is
# exact but Python-slow.  These run the same x^4 = 3 binomial arithmetic on
# whole query batches.  Products are reduced mod P eagerly so 4-term
# accumulations stay far below 2^64.
# ---------------------------------------------------------------------------

_U64P = np.uint64(P)
_W64 = np.uint64(W)


def v_add(a, b):
    return (a + b) % _U64P


def v_sub(a, b):
    return (a % _U64P + _U64P - b % _U64P) % _U64P


def v_mul(a, b):
    """(..., 4) x (..., 4) -> (..., 4), broadcasting."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    shape = np.broadcast_shapes(a.shape, b.shape)
    c = [np.zeros(shape[:-1], dtype=np.uint64) for _ in range(7)]
    for i in range(4):
        ai = a[..., i]
        for j in range(4):
            c[i + j] = (c[i + j] + ai * b[..., j] % _U64P) % _U64P
    for k in range(6, 3, -1):
        c[k - 4] = (c[k - 4] + _W64 * c[k]) % _U64P
    return np.stack(c[:4], axis=-1)


def v_mul_base(a, s):
    """EF (..., 4) times base (...,) or scalar."""
    a = np.asarray(a, dtype=np.uint64)
    s = np.asarray(s, dtype=np.uint64) % _U64P
    return a * s[..., None] % _U64P


def v_base_inv(x):
    """Vectorized base-field inverse by square-and-multiply (x^(P-2))."""
    x = np.asarray(x, dtype=np.uint64) % _U64P
    assert (x != 0).all(), "division by zero"
    r = np.ones_like(x)
    e = P - 2
    b = x
    while e:
        if e & 1:
            r = r * b % _U64P
        b = b * b % _U64P
        e >>= 1
    return r


# Frobenius x -> x^p is coefficient-wise scaling: phi(a)_i = a_i * C^i with
# C = W^((p-1)/4) (binomial extension; P-1 divisible by 4).  The norm
# N(a) = a * phi(a) * phi^2(a) * phi^3(a) lands in the base field, giving
# inv(a) = (phi(a) phi^2(a) phi^3(a)) / N(a) with ONE base inversion
# (mirrors ops/ext.py's device inverse).
# _FROB[i][k] = C^(i*k) mod P
_FROB_C = pow(W, (P - 1) // 4, P)
_FROB = [
    np.array([pow(_FROB_C, i * k, P) for k in range(4)], dtype=np.uint64)
    for i in range(4)
]


def v_frob(a, i):
    return np.asarray(a, dtype=np.uint64) * _FROB[i % 4] % _U64P


def v_inv(a):
    """Vectorized EF4 inverse via Frobenius norm."""
    a = np.asarray(a, dtype=np.uint64) % _U64P
    c1 = v_frob(a, 1)
    c2 = v_frob(a, 2)
    c3 = v_frob(a, 3)
    adj = v_mul(c1, v_mul(c2, c3))
    norm = v_mul(a, adj)
    # norm must be (n, 0, 0, 0)
    n0 = norm[..., 0]
    return v_mul_base(adj, v_base_inv(n0))
