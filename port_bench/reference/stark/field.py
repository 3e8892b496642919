"""KoalaBear base field on the host (exact Python ints and numpy): a frozen
copy of the port's host helpers."""

from __future__ import annotations

import functools

import numpy as np

P = 0x7F000001  # KoalaBear modulus
GENERATOR = 3  # multiplicative generator of F_p^*
TWO_ADICITY = 24  # p - 1 = 2^24 * 127
TWO_ADIC_GENERATOR = 1791270792  # 3^127 mod p, order 2^24


def h_add(a: int, b: int) -> int:
    return (a + b) % P


def h_sub(a: int, b: int) -> int:
    return (a - b) % P


def h_mul(a: int, b: int) -> int:
    return (a * b) % P


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


# ---------------------------------------------------------------------------
# Two-adic roots of unity
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def two_adic_root(log_n: int) -> int:
    """Canonical generator of the order-2^log_n subgroup (host int)."""
    assert 0 <= log_n <= TWO_ADICITY
    return pow(TWO_ADIC_GENERATOR, 1 << (TWO_ADICITY - log_n), P)


@functools.lru_cache(maxsize=None)
def _host_powers(base: int, n: int) -> np.ndarray:
    """Doubling construction in exact uint64 numpy (same values as a
    running product, without a Python loop over n)."""
    out = np.ones(1, dtype=np.uint64)
    s = 0
    while len(out) < n:
        out = np.concatenate([out, out * np.uint64(pow(base, 1 << s, P)) % np.uint64(P)])
        s += 1
    res = out[:n].astype(np.uint32)
    res.flags.writeable = False
    return res


def powers_host(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ...] canonical, computed host-side (cached)."""
    return _host_powers(base % P, n)
