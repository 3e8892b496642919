"""KoalaBear base-field arithmetic on torch tensors (canonical int32).

p = 2^31 - 2^24 + 1 = 0x7f000001 < 2^31, so every canonical value fits a
non-negative `torch.int32`.  Field matrices are stored as int32 in [0, p).
The functions here widen to int64 for the arithmetic (a*b < 2^62), reduce
mod p and return canonical int32 tensors; Python ints are accepted on
either side.  The values are canonical throughout: the JAX package keeps
device values in Montgomery form, but only canonical values ever reach its
transcript, and those are what the port reproduces.  (The CUDA kernels use
Montgomery form internally and convert at load and store.)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

P = 0x7F000001  # KoalaBear modulus
GENERATOR = 3  # multiplicative generator of F_p^*
TWO_ADICITY = 24  # p - 1 = 2^24 * 127
TWO_ADIC_GENERATOR = 1791270792  # 3^127 mod p, order 2^24
W_EF4 = 3  # EF4 = F_p[x] / (x^4 - 3)

I32 = torch.int32
I64 = torch.int64


def _w(x):
    """Widen a tensor to int64 (Python ints pass through)."""
    return x.to(I64) if isinstance(x, torch.Tensor) else int(x)


def _out(x):
    return x.to(I32) if isinstance(x, torch.Tensor) else int(x)


def fadd(a, b):
    s = _w(a) + _w(b)
    if isinstance(s, int):
        return s % P
    return torch.where(s >= P, s - P, s).to(I32)


def fsub(a, b):
    d = _w(a) - _w(b)
    if isinstance(d, int):
        return d % P
    return torch.where(d < 0, d + P, d).to(I32)


def fneg(a):
    return fsub(0, a)


def fmul(a, b):
    return _out((_w(a) * _w(b)) % P)


def fsquare(a):
    return fmul(a, a)


def fpow(a, e: int):
    """a^e for a static integer exponent (square and multiply)."""
    result = None
    base = a
    ee = int(e)
    while ee > 0:
        if ee & 1:
            result = base if result is None else fmul(result, base)
        ee >>= 1
        if ee:
            base = fsquare(base)
    if result is None:
        return torch.ones_like(a, dtype=I32) if isinstance(a, torch.Tensor) else 1
    return _out(result)


def finv(a):
    """a^-1 by Fermat (a^(p-2)); 0 maps to 0."""
    return fpow(a, P - 2)


def fhalve(a):
    """a / 2 mod p."""
    x = _w(a)
    if isinstance(x, int):
        return x * ((P + 1) >> 1) % P
    return _out(torch.where(x & 1 == 1, (x >> 1) + ((P + 1) >> 1), x >> 1))


def as_field_tensor(x, device) -> torch.Tensor:
    """A matrix of canonical values (numpy array of any integer dtype, or a
    tensor) as an int32 tensor on `device`; raises if a value is outside
    [0, p)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int64))
    if x.numel() and (int(x.min()) < 0 or int(x.max()) >= P):
        raise ValueError("values are not canonical field elements")
    return x.to(device=device, dtype=I32)


def fsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Exact mod-p sum over axis 0: int64 partial sums of canonical values
    are exact for fewer than 2^32 rows."""
    return (x.to(I64).sum(0) % P).to(I32)


def fsum_small(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exact mod-p sum over one axis (any length below 2^32)."""
    return (x.to(I64).sum(axis) % P).to(I32)


def powers_dev(base: int, n: int, device) -> torch.Tensor:
    """(n,) int32 [1, b, b^2, ...] built on `device` by log2(n) doubling
    steps (n a power of two)."""
    p = torch.ones(1, dtype=I64, device=device)
    s = 0
    while p.shape[0] < n:
        p = torch.cat([p, p * pow(base, 1 << s, P) % P])
        s += 1
    return p[:n].to(I32)


# ---------------------------------------------------------------------------
# Host-side exact scalar helpers (Python ints, canonical form)
# ---------------------------------------------------------------------------


def h_add(a: int, b: int) -> int:
    return (a + b) % P


def h_sub(a: int, b: int) -> int:
    return (a - b) % P


def h_mul(a: int, b: int) -> int:
    return (a * b) % P


def h_inv(a: int) -> int:
    return pow(a, P - 2, P)


@functools.lru_cache(maxsize=None)
def monty_of(x: int) -> int:
    return (x << 32) % P


def np_to_monty(x: np.ndarray) -> np.ndarray:
    """numpy canonical uint32 -> Montgomery form (host, exact via uint64)."""
    return ((x.astype(np.uint64) << np.uint64(32)) % np.uint64(P)).astype(np.uint32)


def np_from_monty(x: np.ndarray) -> np.ndarray:
    rinv = pow(1 << 32, -1, P)
    return ((x.astype(object) * rinv) % P).astype(np.uint32)


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
