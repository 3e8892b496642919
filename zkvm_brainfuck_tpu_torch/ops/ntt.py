"""Radix-2 NTT / coset LDE over KoalaBear for column batches.

Counterpart of the JAX package's ops/ntt.py and ops/ntt_pallas.py.
Matrices are (rows, cols) canonical int32; the transform runs down the row
axis for all columns at once.  Conventions (p3 two-adic domains):

- `ntt(coeffs)` returns evaluations in NATURAL order over H_n (points g^i,
  g = two_adic_root(log_n)); `intt` inverts.
- `coset_lde(evals, log_blowup, shift)` maps evaluations over H_n to
  evaluations over shift*H_{n<<b} in natural order.

A transform of 2^L rows is two kinds of pass, each a CUDA kernel
(csrc/ntt.cu) for CUDA tensors and a plain torch version for CPU tensors:

- `ntt_block_stages`: stages 1..k (k = min(10, L), the Pallas kernel's job)
  inside every 2^k-row block, reading the natural-order input in
  bit-reversed row order itself.  It takes fewer than 2^L input rows (the
  rest read as zero) and an optional per-row factor table, so the LDE's
  n^-1 * shift^i scale and zero padding cost no pass of their own.
- `ntt_stage`: stages k+1..L in one pass (at most PASS_LOG_MAX stages a
  pass; more take several), in place.

The twiddle blob keeps the JAX layout: stage s at offset 2^(s-1)-1, length
2^(s-1); canonical for the plain versions (`twiddle_dev`), in Montgomery
form for the kernels (`twiddle_mont_dev`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from . import field as f
from . import kernels as kn
from .field import I32, I64, P

BLOCK_LOG = 10  # stages of the block pass (ntt_block_stages)
PASS_LOG_MAX = 12  # most stages of one ntt_stage pass (csrc/ntt.cu)


@lru_cache(maxsize=None)
def bit_reversal_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def reverse_bits(idx, log_n: int) -> np.ndarray:
    """The low log_n bits of each index reversed: bit_reversal_perm(log_n)[idx]
    without building the 2^log_n table (O(len(idx) * log_n))."""
    idx = np.asarray(idx, np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def twiddle_blob(log_n: int, inverse: bool) -> np.ndarray:
    """All stage tables concatenated (canonical uint32): stage s at offset
    2^(s-1)-1, length 2^(s-1), entries w_s^j (w_s^-j for the inverse)."""
    if log_n == 0:
        return np.zeros(1, np.uint32)
    tables = []
    for s in range(1, log_n + 1):
        w = f.two_adic_root(s)
        if inverse:
            w = pow(w, (1 << s) - 1, P)
        tables.append(f.powers_host(w, 1 << (s - 1)))
    return np.concatenate(tables)


@lru_cache(maxsize=None)
def twiddle_dev(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The canonical twiddle blob on `device`: the plain versions'."""
    return torch.from_numpy(twiddle_blob(log_n, inverse).astype(np.int32)).to(device)


@lru_cache(maxsize=None)
def twiddle_mont_dev(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The twiddle blob in Montgomery form (w * 2^32 mod p) on `device`: the
    kernels'.  Made from the host blob, so no canonical copy stays there."""
    mont = (twiddle_blob(log_n, inverse).astype(np.uint64) << np.uint64(32)) % np.uint64(P)
    return torch.from_numpy(mont.astype(np.int32)).to(device)


@lru_cache(maxsize=None)
def bitrev_dev(log_n: int, device: torch.device) -> torch.Tensor:
    """(2^log_n,) int64 bit-reversal permutation, built on the device."""
    idx = torch.arange(1 << log_n, dtype=I64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def scale_factors_dev(log_n: int, shift: int, device: torch.device) -> torch.Tensor:
    """(2^log_n,) canonical row factors n^-1 * shift^i: the coefficient
    scale of a coset LDE (and, with shift 1, the inverse NTT's n^-1)."""
    n_inv = pow(1 << log_n, P - 2, P)
    return f.fmul(f.powers_dev(shift % P, 1 << log_n, device), n_inv)


# ---------------------------------------------------------------------------
# Plain versions of the two kernels
# ---------------------------------------------------------------------------


def _stage_plain(x: torch.Tensor, tw_blob: torch.Tensor, s: int) -> torch.Tensor:
    n, cols = x.shape
    m = 1 << s
    half = m // 2
    tw = tw_blob[half - 1 : 2 * half - 1].to(I64)
    y = x.to(I64).reshape(n // m, m, cols)
    u = y[:, :half, :]
    v = y[:, half:, :] * tw[None, :, None] % P
    lo = u + v
    hi = u - v
    lo = torch.where(lo >= P, lo - P, lo)
    hi = torch.where(hi < 0, hi + P, hi)
    return torch.cat([lo, hi], dim=1).reshape(n, cols).to(I32)


def ntt_block_stages_plain(x: torch.Tensor, log_n: int, k: int, inverse: bool = False,
                           factors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stages 1..k of the 2^log_n-point transform of the natural-order (m, W)
    matrix x (rows >= m are zero; row i scaled by factors[i] if given), taken
    in bit-reversed row order: returns (2^log_n, W)."""
    m, w = x.shape
    n = 1 << log_n
    if factors is not None:
        x = f.fmul(x, factors[:m, None])
    if m < n:
        x = torch.cat([x, torch.zeros((n - m, w), dtype=I32, device=x.device)])
    xb = x.index_select(0, bitrev_dev(log_n, x.device))
    tw = twiddle_dev(log_n, inverse, x.device)
    for s in range(1, k + 1):
        xb = _stage_plain(xb, tw, s)
    return xb


def ntt_stage_plain(x: torch.Tensor, first: int, last: int, inverse: bool = False) -> torch.Tensor:
    """Stages first..last over the whole (2^L, W) matrix; returns a new one."""
    tw = twiddle_dev(_log2(x.shape[0]), inverse, x.device)
    for s in range(first, last + 1):
        x = _stage_plain(x, tw, s)
    return x


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def ntt_block_stages(x: torch.Tensor, log_n: int, k: int, inverse: bool = False,
                     factors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stages 1..k (k <= 10) inside every 2^k-row block of the 2^log_n-point
    transform of the natural-order (m, W) matrix x, m <= 2^log_n, taken in
    bit-reversed row order.  Rows >= m read as zero; `factors` ((>= m,)
    canonical) scales input row i.  Returns a new (2^log_n, W) matrix."""
    if x.dim() != 2:
        raise ValueError(f"ntt_block_stages: expected an (m, W) matrix, got {tuple(x.shape)}")
    m, w = x.shape
    if not 1 <= k <= min(BLOCK_LOG, log_n) or not 1 <= m <= 1 << log_n:
        raise ValueError(f"ntt_block_stages: bad k={k} for {m} rows of 2^{log_n}")
    if factors is not None and (factors.dim() != 1 or factors.shape[0] < m
                                or factors.device != x.device):
        raise ValueError("ntt_block_stages: factors must be one per input row, on x's device")
    if not x.is_cuda:
        return ntt_block_stages_plain(x, log_n, k, inverse, factors)
    kn.require_cuda_int32(x, "ntt_block_stages")
    if factors is not None:
        kn.require_cuda_int32(factors, "ntt_block_stages factors", ndim=1)
    tw = twiddle_mont_dev(log_n, inverse, x.device)
    out = torch.empty((1 << log_n, w), dtype=I32, device=x.device)
    err = kn.lib("ntt.cu", x.device).zkbf_ntt_block_stages(
        x.data_ptr(), out.data_ptr(), tw.data_ptr(),
        None if factors is None else factors.data_ptr(), m, log_n, w, k, kn.stream(x.device)
    )
    kn.check(err, "ntt_block_stages")
    kn.COUNTS["ntt_block_stages"] += 1
    return out


def ntt_stage(x: torch.Tensor, first: int, last: int, inverse: bool = False) -> torch.Tensor:
    """Stages first..last (at most PASS_LOG_MAX) of the transform over the
    whole (2^L, W) matrix, in one pass, in place; returns x."""
    if x.dim() != 2:
        raise ValueError(f"ntt_stage: expected an (n, W) matrix, got {tuple(x.shape)}")
    n, w = x.shape
    log_n = _log2(n)
    if not 1 <= first <= last <= log_n or last - first + 1 > PASS_LOG_MAX:
        raise ValueError(f"ntt_stage: bad stages {first}..{last} for n={n}")
    if not x.is_cuda:
        x.copy_(ntt_stage_plain(x, first, last, inverse))
        return x
    kn.require_cuda_int32(x, "ntt_stage")
    tw = twiddle_mont_dev(log_n, inverse, x.device)
    err = kn.lib("ntt.cu", x.device).zkbf_ntt_stage(
        x.data_ptr(), x.data_ptr(), tw.data_ptr(), log_n, w, first, last, kn.stream(x.device)
    )
    kn.check(err, "ntt_stage")
    kn.COUNTS["ntt_stage"] += 1
    return x


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def transform(x: torch.Tensor, log_n: int, inverse: bool,
              factors: Optional[torch.Tensor] = None,
              pass_log: int = PASS_LOG_MAX) -> torch.Tensor:
    """The 2^log_n-point NTT (the inverse without its n^-1) of the
    natural-order (m, W) int32 matrix x, m <= 2^log_n, rows >= m zero and
    row i scaled by factors[i] first: ntt_block_stages, then ntt_stage passes
    of at most `pass_log` stages.  Natural order out."""
    k = min(BLOCK_LOG, log_n)
    y = ntt_block_stages(x, log_n, k, inverse, factors)
    for first in range(k + 1, log_n + 1, pass_log):
        ntt_stage(y, first, min(log_n, first + pass_log - 1), inverse)
    return y


def ntt_dev(x: torch.Tensor, log_n: int, inverse: bool,
            pass_log: int = PASS_LOG_MAX) -> torch.Tensor:
    """NTT down axis 0 of an (2^log_n, ...) int32 tensor; natural order in
    and out; the inverse includes the n^-1 scale (as row factors)."""
    if log_n == 0:
        return x
    orig_shape = x.shape
    x = x.reshape(1 << log_n, -1).to(I32).contiguous()
    factors = scale_factors_dev(log_n, 1, x.device) if inverse else None
    return transform(x, log_n, inverse, factors, pass_log).reshape(orig_shape)


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "size must be a power of two"
    return log_n


def ntt(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over H_n (natural order). Shape (n, ...)."""
    return ntt_dev(coeffs, _log2(coeffs.shape[0]), False)


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Evaluations over H_n (natural order) -> coefficients."""
    return ntt_dev(evals, _log2(evals.shape[0]), True)


def coset_lde(evals: torch.Tensor, log_blowup: int, shift: int = f.GENERATOR,
              pass_log: int = PASS_LOG_MAX) -> torch.Tensor:
    """Evals over H_n -> evals over shift*H_{n<<log_blowup} (natural order):
    the inverse transform without n^-1, then the forward one of the zero-padded
    coefficients scaled by n^-1 * shift^i, both scale and padding done by its
    block pass.  Shape (n, ...) -> (n << log_blowup, ...)."""
    n = evals.shape[0]
    log_n = _log2(n)
    x = evals.reshape(n, -1).to(I32).contiguous()
    if log_n == 0:
        coeffs = x
    else:
        coeffs = transform(x, log_n, True, pass_log=pass_log)
    out = transform(coeffs, log_n + log_blowup, False,
                    scale_factors_dev(log_n, shift, x.device), pass_log)
    return out.reshape((n << log_blowup,) + tuple(evals.shape[1:]))
