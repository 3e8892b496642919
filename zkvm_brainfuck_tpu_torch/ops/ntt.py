"""Radix-2 NTT / coset LDE over KoalaBear for column batches.

Counterpart of the JAX package's ops/ntt.py and ops/ntt_pallas.py.
Matrices are (rows, cols) canonical int32; the transform runs down the row
axis for all columns at once.  Conventions (p3 two-adic domains):

- `ntt(coeffs)` returns evaluations in NATURAL order over H_n (points g^i,
  g = two_adic_root(log_n)); `intt` inverts.
- `coset_lde(evals, log_blowup, shift)` maps evaluations over H_n to
  evaluations over shift*H_{n<<b} in natural order.

A transform is: gather the rows into bit-reversed order, then
`ntt_block_stages` (stages 1..min(10, log n) inside 2^k-row blocks, the
Pallas kernel's job) and one `ntt_stage` per stage above 10.  Each of the two
is a CUDA kernel (csrc/ntt.cu) for CUDA tensors and a plain torch version
for CPU tensors.  The twiddle blob keeps the JAX layout: stage s at offset
2^(s-1)-1, length 2^(s-1), but canonical (the kernels convert to
Montgomery form themselves).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import field as f
from . import kernels as kn
from .field import I32, I64, P

BLOCK_LOG = 10  # stages fused by ntt_block_stages


@lru_cache(maxsize=None)
def bit_reversal_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
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
    """Device twiddle blob (same layout), built on the device."""
    if log_n == 0:
        return torch.zeros(1, dtype=I32, device=device)
    stages = []
    for s in range(1, log_n + 1):
        w = f.two_adic_root(s)
        if inverse:
            w = pow(w, (1 << s) - 1, P)
        stages.append(f.powers_dev(w, 1 << (s - 1), device))
    return torch.cat(stages)


@lru_cache(maxsize=None)
def bitrev_dev(log_n: int, device: torch.device) -> torch.Tensor:
    """(2^log_n,) int64 bit-reversal permutation, built on the device."""
    idx = torch.arange(1 << log_n, dtype=I64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


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


def ntt_block_stages_plain(x_bitrev: torch.Tensor, tw_blob: torch.Tensor, k: int):
    """Stages 1..k of a bit-reversed (n, W) matrix (n a multiple of 2^k)."""
    for s in range(1, k + 1):
        x_bitrev = _stage_plain(x_bitrev, tw_blob, s)
    return x_bitrev


def ntt_stage_plain(x: torch.Tensor, tw_blob: torch.Tensor, s: int) -> torch.Tensor:
    return _stage_plain(x, tw_blob, s)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_args(x, tw_blob, what):
    if x.dim() != 2:
        raise ValueError(f"{what}: expected an (n, W) matrix, got {tuple(x.shape)}")
    if tw_blob.device != x.device:
        raise ValueError(f"{what}: twiddles on {tw_blob.device}, matrix on {x.device}")


def ntt_block_stages(x_bitrev: torch.Tensor, tw_blob: torch.Tensor, k: int) -> torch.Tensor:
    """Run NTT stages 1..k (k <= 10) inside every 2^k-row block of a
    bit-reversed (n, W) matrix; returns a new matrix."""
    _check_args(x_bitrev, tw_blob, "ntt_block_stages")
    n, w = x_bitrev.shape
    if not 1 <= k <= BLOCK_LOG or n % (1 << k):
        raise ValueError(f"ntt_block_stages: bad k={k} for n={n}")
    if not x_bitrev.is_cuda:
        return ntt_block_stages_plain(x_bitrev, tw_blob, k)
    kn.require_cuda_int32(x_bitrev, "ntt_block_stages")
    kn.require_cuda_int32(tw_blob, "ntt_block_stages twiddles", ndim=1)
    if tw_blob.shape[0] < (1 << k) - 1:
        raise ValueError("ntt_block_stages: twiddle blob too short")
    out = torch.empty_like(x_bitrev)
    err = kn.lib("ntt.cu").zkbf_ntt_block_stages(
        x_bitrev.data_ptr(), out.data_ptr(), tw_blob.data_ptr(), n, w, k, kn.stream()
    )
    kn.check(err, "ntt_block_stages")
    kn.COUNTS["ntt_block_stages"] += 1
    return out


def ntt_stage(x: torch.Tensor, tw_blob: torch.Tensor, s: int) -> torch.Tensor:
    """One radix-2 DIT stage s over the whole (n, W) matrix; returns a new
    matrix."""
    _check_args(x, tw_blob, "ntt_stage")
    n, w = x.shape
    if s < 1 or (1 << s) > n or n % (1 << s):
        raise ValueError(f"ntt_stage: bad stage {s} for n={n}")
    if not x.is_cuda:
        return ntt_stage_plain(x, tw_blob, s)
    kn.require_cuda_int32(x, "ntt_stage")
    kn.require_cuda_int32(tw_blob, "ntt_stage twiddles", ndim=1)
    if tw_blob.shape[0] < (1 << s) - 1:
        raise ValueError("ntt_stage: twiddle blob too short")
    out = torch.empty_like(x)
    err = kn.lib("ntt.cu").zkbf_ntt_stage(
        x.data_ptr(), out.data_ptr(), tw_blob.data_ptr(), n, w, s, kn.stream()
    )
    kn.check(err, "ntt_stage")
    kn.COUNTS["ntt_stage"] += 1
    return out


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def ntt_dev(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """NTT down axis 0 of an (2^log_n, ...) int32 tensor; natural order in
    and out; the inverse includes the n^-1 scale."""
    if log_n == 0:
        return x
    orig_shape = x.shape
    n = 1 << log_n
    x = x.reshape(n, -1).to(I32)
    tw = twiddle_dev(log_n, inverse, x.device)
    xb = x.index_select(0, bitrev_dev(log_n, x.device)).contiguous()
    k = min(BLOCK_LOG, log_n)
    xb = ntt_block_stages(xb, tw, k)
    for s in range(k + 1, log_n + 1):
        xb = ntt_stage(xb, tw, s)
    if inverse:
        xb = f.fmul(xb, pow(n, P - 2, P))
    return xb.reshape(orig_shape)


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


@lru_cache(maxsize=None)
def shift_powers_dev(shift: int, log_n: int, device: torch.device) -> torch.Tensor:
    return f.powers_dev(shift % P, 1 << log_n, device)


def coset_lde(evals: torch.Tensor, log_blowup: int, shift: int = f.GENERATOR):
    """Evals over H_n -> evals over shift*H_{n<<log_blowup} (natural order):
    coefficients scaled by shift^i, zero-padded, transformed."""
    n = evals.shape[0]
    log_n = _log2(n)
    coeffs = intt(evals)
    sp = shift_powers_dev(shift, log_n, evals.device)
    coeffs = f.fmul(coeffs, sp.reshape((n,) + (1,) * (evals.dim() - 1)))
    pad = torch.zeros(
        (n * ((1 << log_blowup) - 1),) + tuple(evals.shape[1:]), dtype=I32, device=evals.device
    )
    return ntt(torch.cat([coeffs, pad]))
