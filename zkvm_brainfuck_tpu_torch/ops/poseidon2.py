"""Poseidon2 permutation (width 16, KoalaBear): CUDA kernels, plain torch
versions, and the exact host versions.

Parameters as in the JAX package (`zkvm_brainfuck_tpu/ops/poseidon2.py`):
8 external + 13 internal rounds, x^3 S-box, the reference's RC_16_30 round
constants (`data/poseidon2_rc16.json`, this package's own copy: rows 0..4
initial external, rows 4..17 internal column 0, rows 17..21 terminal
external), the HorizenLabs M4 external layer and the Plonky3 KoalaBear-16
internal diagonal.

Two kernels (csrc/poseidon2.cu) and their plain versions:

- `hash_rows(mats, bitrev)`: PaddingFreeSponge 16/8/8 over the row
  concatenation of same-height matrices -> (H, 8) digests; with `bitrev`,
  digest i hashes row rev(i) (the committed Merkle digest layer).
- `permute(states, out_cols)`: batched permutation of (N, 16) states,
  returning the first `out_cols` lanes (the Merkle compress and the grind).

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import json
import os
from functools import lru_cache
from typing import Sequence, Union

import numpy as np
import torch

from . import kernels as kn
from .field import I32, I64, P

WIDTH = 16
RATE = 8
OUT = 8
ROUNDS_F = 8
ROUNDS_P = 13
DIGEST_SIZE = 8

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

with open(os.path.join(_DATA, "poseidon2_rc16.json")) as _fh:
    _RC = json.load(_fh)["rc_16_30"]

RC_INITIAL = [_RC[r] for r in range(0, 4)]
RC_INTERNAL = [_RC[r][0] for r in range(4, 4 + ROUNDS_P)]
RC_TERMINAL = [_RC[r] for r in range(4 + ROUNDS_P, 8 + ROUNDS_P)]


def _frac(num: int, den: int) -> int:
    return (num % P) * pow(den, P - 2, P) % P


# Internal diagonal V = [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/8,
# 1/2^24, -1/2^8, -1/8, -1/16, -1/2^24] (Plonky3 KoalaBear-16).
INTERNAL_DIAG = [
    P - 2,
    1,
    2,
    _frac(1, 2),
    3,
    4,
    P - _frac(1, 2),
    P - 3,
    P - 4,
    _frac(1, 1 << 8),
    _frac(1, 8),
    _frac(1, 1 << 24),
    P - _frac(1, 1 << 8),
    P - _frac(1, 8),
    P - _frac(1, 16),
    P - _frac(1, 1 << 24),
]
assert len(set(INTERNAL_DIAG)) == WIDTH


def montgomery_constants():
    """(rc_ext (8*16), rc_int (13), diag (16)) in Montgomery form (x * 2^32
    mod p), the layout `zkbf_p2_set_constants` copies to constant memory."""
    mont = lambda x: (int(x) << 32) % P
    rc_ext = [mont(v) for row in RC_INITIAL + RC_TERMINAL for v in row]
    return rc_ext, [mont(v) for v in RC_INTERNAL], [mont(v) for v in INTERNAL_DIAG]


# ---------------------------------------------------------------------------
# Host (exact Python int) permutation - used by the Fiat-Shamir challenger.
# ---------------------------------------------------------------------------


def _h_m4(block):
    a, b, c, d = block
    return [
        (2 * a + 3 * b + c + d) % P,
        (a + 2 * b + 3 * c + d) % P,
        (a + b + 2 * c + 3 * d) % P,
        (3 * a + b + c + 2 * d) % P,
    ]


def _h_external_linear(state):
    blocks = [_h_m4(state[i : i + 4]) for i in range(0, WIDTH, 4)]
    sums = [sum(blk[j] for blk in blocks) % P for j in range(4)]
    return [(blocks[i // 4][i % 4] + sums[i % 4]) % P for i in range(WIDTH)]


def _h_sbox(x):
    return x * x % P * x % P


def permute_host(state):
    """Exact Poseidon2 on a list of 16 canonical ints."""
    s = _h_external_linear(list(state))
    for r in range(4):
        s = [(s[i] + RC_INITIAL[r][i]) % P for i in range(WIDTH)]
        s = [_h_sbox(x) for x in s]
        s = _h_external_linear(s)
    for r in range(ROUNDS_P):
        s0 = _h_sbox((s[0] + RC_INTERNAL[r]) % P)
        s = [s0] + s[1:]
        tot = sum(s) % P
        s = [(tot + INTERNAL_DIAG[i] * s[i]) % P for i in range(WIDTH)]
    for r in range(4):
        s = [(s[i] + RC_TERMINAL[r][i]) % P for i in range(WIDTH)]
        s = [_h_sbox(x) for x in s]
        s = _h_external_linear(s)
    return s


def hash_host(values):
    """PaddingFreeSponge 16/8/8 over canonical ints -> 8-int digest."""
    state = [0] * WIDTH
    vals = [int(v) for v in values]
    for i in range(0, len(vals), RATE):
        chunk = vals[i : i + RATE]
        state[: len(chunk)] = chunk
        state = permute_host(state)
    return state[:OUT]


def compress_host(left, right):
    """TruncatedPermutation<2, 8, 16>: permute(concat) and truncate."""
    state = [int(v) for v in left] + [int(v) for v in right]
    assert len(state) == WIDTH
    return permute_host(state)[:OUT]


# ---------------------------------------------------------------------------
# Plain torch versions (canonical int64 arithmetic, whole batch per op).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _torch_constants(device: torch.device):
    rc_init = torch.tensor(RC_INITIAL, dtype=I64, device=device)
    rc_int = torch.tensor(RC_INTERNAL, dtype=I64, device=device)
    rc_term = torch.tensor(RC_TERMINAL, dtype=I64, device=device)
    diag = torch.tensor(INTERNAL_DIAG, dtype=I64, device=device)
    return rc_init, rc_int, rc_term, diag


def _t_sbox(x):
    return x * x % P * x % P


def _t_external_linear(s):
    """(N, 16) int64 canonical -> (N, 16): M4 on each block of 4 lanes
    (out_j = sum + x_j + 2 x_{j+1}), then the cross-block column sums."""
    n = s.shape[0]
    x = s.view(n, 4, 4)
    blk = (x.sum(-1, keepdim=True) + x + 2 * torch.roll(x, -1, dims=-1)) % P
    return ((blk + blk.sum(1, keepdim=True)) % P).reshape(n, WIDTH)


def permute_plain(states: torch.Tensor) -> torch.Tensor:
    """Plain torch Poseidon2 over (N, 16) canonical states -> int32."""
    rc_init, rc_int, rc_term, diag = _torch_constants(states.device)
    s = _t_external_linear(states.to(I64))
    for r in range(4):
        s = _t_external_linear(_t_sbox((s + rc_init[r]) % P))
    for r in range(ROUNDS_P):
        s0 = _t_sbox((s[:, 0] + rc_int[r]) % P)
        s = torch.cat([s0[:, None], s[:, 1:]], dim=1)
        s = (s.sum(1, keepdim=True) + diag * s) % P
    for r in range(4):
        s = _t_external_linear(_t_sbox((s + rc_term[r]) % P))
    return s.to(I32)


def hash_rows_plain(mats: Sequence[torch.Tensor], bitrev: bool = False) -> torch.Tensor:
    """Plain torch sponge over the row concatenation of same-height
    matrices -> (H, 8) int32; with `bitrev`, digest i hashes row rev(i)."""
    row = torch.cat([m.to(I64) for m in mats], dim=1)
    h, w = row.shape
    state = torch.zeros((h, WIDTH), dtype=I64, device=row.device)
    for i in range(0, w, RATE):
        chunk = row[:, i : i + RATE]
        state = torch.cat([chunk, state[:, chunk.shape[1] :]], dim=1)
        state = permute_plain(state).to(I64)
    out = state[:, :OUT].to(I32)
    if bitrev:
        from .ntt import bitrev_dev

        out = out[bitrev_dev(h.bit_length() - 1, out.device)]
    return out.contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

MAX_MATS = 8  # matrices per hash_rows launch (ZKBF_P2_MAX_MATS in the source)


def hash_rows(mats: Union[torch.Tensor, Sequence[torch.Tensor]], bitrev: bool = False):
    """Leaf sponge over the row concatenation of same-height matrices."""
    if isinstance(mats, torch.Tensor):
        mats = [mats]
    mats = list(mats)
    h = int(mats[0].shape[0])
    for m in mats:
        if m.dim() != 2 or int(m.shape[0]) != h:
            raise ValueError("hash_rows: matrices must be 2-D with equal heights")
    if not mats[0].is_cuda:
        return hash_rows_plain(mats, bitrev)
    if len(mats) > MAX_MATS:
        # More matrices than a launch takes (narrow LDE blocks): join
        # neighbours.  The sponge reads the row concatenation, so the
        # digests do not change.
        per = -(-len(mats) // MAX_MATS)
        mats = [torch.cat(mats[k : k + per], dim=1) for k in range(0, len(mats), per)]
    if bitrev and h & (h - 1):
        raise ValueError("hash_rows: a bit-reversed height must be a power of two")
    for m in mats:
        kn.require_cuda_int32(m, "hash_rows")
    out = torch.empty((h, OUT), dtype=I32, device=mats[0].device)
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    widths = (ctypes.c_int * len(mats))(*[int(m.shape[1]) for m in mats])
    lib = kn.lib("poseidon2.cu", out.device)
    kn.check(
        lib.zkbf_p2_hash_rows(
            ctypes.addressof(ptrs), ctypes.addressof(widths), len(mats),
            out.data_ptr(), h, h.bit_length() - 1, int(bitrev), kn.stream(out.device),
        ),
        "poseidon2_hash_rows",
    )
    kn.COUNTS["poseidon2_hash_rows"] += 1
    return out


def sponge_cols(cols: Sequence[torch.Tensor]):
    """PaddingFreeSponge over a row given as a sequence of same-shape (N,)
    column tensors (one per field element position) -> the 8 digest
    columns; the column form of `hash_rows`."""
    digest = hash_rows(torch.stack(list(cols), dim=1).to(I32))
    return [digest[:, j] for j in range(OUT)]


def permute(states: torch.Tensor, out_cols: int = WIDTH) -> torch.Tensor:
    """Batched permutation of (N, 16) states -> (N, out_cols) int32."""
    if states.dim() != 2 or states.shape[1] != WIDTH:
        raise ValueError(f"permute: expected (N, 16), got {tuple(states.shape)}")
    if not 1 <= out_cols <= WIDTH:
        raise ValueError("permute: out_cols must be in 1..16")
    if not states.is_cuda:
        return permute_plain(states)[:, :out_cols].contiguous()
    kn.require_cuda_int32(states, "permute")
    n = int(states.shape[0])
    out = torch.empty((n, out_cols), dtype=I32, device=states.device)
    if n:
        lib = kn.lib("poseidon2.cu", states.device)
        kn.check(
            lib.zkbf_p2_permute(states.data_ptr(), out.data_ptr(), n, out_cols,
                                kn.stream(states.device)),
            "poseidon2_permute",
        )
        kn.COUNTS["poseidon2_permute"] += 1
    return out


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """TruncatedPermutation over batches: (N,8),(N,8) -> (N,8)."""
    return permute(torch.cat([left, right], dim=1), out_cols=OUT)


# ---------------------------------------------------------------------------
# Vectorized host (numpy uint64) permutation - the verifier's batch walker.
# ---------------------------------------------------------------------------

_NP_RC_INITIAL = np.array(RC_INITIAL, dtype=np.uint64)
_NP_RC_INTERNAL = np.array(RC_INTERNAL, dtype=np.uint64)
_NP_RC_TERMINAL = np.array(RC_TERMINAL, dtype=np.uint64)
_NP_DIAG = np.array(INTERNAL_DIAG, dtype=np.uint64)
_U64P = np.uint64(P)


def _np_sbox(x):
    return x * x % _U64P * x % _U64P


def _np_external_linear(s):
    """(N, 16) -> (N, 16), canonical u64."""
    out = np.empty_like(s)
    blocks = []
    for b in range(0, WIDTH, 4):
        a, bb, c, d = s[:, b], s[:, b + 1], s[:, b + 2], s[:, b + 3]
        t_all = (a + bb + c + d) % _U64P
        blocks.append(
            np.stack(
                [
                    (t_all + a + 2 * bb) % _U64P,
                    (t_all + bb + 2 * c) % _U64P,
                    (t_all + c + 2 * d) % _U64P,
                    (t_all + d + 2 * a) % _U64P,
                ],
                axis=1,
            )
        )
    sums = (blocks[0] + blocks[1] + blocks[2] + blocks[3]) % _U64P
    for b in range(4):
        out[:, 4 * b : 4 * b + 4] = (blocks[b] + sums) % _U64P
    return out


def permute_np(states: np.ndarray) -> np.ndarray:
    """Exact Poseidon2 on (N, 16) canonical uint64 (or any uint) batches."""
    s = np.asarray(states, dtype=np.uint64) % _U64P
    s = _np_external_linear(s)
    for r in range(4):
        s = _np_external_linear(_np_sbox((s + _NP_RC_INITIAL[r]) % _U64P))
    for r in range(ROUNDS_P):
        s0 = _np_sbox((s[:, 0] + _NP_RC_INTERNAL[r]) % _U64P)
        s = s.copy()
        s[:, 0] = s0
        tot = s.sum(axis=1) % _U64P
        s = (tot[:, None] + _NP_DIAG[None, :] * s) % _U64P
    for r in range(4):
        s = _np_external_linear(_np_sbox((s + _NP_RC_TERMINAL[r]) % _U64P))
    return s


def hash_np(matrix: np.ndarray) -> np.ndarray:
    """PaddingFreeSponge 16/8/8 per row: (N, W) canonical -> (N, 8) u64."""
    m = np.asarray(matrix, dtype=np.uint64)
    n, w = m.shape
    state = np.zeros((n, WIDTH), dtype=np.uint64)
    for i in range(0, w, RATE):
        chunk = m[:, i : i + RATE]
        state = state.copy()
        state[:, : chunk.shape[1]] = chunk
        state = permute_np(state)
    return state[:, :OUT]


def compress_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """TruncatedPermutation batch: (N,8),(N,8) -> (N,8) u64."""
    return permute_np(np.concatenate([left, right], axis=1))[:, :OUT]
