"""Poseidon2 permutation (width 16, KoalaBear), exact host versions only.

A frozen copy of the port's host permutation (8 external + 13 internal
rounds, x^3 S-box, the RC_16_30 round constants in `poseidon2_rc16.json`
beside this file, the M4 external layer and the Plonky3 KoalaBear-16
internal diagonal): the Python-int version drives the transcript, the
numpy version hashes whole batches (Merkle paths, the preprocessed tree).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .field import P

WIDTH = 16
RATE = 8
OUT = 8
ROUNDS_F = 8
ROUNDS_P = 13
DIGEST_SIZE = 8

_DATA = os.path.dirname(os.path.abspath(__file__))

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
