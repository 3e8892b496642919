"""The verifying key worked out again from the guest's source, in numpy.

The machine's two preprocessed tables are the Program chip's (pc, opcode
and the four little-endian bytes of op_a for every instruction, padded to
a power of two of at least 16 rows) and the Byte chip's (row r holds
r & 0xff and r, 2^16 rows).  They are sorted by height (tallest first) and
name, extended to twice their height over the coset GENERATOR * H_2n, and
committed in one Merkle batch whose digest layers hash the rows in
bit-reversed order (reference crates/stark/src/machine.rs setup, p3
TwoAdicFriPcs::commit).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .air.base import next_power_of_two
from .interp import compile_source
from .stark import field as xf
from .stark import poseidon2 as p2
from .stark.domains import Domain
from .stark.field import GENERATOR, P
from .stark.merkle import reverse_bits, root_np
from .stark.serial import encode_vk
from .stark.types import StarkVerifyingKey

_U64P = np.uint64(P)
BYTE_ROWS = 1 << 16


def _ntt(x: np.ndarray, root: int) -> np.ndarray:
    """Evaluations sum_i x_i root^(ik) for every k, natural order, over the
    columns of a (2^L, W) uint64 array."""
    n = x.shape[0]
    log_n = n.bit_length() - 1
    x = x[reverse_bits(np.arange(n), log_n)] % _U64P
    for s in range(1, log_n + 1):
        m = 1 << s
        w_m = pow(root, n >> s, P)
        tw = xf.powers_host(w_m, m // 2).astype(np.uint64)[None, :, None]
        x = x.reshape(n // m, m, -1)
        u = x[:, : m // 2]
        v = x[:, m // 2 :] * tw % _U64P
        x = np.concatenate([(u + v) % _U64P, (u + _U64P - v) % _U64P], axis=1)
    return x.reshape(n, -1)


def coset_lde(evals: np.ndarray, log_blowup: int) -> np.ndarray:
    """Evaluations over H_n -> evaluations over GENERATOR * H_(n << b)."""
    n = evals.shape[0]
    log_n = n.bit_length() - 1
    w = xf.two_adic_root(log_n)
    coeffs = _ntt(evals.astype(np.uint64), pow(w, P - 2, P)) * np.uint64(pow(n, P - 2, P)) % _U64P
    coeffs = coeffs * xf.powers_host(GENERATOR, n).astype(np.uint64)[:, None] % _U64P
    big = np.zeros((n << log_blowup, evals.shape[1]), np.uint64)
    big[:n] = coeffs
    return _ntt(big, xf.two_adic_root(log_n + log_blowup))


def preprocessed(src: str) -> List[Tuple[str, np.ndarray]]:
    ops, arg = compile_source(src)
    n = len(ops)
    h = next_power_of_two(n)
    prog = np.zeros((h, 6), np.uint64)
    prog[:n, 0] = np.arange(n)
    prog[:n, 1] = ops
    a = np.asarray(arg, np.uint64)
    for i in range(4):
        prog[:n, 2 + i] = (a >> np.uint64(8 * i)) & np.uint64(0xFF)
    r = np.arange(BYTE_ROWS, dtype=np.uint64)
    byte = np.stack([r & np.uint64(0xFF), r], axis=1)
    return sorted([("Program", prog), ("Byte", byte)], key=lambda t: (-t[1].shape[0], t[0]))


def verifying_key(src: str, log_blowup: int) -> StarkVerifyingKey:
    tables = preprocessed(src)
    groups: Dict[int, List[np.ndarray]] = {}
    for _name, t in tables:
        groups.setdefault(t.shape[0] << log_blowup, []).append(coset_lde(t, log_blowup))
    digests = {}
    for h, ldes in groups.items():
        rows = np.concatenate(ldes, axis=1)[reverse_bits(np.arange(h), h.bit_length() - 1)]
        digests[h] = p2.hash_np(rows)
    root = root_np(digests)
    info = [(name, Domain(t.shape[0].bit_length() - 1, 1), (t.shape[0], t.shape[1]))
            for name, t in tables]
    return StarkVerifyingKey(commit=[int(x) for x in root], chip_information=info,
                             chip_ordering={name: i for i, (name, _t) in enumerate(tables)})


def verifying_key_bytes(src: str, log_blowup: int) -> bytes:
    return encode_vk(verifying_key(src, log_blowup))
