"""Proof and verifying-key bytes: the decoders, and the vk encoder that the
reference's own vk is compared through.  A frozen copy of the port's
stark/serial.py (itself the JAX package's byte format).

Replaces the round-1 pickle round-trip with a versioned, length-prefixed
little-endian u32 encoding that mirrors the reference's ShardProof field
order (crates/stark/src/types.rs:13-115: commitment, opened_values,
opening_proof, chip_ordering) so proof sizes are comparable with the
bincode size the reference logs (crates/core/machine/src/utils/prove.rs:47).

Deserialization is pure parsing over untrusted bytes - every count is
bounds-checked against the remaining buffer, and malformed input raises
`ProofDecodeError` (never executes anything, unlike `pickle.loads`).

Layout (all integers little-endian u32 unless noted):
    magic "ZKBF" | version | <ShardProof>
    ShardProof  = 3 x digest(8) | n_chips x ChipOpenedValues | PcsProof
                  | chip_ordering (n, then per chip: name_len, utf8, index)
    ChipOpened  = log_degree | cumulative_sum ef(4)
                  | Air(preprocessed) | Air(main) | Air(permutation)
                  | n_chunks x (n_cols x ef)
    Air         = n_local x ef | n_next x ef
    PcsProof    = FriProof | n_queries x (n_rounds x BatchOpening)
    FriProof    = n_commits x digest | final_poly ef | pow_witness u64
                  | n_queries x (n_layers x (pair(8) | n_sibs x digest(8)))
    BatchOpening= n_mats x (width, width values) | n_sibs x digest(8)
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

MAGIC = b"ZKBF"
VK_MAGIC = b"ZKBK"
VERSION = 1


class ProofDecodeError(Exception):
    pass


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u32(self, x: int):
        if not 0 <= x < (1 << 32):
            raise ValueError(f"u32 out of range: {x}")
        self.parts.append(struct.pack("<I", x))

    def u32s(self, xs):
        arr = np.asarray([int(v) for v in xs], dtype=np.uint32)
        self.parts.append(arr.astype("<u4").tobytes())

    def raw(self, b: bytes):
        self.parts.append(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.data):
            raise ProofDecodeError("truncated proof bytes")
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def count(self, limit: int = 1 << 24) -> int:
        n = self.u32()
        if n > limit:
            raise ProofDecodeError(f"implausible count {n}")
        return n

    def u32s(self, n: int) -> np.ndarray:
        if n > (len(self.data) - self.off) // 4:
            raise ProofDecodeError("truncated proof bytes")
        return np.frombuffer(self._take(4 * n), dtype="<u4").astype(np.uint32)

    def done(self) -> bool:
        return self.off == len(self.data)


# -- encode -----------------------------------------------------------------


def _w_digest(w: _Writer, d):
    vals = [int(x) for x in d]
    if len(vals) != 8:
        raise ValueError("digest must have 8 elements")
    w.u32s(vals)


def _r_ef(r: _Reader) -> tuple:
    return tuple(int(x) for x in r.u32s(4))


def _r_ef_list(r: _Reader) -> list:
    return [_r_ef(r) for _ in range(r.count())]


def _r_air(r: _Reader):
    from .types import AirOpenedValues

    return AirOpenedValues(local=_r_ef_list(r), next=_r_ef_list(r))


def _r_digest(r: _Reader) -> list:
    return [int(x) for x in r.u32s(8)]


def _r_paths(r: _Reader) -> np.ndarray:
    n = r.count()
    return r.u32s(8 * n).reshape(n, 8)


def encode_vk(vk) -> bytes:
    """StarkVerifyingKey -> bytes (reference machine.rs:73-75 serde parity).

    Layout: magic "ZKBK" | version | commit digest(8)
            | n_chips x (name_len, utf8, log_n, shift, height, width)
            | chip_ordering (n, then per chip: name_len, utf8, index)
    """
    w = _Writer()
    w.raw(VK_MAGIC)
    w.u32(VERSION)
    _w_digest(w, vk.commit)
    w.u32(len(vk.chip_information))
    for name, domain, (h, wd) in vk.chip_information:
        nb = name.encode("utf-8")
        w.u32(len(nb))
        w.raw(nb)
        w.u32(domain.log_n)
        w.u32(domain.shift)
        w.u32(h)
        w.u32(wd)
    items = sorted(vk.chip_ordering.items(), key=lambda kv: kv[1])
    w.u32(len(items))
    for name, idx in items:
        nb = name.encode("utf-8")
        w.u32(len(nb))
        w.raw(nb)
        w.u32(idx)
    return w.getvalue()


def decode_vk(data: bytes):
    """bytes -> StarkVerifyingKey (bounds-checked pure parsing)."""
    from .domains import Domain
    from .types import StarkVerifyingKey

    r = _Reader(data)
    if r._take(4) != VK_MAGIC:
        raise ProofDecodeError("bad vk magic")
    if r.u32() != VERSION:
        raise ProofDecodeError("unsupported vk version")
    commit = _r_digest(r)
    chip_information = []
    for _ in range(r.count(1 << 10)):
        name_len = r.count(1 << 10)
        name = r._take(name_len).decode("utf-8")
        log_n = r.count(64)
        shift = r.u32()
        h = r.count(1 << 26)
        wd = r.count(1 << 20)
        chip_information.append((name, Domain(log_n, shift), (h, wd)))
    chip_ordering = {}
    for _ in range(r.count(1 << 10)):
        name_len = r.count(1 << 10)
        name = r._take(name_len).decode("utf-8")
        chip_ordering[name] = r.u32()
    if not r.done():
        raise ProofDecodeError("trailing bytes after vk")
    return StarkVerifyingKey(
        commit=commit,
        chip_information=chip_information,
        chip_ordering=chip_ordering,
    )


def decode_shard_proof(data: bytes):
    from .pcs import BatchOpening, PcsProof
    from .fri import FriProof
    from .types import ChipOpenedValues, ShardCommitment, ShardProof

    r = _Reader(data)
    if r._take(4) != MAGIC:
        raise ProofDecodeError("bad magic")
    if r.u32() != VERSION:
        raise ProofDecodeError("unsupported proof version")
    commitment = ShardCommitment(
        main_commit=_r_digest(r),
        permutation_commit=_r_digest(r),
        quotient_commit=_r_digest(r),
    )

    opened = []
    for _ in range(r.count(1 << 10)):
        log_degree = r.u32()
        csum = _r_ef(r)
        prep = _r_air(r)
        main = _r_air(r)
        perm = _r_air(r)
        quotient = [_r_ef_list(r) for _ in range(r.count(1 << 10))]
        opened.append(
            ChipOpenedValues(
                preprocessed=prep,
                main=main,
                permutation=perm,
                quotient=quotient,
                cumulative_sum=csum,
                log_degree=log_degree,
            )
        )

    commits = [_r_digest(r) for _ in range(r.count(1 << 10))]
    final_poly = _r_ef(r)
    pow_witness = r.u64()
    query_commit_openings = []
    for _ in range(r.count(1 << 16)):
        layers = []
        for _ in range(r.count(1 << 10)):
            pair = r.u32s(8)
            layers.append((pair, _r_paths(r)))
        query_commit_openings.append(layers)
    fri = FriProof(
        commit_phase_commits=commits,
        final_poly=final_poly,
        pow_witness=pow_witness,
        query_commit_openings=query_commit_openings,
    )

    query_input_openings = []
    for _ in range(r.count(1 << 16)):
        per_q = []
        for _ in range(r.count(1 << 10)):
            rows = []
            for _ in range(r.count(1 << 10)):
                width = r.count(1 << 20)
                rows.append(r.u32s(width))
            per_q.append(BatchOpening(opened_rows=rows, proof=_r_paths(r)))
        query_input_openings.append(per_q)
    pcs = PcsProof(fri=fri, query_input_openings=query_input_openings)

    chip_ordering = {}
    for _ in range(r.count(1 << 10)):
        name_len = r.count(1 << 10)
        name = r._take(name_len).decode("utf-8")
        chip_ordering[name] = r.u32()
    if not r.done():
        raise ProofDecodeError("trailing bytes after proof")
    return ShardProof(
        commitment=commitment,
        opened_values=opened,
        opening_proof=pcs,
        chip_ordering=chip_ordering,
    )
