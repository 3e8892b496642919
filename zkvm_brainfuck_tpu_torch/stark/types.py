"""Proof containers (reference: crates/stark/src/types.rs), as in the JAX
package's stark/types.py."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from .pcs import PcsProof


@dataclass
class AirOpenedValues:
    local: List[tuple]  # EF4 tuples per column
    next: List[tuple]


@dataclass
class ChipOpenedValues:
    preprocessed: AirOpenedValues
    main: AirOpenedValues
    permutation: AirOpenedValues  # flattened base columns (PW*4)
    quotient: List[List[tuple]]  # per chunk, per base column (4), EF values
    cumulative_sum: tuple
    log_degree: int


@dataclass
class ShardCommitment:
    main_commit: List[int]
    permutation_commit: List[int]
    quotient_commit: List[int]


@dataclass
class ShardProof:
    commitment: ShardCommitment
    opened_values: List[ChipOpenedValues]
    opening_proof: PcsProof
    chip_ordering: Dict[str, int]

    def cumulative_sum(self) -> tuple:
        from . import ef_host as efh

        acc = efh.ZERO
        for c in self.opened_values:
            acc = efh.add(acc, c.cumulative_sum)
        return acc

    def contains_cpu(self) -> bool:
        return "Cpu" in self.chip_ordering

    def log_degree_cpu(self) -> int:
        idx = self.chip_ordering["Cpu"]
        return self.opened_values[idx].log_degree

    def to_bytes(self) -> bytes:
        """Deterministic length-prefixed u32 encoding (stark/serial.py)."""
        from .serial import encode_shard_proof

        return encode_shard_proof(self)

    @staticmethod
    def from_bytes(data: bytes) -> "ShardProof":
        """Safe parse of untrusted bytes (raises ProofDecodeError)."""
        from .serial import decode_shard_proof

        return decode_shard_proof(data)


@dataclass
class MachineProof:
    shard_proof: ShardProof

    def to_bytes(self) -> bytes:
        return self.shard_proof.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "MachineProof":
        return MachineProof(shard_proof=ShardProof.from_bytes(data))
