"""Proof and key containers (reference: crates/stark/src/types.rs,
machine.rs), a frozen copy of the port's."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .domains import Domain
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

    @staticmethod
    def from_bytes(data: bytes) -> "ShardProof":
        """Safe parse of untrusted bytes (raises ProofDecodeError)."""
        from .serial import decode_shard_proof

        return decode_shard_proof(data)


@dataclass
class StarkVerifyingKey:
    commit: List[int]
    chip_information: List[Tuple[str, Domain, Tuple[int, int]]]  # (name, domain, (h, w))
    chip_ordering: Dict[str, int]

    def observe_into(self, challenger):
        challenger.observe_commitment([int(x) for x in self.commit])
        for _ in range(7):
            challenger.observe(0)
