"""STARK configuration (reference: crates/stark/src/config.rs +
kb31_poseidon2.rs).

One concrete config, mirroring `KoalaBearPoseidon2`: KoalaBear base field,
EF4 challenge field, Poseidon2-16 hashing, two-adic FRI with log_blowup 1,
84 queries (env `FRI_QUERIES`), 16 PoW bits (~100-bit security target).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .challenger import DuplexChallenger

DIGEST_SIZE = 8


@dataclass
class FriConfig:
    log_blowup: int = 1
    num_queries: int = 84
    proof_of_work_bits: int = 16


def default_fri_config() -> FriConfig:
    return FriConfig(
        log_blowup=1,
        num_queries=int(os.environ.get("FRI_QUERIES", "84")),
        proof_of_work_bits=16,
    )


class KoalaBearPoseidon2:
    """The default (and only) config; name kept for reference parity."""

    def __init__(self, fri: FriConfig | None = None):
        self.fri = fri or default_fri_config()

    def challenger(self) -> DuplexChallenger:
        return DuplexChallenger()

    def zero_commitment(self):
        return [0] * DIGEST_SIZE
