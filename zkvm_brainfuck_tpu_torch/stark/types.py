"""Opened-value containers (reference: crates/stark/src/types.rs).

The two the uni-STARK verifier needs, as in the JAX package's
stark/types.py; the shard/machine proof types come with the multi-table
prover.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


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
