"""LogUp lookup (interaction) types.

Reference: crates/stark/src/lookup/lookup.rs.  `argument_index` (the LookupKind
discriminant) is mixed into every RLC fingerprint as the beta^0 term
(permutation.rs:48-56), keeping distinct buses separate.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Tuple


class LookupKind(IntEnum):
    MEMORY = 1
    PROGRAM = 2
    ALU = 3
    JUMP = 4
    MEM_INSTR = 5
    IO = 6
    BYTE = 7


@dataclass(frozen=True)
class Affine:
    """Affine function of the LOCAL preprocessed/main row (VirtualPairCol).

    terms: ((is_prep, col_index, weight), ...), weight canonical int.
    """

    const: int
    terms: Tuple[Tuple[bool, int, int], ...]

    def apply_host(self, prep_row, main_row, P: int) -> int:
        acc = self.const
        for is_prep, idx, w in self.terms:
            v = prep_row[idx] if is_prep else main_row[idx]
            acc = (acc + w * int(v)) % P
        return acc % P


@dataclass(frozen=True)
class Lookup:
    """One send/receive message: values + multiplicity, all affine in the row."""

    values: Tuple[Affine, ...]
    multiplicity: Affine
    kind: LookupKind

    @property
    def argument_index(self) -> int:
        return int(self.kind)
