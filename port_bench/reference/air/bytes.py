"""Byte chip: 2^16-row preprocessed range-check table + multiplicities.

Reference: crates/core/machine/src/bytes/.  The layout and `eval` only, frozen
from the port's models/bytes.py.  Row r carries value_u8 = r & 0xff and
value_u16 = r; the main trace holds per-row multiplicities for U8Range
(receives (0, value_u8, 0)) and U16Range (receives (1, 0, value_u16)).
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from .base import ChipAir

NUM_ROWS = 1 << 16
NUM_BYTE_OPS = 2

BYTE_PREPROCESSED_COLS = Layout([("value_u8", 1), ("value_u16", 1)])
BYTE_MULT_COLS = Layout([("multiplicities", NUM_BYTE_OPS)])


class ByteChip(ChipAir):
    name = "Byte"
    cols = BYTE_MULT_COLS
    prep_cols = BYTE_PREPROCESSED_COLS
    local_only = False

    def eval(self, b) -> None:
        prep = b.prep_local
        mult = b.local.multiplicities
        b.receive(LookupKind.BYTE, [0, prep.value_u8, 0], mult[0])
        b.receive(LookupKind.BYTE, [1, 0, prep.value_u16], mult[1])
