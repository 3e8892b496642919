"""Byte chip: 2^16-row preprocessed range-check table + multiplicities.

Reference: crates/core/machine/src/bytes/.  The layout and `eval` are copies
of the JAX package's models/bytes.py.  Row r carries value_u8 = r & 0xff and
value_u16 = r; the main trace holds per-row multiplicities for U8Range
(receives (0, value_u8, 0)) and U16Range (receives (1, 0, value_u16)).

Multiplicities are device histograms (`index_add_`) over every chip's
range-check streams (ByteDeps): they count, so they need no field arithmetic.
"""

from __future__ import annotations

import torch

from ..core.isa import NUM_BYTE_OPS
from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from .base import ByteDeps, ChipAir

NUM_ROWS = 1 << 16

BYTE_PREPROCESSED_COLS = Layout([("value_u8", 1), ("value_u16", 1)])
BYTE_MULT_COLS = Layout([("multiplicities", NUM_BYTE_OPS)])


def histogram(deps: ByteDeps, device):
    """Aggregate u8/u16 streams into 2^16-length int64 multiplicity columns."""
    out = []
    for streams in (deps.u8, deps.u16):
        h = torch.zeros(NUM_ROWS, dtype=torch.int64, device=device)
        for vals, weights in streams:
            h.index_add_(0, vals.reshape(-1).to(device=device, dtype=torch.int64),
                         weights.reshape(-1).to(device=device, dtype=torch.int64))
        out.append(h)
    return out[0], out[1]


class ByteChip(ChipAir):
    name = "Byte"
    cols = BYTE_MULT_COLS
    prep_cols = BYTE_PREPROCESSED_COLS
    local_only = False

    def included(self, record: ExecutionRecord) -> bool:
        return True

    def num_rows(self, record: ExecutionRecord) -> int:
        return NUM_ROWS

    def generate_preprocessed(self, program, device=None) -> torch.Tensor:
        r = torch.arange(NUM_ROWS, dtype=torch.int64, device=resolve_device(device))
        return self.prep_cols.assemble({"value_u8": r & 0xFF, "value_u16": r}, NUM_ROWS)

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        u8, u16 = histogram(deps, resolve_device(device))
        return self.cols.assemble(
            {"multiplicities[0]": u8, "multiplicities[1]": u16}, NUM_ROWS
        )

    def eval(self, b) -> None:
        prep = b.prep_local
        mult = b.local.multiplicities
        b.receive(LookupKind.BYTE, [0, prep.value_u8, 0], mult[0])
        b.receive(LookupKind.BYTE, [1, 0, prep.value_u16], mult[1])
