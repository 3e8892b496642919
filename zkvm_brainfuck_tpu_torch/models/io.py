"""IO chip: ','/'.' selectors; value correctness rides on the CPU memory
argument.  Reference: crates/core/machine/src/io/mod.rs.  The layout and
`eval` are copies of the JAX package's models/io.py; trace generation is
whole-column torch.
"""

from __future__ import annotations

import torch

from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from .base import ChipAir, column, next_power_of_two, pad_rows

IO_COLS = Layout(
    [("pc", 1), ("mp", 1), ("mv", 1), ("is_input", 1), ("is_output", 1)]
)


class IoChip(ChipAir):
    name = "IO"
    cols = IO_COLS
    local_only = True

    def included(self, record: ExecutionRecord) -> bool:
        return bool(record.io_mask.any())

    def num_rows(self, record: ExecutionRecord) -> int:
        return next_power_of_two(int(record.io_mask.sum()))

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        device = resolve_device(device)
        mask = record.io_mask
        c = record.cpu
        n = int(mask.sum())
        opcode = column(c.opcode[mask], device)
        cols = {
            "pc": column(c.pc[mask], device),
            "mp": column(c.mp[mask], device),
            "mv": column(c.mv[mask], device),
            "is_input": (opcode == 6).to(torch.int64),
            "is_output": (opcode == 7).to(torch.int64),
        }
        padded = self.num_rows(record)
        return self.cols.assemble(pad_rows(cols, n, padded), padded)

    def eval(self, b) -> None:
        local = b.local
        is_real = local.is_input + local.is_output
        b.assert_bool(local.is_input)
        b.assert_bool(local.is_output)
        b.assert_bool(is_real)
        opcode = local.is_input * 6 + local.is_output * 7
        b.receive(LookupKind.IO, [local.pc, opcode, local.mp, local.mv], is_real)
