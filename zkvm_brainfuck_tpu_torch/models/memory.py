"""Memory chip: closes the per-address access chains of the Memory argument.

Reference: crates/core/machine/src/memory/memory.rs.  The layout and `eval`
are copies of the JAX package's models/memory.py; trace generation is
whole-column torch.  For every touched address it RECEIVES (initial_clk,
addr, initial_value) and SENDS (final_clk, addr, final_value); together with
the CPU's per-access send(prev)/receive(current) pairs the Memory-kind
multiset cancels iff every read sees the last write (initial memory is
all-zeros at timestamp 0).  Two address entries per row.
"""

from __future__ import annotations

import torch

from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from .base import ChipAir, column, next_power_of_two

NUM_MEMORY_ENTRIES_PER_ROW = 2

SINGLE_MEMORY_LOCAL = Layout(
    [
        ("addr", 1),
        ("initial_clk", 1),
        ("final_clk", 1),
        ("initial_value", 1),
        ("final_value", 1),
        ("is_real", 1),
    ]
)

MEM_COLS = Layout([("memory_entries", (NUM_MEMORY_ENTRIES_PER_ROW, SINGLE_MEMORY_LOCAL))])


class MemoryChip(ChipAir):
    name = "Memory"
    cols = MEM_COLS
    local_only = False  # reference MemoryChip keeps default local_only = false

    def included(self, record: ExecutionRecord) -> bool:
        return len(record.memory) > 0

    def num_rows(self, record: ExecutionRecord) -> int:
        n = (len(record.memory) + NUM_MEMORY_ENTRIES_PER_ROW - 1) // NUM_MEMORY_ENTRIES_PER_ROW
        return next_power_of_two(n)

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        device = resolve_device(device)
        m = record.memory
        n_ev = len(m)
        padded = self.num_rows(record)
        total = padded * NUM_MEMORY_ENTRIES_PER_ROW

        def col(x):
            return torch.nn.functional.pad(x, (0, total - n_ev))

        data = {
            "addr": col(column(m.addr, device)),
            "initial_clk": col(column(m.initial_ts, device)),
            "final_clk": col(column(m.final_ts, device)),
            "initial_value": col(column(m.initial_value, device)),
            "final_value": col(column(m.final_value, device)),
            "is_real": col(torch.ones(n_ev, dtype=torch.int64, device=device)),
        }
        cols = {}
        for k in range(NUM_MEMORY_ENTRIES_PER_ROW):
            for name, arr in data.items():
                cols[f"memory_entries[{k}].{name}"] = arr[k::NUM_MEMORY_ENTRIES_PER_ROW]
        return self.cols.assemble(cols, padded)

    def eval(self, b) -> None:
        for entry in b.local.memory_entries:
            b.receive(
                LookupKind.MEMORY,
                [entry.initial_clk, entry.addr, entry.initial_value],
                entry.is_real,
            )
            b.send(
                LookupKind.MEMORY,
                [entry.final_clk, entry.addr, entry.final_value],
                entry.is_real,
            )
