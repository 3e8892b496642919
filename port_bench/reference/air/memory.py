"""Memory chip: closes the per-address access chains of the Memory argument.

Reference: crates/core/machine/src/memory/memory.rs.  The layout and `eval`
only, frozen from the port's models/memory.py.  For every touched address it RECEIVES (initial_clk,
addr, initial_value) and SENDS (final_clk, addr, final_value); together with
the CPU's per-access send(prev)/receive(current) pairs the Memory-kind
multiset cancels iff every read sees the last write (initial memory is
all-zeros at timestamp 0).  Two address entries per row.
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from .base import ChipAir

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
