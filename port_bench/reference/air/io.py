"""IO chip: ','/'.' selectors; value correctness rides on the CPU memory
argument.  Reference: crates/core/machine/src/io/mod.rs.  The layout and
`eval` only, frozen from the port's models/io.py.
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from .base import ChipAir

IO_COLS = Layout(
    [("pc", 1), ("mp", 1), ("mv", 1), ("is_input", 1), ("is_output", 1)]
)


class IoChip(ChipAir):
    name = "IO"
    cols = IO_COLS
    local_only = True

    def eval(self, b) -> None:
        local = b.local
        is_real = local.is_input + local.is_output
        b.assert_bool(local.is_input)
        b.assert_bool(local.is_output)
        b.assert_bool(is_real)
        opcode = local.is_input * 6 + local.is_output * 7
        b.receive(LookupKind.IO, [local.pc, opcode, local.mp, local.mv], is_real)
