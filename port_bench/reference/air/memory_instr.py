"""MemoryInstrs chip: '>'/'<' pointer stepping with cross-row mp continuity.

Reference: crates/core/machine/src/memory/instructions/.  The layout and
`eval` only, frozen from the port's models/memory_instr.py.  NOT local_only: the `local.next_mp ==
next.mp` transition constraint couples adjacent rows, which is why rows must
stay in execution order (trace.rs:74-76, air.rs:46-49).
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from . import operations as op
from .base import ChipAir

MEMORY_INSTRUCTIONS_COLS = Layout(
    [
        ("pc", 1),
        ("clk", 1),
        ("mp", 4),
        ("mp_range_checker", op.KB_WORD_RANGE_CHECKER),
        ("next_mp", 4),
        ("next_mp_range_checker", op.KB_WORD_RANGE_CHECKER),
        ("is_step_forward", 1),
        ("is_step_backward", 1),
        ("is_real", 1),
    ]
)


class MemoryInstructionsChip(ChipAir):
    name = "MemoryInstrs"
    cols = MEMORY_INSTRUCTIONS_COLS
    local_only = False

    def eval(self, b) -> None:
        local = b.local
        next_ = b.next
        is_real = local.is_step_forward + local.is_step_backward
        b.assert_bool(local.is_step_forward)
        b.assert_bool(local.is_step_backward)
        b.assert_bool(is_real)

        mp = op.reduce_word(local.mp)
        next_mp = op.reduce_word(local.next_mp)
        b.when(local.is_step_forward).assert_eq(next_mp, mp + 1)
        b.when(local.is_step_backward).assert_eq(next_mp, mp - 1)

        # cross-row pointer continuity (air.rs:46-49)
        b.when_transition().when(next_.is_real).assert_eq(
            next_mp, op.reduce_word(next_.mp)
        )

        op.eval_kb_word_range_check(b, local.mp, local.mp_range_checker, local.is_real)
        op.eval_kb_word_range_check(
            b, local.next_mp, local.next_mp_range_checker, local.is_real
        )

        opcode = local.is_step_forward * 4 + local.is_step_backward * 5
        b.receive(
            LookupKind.MEM_INSTR, [local.clk, local.pc, opcode, mp, next_mp], is_real
        )
