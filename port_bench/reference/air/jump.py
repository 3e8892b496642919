"""Jump chip: '['/']' branch semantics with pc/next_pc range-checked words.

Reference: crates/core/machine/src/jump/ (cols.rs:12-31, air.rs:22-85).  The
layout and `eval` only, frozen from the port's models/jump.py.
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from . import operations as op
from .base import ChipAir

JUMP_COLS = Layout(
    [
        ("pc", 4),
        ("pc_range_checker", op.KB_WORD_RANGE_CHECKER),
        ("next_pc", 4),
        ("next_pc_range_checker", op.KB_WORD_RANGE_CHECKER),
        ("dst", 4),
        ("mv", 1),
        ("is_mv_zero", op.IS_ZERO_OPERATION),
        ("is_loop_start", 1),
        ("is_loop_end", 1),
    ]
)


class JumpChip(ChipAir):
    name = "Jump"
    cols = JUMP_COLS
    local_only = True

    def eval(self, b) -> None:
        local = b.local
        is_real = local.is_loop_start + local.is_loop_end
        b.assert_bool(local.is_loop_start)
        b.assert_bool(local.is_loop_end)
        b.assert_bool(is_real)

        op.eval_is_zero(b, local.mv, local.is_mv_zero, is_real)

        pc = op.reduce_word(local.pc)
        next_pc = op.reduce_word(local.next_pc)
        dst = op.reduce_word(local.dst)

        # '[': jump to dst iff mv == 0 else fall through (air.rs:34-56)
        b.when(local.is_loop_start).when(local.is_mv_zero.result).assert_eq(next_pc, dst)
        b.when(local.is_loop_start).when_not(local.is_mv_zero.result).assert_eq(
            next_pc, pc + 1
        )
        # ']': jump to dst iff mv != 0
        b.when(local.is_loop_end).when_not(local.is_mv_zero.result).assert_eq(next_pc, dst)
        b.when(local.is_loop_end).when(local.is_mv_zero.result).assert_eq(next_pc, pc + 1)

        op.eval_kb_word_range_check(b, local.pc, local.pc_range_checker, is_real)
        op.eval_kb_word_range_check(b, local.next_pc, local.next_pc_range_checker, is_real)

        opcode = local.is_loop_start * 0 + local.is_loop_end * 1
        b.receive(LookupKind.JUMP, [pc, next_pc, opcode, local.mv], is_real)
