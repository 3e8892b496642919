"""AddSub chip: '+'/'-' mod 256 through one shared adder.

Reference: crates/core/machine/src/alu/mod.rs.  The layout and `eval` only,
frozen from the port's models/alu.py.  For Add, operand_1 = mv and the adder output is next_mv; for Sub the
roles swap (operand_1 = next_mv, so operand_1 + 1 == mv), letting both
opcodes share AddOperation.
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from . import operations as op
from .base import ChipAir

ADD_SUB_COLS = Layout(
    [
        ("pc", 1),
        ("add_operation", op.ADD_OPERATION),
        ("operand_1", 1),
        ("operand_2", 1),
        ("is_add", 1),
        ("is_sub", 1),
    ]
)


class AddSubChip(ChipAir):
    name = "AddSub"
    cols = ADD_SUB_COLS
    local_only = True

    def eval(self, b) -> None:
        local = b.local
        is_real = local.is_add + local.is_sub
        b.assert_bool(local.is_add)
        b.assert_bool(local.is_sub)
        b.assert_bool(is_real)

        op.eval_add_operation(
            b, local.operand_1, local.operand_2, local.add_operation, is_real
        )

        # Add: (pc, ADD, result, operand_1); Sub: (pc, SUB, operand_1, result)
        b.receive(
            LookupKind.ALU,
            [local.pc, 2, local.add_operation.value, local.operand_1],
            local.is_add,
        )
        b.receive(
            LookupKind.ALU,
            [local.pc, 3, local.operand_1, local.add_operation.value],
            local.is_sub,
        )
