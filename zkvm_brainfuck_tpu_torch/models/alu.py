"""AddSub chip: '+'/'-' mod 256 through one shared adder.

Reference: crates/core/machine/src/alu/mod.rs.  The layout and `eval` are
copies of the JAX package's models/alu.py; trace generation is whole-column
torch.  For Add, operand_1 = mv and the adder output is next_mv; for Sub the
roles swap (operand_1 = next_mv, so operand_1 + 1 == mv), letting both
opcodes share AddOperation.
"""

from __future__ import annotations

import torch

from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from . import operations as op
from .base import ByteDeps, ChipAir, column, next_power_of_two, pad_rows

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

    def included(self, record: ExecutionRecord) -> bool:
        return bool(record.alu_mask.any())

    def num_rows(self, record: ExecutionRecord) -> int:
        return next_power_of_two(int(record.alu_mask.sum()))

    def _columns(self, record: ExecutionRecord, device):
        mask = record.alu_mask
        c = record.cpu
        pc = column(c.pc[mask], device)
        opcode = column(c.opcode[mask], device)
        mv = column(c.mv[mask], device)
        next_mv = column(c.next_mv[mask], device)
        operand_1 = torch.where(opcode == 2, mv, next_mv)
        operand_2 = torch.ones_like(operand_1)
        add_cols = op.populate_add_operation(operand_1, operand_2)
        cols = {
            "pc": pc,
            "operand_1": operand_1,
            "operand_2": operand_2,
            "is_add": (opcode == 2).to(torch.int64),
            "is_sub": (opcode == 3).to(torch.int64),
            "add_operation.value": add_cols["value"],
            "add_operation.carry": add_cols["carry"],
        }
        return cols, int(mask.sum())

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        cols, n = self._columns(record, resolve_device(device))
        padded = self.num_rows(record)
        return self.cols.assemble(pad_rows(cols, n, padded), padded)

    def byte_dependencies(self, record: ExecutionRecord, out: ByteDeps, device=None) -> None:
        cols, _n = self._columns(record, resolve_device(device))
        out.add_u8(cols["operand_1"])
        out.add_u8(cols["operand_2"])
        out.add_u8(cols["add_operation.value"])

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
