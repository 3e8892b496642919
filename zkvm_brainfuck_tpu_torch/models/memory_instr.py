"""MemoryInstrs chip: '>'/'<' pointer stepping with cross-row mp continuity.

Reference: crates/core/machine/src/memory/instructions/.  The layout and
`eval` are copies of the JAX package's models/memory_instr.py; trace
generation is whole-column torch.  NOT local_only: the `local.next_mp ==
next.mp` transition constraint couples adjacent rows, which is why rows must
stay in execution order (trace.rs:74-76, air.rs:46-49).
"""

from __future__ import annotations

import torch

from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from . import operations as op
from .base import ChipAir, column, next_power_of_two, pad_rows

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

    def included(self, record: ExecutionRecord) -> bool:
        return bool(record.memory_instr_mask.any())

    def num_rows(self, record: ExecutionRecord) -> int:
        return next_power_of_two(int(record.memory_instr_mask.sum()))

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        device = resolve_device(device)
        mask = record.memory_instr_mask
        c = record.cpu
        n = int(mask.sum())
        mp = column(c.mp[mask], device)
        next_mp = column(c.next_mp[mask], device)
        opcode = column(c.opcode[mask], device)

        cols = {
            "pc": column(c.pc[mask], device),
            "clk": 2 * column(mask.nonzero()[0], device),
            "is_step_forward": (opcode == 4).to(torch.int64),
            "is_step_backward": (opcode == 5).to(torch.int64),
            "is_real": torch.ones(n, dtype=torch.int64, device=device),
        }
        for i, bb in enumerate(op.word_bytes(mp)):
            cols[f"mp[{i}]"] = bb
        for i, bb in enumerate(op.word_bytes(next_mp)):
            cols[f"next_mp[{i}]"] = bb
        for k, v in op.populate_kb_word_range_check(mp).items():
            cols[f"mp_range_checker.{k}"] = v
        for k, v in op.populate_kb_word_range_check(next_mp).items():
            cols[f"next_mp_range_checker.{k}"] = v

        padded = self.num_rows(record)
        return self.cols.assemble(pad_rows(cols, n, padded), padded)

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
