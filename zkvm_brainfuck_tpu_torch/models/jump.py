"""Jump chip: '['/']' branch semantics with pc/next_pc range-checked words.

Reference: crates/core/machine/src/jump/ (cols.rs:12-31, air.rs:22-85).  The
layout and `eval` are copies of the JAX package's models/jump.py; trace
generation is whole-column torch.
"""

from __future__ import annotations

import torch

from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from . import operations as op
from .base import ChipAir, column, next_power_of_two, pad_rows

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

    def included(self, record: ExecutionRecord) -> bool:
        return bool(record.jump_mask.any())

    def num_rows(self, record: ExecutionRecord) -> int:
        return next_power_of_two(int(record.jump_mask.sum()))

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        device = resolve_device(device)
        mask = record.jump_mask
        c = record.cpu
        n = int(mask.sum())
        pc = column(c.pc[mask], device)
        next_pc = column(c.next_pc[mask], device)
        dst = column(c.op_a[mask], device)
        mv = column(c.mv[mask], device)
        opcode = column(c.opcode[mask], device)

        cols = {"mv": mv}
        for i, bb in enumerate(op.word_bytes(pc)):
            cols[f"pc[{i}]"] = bb
        for i, bb in enumerate(op.word_bytes(next_pc)):
            cols[f"next_pc[{i}]"] = bb
        for i, bb in enumerate(op.word_bytes(dst)):
            cols[f"dst[{i}]"] = bb
        for k, v in op.populate_kb_word_range_check(pc).items():
            cols[f"pc_range_checker.{k}"] = v
        for k, v in op.populate_kb_word_range_check(next_pc).items():
            cols[f"next_pc_range_checker.{k}"] = v
        for k, v in op.populate_is_zero(mv).items():
            cols[f"is_mv_zero.{k}"] = v
        cols["is_loop_start"] = (opcode == 0).to(torch.int64)
        cols["is_loop_end"] = (opcode == 1).to(torch.int64)

        padded = self.num_rows(record)
        return self.cols.assemble(pad_rows(cols, n, padded), padded)

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
