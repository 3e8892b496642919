"""Program chip: preprocessed instruction table + execution multiplicities.

Reference: crates/core/machine/src/program/mod.rs.  The layout and `eval`
are copies of the JAX package's models/program.py; the tables are built with
torch on a device.  The preprocessed trace pins (pc, opcode, op_a) for the
whole program; the main trace is the per-pc execution count (a device
bincount over the cpu pc column), received against the CPU's Program-kind
sends.
"""

from __future__ import annotations

import torch

from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from . import operations as op
from .base import ChipAir, column, next_power_of_two, pad_rows
from .cpu import INSTRUCTION_COLS

PROGRAM_PREPROCESSED_COLS = Layout([("pc", 1), ("instruction", INSTRUCTION_COLS)])
PROGRAM_MULT_COLS = Layout([("multiplicity", 1)])


class ProgramChip(ChipAir):
    name = "Program"
    cols = PROGRAM_MULT_COLS
    prep_cols = PROGRAM_PREPROCESSED_COLS
    local_only = False

    def included(self, record: ExecutionRecord) -> bool:
        return True

    def num_rows(self, record: ExecutionRecord) -> int:
        return next_power_of_two(len(record.program))

    def generate_preprocessed(self, program, device=None) -> torch.Tensor:
        device = resolve_device(device)
        opcodes, op_a = program.to_arrays()
        n = len(opcodes)
        padded = next_power_of_two(n)
        cols = {
            "pc": torch.arange(n, dtype=torch.int64, device=device),
            "instruction.opcode": column(opcodes, device),
        }
        for i, bb in enumerate(op.word_bytes(column(op_a, device))):
            cols[f"instruction.op_a[{i}]"] = bb
        return self.prep_cols.assemble(pad_rows(cols, n, padded), padded)

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        device = resolve_device(device)
        padded = self.num_rows(record)
        counts = torch.bincount(column(record.cpu.pc, device), minlength=padded)
        return self.cols.assemble({"multiplicity": counts[:padded]}, padded)

    def eval(self, b) -> None:
        prep = b.prep_local
        b.receive(
            LookupKind.PROGRAM,
            [prep.pc, prep.instruction.opcode, prep.instruction.opcode]
            + list(prep.instruction.op_a),
            b.local.multiplicity,
        )
