"""Program chip: preprocessed instruction table + execution multiplicities.

Reference: crates/core/machine/src/program/mod.rs.  The layout and `eval`
only, frozen from the port's models/program.py.  The preprocessed trace pins
(pc, opcode, op_a) for the whole program (built in `reference/vk.py`); the
main trace is the per-pc execution count, received against the CPU's
Program-kind sends.
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from .base import ChipAir
from .cpu import INSTRUCTION_COLS

PROGRAM_PREPROCESSED_COLS = Layout([("pc", 1), ("instruction", INSTRUCTION_COLS)])
PROGRAM_MULT_COLS = Layout([("multiplicity", 1)])


class ProgramChip(ChipAir):
    name = "Program"
    cols = PROGRAM_MULT_COLS
    prep_cols = PROGRAM_PREPROCESSED_COLS
    local_only = False

    def eval(self, b) -> None:
        prep = b.prep_local
        b.receive(
            LookupKind.PROGRAM,
            [prep.pc, prep.instruction.opcode, prep.instruction.opcode]
            + list(prep.instruction.op_a),
            b.local.multiplicity,
        )
