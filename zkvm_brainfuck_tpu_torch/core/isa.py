"""Guest ISA: Brainfuck opcodes and instructions.

Reference: crates/core/executor/src/opcode.rs:12-64,
crates/core/executor/src/instruction.rs:8-69.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class Opcode(IntEnum):
    LOOP_START = 0  # '[' jump to matching ] if cell == 0
    LOOP_END = 1  # ']' jump back if cell != 0
    ADD = 2  # '+'
    SUB = 3  # '-'
    MEM_STEP_FORWARD = 4  # '>'
    MEM_STEP_BACKWARD = 5  # '<'
    INPUT = 6  # ','
    OUTPUT = 7  # '.'

    @property
    def mnemonic(self) -> str:
        return "[]+-><,."[int(self)]


class ByteOpcode(IntEnum):
    U8_RANGE = 0
    U16_RANGE = 1


NUM_BYTE_OPS = 2

_CHAR_TO_OPCODE = {
    ">": Opcode.MEM_STEP_FORWARD,
    "<": Opcode.MEM_STEP_BACKWARD,
    "+": Opcode.ADD,
    "-": Opcode.SUB,
    ".": Opcode.OUTPUT,
    ",": Opcode.INPUT,
    "[": Opcode.LOOP_START,
    "]": Opcode.LOOP_END,
}


@dataclass(frozen=True)
class Instruction:
    opcode: Opcode
    op_a: int = 0  # jump target for '[' / ']'

    @property
    def is_alu(self) -> bool:
        return self.opcode in (Opcode.ADD, Opcode.SUB)

    @property
    def is_jump(self) -> bool:
        return self.opcode in (Opcode.LOOP_START, Opcode.LOOP_END)

    @property
    def is_memory(self) -> bool:
        return self.opcode in (Opcode.MEM_STEP_FORWARD, Opcode.MEM_STEP_BACKWARD)

    @property
    def is_io(self) -> bool:
        return self.opcode in (Opcode.INPUT, Opcode.OUTPUT)

    @property
    def is_mv_immutable(self) -> bool:
        """Ops that do not overwrite mv (reference instruction.rs:51-55)."""
        return self.is_alu or self.is_jump or self.opcode == Opcode.OUTPUT

    def __repr__(self) -> str:
        if self.is_jump:
            return f"{self.opcode.mnemonic}{self.op_a}"
        return self.opcode.mnemonic


def decode_char(ch: str, operand: int | None = None) -> Instruction:
    op = _CHAR_TO_OPCODE[ch]
    return Instruction(op, operand if operand is not None else 0)
