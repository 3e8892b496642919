"""Brainfuck "compiler": source -> instruction list with resolved brackets.

Reference semantics (crates/core/executor/src/program.rs:22-50):
- '[' gets op_a = index AFTER the matching ']'
- ']' gets op_a = index after the matching '[' (i.e. start_pos + 1)
- whitespace (space, \\n, \\r) is skipped; any other character is an opcode
- termination: pc == len(instructions)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .isa import Instruction, Opcode, decode_char


@dataclass
class Program:
    instructions: List[Instruction] = field(default_factory=list)

    @classmethod
    def from_source(cls, code: str) -> "Program":
        loop_stack: List[int] = []
        instructions: List[Instruction] = []
        for ch in code:
            if ch == "[":
                instructions.append(decode_char(ch, 0))
                loop_stack.append(len(instructions) - 1)
            elif ch == "]":
                start_pos = loop_stack.pop()
                # back-patch the '[' with the index of this ']' (the patch happens
                # before ']' is appended, mirroring program.rs:35-38 exactly: a
                # skipping '[' lands ON the ']' whose zero-check then steps past it)
                instructions[start_pos] = Instruction(
                    Opcode.LOOP_START, len(instructions)
                )
                instructions.append(decode_char(ch, start_pos + 1))
            elif ch not in (" ", "\n", "\r"):
                instructions.append(decode_char(ch))
        if loop_stack:
            raise ValueError("unbalanced '[' in program")
        return cls(instructions)

    def fetch(self, pc: int) -> Instruction:
        return self.instructions[pc]

    def __len__(self) -> int:
        return len(self.instructions)

    def to_arrays(self):
        """Columnar (opcode, op_a) uint32 arrays for device-side trace gen."""
        n = len(self.instructions)
        opcodes = np.fromiter((int(i.opcode) for i in self.instructions), np.uint32, n)
        op_a = np.fromiter((i.op_a for i in self.instructions), np.uint32, n)
        return opcodes, op_a
