"""A plain Brainfuck interpreter with the zkVM's semantics, written apart
from the port (reference crates/core/executor/src/executor.rs,
program.rs:22-50).

- Whitespace (space, newline, carriage return) is skipped; every other
  character is an instruction, and an unknown one is refused.
- One cycle per instruction.  '[' on a zero cell lands ON its ']' (which
  then steps past), ']' on a non-zero cell goes to the instruction after
  its '['.
- Cells hold bytes; '+'/'-' wrap mod 256; ',' stores the next input byte
  and stops the run when the input is exhausted; '.' appends the cell.
- '>'/'<' move the pointer and touch no memory; every other instruction
  reads (or writes) the cell under the pointer.

Besides the output and the cycle count, `run` returns what each chip of
the machine holds: the instruction counts by class, the distinct addresses
touched, every ','/'.' event, and each touched address's last access.
Memory is accessed at clk + 1 (clk = 2 x the cycle) and an ALU write at
clk + 2; a fresh cell holds 0 at timestamp 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

OPCODES = "[]+-><,."  # index = the zkVM's opcode number
TAPE_CELLS = 1 << 22  # the interpreter refuses a pointer outside [0, 2^22)


def compile_source(src: str) -> Tuple[List[int], List[int]]:
    """(opcodes, op_a): '[' carries the index of its ']', ']' the index after
    its '['."""
    ops: List[int] = []
    arg: List[int] = []
    stack: List[int] = []
    for ch in src:
        if ch in " \n\r":
            continue
        op = OPCODES.find(ch)
        if op < 0:
            raise ValueError(f"not a Brainfuck instruction: {ch!r}")
        if op == 0:
            stack.append(len(ops))
            ops.append(0)
            arg.append(0)
        elif op == 1:
            if not stack:
                raise ValueError("unbalanced ']'")
            start = stack.pop()
            arg[start] = len(ops)
            ops.append(1)
            arg.append(start + 1)
        else:
            ops.append(op)
            arg.append(0)
    if stack:
        raise ValueError("unbalanced '['")
    return ops, arg


@dataclass
class Run:
    output: bytes
    cycles: int
    counts: List[int]  # instructions executed per opcode, OPCODES order
    touched: int  # distinct addresses read or written
    io_events: np.ndarray  # (events, 4): pc, pointer, value, opcode of each ',' and '.'
    memory: np.ndarray  # (touched, 3), by address: address, last timestamp, final value

    @property
    def alu(self) -> int:
        return self.counts[2] + self.counts[3]

    @property
    def jumps(self) -> int:
        return self.counts[0] + self.counts[1]

    @property
    def steps(self) -> int:
        return self.counts[4] + self.counts[5]

    @property
    def io(self) -> int:
        return self.counts[6] + self.counts[7]


def run(src: str, stdin: bytes) -> Run:
    ops, arg = compile_source(src)
    n = len(ops)
    tape = bytearray(TAPE_CELLS)
    seen = bytearray(TAPE_CELLS)
    last = [0] * TAPE_CELLS
    counts = [0] * 8
    out = bytearray()
    io: List[Tuple[int, int, int, int]] = []
    pc = ptr = inp = touched = clk = 0
    n_in = len(stdin)
    while pc != n:
        op = ops[pc]
        counts[op] += 1
        clk += 2
        if op == 4:
            ptr += 1
            pc += 1
            continue
        if op == 5:
            ptr -= 1
            pc += 1
            continue
        if not 0 <= ptr < TAPE_CELLS:
            raise ValueError(f"pointer {ptr} outside the interpreter's tape")
        if not seen[ptr]:
            seen[ptr] = 1
            touched += 1
        if op == 3:
            tape[ptr] = (tape[ptr] - 1) & 0xFF
            last[ptr] = clk
            pc += 1
            continue
        last[ptr] = clk - 1
        if op == 1:
            pc = arg[pc] if tape[ptr] else pc + 1
        elif op == 0:
            pc = pc + 1 if tape[ptr] else arg[pc]
        elif op == 2:
            tape[ptr] = (tape[ptr] + 1) & 0xFF
            last[ptr] = clk
            pc += 1
        elif op == 6:
            if inp >= n_in:
                raise ValueError("input exhausted")
            tape[ptr] = stdin[inp]
            inp += 1
            io.append((pc, ptr, tape[ptr], 6))
            pc += 1
        else:
            out.append(tape[ptr])
            io.append((pc, ptr, tape[ptr], 7))
            pc += 1
    addrs = np.flatnonzero(np.frombuffer(seen, dtype=np.uint8))
    memory = np.stack([addrs, np.array([last[a] for a in addrs.tolist()], dtype=np.int64),
                       np.frombuffer(tape, dtype=np.uint8)[addrs]], axis=1).astype(np.int64)
    return Run(output=bytes(out), cycles=sum(counts), counts=counts, touched=touched,
               io_events=np.array(io, dtype=np.int64).reshape(-1, 4), memory=memory)
