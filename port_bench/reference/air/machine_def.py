"""The Brainfuck machine: all 8 chips in reference order.

Reference: crates/core/machine/src/brainfuck/mod.rs:47-81 (the JAX package's
models/machine_def.py).
"""

from __future__ import annotations

from .alu import AddSubChip
from .bytes import ByteChip
from .cpu import CpuChip
from .io import IoChip
from .jump import JumpChip
from .memory import MemoryChip
from .memory_instr import MemoryInstructionsChip
from .program import ProgramChip


def brainfuck_chips():
    return [
        CpuChip(),
        ProgramChip(),
        AddSubChip(),
        JumpChip(),
        MemoryChip(),
        ByteChip(),
        MemoryInstructionsChip(),
        IoChip(),
    ]
