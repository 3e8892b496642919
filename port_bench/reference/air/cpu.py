"""CPU chip: one row per cycle; the spine of the machine.

Reference: crates/core/machine/src/cpu/ (cols.rs:29-71, air.rs, trace.rs).
The layout and `eval` only, frozen from the port's models/cpu.py.
Sends every instruction-class tuple to its specialized chip, fetches
instructions from the Program table, and runs the two per-cycle memory
accesses (clk+1 read/io, clk+2 ALU write) through the Memory argument.
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind
from . import operations as op
from .base import ChipAir

INSTRUCTION_COLS = Layout([("opcode", 1), ("op_a", 4)])

CPU_COLS = Layout(
    [
        ("clk_16bit_limb", 1),
        ("clk_8bit_limb", 1),
        ("pc", 1),
        ("next_pc", 1),
        ("mp", 1),
        ("next_mp", 1),
        ("mv", 1),
        ("next_mv", 1),
        ("instruction", INSTRUCTION_COLS),
        ("mv_access", op.MEMORY_READ_WRITE_COLS),
        ("next_mv_access", op.MEMORY_WRITE_COLS),
        ("mv_accessed", 1),
        ("next_mv_accessed", 1),
        ("is_mv_immutable", 1),
        ("is_alu", 1),
        ("is_jump", 1),
        ("is_io", 1),
        ("is_memory_instr", 1),
        ("is_real", 1),
    ]
)


class CpuChip(ChipAir):
    name = "Cpu"
    cols = CPU_COLS
    local_only = False

    def eval(self, b) -> None:
        local = b.local
        next_ = b.next

        clk = local.clk_8bit_limb * (1 << 16) + local.clk_16bit_limb

        # Program fetch (pc, opcode, opcode, op_a bytes) - the duplicated
        # opcode mirrors send_program's value layout (air/program.rs:20-27).
        b.send(
            LookupKind.PROGRAM,
            [local.pc, local.instruction.opcode, local.instruction.opcode]
            + list(local.instruction.op_a),
            local.is_real,
        )

        # Instruction-class sends (air/builder.rs:82-230 schemas).
        b.send(
            LookupKind.ALU,
            [local.pc, local.instruction.opcode, local.next_mv, local.mv],
            local.is_alu,
        )
        b.send(
            LookupKind.JUMP,
            [local.pc, local.next_pc, local.instruction.opcode, local.mv],
            local.is_jump,
        )
        b.send(
            LookupKind.MEM_INSTR,
            [clk, local.pc, local.instruction.opcode, local.mp, local.next_mp],
            local.is_memory_instr,
        )
        b.send(
            LookupKind.IO,
            [local.pc, local.instruction.opcode, local.mp, local.mv],
            local.is_io,
        )

        # Register/memory constraints (cpu/air.rs:159-185).
        op.eval_memory_access(b, clk + 1, local.mp, local.mv_access, local.mv_accessed)
        op.eval_memory_access(
            b, clk + 2, local.mp, local.next_mv_access, local.next_mv_accessed
        )
        op.range_check_u8(b, local.mv, local.is_real)
        b.when(local.is_mv_immutable).assert_eq(
            local.mv_access.access.value, local.mv_access.prev_value
        )

        # clk chaining + 24-bit range (cpu/air.rs:95-123).
        b.when_first_row().assert_zero(clk)
        next_clk = next_.clk_8bit_limb * (1 << 16) + next_.clk_16bit_limb
        b.when_transition().when(next_.is_real).assert_eq(clk + 2, next_clk)
        op.eval_range_check_24bits(
            b, clk, local.clk_16bit_limb, local.clk_8bit_limb, local.is_real
        )

        # pc chaining (cpu/air.rs:126-139).
        b.when_transition().when(next_.is_real).assert_eq(local.next_pc, next_.pc)
        b.when_transition().when(local.is_real).when_not(local.is_jump).assert_eq(
            local.next_pc, local.pc + 1
        )

        # is_real shape (cpu/air.rs:145-156).
        b.assert_bool(local.is_real)
        b.when_first_row().assert_one(local.is_real)
        b.when_transition().when_not(local.is_real).assert_zero(next_.is_real)

        b.assert_bool(local.is_alu)
        b.assert_bool(local.is_jump)
        b.assert_bool(local.is_memory_instr)
        b.assert_bool(local.is_io)
        b.assert_bool(local.is_mv_immutable)
        b.assert_bool(local.mv_accessed)
        b.assert_bool(local.next_mv_accessed)
