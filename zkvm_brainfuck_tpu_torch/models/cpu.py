"""CPU chip: one row per cycle; the spine of the machine.

Reference: crates/core/machine/src/cpu/ (cols.rs:29-71, air.rs, trace.rs).
The layout and `eval` are copies of the JAX package's models/cpu.py; trace
generation is rewritten as whole-column torch expressions.
Sends every instruction-class tuple to its specialized chip, fetches
instructions from the Program table, and runs the two per-cycle memory
accesses (clk+1 read/io, clk+2 ALU write) through the Memory argument.
"""

from __future__ import annotations

import torch

from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..stark.layout import Layout
from ..stark.lookup import LookupKind
from . import operations as op
from .base import ByteDeps, ChipAir, column, pad_rows

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

    def included(self, record: ExecutionRecord) -> bool:
        return record.num_cycles > 0

    def num_rows(self, record: ExecutionRecord) -> int:
        # cpu/trace.rs:32 uses plain next_power_of_two (no min-16 clamp)
        n = record.num_cycles
        return max(1, 1 << (n - 1).bit_length()) if n else 1

    def _columns(self, record: ExecutionRecord, device):
        """Column tensors (int64, canonical) of the executed cycles."""
        c = record.cpu
        n = record.num_cycles
        col = lambda a: column(a, device)  # noqa: E731

        clk = 2 * torch.arange(n, dtype=torch.int64, device=device)
        opcode = col(c.opcode)
        is_alu = ((opcode == 2) | (opcode == 3)).to(torch.int64)
        is_jump = ((opcode == 0) | (opcode == 1)).to(torch.int64)
        is_mem = ((opcode == 4) | (opcode == 5)).to(torch.int64)
        is_io = ((opcode == 6) | (opcode == 7)).to(torch.int64)
        is_immutable = is_alu | is_jump | (opcode == 7).to(torch.int64)

        mv = col(c.mv)
        next_mv = col(c.next_mv)
        mv_accessed = col(c.mv_accessed)
        next_mv_accessed = col(c.next_mv_accessed)

        cols = {
            "clk_16bit_limb": clk & 0xFFFF,
            "clk_8bit_limb": (clk >> 16) & 0xFF,
            "pc": col(c.pc),
            "next_pc": col(c.next_pc),
            "mp": col(c.mp),
            "next_mp": col(c.next_mp),
            "mv": mv,
            "next_mv": next_mv,
            "instruction.opcode": opcode,
            "mv_accessed": mv_accessed,
            "next_mv_accessed": next_mv_accessed,
            "is_mv_immutable": is_immutable,
            "is_alu": is_alu,
            "is_jump": is_jump,
            "is_io": is_io,
            "is_memory_instr": is_mem,
            "is_real": is_alu + is_jump + is_mem + is_io,
        }
        op_a = col(c.op_a)
        for i, b in enumerate(op.word_bytes(op_a)):
            cols[f"instruction.op_a[{i}]"] = b
        cols.update(
            op.populate_memory_access(
                "mv_access",
                value=mv,
                prev_value=col(c.mv_prev_value),
                prev_clk=col(c.mv_prev_ts),
                clk=clk + 1,
                accessed=mv_accessed,
            )
        )
        cols.update(
            op.populate_memory_access(
                "next_mv_access",
                value=next_mv,
                prev_value=mv,  # ALU write at clk+2 overwrites the clk+1 value
                prev_clk=col(c.next_mv_prev_ts),
                clk=clk + 2,
                accessed=next_mv_accessed,
            )
        )
        return cols, n

    def generate_trace(self, record: ExecutionRecord, deps, device=None) -> torch.Tensor:
        """(2^k, 31) canonical int32 trace on `device` (the card unless
        device="cpu")."""
        device = resolve_device(device)
        cols, n = self._columns(record, device)
        padded = self.num_rows(record)
        return self.cols.assemble(pad_rows(cols, n, padded), padded)

    def byte_dependencies(self, record: ExecutionRecord, out: ByteDeps, device=None) -> None:
        cols, n = self._columns(record, resolve_device(device))
        out.add_u16(cols["clk_16bit_limb"])
        out.add_u8(cols["clk_8bit_limb"])
        out.add_u8(cols["mv"])
        acc = cols["mv_accessed"]
        nacc = cols["next_mv_accessed"]
        out.add_u16(cols["mv_access.access.diff_16bit_limb"], acc)
        out.add_u8(cols["mv_access.access.diff_8bit_limb"], acc)
        out.add_u16(cols["next_mv_access.access.diff_16bit_limb"], nacc)
        out.add_u8(cols["next_mv_access.access.diff_8bit_limb"], nacc)

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
