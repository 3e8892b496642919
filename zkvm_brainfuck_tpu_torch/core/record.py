"""Columnar execution record: the "shard" as struct-of-arrays.

TPU-first re-design of the reference's event vectors
(crates/core/executor/src/record.rs:15-43, events/*):  instead of per-cycle
structs, every event field is a dense numpy column so that chip trace
generation becomes vectorized device code.  Per-instruction-class event lists
(add/jump/memory-instr/io) are *derived views* selected by opcode masks - they
are not stored separately (the reference's sub_events is empty anyway,
record.rs:21-23).  Byte-lookup multiplicities are not collected here at all:
they are computed on-device as histograms during trace generation
(the TPU equivalent of `generate_dependencies`).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Optional

import numpy as np

from .program import Program


@dataclass
class CpuColumns:
    """One entry per executed cycle; clk(i) = 2*i."""

    pc: np.ndarray  # u32
    next_pc: np.ndarray  # u32
    mp: np.ndarray  # u32
    next_mp: np.ndarray  # u32
    mv: np.ndarray  # u32 (byte value)
    next_mv: np.ndarray  # u32 (byte value; ALU result)
    opcode: np.ndarray  # u32
    op_a: np.ndarray  # u32 (jump destination operand)
    mv_accessed: np.ndarray  # u8 bool: cycle touched memory at clk+1
    mv_prev_ts: np.ndarray  # u32: previous access timestamp for the clk+1 access
    mv_prev_value: np.ndarray  # u32: value before the clk+1 access
    next_mv_accessed: np.ndarray  # u8 bool: ALU write at clk+2
    next_mv_prev_ts: np.ndarray  # u32

    def __len__(self):
        return len(self.pc)


@dataclass
class MemoryFirstLast:
    """Per touched address: first/last access records (events/memory.rs:7-26)."""

    addr: np.ndarray  # u32
    initial_ts: np.ndarray  # u32
    initial_value: np.ndarray  # u32
    final_ts: np.ndarray  # u32
    final_value: np.ndarray  # u32

    def __len__(self):
        return len(self.addr)


@dataclass
class ExecutionRecord:
    program: Program
    cpu: CpuColumns
    memory: MemoryFirstLast
    input_stream: bytes
    output_stream: bytes
    global_clk: int

    # -- derived per-instruction-class masks (cached) ---------------------

    def _mask(self, *opcodes) -> np.ndarray:
        m = np.zeros(len(self.cpu), dtype=bool)
        for op in opcodes:
            m |= self.cpu.opcode == int(op)
        return m

    @property
    def alu_mask(self) -> np.ndarray:
        return self._mask(2, 3)

    @property
    def jump_mask(self) -> np.ndarray:
        return self._mask(0, 1)

    @property
    def memory_instr_mask(self) -> np.ndarray:
        return self._mask(4, 5)

    @property
    def io_mask(self) -> np.ndarray:
        return self._mask(6, 7)

    @property
    def num_cycles(self) -> int:
        return len(self.cpu)

    def append(self, other: "ExecutionRecord") -> None:
        """Merge another record's events into this one (MachineRecord::append,
        reference record.rs:71-88 / stark/src/record.rs:2-5).

        clk is implicit here (clk(i) = 2*i), so concatenating other's CPU
        rows reassigns their clocks: every timestamp carried by `other`
        (mv_prev_ts / next_mv_prev_ts / memory initial+final ts) is REBASED
        by 2*len(self.cpu) first, preserving ts==0 "fresh address" semantics
        (the reference's CpuEvent carries an explicit clk instead,
        record.rs:72-88, so no rebasing is needed there).

        Memory first/last entries are then reconciled per address: earliest
        (rebased) initial access wins the initial slot, latest final access
        wins the final slot; ties break deterministically in favor of self
        (concat order), which matters only for the both-fresh (ts==0,
        value==0) case.

        Both records must execute the SAME program - the merged record
        indexes self.program with other's pc values.
        """
        assert (
            self.program is other.program
            or [
                (int(i.opcode), i.op_a) for i in self.program.instructions
            ]
            == [(int(i.opcode), i.op_a) for i in other.program.instructions]
        ), "append requires records of the same program"

        clk_base = np.int64(2 * len(self.cpu))

        def rebase(ts: np.ndarray) -> np.ndarray:
            t = ts.astype(np.int64)
            return np.where(t > 0, t + clk_base, 0).astype(np.uint32)

        rebased = {
            "mv_prev_ts": rebase(other.cpu.mv_prev_ts),
            "next_mv_prev_ts": rebase(other.cpu.next_mv_prev_ts),
        }
        self.cpu = CpuColumns(
            **{
                f: np.concatenate(
                    [getattr(self.cpu, f), rebased.get(f, getattr(other.cpu, f))]
                )
                for f in (
                    "pc", "next_pc", "mp", "next_mp", "mv", "next_mv",
                    "opcode", "op_a", "mv_accessed", "mv_prev_ts",
                    "mv_prev_value", "next_mv_accessed", "next_mv_prev_ts",
                )
            }
        )
        if len(other.memory):
            addr = np.concatenate([self.memory.addr, other.memory.addr])
            ini_ts = np.concatenate(
                [self.memory.initial_ts, rebase(other.memory.initial_ts)]
            ).astype(np.int64)
            ini_v = np.concatenate([self.memory.initial_value, other.memory.initial_value])
            fin_ts = np.concatenate(
                [self.memory.final_ts, rebase(other.memory.final_ts)]
            ).astype(np.int64)
            fin_v = np.concatenate([self.memory.final_value, other.memory.final_value])
            idx = np.arange(len(addr), dtype=np.int64)
            uniq, inv = np.unique(addr, return_inverse=True)

            def pick(keys_primary):
                """Per address: index of the entry with the smallest
                (primary, concat-order) key - concat order = self first."""
                order = np.lexsort((idx, keys_primary))
                groups, first_pos = np.unique(inv[order], return_index=True)
                out = np.empty(len(uniq), dtype=np.int64)
                out[groups] = order[first_pos]
                return out

            ini_pick = pick(ini_ts)
            fin_pick = pick(-fin_ts)
            self.memory = MemoryFirstLast(
                addr=uniq.astype(np.uint32),
                initial_ts=ini_ts[ini_pick].astype(np.uint32),
                initial_value=ini_v[ini_pick],
                final_ts=fin_ts[fin_pick].astype(np.uint32),
                final_value=fin_v[fin_pick],
            )
        self.input_stream = self.input_stream + other.input_stream
        self.output_stream = self.output_stream + other.output_stream
        self.global_clk += other.global_clk

    def opcode_counts(self) -> dict:
        from .isa import Opcode

        vals, counts = np.unique(self.cpu.opcode, return_counts=True)
        return {Opcode(int(v)).mnemonic: int(c) for v, c in zip(vals, counts)}
