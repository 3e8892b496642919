"""Brainfuck interpreter emitting columnar events (host front-end).

Faithful to the reference interpreter (crates/core/executor/src/executor.rs):
- clk += 2 per instruction; memory reads happen at clk+1, ALU writes at clk+2
- ALU: read mv at clk+1, write mv+/-1 (mod 256) at clk+2
- jumps: read mv at clk+1, branch on zero/nonzero to op_a or pc+1
- '>' '<': move mem_ptr only (no memory access)
- ',': write input byte at clk+1; '.': read at clk+1 and append to output
- terminates when pc == len(program)
- per-address first/last access records maintained for the Memory chip

The one engine is the C++ interpreter in `native/`, built with g++ at first
use and loaded via ctypes.  It has no fallback: if it cannot be built or
loaded, `execute` raises.
"""

from __future__ import annotations

from .program import Program
from .record import ExecutionRecord


class ExecutionError(Exception):
    pass


def execute(program: Program, input_stream: bytes) -> ExecutionRecord:
    """Run the guest program on the native engine."""
    from .native import execute_native

    return execute_native(program, input_stream)
