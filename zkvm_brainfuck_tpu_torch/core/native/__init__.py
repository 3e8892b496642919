"""ctypes loader for the native C++ executor.

The source is this package's copy of the JAX package's executor.cpp; it is
built with g++ at first use into the port's ignored build directory
(`build.build_executor`), never into the package.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None


class _BfRecord(ctypes.Structure):
    _fields_ = (
        [("n_cycles", ctypes.c_uint64)]
        + [
            (name, ctypes.POINTER(ctypes.c_uint32))
            for name in (
                "pc",
                "next_pc",
                "mp",
                "next_mp",
                "mv",
                "next_mv",
                "opcode",
                "op_a",
                "mv_accessed",
                "mv_prev_ts",
                "mv_prev_value",
                "next_mv_accessed",
                "next_mv_prev_ts",
            )
        ]
        + [("n_mem", ctypes.c_uint64)]
        + [
            (name, ctypes.POINTER(ctypes.c_uint32))
            for name in ("m_addr", "m_init_ts", "m_init_val", "m_final_ts", "m_final_val")
        ]
        + [
            ("out_len", ctypes.c_uint64),
            ("output", ctypes.POINTER(ctypes.c_uint8)),
            ("global_clk", ctypes.c_uint64),
            ("status", ctypes.c_int),
            ("impl", ctypes.c_void_p),
        ]
    )


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            from ...build import build_executor

            lib = ctypes.CDLL(build_executor())
            lib.bf_execute.restype = ctypes.POINTER(_BfRecord)
            lib.bf_execute.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64,
                ctypes.c_uint64,
            ]
            lib.bf_free.argtypes = [ctypes.POINTER(_BfRecord)]
            _LIB = lib
    return _LIB


def _copy_u32(ptr, n) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


def execute_native(program, input_stream: bytes, max_cycles: int = 0):
    from ..executor import ExecutionError
    from ..record import CpuColumns, ExecutionRecord, MemoryFirstLast

    lib = _lib()
    opcodes, op_a = program.to_arrays()
    opcodes = np.ascontiguousarray(opcodes)
    op_a = np.ascontiguousarray(op_a)
    inp = np.frombuffer(bytes(input_stream), dtype=np.uint8).copy()

    rec = lib.bf_execute(
        opcodes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        op_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(opcodes),
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(inp),
        max_cycles,
    )
    try:
        r = rec.contents
        if r.status == 1:
            raise ExecutionError("input stream exhausted")
        if r.status == 2:
            raise ExecutionError("cycle limit exceeded")
        n = r.n_cycles
        cpu = CpuColumns(
            pc=_copy_u32(r.pc, n),
            next_pc=_copy_u32(r.next_pc, n),
            mp=_copy_u32(r.mp, n),
            next_mp=_copy_u32(r.next_mp, n),
            mv=_copy_u32(r.mv, n),
            next_mv=_copy_u32(r.next_mv, n),
            opcode=_copy_u32(r.opcode, n),
            op_a=_copy_u32(r.op_a, n),
            mv_accessed=_copy_u32(r.mv_accessed, n),
            mv_prev_ts=_copy_u32(r.mv_prev_ts, n),
            mv_prev_value=_copy_u32(r.mv_prev_value, n),
            next_mv_accessed=_copy_u32(r.next_mv_accessed, n),
            next_mv_prev_ts=_copy_u32(r.next_mv_prev_ts, n),
        )
        mem = MemoryFirstLast(
            addr=_copy_u32(r.m_addr, r.n_mem),
            initial_ts=_copy_u32(r.m_init_ts, r.n_mem),
            initial_value=_copy_u32(r.m_init_val, r.n_mem),
            final_ts=_copy_u32(r.m_final_ts, r.n_mem),
            final_value=_copy_u32(r.m_final_val, r.n_mem),
        )
        out = bytes(np.ctypeslib.as_array(r.output, shape=(r.out_len,))) if r.out_len else b""
        return ExecutionRecord(
            program=program,
            cpu=cpu,
            memory=mem,
            input_stream=bytes(input_stream),
            output_stream=out,
            global_clk=int(r.global_clk),
        )
    finally:
        lib.bf_free(rec)
