"""Ties a proof to its own job.

A proof carries no public values, so its verification alone cannot tell
it from a valid proof of another job of the same guest.  The IO and
Memory chips' main traces follow from the job alone: IO holds every ','
and '.' (pc, pointer, value, which), Memory every touched address with
its last timestamp and final value.  This module builds both from the
reference interpreter's run, evaluates them at the proof's out-of-domain
point zeta (and at zeta times the trace domain's generator, where the
chip opens its next row), and compares them with the values the proof
opens there, which its verification has bound to its main commitment.
A proof of other stdin, or a stale one, differs there.

Row layouts (upstream io/mod.rs, memory/memory.rs; frozen in air/): IO
rows in execution order, zero rows after; Memory entries by address, two
a row, zero entries after.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import interp
from .air.base import next_power_of_two
from .stark import ef_host as efh
from .stark.field import P, powers_host, two_adic_root

_P = np.uint64(P)
MEMORY_ENTRIES_PER_ROW = 2


def io_trace(run: interp.Run) -> np.ndarray:
    """(rows, 5): pc, mp, mv, is_input, is_output."""
    ev = run.io_events
    rows = next_power_of_two(len(ev))
    t = np.zeros((rows, 5), dtype=np.uint64)
    t[: len(ev), 0:3] = ev[:, 0:3]
    t[: len(ev), 3] = ev[:, 3] == 6
    t[: len(ev), 4] = ev[:, 3] == 7
    return t


def memory_trace(run: interp.Run) -> np.ndarray:
    """(rows, 12): per entry addr, initial_clk, final_clk, initial_value,
    final_value, is_real; a fresh cell starts at 0 with 0."""
    m = run.memory
    rows = next_power_of_two(-(-len(m) // MEMORY_ENTRIES_PER_ROW))
    e = np.zeros((rows * MEMORY_ENTRIES_PER_ROW, 6), dtype=np.uint64)
    e[: len(m), 0] = m[:, 0]
    e[: len(m), 2] = m[:, 1]
    e[: len(m), 4] = m[:, 2]
    e[: len(m), 5] = 1
    return e.reshape(rows, MEMORY_ENTRIES_PER_ROW * 6)


def evaluate(trace: np.ndarray, zeta: tuple, nxt: bool) -> List[List[tuple]]:
    """Each column of `trace` (the values on the subgroup of its height,
    row i at g^i) at zeta and, with `nxt`, at g * zeta; by the barycentric
    form, L_i(z) = g^i (z^n - 1) / (n (z - g^i))."""
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    pts = powers_host(two_adic_root(log_n), n).astype(np.uint64)
    z = np.array(zeta, dtype=np.uint64)
    diff = np.broadcast_to(z, (n, 4)).copy()
    diff[:, 0] = (diff[:, 0] + _P - pts) % _P
    w = efh.v_mul_base(efh.v_inv(diff), pts)
    scale = efh.mul_base(efh.add_base(efh.epow(zeta, n), P - 1), pow(n, P - 2, P))
    out = []
    for rows in ([trace, np.roll(trace, -1, axis=0)] if nxt else [trace]):
        vals = []
        for c in range(rows.shape[1]):
            s = (rows[:, c, None] % _P * w % _P).sum(axis=0) % _P
            vals.append(efh.mul(scale, tuple(int(x) for x in s)))
        out.append(vals)
    return out


def mismatch(run: interp.Run, opened: Dict[str, object], zeta: tuple) -> Optional[str]:
    """None if the proof's IO and Memory openings are the job's, else why
    not.  `opened`: chip name -> its ChipOpenedValues."""
    for name, trace, nxt in (("IO", io_trace(run) if len(run.io_events) else None, False),
                             ("Memory", memory_trace(run) if len(run.memory) else None, True)):
        if trace is None:
            continue
        vals = opened.get(name)
        if vals is None:
            return f"no {name} chip"
        if vals.log_degree != trace.shape[0].bit_length() - 1:
            return f"{name}: height 2^{vals.log_degree}, the job's is {trace.shape[0]} rows"
        want = evaluate(trace, zeta, nxt)
        if [tuple(v) for v in vals.main.local] != want[0]:
            return f"{name}: the opened row at zeta is not the job's"
        if nxt and [tuple(v) for v in vals.main.next] != want[1]:
            return f"{name}: the opened next row is not the job's"
    return None
