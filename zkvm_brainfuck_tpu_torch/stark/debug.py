"""Debug checkers: row-wise constraint replay + lookup balance diffing.

A copy of the JAX package's stark/debug.py (host numpy; only the package it
imports from differs).  Counterparts of crates/stark/src/debug.rs
(DebugConstraintBuilder) and crates/stark/src/lookup/debug.rs
(debug_interactions_with_all_chips), but vectorized: constraints are
evaluated over every row at once with the exact numpy backend, and
interaction multisets are accumulated with numpy instead of per-row
HashMaps.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.field import P
from .builder import NumericBuilder, NumpyBackend, V
from .chip import Chip
from .lookup import Lookup


def check_constraints(
    chip: Chip,
    main: np.ndarray,
    prep: Optional[np.ndarray] = None,
    perm: Optional[np.ndarray] = None,
    perm_challenges=None,
    cumulative_sum=None,
) -> List[str]:
    """Evaluate all constraints on every row; returns failure descriptions.

    main/prep: (N, W) canonical uint arrays. perm: (N, PW, 4) EF rows.
    """
    n = main.shape[0]
    main64 = main.astype(np.uint64)
    mnext = np.roll(main64, -1, axis=0)
    if prep is not None and prep.shape[1] > 0:
        prep64 = prep.astype(np.uint64)
        pnext = np.roll(prep64, -1, axis=0)
    else:
        prep64 = pnext = None

    first = np.zeros(n, np.uint64)
    first[0] = 1
    last = np.zeros(n, np.uint64)
    last[-1] = 1
    trans = np.ones(n, np.uint64)
    trans[-1] = 0

    failures: List[str] = []
    counter = [0]

    def on_constraint(v: V):
        idx = counter[0]
        counter[0] += 1
        vals = v.p
        if isinstance(vals, tuple):
            vals = np.stack([np.broadcast_to(x, (n,)) for x in vals], axis=-1)
        else:
            vals = np.broadcast_to(vals, (n,))
        bad = np.nonzero(vals.reshape(n, -1).any(axis=1))[0]
        if len(bad) > 0:
            failures.append(
                f"{chip.name}: constraint #{idx} nonzero at rows {bad[:5].tolist()}"
            )

    be = NumpyBackend

    def getter(mat, nxt):
        def get(i):
            src = nxt if mat is None else mat
            return V(be, src[:, i], False)

        return get

    b = NumericBuilder(
        backend=be,
        main_local=lambda i: V(be, main64[:, i]),
        main_next=lambda i: V(be, mnext[:, i]),
        prep_local=(lambda i: V(be, prep64[:, i])) if prep64 is not None else None,
        prep_next=(lambda i: V(be, pnext[:, i])) if pnext is not None else None,
        is_first_row=V(be, first),
        is_last_row=V(be, last),
        is_transition=V(be, trans),
        on_constraint=on_constraint,
    )
    if perm is not None:
        perm64 = perm.astype(np.uint64)  # (N, PW, 4)
        pn = np.roll(perm64, -1, axis=0)
        b.perm_local = [
            V(be, tuple(perm64[:, i, k] for k in range(4)), True)
            for i in range(perm.shape[1])
        ]
        b.perm_next = [
            V(be, tuple(pn[:, i, k] for k in range(4)), True)
            for i in range(perm.shape[1])
        ]
        b.perm_challenges = [
            V(be, tuple(np.uint64(x) for x in c), True) for c in perm_challenges
        ]
        b.cumulative_sum = V(be, tuple(np.uint64(x) for x in cumulative_sum), True)
    chip.eval(b)
    if perm is not None:
        from .permutation import eval_permutation_constraints

        eval_permutation_constraints(chip, b)
    return failures


def _affine_values(aff, prep: Optional[np.ndarray], main: np.ndarray) -> np.ndarray:
    n = main.shape[0]
    acc = np.full(n, aff.const % P, np.uint64)
    for is_prep, idx, w in aff.terms:
        src = prep if is_prep else main
        acc = (acc + np.uint64(w) * src[:, idx].astype(np.uint64)) % np.uint64(P)
    return acc


def debug_lookup_balance(
    chips_traces: List[Tuple[Chip, Optional[np.ndarray], np.ndarray]],
    kinds=None,
) -> Dict[tuple, int]:
    """Net multiplicity per lookup key across all chips; {} iff balanced.

    chips_traces: (chip, prep, main) with canonical uint32 matrices.
    Returns {(kind, values...): net} for unbalanced keys (signed, mod-P aware).
    """
    net: Dict[tuple, int] = defaultdict(int)
    for chip, prep, main in chips_traces:
        for lookups, sign in ((chip.sends, 1), (chip.receives, -1)):
            for lk in lookups:
                if kinds is not None and lk.kind not in kinds:
                    continue
                mult = _affine_values(lk.multiplicity, prep, main).astype(np.int64)
                vals = np.stack(
                    [_affine_values(v, prep, main) for v in lk.values], axis=1
                )
                nz = np.nonzero(mult)[0]
                for i in nz:
                    key = (int(lk.kind),) + tuple(int(x) for x in vals[i])
                    m = int(mult[i])
                    if m > P // 2:
                        m -= P  # negative multiplicities wrap
                    net[key] += sign * m
    return {k: v for k, v in net.items() if v != 0}
