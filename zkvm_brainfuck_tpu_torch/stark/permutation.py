"""LogUp permutation argument: trace generation + constraints.

Counterpart of the JAX package's stark/permutation.py (reference:
crates/stark/src/permutation.rs).  Per chip with I interactions and batch
size B (= 2^log_quotient_degree), the permutation trace has ceil(I/B) + 1
EF4 columns: batched sums of +/- mult_i / fingerprint_i, plus an inclusive
running-sum column whose last entry is the chip's cumulative sum.

fingerprint_i = alpha + argument_index_i + sum_j beta^{j+1} * value_{i,j}
(the beta^0 slot carries the LookupKind discriminant).

The trace is made by one kernel (ops/logup.py `logup_trace`,
csrc/logup.cu): fingerprints, one batch inversion per row, batch sums, row
sums, and the running sum as a single-pass scan with decoupled look-back.  The constraints are copied from
the JAX package and run over any numeric builder (quotient, verifier).
"""

from __future__ import annotations

import numpy as np

from ..ops import logup as lu
from ..parallel.mesh import RowSharded
from ..parallel.sharded import logup_trace_sharded
from .chip import Chip
from .lookup import Affine


def _interactions(chip: Chip):
    return [(lk, True) for lk in chip.sends] + [(lk, False) for lk in chip.receives]


def logup_table(chip: Chip) -> lu.LogupTable:
    """The chip's interaction table for the LogUp kernels (built once)."""
    table = chip.__dict__.get("_logup_table")
    if table is None:
        table = chip.__dict__["_logup_table"] = lu.LogupTable(
            _interactions(chip), chip.logup_batch_size
        )
    return table


def host_beta_pows(chip: Chip, beta_host) -> np.ndarray:
    """(max_vals+1, 4) canonical beta powers 1, beta, beta^2, ... (host exact)."""
    from . import ef_host as efh

    inter = _interactions(chip)
    max_vals = max(len(lk.values) for lk, _ in inter)
    return efh.powers(beta_host, max_vals + 1).astype(np.uint32)


def generate_permutation_trace(chip: Chip, prep, main, alpha_host, beta_host):
    """LogUp trace of one chip on main's device.

    prep/main: (N, PW) / (N, W) canonical int32 tensors (prep None for chips
    without a preprocessed trace), or both row-sharded over a mesh (the
    kernel on each shard, then the cross-shard offsets); alpha_host,
    beta_host: exact host EF4 tuples.  Returns (perm_trace (N, NB+1, 4)
    int32, row-sharded like main, cumulative_sum (4,) int32 tensor on the
    (first) device)."""
    table = logup_table(chip)
    beta_pows = host_beta_pows(chip, beta_host)
    if isinstance(main, RowSharded):
        return logup_trace_sharded(table, main, prep,
                                   lambda dev: lu.challenge_matrix(alpha_host, beta_pows, dev))
    return lu.logup_trace(table, main, prep, lu.challenge_matrix(alpha_host, beta_pows, main.device))


def eval_permutation_constraints(chip: Chip, b) -> None:
    """Constraints tying the permutation trace to the main trace.

    Mirrors permutation.rs:199-271: per batch,
    entry * prod_i rlc_i == sum_i (+/-m_i) * prod_{j != i} rlc_j,
    and the running-sum column's first/transition/last-row equations.
    Runs over any numeric builder (quotient / verifier / debug).
    """
    inter = _interactions(chip)
    batch = chip.logup_batch_size
    alpha, beta = b.perm_challenges[0], b.perm_challenges[1]

    max_vals = max(len(lk.values) for lk, _ in inter)
    beta_pows = getattr(b, "perm_beta_pows", None)
    if beta_pows is None:
        beta_pows = [b._const(1).as_ext()]
        for _ in range(max_vals):
            beta_pows.append(beta_pows[-1] * beta)

    def affine_value(aff: Affine):
        acc = b._const(aff.const)
        for is_prep, idx, w in aff.terms:
            col = b.get_prep_local(idx) if is_prep else b.get_main_local(idx)
            acc = acc + col * w
        return acc

    perm_local = b.perm_local
    perm_next = b.perm_next
    num_batches = len(perm_local) - 1

    for bi in range(num_batches):
        chunk = inter[bi * batch : (bi + 1) * batch]
        rlcs = []
        ms = []
        for lk, is_send in chunk:
            rlc = alpha + b._const(lk.argument_index).as_ext()
            for j, aff in enumerate(lk.values):
                rlc = rlc + beta_pows[j + 1] * affine_value(aff)
            rlcs.append(rlc)
            m = affine_value(lk.multiplicity)
            ms.append(m if is_send else -m)

        product = rlcs[0]
        for r in rlcs[1:]:
            product = product * r
        numerator = None
        for i, m in enumerate(ms):
            # start from the base-field multiplicity: the first rlc multiply
            # is then ext*base (4 muls) instead of a full EF product (16)
            term = m
            for j, r in enumerate(rlcs):
                if j != i:
                    term = term * r
            term = term.as_ext()
            numerator = term if numerator is None else numerator + term
        b.assert_eq_ext(perm_local[bi] * product, numerator)

    sum_local = perm_local[0]
    sum_next = perm_next[0]
    for i in range(1, num_batches):
        sum_local = sum_local + perm_local[i]
        sum_next = sum_next + perm_next[i]
    phi_local = perm_local[-1]
    phi_next = perm_next[-1]

    b.when_first_row().assert_eq_ext(phi_local, sum_local)
    b.when_transition().assert_eq_ext(phi_next - phi_local, sum_next)
    b.when_last_row().assert_eq_ext(phi_local, b.cumulative_sum)
