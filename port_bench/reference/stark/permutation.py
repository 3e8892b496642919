"""LogUp permutation constraints (reference: crates/stark/src/permutation.rs
199-271), a frozen copy of the port's: per chip with I interactions and
batch size B, the permutation trace has ceil(I/B) + 1 EF4 columns, batched
sums of +/- mult_i / fingerprint_i and an inclusive running sum whose last
entry is the chip's cumulative sum, with
fingerprint_i = alpha + argument_index_i + sum_j beta^{j+1} * value_{i,j}.
"""

from __future__ import annotations

from ..air.chip import Chip
from ..air.lookup import Affine


def _interactions(chip: Chip):
    return [(lk, True) for lk in chip.sends] + [(lk, False) for lk in chip.receives]



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
