"""Host-side verifier pieces (the JAX package's stark/verifier.py).

Only the quotient recombination is needed by the uni-STARK verifier; the
machine verifier comes with the multi-table prover.
"""

from __future__ import annotations

from typing import List

from . import ef_host as efh
from .domains import Domain
from .types import ChipOpenedValues


def recompute_quotient(
    opening: ChipOpenedValues, qc_domains: List[Domain], zeta: tuple
) -> tuple:
    """Lagrange-style recombination of the chunk openings (verifier.rs:294-329)."""
    zps = []
    for i, domain in enumerate(qc_domains):
        acc = efh.ONE
        for j, other in enumerate(qc_domains):
            if j == i:
                continue
            num = other.zp_at_point_ef(zeta)
            den = other.zp_at_point_ef(efh.from_base(domain.first_point()))
            acc = efh.mul(acc, efh.mul(num, efh.inv(den)))
        zps.append(acc)

    total = efh.ZERO
    for ch_i, ch in enumerate(opening.quotient):
        for e_i, c in enumerate(ch):
            total = efh.add(total, efh.mul(zps[ch_i], efh.mul(efh.monomial(e_i), c)))
    return total
