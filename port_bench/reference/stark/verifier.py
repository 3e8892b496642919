"""Shard verifier: full host-side transcript replay + OOD constraint check.

A frozen copy of the port's host verifier (exact Python ints and numpy),
with the configuration's guarantees (queries, proof-of-work bits, blowup)
passed in by the caller rather than read from the proof or the prover.

Reference: crates/stark/src/verifier.rs:27-216.  Order: observe main commit ->
sample 2 permutation challenges -> observe permutation commit + cumulative
sums -> sample alpha -> observe quotient commit -> sample zeta -> PCS verify
over the 4 rounds -> per-chip `folded_constraints * inv_zeroifier ==
recomposed quotient(zeta)` -> sum of cumulative sums must vanish.
Returns zeta, at which the caller may hold the opened values to traces of
its own.
"""

from __future__ import annotations

from typing import List

from ..air.builder import HostEFBackend, NumericBuilder, V
from ..air.chip import Chip
from . import ef_host as efh
from .challenger import DuplexChallenger
from .domains import Domain
from .errors import (
    CumulativeSumsError,
    OodEvaluationMismatch,
    OpeningShapeError,
)
from .field import P
from .pcs import pcs_verify
from .permutation import eval_permutation_constraints
from .types import ChipOpenedValues, ShardProof, StarkVerifyingKey


def verify_shard(
    config,
    vk: StarkVerifyingKey,
    chips: List[Chip],
    challenger: DuplexChallenger,
    proof: ShardProof,
):
    if len(chips) != len(proof.opened_values):
        raise OpeningShapeError("chip opening length mismatch")

    # Byte-lookup multiplicity overflow guard (verifier.rs:48-61).
    total = 0
    for chip, vals in zip(chips, proof.opened_values):
        total += chip.num_sent_byte_lookups() << vals.log_degree
    if total > P:
        raise CumulativeSumsError("byte multiplicities overflow")

    log_degrees = [v.log_degree for v in proof.opened_values]
    trace_domains = [Domain(ld, 1) for ld in log_degrees]

    challenger.observe_commitment(proof.commitment.main_commit)
    perm_challenges = [challenger.sample_ext() for _ in range(2)]
    challenger.observe_commitment(proof.commitment.permutation_commit)
    for chip, vals in zip(chips, proof.opened_values):
        challenger.observe_slice(list(vals.cumulative_sum))
        if chip.num_interactions == 0 and vals.cumulative_sum != efh.ZERO:
            raise CumulativeSumsError("nonzero cumulative sum without lookups")
    alpha = challenger.sample_ext()
    challenger.observe_commitment(proof.commitment.quotient_commit)
    zeta = challenger.sample_ext()

    # -- shape checks ------------------------------------------------------
    for chip, vals in zip(chips, proof.opened_values):
        if len(vals.main.local) != chip.width or len(vals.main.next) != chip.width:
            raise OpeningShapeError(f"{chip.name}: main width mismatch")
        if len(vals.preprocessed.local) != chip.preprocessed_width:
            raise OpeningShapeError(f"{chip.name}: preprocessed width mismatch")
        if len(vals.permutation.local) != chip.permutation_width * 4:
            raise OpeningShapeError(f"{chip.name}: permutation width mismatch")
        if len(vals.quotient) != chip.quotient_width:
            raise OpeningShapeError(f"{chip.name}: quotient chunk count mismatch")
        for ch in vals.quotient:
            if len(ch) != 4:
                raise OpeningShapeError(f"{chip.name}: quotient chunk width mismatch")

    # -- PCS rounds --------------------------------------------------------
    prep_mats = []
    for (name, domain, dims) in vk.chip_information:
        # locate this chip's opened values via proof ordering
        i = proof.chip_ordering.get(name)
        if i is None:
            raise OpeningShapeError(f"preprocessed chip {name} missing from proof")
        vals = proof.opened_values[i]
        chip = chips[i]
        if not chip.local_only:
            pts = [
                (zeta, vals.preprocessed.local),
                (domain.next_point_ef(zeta), vals.preprocessed.next),
            ]
        else:
            pts = [(zeta, vals.preprocessed.local)]
        prep_mats.append((domain, pts))

    main_mats = []
    for chip, td, vals in zip(chips, trace_domains, proof.opened_values):
        if not chip.local_only:
            pts = [(zeta, vals.main.local), (td.next_point_ef(zeta), vals.main.next)]
        else:
            pts = [(zeta, vals.main.local)]
        main_mats.append((td, pts))

    perm_mats = [
        (td, [(zeta, vals.permutation.local), (td.next_point_ef(zeta), vals.permutation.next)])
        for td, vals in zip(trace_domains, proof.opened_values)
    ]

    quotient_mats = []
    qc_domains_per_chip = []
    for chip, td, ld, vals in zip(chips, trace_domains, log_degrees, proof.opened_values):
        qdomain = td.create_disjoint_domain(1 << (ld + chip.log_quotient_degree))
        qc_domains = qdomain.split_domains(chip.quotient_width)
        qc_domains_per_chip.append(qc_domains)
        for d, ch in zip(qc_domains, vals.quotient):
            quotient_mats.append((d, [(zeta, ch)]))

    pcs_verify(
        [
            (vk.commit, prep_mats),
            (proof.commitment.main_commit, main_mats),
            (proof.commitment.permutation_commit, perm_mats),
            (proof.commitment.quotient_commit, quotient_mats),
        ],
        proof.opening_proof,
        challenger,
        num_queries=config.fri.num_queries,
        pow_bits=config.fri.proof_of_work_bits,
        log_blowup=config.fri.log_blowup,
    )

    # -- per-chip OOD constraint check ------------------------------------
    for chip, td, qc_domains, vals in zip(
        chips, trace_domains, qc_domains_per_chip, proof.opened_values
    ):
        verify_constraints(chip, vals, td, qc_domains, zeta, alpha, perm_challenges)

    # -- global cumulative sum --------------------------------------------
    if proof.cumulative_sum() != efh.ZERO:
        raise CumulativeSumsError("global cumulative sum is not zero")
    return zeta


def verify_constraints(
    chip: Chip,
    opening: ChipOpenedValues,
    trace_domain: Domain,
    qc_domains: List[Domain],
    zeta: tuple,
    alpha: tuple,
    perm_challenges,
):
    sels = trace_domain.selectors_at_point_ef(zeta)
    folded = eval_constraints_at_point(chip, opening, sels, alpha, perm_challenges)
    quotient = recompute_quotient(opening, qc_domains, zeta)
    if efh.mul(folded, sels["inv_zeroifier"]) != quotient:
        raise OodEvaluationMismatch(f"{chip.name}: OOD evaluation mismatch")


def eval_constraints_at_point(
    chip: Chip, opening: ChipOpenedValues, sels, alpha: tuple, perm_challenges
) -> tuple:
    be = HostEFBackend
    acc = [efh.ZERO]

    def on_constraint(v: V):
        acc[0] = efh.add(efh.mul(acc[0], alpha), v.p)

    # Reconstruct EF columns from the flattened permutation opening.
    def unflatten_ef(flat):
        out = []
        for i in range(len(flat) // 4):
            acc_ef = efh.ZERO
            for k in range(4):
                acc_ef = efh.add(acc_ef, efh.mul(efh.monomial(k), flat[4 * i + k]))
            out.append(acc_ef)
        return out

    perm_local = unflatten_ef(opening.permutation.local)
    perm_next = unflatten_ef(opening.permutation.next)

    b = NumericBuilder(
        backend=be,
        main_local=lambda i: V(be, opening.main.local[i], True),
        main_next=lambda i: V(be, opening.main.next[i], True),
        prep_local=(lambda i: V(be, opening.preprocessed.local[i], True))
        if opening.preprocessed.local
        else None,
        prep_next=(lambda i: V(be, opening.preprocessed.next[i], True))
        if opening.preprocessed.local
        else None,
        is_first_row=V(be, sels["is_first_row"], True),
        is_last_row=V(be, sels["is_last_row"], True),
        is_transition=V(be, sels["is_transition"], True),
        on_constraint=on_constraint,
        perm_local=[V(be, x, True) for x in perm_local],
        perm_next=[V(be, x, True) for x in perm_next],
        perm_challenges=[V(be, c, True) for c in perm_challenges],
        cumulative_sum=V(be, opening.cumulative_sum, True),
    )
    chip.eval(b)
    eval_permutation_constraints(chip, b)
    return acc[0]


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
