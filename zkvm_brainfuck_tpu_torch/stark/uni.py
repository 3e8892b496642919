"""Single-chip "uni-stark" prove/verify (no lookup argument).

Counterpart of the JAX package's stark/uni.py and of the reference's
p3_uni_stark test path (utils/prove.rs:99-159): prove one AIR's constraints
over one main trace - lookups become no-ops (EmptyMessageBuilder
semantics) - then verify the OOD quotient identity and the FRI opening.

The prover runs on the card unless the caller passes device="cpu"; the
verifier is host code (numpy and exact Python ints), as in the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

from ..device import elapsed, resolve_device
from ..ops import field as xf
from . import ef_host as efh
from .builder import HostEFBackend, NumericBuilder, V
from .challenger import DuplexChallenger
from .chip import Chip
from .domains import Domain
from .errors import VerificationFailure
from .pcs import PcsProof, pcs_commit, pcs_open, pcs_verify
from .quotient import quotient_values, split_quotient_chunks
from .types import AirOpenedValues, ChipOpenedValues
from .verifier import recompute_quotient

POW_BITS = 8


@dataclass
class UniProof:
    main_commit: List[int]
    quotient_commit: List[int]
    main_local: list
    main_next: list
    quotient: list  # 2^log_qd chunks x 4 EF values
    log_degree: int
    pcs_proof: PcsProof


def _air_constraints_degree(chip: Chip) -> int:
    return max(chip.max_constraint_degree, 2)


def _log_quotient_degree(chip: Chip) -> int:
    return max((_air_constraints_degree(chip) - 1 - 1).bit_length(), 1)


def uni_stark_prove(
    chip: Chip,
    trace,
    challenger: DuplexChallenger,
    num_queries: int = 12,
    device=None,
    timings: Dict[str, float] = None,
) -> UniProof:
    """Prove `chip`'s AIR over `trace` ((2^k, width) canonical values, numpy
    or torch).  `timings`, when given, receives the seconds of each phase."""
    device = resolve_device(device)
    timings = {} if timings is None else timings
    trace = xf.as_field_tensor(trace, device)
    n = trace.shape[0]
    log_n = n.bit_length() - 1
    if trace.dim() != 2 or n != 1 << log_n or trace.shape[1] != chip.width:
        raise ValueError(f"trace must be (2^k, {chip.width}), got {tuple(trace.shape)}")
    tdomain = Domain(log_n, 1)
    log_qd = _log_quotient_degree(chip)

    t0 = time.time()
    root, data = pcs_commit([(tdomain, trace)], device=device)
    timings["main_commit"] = elapsed(t0, device)
    challenger.observe_commitment([int(x) for x in root])
    alpha = challenger.sample_ext()

    t0 = time.time()
    qdomain = tdomain.create_disjoint_domain(1 << (log_n + log_qd))
    qvals = quotient_values(chip, tdomain, qdomain, None, data.lde_blocks(0), None, None, alpha,
                            None)
    chunks = split_quotient_chunks(qdomain, qvals, 1 << log_qd)
    timings["quotient"] = elapsed(t0, device)

    t0 = time.time()
    sub_domains = qdomain.split_domains(1 << log_qd)
    qroot, qdata = pcs_commit(list(zip(sub_domains, chunks)), device=device)
    timings["quotient_commit"] = elapsed(t0, device)
    challenger.observe_commitment([int(x) for x in qroot])
    zeta = challenger.sample_ext()

    t0 = time.time()
    opened, pcs_proof = pcs_open(
        [
            (data, [[zeta, tdomain.next_point_ef(zeta)]]),
            (qdata, [[zeta]] * len(chunks)),
        ],
        challenger,
        num_queries=num_queries,
        pow_bits=POW_BITS,
        timings=timings,
    )
    timings["pcs_open"] = elapsed(t0, device)
    return UniProof(
        main_commit=[int(x) for x in root],
        quotient_commit=[int(x) for x in qroot],
        main_local=opened[0][0][0],
        main_next=opened[0][0][1],
        quotient=[opened[1][k][0] for k in range(len(chunks))],
        log_degree=log_n,
        pcs_proof=pcs_proof,
    )


def uni_stark_verify(
    chip: Chip, proof: UniProof, challenger: DuplexChallenger, num_queries: int = 12
):
    """Host verifier; raises VerificationFailure (or a subclass)."""
    challenger.observe_commitment(proof.main_commit)
    alpha = challenger.sample_ext()
    challenger.observe_commitment(proof.quotient_commit)
    zeta = challenger.sample_ext()

    log_qd = _log_quotient_degree(chip)
    tdomain = Domain(proof.log_degree, 1)
    qdomain = tdomain.create_disjoint_domain(1 << (proof.log_degree + log_qd))
    qc_domains = qdomain.split_domains(1 << log_qd)

    pcs_verify(
        [
            (
                proof.main_commit,
                [
                    (
                        tdomain,
                        [
                            (zeta, proof.main_local),
                            (tdomain.next_point_ef(zeta), proof.main_next),
                        ],
                    )
                ],
            ),
            (
                proof.quotient_commit,
                [(d, [(zeta, ch)]) for d, ch in zip(qc_domains, proof.quotient)],
            ),
        ],
        proof.pcs_proof,
        challenger,
        num_queries=num_queries,
        pow_bits=POW_BITS,
    )

    # OOD constraint check (AIR only, alpha-Horner).
    sels = tdomain.selectors_at_point_ef(zeta)
    be = HostEFBackend
    acc = [efh.ZERO]
    b = NumericBuilder(
        backend=be,
        main_local=lambda i: V(be, proof.main_local[i], True),
        main_next=lambda i: V(be, proof.main_next[i], True),
        prep_local=None,
        prep_next=None,
        is_first_row=V(be, sels["is_first_row"], True),
        is_last_row=V(be, sels["is_last_row"], True),
        is_transition=V(be, sels["is_transition"], True),
        on_constraint=lambda v: acc.__setitem__(0, efh.add(efh.mul(acc[0], alpha), v.p)),
    )
    chip.eval(b)
    folded = acc[0]

    opening = ChipOpenedValues(
        preprocessed=AirOpenedValues([], []),
        main=AirOpenedValues(proof.main_local, proof.main_next),
        permutation=AirOpenedValues([], []),
        quotient=proof.quotient,
        cumulative_sum=efh.ZERO,
        log_degree=proof.log_degree,
    )
    quotient = recompute_quotient(opening, qc_domains, zeta)
    if efh.mul(folded, sels["inv_zeroifier"]) != quotient:
        raise VerificationFailure(f"{chip.name}: uni-stark OOD mismatch")
