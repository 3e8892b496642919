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

import torch

from ..device import elapsed, resolve_device
from ..ops import ext as xe
from ..ops import field as xf
from ..ops.field import I32, I64
from . import ef_host as efh
from .builder import HostEFBackend, NumericBuilder, TorchBackend, V
from .challenger import DuplexChallenger
from .chip import Chip
from .domains import Domain, selectors_on_coset
from .errors import VerificationFailure
from .pcs import PcsProof, pcs_commit, pcs_open, pcs_verify
from .quotient import _fsum_axis0
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
    qvals = _uni_quotient(chip, tdomain, qdomain, data.ldes[0], alpha)
    chunks = [qvals[k :: 1 << log_qd].contiguous() for k in range(1 << log_qd)]
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


def _uni_quotient(chip: Chip, tdomain, qdomain, main_lde: torch.Tensor, alpha_host):
    """Quotient values on the qdomain coset: (nq, 4) canonical int32.

    Every constraint is evaluated over whole coset columns with the
    TorchBackend; constraint j of K gets weight alpha^(K-1-j) (the
    alpha-Horner fold written as a sum), and the sum is divided by the
    zeroifier."""
    device = main_lde.device
    nq = qdomain.size
    next_step = 1 << (qdomain.log_n - tdomain.log_n)
    sels = selectors_on_coset(tdomain.log_n, qdomain.log_n, qdomain.shift, device)
    cols = main_lde.t().contiguous()  # (W, nq): one contiguous row per column
    nxt = torch.roll(cols, -next_step, dims=1)
    be = TorchBackend
    collected = []
    b = NumericBuilder(
        backend=be,
        main_local=lambda i: V(be, cols[i]),
        main_next=lambda i: V(be, nxt[i]),
        prep_local=None,
        prep_next=None,
        is_first_row=V(be, sels["is_first_row"]),
        is_last_row=V(be, sels["is_last_row"]),
        is_transition=V(be, sels["is_transition"]),
        on_constraint=lambda v: collected.append((v.p, v.ext)),
    )
    chip.eval(b)
    k_total = len(collected)
    pows = [efh.ONE]
    for _ in range(k_total - 1):
        pows.append(efh.mul(pows[-1], alpha_host))
    weights = [pows[k_total - 1 - j] for j in range(k_total)]

    def full(x):
        if isinstance(x, torch.Tensor):
            return x.to(I32).expand(nq)
        return torch.full((nq,), int(x), dtype=I32, device=device)

    acc = xe.ezeros((nq,), device=device)
    base = [(full(p), w) for (p, ext), w in zip(collected, weights) if not ext]
    if base:
        bstack = torch.stack([p for p, _w in base])  # (K_b, nq)
        bw = torch.tensor([w for _p, w in base], dtype=I64, device=device)  # (K_b, 4)
        acc = xe.eadd(
            acc, tuple(_fsum_axis0(xf.fmul(bstack, bw[:, t][:, None])) for t in range(4))
        )
    ext = [(p, w) for (p, e), w in zip(collected, weights) if e]
    if ext:
        estack = tuple(torch.stack([full(p[t]) for p, _w in ext]) for t in range(4))
        ew = torch.tensor([w for _p, w in ext], dtype=I64, device=device)
        prod = xe.emul(estack, tuple(ew[:, t][:, None] for t in range(4)))
        acc = xe.eadd(acc, tuple(_fsum_axis0(pl) for pl in prod))
    return xe.to_array(xe.emul_base(acc, sels["inv_zeroifier"]))


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
