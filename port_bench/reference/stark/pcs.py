"""Two-adic FRI PCS verification on the host: a frozen copy of the port's
`pcs_verify` (input-batch Merkle proofs over every round, reduced openings
per height at every query point, then the FRI fold chains), with the
blowup passed in from the configuration instead of read from the prover.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import ef_host as efh
from . import field as xf
from . import merkle as mk
from .challenger import DuplexChallenger
from .domains import Domain
from .errors import InvalidOpeningArgument, OpeningShapeError
from .field import GENERATOR, P
from .fri import FriProof, _pow_base_vec, fri_check_queries_np, fri_verify_transcript


@dataclass
class BatchOpening:
    """Input openings for one round at one query: rows per matrix + path."""

    opened_rows: List[np.ndarray]
    proof: np.ndarray


@dataclass
class PcsProof:
    fri: FriProof
    # query_input_openings[q][round] = BatchOpening
    query_input_openings: List[List[BatchOpening]]



def _ef_powers_host(alpha: tuple, n: int) -> List[tuple]:
    out = [efh.ONE]
    for _ in range(n):
        out.append(efh.mul(out[-1], alpha))
    return out



def pcs_verify(
    rounds: Sequence[Tuple[Sequence[int], List[Tuple[Domain, List[Tuple[tuple, List[tuple]]]]]]],
    proof: PcsProof,
    challenger: DuplexChallenger,
    num_queries: int,
    pow_bits: int,
    log_blowup: int,
):
    """rounds: (root, [(domain, [(point, ys_per_column), ...]), ...]).

    Raises VerificationFailure on any inconsistency.
    """
    # 1. Replay opened-value observations; alpha.
    for _root, mats in rounds:
        for _domain, pts in mats:
            for _z, ys in pts:
                for y in ys:
                    challenger.observe_slice(list(y))
    alpha = challenger.sample_ext()

    # 2. FRI transcript replay.
    log_global = max(
        domain.log_n + log_blowup for _root, mats in rounds for domain, _ in mats
    )
    betas, indices = fri_verify_transcript(
        proof.fri, challenger, log_global, num_queries, pow_bits
    )

    per_h: Dict[int, int] = {}
    for _root, mats in rounds:
        for domain, pts in mats:
            lh = domain.log_n + log_blowup
            for _z, ys in pts:
                per_h[lh] = per_h.get(lh, 0) + len(ys)
    alpha_pows = _ef_powers_host(alpha, max(per_h.values()) if per_h else 1)

    # 3. Per-query checks, vectorized over ALL queries at once.
    if len(proof.query_input_openings) != num_queries or len(
        proof.fri.query_commit_openings
    ) != num_queries:
        raise OpeningShapeError("wrong number of query openings")
    for q in range(num_queries):
        if len(proof.query_input_openings[q]) != len(rounds):
            raise OpeningShapeError("wrong number of round openings")

    idx_arr = np.asarray(indices, dtype=np.int64)
    u64p = np.uint64(P)

    # 3a. Input-batch Merkle proofs: one vectorized walk per round.
    rows_by_round: List[List[np.ndarray]] = []
    for r, (root, mats) in enumerate(rounds):
        log_batch = max(d.log_n for d, _ in mats) + log_blowup
        dims = [(1 << (d.log_n + log_blowup), len(_first_ys(pts))) for d, pts in mats]
        try:
            rows_mats = [
                np.stack(
                    [
                        np.asarray(
                            proof.query_input_openings[q][r].opened_rows[m],
                            dtype=np.uint64,
                        )
                        for q in range(num_queries)
                    ]
                )
                for m in range(len(mats))
            ]
            paths = np.stack(
                [
                    np.asarray(proof.query_input_openings[q][r].proof, dtype=np.uint64)
                    for q in range(num_queries)
                ]
            )
        except (ValueError, IndexError) as err:
            raise OpeningShapeError(f"malformed input openings: {err}") from err
        for (h, w), rm in zip(dims, rows_mats):
            if rm.shape != (num_queries, w):
                raise OpeningShapeError("opened row width mismatch")
        idx_b = idx_arr >> (log_global - log_batch)
        ok = mk.verify_batch_np(root, dims, idx_b, rows_mats, paths)
        if not ok.all():
            raise InvalidOpeningArgument(
                f"query {int(np.argmin(ok))}: bad input Merkle proof"
            )
        rows_by_round.append(rows_mats)

    # 3b. Reduced openings per height at every query point, vectorized.
    ro_val: Dict[int, np.ndarray] = {}
    counters: Dict[tuple, int] = {}
    inv_xz_cache: Dict[tuple, np.ndarray] = {}
    x_cache: Dict[int, np.ndarray] = {}
    alpha_pows_arr = np.asarray(alpha_pows, dtype=np.uint64)  # (A+1, 4)
    for (root, mats), rows in zip(rounds, rows_by_round):
        for (domain, pts), row in zip(mats, rows):
            log_h = domain.log_n + log_blowup
            if log_h not in x_cache:
                # the query points GENERATOR * g_h^rev(i), committed row i
                rev = mk.reverse_bits(idx_arr >> (log_global - log_h), log_h)
                x_cache[log_h] = (
                    _pow_base_vec(xf.two_adic_root(log_h), rev) * np.uint64(GENERATOR) % u64p
                )
            x = x_cache[log_h]  # (Q,)
            ro_val.setdefault(log_h, np.zeros((num_queries, 4), dtype=np.uint64))
            row64 = row % u64p  # (Q, W)
            for z, ys in pts:
                c0 = counters.get((log_h, z), 0)
                if len(ys) == 0:
                    continue
                ck = (log_h, z)
                if ck not in inv_xz_cache:
                    xz = np.broadcast_to(
                        (u64p - np.asarray(z, dtype=np.uint64) % u64p) % u64p,
                        (num_queries, 4),
                    ).copy()
                    xz[:, 0] = (xz[:, 0] + x) % u64p
                    inv_xz_cache[ck] = efh.v_inv(xz)
                inv_xz = inv_xz_cache[ck]
                if len(ys) != row64.shape[1]:
                    raise OpeningShapeError("opened value count mismatch")
                ys_arr = np.asarray(ys, dtype=np.uint64) % u64p  # (W, 4)
                diff = np.broadcast_to(
                    (u64p - ys_arr) % u64p, (num_queries,) + ys_arr.shape
                ).copy()  # (Q, W, 4)
                diff[:, :, 0] = (diff[:, :, 0] + row64) % u64p
                ap = alpha_pows_arr[c0 : c0 + len(ys)]  # (W, 4)
                prod = efh.v_mul(ap[None, :, :], diff)  # (Q, W, 4)
                acc = prod.sum(axis=1, dtype=np.uint64) % u64p  # (Q, 4)
                ro_val[log_h] = (ro_val[log_h] + efh.v_mul(acc, inv_xz)) % u64p
                counters[(log_h, z)] = c0 + len(ys)

    # 3c. FRI fold chains, vectorized.
    fri_check_queries_np(proof.fri, indices, betas, log_global, log_blowup, ro_val)


def _first_ys(pts):
    return pts[0][1] if pts else []
