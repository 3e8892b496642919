"""FRI verification on the host: the transcript replay and the vectorized
query walk.  A frozen copy of the port's verifier side (p3 TwoAdicFriPcs:
two-adic, arity-2 folds, commit-per-layer, final constant, PoW witness);
the fold is f'(x^2) = (f(x)+f(-x))/2 + beta * (f(x)-f(-x))/(2x), and
reduced-opening inputs at smaller heights join right after the fold that
reaches their height.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from . import ef_host as efh
from . import field as xf
from . import merkle as mk
from .challenger import DuplexChallenger
from .errors import InvalidOpeningArgument, InvalidPowWitness, OpeningShapeError
from .field import P


@dataclass
class FriProof:
    commit_phase_commits: List[np.ndarray]  # (8,) roots
    final_poly: Tuple[int, int, int, int]
    pow_witness: int
    # per query: list over layers of (pair_row(8 ints), path (L,8))
    query_commit_openings: List[List[Tuple[np.ndarray, np.ndarray]]]



def fri_verify_transcript(
    proof: FriProof,
    challenger: DuplexChallenger,
    log_max: int,
    num_queries: int,
    pow_bits: int,
):
    """Replay the FRI transcript; returns (betas, query_indices) or raises."""
    betas = []
    for root in proof.commit_phase_commits:
        challenger.observe_commitment([int(x) for x in root])
        betas.append(challenger.sample_ext())
    for c in proof.final_poly:
        challenger.observe(int(c))
    if not challenger.check_witness(pow_bits, proof.pow_witness):
        raise InvalidPowWitness("FRI proof-of-work check failed")
    indices = [challenger.sample_bits(log_max) for _ in range(num_queries)]
    return betas, indices


# ---------------------------------------------------------------------------
# Vectorized (numpy) query verification - all queries in one pass.
# ---------------------------------------------------------------------------

_U64P = np.uint64(P)


def _pow_base_vec(g: int, k: np.ndarray) -> np.ndarray:
    """Vectorized g^k mod P for (Q,) exponent arrays (square-and-multiply)."""
    r = np.ones(len(k), dtype=np.uint64)
    b = np.uint64(g % P)
    kk = np.asarray(k, dtype=np.int64).copy()
    while (kk > 0).any():
        r = np.where(kk & 1 == 1, r * b % _U64P, r)
        b = b * b % _U64P
        kk >>= 1
    return r


def fri_check_queries_np(
    proof: FriProof,
    indices,
    betas,
    log_max: int,
    log_blowup: int,
    ro_by_height,  # dict: log_h -> (Q, 4) uint64 reduced-opening values
):
    """Walk ALL queries' fold chains in one vectorized pass."""
    q_n = len(indices)
    idx = np.asarray(indices, dtype=np.int64).copy()
    half = pow(2, P - 2, P)
    e = np.asarray(ro_by_height[log_max], dtype=np.uint64) % _U64P
    log_h = log_max
    betas_arr = np.asarray(betas, dtype=np.uint64)  # (L, 4)
    for l, root in enumerate(proof.commit_phase_commits):
        try:
            pairs = np.stack(
                [
                    np.asarray(proof.query_commit_openings[q][l][0], dtype=np.uint64)
                    for q in range(q_n)
                ]
            )
            paths = np.stack(
                [
                    np.asarray(proof.query_commit_openings[q][l][1], dtype=np.uint64)
                    for q in range(q_n)
                ]
            )
        except (ValueError, IndexError) as err:
            raise OpeningShapeError(f"malformed FRI query openings: {err}") from err
        if pairs.shape != (q_n, 8) or paths.shape[0] != q_n:
            raise OpeningShapeError("malformed FRI query opening shapes")
        ok = mk.verify_batch_np(root, [(1 << (log_h - 1), 8)], idx >> 1, [pairs], paths)
        if not ok.all():
            raise InvalidOpeningArgument(
                f"FRI query {int(np.argmin(ok))}: bad Merkle path at layer {l}"
            )
        e0 = pairs[:, :4]
        e1 = pairs[:, 4:]
        odd = (idx & 1).astype(bool)
        mine = np.where(odd[:, None], e1, e0)
        okv = (mine == e).all(axis=1)
        if not okv.all():
            raise InvalidOpeningArgument(
                f"FRI query {int(np.argmin(okv))}: folded value mismatch at layer {l}"
            )
        # x~ = g_h^{rev_h(idx & ~1)}
        xt = _pow_base_vec(xf.two_adic_root(log_h), mk.reverse_bits(idx & ~1, log_h))
        s = efh.v_mul_base(efh.v_add(e0, e1), np.uint64(half))
        d = efh.v_mul_base(
            efh.v_mul_base(efh.v_sub(e0, e1), np.uint64(half)),
            efh.v_base_inv(xt),
        )
        e = efh.v_add(s, efh.v_mul(betas_arr[l][None, :], d))
        idx >>= 1
        log_h -= 1
        ro = ro_by_height.get(log_h)
        if ro is not None:
            e = efh.v_add(e, np.asarray(ro, dtype=np.uint64))
    final = np.asarray(proof.final_poly, dtype=np.uint64)
    okf = (e == final[None, :]).all(axis=1)
    if not okf.all():
        raise InvalidOpeningArgument(
            f"FRI query {int(np.argmin(okf))}: final value != final_poly"
        )
