"""Conversions between the JAX package's objects and the port's, and a
stable JSON encoding of the port's `UniProof`.

The JAX package is never imported here: its objects are read through their
attributes as ints and numpy arrays, and objects of its classes are built
from constructors the caller passes in.  The tests use this module to feed
both packages the same inputs and to verify each package's proofs with the
other's verifier.
"""

from __future__ import annotations

import json
from typing import Callable

import numpy as np
import torch

from .ops.field import as_field_tensor, np_from_monty
from .stark.challenger import DuplexChallenger
from .stark.fri import FriProof
from .stark.pcs import BatchOpening, PcsProof
from .stark.uni import UniProof


# ---------------------------------------------------------------------------
# Matrices and the challenger
# ---------------------------------------------------------------------------


def matrix_from_jax(arr, montgomery: bool = False, device="cpu") -> torch.Tensor:
    """A JAX (or numpy) uint32 matrix -> canonical int32 tensor on `device`.
    `montgomery`: the values are in the JAX device form x * 2^32 mod p."""
    a = np.asarray(arr).astype(np.uint32)
    if montgomery:
        a = np_from_monty(a)
    return as_field_tensor(a, device)


def matrix_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Canonical int32 tensor -> numpy uint32 (the JAX package's host form)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def challenger_from_jax(c) -> DuplexChallenger:
    out = DuplexChallenger()
    out.state = [int(x) for x in c.state]
    out.input_buffer = [int(x) for x in c.input_buffer]
    out.output_buffer = [int(x) for x in c.output_buffer]
    return out


def challenger_to_jax(c: DuplexChallenger, cls: Callable):
    out = cls()
    out.state = list(c.state)
    out.input_buffer = list(c.input_buffer)
    out.output_buffer = list(c.output_buffer)
    return out


# ---------------------------------------------------------------------------
# Proofs
# ---------------------------------------------------------------------------


def _u32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64).astype(np.uint32)


def _ef_list(vals):
    return [tuple(int(x) for x in v) for v in vals]


def _convert_uni(p, UniProof_, PcsProof_, BatchOpening_, FriProof_):
    fri = p.pcs_proof.fri
    return UniProof_(
        main_commit=[int(x) for x in p.main_commit],
        quotient_commit=[int(x) for x in p.quotient_commit],
        main_local=_ef_list(p.main_local),
        main_next=_ef_list(p.main_next),
        quotient=[_ef_list(ch) for ch in p.quotient],
        log_degree=int(p.log_degree),
        pcs_proof=PcsProof_(
            fri=FriProof_(
                commit_phase_commits=[_u32(r) for r in fri.commit_phase_commits],
                final_poly=tuple(int(x) for x in fri.final_poly),
                pow_witness=int(fri.pow_witness),
                query_commit_openings=[
                    [(_u32(row), _u32(path)) for row, path in layers]
                    for layers in fri.query_commit_openings
                ],
            ),
            query_input_openings=[
                [
                    BatchOpening_(
                        opened_rows=[_u32(r) for r in bo.opened_rows], proof=_u32(bo.proof)
                    )
                    for bo in rounds
                ]
                for rounds in p.pcs_proof.query_input_openings
            ],
        ),
    )


def uni_proof_from_jax(p) -> UniProof:
    """A JAX `UniProof` (read through its attributes) -> the port's."""
    return _convert_uni(p, UniProof, PcsProof, BatchOpening, FriProof)


def uni_proof_to_jax(p: UniProof, UniProof_, PcsProof_, BatchOpening_, FriProof_):
    """The port's `UniProof` -> an object of the given (JAX) classes."""
    return _convert_uni(p, UniProof_, PcsProof_, BatchOpening_, FriProof_)


# ---------------------------------------------------------------------------
# Stable JSON
# ---------------------------------------------------------------------------


def _ints(a):
    return [int(x) for x in np.asarray(a).reshape(-1)]


def uni_proof_to_dict(p) -> dict:
    """Plain-int dict of a `UniProof` (port's or JAX's: attributes only).
    Every field is kept; Merkle paths are flattened row-major (rows of 8)."""
    fri = p.pcs_proof.fri
    return {
        "main_commit": [int(x) for x in p.main_commit],
        "quotient_commit": [int(x) for x in p.quotient_commit],
        "main_local": [list(v) for v in _ef_list(p.main_local)],
        "main_next": [list(v) for v in _ef_list(p.main_next)],
        "quotient": [[list(v) for v in _ef_list(ch)] for ch in p.quotient],
        "log_degree": int(p.log_degree),
        "fri": {
            "commit_phase_commits": [_ints(r) for r in fri.commit_phase_commits],
            "final_poly": [int(x) for x in fri.final_poly],
            "pow_witness": int(fri.pow_witness),
            "query_commit_openings": [
                [{"row": _ints(row), "path": _ints(path)} for row, path in layers]
                for layers in fri.query_commit_openings
            ],
        },
        "query_input_openings": [
            [
                {"rows": [_ints(r) for r in bo.opened_rows], "path": _ints(bo.proof)}
                for bo in rounds
            ]
            for rounds in p.pcs_proof.query_input_openings
        ],
    }


def uni_proof_to_json(p) -> str:
    """Stable JSON text: sorted keys, no whitespace, one trailing newline."""
    return json.dumps(uni_proof_to_dict(p), sort_keys=True, separators=(",", ":")) + "\n"


def uni_proof_from_json(text: str) -> UniProof:
    d = json.loads(text)
    path = lambda flat: np.asarray(flat, dtype=np.uint32).reshape(-1, 8)
    fri = d["fri"]
    return UniProof(
        main_commit=d["main_commit"],
        quotient_commit=d["quotient_commit"],
        main_local=[tuple(v) for v in d["main_local"]],
        main_next=[tuple(v) for v in d["main_next"]],
        quotient=[[tuple(v) for v in ch] for ch in d["quotient"]],
        log_degree=d["log_degree"],
        pcs_proof=PcsProof(
            fri=FriProof(
                commit_phase_commits=[np.asarray(r, dtype=np.uint32) for r in fri["commit_phase_commits"]],
                final_poly=tuple(fri["final_poly"]),
                pow_witness=fri["pow_witness"],
                query_commit_openings=[
                    [(np.asarray(o["row"], dtype=np.uint32), path(o["path"])) for o in layers]
                    for layers in fri["query_commit_openings"]
                ],
            ),
            query_input_openings=[
                [
                    BatchOpening(
                        opened_rows=[np.asarray(r, dtype=np.uint32) for r in o["rows"]],
                        proof=path(o["path"]),
                    )
                    for o in rounds
                ]
                for rounds in d["query_input_openings"]
            ],
        ),
    )

