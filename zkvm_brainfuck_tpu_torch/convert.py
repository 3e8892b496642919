"""Conversions between the JAX package's objects and the port's, and a
stable JSON encoding of the port's `UniProof`.

The "weights carried across": a JAX `StarkProvingKey` / `StarkVerifyingKey`
becomes the port's (preprocessed traces Montgomery -> canonical, then the
port's own preprocessed commit, checked against the JAX root), and a JAX
`ShardProof` becomes the port's and back.

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
from .stark import types as st
from .stark.challenger import DuplexChallenger
from .stark.domains import Domain
from .stark.fri import FriProof
from .stark.machine import StarkProvingKey, StarkVerifyingKey, commit_preprocessed
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


def _convert_pcs(p, PcsProof_, BatchOpening_, FriProof_):
    fri = p.fri
    return PcsProof_(
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
                BatchOpening_(opened_rows=[_u32(r) for r in bo.opened_rows], proof=_u32(bo.proof))
                for bo in rounds
            ]
            for rounds in p.query_input_openings
        ],
    )


def _convert_uni(p, UniProof_, PcsProof_, BatchOpening_, FriProof_):
    return UniProof_(
        main_commit=[int(x) for x in p.main_commit],
        quotient_commit=[int(x) for x in p.quotient_commit],
        main_local=_ef_list(p.main_local),
        main_next=_ef_list(p.main_next),
        quotient=[_ef_list(ch) for ch in p.quotient],
        log_degree=int(p.log_degree),
        pcs_proof=_convert_pcs(p.pcs_proof, PcsProof_, BatchOpening_, FriProof_),
    )


def uni_proof_from_jax(p) -> UniProof:
    """A JAX `UniProof` (read through its attributes) -> the port's."""
    return _convert_uni(p, UniProof, PcsProof, BatchOpening, FriProof)


def uni_proof_to_jax(p: UniProof, UniProof_, PcsProof_, BatchOpening_, FriProof_):
    """The port's `UniProof` -> an object of the given (JAX) classes."""
    return _convert_uni(p, UniProof_, PcsProof_, BatchOpening_, FriProof_)


# ---------------------------------------------------------------------------
# Machine proofs and keys
# ---------------------------------------------------------------------------

# The classes a shard proof is built from, by name: the port's here; the
# caller passes the JAX package's for the other direction.
PORT_PROOF_CLASSES = {
    "ShardProof": st.ShardProof,
    "ShardCommitment": st.ShardCommitment,
    "ChipOpenedValues": st.ChipOpenedValues,
    "AirOpenedValues": st.AirOpenedValues,
    "PcsProof": PcsProof,
    "BatchOpening": BatchOpening,
    "FriProof": FriProof,
}


def _convert_shard(sp, C):
    air = lambda a: C["AirOpenedValues"](local=_ef_list(a.local), next=_ef_list(a.next))  # noqa: E731
    return C["ShardProof"](
        commitment=C["ShardCommitment"](
            main_commit=[int(x) for x in sp.commitment.main_commit],
            permutation_commit=[int(x) for x in sp.commitment.permutation_commit],
            quotient_commit=[int(x) for x in sp.commitment.quotient_commit],
        ),
        opened_values=[
            C["ChipOpenedValues"](
                preprocessed=air(c.preprocessed),
                main=air(c.main),
                permutation=air(c.permutation),
                quotient=[_ef_list(ch) for ch in c.quotient],
                cumulative_sum=tuple(int(x) for x in c.cumulative_sum),
                log_degree=int(c.log_degree),
            )
            for c in sp.opened_values
        ],
        opening_proof=_convert_pcs(sp.opening_proof, C["PcsProof"], C["BatchOpening"], C["FriProof"]),
        chip_ordering={str(k): int(v) for k, v in sp.chip_ordering.items()},
    )


def shard_proof_from_jax(sp) -> st.ShardProof:
    """A JAX `ShardProof` (read through its attributes) -> the port's."""
    return _convert_shard(sp, PORT_PROOF_CLASSES)


def shard_proof_to_jax(sp: st.ShardProof, classes: dict):
    """The port's `ShardProof` -> one built from `classes` (the JAX
    package's, keyed as PORT_PROOF_CLASSES)."""
    return _convert_shard(sp, classes)


def verifying_key_from_jax(vk) -> StarkVerifyingKey:
    return StarkVerifyingKey(
        commit=[int(x) for x in vk.commit],
        chip_information=[
            (str(name), Domain(int(d.log_n), int(d.shift)), (int(h), int(w)))
            for name, d, (h, w) in vk.chip_information
        ],
        chip_ordering={str(k): int(v) for k, v in vk.chip_ordering.items()},
    )


def proving_key_from_jax(pk, device=None) -> StarkProvingKey:
    """A JAX `StarkProvingKey` -> the port's on `device`: its preprocessed
    traces as canonical numpy (from Montgomery form), committed again by the
    port; raises if the port's root differs from the JAX package's."""
    order = sorted(pk.chip_ordering.items(), key=lambda kv: kv[1])
    named = [
        (name, bool(pk.local_only[i]), np_from_monty(np.asarray(pk.traces[i]).astype(np.uint32)))
        for name, i in order
    ]
    port_pk, _vk = commit_preprocessed(named, device)
    if [int(x) for x in port_pk.commit] != [int(x) for x in pk.commit]:
        raise ValueError("the port's preprocessed commitment differs from the JAX package's")
    if port_pk.chip_ordering != dict(pk.chip_ordering):
        raise ValueError("the port's preprocessed chip ordering differs from the JAX package's")
    return port_pk


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

