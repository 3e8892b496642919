"""StarkMachine: chip collection + setup/verify.

Counterpart of the JAX package's stark/machine.py (reference
crates/stark/src/machine.rs).  Preprocessed traces are sorted by (height
desc, name asc) and committed in one PCS batch on the device; pk/vk carry
the root, the ordering and the local-only flags.  The transcript binds the
preprocessed root plus a 7-zero pad exactly like machine.rs:64-69.
`debug_constraints` is the BF_DEBUG replay.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.program import Program
from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..models.base import ByteDeps, ChipAir
from ..ops.field import as_field_tensor
from ..parallel.mesh import check_prover_device, current_mesh, place_rows
from .challenger import DuplexChallenger
from .chip import Chip
from .domains import Domain
from .errors import MachineVerificationError, VerificationFailure
from .pcs import PcsProverData, pcs_commit


@dataclass
class StarkProvingKey:
    commit: np.ndarray  # (8,) canonical root
    traces: list  # preprocessed traces (canonical int32; RowSharded on a mesh), sorted order
    data: PcsProverData
    chip_ordering: Dict[str, int]
    local_only: List[bool]

    def observe_into(self, challenger: DuplexChallenger):
        challenger.observe_commitment([int(x) for x in self.commit])
        for _ in range(7):
            challenger.observe(0)


@dataclass
class StarkVerifyingKey:
    commit: List[int]
    chip_information: List[Tuple[str, Domain, Tuple[int, int]]]  # (name, domain, (h, w))
    chip_ordering: Dict[str, int]

    def observe_into(self, challenger: DuplexChallenger):
        challenger.observe_commitment([int(x) for x in self.commit])
        for _ in range(7):
            challenger.observe(0)


def commit_preprocessed(named, device) -> Tuple[StarkProvingKey, StarkVerifyingKey]:
    """pk and vk from (name, local_only, trace) triples (canonical values,
    numpy or torch): sort by (height desc, name asc), commit the traces in
    one batch on `device` (row-sharded over the mesh, when one is set)."""
    mesh = current_mesh()
    if mesh is not None:
        check_prover_device(mesh, device)
    named = sorted(
        ((name, lo, place_rows(as_field_tensor(t, device))) for name, lo, t in named),
        key=lambda t: (-t[2].shape[0], t[0]),
    )
    domains_and_traces = []
    chip_information = []
    for name, _lo, trace in named:
        domain = Domain(trace.shape[0].bit_length() - 1, 1)
        domains_and_traces.append((domain, trace))
        chip_information.append((name, domain, (trace.shape[0], trace.shape[1])))
    root, data = pcs_commit(domains_and_traces, device=device)
    chip_ordering = {name: i for i, (name, _, _) in enumerate(named)}
    pk = StarkProvingKey(
        commit=root,
        traces=[t for _, _, t in named],
        data=data,
        chip_ordering=chip_ordering,
        local_only=[lo for _, lo, _ in named],
    )
    vk = StarkVerifyingKey(
        commit=[int(x) for x in root],
        chip_information=chip_information,
        chip_ordering=dict(chip_ordering),
    )
    return pk, vk


class StarkMachine:
    def __init__(self, config, airs: List[ChipAir]):
        self.config = config
        self.chips: List[Chip] = [Chip(a) for a in airs]

    def shard_chips(self, record: ExecutionRecord) -> List[Chip]:
        return [c for c in self.chips if c.included(record)]

    def shard_chips_ordered(self, chip_ordering: Dict[str, int]) -> List[Chip]:
        present = [c for c in self.chips if c.name in chip_ordering]
        return sorted(present, key=lambda c: chip_ordering[c.name])

    # -- setup ------------------------------------------------------------

    def setup(self, program: Program, device=None) -> Tuple[StarkProvingKey, StarkVerifyingKey]:
        """Preprocessed traces, their commit on the device (the card unless
        device="cpu"), and the keys."""
        device = resolve_device(device)
        named = []
        for chip in self.chips:
            prep = chip.air.generate_preprocessed(program, device=device)
            if prep is None:
                continue
            assert prep.shape[1] == chip.preprocessed_width, chip.name
            named.append((chip.name, chip.local_only, prep))
        return commit_preprocessed(named, device)

    # -- dependencies (byte-table histograms) ------------------------------

    def generate_dependencies(self, record: ExecutionRecord, device=None) -> ByteDeps:
        deps = ByteDeps()
        for chip in self.shard_chips(record):
            chip.air.byte_dependencies(record, deps, device=device)
        return deps

    # -- verification ------------------------------------------------------

    def verify(self, vk: StarkVerifyingKey, proof, challenger: DuplexChallenger):
        """Raises a typed `VerificationFailure` subclass on rejection; any
        structural malformation (bad orderings, missing fields) that surfaces
        as a non-verification exception is wrapped in
        `MachineVerificationError` (machine.rs InvalidShardProof)."""
        from .verifier import verify_shard

        vk.observe_into(challenger)
        try:
            chips = self.shard_chips_ordered(proof.shard_proof.chip_ordering)
            verify_shard(self.config, vk, chips, challenger, proof.shard_proof)
        except VerificationFailure:
            raise
        except (KeyError, IndexError, AttributeError, TypeError, ValueError) as e:
            raise MachineVerificationError(
                f"structurally invalid shard proof: {type(e).__name__}: {e}"
            ) from e

    # -- debug -------------------------------------------------------------

    def debug_constraints(self, program: Program, record: ExecutionRecord, device=None):
        """Row-by-row constraint + lookup-balance replay (debug feature).

        Mirrors machine.rs:288-387 + debug.rs:24-262, as the JAX package's
        StarkMachine.debug_constraints does: the traces are generated on
        `device` (the card unless device="cpu") and checked on the host
        (stark/debug.py): the AIR constraints, the lookup balance, THEN two
        permutation challenges sampled from a challenger that observed 0..7,
        each chip's LogUp permutation trace from generate_permutation_trace
        (on the card, the fused LogUp kernel), the permutation constraints
        row by row, and the global cumulative-sum-zero check.  Raises
        AssertionError on the first failure; SKIP_CONSTRAINTS turns it off.
        """
        if os.environ.get("SKIP_CONSTRAINTS"):
            return
        from . import ef_host as efh
        from . import permutation
        from .debug import check_constraints, debug_lookup_balance

        def host(t):
            return None if t is None else t.cpu().numpy().astype(np.uint32)

        device = resolve_device(device)
        deps = self.generate_dependencies(record, device=device)
        traces = []
        for chip in self.shard_chips(record):
            prep = chip.air.generate_preprocessed(program, device=device)
            main = chip.air.generate_trace(record, deps, device=device)
            prep_np, main_np = host(prep), host(main)
            traces.append((chip, prep, main, prep_np, main_np))
            fails = check_constraints(chip, main_np, prep_np)
            if fails:
                raise AssertionError(f"constraint failures: {fails}")
        imbalance = debug_lookup_balance([(c, p, m) for c, _p, _m, p, m in traces])
        if imbalance:
            raise AssertionError(
                f"lookup imbalance ({len(imbalance)} keys): "
                f"{dict(list(imbalance.items())[:10])}"
            )

        # Permutation replay: sample 2 challenges, build the real LogUp
        # traces, re-check AIR + permutation constraints per row, and assert
        # the cumulative sums cancel (machine.rs:331-387).
        challenger = DuplexChallenger()
        challenger.observe_slice(list(range(8)))
        perm_challenges = [challenger.sample_ext(), challenger.sample_ext()]
        total = efh.ZERO
        for chip, prep, main, prep_np, main_np in traces:
            perm, csum = permutation.generate_permutation_trace(
                chip, prep, main, perm_challenges[0], perm_challenges[1]
            )
            csum_host = tuple(int(x) for x in csum.cpu().tolist())
            fails = check_constraints(
                chip, main_np, prep_np, host(perm), perm_challenges, csum_host
            )
            if fails:
                raise AssertionError(f"permutation constraint failures: {fails}")
            total = efh.add(total, csum_host)
        if total != efh.ZERO:
            raise AssertionError(f"cumulative sums do not cancel: {total}")
