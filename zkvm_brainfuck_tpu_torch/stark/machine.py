"""StarkMachine: chip collection + setup/verify.

Counterpart of the JAX package's stark/machine.py (reference
crates/stark/src/machine.rs).  Preprocessed traces are sorted by (height
desc, name asc) and committed in one PCS batch on the device; pk/vk carry
the root, the ordering and the local-only flags.  The transcript binds the
preprocessed root plus a 7-zero pad exactly like machine.rs:64-69.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.program import Program
from ..core.record import ExecutionRecord
from ..device import resolve_device
from ..models.base import ByteDeps, ChipAir
from ..ops.field import as_field_tensor
from .challenger import DuplexChallenger
from .chip import Chip
from .domains import Domain
from .errors import MachineVerificationError, VerificationFailure
from .pcs import PcsProverData, pcs_commit


@dataclass
class StarkProvingKey:
    commit: np.ndarray  # (8,) canonical root
    traces: List[torch.Tensor]  # preprocessed traces (canonical int32), sorted order
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
    one batch on `device`."""
    named = sorted(
        ((name, lo, as_field_tensor(t, device)) for name, lo, t in named),
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
