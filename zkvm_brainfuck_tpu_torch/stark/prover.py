"""Machine prover: the full shard proving pipeline on one device.

Counterpart of the JAX package's stark/prover.py (reference pipeline:
crates/stark/src/prover.rs:560-583, 242-553): generate traces -> main commit
-> 2 permutation challenges -> LogUp traces + cumulative sums -> permutation
commit -> alpha -> quotient evaluation on disjoint cosets -> quotient commit
-> zeta -> one 4-round PCS opening [preprocessed, main, permutation,
quotient].

Device/host split: trace, LogUp, quotient, NTT, Merkle and FRI-fold work
runs on the device (the card, or the plain versions on the CPU when the
prover is built with device="cpu"); the duplex challenger is host-side and
touches only roots, cumulative sums and opened values.

With a row mesh set (`set_shard_mesh`, parallel/mesh.py), every trace is
placed row-sharded (`place_rows`) and the LDEs, Merkle leaves, LogUp
traces and quotient values stay row-sharded; the prover's device must be
the mesh's first device, and the proof is the same bytes.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch

from ..core.program import Program
from ..core.record import ExecutionRecord
from ..device import elapsed, resolve_device
from ..ops.field import GENERATOR
# set_shard_mesh and current_mesh are re-exported here, as in the JAX package
from ..parallel.mesh import check_prover_device, current_mesh, place_rows, set_shard_mesh  # noqa: F401
from ..utils import phases
from .challenger import DuplexChallenger
from .domains import Domain
from .machine import StarkMachine, StarkProvingKey
from .pcs import pcs_commit, pcs_open
from .permutation import generate_permutation_trace
from .quotient import quotient_values, split_quotient_chunks
from .types import (
    AirOpenedValues,
    ChipOpenedValues,
    MachineProof,
    ShardCommitment,
    ShardProof,
)

log = logging.getLogger("zkbf.prover")


class MachineProver:
    """Hardware-abstraction seam (reference `MachineProver` trait,
    crates/stark/src/prover.rs:27-150).

    Subclasses own the device representation of traces; the Fiat-Shamir
    transcript only ever crosses this boundary as host integers (roots,
    cumulative sums, opened values).  `prove` is the backend-independent
    pipeline; `generate_traces`, `commit` and `open` are the backend's
    entry points.  `timings`, when given, receives the seconds of each phase
    under the JAX package's phase names."""

    def __init__(self, machine: StarkMachine, device=None):
        self.machine = machine
        self.device = resolve_device(device)

    @property
    def config(self):
        return self.machine.config

    def setup(self, program: Program):
        return self.machine.setup(program, device=self.device)

    def generate_traces(self, record: ExecutionRecord):
        raise NotImplementedError

    def commit(self, named_traces):
        raise NotImplementedError

    def open(self, pk, shard_data, challenger, timings) -> ShardProof:
        raise NotImplementedError

    def prove(
        self,
        pk: StarkProvingKey,
        record: ExecutionRecord,
        challenger: DuplexChallenger,
        timings: Optional[Dict[str, float]] = None,
    ) -> MachineProof:
        timings = {} if timings is None else timings
        mesh = current_mesh()
        if mesh is not None:
            check_prover_device(mesh, self.device)
        if pk.data.mesh != mesh:
            raise ValueError(f"the proving key was set up on mesh {pk.data.mesh}, the prove runs "
                             f"on {mesh}: run setup under the prove's mesh")
        pk.observe_into(challenger)
        t0 = time.time()
        named_traces = self.generate_traces(record)
        timings["trace_gen"] = elapsed(t0, self.device)
        phases.add("trace_gen", timings["trace_gen"])

        t0 = time.time()
        shard_data = self.commit(named_traces)
        timings["main_commit"] = elapsed(t0, self.device)
        phases.add("main_commit", timings["main_commit"])
        # open() drops the main eval matrices after LogUp; no other
        # reference may keep them alive.
        del named_traces
        proof = self.open(pk, shard_data, challenger, timings)
        return MachineProof(shard_proof=proof)


class CudaProver(MachineProver):
    """The hardware prover: every device phase on one CUDA card through the
    port's kernels (or their plain versions for device="cpu")."""

    # -- phase 1: traces ---------------------------------------------------

    def generate_traces(self, record: ExecutionRecord):
        deps = self.machine.generate_dependencies(record, device=self.device)
        return [
            (chip.name, place_rows(chip.air.generate_trace(record, deps, device=self.device)))
            for chip in self.machine.shard_chips(record)
        ]

    # -- phase 2: main commit ---------------------------------------------

    def commit(self, named_traces):
        named_traces = sorted(named_traces, key=lambda t: (-t[1].shape[0], t[0]))
        domains_and_traces = [
            (Domain(t.shape[0].bit_length() - 1, 1), t) for _, t in named_traces
        ]
        root, data = pcs_commit(domains_and_traces, device=self.device)
        return {
            "traces": [t for _, t in named_traces],
            "root": root,
            "data": data,
            "chip_ordering": {name: i for i, (name, _) in enumerate(named_traces)},
        }

    # -- phase 3: open -----------------------------------------------------

    def open(self, pk: StarkProvingKey, shard_data, challenger: DuplexChallenger,
             timings: Dict[str, float]) -> ShardProof:
        config = self.config
        device = self.device
        chips = self.machine.shard_chips_ordered(shard_data["chip_ordering"])
        traces = shard_data["traces"]
        main_data = shard_data["data"]

        degrees = [t.shape[0] for t in traces]
        log_degrees = [d.bit_length() - 1 for d in degrees]
        trace_domains = [Domain(ld, 1) for ld in log_degrees]
        trace_widths = [t.shape[1] for t in traces]

        challenger.observe_commitment([int(x) for x in shard_data["root"]])
        perm_challenges = [challenger.sample_ext() for _ in range(2)]

        # LogUp traces (device), then ONE transfer of the cumulative sums.
        t0 = time.time()
        perm_traces = []
        cumulative_sums = []
        for chip, trace in zip(chips, traces):
            prep = None
            if chip.name in pk.chip_ordering:
                prep = pk.traces[pk.chip_ordering[chip.name]]
            perm, csum = generate_permutation_trace(
                chip, prep, trace, perm_challenges[0], perm_challenges[1]
            )
            perm_traces.append(perm)
            cumulative_sums.append(csum)
        cumulative_sums_host = [
            tuple(int(x) for x in row) for row in torch.stack(cumulative_sums).cpu().tolist()
        ]
        timings["perm_trace"] = elapsed(t0, device)
        phases.add("perm_trace", timings["perm_trace"])
        for i, chip in enumerate(chips):
            log.debug(
                "%-12s | Main Cols = %3d | Pre Cols = %3d | Perm Cols = %3d | Rows = %7d",
                chip.name, trace_widths[i], chip.preprocessed_width,
                perm_traces[i].shape[1] * 4, degrees[i],
            )

        # The main eval matrices are no longer read (the quotient and the
        # openings use the LDEs): free them.
        traces = None
        shard_data["traces"] = None

        t0 = time.time()
        perm_root, perm_data = pcs_commit(
            [(d, p.reshape(p.shape[0], -1)) for d, p in zip(trace_domains, perm_traces)],
            device=device,
        )
        perm_traces = None  # the committed round keeps the LDEs (or the evals)
        timings["perm_commit"] = elapsed(t0, device)
        phases.add("perm_commit", timings["perm_commit"])

        challenger.observe_commitment([int(x) for x in perm_root])
        for csum in cumulative_sums_host:
            challenger.observe_slice(list(csum))
        alpha = challenger.sample_ext()

        # Quotient evaluation per chip on its disjoint coset.
        t0 = time.time()
        quotient_mats = []
        quotient_domains_flat = []
        chunk_counts = []
        for i, chip in enumerate(chips):
            log_qd = chip.log_quotient_degree
            qdomain = trace_domains[i].create_disjoint_domain(1 << (log_degrees[i] + log_qd))
            # With blowup == log_qd == 1 the quotient domain IS the LDE domain.
            assert qdomain.log_n == log_degrees[i] + 1 and qdomain.shift == GENERATOR
            # The LDEs as column blocks: the resident LDE in normal mode;
            # in low-memory mode blocks recomputed here, which die when this
            # chip's quotient is done (no name outside the call holds them).
            prep_index = pk.chip_ordering.get(chip.name)
            qvals = quotient_values(
                chip,
                trace_domains[i],
                qdomain,
                None if prep_index is None else pk.data.lde_blocks(prep_index),
                main_data.lde_blocks(i),
                perm_data.lde_blocks(i),
                perm_challenges,
                alpha,
                cumulative_sums_host[i],
            )
            chunks = split_quotient_chunks(qdomain, qvals, 1 << log_qd)
            quotient_domains_flat.extend(qdomain.split_domains(1 << log_qd))
            quotient_mats.extend(chunks)
            chunk_counts.append(1 << log_qd)
        timings["quotient"] = elapsed(t0, device)
        phases.add("quotient", timings["quotient"])

        t0 = time.time()
        quotient_root, quotient_data = pcs_commit(
            list(zip(quotient_domains_flat, quotient_mats)), device=device
        )
        n_quotient_mats = len(quotient_mats)
        quotient_mats = None  # the committed round keeps the LDEs
        timings["quotient_commit"] = elapsed(t0, device)
        phases.add("quotient_commit", timings["quotient_commit"])
        challenger.observe_commitment([int(x) for x in quotient_root])

        zeta = challenger.sample_ext()

        # Opening points per round.
        prep_points = []
        for trace, lo in zip(pk.traces, pk.local_only):
            d = Domain(trace.shape[0].bit_length() - 1, 1)
            prep_points.append([zeta] if lo else [zeta, d.next_point_ef(zeta)])
        main_points = [
            [zeta] if chip.local_only else [zeta, td.next_point_ef(zeta)]
            for chip, td in zip(chips, trace_domains)
        ]
        perm_points = [[zeta, td.next_point_ef(zeta)] for td in trace_domains]
        quotient_points = [[zeta] for _ in range(n_quotient_mats)]

        t0 = time.time()
        opened, pcs_proof = pcs_open(
            [
                (pk.data, prep_points),
                (main_data, main_points),
                (perm_data, perm_points),
                (quotient_data, quotient_points),
            ],
            challenger,
            num_queries=config.fri.num_queries,
            pow_bits=config.fri.proof_of_work_bits,
            timings=timings,
        )
        timings["pcs_open_total"] = elapsed(t0, device)
        phases.add("pcs_open_total", timings["pcs_open_total"])

        prep_vals, main_vals, perm_vals, quot_vals = opened

        def air_vals(mat_vals, local_only_flag, width):
            if local_only_flag:
                return AirOpenedValues(local=mat_vals[0], next=[(0, 0, 0, 0)] * width)
            return AirOpenedValues(local=mat_vals[0], next=mat_vals[1])

        opened_chips = []
        qi = 0
        for i, chip in enumerate(chips):
            if chip.name in pk.chip_ordering:
                pidx = pk.chip_ordering[chip.name]
                prep_open = air_vals(
                    prep_vals[pidx], pk.local_only[pidx], pk.traces[pidx].shape[1]
                )
            else:
                prep_open = AirOpenedValues(local=[], next=[])
            main_open = air_vals(main_vals[i], chip.local_only, trace_widths[i])
            perm_open = AirOpenedValues(local=perm_vals[i][0], next=perm_vals[i][1])
            chunks = [quot_vals[qi + k][0] for k in range(chunk_counts[i])]
            qi += chunk_counts[i]
            opened_chips.append(
                ChipOpenedValues(
                    preprocessed=prep_open,
                    main=main_open,
                    permutation=perm_open,
                    quotient=chunks,
                    cumulative_sum=cumulative_sums_host[i],
                    log_degree=log_degrees[i],
                )
            )

        return ShardProof(
            commitment=ShardCommitment(
                main_commit=[int(x) for x in shard_data["root"]],
                permutation_commit=[int(x) for x in perm_root],
                quotient_commit=[int(x) for x in quotient_root],
            ),
            opened_values=opened_chips,
            opening_proof=pcs_proof,
            chip_ordering=dict(shard_data["chip_ordering"]),
        )
