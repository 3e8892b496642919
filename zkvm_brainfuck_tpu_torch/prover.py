"""End-to-end prover orchestration (reference: crates/prover/).

Counterpart of the JAX package's prover.py.  `BfProver` ties the executor
front-end to the STARK machine: setup parses the guest source into keys,
execute runs the interpreter only, prove runs the full pipeline and logs the
summary line (cycles / e2e ms / kHz / proof size, matching
utils/prove.rs:50-56), verify enforces the CPU-chip presence and the 2^22
max log degree (crates/prover/src/verify.rs:16-28).

The device work runs on the card unless the prover is built with
device="cpu" (the plain versions of the kernels, for the tests).

Environment, as in the JAX package: BF_DEBUG=1 replays the constraints
and the lookups after a prove (`StarkMachine.debug_constraints`; off with
SKIP_CONSTRAINTS); ZKBF_PROFILE=<dir> wraps the prove in torch.profiler
and writes a Chrome trace into <dir>; ZKBF_LOG sets the log level
(`utils.logging.setup_logger`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .core.executor import execute
from .core.program import Program
from .device import elapsed
from .models.machine_def import brainfuck_chips
from .stark.config import KoalaBearPoseidon2
from .stark.errors import (
    CpuLogDegreeTooLarge,
    MachineVerificationError,
    MissingCpuChip,
    VerificationFailure,
)
from .stark.machine import StarkMachine, StarkProvingKey, StarkVerifyingKey
from .stark.prover import CudaProver
from .stark.serial import decode_vk, encode_vk
from .stark.types import MachineProof
from .utils import phases
from .utils.report import generate_execution_report

log = logging.getLogger("zkbf.prover")

# Max CPU trace log-degree: lookup multiplicity overflow bound
# (reference crates/core/machine/src/cpu/mod.rs:8).
MAX_CPU_LOG_DEGREE = 22


@dataclass
class BfVerifyingKey:
    vk: StarkVerifyingKey

    def to_bytes(self) -> bytes:
        """Serialize (reference StarkVerifyingKey serde, machine.rs:73-75)."""
        return encode_vk(self.vk)

    @classmethod
    def from_bytes(cls, data: bytes) -> "BfVerifyingKey":
        return cls(vk=decode_vk(data))


@dataclass
class BfProvingKey:
    pk: StarkProvingKey
    elf: str
    vk: BfVerifyingKey

    def to_bytes(self) -> bytes:
        """Serialize by carrying the guest source, like the reference
        BfProvingKey carries the ELF (crates/prover/src/types.rs:9-14).

        The device-resident PCS data (preprocessed traces, LDEs, Merkle
        tree) is not serialized: it is recomputed from the source on load,
        and the recomputed commitment is checked against the stored vk."""
        elf_b = self.elf.encode("utf-8")
        vk_b = self.vk.to_bytes()
        return struct.pack("<II", len(elf_b), len(vk_b)) + elf_b + vk_b

    @classmethod
    def from_bytes(cls, data: bytes, prover: "BfProver") -> "BfProvingKey":
        if len(data) < 8:
            raise VerificationFailure("truncated proving key bytes")
        n_elf, n_vk = struct.unpack("<II", data[:8])
        if 8 + n_elf + n_vk != len(data):
            raise VerificationFailure("bad proving key framing")
        elf = data[8 : 8 + n_elf].decode("utf-8")
        stored_vk = BfVerifyingKey.from_bytes(data[8 + n_elf :])
        pk, vk = prover.setup(elf)
        if vk.vk.commit != stored_vk.vk.commit:
            raise VerificationFailure(
                "recomputed preprocessed commitment does not match stored vk"
            )
        return pk


@dataclass
class BfCoreProof:
    proof: MachineProof
    stdin: bytes
    public_values: bytes
    cycles: int
    # seconds per phase of this prove (execute, the pipeline's phases,
    # prove_total); not part of the proof
    timings: Dict[str, float] = field(default_factory=dict, compare=False)


class BfProver:
    def __init__(self, config: Optional[KoalaBearPoseidon2] = None, device=None):
        self.config = config or KoalaBearPoseidon2()
        self.machine = StarkMachine(self.config, brainfuck_chips())
        self.core_prover = CudaProver(self.machine, device=device)

    def setup(self, elf: str) -> Tuple[BfProvingKey, BfVerifyingKey]:
        program = Program.from_source(elf)
        pk, vk = self.core_prover.setup(program)
        bf_vk = BfVerifyingKey(vk=vk)
        return BfProvingKey(pk=pk, elf=elf, vk=bf_vk), bf_vk

    def execute(self, elf: str, stdin: bytes) -> bytes:
        return execute(Program.from_source(elf), stdin).output_stream

    def prove(self, pk: BfProvingKey, stdin: bytes) -> BfCoreProof:
        timings: Dict[str, float] = {}
        program = Program.from_source(pk.elf)
        t0 = time.time()
        record = execute(program, stdin)
        timings["execute"] = time.time() - t0
        phases.add("execute", timings["execute"])

        challenger = self.config.challenger()
        device = self.core_prover.device
        t0 = time.time()
        with _profiled(os.environ.get("ZKBF_PROFILE"), device):
            proof = self.core_prover.prove(pk.pk, record, challenger, timings=timings)
        timings["prove_total"] = elapsed(t0, device)
        phases.add("prove_total", timings["prove_total"])
        log.info(
            "summary: cycles=%d, e2e=%dms, khz=%.2f, proofSize=%d",
            record.global_clk,
            int(timings["prove_total"] * 1000),
            record.global_clk / max(timings["prove_total"] * 1000, 1e-9),
            len(proof.to_bytes()),
        )
        for line in generate_execution_report(record.opcode_counts()):
            log.debug("%s", line)

        if os.environ.get("BF_DEBUG", "").lower() in ("1", "true"):
            self.machine.debug_constraints(program, record, device=device)

        return BfCoreProof(
            proof=proof,
            stdin=bytes(stdin),
            public_values=record.output_stream,
            cycles=record.global_clk,
            timings=timings,
        )

    def verify(self, proof: MachineProof, vk: BfVerifyingKey) -> None:
        sp = proof.shard_proof
        if not sp.contains_cpu():
            raise MissingCpuChip("missing CPU chip in shard")
        try:
            if sp.log_degree_cpu() > MAX_CPU_LOG_DEGREE:
                raise CpuLogDegreeTooLarge(
                    f"CPU log degree {sp.log_degree_cpu()} > {MAX_CPU_LOG_DEGREE}"
                )
        except (KeyError, IndexError, AttributeError, TypeError) as e:
            raise MachineVerificationError(
                f"structurally invalid shard proof: {type(e).__name__}: {e}"
            ) from e
        self.machine.verify(vk.vk, proof, self.config.challenger())


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device):
    """ZKBF_PROFILE=<dir>: a torch.profiler trace of the block (host, and the
    card's kernels and copies when `device` is the card), written into <dir>
    as a Chrome trace; the counterpart of the JAX package's
    jax.profiler.trace.  Without a directory, nothing."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"prove_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("torch.profiler trace written to %s", path)
