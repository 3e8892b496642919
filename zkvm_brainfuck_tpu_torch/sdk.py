"""SDK: the user-facing client (reference: crates/sdk/src/lib.rs, action.rs,
provers/), with the JAX package's API plus a `device=` keyword.

    from zkvm_brainfuck_tpu_torch import ProverClient

    client = ProverClient()            # the card; ProverClient(device="cpu") for tests
    (pk, vk) = client.setup(elf)
    output = client.execute(elf, stdin).run()
    proof = client.prove(pk, stdin).run()
    client.verify(proof, vk)

`device=None` means the CUDA card and raises `NoCudaDevice` without one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .prover import BfCoreProof, BfProver, BfProvingKey, BfVerifyingKey
from .stark.config import KoalaBearPoseidon2
from .stark.errors import VerificationFailure as BfVerificationError  # noqa: F401


@dataclass
class BfProofWithPublicValues:
    proof: BfCoreProof
    stdin: bytes

    @property
    def public_values(self) -> bytes:
        return self.proof.public_values


class Execute:
    """Action builder for execution (reference action.rs:10-33)."""

    def __init__(self, prover: "Prover", elf: str, stdin: bytes):
        self._prover = prover
        self._elf = elf
        self._stdin = bytes(stdin)

    def with_stdin(self, stdin: bytes) -> "Execute":
        self._stdin = bytes(stdin)
        return self

    def run(self) -> bytes:
        return self._prover.execute(self._elf, self._stdin)


class Prove:
    """Action builder for proving (reference action.rs:37-62)."""

    def __init__(self, prover: "Prover", pk: BfProvingKey, stdin: bytes):
        self._prover = prover
        self._pk = pk
        self._stdin = bytes(stdin)

    def with_stdin(self, stdin: bytes) -> "Prove":
        self._stdin = bytes(stdin)
        return self

    def run(self) -> BfProofWithPublicValues:
        return self._prover.prove(self._pk, self._stdin)


class Prover:
    """Prover trait (reference provers/mod.rs:24-42)."""

    def setup(self, elf: str):
        raise NotImplementedError

    def execute(self, elf: str, stdin: bytes) -> bytes:
        raise NotImplementedError

    def prove(self, pk: BfProvingKey, stdin: bytes) -> BfProofWithPublicValues:
        raise NotImplementedError

    def verify(self, proof: BfProofWithPublicValues, vk: BfVerifyingKey) -> None:
        raise NotImplementedError


class CpuProver(Prover):
    """The local prover wrapping BfProver (the reference's provers/cpu.rs;
    the name is the reference's).  Its device work runs on the CUDA card,
    or on the CPU through the plain versions when built with device="cpu"."""

    def __init__(self, config: Optional[KoalaBearPoseidon2] = None, device=None):
        self.prover = BfProver(config=config, device=device)

    def setup(self, elf: str):
        return self.prover.setup(elf)

    def execute(self, elf: str, stdin: bytes) -> bytes:
        return self.prover.execute(elf, stdin)

    def prove(self, pk: BfProvingKey, stdin: bytes) -> BfProofWithPublicValues:
        core = self.prover.prove(pk, stdin)
        return BfProofWithPublicValues(proof=core, stdin=bytes(stdin))

    def verify(self, proof: BfProofWithPublicValues, vk: BfVerifyingKey) -> None:
        self.prover.verify(proof.proof.proof, vk)


class ProverClient:
    def __init__(self, prover: Optional[Prover] = None, device=None):
        self.prover = prover or CpuProver(device=device)

    @staticmethod
    def builder() -> "ProverClientBuilder":
        return ProverClientBuilder()

    def execute(self, elf: str, stdin: bytes = b"") -> Execute:
        return Execute(self.prover, elf, stdin)

    def prove(self, pk: BfProvingKey, stdin: bytes = b"") -> Prove:
        return Prove(self.prover, pk, stdin)

    def verify(self, proof: BfProofWithPublicValues, vk: BfVerifyingKey) -> None:
        self.prover.verify(proof, vk)

    def setup(self, elf: str):
        return self.prover.setup(elf)


class ProverClientBuilder:
    def __init__(self):
        self._skip_simulation = False

    def skip_simulation(self) -> "ProverClientBuilder":
        self._skip_simulation = True
        return self

    def build(self) -> ProverClient:
        return ProverClient()
