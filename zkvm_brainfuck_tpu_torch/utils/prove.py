"""Library prove/test helpers (reference crates/core/machine/src/utils/prove.rs).

Counterpart of the JAX package's utils/prove.py, with the port's `device`
argument: None means the CUDA card (`NoCudaDevice` without one), "cpu" the
plain PyTorch versions of the kernels.

`run_test` mirrors `run_test_core` (utils/prove.rs:68-95): prove with one
BfProver, then REBUILD config/machine/keys from scratch for the verify leg -
guarding against prover state silently leaking into verification.  The vk
crosses the prover->verifier boundary as BYTES (serial.py), so the check also
exercises the serialized-key path the reference gets from serde.
"""

from __future__ import annotations

from ..device import resolve_device


def run_test(elf: str, stdin: bytes = b"", device=None):
    """Prove `elf` with one prover; verify with a FRESH machine + decoded vk.

    Returns the BfCoreProof.  Raises on any execution/proving/verification
    failure (reference run_test, utils/prove.rs:68-74).
    """
    from ..prover import BfProver, BfVerifyingKey

    device = resolve_device(device)
    prover = BfProver(device=device)
    pk, vk = prover.setup(elf)
    proof = prover.prove(pk, stdin)

    fresh = BfProver(device=device)
    fresh_vk = BfVerifyingKey.from_bytes(vk.to_bytes())
    fresh.verify(proof.proof, fresh_vk)
    return proof


def prove_program(elf: str, stdin: bytes = b"", device=None):
    """Execute + prove + summary log (reference `prove`, utils/prove.rs:23-66).

    Returns (proof, verifying key, prover) without verifying.
    """
    from ..prover import BfProver

    prover = BfProver(device=resolve_device(device))
    pk, vk = prover.setup(elf)
    proof = prover.prove(pk, stdin)
    return proof, vk, prover
