"""Typed verification-error taxonomy.

Mirrors the reference's error enums so callers (and the adversarial tests)
can distinguish WHY a proof was rejected, not just that it was:

- `VerificationError` variants (crates/stark/src/verifier.rs:350-365):
  InvalidopeningArgument, OodEvaluationMismatch, OpeningShapeError,
  CumulativeSumsError;
- `MachineVerificationError` (crates/stark/src/machine.rs:391-416):
  InvalidShardProof wrapper, NonZeroCumulativeSum;
- `BfVerificationError` (crates/sdk/src/provers/mod.rs:16-21) /
  crates/prover/src/verify.rs:16-28: missing CPU chip, CPU log degree bound.

Every class subclasses `VerificationFailure`, so existing `except
VerificationFailure` call sites keep working.
"""

from __future__ import annotations


class VerificationFailure(Exception):
    """Base class: the proof was rejected."""


class InvalidOpeningArgument(VerificationFailure):
    """A PCS/FRI opening is inconsistent: bad Merkle path, folded-value
    mismatch along a query's fold chain, or final-polynomial mismatch
    (reference VerificationError::InvalidopeningArgument)."""


class InvalidPowWitness(VerificationFailure):
    """The FRI proof-of-work witness does not grind to zero (part of the
    reference's FRI opening error; split out because every transcript-level
    tamper surfaces here first)."""


class OodEvaluationMismatch(VerificationFailure):
    """folded_constraints(zeta) * inv_zeroifier != recomposed quotient(zeta)
    (reference VerificationError::OodEvaluationMismatch)."""


class OpeningShapeError(VerificationFailure):
    """Opened-value shapes disagree with the chip/machine definition
    (reference VerificationError::OpeningShapeError)."""


class CumulativeSumsError(VerificationFailure):
    """LogUp cumulative sums are inconsistent: nonzero global sum, nonzero
    sum on a lookup-free chip, or the byte-multiplicity overflow guard
    (reference machine.rs NonZeroCumulativeSum + verifier.rs:48-61)."""


class MissingCpuChip(VerificationFailure):
    """The shard proof does not contain the CPU chip
    (reference crates/prover/src/verify.rs:16-21)."""


class CpuLogDegreeTooLarge(VerificationFailure):
    """CPU trace log degree exceeds MAX_CPU_LOG_DEGREE = 22
    (reference crates/prover/src/verify.rs:22-28)."""


class MachineVerificationError(VerificationFailure):
    """Wrapper for structurally invalid shard proofs (malformed orderings,
    missing keys) - the reference's MachineVerificationError::InvalidShardProof.
    Carries the underlying exception as __cause__ when wrapping."""
