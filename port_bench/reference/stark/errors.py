"""Typed verification-error taxonomy.

Mirrors the reference's error enums so callers (and the adversarial tests)
can distinguish WHY a proof was rejected, not just that it was:

the `VerificationError` variants (crates/stark/src/verifier.rs:350-365),
each a subclass of `VerificationFailure`.
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
