"""PyTorch/CUDA port of the zkvm_brainfuck_tpu STARK prover.

The entry point is `ProverClient` (sdk.py): setup -> prove -> verify of a
Brainfuck guest over the machine's 8 chips, with LogUp, the preprocessed
commit and the 4-round opening, as in the JAX package.  The single-chip
uni-STARK (`stark.uni`) stays beside it.  Hand-written CUDA kernels
(`csrc/`): the NTT block stages, the global NTT stage, the Poseidon2 leaf
sponge, the Merkle tree walk, the batched Poseidon2 permutation, and the
LogUp trace (entries and running sum in one kernel).  Field values are
canonical KoalaBear elements in `torch.int32`.

Entry points (`ProverClient`, `utils.prove.run_test` / `prove_program`,
`StarkMachine.debug_constraints`, the examples) run on `cuda` unless the
caller passes `device="cpu"`, which selects each kernel's plain PyTorch
version.  BF_DEBUG, SKIP_CONSTRAINTS, ZKBF_PROFILE and ZKBF_LOG act as in
the JAX package (prover.py).  Importing this package never builds or loads
a kernel.
"""

from .device import NoCudaDevice, resolve_device
from .prover import BfCoreProof, BfProver, BfProvingKey, BfVerifyingKey
from .sdk import BfProofWithPublicValues, BfVerificationError, CpuProver, Prover, ProverClient
from .utils.logging import setup_logger

__all__ = [
    "ProverClient",
    "Prover",
    "CpuProver",
    "BfProver",
    "BfProvingKey",
    "BfVerifyingKey",
    "BfCoreProof",
    "BfProofWithPublicValues",
    "BfVerificationError",
    "NoCudaDevice",
    "resolve_device",
    "setup_logger",
]
