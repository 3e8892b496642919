"""PyTorch/CUDA port of the zkvm_brainfuck_tpu STARK prover.

Slice 1: the single-chip uni-STARK (`stark.uni`) over the Cpu chip, with
hand-written CUDA kernels for the NTT block stages, the global NTT stage,
the Poseidon2 leaf sponge and the batched Poseidon2 permutation
(`csrc/`).  Field values are canonical KoalaBear elements in `torch.int32`.

Entry points run on `cuda` unless the caller passes `device="cpu"`, which
selects each kernel's plain PyTorch version.  Importing this package never
builds or loads a kernel.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
