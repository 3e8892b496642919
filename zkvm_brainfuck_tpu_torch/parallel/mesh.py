"""A row mesh of torch devices for multi-device proving.

Counterpart of the JAX package's parallel/mesh.py.  The scaling axis of the
prover is trace rows: traces, LDEs, Merkle leaves, LogUp terms and quotient
points shard over a 1-D "rows" mesh.  One process drives every device of
the mesh (single-controller, as the JAX package's `shard_map`): a mesh is an
explicit tuple of torch devices, and collectives are explicit
device-to-device copies (`parallel/collectives.py`).  A mesh may name one
device more than once: n x `cpu` in the tests, n x `cuda:0` for a virtual
mesh on one card; each entry is a shard of its own.

With a mesh set (`set_shard_mesh`), the prover places every trace with
`place_rows` and each phase works on the row blocks (`RowSharded`); a
`RowSharded` becomes one tensor only through `gather`, which the code calls
by name where it needs one.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..device import NoCudaDevice

MAX_MESH = 16


def _normalise(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class RowMesh:
    """Devices along one "rows" axis; shard k lives on devices[k]."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def cards(self) -> int:
        """Distinct devices of the mesh (1 for a virtual mesh)."""
        return len(set(self.devices))


def make_row_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> RowMesh:
    """A 1-D rows mesh: the first `n_devices` CUDA devices (all of them by
    default), or the caller's explicit `devices` (for example ["cpu"] * 8,
    or ["cuda:0"] * 4 for a virtual mesh on one card).  The size must be a
    power of two <= 16: every committed trace height is a power of two >= 16,
    so such meshes always divide every height."""
    if devices is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice("make_row_mesh: no CUDA device is available; pass devices=")
        have = torch.cuda.device_count()
        n = n_devices or have
        if n > have:
            raise ValueError(f"make_row_mesh: {n} devices asked for, {have} present")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"make_row_mesh: n_devices={n_devices} but {len(devs)} devices given")
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise NoCudaDevice("make_row_mesh: a CUDA device was named but none is available")
        devs = [_normalise(d) for d in devs]
    n = len(devs)
    if n < 1 or n & (n - 1) or n > MAX_MESH:
        raise ValueError(
            f"rows mesh size must be a power of two <= 16, got {n} "
            "(trace heights are powers of two >= 16; other mesh sizes "
            "cannot divide them)"
        )
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"make_row_mesh: a mesh mixes device types {sorted({d.type for d in devs})}")
    return RowMesh(tuple(devs))


# -- the active proving mesh -------------------------------------------------

CURRENT_MESH: Optional[RowMesh] = None


def set_shard_mesh(mesh: Optional[RowMesh]) -> None:
    global CURRENT_MESH
    CURRENT_MESH = mesh


def current_mesh() -> Optional[RowMesh]:
    return CURRENT_MESH


def check_prover_device(mesh: RowMesh, device) -> None:
    """Raise unless `device` is the mesh's first device (where the prover's
    unsharded work and the gathers run)."""
    if _normalise(device) != mesh.first:
        raise ValueError(f"the prover's device {device} is not the mesh's first device {mesh.first}")


def on(device: torch.device):
    """Make `device` the current CUDA device inside the block (kernels
    launch on the current device's stream); nothing for a CPU device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# -- row-sharded tensors -----------------------------------------------------


@dataclass
class RowSharded:
    """A tensor of `shape` split into contiguous row blocks: block k holds
    rows [k * rows, (k + 1) * rows) on mesh.devices[k].  `gather` is the
    only way back to one tensor."""

    mesh: RowMesh
    blocks: List[torch.Tensor]
    shape: Tuple[int, ...]

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        if len(self.blocks) != self.mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a mesh of {self.mesh.size}")
        for b, dev in zip(self.blocks, self.mesh.devices):
            if tuple(b.shape) != (self.rows,) + self.shape[1:] or b.device != dev:
                raise ValueError(f"block {tuple(b.shape)} on {b.device} does not fit {self.shape} "
                                 f"over {self.mesh.size} shards")

    @property
    def rows(self) -> int:
        """Rows of each block."""
        return self.shape[0] // self.mesh.size

    @property
    def device(self) -> torch.device:
        return self.mesh.first

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def reshape(self, *shape) -> "RowSharded":
        """Reshape every row block; the row count stays."""
        if shape[0] != self.shape[0]:
            raise ValueError(f"RowSharded.reshape keeps the rows: {shape} from {self.shape}")
        blocks = [b.reshape((self.rows,) + tuple(shape[1:])) for b in self.blocks]
        return RowSharded(self.mesh, blocks, (self.shape[0],) + tuple(blocks[0].shape[1:]))

    def cols(self, c0: int, c1: int) -> "RowSharded":
        """Columns [c0, c1) of a 2-D x, each shard's block made contiguous
        (the sharded `x[:, c0:c1].contiguous()`)."""
        return RowSharded(self.mesh, [b[:, c0:c1].contiguous() for b in self.blocks],
                          (self.shape[0], c1 - c0))

    def gather(self, device=None) -> torch.Tensor:
        """All rows as one tensor on `device` (the mesh's first by default),
        counted under "gather" in the collectives' bytes."""
        from . import collectives

        return collectives.gather(self, self.mesh.first if device is None else device)


def join_cols(parts: Sequence[RowSharded]) -> RowSharded:
    """Row-sharded 2-D matrices of one height side by side: each shard's
    blocks joined on dim 1 (the sharded `torch.cat(parts, dim=1)`)."""
    mesh = parts[0].mesh
    blocks = [torch.cat([p.blocks[k] for p in parts], dim=1) for k in range(mesh.size)]
    return RowSharded(mesh, blocks, (parts[0].shape[0], sum(p.shape[1] for p in parts)))


def place_rows(t):
    """Place `t` row-sharded over the active mesh (unchanged without one):
    contiguous row blocks, block k copied to device k.  A height that is
    not a power of two divisible by the mesh size means a misconfiguration,
    so it RAISES; it never replicates."""
    mesh = CURRENT_MESH
    if mesh is None:
        return t
    from . import collectives

    return collectives.scatter(t, mesh)


def shard_fraction(x) -> float:
    """Share of `x` that one shard stores (1.0 for one tensor), counted per
    distinct block: a row-sharded intermediate on an n-shard mesh gives 1/n."""
    if isinstance(x, RowSharded):
        total = x.numel()
        return max(b.numel() for b in x.blocks) / total if total else 0.0
    return 1.0
