"""Collectives over a row mesh, as explicit device-to-device copies.

Each function takes the per-shard blocks of one value (block k on
mesh.devices[k]) and returns the per-shard results, with the semantics of
the `jax.lax` collective of the same name inside `shard_map`:

- `all_gather(mesh, blocks)`: every shard gets the (d, ...) stack of all
  blocks;
- `all_to_all(mesh, blocks)`: block k is (d, ...); chunk j goes to shard j,
  which stacks what it receives in source order (split and concat on axis
  0, untiled);
- `ppermute(mesh, blocks, pairs)`: (source, destination) pairs; a shard
  that receives nothing gets zeros;
- `psum(mesh, blocks)`: the mod-p sum of all blocks, on every shard.

`gather`, `scatter` and `gather_rows` are the named moves between one
tensor and a `RowSharded`; `reshard` moves row blocks between shards.
`BYTES[kind]` counts the bytes each kind moves between two different
shards (what would cross between cards on a mesh of cards; on a virtual
mesh the copies stay on one card).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import field as xf
from .mesh import RowMesh, RowSharded

KINDS = ("all_gather", "all_to_all", "ppermute", "psum", "gather", "scatter", "reshard")
BYTES: Dict[str, int] = {k: 0 for k in KINDS}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def move(t: torch.Tensor, src: int, dst: int, mesh: RowMesh, kind: str) -> torch.Tensor:
    """Shard src's tensor t on shard dst's device; counted when src != dst."""
    if src != dst:
        BYTES[kind] += t.numel() * t.element_size()
    return t.to(mesh.devices[dst], non_blocking=True)


def all_gather(mesh: RowMesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.stack([move(b, k, j, mesh, "all_gather") for k, b in enumerate(blocks)])
            for j in range(mesh.size)]


def all_to_all(mesh: RowMesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    d = mesh.size
    for b in blocks:
        if b.shape[0] != d:
            raise ValueError(f"all_to_all: blocks must split into {d} chunks, got {tuple(b.shape)}")
    return [torch.stack([move(b[j], k, j, mesh, "all_to_all") for k, b in enumerate(blocks)])
            for j in range(d)]


def ppermute(mesh: RowMesh, blocks: Sequence[torch.Tensor],
             pairs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    out = [torch.zeros_like(b) for b in blocks]
    for src, dst in pairs:
        out[dst] = move(blocks[src], src, dst, mesh, "ppermute")
    return out


def psum(mesh: RowMesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Mod-p sum of canonical blocks, reduced on shard 0 and sent back."""
    total = blocks[0].to(torch.int64)
    for k in range(1, mesh.size):
        total = total + move(blocks[k], k, 0, mesh, "psum").to(torch.int64)
    total = (total % xf.P).to(torch.int32)
    return [move(total, 0, j, mesh, "psum") for j in range(mesh.size)]


def ring_next(mesh: RowMesh) -> List[Tuple[int, int]]:
    """ppermute pairs that give shard i what shard i+1 holds (the last
    shard gets shard 0's)."""
    d = mesh.size
    return [((i + 1) % d, i) for i in range(d)]


# -- named moves between one tensor and a RowSharded ------------------------


def gather(x: RowSharded, device) -> torch.Tensor:
    """All rows of x on one device (its shard index is found in the mesh,
    0 for a device outside it)."""
    device = torch.device(device)
    dst = next((j for j, d in enumerate(x.mesh.devices) if d == device), 0)
    parts = []
    for k, b in enumerate(x.blocks):
        if k != dst:
            BYTES["gather"] += b.numel() * b.element_size()
        parts.append(b.to(device, non_blocking=True))
    return torch.cat(parts)


def scatter(t: torch.Tensor, mesh: RowMesh) -> RowSharded:
    """Contiguous row blocks of t (on the mesh's first device), block k
    copied to shard k; raises unless the height is a power of two that the
    mesh size divides (every committed height is a power of two)."""
    n = int(t.shape[0])
    d = mesh.size
    if n % d or n & (n - 1):
        raise ValueError(f"trace height {n} not divisible by mesh size {d} into power-of-two "
                         "blocks; row sharding requires power-of-two heights and meshes <= 16 "
                         "(make_row_mesh)")
    h = n // d
    blocks = []
    for k, dev in enumerate(mesh.devices):
        if k:
            BYTES["scatter"] += h * t[0:1].numel() * t.element_size()
        blocks.append(t[k * h:(k + 1) * h].to(dev, copy=True))
    return RowSharded(mesh, blocks, tuple(t.shape))


def reshard_pad(x: RowSharded, log_blowup: int) -> RowSharded:
    """x followed by zero rows up to (rows << log_blowup), row-sharded: new
    block j joins old blocks j*2^b .. (j+1)*2^b - 1 (those that exist) and
    zero rows after them."""
    mesh, d, f = x.mesh, x.mesh.size, 1 << log_blowup
    blocks = []
    for j, dev in enumerate(mesh.devices):
        parts = [move(x.blocks[k], k, j, mesh, "reshard") for k in range(j * f, min((j + 1) * f, d))]
        zero_rows = x.rows * (f - len(parts))
        if zero_rows:
            parts.append(torch.zeros((zero_rows,) + x.shape[1:], dtype=x.dtype, device=dev))
        blocks.append(torch.cat(parts))
    return RowSharded(mesh, blocks, (x.shape[0] * f,) + x.shape[1:])


def gather_rows(mesh: RowMesh, blocks: Sequence[torch.Tensor], shard: np.ndarray,
                local: np.ndarray) -> torch.Tensor:
    """Rows blocks[shard[q]][local[q]] for every q, stacked in q order on
    the mesh's first device (counted under "gather")."""
    shard = np.asarray(shard, np.int64)
    local = np.asarray(local, np.int64)
    first = mesh.first
    if not len(shard):
        return blocks[0].new_empty((0,) + tuple(blocks[0].shape[1:])).to(first)
    parts, order = [], []
    for k in np.unique(shard):
        sel = np.nonzero(shard == k)[0]
        idx = torch.as_tensor(local[sel], device=blocks[k].device)
        parts.append(move(blocks[k].index_select(0, idx), int(k), 0, mesh, "gather"))
        order.append(sel)
    got = torch.cat(parts)
    inv = np.empty(len(shard), np.int64)
    inv[np.concatenate(order)] = np.arange(len(shard))
    return got.index_select(0, torch.as_tensor(inv, device=first))
