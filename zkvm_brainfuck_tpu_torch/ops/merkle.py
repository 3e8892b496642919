"""Merkle-tree MMCS over Poseidon2 (digest 8), p3 `MerkleTreeMmcs` semantics.

Counterpart of the JAX package's ops/merkle.py.  Commit semantics for a
batch of matrices with power-of-two heights:

- the digest layer at height H hashes, per index i, the concatenation of
  row i of every matrix of height H (in batch order) with one padding-free
  sponge (`poseidon2.hash_rows`);
- going up, `compress(left, right)` combines children, and when a layer's
  size matches some matrices' height, their row hash is folded in with an
  extra compress (p3's compress-and-inject).

Every level lives in one flat (L, 8) int32 buffer at host-planned offsets
(`TreePlan`), as in the JAX package, so the sibling index math is shared
with it.  `build_tree` walks the whole tree, compress-and-inject included,
in at most two launches of the `poseidon2_tree` kernels (csrc/poseidon2.cu)
on the card; `build_tree_plain`, the level loop over
`poseidon2.permute_plain`, is its plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import kernels as kn
from . import poseidon2 as p2
from .field import I32

# ---------------------------------------------------------------------------
# Host-side plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreePlan:
    """Layout of one batch signature: region 0 is the digest layer (height
    max_h); region i >= 1 holds the size-(max_h >> i) level.
    `inject_levels` marks levels whose size matches some smaller matrices'
    height (p3 compress-and-inject)."""

    heights: Tuple[int, ...]
    max_h: int
    log_max: int
    level_off: Tuple[int, ...]
    flat_len: int
    inject_levels: Tuple[Tuple[int, int], ...]


@lru_cache(maxsize=None)
def make_plan(heights: Tuple[int, ...]) -> TreePlan:
    max_h = max(heights)
    log_max = max_h.bit_length() - 1
    inject_sizes = {h for h in heights if h != max_h}

    level_off = [0]
    off = max_h
    inject_levels: List[Tuple[int, int]] = []
    for i in range(1, log_max + 1):
        level_off.append(off)
        off += max_h >> i
        if (max_h >> i) in inject_sizes:
            inject_levels.append((i, max_h >> i))

    return TreePlan(
        heights=tuple(heights),
        max_h=max_h,
        log_max=log_max,
        level_off=tuple(level_off),
        flat_len=off,
        inject_levels=tuple(inject_levels),
    )


# ---------------------------------------------------------------------------
# Digest layers and the tree walk
# ---------------------------------------------------------------------------


def sponge_rows(mats: Sequence[torch.Tensor], bitrev: bool = False) -> torch.Tensor:
    """PaddingFreeSponge 16/8/8 over the row concatenation of same-height
    matrices: (H, W_total) -> (H, 8).  With `bitrev`, digest i hashes row
    rev(i) (the committed order of a PCS LDE, JAX ops/merkle.py:466)."""
    return p2.hash_rows(list(mats), bitrev=bitrev)


def _check_digests(plan: TreePlan, digests_by_height: Dict[int, torch.Tensor]) -> None:
    """Raise unless every layer the walk reads is an (h, 8) int32 tensor on
    one device: the digest layer at max_h and each injected height."""
    need = [plan.max_h] + [h for _lvl, h in plan.inject_levels]
    top = digests_by_height.get(plan.max_h)
    for h in need:
        d = digests_by_height.get(h)
        if d is None:
            raise ValueError(f"build_tree: no digest layer of height {h}")
        if d.dim() != 2 or tuple(d.shape) != (h, 8) or d.dtype != I32:
            raise ValueError(f"build_tree: the height-{h} layer must be ({h}, 8) int32, got "
                             f"{tuple(d.shape)} {d.dtype}")
        if d.device != top.device:
            raise ValueError("build_tree: digest layers on different devices")


def build_tree_plain(plan: TreePlan, digests_by_height: Dict[int, torch.Tensor]) -> torch.Tensor:
    """Plain version of `build_tree`: one batch permutation per level, and
    one more per compress-and-inject level."""
    inject = dict(plan.inject_levels)
    top = digests_by_height[plan.max_h]
    flat = torch.empty((plan.flat_len, 8), dtype=I32, device=top.device)
    flat[: plan.max_h] = top
    prev = top
    for i in range(1, plan.log_max + 1):
        s = plan.max_h >> i
        out = p2.permute_plain(prev.reshape(s, 16))[:, :8]
        if i in inject:
            out = p2.permute_plain(torch.cat([out, digests_by_height[inject[i]]], dim=1))[:, :8]
        flat[plan.level_off[i] : plan.level_off[i] + s] = out
        prev = out
    return flat


def build_tree(plan: TreePlan, digests_by_height: Dict[int, torch.Tensor]) -> torch.Tensor:
    """Flat level buffer from per-height digest layers (committed order).
    The root lives at row plan.level_off[plan.log_max].  On the card, the
    `poseidon2_tree` kernel pair (at most two launches)."""
    _check_digests(plan, digests_by_height)
    top = digests_by_height[plan.max_h]
    if not top.is_cuda:
        return build_tree_plain(plan, digests_by_height)
    layers = [top] + [digests_by_height[h] for _lvl, h in plan.inject_levels]
    for d in layers:
        kn.require_cuda_int32(d, "build_tree")
    inject = dict(plan.inject_levels)
    flat = torch.empty((plan.flat_len, 8), dtype=I32, device=top.device)
    n_counters = (plan.max_h >> 13) + 8
    counters = torch.empty(n_counters, dtype=I32, device=top.device)
    offs = (ctypes.c_longlong * (plan.log_max + 1))(*plan.level_off)
    ptrs = (ctypes.c_void_p * (plan.log_max + 1))(
        *[digests_by_height[inject[i]].data_ptr() if i in inject else None
          for i in range(plan.log_max + 1)])
    kn.check(
        kn.lib("poseidon2.cu", top.device).zkbf_p2_tree(
            top.data_ptr(), flat.data_ptr(), counters.data_ptr(), n_counters,
            ctypes.addressof(offs), ctypes.addressof(ptrs), plan.log_max, kn.stream(top.device),
        ),
        "poseidon2_tree",
    )
    kn.COUNTS["poseidon2_tree"] += 1
    return flat


def root_of(plan: TreePlan, flat: torch.Tensor) -> np.ndarray:
    """(8,) canonical root row, on the host (uint32)."""
    return flat[plan.level_off[plan.log_max]].cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# Prover-side tree object
# ---------------------------------------------------------------------------


@dataclass
class MerkleTree:
    matrices: List[torch.Tensor]  # original order
    plan: TreePlan
    flat: torch.Tensor  # digest layer + all levels
    root: np.ndarray  # (8,) canonical uint32 (host)
    # True when committed row i is matrices[k][bit_reverse(i)] (PCS LDEs are
    # kept in natural order; the reversal is resolved at open time).
    bitrev: bool = False

    @property
    def max_height(self) -> int:
        return self.plan.max_h


def commit(matrices: Sequence[torch.Tensor], bitrev: bool = False) -> MerkleTree:
    """Commit to a batch of (H_i, W_i) matrices (H_i powers of two)."""
    assert matrices, "empty batch"
    heights = tuple(int(m.shape[0]) for m in matrices)
    for h in heights:
        assert h & (h - 1) == 0, "heights must be powers of two"
    plan = make_plan(heights)
    by_height: Dict[int, list] = {}
    for m in matrices:
        by_height.setdefault(int(m.shape[0]), []).append(m)
    digests = {h: sponge_rows(ms, bitrev) for h, ms in by_height.items()}
    flat = build_tree(plan, digests)
    return MerkleTree(
        matrices=list(matrices), plan=plan, flat=flat, root=root_of(plan, flat), bitrev=bitrev
    )


# ---------------------------------------------------------------------------
# Openings
# ---------------------------------------------------------------------------


def sibling_flat_indices(plan: TreePlan, indices: np.ndarray) -> np.ndarray:
    """Host: flat-buffer row index of the sibling at every level, (Q, log_max)."""
    q = len(indices)
    out = np.empty((q, plan.log_max), dtype=np.int64)
    idx = np.array(indices, np.int64)
    for level in range(plan.log_max):
        out[:, level] = plan.level_off[level] + (idx ^ 1)
        idx >>= 1
    return out


def open_batch(tree: MerkleTree, indices: np.ndarray):
    """Rows per matrix (Q, W_m) and sibling paths (Q, log_max, 8) for the
    leaf `indices`, as host uint32 arrays."""
    return open_many([tree], [indices])[0]


def open_many(trees: Sequence[MerkleTree], indices_list):
    """Openings of many trees: one index_select per matrix and per tree
    flat buffer (a row-sharded tree gathers its pieces from the shards that
    own them), then ONE host transfer of all pieces.  Returns, per tree,
    (rows per matrix (Q, W_m), paths (Q, log_max, 8)) as host uint32."""
    from . import ntt as nt

    pieces: List[torch.Tensor] = []
    plan_counts = []
    for tree, indices in zip(trees, indices_list):
        indices = np.asarray(indices, np.int64)
        if not isinstance(tree, MerkleTree):
            # a row-sharded tree (parallel/sharded.py ShardedMerkleTree)
            pieces.extend(tree.query_pieces(indices))
            plan_counts.append(len(tree.matrices))
            continue
        plan = tree.plan
        for m in tree.matrices:
            log_h = int(m.shape[0]).bit_length() - 1
            r = indices >> (plan.log_max - log_h)
            if tree.bitrev:
                r = nt.reverse_bits(r, log_h)
            pieces.append(m.index_select(0, torch.as_tensor(r, device=m.device)))
        if plan.log_max > 0:
            sibs = sibling_flat_indices(plan, indices)
            path = tree.flat.index_select(0, torch.as_tensor(sibs.reshape(-1), device=tree.flat.device))
            pieces.append(path.reshape(len(indices), plan.log_max, 8))
        else:
            pieces.append(torch.zeros((len(indices), 0, 8), dtype=I32, device=tree.flat.device))
        plan_counts.append(len(tree.matrices))
    flat = torch.cat([p.reshape(-1) for p in pieces]).cpu().numpy().astype(np.uint32)
    bounds = np.cumsum([p.numel() for p in pieces])[:-1]
    host = [a.reshape(p.shape) for a, p in zip(np.split(flat, bounds), pieces)]
    out = []
    off = 0
    for n_mats in plan_counts:
        out.append((host[off : off + n_mats], host[off + n_mats]))
        off += n_mats + 1
    return out


def verify_batch_np(
    root,
    dims: Sequence[tuple],
    indices: np.ndarray,
    opened_rows: Sequence[np.ndarray],
    proofs: np.ndarray,
) -> np.ndarray:
    """Vectorized host-side batch-opening check over ALL queries at once.

    dims: per matrix (height, width).  indices: (Q,) leaf indices.
    opened_rows[m]: (Q, W_m) canonical values for matrix m.
    proofs: (Q, log_max, 8) sibling digests, leaf-to-root order.
    Returns a (Q,) bool array (True = path checks out against `root`).
    """
    heights = [h for h, _ in dims]
    max_h = max(heights)
    log_max = max_h.bit_length() - 1

    by_height: dict = {}
    for (h, _w), rows in zip(dims, opened_rows):
        by_height.setdefault(h, []).append(np.asarray(rows, dtype=np.uint64))

    curr = p2.hash_np(np.concatenate(by_height[max_h], axis=1))  # (Q, 8)
    idx = np.asarray(indices, dtype=np.int64).copy()
    proofs = np.asarray(proofs, dtype=np.uint64)
    size = max_h
    for level in range(log_max):
        sib = proofs[:, level]  # (Q, 8)
        odd = (idx & 1).astype(bool)[:, None]
        left = np.where(odd, sib, curr)
        right = np.where(odd, curr, sib)
        curr = p2.compress_np(left, right)
        idx >>= 1
        size //= 2
        if size in by_height:
            injected = p2.hash_np(np.concatenate(by_height[size], axis=1))
            curr = p2.compress_np(curr, injected)
    root_v = np.asarray([int(x) for x in root], dtype=np.uint64)
    return (curr == root_v[None, :]).all(axis=1)

