"""Merkle-tree MMCS over Poseidon2 (digest 8), p3 `MerkleTreeMmcs`
semantics, on the host: the batch-opening check of the port's verifier (a
frozen copy) and the whole tree over digest layers, for the preprocessed
commitment.  The digest layer at height H hashes, per index i, the
concatenation of row i of every matrix of height H (in batch order);
going up, `compress(left, right)` combines children, and where a layer's
size matches some matrices' height their row hash is folded in with an
extra compress (compress-and-inject).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from . import poseidon2 as p2


def reverse_bits(idx, log_n: int) -> np.ndarray:
    """The low log_n bits of each index reversed."""
    idx = np.asarray(idx, np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def root_np(digests_by_height: Dict[int, np.ndarray]) -> np.ndarray:
    """(8,) root over per-height digest layers (committed order)."""
    max_h = max(digests_by_height)
    cur = np.asarray(digests_by_height[max_h], dtype=np.uint64)
    size = max_h
    while size > 1:
        cur = p2.compress_np(cur[0::2], cur[1::2])
        size //= 2
        if size in digests_by_height and size != max_h:
            cur = p2.compress_np(cur, np.asarray(digests_by_height[size], dtype=np.uint64))
    return cur[0]


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

