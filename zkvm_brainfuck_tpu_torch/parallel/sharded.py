"""Row-sharded proving over a mesh: the 4-step NTT, the LDE, the Merkle
commit, LogUp offsets, and the demo step.

Counterpart of the JAX package's parallel/sharded.py, in canonical int32
like the rest of the port.  Every function takes `RowSharded` values (row
block k on mesh.devices[k]) and cooperates through the explicit
collectives of `parallel/collectives.py`:

- `sharded_ntt`: the 4-step NTT (three all_to_alls); its local size-m
  transform is the port's two NTT kernels on each shard
  (`local_transform`), the size-d DFT and the twiddle are eager torch.
- `sharded_coset_lde`: the prover's LDE on a mesh: sharded iNTT, the
  n^-1 * shift^i scale on each shard's rows, zero rows (`reshard_pad`), a
  sharded NTT; below n = d^2 a named gather, the single-device LDE, and a
  scatter.  `sharded_lde_blocks` runs it a column block.
- `sharded_digest_layer` + `build_sharded_tree` (`ShardedMerkleTree`): the
  bit-reversed digest layer routed by one all_to_all into contiguous leaf
  ranges, one subtree walk a shard, the top log2(d) levels on the first
  device.
- `logup_trace_sharded`: the fused LogUp kernel on each shard, then the
  exclusive prefix of the earlier shards' cumulative sums added to the
  running-sum column; `logup_phi_sharded` is the JAX-shaped version over
  entries and row sums.
- `sharded_prove_step`: a Merkle root, a LogUp-style sum and a ppermute
  halo in one step (the function the JAX package's multi-chip dry run
  compiles).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import ext as xe
from ..ops import field as xf
from ..ops import logup as lu
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops import poseidon2 as p2
from ..ops.field import I32, I64, P
from . import collectives as co
from .mesh import RowMesh, RowSharded, on


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"{n} is not a power of two")
    return log_n


def _rev_index(d: int, device) -> torch.Tensor:
    return torch.as_tensor(nt.reverse_bits(np.arange(d), _log2(d)), device=device)


# ---------------------------------------------------------------------------
# The 4-step NTT
# ---------------------------------------------------------------------------


def _root(log_n: int, inverse: bool) -> int:
    w = xf.two_adic_root(log_n)
    return pow(w, P - 2, P) if inverse else w


@lru_cache(maxsize=None)
def _dft_matrix(log_n: int, inverse: bool, d: int, device: torch.device) -> torch.Tensor:
    """(d, d) int64 V[q', p] = w_d^(p q'), w_d = w_n^(n/d)."""
    w_d = pow(_root(log_n, inverse), (1 << log_n) // d, P)
    v = [[pow(w_d, p * q, P) for p in range(d)] for q in range(d)]
    return torch.tensor(v, dtype=I64, device=device)


@lru_cache(maxsize=None)
def _twiddles(log_n: int, inverse: bool, d: int, q: int, device: torch.device) -> torch.Tensor:
    """(d, mc) int64 T[q', u] = w_n^((q*mc + u) * q') for shard q's t-chunk."""
    w_n = _root(log_n, inverse)
    mc = (1 << log_n) // (d * d)
    rows = [xf.fmul(xf.powers_dev(pow(w_n, qp, P), mc, device), pow(w_n, q * mc * qp, P))
            for qp in range(d)]
    return torch.stack(rows).to(I64)


def _dft_twiddle(a: torch.Tensor, log_n: int, inverse: bool, q: int) -> torch.Tensor:
    """Steps 2-3 on shard q: a (d=p, mc, w) -> z[q'] = T[q'] * sum_p V[q', p] a[p]."""
    d, mc, w = a.shape
    v = _dft_matrix(log_n, inverse, d, a.device)
    tw = _twiddles(log_n, inverse, d, q, a.device)
    a64 = a.to(I64)
    z = torch.empty((d, mc, w), dtype=I32, device=a.device)
    for qp in range(d):
        s = ((a64 * v[qp][:, None, None]) % P).sum(0) % P
        z[qp] = (s * tw[qp][:, None]) % P
    return z


def local_transform(z: torch.Tensor, log_m: int, inverse: bool, shard: int) -> torch.Tensor:
    """Step 5 on one shard: the size-m NTT of its (m, W) block (the inverse
    without m^-1), through ntt_block_stages and ntt_stage."""
    return nt.transform(z, log_m, inverse)


def four_step(x: RowSharded, inverse: bool) -> RowSharded:
    """The 2^log_n-point NTT down the rows of x (the inverse without n^-1),
    natural order in and out, row-sharded; needs n >= d^2.

    With i = p*m + t and j = q' + d*r' (m = n/d, w = w_n):
        F[q' + d r'] = sum_t w_m^(t r') * [w_n^(t q') * sum_p x[p m + t] w_d^(p q')]
    1. all_to_all: shard q gets its t-chunk of every p;
    2. the size-d DFT over p; 3. the twiddle w_n^(t q');
    4. all_to_all: shard q' gets every t of its q';
    5. the size-m NTT over t (`local_transform`);
    6. all_to_all + interleave: output j = q' + d r' to contiguous rows."""
    mesh, d = x.mesh, x.mesh.size
    n = x.shape[0]
    log_n = _log2(n)
    m = n // d
    if n < d * d:
        raise ValueError(f"four_step: {n} rows over {d} shards (needs n >= d^2)")
    mc = m // d
    w = x.numel() // n
    a = co.all_to_all(mesh, [b.reshape(d, mc, w) for b in x.blocks])
    z = []
    for q, (aq, dev) in enumerate(zip(a, mesh.devices)):
        with on(dev):
            z.append(_dft_twiddle(aq, log_n, inverse, q))
    z = co.all_to_all(mesh, z)
    f = []
    for q, (zq, dev) in enumerate(zip(z, mesh.devices)):
        with on(dev):
            f.append(local_transform(zq.reshape(m, w), log_n - _log2(d), inverse, q).reshape(d, mc, w))
    f = co.all_to_all(mesh, f)
    blocks = [b.transpose(0, 1).reshape((m,) + x.shape[1:]) for b in f]
    return RowSharded(mesh, blocks, x.shape)


def sharded_ntt(mesh: RowMesh, x: RowSharded, inverse: bool = False) -> RowSharded:
    """NTT down the rows of the row-sharded (n, W) x, natural order in and
    out; the inverse includes n^-1 (the JAX package's sharded_ntt).  Needs
    n >= d^2 (d <= m)."""
    if x.mesh != mesh:
        raise ValueError("sharded_ntt: x is not sharded over this mesh")
    out = four_step(x, inverse)
    if inverse:
        n_inv = pow(x.shape[0], P - 2, P)
        out = RowSharded(mesh, [xf.fmul(b, n_inv) for b in out.blocks], out.shape)
    return out


@lru_cache(maxsize=None)
def _row_factors(log_n: int, shift: int, row0: int, rows: int, device: torch.device) -> torch.Tensor:
    """(rows, 1) n^-1 * shift^i for the rows i in [row0, row0 + rows)."""
    first = pow(1 << log_n, P - 2, P) * pow(shift, row0, P) % P
    return xf.fmul(xf.powers_dev(shift, rows, device), first)[:, None]


def sharded_coset_lde(x: RowSharded, log_blowup: int, shift: int) -> RowSharded:
    """ops/ntt.py coset_lde on a mesh: evaluations over H_n ->
    evaluations over shift*H_{n<<b}, natural order, row-sharded.  Below
    n = d^2 the evaluations are gathered to the first device, extended
    there and scattered back (counted)."""
    mesh, d = x.mesh, x.mesh.size
    n = x.shape[0]
    if n < d * d:
        with on(mesh.first):
            full = nt.coset_lde(x.gather(mesh.first), log_blowup, shift)
        return co.scatter(full, mesh)
    log_n = _log2(n)
    c = four_step(x, inverse=True)
    scaled = [xf.fmul(b, _row_factors(log_n, shift % P, k * c.rows, c.rows, b.device))
              for k, b in enumerate(c.blocks)]
    padded = co.reshard_pad(RowSharded(mesh, scaled, c.shape), log_blowup)
    return four_step(padded, inverse=False)


def sharded_lde_blocks(x: RowSharded, spans: Sequence[tuple], log_blowup: int,
                       shift: int) -> List[RowSharded]:
    """The column-blocked LDE on a mesh: one `sharded_coset_lde` of each
    column span [c0, c1) of x, in span order (stark/pcs.py `_lde_spans`)."""
    return [sharded_coset_lde(x.cols(c0, c1), log_blowup, shift) for c0, c1 in spans]


# ---------------------------------------------------------------------------
# Merkle commit over a mesh
# ---------------------------------------------------------------------------


def sharded_digest_layer(mats: Sequence[RowSharded]) -> RowSharded:
    """The committed (bit-reversed) digest layer of same-height row-sharded
    matrices, in contiguous leaf ranges.  Shard k hashes its own rows in
    local bit-reversed order (poseidon2_hash_rows): local digest s' is row
    k*h + rev(s'), which is global leaf s'*d + rev(k).  So chunk c of shard
    k's digests belongs to leaf shard c: one all_to_all of 8 words a row,
    then an interleave.  With fewer rows a shard than shards the layer is
    assembled on the first device (a named gather) and scattered."""
    mesh, d = mats[0].mesh, mats[0].mesh.size
    big = mats[0].shape[0]
    h = big // d
    local = []
    for k, dev in enumerate(mesh.devices):
        with on(dev):
            local.append(p2.hash_rows([m.blocks[k] for m in mats], bitrev=True))
    if h >= d:
        recv = co.all_to_all(mesh, [dg.reshape(d, h // d, 8) for dg in local])
        blocks = [r.index_select(0, _rev_index(d, r.device)).transpose(0, 1).reshape(h, 8)
                  for r in recv]
        return RowSharded(mesh, blocks, (big, 8))
    parts = torch.stack([co.move(dg, k, 0, mesh, "gather") for k, dg in enumerate(local)])
    layer = parts.index_select(0, _rev_index(d, mesh.first)).transpose(0, 1).reshape(big, 8)
    return co.scatter(layer, mesh)


@dataclass
class ShardedMerkleTree:
    """A commit's tree over a mesh: shard k holds the subtree of leaves
    [k*h, (k+1)*h) of every level below the top log2(d) (`flats[k]`, laid
    out by `local_plan`); the top levels are on the first device
    (`top_flat`, laid out by `top_plan`).  `plan` is the global layout,
    which `gather_flat` reproduces."""

    matrices: List[RowSharded]
    plan: mk.TreePlan
    local_plan: mk.TreePlan
    flats: List[torch.Tensor]
    top_plan: mk.TreePlan
    top_flat: torch.Tensor
    root: np.ndarray
    bitrev: bool = True

    @property
    def mesh(self) -> RowMesh:
        return self.matrices[0].mesh

    @property
    def digests(self) -> RowSharded:
        """The digest layer (leaves), row-sharded."""
        h = self.local_plan.max_h
        return RowSharded(self.mesh, [f[:h] for f in self.flats], (self.plan.max_h, 8))

    def gather_flat(self, device=None) -> torch.Tensor:
        """The single-device flat buffer (`plan` layout) on one device,
        counted under "gather"."""
        mesh, lp = self.mesh, self.local_plan
        device = mesh.first if device is None else torch.device(device)
        parts = []
        for i in range(lp.log_max):
            size = lp.max_h >> i
            for k, fl in enumerate(self.flats):
                piece = fl[lp.level_off[i]:lp.level_off[i] + size]
                if k:
                    co.BYTES["gather"] += piece.numel() * piece.element_size()
                parts.append(piece.to(device))
        tp = self.top_plan
        for i in range(tp.log_max + 1):
            parts.append(self.top_flat[tp.level_off[i]:tp.level_off[i] + (tp.max_h >> i)].to(device))
        return torch.cat(parts)

    def query_pieces(self, indices: np.ndarray) -> List[torch.Tensor]:
        """ops/merkle.py open_many's pieces, on the first device: each
        matrix's rows at the leaf `indices` from the shards that own them,
        then the (Q, log_max, 8) sibling paths (subtree levels from each
        query's shard, the top levels from the first device)."""
        mesh, lp, tp = self.mesh, self.local_plan, self.top_plan
        idx = np.asarray(indices, np.int64)
        big = self.plan.log_max
        pieces = []
        for m in self.matrices:
            log_h = _log2(m.shape[0])
            r = idx >> (big - log_h)
            if self.bitrev:
                r = nt.reverse_bits(r, log_h)
            pieces.append(co.gather_rows(mesh, m.blocks, r // m.rows, r % m.rows))
        lh = lp.log_max
        shard = np.repeat((idx >> lh)[:, None], lh, axis=1)
        local = np.empty((len(idx), lh), np.int64)
        for lvl in range(lh):
            local[:, lvl] = lp.level_off[lvl] + (((idx >> lvl) ^ 1) & ((lp.max_h >> lvl) - 1))
        paths = [co.gather_rows(mesh, self.flats, shard.reshape(-1), local.reshape(-1))
                 .reshape(len(idx), lh, 8)]
        top = np.empty((len(idx), tp.log_max), np.int64)
        for lvl in range(tp.log_max):
            top[:, lvl] = tp.level_off[lvl] + ((idx >> (lh + lvl)) ^ 1)
        paths.append(self.top_flat.index_select(0, torch.as_tensor(top.reshape(-1), device=mesh.first))
                     .reshape(len(idx), tp.log_max, 8))
        pieces.append(torch.cat(paths, dim=1))
        return pieces


def build_sharded_tree(plan: mk.TreePlan, digests: Dict[int, RowSharded],
                       matrices: List[RowSharded]) -> ShardedMerkleTree:
    """One `build_tree` walk a shard over its leaf range (compress-and-inject
    included: an injected layer's shard k holds the same subtree range),
    the d subtree roots gathered to the first device and walked to the
    root there.  The root equals the single-device tree's."""
    layer = digests[plan.max_h]
    mesh, d = layer.mesh, layer.mesh.size
    for hh in plan.heights:
        if hh % d:
            raise ValueError(f"build_sharded_tree: height {hh} over {d} shards")
    local_plan = mk.make_plan(tuple(hh // d for hh in plan.heights))
    flats = []
    for k, dev in enumerate(mesh.devices):
        with on(dev):
            flats.append(mk.build_tree(local_plan, {hh // d: dg.blocks[k] for hh, dg in digests.items()}))
    top_row = local_plan.level_off[local_plan.log_max]
    tops = torch.cat([co.move(fl[top_row:top_row + 1], k, 0, mesh, "gather")
                      for k, fl in enumerate(flats)])
    top_plan = mk.make_plan((d,))
    with on(mesh.first):
        top_flat = mk.build_tree(top_plan, {d: tops})
    return ShardedMerkleTree(matrices=list(matrices), plan=plan, local_plan=local_plan,
                             flats=flats, top_plan=top_plan, top_flat=top_flat,
                             root=mk.root_of(top_plan, top_flat))


# ---------------------------------------------------------------------------
# LogUp over a mesh
# ---------------------------------------------------------------------------


def _exclusive_offsets(mesh: RowMesh, totals: Sequence[torch.Tensor]):
    """Per shard, the mod-p sum of the earlier shards' (4,) totals; and the
    sum of all of them on the first shard."""
    gathered = co.all_gather(mesh, totals)
    offsets = [xf.fsum_small(g[:k], axis=0) for k, g in enumerate(gathered)]
    return offsets, xf.fsum_small(gathered[0], axis=0)


def logup_phi_sharded(mesh: RowMesh, ents: RowSharded, rss: RowSharded):
    """The LogUp running sum over a mesh (JAX semantics): ents (N, NB, 4) and
    row sums rss (N, 4), canonical, row-sharded.  Returns (perm (N, NB+1, 4)
    row-sharded with phi in column NB, cumulative sum (4,) on the first
    device): a local inclusive scan, plus the exclusive prefix of the
    earlier shards' totals."""
    local = [((r.to(I64).cumsum(0)) % P).to(I32) for r in rss.blocks]
    offsets, csum = _exclusive_offsets(mesh, [s[-1] for s in local])
    blocks = [torch.cat([e, xf.fadd(s, o[None, :])[:, None, :]], dim=1)
              for e, s, o in zip(ents.blocks, local, offsets)]
    return RowSharded(mesh, blocks, (ents.shape[0], ents.shape[1] + 1, 4)), csum


def logup_trace_sharded(table: lu.LogupTable, main: RowSharded, prep: Optional[RowSharded],
                        chal: Callable[[torch.device], torch.Tensor]):
    """ops/logup.py logup_trace on a mesh: the fused kernel on each shard's
    rows (chal(device) gives the challenge matrix on a shard's device),
    then the earlier shards' cumulative sums added to column NB.  Returns
    (perm row-sharded, cumulative sum (4,) on the first device)."""
    mesh = main.mesh
    perms, totals = [], []
    for k, dev in enumerate(mesh.devices):
        with on(dev):
            perm, csum = lu.logup_trace(table, main.blocks[k],
                                        None if prep is None else prep.blocks[k], chal(dev))
        perms.append(perm)
        totals.append(csum)
    offsets, csum = _exclusive_offsets(mesh, totals)
    for perm, off in zip(perms, offsets):
        perm[:, -1, :] = xf.fadd(perm[:, -1, :], off[None, :])
    return RowSharded(mesh, perms, (main.shape[0],) + tuple(perms[0].shape[1:])), csum


# ---------------------------------------------------------------------------
# The multi-device step of the JAX package's dry run
# ---------------------------------------------------------------------------


def _subtree_root(digests: torch.Tensor) -> torch.Tensor:
    h = digests.shape[0]
    plan = mk.make_plan((h,))
    flat = mk.build_tree(plan, {h: digests})
    return flat[plan.level_off[plan.log_max]]


def sharded_prove_step(mesh: RowMesh, trace: RowSharded, alpha, beta):
    """One multi-device step over a row-sharded (N, W) canonical trace, with
    EF4 challenges alpha, beta (4 canonical values each).  Returns (root
    (8,), cumulative sum (4,), both on the first device; transition (N,)
    row-sharded):
    - the Poseidon2 Merkle root of the rows (natural order): each shard's
      subtree root, all_gathered and walked to the root;
    - the cumulative sum of 1 / (alpha + beta * fp_i), fp_i the row's
      fingerprint (Horner in 257), by local scans plus exclusive offsets;
    - the next-row difference of column 0, with shard i+1's first row
      brought to shard i by ppermute (the last shard gets shard 0's)."""
    a = tuple(int(v) % P for v in alpha)
    b = tuple(int(v) % P for v in beta)
    roots, scans = [], []
    for blk, dev in zip(trace.blocks, mesh.devices):
        with on(dev):
            roots.append(_subtree_root(p2.hash_rows(blk)))
        fp = blk[:, 0]
        for c in range(1, blk.shape[1]):
            fp = xf.fadd(xf.fmul(fp, 257), blk[:, c])
        denom = xe.eadd(tuple(torch.full_like(fp, v) for v in a), xe.emul_base(b, fp))
        terms = xe.to_array(xe.einv(denom))
        scans.append((terms.to(I64).cumsum(0) % P).to(I32))
    tops = co.all_gather(mesh, roots)[0]
    with on(mesh.first):
        root = _subtree_root(tops)
    offsets, _total = _exclusive_offsets(mesh, [s[-1] for s in scans])
    running = [xf.fadd(s, o[None, :]) for s, o in zip(scans, offsets)]
    cumulative = co.all_gather(mesh, [r[-1] for r in running])[0][-1]
    nxt = co.ppermute(mesh, [blk[0] for blk in trace.blocks], co.ring_next(mesh))
    transition = [xf.fsub(torch.cat([blk[1:, 0], n[:1]]), blk[:, 0])
                  for blk, n in zip(trace.blocks, nxt)]
    return root, cumulative, RowSharded(mesh, transition, (trace.shape[0],))
