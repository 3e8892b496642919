"""Two-adic FRI polynomial commitment scheme (the reference's TwoAdicFriPcs).

Counterpart of the JAX package's stark/pcs.py:

- commit: evals over (log_n, shift) domains -> coset LDE onto
  GENERATOR*H_{2n} (blowup 2), committed in bit-reversed row order under one
  Merkle MMCS batch.  At LDE heights >= 2^ZKBF_BLK_LOG rows each matrix's
  LDE runs in blocks of ZKBF_BLK_W columns (`_lde_spans`); the digest layer
  hashes the blocks in matrix order, which is the row concatenation.
  - normal mode: the natural-order LDEs are kept (blocks joined) for the
    quotient, the openings and the queries;
  - low-memory mode (`_lowmem_for`: ZKBF_LOWMEM, or a batch whose tallest
    LDE reaches 2^ZKBF_LOWMEM_LOG rows): only the eval matrices, the tree
    plan and the root are kept.  The quotient recomputes a chip's LDE
    blocks (`PcsProverData.lde_blocks`), and the queries rebuild a round's
    blocks and tree, one round at a time.
- open: opened values evaluated barycentrically from the LDEs (normal
  rounds) or from the eval matrices on their source domains (low-memory
  rounds), one `open_eval` launch a unit (ops/openings.py); the transcript
  observes them, samples the batch-combination alpha, builds one (h, 4)
  reduced opening per height, one `ro_accum` launch a sub-unit, and runs
  FRI.  A low-memory round's part of a reduced opening is q = (g - g(z)) /
  (x - z) on the source domain (`ro_accum` writing), carried to the LDE
  domain by one 4-column LDE.  Query proofs bundle the input-batch Merkle
  openings and the FRI layer walks.
- verify: full host-side replay (numpy), copied from the JAX package.
- on a mesh (row-sharded eval matrices, `parallel/`), in every mode: the
  LDE blocks stay row-sharded (`sharded_lde_blocks`, the counterpart of
  `_ntt_dispatch`), the digest layer is routed into contiguous leaf ranges
  and each shard walks its subtree (`ShardedMerkleTree`); a low-memory
  round keeps its row-sharded evals and rebuilds the sharded blocks and
  tree at query time.  Opened values are per-shard sums (each shard's
  launch on its own device, at its own first row) added by a psum;
  reduced openings are computed per shard (a low-memory sub-unit's q on
  each shard's source rows, then one sharded 4-column LDE) and gathered
  once to the first device for FRI.

Proofs are the same bytes in every mode, with or without a mesh.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import elapsed, resolve_device
from ..ops import ext as xe
from ..ops import field as xf
from ..ops import merkle as mk
from ..ops import ntt as nt
from ..ops import openings as op
from ..ops.field import GENERATOR, I32, P
from ..parallel import collectives as co
from ..parallel.mesh import RowMesh, RowSharded, join_cols
from ..parallel.sharded import (
    build_sharded_tree,
    sharded_coset_lde,
    sharded_digest_layer,
    sharded_lde_blocks,
)
from ..utils import phases
from . import ef_host as efh
from .challenger import DuplexChallenger
from .domains import Domain
from .errors import InvalidOpeningArgument, OpeningShapeError
from .fri import FriProof, _pow_base_vec, fri_check_queries_np, fri_prove, fri_verify_transcript

LOG_BLOWUP = 1


@dataclass
class PcsProverData:
    domains: List[Domain]
    # LDE evals over GENERATOR*H_2n, natural order (RowSharded on a mesh);
    # None in low-memory mode
    ldes: Optional[List[torch.Tensor]]
    # commits bit-reversed LDE rows (a ShardedMerkleTree on a mesh); in
    # low-memory mode only the plan and the root
    tree: mk.MerkleTree
    sig: tuple  # per matrix (log_n, shift, width)
    evals: Optional[List[torch.Tensor]] = None  # kept only in low-memory mode

    @property
    def lowmem(self) -> bool:
        return self.ldes is None

    @property
    def root(self) -> np.ndarray:
        return self.tree.root

    @property
    def mesh(self) -> Optional[RowMesh]:
        """The mesh of a row-sharded round (None on one device)."""
        held = self.evals if self.lowmem else self.ldes
        return held[0].mesh if held and isinstance(held[0], RowSharded) else None

    @property
    def device(self) -> torch.device:
        return (self.evals if self.lowmem else self.ldes)[0].device

    def lde_blocks(self, i: int) -> List[torch.Tensor]:
        """Column-blocked LDE of matrix i (recomputed in low-memory mode;
        row-sharded blocks on a mesh)."""
        if not self.lowmem:
            return [self.ldes[i]]
        log_n, shift, _w = self.sig[i]
        return _lde_blocks(self.evals[i], log_n, shift)


def lde(evals: torch.Tensor, log_n: int, shift: int) -> torch.Tensor:
    """Evaluations over shift*H_n -> evaluations over GENERATOR*H_2n
    (natural order): iNTT, scale coefficient i by n^-1 * (GENERATOR/shift)^i,
    zero-pad, NTT; the scale and the padding happen inside the forward
    transform's block pass (ops/ntt.py coset_lde)."""
    assert evals.shape[0] == 1 << log_n
    return nt.coset_lde(evals, LOG_BLOWUP, _lde_shift(shift))


def _lde_shift(shift: int) -> int:
    """The coset shift that carries evaluations over shift*H_n to
    GENERATOR*H_2n."""
    return GENERATOR * pow(shift, P - 2, P) % P


def _blk_cfg() -> Tuple[int, int]:
    """(ZKBF_BLK_LOG, ZKBF_BLK_W): LDEs of at least 2^ZKBF_BLK_LOG rows run
    in blocks of ZKBF_BLK_W columns (defaults 23 and 8, as the JAX package)."""
    return int(os.environ.get("ZKBF_BLK_LOG", "23")), int(os.environ.get("ZKBF_BLK_W", "8"))


def _blocked_spans(width: int, bw: int):
    return [(c0, min(c0 + bw, width)) for c0 in range(0, width, bw)]


def _lde_spans(log_n: int, width: int):
    """Column spans of one matrix's LDE: narrow blocks at blocked heights,
    one full-width span otherwise."""
    blk_log, blk_w = _blk_cfg()
    if log_n + LOG_BLOWUP >= blk_log:
        return _blocked_spans(width, blk_w)
    return [(0, width)]


def _lowmem_for(sig: tuple) -> bool:
    """Low-memory commit mode: keep the evals, drop the LDEs and the tree's
    flat buffer.  ZKBF_LOWMEM=1 forces it on, =0 off; otherwise it is on when
    the batch's tallest LDE reaches 2^ZKBF_LOWMEM_LOG rows (default 23)."""
    env = os.environ.get("ZKBF_LOWMEM", "")
    if env == "1":
        return True
    if env == "0":
        return False
    thr = int(os.environ.get("ZKBF_LOWMEM_LOG", "23"))
    return max(ln + LOG_BLOWUP for ln, _s, _w in sig) >= thr


def _lde_blocks(evals, log_n: int, shift: int) -> list:
    """The LDE of each column span of `evals` (each span made contiguous);
    row-sharded blocks of row-sharded evals."""
    spans = _lde_spans(log_n, int(evals.shape[1]))
    if isinstance(evals, RowSharded):
        return sharded_lde_blocks(evals, spans, LOG_BLOWUP, _lde_shift(shift))
    return [lde(evals[:, c0:c1].contiguous(), log_n, shift) for c0, c1 in spans]


def _group_sigs(sig: tuple):
    """Group (index, matsig) by LDE height, preserving batch order within
    each group (the digest layer hashes same-height rows in batch order)."""
    groups: Dict[int, list] = {}
    for i, ms in enumerate(sig):
        groups.setdefault(ms[0] + LOG_BLOWUP, []).append((i, ms))
    return sorted(groups.items(), key=lambda kv: -kv[0])


def _commit_blocks(sig: tuple, evals: Sequence, keep):
    """LDE blocks and digest layers of a batch, one height group at a time;
    keep(i, blocks) receives matrix i's blocks, which are dropped after
    their group's digest layer unless it keeps them.  Row-sharded evals
    give row-sharded blocks and layers in contiguous leaf ranges.  Returns
    the tree plan and the digest layers by height."""
    digests: Dict[int, object] = {}
    for log_lde, members in _group_sigs(sig):
        group = []
        for i, (log_n, shift, _w) in members:
            blocks = _lde_blocks(evals[i], log_n, shift)
            keep(i, blocks)
            group.extend(blocks)
        if isinstance(group[0], RowSharded):
            digests[1 << log_lde] = sharded_digest_layer(group)
        else:
            digests[1 << log_lde] = mk.sponge_rows(group, bitrev=True)
        del group, blocks
    return mk.make_plan(tuple(1 << (ln + LOG_BLOWUP) for ln, _, _ in sig)), digests


def _tree(plan: mk.TreePlan, digests: Dict[int, object], matrices: list):
    """The tree over a commit's digest layers, opening `matrices`: one walk
    on one device, or a subtree walk a shard (`build_sharded_tree`) over
    row-sharded layers."""
    if isinstance(digests[plan.max_h], RowSharded):
        return build_sharded_tree(plan, digests, matrices)
    flat = mk.build_tree(plan, digests)
    return mk.MerkleTree(matrices=matrices, plan=plan, flat=flat, root=mk.root_of(plan, flat),
                         bitrev=True)


def _join_blocks(blocks: list):
    """A matrix's LDE from its column blocks."""
    if len(blocks) == 1:
        return blocks[0]
    return join_cols(blocks) if isinstance(blocks[0], RowSharded) else torch.cat(blocks, dim=1)


def pcs_commit(
    domains_and_evals: Sequence[Tuple[Domain, torch.Tensor]], device=None
) -> Tuple[np.ndarray, PcsProverData]:
    """Commit a batch of (2^log_n, W) canonical eval matrices: LDE each (in
    column blocks at blocked heights), hash each LDE-height group's
    bit-reversed rows into its digest layer, walk the tree.  In low-memory
    mode only the evals, the plan and the root are kept.  Runs on the card
    unless device="cpu"; row-sharded evals (one mesh) keep every LDE block,
    digest layer and subtree row-sharded, with the single-device root and
    LDE values."""
    device = resolve_device(device)
    domains = [d for d, _ in domains_and_evals]
    evals = [e for _, e in domains_and_evals]
    if any(isinstance(e, RowSharded) for e in evals):
        if not all(isinstance(e, RowSharded) and e.mesh == evals[0].mesh for e in evals):
            raise ValueError("pcs_commit: a batch mixes meshes or row-sharded and single-device matrices")
    else:
        evals = [xf.as_field_tensor(e, device) for e in evals]
    for d, e in zip(domains, evals):
        if e.dim() != 2 or e.shape[0] != d.size:
            raise ValueError(f"evals of shape {tuple(e.shape)} do not fit {d}")
    sig = tuple((d.log_n, d.shift, int(e.shape[1])) for d, e in zip(domains, evals))

    if _lowmem_for(sig):
        plan, digests = _commit_blocks(sig, evals, lambda i, blocks: None)
        root = _tree(plan, digests, []).root
        del digests  # the tree is rebuilt round by round at query time
        tree = mk.MerkleTree(matrices=None, plan=plan, flat=None, root=root, bitrev=True)
        return root, PcsProverData(domains=domains, ldes=None, tree=tree, sig=sig, evals=evals)

    ldes: list = [None] * len(sig)

    def keep(i, blocks):
        ldes[i] = _join_blocks(blocks)

    plan, digests = _commit_blocks(sig, evals, keep)
    tree = _tree(plan, digests, list(ldes))
    return tree.root, PcsProverData(domains=domains, ldes=ldes, tree=tree, sig=sig)


# ---------------------------------------------------------------------------
# Opening rounds (the device work is ops/openings.py)
# ---------------------------------------------------------------------------


@dataclass
class BatchOpening:
    """Input openings for one round at one query: rows per matrix + path."""

    opened_rows: List[np.ndarray]
    proof: np.ndarray


@dataclass
class PcsProof:
    fri: FriProof
    # query_input_openings[q][round] = BatchOpening
    query_input_openings: List[List[BatchOpening]]


def _open_groups(sig: tuple):
    groups: Dict[tuple, list] = {}
    for r, mats in enumerate(sig):
        for i, (log_n, _shift, _w, zis) in enumerate(mats):
            log_h = log_n + LOG_BLOWUP
            for pi, zi in enumerate(zis):
                groups.setdefault((log_h, zi), []).append((r, i, pi))
    return list(groups.items())


def _open_eval_sharded(mesh: RowMesh, mats: Sequence[RowSharded], z: tuple, log_m: int,
                       shift: int) -> torch.Tensor:
    """open_eval over row-sharded matrices: each shard's raw sums over its
    own rows (a launch on its own device), added mod p by a psum (the order
    cannot change a value)."""
    rows = (1 << log_m) // mesh.size
    parts = [op.open_eval([m.blocks[k] for m in mats], z, log_m, shift, row0=k * rows)
             for k in range(mesh.size)]
    return co.psum(mesh, parts)[0]


def _ro_plan(sig: tuple):
    """Static reduced-opening plan: (log_h, zi, members, c0, w_total) per
    (height, point) group; alpha powers are counted per (height, point)."""
    groups: Dict[tuple, list] = {}
    for r, mats in enumerate(sig):
        for i, (log_n, _shift, w, zis) in enumerate(mats):
            log_h = log_n + LOG_BLOWUP
            for pi, zi in enumerate(zis):
                groups.setdefault((log_h, zi), []).append((r, i, pi, w))
    counters: Dict[tuple, int] = {}
    plan = []
    for (log_h, zi), members in groups.items():
        w_total = sum(w for _r, _i, _pi, w in members)
        c0 = counters.get((log_h, zi), 0)
        plan.append((log_h, zi, tuple(members), c0, w_total))
        counters[(log_h, zi)] = c0 + w_total
    return plan


def _open_sig(rounds, zmap: Dict[tuple, int]) -> tuple:
    sig = []
    for data, points_per_mat in rounds:
        mats = []
        for (log_n, shift, w), pts in zip(data.sig, points_per_mat):
            zis = tuple(zmap.setdefault(z, len(zmap)) for z in pts)
            mats.append((log_n, shift, w, zis))
        sig.append(tuple(mats))
    return tuple(sig)


def _bary_factor(log_m: int, shift: int, z: tuple) -> tuple:
    """-(z^M - s^M) / (M * s^M): the host scalar completing the barycentric
    raw sums on the coset shift*H_M.  For evaluations f(x_i) on s*H_M,

        f(z) = (z^M - s^M)/(M s^M) * sum_i f(x_i) * x_i / (z - x_i);

    `open_eval` sums f(x_i) * x_i * inv(x_i - z), so the sign folds
    inv(x-z) = -inv(z-x)."""
    m = 1 << log_m
    s_m = pow(shift, m, P)
    num = efh.add_base(efh.epow(z, m), P - s_m)
    den_inv = pow(m * s_m % P, P - 2, P)
    return efh.neg(efh.mul_base(num, den_inv))


def ro_src_accum(ro, mats: Sequence[torch.Tensor], alpha_pows: torch.Tensor, s: tuple, z: tuple,
                 log_n: int, shift: int) -> torch.Tensor:
    """A low-memory sub-unit's part of a reduced opening, from its members'
    evals on the source domain shift*H_n: q = (g - S) * inv(x - z) there
    (`ro_accum` with `first`), g = sum_k alpha^k f_k and S = g(z) (an exact
    division), then ONE 4-column LDE onto GENERATOR*H_2n, added into the
    (2n, 4) reduced opening ro (None starts from zero).  The same values as
    ro_accum over the members' LDEs."""
    q = op.ro_accum(None, mats, alpha_pows, s, z, log_n, shift, first=True)
    contrib = lde(q, log_n, shift)
    return contrib if ro is None else xf.fadd(ro, contrib)


def pcs_open(
    rounds: Sequence[Tuple[PcsProverData, List[List[tuple]]]],
    challenger: DuplexChallenger,
    num_queries: int,
    pow_bits: int,
    timings: Dict[str, float] = None,
):
    """Open rounds at EF points.

    rounds: (data, points_per_matrix) where points_per_matrix[i] is the list
    of EF4 host tuples for matrix i.  Low-memory rounds (data.lowmem) are
    evaluated from their eval matrices on their source domains and rebuild
    their LDEs and tree at query time, one round at a time.  Returns
    (opened_values, PcsProof); opened_values[r][i][p] = list of EF tuples per
    column."""
    timings = {} if timings is None else timings
    t0 = time.time()
    device = rounds[0][0].device
    meshes = {data.mesh for data, _p in rounds}
    if len(meshes) != 1:
        raise ValueError("pcs_open: the rounds are not all on one mesh (or all unsharded)")
    mesh = meshes.pop()

    # 1. Opened values, barycentric, one evaluation per unit: the normal
    # members of an (LDE height, point) group on the LDE coset, and its
    # low-memory members per source domain (log_n, shift).
    zmap: Dict[tuple, int] = {}
    sig = _open_sig(rounds, zmap)
    z_by_index = {zi: z for z, zi in zmap.items()}
    units = []  # (log_m, shift, zi, members, lowmem)
    for (log_h, zi), members in _open_groups(sig):
        normal = [(r, i, pi) for r, i, pi in members if not rounds[r][0].lowmem]
        if normal:
            units.append((log_h, GENERATOR, zi, tuple(normal), False))
        by_dom: Dict[tuple, list] = {}
        for r, i, pi in members:
            if rounds[r][0].lowmem:
                log_n, shift, _w = rounds[r][0].sig[i]
                by_dom.setdefault((log_n, shift), []).append((r, i, pi))
        for (log_n, shift), ms in sorted(by_dom.items()):
            units.append((log_n, shift, zi, tuple(ms), True))
    pieces = []
    for log_m, shift, zi, members, lowmem in units:
        mats = [rounds[r][0].evals[i] if lowmem else rounds[r][0].ldes[i] for r, i, _pi in members]
        if mesh is not None:
            pieces.append(_open_eval_sharded(mesh, mats, z_by_index[zi], log_m, shift))
        else:
            pieces.append(op.open_eval(mats, z_by_index[zi], log_m, shift))
    raw = [p.cpu().numpy() for p in pieces]

    opened_values = [
        [[None] * len(pts) for pts in points_per_mat] for _, points_per_mat in rounds
    ]
    for ys_raw, (log_m, shift, zi, members, _lm) in zip(raw, units):
        factor = _bary_factor(log_m, shift, z_by_index[zi])
        off = 0
        for r, i, pi in members:
            w = rounds[r][0].sig[i][2]
            opened_values[r][i][pi] = [
                efh.mul(factor, tuple(int(x) for x in y)) for y in ys_raw[off : off + w]
            ]
            off += w
    timings["open_eval"] = time.time() - t0
    phases.add("open_eval", timings["open_eval"])
    t0 = time.time()

    # 2. Bind opened values, then sample the combination challenge.
    for round_vals in opened_values:
        for mat_vals in round_vals:
            for pt_vals in mat_vals:
                for y in pt_vals:
                    challenger.observe_slice(list(y))
    alpha = challenger.sample_ext()

    # 3. Reduced openings: one accumulation per (height, point) group, split
    # into an LDE sub-unit (normal members) and one sub-unit per source
    # domain (low-memory members), each with its members' own alpha powers
    # (offsets in member order) and its own S.  On a mesh each shard
    # accumulates its own rows; the sums are gathered once, for FRI.
    alpha_pows_host = _ef_powers_host(alpha, _total_alpha_budget(rounds))
    ro: Dict[int, object] = {}  # log_h -> (h, 4) (a list of per-shard parts on a mesh)
    for log_h, zi, members, c0, _w_total in _ro_plan(sig):
        z = z_by_index[zi]
        sub_units: Dict[tuple, list] = {}
        off = c0
        for r, i, pi, w in members:
            data = rounds[r][0]
            key = ("src",) + data.sig[i][:2] if data.lowmem else ("lde",)
            sub_units.setdefault(key, []).append((r, i, pi, w, off))
            off += w
        for key, ms in sorted(sub_units.items()):
            s = efh.ZERO
            mats, aps = [], []
            for r, i, pi, w, m_off in ms:
                for k, y in enumerate(opened_values[r][i][pi]):
                    s = efh.add(s, efh.mul(alpha_pows_host[m_off + k], y))
                aps += alpha_pows_host[m_off : m_off + w]
                data = rounds[r][0]
                mats.append(data.evals[i] if data.lowmem else data.ldes[i])
            if mesh is not None:
                if key[0] == "src":
                    ro[log_h] = _ro_src_accum_sharded(mesh, ro.get(log_h), mats, aps, s, z,
                                                      key[1], key[2])
                else:
                    ro[log_h] = _ro_accum_sharded(mesh, ro.get(log_h), mats, aps, s, z, log_h)
                continue
            aps = torch.tensor(aps, dtype=I32, device=device)
            if key[0] == "src":
                ro[log_h] = ro_src_accum(ro.get(log_h), mats, aps, s, z, key[1], key[2])
            else:
                ro[log_h] = op.ro_accum(ro.get(log_h), mats, aps, s, z, log_h, GENERATOR,
                                        first=log_h not in ro)
    if mesh is not None:
        ro = {log_h: RowSharded(mesh, parts, (1 << log_h, 4)).gather() for log_h, parts in ro.items()}
    ro = {log_h: xe.from_array(v) for log_h, v in ro.items()}  # EF planes (views) for FRI
    timings["reduced_open"] = elapsed(t0, device)
    phases.add("reduced_open", timings["reduced_open"])

    # 4. FRI.
    fri_proof, indices = fri_prove(ro, challenger, LOG_BLOWUP, num_queries, pow_bits, timings)

    # 5. Input-batch openings at the query indices: the normal rounds in one
    # gather and transfer; each low-memory round rebuilt, opened and freed
    # before the next, so at most one round's LDEs are resident.
    t0 = time.time()
    log_global = max(ro.keys())
    idx = np.asarray(indices, np.int64)
    per_round: List[Optional[tuple]] = [None] * len(rounds)
    normal_ids = [r for r, (d, _p) in enumerate(rounds) if not d.lowmem]
    if normal_ids:
        trees = [rounds[r][0].tree for r in normal_ids]
        opened = mk.open_many(trees, [idx >> (log_global - t.plan.log_max) for t in trees])
        for r, o in zip(normal_ids, opened):
            per_round[r] = o
    for r, (data, _p) in enumerate(rounds):
        if data.lowmem:
            per_round[r] = _lowmem_round_openings(data, idx, log_global)
    query_input_openings = [
        [BatchOpening(opened_rows=[rw[q] for rw in rows], proof=paths[q]) for rows, paths in per_round]
        for q in range(num_queries)
    ]
    timings["query_open"] = time.time() - t0
    phases.add("query_open", timings["query_open"])
    return opened_values, PcsProof(fri=fri_proof, query_input_openings=query_input_openings)


def _ro_accum_sharded(mesh: RowMesh, acc, mats: Sequence[RowSharded], aps: List[tuple], s: tuple,
                      z: tuple, log_h: int):
    """ro_accum on each shard's rows of the LDE coset (a launch on its own
    device); acc is the list of per-shard (rows, 4) parts (None starts from
    zero), aps the host alpha powers of the columns."""
    rows = (1 << log_h) // mesh.size
    return [op.ro_accum(None if acc is None else acc[k], [m.blocks[k] for m in mats],
                        torch.tensor(aps, dtype=I32, device=dev), s, z, log_h, GENERATOR,
                        row0=k * rows, first=acc is None)
            for k, dev in enumerate(mesh.devices)]


def _ro_src_accum_sharded(mesh: RowMesh, acc, mats: Sequence[RowSharded], aps: List[tuple],
                          s: tuple, z: tuple, log_n: int, shift: int):
    """ro_src_accum over row-sharded evals on the source domain shift*H_n:
    each shard's q = (g - S) * inv(x - z) on its own source rows, one
    sharded 4-column LDE of q onto GENERATOR*H_2n, added into the per-shard
    (rows, 4) parts acc of the LDE rows (None starts from zero)."""
    rows = (1 << log_n) // mesh.size
    q = [op.ro_accum(None, [m.blocks[k] for m in mats], torch.tensor(aps, dtype=I32, device=dev),
                     s, z, log_n, shift, row0=k * rows, first=True)
         for k, dev in enumerate(mesh.devices)]
    contrib = sharded_coset_lde(RowSharded(mesh, q, (1 << log_n, 4)), LOG_BLOWUP, _lde_shift(shift))
    return contrib.blocks if acc is None else [xf.fadd(a, c) for a, c in zip(acc, contrib.blocks)]


def _lowmem_round_openings(data: PcsProverData, idx: np.ndarray, log_global: int):
    """Rebuild one low-memory round's LDE blocks and tree (the commit's own
    steps; row-sharded on a mesh), check its root against the committed
    one, and open it at the query indices.  Returns (rows per matrix (Q,
    W_i), paths (Q, L, 8)) as host uint32; everything rebuilt is freed on
    return."""
    block_lists: Dict[int, list] = {}
    plan, digests = _commit_blocks(data.sig, data.evals, block_lists.__setitem__)
    # The blocks in matrix order, as the tree's matrices: a block's height is
    # its matrix's, so its row indices are the matrix's.
    blocks = [b for i in range(len(data.sig)) for b in block_lists[i]]
    tree = _tree(plan, digests, blocks)
    del digests
    if not np.array_equal(tree.root, data.tree.root):
        raise RuntimeError("low-memory rebuild produced a different Merkle root")
    block_rows, paths = mk.open_many([tree], [idx >> (log_global - plan.log_max)])[0]
    rows, off = [], 0
    for i in range(len(data.sig)):
        nb = len(block_lists[i])
        rows.append(np.concatenate(block_rows[off : off + nb], axis=1))
        off += nb
    return rows, paths


def _total_alpha_budget(rounds) -> int:
    per_height: Dict[int, int] = {}
    for data, points_per_mat in rounds:
        for (log_n, _s, w), pts in zip(data.sig, points_per_mat):
            log_h = log_n + LOG_BLOWUP
            per_height[log_h] = per_height.get(log_h, 0) + w * len(pts)
    return max(per_height.values()) if per_height else 1


def _ef_powers_host(alpha: tuple, n: int) -> List[tuple]:
    out = [efh.ONE]
    for _ in range(n):
        out.append(efh.mul(out[-1], alpha))
    return out


# ---------------------------------------------------------------------------
# Verification (host), copied from the JAX package
# ---------------------------------------------------------------------------


def pcs_verify(
    rounds: Sequence[Tuple[Sequence[int], List[Tuple[Domain, List[Tuple[tuple, List[tuple]]]]]]],
    proof: PcsProof,
    challenger: DuplexChallenger,
    num_queries: int,
    pow_bits: int,
):
    """rounds: (root, [(domain, [(point, ys_per_column), ...]), ...]).

    Raises VerificationFailure on any inconsistency.
    """
    # 1. Replay opened-value observations; alpha.
    for _root, mats in rounds:
        for _domain, pts in mats:
            for _z, ys in pts:
                for y in ys:
                    challenger.observe_slice(list(y))
    alpha = challenger.sample_ext()

    # 2. FRI transcript replay.
    log_global = max(
        domain.log_n + LOG_BLOWUP for _root, mats in rounds for domain, _ in mats
    )
    betas, indices = fri_verify_transcript(
        proof.fri, challenger, log_global, num_queries, pow_bits
    )

    per_h: Dict[int, int] = {}
    for _root, mats in rounds:
        for domain, pts in mats:
            lh = domain.log_n + LOG_BLOWUP
            for _z, ys in pts:
                per_h[lh] = per_h.get(lh, 0) + len(ys)
    alpha_pows = _ef_powers_host(alpha, max(per_h.values()) if per_h else 1)

    # 3. Per-query checks, vectorized over ALL queries at once.
    if len(proof.query_input_openings) != num_queries or len(
        proof.fri.query_commit_openings
    ) != num_queries:
        raise OpeningShapeError("wrong number of query openings")
    for q in range(num_queries):
        if len(proof.query_input_openings[q]) != len(rounds):
            raise OpeningShapeError("wrong number of round openings")

    idx_arr = np.asarray(indices, dtype=np.int64)
    u64p = np.uint64(P)

    # 3a. Input-batch Merkle proofs: one vectorized walk per round.
    rows_by_round: List[List[np.ndarray]] = []
    for r, (root, mats) in enumerate(rounds):
        log_batch = max(d.log_n for d, _ in mats) + LOG_BLOWUP
        dims = [(1 << (d.log_n + LOG_BLOWUP), len(_first_ys(pts))) for d, pts in mats]
        try:
            rows_mats = [
                np.stack(
                    [
                        np.asarray(
                            proof.query_input_openings[q][r].opened_rows[m],
                            dtype=np.uint64,
                        )
                        for q in range(num_queries)
                    ]
                )
                for m in range(len(mats))
            ]
            paths = np.stack(
                [
                    np.asarray(proof.query_input_openings[q][r].proof, dtype=np.uint64)
                    for q in range(num_queries)
                ]
            )
        except (ValueError, IndexError) as err:
            raise OpeningShapeError(f"malformed input openings: {err}") from err
        for (h, w), rm in zip(dims, rows_mats):
            if rm.shape != (num_queries, w):
                raise OpeningShapeError("opened row width mismatch")
        idx_b = idx_arr >> (log_global - log_batch)
        ok = mk.verify_batch_np(root, dims, idx_b, rows_mats, paths)
        if not ok.all():
            raise InvalidOpeningArgument(
                f"query {int(np.argmin(ok))}: bad input Merkle proof"
            )
        rows_by_round.append(rows_mats)

    # 3b. Reduced openings per height at every query point, vectorized.
    ro_val: Dict[int, np.ndarray] = {}
    counters: Dict[tuple, int] = {}
    inv_xz_cache: Dict[tuple, np.ndarray] = {}
    x_cache: Dict[int, np.ndarray] = {}
    alpha_pows_arr = np.asarray(alpha_pows, dtype=np.uint64)  # (A+1, 4)
    for (root, mats), rows in zip(rounds, rows_by_round):
        for (domain, pts), row in zip(mats, rows):
            log_h = domain.log_n + LOG_BLOWUP
            if log_h not in x_cache:
                # the query points GENERATOR * g_h^rev(i), committed row i
                rev = nt.reverse_bits(idx_arr >> (log_global - log_h), log_h)
                x_cache[log_h] = (
                    _pow_base_vec(xf.two_adic_root(log_h), rev) * np.uint64(GENERATOR) % u64p
                )
            x = x_cache[log_h]  # (Q,)
            ro_val.setdefault(log_h, np.zeros((num_queries, 4), dtype=np.uint64))
            row64 = row % u64p  # (Q, W)
            for z, ys in pts:
                c0 = counters.get((log_h, z), 0)
                if len(ys) == 0:
                    continue
                ck = (log_h, z)
                if ck not in inv_xz_cache:
                    xz = np.broadcast_to(
                        (u64p - np.asarray(z, dtype=np.uint64) % u64p) % u64p,
                        (num_queries, 4),
                    ).copy()
                    xz[:, 0] = (xz[:, 0] + x) % u64p
                    inv_xz_cache[ck] = efh.v_inv(xz)
                inv_xz = inv_xz_cache[ck]
                if len(ys) != row64.shape[1]:
                    raise OpeningShapeError("opened value count mismatch")
                ys_arr = np.asarray(ys, dtype=np.uint64) % u64p  # (W, 4)
                diff = np.broadcast_to(
                    (u64p - ys_arr) % u64p, (num_queries,) + ys_arr.shape
                ).copy()  # (Q, W, 4)
                diff[:, :, 0] = (diff[:, :, 0] + row64) % u64p
                ap = alpha_pows_arr[c0 : c0 + len(ys)]  # (W, 4)
                prod = efh.v_mul(ap[None, :, :], diff)  # (Q, W, 4)
                acc = prod.sum(axis=1, dtype=np.uint64) % u64p  # (Q, 4)
                ro_val[log_h] = (ro_val[log_h] + efh.v_mul(acc, inv_xz)) % u64p
                counters[(log_h, z)] = c0 + len(ys)

    # 3c. FRI fold chains, vectorized.
    fri_check_queries_np(proof.fri, indices, betas, log_global, LOG_BLOWUP, ro_val)


def _first_ys(pts):
    return pts[0][1] if pts else []
