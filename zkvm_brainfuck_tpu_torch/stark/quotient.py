"""Quotient polynomial evaluation on the disjoint coset (device).

Counterpart of the JAX package's stark/quotient.py (reference
crates/stark/src/quotient.rs): run the chip's constraints (AIR, then the
LogUp permutation constraints) over every coset point, fold them with the
alpha powers of folder.rs:68-72, multiply by the inverse zeroifier, and
return the EF4 quotient evaluations.

`quotient_values` hands each device's (or mesh shard's) LDE column blocks,
in place, to ops/quotient.py `quotient_eval`: on the card one launch of the
chip's generated kernel (stark/codegen.py).  The plain version,
`quotient_rows_plain`, evaluates every constraint over whole coset columns
with the `TorchBackend` (eager torch), the next row being the coset column
rolled by the blowup (or shifted, with the next shard's halo); constraint j
of K gets the exact host weight alpha^(K-1-j) (the alpha-Horner fold
written as a sum), and the base and extension constraints are stacked and
folded with one weighted mod-p sum each.  It runs on any device.  The
uni-STARK quotient (stark/uni.py) is the case without preprocessed or
permutation columns.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops import ext as xe
from ..ops import field as xf
from ..ops import quotient as oq
from ..ops.field import I32, I64
from ..parallel import collectives as co
from ..parallel.mesh import RowSharded
from . import ef_host as efh
from .builder import HostEFBackend, NumericBuilder, TorchBackend, V
from .chip import Chip
from .domains import Domain, selectors_on_coset
from .pcs import _lde_spans
from .permutation import eval_permutation_constraints, host_beta_pows

# Calls of the plain version (quotient_rows_plain) in this process: a
# prove on the card makes none.
PLAIN_CALLS = 0


def constraint_ext_flags(chip: Chip) -> List[bool]:
    """Per-constraint ext(True)/base(False) flags, in emission order (AIR,
    then permutation constraints): one exact host-scalar pass, kept on the
    chip."""
    if "_constraint_ext_flags" not in chip.__dict__:
        be = HostEFBackend
        flags: List[bool] = []
        one = efh.from_base(1)
        b = NumericBuilder(
            backend=be,
            main_local=lambda i: V(be, one),
            main_next=lambda i: V(be, one),
            prep_local=(lambda i: V(be, one)) if chip.preprocessed_width else None,
            prep_next=(lambda i: V(be, one)) if chip.preprocessed_width else None,
            is_first_row=V(be, one),
            is_last_row=V(be, one),
            is_transition=V(be, one),
            on_constraint=lambda v: flags.append(v.ext),
            perm_local=[V(be, efh.ONE, True)] * chip.permutation_width,
            perm_next=[V(be, efh.ONE, True)] * chip.permutation_width,
            perm_challenges=[V(be, efh.ONE, True), V(be, efh.ONE, True)],
            cumulative_sum=V(be, efh.ZERO, True),
        )
        chip.eval(b)
        eval_permutation_constraints(chip, b)
        chip.__dict__["_constraint_ext_flags"] = flags
    return chip.__dict__["_constraint_ext_flags"]


def _fsum_axis0(x):
    """Exact mod-p sum over the (small) constraint axis."""
    return xf.fsum_small(x, axis=0)


def _blk_col(blocks, i: int) -> torch.Tensor:
    """Column i of a column-blocked matrix: a list of (W_b, Nq) blocks of
    rows, one row per column."""
    for b in blocks:
        if i < b.shape[0]:
            return b[i]
        i -= b.shape[0]
    raise IndexError(i)


def quotient_values(
    chip: Chip,
    trace_domain: Domain,
    quotient_domain: Domain,
    prep_lde,
    main_lde,
    perm_lde,
    perm_challenges,
    alpha: tuple,
    cumulative_sum,
):
    """(Nq, 4) canonical int32 quotient values on the quotient coset.

    *_lde: lists of (Nq, w_b) canonical column blocks of the LDEs on the
    coset, in column order (`PcsProverData.lde_blocks`; prep_lde None for
    chips without a preprocessed trace; perm_lde None evaluates the AIR
    alone, the uni-STARK case).  perm_challenges (alpha', beta), alpha and
    cumulative_sum are exact host EF4 tuples.  Row-sharded LDEs give
    row-sharded values: each shard evaluates its own coset rows.  Each
    device or shard is one `quotient_eval` (ops/quotient.py) on its blocks
    in place."""
    nq = quotient_domain.size
    next_step = 1 << (quotient_domain.log_n - trace_domain.log_n)
    args = (perm_challenges, alpha, cumulative_sum)
    if not isinstance(main_lde[0], RowSharded):
        sels = selectors_on_coset(trace_domain.log_n, quotient_domain.log_n, quotient_domain.shift,
                                  main_lde[0].device)
        return oq.quotient_eval(chip, main_lde, prep_lde, perm_lde, sels, next_step, *args)
    # Row-sharded: a shard's next rows past its last are a halo of the
    # right-hand neighbour's first rows (ppermute on the ring; the last
    # shard takes shard 0's), and its selectors are those of its row range.
    mesh = main_lde[0].mesh
    rows = nq // mesh.size
    if rows < next_step:
        raise ValueError(f"quotient: {rows} coset rows a shard, fewer than the next-row step")

    def shard_blocks(blocks):
        if blocks is None:
            return [None] * mesh.size, [None] * mesh.size
        local = [[blk.blocks[k] for blk in blocks] for k in range(mesh.size)]
        halos = [co.ppermute(mesh, [b[:next_step] for b in blk.blocks], co.ring_next(mesh))
                 for blk in blocks]
        return local, [[h[k] for h in halos] for k in range(mesh.size)]

    (main, main_h), (prep, prep_h), (perm, perm_h) = (
        shard_blocks(main_lde), shard_blocks(prep_lde), shard_blocks(perm_lde))
    out = []
    for k, dev in enumerate(mesh.devices):
        sels = selectors_on_coset(trace_domain.log_n, quotient_domain.log_n, quotient_domain.shift,
                                  dev, k * rows, rows)
        out.append(oq.quotient_eval(chip, main[k], prep[k], perm[k], sels, next_step, *args,
                                    halo=(main_h[k], prep_h[k], perm_h[k])))
    return RowSharded(mesh, out, (nq, 4))


def quotient_rows_plain(chip, main, prep, perm, sels, next_step, perm_challenges, alpha,
                        cumulative_sum, halo=None) -> torch.Tensor:
    """The plain version of ops/quotient.py `quotient_eval` (same
    arguments): every block transposed into one contiguous row a column,
    its next rows rolled by the step (halo None) or shifted with the halo
    appended (a mesh shard), then `_quotient_rows`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    nq = int(main[0].shape[0])

    def columns(blocks, halos):
        if blocks is None:
            return None
        cols = [b.t().contiguous() for b in blocks]
        if halos is None:
            return cols, [torch.roll(c, -next_step, dims=1) for c in cols]
        return cols, [torch.cat([b[next_step:], h]).t().contiguous() for b, h in zip(blocks, halos)]

    mh, ph, qh = halo if halo is not None else (None, None, None)
    return _quotient_rows(chip, columns(prep, ph), columns(main, mh), columns(perm, qh), sels, nq,
                          main[0].device, perm_challenges, alpha, cumulative_sum)


def _quotient_rows(chip, prep_cols, main_cols, perm_cols, sels, nq, device, perm_challenges,
                   alpha, cumulative_sum) -> torch.Tensor:
    """The folded quotient at nq coset points: *_cols are (column rows, next
    column rows) pairs of (w_b, nq) blocks (None where absent), sels the
    selectors at those points."""
    be = TorchBackend
    main, main_next = main_cols
    prep, prep_next = prep_cols if prep_cols is not None else (None, None)
    perm_kw = {}
    if perm_cols is not None:
        perm, perm_nxt = perm_cols
        perm_w = sum(c.shape[0] for c in perm) // 4
        planes = lambda m, i: tuple(_blk_col(m, 4 * i + k) for k in range(4))  # noqa: E731
        perm_kw = dict(
            perm_local=[V(be, planes(perm, i), True) for i in range(perm_w)],
            perm_next=[V(be, planes(perm_nxt, i), True) for i in range(perm_w)],
            perm_challenges=[V(be, tuple(c), True) for c in perm_challenges],
            cumulative_sum=V(be, tuple(int(x) for x in cumulative_sum), True),
        )
    collected = []
    b = NumericBuilder(
        backend=be,
        main_local=lambda i: V(be, _blk_col(main, i)),
        main_next=lambda i: V(be, _blk_col(main_next, i)),
        prep_local=(lambda i: V(be, _blk_col(prep, i))) if prep is not None else None,
        prep_next=(lambda i: V(be, _blk_col(prep_next, i))) if prep is not None else None,
        is_first_row=V(be, sels["is_first_row"]),
        is_last_row=V(be, sels["is_last_row"]),
        is_transition=V(be, sels["is_transition"]),
        on_constraint=lambda v: collected.append((v.p, v.ext)),
        **perm_kw,
    )
    chip.eval(b)
    if perm_cols is not None:
        b.perm_beta_pows = [
            V(be, tuple(int(x) for x in row), True)
            for row in host_beta_pows(chip, perm_challenges[1])
        ]
        eval_permutation_constraints(chip, b)
        assert [e for _p, e in collected] == constraint_ext_flags(chip), chip.name

    k_total = len(collected)
    pows = [efh.ONE]
    for _ in range(k_total - 1):
        pows.append(efh.mul(pows[-1], alpha))
    weights = [pows[k_total - 1 - j] for j in range(k_total)]

    def full(x):
        if isinstance(x, torch.Tensor):
            return x.to(I32).expand(nq)
        return torch.full((nq,), int(x), dtype=I32, device=device)

    acc = xe.ezeros((nq,), device=device)
    base = [(full(p), w) for (p, ext), w in zip(collected, weights) if not ext]
    if base:
        bstack = torch.stack([p for p, _w in base])  # (K_b, nq)
        bw = torch.tensor([w for _p, w in base], dtype=I64, device=device)  # (K_b, 4)
        acc = xe.eadd(
            acc, tuple(_fsum_axis0(xf.fmul(bstack, bw[:, t][:, None])) for t in range(4))
        )
    ext = [(p, w) for (p, e), w in zip(collected, weights) if e]
    if ext:
        estack = tuple(torch.stack([full(p[t]) for p, _w in ext]) for t in range(4))
        ew = torch.tensor([w for _p, w in ext], dtype=I64, device=device)
        prod = xe.emul(estack, tuple(ew[:, t][:, None] for t in range(4)))
        acc = xe.eadd(acc, tuple(_fsum_axis0(pl) for pl in prod))
    return xe.to_array(xe.emul_base(acc, sels["inv_zeroifier"]))


def split_quotient_chunks(quotient_domain: Domain, qvals, n_chunks: int):
    """Split coset evals into per-subdomain chunk matrices (p3 split_evals):
    chunk k = rows k::n_chunks, 4 base columns, on split_domains(n)[k].
    Row-sharded values give row-sharded chunks (each shard's rows of a
    chunk are its own rows k::n_chunks)."""
    if isinstance(qvals, RowSharded):
        return [RowSharded(qvals.mesh, [b[k::n_chunks].reshape(-1, 4).contiguous()
                                        for b in qvals.blocks], (qvals.shape[0] // n_chunks, 4))
                for k in range(n_chunks)]
    return [qvals[k::n_chunks].reshape(-1, 4).contiguous() for k in range(n_chunks)]


def quotient_block_widths(chip, trace_log_n: int, prep_width) -> dict:
    """The column-block widths of the LDEs that a low-memory prove passes to
    `quotient_values` for (chip, height): blocks of ZKBF_BLK_W columns at
    blocked LDE heights, one full-width block otherwise (stark/pcs.py
    `_lde_spans`).  A normal-mode round passes its resident LDE whole."""
    widths = {"main": chip.width, "perm": chip.permutation_width * 4, "prep": prep_width or 0}
    return {k: tuple(c1 - c0 for c0, c1 in _lde_spans(trace_log_n, w)) if w else ()
            for k, w in widths.items()}
