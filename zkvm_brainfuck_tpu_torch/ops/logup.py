"""LogUp permutation-trace kernels (csrc/logup.cu) and their plain versions.

Counterpart of the device half of the JAX package's stark/permutation.py:

- `logup_trace(table, main, prep, chal) -> (perm, csum)`: per row, the
  fingerprints d_i = alpha + argument_index_i + sum_j beta^(j+1) value_ij
  of the chip's interactions, the terms +-m_i / d_i, their sums per batch
  of B, and the row sum; then the inclusive running sum phi of the row
  sums.  Returns the (N, NB+1, 4) permutation trace with the entries in
  columns 0..NB-1 and phi in column NB, and the cumulative sum phi[N-1] as
  a (4,) tensor.  On the card this is one kernel (the running sum is a
  single-pass scan with decoupled look-back inside it); its plain version
  is `logup_entries_plain` (entries, row sums in column NB) followed by
  `logup_scan_plain` (column NB into phi, in place).

`chal` is the (V+2, 4) canonical int32 matrix [alpha; beta^0; ...; beta^V],
V the largest value count of the chip's interactions.  The wrapper launches
the kernel for CUDA tensors and takes the plain version only for CPU
tensors.  The plain versions invert every denominator on its own (Fermat,
through the norm); the kernel batch-inverts the denominators of a row; the
inverse is unique, so both give the same bits.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import ext as xe
from . import field as xf
from . import kernels as kn
from .field import I32, I64, P

MAX_INTERACTIONS = 16  # csrc/logup.cu MAX_I
ENTRY_LANES = 2  # csrc/logup.cu ENTRY_LANES: threads that share a row


class LogupTable:
    """A chip's interactions in LogUp order (sends, then receives), as
    (lookup, is_send) pairs, with its batch size B = 2^log_quotient_degree.

    `descriptor(device)` is the int32 table the kernel reads (layout in
    csrc/logup.cu), built once per device."""

    def __init__(self, interactions: Sequence[tuple], batch: int):
        self.interactions = list(interactions)
        self.batch = batch
        self.n_inter = len(self.interactions)
        self.nb = (self.n_inter + batch - 1) // batch
        self.max_vals = max(len(lk.values) for lk, _ in self.interactions)
        self._desc: Dict[torch.device, torch.Tensor] = {}

    def descriptor(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._desc:
            words: List[int] = []

            def affine(aff):
                words.extend([aff.const % P, len(aff.terms)])
                for is_prep, idx, w in aff.terms:
                    words.extend([int(is_prep), idx, xf.monty_of(w % P)])

            for lk, is_send in self.interactions:
                words.extend([int(is_send), lk.argument_index, len(lk.values)])
                for aff in lk.values:
                    affine(aff)
                affine(lk.multiplicity)
            self._desc[device] = torch.tensor(words, dtype=I32, device=device)
        return self._desc[device]


def challenge_matrix(alpha: Sequence[int], beta_pows, device) -> torch.Tensor:
    """(V+2, 4) int32 [alpha; beta^0..beta^V] on `device`."""
    rows = [[int(x) for x in alpha]] + [[int(x) for x in b] for b in beta_pows]
    return torch.tensor(rows, dtype=I32, device=device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _affine_plain(aff, main: torch.Tensor, prep) -> torch.Tensor:
    acc = torch.full((main.shape[0],), aff.const % P, dtype=I64, device=main.device)
    for is_prep, idx, w in aff.terms:
        col = (prep if is_prep else main)[:, idx].to(I64)
        acc = (acc + col * (w % P)) % P
    return acc


def logup_entries_plain(table: LogupTable, main, prep, chal) -> torch.Tensor:
    n = main.shape[0]
    c = chal.to(I64)
    denoms: List[tuple] = []
    mults: List[torch.Tensor] = []
    for lk, is_send in table.interactions:
        d = [torch.full((n,), int(c[0, k]), dtype=I64, device=main.device) for k in range(4)]
        d[0] = (d[0] + lk.argument_index) % P
        for j, aff in enumerate(lk.values):
            v = _affine_plain(aff, main, prep)
            d = [(d[k] + v * c[j + 2, k]) % P for k in range(4)]
        denoms.append(tuple(x.to(I32) for x in d))
        m = _affine_plain(lk.multiplicity, main, prep)
        mults.append(m if is_send else (P - m) % P)
    stack = tuple(torch.stack([d[k] for d in denoms], dim=1) for k in range(4))  # (N, I)
    terms = xe.emul_base(xe.einv(stack), torch.stack(mults, dim=1))
    out = torch.zeros((n, table.nb + 1, 4), dtype=I32, device=main.device)
    row = xe.ezeros((n,), device=main.device)
    for b in range(table.nb):
        cols = slice(b * table.batch, min((b + 1) * table.batch, table.n_inter))
        ent = tuple(xf.fsum_small(t[:, cols], axis=1) for t in terms)
        out[:, b, :] = xe.to_array(ent)
        row = xe.eadd(row, ent)
    out[:, table.nb, :] = xe.to_array(row)
    return out


def logup_scan_plain(perm: torch.Tensor) -> torch.Tensor:
    nb = perm.shape[1] - 1
    phi = (perm[:, nb, :].to(I64).cumsum(0) % P).to(I32)  # < 2^31 x 2^22 rows: exact
    perm[:, nb, :] = phi
    return phi[-1].clone()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(table: LogupTable, main, prep, chal):
    if main.dim() != 2:
        raise ValueError(f"logup_trace: expected an (N, W) main trace, got {tuple(main.shape)}")
    need_prep = any(is_prep for lk, _ in table.interactions
                    for aff in (*lk.values, lk.multiplicity) for is_prep, _i, _w in aff.terms)
    if need_prep and prep is None:
        raise ValueError("logup_trace: the chip reads preprocessed columns; prep is missing")
    if prep is not None and (prep.dim() != 2 or prep.shape[0] != main.shape[0]):
        raise ValueError("logup_trace: prep must be (N, PW) with main's N")
    if tuple(chal.shape) != (table.max_vals + 2, 4):
        raise ValueError(f"logup_trace: chal must be ({table.max_vals + 2}, 4)")
    for t in (prep, chal):
        if t is not None and t.device != main.device:
            raise ValueError("logup_trace: inputs on different devices")


def logup_trace(table: LogupTable, main: torch.Tensor, prep, chal: torch.Tensor):
    """(perm, csum): the (N, NB+1, 4) canonical int32 permutation trace,
    entries in columns 0..NB-1 and the running sum phi in column NB, and
    the cumulative sum phi[N-1] as a (4,) tensor.  On the card one launch
    of the fused kernel (after a clear of its scratch), in which
    ENTRY_LANES threads share a row, each taking ceil(NB / ENTRY_LANES)
    whole batches: at most 16 / ENTRY_LANES interactions."""
    _check_inputs(table, main, prep, chal)
    if not main.is_cuda:
        perm = logup_entries_plain(table, main, prep, chal)
        return perm, logup_scan_plain(perm)
    share = min(table.n_inter, -(-table.nb // ENTRY_LANES) * table.batch)
    if table.n_inter > MAX_INTERACTIONS or share > MAX_INTERACTIONS // ENTRY_LANES:
        raise ValueError(f"logup_trace: {table.n_inter} interactions in batches of "
                         f"{table.batch} do not fit {ENTRY_LANES} lanes a row")
    kn.require_cuda_int32(main, "logup_trace main")
    kn.require_cuda_int32(chal, "logup_trace chal")
    if prep is not None:
        kn.require_cuda_int32(prep, "logup_trace prep")
    desc = table.descriptor(main.device)
    n, w = main.shape
    lib = kn.lib("logup.cu", main.device)
    words = lib.zkbf_logup_scratch_words(n)
    scratch = torch.empty(words, dtype=I32, device=main.device)
    perm = torch.empty((n, table.nb + 1, 4), dtype=I32, device=main.device)
    csum = torch.empty(4, dtype=I32, device=main.device)
    err = lib.zkbf_logup_trace(
        main.data_ptr(), w, prep.data_ptr() if prep is not None else None,
        prep.shape[1] if prep is not None else 0, n, desc.data_ptr(), desc.shape[0],
        chal.data_ptr(), chal.shape[0], perm.data_ptr(), csum.data_ptr(), scratch.data_ptr(),
        words, table.n_inter, table.batch, table.nb, kn.stream(main.device),
    )
    kn.check(err, "logup_trace")
    kn.COUNTS["logup_entries"] += 1
    return perm, csum
