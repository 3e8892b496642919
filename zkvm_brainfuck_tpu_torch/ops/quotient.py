"""A chip's quotient on its coset: the generated kernels (stark/codegen.py
over csrc/quotient.cuh) and the wrapper that launches them.

Counterpart of the JAX package's stark/quotient.py `_quotient_program`.
`quotient_eval(chip, main, prep, perm, sels, next_step, perm_challenges,
alpha, cumulative_sum, halo=None)` is the (rows, 4) canonical int32 folded
quotient at `rows` coset rows:

- main / prep / perm: the chip's LDE column blocks at those rows, in
  column order ((rows, w_b) int32, each row contiguous; prep None for a
  chip without a preprocessed trace, perm None for the AIR alone, the
  uni-STARK); an EF4 permutation column is 4 planes and may straddle two
  blocks;
- the next row of row r is r + next_step; past the last row it is read
  from `halo`, a (main, prep, perm) triple of block lists of next_step rows
  each (a mesh shard: the next shard's first rows), or, when halo is None,
  from row r + next_step - rows (one device: the coset wraps);
- sels: the selectors at those rows (stark/domains.py selectors_on_coset);
- perm_challenges (alpha', beta), alpha and cumulative_sum: exact host EF4
  values.

For CUDA tensors the wrapper launches the chip's kernel once, reading the
blocks in place through a table of blocks (pointer, row stride, width;
the kernel stages each tile of rows into shared memory); a kernel that
fails to build or launch raises.  Only CPU tensors take the plain version
(stark/quotient.py `quotient_rows_plain`: every constraint in eager torch
over transposed and rolled copies of the columns).  Every operation is
exact mod p, so both give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import kernels as kn
from .field import I32

SELECTORS = ("is_first_row", "is_last_row", "is_transition", "inv_zeroifier")


def _groups(chip, main, prep, perm) -> List[tuple]:
    """(name, blocks, width) of the column groups in the kernel's order."""
    groups = [("main", main, chip.width)]
    if chip.preprocessed_width:
        groups.append(("prep", prep, chip.preprocessed_width))
    elif prep is not None:
        raise ValueError(f"quotient_eval: {chip.name} has no preprocessed trace")
    if perm is not None:
        groups.append(("perm", perm, 4 * chip.permutation_width))
    return groups


def _check(chip, main, prep, perm, sels, next_step: int, halo) -> None:
    if not main:
        raise ValueError("quotient_eval: no main blocks")
    rows = int(main[0].shape[0])
    device = main[0].device
    groups = _groups(chip, main, prep, perm)
    if halo is not None and len(halo) != 3:
        raise ValueError("quotient_eval: halo must be (main, prep, perm) block lists")
    for name, blocks, width in groups:
        if blocks is None:
            raise ValueError(f"quotient_eval: {chip.name} needs its {name} blocks")
        if sum(int(b.shape[1]) for b in blocks) != width:
            raise ValueError(f"quotient_eval: {name} blocks of widths "
                             f"{[int(b.shape[1]) for b in blocks]} for {width} columns")
        hblocks = None if halo is None else halo[("main", "prep", "perm").index(name)]
        if halo is not None and (hblocks is None or len(hblocks) != len(blocks)):
            raise ValueError(f"quotient_eval: the {name} halo must have a block for each block")
        for k, b in enumerate(blocks):
            if b.dim() != 2 or int(b.shape[0]) != rows or b.device != device:
                raise ValueError(f"quotient_eval: {name} blocks must be 2-D, of {rows} rows, on "
                                 f"{device}")
            if hblocks is not None and (tuple(hblocks[k].shape) != (next_step, int(b.shape[1]))
                                        or hblocks[k].device != device):
                raise ValueError(f"quotient_eval: a {name} halo block must be "
                                 f"({next_step}, {int(b.shape[1])}) on {device}")
    if not 1 <= next_step <= rows:
        raise ValueError(f"quotient_eval: {rows} rows, fewer than the next-row step {next_step}")
    for s in SELECTORS:
        if tuple(sels[s].shape) != (rows,) or sels[s].device != device:
            raise ValueError(f"quotient_eval: selector {s} must be ({rows},) on {device}")


def quotient_eval(chip, main: Sequence[torch.Tensor], prep: Optional[Sequence[torch.Tensor]],
                  perm: Optional[Sequence[torch.Tensor]], sels: dict, next_step: int,
                  perm_challenges, alpha: tuple, cumulative_sum, halo=None) -> torch.Tensor:
    """(rows, 4) canonical int32: the chip's folded constraints times the
    inverse zeroifier at each row.  On the card one launch of the chip's
    generated kernel."""
    _check(chip, main, prep, perm, sels, next_step, halo)
    if not main[0].is_cuda:
        from ..stark.quotient import quotient_rows_plain

        return quotient_rows_plain(chip, main, prep, perm, sels, next_step, perm_challenges, alpha,
                                   cumulative_sum, halo)
    launch = Launch(chip, main, prep, perm, sels, next_step, perm_challenges, alpha,
                    cumulative_sum, halo)
    launch()
    kn.COUNTS["quotient_eval"] += 1
    return launch.out


class Launch:
    """A launch of the chip's kernel with its arguments built: the loaded
    library, the block table, the selector pointers and the parameter
    words as C arrays, and the result tensor.  Calling it launches the
    kernel on the current stream (and raises on a CUDA error); the wrapper
    calls it once, a timing may call it again."""

    def __init__(self, chip, main, prep, perm, sels, next_step, perm_challenges, alpha,
                 cumulative_sum, halo=None):
        from ..stark import codegen

        prog = codegen.program(chip, perm is not None)
        device = main[0].device
        self.name = prog.name
        self.table = block_table(chip, main, prep, perm, halo)
        for s in SELECTORS:
            _require(sels[s], f"quotient_eval selector {s}", 1)
        self.sel_ptrs = (ctypes.c_void_p * 4)(*[sels[s].data_ptr() for s in SELECTORS])
        self.words = prog.params(perm_challenges, alpha, cumulative_sum)
        rows = int(main[0].shape[0])
        self.out = torch.empty((rows, 4), dtype=I32, device=device)
        self.lib = kn.generated_lib(prog.name, prog.text, device)
        local, hal, strides, hstrides, widths, n_blk = self.table
        self.args = (ctypes.addressof(local), ctypes.addressof(hal), ctypes.addressof(strides),
                     ctypes.addressof(hstrides), ctypes.addressof(widths), n_blk,
                     ctypes.addressof(self.sel_ptrs), self.words.ctypes.data, len(self.words),
                     rows, next_step, self.out.data_ptr(), kn.stream(device))

    def __call__(self) -> None:
        kn.check(self.lib.zkbf_quotient(*self.args), f"quotient_eval {self.name}")


def block_table(chip, main, prep, perm, halo=None) -> tuple:
    """The kernel's block table as C arrays (local pointers, halo pointers,
    row strides, halo row strides, widths, the block count), in the column
    order of stark/codegen.py: main, preprocessed, permutation planes.
    Without a halo a block's halo is the block itself (the coset wraps)."""
    local, hal, strides, hstrides, widths = [], [], [], [], []
    for name, blocks, _w in _groups(chip, main, prep, perm):
        hblocks = blocks if halo is None else halo[("main", "prep", "perm").index(name)]
        for b, hb in zip(blocks, hblocks):
            for t, what in ((b, f"quotient_eval {name} block"), (hb, f"quotient_eval {name} halo")):
                _require(t, what, 2)
            local.append(b.data_ptr())
            strides.append(b.stride(0))
            hal.append(hb.data_ptr())
            hstrides.append(hb.stride(0))
            widths.append(int(b.shape[1]))
    n = len(local)
    return ((ctypes.c_void_p * n)(*local), (ctypes.c_void_p * n)(*hal),
            (ctypes.c_int * n)(*strides), (ctypes.c_int * n)(*hstrides),
            (ctypes.c_int * n)(*widths), n)


def _require(t: torch.Tensor, what: str, ndim: int) -> None:
    """int32 of `ndim` dims, each row contiguous (a column block may be a
    view with a larger row stride)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: expected rows with unit column stride, got strides {t.stride()}")
