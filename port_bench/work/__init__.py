"""The least time one proof's work needs on one H100, counted from the
proof's own shapes, keyed by function (LDE, row hashing, tree, LogUp
trace, quotient, FRI fold, opened values, reduced openings, grind) and
never by kernel, so the same work reads the same whatever implements it.

The arithmetic is a frozen copy of the bounds the port's smoke script
kept (`chip_smoke.py` `bound`, `launch_bounds`), with three changes: the
functions are counted from the shapes of the proof rather than from a
kernel's launch arguments; every product by a fixed matrix (the NTT's
butterflies, Poseidon2's external linear layers, the openings' column
products) counts at the int8 tensor-core rate, the fastest unit that can
do it; and an opened matrix is read once for all its points.  Each
function counts at the larger of its bytes over the HBM rate and its
operations' time, so no implementation can need less.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 64 * 132 * 1.98e9  # INT32 lanes x SMs x boost clock (Hopper white paper)
IMMA_OPS_PER_S = 1.979e15  # int8 tensor cores, dense (data sheet)
MUL_INSTR, ADD_INSTR = 5, 2  # a Montgomery product; an addition, compare and select
IMMA_OPS_PER_PRODUCT = 16 * 2  # 4-byte x 4-byte: 16 byte products, a multiply and an add each
# One EF4 inverse through the norm: 8 Frobenius scales, 2 EF4 products, the
# norm's 4, the Fermat power p - 2 by 48 squarings and 6 products, 4 scales.
EF4_INV_MULS = 8 + 2 * 16 + 4 + 48 + 6 + 4
EF4_MUL = (16, 12)  # (products, additions) of an EF4 product
# Poseidon2-16: 8 full rounds of 16 cubes (2 products) and 16 constants, 13
# partial rounds of 1 cube, 1 constant, a 15-addition lane sum and the
# internal diagonal (7 products, 28 additions); 9 external 16 x 16 linear
# layers as products by a fixed matrix.
P2_INSTR = (8 * 16 * 2 + 13 * (2 + 7)) * MUL_INSTR + (8 * 16 + 13 * (1 + 15 + 28)) * ADD_INSTR
P2_TENSOR_OPS = 9 * 16 * 16 * IMMA_OPS_PER_PRODUCT

Work = Tuple[float, float, float]  # bytes, INT32 instructions, tensor-core operations


def seconds(w: Work) -> float:
    b, i, t = w
    return max(b / HBM_BYTES_PER_S, i / INT_OPS_PER_S + t / IMMA_OPS_PER_S)


def _add(acc: Dict[str, List[float]], key: str, b: float, i: float = 0.0, t: float = 0.0):
    cur = acc.setdefault(key, [0.0, 0.0, 0.0])
    cur[0] += b
    cur[1] += i
    cur[2] += t


def _lde(acc, n: int, w: int, log_blowup: int):
    """Evaluations over H_n to the coset of 2^b * n rows: the inverse
    transform, the coset scale and the forward transform's products, all
    by fixed twiddles; evaluations read once, the extension written once."""
    m = n << log_blowup
    products = w * ((n // 2) * (n.bit_length() - 1) + n + (m // 2) * (m.bit_length() - 1))
    _add(acc, "lde", 4 * w * (n + m), 0, products * IMMA_OPS_PER_PRODUCT)


def _perms(acc, key: str, perms: int, nbytes: float):
    _add(acc, key, nbytes, perms * P2_INSTR, perms * P2_TENSOR_OPS)


def _commit(acc, mats: List[Tuple[int, int]]):
    """Digest layers (a sponge over each height's row concatenation) and
    the tree with compress-and-inject, over (height, width) matrices."""
    by_h: Dict[int, int] = {}
    for h, w in mats:
        by_h[h] = by_h.get(h, 0) + w
    for h, w in by_h.items():
        _perms(acc, "row_hash", h * ((w + 7) // 8), 4 * h * w + 32 * h)
    top = max(by_h)
    perms, size = 0, top
    while size > 1:
        size //= 2
        perms += size * (2 if size in by_h else 1)
    read = top + sum(h for h in by_h if h != top)
    _perms(acc, "tree", perms, 32 * (read + 2 * top))


def proof_work(shapes: List[dict], log_blowup: int, pow_bits: int) -> Dict[str, Work]:
    """shapes: one dict per chip of the proof with `n` (rows), `width`,
    `prep_width`, `perm_width` (EF4 columns, 0 without interactions),
    `quotient_chunks`, `local_only`, `logup_products` (a row's products of
    the LogUp trace), `quotient_reads` (distinct column reads a row),
    `quotient_products` and `quotient_additions` (a row's, folded)."""
    acc: Dict[str, List[float]] = {}
    main, perm, quot = [], [], []
    for c in shapes:
        n = c["n"]
        main.append((n, c["width"]))
        _lde(acc, n, c["width"], log_blowup)
        if c["perm_width"]:
            pw = 4 * c["perm_width"]
            perm.append((n, pw))
            _lde(acc, n, pw, log_blowup)
            _add(acc, "logup", 4 * n * (c["width"] + c["prep_width"]) + 4 * n * pw,
                 n * (c["logup_products"] * (MUL_INSTR + ADD_INSTR) + 4 * ADD_INSTR))
        rows = n * c["quotient_chunks"]
        _add(acc, "quotient", 4 * rows * (c["quotient_reads"] + 4) + 16 * rows,
             rows * (c["quotient_products"] * MUL_INSTR + c["quotient_additions"] * ADD_INSTR))
        for _ in range(c["quotient_chunks"]):
            quot.append((n, 4))
            _lde(acc, n, 4, log_blowup)
    for mats in (main, perm, quot):
        _commit(acc, [(h << log_blowup, w) for h, w in mats])

    # Opened values and reduced openings: every committed matrix (and the
    # preprocessed ones) read once; a (height, point) unit's rows each take
    # an EF4 inverse, and every element 4 column products per point.
    units: Dict[Tuple[int, int], int] = {}
    for c in shapes:
        h = c["n"] << log_blowup
        pts = 1 if c["local_only"] else 2
        members = [(c["width"], pts), (c["prep_width"], pts), (4 * c["perm_width"], 2),
                   (4 * c["quotient_chunks"], 1)]
        for w, k in members:
            if not w:
                continue
            _add(acc, "open_eval", 4 * h * w, 0, h * w * k * 4 * IMMA_OPS_PER_PRODUCT)
            _add(acc, "reduced_open", 4 * h * w, 0, h * w * k * 4 * IMMA_OPS_PER_PRODUCT)
            for p in range(k):
                units[(h, p)] = 1
    for (h, _p) in units:
        _add(acc, "open_eval", 0, h * (EF4_INV_MULS + 4) * MUL_INSTR)
        _add(acc, "reduced_open", 32 * h, h * ((EF4_INV_MULS + 16) * MUL_INSTR + 20 * ADD_INSTR))

    # FRI: each fold reads 2^h EF4 values and writes half, and each layer is
    # committed as pairs (a width-8 matrix of 2^(h-1) rows).
    log_h = max(c["n"] for c in shapes).bit_length() - 1 + log_blowup
    while log_h > log_blowup:
        h = 1 << log_h
        _add(acc, "fri_fold", 16 * h + 8 * h, h // 2 * (EF4_MUL[0] + 4) * MUL_INSTR)
        _commit(acc, [(h // 2, 8)])
        log_h -= 1
    _perms(acc, "grind", 1 << pow_bits, 0)
    return {k: tuple(v) for k, v in acc.items()}
