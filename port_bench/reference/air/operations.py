"""Shared constraint gadgets (reference: crates/core/machine/src/operations/).

Each gadget pairs a Layout fragment with `eval` (constraints over builder
values), frozen from the port's models/operations.py without the
trace-generation `populate` halves.
"""

from __future__ import annotations

from .layout import Layout
from .lookup import LookupKind

# ---------------------------------------------------------------------------
# AddOperation: u8 add with carry (operations/add.rs:12-76)
# ---------------------------------------------------------------------------

ADD_OPERATION = Layout([("value", 1), ("carry", 1)])


def eval_add_operation(b, a, bb, cols, is_real):
    """a + bb == value mod 256 with carry; u8 range checks via byte table."""
    base = 256
    w = b.when(is_real)
    overflow = a + bb - cols.value
    w.assert_zero(overflow * (overflow - base))
    w.assert_zero(cols.carry * (overflow - base))
    w.assert_zero((cols.carry - 1) * overflow)
    w.assert_bool(cols.carry)
    w.assert_bool(is_real)
    range_check_u8(b, a, is_real)
    range_check_u8(b, bb, is_real)
    range_check_u8(b, cols.value, is_real)


# ---------------------------------------------------------------------------
# IsZeroOperation (operations/is_zero.rs:16-66)
# ---------------------------------------------------------------------------

IS_ZERO_OPERATION = Layout([("inverse", 1), ("result", 1)])


def eval_is_zero(b, a, cols, is_real):
    is_zero = 1 - cols.inverse * a
    b.when(is_real).assert_eq(is_zero, cols.result)
    b.when(is_real).assert_bool(cols.result)
    b.when(is_real).when(cols.result).assert_zero(a)


# ---------------------------------------------------------------------------
# KoalaBearWordRangeChecker (operations/koala_bear_word.rs:12-107)
# Proves a 4-byte LE word is < p = 0x7f000001.
# ---------------------------------------------------------------------------

KB_WORD_RANGE_CHECKER = Layout(
    [
        ("most_sig_byte_decomp", 8),
        ("and_most_sig_byte_decomp_0_to_2", 1),
        ("and_most_sig_byte_decomp_0_to_3", 1),
        ("and_most_sig_byte_decomp_0_to_4", 1),
        ("and_most_sig_byte_decomp_0_to_5", 1),
        ("and_most_sig_byte_decomp_0_to_6", 1),
        ("and_most_sig_byte_decomp_0_to_7", 1),
    ]
)


def eval_kb_word_range_check(b, word, cols, is_real):
    """word: list of 4 byte values (LE)."""
    bits = cols.most_sig_byte_decomp
    w = b.when(is_real)
    recomposed = None
    for i, bit in enumerate(bits):
        w.assert_bool(bit)
        term = bit * (1 << i)
        recomposed = term if recomposed is None else recomposed + term
    w.assert_eq(recomposed, word[3])
    # top bit must be zero (value < 2^31)
    w.assert_zero(bits[7])
    # and-chain of bits 0..6; if all ones (msb == 0x7f) low bytes must be 0
    ands = [
        cols.and_most_sig_byte_decomp_0_to_2,
        cols.and_most_sig_byte_decomp_0_to_3,
        cols.and_most_sig_byte_decomp_0_to_4,
        cols.and_most_sig_byte_decomp_0_to_5,
        cols.and_most_sig_byte_decomp_0_to_6,
        cols.and_most_sig_byte_decomp_0_to_7,
    ]
    w.assert_eq(ands[0], bits[0] * bits[1])
    for k in range(1, 6):
        w.assert_eq(ands[k], ands[k - 1] * bits[k + 1])
    b.when(is_real).when(ands[5]).assert_zero(word[0] + word[1] + word[2])


# ---------------------------------------------------------------------------
# KoalaBearBitDecomposition (operations/koala_bear_range.rs:10-113)
# Full 32-bit variant of the word range check: prove a single field value,
# given as 32 bit columns, is < p = 0x7f000001.  Unused by the 8 chips in the
# reference too; kept as a utility gadget for parity.
# ---------------------------------------------------------------------------

KB_BIT_DECOMPOSITION = Layout(
    [
        ("bits", 32),
        ("and_most_sig_byte_decomp_0_to_2", 1),
        ("and_most_sig_byte_decomp_0_to_3", 1),
        ("and_most_sig_byte_decomp_0_to_4", 1),
        ("and_most_sig_byte_decomp_0_to_5", 1),
        ("and_most_sig_byte_decomp_0_to_6", 1),
        ("and_most_sig_byte_decomp_0_to_7", 1),
    ]
)


def eval_kb_bit_decomposition(b, value, cols, is_real):
    """value reconstructs from cols.bits; the reconstruction is < p."""
    w = b.when(is_real)
    recomposed = None
    for i, bit in enumerate(cols.bits):
        w.assert_bool(bit)
        term = bit * (1 << i)
        recomposed = term if recomposed is None else recomposed + term
    w.assert_eq(recomposed, value)
    msb = cols.bits[24:32]
    # value < 2^31, and if the top byte is 0x7f the low 24 bits must be 0
    w.assert_zero(msb[7])
    ands = [
        cols.and_most_sig_byte_decomp_0_to_2,
        cols.and_most_sig_byte_decomp_0_to_3,
        cols.and_most_sig_byte_decomp_0_to_4,
        cols.and_most_sig_byte_decomp_0_to_5,
        cols.and_most_sig_byte_decomp_0_to_6,
        cols.and_most_sig_byte_decomp_0_to_7,
    ]
    w.assert_eq(ands[0], msb[0] * msb[1])
    for k in range(1, 6):
        w.assert_eq(ands[k], ands[k - 1] * msb[k + 1])
    lower_sum = None
    for bit in cols.bits[0:24]:
        lower_sum = bit if lower_sum is None else lower_sum + bit
    b.when(is_real).when(ands[5]).assert_zero(lower_sum)


def reduce_word(word_vals):
    """Builder-side: Word -> single value sum b_i * 256^i."""
    acc = None
    for i, v in enumerate(word_vals):
        term = v * (1 << (8 * i))
        acc = term if acc is None else acc + term
    return acc


# ---------------------------------------------------------------------------
# Byte-table helpers (air/u8_air.rs, air/memory.rs:96-126)
# ---------------------------------------------------------------------------


def range_check_u8(b, value, multiplicity):
    b.send(LookupKind.BYTE, [0, value, 0], multiplicity)


def range_check_u16(b, value, multiplicity):
    b.send(LookupKind.BYTE, [1, 0, value], multiplicity)


def eval_range_check_24bits(b, value, limb16, limb8, do_check):
    """value == limb16 + limb8 * 2^16 with table range checks."""
    b.when(do_check).assert_eq(value, limb16 + limb8 * (1 << 16))
    range_check_u16(b, limb16, do_check)
    range_check_u8(b, limb8, do_check)


# ---------------------------------------------------------------------------
# Memory access columns (memory/consistency/cols.rs) + builder logic
# (air/memory.rs:12-95)
# ---------------------------------------------------------------------------

MEMORY_ACCESS_COLS = Layout(
    [("value", 1), ("prev_clk", 1), ("diff_16bit_limb", 1), ("diff_8bit_limb", 1)]
)

MEMORY_READ_WRITE_COLS = Layout([("prev_value", 1), ("access", MEMORY_ACCESS_COLS)])
MEMORY_WRITE_COLS = Layout([("prev_value", 1), ("access", MEMORY_ACCESS_COLS)])


def eval_memory_access(b, clk, addr, mem, do_check):
    """Timestamp ordering + the Memory-kind multiset send/receive pair."""
    b.assert_bool(do_check)
    access = mem.access
    diff_minus_one = clk - access.prev_clk - 1
    eval_range_check_24bits(
        b, diff_minus_one, access.diff_16bit_limb, access.diff_8bit_limb, do_check
    )
    b.send(LookupKind.MEMORY, [access.prev_clk, addr, mem.prev_value], do_check)
    b.receive(LookupKind.MEMORY, [clk, addr, access.value], do_check)
