"""The opened values and reduced openings of the port (ops/openings.py, the
plain versions of csrc/openings.cu) on the CPU, against the JAX package's
programs on the same seeded inputs, exactly (p < 2^31: int64 is exact).

- open_eval_plain against `_open_eval_group_program` on the LDE coset and on
  a source domain of another shift, at two points;
- ro_accum_plain against `_ro_group_program`, writing (`first`) and adding;
- the low-memory source sub-unit (stark/pcs.py ro_src_accum) against
  `_ro_src_group_program`;
- a mesh shard's rows: over 8 equal row ranges the raw sums add up to the
  whole unit's and the reduced-opening rows join into the whole's;
- on CPU tensors the wrappers run the plain versions and count no launch;
  the launch path refuses CPU and int64 tensors with typed errors, and a
  unit of more members than one launch takes is split;
- the kernels' products on the int8 tensor cores (csrc/openings.cu), emulated
  in numpy step for step (byte planes, the 2^(8j) / 2^(8a) folds, 32-bit
  sums that must stay below 2^31 under their flush schedule, the 64-bit
  recombination), equal the plain versions: random members, every word
  p - 1 and every word p - 2 (bytes 255, 255, 255, 126), widths 1, 7, 8, 9
  and 45, a row count that is not a multiple of a tile, a flush crossed by
  one row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.stark import pcs as jpcs
from zkvm_brainfuck_tpu_torch.ops import ext as xe
from zkvm_brainfuck_tpu_torch.ops import field as xf
from zkvm_brainfuck_tpu_torch.ops import kernels as kn
from zkvm_brainfuck_tpu_torch.ops import openings as op
from zkvm_brainfuck_tpu_torch.ops.field import GENERATOR, P
from zkvm_brainfuck_tpu_torch.stark import pcs

WIDTHS = (3, 7, 1, 4)  # member widths of a unit
SHIFTS = {"lde": GENERATOR, "source": GENERATOR * 7 % P}


def _rand(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int32))


def _unit(seed, log_h, widths=WIDTHS):
    """Members, two points z and z', alpha powers, S and a reduced opening
    to add into, from a numpy seed."""
    rng = np.random.default_rng(seed)
    mats = [_rand(rng, (1 << log_h, w)) for w in widths]
    zs = [tuple(int(x) for x in _rand(rng, 4)) for _ in range(2)]
    aps = _rand(rng, (sum(widths), 4))
    s = tuple(int(x) for x in _rand(rng, 4))
    ro_in = _rand(rng, (1 << log_h, 4))
    return mats, zs, aps, s, ro_in


def _jmats(mats):
    return tuple(jf.to_monty(jnp.asarray(m)) for m in mats)


def _japs(aps, widths):
    return tuple(jnp.asarray(a) for a in np.split(aps, np.cumsum(widths)[:-1]))


@pytest.mark.parametrize("domain", sorted(SHIFTS))
@pytest.mark.parametrize("point", [0, 1])
def test_open_eval_plain_matches_jax(domain, point):
    log_h, shift = 6, SHIFTS[domain]
    mats, zs, _aps, _s, _ro = _unit(5, log_h)
    z = zs[point]
    got = op.open_eval_plain([_t(m) for m in mats], z, log_h, shift)
    want = jpcs._open_eval_group_program((log_h, shift), WIDTHS)(
        _jmats(mats), jnp.asarray(np.array(z, np.uint32)), jpcs._domain_points_dev(log_h, shift))
    assert got.dtype == torch.int32 and tuple(got.shape) == (sum(WIDTHS), 4)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("first", [True, False])
def test_ro_accum_plain_matches_jax(first):
    log_h = 7
    mats, zs, aps, s, ro_in = _unit(6, log_h)
    ro = None if first else _t(ro_in)
    got = op.ro_accum_plain(ro, [_t(m) for m in mats], _t(aps), s, zs[0], log_h, GENERATOR,
                            first=first)
    want = jpcs._ro_group_program(log_h, WIDTHS, first)(
        jnp.zeros((1, 4), jnp.uint32) if first else jf.to_monty(jnp.asarray(ro_in)),
        _jmats(mats), _japs(aps, WIDTHS), jnp.asarray(np.array(s, np.uint32)),
        jnp.asarray(np.array(zs[0], np.uint32)), jpcs._lde_points_dev(log_h))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jf.from_monty(want)))
    if not first:
        assert got is ro  # added in place


@pytest.mark.parametrize("first", [True, False])
def test_ro_src_accum_matches_jax(first):
    """The source sub-unit: q on shift*H_n (ro_accum writing), one 4-column
    LDE onto GENERATOR*H_2n, added into the reduced opening."""
    log_n, shift = 5, SHIFTS["source"]
    mats, zs, aps, s, _ro = _unit(7, log_n)
    ro_in = _rand(np.random.default_rng(8), (2 << log_n, 4))
    got = pcs.ro_src_accum(None if first else _t(ro_in), [_t(m) for m in mats], _t(aps), s, zs[1],
                           log_n, shift)
    want = jpcs._ro_src_group_program(log_n, shift, WIDTHS, first)(
        jnp.zeros((1, 4), jnp.uint32) if first else jf.to_monty(jnp.asarray(ro_in)),
        _jmats(mats), _japs(aps, WIDTHS), jnp.asarray(np.array(s, np.uint32)),
        jnp.asarray(np.array(zs[1], np.uint32)), jpcs._domain_points_dev(log_n, shift),
        jpcs._commit_aux(((log_n, shift, 4),)))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jf.from_monty(want)))


@pytest.mark.parametrize("domain", sorted(SHIFTS))
def test_shard_rows_add_up_to_the_whole_unit(domain):
    """row0 in 8 equal ranges (a mesh shard's rows): the parts' raw sums
    add up mod p to the whole unit's, and the parts' reduced-opening rows,
    written and then added into, join into the whole's."""
    log_h, shift, shards = 7, SHIFTS[domain], 8
    mats, zs, aps, s, ro_in = _unit(9, log_h)
    tmats, taps = [_t(m) for m in mats], _t(aps)
    rows = (1 << log_h) // shards
    whole = op.open_eval(tmats, zs[0], log_h, shift)
    parts = [op.open_eval([m[k * rows:(k + 1) * rows] for m in tmats], zs[0], log_h, shift,
                          row0=k * rows) for k in range(shards)]
    assert torch.equal((torch.stack(parts).to(torch.int64).sum(0) % P).to(torch.int32), whole)
    for first in (True, False):
        ro = None if first else _t(ro_in)
        whole = op.ro_accum(None if first else ro.clone(), tmats, taps, s, zs[1], log_h, shift,
                            first=first)
        parts = [op.ro_accum(None if first else ro[k * rows:(k + 1) * rows].clone(),
                             [m[k * rows:(k + 1) * rows] for m in tmats], taps, s, zs[1], log_h,
                             shift, row0=k * rows, first=first) for k in range(shards)]
        assert torch.equal(torch.cat(parts), whole), first


def test_wrappers_run_the_plain_versions_on_cpu_tensors(monkeypatch):
    mats, zs, aps, s, ro_in = _unit(10, 5)
    tmats = [_t(m) for m in mats]
    calls = []
    for name in ("open_eval_plain", "ro_accum_plain"):
        inner = getattr(op, name)
        monkeypatch.setattr(op, name, lambda *a, _i=inner, _n=name, **k: calls.append(_n) or _i(*a, **k))
    before = dict(kn.COUNTS)
    op.open_eval(tmats, zs[0], 5, GENERATOR)
    op.ro_accum(None, tmats, _t(aps), s, zs[0], 5, GENERATOR, first=True)
    op.ro_accum(_t(ro_in), tmats, _t(aps), s, zs[0], 5, GENERATOR)
    assert calls == ["open_eval_plain", "ro_accum_plain", "ro_accum_plain"]
    assert kn.COUNTS == before  # plain versions are not launches
    assert kn.COUNTS.keys() >= {"open_eval", "ro_accum"}


def test_launch_path_refuses_cpu_and_int64_tensors():
    """The CUDA launch path checks its inputs before it loads the library:
    an int64 member is a TypeError, a CPU member a ValueError; shapes that
    do not fit are ValueErrors on every device."""
    mats, zs, aps, s, _ro = _unit(11, 5)
    cpu32 = [_t(m) for m in mats]
    cpu64 = [m.to(torch.int64) for m in cpu32]
    with pytest.raises(TypeError):
        op._launch_open_eval(cpu64, zs[0], 5, GENERATOR, 0)
    with pytest.raises(ValueError):
        op._launch_open_eval(cpu32, zs[0], 5, GENERATOR, 0)
    with pytest.raises(TypeError):
        op._launch_ro_accum(None, cpu64, _t(aps), s, zs[0], 5, GENERATOR, 0, True)
    with pytest.raises(ValueError):
        op._launch_ro_accum(None, cpu32, _t(aps), s, zs[0], 5, GENERATOR, 0, True)
    with pytest.raises(ValueError):
        op.ro_accum(None, cpu32, _t(aps[1:]), s, zs[0], 5, GENERATOR, first=True)
    with pytest.raises(ValueError):
        op.ro_accum(None, cpu32, _t(aps), s, zs[0], 5, GENERATOR)  # adding needs a ro
    with pytest.raises(ValueError):
        op.open_eval(cpu32, zs[0], 5, GENERATOR, row0=8)  # rows past the domain


def test_units_of_more_members_than_a_launch_are_split():
    mats = [torch.zeros((4, 1 + k % 3), dtype=torch.int32) for k in range(2 * op.MAX_MEMBERS + 3)]
    chunks = op._chunks(mats)
    assert [k for c in chunks for k in c] == list(range(len(mats)))
    assert [len(c) for c in chunks] == [op.MAX_MEMBERS, op.MAX_MEMBERS, 3]
    assert op._chunks(mats[:5]) == [list(range(5))]


# ---------------------------------------------------------------------------
# The tensor-core scheme of csrc/openings.cu, emulated
# ---------------------------------------------------------------------------

TILE = 64  # rows of a tile (csrc/openings.cu TILE_ROWS[0])
FLUSH_ROWS = 8192  # rows an open_eval block's 32-bit sums take before a flush
S32 = 1 << 31
# name -> (log_m, member widths, rows, every member word or None, blocks of
# the open_eval emulation); rows < 2^log_m, row0 = 2^log_m - rows
SCHEME_CASES = {
    "random, widths 1 7 8 9 45, 100 rows": (7, (1, 7, 8, 9, 45), 100, None, 3),
    "every word p - 1": (7, (1, 7, 8, 9, 45), 100, P - 1, 2),
    "every word p - 2": (7, (1, 7, 8, 9, 45), 100, P - 2, 2),
    "a flush crossed by one row, 8193 rows of p - 2": (14, (9,), 8193, P - 2, 1),
}


def _bytes(a):
    """(...) values below 2^32 -> (..., 4) their bytes, lowest first."""
    return np.stack([(a >> (8 * b)) & 255 for b in range(4)], axis=-1)


def _recombine(d):
    """(..., 4) 32-bit sums D_b -> sum_b 2^(8b) D_b mod p, the sum in 64 bits."""
    assert int(d.max()) < S32 * 4  # so that the 64-bit sum is below 2^56 + 2^58
    t = sum(d[..., b] << (8 * b) for b in range(4))
    assert int(t.max()) < 1 << 63
    return t % P


def _weights(h, z, log_m, shift, row0):
    """(h, 4) canonical w_e(x_i) = x_i inv(x_i - z) (the plain helpers)."""
    pts = xf.coset_points(log_m, shift, row0, h, "cpu")
    w = xe.emul_base(op._inv_x_minus_z(pts, z), pts)
    return np.stack([x.numpy().astype(np.int64) for x in w], axis=-1)


def _scheme_open_eval(mats, z, log_m, shift, row0, blocks):
    """open_eval_kernel in numpy: `blocks` blocks, block k taking tiles k,
    k + blocks, ...; A_j = the bytes of w_e 2^(8j) mod p (planes 16 j + 4 e +
    b), B_j = byte j of the members; the four j's into one 32-bit sum per
    (column, e, b), flushed every FLUSH_ROWS rows a block into its sums mod
    p; the blocks' sums added mod p."""
    f = np.concatenate(mats, axis=1).astype(np.int64)
    h, width = f.shape
    w = _weights(h, z, log_m, shift, row0)
    a = _bytes(np.stack([w * (1 << (8 * j)) % P for j in range(4)], axis=1))  # (h, j, e, b)
    fb = _bytes(f)  # (h, c, j)
    out = np.zeros((width, 4), np.int64)
    tiles = -(-h // TILE)
    for blk in range(blocks):
        acc = np.zeros((width, 4, 4), np.int64)  # (c, e, b): the 32-bit sums
        since = 0
        for tile in range(blk, tiles, blocks):
            if since == FLUSH_ROWS // TILE:
                out = (out + _recombine(acc)) % P
                acc[:] = 0
                since = 0
            rows = slice(tile * TILE, min(h, (tile + 1) * TILE))
            acc += np.einsum("ijeb,icj->ceb", a[rows], fb[rows])
            assert int(acc.max()) < S32
            since += 1
        out = (out + _recombine(acc)) % P
    return out


def _scheme_ro_accum(ro, mats, aps, s, z, log_m, shift, row0, first):
    """ro_accum_kernel in numpy: A = the members' bytes (K = 8 columns x 4
    bytes a step), B = byte b of alpha[c, e] 2^(8a) mod p at (c, a), (e, b);
    each member's 32-bit sums per (row, e, b) into 64 bits, T = sum_b 2^(8b)
    D_b mod p, then (T - s) inv(x - z) written or added."""
    h = mats[0].shape[0]
    acc = np.zeros((h, 4, 4), np.int64)  # (i, e, b)
    off = 0
    for m in mats:
        width = m.shape[1]
        al = aps[off:off + width].astype(np.int64)  # (c, e)
        table = _bytes(np.stack([al * (1 << (8 * a)) % P for a in range(4)], axis=1))  # (c, a, e, b)
        for r0 in range(0, h, TILE):
            d = np.einsum("ica,caeb->ieb", _bytes(m[r0:r0 + TILE].astype(np.int64)), table)
            assert int(d.max()) < S32
            acc[r0:r0 + TILE] += d
        off += width
    t = _recombine(acc)
    pts = xf.coset_points(log_m, shift, row0, h, "cpu")
    diff = xe.esub(tuple(torch.from_numpy(t[:, e].astype(np.int32)) for e in range(4)), s)
    q = xe.to_array(xe.emul(diff, op._inv_x_minus_z(pts, z))).numpy().astype(np.int64)
    return q if first else (ro.astype(np.int64) + q) % P


@pytest.mark.parametrize("case", sorted(SCHEME_CASES))
def test_tensor_core_scheme_equals_plain(case):
    log_m, widths, h, fill, blocks = SCHEME_CASES[case]
    rng = np.random.default_rng(13)
    if fill is None:
        mats = [_rand(rng, (h, w)) for w in widths]
    else:
        mats = [np.full((h, w), fill, np.uint32) for w in widths]
    z, s = (tuple(int(x) for x in _rand(rng, 4)) for _ in range(2))
    aps, ro_in = _rand(rng, (sum(widths), 4)), _rand(rng, (h, 4))
    row0, shift = (1 << log_m) - h, SHIFTS["lde"]
    tmats = [_t(m) for m in mats]
    got = _scheme_open_eval(mats, z, log_m, shift, row0, blocks)
    want = op.open_eval_plain(tmats, z, log_m, shift, row0).numpy().astype(np.int64)
    assert np.array_equal(got, want)
    for first in (True, False):
        got = _scheme_ro_accum(ro_in, mats, aps, s, z, log_m, shift, row0, first)
        want = op.ro_accum_plain(None if first else _t(ro_in), tmats, _t(aps), s, z, log_m, shift,
                                 row0, first=first).numpy().astype(np.int64)
        assert np.array_equal(got, want), first
