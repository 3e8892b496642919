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
  unit of more members than one launch takes is split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.stark import pcs as jpcs
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
