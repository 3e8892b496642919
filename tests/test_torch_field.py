"""Port field arithmetic (zkvm_brainfuck_tpu_torch.ops.field / ops.ext /
stark.ef_host) against the JAX package, exact equality on random values
including the edge values 0, 1 and p - 1."""

import numpy as np
import jax.numpy as jnp
import torch

from zkvm_brainfuck_tpu.ops import ext as jxe
from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.stark import ef_host as jefh
from zkvm_brainfuck_tpu_torch.ops import ext as txe
from zkvm_brainfuck_tpu_torch.ops import field as tf
from zkvm_brainfuck_tpu_torch.stark import ef_host as tefh
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

P = tf.P
EDGES = np.array([0, 1, P - 1, 2, P - 2], dtype=np.uint32)


def _vals(seed, n=1024, nonzero=False):
    rng = np.random.default_rng(seed)
    v = rng.integers(1 if nonzero else 0, P, size=n, dtype=np.uint32)
    e = EDGES[EDGES != 0] if nonzero else EDGES
    v[: len(e)] = e
    return v


def _jax(fn, *args):
    """Run a JAX Montgomery-form function on canonical numpy inputs."""
    out = fn(*[jf.to_monty(jnp.asarray(a)) for a in args])
    return np.asarray(jf.from_monty(out))


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def test_field_constants_match():
    assert tf.P == jf.P and tf.GENERATOR == jf.GENERATOR
    assert tf.TWO_ADIC_GENERATOR == jf.TWO_ADIC_GENERATOR and tf.W_EF4 == jf.W_EF4
    for k in (0, 1, 5, 24):
        assert tf.two_adic_root(k) == jf.two_adic_root(k)
    assert np.array_equal(tf.powers_host(7, 1000), jf.powers_host(7, 1000))
    assert np.array_equal(tf.powers_dev(7, 1024, "cpu").numpy(), jf.powers_host(7, 1024).astype(np.int32))
    for a, b in ((0, 1), (P - 1, P - 1), (12345, 678910)):
        assert tf.h_add(a, b) == jf.h_add(a, b) and tf.h_sub(a, b) == jf.h_sub(a, b)
        assert tf.h_mul(a, b) == jf.h_mul(a, b) and tf.monty_of(a) == jf.monty_of(a)
        if b:
            assert tf.h_inv(b) == jf.h_inv(b)
    v = _vals(6)
    assert np.array_equal(tf.np_to_monty(v), jf.np_to_monty(v))
    assert np.array_equal(tf.np_from_monty(jf.np_to_monty(v)), v)


def test_base_ops_match_jax():
    a, b = _vals(1), _vals(2)[::-1].copy()
    pairs = [
        (tf.fadd, jf.fadd),
        (tf.fsub, jf.fsub),
        (tf.fmul, jf.fmul),
    ]
    for tfn, jfn in pairs:
        assert np.array_equal(tfn(_t(a), _t(b)).numpy(), _jax(jfn, a, b).astype(np.int32))
    assert np.array_equal(tf.fneg(_t(a)).numpy(), _jax(jf.fneg, a).astype(np.int32))
    assert np.array_equal(tf.fhalve(_t(a)).numpy(), _jax(jf.fhalve, a).astype(np.int32))


def test_finv_matches_jax():
    a = _vals(3, nonzero=True)
    got = tf.finv(_t(a))
    assert np.array_equal(got.numpy(), _jax(jf.finv, a).astype(np.int32))
    assert (tf.fmul(got, _t(a)) == 1).all()
    assert int(tf.finv(torch.zeros(1, dtype=torch.int32))[0]) == 0


def test_fsum_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(0, P, size=(1 << 14, 3), dtype=np.uint32)
    x[:5, 0] = P - 1
    assert np.array_equal(tf.fsum_rows(_t(x)).numpy(), _jax(jf.fsum_rows, x).astype(np.int32))
    y = rng.integers(0, P, size=(40, 64), dtype=np.uint32)
    got = tf.fsum_small(_t(y), axis=0).numpy()
    want = _jax(lambda m: jf.fsum_small(m, axis=0), y)
    assert np.array_equal(got, want.astype(np.int32))


def _ef(seed, nonzero=False):
    return tuple(_vals(seed + k, nonzero=nonzero) for k in range(4))


def _jax_ef(fn, *efs):
    outs = fn(*[tuple(jf.to_monty(jnp.asarray(p)) for p in e) for e in efs])
    return tuple(np.asarray(jf.from_monty(o)).astype(np.int32) for o in outs)


def test_ext_ops_match_jax():
    a, b = _ef(10), _ef(20)
    ta, tb = tuple(map(_t, a)), tuple(map(_t, b))
    for tfn, jfn in ((txe.emul, jxe.emul), (txe.eadd, jxe.eadd), (txe.esub, jxe.esub)):
        got = tfn(ta, tb)
        want = _jax_ef(jfn, a, b)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w)


def test_einv_matches_jax():
    a = _ef(30, nonzero=True)
    got = txe.einv(tuple(map(_t, a)))
    want = _jax_ef(lambda x: jxe.einv(x), a)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    one = txe.emul(got, tuple(map(_t, a)))
    assert (one[0] == 1).all() and all((p == 0).all() for p in one[1:])


def test_ef_host_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a = tuple(int(x) for x in rng.integers(0, P, 4))
        b = tuple(int(x) for x in rng.integers(0, P, 4))
        assert tefh.mul(a, b) == jefh.mul(a, b)
        assert tefh.add(a, b) == jefh.add(a, b)
        assert tefh.inv(a) == jefh.inv(a)
        assert tefh.epow(a, 12345) == jefh.epow(a, 12345)
    va = rng.integers(0, P, size=(64, 4)).astype(np.uint64)
    vb = rng.integers(0, P, size=(64, 4)).astype(np.uint64)
    assert np.array_equal(tefh.v_mul(va, vb), jefh.v_mul(va, vb))
    assert np.array_equal(tefh.v_inv(va), jefh.v_inv(va))
