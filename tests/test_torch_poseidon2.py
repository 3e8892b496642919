"""Port Poseidon2 (plain versions of the hash_rows / permute kernels) and the
port challenger against the JAX package and the pinned known answers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.ops import poseidon2 as jp2
from zkvm_brainfuck_tpu.stark.challenger import DuplexChallenger as JaxChallenger
from zkvm_brainfuck_tpu_torch.convert import challenger_from_jax, challenger_to_jax
from zkvm_brainfuck_tpu_torch.ops import poseidon2 as tp2
from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

P = jf.P

# Known answers pinned in tests/test_poseidon2.py (the JAX package's KATs).
PERMUTE_0_15_KAT = [
    1635930443, 1105042214, 1882043429, 1844048402, 1473750845, 312930215,
    1730043656, 527466685, 315587567, 16091010, 1900299987, 511572576,
    308360161, 643372060, 611592657, 1241962896,
]
HASH_0_16_KAT = [
    1082882034, 244805241, 625444968, 1281638361, 2007358707, 1894918424,
    2090591859, 494909322,
]
COMPRESS_KAT = [
    94054604, 837003546, 1213899664, 1951709641, 767324975, 1194706745,
    1901375086, 1958278263,
]
CHALLENGER_KAT = [1996372297, 146816208, 1377854112, 708914315]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _jax(fn, *args):
    out = fn(*[jf.to_monty(jnp.asarray(np.asarray(a, np.uint32))) for a in args])
    return np.asarray(jf.from_monty(out)).astype(np.int32)


def test_known_answers():
    assert tp2.permute_host(list(range(16))) == PERMUTE_0_15_KAT
    got = tp2.permute(_t(np.arange(16)[None]))
    assert got[0].tolist() == PERMUTE_0_15_KAT
    assert tp2.hash_host(list(range(17))) == HASH_0_16_KAT
    assert tp2.hash_rows(_t(np.arange(17)[None]))[0].tolist() == HASH_0_16_KAT
    right = [7, 11, 13, 17, 19, 23, 29, 31]
    assert tp2.compress_host(list(range(8)), right) == COMPRESS_KAT
    assert tp2.compress(_t(np.arange(8)[None]), _t([right]))[0].tolist() == COMPRESS_KAT
    c = DuplexChallenger()
    c.observe_slice(list(range(1, 9)))
    assert [c.sample() for _ in range(4)] == CHALLENGER_KAT


def test_constants_match_jax():
    assert tp2.RC_INITIAL == jp2.RC_INITIAL
    assert tp2.RC_INTERNAL == jp2.RC_INTERNAL
    assert tp2.RC_TERMINAL == jp2.RC_TERMINAL
    assert tp2.INTERNAL_DIAG == jp2.INTERNAL_DIAG
    rc_ext, rc_int, diag = tp2.montgomery_constants()
    assert rc_int == [jf.monty_of(v) for v in jp2.RC_INTERNAL]
    assert diag == [jf.monty_of(v) for v in jp2.INTERNAL_DIAG]
    assert len(rc_ext) == 8 * 16


def test_permute_matches_jax():
    states = np.random.default_rng(1).integers(0, P, size=(64, 16), dtype=np.uint32)
    states[0] = P - 1
    assert np.array_equal(tp2.permute(_t(states)).numpy(), _jax(jp2.permute, states))
    assert np.array_equal(tp2.permute(_t(states), out_cols=8).numpy(), _jax(jp2.permute, states)[:, :8])


@pytest.mark.parametrize("w", [1, 8, 31])
def test_hash_rows_matches_jax(w):
    m = np.random.default_rng(w).integers(0, P, size=(32, w), dtype=np.uint32)
    assert np.array_equal(tp2.hash_rows(_t(m)).numpy(), _jax(jp2.hash_rows, m))


def test_sponge_cols_matches_jax():
    m = np.random.default_rng(5).integers(0, P, size=(16, 11), dtype=np.uint32)
    got = tp2.sponge_cols([_t(m[:, i]) for i in range(11)])
    want = jp2.sponge_cols([jf.to_monty(jnp.asarray(m[:, i])) for i in range(11)])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(jf.from_monty(w)).astype(np.int32))


def test_hash_rows_concat_and_bitrev():
    """Several matrices hash as their row concatenation; bitrev permutes rows."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, P, size=(16, 5), dtype=np.uint32)
    b = rng.integers(0, P, size=(16, 4), dtype=np.uint32)
    cat = np.concatenate([a, b], axis=1)
    want = _jax(jp2.hash_rows, cat)
    assert np.array_equal(tp2.hash_rows([_t(a), _t(b)]).numpy(), want)
    from zkvm_brainfuck_tpu.ops.ntt import bit_reversal_perm

    got = tp2.hash_rows([_t(a), _t(b)], bitrev=True).numpy()
    assert np.array_equal(got, want[bit_reversal_perm(4)])


def test_compress_matches_jax():
    rng = np.random.default_rng(3)
    left = rng.integers(0, P, size=(16, 8), dtype=np.uint32)
    right = rng.integers(0, P, size=(16, 8), dtype=np.uint32)
    assert np.array_equal(tp2.compress(_t(left), _t(right)).numpy(), _jax(jp2.compress, left, right))


def test_numpy_host_versions_match_jax():
    rng = np.random.default_rng(4)
    s = rng.integers(0, P, size=(8, 16)).astype(np.uint64)
    assert np.array_equal(tp2.permute_np(s), jp2.permute_np(s))
    m = rng.integers(0, P, size=(8, 13)).astype(np.uint64)
    assert np.array_equal(tp2.hash_np(m), jp2.hash_np(m))
    assert np.array_equal(tp2.compress_np(s[:, :8], s[:, 8:]), jp2.compress_np(s[:, :8], s[:, 8:]))


def _transcript(c):
    c.observe_slice([5, 6, 7])
    out = [c.sample(), c.sample_ext()]
    c.observe_slice(list(range(100, 111)))
    out += [c.sample_bits(12), c.sample_ext(), c.sample()]
    c.observe(P + 3)  # reduced mod p
    out.append(c.sample_bits(20))
    return out


def test_challenger_transcript_matches_jax():
    assert _transcript(DuplexChallenger()) == _transcript(JaxChallenger())
    j = JaxChallenger()
    j.observe_slice([1, 2, 3])
    t = challenger_from_jax(j)
    assert _transcript(t) == _transcript(j)
    back = challenger_to_jax(t, JaxChallenger)  # mid-transcript, pending outputs
    assert _transcript(back) == _transcript(t)


def test_grind_matches_jax():
    j = JaxChallenger()
    j.observe_slice(list(range(5)))
    t = challenger_from_jax(j)
    wj = j.grind(8)
    wt = t.grind(8, "cpu")
    assert wt == wj
    assert t.state == j.state and t.output_buffer == j.output_buffer
    # the lowest witness: no smaller candidate passes
    fresh = JaxChallenger()
    fresh.observe_slice(list(range(5)))
    assert not any(fresh.clone().check_witness(8, w) for w in range(wt))
