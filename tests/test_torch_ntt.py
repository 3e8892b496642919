"""Port NTT (plain versions of the ntt_block_stages / ntt_stage kernels)
against the JAX package's NTT and its Pallas first-stages kernel (run in
interpret mode on the CPU, as tests/test_ntt_merkle.py runs it)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.ops import ntt as jnt
from zkvm_brainfuck_tpu.ops import ntt_pallas as jntp
from zkvm_brainfuck_tpu_torch.ops import field as tf
from zkvm_brainfuck_tpu_torch.ops import ntt as tnt

P = jf.P
CPU = torch.device("cpu")


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _jax(fn, a):
    return np.asarray(jf.from_monty(fn(jf.to_monty(jnp.asarray(a))))).astype(np.int32)


def test_tables_match_jax():
    for log_n in (1, 4, 11):
        want = jf.np_from_monty(jnt.twiddle_blob(log_n, False))
        assert np.array_equal(tnt.twiddle_blob(log_n, False), want)
        assert np.array_equal(tnt.twiddle_dev(log_n, True, CPU).numpy(),
                              jf.np_from_monty(jnt.twiddle_blob(log_n, True)).astype(np.int32))
        assert np.array_equal(tnt.bit_reversal_perm(log_n), jnt.bit_reversal_perm(log_n))
        assert np.array_equal(tnt.bitrev_dev(log_n, CPU).numpy(), jnt.bit_reversal_perm(log_n))


@pytest.mark.parametrize("log_n", [4, 11])
def test_ntt_intt_lde_match_jax(log_n):
    x = _rand(log_n, (1 << log_n, 3))
    assert np.array_equal(tnt.ntt(_t(x)).numpy(), _jax(jnt.ntt, x))
    assert np.array_equal(tnt.intt(_t(x)).numpy(), _jax(jnt.intt, x))
    got = tnt.coset_lde(_t(x), 1, tf.GENERATOR).numpy()
    assert np.array_equal(got, _jax(lambda e: jnt.coset_lde(e, 1, jf.GENERATOR), x))
    assert np.array_equal(tnt.intt(tnt.ntt(_t(x))).numpy(), x.astype(np.int32))


@pytest.mark.parametrize("log_n,k", [(11, 10), (4, 4)])
def test_block_stages_match_pallas(log_n, k):
    n, w = 1 << log_n, 3
    x = _rand(100 + log_n, (n, w))
    xb = x[jnt.bit_reversal_perm(log_n)]
    tw_m = jnp.asarray(jnt.twiddle_blob(log_n, False))  # Montgomery blob
    want = np.asarray(
        jf.from_monty(jntp.ntt_first_stages(jf.to_monty(jnp.asarray(xb)), tw_m, k))
    ).astype(np.int32)
    got = tnt.ntt_block_stages(_t(xb), tnt.twiddle_dev(log_n, False, CPU), k)
    assert np.array_equal(got.numpy(), want)


def test_stage_is_the_jax_stage_loop():
    """ntt_stage for s > 10 is the body of the JAX stage loop: stages
    11..log n after the block stages give the JAX NTT."""
    log_n = 12
    x = _rand(7, (1 << log_n, 2))
    tw = tnt.twiddle_dev(log_n, False, CPU)
    xb = _t(x[jnt.bit_reversal_perm(log_n)])
    xb = tnt.ntt_block_stages(xb, tw, 10)
    for s in (11, 12):
        xb = tnt.ntt_stage(xb, tw, s)
    assert np.array_equal(xb.numpy(), _jax(jnt.ntt, x))
