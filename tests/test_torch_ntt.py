"""Port NTT (plain versions of the ntt_block_stages / ntt_stage kernels)
against the JAX package's NTT and its Pallas first-stages kernel (run in
interpret mode on the CPU, as tests/test_ntt_merkle.py runs it), and the
fused LDE against the composition it replaced."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.ops import ntt as jnt
from zkvm_brainfuck_tpu.ops import ntt_pallas as jntp
from zkvm_brainfuck_tpu_torch.ops import field as tf
from zkvm_brainfuck_tpu_torch.ops import ntt as tnt
from zkvm_brainfuck_tpu_torch.stark import pcs as tpcs
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

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
        for inverse in (False, True):  # the kernels' blob is the JAX (Montgomery) blob
            assert np.array_equal(tnt.twiddle_mont_dev(log_n, inverse, CPU).numpy(),
                                  np.asarray(jnt.twiddle_blob(log_n, inverse)).astype(np.int32))
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


@pytest.mark.parametrize("log_n,pass_log", [(13, 1), (13, 2), (12, 5)])
def test_stage_split_matches_jax(log_n, pass_log):
    """Stages above the block pass split into passes of at most `pass_log`
    stages give the same NTT, iNTT and LDE as the JAX package."""
    x = _rand(200 + log_n, (1 << log_n, 2))
    assert np.array_equal(tnt.ntt_dev(_t(x), log_n, False, pass_log).numpy(), _jax(jnt.ntt, x))
    assert np.array_equal(tnt.ntt_dev(_t(x), log_n, True, pass_log).numpy(), _jax(jnt.intt, x))
    got = tnt.coset_lde(_t(x), 1, tf.GENERATOR, pass_log=pass_log).numpy()
    assert np.array_equal(got, _jax(lambda e: jnt.coset_lde(e, 1, jf.GENERATOR), x))


@pytest.mark.parametrize("log_n,k", [(11, 10), (4, 4)])
def test_block_stages_match_pallas(log_n, k):
    """The block pass takes the natural-order input and gathers the
    bit-reversed rows itself; the Pallas kernel is given them gathered."""
    n, w = 1 << log_n, 3
    x = _rand(100 + log_n, (n, w))
    xb = x[jnt.bit_reversal_perm(log_n)]
    tw_m = jnp.asarray(jnt.twiddle_blob(log_n, False))  # Montgomery blob
    want = np.asarray(
        jf.from_monty(jntp.ntt_first_stages(jf.to_monty(jnp.asarray(xb)), tw_m, k))
    ).astype(np.int32)
    got = tnt.ntt_block_stages(_t(x), log_n, k)
    assert np.array_equal(got.numpy(), want)


def test_stage_is_the_jax_stage_loop():
    """ntt_stage over stages 11..log n, after the block stages, gives the
    JAX NTT; it runs in place."""
    log_n = 12
    x = _rand(7, (1 << log_n, 2))
    xb = tnt.ntt_block_stages(_t(x), log_n, 10)
    out = tnt.ntt_stage(xb, 11, 12)
    assert out is xb
    assert np.array_equal(xb.numpy(), _jax(jnt.ntt, x))


def _old_lde(x: torch.Tensor, log_n: int, shift: int) -> torch.Tensor:
    """The LDE as it was composed before the block pass took over its glue:
    gather, all stages, n^-1 multiply, shift-power multiply, zero block,
    gather, all stages."""
    def old_ntt(v, ln, inverse):
        v = v[torch.from_numpy(tnt.bit_reversal_perm(ln))]
        v = tnt.ntt_stage_plain(v, 1, ln, inverse)
        return tf.fmul(v, pow(1 << ln, P - 2, P)) if inverse else v

    n = 1 << log_n
    c = old_ntt(x, log_n, True)
    lde_shift = tf.GENERATOR * pow(shift, P - 2, P) % P
    c = tf.fmul(c, tf.powers_dev(lde_shift, n, CPU)[:, None])
    return old_ntt(torch.cat([c, torch.zeros_like(c)]), log_n + 1, False)


@pytest.mark.parametrize(
    "log_n,pass_log,shift",
    [(5, 12, 1), (9, 12, tf.GENERATOR), (10, 12, 1), (12, 1, tf.GENERATOR), (13, 2, 1)],
    ids=["below-one-block", "lde-one-block", "inverse-one-block", "split-1", "split-2"],
)
def test_fused_lde_matches_old_composition(log_n, pass_log, shift):
    x = _t(_rand(300 + log_n, (1 << log_n, 3)))
    want = _old_lde(x, log_n, shift)
    lde_shift = tf.GENERATOR * pow(shift, P - 2, P) % P
    got = tnt.coset_lde(x, 1, lde_shift, pass_log=pass_log)
    assert torch.equal(got, want)
    if pass_log == tnt.PASS_LOG_MAX:
        assert torch.equal(tpcs.lde(x, log_n, shift), want)


def test_block_stages_zero_rows_and_factors():
    """Rows >= m read as zero and factors scale the input rows: the same as
    scaling and padding first."""
    log_n, m = 6, 32
    x = _t(_rand(5, (m, 4)))
    fac = _t(_rand(6, (m,)))
    padded = torch.cat([tf.fmul(x, fac[:, None]), torch.zeros((m, 4), dtype=torch.int32)])
    for k in (1, 3, 6):
        want = tnt.ntt_block_stages(padded, log_n, k)
        assert torch.equal(tnt.ntt_block_stages(x, log_n, k, factors=fac), want)
    with pytest.raises(ValueError):
        tnt.ntt_block_stages(x, log_n, 7)
    with pytest.raises(ValueError):
        tnt.ntt_stage(padded, 1, 13)


@pytest.mark.cuda
def test_ntt_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the NTT kernels are CUDA only")
    dev = torch.device("cuda")
    for log_n, w, pass_log in ((12, 31, 12), (13, 5, 2), (7, 9, 12)):
        x = _t(_rand(log_n, (1 << log_n, w)))
        for inverse in (False, True):
            got = tnt.ntt_dev(x.to(dev), log_n, inverse, pass_log).cpu()
            assert torch.equal(got, tnt.ntt_dev(x, log_n, inverse, pass_log))
        got = tnt.coset_lde(x.to(dev), 1, 7, pass_log=pass_log).cpu()
        assert torch.equal(got, tnt.coset_lde(x, 1, 7, pass_log=pass_log))
