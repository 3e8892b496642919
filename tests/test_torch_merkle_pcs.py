"""Port Merkle MMCS and PCS commit against the JAX package; a port-only
pcs_open -> pcs_verify round trip (JAX's pcs_open is compared through the
whole-slice test in test_torch_uni.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.ops import merkle as jmk
from zkvm_brainfuck_tpu.stark import domains as jdom
from zkvm_brainfuck_tpu.stark import pcs as jpcs
from zkvm_brainfuck_tpu_torch import convert
from zkvm_brainfuck_tpu_torch.ops import merkle as tmk
from zkvm_brainfuck_tpu_torch.stark import pcs as tpcs
from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
from zkvm_brainfuck_tpu_torch.stark.domains import Domain
from zkvm_brainfuck_tpu_torch.stark.errors import VerificationFailure
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

P = jf.P


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _m(a):
    return jf.to_monty(jnp.asarray(a))


@pytest.mark.parametrize("heights", [(64,), (64, 32, 16)])
def test_merkle_root_and_opening_match_jax(heights):
    mats = [_rand(i + 10, (h, 3 + i)) for i, h in enumerate(heights)]
    jtree = jmk.commit([_m(m) for m in mats])
    ttree = tmk.commit([_t(m) for m in mats])
    assert np.array_equal(ttree.root, jtree.root)
    assert ttree.plan == tmk.make_plan(heights)
    assert ttree.plan.level_off == jtree.plan.level_off
    assert ttree.plan.inject_levels == jtree.plan.inject_levels

    idx = np.array([0, 5, 17, 63])
    rows, paths = tmk.open_batch(ttree, idx)
    jrows, jpaths = jmk.open_batch(jtree, idx)
    for r, jr in zip(rows, jrows):
        assert np.array_equal(r, jr)
    assert np.array_equal(paths, jpaths)
    dims = [(m.shape[0], m.shape[1]) for m in mats]
    assert tmk.verify_batch_np(ttree.root, dims, idx, rows, paths).all()
    assert jmk.verify_batch_np(ttree.root, dims, idx, rows, paths).all()
    bad = [r.copy() for r in rows]
    bad[0][1, 0] ^= 1
    ok = tmk.verify_batch_np(ttree.root, dims, idx, bad, paths)
    assert list(ok) == [True, False, True, True]


def test_pcs_commit_matches_jax():
    """Two heights and a shifted domain in one batch (the quotient chunks'
    shape), same root and same natural-order LDEs as the JAX commit."""
    specs = [(5, 1, 3), (5, jf.GENERATOR * 7 % P, 4), (4, 1, 2)]
    mats = [_rand(20 + i, (1 << ln, w)) for i, (ln, _s, w) in enumerate(specs)]
    jroot, jdata = jpcs.pcs_commit(
        [(jdom.Domain(ln, s), _m(m)) for (ln, s, _w), m in zip(specs, mats)]
    )
    troot, tdata = tpcs.pcs_commit(
        [(Domain(ln, s), _t(m)) for (ln, s, _w), m in zip(specs, mats)], device="cpu"
    )
    assert np.array_equal(troot, np.asarray(jroot))
    for tl, jl in zip(tdata.ldes, jdata.ldes):
        assert torch.equal(tl, convert.matrix_from_jax(jl, montgomery=True))


def test_pcs_open_verify_roundtrip():
    rng = np.random.default_rng(7)
    log_n, w = 6, 5
    evals = _t(rng.integers(0, P, size=(1 << log_n, w), dtype=np.uint32))
    dom = Domain(log_n, 1)
    root, data = tpcs.pcs_commit([(dom, evals)], device="cpu")
    ch = DuplexChallenger()
    ch.observe_commitment([int(x) for x in root])
    z = ch.sample_ext()
    z2 = dom.next_point_ef(z)
    opened, proof = tpcs.pcs_open([(data, [[z, z2]])], ch, num_queries=8, pow_bits=4)

    # opened values are the polynomial's values: check one column directly
    from zkvm_brainfuck_tpu_torch.ops import ntt as tnt
    from zkvm_brainfuck_tpu_torch.stark import ef_host as efh

    coeffs = tnt.intt(evals[:, :1])[:, 0].tolist()
    acc = efh.ZERO
    for c in reversed(coeffs):
        acc = efh.add_base(efh.mul(acc, z), c)
    assert opened[0][0][0][0] == acc

    def verify(vals):
        vch = DuplexChallenger()
        vch.observe_commitment([int(x) for x in root])
        vch.sample_ext()
        tpcs.pcs_verify(
            [(root, [(dom, [(z, vals[0]), (z2, vals[1])])])], proof, vch,
            num_queries=8, pow_bits=4,
        )

    verify(opened[0][0])
    bad = [list(opened[0][0][0]), list(opened[0][0][1])]
    bad[0][2] = ((bad[0][2][0] + 1) % P,) + tuple(bad[0][2][1:])
    with pytest.raises(VerificationFailure):
        verify(bad)


@pytest.mark.parametrize("log_h", range(1, 24))
def test_reverse_bits_equals_the_table(log_h):
    from zkvm_brainfuck_tpu_torch.ops import ntt as tnt

    idx = np.random.default_rng(log_h).integers(0, 1 << log_h, size=84)
    table = tnt.bit_reversal_perm.__wrapped__(log_h)  # uncached: no 2^23 table kept
    assert np.array_equal(tnt.reverse_bits(idx, log_h), table[idx])


def test_pcs_open_verify_without_index_tables(monkeypatch):
    """The prover's and the verifier's query paths build no table of the
    whole domain: a normal and a low-memory round open and verify with the
    bit-reversal table and the host domain points made to raise."""
    from zkvm_brainfuck_tpu_torch.ops import ntt as tnt

    def refuse(*_args):
        raise AssertionError("a whole-domain table was built on the query path")

    rng = np.random.default_rng(9)
    doms = [Domain(6, 1), Domain(4, 1)]
    rounds, claims = [], []
    ch = DuplexChallenger()
    for lowmem in ("0", "1"):
        monkeypatch.setenv("ZKBF_LOWMEM", lowmem)
        evals = [_t(rng.integers(0, P, size=(d.size, 3), dtype=np.uint32)) for d in doms]
        root, data = tpcs.pcs_commit(list(zip(doms, evals)), device="cpu")
        assert data.lowmem == (lowmem == "1")
        ch.observe_commitment([int(x) for x in root])
        rounds.append(data)
        claims.append([int(x) for x in root])
    z = ch.sample_ext()
    vch = ch.clone()
    monkeypatch.setattr(tnt, "bit_reversal_perm", refuse)
    monkeypatch.setattr(Domain, "points_host", refuse)
    opened, proof = tpcs.pcs_open([(d, [[z], [z]]) for d in rounds], ch, num_queries=8, pow_bits=4)
    tpcs.pcs_verify(
        [(root, [(d, [(z, opened[r][i][0])]) for i, d in enumerate(doms)])
         for r, root in enumerate(claims)],
        proof, vch, num_queries=8, pow_bits=4,
    )
