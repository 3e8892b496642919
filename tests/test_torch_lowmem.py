"""The port's low-memory PCS mode and column-blocked LDEs (ZKBF_LOWMEM,
ZKBF_LOWMEM_LOG, ZKBF_BLK_LOG, ZKBF_BLK_W) on the CPU, at small sizes.

- printa through ProverClient in four modes reproduces the JAX-made golden
  vk, 1741-entry transcript and proof bytes (tests/golden/*_q84*).
- The mode functions and the source-domain evaluations equal the live JAX
  package's (`_lowmem_for`, `_lde_spans`, `quotient_block_widths`,
  `_open_eval_group_program`, `_ro_src_group_program`).
- The four-round opening layout gives the same opened values and proof in
  low-memory and mixed modes as in the normal mode, and both packages'
  verifiers accept it; a rebuilt root that differs raises.
"""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.stark import pcs as jpcs
from zkvm_brainfuck_tpu.stark import quotient as jquot
from zkvm_brainfuck_tpu_torch import ProverClient, convert, guests
from zkvm_brainfuck_tpu_torch.ops import openings
from zkvm_brainfuck_tpu_torch.sdk import CpuProver
from zkvm_brainfuck_tpu_torch.stark import pcs
from zkvm_brainfuck_tpu_torch.stark import prover as prover_mod
from zkvm_brainfuck_tpu_torch.stark import quotient as tquot
from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
from zkvm_brainfuck_tpu_torch.stark.config import FriConfig, KoalaBearPoseidon2
from zkvm_brainfuck_tpu_torch.stark.domains import Domain
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

P = jf.P
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MODE_VARS = ("ZKBF_LOWMEM", "ZKBF_LOWMEM_LOG", "ZKBF_BLK_LOG", "ZKBF_BLK_W")


def _golden(name, mode="rb"):
    with open(os.path.join(GOLDEN_DIR, name), mode) as fh:
        return fh.read()


def _set_env(monkeypatch, env):
    for k in MODE_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


class RecordingConfig(KoalaBearPoseidon2):
    """The production config (84 queries, 16 PoW bits); every challenger it
    makes records its observe/sample stream."""

    def __init__(self):
        super().__init__(FriConfig(log_blowup=1, num_queries=84, proof_of_work_bits=16))
        self.challengers = []

    def challenger(self):
        ch = super().challenger()
        ch.start_recording()
        self.challengers.append(ch)
        return ch


# (setup env, prove env, low-memory flag of each opened round
# [preprocessed, main, permutation, quotient]).  Every printa round's
# tallest LDE has 2^17 rows (the Byte chip), so no ZKBF_LOWMEM_LOG splits
# the rounds of one commit phase: the mixed case sets ZKBF_LOWMEM_LOG=18 for
# setup (a normal preprocessed round) and 17 for the prove (low-memory main,
# permutation and quotient rounds), the split the JAX package makes at 2^22.
MODES = {
    "lowmem": ({"ZKBF_LOWMEM": "1"}, {"ZKBF_LOWMEM": "1"}, [True] * 4),
    "lowmem_blocked": (
        {"ZKBF_LOWMEM": "1", "ZKBF_BLK_LOG": "4", "ZKBF_BLK_W": "8"},
        {"ZKBF_LOWMEM": "1", "ZKBF_BLK_LOG": "4", "ZKBF_BLK_W": "8"},
        [True] * 4,
    ),
    "normal_blocked": ({"ZKBF_LOWMEM": "0", "ZKBF_BLK_LOG": "4"},
                       {"ZKBF_LOWMEM": "0", "ZKBF_BLK_LOG": "4"}, [False] * 4),
    "mixed": ({"ZKBF_LOWMEM_LOG": "18"}, {"ZKBF_LOWMEM_LOG": "17"}, [False, True, True, True]),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_printa_golden_in_mode(mode, monkeypatch):
    setup_env, prove_env, want_flags = MODES[mode]
    rounds_seen, blocks_seen = [], []
    open_inner, quotient_inner = prover_mod.pcs_open, prover_mod.quotient_values

    def record_open(rounds, *args, **kwargs):
        rounds_seen.extend(d for d, _pts in rounds)
        return open_inner(rounds, *args, **kwargs)

    def record_quotient(chip, trace_domain, qdomain, prep, main, perm, *args):
        widths = {k: tuple(int(b.shape[1]) for b in v) if v is not None else ()
                  for k, v in (("prep", prep), ("main", main), ("perm", perm))}
        blocks_seen.append((chip, trace_domain.log_n, widths))
        return quotient_inner(chip, trace_domain, qdomain, prep, main, perm, *args)

    monkeypatch.setattr(prover_mod, "pcs_open", record_open)
    monkeypatch.setattr(prover_mod, "quotient_values", record_quotient)
    config = RecordingConfig()
    client = ProverClient(CpuProver(config=config, device="cpu"))
    _set_env(monkeypatch, setup_env)
    pk, vk = client.setup(guests.PRINTA_BF)
    _set_env(monkeypatch, prove_env)
    proof = client.prove(pk, b"").run()

    assert vk.to_bytes() == _golden("vk_printa_q84.bin")
    want = json.loads(_golden("transcript_printa_q84.json", "r"))["transcript"]
    got = config.challengers[0].record
    assert len(got) == 1741 and got == want
    assert proof.proof.proof.to_bytes() == _golden("proof_printa_q84.bin")
    client.verify(proof, vk)

    assert [d.lowmem for d in rounds_seen] == want_flags
    for d in rounds_seen:
        if d.lowmem:  # no LDE and no tree flat buffer after the commit
            assert d.ldes is None and d.tree.flat is None and d.tree.matrices is None
            assert len(d.evals) == len(d.sig)
    assert len(blocks_seen) == len(proof.proof.proof.shard_proof.opened_values)
    for chip, log_n, widths in blocks_seen:
        if want_flags[1]:
            prep_w = chip.preprocessed_width if widths["prep"] else 0
            assert widths == tquot.quotient_block_widths(chip, log_n, prep_w)
        else:  # the resident LDE, whole
            assert all(len(w) <= 1 for w in widths.values())


ENVS = [
    {},
    {"ZKBF_LOWMEM": "1"},
    {"ZKBF_LOWMEM": "0", "ZKBF_LOWMEM_LOG": "4"},
    {"ZKBF_LOWMEM_LOG": "8", "ZKBF_BLK_LOG": "4"},
    {"ZKBF_LOWMEM_LOG": "17", "ZKBF_BLK_LOG": "5", "ZKBF_BLK_W": "3"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items())
                         or "defaults")
def test_mode_functions_match_jax(env, monkeypatch):
    _set_env(monkeypatch, env)
    sigs = [((22, 1, 31), (21, 1, 7)), ((4, 1, 3),), ((7, 3, 4), (16, 5, 2)), ((16, 1, 2),)]
    for sig in sigs:
        assert pcs._lowmem_for(sig) == jpcs._lowmem_for(sig), sig
    for log_n in (2, 3, 4, 6, 16, 21, 22):
        for width in (1, 3, 4, 8, 9, 31, 36):
            assert pcs._lde_spans(log_n, width) == jpcs._lde_spans(log_n, width)
    for width, perm_width in ((31, 9), (1, 2), (7, 4)):
        chip = types.SimpleNamespace(width=width, permutation_width=perm_width)
        for log_n in (3, 4, 16, 22):
            for prep in (None, 0, 6):
                assert (tquot.quotient_block_widths(chip, log_n, prep)
                        == jquot.quotient_block_widths(chip, log_n, prep))


def _rand(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint32)


def _ef(rng):
    return tuple(int(x) for x in _rand(rng, 4))


def test_source_domain_evaluations_match_jax():
    """Opened-value raw sums and a reduced-opening contribution from evals on
    a shifted source domain (log_n 5, widths (3, 2)), against the JAX
    package's programs on the same seeded input."""
    rng = np.random.default_rng(61)
    log_n, shift, widths = 5, jf.GENERATOR * 7 % P, (3, 2)
    mats = [_rand(rng, (1 << log_n, w)) for w in widths]
    z = _ef(rng)
    tmats = [torch.from_numpy(m.astype(np.int32)) for m in mats]
    jmats = tuple(jf.to_monty(jnp.asarray(m)) for m in mats)
    z_arg = jnp.asarray(np.array(z, np.uint32))

    got = openings.open_eval(tmats, z, log_n, shift)
    want = jpcs._open_eval_group_program((log_n, shift), widths)(
        jmats, z_arg, jpcs._domain_points_dev(log_n, shift))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))

    aps = [_rand(rng, (w, 4)) for w in widths]
    s = _ef(rng)
    ro_in = _rand(rng, (2 << log_n, 4))
    alpha_pows = torch.from_numpy(np.concatenate(aps).astype(np.int32))
    for first in (True, False):
        ro = None if first else torch.from_numpy(ro_in.astype(np.int32))
        got = pcs.ro_src_accum(ro, tmats, alpha_pows, s, z, log_n, shift)
        want = jpcs._ro_src_group_program(log_n, shift, widths, first)(
            jf.to_monty(jnp.asarray(ro_in)) if not first else jnp.zeros((1, 4), jnp.uint32),
            jmats, tuple(jnp.asarray(a) for a in aps), jnp.asarray(np.array(s, np.uint32)), z_arg,
            jpcs._domain_points_dev(log_n, shift), jpcs._commit_aux(((log_n, shift, 4),)))
        got_arr = got.numpy().astype(np.uint32)
        assert np.array_equal(got_arr, np.asarray(jf.from_monty(want))), first


# (log_n, width, local_only) per matrix, per round: the machine's 4-round
# shape, log_n 2..9, local-only matrices opened at zeta alone; quotient
# chunks on shifted domains are the fourth round.
LAYOUT = [
    [(9, 2, False), (4, 3, False)],
    [(9, 3, False), (8, 2, True), (7, 4, False), (3, 5, True), (2, 1, False)],
    [(9, 8, False), (6, 8, False), (5, 4, False)],
]


def _plain(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in vars(x).items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _four_rounds(monkeypatch, envs):
    """Commit the layout's rounds (round r under envs[r]) and open them."""
    rng = np.random.default_rng(8)
    commits = []
    ch = DuplexChallenger()
    qdoms = Domain(9, 1).create_disjoint_domain(1 << 10).split_domains(2)
    mats = [[(Domain(ln, 1), _rand(rng, (1 << ln, w)), lo) for ln, w, lo in r] for r in LAYOUT]
    mats.append([(d, _rand(rng, (1 << 9, 4)), True) for d in qdoms])
    for env, r in zip(envs, mats):
        _set_env(monkeypatch, env)
        root, data = pcs.pcs_commit([(d, torch.from_numpy(e.astype(np.int32))) for d, e, _ in r],
                                    device="cpu")
        ch.observe_commitment([int(x) for x in root])
        commits.append((root, data, [(d, lo) for d, _e, lo in r]))
    _set_env(monkeypatch, {})
    zeta = ch.sample_ext()
    points = [[[zeta] if lo else [zeta, d.next_point_ef(zeta)] for d, lo in doms]
              for _root, _data, doms in commits]
    verifier_ch = ch.clone()
    opened, proof = pcs.pcs_open([(data, pts) for (_r, data, _d), pts in zip(commits, points)],
                                 ch, num_queries=12, pow_bits=6)
    claims = [([int(x) for x in root], [(d, [(z, opened[r][i][k]) for k, z in enumerate(points[r][i])])
                                        for i, (d, _lo) in enumerate(doms)])
              for r, (root, _data, doms) in enumerate(commits)]
    return [d for _r, d, _doms in commits], opened, proof, claims, verifier_ch


def test_four_round_layout_same_in_every_mode(monkeypatch):
    from zkvm_brainfuck_tpu.stark.challenger import DuplexChallenger as JaxChallenger
    from zkvm_brainfuck_tpu.stark.domains import Domain as JaxDomain
    from zkvm_brainfuck_tpu.stark.fri import FriProof as JaxFriProof

    _d, opened, proof, _claims, _vch = _four_rounds(monkeypatch, [{}] * 4)
    lowmem, mixed = {"ZKBF_LOWMEM": "1"}, {"ZKBF_LOWMEM": "1", "ZKBF_BLK_LOG": "4", "ZKBF_BLK_W": "3"}
    for envs in ([lowmem] * 4, [{}, mixed, {}, mixed]):
        datas, opened_lm, proof_lm, claims, vch = _four_rounds(monkeypatch, envs)
        assert [d.lowmem for d in datas] == ["ZKBF_LOWMEM" in e for e in envs]
        assert opened_lm == opened
        assert _plain(proof_lm) == _plain(proof)
        pcs.pcs_verify(claims, proof_lm, vch.clone(), num_queries=12, pow_bits=6)
        jclaims = [(root, [(JaxDomain(d.log_n, d.shift), pts) for d, pts in mats])
                   for root, mats in claims]
        jproof = convert._convert_pcs(proof_lm, jpcs.PcsProof, jpcs.BatchOpening, JaxFriProof)
        jpcs.pcs_verify(jclaims, jproof, convert.challenger_to_jax(vch, JaxChallenger),
                        num_queries=12, pow_bits=6)


def test_lowmem_rebuild_with_another_root_raises(monkeypatch):
    _set_env(monkeypatch, {"ZKBF_LOWMEM": "1"})
    rng = np.random.default_rng(5)
    evals = torch.from_numpy(_rand(rng, (1 << 5, 3)).astype(np.int32))
    root, data = pcs.pcs_commit([(Domain(5, 1), evals)], device="cpu")
    assert data.lowmem and data.tree.flat is None
    data.evals[0] = data.evals[0].clone()
    data.evals[0][7, 1] = (int(data.evals[0][7, 1]) + 1) % P  # not what was committed
    ch = DuplexChallenger()
    ch.observe_commitment([int(x) for x in root])
    z = ch.sample_ext()
    with pytest.raises(RuntimeError, match="different Merkle root"):
        pcs.pcs_open([(data, [[z]])], ch, num_queries=4, pow_bits=2)
