"""The port's low-memory PCS mode and column-blocked LDEs over an 8-shard
mesh of CPU devices (stark/pcs.py with row-sharded rounds), against the
port's single-device results, the JAX package's source-domain programs and
the `printa` golden files.

- printa set up and proved under the mesh in the four modes of
  tests/test_torch_lowmem.py reproduces the golden vk, 1741-entry
  transcript and proof; one setup and prove a mode serves every test.
- The sharded blocked and low-memory commits give the single-device root,
  the sharded low-memory query openings its rows and paths (a rebuild
  with another root raises), and the sharded source-domain opened values
  and reduced-opening sub-unit its values and the JAX package's.
- Every kept or recomputed intermediate holds 1/8 of its rows a shard.

Every comparison is exact (integer field values).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lowmem import MODES, RecordingConfig, _ef, _golden, _rand, _set_env
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.stark import pcs as jpcs
from zkvm_brainfuck_tpu_torch import ProverClient, guests
from zkvm_brainfuck_tpu_torch.ops import openings
from zkvm_brainfuck_tpu_torch.ops.field import GENERATOR, P
from zkvm_brainfuck_tpu_torch.parallel import collectives as co
from zkvm_brainfuck_tpu_torch.parallel.mesh import (
    RowSharded,
    make_row_mesh,
    set_shard_mesh,
    shard_fraction,
)
from zkvm_brainfuck_tpu_torch.sdk import CpuProver
from zkvm_brainfuck_tpu_torch.stark import pcs
from zkvm_brainfuck_tpu_torch.stark import prover as stark_prover
from zkvm_brainfuck_tpu_torch.stark import quotient as tquot
from zkvm_brainfuck_tpu_torch.stark.domains import Domain

SHARDS = 8


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int32))


@pytest.fixture(scope="module")
def mesh():
    return make_row_mesh(devices=["cpu"] * SHARDS)


def _prove_in_mode(mesh, mode):
    """printa set up and proved under the mesh in `mode`; the opened rounds,
    every LDE block made (commit, quotient and query time), every digest
    layer and each quotient call's block widths (with those that
    `quotient_block_widths` gives) and values are recorded."""
    setup_env, prove_env, _flags = MODES[mode]
    seen = {"rounds": [], "blocks": [], "digests": [], "quotient": []}
    open_inner, quotient_inner = stark_prover.pcs_open, stark_prover.quotient_values
    blocks_inner, digest_inner = pcs._lde_blocks, pcs.sharded_digest_layer

    def record_open(rounds, *args, **kwargs):
        seen["rounds"].extend(d for d, _pts in rounds)
        return open_inner(rounds, *args, **kwargs)

    def record_quotient(chip, trace_domain, qdomain, prep, main, perm, *args):
        widths = {k: tuple(int(b.shape[1]) for b in v) if v is not None else ()
                  for k, v in (("prep", prep), ("main", main), ("perm", perm))}
        # the low-memory widths, read under the prove's environment
        want = tquot.quotient_block_widths(chip, trace_domain.log_n,
                                           chip.preprocessed_width if prep is not None else 0)
        out = quotient_inner(chip, trace_domain, qdomain, prep, main, perm, *args)
        seen["quotient"].append((widths, want, out))
        return out

    def record_blocks(*args):
        out = blocks_inner(*args)
        seen["blocks"].extend(out)
        return out

    def record_digests(*args):
        out = digest_inner(*args)
        seen["digests"].append(out)
        return out

    config = RecordingConfig()
    client = ProverClient(CpuProver(config=config, device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stark_prover, "pcs_open", record_open)
        mp.setattr(stark_prover, "quotient_values", record_quotient)
        mp.setattr(pcs, "_lde_blocks", record_blocks)
        mp.setattr(pcs, "sharded_digest_layer", record_digests)
        set_shard_mesh(mesh)
        try:
            _set_env(mp, setup_env)
            pk, vk = client.setup(guests.PRINTA_BF)
            _set_env(mp, prove_env)
            proof = client.prove(pk, b"").run()
        finally:
            set_shard_mesh(None)
    return client, pk, vk, proof, config.challengers[0].record, seen


@pytest.fixture(scope="module")
def mode_run(mesh):
    runs = {}

    def run(mode):
        if mode not in runs:
            runs[mode] = _prove_in_mode(mesh, mode)
        return runs[mode]

    return run


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mesh_printa_golden_in_mode(mode_run, mode):
    client, pk, vk, proof, transcript, seen = mode_run(mode)
    assert vk.to_bytes() == _golden("vk_printa_q84.bin")
    want = json.loads(_golden("transcript_printa_q84.json", "r"))["transcript"]
    assert len(transcript) == 1741 and transcript == want
    assert proof.proof.proof.to_bytes() == _golden("proof_printa_q84.bin")
    client.verify(proof, vk)

    want_flags = MODES[mode][2]
    assert [d.lowmem for d in seen["rounds"]] == want_flags
    for d in seen["rounds"]:
        assert d.mesh is not None and d.mesh.size == SHARDS
        if d.lowmem:  # the row-sharded evals, the plan and the root only
            assert d.ldes is None and d.tree.flat is None and d.tree.matrices is None
            assert all(isinstance(e, RowSharded) for e in d.evals)
        else:
            assert all(isinstance(x, RowSharded) for x in d.ldes)
    assert len(seen["quotient"]) == len(proof.proof.proof.shard_proof.opened_values)
    for widths, want_widths, _q in seen["quotient"]:
        if want_flags[1]:
            assert widths == want_widths
        else:  # the resident LDE, whole
            assert all(len(w) <= 1 for w in widths.values())


def test_mesh_lowmem_intermediates_stay_sharded(mode_run):
    """In the low-memory blocked mode, the kept evals of every round, every
    LDE block (committed, recomputed for the quotient and rebuilt for the
    queries), every digest layer and the quotient values hold 1/8 of their
    rows on each shard."""
    _client, _pk, _vk, _proof, _tr, seen = mode_run("lowmem_blocked")
    groups = {
        "kept evals": [e for d in seen["rounds"] for e in d.evals],
        "LDE blocks": seen["blocks"],
        "leaf digests": seen["digests"],
        "quotient values": [q for _w, _want, q in seen["quotient"]],
    }
    assert any(b.shape[1] < 8 for b in seen["blocks"])  # narrow tail blocks too
    for what, items in groups.items():
        assert items, what
        for x in items:
            assert isinstance(x, RowSharded), what
            assert shard_fraction(x) <= 1.01 / SHARDS, f"{what}: {shard_fraction(x)} of {x.shape}"


# ---------------------------------------------------------------------------
# Unit tests against the single-device port and the JAX package
# ---------------------------------------------------------------------------

COMMIT_ENVS = {
    "lowmem": {"ZKBF_LOWMEM": "1", "ZKBF_BLK_LOG": "4", "ZKBF_BLK_W": "2"},
    "normal_blocked": {"ZKBF_LOWMEM": "0", "ZKBF_BLK_LOG": "4", "ZKBF_BLK_W": "2"},
}


def _commit_both(mesh, monkeypatch, env, heights, seed):
    """A batch (widths 3, 2, 5; shifts 1, GENERATOR, 1) committed on one
    device and row-sharded under `env`."""
    _set_env(monkeypatch, env)
    rng = np.random.default_rng(seed)
    mats = [_t(_rand(rng, (h, w))) for h, w in zip(heights, (3, 2, 5))]
    domains = [Domain(h.bit_length() - 1, s) for h, s in zip(heights, (1, GENERATOR, 1))]
    root, data = pcs.pcs_commit(list(zip(domains, mats)), device="cpu")
    root8, data8 = pcs.pcs_commit(list(zip(domains, [co.scatter(m, mesh) for m in mats])),
                                  device="cpu")
    return rng, (root, data), (root8, data8)


@pytest.mark.parametrize("heights", [(16,), (1 << 10, 1 << 8, 16)])
@pytest.mark.parametrize("mode", sorted(COMMIT_ENVS))
def test_sharded_blocked_and_lowmem_commit_equal_single_device(mesh, monkeypatch, mode, heights):
    """Heights as in test_torch_sharded.py: a 16-row matrix takes the
    gather branch; 2^10 and 2^8 rows run the 4-step LDE a block."""
    _rng, (root, data), (root8, data8) = _commit_both(mesh, monkeypatch, COMMIT_ENVS[mode],
                                                      heights, len(heights))
    assert np.array_equal(root8, root)
    assert data8.lowmem == data.lowmem == (mode == "lowmem")
    assert data8.mesh == mesh
    for i, (log_n, _shift, width) in enumerate(data.sig):
        blocks, blocks8 = data.lde_blocks(i), data8.lde_blocks(i)
        # recomputed 2-column blocks, or the resident LDE joined from them
        assert len(blocks8) == len(blocks) == (-(-width // 2) if data.lowmem else 1)
        for b, b8 in zip(blocks, blocks8):
            assert shard_fraction(b8) == 1 / SHARDS
            assert torch.equal(b8.gather(), b)
    if data8.lowmem:
        assert data8.tree.flat is None and all(shard_fraction(e) == 1 / SHARDS for e in data8.evals)
    else:
        assert torch.equal(data8.tree.gather_flat(), data.tree.flat)


def test_sharded_lowmem_query_openings_equal_single_device(mesh, monkeypatch):
    rng, (_root, data), (_root8, data8) = _commit_both(
        mesh, monkeypatch, COMMIT_ENVS["lowmem"], (1 << 10, 1 << 8, 16), 3)
    log_global = data.tree.plan.log_max
    idx = rng.integers(0, 1 << log_global, 20)
    rows, paths = pcs._lowmem_round_openings(data, idx, log_global)
    rows8, paths8 = pcs._lowmem_round_openings(data8, idx, log_global)
    assert [r.shape for r in rows8] == [(20, 3), (20, 2), (20, 5)]
    assert all(np.array_equal(a, b) for a, b in zip(rows8, rows))
    assert np.array_equal(paths8, paths)


def test_sharded_lowmem_rebuild_with_another_root_raises(mesh, monkeypatch):
    rng, _single, (_root8, data8) = _commit_both(
        mesh, monkeypatch, COMMIT_ENVS["lowmem"], (1 << 10, 1 << 8, 16), 4)
    block = data8.evals[0].blocks[5]
    block[3, 1] = (int(block[3, 1]) + 1) % P  # shard 5's rows are not what was committed
    log_global = data8.tree.plan.log_max
    with pytest.raises(RuntimeError, match="different Merkle root"):
        pcs._lowmem_round_openings(data8, rng.integers(0, 1 << log_global, 4), log_global)


@pytest.mark.parametrize("log_n", [4, 7])
def test_sharded_source_domain_evaluations_equal_single_device_and_jax(mesh, log_n):
    """Opened-value raw sums and the "src" reduced-opening sub-unit from evals
    on a shifted source domain (widths (3, 2)), row-sharded, against the
    single-device port and the JAX package's programs.  2^4 rows take the
    gather branch of the sub-unit's 4-column LDE, 2^7 the 4-step NTT."""
    rng = np.random.default_rng(61 + log_n)
    shift, widths = GENERATOR * 7 % P, (3, 2)
    mats = [_rand(rng, (1 << log_n, w)) for w in widths]
    z = _ef(rng)
    tmats = [_t(m) for m in mats]
    smats = [co.scatter(m, mesh) for m in tmats]
    jmats = tuple(jf.to_monty(jnp.asarray(m)) for m in mats)
    z_arg = jnp.asarray(np.array(z, np.uint32))

    got = pcs._open_eval_sharded(mesh, smats, z, log_n, shift)
    single = openings.open_eval(tmats, z, log_n, shift)
    want = jpcs._open_eval_group_program((log_n, shift), widths)(
        jmats, z_arg, jpcs._domain_points_dev(log_n, shift))
    assert torch.equal(got, single)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))

    aps = [_rand(rng, (w, 4)) for w in widths]
    s = _ef(rng)
    ro_in = _rand(rng, (2 << log_n, 4))
    host_aps = [tuple(int(v) for v in row) for a in aps for row in a]
    for first in (True, False):
        acc = None if first else list(co.scatter(_t(ro_in), mesh).blocks)
        parts = pcs._ro_src_accum_sharded(mesh, acc, smats, host_aps, s, z, log_n, shift)
        assert [p.shape for p in parts] == [((2 << log_n) // SHARDS, 4)] * SHARDS
        got = torch.cat(parts)
        ro = None if first else _t(ro_in)
        single = pcs.ro_src_accum(ro, tmats, _t(np.concatenate(aps)), s, z, log_n, shift)
        want = jpcs._ro_src_group_program(log_n, shift, widths, first)(
            jf.to_monty(jnp.asarray(ro_in)) if not first else jnp.zeros((1, 4), jnp.uint32),
            jmats, tuple(jnp.asarray(a) for a in aps), jnp.asarray(np.array(s, np.uint32)), z_arg,
            jpcs._domain_points_dev(log_n, shift), jpcs._commit_aux(((log_n, shift, 4),)))
        assert torch.equal(got, single), first
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jf.from_monty(want))), first
