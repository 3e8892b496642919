"""The port's multi-device proving (zkvm_brainfuck_tpu_torch/parallel/) on an
8-shard mesh of CPU devices, against the port's single-device results, the
JAX package's parallel/sharded.py on the conftest's 8-device JAX CPU mesh,
and the `printa` golden files.

Field values cross between the packages as numpy arrays: canonical in the
port, Montgomery inside the JAX functions (their inputs are converted with
`np_to_monty` and their outputs back with `np_from_monty`).  Every
comparison is exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from zkvm_brainfuck_tpu_torch import NoCudaDevice, ProverClient, convert, guests
from zkvm_brainfuck_tpu_torch.ops import merkle as mk
from zkvm_brainfuck_tpu_torch.ops import ntt as nt
from zkvm_brainfuck_tpu_torch.ops.field import GENERATOR, P, np_from_monty, np_to_monty
from zkvm_brainfuck_tpu_torch.parallel import collectives as co
from zkvm_brainfuck_tpu_torch.parallel import sharded
from zkvm_brainfuck_tpu_torch.parallel.mesh import (
    RowSharded,
    current_mesh,
    make_row_mesh,
    place_rows,
    set_shard_mesh,
    shard_fraction,
)
from zkvm_brainfuck_tpu_torch.sdk import CpuProver
from zkvm_brainfuck_tpu_torch.stark import machine as stark_machine
from zkvm_brainfuck_tpu_torch.stark import prover as stark_prover
from zkvm_brainfuck_tpu_torch.stark.config import FriConfig, KoalaBearPoseidon2
from zkvm_brainfuck_tpu_torch.stark.domains import Domain
from zkvm_brainfuck_tpu_torch.stark.pcs import pcs_commit

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SHARDS = 8
# JAX chips made here stay alive for the module: the JAX package caches
# constraint flags by id(chip), so a freed chip's address must not be reused.
_KEEP = []


def _golden(name, mode="rb"):
    with open(os.path.join(GOLDEN_DIR, name), mode) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def mesh():
    return make_row_mesh(devices=["cpu"] * SHARDS)


@pytest.fixture(scope="module")
def jax_mesh():
    from zkvm_brainfuck_tpu.parallel.mesh import make_row_mesh as jax_make_row_mesh

    assert len(jax.devices()) >= SHARDS, "conftest must provide the virtual 8-device CPU mesh"
    return jax_make_row_mesh(SHARDS)


def _rand(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int32))


def _np(t):
    return t.cpu().numpy().astype(np.uint32)


def _jax_rows(jax_mesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(jax_mesh, JP("rows")))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a module's tests.  The suite runs in
    several worker processes; beside them, torch's OpenMP teams
    oversubscribe the host's cores and a CPU prove, many small ops, runs one
    to two orders of magnitude slower.  The port's other test modules
    import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 32])
def test_make_row_mesh_refuses_sizes_that_cannot_divide_heights(n):
    with pytest.raises(ValueError, match="power of two <= 16"):
        make_row_mesh(devices=["cpu"] * n)


def test_make_row_mesh_needs_a_card_unless_given_devices():
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            make_row_mesh(torch.cuda.device_count() + 1)
        return
    with pytest.raises(NoCudaDevice):
        make_row_mesh()
    with pytest.raises(NoCudaDevice):
        make_row_mesh(devices=["cuda:0"] * 4)


def test_place_rows_shards_and_refuses_an_indivisible_height(mesh):
    t = _t(np.arange(64 * 3).reshape(64, 3))
    assert place_rows(t) is t  # no mesh set
    set_shard_mesh(mesh)
    try:
        assert current_mesh() is mesh
        with pytest.raises(ValueError, match="not divisible by mesh size"):
            place_rows(torch.zeros((24, 2), dtype=torch.int32))
        x = place_rows(t)
    finally:
        set_shard_mesh(None)
    assert isinstance(x, RowSharded) and x.shape == (64, 3)
    assert [tuple(b.shape) for b in x.blocks] == [(8, 3)] * SHARDS
    assert shard_fraction(x) == 1 / SHARDS and shard_fraction(t) == 1.0
    assert torch.equal(x.gather(), t)


def test_collectives_follow_shard_map_semantics(mesh):
    blocks = [torch.full((SHARDS, 2), k, dtype=torch.int32) + torch.arange(SHARDS, dtype=torch.int32)[:, None]
              for k in range(SHARDS)]
    co.reset_bytes()
    out = co.all_to_all(mesh, blocks)
    for j, o in enumerate(out):  # shard j gets chunk j of every source, in source order
        assert torch.equal(o[:, 0], torch.arange(SHARDS, dtype=torch.int32) + j)
    assert co.BYTES["all_to_all"] == SHARDS * (SHARDS - 1) * 2 * 4
    got = co.ppermute(mesh, [b[0] for b in blocks], co.ring_next(mesh))
    assert [int(g[0]) for g in got] == [(k + 1) % SHARDS for k in range(SHARDS)]
    total = co.psum(mesh, [torch.full((3,), P - 1, dtype=torch.int32)] * SHARDS)
    assert all(torch.equal(t, torch.full((3,), P - SHARDS, dtype=torch.int32)) for t in total)
    gathered = co.all_gather(mesh, [b[0] for b in blocks])
    assert all(torch.equal(g, torch.stack([b[0] for b in blocks])) for g in gathered)


# ---------------------------------------------------------------------------
# The three functions of the JAX package's parallel/sharded.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_equals_single_device_and_jax(mesh, jax_mesh, inverse):
    from zkvm_brainfuck_tpu.parallel.sharded import sharded_ntt as jax_sharded_ntt

    log_n, w = 12, 3
    x = _rand(np.random.default_rng(9), (1 << log_n, w))
    got = sharded.sharded_ntt(mesh, co.scatter(_t(x), mesh), inverse=inverse)
    assert shard_fraction(got) == 1 / SHARDS
    got = _np(got.gather())
    single = _np(nt.ntt_dev(_t(x), log_n, inverse))
    xm = _jax_rows(jax_mesh, np_to_monty(x))
    ref = np_from_monty(np.asarray(jax.jit(lambda v: jax_sharded_ntt(jax_mesh, v, inverse=inverse))(xm)))
    assert np.array_equal(got, single)
    assert np.array_equal(got, ref)


def test_logup_phi_sharded_equals_jax(mesh, jax_mesh):
    from zkvm_brainfuck_tpu.parallel.sharded import logup_phi_sharded as jax_phi

    rng = np.random.default_rng(12)
    ents, rss = _rand(rng, (16 * SHARDS, 3, 4)), _rand(rng, (16 * SHARDS, 4))
    perm, csum = sharded.logup_phi_sharded(mesh, co.scatter(_t(ents), mesh), co.scatter(_t(rss), mesh))
    ref_perm, ref_csum = jax.jit(lambda e, r: jax_phi(jax_mesh, e, r))(
        _jax_rows(jax_mesh, np_to_monty(ents)), _jax_rows(jax_mesh, np_to_monty(rss)))
    assert np.array_equal(_np(perm.gather()), np_from_monty(np.asarray(ref_perm)))
    assert np.array_equal(_np(csum), np_from_monty(np.asarray(ref_csum)))


def test_sharded_prove_step_equals_jax(mesh, jax_mesh):
    from zkvm_brainfuck_tpu.parallel.sharded import sharded_prove_step as jax_step

    rng = np.random.default_rng(13)
    trace = _rand(rng, (16 * SHARDS, 8))
    alpha, beta = _rand(rng, (4,)), _rand(rng, (4,))
    root, cumulative, transition = sharded.sharded_prove_step(
        mesh, co.scatter(_t(trace), mesh), alpha, beta)
    ref_root, ref_cum, ref_tr = jax.jit(lambda t, a, b: jax_step(jax_mesh, t, a, b))(
        _jax_rows(jax_mesh, trace), jnp.asarray(alpha), jnp.asarray(beta))
    assert np.array_equal(_np(root), np_from_monty(np.asarray(ref_root)))
    assert np.array_equal(_np(cumulative), np_from_monty(np.asarray(ref_cum)))
    assert np.array_equal(_np(transition.gather()), np.asarray(ref_tr))


# ---------------------------------------------------------------------------
# The prover's LDE and commit over the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heights", [(16,), (1 << 10, 1 << 8, 16)])
def test_sharded_lde_and_commit_equal_single_device(mesh, heights):
    """A 16-row matrix takes the gather branch (n < d^2) and its 32-row LDE
    has fewer leaves a shard than shards; 2^10 and 2^8 rows run the 4-step
    LDE, the all_to_all digest routing and an injected layer."""
    rng = np.random.default_rng(len(heights))
    shifts = (1, GENERATOR, 1)
    mats = [_t(_rand(rng, (h, w))) for h, w in zip(heights, (3, 2, 5))]
    domains = [Domain(h.bit_length() - 1, s) for h, s in zip(heights, shifts)]
    root, data = pcs_commit(list(zip(domains, mats)), device="cpu")
    co.reset_bytes()
    root8, data8 = pcs_commit(list(zip(domains, [co.scatter(m, mesh) for m in mats])), device="cpu")
    assert np.array_equal(root8, root)
    for lde, lde8 in zip(data.ldes, data8.ldes):
        assert shard_fraction(lde8) == 1 / SHARDS
        assert torch.equal(lde8.gather(), lde)
    assert shard_fraction(data8.tree.digests) == 1 / SHARDS
    assert torch.equal(data8.tree.gather_flat(), data.tree.flat)
    idx = rng.integers(0, 2 * max(heights), 20)
    (rows, paths), (rows8, paths8) = mk.open_many([data.tree, data8.tree], [idx, idx])
    assert all(np.array_equal(a, b) for a, b in zip(rows, rows8))
    assert np.array_equal(paths, paths8)
    assert co.BYTES["gather"] > 0 and co.BYTES["scatter"] > 0
    assert (co.BYTES["all_to_all"] > 0) == (max(heights) >= SHARDS * SHARDS)


# ---------------------------------------------------------------------------
# printa through ProverClient under the mesh
# ---------------------------------------------------------------------------


class RecordingConfig(KoalaBearPoseidon2):
    """The production config; every challenger it makes records its
    observe/sample stream."""

    def __init__(self):
        super().__init__(FriConfig(log_blowup=1, num_queries=84, proof_of_work_bits=16))
        self.challengers = []

    def challenger(self):
        ch = super().challenger()
        ch.start_recording()
        self.challengers.append(ch)
        return ch


@pytest.fixture(scope="module")
def mesh_run(mesh):
    """printa set up and proved once under the 8-shard mesh; the traces,
    the committed rounds, the permutation traces and the quotient values
    are recorded as the prover makes them."""
    seen = {"traces": [], "commits": [], "perm": [], "quotient": []}

    def record(key, fn, pick=lambda out: out):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[key].append(pick(out))
            return out
        return wrapper

    patches = [
        (stark_prover, "place_rows", record("traces", stark_prover.place_rows)),
        (stark_machine, "place_rows", record("traces", stark_machine.place_rows)),
        (stark_prover, "pcs_commit", record("commits", stark_prover.pcs_commit, lambda o: o[1])),
        (stark_prover, "generate_permutation_trace",
         record("perm", stark_prover.generate_permutation_trace, lambda o: o[0])),
        (stark_prover, "quotient_values", record("quotient", stark_prover.quotient_values)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    config = RecordingConfig()
    client = ProverClient(CpuProver(config=config, device="cpu"))
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    set_shard_mesh(mesh)
    try:
        pk, vk = client.setup(guests.PRINTA_BF)
        proof = client.prove(pk, b"").run()
    finally:
        set_shard_mesh(None)
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return client, pk, vk, proof, config.challengers[0].record, seen


def test_mesh_printa_equals_the_golden_files(mesh_run):
    _client, _pk, vk, proof, transcript, _seen = mesh_run
    assert vk.to_bytes() == _golden("vk_printa_q84.bin")
    want = json.loads(_golden("transcript_printa_q84.json", "r"))["transcript"]
    assert len(transcript) == len(want) == 1741
    assert transcript == want
    assert proof.proof.proof.to_bytes() == _golden("proof_printa_q84.bin")


def test_both_verifiers_accept_the_mesh_proof(mesh_run):
    from zkvm_brainfuck_tpu.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu.stark import fri, pcs, types
    from zkvm_brainfuck_tpu.stark.config import FriConfig as JaxFri
    from zkvm_brainfuck_tpu.stark.config import KoalaBearPoseidon2 as JaxConfig
    from zkvm_brainfuck_tpu.stark.machine import StarkMachine
    from zkvm_brainfuck_tpu.stark.serial import decode_vk

    client, _pk, vk, proof, _tr, _seen = mesh_run
    client.verify(proof, vk)
    classes = {"ShardProof": types.ShardProof, "ShardCommitment": types.ShardCommitment,
               "ChipOpenedValues": types.ChipOpenedValues, "AirOpenedValues": types.AirOpenedValues,
               "PcsProof": pcs.PcsProof, "BatchOpening": pcs.BatchOpening, "FriProof": fri.FriProof}
    config = JaxConfig(JaxFri(log_blowup=1, num_queries=84, proof_of_work_bits=16))
    machine = StarkMachine(config, brainfuck_chips())
    _KEEP.append(machine)
    sp = convert.shard_proof_to_jax(proof.proof.proof.shard_proof, classes)
    machine.verify(decode_vk(vk.to_bytes()), types.MachineProof(shard_proof=sp), config.challenger())


def test_mesh_intermediates_stay_sharded(mesh_run):
    """The port's form of the JAX package's
    tests/test_sharded.py::test_sharded_intermediates_stay_sharded, which
    fails in the JAX package in this image ("Merkle flat buffer replicated:
    1.0"): every trace, the preprocessed and main LDEs, every commit's leaf
    digests, the permutation traces and the quotient values hold 1/8 of
    their rows on each shard."""
    _client, pk, _vk, _proof, _tr, seen = mesh_run
    main = seen["commits"][0]
    groups = {
        "traces": seen["traces"],
        "preprocessed LDEs": pk.pk.data.ldes,
        "main LDEs": main.ldes,
        "leaf digests": [pk.pk.data.tree.digests] + [c.tree.digests for c in seen["commits"]],
        "permutation traces": seen["perm"],
        "quotient values": seen["quotient"],
    }
    assert len(seen["traces"]) == len(pk.pk.traces) + len(main.ldes)
    assert len(seen["commits"]) == 3 and len(seen["perm"]) == len(seen["quotient"]) == len(main.ldes)
    for what, items in groups.items():
        assert items, what
        for x in items:
            assert shard_fraction(x) <= 1.01 / SHARDS, f"{what}: {shard_fraction(x)} of {x.shape}"


def test_a_key_from_another_mesh_is_refused(mesh_run, mesh):
    client, pk, _vk, _proof, _tr, _seen = mesh_run
    with pytest.raises(ValueError, match="set up on mesh"):
        client.prove(pk, b"").run()  # no mesh set, a key of the 8-shard mesh
    set_shard_mesh(make_row_mesh(devices=["cpu"] * 4))
    try:
        with pytest.raises(ValueError, match="set up on mesh"):
            client.prove(pk, b"").run()
    finally:
        set_shard_mesh(None)


def test_bf_debug_replay_under_a_mesh(mesh_run, mesh, monkeypatch):
    """BF_DEBUG=1 with the mesh set: the replay regenerates the traces on
    the prover's device and checks them on the host, and passes."""
    client, pk, _vk, _proof, _tr, _seen = mesh_run
    machine = client.prover.prover.machine
    replays = []
    replay = machine.debug_constraints
    monkeypatch.setattr(machine, "debug_constraints",
                        lambda *a, **k: replays.append(replay(*a, **k)))
    monkeypatch.setenv("BF_DEBUG", "1")
    set_shard_mesh(mesh)
    try:
        proof = client.prove(pk, b"").run()
    finally:
        set_shard_mesh(None)
    assert len(replays) == 1
    assert proof.proof.proof.to_bytes() == _golden("proof_printa_q84.bin")
