"""The port's main path, ProverClient setup -> prove -> verify over the 8
chips, against the JAX-made golden files of the `printa` guest at the
production config (84 FRI queries, 16 PoW bits): the vk bytes, the whole
1741-entry Fiat-Shamir transcript and the proof bytes, reproduced by the
plain versions of the kernels (device="cpu").  Also: the port's verifier on
the golden proof and on the adversarial probes, serialization round trips,
conversions to and from the JAX package's objects, and a proof made from a
JAX-made proving key."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from zkvm_brainfuck_tpu_torch import NoCudaDevice, ProverClient, convert, guests
from zkvm_brainfuck_tpu_torch.core.executor import execute
from zkvm_brainfuck_tpu_torch.core.program import Program
from zkvm_brainfuck_tpu_torch.prover import BfProvingKey, BfVerifyingKey
from zkvm_brainfuck_tpu_torch.sdk import CpuProver
from zkvm_brainfuck_tpu_torch.stark.config import FriConfig, KoalaBearPoseidon2
from zkvm_brainfuck_tpu_torch.stark.errors import (
    CpuLogDegreeTooLarge,
    MissingCpuChip,
    VerificationFailure,
)
from zkvm_brainfuck_tpu_torch.stark.serial import ProofDecodeError
from zkvm_brainfuck_tpu_torch.stark.types import MachineProof, ShardProof
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
# Half-open transcript segments of the pipeline (ROADMAP "Main path, slice by slice").
SEGMENTS = [("S1 setup", 0, 15), ("S2 main commit", 15, 31), ("S3 LogUp", 31, 67),
            ("S4 quotient", 67, 79), ("S5 open", 79, 1741)]


def _golden(name, mode="rb"):
    with open(os.path.join(GOLDEN_DIR, name), mode) as fh:
        return fh.read()


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
def golden_run():
    """printa through ProverClient on the CPU, proved once per module."""
    config = RecordingConfig()
    client = ProverClient(CpuProver(config=config, device="cpu"))
    pk, vk = client.setup(guests.PRINTA_BF)
    proof = client.prove(pk, b"").run()
    transcript = config.challengers[0].record
    return client, pk, vk, proof, transcript


def _first_difference(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def test_vk_bytes_equal_golden(golden_run):
    _client, pk, vk, _proof, _tr = golden_run
    assert vk.to_bytes() == _golden("vk_printa_q84.bin")
    assert pk.vk.to_bytes() == vk.to_bytes()


def test_transcript_equals_golden(golden_run):
    transcript = golden_run[4]
    golden = json.loads(_golden("transcript_printa_q84.json", "r"))
    assert (golden["fri_queries"], golden["pow_bits"]) == (84, 16)
    want = golden["transcript"]
    first = _first_difference(transcript, want)
    where = next((f"{name} [{lo},{hi})" for name, lo, hi in SEGMENTS
                  if first is not None and lo <= first < hi), "beyond S5")
    assert first is None, (
        f"transcript differs first at entry {first}, in {where}: "
        f"{transcript[first:first + 4]} != {want[first:first + 4]}"
    )
    assert len(transcript) == 1741


def test_proof_bytes_equal_golden(golden_run):
    proof = golden_run[3]
    assert proof.proof.proof.to_bytes() == _golden("proof_printa_q84.bin")
    assert proof.public_values == bytes([65])  # 'A'
    assert proof.proof.cycles == 66


def test_main_path_fills_the_phase_timings(golden_run):
    timings = golden_run[3].proof.timings
    for phase in ("execute", "trace_gen", "main_commit", "perm_trace", "perm_commit",
                  "quotient", "quotient_commit", "open_eval", "reduced_open", "fri_commit",
                  "grind", "query_open", "pcs_open_total", "prove_total"):
        assert timings[phase] >= 0, phase


def test_client_verifies_its_proof_and_the_golden_proof(golden_run):
    client, _pk, vk, proof, _tr = golden_run
    client.verify(proof, vk)
    golden = copy.copy(proof)
    golden.proof = copy.copy(proof.proof)
    golden.proof.proof = MachineProof.from_bytes(_golden("proof_printa_q84.bin"))
    client.verify(golden, BfVerifyingKey.from_bytes(_golden("vk_printa_q84.bin")))


def _flip_cumulative_sum(client, proof, vk):
    sp = proof.proof.proof.shard_proof
    c = sp.opened_values[0].cumulative_sum
    sp.opened_values[0].cumulative_sum = ((c[0] + 1) % 0x7F000001,) + tuple(c[1:])
    return proof, vk


def _other_programs_vk(client, proof, vk):
    _pk, other = client.setup(guests.LOOP_BF)
    assert other.vk.commit != vk.vk.commit
    return proof, other


def _truncate_fri_queries(client, proof, vk):
    fri = proof.proof.proof.shard_proof.opening_proof.fri
    fri.query_commit_openings = fri.query_commit_openings[:-1]
    return proof, vk


@pytest.mark.parametrize("probe", [_flip_cumulative_sum, _other_programs_vk, _truncate_fri_queries])
def test_adversarial_probes_rejected_with_typed_errors(golden_run, probe):
    client, _pk, vk, proof, _tr = golden_run
    bad, bad_vk = probe(client, copy.deepcopy(proof), vk)
    with pytest.raises(VerificationFailure) as err:
        client.verify(bad, bad_vk)
    assert type(err.value) is not VerificationFailure, err.value


def test_cpu_chip_checks(golden_run):
    client, _pk, vk, proof, _tr = golden_run
    no_cpu = copy.deepcopy(proof)
    sp = no_cpu.proof.proof.shard_proof
    sp.chip_ordering = {("Cpu2" if k == "Cpu" else k): v for k, v in sp.chip_ordering.items()}
    with pytest.raises(MissingCpuChip):
        client.verify(no_cpu, vk)
    too_big = copy.deepcopy(proof)
    sp = too_big.proof.proof.shard_proof
    sp.opened_values[sp.chip_ordering["Cpu"]].log_degree = 23
    with pytest.raises(CpuLogDegreeTooLarge):
        client.verify(too_big, vk)


def test_serialization_round_trips(golden_run):
    client, pk, vk, proof, _tr = golden_run
    data = proof.proof.proof.to_bytes()
    assert ShardProof.from_bytes(data).to_bytes() == data
    with pytest.raises(ProofDecodeError):
        ShardProof.from_bytes(data[:-3])
    assert BfVerifyingKey.from_bytes(vk.to_bytes()).to_bytes() == vk.to_bytes()
    pk2 = BfProvingKey.from_bytes(pk.to_bytes(), client.prover.prover)
    assert [int(x) for x in pk2.pk.commit] == vk.vk.commit and pk2.elf == guests.PRINTA_BF


def test_execute_matches_the_record():
    client = ProverClient(device="cpu")
    out = client.execute(guests.FIBO_BF, bytes([5])).run()
    assert out == execute(Program.from_source(guests.FIBO_BF), bytes([5])).output_stream
    assert client.execute(guests.PRINTA_BF).run() == b"A"


def test_client_without_a_card_raises():
    if torch.cuda.is_available():
        assert ProverClient().prover.prover.core_prover.device.type == "cuda"
        return
    with pytest.raises(NoCudaDevice):
        ProverClient()
    with pytest.raises(NoCudaDevice):
        ProverClient.builder().build()


# ---------------------------------------------------------------------------
# Against the JAX package's objects
# ---------------------------------------------------------------------------


def _jax_proof_classes():
    from zkvm_brainfuck_tpu.stark import fri, pcs, types

    return {
        "ShardProof": types.ShardProof,
        "ShardCommitment": types.ShardCommitment,
        "ChipOpenedValues": types.ChipOpenedValues,
        "AirOpenedValues": types.AirOpenedValues,
        "PcsProof": pcs.PcsProof,
        "BatchOpening": pcs.BatchOpening,
        "FriProof": fri.FriProof,
    }


def test_shard_proof_converts_both_ways(golden_run):
    from zkvm_brainfuck_tpu.stark.serial import decode_shard_proof, encode_shard_proof

    data = _golden("proof_printa_q84.bin")
    port = convert.shard_proof_from_jax(decode_shard_proof(data))
    assert port.to_bytes() == data
    mine = golden_run[3].proof.proof.shard_proof
    assert encode_shard_proof(convert.shard_proof_to_jax(mine, _jax_proof_classes())) == data


def test_jax_verifier_accepts_the_port_proof(golden_run):
    from zkvm_brainfuck_tpu.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu.stark.config import FriConfig as JaxFri
    from zkvm_brainfuck_tpu.stark.config import KoalaBearPoseidon2 as JaxConfig
    from zkvm_brainfuck_tpu.stark.machine import StarkMachine
    from zkvm_brainfuck_tpu.stark.serial import decode_vk
    from zkvm_brainfuck_tpu.stark.types import MachineProof as JaxMachineProof

    config = JaxConfig(JaxFri(log_blowup=1, num_queries=84, proof_of_work_bits=16))
    machine = StarkMachine(config, brainfuck_chips())
    _client, _pk, vk, proof, _tr = golden_run
    sp = convert.shard_proof_to_jax(proof.proof.proof.shard_proof, _jax_proof_classes())
    machine.verify(decode_vk(vk.to_bytes()), JaxMachineProof(shard_proof=sp), config.challenger())


def test_proof_from_a_jax_proving_key_equals_the_port_proof(golden_run):
    """The JAX package's setup, carried across (Montgomery -> canonical,
    recommitted by the port), proves the same bytes as the port's own pk."""
    from zkvm_brainfuck_tpu.core.program import Program as JaxProgram
    from zkvm_brainfuck_tpu.models.machine_def import brainfuck_chips
    from zkvm_brainfuck_tpu.stark.config import KoalaBearPoseidon2 as JaxConfig
    from zkvm_brainfuck_tpu.stark.machine import StarkMachine

    jpk, jvk = StarkMachine(JaxConfig(), brainfuck_chips()).setup(
        JaxProgram.from_source(guests.PRINTA_BF))
    client, pk, vk, proof, _tr = golden_run
    vk_from_jax = convert.verifying_key_from_jax(jvk)
    assert BfVerifyingKey(vk_from_jax).to_bytes() == vk.to_bytes()
    pk_from_jax = convert.proving_key_from_jax(jpk, device="cpu")
    for a, b in zip(pk_from_jax.traces, pk.pk.traces):
        assert torch.equal(a, b)
    converted = BfProvingKey(pk=pk_from_jax, elf=guests.PRINTA_BF, vk=BfVerifyingKey(vk_from_jax))
    again = client.prove(converted, b"").run()
    assert again.proof.proof.to_bytes() == proof.proof.proof.to_bytes()
    assert np.array_equal(np.asarray(pk_from_jax.commit), np.asarray(pk.pk.commit))


def test_pcs_open_four_rounds_eight_heights():
    """pcs_open over the machine's 4-round shape: 8 trace heights, local-only
    matrices opened at zeta alone, quotient chunks on shifted domains; the
    port's and the JAX package's host verifiers both accept the opening."""
    from zkvm_brainfuck_tpu.stark import pcs as jpcs
    from zkvm_brainfuck_tpu.stark.challenger import DuplexChallenger as JaxChallenger
    from zkvm_brainfuck_tpu.stark.domains import Domain as JaxDomain
    from zkvm_brainfuck_tpu_torch.stark import pcs
    from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
    from zkvm_brainfuck_tpu_torch.stark.domains import Domain

    rng = np.random.default_rng(8)
    P = 0x7F000001
    # (log_n, width, local_only) per matrix, per round; log_n 2..9 all appear
    layout = [
        [(9, 2, False), (4, 3, False)],                        # preprocessed
        [(9, 3, False), (8, 2, True), (7, 4, False), (3, 5, True), (2, 1, False)],
        [(9, 8, False), (6, 8, False), (5, 4, False)],         # permutation
    ]
    rounds_data, roots, domains = [], [], []
    ch = DuplexChallenger()
    for mats in layout:
        doms = [Domain(ln, 1) for ln, _w, _lo in mats]
        evals = [torch.from_numpy(rng.integers(0, P, (1 << ln, w)).astype(np.int32))
                 for ln, w, _lo in mats]
        root, data = pcs.pcs_commit(list(zip(doms, evals)), device="cpu")
        ch.observe_commitment([int(x) for x in root])
        rounds_data.append(data)
        roots.append(root)
        domains.append(doms)
    qdom = Domain(9, 1).create_disjoint_domain(1 << 10)
    qdoms = qdom.split_domains(2)
    chunks = [torch.from_numpy(rng.integers(0, P, (1 << 9, 4)).astype(np.int32)) for _ in qdoms]
    qroot, qdata = pcs.pcs_commit(list(zip(qdoms, chunks)), device="cpu")
    ch.observe_commitment([int(x) for x in qroot])
    zeta = ch.sample_ext()
    verifier_ch = ch.clone()

    points = [[[zeta] if lo else [zeta, d.next_point_ef(zeta)] for (_ln, _w, lo), d in zip(mats, doms)]
              for mats, doms in zip(layout, domains)] + [[[zeta]] * len(qdoms)]
    opened, proof = pcs.pcs_open(
        list(zip(rounds_data + [qdata], points)), ch, num_queries=12, pow_bits=6)

    def claims(dom_cls):
        out = []
        for r, (root, doms) in enumerate(zip(roots + [qroot], domains + [qdoms])):
            mats = []
            for i, d in enumerate(doms):
                pts = points[r][i]
                mats.append((dom_cls(d.log_n, d.shift),
                             [(z, opened[r][i][k]) for k, z in enumerate(pts)]))
            out.append(([int(x) for x in root], mats))
        return out

    pcs.pcs_verify(claims(Domain), proof, verifier_ch.clone(), num_queries=12, pow_bits=6)
    jproof = convert._convert_pcs(proof, jpcs.PcsProof, jpcs.BatchOpening,
                                  _jax_proof_classes()["FriProof"])
    jch = convert.challenger_to_jax(verifier_ch, JaxChallenger)
    jpcs.pcs_verify(claims(JaxDomain), jproof, jch, num_queries=12, pow_bits=6)
    assert len(proof.query_input_openings[0]) == 4
