"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zkvm_brainfuck_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import zkvm_brainfuck_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib" or k.startswith("jaxlib.")
             or k == "zkvm_brainfuck_tpu" or k.startswith("zkvm_brainfuck_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_importing_every_port_module_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 30


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|zkvm_brainfuck_tpu)(?:\.|\s|$)", re.M)
    hits = []
    for path in _sources():
        with open(path) as fh:
            hits += [f"{path}: {m.group(0).strip()}" for m in pat.finditer(fh.read())]
    assert not hits, hits


def test_entry_points_need_a_card_unless_asked_for_cpu():
    from zkvm_brainfuck_tpu_torch.device import NoCudaDevice, resolve_device
    from zkvm_brainfuck_tpu_torch.models.cpu import CpuChip
    from zkvm_brainfuck_tpu_torch.stark.challenger import DuplexChallenger
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.domains import Domain
    from zkvm_brainfuck_tpu_torch.stark.pcs import pcs_commit
    from zkvm_brainfuck_tpu_torch.stark.uni import uni_stark_prove

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    trace = np.zeros((16, 31), dtype=np.uint32)
    with pytest.raises(NoCudaDevice):
        uni_stark_prove(Chip(CpuChip()), trace, DuplexChallenger(), num_queries=2)
    with pytest.raises(NoCudaDevice):
        pcs_commit([(Domain(4, 1), torch.zeros((16, 2), dtype=torch.int32))])
    with pytest.raises(NoCudaDevice):
        resolve_device("cuda")


def test_plain_versions_are_not_counted_as_launches():
    """On CPU tensors a wrapper runs its plain version and counts no launch;
    the launch path accepts only contiguous int32 CUDA tensors."""
    from zkvm_brainfuck_tpu_torch.models.memory import MemoryChip
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn
    from zkvm_brainfuck_tpu_torch.ops import logup, merkle, ntt, poseidon2
    from zkvm_brainfuck_tpu_torch.stark.chip import Chip
    from zkvm_brainfuck_tpu_torch.stark.permutation import host_beta_pows, logup_table

    before = dict(kn.COUNTS)
    x = torch.zeros((16, 16), dtype=torch.int32)
    poseidon2.permute(x)
    leaves = poseidon2.hash_rows(x)
    merkle.build_tree(merkle.make_plan((16,)), {16: leaves})
    ntt.ntt_stage(ntt.ntt_block_stages(x, 4, 3), 4, 4)
    memory = Chip(MemoryChip())
    chal = logup.challenge_matrix((1, 2, 3, 4), host_beta_pows(memory, (5, 6, 7, 8)), "cpu")
    logup.logup_trace(logup_table(memory), torch.zeros((16, memory.width), dtype=torch.int32),
                      None, chal)
    assert kn.COUNTS == before  # plain versions are not launches
    with pytest.raises(ValueError):
        kn.require_cuda_int32(x, "test")


def test_every_kernel_is_registered_with_the_smoke_run():
    """Each kernel of ops/kernels.py has its source, the TPU function it
    replaces, its device functions and its bound in chip_smoke.py, and only
    those kernels do; a function fused into a kernel (the LogUp running sum)
    keeps its source and the TPU function it replaces in the kernels line."""
    import chip_smoke
    from zkvm_brainfuck_tpu_torch.ops import kernels as kn

    names = set(kn.KERNELS)
    assert {"poseidon2_tree", "quotient_eval"} <= names and len(names) == 9
    assert set(kn.COUNTS) == names
    assert chip_smoke.FUSED == {"logup_scan": "logup_entries"}
    for table in (chip_smoke.DEVICE_FUNCS, chip_smoke.launch_bounds()):
        assert set(table) == names
    for table in (chip_smoke.SOURCES, chip_smoke.REPLACES):
        assert set(table) == names | set(chip_smoke.FUSED)
    for name in names | set(chip_smoke.FUSED):
        assert os.path.exists(os.path.join(ROOT, chip_smoke.SOURCES[name]))
        path, line = chip_smoke.REPLACES[name].rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as fh:
            assert int(line) <= len(fh.readlines())
