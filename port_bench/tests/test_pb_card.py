"""On the card: each cell runs and comes out correct, and neither its
control nor a stale proof does.  Skips without a card (decided in a
fixture)."""

import json
import subprocess
import sys

import pytest

from port_bench import manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(args, env=None):
    out = subprocess.run([sys.executable, "-m"] + args, cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_cell_is_correct(card, cell):
    r = _run(["port_bench.run", "--workload", cell, "--seed", "2147483701", "--seconds", "5"])
    assert r[-1]["correct"] is True


@pytest.mark.card
@pytest.mark.parametrize("fault", ["queries", "stale"])
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_control_is_not_correct(card, cell, fault):
    r = _run(["port_bench.control", "--workload", cell, "--seeds", "5,6,7", "--seconds", "1",
              "--fault", fault])
    assert [x["correct"] for x in r] == [False, False, False]
