"""Nothing under port_bench imports JAX or the JAX package (compared by whole
top-level name), the reference imports nothing of the port, and a run's
process holds neither once it has run."""

import ast
import os
import subprocess
import sys

from port_bench import manifest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "zkvm_brainfuck_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _dirs, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for f in _files():
        assert not set(_imports(f)) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_port():
    for f in _files("reference"):
        assert "zkvm_brainfuck_tpu_torch" not in set(_imports(f)), f
        assert "torch" not in set(_imports(f)), f


def test_a_run_loads_neither():
    code = (
        "import sys, json\n"
        "from port_bench import run, manifest\n"
        "from port_bench.traffic import loops\n"
        "mix = loops.Mix('tiny', 2**9 - 1, 1, (3, 20), None)\n"
        "cell = manifest.cell('default.loop_2p22')\n"
        "r = run.run_cell(cell, manifest.config('default'), mix, 3, 0.1, False, device='cpu', workers=1)\n"
        "assert r['correct'], r\n"
        "print(json.dumps(run.forbidden_modules()))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
