"""Build the port's native code at first use, into an ignored directory.

- CUDA kernels: every `csrc/*.cu` is compiled by its own `nvcc` process
  (all started together) into one shared library with a plain C interface,
  loaded with ctypes (no PyTorch headers, so each build takes seconds).
- The generated quotient kernels (stark/codegen.py): each chip's rendered
  source is written into the build directory and compiled the same way,
  against `csrc/quotient.cuh`.
- The guest executor: `core/native/executor.cpp` with `g++`.

Outputs are named by a hash of their sources (a generated library by its
text, the headers and the flags), so a stale library is never
loaded, and are written to a temporary name and renamed into place, so
concurrent test workers never see a half-written file.  The directory is
`<checkout>/build/torch_kernels`, or `$ZKBF_TORCH_BUILD` when set.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# Sources compiled into one library each; headers are hashed into every key.
CUDA_SOURCES = ("ntt.cu", "poseidon2.cu", "logup.cu", "openings.cu")
CUDA_HEADERS = ("koalabear.cuh", "ef4.cuh")
QUOTIENT_HEADER = "quotient.cuh"
# The compiler's output (ptxas registers and spills) of each library built
# by this process, by source or generated name.
LOGS: Dict[str, str] = {}


def build_dir() -> str:
    d = os.environ.get("ZKBF_TORCH_BUILD") or os.path.join(
        os.path.dirname(PKG_DIR), "build", "torch_kernels"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _digest(paths: Sequence[str], extra: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(extra).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def _lib_path(src: str) -> str:
    paths = [os.path.join(CSRC, src)] + [os.path.join(CSRC, h) for h in CUDA_HEADERS]
    stem = os.path.splitext(src)[0]
    return os.path.join(build_dir(), f"libzkbf_{stem}_{_digest(paths, NVCC_FLAGS)}.so")


def build_cuda(sources: Sequence[str] = CUDA_SOURCES, verbose: bool = False) -> Dict[str, str]:
    """Compile every missing kernel library, one nvcc per source in parallel.

    Returns {source: library path}.  Raises with the compiler's output if a
    build fails."""
    return _nvcc_all({src: (os.path.join(CSRC, src), _lib_path(src)) for src in sources}, verbose)


def build_generated(texts: Dict[str, str], verbose: bool = False) -> Dict[str, str]:
    """Compile every missing generated library ({name: source text}, each
    including `csrc/quotient.cuh`), one nvcc per source in parallel.
    Returns {name: library path}."""
    return _nvcc_all(_generated_jobs(texts), verbose)


def _generated_jobs(texts: Dict[str, str]) -> Dict[str, tuple]:
    """{name: (source path, library path)}, each source written into the
    build directory (temporary name, then renamed) unless it is there."""
    headers = [os.path.join(CSRC, h) for h in CUDA_HEADERS + (QUOTIENT_HEADER,)]
    jobs = {}
    for name, text in texts.items():
        h = hashlib.sha256(text.encode())
        h.update(_digest(headers, NVCC_FLAGS).encode())
        stem = f"zkbf_q_{name}_{h.hexdigest()[:16]}"
        src = os.path.join(build_dir(), stem + ".cu")
        lib = os.path.join(build_dir(), f"lib{stem}.so")
        if not os.path.exists(lib) and not os.path.exists(src):
            fd, tmp = tempfile.mkstemp(suffix=".cu", dir=build_dir())
            with os.fdopen(fd, "w") as fh:
                fh.write(text)
            os.replace(tmp, src)
        jobs[name] = (src, lib)
    return jobs


def _nvcc_all(jobs: Dict[str, tuple], verbose: bool) -> Dict[str, str]:
    """{name: (source path, library path)}: start one nvcc for each missing
    library, wait for all, rename each into place."""
    out: Dict[str, str] = {}
    procs: List[tuple] = []
    for name, (src, lib) in jobs.items():
        out[name] = lib
        if os.path.exists(lib):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, "-o", tmp, src]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            os.unlink(tmp)
            continue
        if verbose:
            print(f"[build] {name}\n{log}", flush=True)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def build_executor() -> str:
    """Compile the guest executor with g++ (once per source version)."""
    src = os.path.join(PKG_DIR, "core", "native", "executor.cpp")
    flags = ["-O3", "-std=c++17", "-shared", "-fPIC"]
    lib = os.path.join(build_dir(), f"libbfexec_{_digest([src], flags)}.so")
    if not os.path.exists(lib):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        res = subprocess.run(["g++", *flags, "-o", tmp, src], capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed building the executor:\n{res.stderr}")
        os.replace(tmp, lib)
    return lib


def quotient_sources() -> Dict[str, str]:
    """{name: text} of the generated quotient kernels that proving runs:
    the 8 chips' and the Cpu chip's without LogUp (the uni-STARK)."""
    from .models.cpu import CpuChip
    from .models.machine_def import brainfuck_chips
    from .stark import codegen
    from .stark.chip import Chip

    progs = [codegen.program(Chip(air)) for air in brainfuck_chips()]
    progs.append(codegen.program(Chip(CpuChip()), perm=False))
    return {p.name: p.text for p in progs}


def build_all(verbose: bool = False) -> float:
    """Build the kernels (the hand-written sources and every generated
    quotient kernel, all nvcc processes at once) and the executor; returns
    the seconds it took."""
    t0 = time.time()
    jobs = {src: (os.path.join(CSRC, src), _lib_path(src)) for src in CUDA_SOURCES}
    jobs.update(_generated_jobs(quotient_sources()))
    _nvcc_all(jobs, verbose)
    build_executor()
    return time.time() - t0
