"""Build the port's native code at first use, into an ignored directory.

- CUDA kernels: every `csrc/*.cu` is compiled by its own `nvcc` process
  (all started together) into one shared library with a plain C interface,
  loaded with ctypes (no PyTorch headers, so each build takes seconds).
- The guest executor: `core/native/executor.cpp` with `g++`.

Outputs are named by a hash of their sources, so a stale library is never
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
    out: Dict[str, str] = {}
    procs: List[tuple] = []
    for src in sources:
        lib = _lib_path(src)
        out[src] = lib
        if os.path.exists(lib):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            os.unlink(tmp)
            continue
        if verbose:
            print(f"[build] {src}\n{log}", flush=True)
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


def build_all(verbose: bool = False) -> float:
    """Build the kernels and the executor; returns the seconds it took."""
    t0 = time.time()
    build_cuda(verbose=verbose)
    build_executor()
    return time.time() - t0
