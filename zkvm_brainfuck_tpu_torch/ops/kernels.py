"""ctypes bindings of the hand-written CUDA kernels, and their launch counts.

Each `csrc/*.cu` file is a shared library with a plain C interface: every
launcher takes device pointers, sizes and a `cudaStream_t`, launches on that
stream, and returns `cudaGetLastError()`.  The libraries are built and
loaded at first launch (`build.py`), never at import.

`COUNTS[name]` is incremented by the wrapper of kernel `name` each time it
launches that kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from .. import build

KERNELS = (
    "ntt_block_stages", "ntt_stage", "poseidon2_hash_rows", "poseidon2_tree",
    "poseidon2_permute", "logup_entries",
)
COUNTS: Dict[str, int] = {k: 0 for k in KERNELS}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "ntt.cu": {
        # (x, out, tw, factors, rows_in, log_n, w, k, stream)
        "zkbf_ntt_block_stages": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        # (x, out, tw, log_n, w, first, last, stream)
        "zkbf_ntt_stage": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "poseidon2.cu": {
        # (rc_ext[8*16], rc_int[13], diag[16]) Montgomery constants, host arrays
        "zkbf_p2_set_constants": [_P, _P, _P],
        # (mat ptrs, widths, n_mats, out, h, log_h, bitrev, stream)
        "zkbf_p2_hash_rows": [_P, _P, _I, _P, _I, _I, _I, _P],
        # (states, out, n, out_cols, stream)
        "zkbf_p2_permute": [_P, _P, _I, _I, _P],
        # (leaves, flat, counters, n_counters, level_off, inject ptrs, log_max, stream)
        "zkbf_p2_tree": [_P, _P, _P, _I, _P, _P, _I, _P],
    },
    "logup.cu": {
        # (main, w, prep, pw, n, desc, desc_len, chal, n_chal, out, csum, scratch,
        #  scratch_words, n_inter, batch, nb, stream)
        "zkbf_logup_trace": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _L, _I, _I, _I, _P],
        # (n) -> scratch words of zkbf_logup_trace
        "zkbf_logup_scratch_words": [_I],
    },
}


_RESTYPES = {"zkbf_logup_scratch_words": _L}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def lib(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built on first use."""
    with _LOCK:
        if source not in _LIBS:
            path = build.build_cuda([source])[source]
            handle = ctypes.CDLL(path)
            for fn, argtypes in _ARGTYPES[source].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
            if source == "poseidon2.cu":
                from .poseidon2 import montgomery_constants

                arrays = [
                    (ctypes.c_uint32 * len(c))(*c) for c in montgomery_constants()
                ]
                check(handle.zkbf_p2_set_constants(*[ctypes.addressof(a) for a in arrays]),
                      "zkbf_p2_set_constants")
            _LIBS[source] = handle
        return _LIBS[source]


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require_cuda_int32(t: torch.Tensor, what: str, ndim: int = 2) -> None:
    """Raise unless `t` is a contiguous int32 CUDA tensor of `ndim` dims."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
