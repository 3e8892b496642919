"""ctypes bindings of the hand-written CUDA kernels, and their launch counts.

Each `csrc/*.cu` file, and each chip's generated quotient kernel
(stark/codegen.py over `csrc/quotient.cuh`), is a shared library with a
plain C interface: every
launcher takes device pointers, sizes and a `cudaStream_t`, launches on that
stream, and returns `cudaGetLastError()`.  The libraries are built and
loaded at first launch (`build.py`), never at import.  A library links the
CUDA runtime statically, so its current device is its own: `lib(source,
device)` sets it to the device of the tensors about to be launched on
(`zkbf_set_device`), and uploads the Poseidon2 constants to each device
once.

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
    "poseidon2_permute", "logup_entries", "open_eval", "ro_accum", "quotient_eval",
)
COUNTS: Dict[str, int] = {k: 0 for k in KERNELS}

_LOCK = threading.Lock()
_LIBS: Dict[object, ctypes.CDLL] = {}  # by source, or (name, text) of a generated one
_CONSTANTS_ON: set = set()  # (id of the library, device index) holding the Poseidon2 constants

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_ARGTYPES = {
    "ntt.cu": {
        "zkbf_set_device": [_I],
        # (x, out, tw, factors, rows_in, log_n, w, k, stream)
        "zkbf_ntt_block_stages": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        # (x, out, tw, log_n, w, first, last, stream)
        "zkbf_ntt_stage": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "poseidon2.cu": {
        "zkbf_set_device": [_I],
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
        "zkbf_set_device": [_I],
        # (main, w, prep, pw, n, desc, desc_len, chal, n_chal, out, csum, scratch,
        #  scratch_words, n_inter, batch, nb, stream)
        "zkbf_logup_trace": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _L, _I, _I, _I, _P],
        # (n) -> scratch words of zkbf_logup_trace
        "zkbf_logup_scratch_words": [_I],
    },
    "openings.cu": {
        "zkbf_set_device": [_I],
        # (mat ptrs, widths, n_mats, h, g, shift, row0, z, out, scratch, stream)
        "zkbf_open_eval": [_P, _P, _I, _I, _U, _U, _I, _P, _P, _P, _P],
        # (total width) -> 8-byte scratch words of zkbf_open_eval
        "zkbf_open_eval_scratch_words": [_I],
        # (mat ptrs, widths, n_mats, h, g, shift, row0, z, s, alpha_pows, ro, first, stream)
        "zkbf_ro_accum": [_P, _P, _I, _I, _U, _U, _I, _P, _P, _P, _P, _I, _P],
    },
    # every generated quotient library
    "quotient": {
        "zkbf_set_device": [_I],
        # (block local ptrs, halo ptrs, strides, halo strides, widths, n_blk, sel ptrs, prm,
        #  n_prm, rows, step, out, stream)
        "zkbf_quotient": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P],
        # (step, registers, tile bytes, blocks an SM): out through the pointers
        "zkbf_quotient_info": [_I, _P, _P, _P],
    },
}


_RESTYPES = {"zkbf_logup_scratch_words": _L, "zkbf_open_eval_scratch_words": _L}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def lib(source: str, device=None) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>` (built on first use), its
    runtime's current device set to `device` (the current CUDA device by
    default)."""
    index = _index(device)
    with _LOCK:
        if source not in _LIBS:
            _LIBS[source] = _open(build.build_cuda([source])[source], _ARGTYPES[source])
        handle = _LIBS[source]
        check(handle.zkbf_set_device(index), "zkbf_set_device")
        if source == "poseidon2.cu" and (id(handle), index) not in _CONSTANTS_ON:
            from .poseidon2 import montgomery_constants

            arrays = [
                (ctypes.c_uint32 * len(c))(*c) for c in montgomery_constants()
            ]
            check(handle.zkbf_p2_set_constants(*[ctypes.addressof(a) for a in arrays]),
                  "zkbf_p2_set_constants")
            _CONSTANTS_ON.add((id(handle), index))
        return handle


def generated_lib(name: str, text: str, device=None) -> ctypes.CDLL:
    """The loaded library of a generated quotient kernel (`name`, its
    source `text`; built on first use), its current device set to
    `device`."""
    index = _index(device)
    key = (name, text)
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = _open(build.build_generated({name: text})[name], _ARGTYPES["quotient"])
        handle = _LIBS[key]
        check(handle.zkbf_set_device(index), "zkbf_set_device")
        return handle


def _open(path: str, argtypes: dict) -> ctypes.CDLL:
    handle = ctypes.CDLL(path)
    for fn, types in argtypes.items():
        getattr(handle, fn).argtypes = types
        getattr(handle, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
    return handle


def _index(device) -> int:
    device = None if device is None else torch.device(device)
    if device is None or device.index is None:
        return torch.cuda.current_device()
    return device.index


def stream(device=None) -> int:
    """The current stream of `device` (the current CUDA device by default)."""
    return torch.cuda.current_stream(device).cuda_stream


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
