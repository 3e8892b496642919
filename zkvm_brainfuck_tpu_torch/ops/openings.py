"""Opened values and reduced openings (csrc/openings.cu) and their plain
versions.

Counterpart of the device half of the JAX package's stark/pcs.py opening
rounds.  A unit is a list of member matrices of one height h (canonical
int32, (h, w_k)) evaluated on the points x_i = shift * g^(row0 + i), i < h,
g the generator of the order-2^log_m subgroup (row0 > 0 for a mesh shard's
rows), and one EF4 point z (a host tuple) outside that domain:

- `open_eval(mats, z, log_m, shift, row0=0)`: the (W, 4) raw sums
  S_c = sum_i f_c(x_i) * x_i * inv(x_i - z) of every column c of every
  member (W = sum of the widths), which the host completes into the
  barycentric opened values;
- `ro_accum(ro, mats, alpha_pows, s, z, log_m, shift, row0=0, first=False)`:
  per row, (sum_c alpha_c f_c(x_i) - s) * inv(x_i - z), with alpha_pows the
  (W, 4) int32 alpha powers of the columns and s an EF4 host tuple, written
  into a new (h, 4) reduced opening (`first`) or added to `ro` in place.

The wrappers launch the kernel for CUDA tensors, one launch for a unit of
up to MAX_MEMBERS members (more are split over launches; a unit whose
tiles do not fit a block's shared memory is refused), and take the plain
version only for CPU tensors.  The plain
versions are the eager int64 torch code the PCS ran before the kernels;
inverses are unique, so both give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import ext as xe
from . import field as xf
from . import kernels as kn
from .field import I32, I64, P

MAX_MEMBERS = 16  # members of one launch (csrc/openings.cu ZKBF_OPEN_MAX_MEMBERS)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _inv_x_minus_z(pts: torch.Tensor, z: tuple):
    """EF planes of inv(x - z) over base points x."""
    return xe.einv((xf.fsub(pts, z[0]), xf.fsub(0, z[1]), xf.fsub(0, z[2]), xf.fsub(0, z[3])))


def _weighted_col_sums(m: torch.Tensor, w: tuple) -> torch.Tensor:
    """(W, 4) raw sums S_c = sum_i m[i, c] * w(x_i) over the rows (exact)."""
    out = []
    for wt in w:
        out.append(((m.to(I64) * wt.to(I64)[:, None]) % P).sum(0) % P)
    return torch.stack(out, dim=-1).to(I32)


def open_eval_plain(mats: Sequence[torch.Tensor], z: tuple, log_m: int, shift: int,
                    row0: int = 0) -> torch.Tensor:
    pts = xf.coset_points(log_m, shift, row0, int(mats[0].shape[0]), mats[0].device)
    w = xe.emul_base(_inv_x_minus_z(pts, z), pts)
    return torch.cat([_weighted_col_sums(m, w) for m in mats])


def ro_accum_plain(ro, mats: Sequence[torch.Tensor], alpha_pows: torch.Tensor, s: tuple, z: tuple,
                   log_m: int, shift: int, row0: int = 0, first: bool = False):
    pts = xf.coset_points(log_m, shift, row0, int(mats[0].shape[0]), mats[0].device)
    ap = alpha_pows.to(I64)
    a, off = None, 0
    for m in mats:
        w = int(m.shape[1])
        m64 = m.to(I64)
        part = tuple(((m64 * ap[None, off : off + w, t]) % P).sum(1) % P for t in range(4))
        a = part if a is None else tuple((x + y) % P for x, y in zip(a, part))
        off += w
    diff = xe.esub(tuple(x.to(I32) for x in a), s)
    q = xe.emul(diff, _inv_x_minus_z(pts, z))
    if first:
        return xe.to_array(q)
    ro.copy_(xe.to_array(xe.eadd(xe.from_array(ro), q)))
    return ro


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_unit(what: str, mats: Sequence[torch.Tensor], log_m: int, row0: int) -> int:
    if not mats:
        raise ValueError(f"{what}: no member matrices")
    h = int(mats[0].shape[0])
    for m in mats:
        if m.dim() != 2 or int(m.shape[0]) != h or m.shape[1] < 1:
            raise ValueError(f"{what}: members must be 2-D, non-empty, with equal heights")
        if m.device != mats[0].device:
            raise ValueError(f"{what}: members on different devices")
    if row0 < 0 or row0 + h > (1 << log_m):
        raise ValueError(f"{what}: rows [{row0}, {row0 + h}) do not lie in a domain of 2^{log_m}")
    return h


def _require(t: torch.Tensor, what: str, ndim: int) -> None:
    """The launch path's check: int32 first, then a contiguous CUDA tensor."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {t.dtype}")
    kn.require_cuda_int32(t, what, ndim)


def _chunks(mats: Sequence[torch.Tensor]) -> List[List[int]]:
    """Member indices split into launches of at most MAX_MEMBERS members."""
    return [list(range(k, min(k + MAX_MEMBERS, len(mats)))) for k in range(0, len(mats), MAX_MEMBERS)]


def _member_arrays(mats: Sequence[torch.Tensor]):
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    widths = (ctypes.c_int * len(mats))(*[int(m.shape[1]) for m in mats])
    return ptrs, widths


def _words(v: tuple):
    return (ctypes.c_uint * 4)(*[int(x) % P for x in v])


def open_eval(mats: Sequence[torch.Tensor], z: tuple, log_m: int, shift: int,
              row0: int = 0) -> torch.Tensor:
    """(W, 4) canonical raw sums S_c = sum_i f_c(x_i) * x_i * inv(x_i - z)
    over the points shift * g^(row0 + i).  On the card one launch (after a
    clear of its 64-bit scratch) for all members."""
    mats = list(mats)
    _check_unit("open_eval", mats, log_m, row0)
    if not mats[0].is_cuda:
        return open_eval_plain(mats, z, log_m, shift, row0)
    return _launch_open_eval(mats, z, log_m, shift, row0)


def _launch_open_eval(mats, z, log_m, shift, row0):
    for m in mats:
        _require(m, "open_eval member", 2)
    h = int(mats[0].shape[0])
    device = mats[0].device
    total = sum(int(m.shape[1]) for m in mats)
    out = torch.empty((total, 4), dtype=I32, device=device)
    lib = kn.lib("openings.cu", device)
    g = xf.two_adic_root(log_m)
    zw = _words(z)
    col = 0
    for chunk in _chunks(mats):
        part = [mats[k] for k in chunk]
        width = sum(int(m.shape[1]) for m in part)
        scratch = torch.empty(lib.zkbf_open_eval_scratch_words(width), dtype=I64, device=device)
        ptrs, widths = _member_arrays(part)
        kn.check(lib.zkbf_open_eval(
            ctypes.addressof(ptrs), ctypes.addressof(widths), len(part), h, g, shift % P, row0,
            ctypes.addressof(zw), out[col:].data_ptr(), scratch.data_ptr(),
            kn.stream(device)), "open_eval")
        kn.COUNTS["open_eval"] += 1
        col += width
    return out


def ro_accum(ro, mats: Sequence[torch.Tensor], alpha_pows: torch.Tensor, s: tuple, z: tuple,
             log_m: int, shift: int, row0: int = 0, first: bool = False) -> torch.Tensor:
    """The (h, 4) reduced opening with (sum_c alpha_c f_c(x_i) - s) *
    inv(x_i - z) written into it (`first`: a new tensor, `ro` is not read)
    or added to `ro` in place.  On the card one launch for all members."""
    mats = list(mats)
    h = _check_unit("ro_accum", mats, log_m, row0)
    total = sum(int(m.shape[1]) for m in mats)
    if tuple(alpha_pows.shape) != (total, 4):
        raise ValueError(f"ro_accum: alpha_pows must be ({total}, 4), got {tuple(alpha_pows.shape)}")
    if not first and (ro is None or tuple(ro.shape) != (h, 4)):
        raise ValueError(f"ro_accum: ro must be ({h}, 4) unless first")
    if not mats[0].is_cuda:
        return ro_accum_plain(ro, mats, alpha_pows, s, z, log_m, shift, row0, first)
    return _launch_ro_accum(ro, mats, alpha_pows, s, z, log_m, shift, row0, first)


def _launch_ro_accum(ro, mats, alpha_pows, s, z, log_m, shift, row0, first):
    for m in mats:
        _require(m, "ro_accum member", 2)
    h = int(mats[0].shape[0])
    _require(alpha_pows, "ro_accum alpha_pows", 2)
    device = mats[0].device
    if first:
        ro = torch.empty((h, 4), dtype=I32, device=device)
    _require(ro, "ro_accum ro", 2)
    if ro.device != device or alpha_pows.device != device:
        raise ValueError("ro_accum: inputs on different devices")
    lib = kn.lib("openings.cu", device)
    g = xf.two_adic_root(log_m)
    zw = _words(z)
    col = 0
    for n, chunk in enumerate(_chunks(mats)):
        part = [mats[k] for k in chunk]
        width = sum(int(m.shape[1]) for m in part)
        ptrs, widths = _member_arrays(part)
        # (a1 + a2 - s) * inv = (a1 - s) * inv + a2 * inv: s in the first launch only
        sw = _words(s if n == 0 else (0, 0, 0, 0))
        kn.check(lib.zkbf_ro_accum(
            ctypes.addressof(ptrs), ctypes.addressof(widths), len(part), h, g, shift % P, row0,
            ctypes.addressof(zw), ctypes.addressof(sw),
            alpha_pows[col:].data_ptr(), ro.data_ptr(), int(first and n == 0),
            kn.stream(device)), "ro_accum")
        kn.COUNTS["ro_accum"] += 1
        col += width
    return ro
