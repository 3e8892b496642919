"""Two-adic multiplicative coset domains + Lagrange selectors.

Counterpart of the JAX package's stark/domains.py (p3's
TwoAdicMultiplicativeCoset: create_disjoint_domain, split_domains,
selectors_at_point / selectors_on_coset, zp_at_point, next_point).

A domain is (log_n, shift): the points shift * g^i, g = two_adic_generator.
Selectors follow p3's unshifted convention: with u = x / shift,
Z(u) = u^n - 1, first = Z/(u-1), last = Z/(u - g^{-1}), transition = u - g^{-1}.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import field as xf
from ..ops.field import GENERATOR, P
from . import ef_host as efh


@dataclass(frozen=True)
class Domain:
    log_n: int
    shift: int = 1

    @property
    def size(self) -> int:
        return 1 << self.log_n

    @property
    def gen(self) -> int:
        return xf.two_adic_root(self.log_n)

    def first_point(self) -> int:
        return self.shift

    def next_point_ef(self, zeta):
        """g * zeta for an EF4 point (host tuple)."""
        return efh.mul_base(zeta, self.gen)

    def create_disjoint_domain(self, min_size: int) -> "Domain":
        return Domain(
            log_n=(min_size - 1).bit_length(),
            shift=self.shift * GENERATOR % P,
        )

    def split_domains(self, n_chunks: int) -> list:
        log_chunks = n_chunks.bit_length() - 1
        g = self.gen
        return [
            Domain(self.log_n - log_chunks, self.shift * pow(g, k, P) % P)
            for k in range(n_chunks)
        ]

    # -- host (EF point) selectors ---------------------------------------

    def zp_at_point_ef(self, point):
        """Z(point) = (point/shift)^n - 1 for an EF4 point."""
        u = efh.mul_base(point, pow(self.shift, P - 2, P))
        return efh.add_base(efh.epow(u, self.size), P - 1)

    def selectors_at_point_ef(self, point):
        u = efh.mul_base(point, pow(self.shift, P - 2, P))
        z_h = efh.add_base(efh.epow(u, self.size), P - 1)
        g_inv = pow(self.gen, P - 2, P)
        first_den = efh.add_base(u, P - 1)
        last_den = efh.add_base(u, P - g_inv)
        return {
            "is_first_row": efh.mul(z_h, efh.inv(first_den)),
            "is_last_row": efh.mul(z_h, efh.inv(last_den)),
            "is_transition": last_den,
            "inv_zeroifier": efh.inv(z_h),
        }

    # -- whole-domain points (host) --------------------------------------

    def points_host(self) -> np.ndarray:
        """All domain points, natural order, canonical uint32."""
        pows = xf.powers_host(self.gen, self.size)
        return (pows.astype(np.uint64) * self.shift % P).astype(np.uint32)


@lru_cache(maxsize=None)
def domain_points_dev(log_n: int, shift: int, device: torch.device, row0: int = 0,
                      rows=None) -> torch.Tensor:
    """Points shift * g^i of the domain for i in [row0, row0 + rows) (all of
    them by default: a shard of a mesh asks for its own rows)."""
    rows = (1 << log_n) - row0 if rows is None else rows
    return xf.coset_points(log_n, shift, row0, rows, device)


@lru_cache(maxsize=None)
def selectors_on_coset(trace_log_n: int, coset_log_n: int, coset_shift: int, device,
                       row0: int = 0, rows=None):
    """Selectors of the trace domain H_n (shift 1) over a larger coset, as
    canonical int32 tensors built on `device` (values of the JAX package's
    selectors_on_coset / selectors_on_coset_dev), at the coset rows [row0,
    row0 + rows) (all by default).  Z_H is periodic with period = coset size
    / n, so its inversion runs on that many lanes."""
    assert coset_shift != 1
    device = torch.device(device)
    n = 1 << trace_log_n
    rows = (1 << coset_log_n) - row0 if rows is None else rows
    g_c = xf.two_adic_root(coset_log_n)
    x = domain_points_dev(coset_log_n, coset_shift, device, row0, rows)
    log_per = coset_log_n - trace_log_n
    if row0 % (1 << log_per) or rows % (1 << log_per):
        raise ValueError(f"selectors_on_coset: rows [{row0}, {row0 + rows}) split Z_H's period")
    zh_short = xf.fsub(
        xf.fmul(xf.powers_dev(pow(g_c, n, P), 1 << log_per, device), pow(coset_shift, n, P)), 1
    )
    g_inv = pow(xf.two_adic_root(trace_log_n), P - 2, P)
    first_den = xf.fadd(x, P - 1)
    last_den = xf.fadd(x, P - g_inv)
    zh = zh_short.repeat(rows >> log_per)
    return {
        "is_first_row": xf.fmul(zh, xf.finv(first_den)),
        "is_last_row": xf.fmul(zh, xf.finv(last_den)),
        "is_transition": last_den,
        "inv_zeroifier": xf.finv(zh_short).repeat(rows >> log_per),
    }
