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

from . import ef_host as efh
from . import field as xf
from .field import GENERATOR, P


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
