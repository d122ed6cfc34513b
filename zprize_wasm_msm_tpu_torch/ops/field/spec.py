"""Field specialization constants.

Analog of the reference's codegen-time field specialization (reference:
wasmcurves/src/build_f1m.js:28-50 computes n64, pq, pR2, pOne, np32 at WASM
build time).  Here the same constants are precomputed host-side into a
frozen, hashable ``FieldSpec`` that parameterizes every field function and
every kernel launch.

Limb representation at the package's public functions: little-endian 16-bit
limbs, ``n_limbs`` a multiple of 4, Montgomery radix R = 2**(16 * n_limbs).
The plain tensor arithmetic (ops.field.mont) holds those limbs in int64;
the CUDA kernels see the SAME integer as ``n_words = n_limbs / 2`` packed
32-bit words (word j = limb 2j | limb 2j+1 << 16), so they need
``np32 = -q^{-1} mod 2^32`` and 32-bit-word views of q and R mod q, which
this spec adds to the 16-bit constants.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from functools import cached_property

from ...utils.bigint import int_to_limbs, mod_inv

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """All host-precomputed constants for one prime field.

    Montgomery radix R = 2**(16 * n_limbs); matches the reference's
    R = 2**384 for BLS12-381 Fq (build_f1m.js) because n_limbs = 48*8/16.
    """

    q: int  # the prime modulus

    @cached_property
    def bits(self) -> int:
        return self.q.bit_length()

    @cached_property
    def n_limbs(self) -> int:
        # Round the limb count up to a multiple of 4 (64-bit words) so that
        # R matches the reference's 64-bit-limb Montgomery radix exactly.
        n64 = -(-self.bits // 64)
        return n64 * 4

    @cached_property
    def n_bytes(self) -> int:
        return self.n_limbs * 2

    @cached_property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.n_limbs)

    @cached_property
    def R_mod_q(self) -> int:
        return self.R % self.q

    @cached_property
    def R2_mod_q(self) -> int:
        return (self.R * self.R) % self.q

    @cached_property
    def R_inv_mod_q(self) -> int:
        """R^{-1} mod q: from_mont_int's factor, computed once."""
        return mod_inv(self.R, self.q)

    @cached_property
    def np16(self) -> int:
        """-q^{-1} mod 2^16 (reference np32, build_f1m.js:504, for word=16)."""
        return (-mod_inv(self.q, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @cached_property
    def np32(self) -> int:
        """-q^{-1} mod 2^32: the CIOS word constant of the 32-bit-word CUDA
        field core (csrc/field.cuh)."""
        return (-mod_inv(self.q, 1 << 32)) % (1 << 32)

    @cached_property
    def n_words(self) -> int:
        """32-bit words per element in the CUDA kernels (n_limbs / 2)."""
        return self.n_limbs // 2

    # ---- 32-bit-word views (little-endian, uint32) for the CUDA kernels ----

    @cached_property
    def q_words(self) -> np.ndarray:
        return int_to_limbs(self.q, self.n_words, 32)

    @cached_property
    def one_mont_words(self) -> np.ndarray:
        """Montgomery form of 1 (= R mod q) as 32-bit words."""
        return int_to_limbs(self.R_mod_q, self.n_words, 32)

    # ---- numpy constant arrays (little-endian 16-bit limbs in uint32) ----

    @cached_property
    def q_limbs(self) -> np.ndarray:
        return int_to_limbs(self.q, self.n_limbs)

    @cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R2_mod_q, self.n_limbs)

    @cached_property
    def one_mont_limbs(self) -> np.ndarray:
        """Montgomery form of 1 (= R mod q); reference pOne."""
        return int_to_limbs(self.R_mod_q, self.n_limbs)

    @cached_property
    def zero_limbs(self) -> np.ndarray:
        return np.zeros(self.n_limbs, dtype=np.uint32)

    # ---- sqrt (Tonelli-Shanks) parameters, ref build_f1m.js:1127-1145 ----

    @cached_property
    def sqrt_s(self) -> int:
        """2-adicity: q - 1 = t * 2^s with t odd."""
        s, t = 0, self.q - 1
        while t % 2 == 0:
            s += 1
            t //= 2
        return s

    @cached_property
    def sqrt_t(self) -> int:
        return (self.q - 1) >> self.sqrt_s

    @cached_property
    def nqr(self) -> int:
        """Smallest quadratic non-residue (codegen-time search, as ref)."""
        n = 2
        while pow(n, (self.q - 1) // 2, self.q) != self.q - 1:
            n += 1
        return n

    def to_mont_int(self, a: int) -> int:
        return (a % self.q) * self.R % self.q

    def from_mont_int(self, a: int) -> int:
        return a * self.R_inv_mod_q % self.q

    def __repr__(self) -> str:  # keep reprs short in test output
        return f"FieldSpec(bits={self.bits}, n_limbs={self.n_limbs})"


@functools.lru_cache(maxsize=None)
def field_spec(q: int) -> FieldSpec:
    return FieldSpec(q)
