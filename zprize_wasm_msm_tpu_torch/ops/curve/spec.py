"""Curve specialization constants (host-side).

Analog of the reference's per-curve codegen specialization
(wasmcurves/src/build_curve_jacobian_a0.js:29 receives prime, b, prefix;
src/bls12381/build_bls12381.js:22-23 supplies q, r).  A frozen, hashable
``CurveSpec`` parameterizes every curve/MSM function and kernel launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Tuple

import numpy as np

from ..field.spec import FieldSpec, field_spec
from ...utils.bigint import int_to_limbs


@dataclass(frozen=True)
class GLVSpec:
    """GLV endomorphism lattice for curves with CM discriminant -3.

    Constants match the reference's codegen-time table
    (wasmcurves/src/build_glv.js:13-30): beta is the cube root of unity in
    Fq; (u0,u1), (v0,v1) span the lattice of (a,b) with a + b*lambda = 0
    mod r; divisor = u0*v1 - ... = r.
    """

    beta: int  # cube root of unity in Fq (standard domain)
    lam: int  # lambda: phi(P) = lam * P
    u0: int
    u1: int
    v0: int
    v1: int  # may be negative


@dataclass(frozen=True)
class CurveSpec:
    """Short Weierstrass curve y^2 = x^3 + a*x + b over Fq (or an extension
    of it), subgroup order r.

    ext=1: coordinates in Fq, b/gx/gy plain ints.
    ext=2: coordinates in Fq2 = Fq[u]/(u^2 - nr) (the reference's G2 over
    f2m, wasmcurves/src/bls12381/build_bls12381.js:47-53); b/gx/gy are
    2-tuples (c0, c1).
    ext=3: coordinates in Fq3 = Fq[v]/(v^3 - nr) (MNT6753's G2 over f3m,
    src/mnt6753/build_mnt6753.js:56); a/b/gx/gy are 3-tuples.
    a: 0 for the a = 0 formulas, else the general-a ones (ops.curve.group).
    """

    name: str
    q: int
    r: int
    a: Tuple[int, ...]  # int for ext=1; int or a component tuple over an extension
    b: Tuple[int, ...]  # int for ext=1, (c0, c1) for ext=2, (c0, c1, c2) for ext=3
    gx: Tuple[int, ...]
    gy: Tuple[int, ...]
    glv: Optional[GLVSpec] = None
    ext: int = 1
    nr: int = -1  # extension non-residue (u^2 = nr), ext >= 2 only
    bls_x: Optional[int] = None  # signed BLS parameter (subgroup checks, pairing)

    @cached_property
    def fq(self) -> FieldSpec:
        return field_spec(self.q)

    @cached_property
    def fr(self) -> FieldSpec:
        return field_spec(self.r)

    @cached_property
    def field(self):
        """The coordinate-field backend (ops.field.tower)."""
        from ..field import tower

        if self.ext == 1:
            return tower.Fq(self.fq)
        if self.ext == 2:
            return tower.Fq2(self.fq, self.nr)
        if self.ext != 3:
            raise ValueError(f"{self.name}: unsupported extension degree {self.ext}")
        return tower.Fq3(self.fq, self.nr)

    @cached_property
    def b3(self):
        """3*b as a coordinate-field host constant (for the RCB16 formulas)."""
        if isinstance(self.b, int):
            return 3 * self.b % self.q
        return tuple(3 * c % self.q for c in self.b)

    # --- Montgomery-domain constants used by the projective formulas ------
    # b3_mont_limbs, b_mont_limbs and a_mont_limbs are Fq constants (on an
    # extension curve's tuples they raise a TypeError); an extension curve's
    # 3b reaches the kernels as b3_flat_limbs, and the plain group ops take
    # a, b and 3b through curve.field.const.

    @cached_property
    def b3_mont_limbs(self) -> np.ndarray:
        """3*b in Montgomery form (used by the complete a=0 formulas)."""
        return int_to_limbs(self.fq.to_mont_int(3 * self.b), self.fq.n_limbs)

    @cached_property
    def b3_flat_limbs(self) -> Tuple[int, ...]:
        """3*b as flat Montgomery limbs over the coordinate field
        (ext*L entries): the layout the CUDA kernels' constant block is
        packed from (_build.curve_consts)."""
        b3 = self.b3
        comps = (b3,) if isinstance(b3, int) else tuple(b3)
        out = []
        for comp in comps:
            out.extend(
                int(v)
                for v in int_to_limbs(self.fq.to_mont_int(comp), self.fq.n_limbs)
            )
        return tuple(out)

    @cached_property
    def b_mont_limbs(self) -> np.ndarray:
        return int_to_limbs(self.fq.to_mont_int(self.b), self.fq.n_limbs)

    @cached_property
    def a_mont_limbs(self) -> np.ndarray:
        return int_to_limbs(self.fq.to_mont_int(self.a), self.fq.n_limbs)

    @cached_property
    def beta_mont_limbs(self) -> Optional[np.ndarray]:
        if self.glv is None:
            return None
        return int_to_limbs(self.fq.to_mont_int(self.glv.beta), self.fq.n_limbs)

    @cached_property
    def generator_affine(self) -> Tuple[int, int]:
        return (self.gx, self.gy)

    def __repr__(self) -> str:
        return f"CurveSpec({self.name})"
