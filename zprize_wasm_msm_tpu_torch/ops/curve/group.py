"""Branch-free elliptic-curve group ops on limb-tensor batches.

Counterpart of the reference's Jacobian a=0 group layer
(wasmcurves/src/build_curve_jacobian_a0.js: add:541, addMixed:661,
double:291, neg, timesScalar via build_timesscalarnaf.js,
normalize/toAffine:940-1013, batchToAffine:1040).

The reference's Jacobian formulas carry data-dependent special cases
(P==Q, P==-Q, infinity); a batched tensor program would have to evaluate
both the add and the double path plus selects.  Instead these are the
*complete* homogeneous projective formulas for a=0 curves
(Renes–Costello–Batina 2016, Algorithms 7-9): exception-free by
construction, every batch element runs the identical straight-line code.
Infinity is (0:1:0); affine zero is encoded as (0,0) exactly like the
reference (build_curve_jacobian_a0.js isZeroAffine:55).

Curves with a != 0 (MNT6753 G1 and G2, the reference's projective curve,
build_curve_projective.js) take the complete formulas for any a (RCB16
algorithm 1) in ``_add_general``; ``double`` and ``add_mixed`` reuse it.

A point batch is a tuple (X, Y, Z) of int64 tensors of shape (EL, *batch)
in Montgomery form (EL = field.elem_len); affine batches are (X, Y).
These functions are also the plain version the CUDA device functions
(csrc/group.cuh) are held against, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..field.tower import stack_elems
from .spec import CurveSpec

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
AffinePoint = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# constructors / predicates
# ---------------------------------------------------------------------------


def zero(curve: CurveSpec, batch_shape=(), device=None) -> Point:
    """The identity (0 : 1 : 0)."""
    F = curve.field
    return (
        F.zeros(batch_shape, device),
        F.one(batch_shape, device),
        F.zeros(batch_shape, device),
    )


def generator(curve: CurveSpec, batch_shape=(), device=None) -> Point:
    F = curve.field
    return (
        F.const(curve.gx, batch_shape, device),
        F.const(curve.gy, batch_shape, device),
        F.one(batch_shape, device),
    )


def is_zero(curve: CurveSpec, p: Point) -> torch.Tensor:
    return curve.field.is_zero(p[2])


def is_zero_affine(curve: CurveSpec, p: AffinePoint) -> torch.Tensor:
    """(0,0) encodes the affine identity (ref isZeroAffine:55)."""
    F = curve.field
    return F.is_zero(p[0]) & F.is_zero(p[1])


def from_affine(curve: CurveSpec, p: AffinePoint) -> Point:
    """Affine -> projective; (0,0) -> (0:1:0)."""
    F = curve.field
    z = is_zero_affine(curve, p)
    batch = F.batch_shape(p[0])
    one = F.one(batch, p[0].device)
    zeros = F.zeros(batch, p[0].device)
    return (p[0], F.select(z, one, p[1]), F.select(z, zeros, one))


def eq(curve: CurveSpec, p: Point, q: Point) -> torch.Tensor:
    """Projective equality: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1 (+ both-inf)."""
    F = curve.field
    both_inf = is_zero(curve, p) & is_zero(curve, q)
    one_inf = is_zero(curve, p) ^ is_zero(curve, q)
    x_eq = F.eq(F.mul(p[0], q[2]), F.mul(q[0], p[2]))
    y_eq = F.eq(F.mul(p[1], q[2]), F.mul(q[1], p[2]))
    return both_inf | (x_eq & y_eq & ~one_inf)


# ---------------------------------------------------------------------------
# complete group law (RCB16 algorithms 7/8/9 for a = 0)
# ---------------------------------------------------------------------------


def _b3(curve: CurveSpec, like: torch.Tensor) -> torch.Tensor:
    """3b as an (L, 1, ..., 1) Montgomery constant beside ``like``."""
    return curve.field.const(curve.b3, (1,) * (like.ndim - 1), like.device)


def _const(curve: CurveSpec, value, like: torch.Tensor) -> torch.Tensor:
    """A coordinate-field constant as an (EL, 1, ..., 1) batch beside ``like``."""
    return curve.field.const(value, (1,) * (like.ndim - 1), like.device)


def _add_general(curve: CurveSpec, p: Point, q: Point) -> Point:
    """Complete projective addition for ARBITRARY a (RCB16 alg. 1; 12M and
    the products by a and 3b), in the JAX package's five rounds of
    independent products; the sums of a round are stacked too.

    Serves the reference's projective curve (build_curve_projective.js,
    MNT6753 with a = 11) — but exception-free where the reference's
    add-1998-cmo-2 has special cases.
    """
    F = curve.field
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    b3 = _const(curve, curve.b3, X1)
    a = _const(curve, curve.a, X1)
    fadd, fsub = F.add, F.sub

    sX1Y1, sX2Y2, sX1Z1, sX2Z2, sY1Z1, sY2Z2 = fadd(
        stack_elems(X1, X2, X1, X2, Y1, Y2), stack_elems(Y1, Y2, Z1, Z2, Z1, Z2)
    ).unbind(1)
    t0, t1, t2, m3, m4, m5 = F.mul_many(
        [(X1, X2), (Y1, Y2), (Z1, Z2), (sX1Y1, sX2Y2), (sX1Z1, sX2Z2), (sY1Z1, sY2Z2)]
    )
    # X1Y2 + X2Y1, X1Z2 + X2Z1, Y1Z2 + Y2Z1
    t3, t4, t5 = fsub(
        stack_elems(m3, m4, m5), fadd(stack_elems(t0, t0, t1), stack_elems(t1, t2, t2))
    ).unbind(1)

    at4, bt2, at2 = F.mul_many([(a, t4), (b3, t2), (a, t2)])
    Z3a, t0_2 = fadd(stack_elems(bt2, t0), stack_elems(at4, t0)).unbind(1)
    Z3, t0_3 = fadd(stack_elems(t1, t0_2), stack_elems(Z3a, t0)).unbind(1)
    X3, t2n = fsub(stack_elems(t1, t0), stack_elems(Z3a, at2)).unbind(1)
    t1n = fadd(t0_3, at2)  # 3 t0 + a t2

    bt4, at2n = F.mul_many([(b3, t4), (a, t2n)])
    t4n = fadd(bt4, at2n)

    Y3, m0, m1, m2, m3b = F.mul_many(
        [(X3, Z3), (t1n, t4n), (t5, t4n), (t3, X3), (t3, t1n)]
    )
    (m4b,) = F.mul_many([(t5, Z3)])
    Y3, Z3 = fadd(stack_elems(Y3, m4b), stack_elems(m0, m3b)).unbind(1)
    return (fsub(m2, m1), Y3, Z3)


def add(curve: CurveSpec, p: Point, q: Point) -> Point:
    """Complete projective addition (RCB16 alg. 7 for a=0; 12M; alg. 1 for
    general a, _add_general).

    Replaces the reference's branchy Jacobian add
    (build_curve_jacobian_a0.js:541-658) — handles P==Q, P==-Q and
    infinities with NO special cases.
    """
    if curve.a != 0:
        return _add_general(curve, p, q)
    F = curve.field
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    b3 = _b3(curve, X1)
    fadd, fsub = F.add, F.sub

    # round 1: six independent products, one stacked multiply (their six
    # operand sums one stacked add: eager PyTorch pays per launch)
    sX1Y1, sX2Y2, sY1Z1, sY2Z2, sX1Z1, sX2Z2 = fadd(
        stack_elems(X1, X2, Y1, Y2, X1, X2), stack_elems(Y1, Y2, Z1, Z2, Z1, Z2)
    ).unbind(1)
    t0, t1, t2, A, B, C = F.mul_many(
        [(X1, X2), (Y1, Y2), (Z1, Z2), (sX1Y1, sX2Y2), (sY1Z1, sY2Z2), (sX1Z1, sX2Z2)]
    )
    # X1Y2 + X2Y1, Y1Z2 + Y2Z1, X1Z2 + X2Z1
    t3, t4, Yr = fsub(
        fsub(stack_elems(A, B, C), stack_elems(t0, t1, t0)), stack_elems(t1, t2, t2)
    ).unbind(1)
    t0_3 = fadd(fadd(t0, t0), t0)

    # round 2: the two b3 products
    t2b, Yb = F.mul_many([(b3, t2), (b3, Yr)])
    Z3l = fadd(t1, t2b)
    t1l = fsub(t1, t2b)

    # round 3: six independent products
    X3a, t2c, Yc, t1c, t0c, Z3c = F.mul_many(
        [
            (t4, Yb),
            (t3, t1l),
            (Yb, t0_3),
            (t1l, Z3l),
            (t0_3, t3),
            (Z3l, t4),
        ]
    )
    Y3, Z3 = fadd(stack_elems(t1c, Z3c), stack_elems(Yc, t0c)).unbind(1)
    return (fsub(t2c, X3a), Y3, Z3)


def add_mixed(curve: CurveSpec, p: Point, q: AffinePoint) -> Point:
    """Complete projective + affine addition, a=0 (RCB16 alg. 8; 11M).

    Replaces build_curve_jacobian_a0.js addMixed:661.  The affine identity
    (0,0) cannot be expressed in the complete formula, so it is handled by
    one select — the only mask in the hot path.  General-a curves lift q
    and take the complete add.
    """
    if curve.a != 0:
        return add(curve, p, from_affine(curve, q))
    F = curve.field
    X1, Y1, Z1 = p
    X2, Y2 = q
    b3 = _b3(curve, X1)
    fadd, fsub = F.add, F.sub

    # round 1: six independent products (incl. b3*Z1), one stacked multiply
    sX1Y1, sX2Y2 = fadd(stack_elems(X1, X2), stack_elems(Y1, Y2)).unbind(1)
    t0, t1, A, t4a, Ya, t2b = F.mul_many(
        [(X1, X2), (Y1, Y2), (sX1Y1, sX2Y2), (Y2, Z1), (X2, Z1), (b3, Z1)]
    )
    t4, Yr, t0_2, Z3l = fadd(stack_elems(t4a, Ya, t0, t1), stack_elems(Y1, X1, t0, t2b)).unbind(1)
    At0, t1l = fsub(stack_elems(A, t1), stack_elems(t0, t2b)).unbind(1)
    t3 = fsub(At0, t1)
    t0_3 = fadd(t0_2, t0)

    # round 2
    (Yb,) = F.mul_many([(b3, Yr)])

    # round 3: six independent products
    X3a, t2c, Yc, t1c, t0c, Z3c = F.mul_many(
        [
            (t4, Yb),
            (t3, t1l),
            (Yb, t0_3),
            (t1l, Z3l),
            (t0_3, t3),
            (Z3l, t4),
        ]
    )
    X3 = fsub(t2c, X3a)
    Y3, Z3 = fadd(stack_elems(t1c, Z3c), stack_elems(Yc, t0c)).unbind(1)

    qz = is_zero_affine(curve, q)
    return (
        F.select(qz, X1, X3),
        F.select(qz, Y1, Y3),
        F.select(qz, Z1, Z3),
    )


def double(curve: CurveSpec, p: Point) -> Point:
    """Complete projective doubling, a=0 (RCB16 alg. 9; 6M+2S).

    Replaces build_curve_jacobian_a0.js double:291; handles infinity for
    free ((0:1:0) maps to itself).  General-a curves take the complete add
    with P = Q.
    """
    if curve.a != 0:
        return _add_general(curve, p, p)
    F = curve.field
    X, Y, Z = p
    b3 = _b3(curve, X)
    fadd, fsub = F.add, F.sub

    # round 1: four independent products
    t0, t1, t2, txy = F.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])

    # round 2; then 8 Y^2, t0 + t2b and t0 - 3 t2b, their sums stacked
    (t2b,) = F.mul_many([(b3, t2)])
    Z2, Y3s, t2b_2 = fadd(stack_elems(t0, t0, t2b), stack_elems(t0, t2b, t2b)).unbind(1)
    Z4, t2b_3 = fadd(stack_elems(Z2, t2b_2), stack_elems(Z2, t2b)).unbind(1)
    Z8 = fadd(Z4, Z4)  # 8*Y^2
    t0p = fsub(t0, t2b_3)

    # round 3: four independent products
    X3a, Z3c, Yc, Xc = F.mul_many(
        [(t2b, Z8), (t1, Z8), (t0p, Y3s), (t0p, txy)]
    )
    X3, Y3 = fadd(stack_elems(Xc, X3a), stack_elems(Xc, Yc)).unbind(1)
    return (X3, Y3, Z3c)


def neg(curve: CurveSpec, p: Point) -> Point:
    return (p[0], curve.field.neg(p[1]), p[2])


def neg_affine(curve: CurveSpec, p: AffinePoint) -> AffinePoint:
    return (p[0], curve.field.neg(p[1]))


def sub(curve: CurveSpec, p: Point, q: Point) -> Point:
    return add(curve, p, neg(curve, q))


def select(mask: torch.Tensor, p: Point, q: Point) -> Point:
    """Batch-wise select between two point batches (mask True -> p)."""
    return tuple(torch.where(mask[None], a, b) for a, b in zip(p, q))


# ---------------------------------------------------------------------------
# scalar multiplication (ref build_timesscalarnaf.js / timesScalar)
# ---------------------------------------------------------------------------


def times_scalar(curve: CurveSpec, p: Point, scalar_limbs: torch.Tensor) -> Point:
    """MSB-first double-and-add over a batch.

    scalar_limbs: (Ls, *batch) int64 16-bit limbs (standard domain).
    The reference uses a NAF ladder (build_timesscalarnaf.js); with complete
    formulas a plain ladder is branch-free, and MSM never calls this on the
    hot path — it exists for API parity and as a differential oracle.
    A Python loop over the Ls*16 bits: one double, one add, one select each.
    """
    F = curve.field
    Ls = scalar_limbs.shape[0]
    acc = zero(curve, F.batch_shape(p[0]), p[0].device)
    for limb in range(Ls - 1, -1, -1):
        for bit in range(15, -1, -1):
            acc = double(curve, acc)
            added = add(curve, acc, p)
            acc = select(((scalar_limbs[limb] >> bit) & 1) == 1, added, acc)
    return acc


# ---------------------------------------------------------------------------
# normalization (ref normalize/toAffine:940-1013, batchToAffine:1040)
# ---------------------------------------------------------------------------


def to_affine(curve: CurveSpec, p: Point) -> AffinePoint:
    """Projective -> affine via batched Montgomery inversion of Z.

    Infinity maps to (0,0), matching the reference's encoding.
    """
    F = curve.field
    X, Y, Z = p
    zinv = F.batch_inverse(Z)
    x, y = F.mul_many([(X, zinv), (Y, zinv)])
    inf = F.is_zero(Z)
    zl = torch.zeros_like(x)
    return (F.select(inf, zl, x), F.select(inf, zl, y))


def in_curve(curve: CurveSpec, p: Point) -> torch.Tensor:
    """Y^2*Z == X^3 + a*X*Z^2 + b*Z^3 (ref inCurve:1330)."""
    F = curve.field
    X, Y, Z = p
    b = _const(curve, curve.b, X)
    zsq = F.mul(Z, Z)
    lhs = F.mul(F.mul(Y, Y), Z)
    x3 = F.mul(F.mul(X, X), X)
    rhs = F.add(x3, F.mul(b, F.mul(zsq, Z)))
    if curve.a != 0:
        rhs = F.add(rhs, F.mul(_const(curve, curve.a, X), F.mul(X, zsq)))
    return F.eq(lhs, rhs) | is_zero(curve, p)
