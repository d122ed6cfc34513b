"""GLV endomorphism scalar decomposition, vectorized over the batch.

Counterpart of the reference's GLV module (wasmcurves/src/build_glv.js —
decomposeScalar:53-146, endomorphism:150, preprocessEndomorphism:178-263,
isPositive:34).  The reference runs a 512-bit long division per scalar (via
the g1m_int512 instance of build_int.js); here the division by the lattice
determinant r is a Barrett reduction with a host-precomputed mu, so the
whole decomposition is a handful of vectorized limb products over the batch
(ops.field.intops) — no data-dependent loops.

Semantics match the reference exactly:
    q1 = floor(k / r)                  (u1 = 1)
    q2 = floor(k * negV1 / r)
    k1 = k - q1*v0 - q2*u0 = k - q1 - q2*u0          (v0 = 1)
    k2 = -q1*v1 - q2*u1   = q1*negV1 - q2            (u1 = 1)
    sign bit 0 = (k1 >= 0), bit 1 = (k2 >= 0); outputs |k1|, |k2|
and k = k1 + k2*lambda (mod r) with phi(x, y) = (beta*x, y) = lambda*(x,y).

The one field product per point, beta * x, goes through
ops.field.batch.batch_mul: the mont_mul CUDA kernel for points on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..curve.spec import CurveSpec
from ..field import batch, intops, mont

#: number of 16-bit limbs in a decomposed half-scalar slot.  |k1|,|k2| fit
#: in ~128 bits for canonical inputs; 9 limbs (144 bits) leave slack for
#: non-canonical (>= r) inputs.
HALF_LIMBS = 9

#: tight bit bound for the decomposed |k1|, |k2| magnitudes: the lattice
#: constants are ~2^127.5 (u0 = z^2, |v1| = z^2 - 1), Barrett quotients
#: carry <= 2 of slack, and non-canonical 256-bit inputs add ~1 bit — so
#: 132 bits covers every reachable value with >= 2 bits of headroom.
#: Window digitization uses THIS (not HALF_LIMBS*16): 12 fewer digit bits
#: means 2 fewer windows at c=6 (W 23 vs 25).
MAX_BITS = 132


def decompose_scalars(
    curve: CurveSpec, scalars: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split (Ls, N) scalars into (|k1|, |k2|, k1_pos, k2_pos).

    |k1|, |k2| are (HALF_LIMBS, N) limb tensors; k1_pos/k2_pos boolean (N,)
    (True = positive, zero counts as positive, matching isPositive:34).
    """
    glv = curve.glv
    if glv is None:
        raise ValueError(f"{curve.name} has no GLV spec")
    r = curve.r
    neg_v1 = -glv.v1  # positive constant (build_glv.js negV1)
    Ls = scalars.shape[0]

    # q1 = k / r
    q1 = intops.barrett_div(scalars, r)  # (Ls, N)
    # q2 = (k * negV1) / r
    prod = intops.int_mul_const(scalars, neg_v1)  # (Ls + 8, N)
    q2 = intops.barrett_div(prod, r)

    # k1 = k - q1 - q2*u0   (in Ls+9 limbs; |k1| < 2^144)
    wide = Ls + HALF_LIMBS
    k_w = intops.pad_limbs(scalars, wide)
    q2u0 = intops.int_mul_const(q2, glv.u0, wide)
    d, _ = intops.int_add(intops.pad_limbs(q1, wide), q2u0)
    k1, borrow1 = intops.int_sub(k_w, d)
    k1_neg_mag, _ = intops.int_sub(d, k_w)
    k1_pos = borrow1 == 0
    k1_abs = torch.where(k1_pos[None], k1, k1_neg_mag)[:HALF_LIMBS]

    # k2 = q1*negV1 - q2
    s1 = intops.int_mul_const(q1, neg_v1, wide)
    q2_w = intops.pad_limbs(q2, wide)
    k2, borrow2 = intops.int_sub(s1, q2_w)
    k2_neg_mag, _ = intops.int_sub(q2_w, s1)
    k2_pos = borrow2 == 0
    k2_abs = torch.where(k2_pos[None], k2, k2_neg_mag)[:HALF_LIMBS]

    return k1_abs, k2_abs, k1_pos, k2_pos


def endomorphism(curve: CurveSpec, points: Tuple[torch.Tensor, torch.Tensor], impl: str = "auto"):
    """phi(x, y) = (beta*x, y) on an affine Montgomery batch
    (ref build_glv.js endomorphism:150-163, sans the sign fold)."""
    fq = curve.fq
    X, Y = points
    # beta as ONE (L, 1) element: batch_mul reads it for the whole batch
    beta = mont._int_const(fq, fq.to_mont_int(curve.glv.beta), X.device)
    return (batch.batch_mul(fq, X, mont._col(beta, X.ndim - 1), impl=impl), Y)


def preprocess_endomorphism(
    curve: CurveSpec,
    points: Tuple[torch.Tensor, torch.Tensor],
    scalars: torch.Tensor,
    impl: str = "auto",
):
    """n points / full scalars -> 2n points / half-width positive scalars.

    (ref preprocessEndomorphism:178-263.)  Output layout is
    [originals..., endomorphisms...] (vs the reference's interleaving —
    irrelevant to the MSM sum).  The sign of k1/k2 is folded into y.
    """
    fq = curve.fq
    X, Y = points
    k1, k2, k1_pos, k2_pos = decompose_scalars(curve, scalars)
    negY = mont.neg(fq, Y)
    y1 = mont._select(k1_pos, Y, negY)
    bX, _ = endomorphism(curve, (X, Y), impl=impl)
    y2 = mont._select(k2_pos, Y, negY)
    Xout = torch.cat([X, bX], dim=1)
    Yout = torch.cat([y1, y2], dim=1)
    kout = torch.cat([k1, k2], dim=1)
    return (Xout, Yout), kout
