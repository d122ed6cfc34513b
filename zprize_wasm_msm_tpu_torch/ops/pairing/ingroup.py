"""Endomorphism-based subgroup membership checks for BLS12-381.

Port of zprize_wasm_msm_tpu/ops/pairing/ingroup.py, the counterpart of the
reference's in-group checks (wasmcurves/src/bls12381/build_bls12381.js
buildInGroupG1:1494-1556, buildInGroupG2:1376-1492, wired at :1612-1615) —
curve membership alone (in_curve) does NOT imply membership in the order-r
subgroup: G1 has cofactor ~2^125, the G2 twist ~2^381, and accepting
non-subgroup points breaks pairing-based protocols.

G1 (Bowe's criterion, as the reference):
    sigma(P)  = (beta  * x, y)     -- beta a primitive cube root of 1 in Fq
    sigma2(P) = (beta^2 * x, y)
    P in subgroup  <=>  [(z^2-1)/3] * (2*sigma(P) - P - sigma2(P)) == sigma2(P)
where z is the BLS parameter.  Which of the two cube roots plays `beta`
matters; it is validated once per curve against the host oracle instead of
hardcoding the reference's byte constants.

G2 (untwist-Frobenius endomorphism psi, as the reference):
    P in subgroup  <=>  [z] * psi^3(P') + psi^2(P') == P
with P' the W-scaled point and psi^2/psi^3 realized by the reference's
constant dance (WINV, FROB2X, FROB3Y and the (1±u) component shuffles,
build_bls12381.js:1382-1471).

Both checks are batched: inputs are affine Montgomery batches, output a
boolean mask (identity counts as in-group; off-curve points are rejected).
Plain group ops (the scalar multiplication is group.times_scalar's ladder).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..curve import group
from ..curve.spec import CurveSpec
from ..field import mont
from ...utils.bigint import int_to_limbs
from .tower import _st

# Constants of the reference's G2 check (build_bls12381.js:1382-1392).
# WINV = ((1+u)/2)^-1-style untwist scalar; FROB2X/FROB3Y the Frobenius
# twist factors.  Public curve constants.
_WINV = (
    2001204777610833696708894912867952078278441409969503942666029068062015825245418932221343814564507832018947136279894,
    2001204777610833696708894912867952078278441409969503942666029068062015825245418932221343814564507832018947136279893,
)
_FROB2X = 4002409555221667392624310435006688643935503118305586438271171395842971157480381377015405980053539358417135540939436
_FROB3Y = (
    2973677408986561043442465346520108879172042883009249989176415018091420807192182638567116318576472649347015917690530,
    2973677408986561043442465346520108879172042883009249989176415018091420807192182638567116318576472649347015917690530,
)


@functools.lru_cache(maxsize=None)
def _cube_roots_for_g1_check(q: int, r: int, gx: int, gy: int, b: int, z: int):
    """(beta, beta2) ordered so the Bowe predicate holds on the generator —
    validated against the pure-Python oracle once per curve."""
    from ...oracle import Curve as OracleCurve

    # the two primitive cube roots of unity in Fq
    g = 2
    while pow(g, (q - 1) // 3, q) == 1:
        g += 1
    r1 = pow(g, (q - 1) // 3, q)
    r2 = r1 * r1 % q
    oc = OracleCurve(q=q, a=0, b=b, r=r, gx=gx, gy=gy)
    zc = (z * z - 1) // 3
    for beta, beta2 in ((r1, r2), (r2, r1)):
        P = oc.g
        sp = (beta * P[0] % q, P[1])
        s2p = (beta2 * P[0] % q, P[1])
        t = oc.add(oc.add(oc.double(sp), oc.neg(P)), oc.neg(s2p))
        if oc.mul(t, zc) == s2p:
            return beta, beta2
    raise AssertionError("neither cube-root order satisfies the predicate")


def _limbs_col(values, like: torch.Tensor) -> torch.Tensor:
    """Concatenated host limb vectors -> a (K, 1, ..., 1) int64 column on
    ``like``'s device, broadcastable against (K, *batch)."""
    t = torch.as_tensor(np.concatenate(values).astype(np.int64), device=like.device)
    return t.reshape(t.shape + (1,) * (like.ndim - 1))


def _fq_const_mul(fq, X, value: int):
    """X * const, const a standard-domain host int (broadcast batch mul)."""
    return mont.mont_mul(fq, X, _limbs_col([int_to_limbs(fq.to_mont_int(value), fq.n_limbs)], X))


def _scalar_batch(k: int, n_limbs: int, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as (n_limbs, *batch) standard-domain limbs."""
    return _limbs_col([int_to_limbs(k, n_limbs)], like).expand((n_limbs,) + tuple(like.shape[1:]))


def g1_in_group(curve: CurveSpec, z: int, P: Tuple[torch.Tensor, torch.Tensor]):
    """Batched BLS12 G1 subgroup check on affine Montgomery points
    (ref g1m_inGroupAffine, build_bls12381.js:1494-1556).

    Returns a boolean (N,) mask.  (0,0) = identity -> True; off-curve ->
    False.
    """
    fq = curve.fq
    X, Y = P
    beta, beta2 = _cube_roots_for_g1_check(
        curve.q, curve.r, curve.gx, curve.gy, curve.b, abs(z)
    )
    sp = group.from_affine(curve, (_fq_const_mul(fq, X, beta), Y))
    s2p = group.from_affine(curve, (_fq_const_mul(fq, X, beta2), Y))
    t = group.double(curve, sp)
    t = group.sub(curve, t, group.from_affine(curve, (X, Y)))
    t = group.sub(curve, t, s2p)
    zc = (abs(z) ** 2 - 1) // 3
    t = group.times_scalar(curve, t, _scalar_batch(zc, (zc.bit_length() + 15) // 16, X))
    ok = group.eq(curve, t, s2p)
    is_id = group.is_zero_affine(curve, (X, Y))
    on_curve = group.in_curve(curve, group.from_affine(curve, (X, Y)))
    return (ok & on_curve) | is_id


def _f2_const_mul(F2, A, c0: int, c1: int):
    """Fq2 batch times the Fq2 host constant c0 + c1*u."""
    fq = F2.spec
    L = fq.n_limbs
    const = _limbs_col(
        [int_to_limbs(fq.to_mont_int(c0), L), int_to_limbs(fq.to_mont_int(c1), L)], A
    )
    return F2.mul(A, const)


def g2_in_group(curve: CurveSpec, z: int, P: Tuple[torch.Tensor, torch.Tensor]):
    """Batched BLS12-381 G2 subgroup check on affine Montgomery points
    (ref g2m_inGroupAffine, build_bls12381.js:1376-1473).

    Computes psi^2(P) and psi^3(P) via the reference's constant dance and
    accepts iff [z]*psi^3(P) + psi^2(P) == P.  Returns (N,) bool.
    """
    fq = curve.fq
    F2 = curve.field
    L = fq.n_limbs
    X, Y = P

    xw = _f2_const_mul(F2, X, *_WINV)
    yw = _f2_const_mul(F2, Y, *_WINV)

    # f2 = psi^2(P'): x *= FROB2X (an Fq scalar), y = -y; then both get the
    # (c0,c1) -> (c0-c1, c0+c1) shuffle (multiplication by (1+u))
    xr = _fq_const_mul(fq, _st(xw[:L], xw[L:]), _FROB2X)  # both components, one product
    f2x = torch.cat([xr[:, 0], xr[:, 1]])
    f2y = F2.neg(yw)
    # f3 = psi^3(P'): x = -x_winv, y = y_winv * FROB3Y
    f3x = F2.neg(xw)
    f3y = _f2_const_mul(F2, yw, *_FROB3Y)

    def shuffle_sub_add(a):  # (c0, c1) -> (c0 - c1, c0 + c1)
        return torch.cat([mont.sub(fq, a[:L], a[L:]), mont.add(fq, a[:L], a[L:])])

    def shuffle_add_sub(a):  # (c0, c1) -> (c0 + c1, c0 - c1)
        return torch.cat([mont.add(fq, a[:L], a[L:]), mont.sub(fq, a[:L], a[L:])])

    def shuffle_y3(a):  # (c0, c1) -> (c1 - c0, c0 + c1)  (ref :1460-1463)
        return torch.cat([mont.sub(fq, a[L:], a[:L]), mont.add(fq, a[:L], a[L:])])

    f2x = shuffle_sub_add(f2x)
    f2y = shuffle_sub_add(f2y)
    f3x = shuffle_add_sub(f3x)
    f3y = shuffle_y3(f3y)

    f3 = group.from_affine(curve, (f3x, f3y))
    f3 = group.times_scalar(curve, f3, _scalar_batch(abs(z), 4, X))
    f3 = group.add_mixed(curve, f3, (f2x, f2y))
    ok = group.eq(curve, f3, group.from_affine(curve, (X, Y)))
    is_id = group.is_zero_affine(curve, (X, Y))
    on_curve = group.in_curve(curve, group.from_affine(curve, (X, Y)))
    return (ok & on_curve) | is_id
