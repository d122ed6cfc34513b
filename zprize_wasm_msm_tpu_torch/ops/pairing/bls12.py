"""Optimal-ate pairing for BLS12 curves, batched over (P, Q) pairs.

Port of zprize_wasm_msm_tpu/ops/pairing/bls12.py, the counterpart of the
reference's pairing (wasmcurves/src/bls12381/build_bls12381.js —
prepareG1:321, prepDblStep:335, prepAddStep:448, prepareG2:576, ell:789,
millerLoop:841, finalExponentiation:1181, cyclotomicSquare:1008; ate loop
constant x = -0xd201000000010000 at :254-256, finalExpZ at :267).

Structure:
  prepareG2 + millerLoop   -> ONE Python loop over the interior bits of |x|
                              carrying (R, f): each step runs the Jacobian
                              doubling step, the line evaluation (sparse
                              f12 mul014), the addition step and its line,
                              a branch-free select of the added state where
                              the bit is 1, and the f^2 — the reference's
                              coefficient stream, fused so no coefficient
                              array is materialized and the whole pair batch
                              advances per step.
  finalExponentiation      -> easy part exactly as the reference
                              (conjugate, one f12 inverse, frobenius^2), hard
                              part the reference's chain of cyclotomic
                              exponentiations by |x|.

The exponents of the final exponentiation are host constants: the
exponentiations skip the product where a digit is 0 (the JAX package runs
both branches and selects; the values are the same).  No batch padding:
the JAX package pads the pair batch only to reuse one compiled executable.

All values Montgomery; G1 points are affine (L, N) pairs, G2 points affine
(2L, N) pairs, pairing results (12L, N).  Plain PyTorch: every op is a
batch of launches on the tensors' device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import torch

from ..curve.spec import CurveSpec
from ..field import mont
from ..field.tower import Fq2
from .tower import Tower, _st

#: BLS parameter; the ate loop count is |x| and x < 0 for BLS12-381
BLS12_381_X = -0xD201000000010000


@dataclass(frozen=True)
class PairingSpec:
    g1: CurveSpec
    g2: CurveSpec
    x: int  # signed BLS parameter

    @cached_property
    def tower(self) -> Tower:
        return Tower(self.g1.fq)

    @cached_property
    def loop_bits(self) -> Tuple[int, ...]:
        """LSB-first bits of |x| (ref `bits()` at build_bls12381.js:300)."""
        n = abs(self.x)
        return tuple((n >> i) & 1 for i in range(n.bit_length()))


def _dbl_step(F2: Fq2, R):
    """Jacobian doubling + line coefficients (ref prepDblStep:335).

    R = (Rx, Ry, Rz) over Fq2.  Returns (R', (coef_a, coef_b, coef_c))
    with ell consuming c4 = coef_a * P.y, c1 = coef_b * P.x, c0 = coef_c.
    Independent Fq2 ops of one round run as one stacked call.
    """
    Rx, Ry, Rz = R
    s_zy = F2.add(Rz, Ry)
    t0, t1, zsq, sq_zy = F2.square(_st(Rx, Ry, Rz, s_zy)).unbind(1)
    t1x, t0_2 = F2.add(_st(t1, t0), _st(Rx, t0)).unbind(1)
    t4 = F2.add(t0_2, t0)  # 3 t0
    t6 = F2.add(Rx, t4)
    t2, sq_t1x, t5, sq_t6 = F2.square(_st(t1, t1x, t4, t6)).unbind(1)
    # (t1 + Rx)^2 - t0 - t2, (Rz + Ry)^2 - t1 - zsq, t6^2 - t0 - t5
    d = F2.sub(_st(sq_t1x, sq_zy, sq_t6), _st(t0, t1, t0))
    t3h, nRz, t6 = F2.sub(d, _st(t2, zsq, t5)).unbind(1)
    t3, t1_2, t2_2 = F2.add(_st(t3h, t1, t2), _st(t3h, t1, t2)).unbind(1)
    t3_2, t1_4, t2_4 = F2.add(_st(t3, t1_2, t2_2), _st(t3, t1_2, t2_2)).unbind(1)
    nRx = F2.sub(t5, t3_2)
    t3x, coef_c = F2.sub(_st(t3, t6), _st(nRx, t1_4)).unbind(1)
    nRy_p, tzs, nzs = F2.mul(_st(t3x, t4, nRz), _st(t4, zsq, zsq)).unbind(1)
    t2_8, tzs_2, coef_a = F2.add(_st(t2_4, tzs, nzs), _st(t2_4, tzs, nzs)).unbind(1)
    nRy = F2.sub(nRy_p, t2_8)
    coef_b = F2.neg(tzs_2)
    return (nRx, nRy, nRz), (coef_a, coef_b, coef_c)


def _add_step(F2: Fq2, R, Q):
    """Jacobian mixed addition + line coefficients (ref prepAddStep:448).
    Independent Fq2 ops of one round run as one stacked call."""
    Rx, Ry, Rz = R
    Qx, Qy = Q
    s_qz = F2.add(Qy, Rz)
    zsq, ysq, sq_qz = F2.square(_st(Rz, Qy, s_qz)).unbind(1)
    u = F2.sub(F2.sub(sq_qz, ysq), zsq)
    t0, t1 = F2.mul(_st(zsq, u), _st(Qx, zsq)).unbind(1)
    t2, t6a = F2.sub(_st(t0, t1), _st(Rx, Ry)).unbind(1)
    t6 = F2.sub(t6a, Ry)
    s_zt2 = F2.add(Rz, t2)
    t3, t9, sq_t6, sq_zt2 = F2.mul(_st(t2, t6, t6, s_zt2), _st(t2, Qx, t6, s_zt2)).unbind(1)
    t4 = F2.add(t3, t3)
    t4 = F2.add(t4, t4)
    t5, t7 = F2.mul(_st(t4, t4), _st(t2, Rx)).unbind(1)
    # sq(t6) - t5 - t7 - t7 and sq(Rz + t2) - zsq - t3
    d = F2.sub(F2.sub(_st(sq_t6, sq_zt2), _st(t5, zsq)), _st(t7, t3))
    nRx = F2.sub(d[:, 0], t7)
    nRz = d[:, 1]
    t10 = F2.add(Qy, nRz)
    t7mx = F2.sub(t7, nRx)
    t8, t0b, sq_t10, sq_nrz = F2.mul(_st(t7mx, Ry, t10, nRz), _st(t6, t5, t10, nRz)).unbind(1)
    t0b_2, t9_2, coef_a, t6_2 = F2.add(_st(t0b, t9, nRz, t6), _st(t0b, t9, nRz, t6)).unbind(1)
    nRy, t10 = F2.sub(_st(t8, sq_t10), _st(t0b_2, ysq)).unbind(1)
    t10 = F2.sub(t10, sq_nrz)
    t9 = F2.sub(t9_2, t10)
    coef_b = F2.neg(t6_2)  # (-t6) + (-t6): t1 in the reference
    coef_c = t9
    return (nRx, nRy, nRz), (coef_a, coef_b, coef_c)


def _ell(tw: Tower, f, coefs, Px, Py):
    """Line evaluation folded into f (ref ell:789)."""
    coef_a, coef_b, coef_c = coefs
    # c4 = coef_a * P.y, c1 = coef_b * P.x: one base product
    c4, c1 = tw.f2_scale_fq(_st(coef_a, coef_b), _st(Py, Px)).unbind(1)
    return tw.f12_mul014(f, coef_c, c1, c4)


def _infinity_pairs(tw: Tower, P, Q):
    """Pairs with P or Q at the affine identity (0, 0) (their f is 1)."""
    F2 = tw.f2
    Px, Py = P
    Qx, Qy = Q
    return (mont.is_zero(tw.spec, Px) & mont.is_zero(tw.spec, Py)) | (F2.is_zero(Qx) & F2.is_zero(Qy))


def miller_loop(ps: PairingSpec, P, Q):
    """Batched Miller loop: P affine G1 (L, N) x2; Q affine G2 (2L, N) x2.

    Returns f in Fq12, (12L, N).  Pairs with P or Q at infinity yield 1."""
    tw = ps.tower
    F2 = tw.f2
    Px, Py = P
    Qx, Qy = Q
    batch, dev = Px.shape[1:], Px.device
    bits = ps.loop_bits  # LSB-first; bits[-1] == 1

    R = (Qx, Qy, F2.one(batch, dev))
    f = tw.f12_one(batch, dev)
    for i in range(len(bits) - 2, 0, -1):
        R, dcoef = _dbl_step(F2, R)
        f = _ell(tw, f, dcoef, Px, Py)
        Ra, acoef = _add_step(F2, R, (Qx, Qy))
        fa = _ell(tw, f, acoef, Px, Py)
        # branch-free, as in the reference's scan body: both states are
        # computed and the bit selects one
        do_add = torch.full(tuple(batch), bits[i] == 1, dtype=torch.bool, device=dev)
        R = tuple(F2.select(do_add, a, b) for a, b in zip(Ra, R))
        f = torch.where(do_add[None], fa, f)
        f = tw.f12_square(f)
    R, dcoef = _dbl_step(F2, R)
    f = _ell(tw, f, dcoef, Px, Py)
    if ps.x < 0:  # ref isLoopNegative (build_bls12381.js:257)
        f = tw.f12_conjugate(f)
    return torch.where(_infinity_pairs(tw, P, Q)[None], tw.f12_one(batch, dev), f)


@functools.lru_cache(maxsize=None)
def _hard_exp_bits(q: int, r: int) -> Tuple[int, ...]:
    """MSB-first bits of the hard-part exponent (q^4 - q^2 + 1) / r."""
    e, rem = divmod(q**4 - q**2 + 1, r)
    assert rem == 0, "r must divide the 12th cyclotomic polynomial at q"
    n = e.bit_length()
    return tuple((e >> (n - 1 - i)) & 1 for i in range(n))


@functools.lru_cache(maxsize=None)
def _naf_digits_msb(n: int) -> Tuple[int, ...]:
    """Non-adjacent form of n > 0, MSB-first (ref naf() helper used by
    buildCyclotomicExp, build_bls12381.js:1117)."""
    digs = []
    while n:
        if n & 1:
            d = 2 - (n % 4)  # 1 or -1
            digs.append(d)
            n -= d
        else:
            digs.append(0)
        n >>= 1
    return tuple(reversed(digs))


def _cyclotomic_exp(tw: Tower, f, e_abs: int, negative: bool):
    """f^(±e_abs) for f in the cyclotomic subgroup: NAF square-and-multiply
    with Granger-Scott squarings; inversion is conjugation there
    (ref __cyclotomicExp_w0, build_bls12381.js:1117-1178).  The digits are
    host constants: a product by f (digit 1) or its conjugate (digit -1)
    only where the digit is not 0."""
    digs = _naf_digits_msb(e_abs)
    assert digs[0] == 1
    inv = tw.f12_conjugate(f)
    res = f
    for d in digs[1:]:
        res = tw.f12_cyclotomic_square(res)
        if d == 1:
            res = tw.f12_mul(res, f)
        elif d == -1:
            res = tw.f12_mul(res, inv)
    return tw.f12_conjugate(res) if negative else res


def _frob_k(tw: Tower, a, k: int):
    for _ in range(k):
        a = tw.f12_frobenius(a)
    return a


def _fe_easy(tw: Tower, f):
    """Easy part: f^((q^6-1)(q^2+1))."""
    t2 = tw.f12_mul(tw.f12_conjugate(f), tw.f12_inverse(f))
    return tw.f12_mul(_frob_k(tw, t2, 2), t2)


def final_exponentiation(ps: PairingSpec, f):
    """f^((q^12 - 1) / r) (ref finalExponentiation:1181-1290).

    Easy part: f^(q^6-1) = conj(f) * f^-1, then ^(q^2+1) via frobenius^2.
    Hard part: the reference's zkcrypto-style addition chain — four
    cyclotomic exponentiations by the BLS parameter w0 = |x| plus
    frobenius powers — ~260 cyclotomic squarings instead of ~1505 generic
    square-and-multiply steps (build_bls12381.js:1183-1290, w0 at :267).
    """
    tw = ps.tower
    mul, conj = tw.f12_mul, tw.f12_conjugate

    def cyc_exp(a):  # a^|x|, conjugated for x < 0
        return _cyclotomic_exp(tw, a, abs(ps.x), ps.x < 0)

    t2 = _fe_easy(tw, f)
    # hard part (formula sequence of build_bls12381.js:1229-1289)
    t1 = conj(tw.f12_cyclotomic_square(t2))
    t3 = cyc_exp(t2)
    t4 = tw.f12_cyclotomic_square(t3)
    t5 = mul(t1, t3)
    t1 = cyc_exp(t5)
    t0 = cyc_exp(t1)
    t6 = cyc_exp(t0)
    t6 = mul(t6, t4)
    t4 = cyc_exp(t6)
    t5 = conj(t5)
    t4 = mul(mul(t4, t5), t2)
    t5 = conj(t2)
    t1 = mul(t1, t2)
    t6 = mul(t6, t5)
    t3 = mul(t3, t0)
    t1 = _frob_k(tw, t1, 3)
    t6 = _frob_k(tw, t6, 1)
    t3 = mul(_frob_k(tw, t3, 2), t1)
    t3 = mul(t3, t6)
    return mul(t3, t4)


def final_exponentiation_plain(ps: PairingSpec, f):
    """Reference-free oracle: plain square-and-multiply by the hard
    exponent (q^4 - q^2 + 1)/r after the same easy part.  The differential
    check of the fast chain (and the general-curve fallback; the w0 chain
    is BLS-family-specific).  The exponent is a host constant: the product
    only where a bit is 1."""
    tw = ps.tower
    t = _fe_easy(tw, f)
    acc = t
    for bit in _hard_exp_bits(ps.g1.q, ps.g1.r)[1:]:
        acc = tw.f12_square(acc)
        if bit:
            acc = tw.f12_mul(acc, t)
    return acc


def pairing(ps: PairingSpec, P, Q):
    """e(P, Q) batched (ref pairing:1597)."""
    return final_exponentiation(ps, miller_loop(ps, P, Q))


def _f12_product_tree(ps: PairingSpec, f):
    """Log-depth product over the pair axis: (12L, N) -> (12L, 1)."""
    tw = ps.tower
    n = f.shape[1]
    while n > 1:
        half = n // 2
        prod = tw.f12_mul(f[:, :half], f[:, half : 2 * half])
        f = torch.cat([prod, f[:, -1:]], dim=1) if n % 2 else prod
        n = half + (n % 2)
    return f


def pairing_eq(ps: PairingSpec, Ps, Qs):
    """prod_i e(P_i, Q_i) == 1 (the ref's pairingEq1-5:1592-1596).

    Ps/Qs are batches; the Miller loops run batched, the product is folded
    log-depth, and ONE final exponentiation finishes.  Returns a 0-dim bool
    tensor on the inputs' device (no host synchronisation here).
    """
    tw = ps.tower
    f = _f12_product_tree(ps, miller_loop(ps, Ps, Qs))
    e = final_exponentiation(ps, f)
    return (e == tw.f12_one((1,), e.device)).all()


_bls12_381_spec = None


def get_bls12_381_spec() -> PairingSpec:
    global _bls12_381_spec
    if _bls12_381_spec is None:
        from ...models.curves import bls12_381, bls12_381_g2

        _bls12_381_spec = PairingSpec(g1=bls12_381, g2=bls12_381_g2, x=BLS12_381_X)
    return _bls12_381_spec
