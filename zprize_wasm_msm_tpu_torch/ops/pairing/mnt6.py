"""Ate pairing for MNT6-753, batched over (P, Q) pairs.

Port of zprize_wasm_msm_tpu/ops/pairing/mnt6.py, the counterpart of
wasmcurves/src/mnt6753/build_mnt6753.js:
  prepareG1 (:300)            -> P embedded into Fq3 via the twist
                                 (PX_twist = PX*v, PY_twist = PY*v)
  prepareG2 + millerLoop
  (:361, :678)                -> ONE Python loop over the bits of the ate
                                 loop count carrying (R, f): Jacobian-
                                 with-T doubling (prepDblStep:567) and
                                 mixed addition (prepAddStep:450) with
                                 fused line evaluation into Fq6; the add
                                 step is computed on every bit and selected
                                 branch-free, as in the reference's scan
  finalExponentiation (:1272) -> easy part (FirstChunk:1248,
                                 t^((q^3-1)(q+1))) then hard part
                                 (LastChunk:1224): frob1(beta) * beta^w0
                                 with the NAF cyclotomic exponentiation
                                 (cyclotomicSquare:1052, w0 = the ate
                                 loop count, :1225)

Tower: Fq6 = Fq3[w]/(w^2 - v) over Fq3 = Fq[v]/(v^3 - 11)
(ftm = buildF2m over f3m with mulNR6 = multiply-by-v, :58-88).
Element layout: flat (6L, *batch) = [c00 c01 c02 | c10 c11 c12]
(w-coefficient second), the JAX package's.

All values Montgomery; G1 points affine (L, N), G2 affine (3L, N).  Plain
PyTorch: every op is a batch of launches on the tensors' device, so the
independent products of a step run as one stacked product (the JAX
package's formulas, their rounds of independent operations batched; the
values are the same).  The exponentiation's digits are host constants: a
product only where a digit is not 0.  No batch padding (the JAX package
pads only to reuse one compiled executable).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import torch

from ..curve.spec import CurveSpec
from ..field import mont
from ..field.tower import Fq2, Fq3, stack_elems

_st = stack_elems

#: the MNT6-753 ate loop count == final-exp hard-part w0
#: (ref ateLoopCount:262 == MNT6753_final_exponent_last_chunk_abs_of_w0:1225)
MNT6753_ATE_LOOP = 204691208819330962009469868104636132783269696790011977400223898462431810102935615891307667367766898917669754470400


@dataclass(frozen=True)
class MNT6PairingSpec:
    g1: CurveSpec
    g2: CurveSpec
    loop_count: int = MNT6753_ATE_LOOP

    @cached_property
    def f3(self) -> Fq3:
        return Fq3(self.g1.fq, 11)

    @cached_property
    def f2(self) -> Fq2:
        """Fq2 with the SAME non-residue 11 (only used by the cyclotomic
        squaring's Fq4-style sub-squares, ref f2m built over mulNR3 :54)."""
        return Fq2(self.g1.fq, 11)

    @cached_property
    def loop_bits(self) -> Tuple[int, ...]:
        n = self.loop_count
        return tuple((n >> i) & 1 for i in range(n.bit_length()))

    @cached_property
    def frob_gammas(self):
        """gamma(i, n) = 11^(widx*(q^n-1)/6 + vidx*(q^n-1)/3) mod q for
        component i = 3*widx + vidx — the host derivation of the F6/F3
        coefficient tables (ref buildFrobeniusMap:989-1027)."""
        q = self.g1.q
        out = {}
        for n in range(1, 4):
            qn = q**n
            e6 = (qn - 1) // 6
            e3 = (qn - 1) // 3
            coefs = []
            for i in range(6):
                widx, vidx = divmod(i, 3)
                coefs.append(pow(11, widx * e6 + vidx * e3, q))
            out[n] = tuple(coefs)
        return out


# ---------------------------------------------------------------------------
# Fq6 = Fq3[w]/(w^2 - v) arithmetic on flat (6L, *batch) values
# ---------------------------------------------------------------------------


def _split6(ps, a):
    k = 3 * ps.g1.fq.n_limbs
    return a[:k], a[k:]


def f6_one(ps, batch, device=None):
    F3 = ps.f3
    return torch.cat([F3.one(batch, device), F3.zeros(batch, device)])


def _mul_v(ps, x):
    """v * (x0 + x1 v + x2 v^2) = 11 x2 + x0 v + x1 v^2."""
    F3 = ps.f3
    L = ps.g1.fq.n_limbs
    return torch.cat([F3._mul_nr(x[2 * L :]), x[:L], x[L : 2 * L]])


def f6_mul(ps, a, b):
    """Karatsuba over Fq3; w^2 = v so the cross term shifts by v
    (ref ftm mul = build_f2m.js mul with mulNR6 = multiply-by-v)."""
    F3 = ps.f3
    a0, a1 = _split6(ps, a)
    b0, b1 = _split6(ps, b)
    sa, sb = F3.add(_st(a0, b0), _st(a1, b1)).unbind(1)
    t0, t1, m = F3.mul_many([(a0, b0), (a1, b1), (sa, sb)])
    # c0 = t0 + v t1, c1 = m - (t0 + t1)
    c0, s01 = F3.add(_st(t0, t0), _st(_mul_v(ps, t1), t1)).unbind(1)
    return torch.cat([c0, F3.sub(m, s01)])


def f6_square(ps, a):
    return f6_mul(ps, a, a)


def f6_conjugate(ps, a):
    F3 = ps.f3
    a0, a1 = _split6(ps, a)
    return torch.cat([a0, F3.neg(a1)])


def f6_inverse(ps, a):
    """(a0 - a1 w) / (a0^2 - v a1^2): one Fq3 inversion (Fq3.inverse: one
    launch of the field inversion kernel on the card)."""
    F3 = ps.f3
    a0, a1 = _split6(ps, a)
    sq0, sq1 = F3.mul_many([(a0, a0), (a1, a1)])
    tinv = F3.inverse(F3.sub(sq0, _mul_v(ps, sq1)))
    r0, r1 = F3.mul_many([(a0, tinv), (a1, tinv)])
    return torch.cat([r0, F3.neg(r1)])


@functools.lru_cache(maxsize=None)
def _frob_consts(ps, n: int, device: torch.device) -> torch.Tensor:
    """(L, 6) Montgomery limbs of gamma(i, n), i = 0..5."""
    s = ps.g1.fq
    return torch.stack(
        [mont._int_const(s, s.to_mont_int(g), device) for g in ps.frob_gammas[n]], dim=1
    )


def f6_frobenius(ps, a, n: int):
    """a^(q^n): componentwise Fq scalar multiply by gamma(i, n)
    (ref __frobeniusMap1/2/3, buildFrobeniusMap:989): the six components
    in one product (gamma = 1 multiplies by R mod q, the identity)."""
    s = ps.g1.fq
    L = s.n_limbs
    comps = a.reshape((6, L) + tuple(a.shape[1:])).transpose(0, 1)  # (L, 6, *batch)
    g = _frob_consts(ps, n, a.device).reshape((L, 6) + (1,) * (a.ndim - 1))
    return mont.mont_mul(s, comps, g).transpose(0, 1).reshape(a.shape)


def f6_cyclotomic_square(ps, a):
    """Granger-Scott squaring in the degree-6 cyclotomic subgroup via the
    three Fq2(nr=11) sub-squares (ref __cyclotomicSquare:1052-1149):
      A = (c00, c11), B = (c10, c02), C = (c01, c12);
      r00 = 3 ASQ0 - 2 A0      r04 = 3 ASQ1 + 2 A1
      r03 = 3*11 CSQ1 + 2 B0   r02 = 3 CSQ0 - 2 B1
      r01 = 3 BSQ0 - 2 C0      r05 = 3 BSQ1 + 2 C1
    The three sub-squares are one Fq2 square; the six results one stacked
    difference or sum, a doubling and a sum."""
    s = ps.g1.fq
    L = s.n_limbs
    c = [a[i * L : (i + 1) * L] for i in range(6)]
    SQ = ps.f2.square(_st(torch.cat([c[0], c[4]]), torch.cat([c[3], c[2]]), torch.cat([c[1], c[5]])))
    asq, bsq, csq = SQ.unbind(1)
    asq0, asq1 = asq[:L], asq[L:]
    bsq0, bsq1 = bsq[:L], bsq[L:]
    csq0, csq1 = csq[:L], csq[L:]
    nr_csq1 = ps.f3._mul_nr(csq1)
    # 3x - 2y for r0, r2, r1 and 3x + 2y for r4, r3, r5: (x -+ y) doubled plus x
    x = _st(asq0, csq0, bsq0, asq1, nr_csq1, bsq1)
    t = torch.cat(
        [
            mont.sub(s, _st(asq0, csq0, bsq0), _st(c[0], c[2], c[1])),
            mont.add(s, _st(asq1, nr_csq1, bsq1), _st(c[4], c[3], c[5])),
        ],
        dim=1,
    )
    r0, r2, r1, r4, r3, r5 = mont.add(s, mont.add(s, t, t), x).unbind(1)
    return torch.cat([r0, r1, r2, r3, r4, r5])


@functools.lru_cache(maxsize=None)
def _naf_digits_msb(n: int) -> Tuple[int, ...]:
    digs = []
    while n:
        if n & 1:
            d = 2 - (n % 4)
            digs.append(d)
            n -= d
        else:
            digs.append(0)
        n >>= 1
    return tuple(reversed(digs))


def f6_cyclotomic_exp(ps, f, e_abs: int):
    """f^e_abs by NAF square-and-multiply with cyclotomic squarings;
    inversion is conjugation (ref __cyclotomicExp_w0:1150-1223).  The
    digits are host constants: a product by f (digit 1) or its conjugate
    (digit -1) only where the digit is not 0."""
    digs = _naf_digits_msb(e_abs)
    assert digs[0] == 1
    inv = f6_conjugate(ps, f)
    res = f
    for d in digs[1:]:
        res = f6_cyclotomic_square(ps, res)
        if d == 1:
            res = f6_mul(ps, res, f)
        elif d == -1:
            res = f6_mul(ps, res, inv)
    return res


# ---------------------------------------------------------------------------
# Miller loop (Jacobian-with-T steps, ref prepDblStep:567 / prepAddStep:450)
# ---------------------------------------------------------------------------


def _dbl_step(ps, R):
    """The reference's doubling step and its line coefficients
    (H, 4C, J, L), its products in four rounds of independent products."""
    F3 = ps.f3
    X1, Y1, Z1, T1 = R
    a2 = F3.const(ps.g2.a, (1,) * (X1.ndim - 1), X1.device)  # (0, 0, 11) = 11 v^2 (TwistCoefA:546)

    s_yz = F3.add(Y1, Z1)
    A, B, C, sq_yz, zsq = F3.mul_many([(T1, T1), (X1, X1), (Y1, Y1), (s_yz, s_yz), (Z1, Z1)])
    s_xc, zc = F3.add(_st(X1, zsq), _st(C, C)).unbind(1)
    D, sq_xc, aA = F3.mul_many([(C, C), (s_xc, s_xc), (a2, A)])
    # E = (X1 + C)^2 - B - D; F = 3B + a2 A (B - (-B) - (-B));
    # nZ = (Y1 + Z1)^2 - (Z1^2 + C)
    neg_b = F3.neg(B)
    e_b, b2, nZ = F3.sub(_st(sq_xc, B, sq_yz), _st(B, neg_b, zc)).unbind(1)
    E, B3 = F3.sub(_st(e_b, b2), _st(D, neg_b)).unbind(1)
    F_ = F3.add(B3, aA)
    s_zt, s_ft, s_fx = F3.add(_st(nZ, F_, F_), _st(T1, T1, X1)).unbind(1)
    G, nT, sq_zt, sq_ft, sq_fx = F3.mul_many(
        [(F_, F_), (nZ, nZ), (s_zt, s_zt), (s_ft, s_ft), (s_fx, s_fx)]
    )
    E2, D2, C2 = F3.add(_st(E, D, C), _st(E, D, C)).unbind(1)
    E4, D4, fourC = F3.add(_st(E2, D2, C2), _st(E2, D2, C2)).unbind(1)
    nX, h_, j_, l_ = F3.sub(_st(G, sq_zt, sq_ft, sq_fx), _st(E4, nT, G, G)).unbind(1)
    H, J, Lc = F3.sub(_st(h_, j_, l_), _st(A, A, B)).unbind(1)
    (nY,) = F3.mul_many([(F3.sub(E2, nX), F_)])
    nY = F3.sub(nY, F3.add(D4, D4))
    return (nX, nY, nZ, nT), (H, fourC, J, Lc)


def _add_step(ps, R, QX, QY, QY2):
    """The reference's mixed addition step and its line coefficients
    (L1, nZ), its products in four rounds of independent products."""
    F3 = ps.f3
    X1, Y1, Z1, T1 = R
    s_qz = F3.add(QY, Z1)
    B, sq_qz = F3.mul_many([(QX, T1), (s_qz, s_qz)])
    d_, H = F3.sub(_st(sq_qz, B), _st(QY2, X1)).unbind(1)
    d_ = F3.sub(d_, T1)
    s_zh = F3.add(Z1, H)
    Dm, I, sq_zh = F3.mul_many([(d_, T1), (H, H), (s_zh, s_zh)])
    I2, Y2, tI = F3.add(_st(I, Y1, T1), _st(I, Y1, I)).unbind(1)
    E = F3.add(I2, I2)
    L1, nZ = F3.sub(_st(Dm, sq_zh), _st(Y2, tI)).unbind(1)
    J, V, nT, sq_l1 = F3.mul_many([(H, E), (X1, E), (nZ, nZ), (L1, L1)])
    nX = F3.sub(sq_l1, F3.add(F3.add(V, V), J))
    m1, m2 = F3.mul_many([(L1, F3.sub(V, nX)), (Y2, J)])
    return (nX, F3.sub(m1, m2), nZ, nT), (L1, nZ)


def miller_loop(ps, P, Q):
    """Batched MNT6 ate Miller loop (ref millerLoop:678-787).

    P affine G1 (L, N) x2; Q affine G2 (3L, N) x2 over Fq3.  Returns f in
    Fq6, (6L, N).  Pairs with P or Q at infinity yield 1."""
    F3 = ps.f3
    s = ps.g1.fq
    Px, Py = P
    Qx, Qy = Q
    batch, dev = Px.shape[1:], Px.device

    zero1 = mont.zeros(s, batch, dev)
    # P twisted into Fq3: PX_twist = PX * v = (0, PX, 0) (prepareG1:326-331)
    PXt = torch.cat([zero1, Px, zero1])
    PYt = torch.cat([zero1, Py, zero1])
    # twist = v; twist^-1 precomputed host-side: v^-1 = v^2 / 11
    inv11 = pow(11, -1, ps.g1.q)
    twist_inv = F3.const((0, 0, inv11), (1,) * len(batch), dev)
    QXot, QYot, QY2 = F3.mul_many([(Qx, twist_inv), (Qy, twist_inv), (Qy, Qy)])
    # L1Coef = (PX, 0, 0) - QX_over_twist  (millerLoop:719-723)
    L1Coef = F3.sub(torch.cat([Px, zero1, zero1]), QXot)

    R = (Qx, Qy, F3.one(batch, dev), F3.one(batch, dev))
    f = f6_one(ps, batch, dev)
    bits = ps.loop_bits  # LSB-first; bits[-1] == 1
    for i in range(len(bits) - 2, -1, -1):
        R, (H, fourC, J, Lc) = _dbl_step(ps, R)
        jp, ev1 = F3.mul_many([(J, PXt), (H, PYt)])
        ev0 = F3.sub(F3.sub(Lc, jp), fourC)
        f = f6_mul(ps, f6_square(ps, f), torch.cat([ev0, ev1]))
        Ra, (L1, RZ) = _add_step(ps, R, Qx, Qy, QY2)
        ev0a, rq, ll = F3.mul_many([(RZ, PYt), (RZ, QYot), (L1Coef, L1)])
        fa = f6_mul(ps, f, torch.cat([ev0a, F3.neg(F3.add(rq, ll))]))
        # branch-free, as in the reference's scan body: both states are
        # computed and the bit selects one
        do_add = torch.full(tuple(batch), bits[i] == 1, dtype=torch.bool, device=dev)
        R = tuple(F3.select(do_add, a, b) for a, b in zip(Ra, R))
        f = torch.where(do_add[None], fa, f)

    inf = (mont.is_zero(s, Px) & mont.is_zero(s, Py)) | (F3.is_zero(Qx) & F3.is_zero(Qy))
    return torch.where(inf[None], f6_one(ps, batch, dev), f)


def _fe_easy(ps, f):
    """Easy part (FirstChunk:1248): t = frob3(f) * f^-1;
    beta = frob1(t) * t."""
    t = f6_mul(ps, f6_frobenius(ps, f, 3), f6_inverse(ps, f))
    return f6_mul(ps, f6_frobenius(ps, t, 1), t)


def final_exponentiation(ps, f):
    """f^((q^6-1)/r) (ref finalExponentiation:1272).

    Easy part (FirstChunk:1248): t = frob3(f) * f^-1; beta = frob1(t) * t.
    Hard part (LastChunk:1224): frob1(beta) * beta^w0."""
    beta = _fe_easy(ps, f)
    return f6_mul(ps, f6_frobenius(ps, beta, 1), f6_cyclotomic_exp(ps, beta, ps.loop_count))


def pairing(ps, P, Q):
    """e(P, Q) batched (ref buildPairing:1345)."""
    return final_exponentiation(ps, miller_loop(ps, P, Q))


def _f6_product_tree(ps, f):
    """Log-depth product over the pair axis: (6L, N) -> (6L, 1)."""
    n = f.shape[1]
    while n > 1:
        half = n // 2
        prod = f6_mul(ps, f[:, :half], f[:, half : 2 * half])
        f = torch.cat([prod, f[:, -1:]], dim=1) if n % 2 else prod
        n = half + (n % 2)
    return f


def pairing_eq(ps, Ps, Qs):
    """prod_i e(P_i, Q_i) == 1 (ref pairingEq1-3:1312): the Miller loops
    batched, the product folded log-depth, ONE final exponentiation.
    Returns a 0-dim bool tensor on the inputs' device."""
    f = _f6_product_tree(ps, miller_loop(ps, Ps, Qs))
    e = final_exponentiation(ps, f)
    return (e == f6_one(ps, (1,), e.device)).all()


_mnt6_spec = None


def get_mnt6753_spec() -> MNT6PairingSpec:
    global _mnt6_spec
    if _mnt6_spec is None:
        from ...models.curves import mnt6753, mnt6753_g2

        _mnt6_spec = MNT6PairingSpec(g1=mnt6753, g2=mnt6753_g2)
    return _mnt6_spec
