"""Optimal-ate pairing for BN curves (the reference's bn128), batched.

Port of zprize_wasm_msm_tpu/ops/pairing/bn.py, the counterpart of
wasmcurves/src/bn128/build_bn128.js:
  prepareG2 + millerLoop  (:550, :806) -> one Python loop over the bits of
      the ate loop count 6z+2, carrying (R, f); homogeneous-projective
      doubling/addition steps with fused line evaluation (prepDblStep:417,
      prepAddStep:331) folded via the sparse f12_mul024 (:663), a
      branch-free select of the added state, then the two
      Frobenius-twisted add steps with Q1 = pi(Q), Q2 = -pi^2(Q)
      (mulByQ:515, prepareG2 tail :604-621).
  finalExponentiation (:1290) -> easy part (FirstChunk:994) + the BN
      hard-part addition chain (LastChunk:1200-1286) with cyclotomic
      exponentiations by z (finalExpZ:287) — transcribed step for step.

Shares the Fq6/Fq12 tower with the BLS pairing, instantiated with the BN
sextic non-residue xi = 9 + u (ref pNonResidueF6:185).

All values Montgomery; G1 points affine (L, N), G2 affine (2L, N),
results (12L, N).  Plain PyTorch, as bls12.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import torch

from ..curve.spec import CurveSpec
from .bls12 import _cyclotomic_exp, _f12_product_tree, _fe_easy, _frob_k, _infinity_pairs
from .tower import Tower, _st

#: BN254 curve parameter z (ref finalExpZ, build_bn128.js:287)
BN254_Z = 4965661367192848881


@dataclass(frozen=True)
class BNPairingSpec:
    g1: CurveSpec
    g2: CurveSpec
    z: int  # BN parameter; ate loop count is 6z+2
    xi: Tuple[int, int] = (9, 1)  # sextic non-residue (ref pNonResidueF6:185)

    @cached_property
    def tower(self) -> Tower:
        return Tower(self.g1.fq, xi=self.xi)

    @cached_property
    def loop_count(self) -> int:
        return 6 * self.z + 2  # ref ateLoopCount:253

    @cached_property
    def loop_bits(self) -> Tuple[int, ...]:
        """LSB-first bits of 6z+2 (ref bits():305)."""
        n = self.loop_count
        return tuple((n >> i) & 1 for i in range(n.bit_length()))

    # -- embedded constants (ref :190-199, :525-535) -----------------------

    @cached_property
    def two_inv(self) -> Tuple[int, int]:
        return (pow(2, -1, self.g1.q), 0)  # pTwoInv:190

    @cached_property
    def twist_b(self) -> Tuple[int, int]:
        return tuple(c % self.g1.q for c in self.g2.b)  # pTwistCoefB:197

    @cached_property
    def frob_gamma_x(self) -> Tuple[int, int]:
        """xi^((q-1)/3): the mulByQ x-coefficient (MulByQX:525)."""
        return self._xi_pow((self.g1.q - 1) // 3)

    @cached_property
    def frob_gamma_y(self) -> Tuple[int, int]:
        """xi^((q-1)/2): the mulByQ y-coefficient (MulByQY:530)."""
        return self._xi_pow((self.g1.q - 1) // 2)

    def _xi_pow(self, e: int) -> Tuple[int, int]:
        from ...oracle import F2 as HostF2

        hf = HostF2(self.g1.q, -1)
        acc, base = (1, 0), self.xi
        while e:
            if e & 1:
                acc = hf.mul(acc, base)
            base = hf.sqr(base)
            e >>= 1
        return acc


def _dbl_step(ps: BNPairingSpec, R):
    """Homogeneous-projective doubling + line coefficients
    (ref prepDblStep, build_bn128.js:417-512).  Independent Fq2 ops of one
    round run as one stacked call."""
    tw = ps.tower
    F2 = tw.f2
    X1, Y1, Z1 = R
    one_batch, dev = (1,) * (X1.ndim - 1), X1.device
    two_inv = F2.const(ps.two_inv, one_batch, dev)
    twist_b = F2.const(ps.twist_b, one_batch, dev)

    s_yz = F2.add(Y1, Z1)
    yh, B, C, syz2, J = F2.mul(_st(Y1, Y1, Z1, s_yz, X1), _st(two_inv, Y1, Z1, s_yz, X1)).unbind(1)
    C2, BC, J2 = F2.add(_st(C, B, J), _st(C, C, J)).unbind(1)
    D, ell_vv = F2.add(_st(C2, J2), _st(C, J)).unbind(1)  # 3C, 3J
    A, E = F2.mul(_st(X1, twist_b), _st(yh, D)).unbind(1)
    E_2 = F2.add(E, E)
    F_ = F2.add(E_2, E)  # 3E
    H = F2.sub(syz2, BC)
    BF = F2.add(B, F_)
    BmF, I = F2.sub(_st(B, E), _st(F_, B)).unbind(1)
    G, E2, nX, nZ = F2.mul(_st(BF, E, A, B), _st(two_inv, E, BmF, H)).unbind(1)
    G2, E2_2 = F2.mul(G, G), F2.add(E2, E2)
    nY = F2.sub(G2, F2.add(E2_2, E2))

    ell_0 = tw.f2_mul_xi(I)
    ell_vw = F2.neg(H)  # later * yP
    return (nX, nY, nZ), (ell_0, ell_vw, ell_vv)


def _add_step(ps: BNPairingSpec, R, Q):
    """Homogeneous-projective mixed addition + line coefficients
    (ref prepAddStep, build_bn128.js:331-413)."""
    tw = ps.tower
    F2 = tw.f2
    X1, Y1, Z1 = R
    X2, Y2 = Q

    x2z, y2z = F2.mul(_st(X2, Y2), _st(Z1, Z1)).unbind(1)
    D, E = F2.sub(_st(X1, Y1), _st(x2z, y2z)).unbind(1)
    F_, G, ex, dy = F2.mul(_st(D, E, E, D), _st(D, E, X2, Y2)).unbind(1)
    H, I, zg = F2.mul(_st(D, X1, Z1), _st(F_, F_, G)).unbind(1)
    hzg, I_2 = F2.add(_st(H, I), _st(zg, I)).unbind(1)
    J = F2.sub(hzg, I_2)
    IJ = F2.sub(I, J)
    eij, hy, nX, nZ = F2.mul(_st(E, H, D, Z1), _st(IJ, Y1, J, H)).unbind(1)
    nY, l0 = F2.sub(_st(eij, ex), _st(hy, dy)).unbind(1)

    ell_0 = tw.f2_mul_xi(l0)
    ell_vw = D  # later * yP
    ell_vv = F2.neg(E)  # later * xP
    return (nX, nY, nZ), (ell_0, ell_vw, ell_vv)


def _ell(tw: Tower, f, coefs, Px, Py):
    """Fold one line into f (ref millerLoop's f2m_mul1 + __mulBy024,
    build_bn128.js:842-844)."""
    ell_0, ell_vw, ell_vv = coefs
    # vw = ell_vw * P.y, vv = ell_vv * P.x: one base product
    vw, vv = tw.f2_scale_fq(_st(ell_vw, ell_vv), _st(Py, Px)).unbind(1)
    return tw.f12_mul024(f, ell_0, vv, vw)


def _mul_by_q(ps: BNPairingSpec, Q):
    """Frobenius endomorphism on the twist: (x, y) ->
    (gamma_x * conj(x), gamma_y * conj(y)) (ref mulByQ:515-545)."""
    F2 = ps.tower.f2
    Qx, Qy = Q
    one_batch, dev = (1,) * (Qx.ndim - 1), Qx.device
    g = _st(F2.const(ps.frob_gamma_x, one_batch, dev), F2.const(ps.frob_gamma_y, one_batch, dev))
    x, y = F2.mul(g, F2.conjugate(_st(Qx, Qy))).unbind(1)
    return (x, y)


def miller_loop(ps: BNPairingSpec, P, Q):
    """Batched BN Miller loop (ref millerLoop:806-885 + prepareG2:550).

    P affine G1 (L, N) x2; Q affine G2 (2L, N) x2.  Pairs with P or Q at
    infinity yield 1."""
    tw = ps.tower
    F2 = tw.f2
    Px, Py = P
    Qx, Qy = Q
    batch, dev = Px.shape[1:], Px.device
    bits = ps.loop_bits  # LSB-first; bits[-1] == 1

    R = (Qx, Qy, F2.one(batch, dev))
    f = tw.f12_one(batch, dev)
    for i in range(len(bits) - 2, -1, -1):
        f = tw.f12_square(f)
        R, dcoef = _dbl_step(ps, R)
        f = _ell(tw, f, dcoef, Px, Py)
        Ra, acoef = _add_step(ps, R, (Qx, Qy))
        fa = _ell(tw, f, acoef, Px, Py)
        # branch-free, as in the reference's scan body
        do_add = torch.full(tuple(batch), bits[i] == 1, dtype=torch.bool, device=dev)
        R = tuple(F2.select(do_add, a, b) for a, b in zip(Ra, R))
        f = torch.where(do_add[None], fa, f)

    # the two Frobenius-twisted add steps (prepareG2 tail :604-621)
    Q1 = _mul_by_q(ps, (Qx, Qy))
    Q2 = _mul_by_q(ps, Q1)
    Q2 = (Q2[0], F2.neg(Q2[1]))
    R, c1 = _add_step(ps, R, Q1)
    f = _ell(tw, f, c1, Px, Py)
    R, c2 = _add_step(ps, R, Q2)
    f = _ell(tw, f, c2, Px, Py)
    return torch.where(_infinity_pairs(tw, P, Q)[None], tw.f12_one(batch, dev), f)


def _exp_nz(ps: BNPairingSpec, a):
    """a^(-z): z > 0, so exp-then-conjugate (`finalExpIsNegative ? [] :
    conjugate` at build_bn128.js:1235)."""
    return _cyclotomic_exp(ps.tower, a, ps.z, True)


def _tail(ps: BNPairingSpec, elt, B, D, E, G):
    """The mul/conjugate/frobenius tail of the hard-part chain
    (LastChunk:1236-1286)."""
    tw = ps.tower
    mul = tw.f12_mul
    conj = tw.f12_conjugate
    H = conj(D)
    I = conj(G)
    J = mul(I, E)
    K = mul(J, H)
    L_ = mul(K, B)
    M = mul(K, E)
    N = mul(M, elt)
    O = _frob_k(tw, L_, 1)
    P_ = mul(O, N)
    Q_ = _frob_k(tw, K, 2)
    R_ = mul(Q_, P_)
    S = conj(elt)
    T_ = mul(S, L_)
    U = _frob_k(tw, T_, 3)
    return mul(U, R_)


def final_exponentiation(ps: BNPairingSpec, f):
    """f^((q^12 - 1) / r) (ref finalExponentiation:1290).

    Easy part (FirstChunk:994): f^(q^6-1) then ^(q^2+1).
    Hard part (LastChunk:1200-1286): the devegili/zkcrypto BN chain with
    three cyclotomic exponentiations by -z.  The chain's exponent is
    d * (q^4 - q^2 + 1)/r with d = 2z(6z^2+3z+1) (the reference computes
    the same chain at :1200-1286) — a harmless fixed power: the result is
    still a non-degenerate bilinear pairing and matches the reference bit
    for bit.
    """
    tw = ps.tower
    elt = _fe_easy(tw, f)
    A = _exp_nz(ps, elt)
    B = tw.f12_cyclotomic_square(A)
    D = tw.f12_mul(tw.f12_cyclotomic_square(B), B)
    E = _exp_nz(ps, D)
    F_ = tw.f12_cyclotomic_square(E)
    G = _exp_nz(ps, F_)
    return _tail(ps, elt, B, D, E, G)


def pairing(ps: BNPairingSpec, P, Q):
    """e(P, Q) batched (ref bn128 pairing:1368)."""
    return final_exponentiation(ps, miller_loop(ps, P, Q))


def pairing_eq(ps: BNPairingSpec, Ps, Qs):
    """prod_i e(P_i, Q_i) == 1 (ref pairingEq1-5 for bn128): a 0-dim bool
    tensor on the inputs' device."""
    tw = ps.tower
    f = _f12_product_tree(ps, miller_loop(ps, Ps, Qs))
    e = final_exponentiation(ps, f)
    return (e == tw.f12_one((1,), e.device)).all()


_bn254_spec = None


def get_bn254_spec() -> BNPairingSpec:
    global _bn254_spec
    if _bn254_spec is None:
        from ...models.curves import bn254, bn254_g2

        _bn254_spec = BNPairingSpec(g1=bn254, g2=bn254_g2, z=BN254_Z)
    return _bn254_spec


_toy_bn_spec = None


def get_toy_bn_spec() -> BNPairingSpec:
    """The 15-bit toy BN family (z = 5): the same pairing code on a toy
    field, for the fast CPU tests."""
    global _toy_bn_spec
    if _toy_bn_spec is None:
        from ...models.curves import toy_bn, toy_bn_g2

        _toy_bn_spec = BNPairingSpec(g1=toy_bn, g2=toy_bn_g2, z=5, xi=(4, 1))
    return _toy_bn_spec
