"""Fq6 / Fq12 tower arithmetic for pairings, batched on limb tensors.

Port of zprize_wasm_msm_tpu/ops/pairing/tower.py, the counterpart of the
reference's extension tower (wasmcurves/src/build_f3m.js instantiated as
f6m over f2m with mulNR = (1+u)-multiplication, and build_f2m.js as ftm =
Fq12 over f6m — wired at build_bls12381.js:195-252; sparse muls
f6m_mul1/mul01 and ftm_mul014 at :625-788).

Tower (BLS12-381 and BN-style curves):
  Fq2  = Fq[u]/(u^2+1)          — ops.field.tower.Fq2, flat (2L, *batch)
  Fq6  = Fq2[v]/(v^3-ξ)         — flat (6L, *batch), components c0,c1,c2
  Fq12 = Fq6[w]/(w^2-v)         — flat (12L, *batch), components c0,c1

Every op is a composition of plain batched base-field ops (ops.field.mont),
so one call advances the whole pair batch.  Eager PyTorch pays per launch,
not per element, so independent Fq2 operations of one formula are stacked
along a new batch axis (``_st``) and run as ONE base op: an Fq6 product is
one Fq2 product call over its six Karatsuba products, an Fq12 product one
Fq6 product call over its three.  Every value is canonical, so the limbs
equal the JAX package's bit for bit whatever the grouping.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import torch

from ..field import mont
from ..field.spec import FieldSpec
from ..field.tower import Fq2
from ..field.tower import stack_elems as _st


@dataclass(frozen=True)
class Tower:
    """Fq6/Fq12 ops over a base prime field, parameterized by the sextic
    non-residue ξ ∈ Fq2 (Fq2 = Fq[u]/(u^2+1)).

    ξ = 1 + u for BLS12-381 (ref build_bls12381.js build_mulNR2:195);
    ξ = 9 + u for BN254 (ref src/bn128/build_bn128.js pNonResidueF6:185).
    """

    spec: FieldSpec
    xi: Tuple[int, int] = (1, 1)

    @cached_property
    def f2(self) -> Fq2:
        return Fq2(self.spec, -1)

    @property
    def L2(self) -> int:
        return 2 * self.spec.n_limbs

    def _base_map(self, fn, *arrs):
        """Apply a base-field op componentwise over a stacked (mL, *batch)
        tensor: reshape to (L, m, *batch) so ONE base op advances all m
        components (limb semantics stay per-component)."""
        L = self.spec.n_limbs
        shp = arrs[0].shape
        m = shp[0] // L

        def to3(x):
            return x.reshape((m, L) + tuple(shp[1:])).transpose(0, 1)

        out = fn(*[to3(x) for x in arrs])
        return out.transpose(0, 1).reshape(shp)

    # -- Fq2 helpers --------------------------------------------------------

    def f2_mul_xi(self, a):
        """ξ * a, for a (2L, *batch) Fq2 batch.  Fast path for ξ = 1+u:
        (a0 - a1) + (a0 + a1) u (ref build_bls12381.js build_mulNR2:195);
        general ξ via one Fq2 product by the constant (ref bn128
        build_mulNR6:202)."""
        s = self.spec
        L = s.n_limbs
        if self.xi == (1, 1):
            a0, a1 = a[:L], a[L:]
            return torch.cat([mont.sub(s, a0, a1), mont.add(s, a0, a1)])
        xi = self.f2.const(self.xi, (1,) * (a.ndim - 1), a.device)
        return self.f2.mul(a, xi)

    def f2_scale_fq(self, a2, s1):
        """Scale an Fq2 batch (2L, *batch) componentwise by an Fq batch
        (L, *batch) (the reference's f2m_mul1 over the base field,
        build_f2m.js): one base product."""
        L = self.spec.n_limbs
        r = mont.mont_mul(self.spec, _st(a2[:L], a2[L:]), s1[:, None])
        return torch.cat([r[:, 0], r[:, 1]])

    # -- Fq6 ----------------------------------------------------------------

    def f6_split(self, a):
        k = self.L2
        return a[:k], a[k : 2 * k], a[2 * k :]

    def f6_zero(self, batch, device=None):
        return torch.zeros((3 * self.L2,) + tuple(batch), dtype=torch.int64, device=device)

    def f6_one(self, batch, device=None):
        F2 = self.f2
        return torch.cat([F2.one(batch, device), F2.zeros(batch, device), F2.zeros(batch, device)])

    def f6_add(self, a, b):
        return self._base_map(lambda x, y: mont.add(self.spec, x, y), a, b)

    def f6_sub(self, a, b):
        return self._base_map(lambda x, y: mont.sub(self.spec, x, y), a, b)

    def f6_neg(self, a):
        return self._base_map(lambda x: mont.neg(self.spec, x), a)

    def f6_mul_nr(self, a):
        """v * (c0 + c1 v + c2 v^2) = ξ c2 + c0 v + c1 v^2
        (ref build_mulNR6:218)."""
        c0, c1, c2 = self.f6_split(a)
        return torch.cat([self.f2_mul_xi(c2), c0, c1])

    def f6_mul(self, a, b):
        """Toom/Karatsuba-style 6-mul Fq6 product (ref build_f3m.js
        mul:152): the six Fq2 products in one call."""
        F2 = self.f2
        a0, a1, a2 = self.f6_split(a)
        b0, b1, b2 = self.f6_split(b)
        sa01, sa12, sa02, sb01, sb12, sb02 = F2.add(
            _st(a0, a1, a0, b0, b1, b0), _st(a1, a2, a2, b1, b2, b2)
        ).unbind(1)
        t0, t1, t2, m01, m12, m02 = F2.mul(
            _st(a0, a1, a2, sa01, sa12, sa02), _st(b0, b1, b2, sb01, sb12, sb02)
        ).unbind(1)
        # (m12 - t1 - t2, m01 - t0 - t1, m02 - t0 - t2)
        d = F2.sub(F2.sub(_st(m12, m01, m02), _st(t1, t0, t0)), _st(t2, t1, t2))
        x0, x1 = self.f2_mul_xi(_st(d[:, 0], t2)).unbind(1)
        c = F2.add(_st(t0, d[:, 1], d[:, 2]), _st(x0, x1, t1))
        return torch.cat(c.unbind(1))

    def f6_square(self, a):
        return self.f6_mul(a, a)

    def f6_mul1(self, a, c1):
        """a * (0 + c1 v + 0 v^2), c1 in Fq2 (ref f6m_mul1:625)."""
        F2 = self.f2
        a0, a1, a2 = self.f6_split(a)
        s12, s01 = F2.add(_st(a1, a0), _st(a2, a1)).unbind(1)
        b_b, p12, p01 = F2.mul(_st(a1, s12, s01), c1[:, None]).unbind(1)
        d12, t2 = F2.sub(_st(p12, p01), _st(b_b, b_b)).unbind(1)
        return torch.cat([self.f2_mul_xi(d12), t2, b_b])

    def f6_mul01(self, a, c0, c1):
        """a * (c0 + c1 v), c0/c1 in Fq2 (ref f6m_mul01:668)."""
        F2 = self.f2
        a0, a1, a2 = self.f6_split(a)
        s12, sc, s01, s02 = F2.add(_st(a1, c0, a0, a0), _st(a2, c1, a1, a2)).unbind(1)
        a_a, b_b, p12, p01, p02 = F2.mul(
            _st(a0, a1, s12, sc, s02), _st(c0, c1, c1, s01, c0)
        ).unbind(1)
        d12, d01, d02 = F2.sub(_st(p12, p01, p02), _st(b_b, a_a, a_a)).unbind(1)
        t1, t3 = F2.add(_st(self.f2_mul_xi(d12), d02), _st(a_a, b_b)).unbind(1)
        t2 = F2.sub(d01, b_b)
        return torch.cat([t1, t2, t3])

    def f6_inverse(self, a):
        """Fq6 inverse (ref build_f3m.js inverse:416).  The one Fq2
        inversion is Fq2.batch_inverse: its one field inversion is the
        inversion kernel for a tensor on the card (ops.field.kernels), the
        Fermat ladder on the CPU."""
        F2 = self.f2
        a0, a1, a2 = self.f6_split(a)
        sq0, p12, sq2, p01, sq1, p02 = F2.mul(
            _st(a0, a1, a2, a0, a1, a0), _st(a0, a2, a2, a1, a1, a2)
        ).unbind(1)
        x12, x22 = self.f2_mul_xi(_st(p12, sq2)).unbind(1)
        c = F2.sub(_st(sq0, x22, sq1), _st(x12, p01, p02))  # (c0, c1, c2)
        c0, c1, c2 = c.unbind(1)
        q21, q12, q00 = F2.mul(_st(a2, a1, a0), _st(c1, c2, c0)).unbind(1)
        t = F2.add(self.f2_mul_xi(F2.add(q21, q12)), q00)
        tinv = F2.batch_inverse(t)
        return torch.cat(F2.mul(c, tinv[:, None]).unbind(1))

    # -- Fq12 ---------------------------------------------------------------

    def f12_split(self, a):
        k = 3 * self.L2
        return a[:k], a[k:]

    def f12_one(self, batch, device=None):
        return torch.cat([self.f6_one(batch, device), self.f6_zero(batch, device)])

    def f12_mul(self, a, b):
        """Karatsuba over Fq6 (ref build_f2m.js mul instantiated as ftm): the
        three Fq6 products in one call."""
        a0, a1 = self.f12_split(a)
        b0, b1 = self.f12_split(b)
        sa, sb = self.f6_add(_st(a0, b0), _st(a1, b1)).unbind(1)
        t0, t1, m = self.f6_mul(_st(a0, a1, sa), _st(b0, b1, sb)).unbind(1)
        c0, s01 = self.f6_add(_st(t0, t0), _st(self.f6_mul_nr(t1), t1)).unbind(1)
        return torch.cat([c0, self.f6_sub(m, s01)])

    def f12_square(self, a):
        """Complex squaring over Fq6: its two Fq6 products in one call."""
        a0, a1 = self.f12_split(a)
        s0, s1 = self.f6_add(_st(a0, a0), _st(a1, self.f6_mul_nr(a1))).unbind(1)
        v0, t = self.f6_mul(_st(a0, s0), _st(a1, s1)).unbind(1)
        u, c1 = self.f6_add(_st(v0, v0), _st(self.f6_mul_nr(v0), v0)).unbind(1)
        return torch.cat([self.f6_sub(t, u), c1])

    def f12_conjugate(self, a):
        """a0 - a1 w (= a^(p^6), ref ftm conjugate)."""
        a0, a1 = self.f12_split(a)
        return torch.cat([a0, self.f6_neg(a1)])

    def f12_inverse(self, a):
        a0, a1 = self.f12_split(a)
        sq0, sq1 = self.f6_mul(_st(a0, a1), _st(a0, a1)).unbind(1)
        tinv = self.f6_inverse(self.f6_sub(sq0, self.f6_mul_nr(sq1)))
        c0, c1 = self.f6_mul(_st(a0, a1), tinv[:, None]).unbind(1)
        return torch.cat([c0, self.f6_neg(c1)])

    def f12_mul014(self, a, c0, c1, c4):
        """Sparse multiply by (c0 + c1 v) + (c4 v) w — the Miller-loop line
        (ref ftm_mul014:737).  Its three sparse Fq6 products (two mul01, one
        mul1 = mul01 with c0 = 0) run as one f6_mul01 call."""
        a0, a1 = self.f12_split(a)
        L2 = self.L2
        s = self._base_map(lambda x, y: mont.add(self.spec, x, y),
                           torch.cat([a1, c1]), torch.cat([a0, c4]))
        sa, o = s[: 3 * L2], s[3 * L2 :]  # a1 + a0, c1 + c4
        zero = torch.zeros_like(c0)
        aa, r1, bb = self.f6_mul01(_st(a0, sa, a1), _st(c0, c0, zero), _st(c1, o, c4)).unbind(1)
        r0, s_ab = self.f6_add(_st(self.f6_mul_nr(bb), aa), _st(aa, bb)).unbind(1)
        return torch.cat([r0, self.f6_sub(r1, s_ab)])

    def f12_mul024(self, a, x0, x2, x4):
        """Sparse multiply by x0 + x2 v^2 + x4 v w — the BN Miller-loop line
        (ref src/bn128/build_bn128.js __mulBy024:663-805; component z_i is
        the i-th Fq2 slot of the flat f12 layout, matching the reference's
        offsets z0..z5).  The reference's 13 Fq2 products in one call."""
        F2 = self.f2
        k = self.L2
        z = [a[m * k : (m + 1) * k] for m in range(6)]
        t2, t1, z13, x02, x24, z24, x04 = F2.add(
            _st(z[0], z[0], z[1], x0, x2, z[2], x0), _st(z[4], z[2], z[3], x2, x4, z[4], x4)
        ).unbind(1)
        s0, x024 = F2.add(_st(z13, x02), _st(z[5], x4)).unbind(1)
        (d0, d2, d4, z1x2, z5x4, z1x0, p02, z3x4, p24, z3x0, z5x2, p04, p5) = F2.mul(
            _st(z[0], z[2], z[4], z[1], z[5], z[1], t1, z[3], x24, z[3], z[5], t2, s0),
            _st(x0, x2, x4, x2, x4, x0, x02, x4, z24, x0, x2, x04, x024),
        ).unbind(1)
        e = F2.add(
            _st(z1x2, z5x4, d0, d2, d0, z1x2, z1x0, z3x0),
            _st(d4, d2, d2, d4, d4, z5x4, z3x4, z5x2),
        ).unbind(1)
        # (t3 of z2', t3 of z3', t3 of z4'): t1 (x0+x2) - (d0+d2), ...
        f02, f24, f04 = F2.sub(_st(p02, p24, p04), _st(e[2], e[3], e[4])).unbind(1)
        xi0, xi1, xi3, xi4 = self.f2_mul_xi(_st(e[0], e[1], f24, z5x2)).unbind(1)
        o0, o1, o2, o3, o4, s1a = F2.add(
            _st(xi0, xi1, f02, xi3, xi4, e[5]), _st(d0, z1x0, z3x4, z3x0, f04, e[6])
        ).unbind(1)
        o5 = F2.sub(p5, F2.add(s1a, e[7]))
        return torch.cat([o0, o1, o2, o3, o4, o5])

    # -- Frobenius ----------------------------------------------------------

    @cached_property
    def _frob_gammas(self):
        """Host table γ_k = ξ^(k(q-1)/6) in Fq2 for k = 0..5."""
        from ...oracle import F2 as HostF2

        q = self.spec.q
        hf = HostF2(q, -1)
        out = []
        for k in range(6):
            e = k * (q - 1) // 6
            acc, base = (1, 0), self.xi
            while e:
                if e & 1:
                    acc = hf.mul(acc, base)
                base = hf.sqr(base)
                e >>= 1
            out.append(acc)
        return out

    def _f2_const(self, val, batch, device=None):
        return self.f2.const(val, batch, device)

    def f12_frobenius(self, a):
        """a^q (ref buildFrobeniusMap(1), build_bls12381.js:904).

        Component c_{i,j} of v^i w^j maps to conj(c_{i,j}) * γ_{2i+j}.
        Layout: [c00, c01, c02 | c10, c11, c12], the first index the w
        coefficient: a = (c00 + c01 v + c02 v^2) + (c10 + c11 v + c12 v^2) w.
        """
        F2 = self.f2
        k = self.L2
        nb = a.ndim - 1
        cc = F2.conjugate(_st(*[a[m * k : (m + 1) * k] for m in range(6)]))
        # every component but c00 (γ_0 = 1) times its γ, in one product
        gammas = _st(*[self._f2_const(self._frob_gammas[2 * (m % 3) + m // 3], (1,) * nb, a.device)
                       for m in range(1, 6)])
        out = F2.mul(cc[:, 1:], gammas)
        return torch.cat([cc[:, 0]] + list(out.unbind(1)))

    def f12_cyclotomic_square(self, a):
        """Granger-Scott cyclotomic squaring (ref cyclotomicSquare:1008) —
        valid for elements of the cyclotomic subgroup (after the easy part
        of the final exponentiation).  The tower is [c00,c01,c02,c10,c11,c12];
        Granger-Scott works on the Fq4 sub-pairs (c00,c11), (c10,c02),
        (c01,c12): its three Fq4 squarings' nine Fq2 squares in one call."""
        F2 = self.f2
        k = self.L2
        c = [a[m * k : (m + 1) * k] for m in range(6)]
        z0, z4, z3, z2, z1, z5 = c
        s01, s23, s45 = F2.add(_st(z0, z2, z4), _st(z1, z3, z5)).unbind(1)
        sq = F2.square(_st(z0, z1, s01, z2, z3, s23, z4, z5, s45)).unbind(1)
        t0s, t1s, t2s = sq[0::3], sq[1::3], sq[2::3]  # per pair: a0^2, a1^2, (a0+a1)^2
        xi_t1 = self.f2_mul_xi(_st(*t1s)).unbind(1)
        u = F2.add(_st(*xi_t1, *t0s), _st(*t0s, *t1s)).unbind(1)
        A = u[:3]  # fp4_square's c0 = ξ a1^2 + a0^2, per pair
        B = F2.sub(_st(*t2s), _st(*u[3:])).unbind(1)  # its c1 = 2 a0 a1
        xi_b2 = self.f2_mul_xi(B[2])
        # z0 = 2(A0 - z0) + A0, z4 = 2(A1 - z4) + A1, z3 = 2(A2 - z3) + A2;
        # z1 = 2(B0 + z1) + B0, z5 = 2(B1 + z5) + B1, z2 = 2(ξB2 + z2) + ξB2
        d_sub = F2.sub(_st(A[0], A[1], A[2]), _st(z0, z4, z3))
        d_add = F2.add(_st(B[0], B[1], xi_b2), _st(z1, z5, z2))
        d = torch.cat([d_sub, d_add], dim=1)
        n0, n4, n3, n1, n5, n2 = F2.add(
            F2.add(d, d), _st(A[0], A[1], A[2], B[0], B[1], xi_b2)
        ).unbind(1)
        return torch.cat([n0, n4, n3, n2, n1, n5])
