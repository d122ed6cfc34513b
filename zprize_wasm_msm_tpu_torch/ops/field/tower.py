"""Field tower backends: a uniform op surface over the coordinate field.

Counterpart of the reference's field-prefix parameterization: the curve
generator takes a field *prefix* ("f1m" or "f2m") and emits calls to that
field's exported ops (wasmcurves/src/build_curve_jacobian_a0.js:29
`prefixField` arg).  A frozen backend object carries the specialization so
ONE generic group/MSM layer serves every coordinate field.

``Fq``, the quadratic extension ``Fq2`` (G2) and the cubic extension
``Fq3`` (MNT6753's G2) are here.

Element layouts (all Montgomery form):
  Fq:   (L, *batch) int64 — as ops.field.mont.
  Fq2:  (2L, *batch) int64 — flat: component 0 in limbs [:L], component 1
        in [L:], so generic shape logic downstream (padding, reshapes,
        bucket layouts) treats extension elements as wider base elements.
        Packed to 32-bit words (utils/convert.pack_words) this is [c0
        words][c1 words], the layout of the CUDA kernels' Fe2.
  Fq3:  (3L, *batch) int64 — flat the same way, components 0, 1, 2.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple, Union

import numpy as np
import torch

from . import mont
from .spec import FieldSpec

IntLike = Union[int, Tuple[int, ...]]


def stack_elems(*xs: torch.Tensor) -> torch.Tensor:
    """Stack same-width elements (Fq, Fq2 or Fq3) along a new axis 1, after the
    limb axis, broadcasting their batch shapes: k independent values become
    one batch, so k independent field ops run as one (eager PyTorch pays
    per launch, not per element)."""
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    return torch.stack([x if x.shape == shape else x.expand(shape) for x in xs], dim=1)


@dataclass(frozen=True)
class Fq:
    """Base prime field backend (delegates to ops.field.mont)."""

    spec: FieldSpec

    #: leading element axes before the batch (limb axis only)
    elem_ndim = 1

    @property
    def elem_len(self) -> int:
        return self.spec.n_limbs

    def batch_shape(self, a):
        return a.shape[1:]

    def zeros(self, batch_shape=(), device=None):
        return mont.zeros(self.spec, batch_shape, device)

    def one(self, batch_shape=(), device=None):
        return mont.one_mont(self.spec, batch_shape, device)

    def const(self, value: IntLike, batch_shape=(), device=None):
        """Host int (standard domain) -> Montgomery element batch."""
        if not isinstance(value, int):
            raise TypeError(f"Fq.const takes an int, got {type(value).__name__}")
        return mont.full_const(
            self.spec, self.spec.to_mont_int(value), batch_shape, device
        )

    def add(self, a, b):
        return mont.add(self.spec, a, b)

    def sub(self, a, b):
        return mont.sub(self.spec, a, b)

    def neg(self, a):
        return mont.neg(self.spec, a)

    def mul(self, a, b):
        return mont.mont_mul(self.spec, a, b)

    def mul_many(self, pairs):
        """One stacked multiply for independent products: eager PyTorch pays
        per call, so k products in one call cost about what one does."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        a, b = (stack_elems(*side) for side in zip(*pairs))
        return list(mont.mont_mul(self.spec, a, b).unbind(1))

    def square(self, a):
        return mont.mont_square(self.spec, a)

    def inverse(self, a):
        return mont.inverse(self.spec, a)

    def batch_inverse(self, a):
        return mont.batch_inverse(self.spec, a)

    def is_zero(self, a):
        return mont.is_zero(self.spec, a)

    def eq(self, a, b):
        return mont.eq(self.spec, a, b)

    def select(self, mask, a, b):
        return torch.where(mask[None], a, b)

    def sqrt(self, a):
        return mont.sqrt(self.spec, a)

    # host-side marshalling ------------------------------------------------
    def to_host(self, a) -> list:
        from ...utils.limbs import limbs_to_ints

        vals = limbs_to_ints(a.detach().cpu().numpy().astype(np.uint32))
        return [self.spec.from_mont_int(v) for v in vals]


@dataclass(frozen=True)
class Fq2:
    """Quadratic extension Fq[u]/(u^2 - nr) (ref src/build_f2m.js; the JAX
    package's ops/field/tower.py Fq2).  For BLS12-381 and BN254, nr = -1.

    Flat element layout: (2L, *batch) int64 — component 0 in limbs [:L],
    component 1 in limbs [L:].
    """

    spec: FieldSpec  # the base field
    nr: int  # non-residue, as a signed small int (e.g. -1)

    elem_ndim = 1

    @property
    def elem_len(self) -> int:
        return 2 * self.spec.n_limbs

    @cached_property
    def _nr_is_m1(self) -> bool:
        return self.nr % self.spec.q == self.spec.q - 1

    def _split(self, a):
        L = self.spec.n_limbs
        return a[:L], a[L:]

    def batch_shape(self, a):
        return a.shape[1:]

    def zeros(self, batch_shape=(), device=None):
        return torch.cat(
            [mont.zeros(self.spec, batch_shape, device), mont.zeros(self.spec, batch_shape, device)]
        )

    def one(self, batch_shape=(), device=None):
        return torch.cat(
            [mont.one_mont(self.spec, batch_shape, device), mont.zeros(self.spec, batch_shape, device)]
        )

    def const(self, value: IntLike, batch_shape=(), device=None):
        """Host int or (c0, c1) pair (standard domain) -> Montgomery batch."""
        if isinstance(value, int):
            value = (value, 0)
        if len(value) != 2:
            raise TypeError(f"Fq2.const takes an int or a (c0, c1) pair, got {value!r}")
        return torch.cat(
            [
                mont.full_const(self.spec, self.spec.to_mont_int(v), batch_shape, device)
                for v in value
            ]
        )

    def _mul_nr(self, a):
        """Multiply a base-field batch by the non-residue."""
        if self._nr_is_m1:
            return mont.neg(self.spec, a)
        c = mont.full_const(self.spec, self.spec.to_mont_int(self.nr), (1,) * (a.ndim - 1), a.device)
        return mont.mont_mul(self.spec, a, c)

    def _pair(self, a):
        """(2L, *batch) -> the (L, 2, *batch) view: both components in one
        base-field batch, so a componentwise op is one base op (one carry
        pass, not two)."""
        L = self.spec.n_limbs
        return a.reshape((2, L) + tuple(a.shape[1:])).transpose(0, 1)

    def _unpair(self, r):
        return r.transpose(0, 1).reshape((2 * self.spec.n_limbs,) + tuple(r.shape[2:]))

    def add(self, a, b):
        return self._unpair(mont.add(self.spec, self._pair(a), self._pair(b)))

    def sub(self, a, b):
        return self._unpair(mont.sub(self.spec, self._pair(a), self._pair(b)))

    def neg(self, a):
        return self._unpair(mont.neg(self.spec, self._pair(a)))

    def conjugate(self, a):
        """(a0, a1) -> (a0, -a1) (ref build_f2m.js conjugate:115)."""
        a0, a1 = self._split(a)
        return torch.cat([a0, mont.neg(self.spec, a1)])

    def mul(self, a, b):
        """Karatsuba: 3 base products in one stacked call (ref build_f2m.js
        mul:153); the two operand sums in one base op and, for nr = -1, the
        differences m0 - m1 and m2 - m0 in one more."""
        s = self.spec
        a0, a1 = self._split(a)
        b0, b1 = self._split(b)
        sa, sb = mont.add(s, stack_elems(a0, b0), stack_elems(a1, b1)).unbind(1)
        m0, m1, m2 = Fq(s).mul_many([(a0, b0), (a1, b1), (sa, sb)])
        if self._nr_is_m1:
            c0, d = mont.sub(s, stack_elems(m0, m2), stack_elems(m1, m0)).unbind(1)
            return torch.cat([c0, mont.sub(s, d, m1)])
        c0 = mont.add(s, m0, self._mul_nr(m1))
        c1 = mont.sub(s, mont.sub(s, m2, m0), m1)
        return torch.cat([c0, c1])

    def mul_many(self, pairs):
        """Independent products in one stacked Karatsuba (see Fq.mul_many)."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        a, b = (stack_elems(*side) for side in zip(*pairs))
        return list(self.mul(a, b).unbind(1))

    def square(self, a):
        """Complex squaring (2 base products, ref build_f2m.js square:212)."""
        s = self.spec
        a0, a1 = self._split(a)
        if self._nr_is_m1:
            p, q = Fq(s).mul_many([(mont.add(s, a0, a1), mont.sub(s, a0, a1)), (a0, a1)])
            return torch.cat([p, mont.add(s, q, q)])
        return self.mul(a, a)

    def norm(self, a):
        """a0^2 - nr a1^2 (base-field batch)."""
        s = self.spec
        a0, a1 = self._split(a)
        sq0, sq1 = Fq(s).mul_many([(a0, a0), (a1, a1)])
        return mont.sub(s, sq0, self._mul_nr(sq1))

    def _conj_times(self, a, ninv):
        s = self.spec
        a0, a1 = self._split(a)
        c0, c1 = Fq(s).mul_many([(a0, ninv), (a1, ninv)])
        return torch.cat([c0, mont.neg(s, c1)])

    def inverse(self, a):
        """conj(a) / norm(a) (ref build_f2m.js inverse:379): one Fq
        inversion of the norm."""
        return self._conj_times(a, mont.inverse(self.spec, self.norm(a)))

    def batch_inverse(self, a):
        """The norms through mont.batch_inverse, whose one inversion is the
        field inversion kernel for a tensor on the card."""
        return self._conj_times(a, mont.batch_inverse(self.spec, self.norm(a)))

    def is_zero(self, a):
        a0, a1 = self._split(a)
        return mont.is_zero(self.spec, a0) & mont.is_zero(self.spec, a1)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, mask, a, b):
        return torch.where(mask[None], a, b)

    def sign(self, a):
        """sign(a1) if a1 != 0 else sign(a0) (ref build_f2m.js sign:411)."""
        a0, a1 = self._split(a)
        s1 = mont.sign(self.spec, a1)
        return torch.where(s1 != 0, s1, mont.sign(self.spec, a0))

    def exp_const(self, a, e: int):
        """a^e for a host-known exponent (MSB-first square-and-multiply, the
        Fq2 instantiation of build_timesscalar.js); the multiply is skipped
        on zero bits."""
        if e == 0:
            return self.one(self.batch_shape(a), a.device)
        acc = a  # the top bit is always 1
        for i in range(e.bit_length() - 2, -1, -1):
            acc = self.square(acc)
            if (e >> i) & 1:
                acc = self.mul(acc, a)
        return acc

    def sqrt(self, a):
        """Square root in Fq2 for q = 3 (mod 4): algorithm 9 (adjusted) of
        eprint 2012/685, the reference's f2m sqrt (build_f2m.js
        buildSqrt:453-522), for any non-residue nr.  Returns (root,
        has_root mask); branch-free (the reference traps on non-residues
        instead)."""
        q = self.spec.q
        if q % 4 != 3:
            raise NotImplementedError(f"Fq2.sqrt: q = {q} is not 3 mod 4 (as in the reference)")
        batch, dev = self.batch_shape(a), a.device
        a1 = self.exp_const(a, (q - 3) // 4)
        alpha = self.mul(self.square(a1), a)
        x0 = self.mul(a1, a)
        alpha_is_m1 = self.eq(alpha, self.neg(self.one(batch, dev)))
        # alpha = -1: x = u x0; otherwise x = (1 + alpha)^((q-1)/2) x0
        xa = self.mul(self.const((0, 1), batch, dev), x0)
        b = self.exp_const(self.add(self.one(batch, dev), alpha), (q - 1) // 2)
        x = self.select(alpha_is_m1, xa, self.mul(b, x0))
        return x, self.eq(self.square(x), a) | self.is_zero(a)

    # host-side marshalling ------------------------------------------------
    def to_host(self, a) -> list:
        from ...utils.limbs import limbs_to_ints

        a = a.detach().cpu().numpy().astype(np.uint32)
        a0, a1 = self._split(a)
        f = self.spec.from_mont_int
        return [(f(x), f(y)) for x, y in zip(limbs_to_ints(a0), limbs_to_ints(a1))]


@dataclass(frozen=True)
class Fq3:
    """Cubic extension Fq[v]/(v^3 - nr) (ref src/build_f3m.js — mul:152,
    square:218, inverse:416; instantiated for MNT6753 with nr = 11,
    src/mnt6753/build_mnt6753.js build_mulNR3:34-51; the JAX package's
    ops/field/tower.py Fq3).

    Flat element layout: (3L, *batch) int64 — component k in limb rows
    [kL:(k+1)L], the Fq2 convention, so the generic group and MSM layers
    treat extension elements as wider base elements.  Independent base ops
    of a formula run as one stacked op (eager PyTorch pays per launch).
    """

    spec: FieldSpec  # the base field
    nr: int  # non-residue (v^3 = nr), small positive int

    elem_ndim = 1

    @property
    def elem_len(self) -> int:
        return 3 * self.spec.n_limbs

    def _split(self, a):
        L = self.spec.n_limbs
        return a[:L], a[L : 2 * L], a[2 * L :]

    def batch_shape(self, a):
        return a.shape[1:]

    def zeros(self, batch_shape=(), device=None):
        return torch.zeros((self.elem_len,) + tuple(batch_shape), dtype=mont.I64, device=device)

    def one(self, batch_shape=(), device=None):
        return torch.cat(
            [mont.one_mont(self.spec, batch_shape, device)]
            + [mont.zeros(self.spec, batch_shape, device)] * 2
        )

    def const(self, value: IntLike, batch_shape=(), device=None):
        """Host int or (c0, c1, c2) triple (standard domain) -> Montgomery batch."""
        if isinstance(value, int):
            value = (value, 0, 0)
        if len(value) != 3:
            raise TypeError(f"Fq3.const takes an int or a (c0, c1, c2) triple, got {value!r}")
        return torch.cat(
            [
                mont.full_const(self.spec, self.spec.to_mont_int(v % self.spec.q), batch_shape, device)
                for v in value
            ]
        )

    def _mul_nr(self, a):
        """Multiply a base-field batch by the non-residue (mulNR3)."""
        c = mont.full_const(
            self.spec, self.spec.to_mont_int(self.nr % self.spec.q), (1,) * (a.ndim - 1), a.device
        )
        return mont.mont_mul(self.spec, a, c)

    def _tri(self, a):
        """(3L, *batch) -> the (L, 3, *batch) view: the three components in
        one base-field batch, so a componentwise op is one base op."""
        L = self.spec.n_limbs
        return a.reshape((3, L) + tuple(a.shape[1:])).transpose(0, 1)

    def _untri(self, r):
        return r.transpose(0, 1).reshape((3 * self.spec.n_limbs,) + tuple(r.shape[2:]))

    def add(self, a, b):
        return self._untri(mont.add(self.spec, self._tri(a), self._tri(b)))

    def sub(self, a, b):
        return self._untri(mont.sub(self.spec, self._tri(a), self._tri(b)))

    def neg(self, a):
        return self._untri(mont.neg(self.spec, self._tri(a)))

    def mul(self, a, b):
        """6-multiplication Karatsuba-style product (ref build_f3m.js
        mul:152): the six operand sums one base op, the six products one,
        the differences two, the two products by nr one, the last sums one."""
        s = self.spec
        a0, a1, a2 = self._split(a)
        b0, b1, b2 = self._split(b)
        sa01, sb01, sa12, sb12, sa02, sb02 = mont.add(
            s, stack_elems(a0, b0, a1, b1, a0, b0), stack_elems(a1, b1, a2, b2, a2, b2)
        ).unbind(1)
        t0, t1, t2, m01, m12, m02 = Fq(s).mul_many(
            [(a0, b0), (a1, b1), (a2, b2), (sa01, sb01), (sa12, sb12), (sa02, sb02)]
        )
        # m12 - t1 - t2, m01 - t0 - t1, m02 - t0 - t2
        d = mont.sub(s, stack_elems(m12, m01, m02), stack_elems(t1, t0, t0))
        e12, e01, e02 = mont.sub(s, d, stack_elems(t2, t1, t2)).unbind(1)
        n12, n2 = self._mul_nr(stack_elems(e12, t2)).unbind(1)
        return self._untri(mont.add(s, stack_elems(t0, e01, e02), stack_elems(n12, n2, t1)))

    def mul_many(self, pairs):
        """Independent products in one stacked product (see Fq.mul_many)."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        a, b = (stack_elems(*side) for side in zip(*pairs))
        return list(self.mul(a, b).unbind(1))

    def square(self, a):
        return self.mul(a, a)

    def _cofactors(self, a):
        """(c0, c1, c2, t): a^{-1} = c / t with t = a0 c0 + nr (a2 c1 + a1 c2)
        in the base field (ref build_f3m.js inverse:416)."""
        s = self.spec
        a0, a1, a2 = self._split(a)
        sq0, sq1, sq2, m01, m02, m12 = Fq(s).mul_many(
            [(a0, a0), (a1, a1), (a2, a2), (a0, a1), (a0, a2), (a1, a2)]
        )
        n12, n2 = self._mul_nr(stack_elems(m12, sq2)).unbind(1)
        c0, c1, c2 = mont.sub(s, stack_elems(sq0, n2, sq1), stack_elems(n12, m01, m02)).unbind(1)
        u0, u1, t0 = Fq(s).mul_many([(a2, c1), (a1, c2), (a0, c0)])
        t = mont.add(s, t0, self._mul_nr(mont.add(s, u0, u1)))
        return c0, c1, c2, t

    def inverse(self, a):
        """Fq3 inverse (ref build_f3m.js inverse:416): the cofactors over
        one base inversion of the norm-style t, through
        ops.field.kernels.inverse: one launch of the field inversion kernel
        for a tensor on the card, the plain Fermat ladder for a CPU tensor.
        0 maps to 0."""
        from . import kernels  # kernels imports mont, which this module imports

        c0, c1, c2, t = self._cofactors(a)
        tinv = kernels.inverse(self.spec, t)
        return self._untri(
            mont.mont_mul(self.spec, self._tri(torch.cat([c0, c1, c2])), tinv[:, None])
        )

    def batch_inverse(self, a):
        # the cofactor trick already shares ONE base inversion per element,
        # and the inversion runs over the whole batch at once
        return self.inverse(a)

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, mask, a, b):
        return torch.where(mask[None], a, b)

    def sign(self, a):
        """Sign of the highest nonzero component, order c2 -> c1 -> c0
        (ref build_f3m.js sign:473)."""
        a0, a1, a2 = self._split(a)
        s0, s1, s2 = mont.sign(self.spec, stack_elems(a0, a1, a2)).unbind(0)
        return torch.where(s2 != 0, s2, torch.where(s1 != 0, s1, s0))

    def sqrt(self, a):
        raise NotImplementedError(
            "Fq3 square root is not implemented (the reference's f3m has no "
            "sqrt either, build_f3m.js); compressed decode is unavailable "
            "for cubic-extension curves — use uncompressed serialization."
        )

    # host-side marshalling ------------------------------------------------
    def to_host(self, a) -> list:
        from ...utils.limbs import limbs_to_ints

        a = a.detach().cpu().numpy().astype(np.uint32)
        f = self.spec.from_mont_int
        return [
            (f(x), f(y), f(z)) for x, y, z in zip(*(limbs_to_ints(c) for c in self._split(a)))
        ]
