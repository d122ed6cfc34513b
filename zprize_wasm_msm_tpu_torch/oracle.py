"""Pure-Python reference oracle: fields, curves, MSM, NTT.

Mirrors the reference's *behavior* (wasmcurves field/curve/MSM semantics)
with plain Python bigints, used only for differential testing of the tensor
code and the CUDA kernels (the role wasmcurves' simpler engines play for its optimized one,
e.g. test/batchAffine.js:1210-1222 derives expected MSM results with
timesScalar + add loops).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# field
# ---------------------------------------------------------------------------


class F:
    """Prime field helpers over python ints."""

    def __init__(self, q: int):
        self.q = q

    def add(self, a, b):
        return (a + b) % self.q

    def sub(self, a, b):
        return (a - b) % self.q

    def neg(self, a):
        return (-a) % self.q

    def mul(self, a, b):
        return (a * b) % self.q

    def sqr(self, a):
        return (a * a) % self.q

    def inv(self, a):
        """a^{-1} (0 -> 0, as a^(q-2) gives): the extended Euclid of pow,
        ~50x faster than the ladder at 753 bits."""
        return pow(a, -1, self.q) if a % self.q else 0

    def sqrt(self, a) -> Optional[int]:
        if a == 0:
            return 0
        if pow(a, (self.q - 1) // 2, self.q) != 1:
            return None
        if self.q % 4 == 3:
            return pow(a, (self.q + 1) // 4, self.q)
        # Tonelli-Shanks
        s, t = 0, self.q - 1
        while t % 2 == 0:
            s += 1
            t //= 2
        z = 2
        while pow(z, (self.q - 1) // 2, self.q) != self.q - 1:
            z += 1
        m, c, w, r = s, pow(z, t, self.q), pow(a, t, self.q), pow(a, (t + 1) // 2, self.q)
        while w != 1:
            i, ww = 0, w
            while ww != 1:
                ww = ww * ww % self.q
                i += 1
            b = pow(c, 1 << (m - i - 1), self.q)
            m, c = i, b * b % self.q
            w = w * c % self.q
            r = r * b % self.q
        return r

    # generic-field surface (shared with F2 so Curve can be field-agnostic)
    def of(self, v):
        return v % self.q if isinstance(v, int) else v

    def is_zero(self, a) -> bool:
        return a % self.q == 0

    def small(self, n: int):
        return n % self.q


class F2:
    """Quadratic extension Fq[u]/(u^2 - nr) over python int pairs."""

    def __init__(self, q: int, nr: int = -1):
        self.q = q
        self.nr = nr % q

    def of(self, v):
        if isinstance(v, int):
            return (v % self.q, 0)
        return (v[0] % self.q, v[1] % self.q)

    def small(self, n: int):
        return (n % self.q, 0)

    def add(self, a, b):
        return ((a[0] + b[0]) % self.q, (a[1] + b[1]) % self.q)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.q, (a[1] - b[1]) % self.q)

    def neg(self, a):
        return ((-a[0]) % self.q, (-a[1]) % self.q)

    def mul(self, a, b):
        q = self.q
        c0 = (a[0] * b[0] + self.nr * a[1] * b[1]) % q
        c1 = (a[0] * b[1] + a[1] * b[0]) % q
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        q = self.q
        norm = (a[0] * a[0] - self.nr * a[1] * a[1]) % q
        ninv = pow(norm, -1, q) if norm else 0
        return (a[0] * ninv % q, (-a[1]) * ninv % q)

    def is_zero(self, a) -> bool:
        return a[0] % self.q == 0 and a[1] % self.q == 0


class F3:
    """Cubic extension Fq[v]/(v^3 - nr) over python int triples
    (the host oracle for src/build_f3m.js — MNT6753's coordinate field)."""

    def __init__(self, q: int, nr: int):
        self.q = q
        self.nr = nr % q

    def of(self, v):
        if isinstance(v, int):
            return (v % self.q, 0, 0)
        return tuple(c % self.q for c in v)

    def small(self, n: int):
        return (n % self.q, 0, 0)

    def add(self, a, b):
        return tuple((x + y) % self.q for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple((x - y) % self.q for x, y in zip(a, b))

    def neg(self, a):
        return tuple((-x) % self.q for x in a)

    def mul(self, a, b):
        q, nr = self.q, self.nr
        c0 = (a[0] * b[0] + nr * (a[1] * b[2] + a[2] * b[1])) % q
        c1 = (a[0] * b[1] + a[1] * b[0] + nr * a[2] * b[2]) % q
        c2 = (a[0] * b[2] + a[1] * b[1] + a[2] * b[0]) % q
        return (c0, c1, c2)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        q, nr = self.q, self.nr
        a0, a1, a2 = a
        c0 = (a0 * a0 - nr * a1 * a2) % q
        c1 = (nr * a2 * a2 - a0 * a1) % q
        c2 = (a1 * a1 - a0 * a2) % q
        t = (a0 * c0 + nr * (a2 * c1 + a1 * c2)) % q
        ti = pow(t, -1, q) if t else 0
        return (c0 * ti % q, c1 * ti % q, c2 * ti % q)

    def is_zero(self, a) -> bool:
        return all(c % self.q == 0 for c in a)


# ---------------------------------------------------------------------------
# short Weierstrass curve y^2 = x^3 + a*x + b, Jacobian coordinates
# ---------------------------------------------------------------------------

# Affine points are (x, y) tuples; None is the point at infinity.
Affine = Optional[Tuple[int, int]]


@dataclass
class Curve:
    """Field-agnostic short Weierstrass group oracle.

    With the default field, coordinates are python ints (G1); pass
    field=F2(q, nr) and tuple coordinates for G2 over Fq2.
    """

    q: int
    a: int
    b: object
    r: int  # group order
    gx: object
    gy: object
    field: object = None

    def __post_init__(self):
        self.F = self.field if self.field is not None else F(self.q)
        self.a = self.F.of(self.a)
        self.b = self.F.of(self.b)
        self.gx = self.F.of(self.gx)
        self.gy = self.F.of(self.gy)

    @property
    def g(self) -> Affine:
        return (self.gx, self.gy)

    def is_on_curve(self, p: Affine) -> bool:
        if p is None:
            return True
        x, y = p
        f = self.F
        lhs = f.sqr(y)
        rhs = f.add(f.add(f.mul(f.sqr(x), x), f.mul(self.a, x)), self.b)
        return f.is_zero(f.sub(lhs, rhs))

    def neg(self, p: Affine) -> Affine:
        if p is None:
            return None
        return (p[0], self.F.neg(p[1]))

    def add(self, p: Affine, s: Affine) -> Affine:
        f = self.F
        if p is None:
            return s
        if s is None:
            return p
        x1, y1 = p
        x2, y2 = s
        if f.is_zero(f.sub(x1, x2)):
            if f.is_zero(f.add(y1, y2)):
                return None
            # doubling
            lam = f.mul(
                f.add(f.mul(f.small(3), f.sqr(x1)), self.a),
                f.inv(f.mul(f.small(2), y1)),
            )
        else:
            lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
        x3 = f.sub(f.sqr(lam), f.add(x1, x2))
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        return (x3, y3)

    def double(self, p: Affine) -> Affine:
        return self.add(p, p)

    def mul(self, p: Affine, k: int) -> Affine:
        """k*P by double-and-add over the FULL scalar — no k mod r shortcut,
        so differential tests exercise non-canonical (>= r) scalars and
        points outside the order-r subgroup end-to-end."""
        assert k >= 0, "negative scalar: negate the point instead"
        acc: Affine = None
        add = p
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.add(add, add)
            k >>= 1
        return acc

    def msm(self, points: Sequence[Affine], scalars: Sequence[int]) -> Affine:
        """Naive double-and-add MSM — the differential oracle."""
        acc: Affine = None
        for p, k in zip(points, scalars):
            acc = self.add(acc, self.mul(p, k))
        return acc


# ---------------------------------------------------------------------------
# NTT oracle over Fr
# ---------------------------------------------------------------------------


def ntt(values: List[int], r: int, root: int) -> List[int]:
    """O(n^2) DFT over Z_r with given primitive n-th root (oracle only):
    out_i = sum_j values_j root^(i j), the powers read from a table of the
    n distinct ones (root^n = 1)."""
    n = len(values)
    powers = [pow(root, k, r) for k in range(n)]
    return [
        sum(values[j] * powers[i * j % n] for j in range(n)) % r for i in range(n)
    ]
