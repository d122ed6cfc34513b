"""PyTorch port, the window fold's Fq2 links (csrc/fold2.cuh), the product
by 3b as additions (fold2.cuh fold2_twist, csrc/par.cuh fe_mul_b3k) and the
Montgomery square of K6 (csrc/field.cuh fe_sqr), modelled on the CPU.

fold2.cuh runs one point on a block of NT threads and keeps an Fq2 element
as its Karatsuba components (c0, c1, c0 + c1).  Each Fq product k of slot
s's Fq2 product (k = 0: a0 b0, 1: a1 b1, 2: (a0 + a1)(b0 + b1)) runs on PL
lanes (coop.cuh fe_mul_coop) or one (fe_mul): on three warps (NT = 96) warp
k takes component k of every slot, slot s on lanes s PL ..; on one warp
(NT = 32) unit t // PL takes component unit % 3 of slot unit // 3.  Those
lanes compute every sum of the formula on component k only; the first lane
of each product stores it, the block waits, the lanes of (s, k) store
component k of slot s's Fq2 result (m0 - m1, m2 - m0 - m1, m2 - 2 m1), the
block waits again; the new point's nine components are stored by the lanes
of slots 0 .. 2.  The model below runs that schedule thread for
thread, on the field core of tests/test_torch_chains.py (the PTX carry
chains of csrc/chains.cuh through a PTX interpreter, fe_mul's 64-bit rows
and fe_mul_coop's lanes in Python integers), in both forms (PL =
coop_lanes on 96 threads, PL = 1 on 32) and with both products by 3b
(additions where 3b = k (1 + u), a level of products otherwise).  The lanes
of a product must pass the same operands, and the point must equal bit for
bit the JAX package's ops.curve.group double / add over Fq2 (integers,
tolerance zero), on toy_g2, BN254 G2 and BLS12-381 G2, with components 0,
1, q-1, (q+-1)/2 and words of all ones among the operands.  The compiled
links are held against the plain ops on the card by chip_smoke.py's
device-function phase.
"""

import functools

import numpy as np
import pytest

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu_torch import _build
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import edge_values, field_operands, mont_limbs, to_jax
from tests.test_torch_chains import Core, from_words, words
from tests.test_torch_par import coop_lanes, mul_coop, mul_small

G2_NAMES = ["toy_g2", "bn254_g2", "bls12_381_g2"]
M32 = (1 << 32) - 1
#: the forms of the link: (lanes an Fq product, threads of the block, the
#: product by 3b taken as additions where the curve allows it)
FORMS = {"warps": ("coop", 96, True), "lane": (1, 32, True), "warps_b3_product": ("coop", 96, False)}


class CachedCore(Core):
    """The field core with its results remembered: the threads of a block
    run the same sums on the same values, and the PTX interpreter is slow."""

    def __init__(self, fq):
        super().__init__(fq)
        self.memo = {}

    def _op(self, name, *args):
        key = (name,) + tuple(tuple(a) for a in args)
        if key not in self.memo:
            self.memo[key] = tuple(getattr(Core, name)(self, *map(list, args)))
        return self.memo[key]

    def add(self, a, b):
        return self._op("add", a, b)

    def sub(self, a, b):
        return self._op("sub", a, b)

    def mul(self, a, b):
        return self._op("mul", a, b)


def sel(cond, x, y):
    """fe_select: x where cond, else y."""
    return x if cond else y


def mul_b3k(core, t, k):
    """par.cuh fe_mul_b3k (K2's Fq2 links): 3b t = k (t0 - t1) + k (t0 + t1) u."""
    return (tuple(mul_small(core, core.sub(t[0], t[1]), k)),
            tuple(mul_small(core, core.add(t[0], t[1]), k)))


class Block:
    """One fold block: NT threads, PL lanes a product; an Fq2 element is its
    Karatsuba components (c0, c1, c0 + c1).  On three warps (NT = 96) warp k
    takes component k of every slot, slot s on lanes s PL ..; on one warp
    (NT = 32) unit t // PL takes component unit % 3 of slot unit // 3."""

    def __init__(self, core, PL, NT):
        assert NT in (32, 96)
        self.core, self.PL, self.NT = core, PL, NT
        self.zero = (0,) * core.nw

    def k(self, t):
        """fold2_k: thread t's component."""
        return t // 32 if self.NT == 96 else t // self.PL % 3

    def slot_of(self, t):
        return t % 32 // self.PL if self.NT == 96 else t // self.PL // 3

    def slot(self, t, n):
        """fold2_slot: thread t's slot among n."""
        return min(self.slot_of(t), n - 1)

    def lead(self, t, n):
        """fold2_lead: the first of a product's lanes, its slot below n."""
        return t % self.PL == 0 and self.slot_of(t) < n

    def level(self, ops, n):
        """fold2_level: ops[t] = the Fq operands thread t passes -> the n
        slots' Fq2 results (components) as every thread reads them after."""
        core, PL, zero = self.core, self.PL, self.zero
        m = {}
        for t0 in range(0, self.NT, PL):
            x, y = ops[t0]
            assert all(ops[t0 + r] == (x, y) for r in range(PL)), "lanes of a product disagree"
            assert len({(self.slot(t, n), self.k(t)) for t in range(t0, t0 + PL)}) == 1
            prod = core.mul(x, y) if PL == 1 else tuple(mul_coop(core, list(x), list(y), PL))
            if self.lead(t0, n):
                assert (self.slot(t0, n), self.k(t0)) not in m
                m[(self.slot(t0, n), self.k(t0))] = prod
        r = [[None] * 3 for _ in range(n)]
        for t in range(self.NT):
            k, s = self.k(t), self.slot(t, n)
            m0, m1, m2 = m[(s, 0)], m[(s, 1)], m[(s, 2)]
            x = sel(k == 0, m0, m2)
            y = sel(k == 0, zero, sel(k == 1, m0, m1))
            z = core.sub(core.sub(x, y), m1)
            if self.lead(t, n):
                assert r[s][k] is None
                r[s][k] = z
        return [tuple(v) for v in r]

    def twist(self, v, k):
        """fold2_twist: component k of (1 + u) v."""
        core = self.core
        if k == 1:
            return v[2]
        return core.sub(v[0], v[1]) if k == 0 else core.add(v[0], v[0])

    def b3(self, b3, k):
        """fold2_b3: component k of 3b."""
        return sel(k == 2, self.core.add(b3[0], b3[1]), sel(k == 1, b3[1], b3[0]))

    def out(self, outs):
        """The nine stores of a link's last phase (slot c < 3 stores
        component k of coordinate c) -> the point."""
        pt = [[None] * 3 for _ in range(3)]
        for t, v in enumerate(outs):
            if self.lead(t, 3):
                assert pt[self.slot_of(t)][self.k(t)] is None
                pt[self.slot_of(t)][self.k(t)] = v
        return tuple(tuple(c) for c in pt)

    def double(self, p, b3k, b3):
        """fold2_double_body on point p (X, Y, Z), each by its components."""
        core, NT = self.core, self.NT
        ks = [self.k(t) for t in range(NT)]
        ops = []
        for t, k in enumerate(ks):
            s = self.slot(t, 4)
            ops.append((p[0 if s == 3 else 2 if s == 2 else 1][k], p[1 if s in (0, 3) else 2][k]))
        r = self.level(ops, 4)
        t0 = [r[0][k] for k in ks]
        g = [r[3 if self.slot(t, 4) == 0 else 1][k] for t, k in enumerate(ks)]
        if b3k:
            t2b = [tuple(mul_small(core, self.twist(r[2], k), b3k)) for k in ks]
        else:
            r3 = self.level([(self.b3(b3, k), r[2][k]) for k in ks], 1)
            t2b = [r3[0][k] for k in ks]
        ops = []
        for t in range(NT):
            s = self.slot(t, 4)
            u = core.add(t2b[t], t2b[t])
            u = core.sub(t0[t], core.add(u, t2b[t]))  # t0'
            x = sel(s == 3, g[t], sel(s == 1, t2b[t], u))
            y = core.add(t0[t], t2b[t])  # Y3s
            z8 = core.add(t0[t], t0[t])
            z8 = core.add(z8, z8)
            z8 = core.add(z8, z8)
            ops.append((x, sel(s == 0, g[t], sel(s == 2, y, z8))))
        r = self.level(ops, 4)
        outs = []
        for t, k in enumerate(ks):
            c = min(self.slot_of(t), 2)
            x = r[0 if c == 0 else 1 if c == 1 else 3][k]
            y = sel(c == 2, self.zero, r[0 if c == 0 else 2][k])
            outs.append(core.add(x, y))
        return self.out(outs)

    def add(self, p, q, b3k, b3):
        """fold2_add_body: p + q."""
        core, NT, zero = self.core, self.NT, self.zero
        ks = [self.k(t) for t in range(NT)]
        ops = []
        for t, k in enumerate(ks):
            s = self.slot(t, 6)
            i1, i2 = (1 if s in (1, 4) else 2 if s == 2 else 0), (1 if s == 3 else 2)
            ops.append((core.add(p[i1][k], sel(s >= 3, p[i2][k], zero)),
                        core.add(q[i1][k], sel(s >= 3, q[i2][k], zero))))
        r = self.level(ops, 6)
        mid = []
        for t, k in enumerate(ks):
            s = self.slot(t, 6)
            x = core.sub(core.sub(r[3][k], r[0][k]), r[1][k])  # t3'
            y = x
            f = core.sub(core.sub(r[4][k], r[1][k]), r[2][k])  # t4'
            x, y = sel(s == 1, f, x), sel(s == 4, f, y)
            f = core.add(core.add(r[0][k], r[0][k]), r[0][k])  # 3 t0
            x, y = sel(s == 5, f, x), sel(s == 3, f, y)
            yr = core.sub(core.sub(r[5][k], r[0][k]), r[2][k])  # Yr'
            mid.append([s, k, x, y, yr, r[1][k]])
        if b3k:
            yk = [None] * 3  # sh.y, stored by slot 0
            for t, m in enumerate(mid):
                if self.lead(t, 1):
                    assert yk[m[1]] is None
                    yk[m[1]] = m[4]
            scaled = [(tuple(mul_small(core, self.twist(r[2], k), b3k)),
                       tuple(mul_small(core, self.twist(yk, k), b3k))) for k in ks]
        else:  # slot 0 of the level 3b t2, slot 1 3b Yr'
            r3 = self.level([(self.b3(b3, k), sel(self.slot(t, 2) == 0, r[2][k], mid[t][4]))
                             for t, k in enumerate(ks)], 2)
            scaled = [(r3[0][k], r3[1][k]) for k in ks]
        ops = []
        for (s, k, x, y, _, t1), (t2b, yb) in zip(mid, scaled):
            x, y = sel(s == 3, yb, x), sel(s == 1, yb, y)
            t1l, z3l = core.sub(t1, t2b), core.add(t1, t2b)
            x, y = sel(s == 2, t1l, x), sel(s == 0, t1l, y)
            x, y = sel(s == 4, z3l, x), sel(s == 2, z3l, y)
            ops.append((x, y))
        r = self.level(ops, 6)
        outs = []
        for t, k in enumerate(ks):
            c = min(self.slot_of(t), 2)
            x, y = r[2 * c][k], r[2 * c + 1][k]
            outs.append(sel(c == 0, core.sub(x, y), core.add(x, y)))
        return self.out(outs)


def kform(core, p):
    """fold2_load: (c0, c1) coordinates -> their components."""
    return tuple((c0, c1, core.add(c0, c1)) for c0, c1 in p)


def from_kform(core, p):
    """fold2_store: the components -> (c0, c1); the third must be their sum."""
    assert all(v[2] == core.add(v[0], v[1]) for v in p)
    return tuple((v[0], v[1]) for v in p)


def _points(port, seed=11):
    """Points of any coordinates (the formulas are identities, so the JAX
    ops and the links compute the same values): components 0, 1, q-1,
    (q+-1)/2 and words of all ones below the top word, then random; 3 Fq2
    elements a point.  Montgomery-form integers."""
    q, nw = port.fq.q, port.fq.n_words
    comps = edge_values(q) + [((1 << (32 * (nw - 1))) - 1) % q]
    rng = np.random.default_rng(seed)
    rand = lambda: int.from_bytes(rng.bytes(64), "little") % q
    elems = [(x, y) for x in comps for y in comps[::2]] + [(rand(), rand()) for _ in range(6)]
    return [tuple(elems[(3 * i + j) % len(elems)] for j in range(3)) for i in range(len(elems) // 3)]


def _jax_coords(port, pts):
    L = port.fq.n_limbs
    return tuple(
        to_jax(np.concatenate([ints_to_limbs([p[j][0] for p in pts], L),
                               ints_to_limbs([p[j][1] for p in pts], L)]))
        for j in range(3))


def _from_jax(port, res):
    L = port.fq.n_limbs
    cols = [limbs_to_ints(np.asarray(c)[:L]) for c in res], [limbs_to_ints(np.asarray(c)[L:]) for c in res]
    n = len(cols[0][0])
    return [tuple((cols[0][j][i], cols[1][j][i]) for j in range(3)) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _reference(name, op):
    """The JAX package's double (of each point) or add (each point plus the
    next) over Fq2, once per curve and op: jit-compiled per shape."""
    port, ref = getattr(port_curves, name), getattr(ref_curves, name)
    pts = _points(port)
    P = _jax_coords(port, pts)
    if op == "double":
        return pts, _from_jax(port, ref_group.double(ref, P))
    Q = _jax_coords(port, pts[1:] + pts[:1])
    return pts, _from_jax(port, ref_group.add(ref, P, Q))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("op", ["double", "add"])
@pytest.mark.parametrize("name", G2_NAMES)
def test_fold2_links_match_reference(name, op, form):
    port = getattr(port_curves, name)
    fq, nw = port.fq, port.fq.n_words
    pl, NT, additions = FORMS[form]
    PL = coop_lanes(nw) if pl == "coop" else pl
    b3k = _build.fold_b3k(port) if additions else 0
    assert b3k == (12 if name == "bls12_381_g2" and additions else 0)
    b3 = tuple(tuple(words(fq.to_mont_int(c), nw)) for c in port.b3)
    core = CachedCore(fq)
    block = Block(core, PL, NT)
    pts, want = _reference(name, op)
    K = lambda p: kform(core, tuple((tuple(words(c[0], nw)), tuple(words(c[1], nw))) for c in p))
    for i, p in enumerate(pts):
        if op == "double":
            got = block.double(K(p), b3k, b3)
        else:
            got = block.add(K(p), K(pts[(i + 1) % len(pts)]), b3k, b3)
        got = tuple((from_words(c[0]), from_words(c[1])) for c in from_kform(core, got))
        assert got == want[i], (name, op, form, i)


def test_b3_small_fq2():
    """k where 3b = k (1 + u): 12 on BLS12-381 G2 (b = 4 + 4u); BN254 G2
    and toy_g2 (b = 4932 + 6901u) are refused and keep their level of
    products (fold_b3k 0); over Fq the helper refuses too."""
    assert _build.b3_small_fq2(port_curves.bls12_381_g2) == 12
    assert _build.fold_b3k(port_curves.bls12_381_g2) == 12
    for name in ("bn254_g2", "toy_g2", "toy_bn_g2"):
        with pytest.raises(NotImplementedError, match="1 \\+ u"):
            _build.b3_small_fq2(getattr(port_curves, name))
        assert _build.fold_b3k(getattr(port_curves, name)) == 0
    with pytest.raises(NotImplementedError):
        _build.b3_small_fq2(port_curves.bls12_381)


def test_b3_additions_equal_the_product_by_3b():
    """fe_mul_b3k's additions against the JAX package's Fq2 product by the
    constant 3b (field2.cuh fe_b3), bit for bit, on edge and random
    elements of BLS12-381 G2's Fq2."""
    name = "bls12_381_g2"
    port, ref = getattr(port_curves, name), getattr(ref_curves, name)
    fq, nw, L = port.fq, port.fq.n_words, port.fq.n_limbs
    elems = [p[j] for p in _points(port, seed=5) for j in range(3)]
    b3 = [tuple(fq.to_mont_int(c) for c in port.b3)] * len(elems)
    flat = lambda es: to_jax(np.concatenate([ints_to_limbs([e[0] for e in es], L),
                                             ints_to_limbs([e[1] for e in es], L)]))
    want = np.asarray(ref.field.mul(flat(b3), flat(elems)))
    want = list(zip(limbs_to_ints(want[:L]), limbs_to_ints(want[L:])))
    core = CachedCore(fq)
    block = Block(core, 4, 96)
    k = _build.b3_small_fq2(port)
    for e, w in zip(elems, want):
        v = kform(core, ((tuple(words(e[0], nw)), tuple(words(e[1], nw))),))[0]
        got = [tuple(mul_small(core, block.twist(v, j), k)) for j in range(3)]  # fold2.cuh
        assert (from_words(got[0]), from_words(got[1])) == w
        assert got[2] == core.add(got[0], got[1])
        got = mul_b3k(core, (list(v[0]), list(v[1])), k)  # par.cuh fe_mul_b3k
        assert (from_words(got[0]), from_words(got[1])) == w


def fe_sqr(core, a):
    """field.cuh fe_sqr: cross products once, doubled, the diagonal added,
    then NW reduction rows with the carry of each row's top word kept for
    the next; the bounds the kernel relies on asserted."""
    nw = core.nw
    t = [0] * (2 * nw)
    for i in range(nw - 1):
        c = 0
        for j in range(i + 1, nw):
            s = a[i] * a[j] + t[i + j] + c
            assert s <= (1 << 64) - 1
            t[i + j], c = s & M32, s >> 32
        t[i + nw] = c
    assert t[2 * nw - 1] >> 31 == 0  # the double fits
    t = [((t[i] << 1) | (t[i - 1] >> 31 if i else 0)) & M32 for i in range(2 * nw)]
    c = 0
    for i in range(nw):
        d = a[i] * a[i]
        s = t[2 * i] + (d & M32) + c
        t[2 * i] = s & M32
        s = t[2 * i + 1] + (d >> 32) + (s >> 32)
        t[2 * i + 1], c = s & M32, s >> 32
    assert c == 0
    hi = 0
    for i in range(nw):
        m = (t[i] * core.np32) & M32
        s = m * core.q[0] + t[i]
        assert s & M32 == 0
        c = s >> 32
        for j in range(1, nw):
            s = m * core.q[j] + t[i + j] + c
            t[i + j], c = s & M32, s >> 32
        s = t[i + nw] + c + hi
        t[i + nw], hi = s & M32, s >> 32
    assert hi == 0  # the top half is below 2q < R
    return core.reduce_once(t[nw:])


@pytest.mark.parametrize("name", ["toy", "bn254", "bls12_381"])
def test_fe_sqr_matches_reference(name):
    """fe_sqr against the JAX package's mont.mont_square (the TPU kernel's
    function), every edge value and random ones, bit for bit."""
    ref, port = getattr(ref_curves, name), getattr(port_curves, name)
    a, _ = field_operands(ref.q, 24, seed=41)
    la = mont_limbs(ref.fq, a)
    want = limbs_to_ints(np.asarray(ref_mont.mont_square(ref.fq, to_jax(la))))
    core = Core(port.fq)
    nw = port.fq.n_words
    for x, w in zip(limbs_to_ints(la), want):
        assert from_words(fe_sqr(core, words(x, nw))) == w, (name, x)
