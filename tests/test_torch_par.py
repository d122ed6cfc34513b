"""PyTorch port, the window fold's group ops (csrc/par.cuh) and its
cooperative product (csrc/coop.cuh) modelled lane for lane on the CPU.

par.cuh runs one point on a group of 8 PL lanes of a warp: the PL lanes of
product slot s of the group compute product s of a level (picked by the
slot's index), the group gathers the level's products with a width-8 PL
__shfl_sync, and every lane finishes the level's sums itself; the product
by 3b is additions (fe_mul_small).  A product takes one lane (PL = 1,
fe_mul) or is shared by PL lanes (fe_mul_coop: each lane owns NW / PL
consecutive words of a, q and the accumulator, m broadcast from the first
lane, the shift by __shfl_down_sync, each lane's carry kept local until the
words and carries are gathered and added in one chain).  The model below
runs those schedules for a whole warp, each lane on its own copy of the
registers, on the field core of tests/test_torch_chains.py (the PTX carry
chains of csrc/chains.cuh through a PTX interpreter, fe_mul's 64-bit rows
in Python integers).  Every lane of a group must end with the same value,
equal bit for bit to the JAX package's ops.field.mont / ops.curve.group
(integers, tolerance zero), on the toy curve, BN254 and BLS12-381, with
operands 0, 1, q-1, (q+-1)/2 and words of all ones among them.  The
compiled device functions are held against the plain ops on the card by
chip_smoke.py's device-function phase.
"""

import numpy as np
import pytest

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.field import mont as ref_mont
from zprize_wasm_msm_tpu_torch import _build
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import edge_values, to_jax
from tests.test_torch_chains import Core, chain_add, from_words, words

NAMES = ["toy", "bn254", "bls12_381"]
WARP = 32
M32 = (1 << 32) - 1


def coop_lanes(nw):
    """csrc/coop.cuh coop_lanes<NW>()."""
    return 4 if nw % 4 == 0 else 2 if nw % 2 == 0 else 1


def mul_coop(core, a, b, PL):
    """fe_mul_coop on PL lanes; returns what every lane ends with."""
    nw = core.nw
    K = nw // PL
    A = [a[l * K : (l + 1) * K] for l in range(PL)]
    Q = [core.q[l * K : (l + 1) * K] for l in range(PL)]
    w = [[0] * K for _ in range(PL)]
    c = [0] * PL
    for i in range(nw):
        for l in range(PL):
            s = 0
            for j in range(K):
                s = A[l][j] * b[i] + w[l][j] + (s >> 32)
                assert s <= (1 << 64) - 1
                w[l][j] = s & M32
            c[l] += s >> 32
        m = (w[0][0] * core.np32) & M32  # __shfl_sync from the first lane
        for l in range(PL):
            s = 0
            for j in range(K):
                s = Q[l][j] * m + w[l][j] + (s >> 32)
                w[l][j] = s & M32
            c[l] += s >> 32
        assert w[0][0] == 0
        incoming = [w[l + 1][0] if l + 1 < PL else 0 for l in range(PL)]  # __shfl_down_sync
        for l in range(PL):
            top = incoming[l] + c[l]
            w[l] = w[l][1:] + [top & M32]
            c[l] = top >> 32
            assert c[l] < 1 << 64
    assert c[PL - 1] == 0  # the accumulator is below 2q < R
    t = [w[J // K][J % K] for J in range(nw)]
    add = [0] * nw
    for l in range(PL - 1):
        add[(l + 1) * K] = c[l] & M32
        if (l + 1) * K + 1 < nw:
            add[(l + 1) * K + 1] = c[l] >> 32
    return core.reduce_once(chain_add(nw, t, add))


def mul_small(core, a, k):
    """fe_mul_small: MSB-first doubling and adding with fe_add."""
    acc = a
    for i in range(k.bit_length() - 2, -1, -1):
        acc = core.add(acc, acc)
        if (k >> i) & 1:
            acc = core.add(acc, a)
    return acc


def pick(s, *vals):
    """fe_pick4 / fe_pick6: v_s, the last value for s beyond the list."""
    return vals[min(s, len(vals) - 1)]


def level(core, PL, operands):
    """One level of products: operands[lane] = (a, b) that lane picked.  The
    PL lanes of a slot share one product (every lane of the slot picks the
    same operands); returns, per lane, the value read from slot j of its
    group for j = 0 .. 7."""
    prod = []
    for lane in range(0, WARP, PL):
        a, b = operands[lane]
        assert all(operands[lane + r] == (a, b) for r in range(PL))
        prod.append(core.mul(a, b) if PL == 1 else mul_coop(core, a, b, PL))
    G = 8 * PL
    return [[prod[((lane // G) * G + j * PL) // PL] for j in range(8)] for lane in range(WARP)]


def double_par(core, k3, PL, pts):
    """pt_double_par on a warp: pts[lane] is that lane's copy of its point."""
    ops = []
    for lane, (X, Y, Z) in enumerate(pts):
        s = ((lane % (8 * PL)) // PL) & 3
        ops.append((pick(s, Y, Y, Z, X), pick(s, Y, Z, Z, Y)))
    got = level(core, PL, ops)
    mid, ops = [], []
    for lane in range(WARP):
        t0, t1, t2, txy = got[lane][:4]
        Z8 = core.add(t0, t0)
        Z8 = core.add(Z8, Z8)
        Z8 = core.add(Z8, Z8)
        t2b = mul_small(core, t2, k3)
        Y3s = core.add(t0, t2b)
        u = core.add(t2b, t2b)
        u = core.add(u, t2b)
        t0p = core.sub(t0, u)
        s = ((lane % (8 * PL)) // PL) & 3
        ops.append((pick(s, t0p, t2b, t0p, t1), pick(s, txy, Z8, Y3s, Z8)))
    got = level(core, PL, ops)
    return [(core.add(r[0], r[0]), core.add(r[1], r[2]), r[3]) for r in got]


def add_par(core, k3, PL, ps, qs):
    """pt_add_par on a warp: ps[lane] + qs[lane]."""
    zero = [0] * core.nw
    ops = []
    for lane, ((X1, Y1, Z1), (X2, Y2, Z2)) in enumerate(zip(ps, qs)):
        s = (lane % (8 * PL)) // PL
        a = core.add(pick(s, X1, Y1, Z1, X1, Y1, X1), pick(s, zero, zero, zero, Y1, Z1, Z1))
        b = core.add(pick(s, X2, Y2, Z2, X2, Y2, X2), pick(s, zero, zero, zero, Y2, Z2, Z2))
        ops.append((a, b))
    got = level(core, PL, ops)
    ops = []
    for lane in range(WARP):
        t0, t1, t2, t3, t4, Yr = got[lane][:6]
        t3 = core.sub(core.sub(t3, t0), t1)
        t4 = core.sub(core.sub(t4, t1), t2)
        Yr = core.sub(core.sub(Yr, t0), t2)
        t2b = mul_small(core, t2, k3)
        Yb = mul_small(core, Yr, k3)
        t0_3 = core.add(core.add(t0, t0), t0)
        Z3l = core.add(t1, t2b)
        t1l = core.sub(t1, t2b)
        s = (lane % (8 * PL)) // PL
        ops.append((pick(s, t3, t4, t1l, Yb, Z3l, t0_3), pick(s, t1l, Yb, Z3l, t0_3, t4, t3)))
    got = level(core, PL, ops)
    return [(core.sub(r[0], r[1]), core.add(r[2], r[3]), core.add(r[4], r[5])) for r in got]


def _operands(name, seed=7):
    """Coordinate values (Montgomery words as stored): the edge values, words
    of all ones (long carry ripples), random; 3 n values for n points."""
    port = getattr(port_curves, name)
    q, nw = port.fq.q, port.fq.n_words
    rng = np.random.default_rng(seed)
    vals = edge_values(q) + [
        v % q
        for v in (
            (1 << (32 * (nw - 1))) - 1,  # every word but the top one all ones
            q - (1 << 32),  # q with its low word's carry borrowed
            1 << (32 * nw - 2),
        )
    ]
    vals += [int.from_bytes(rng.bytes(48), "little") % q for _ in range(3 * 8 - len(vals))]
    return port, vals


def _warps(values, n_points, PL):
    """Points (X, Y, Z) from consecutive values, 32 / 8 PL to a warp, each
    replicated on the lanes of its group."""
    G = 8 * PL
    per = WARP // G
    pts = [tuple(values[3 * i + j] for j in range(3)) for i in range(n_points)]
    return [
        [pts[min(w * per + lane // G, n_points - 1)] for lane in range(WARP)]
        for w in range(-(-n_points // per))
    ]


def _ref_points(ref, pts, nw):
    limbs = [ints_to_limbs([p[j] for p in pts], ref.fq.n_limbs) for j in range(3)]
    return to_jax(tuple(limbs))


def _group_results(out, n_points, PL):
    """Lane outputs of each warp -> one point per group; every lane of a
    group must agree."""
    G = 8 * PL
    res = []
    for w, lanes in enumerate(out):
        for g in range(WARP // G):
            group = lanes[g * G : (g + 1) * G]
            assert all(p == group[0] for p in group), "lanes of one group disagree"
            if w * (WARP // G) + g < n_points:
                res.append(group[0])
    return res


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("op", ["double", "add"])
@pytest.mark.parametrize("coop", [False, True])
def test_par_group_ops_match_reference(name, op, coop):
    port, vals = _operands(name)
    ref = getattr(ref_curves, name)
    core = Core(port.fq)
    nw = port.fq.n_words
    PL = coop_lanes(nw) if coop else 1
    n = len(vals) // 3
    w_vals = [words(v, nw) for v in vals]
    ps = _warps(w_vals, n, PL)
    k3 = _build.b3_small(port)
    P = _ref_points(ref, [tuple(vals[3 * i : 3 * i + 3]) for i in range(n)], nw)
    if op == "double":
        out = [double_par(core, k3, PL, lanes) for lanes in ps]
        want = ref_group.double(ref, P)
    else:
        qs = _warps(w_vals[3:] + w_vals[:3], n, PL)  # q = the next point
        out = [add_par(core, k3, PL, a, b) for a, b in zip(ps, qs)]
        vq = vals[3:] + vals[:3]
        want = ref_group.add(ref, P, _ref_points(ref, [tuple(vq[3 * i : 3 * i + 3]) for i in range(n)], nw))
    got = _group_results(out, n, PL)
    want = [limbs_to_ints(np.asarray(c)) for c in want]
    for i, p in enumerate(got):
        assert tuple(from_words(c) for c in p) == tuple(want[j][i] for j in range(3)), (name, op, i)


@pytest.mark.parametrize("name", NAMES)
def test_coop_product_matches_reference(name):
    """fe_mul_coop on every pair of the operands against mont_mul."""
    port, vals = _operands(name, seed=9)
    ref = getattr(ref_curves, name)
    core = Core(port.fq)
    nw = port.fq.n_words
    a = [x for x in vals for _ in vals]
    b = [y for _ in vals for y in vals]
    L = port.fq.n_limbs
    want = limbs_to_ints(np.asarray(ref_mont.mont_mul(
        ref.fq, to_jax(ints_to_limbs(a, L)), to_jax(ints_to_limbs(b, L)))))
    PL = coop_lanes(nw)
    assert PL == {"toy": 2, "bn254": 4, "bls12_381": 4}[name]
    for x, y, z in zip(a, b, want):
        assert from_words(mul_coop(core, words(x, nw), words(y, nw), PL)) == z


@pytest.mark.parametrize("name", NAMES)
def test_mul_small_matches_product_by_3b(name):
    port, vals = _operands(name, seed=8)
    ref = getattr(ref_curves, name)
    core = Core(port.fq)
    nw = port.fq.n_words
    b3 = ints_to_limbs([port.fq.to_mont_int(3 * port.b)] * len(vals), port.fq.n_limbs)
    want = limbs_to_ints(np.asarray(ref_mont.mont_mul(
        ref.fq, to_jax(b3), to_jax(ints_to_limbs(vals, port.fq.n_limbs)))))
    k3 = _build.b3_small(port)
    assert k3 == {"toy": 9, "bn254": 9, "bls12_381": 12}[name]
    for v, w in zip(vals, want):
        assert from_words(mul_small(core, words(v, nw), k3)) == w


def test_b3_small_refuses_curves_it_cannot_take():
    with pytest.raises(NotImplementedError):
        _build.b3_small(port_curves.bls12_381_g2)
