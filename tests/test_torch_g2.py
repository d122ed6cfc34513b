"""PyTorch port, G2: tower.Fq2, the group ops over it, and the MSM's plain
stages over Fq2 against the JAX package — the same numpy inputs through both.

Field and group ops are compared bit for bit (canonical 16-bit limbs,
tolerance zero); bucket sums, window sums and MSM results as affine points,
because two bucket engines add the same points in different orders.  On CPU
tensors the port's wrappers run their plain PyTorch versions; the CUDA
kernels over Fq2 are held against those on the card by chip_smoke.py.  The
level-parallel Fq2 group ops of csrc/par.cuh have a slot-for-slot CPU model
here.  The JAX package's MSM stages are jit-compiled on first use, so each
curve's JAX side runs once, in a module fixture, at one small shape.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zprize_wasm_msm_tpu.models import curves as ref_curves
from zprize_wasm_msm_tpu.ops.curve import group as ref_group
from zprize_wasm_msm_tpu.ops.msm import pippenger as ref_pippenger
from zprize_wasm_msm_tpu.ops.msm import windows as ref_windows

import zprize_wasm_msm_tpu_torch as ZT
from zprize_wasm_msm_tpu_torch import _build
from zprize_wasm_msm_tpu_torch.models import curves as port_curves
from zprize_wasm_msm_tpu_torch.oracle import F2, Curve as OracleCurve
from zprize_wasm_msm_tpu_torch.ops.curve import group
from zprize_wasm_msm_tpu_torch.ops.field.tower import Fq2
from zprize_wasm_msm_tpu_torch.ops.msm import pippenger, pl_bucket, pl_reduce, windows
from zprize_wasm_msm_tpu_torch.utils.convert import from_reference, pack_words, to_reference
from zprize_wasm_msm_tpu_torch.utils.limbs import ints_to_limbs, limbs_to_ints

from tests._torch_helpers import assert_same, mont_limbs, to_jax, to_torch, torch_np

G2_CURVES = ("toy_g2", "toy_bn_g2", "bn254_g2", "bls12_381_g2")
#: the MSM stages' shape: 12 points, c = 3 (W = 8 windows of B = 4), 2 lanes
N, C, T, BITS = 12, 3, 2, 24


def curves_of(name):
    return getattr(ref_curves, name), getattr(port_curves, name)


def oracle_of(curve):
    return OracleCurve(q=curve.q, a=0, b=curve.b, r=curve.r, gx=curve.gx, gy=curve.gy,
                       field=F2(curve.q, curve.nr))


def fq2_np(fq, pairs):
    """(c0, c1) standard-domain pairs -> (2L, n) uint32 Montgomery limbs."""
    return np.concatenate([mont_limbs(fq, [p[0] for p in pairs]),
                           mont_limbs(fq, [p[1] for p in pairs])])


def fq2_host(fq, limbs):
    """(2L, n) Montgomery limbs -> standard-domain pairs."""
    a = np.asarray(limbs).reshape(2 * fq.n_limbs, -1)
    c0, c1 = limbs_to_ints(a[: fq.n_limbs]), limbs_to_ints(a[fq.n_limbs :])
    return [(fq.from_mont_int(x), fq.from_mont_int(y)) for x, y in zip(c0, c1)]


def operands(fq, n_random, seed):
    """Every ordered pair of edge elements (components 0, 1, q-1, (q+-1)/2
    and all-ones words below the top word), then random elements."""
    q = fq.q
    comps = [0, 1, q - 1, q // 2, q // 2 + 1, ((1 << (32 * (fq.n_words - 1))) - 1) % q]
    edges = [(x, y) for x in comps for y in comps]
    rng = np.random.default_rng(seed)
    rand = lambda: int.from_bytes(rng.bytes(64), "little") % q
    a = [u for u in edges for _ in edges[:6]] + [(rand(), rand()) for _ in range(n_random)]
    b = [v for _ in edges for v in edges[:6]] + [(rand(), rand()) for _ in range(n_random)]
    return fq2_np(fq, a), fq2_np(fq, b), a, b


def g2_points(curve, n, seed):
    rng = np.random.default_rng(seed)
    oc = oracle_of(curve)
    return [oc.mul(oc.g, int(rng.integers(1, min(curve.r, 1 << 30)))) for _ in range(n)]


def affine_g2(curve, pts):
    zero = (0, 0)
    return (fq2_np(curve.fq, [zero if p is None else p[0] for p in pts]),
            fq2_np(curve.fq, [zero if p is None else p[1] for p in pts]))


def host_g2(curve, x, y):
    xs, ys = fq2_host(curve.fq, x), fq2_host(curve.fq, y)
    return [None if (u == (0, 0) and v == (0, 0)) else (u, v) for u, v in zip(xs, ys)]


def port_affine(curve, res):
    flat = tuple(c.reshape(c.shape[0], -1) for c in res)
    x, y = torch_np(group.to_affine(curve, flat))
    return host_g2(curve, x, y)


def ref_affine(port, res):
    """A JAX projective batch -> python affine points, through the port's
    to_affine (the same limbs, the same field: tower.Fq2's inversion is held
    against the JAX package's above; a JAX to_affine would compile once per
    shape)."""
    return port_affine(port, tuple(to_torch(np.asarray(c)) for c in res))


# ---------------------------------------------------------------------------
# tower.Fq2 against the JAX package's tower.Fq2, bit for bit
# ---------------------------------------------------------------------------

BINARY = ("add", "sub", "mul")
UNARY = ("neg", "conjugate", "square", "norm")


@pytest.mark.parametrize("name", G2_CURVES[:1] + G2_CURVES[2:])
@pytest.mark.parametrize("op", BINARY + UNARY)
def test_fq2_op_matches_reference(name, op):
    ref, port = curves_of(name)
    F, RF = port.field, ref.field
    assert isinstance(F, Fq2) and F.elem_len == RF.elem_len == 2 * port.fq.n_limbs
    a, b, _, _ = operands(port.fq, 12, seed=3)
    if op in BINARY:
        got = getattr(F, op)(to_torch(a), to_torch(b))
        want = getattr(RF, op)(to_jax(a), to_jax(b))
    else:
        got, want = getattr(F, op)(to_torch(a)), getattr(RF, op)(to_jax(a))
    assert_same(got, want, op)


@pytest.mark.parametrize("name", G2_CURVES[:1] + G2_CURVES[2:])
def test_fq2_mul_many_predicates_and_constants_match_reference(name):
    ref, port = curves_of(name)
    F, RF = port.field, ref.field
    a, b, _, _ = operands(port.fq, 6, seed=4)
    ta, tb, ja, jb = to_torch(a), to_torch(b), to_jax(a), to_jax(b)
    for g, w in zip(F.mul_many([(ta, tb), (tb, ta), (ta, ta)]), RF.mul_many([(ja, jb), (jb, ja), (ja, ja)])):
        assert_same(g, w)
    assert_same(F.is_zero(ta), RF.is_zero(ja))
    assert_same(F.eq(ta, tb), RF.eq(ja, jb))
    assert_same(F.eq(ta, ta), RF.eq(ja, ja))
    mask = np.arange(a.shape[1]) % 3 == 0
    assert_same(F.select(torch.as_tensor(mask), ta, tb), RF.select(to_jax(mask), ja, jb))
    assert_same(F.one((3,)), RF.one((3,)))
    assert_same(F.zeros((2, 2)), RF.zeros((2, 2)))
    assert_same(F.const(port.gx, (2,)), RF.const(ref.gx, (2,)))
    assert_same(F.const(5, (2,)), RF.const(5, (2,)))
    assert F.to_host(ta) == RF.to_host(ja)
    with pytest.raises(TypeError):
        F.const((1, 2, 3))


def test_fq2_inverse_matches_reference_toy():
    ref, port = curves_of("toy_g2")
    a, _, _, _ = operands(port.fq, 20, seed=5)
    F, RF = port.field, ref.field
    assert_same(F.inverse(to_torch(a)), RF.inverse(to_jax(a)))
    assert_same(F.batch_inverse(to_torch(a)), RF.batch_inverse(to_jax(a)))


@pytest.mark.parametrize("name", ["bn254_g2", "bls12_381_g2"])
def test_fq2_inverse_against_host(name):
    _, port = curves_of(name)
    a, _, pairs, _ = operands(port.fq, 6, seed=6)
    f2 = F2(port.q, port.nr)
    want = [(0, 0) if f2.is_zero(p) else f2.inv(p) for p in pairs]
    F = port.field
    assert fq2_host(port.fq, torch_np(F.batch_inverse(to_torch(a)))) == want
    assert fq2_host(port.fq, torch_np(F.inverse(to_torch(a[:, :8])))) == want[:8]


# ---------------------------------------------------------------------------
# group ops over Fq2 against the JAX package's group, bit for bit
# ---------------------------------------------------------------------------

def _g2_cases(port):
    oc = oracle_of(port)
    base = g2_points(port, 5, seed=21)
    pts = base + [None, base[0], base[1], None]
    qts = base[1:] + base[:1] + [base[3], base[0], oc.neg(base[1]), None]
    return oc, pts, qts


# the JAX group ops are jit-compiled per curve and shape (~10 s each at
# BLS12-381's width on the CPU): they run on toy_g2; every G2 curve's group
# ops are also held against the level-parallel models and the oracle below
@pytest.mark.parametrize("name", ["toy_g2"])
@pytest.mark.parametrize("op", ["add", "add_mixed", "double"])
def test_g2_group_op_matches_reference(name, op):
    ref, port = curves_of(name)
    _, pts, qts = _g2_cases(port)
    PA, QA = affine_g2(port, pts), affine_g2(port, qts)
    # projective operands that are not lifted affine points
    tP = group.double(port, group.add(port, group.from_affine(port, to_torch(PA)),
                                      group.from_affine(port, to_torch(QA))))
    P = torch_np(tP)
    if op == "add":
        got = group.add(port, tP, group.from_affine(port, to_torch(QA)))
        want = ref_group.add(ref, to_jax(P), ref_group.from_affine(ref, to_jax(QA)))
    elif op == "add_mixed":
        got = group.add_mixed(port, tP, to_torch(QA))
        want = ref_group.add_mixed(ref, to_jax(P), to_jax(QA))
    else:
        got, want = group.double(port, tP), ref_group.double(ref, to_jax(P))
    assert_same(got, want, op)


@pytest.mark.parametrize("name", ["toy_g2", "toy_bn_g2"])
def test_g2_group_law_times_scalar_and_in_curve_against_oracle(name):
    _, port = curves_of(name)
    oc, pts, qts = _g2_cases(port)
    P = group.from_affine(port, to_torch(affine_g2(port, pts)))
    Q = group.from_affine(port, to_torch(affine_g2(port, qts)))
    assert port_affine(port, group.add(port, P, Q)) == [oc.add(p, q) for p, q in zip(pts, qts)]
    assert port_affine(port, group.double(port, P)) == [oc.add(p, p) for p in pts]
    assert bool(group.in_curve(port, P).all())
    ks = [3, 0, 1, 12345, 77, 9, 2, 5, 1]
    R = group.times_scalar(port, P, to_torch(ints_to_limbs(ks, 2)))
    assert port_affine(port, R) == [oc.mul(p, k) if p else None for p, k in zip(pts, ks)]
    g = group.generator(port, (1,))
    assert port_affine(port, g) == [oc.g]


# ---------------------------------------------------------------------------
# csrc/par.cuh's level-parallel Fq2 doubling and addition, slot for slot
# ---------------------------------------------------------------------------
# A group of 8 PL lanes holds one point; slot s = lane // PL computes one
# Fq2 product of each level, and a gather (__shfl_sync from lane j PL) reads
# slot j's value.  These models run the kernel's index choices on the plain
# Fq2 ops; every slot's value is one element, so the gather is an index.

def double_par_model(curve, p):
    F = curve.field
    b3 = F.const(curve.b3, (1,) * (p[0].ndim - 1))
    slots = [s & 3 for s in range(8)]
    m = [F.mul(p[1 if s != 3 and s != 2 else 0 if s == 3 else 2], p[1 if s in (0, 3) else 2])
         for s in slots]
    out = []
    for s in slots:
        t2b = F.mul(b3, m[2])
        t0, g = m[0], m[3 if s == 0 else 1]
        u = F.sub(t0, F.add(F.add(t2b, t2b), t2b))
        a = g if s == 3 else t2b if s == 1 else u
        y3s = F.add(t0, t2b)
        z8 = F.add(t0, t0)
        z8 = F.add(z8, z8)
        z8 = F.add(z8, z8)
        b = g if s == 0 else y3s if s == 2 else z8
        out.append(F.mul(a, b))
    return (F.add(out[0], out[0]), F.add(out[1], out[2]), out[3])


def add_par_model(curve, p, q):
    F = curve.field
    b3 = F.const(curve.b3, (1,) * (p[0].ndim - 1))
    slots = [min(s, 5) for s in range(8)]
    m = []
    for s in slots:
        i1 = 1 if s in (1, 4) else 2 if s == 2 else 0
        i2 = 1 if s == 3 else 2
        a, b = p[i1], q[i1]
        if s >= 3:
            a, b = F.add(a, p[i2]), F.add(b, q[i2])
        m.append(F.mul(a, b))
    v = []
    for s, ms in zip(slots, m):
        f, g = m[1 if s == 4 else 0], m[1 if s == 3 else 2]
        if s >= 3:
            ms = F.sub(F.sub(ms, f), g)
        elif s == 0:
            ms = F.add(F.add(ms, ms), ms)
        v.append(ms)
    u = [F.mul(b3, vs) if s in (2, 5) else vs for s, vs in zip(slots, v)]
    out = []
    for s in slots:
        z3l, t1l = F.add(u[1], u[2]), F.sub(u[1], u[2])
        a = u[3 if s == 0 else 4 if s == 1 else 5 if s == 3 else 0]
        b = u[5 if s == 1 else 0 if s == 3 else 4 if s == 4 else 3]
        a = t1l if s == 2 else z3l if s == 4 else a
        b = t1l if s == 0 else z3l if s == 2 else b
        out.append(F.mul(a, b))
    return (F.sub(out[0], out[1]), F.add(out[2], out[3]), F.add(out[4], out[5]))


@pytest.mark.parametrize("name", ["toy_g2", "toy_bn_g2", "bn254_g2", "bls12_381_g2"])
def test_fq2_level_parallel_ops_model_matches_group(name):
    """On points (identity, P = Q, P = -Q among them) and on coordinates that
    are any field values, edge components included."""
    _, port = curves_of(name)
    _, pts, qts = _g2_cases(port)
    P = group.from_affine(port, to_torch(affine_g2(port, pts)))
    Q = group.from_affine(port, to_torch(affine_g2(port, qts)))
    a, b, _, _ = operands(port.fq, 0, seed=8)
    k = a.shape[1] // 3
    Pr = tuple(to_torch(a[:, i * k : (i + 1) * k]) for i in range(3))
    Qr = tuple(to_torch(b[:, i * k : (i + 1) * k]) for i in range(3))
    for p, q in ((P, Q), (Pr, Qr)):
        assert_same(add_par_model(port, p, q), torch_np(group.add(port, p, q)))
        assert_same(double_par_model(port, p), torch_np(group.double(port, p)))


# ---------------------------------------------------------------------------
# the MSM's plain stages over Fq2 (the kernels' plain versions) against the
# JAX package's jnp engine: K1 + K4 bucket sums, K4 alone on lane partials,
# K2 window sums, K3 fold; and ctx.msm against the JAX MSM
# ---------------------------------------------------------------------------

def _msm_inputs(port, seed):
    rng = np.random.default_rng(seed)
    pts = g2_points(port, N, seed)
    pts[2] = None  # the affine identity in the batch
    pts[5] = pts[4]  # a repeated point: the doubling case inside a bucket
    ks = [int(rng.integers(0, port.r)) for _ in range(N)]
    ks[0] = 0
    ks[5] = ks[4]
    return pts, ks, affine_g2(port, pts), ints_to_limbs(ks, port.fr.n_limbs)


@pytest.fixture(scope="module", params=["toy_g2", "toy_bn_g2"])
def stages(request):
    """The JAX side once per curve: digits, bucket sums (jnp engine), window
    sums, and on toy_g2 the fold.  Each jit compile costs seconds on the
    CPU; on toy_bn_g2 the fold is held against the oracle instead."""
    ref, port = curves_of(request.param)
    pts, ks, XY, sc = _msm_inputs(port, seed=31)
    jXY = to_jax(XY)
    digits = ref_windows.signed_window_digits(to_jax(sc), C, BITS)
    buckets = ref_pippenger.bucket_accumulate_c(ref, jXY, digits, T, C)
    sums = ref_pippenger.bucket_reduce(ref, buckets)
    point = None
    if request.param == "toy_g2":
        point = ref_pippenger.window_fold(ref, sums, C)
    expected = oracle_of(port).msm(pts, ks)
    return dict(
        ref=ref, port=port, pts=pts, ks=ks, XY=XY, sc=sc, digits=np.asarray(digits),
        buckets=tuple(np.asarray(b) for b in buckets), sums=tuple(np.asarray(x) for x in sums),
        point=[expected] if point is None else ref_affine(port, tuple(np.asarray(x)[:, None] for x in point)),
        expected=expected,
    )


def test_g2_digits_and_bucket_sums_match_reference(stages):
    port = stages["port"]
    digits = windows.signed_window_digits(to_torch(stages["sc"]), C, BITS)
    np.testing.assert_array_equal(torch_np(digits), stages["digits"])
    got = pl_bucket.bucket_accumulate(port, to_torch(stages["XY"]), digits, lanes=T, c=C)
    assert got[0].shape == stages["buckets"][0].shape  # (2L, W, B)
    assert port_affine(port, got) == ref_affine(port, stages["buckets"])


def test_g2_lane_reduce_matches_reference(stages):
    """K4's contract: the sweep's (B, 2L, W, T) lane partials -> (2L, W, B)."""
    port = stages["port"]
    digits = windows.signed_window_digits(to_torch(stages["sc"]), C, BITS)
    raw = pippenger._bucket_sweep_plain(port, to_torch(stages["XY"]), digits, T, C)
    partials = tuple(r.permute(3, 0, 1, 2) for r in raw)  # (L, W, T, B) -> (B, L, W, T)
    got = pl_reduce.lane_reduce(port, partials)
    assert port_affine(port, got) == ref_affine(port, stages["buckets"])


def test_g2_collapse_and_finish_match_reference(stages):
    port = stages["port"]
    buckets = to_torch(stages["buckets"])
    sums = pl_reduce.collapse(port, buckets)
    assert port_affine(port, sums) == ref_affine(port, stages["sums"])
    want = stages["point"]
    assert want == [stages["expected"]]
    assert port_affine(port, pl_reduce.finish(port, buckets, C)) == want
    assert port_affine(port, pl_reduce.finish_large(port, buckets, C)) == want
    fold_in = tuple(a[:, :, None] for a in to_torch(stages["sums"]))
    assert port_affine(port, pl_reduce.finish(port, fold_in, C)) == want


def test_g2_msm_matches_reference_xla_engine():
    """ctx.msm on CPU tensors (the plain engine) against the JAX package's
    MSM with impl="xla" on toy_g2, at the stages' shapes (it reuses their
    compiled functions when the stage tests ran first), and the oracle."""
    ref, port = curves_of("toy_g2")
    pts, ks, XY, sc = _msm_inputs(port, seed=31)
    jres = ref_pippenger.msm(ref, to_jax(XY), to_jax(sc), c=C, max_bits=BITS, lanes=T, impl="xla")
    want = ref_affine(port, tuple(np.asarray(x)[:, None] for x in jres))
    ctx = ZT.build_curve(port, device="cpu")
    got = ctx.msm(to_torch(XY), to_torch(sc), c=C, max_bits=BITS, lanes=T)
    assert port_affine(port, got) == want == [oracle_of(port).msm(pts, ks)]
    assert [ctx.result_to_affine(got)] == want


@pytest.mark.parametrize("name", ["bn254_g2", "bls12_381_g2"])
def test_g2_msm_full_width_against_oracle(name):
    """The full-width curves on the plain engine through the host API,
    against the port's oracle: 7 points (the identity among them), 16-bit
    scalars (a plain group op costs ~40 ms at these widths on the CPU, so
    full scalars' ~300 doublings stay on the card: chip_smoke.py)."""
    _, port = curves_of(name)
    rng = np.random.default_rng(9)
    pts = g2_points(port, 6, seed=41) + [None]
    ks = [int(k) for k in rng.integers(0, 1 << 16, size=len(pts))]
    ks[1] = 0
    ctx = ZT.build_curve(port, device="cpu")
    assert ctx.msm_host(pts, ks, c=4, max_bits=16, lanes=2) == oracle_of(port).msm(pts, ks)


# ---------------------------------------------------------------------------
# state carried across, the kernels' constants, the engine choice
# ---------------------------------------------------------------------------

def test_g2_points_cross_from_reference_and_pack_to_words():
    ref, port = curves_of("bls12_381_g2")
    pts = g2_points(port, 3, seed=51) + [None]
    XY = affine_g2(port, pts)
    jx = ref.field.const(port.gx, (2,))  # a JAX Fq2 array
    tx = from_reference(np.asarray(jx))
    assert tx.dtype == torch.int64 and tuple(tx.shape) == (48, 2)
    assert_same(tx, jx)
    P = from_reference(tuple(to_jax(XY)))
    assert [torch_np(c).tolist() for c in P] == [c.tolist() for c in XY]
    np.testing.assert_array_equal(to_reference(P[0]), XY[0])
    ctx = ZT.build_curve(port, device="cpu")
    dev_pts = ctx.points_to_device(pts)
    assert [torch_np(c).tolist() for c in dev_pts] == [c.tolist() for c in XY]
    # packed words: component 0's NW words, then component 1's
    L = port.fq.n_limbs
    words = pack_words(P[0])
    assert tuple(words.shape) == (L, 4)
    assert torch.equal(words, torch.cat([pack_words(P[0][:L]), pack_words(P[0][L:])]))


def test_g2_kernel_constant_block():
    """3b over Fq2: component 0 in the Fq slot, component 1 in the last;
    BN254 G2's 3b is a full Fq2 element, BLS12-381 G2's 12 + 12u, which the
    level-parallel Fq2 ops take as additions (fold_b3k 12; 0 elsewhere)."""
    for name in ("bls12_381_g2", "bn254_g2", "toy_g2"):
        port = getattr(port_curves, name)
        fq, nw = port.fq, port.fq.n_words
        block = _build.curve_consts(port)
        assert block.shape == (_build.CONSTS_WORDS,) and not block.flags.writeable

        def slot(lo):
            return sum(int(w) << (32 * i) for i, w in enumerate(block[lo : lo + 12]))

        b3 = tuple(3 * c % fq.q for c in port.b)
        assert slot(24) == fq.to_mont_int(b3[0]) and slot(37) == fq.to_mont_int(b3[1])
        assert (block[:24] == _build.field_consts(fq)[:24]).all() and block[36] == fq.np32
        assert not block[24 + nw : 36].any() and not block[37 + nw :].any()
        assert _build.fold_b3k(port) == (12 if name == "bls12_381_g2" else 0)
    assert port_curves.bn254_g2.b3[1] != 0 and port_curves.bls12_381_g2.b3 == (12, 12)
    with pytest.raises(NotImplementedError, match="u\\^2 = -1"):
        _build.curve_consts(dataclasses.replace(port_curves.bls12_381_g2, name="nr2", nr=2))
    assert _build.fold_b3k(port_curves.bls12_381) == 12


def test_g2_resolves_to_the_bucket_kernel_engine():
    """auto on a CUDA tensor picks the bucket kernel engine for G2 with the
    reference's c <= 6 rule (c = 6, W = 44, B = 32 at 256 bits); the sorted
    kernel engine, or an explicit c above 6, resolves as the reference's
    pallas-sorted does (c = 10 at 2^20 when c is unset); the plain engines
    still resolve, and a kernel engine on CPU tensors raises."""
    g2 = port_curves.bls12_381_g2
    got = pippenger.resolve_config(g2, 1 << 20, 256, None, None, 2 << 30, "auto", device="cuda")
    want = ref_pippenger.resolve_config(ref_curves.bls12_381_g2, 1 << 20, 256, None, None, 2 << 30, "pallas")
    assert got == ("kernel", 6, None) and got[1:] == want[1:]
    assert windows.num_windows(256, 6) == 44
    assert pippenger.resolve_config(port_curves.bn254_g2, 1 << 16, 256, 4, None, 2 << 30, "kernel") == (
        "kernel", 4, None)
    for impl, c, ref_impl in (("kernel-sorted", None, "pallas-sorted"), ("kernel-sorted", 10, "pallas-sorted"),
                              ("kernel", 7, "pallas")):
        got = pippenger.resolve_config(g2, 1 << 20, 256, c, None, 2 << 30, impl)
        want = ref_pippenger.resolve_config(ref_curves.bls12_381_g2, 1 << 20, 256, c, None, 2 << 30, ref_impl)
        assert got == ("kernel-sorted", want[1], None) and want[0] == "pallas-sorted"
    assert pippenger.resolve_config(g2, 1 << 20, 256, None, None, 2 << 30, "kernel-sorted")[1] == 10
    assert pippenger.resolve_config(g2, 64, 256, 7, 2, 2 << 30, "plain") == ("plain", 7, 2)
    assert pippenger.resolve_config(g2, 64, 256, 7, None, 2 << 30, "plain-sorted")[0] == "plain-sorted"
    assert pippenger.resolve_config(g2, 64, 256, None, None, 2 << 30, "auto", device="cpu")[0] == "plain"
    ctx = ZT.build_curve(g2, device="cpu")
    for impl in ("kernel", "kernel-sorted"):
        with pytest.raises(ValueError, match="CUDA"):
            ctx.msm(ctx.points_to_device([None]), torch.zeros((16, 1), dtype=torch.int64), impl=impl)
